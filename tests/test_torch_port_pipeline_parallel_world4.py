"""The pipeline-parallel parity checks of test_torch_port_pipeline_parallel.py
on 4 gloo ranks, each composition of the JAX package's: PP2 x SP2 (ring
attention inside each stage), PP2 x TP2 (each stage's blocks TP-sharded,
the row-parallel sums over the stage's model line) and PP2 x DP2 (the rows
split over 'data', the schedule over each shard's local rows): the forward
(video at 1 and 2 microbatches, STG across the stage boundary with the
cross-attention scales, the AV DiT with STG), the video, AV and
multi-modal loops under PP2 x TP2, and the video loop over two clips in 4
microbatches under PP2 x DP2, against the JAX package's on the same
meshes, every rank's result identical. Its own file, so that its launch runs
beside the 2-rank one under xdist."""

from __future__ import annotations

import pytest

from tests import test_torch_port_pipeline_parallel as base
from tests.test_torch_port_pipeline_parallel import inputs, trees  # noqa: F401 (the fixtures)
from tests.torch_port_util import one_intra_op_thread, spawn_ranks  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

LAYOUTS = {"pp2_sp2": (1, 2, 2, 1), "pp2_tp2": (1, 2, 1, 2), "pp2_dp2": (2, 2, 1, 1)}  # (data, pipe, seq, model)


@pytest.fixture(scope="module")
def world4(trees, inputs, tmp_path_factory):  # noqa: F811 (the fixtures)
    from tests.torch_port_pp_workers import run_jobs

    jobs = (base.forward_jobs(trees, inputs, LAYOUTS) + base.loop_jobs(trees, inputs, LAYOUTS["pp2_tp2"])
            + base.dp_loop_jobs(trees, inputs, LAYOUTS["pp2_dp2"], 4))
    return spawn_ranks(run_jobs, 4, tmp_path_factory.mktemp("pp_world4"), jobs)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pp_compositions_match_jax_at_4(world4, trees, inputs, layout):  # noqa: F811
    base.check_forwards(world4, trees, inputs, {layout: LAYOUTS[layout]})


def test_pp_tp_loops_match_jax_at_4(world4, trees, inputs):  # noqa: F811
    base.check_loops(world4, trees, inputs, LAYOUTS["pp2_tp2"])


def test_pp_dp_loop_with_microbatches_matches_jax_at_4(world4, trees, inputs):  # noqa: F811
    """`pipeline_microbatches` 4 over PP2 x DP2 (tests/test_parallel.py:1023):
    each data shard's 2 local rows go as max(1, 4 // 2) = 2 microbatches, so
    stage 0 sends 2 hops a step (1 with the default, the guidance rows / 2)."""
    base.check_dp_loop(world4, trees, inputs, LAYOUTS["pp2_dp2"], 4)
    steps = len(base.LOOP_SIGMAS) - 1
    for rank, r in enumerate(world4):
        calls = r["dp_loop"]["video_calls"]
        assert calls.get("recv" if rank % 2 else "send") == 2 * steps, (rank, calls)


def test_each_rank_holds_its_stage_at_4(world4):
    """Under every layout rank r holds the blocks of its pipe index: the
    pipe axis is outermost after data, so ranks (0, 1) / (2, 3) are stages
    0 / 1 with seq or model inside, and under PP x DP ranks (0, 1) are data
    shard 0's stages."""
    for rank, r in enumerate(world4):
        for key in ("pp2_sp2", "pp2_tp2"):
            stage = rank // 2
            assert r["video"][f"{key}_m2_blocks"] == [2 * stage, 2 * stage + 1]
        assert r["video"]["pp2_dp2_m2_blocks"] == [2 * (rank % 2), 2 * (rank % 2) + 1]
