"""The scale-out parity checks of test_torch_port_parallel.py on 4 gloo
ranks: ring attention at seq 4, the SP forward (video and AV) and loop at
4, TP 4 (int8 too), SP x TP 2 x 2, the TP Q/K norms over 4 ranks. Its own
file, so that its launch runs beside the 2-rank one under xdist."""

from __future__ import annotations

import pytest

from tests import test_torch_port_parallel as base
from tests.test_torch_port_parallel import inputs, loop_inputs, trees  # noqa: F401 (the fixtures)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.fixture(scope="module")
def world4(trees, inputs, loop_inputs, tmp_path_factory):  # noqa: F811 (the fixtures)
    return base._launch(4, trees, inputs, loop_inputs, tmp_path_factory)


def test_ring_sdpa_matches_jax_at_4(request, inputs):  # noqa: F811
    base.test_ring_sdpa_matches_jax(request, inputs, 4)


def test_video_forward_layouts_match_jax_at_4(request, trees, inputs):  # noqa: F811
    base.test_video_forward_layouts_match_jax(request, trees, inputs, 4)


def test_av_forward_layouts_match_jax_at_4(request, trees, inputs):  # noqa: F811
    base.test_av_forward_layouts_match_jax(request, trees, inputs, 4)


def test_tp_qk_norm_reduces_over_the_whole_inner_dim_at_4(request, inputs):  # noqa: F811
    base.test_tp_qk_norm_reduces_over_the_whole_inner_dim(request, inputs, 4)


def test_sp_loops_match_jax_at_4(request, trees, loop_inputs):  # noqa: F811
    base.test_sp_loops_match_jax(request, trees, loop_inputs, 4)
