"""Pipeline parallelism: the port's parallel/pipeline_parallel.py over 2
gloo ranks on the CPU against ltx2_tpu/parallel/pipeline_parallel.py on the
host devices of tests/conftest.py, on the same weights (`random_tree`, 4
blocks: 2 a stage) and inputs.

- the GPipe forward against `make_pipeline_parallel_forward`: video at 1
  and 2 microbatches, per-token timesteps, STG masks in blocks 1 and 2 (on
  either side of the stage boundary) with the late-block cross-attention
  scales, the audio-video DiT with STG on both streams;
- the video loop under CFG and STG (3 rows, 3 microbatches), the joint AV
  loop and the multi-modal loop against the JAX loops on a pipeline mesh;
- every rank's result identical; each rank holds L/P blocks; the stage
  sends each microbatch once (no bubble ticks) and the last stage
  broadcasts the x0;
- the loader reads only each rank's blocks from a safetensors file the
  test writes, under PP and PP x TP (the JAX package's sharded loads);
- the refusals with the JAX messages: guidance reuse and text-KV caching
  under PP, indivisible stages.
fp32 results to 1e-4 of max|x|. test_torch_port_pipeline_parallel_world4.py
runs PP x SP, PP x TP and PP x DP on 4 ranks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import perturbations as jpert
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.parallel import mesh as jmesh
from ltx2_tpu.parallel import pipeline_parallel as jpp
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu_torch.models.transformer import model
from tests.test_torch_port_parallel import _jloop_cfg, _loop_inputs, _modality, _positions, _stacked
from tests.torch_port_util import LOOP_SIGMAS, assert_close, random_tree, spawn_ranks
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

VIDEO4 = dict(num_attention_heads=4, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=4,
              cross_attention_dim=128, compute_dtype="float32")
AV4 = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=4,
           cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
           audio_out_channels=16, caption_channels=24, model_type=model.LTXModelType.AudioVideo)
JVIDEO4 = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None, remat=False,
                                **VIDEO4)
JAV4 = jmodel.LTXModelConfig(remat=False, **{**AV4, "model_type": jmodel.LTXModelType.AudioVideo})
# Row 1 skips self-attention in blocks 1 and 2: one block on each stage.
STG = (2, {1: [("SKIP_VIDEO_SELF_ATTN", [1, 2]), ("SKIP_AUDIO_SELF_ATTN", [1, 2])]})
CA = np.array([1.0, 1.0, 0.5, 0.25], np.float32)
VIDEO_LOOP = dict(cfg_scale=3.0, stg_scale=1.0, stg_blocks=(1, 2), uniform_timesteps=True)
AV_LOOP = dict(cfg_scale=3.0, audio_cfg_scale=2.0, uniform_timesteps=True)
MM_LOOP = dict(stg_scale=1.0, stg_blocks=(1,), uniform_timesteps=True)
DP_LOOP = dict(cfg_scale=3.0, uniform_timesteps=True)  # 2 rows x 2 clips, as tests/test_parallel.py:1023


def _jstg():
    skip = jpert.PerturbationConfig(perturbations=(
        jpert.Perturbation(type=jpert.PerturbationType.SKIP_VIDEO_SELF_ATTN, blocks=(1, 2)),
        jpert.Perturbation(type=jpert.PerturbationType.SKIP_AUDIO_SELF_ATTN, blocks=(1, 2))))
    return jpert.BatchedPerturbationConfig(perturbations=(jpert.PerturbationConfig.empty(), skip))


@pytest.fixture(scope="module")
def trees():
    return {"video": _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**VIDEO4), device="meta"), 51)),
            "av": _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**AV4), device="meta"), 52))}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    vpos, apos = _positions(2)
    return {"video": _modality(2, 16, 128, vpos, rng), "video_pt": _modality(2, 16, 128, vpos, rng, per_token=True),
            "av_video": _modality(2, 16, 24, vpos, rng), "av_audio": _modality(2, 8, 24, apos, rng),
            "loops": _loop_inputs(19), "two_clips": _two_clips()}


def _two_clips():
    """A batch of two noised video clips (the JAX state and its numpy
    dict) and their contexts."""
    a, b = _loop_inputs(19), _loop_inputs(23)
    state = {k: np.concatenate([a["video"][1][k], b["video"][1][k]]) for k in a["video"][1]}
    jstate = dataclasses.replace(a["video"][0], **{k: jnp.asarray(v) for k, v in state.items()})
    return jstate, state, [np.concatenate(pair) for pair in zip(a["ctx_video"], b["ctx_video"])]


def forward_jobs(trees, inputs, layouts):
    """The pp_forwards cases of the layouts named, (data, pipe, seq, model) each."""
    v, vpt = inputs["video"][1], inputs["video_pt"][1]
    av_v, av_a = inputs["av_video"][1], inputs["av_audio"][1]
    video_cases, av_cases = [], []
    for key, layout in layouts.items():
        video_cases += [(f"{key}_m2", layout, 2 // layout[0], v, None, None, None),
                        (f"{key}_m1", layout, 1, v, None, None, None),
                        (f"{key}_stg_ca", layout, 2 // layout[0], v, None, STG, CA)]
        av_cases.append((f"{key}_stg", layout, 2 // layout[0], av_v, av_a, STG, None))
        if layout == (1, 2, 1, 1):
            video_cases.append((f"{key}_per_token", layout, 2, vpt, None, None, None))
    return [("video", "pp_forwards", (trees["video"], VIDEO4, video_cases)),
            ("av", "pp_forwards", (trees["av"], AV4, av_cases))]


def loop_jobs(trees, inputs, layout):
    loops = inputs["loops"]
    v, a = loops["video"][1], loops["audio"][1]
    return [("loops", "pp_loops", (trees["video"], VIDEO4, [
                ("video", "video", layout, VIDEO_LOOP, [v], LOOP_SIGMAS, loops["ctx_video"])])),
            ("av_loops", "pp_loops", (trees["av"], AV4, [
                ("av", "av", layout, AV_LOOP, [v, a], LOOP_SIGMAS, loops["ctx_av"]),
                ("mm", "mm", layout, MM_LOOP, [v, a], LOOP_SIGMAS, loops["ctx_av"])]))]


def dp_loop_jobs(trees, inputs, layout, microbatches):
    """The video loop over two clips under CFG, in `microbatches` microbatches."""
    _, state, ctx = inputs["two_clips"]
    return [("dp_loop", "pp_loops", (trees["video"], VIDEO4, [
        ("video", "video", layout, dict(DP_LOOP, pipeline_microbatches=microbatches), [state], LOOP_SIGMAS, ctx)]))]


def check_dp_loop(results, trees, inputs, layout, microbatches):
    """The loop against the JAX loop on the same mesh and microbatches."""
    jstate, _, ctx = inputs["two_clips"]
    data, pipe, seq, tp = layout
    jp = jax.tree_util.tree_map(jnp.asarray, trees["video"])
    ref = jdenoise.make_video_denoise_loop(JVIDEO4, _jloop_cfg(DP_LOOP), mesh=jax_mesh(data, pipe, seq, tp),
                                          pipeline_axis="pipe", pipeline_microbatches=microbatches)(
        jp, jstate, jnp.asarray(LOOP_SIGMAS), *(jnp.asarray(c) for c in ctx)).latent
    assert_close(same_on_every_rank(results, "dp_loop")["video"], np.asarray(ref),
                 msg=f"{layout} video loop, {microbatches} microbatches")


@pytest.fixture(scope="module")
def world2(trees, inputs, tmp_path_factory):
    from tests.torch_port_pp_workers import run_jobs

    jobs = forward_jobs(trees, inputs, {"pp2": (1, 2, 1, 1)}) + loop_jobs(trees, inputs, (1, 2, 1, 1))
    return spawn_ranks(run_jobs, 2, tmp_path_factory.mktemp("pp_world2"), jobs)


def same_on_every_rank(results, key, skip_suffixes=("_blocks", "_calls")):
    """Rank 0's results under `key`, each (but the per-rank records) bit for
    bit every rank's."""
    first = results[0][key]
    for r in results[1:]:
        for name, value in r[key].items():
            if not name.endswith(skip_suffixes):
                jax.tree_util.tree_map(np.testing.assert_array_equal, value, first[name])
    return first


def jax_mesh(data=1, pipe=2, seq=1, tp=1):
    return jmesh.create_mesh(data=data, model=tp, seq=seq, pipe=pipe, devices=jax.devices()[:data * pipe * seq * tp])


def jax_pp(jp, cfg, video, audio=None, m=2, layout=(1, 2, 1, 1), perturbations=None, ca=None):
    """The JAX package's pipelined x0 on the layout's mesh."""
    data, pipe, seq, tp = layout
    mesh = jax_mesh(data, pipe, seq, tp)
    model_axis = "model" if tp > 1 else None
    cfg = dataclasses.replace(cfg, sequence_axis="seq" if seq > 1 else None)
    params = jpp.shard_pipeline_params(mesh, jp, model_axis=model_axis)
    fn = jpp.make_pipeline_parallel_forward(mesh, cfg, num_microbatches=m, x0=True, perturbations=perturbations,
                                            ca_scales=None if ca is None else jnp.asarray(ca),
                                            data_axis="data" if data > 1 else None, model_axis=model_axis)
    return fn(params, video, audio)


def check_forwards(results, trees, inputs, layouts):
    out = same_on_every_rank(results, "video")
    jp = jax.tree_util.tree_map(jnp.asarray, trees["video"])
    jv, jvpt = inputs["video"][0], inputs["video_pt"][0]
    for key, layout in layouts.items():
        m = 2 // layout[0]
        assert_close(out[f"{key}_m2"], jax_pp(jp, JVIDEO4, jv, m=m, layout=layout), msg=f"{key} video M={m}")
        assert_close(out[f"{key}_m1"], jax_pp(jp, JVIDEO4, jv, m=1, layout=layout), msg=f"{key} video M=1")
        assert_close(out[f"{key}_stg_ca"], jax_pp(jp, JVIDEO4, jv, m=m, layout=layout, perturbations=_jstg(),
                                                  ca=CA), msg=f"{key} video STG + ca_scales")
        if layout == (1, 2, 1, 1):
            assert_close(out[f"{key}_per_token"], jax_pp(jp, JVIDEO4, jvpt), msg=f"{key} per-token timesteps")
    av = same_on_every_rank(results, "av")
    jpa = jax.tree_util.tree_map(jnp.asarray, trees["av"])
    (jav, _), (jaa, _) = inputs["av_video"], inputs["av_audio"]
    for key, layout in layouts.items():
        ref_v, ref_a = jax_pp(jpa, JAV4, jav, jaa, m=2 // layout[0], layout=layout, perturbations=_jstg())
        assert_close(av[f"{key}_stg"][0], ref_v, msg=f"{key} AV STG video")
        assert_close(av[f"{key}_stg"][1], ref_a, msg=f"{key} AV STG audio")


def jax_loops(trees, inputs, layout):
    data, pipe, seq, tp = layout
    mesh = jax_mesh(data, pipe, seq, tp)
    loops, sigmas = inputs["loops"], jnp.asarray(LOOP_SIGMAS)
    jp = jax.tree_util.tree_map(jnp.asarray, trees["video"])
    jpa = jax.tree_util.tree_map(jnp.asarray, trees["av"])
    if tp > 1:
        jp = jpp.shard_pipeline_params(mesh, jp, model_axis="model")
        jpa = jpp.shard_pipeline_params(mesh, jpa, model_axis="model")
    pp = dict(mesh=mesh, pipeline_axis="pipe")
    video = jdenoise.make_video_denoise_loop(JVIDEO4, _jloop_cfg(VIDEO_LOOP), **pp)(
        jp, loops["video"][0], sigmas, *(jnp.asarray(c) for c in loops["ctx_video"])).latent
    av_args = (loops["video"][0], loops["audio"][0], sigmas, *(jnp.asarray(c) for c in loops["ctx_av"]))
    av = jdenoise.make_av_denoise_loop(JAV4, _jloop_cfg(AV_LOOP), **pp)(jpa, *av_args)
    jmm = {k: v for k, v in MM_LOOP.items() if k != "uniform_timesteps"}  # the JAX loop runs per token
    mm = jdenoise.make_multimodal_av_denoise_loop(JAV4, jdenoise.MultiModalLoopConfig(**jmm), **pp)(jpa, *av_args)
    return {"video": np.asarray(video), "av": tuple(np.asarray(s.latent) for s in av),
            "mm": tuple(np.asarray(s.latent) for s in mm)}


def check_loops(results, trees, inputs, layout):
    ref = jax_loops(trees, inputs, layout)
    out = same_on_every_rank(results, "loops")
    assert_close(out["video"], ref["video"], msg=f"{layout} video loop (CFG, STG)")
    out = same_on_every_rank(results, "av_loops")
    for kind in ("av", "mm"):
        assert_close(out[kind][0], ref[kind][0], msg=f"{layout} {kind} loop video")
        assert_close(out[kind][1], ref[kind][1], msg=f"{layout} {kind} loop audio")


def test_pp_forward_matches_jax(world2, trees, inputs):
    check_forwards(world2, trees, inputs, {"pp2": (1, 2, 1, 1)})


def test_pp_loops_match_jax(world2, trees, inputs):
    check_loops(world2, trees, inputs, (1, 2, 1, 1))


def test_each_stage_holds_its_blocks_and_sends_each_microbatch_once(world2):
    """Rank s holds blocks 2s and 2s + 1 of 4; stage 0 sends M hops (the
    JAX schedule's M + P - 1 ticks would make M + P - 2), stage 1 receives
    them, and one broadcast carries the x0."""
    for rank, r in enumerate(world2):
        out = r["video"]
        for name, m in (("pp2_m2", 2), ("pp2_m1", 1)):
            assert out[name + "_blocks"] == [2 * rank, 2 * rank + 1]
            calls = out[name + "_calls"]
            assert calls.get("send" if rank == 0 else "recv") == m and calls.get("broadcast") == 1, calls
            assert "all_reduce" not in calls


def _checkpoint(tmp_path, tree, layers: int = 4):
    from ltx2_tpu.loader import export as jexport
    from ltx2_tpu.loader import safetensors_io as jst

    path = str(tmp_path / "pp.safetensors")
    jst.write_safetensors(path, jexport.params_to_checkpoint(tree), metadata={
        "model_version": "2.0.0", "config": '{"transformer": {"num_attention_heads": 4}}'})
    return path


@pytest.mark.parametrize("tp", [1, 2], ids=["pp2", "pp2_tp2"])
def test_loader_reads_only_each_ranks_blocks(trees, tmp_path, tp):
    """`load_transformer_params(pipe_axis=...)` reads only the rank's L/P
    blocks (the others' places hold no tensor) and composes with
    `tp_axis`: each tensor is the whole load's, sliced by the TP rules."""
    from ltx2_tpu_torch.loader import weight_loader
    from ltx2_tpu_torch.loader.weight_loader import load_transformer_params
    from ltx2_tpu_torch.parallel.mesh import Axis
    from ltx2_tpu_torch.parallel.pipeline_parallel import resident_blocks
    from ltx2_tpu_torch.parallel.sharding import shard_tensor

    path = _checkpoint(tmp_path, trees["video"])
    whole = load_transformer_params(path, device="cpu", target_dtype="float32")
    tensors = dict((*whole.named_parameters(), *whole.named_buffers()))
    read = []
    real = weight_loader.SafetensorsFile.get

    def counted(self, key):
        read.append(key)
        return real(self, key)

    for stage in range(2):
        for index in range(tp):
            pipe = Axis("pipe", 2, stage, (0, 1), None, "gloo")
            model_axis = Axis("model", tp, index, tuple(range(tp)), None, "gloo") if tp > 1 else None
            read.clear()
            weight_loader.SafetensorsFile.get = counted
            try:
                part = load_transformer_params(path, device="cpu", target_dtype="float32", pipe_axis=pipe,
                                               tp_axis=model_axis)
            finally:
                weight_loader.SafetensorsFile.get = real
            assert resident_blocks(part) == [2 * stage, 2 * stage + 1]
            blocks_read = {int(k.split("transformer_blocks.")[1].split(".")[0]) for k in read
                           if "transformer_blocks." in k}
            assert blocks_read == {2 * stage, 2 * stage + 1}
            got = dict((*part.named_parameters(), *part.named_buffers()))
            assert set(got) == {n for n in tensors if not n.startswith("transformer_blocks.")
                                or int(n.split(".")[1]) in (2 * stage, 2 * stage + 1)}
            for name, t in got.items():
                assert torch.equal(t, shard_tensor(name, tensors[name], model_axis)), name
            if tp > 1:
                assert part.cfg.tp_axis is model_axis


def test_pp_refusals_carry_the_jax_messages(trees):
    """Guidance reuse and text-KV caching under PP are refused as the JAX
    loops refuse them; stages that do not divide the blocks too, and on the
    command line with the JAX CLI's exit."""
    from ltx2_tpu_torch.components.guiders import CFGGuider
    from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
    from ltx2_tpu_torch.parallel.mesh import Axis, Mesh
    from ltx2_tpu_torch.parallel.pipeline_parallel import make_pipeline_parallel_forward, stage_layers
    from ltx2_tpu_torch.pipelines import denoise

    for make, jmake, cfg, jcfg in (
            (denoise.make_video_denoise_loop, jdenoise.make_video_denoise_loop,
             denoise.DenoiseLoopConfig(guider=CFGGuider(3.0), cfg_interval=2),
             _jloop_cfg(dict(cfg_scale=3.0, cfg_interval=2))),
            (denoise.make_multimodal_av_denoise_loop, jdenoise.make_multimodal_av_denoise_loop,
             denoise.MultiModalLoopConfig(cfg_interval=2), jdenoise.MultiModalLoopConfig(cfg_interval=2))):
        with pytest.raises(NotImplementedError) as err:
            make(model.LTXModelConfig(**VIDEO4), cfg, pipeline_axis="pipe")
        with pytest.raises(NotImplementedError) as jerr:
            jmake(JVIDEO4, jcfg, pipeline_axis="pipe")
        assert str(err.value) == str(jerr.value)
    pipe = Axis("pipe", 2, 0, (0, 1), None, "gloo")
    mesh = Mesh({"data": 1, "pipe": 2, "model": 1}, {"pipe": pipe}, 0, (0, 1), True)
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO4))
    with pytest.raises(ValueError, match="cache_text_kv is incompatible with pipeline_axis"):
        make_pipeline_parallel_forward(mesh)(dit, None, text_kv={"video": None})
    loop = denoise.make_video_denoise_loop(dit.cfg, denoise.DenoiseLoopConfig(cache_text_kv=True), mesh=mesh,
                                           pipeline_axis="pipe")
    state = _loop_inputs(19)["video"][1]
    from ltx2_tpu_torch.types import LatentState

    ctx = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="cache_text_kv is incompatible with pipeline_axis"):
        loop(dit, LatentState(**{k: torch.from_numpy(np.array(v)) for k, v in state.items()}),
             torch.from_numpy(LOOP_SIGMAS), ctx, ctx)
    with pytest.raises(ValueError, match="must divide num_layers 4"):
        stage_layers(4, Axis("pipe", 3, 0, (0, 1, 2), None, "gloo"))
    from ltx2_tpu_torch import generate

    # The command line exits as the JAX CLI does (scripts/generate.py:620-630).
    with pytest.raises(SystemExit, match="--pp-stages 2 must divide 3 transformer blocks"):
        generate.check_pipe_stages(3, {"pipeline_mesh": mesh})


@pytest.mark.parametrize("model_axis", [None, "model"])
def test_pp_tp_param_spec_matches_jax(model_axis):
    """`shard_pipeline_params` places every tensor as the JAX package's
    `pp_tp_param_spec` does, on every rank of PP2 (and PP2 x TP2): a
    block's tensors ('pipe' leading the spec) on its stage alone, cut along
    each 'model' dim of the TP rule behind it; the replicated rest whole."""
    from tests.test_torch_port_parallel import _jax_path
    from ltx2_tpu_torch.parallel.mesh import Axis, Mesh
    from ltx2_tpu_torch.parallel.pipeline_parallel import shard_pipeline_params

    cfg = model.LTXModelConfig(**AV4)
    whole = dict(model.LTXModel(cfg, device="meta").named_parameters())
    tp = 1 if model_axis is None else 2
    split = set()
    for stage in range(2):
        for index in range(tp):
            axes = {"pipe": Axis("pipe", 2, stage, (0, 1), None, "gloo")}
            if model_axis is not None:
                axes["model"] = Axis("model", tp, index, tuple(range(tp)), None, "gloo")
            mesh = Mesh({"data": 1, "pipe": 2, "model": tp}, axes, 0, tuple(range(2 * tp)), True)
            got = dict(shard_pipeline_params(mesh, model.LTXModel(cfg, device="meta")).named_parameters())
            for name, t in whole.items():
                spec = tuple(jpp.pp_tp_param_spec(_jax_path(name), "pipe", model_axis))
                if spec[:1] == ("pipe",):
                    spec = spec[1:]
                    if int(name.split(".")[1]) // 2 != stage:
                        assert name not in got, name
                        continue
                spec += (None,) * (t.ndim - len(spec))
                want = tuple(d // tp if ax == "model" else d for d, ax in zip(t.shape, spec))
                assert tuple(got[name].shape) == want, (name, spec)
                if "model" in spec:
                    split.add(name)
    assert (len(split) > 20) == (model_axis is not None)
