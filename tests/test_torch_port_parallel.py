"""Scale-out parity: the port's parallel/ modules over gloo ranks on the CPU
against ltx2_tpu/parallel/ on the 8 host devices of tests/conftest.py.

The port's ranks run in fresh processes (`spawn_ranks`, the process group
through a file in the test's tmp directory), once per world size for the
whole module: each launch runs every layout of that size
(tests/torch_port_parallel_workers.py) and the tests hold the results
against the JAX package's on the same weights (`random_tree`) and inputs:

- the TP sharding rules against `spec_for_path` for every leaf of a tiny
  audio-video DiT (LoRA and int8 scales included) and the Gemma rules;
- `ring_sdpa` at seq 2 and 4 against `ring_attention_local` (JAX's dense
  inner; the port's "flash" inner is K2's plain version here): fp32 within
  1e-5 relative, bf16 within 1e-2 of max|x|, n - 1 K/V exchanges;
- the SP forward (video, per-token timesteps, AV, AV with STG) against
  `make_sequence_parallel_forward` (STG against the unsharded forward);
- TP at 2 and 4 (int8 too; V2's gates at 2) against `shard_dit_params` +
  GSPMD, SP x TP (2 x 2); Q/K RMS norms over the whole inner dim under TP
  2 and 4;
- the SP video loop with CFG, STG and Heun, and the AV loop, against the
  JAX loops on a sequence mesh; the refusals with the JAX messages;
- every rank's result identical: the ranks stay in lockstep.
fp32 results to 1e-4 of max|x| (the packages sum in different orders).
This file launches 2 ranks; test_torch_port_parallel_world4.py runs the
same checks on 4 (and SP x TP 2 x 2), so the two launches run side by side
under xdist.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import guiders as jguiders
from ltx2_tpu.components import perturbations as jpert
from ltx2_tpu.components.noisers import _blend as jblend
from ltx2_tpu.components.patchifiers import AudioPatchifier as JAudioPatchifier
from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import AudioLatentTools as JAudioTools
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.loader import int8 as jint8
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.parallel import mesh as jmesh
from ltx2_tpu.parallel import ring_attention as jring
from ltx2_tpu.parallel import sequence_parallel as jsp
from ltx2_tpu.parallel import sharding as jsharding
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.types import AudioLatentShape as JAudioShape
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import sharding
from ltx2_tpu_torch.parallel.mesh import Axis, Mesh
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_av_denoise_loop, make_video_denoise_loop
from ltx2_tpu_torch.types import LatentState
from tests.torch_port_util import LOOP_SIGMAS, assert_close, random_tree, spawn_ranks, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# A video DiT with 4 heads (TP up to 4) and a small audio-video DiT.
VIDEO = dict(num_attention_heads=4, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
             cross_attention_dim=128, compute_dtype="float32")
AV = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
          cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
          audio_out_channels=16, caption_channels=24, model_type=model.LTXModelType.AudioVideo)
V2 = dict(VIDEO, cross_attention_adaln=True, apply_gated_attention=True)  # LTX-2.3: gates on each rank's heads
JVIDEO = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None, remat=False, **VIDEO)
JV2 = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None, remat=False, **V2)
JAV = jmodel.LTXModelConfig(remat=False, **{**AV, "model_type": jmodel.LTXModelType.AudioVideo})
VSHAPE = (1, 16, 2, 2, 4)  # 16 video tokens
ASHAPE = (1, 4, 8, 4)  # 8 audio tokens
RING_SHAPE = (1, 2, 16, 32)


def _stacked(tree):
    tree = dict(tree)
    tree["transformer_blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *tree["transformer_blocks"])
    return tree


@pytest.fixture(scope="module")
def trees():
    return {"video": _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**VIDEO), device="meta"), 31)),
            "av": _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**AV), device="meta"), 32)),
            "v2": _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**V2), device="meta"), 33))}


def _jmesh(seq: int = 1, tp: int = 1, data: int = 1):
    return jmesh.create_mesh(data=data, model=tp, seq=seq, devices=jax.devices()[:data * seq * tp])


def _modality(rows: int, tokens: int, width: int, positions, rng, per_token: bool = False):
    """(JAX Modality, the port's as a dict of numpy arrays)."""
    latent = rng.standard_normal((rows, tokens, 16)).astype(np.float32)
    context = (rng.standard_normal((rows, 8, width)) * 0.5).astype(np.float32)
    sigma = np.full((rows,), 0.7, np.float32)
    timesteps = rng.uniform(0.2, 1.0, (rows, tokens)).astype(np.float32) if per_token else sigma
    positions = np.asarray(positions)
    d = dict(latent=latent, context=context, context_mask=None, timesteps=timesteps, positions=positions,
             sigma=sigma)
    return jmodel.Modality(**{k: (None if v is None else jnp.asarray(v)) for k, v in d.items()}), d


def _positions(rows: int):
    video = JTools(JPatchifier(1), JShape(rows, *VSHAPE[1:]), fps=24.0).create_initial_state().positions
    audio = JAudioTools(JAudioPatchifier(1), JAudioShape(rows, *ASHAPE[1:])).create_initial_state().positions
    return video, audio


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    vpos, apos = _positions(2)
    return {
        "ring": tuple(rng.standard_normal(RING_SHAPE).astype(np.float32) for _ in range(3)),
        "video": _modality(2, 16, 128, vpos, rng),
        "video_pt": _modality(2, 16, 128, vpos, rng, per_token=True),
        "av_video": _modality(2, 16, 24, vpos, rng),
        "av_audio": _modality(2, 8, 24, apos, rng),
        "norm": (rng.standard_normal((2, 3, 64)).astype(np.float32), rng.uniform(0.5, 1.5, 64).astype(np.float32)),
    }


STG = (2, {1: [("SKIP_VIDEO_SELF_ATTN", [1]), ("SKIP_AUDIO_SELF_ATTN", [1])]})


def _jstg():
    skip = jpert.PerturbationConfig(perturbations=(
        jpert.Perturbation(type=jpert.PerturbationType.SKIP_VIDEO_SELF_ATTN, blocks=(1,)),
        jpert.Perturbation(type=jpert.PerturbationType.SKIP_AUDIO_SELF_ATTN, blocks=(1,))))
    return jpert.BatchedPerturbationConfig(perturbations=(jpert.PerturbationConfig.empty(), skip))


def _loop_inputs(seed: int):
    """Noised JAX video and audio states (as numpy dicts too) and contexts."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, tools, tokens in (("video", JTools(JPatchifier(1), JShape(*VSHAPE), fps=24.0), 16),
                                ("audio", JAudioTools(JAudioPatchifier(1), JAudioShape(*ASHAPE)), 8)):
        state = jblend(tools.create_initial_state(), jnp.asarray(rng.standard_normal((1, tokens, 16)),
                                                                 jnp.float32), 1.0)
        out[name] = (state, {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)})
    out["ctx_video"] = [(rng.standard_normal((1, 8, 128)) * 0.5).astype(np.float32) for _ in range(2)]
    out["ctx_av"] = [(rng.standard_normal((1, 8, 24)) * 0.5).astype(np.float32) for _ in range(4)]
    return out


VIDEO_LOOP = dict(cfg_scale=3.0, stg_scale=1.0, stg_blocks=(1,), sampler="heun", uniform_timesteps=True)
AV_LOOP = dict(cfg_scale=3.0, audio_cfg_scale=2.0, uniform_timesteps=True)


def _jloop_cfg(opts):
    opts = dict(opts)
    guider = jguiders.CFGGuider(opts.pop("cfg_scale"))
    audio = jguiders.CFGGuider(opts.pop("audio_cfg_scale", 1.0))
    return jdenoise.DenoiseLoopConfig(guider=guider, audio_guider=audio, **opts)


def _jobs(trees, inputs, loops, world: int):
    v, vpt = inputs["video"][1], inputs["video_pt"][1]
    av_v, av_a = inputs["av_video"][1], inputs["av_audio"][1]
    video_cases = [("sp", world, 1, False, v, None, None), ("tp", 1, world, False, v, None, None),
                   ("tp_int8", 1, world, True, v, None, None)]
    av_cases = [("sp", world, 1, False, av_v, av_a, None)]
    if world == 2:
        video_cases.append(("sp_per_token", 2, 1, False, vpt, None, None))
        av_cases += [("sp_stg", 2, 1, False, av_v, av_a, STG), ("tp", 1, 2, False, av_v, av_a, None)]
    else:
        video_cases.append(("sp_tp", 2, 2, False, v, None, None))
    loop_cases = [("video", "video", dict(VIDEO_LOOP), [loops["video"][1]], LOOP_SIGMAS, loops["ctx_video"])]
    if world == 2:
        loop_cases.append(("av", "av", dict(AV_LOOP), [loops["video"][1], loops["audio"][1]], LOOP_SIGMAS,
                           loops["ctx_av"]))
    jobs = [("ring", "ring_and_collectives", inputs["ring"]),
            ("video", "dit_layouts", (trees["video"], VIDEO, video_cases)),
            ("av", "dit_layouts", (trees["av"], AV, av_cases)),
            ("loops", "loops", (trees["video"], VIDEO, loop_cases[:1])),
            ("norm", "tp_norm_check", (*inputs["norm"], 1e-6))]
    if world == 2:
        jobs.append(("av_loops", "loops", (trees["av"], AV, loop_cases[1:])))
        jobs.append(("v2", "dit_layouts", (trees["v2"], V2, [("sp", 2, 1, False, v, None, None),
                                                              ("tp", 1, 2, False, v, None, None)])))
    return jobs


@pytest.fixture(scope="module")
def loop_inputs():
    return _loop_inputs(9)


def _launch(world, trees, inputs, loop_inputs, tmp_path_factory):
    from tests.torch_port_parallel_workers import run_jobs

    results = spawn_ranks(run_jobs, world, tmp_path_factory.mktemp(f"world{world}"),
                          _jobs(trees, inputs, loop_inputs, world))
    return results


@pytest.fixture(scope="module")
def world2(trees, inputs, loop_inputs, tmp_path_factory):
    return _launch(2, trees, inputs, loop_inputs, tmp_path_factory)


def _ranks(request, world):
    return request.getfixturevalue(f"world{world}")


def _same_on_every_rank(results, key, skip=()):
    """Rank 0's results under `key`, each (but `skip`) bit for bit every rank's."""
    first = results[0][key]
    for r in results[1:]:
        for name, value in r[key].items():
            if name not in skip:
                jax.tree_util.tree_map(np.testing.assert_array_equal, value, first[name])
    return first


# ---------------------------------------------------------------- the rules
def _jax_path(name: str) -> str:
    import re

    return re.sub(r"(transformer_blocks|layers)/\d+/", r"\1/", name.replace(".", "/"))


def test_sharding_rules_match_jax_for_every_leaf():
    """Every tensor of a tiny AV DiT (V2 gates, LoRA adapters and int8
    scales named as the loaders and trainer name them) gets the JAX rule's
    spec without its layer axis."""
    from ltx2_tpu_torch.loader.int8 import quantize_params_int8
    from ltx2_tpu_torch.training.lora import attach_lora_

    cfg = model.LTXModelConfig(**{**AV, "cross_attention_adaln": True, "apply_gated_attention": True,
                                  "caption_channels": None})
    dit = model.LTXModel(cfg)
    for name in ("transformer_blocks.0.attn1.to_q", "transformer_blocks.0.attn1.to_out",
                 "transformer_blocks.0.ff.project_out"):
        attach_lora_(dit.get_submodule(name), rank=2)
    quantize_params_int8(dit.transformer_blocks[1], "transformer_blocks.1")
    names = [n for n, _ in (*dit.named_parameters(), *dit.named_buffers())]
    assert any(n.endswith("weight_cscale") for n in names) and any(n.endswith("lora_B") for n in names)
    checked = 0
    for name in names:
        jspec = tuple(jsharding.spec_for_path(_jax_path(name)))
        if name.startswith("transformer_blocks."):
            jspec = jspec[1:]
        assert sharding.spec_for_path(name) == jspec, name
        checked += bool(jspec)
    assert checked > 40
    for name in ("layers.3.self_attn.q_proj.weight", "layers.3.self_attn.o_proj.weight", "layers.3.mlp.up_proj.weight",
                 "layers.3.mlp.down_proj.weight", "layers.3.self_attn.q_norm.weight", "embed_tokens.weight"):
        assert sharding.gemma_spec_for_path(name) == tuple(jsharding.gemma_spec_for_path(_jax_path(name)))[1:]


# ---------------------------------------------------------------- ring attention
@pytest.mark.parametrize("world", [2])
def test_ring_sdpa_matches_jax(request, inputs, world):
    results = _ranks(request, world)
    out = _same_on_every_rank(results, "ring", skip=("shift_from",))
    q, k, v = (jnp.asarray(x) for x in inputs["ring"])
    mesh = _jmesh(seq=world)
    ref = np.asarray(jring.ring_sdpa(q, k, v, mesh, inner="dense"))
    for inner in ("dense", "flash"):
        assert_close(out[f"fp32_{inner}"], ref, rtol=1e-5, msg=f"ring fp32 {inner}")
        assert out[f"engaged_{inner}"] == {f"ring_{inner}": world}  # one block a rank
        assert out[f"ring_calls_{inner}"] == 2 * (world - 1)  # K and V, n - 1 exchanges
    ref_bf16 = np.asarray(jring.ring_sdpa(*(x.astype(jnp.bfloat16) for x in (q, k, v)), mesh,
                                          inner="dense").astype(jnp.float32))
    assert_close(out["bf16_flash"], ref_bf16, rtol=1e-2, msg="ring bf16")
    assert [r["ring"]["shift_from"] for r in results] == [float((i - 1) % world) for i in range(world)]
    np.testing.assert_array_equal(out["all_reduce"], np.arange(4) * sum(range(1, world + 1)))


# ---------------------------------------------------------------- forwards
def _jax_sp(jp, cfg, video, audio=None, seq=2, tp=1):
    mesh = _jmesh(seq=seq, tp=tp)
    if tp > 1:
        jp = jsharding.shard_dit_params(mesh, jp)
    return jsp.make_sequence_parallel_forward(mesh, cfg, model_axis="model" if tp > 1 else None)(jp, video, audio)


def _jax_tp(jp, cfg, video, audio=None, tp=2):
    mesh = _jmesh(tp=tp)
    fn = jax.jit(lambda p, v, a: jmodel.x0_model_apply(p, cfg, video=v, audio=a))
    return fn(jsharding.shard_dit_params(mesh, jp), video, audio)


@pytest.mark.parametrize("world", [2])
def test_video_forward_layouts_match_jax(request, trees, inputs, world):
    results = _ranks(request, world)
    out = _same_on_every_rank(results, "video")
    jp = jax.tree_util.tree_map(jnp.asarray, trees["video"])
    jv, jvpt = inputs["video"][0], inputs["video_pt"][0]
    assert_close(out["sp"], _jax_sp(jp, JVIDEO, jv, seq=world), msg=f"SP {world}")
    assert out["sp_engaged"] == {"ring_dense": 2 * world}  # 2 blocks, each a ring of `world` blocks
    assert_close(out["tp"], _jax_tp(jp, JVIDEO, jv, tp=world), msg=f"TP {world}")
    j8 = jint8.quantize_params_int8(jp)
    assert_close(out["tp_int8"], _jax_tp(j8, JVIDEO, jv, tp=world), msg=f"TP {world} int8")
    if world == 2:
        assert_close(out["sp_per_token"], _jax_sp(jp, JVIDEO, jvpt), msg="SP per-token timesteps")
        v2 = _same_on_every_rank(results, "v2")
        jp2 = jax.tree_util.tree_map(jnp.asarray, trees["v2"])
        assert_close(v2["sp"], _jax_sp(jp2, JV2, jv), msg="V2 SP 2")
        assert_close(v2["tp"], _jax_tp(jp2, JV2, jv, tp=2), msg="V2 TP 2 (gates on each rank's heads)")
    else:
        assert_close(out["sp_tp"], _jax_sp(jp, JVIDEO, jv, seq=2, tp=2), msg="SP x TP 2 x 2")


@pytest.mark.parametrize("world", [2])
def test_av_forward_layouts_match_jax(request, trees, inputs, world):
    results = _ranks(request, world)
    out = _same_on_every_rank(results, "av")
    jp = jax.tree_util.tree_map(jnp.asarray, trees["av"])
    (jv, _), (ja, _) = inputs["av_video"], inputs["av_audio"]
    ref_v, ref_a = _jax_sp(jp, JAV, jv, ja, seq=world)
    assert_close(out["sp"][0], ref_v, msg=f"AV SP {world} video")
    assert_close(out["sp"][1], ref_a, msg=f"AV SP {world} audio")
    if world == 2:
        ref_v, ref_a = jmodel.x0_model_apply(jp, JAV, video=jv, audio=ja, perturbations=_jstg())
        assert_close(out["sp_stg"][0], ref_v, msg="AV SP STG video")
        assert_close(out["sp_stg"][1], ref_a, msg="AV SP STG audio")
        ref_v, ref_a = _jax_tp(jp, JAV, jv, ja, tp=2)
        assert_close(out["tp"][0], ref_v, msg="AV TP video")
        assert_close(out["tp"][1], ref_a, msg="AV TP audio")


@pytest.mark.parametrize("world", [2])
def test_tp_qk_norm_reduces_over_the_whole_inner_dim(request, inputs, world):
    """Under TP each rank holds 1/T of Q's features; its RMS norm must take
    the mean of squares over all of them: the local slice's norm differs."""
    from ltx2_tpu_torch.core import rms_norm

    x, w = inputs["norm"]
    results = _ranks(request, world)
    full = rms_norm(t(x), t(w), 1e-6).numpy()
    part = 64 // world
    for rank, r in enumerate(results):
        ref = full[..., rank * part:(rank + 1) * part]
        assert_close(r["norm"]["global"], ref, rtol=1e-6, msg=f"rank {rank}")
        assert np.abs(r["norm"]["local"] - ref).max() > 1e-2 * np.abs(ref).max()


# ---------------------------------------------------------------- loops
def _jax_loop(kind, jp, cfg, opts, loops, world):
    sigmas = jnp.asarray(LOOP_SIGMAS)
    mesh = _jmesh(seq=world)
    if kind == "video":
        loop = jdenoise.make_video_denoise_loop(cfg, _jloop_cfg(opts), mesh=mesh)
        return np.asarray(loop(jp, loops["video"][0], sigmas, *(jnp.asarray(c) for c in loops["ctx_video"])).latent)
    loop = jdenoise.make_av_denoise_loop(cfg, _jloop_cfg(opts), mesh=mesh)
    v, a = loop(jp, loops["video"][0], loops["audio"][0], sigmas, *(jnp.asarray(c) for c in loops["ctx_av"]))
    return np.asarray(v.latent), np.asarray(a.latent)


@pytest.mark.parametrize("world", [2])
def test_sp_loops_match_jax(request, trees, loop_inputs, world):
    results = _ranks(request, world)
    out = _same_on_every_rank(results, "loops")
    jp = jax.tree_util.tree_map(jnp.asarray, trees["video"])
    assert_close(out["video"], _jax_loop("video", jp, JVIDEO, VIDEO_LOOP, loop_inputs, world),
                 msg=f"SP {world} video loop (CFG, STG, Heun)")
    assert out["video_engaged"]["ring_dense"] > 0
    if world == 2:
        out = _same_on_every_rank(results, "av_loops")
        jpa = jax.tree_util.tree_map(jnp.asarray, trees["av"])
        ref_v, ref_a = _jax_loop("av", jpa, JAV, AV_LOOP, loop_inputs, 2)
        assert_close(out["av"][0], ref_v, msg="SP AV loop video")
        assert_close(out["av"][1], ref_a, msg="SP AV loop audio")


def _fake_seq_mesh(n: int = 2) -> Mesh:
    """A mesh whose seq axis has n ranks and no group: enough for the
    refusals, which come before any exchange."""
    return Mesh({"data": 1, "seq": n, "model": 1}, {"seq": Axis("seq", n, 0, tuple(range(n)), None, "gloo")}, 0,
                tuple(range(n)), True)


def test_sp_refusals_carry_the_jax_messages(trees):
    """Indivisible token counts, a token mask and text-KV caching under SP x
    TP are refused as the JAX loops refuse them; masked self-attention
    under SP too; guidance reuse under pipeline parallelism with the JAX
    message; every pipeline takes a sequence mesh and a pipeline mesh, and
    refuses both at once as the JAX package's `mesh_loop_kwargs` does."""
    from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
    from ltx2_tpu_torch.pipelines.common import bucketed_tokens, pad_state_tokens

    cfg = model.LTXModelConfig(**VIDEO)
    dit = dit_from_numpy(trees["video"], cfg)
    tools_state = JTools(JPatchifier(1), JShape(1, 16, 3, 1, 3), fps=24.0).create_initial_state()  # 9 tokens
    state = LatentState(**{f.name: t(np.asarray(getattr(tools_state, f.name))) for f in dataclasses.fields(tools_state)})
    ctx = t(np.zeros((1, 8, 128), np.float32))
    loop = make_video_denoise_loop(cfg, DenoiseLoopConfig(guider=CFGGuider(1.0)), mesh=_fake_seq_mesh(2))
    with pytest.raises(ValueError) as err:
        loop(dit, state, t(LOOP_SIGMAS), ctx, ctx)
    with pytest.raises(ValueError) as jerr:
        jdenoise._check_seq_divisible(9, _jmesh(seq=2), "seq", "video")
    assert str(err.value) == str(jerr.value)
    padded, mask = pad_state_tokens(state, bucketed_tokens(9, 4))
    with pytest.raises(NotImplementedError, match="token_mask"):
        loop(dit, padded, t(LOOP_SIGMAS), ctx, ctx, token_mask=mask)
    with pytest.raises(NotImplementedError, match="pipeline parallelism"):
        make_av_denoise_loop(cfg, DenoiseLoopConfig(guider=CFGGuider(3.0), cfg_interval=2), pipeline_axis="pipe")
    from ltx2_tpu_torch.models.transformer.attention import Attention, AttentionConfig, attention_apply

    acfg = AttentionConfig(query_dim=64, heads=2, dim_head=32, sequence_axis=_fake_seq_mesh(2).axis("seq"))
    with pytest.raises(NotImplementedError, match="masked SELF-attention under sequence parallelism"):
        attention_apply(Attention(acfg), acfg, torch.zeros(1, 4, 64), mask=torch.zeros(1, 1, 1, 4))
    from ltx2_tpu_torch.parallel.sequence_parallel import make_sequence_parallel_forward

    from ltx2_tpu_torch.pipelines import (
        a2vid_two_stage, distilled, ic_lora, keyframe_interpolation, retake, ti2vid_hq, two_stage,
    )

    seq_mesh = _fake_seq_mesh(2)
    for cls in (keyframe_interpolation.KeyframeInterpolationPipeline, two_stage.TwoStagePipeline,
                ti2vid_hq.TI2VidHQPipeline, ic_lora.ICLoraPipeline, a2vid_two_stage.A2VidPipelineTwoStage,
                retake.RetakePipeline):
        assert cls(dit, sequence_mesh=seq_mesh).loop_kwargs == {"mesh": seq_mesh}
        with pytest.raises(ValueError) as err:
            cls(dit, sequence_mesh=seq_mesh, pipeline_mesh=seq_mesh)
        with pytest.raises(ValueError) as jerr:
            jdenoise.mesh_loop_kwargs(_jmesh(seq=2), _jmesh(seq=2))
        assert str(err.value) == str(jerr.value)
    assert distilled.DistilledPipeline(dit, pipeline_mesh=seq_mesh).loop_kwargs == {"mesh": seq_mesh,
                                                                                   "pipeline_axis": "pipe"}
    dit.cfg = dataclasses.replace(cfg, tp_axis=Axis("model", 2, 0, (0, 1), None, "gloo"))
    with pytest.raises(ValueError, match="cache_text_kv is incompatible with SP x TP"):
        make_sequence_parallel_forward(_fake_seq_mesh(2))(dit, None, text_kv={"video": None})


def test_runtime_and_meshes_without_a_process_group():
    """axis_layout's factorisations and refusals are the JAX package's; in a
    one-process world every mesh is a member with size-1 axes and no group,
    shaped as the JAX meshes; a world of one rank without explicit
    arguments starts no process group, and a mesh larger than the world is
    refused."""
    from ltx2_tpu.parallel import runtime as jruntime
    from ltx2_tpu_torch.parallel import runtime
    from ltx2_tpu_torch.parallel.mesh import create_mesh, single_device_mesh

    for args in ((8, 2, 2), (8, 1, 1, 8), (8, 2, 2, 2), (4, 1, 2)):
        assert runtime.axis_layout(*args) == tuple(jruntime.axis_layout(*args))
    for args in ((8, 3), (8, 2, 2, 3)):
        with pytest.raises(ValueError):
            jruntime.axis_layout(*args)
        with pytest.raises(ValueError):
            runtime.axis_layout(*args)
    assert not runtime.initialize_distributed() and runtime.world() == (0, 1)
    for mesh, ref in ((single_device_mesh(), jmesh.single_device_mesh()),
                      (create_mesh(data=1, model=1), _jmesh())):
        assert mesh.member and mesh.shape == dict(ref.shape) and mesh.axis_names == tuple(ref.axis_names)
        assert mesh.axis("seq").size == 1 and mesh.axis("model").group is None
    with pytest.raises(ValueError, match="does not match 1 ranks"):
        create_mesh(seq=2, model=1)
