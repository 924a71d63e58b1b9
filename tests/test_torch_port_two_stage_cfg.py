"""The port's two-stage CFG pipeline against ltx2_tpu, in float32 on the
CPU, on the same numpy-drawn weights, contexts and noise:

- `MultiModalGuider.calculate` over CFG / STG / modality / rescale
  combinations at batch 2, the std-ratio rescale per sample (one clip's
  variance does not move the other's guidance);
- `make_multimodal_av_denoise_loop` on the 2-layer AV parity DiT: the
  default three rows, with STG, guidance reuse (`cfg_interval=2`),
  `skip_step=1` and batch 2;
- `TwoStagePipeline(skip_decode=True)` video-only under the rescaled CFG
  and with the audio stream, a tiny distilled LoRA fused for stage 2: the
  latents, and the DiT's weights after the unfuse equal to the JAX
  pipeline's;
- the LoRA repair: `fuse_lora_into_params(return_deltas=True)` hands back
  LoRA terms (host tensors), not deltas, and the unfuse leaves the weights
  the JAX package's fuse and unfuse leave;
- the CLI: the %64 rounding, `--steps-stage1` / `--cfg-stage1`, the refusal
  of `--distilled-lora` with `--fp8-serving`, and a run from tiny files.

Tolerance: RTOL (1e-4 of the reference's largest magnitude,
tests/torch_port_util.py), the two packages summing in different orders.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import guiders as jguiders
from ltx2_tpu.components import patchifiers as jpatch
from ltx2_tpu.components import perturbations as jpert
from ltx2_tpu.components.noisers import _blend as jblend
from ltx2_tpu.conditioning import tools as jtools
from ltx2_tpu.loader import lora as jlora
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.pipelines import two_stage as jtwo_stage
from ltx2_tpu import types as jtypes
from ltx2_tpu_torch import generate, types
from ltx2_tpu_torch.components import guiders, patchifiers
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.conditioning import tools
from ltx2_tpu_torch.loader import lora
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, spatial_upscaler_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from ltx2_tpu_torch.pipelines import denoise, two_stage
from tests.torch_port_util import (
    CFG, assert_bitwise, assert_close, jax_leaves, port_leaves, random_tree, stacked_dit_tree, t,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# The small AV DiT: 2 layers; video 2 heads x 32, audio 2 heads x 16; 16
# latent channels each (audio: 4 channels x 4 mel bins); V1 caption
# projections from 24 channels.
AV = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
          cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
          audio_out_channels=16, caption_channels=24)
AUDIO = dict(audio_vae_channels=4, audio_mel_bins=4)
FPS = 24.0


@pytest.fixture(scope="module")
def av():
    cfg = model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo, **AV)
    jcfg = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, remat=False, **AV)
    tree = stacked_dit_tree(cfg, seed=31)
    return cfg, jcfg, tree


# ---- MultiModalGuider ----------------------------------------------------------

GUIDER_CASES = {
    "cfg": dict(cfg_scale=3.0),
    "cfg_mod": dict(cfg_scale=3.0, modality_scale=3.0),
    "cfg_stg_mod_rescale": dict(cfg_scale=3.0, stg_scale=1.0, modality_scale=2.0, rescale_scale=0.7),
    "mod_rescale": dict(modality_scale=3.0, rescale_scale=0.5),
}


@pytest.mark.parametrize("case", sorted(GUIDER_CASES))
def test_multimodal_guider_matches_jax(case):
    kwargs = GUIDER_CASES[case]
    rng = np.random.default_rng(1)
    rows = [rng.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(4)]
    rows[0][1] *= 10.0  # the second clip 10x the first: a shared variance would couple them
    jg = jguiders.MultiModalGuider(jguiders.MultiModalGuiderParams(**kwargs))
    g = guiders.MultiModalGuider(guiders.MultiModalGuiderParams(**kwargs))
    present = [True, "cfg_scale" in kwargs, "stg_scale" in kwargs, "modality_scale" in kwargs]
    jargs = [jnp.asarray(r) if on else None for r, on in zip(rows, present)]
    args = [t(r) if on else None for r, on in zip(rows, present)]
    ref = jg.calculate(*jargs)
    out = g.calculate(*args)
    assert_close(out, ref, msg=case)
    # Per sample: clip 0's result does not depend on clip 1's rows.
    alone = g.calculate(*[None if a is None else a[:1] for a in args])
    assert_close(out[:1], alone.numpy(), rtol=1e-6, msg=f"{case} per-sample")
    assert g.do_unconditional_generation() == jg.do_unconditional_generation()
    assert g.do_isolated_modality_generation() == jg.do_isolated_modality_generation()


def test_multimodal_guider_skip_step():
    for skip in (0, 1, 2):
        jg = jguiders.MultiModalGuider(jguiders.MultiModalGuiderParams(skip_step=skip))
        g = guiders.MultiModalGuider(guiders.MultiModalGuiderParams(skip_step=skip))
        assert [g.should_skip_step(i) for i in range(7)] == [jg.should_skip_step(i) for i in range(7)]


# ---- The multi-modal loop ------------------------------------------------------

SIGMAS = np.array([1.0, 0.909375, 0.725, 0.421875, 0.0], np.float32)
VIDEO_SHAPE = (2, 2, 2)  # latent frames, height, width: 8 tokens
AUDIO_FRAMES = 9
LOOP_CASES = {
    "default": {},
    "stg": dict(stg_scale=1.0, stg_blocks=(1,), rescale_scale=0.7),
    "cfg_interval_2": dict(cfg_interval=2, rescale_scale=0.7),
    "skip_step_1": dict(skip_step=1),
    "batch_2": dict(rescale_scale=0.7),
}


def _states(batch: int, noise_v: np.ndarray, noise_a: np.ndarray):
    """Both packages' noised initial video and audio states."""
    vshape, ashape = (batch, 16, *VIDEO_SHAPE), (batch, 4, AUDIO_FRAMES, 4)
    jv = jtools.VideoLatentTools(jpatch.VideoLatentPatchifier(1), jtypes.VideoLatentShape(*vshape), fps=FPS)
    ja = jtools.AudioLatentTools(jpatch.AudioPatchifier(1), jtypes.AudioLatentShape(*ashape))
    pv = tools.VideoLatentTools(patchifiers.VideoLatentPatchifier(1), types.VideoLatentShape(*vshape), fps=FPS)
    pa = tools.AudioLatentTools(patchifiers.AudioPatchifier(1), types.AudioLatentShape(*ashape))
    noiser = GaussianNoiser()
    return ((jblend(jv.create_initial_state(), jnp.asarray(noise_v), 1.0),
             jblend(ja.create_initial_state(), jnp.asarray(noise_a), 1.0)),
            (noiser(None, pv.create_initial_state(), 1.0, noise=t(noise_v)),
             noiser(None, pa.create_initial_state(), 1.0, noise=t(noise_a))))


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_multimodal_loop_matches_jax(av, case):
    cfg, jcfg, tree = av
    opts = LOOP_CASES[case]
    batch = 2 if case == "batch_2" else 1
    rng = np.random.default_rng(7)
    noise_v = rng.standard_normal((batch, 8, 16)).astype(np.float32)
    noise_a = rng.standard_normal((batch, AUDIO_FRAMES, 16)).astype(np.float32)
    ctx = [(rng.standard_normal((batch, 6, 24)) * 0.5).astype(np.float32) for _ in range(4)]
    (jv, ja), (pv, pa) = _states(batch, noise_v, noise_a)
    mm = denoise.MultiModalLoopConfig(**opts)
    jmm = jdenoise.MultiModalLoopConfig(**opts)
    assert mm.rows == jmm.rows == 3 + int("stg_scale" in opts)
    port = dit_from_numpy(tree, cfg)
    out_v, out_a = denoise.make_multimodal_av_denoise_loop(cfg, mm)(port, pv, pa, t(SIGMAS), *(t(c) for c in ctx))
    ref_v, ref_a = jdenoise.make_multimodal_av_denoise_loop(jcfg, jmm)(
        jax.tree_util.tree_map(jnp.asarray, tree), jv, ja, jnp.asarray(SIGMAS), *(jnp.asarray(c) for c in ctx))
    assert np.isfinite(out_v.latent.numpy()).all() and np.isfinite(out_a.latent.numpy()).all()
    assert_close(out_v.latent, ref_v.latent, msg=f"{case} video")
    assert_close(out_a.latent, ref_a.latent, msg=f"{case} audio")
    if case == "default":  # the per-row timesteps of a promised all-ones mask compute the same
        uniform = denoise.make_multimodal_av_denoise_loop(cfg, dataclasses.replace(mm, uniform_timesteps=True))
        u_v, u_a = uniform(port, pv, pa, t(SIGMAS), *(t(c) for c in ctx))
        assert_close(u_v.latent, ref_v.latent, msg="uniform video")
        assert_close(u_a.latent, ref_a.latent, msg="uniform audio")


def test_multimodal_rows_and_refusals():
    mm = denoise.MultiModalLoopConfig(stg_scale=1.0, stg_blocks=(0,))
    perturb = denoise._build_mm_perturbations(mm, batch=2)
    jperturb = jdenoise._build_mm_perturbations(jdenoise.MultiModalLoopConfig(stg_scale=1.0, stg_blocks=(0,)),
                                                batch=2)
    names = ("SKIP_VIDEO_SELF_ATTN", "SKIP_A2V_CROSS_ATTN", "SKIP_V2A_CROSS_ATTN", "SKIP_AUDIO_SELF_ATTN")
    for name in names:
        for block in (0, 1):
            got = perturb.mask(getattr(denoise.PerturbationType, name), block).tolist()
            ref = np.asarray(jperturb.mask(getattr(jpert.PerturbationType, name), block)).tolist()
            assert got == ref, (name, block)
    # Rows are [cond, uncond, stg, mod] x 2, pass-major.
    assert perturb.mask(denoise.PerturbationType.SKIP_A2V_CROSS_ATTN, 1).tolist() == [1, 1, 1, 1, 1, 1, 0, 0]
    assert denoise._build_mm_perturbations(denoise.MultiModalLoopConfig(), with_guidance=False) is None
    # The combine over a full step's rows (batch 2, pass-major), a skipped step is cond alone.
    outs = np.random.default_rng(12).standard_normal((8, 5, 16)).astype(np.float32)
    jmm = jdenoise.MultiModalLoopConfig(stg_scale=1.0, stg_blocks=(0,), rescale_scale=0.7)
    mm = denoise.MultiModalLoopConfig(stg_scale=1.0, stg_blocks=(0,), rescale_scale=0.7)
    assert_close(denoise._mm_combine(mm, t(outs), 3.0, False, batch=2),
                 jdenoise._mm_combine(jmm, jnp.asarray(outs), 3.0, jnp.float32(0.0), batch=2), msg="combine")
    assert torch.equal(denoise._mm_combine(mm, t(outs), 3.0, True, batch=2), t(outs[:2]))
    with pytest.raises(ValueError, match="cfg_interval"):
        denoise.make_multimodal_av_denoise_loop(CFG, denoise.MultiModalLoopConfig(cfg_interval=0))
    with pytest.raises(NotImplementedError, match="parallelism"):
        denoise.make_multimodal_av_denoise_loop(CFG, denoise.MultiModalLoopConfig(), mesh=object())


# ---- The LoRA ------------------------------------------------------------------

def _lora_file(path, cfg, rank: int = 2, seed: int = 3, scale: float = 0.05) -> str:
    """A LoRA on every linear weight of every block of `cfg`'s DiT."""
    rng = np.random.default_rng(seed)
    from ltx2_tpu_torch.loader.export import inverse_rewrite

    w = {}
    for name, p in model.LTXModel(cfg, device="meta").named_parameters():
        if name.startswith("transformer_blocks.") and name.endswith(".weight") and p.ndim == 2:
            base = "diffusion_model." + inverse_rewrite(name)[: -len(".weight")]
            out_f, in_f = p.shape
            w[f"{base}.lora_A.weight"] = (rng.standard_normal((rank, in_f)) * scale).astype(np.float32)
            w[f"{base}.lora_B.weight"] = (rng.standard_normal((out_f, rank)) * scale).astype(np.float32)
    jst.write_safetensors(path, w)
    return path


def test_lora_unfuse_makes_deltas_again(av, tmp_path):
    """The repair: no delta is returned (the unfuse makes each again from
    the LoRA's host tensors), the unfused weights equal the JAX package's
    fuse-then-unfuse weights, and the recomputed delta is the fused one bit
    for bit."""
    cfg, jcfg, tree = av
    path = _lora_file(str(tmp_path / "lora.safetensors"), cfg)
    port = dit_from_numpy(tree, cfg)
    before = {k: v.clone() for k, v in port_leaves(port).items()}
    _, applied = lora.fuse_lora_into_params(port, [lora.LoRAConfig(path, 0.8)], return_deltas=True)
    fused = {k: v.clone() for k, v in port_leaves(port).items()}
    tensors = [x for terms in applied.values() for alias in terms for term in alias for x in term
               if isinstance(x, torch.Tensor)]
    assert not tensors  # terms: (the file's host dict, key A, key B, strength), no delta
    held = {id(w) for terms in applied.values() for alias in terms for w, *_ in alias}
    assert all(all(x.device.type == "cpu" for x in w.values()) for terms in applied.values()
               for alias in terms for w, *_ in alias) and len(held) == 1
    assert len(applied) == sum(1 for n, p in port.named_parameters() if n.startswith("transformer_blocks.")
                               and n.endswith(".weight") and p.ndim == 2)
    lora.unfuse_lora_deltas(port, applied)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jparams, japplied = jlora.fuse_lora_into_params(jparams, [jlora.LoRAConfig(path, 0.8)], return_deltas=True)
    jparams = jlora.unfuse_lora_deltas(jparams, japplied)
    ref = jax_leaves(jparams)
    for name, leaf in port_leaves(port).items():
        if name in applied:
            delta = lora._delta(applied[name][0])
            assert torch.equal(fused[name] - delta, leaf), name  # the fused delta, subtracted
            assert_close(leaf, ref[name], rtol=1e-6, msg=name)
            assert (leaf - before[name]).abs().max() <= 2.0 ** -22 * fused[name].abs().max(), name
        else:
            assert_bitwise(leaf, ref[name], name)


# ---- The pipeline --------------------------------------------------------------

UP = dict(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
HEIGHT, WIDTH, FRAMES, SEED = 64, 64, 9, 17
VIDEO_ONLY = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
                  cross_attention_dim=64, compute_dtype="float32")


@pytest.mark.parametrize("kind", ["video_rescaled", "av"])
def test_two_stage_pipeline_matches_jax(av, tmp_path, kind):
    """Stage 1 (3 steps; video-only under RescaledCFGGuider at 0.7, AV under
    the multi-modal loop with the rescale), the upscaler, a rank-2 LoRA on
    every block linear fused for stage 2 and unfused: both latents and
    every DiT weight after the unfuse against the JAX pipeline's, each
    stage's noise from the JAX keys (PRNGKey(seed) -> split 5)."""
    if kind == "av":
        cfg, jcfg, tree = av
    else:
        cfg = model.LTXModelConfig(**VIDEO_ONLY)
        jcfg = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None, remat=False,
                                     **VIDEO_ONLY)
        tree = stacked_dit_tree(cfg, seed=32)
    audio = kind == "av"
    width = 24 if audio else 64
    path = _lora_file(str(tmp_path / "lora.safetensors"), cfg, seed=4)
    up_tree = random_tree(SpatialUpscaler(SpatialUpscalerConfig(**UP), device="meta"), 33)
    stats = {"mean_of_means": np.linspace(-0.2, 0.2, 16, dtype=np.float32),
             "std_of_means": np.linspace(0.8, 1.2, 16, dtype=np.float32)}
    rng = np.random.default_rng(8)
    ctx = [(rng.standard_normal((1, 6, w)) * 0.5).astype(np.float32) for w in (width,) * 2 + (24, 24)]
    common = dict(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, fps=FPS, num_inference_steps=3,
                  guidance_rescale=0.7, latent_channels=16, audio_enabled=audio, **(AUDIO if audio else {}))

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jpipe = jtwo_stage.TwoStagePipeline(
        transformer_params=jparams, transformer_cfg=jcfg,
        video_decoder_params={"per_channel_statistics": jax.tree_util.tree_map(jnp.asarray, stats)},
        spatial_upscaler_params=jax.tree_util.tree_map(jnp.asarray, up_tree),
        spatial_upscaler_cfg=jspatial.SpatialUpscalerConfig(**UP))
    jconfig = jtwo_stage.TwoStageCFGConfig(dtype="float32", distilled_lora_config=jlora.LoRAConfig(path, 0.7),
                                           **common)
    ref_v, ref_a = jpipe(jnp.asarray(ctx[0]), jnp.asarray(ctx[1]), jconfig, skip_decode=True,
                         **(dict(positive_audio_encoding=jnp.asarray(ctx[2]),
                                 negative_audio_encoding=jnp.asarray(ctx[3])) if audio else {}))
    k1, k1a, k2, k2a, _ = jax.random.split(jax.random.PRNGKey(SEED), 5)
    v2, a2 = jax.random.split(k2)

    def normal(key, n):
        return t(np.asarray(jax.random.normal(key, (1, n, 16), jnp.float32)))

    noises = [normal(k1, 2), normal(v2, 8)]
    audio_noises = [normal(k1a, AUDIO_FRAMES), normal(a2, AUDIO_FRAMES)] if audio else None

    port = dit_from_numpy(tree, cfg)
    statistics = PerChannelStatistics(16)
    statistics.mean_of_means.copy_(t(stats["mean_of_means"]))
    statistics.std_of_means.copy_(t(stats["std_of_means"]))
    pipe = two_stage.TwoStagePipeline(port, spatial_upscaler_from_numpy(up_tree, SpatialUpscalerConfig(**UP)),
                                      statistics=statistics)
    config = two_stage.TwoStageCFGConfig(distilled_lora_config=lora.LoRAConfig(path, 0.7), **common)
    phases = []
    out_v, out_a = pipe(t(ctx[0]), t(ctx[1]), config, skip_decode=True, noises=noises, audio_noises=audio_noises,
                        callback=lambda phase, z: phases.append(phase),
                        **(dict(positive_audio_encoding=t(ctx[2]), negative_audio_encoding=t(ctx[3]))
                           if audio else {}))
    assert phases == ["stage1", "upscale", "lora_fuse", "stage2", "lora_unfuse"]
    assert_close(out_v, np.asarray(ref_v), msg=f"{kind} video latent")
    if audio:
        assert tuple(out_a.shape) == (1, 4, AUDIO_FRAMES, 4)
        assert_close(out_a, np.asarray(ref_a), msg=f"{kind} audio latent")
    else:
        assert out_a is None and ref_a is None
    ref = jax_leaves(jpipe.transformer_params)
    restored = 0
    for name, leaf in port_leaves(port).items():
        assert_close(leaf, ref[name], rtol=1e-6, msg=f"restored {name}")
        restored += 1
    assert restored == len(ref)
    # Without the LoRA the latent moves: the LoRA reached stage 2.
    plain_v, _ = pipe(t(ctx[0]), t(ctx[1]), dataclasses.replace(config, distilled_lora_config=None),
                      skip_decode=True, noises=noises, audio_noises=audio_noises,
                      **(dict(positive_audio_encoding=t(ctx[2]), negative_audio_encoding=t(ctx[3]))
                         if audio else {}))
    assert (plain_v - out_v).abs().max() > 1e-4


def test_two_stage_config_checks():
    for kw in (dict(height=96), dict(num_frames=10)):
        with pytest.raises(ValueError):
            two_stage.TwoStageCFGConfig(**kw)
        with pytest.raises(ValueError):
            jtwo_stage.TwoStageCFGConfig(**kw)
    fields = {f.name for f in dataclasses.fields(two_stage.TwoStageCFGConfig)}
    assert {f.name for f in dataclasses.fields(jtwo_stage.TwoStageCFGConfig)} <= fields
    defaults = {f.name: f.default for f in dataclasses.fields(two_stage.TwoStageCFGConfig)}
    for f in dataclasses.fields(jtwo_stage.TwoStageCFGConfig):  # (480 x 704 fails the %64 check in both)
        assert defaults[f.name] == f.default, f.name


# ---- The CLI ------------------------------------------------------------------

def test_two_stage_cli(tmp_path, monkeypatch):
    """--pipeline two-stage from tiny files: the resolution rounded up to
    %64 as the JAX CLI rounds it, --steps-stage1 and --cfg-stage1 reaching
    the config, the LoRA fused and unfused, frames and a .wav out; the
    refusals."""
    from scripts.generate import _round_two_stage_geometry as jround
    from tests.test_torch_port_audio_cli import UPCFG, _write
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors
    from ltx2_tpu_torch.models.upscaler import spatial

    gen = torch.Generator().manual_seed(0)
    ckpt = str(tmp_path / "av.safetensors")
    _write(ckpt, "v1", gen)
    up = str(tmp_path / "up.safetensors")
    write_safetensors(up, spatial.upscaler_to_checkpoint(spatial.init_spatial_upscaler_(
        spatial.SpatialUpscaler(UPCFG), gen)))
    from tests.test_torch_port_audio_cli import AV as FILE_AV
    path = _lora_file(str(tmp_path / "lora.safetensors"), FILE_AV, seed=5)
    seen = {}
    call = two_stage.TwoStagePipeline.__call__

    def record(self, positive, negative, config, **kwargs):
        seen["config"] = config
        return call(self, positive, negative, config, **kwargs)

    monkeypatch.setattr(two_stage.TwoStagePipeline, "__call__", record)
    out = tmp_path / "clip.y4m"
    results, stats = generate.main([
        "--pipeline", "two-stage", "--device", "cpu", "--height", "40", "--width", "64", "--num-frames", "9",
        "--checkpoint", ckpt, "--spatial-upscaler", up, "--audio", "--distilled-lora", path,
        "--distilled-lora-scale", "0.5", "--steps-stage1", "2", "--steps-stage2", "5", "--cfg-stage1", "2.5",
        "--output", str(out)])

    class Args:
        pipeline, height, width = "two-stage", 40, 64

    jround(Args)
    config = seen["config"]
    assert (config.height, config.width) == (Args.height, Args.width) == (64, 64)
    assert config.num_inference_steps == 2 and config.cfg_scale == 2.5 and config.guidance_rescale == 0.7
    assert config.distilled_lora_config == lora.LoRAConfig(path, 0.5)
    frames, wave = results[0]
    assert frames.shape == (9, 64, 64, 3) and wave.shape[0] == 2 and (tmp_path / "clip.wav").exists()
    st = stats[0]
    for phase in ("stage1", "upscale", "lora_fuse", "stage2", "lora_unfuse"):
        assert f"{phase}_s" in st, phase
    assert st["stage1_latent_finite"] and st["stage2_latent_finite"]
    for argv in (["--fp8-serving", "--checkpoint", ckpt, "--distilled-lora", path],
                 ["--pipeline", "distilled", "--modality-scale", "2"],
                 ["--pipeline", "one-stage", "--distilled-lora", path]):
        with pytest.raises(SystemExit):
            generate.main(["--pipeline", "two-stage", "--device", "cpu", "--output", str(out), *argv])
