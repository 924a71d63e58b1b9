"""The port's audio-video path against ltx2_tpu on the same numpy-drawn
weights and inputs, in float32 on the CPU: the audio latent shape,
patchifier and tools; the AV block and model (V1 with caption projections,
V2 with cross-attention AdaLN and gates) with per-token timesteps, each
perturbation mask and cached text K/V; the joint denoise loop with CFG on
both streams, STG on the audio and on both streams, guidance reuse and Heun;
the distilled and one-stage pipelines with audio, the JAX package's noise
handed in, through the audio decoder and the vocoder; and the channelwise
noise normalization.

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

from ltx2_tpu.components import patchifiers as jpatch
from ltx2_tpu.components import perturbations as jpert
from ltx2_tpu.conditioning import tools as jtools
from ltx2_tpu.models import audio_vae as jaudio
from ltx2_tpu.models.transformer import blocks as jblocks
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.pipelines import distilled as jdistilled
from ltx2_tpu.pipelines import one_stage as jone_stage
from ltx2_tpu import types as jtypes
from ltx2_tpu_torch import types
from ltx2_tpu_torch.components import patchifiers, perturbations
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.conditioning import tools
from ltx2_tpu_torch.loader.from_numpy import (
    audio_decoder_from_numpy, dit_from_numpy, spatial_upscaler_from_numpy, vocoder_from_numpy,
)
from ltx2_tpu_torch.models import audio_vae
from ltx2_tpu_torch.models.transformer import blocks, model
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from ltx2_tpu_torch.pipelines import distilled, one_stage
from ltx2_tpu_torch.pipelines.common import decode_audio
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_av_denoise_loop
from tests.torch_port_util import assert_close, make_guiders, random_tree, stacked_dit_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# The small AV DiT: 2 layers; video 2 heads x 32, audio 2 heads x 16; 16
# latent channels each (audio: 4 channels x 4 mel bins).
AV = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
          cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
          audio_out_channels=16)
VERSIONS = {"v1": dict(caption_channels=24),
            "v2": dict(caption_channels=None, cross_attention_adaln=True, apply_gated_attention=True)}
VIDEO_SHAPE = (1, 16, 2, 2, 2)  # 8 tokens
AUDIO = dict(audio_vae_channels=4, audio_mel_bins=4)
FRAMES, FPS = 9, 24.0  # 9 / 24 s: 9 audio latent frames
AUDIO_SHAPE = (1, 4, 9, 4)


def configs(version):
    extra = VERSIONS[version]
    return (model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo, **AV, **extra),
            jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, remat=False, **AV, **extra))


def context_widths(cfg):
    return (cfg.caption_channels or cfg.video_inner_dim, cfg.caption_channels or cfg.audio_inner_dim)


@pytest.fixture(scope="module", params=sorted(VERSIONS))
def weights(request):
    cfg, jcfg = configs(request.param)
    tree = stacked_dit_tree(cfg, seed=11)
    return request.param, cfg, jcfg, jax.tree_util.tree_map(jnp.asarray, tree), dit_from_numpy(tree, cfg)


def _states(rows: int = 1):
    """Both packages' initial video and audio states (positions held bitwise)."""
    vshape = (rows,) + VIDEO_SHAPE[1:]
    ashape = (rows,) + AUDIO_SHAPE[1:]
    jv = jtools.VideoLatentTools(jpatch.VideoLatentPatchifier(1), jtypes.VideoLatentShape(*vshape), fps=FPS)
    ja = jtools.AudioLatentTools(jpatch.AudioPatchifier(1), jtypes.AudioLatentShape(*ashape))
    pv = tools.VideoLatentTools(patchifiers.VideoLatentPatchifier(1), types.VideoLatentShape(*vshape), fps=FPS)
    pa = tools.AudioLatentTools(patchifiers.AudioPatchifier(1), types.AudioLatentShape(*ashape))
    return (jv.create_initial_state(), ja.create_initial_state()), (pv.create_initial_state(),
                                                                     pa.create_initial_state())


def test_audio_shape_patchifier_and_tools():
    pixel = types.VideoPixelShape(1, 121, 512, 768, 24.0)
    jpixel = jtypes.VideoPixelShape(1, 121, 512, 768, 24.0)
    assert types.AudioLatentShape.from_video_pixel_shape(pixel) == (1, 8, 126, 16)
    assert tuple(jtypes.AudioLatentShape.from_video_pixel_shape(jpixel)) == (1, 8, 126, 16)
    shape = types.AudioLatentShape(2, 8, 126, 16)
    pos = patchifiers.AudioPatchifier(1).get_patch_grid_bounds(shape)
    ref = jpatch.AudioPatchifier(1).get_patch_grid_bounds(jtypes.AudioLatentShape(2, 8, 126, 16))
    assert pos.dtype == torch.float32 and np.array_equal(pos.numpy(), np.asarray(ref))
    x = np.random.default_rng(0).standard_normal((2, 8, 126, 16)).astype(np.float32)
    p = patchifiers.AudioPatchifier(1)
    np.testing.assert_array_equal(p.patchify(t(x)).numpy(), np.asarray(jpatch.AudioPatchifier(1).patchify(x)))
    np.testing.assert_array_equal(p.unpatchify(p.patchify(t(x)), shape).numpy(), x)
    (jv, ja), (pv, pa) = _states(2)
    for got, ref in ((pv, jv), (pa, ja)):
        for field in ("latent", "denoise_mask", "positions", "clean_latent"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), field)
    ptools = tools.AudioLatentTools(p, shape)
    state = ptools.create_initial_state(initial_latent=t(x))
    np.testing.assert_array_equal(ptools.unpatchify(ptools.clear_conditioning(state)).latent.numpy(), x)


def _modalities(cfg, rows: int, per_token: bool, seed: int, same_rows: bool = False):
    """(JAX (video, audio) Modality, port's) on numpy-drawn latents,
    contexts and timesteps (per token: each token its own)."""
    rng = np.random.default_rng(seed)
    (jv, ja), (pv, pa) = _states(rows)
    vw, aw = context_widths(cfg)
    n = 1 if same_rows else rows

    def draw(shape):
        x = rng.standard_normal((n,) + shape).astype(np.float32)
        return np.concatenate([x] * (rows // n))

    out_j, out_p = [], []
    for (js, ps, width, tokens) in ((jv, pv, vw, 8), (ja, pa, aw, 9)):
        latent = draw((tokens, 16))
        context = draw((6, width)) * 0.5
        sigma = np.full((rows,), 0.7, np.float32)
        timesteps = (np.concatenate([rng.uniform(0.2, 1.0, (1, tokens)).astype(np.float32)] * rows)
                     if per_token else sigma)
        out_j.append(jmodel.Modality(latent=jnp.asarray(latent), context=jnp.asarray(context), context_mask=None,
                                     timesteps=jnp.asarray(timesteps), positions=js.positions,
                                     sigma=jnp.asarray(sigma)))
        out_p.append(model.Modality(latent=t(latent), context=t(context), context_mask=None, timesteps=t(timesteps),
                                    positions=ps.positions, sigma=t(sigma)))
    return out_j, out_p


@pytest.mark.parametrize("per_token", [False, True], ids=["uniform", "per_token"])
def test_av_model_matches_jax(weights, per_token):
    version, cfg, jcfg, jp, port = weights
    (jv, ja), (pv, pa) = _modalities(cfg, 2, per_token, seed=1)
    ref_v, ref_a = jmodel.x0_model_apply(jp, jcfg, video=jv, audio=ja)
    out_v, out_a = model.x0_model_apply(port, pv, audio=pa)
    assert_close(out_v, ref_v, msg=f"{version} video x0")
    assert_close(out_a, ref_a, msg=f"{version} audio x0")


def test_av_block_matches_jax(weights):
    """Block 1 alone on the same stream args, the args themselves held
    against the JAX package's (cross-modal RoPE and AdaLN embeddings)."""
    version, cfg, jcfg, jp, port = weights
    (jv, ja), (pv, pa) = _modalities(cfg, 1, True, seed=2)
    jvargs, jaargs, _, _ = jmodel.prepare_stream_args(jp, jcfg, video=jv, audio=ja)
    pvargs, paargs = model.prepare_av_args(port, pv, pa)
    for got, ref in ((pvargs, jvargs), (paargs, jaargs)):
        for field in ("x", "context", "timesteps", "cross_scale_shift_timestep", "cross_gate_timestep"):
            assert_close(getattr(got, field), getattr(ref, field), msg=f"{version} {field}")
        for i in range(2):
            assert_close(got.pe[i], ref.pe[i], msg="pe")
            assert_close(got.cross_pe[i], ref.cross_pe[i], msg="cross_pe")
    block1 = jax.tree_util.tree_map(lambda x: x[1], jp["transformer_blocks"])
    jout_v, jout_a = jblocks.av_block_apply(block1, jvargs, jaargs, jcfg.video_stream_config(),
                                            jcfg.audio_stream_config())
    pout_v, pout_a = blocks.joint_block_apply(port.transformer_blocks[1], pvargs, paargs, cfg.video_stream_config(),
                                              cfg.audio_stream_config())
    assert_close(pout_v.x, jout_v.x, msg=f"{version} block video")
    assert_close(pout_a.x, jout_a.x, msg=f"{version} block audio")


PERTURB = {"video_self": "SKIP_VIDEO_SELF_ATTN", "audio_self": "SKIP_AUDIO_SELF_ATTN",
           "a2v": "SKIP_A2V_CROSS_ATTN", "v2a": "SKIP_V2A_CROSS_ATTN"}


@pytest.mark.parametrize("kind", sorted(PERTURB))
def test_av_model_perturbation_masks(weights, kind):
    """Row 1 of two identical rows skips one attention in block 1: both
    packages agree, and the skip moves that row."""
    version, cfg, jcfg, jp, port = weights

    def batched(pkg):
        skip = pkg.PerturbationConfig(perturbations=(pkg.Perturbation(
            type=getattr(pkg.PerturbationType, PERTURB[kind]), blocks=(1,)),))
        return pkg.BatchedPerturbationConfig(perturbations=(pkg.PerturbationConfig.empty(), skip))

    (jv, ja), (pv, pa) = _modalities(cfg, 2, False, seed=3, same_rows=True)
    ref_v, ref_a = jmodel.x0_model_apply(jp, jcfg, video=jv, audio=ja, perturbations=batched(jpert))
    out_v, out_a = model.x0_model_apply(port, pv, audio=pa, perturbations=batched(perturbations))
    assert_close(out_v, ref_v, msg=f"{version} {kind} video")
    assert_close(out_a, ref_a, msg=f"{version} {kind} audio")
    moved = (out_v[1] - out_v[0]).abs().max() + (out_a[1] - out_a[0]).abs().max()
    assert moved > 1e-4, kind


def test_av_model_cached_text_kv():
    cfg, jcfg = configs("v1")
    tree = stacked_dit_tree(cfg, seed=12)
    jp, port = jax.tree_util.tree_map(jnp.asarray, tree), dit_from_numpy(tree, cfg)
    (jv, ja), (pv, pa) = _modalities(cfg, 1, False, seed=4)
    jkv = jmodel.precompute_text_kv(jp, jcfg, video_context=jv.context, audio_context=ja.context)
    kv = model.precompute_text_kv(port, pv.context, pa.context)
    for name in ("video", "audio"):
        for i in range(2):
            assert_close(kv[name][i], jkv[name][i], msg=f"{name} kv")
    ref_v, ref_a = jmodel.x0_model_apply(jp, jcfg, video=jv, audio=ja, text_kv=jkv)
    out_v, out_a = model.x0_model_apply(port, pv, audio=pa, text_kv=kv)
    plain_v, plain_a = model.x0_model_apply(port, pv, audio=pa)
    assert_close(out_v, ref_v, msg="cached video")
    assert_close(out_a, ref_a, msg="cached audio")
    assert_close(out_v, plain_v.numpy(), msg="cached vs computed video")
    assert_close(out_a, plain_a.numpy(), msg="cached vs computed audio")


SIGMAS = np.array([1.0, 0.909375, 0.421875, 0.0], np.float32)
CFG3, CFG5, OFF = ("CFGGuider", {"scale": 3.0}), ("CFGGuider", {"scale": 5.0}), ("CFGGuider", {"scale": 1.0})
STAR = ("CFGStarRescalingGuider", {"scale": 3.0})
# case -> (video guider, audio guider, loop options)
LOOP_CASES = {
    "cfg_both_streams": (CFG3, CFG5, {}),
    "stg_audio": (STAR, ("CFGStarRescalingGuider", {"scale": 7.0}), {"stg_scale": 1.0, "stg_mode": "audio"}),
    "stg_both": (OFF, OFF, {"stg_scale": 1.0, "stg_mode": "both", "stg_blocks": (1,)}),
    "cfg_interval_2": (STAR, ("CFGStarRescalingGuider", {"scale": 7.0}), {"cfg_interval": 2}),
    "heun": (CFG3, CFG5, {"sampler": "heun", "ge_gamma": 0.5}),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_av_denoise_loop_matches_jax(weights, case):
    version, cfg, jcfg, jp, port = weights
    (vg, ag, opts) = LOOP_CASES[case]
    (jvg, pvg), (jag, pag) = make_guiders(vg), make_guiders(ag)
    rng = np.random.default_rng(6)
    vnoise = rng.standard_normal((1, 8, 16)).astype(np.float32)
    anoise = rng.standard_normal((1, 9, 16)).astype(np.float32)
    vw, aw = context_widths(cfg)
    ctx = [(rng.standard_normal((1, 6, w)) * 0.5).astype(np.float32) for w in (vw, vw, aw, aw)]
    (jv, ja), (pv, pa) = _states()
    noiser = GaussianNoiser()
    pv, pa = noiser(None, pv, 1.0, noise=t(vnoise)), noiser(None, pa, 1.0, noise=t(anoise))
    loop = make_av_denoise_loop(cfg, DenoiseLoopConfig(guider=pvg, audio_guider=pag, uniform_timesteps=True, **opts))
    out_v, out_a = loop(port, pv, pa, t(SIGMAS), *(t(c) for c in ctx))
    from ltx2_tpu.components.noisers import _blend as jblend

    jv, ja = jblend(jv, jnp.asarray(vnoise), 1.0), jblend(ja, jnp.asarray(anoise), 1.0)
    jloop = jdenoise.make_av_denoise_loop(jcfg, jdenoise.DenoiseLoopConfig(
        guider=jvg, audio_guider=jag, uniform_timesteps=True, **opts))
    ref_v, ref_a = jloop(jp, jv, ja, jnp.asarray(SIGMAS), *(jnp.asarray(c) for c in ctx))
    assert np.isfinite(out_v.latent.numpy()).all() and np.isfinite(out_a.latent.numpy()).all()
    assert_close(out_v.latent, ref_v.latent, msg=f"{version} {case} video")
    assert_close(out_a.latent, ref_a.latent, msg=f"{version} {case} audio")


def test_channelwise_normalize_audio_population_std():
    """jnp.std is the population std: on 3 tokens the unbiased one would
    differ by sqrt(3 / 2)."""
    x = np.random.default_rng(7).standard_normal((1, 3, 5)).astype(np.float32) * 3 + 1
    ref = jdistilled.channelwise_normalize_audio(jnp.asarray(x))
    out = distilled.channelwise_normalize_audio(t(x))
    assert_close(out, ref, msg="channelwise normalization")
    assert abs(float(out[0, :, 0].std(correction=0)) - 1.0) < 1e-5


# The audio decoder and vocoder of the pipeline tests: 3 levels, 4 latent
# channels x 4 mel bins -> stereo 16-bin mels; a one-stage x4 vocoder.
ADEC = dict(ch=8, ch_mult=(1, 1, 2), num_res_blocks=1, z_channels=4, mel_bins=4)
AVOC = dict(resblock_kernel_sizes=(3,), upsample_rates=(4,), upsample_kernel_sizes=(8,),
            resblock_dilation_sizes=((1, 3),), upsample_initial_channel=16, in_channels_override=32)
UP = dict(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)


@pytest.fixture(scope="module")
def audio_modules():
    dec_tree = random_tree(audio_vae.AudioDecoder(audio_vae.AudioDecoderConfig(**ADEC), device="meta"), 21)
    voc_tree = random_tree(audio_vae.Vocoder(audio_vae.VocoderConfig(**AVOC), device="meta"), 22)
    port = (audio_decoder_from_numpy(dec_tree, audio_vae.AudioDecoderConfig(**ADEC)),
            vocoder_from_numpy(voc_tree, audio_vae.VocoderConfig(**AVOC)))
    return dec_tree, voc_tree, port


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_av_distilled_pipeline_matches_jax(weights, audio_modules):
    """Both stages with the audio stream (stage 1's audio carried into
    stage 2), each stage's video and audio noise from the JAX keys, then
    the audio decoder and vocoder."""
    version, cfg, jcfg, jp, port = weights
    dec_tree, voc_tree, (adec, voc) = audio_modules
    up_tree = random_tree(SpatialUpscaler(SpatialUpscalerConfig(**UP), device="meta"), 23)
    stats = {"mean_of_means": np.linspace(-0.2, 0.2, 16, dtype=np.float32),
             "std_of_means": np.linspace(0.8, 1.2, 16, dtype=np.float32)}
    vw, aw = context_widths(cfg)
    rng = np.random.default_rng(8)
    context = (rng.standard_normal((1, 6, vw)) * 0.5).astype(np.float32)
    audio_context = None if version == "v1" else (rng.standard_normal((1, 6, aw)) * 0.5).astype(np.float32)
    from ltx2_tpu.models.upscaler import spatial as jspatial

    jpipe = jdistilled.DistilledPipeline(
        transformer_params=jp, transformer_cfg=jcfg, video_decoder_params={"per_channel_statistics": _jtree(stats)},
        spatial_upscaler_params=_jtree(up_tree), spatial_upscaler_cfg=jspatial.SpatialUpscalerConfig(**UP),
        audio_decoder_params=_jtree(dec_tree), audio_decoder_cfg=jaudio.AudioDecoderConfig(**ADEC),
        vocoder_params=_jtree(voc_tree), vocoder_cfg=jaudio.VocoderConfig(**AVOC))
    seed = 13
    jconfig = jdistilled.DistilledConfig(height=64, width=64, num_frames=FRAMES, seed=seed, dtype="float32",
                                         latent_channels=16, audio_enabled=True, **AUDIO)
    ref_v, ref_a = jpipe(jnp.asarray(context), None, jconfig, skip_decode=True,
                         audio_encoding=None if audio_context is None else jnp.asarray(audio_context))
    ref_wave = jpipe._decode_audio(ref_a)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    keys = [jax.random.split(k) for k in (k1, k2)]
    noises = [t(np.asarray(jax.random.normal(k[0], (1, n, 16), jnp.float32))) for k, n in zip(keys, (2, 8))]
    audio_noises = [t(np.asarray(jax.random.normal(k[1], (1, 9, 16), jnp.float32))) for k in keys]

    statistics = PerChannelStatistics(16)
    statistics.mean_of_means.copy_(t(stats["mean_of_means"]))
    statistics.std_of_means.copy_(t(stats["std_of_means"]))
    pipe = distilled.DistilledPipeline(port, spatial_upscaler_from_numpy(up_tree, SpatialUpscalerConfig(**UP)),
                                       statistics=statistics, audio_decoder=adec, vocoder=voc)
    config = distilled.DistilledConfig(height=64, width=64, num_frames=FRAMES, seed=seed, latent_channels=16,
                                       audio_enabled=True, **AUDIO)
    out_v, out_a = pipe(t(context), config, skip_decode=True, noises=noises, audio_noises=audio_noises,
                        audio_encoding=None if audio_context is None else t(audio_context))
    assert tuple(out_a.shape) == (1, 4, 9, 4)
    assert_close(out_v, ref_v, msg=f"{version} distilled video latent")
    assert_close(out_a, ref_a, msg=f"{version} distilled audio latent")
    wave = decode_audio(out_a, adec, voc)
    assert tuple(wave.shape) == (1, 2, (4 * 9 - 3) * 4)
    assert_close(wave, ref_wave, msg=f"{version} waveform")
    # Without the internal audio branch (and no audio asked for) the AV DiT
    # runs its video stream alone, as the JAX pipeline does.
    off = dict(use_internal_audio_branch=False, audio_enabled=False)
    ref_off = jpipe(jnp.asarray(context), None, dataclasses.replace(jconfig, **off), skip_decode=True)
    out_off = pipe(t(context), dataclasses.replace(config, **off), skip_decode=True, noises=noises)
    assert_close(out_off, np.asarray(ref_off), msg=f"{version} distilled video-only latent")


def test_av_one_stage_pipeline_matches_jax(weights, audio_modules):
    """The one-stage CFG* pipeline with audio: CFG* on both streams (video
    3.0, audio 7.0), 2 steps, the JAX noise; skip_decode, then the audio
    decode."""
    version, cfg, jcfg, jp, port = weights
    dec_tree, voc_tree, (adec, voc) = audio_modules
    vw, aw = context_widths(cfg)
    rng = np.random.default_rng(9)
    ctx = [(rng.standard_normal((1, 6, w)) * 0.5).astype(np.float32) for w in (vw, vw, aw, aw)]
    jpipe = jone_stage.OneStagePipeline(
        jp, jcfg, audio_decoder_params=_jtree(dec_tree), audio_decoder_cfg=jaudio.AudioDecoderConfig(**ADEC),
        vocoder_params=_jtree(voc_tree), vocoder_cfg=jaudio.VocoderConfig(**AVOC))
    seed = 14
    common = dict(height=64, width=64, num_frames=FRAMES, seed=seed, num_inference_steps=2, latent_channels=16,
                  audio_enabled=True, **AUDIO)
    ref_v, ref_a = jpipe(*(jnp.asarray(c) for c in ctx[:2]), jone_stage.OneStageCFGConfig(**common),
                         positive_audio_encoding=jnp.asarray(ctx[2]), negative_audio_encoding=jnp.asarray(ctx[3]),
                         skip_decode=True)
    _, noise_key, audio_key, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    noise = t(np.asarray(jax.random.normal(noise_key, (1, 8, 16), jnp.float32)))
    audio_noise = t(np.asarray(jax.random.normal(audio_key, (1, 9, 16), jnp.float32)))
    pipe = one_stage.OneStagePipeline(port, audio_decoder=adec, vocoder=voc)
    out_v, out_a = pipe(t(ctx[0]), t(ctx[1]), one_stage.OneStageCFGConfig(dtype="float32", **common),
                        positive_audio_encoding=t(ctx[2]), negative_audio_encoding=t(ctx[3]), skip_decode=True,
                        noise=noise, audio_noise=audio_noise)
    assert_close(out_v, np.asarray(ref_v), msg=f"{version} one-stage video latent")
    assert_close(out_a, np.asarray(ref_a), msg=f"{version} one-stage audio latent")
    ref_wave = jpipe._decode_audio(jnp.asarray(ref_a))
    assert_close(decode_audio(out_a, adec, voc), ref_wave, msg=f"{version} one-stage waveform")
    with pytest.raises(ValueError, match="token_bucket is video-only"):
        pipe(t(ctx[0]), t(ctx[1]), one_stage.OneStageCFGConfig(token_bucket=16, **common),
             positive_audio_encoding=t(ctx[2]), negative_audio_encoding=t(ctx[3]))
    with pytest.raises(ValueError, match="Audio encoding required"):
        pipe(t(ctx[0]), t(ctx[1]), one_stage.OneStageCFGConfig(**common))
