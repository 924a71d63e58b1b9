"""The Res2s sampler and the ti2vid-hq pipeline, on the CPU, against the JAX
package:

- `phi` and `get_res2s_coefficients` at the schedule's step sizes, and
  `get_ancestral_step`, exactly (host float math in both packages);
- `EulerAncestralDiffusionStep` (with the noise handed in, and its
  deterministic sub-step) and `Res2sDiffusionStep` (its SDE coefficients
  and the step, with and without noise) to 1e-6 of max|out| (fp32 step
  math in both, in different op orders);
- `TI2VidHQPipeline` against the JAX pipeline on the same weights and the
  JAX keys' noise, with an image conditioning both stages: the video-only
  2-layer DiT (the Res2s CFG loop at half size, the upscaler, the
  distilled stage 2, the decode within one level), and the small
  audio-video DiT with its audio stream guided at its own scale; the
  latents to 1e-4 of max|latent| (RTOL);
- `generate.main(["--pipeline", "ti2vid-hq", ...])` at a tiny size from
  files against `generate_videos_ti2vid_hq` on the same ledger.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import diffusion_steps as jsteps
from ltx2_tpu.components import res2s as jres2s
from ltx2_tpu.components import schedulers as jschedulers
from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.pipelines import ti2vid_hq as jhq
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.components import diffusion_steps, res2s
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, spatial_upscaler_from_numpy, video_decoder_from_numpy, video_encoder_from_numpy,
)
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.upscaler import spatial
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.pipelines.common import ImageCondition
from ltx2_tpu_torch.pipelines.ti2vid_hq import TI2VidHQConfig, TI2VidHQPipeline
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import (
    CFG, JCFG, assert_close, one_intra_op_thread, random_tree, stacked_dit_tree, t, write_png,
)

PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None), ("down", 16, 16, (2, 1, 1)),
        ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)), ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)),
        ("res", 32, 1, None))
JECFG = jencoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
ECFG = encoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
UP = dict(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
AV = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
          cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
          audio_out_channels=16, caption_channels=24)
AUDIO = dict(audio_vae_channels=4, audio_mel_bins=4)
HEIGHT, WIDTH, FRAMES, SEED, STEPS = 128, 128, 9, 11, 3

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("steps", [3, 15])
def test_res2s_coefficients_and_phi_match_jax(steps):
    sig = [float(s) for s in jschedulers.LTX2Scheduler().execute(steps=steps)][:-1] + [0.0011]
    hs = [-math.log(sig[i + 1] / sig[i]) for i in range(len(sig) - 1)]
    cache, jcache = {}, {}
    for h in hs + [0.0, 1e-12]:
        assert res2s.get_res2s_coefficients(h, cache) == jres2s.get_res2s_coefficients(h, jcache)
        for j in (1, 2, 3):
            assert res2s.phi(j, -h) == jres2s.phi(j, -h)
    assert cache == jcache
    for frm, to in ((1.0, 0.7), (0.7, 0.0), (0.0, 0.0), (0.3, 0.29)):
        up, down = diffusion_steps.get_ancestral_step(frm, to, eta=0.8)
        jup, jdown = jsteps.get_ancestral_step(frm, to, eta=0.8)
        assert float(up) == float(jup) and float(down) == float(jdown)


def test_ancestral_and_res2s_steps_match_jax():
    rng = np.random.default_rng(1)
    x, x0, noise = (rng.standard_normal((1, 12, 16)).astype(np.float32) for _ in range(3))
    anc, janc = diffusion_steps.EulerAncestralDiffusionStep(), jsteps.EulerAncestralDiffusionStep()
    key = jax.random.PRNGKey(3)
    jnoise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    for sigma, nxt in ((0.9, 0.6), (0.4, 0.0)):
        assert_close(anc.step(t(x), t(x0), sigma, nxt, noise=t(jnoise)),
                     janc.step(jnp.asarray(x), jnp.asarray(x0), sigma, nxt, key=key), rtol=1e-6, msg="ancestral")
        assert_close(anc.step(t(x), t(x0), sigma, nxt), janc.step(jnp.asarray(x), jnp.asarray(x0), sigma, nxt),
                     rtol=1e-6, msg="ancestral, deterministic")
    drawn = anc.step(t(x).bfloat16(), t(x0), 0.9, 0.6, generator=torch.Generator().manual_seed(0))
    assert drawn.dtype == torch.bfloat16 and not torch.equal(drawn, anc.step(t(x).bfloat16(), t(x0), 0.9, 0.6))
    r2, jr2 = diffusion_steps.Res2sDiffusionStep(), jsteps.Res2sDiffusionStep()
    for args in ((0.5,), (0.5, 0.2), (0.5, None, 0.3), (0.5, None, None, 0.9)):
        assert r2.get_sde_coeff(*args) == jr2.get_sde_coeff(*args)
    for sigma, nxt in ((0.9, 0.6), (0.2, 0.0011), (0.1, 0.0)):
        for n in (None, noise):
            got = r2.step(t(x), t(x0), sigma, nxt, noise=None if n is None else t(n))
            ref = jr2.step(jnp.asarray(x), jnp.asarray(x0), sigma, nxt, noise=None if n is None else jnp.asarray(n))
            assert_close(got, ref, rtol=1e-6, msg=f"res2s {sigma} -> {nxt}")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("ti2vid_hq")
    return {
        "encoder": random_tree(encoder.VideoEncoder(ECFG, device="meta"), seed=2),
        "decoder": random_tree(VideoDecoder(DCFG), seed=3),
        "upscaler": random_tree(spatial.SpatialUpscaler(spatial.SpatialUpscalerConfig(**UP), device="meta"), seed=4),
        "rng": rng,
        "image": write_png(str(d / "image.png"), rng.integers(0, 256, (100, 90, 3), dtype=np.uint8)),
    }


def _noises(seed: int, tokens, audio_tokens):
    """Each stage's noise as the JAX pipeline draws it: PRNGKey(seed) split
    in (k1, k1a, k2, decode); stage 2's video and audio keys split from k2."""
    k1, k1a, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
    vk2, ak2 = jax.random.split(k2)

    def normal(k, n):
        return t(np.asarray(jax.random.normal(k, (1, n, 16), jnp.float32)))

    return [normal(k1, tokens[0]), normal(vk2, tokens[1])], [normal(k1a, audio_tokens), normal(ak2, audio_tokens)]


@pytest.mark.parametrize("version", ["video", "av"])
def test_ti2vid_hq_pipeline_matches_jax(weights, version):
    if version == "video":
        cfg, jcfg, width = CFG, JCFG, 256
    else:
        cfg = model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo, **AV)
        jcfg = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, remat=False, **AV)
        width = 24
    tree = stacked_dit_tree(cfg, seed=7)
    rng = np.random.default_rng(8)
    pos, neg = ((rng.standard_normal((1, 6, width)) * 0.5).astype(np.float32) for _ in range(2))
    audio = version == "av"
    extra = dict(audio_enabled=True, **AUDIO) if audio else {}
    jpipe = jhq.TI2VidHQPipeline(
        transformer_params=_jtree(tree), transformer_cfg=jcfg,
        video_encoder_params=_jtree(weights["encoder"]), video_encoder_cfg=JECFG,
        video_decoder_params=_jtree(weights["decoder"]), video_decoder_cfg=JDCFG,
        spatial_upscaler_params=_jtree(weights["upscaler"]), spatial_upscaler_cfg=jspatial.SpatialUpscalerConfig(**UP))
    jconfig = jhq.TI2VidHQConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=STEPS,
                                 cfg_scale=3.0, audio_cfg_scale=5.0, latent_channels=16, **extra)
    images = [jcommon.ImageCondition(weights["image"], 0, 0.9)]
    ref = jpipe(jnp.asarray(pos), jnp.asarray(neg), jconfig, images=images, skip_decode=True)
    ref_v, ref_a = ref if audio else (ref, None)

    pipe = TI2VidHQPipeline(dit_from_numpy(tree, cfg), spatial_upscaler_from_numpy(
        weights["upscaler"], spatial.SpatialUpscalerConfig(**UP)), video_decoder=video_decoder_from_numpy(
        weights["decoder"], DCFG), video_encoder=video_encoder_from_numpy(weights["encoder"], ECFG))
    config = TI2VidHQConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=STEPS,
                            cfg_scale=3.0, audio_cfg_scale=5.0, latent_channels=16, **extra)
    noises, audio_noises = _noises(SEED, (8, 32), 9)
    phases = []
    out = pipe(t(pos), t(neg), config, images=[ImageCondition(weights["image"], 0, 0.9)], skip_decode=True,
               noises=noises, audio_noises=audio_noises if audio else None,
               callback=lambda phase, z: phases.append(phase))
    out_v, out_a = out if audio else (out, None)
    assert phases == ["stage1", "upscale", "stage2"]
    assert_close(out_v, np.asarray(ref_v), msg=f"{version} ti2vid-hq latent")
    if audio:
        assert tuple(out_a.shape) == (1, 4, 9, 4)
        assert_close(out_a, np.asarray(ref_a), msg="ti2vid-hq audio latent")
    else:
        frames = pipe(t(pos), t(neg), config, images=[ImageCondition(weights["image"], 0, 0.9)], noises=noises)
        jframes = jpipe(jnp.asarray(pos), jnp.asarray(neg), jconfig, images=images)
        assert frames.shape == (FRAMES, HEIGHT, WIDTH, 3)
        assert np.abs(frames.astype(int) - np.asarray(jframes).astype(int)).max() <= 1


def test_generate_main_ti2vid_hq(weights, tmp_path):
    tree = stacked_dit_tree(CFG, seed=9)
    ckpt = str(tmp_path / "ltx.safetensors")
    jst.write_safetensors(ckpt, {
        **jexport.params_to_checkpoint(tree),
        **{k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(
            video_decoder_from_numpy(weights["decoder"], DCFG)).items()},
        **{k: v.float().numpy() for k, v in vae_weights.encoder_to_checkpoint(
            video_encoder_from_numpy(weights["encoder"], ECFG)).items()}},
        metadata={"model_version": "2.0.0", "config": '{"transformer": {"num_attention_heads": 2}}'})
    out = str(tmp_path / "clip.y4m")
    argv = ["--pipeline", "ti2vid-hq", "--device", "cpu", "--checkpoint", ckpt, "--image", f"{weights['image']}:0",
            "--steps-stage1", "2", "--cfg", "4", "--height", str(HEIGHT), "--width", str(WIDTH), "--frames",
            str(FRAMES), "--seed", str(SEED), "--output", out]
    videos, stats = generate.main(argv)
    # Without --spatial-upscaler the stage-1 latent (half size) is decoded, as the JAX CLI does.
    assert videos[0].shape == (FRAMES, HEIGHT // 2, WIDTH // 2, 3) and stats[0]["stage1_latent_finite"]
    assert "stage2_s" not in stats[0] and os.path.getsize(out) > 0
    ref, _ = generate.generate_videos_ti2vid_hq(
        [SEED], height=HEIGHT, width=WIDTH, frames=FRAMES, steps=2, cfg_scale=4.0, device="cpu",
        images=[ImageCondition(weights["image"], 0, 0.95)],
        ledger=ModelLedger(ckpt, decoder_dtype="bfloat16", device="cpu"))
    np.testing.assert_array_equal(videos[0], ref[0])
