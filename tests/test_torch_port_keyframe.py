"""Keyframe interpolation, on the CPU, against the JAX package on the same
weights (2-layer DiT, the small encoder plan with every stride kind,
mid-16 spatial upscaler, base-16 decoder, random latent statistics):

- `VideoConditionByKeyframeIndex` at pixel frame 0 (the causal fix) and
  at frame 8: the appended latent, denoise mask, positions and clean
  latent, exactly;
- `KeyframeInterpolationPipeline` two-stage (half-size CFG stage 1, the
  upscaler, the distilled stage 2 with the keyframes appended again) and
  one-stage (no upscaler), with the JAX pipeline's noise handed in: the
  latent to 1e-4 of max|latent| (RTOL); a strength-1.0 keyframe's
  appended tokens come out of each stage bit for bit the encoder's latent;
- `generate.main(["--pipeline", "keyframe", "--keyframe", ...])` from
  tiny files against `generate_videos_keyframe` on the same ledger, the
  spec parser against the JAX CLI's, and the refusals.
Decode noise is off (scale 0).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning import keyframe as jkeyframe
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.pipelines import keyframe_interpolation as jki
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.keyframe import VideoConditionByKeyframeIndex
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, spatial_upscaler_from_numpy, video_decoder_from_numpy, video_encoder_from_numpy,
)
from ltx2_tpu_torch.models.upscaler import spatial
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.models.video_vae.encoder import video_encoder_apply
from ltx2_tpu_torch.pipelines.common import load_image_tensor
from ltx2_tpu_torch.pipelines.keyframe_interpolation import (
    Keyframe, KeyframeInterpolationConfig, KeyframeInterpolationPipeline,
)
from ltx2_tpu_torch.types import VideoLatentShape
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
JUPCFG = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
UPCFG = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
HEIGHT, WIDTH, FRAMES, SEED = 128, 128, 9, 3

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("keyframe")
    return {
        "dit": stacked_dit_tree(CFG, seed=1),
        "encoder": random_tree(encoder.VideoEncoder(ECFG, device="meta"), seed=2),
        "decoder": random_tree(VideoDecoder(DCFG), seed=3),
        "upscaler": random_tree(spatial.SpatialUpscaler(UPCFG, device="meta"), seed=4),
        "pos": (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32),
        "first": write_png(str(d / "first.png"), rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)),
        "last": write_png(str(d / "last.png"), rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)),
    }


@pytest.mark.parametrize("frame_idx", [0, 8])
def test_keyframe_conditioning_matches_jax(frame_idx):
    shape = (1, 16, 2, 2, 3)
    rng = np.random.default_rng(frame_idx)
    keyframe = rng.standard_normal((1, 16, 1, 2, 3)).astype(np.float32)
    latent = rng.standard_normal(shape).astype(np.float32)
    jtools = JTools(JPatchifier(1), JShape(*shape), fps=24.0)
    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*shape), fps=24.0)
    ref = jkeyframe.VideoConditionByKeyframeIndex(jnp.asarray(keyframe), frame_idx, 0.8).apply_to(
        jtools.create_initial_state(initial_latent=jnp.asarray(latent)), jtools)
    got = VideoConditionByKeyframeIndex(t(keyframe), frame_idx, 0.8).apply_to(
        tools.create_initial_state(initial_latent=t(latent)), tools)
    for field in ("latent", "denoise_mask", "positions", "clean_latent"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), field)
    assert got.latent.shape[1] == 12 + 6 and float(got.denoise_mask[0, -1, 0]) == np.float32(1 - 0.8)
    # The time coordinate: pixel frame_idx / fps; the causal fix at frame 0 only.
    start = got.positions[0, 0, 12:, 0]
    assert torch.allclose(start, torch.full_like(start, frame_idx / 24.0))
    assert tools.clear_conditioning(got).latent.shape[1] == 12


def _jax_pipeline(weights, upscaler: bool):
    return jki.KeyframeInterpolationPipeline(
        transformer_params=_jtree(weights["dit"]), transformer_cfg=JCFG,
        video_encoder_params=_jtree(weights["encoder"]), video_encoder_cfg=JECFG,
        video_decoder_params=_jtree(weights["decoder"]), video_decoder_cfg=JDCFG,
        spatial_upscaler_params=_jtree(weights["upscaler"]) if upscaler else None, spatial_upscaler_cfg=JUPCFG)


def _jax_noise(seed: int, tokens):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [t(np.asarray(jax.random.normal(k, (1, n, 16), jnp.float32))) for k, n in zip(keys, tokens)]


@pytest.mark.parametrize("two_stage", [True, False], ids=["two_stage", "one_stage"])
def test_keyframe_pipeline_matches_jax(weights, two_stage):
    keyframes = [("first", 0, 1.0), ("last", 8, 0.9)]
    jpipe = _jax_pipeline(weights, two_stage)
    jconfig = jki.KeyframeInterpolationConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED,
                                              num_inference_steps=2, latent_channels=16)
    ref = jpipe(jnp.asarray(weights["pos"]), None, jconfig, skip_decode=True,
                keyframes=[jki.Keyframe(weights[k], f, s) for k, f, s in keyframes])

    dit = dit_from_numpy(weights["dit"], CFG)
    enc = video_encoder_from_numpy(weights["encoder"], ECFG)
    up = spatial_upscaler_from_numpy(weights["upscaler"], UPCFG) if two_stage else None
    pipe = KeyframeInterpolationPipeline(dit, up, video_decoder=video_decoder_from_numpy(weights["decoder"], DCFG),
                                         video_encoder=enc)
    config = KeyframeInterpolationConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED,
                                         num_inference_steps=2, latent_channels=16)
    # Stage 1: 2 x 2 x 2 tokens + 2 keyframes of 2 x 2 (at half size under
    # two stages); stage 2: 2 x 4 x 4 + 2 x 4 x 4.
    tokens = (8 + 8, 32 + 32) if two_stage else (32 + 32, 0)
    phases, ends = [], []
    latent = pipe(t(weights["pos"]), config, keyframes=[Keyframe(weights[k], f, s) for k, f, s in keyframes],
                  skip_decode=True, noises=_jax_noise(SEED, tokens)[:2], end_states=ends,
                  callback=lambda phase, z: phases.append(phase))
    assert phases == (["stage1", "upscale", "stage2"] if two_stage else ["stage1"])
    assert latent.shape == (1, 16, 2, 4, 4)
    assert_close(latent, np.asarray(ref), msg=f"keyframe latent ({'two' if two_stage else 'one'} stage)")
    # The strength-1.0 keyframe's appended tokens at each stage's end: the
    # encoder's latent of the first image at that stage's size, bit for bit.
    for state, size in zip(ends, [(HEIGHT // 2, WIDTH // 2), (HEIGHT, WIDTH)] if two_stage else [(HEIGHT, WIDTH)]):
        encoded = video_encoder_apply(enc, load_image_tensor(weights["first"], *size))
        n = state.latent.shape[1] - 2 * encoded[0, 0].numel()
        kf_tokens = VideoLatentPatchifier(1).patchify(encoded)
        assert torch.equal(state.latent[:, n:n + kf_tokens.shape[1]], kf_tokens)
    if two_stage:
        frames = pipe(t(weights["pos"]), config, keyframes=[Keyframe(weights[k], f, s) for k, f, s in keyframes],
                      noises=_jax_noise(SEED, tokens)[:2])
        assert frames.shape == (FRAMES, HEIGHT, WIDTH, 3) and frames.dtype == np.uint8


@pytest.fixture(scope="module")
def files(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("keyframe_files")
    ckpt = str(d / "ltx.safetensors")
    jst.write_safetensors(ckpt, {
        **jexport.params_to_checkpoint(weights["dit"]),
        **{k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(
            video_decoder_from_numpy(weights["decoder"], DCFG)).items()},
        **{k: v.float().numpy() for k, v in vae_weights.encoder_to_checkpoint(
            video_encoder_from_numpy(weights["encoder"], ECFG)).items()}},
        metadata={"model_version": "2.0.0", "config": '{"transformer": {"num_attention_heads": 2}}'})
    # The file's upscaler at mid 32: the loader keeps the published 32 groups.
    up_cfg = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
    up = str(d / "upscaler.safetensors")
    jst.write_safetensors(up, {k: v.float().numpy() for k, v in spatial.upscaler_to_checkpoint(
        spatial_upscaler_from_numpy(random_tree(spatial.SpatialUpscaler(up_cfg, device="meta"), seed=8),
                                    up_cfg)).items()})
    return ckpt, up


def test_generate_main_keyframe(weights, files):
    ckpt, up = files
    out = os.path.join(os.path.dirname(ckpt), "clip.y4m")
    argv = ["--pipeline", "keyframe", "--device", "cpu", "--checkpoint", ckpt, "--spatial-upscaler", up,
            "--keyframe", f"{weights['first']}:0", "--keyframe", f"{weights['last']}:8:0.8", "--height", str(HEIGHT),
            "--width", str(WIDTH), "--frames", str(FRAMES), "--seed", str(SEED), "--output", out]
    videos, stats = generate.main(argv)
    st = stats[0]
    assert videos[0].shape == (FRAMES, HEIGHT, WIDTH, 3) and videos[0].dtype == np.uint8
    assert st["stage1_latent_finite"] and st["stage2_latent_finite"] and os.path.getsize(out) > 0
    ref, _ = generate.generate_videos_keyframe(
        [SEED], [Keyframe(weights["first"], 0), Keyframe(weights["last"], 8, 0.8)], height=HEIGHT, width=WIDTH,
        frames=FRAMES, device="cpu", ledger=ModelLedger(ckpt, spatial_upscaler_path=up, decoder_dtype="bfloat16",
                                                         device="cpu"))
    np.testing.assert_array_equal(videos[0], ref[0])
    from scripts.generate import build_parser

    jargs = build_parser().parse_args(["--keyframe", "a.png:8", "--keyframe", "b.png:120:0.5"])
    assert [generate.parse_keyframe_spec(s) for s in jargs.keyframe] == [Keyframe("a.png", 8, 0.95),
                                                                         Keyframe("b.png", 120, 0.5)]
    for bad in (["--keyframe", "a.png:0"], ["--pipeline", "keyframe", "--image", "a.png"],
                ["--pipeline", "keyframe", "--audio"]):
        with pytest.raises(SystemExit):
            generate.main(bad + ["--device", "cpu", "--output", out])
    jpg = os.path.join(os.path.dirname(ckpt), "k.jpg")
    with open(jpg, "wb") as fh:
        fh.write(b"\xff\xd8\xff\xe0" + bytes(60))  # a JPEG's signature, then nothing it can decode
    with pytest.raises(ValueError, match=r"k\.jpg: JPEG segment 0xFFE0 of bad length 0"):
        generate.generate_videos_keyframe([SEED], [Keyframe(jpg, 0)], height=HEIGHT, width=WIDTH, frames=FRAMES,
                                          device="cpu", ledger=ModelLedger(ckpt, device="cpu"))
