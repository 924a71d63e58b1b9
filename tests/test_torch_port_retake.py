"""Retake (ltx2_tpu_torch/pipelines/retake.py), on the CPU, against the JAX
package's (ltx2_tpu/pipelines/retake.py) on the same weights (2-layer DiT,
the small encoder plan with every stride kind, base-16 decoder without
decode noise):

- `TemporalRegionMask` against JAX's at several windows and rates, exactly,
  and `RetakeConfig`'s end > start check;
- `RetakePipeline` from `source_video=` (17 frames, 64x64: 3 x 2 x 2
  latent tokens, the window over the first two latent frames) with the JAX
  pipeline's noise handed in: the latent to 1e-4 of max|latent| (RTOL);
  the frozen frame bit for bit the port's encoder latent (and within RTOL
  of JAX's); the decoded frames within one level;
- the source read from a file: `get_video_metadata` and
  `load_video_frames` equal the JAX functions on an MJPEG AVI, a .y4m and
  an MJPEG .mov (bit for bit);
- `generate.main(["--pipeline", "retake", "--video", AVI, ...])` from tiny
  files against `generate_videos_retake` on the same ledger (equal
  frames), its stats' frozen-token check, the flags as the JAX CLI parses
  them, and the refusals.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.pipelines import retake as jretake
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, video_decoder_from_numpy, video_encoder_from_numpy
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.models.video_vae.encoder import video_encoder_apply
from ltx2_tpu_torch.pipelines import retake
from ltx2_tpu_torch.types import VideoLatentShape
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import (  # noqa: F401 (one_intra_op_thread: the fixture)
    CFG, JCFG, assert_close, one_intra_op_thread, random_tree, stacked_dit_tree, t,
)

PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None), ("down", 16, 16, (2, 1, 1)),
        ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)), ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)),
        ("res", 32, 1, None))
JECFG = jencoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
ECFG = encoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
HEIGHT, WIDTH, FRAMES, SEED, STEPS = 64, 64, 17, 7, 2
START, END = 0.1, 0.5  # pixel frames 2 and 12: latent frames [0, 2) retaken, frame 2 kept

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _source(seed: int = 3, frames: int = FRAMES) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]
    base = np.stack([xx * 4.0, yy * 4.0, (xx + yy) * 2.0], -1)
    return np.stack([np.clip(base + 8 * i + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
                     for i in range(frames)])


@pytest.fixture(scope="module")
def weights():
    return {
        "dit": stacked_dit_tree(CFG, seed=11),
        "encoder": random_tree(encoder.VideoEncoder(ECFG, device="meta"), seed=12),
        "decoder": random_tree(VideoDecoder(DCFG), seed=13),
        "pos": (np.random.default_rng(14).standard_normal((1, 16, 256)) * 0.5).astype(np.float32),
        "neg": (np.random.default_rng(15).standard_normal((1, 16, 256)) * 0.5).astype(np.float32),
    }


@pytest.mark.parametrize("window", [(0.5, 1.0, 24.0), (0.0, 0.2, 24.0), (1.0, 3.0, 24.0), (0.3, 0.9, 25.0),
                                    (2.0, 9.0, 30.0)])
def test_temporal_region_mask_matches_jax(window):
    shape = (1, 8, 16, 2, 3)
    jtools = JTools(JPatchifier(1), JShape(*shape), fps=window[2])
    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*shape), fps=window[2])
    ref = jretake.TemporalRegionMask(*window).apply_to(jtools.create_initial_state(), jtools)
    got = retake.TemporalRegionMask(*window).apply_to(tools.create_initial_state(), tools)
    np.testing.assert_array_equal(got.denoise_mask.numpy(), np.asarray(ref.denoise_mask))
    first, last = retake.TemporalRegionMask(*window).latent_frames(16)
    per_frame = 6
    assert float(got.denoise_mask.sum()) == max(0, last - first) * per_frame
    for bad in ((2.0, 1.0), (1.0, 1.0)):
        with pytest.raises(ValueError, match="end_time"):
            retake.RetakeConfig(start_time=bad[0], end_time=bad[1])


@pytest.fixture(scope="module")
def jax_retake(weights):
    pipe = jretake.RetakePipeline(
        transformer_params=_jtree(weights["dit"]), transformer_cfg=JCFG,
        video_encoder_params=_jtree(weights["encoder"]), video_encoder_cfg=JECFG,
        video_decoder_params=_jtree(weights["decoder"]), video_decoder_cfg=JDCFG)
    config = jretake.RetakeConfig(start_time=START, end_time=END, seed=SEED, num_inference_steps=STEPS,
                                  cfg_scale=3.0, latent_channels=16)
    source = _source().astype(np.float32) / 127.5 - 1.0
    source = source.transpose(3, 0, 1, 2)[None]
    args = (jnp.asarray(weights["pos"]), jnp.asarray(weights["neg"]), config)
    latent = pipe(None, *args, source_video=jnp.asarray(source), fps=24.0, skip_decode=True)
    frames = pipe(None, *args, source_video=jnp.asarray(source), fps=24.0)
    noise_key, _ = jax.random.split(jax.random.PRNGKey(SEED))
    noise = np.asarray(jax.random.normal(noise_key, (1, 12, 16), jnp.float32))
    clean = np.asarray(jencoder.video_encoder_apply(_jtree(weights["encoder"]), JECFG, jnp.asarray(source)))
    return {"latent": np.asarray(latent), "frames": np.asarray(frames), "noise": noise, "source": source,
            "clean": clean}


def _port_pipeline(weights):
    return retake.RetakePipeline(dit_from_numpy(weights["dit"], CFG),
                                 video_encoder=video_encoder_from_numpy(weights["encoder"], ECFG),
                                 video_decoder=video_decoder_from_numpy(weights["decoder"], DCFG))


def test_retake_pipeline_matches_jax(weights, jax_retake):
    pipe = _port_pipeline(weights)
    config = retake.RetakeConfig(start_time=START, end_time=END, seed=SEED, num_inference_steps=STEPS, cfg_scale=3.0,
                                 latent_channels=16)
    phases = {}
    args = (t(weights["pos"]), t(weights["neg"]), config)
    latent = pipe(None, *args, source_video=t(jax_retake["source"]), fps=24.0, skip_decode=True,
                  noise=t(jax_retake["noise"]), callback=lambda phase, z: phases.setdefault(phase, z))
    assert list(phases) == ["encode", "denoise"] and latent.shape == (1, 16, 3, 2, 2)
    assert_close(latent, jax_retake["latent"], msg="retake latent")
    # The frame outside the window: bit for bit the encoder's latent, which
    # is JAX's within RTOL.
    encoded = video_encoder_apply(pipe.video_encoder, t(jax_retake["source"]))
    assert torch.equal(latent[:, :, 2:], encoded[:, :, 2:]) and torch.equal(phases["encode"], encoded)
    assert_close(encoded, jax_retake["clean"], msg="retake clean latent")
    assert not torch.equal(latent[:, :, :2], encoded[:, :, :2])
    frames = pipe(None, *args, source_video=t(jax_retake["source"]), fps=24.0, noise=t(jax_retake["noise"]))
    assert frames.shape == jax_retake["frames"].shape == (FRAMES, HEIGHT, WIDTH, 3) and frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - jax_retake["frames"].astype(int)).max() <= 1


@pytest.mark.parametrize("kind", ["avi", "y4m", "mov"])
def test_source_read_matches_jax(tmp_path, kind):
    path = str(tmp_path / f"src.{kind}")
    {"avi": jvio.write_avi_mjpeg, "y4m": jvio.write_y4m, "mov": jvio.write_mp4_mjpeg}[kind](path, _source(), 24.0)
    meta = retake.get_video_metadata(path)
    assert meta == jretake.get_video_metadata(path) and meta[1:] == (FRAMES, HEIGHT, WIDTH)
    assert abs(meta[0] - 24.0) < 1e-3  # an AVI stores microseconds a frame
    got = retake.load_video_frames(path, HEIGHT, WIDTH, FRAMES)
    np.testing.assert_array_equal(got, jretake.load_video_frames(path, HEIGHT, WIDTH, FRAMES))


@pytest.fixture(scope="module")
def files(weights, tmp_path_factory):
    d = tmp_path_factory.mktemp("retake_files")
    ckpt = str(d / "ltx.safetensors")
    jst.write_safetensors(ckpt, {
        **jexport.params_to_checkpoint(weights["dit"]),
        **{k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(
            video_decoder_from_numpy(weights["decoder"], DCFG)).items()},
        **{k: v.float().numpy() for k, v in vae_weights.encoder_to_checkpoint(
            video_encoder_from_numpy(weights["encoder"], ECFG)).items()}},
        metadata={"model_version": "2.0.0", "config": '{"transformer": {"num_attention_heads": 2}}'})
    avi = str(d / "src.avi")
    jvio.write_avi_mjpeg(avi, _source(seed=4, frames=20), 24.0)  # 20 frames: snapped down to 17
    return ckpt, avi


def test_generate_main_retake_from_avi(files):
    ckpt, avi = files
    out = os.path.join(os.path.dirname(ckpt), "retake.y4m")
    flags = ["--retake-start", "0.05", "--retake-end", "0.2", "--num-inference-steps", "2", "--cfg-scale", "3.0"]
    videos, stats = generate.main(["--pipeline", "retake", "--device", "cpu", "--checkpoint", ckpt, "--video", avi,
                                   "--seed", str(SEED), "--output", out, *flags])
    st = stats[0]
    assert videos[0].shape == (FRAMES, HEIGHT, WIDTH, 3) and videos[0].dtype == np.uint8 and os.path.getsize(out)
    assert st["frozen_exact"] and st["retake_latent_frames"] == [0, 1] and st["denoise_latent_finite"]
    ref, _ = generate.generate_videos_retake(
        [SEED], avi, start_time=0.05, end_time=0.2, steps=2, cfg_scale=3.0, device="cpu",
        ledger=ModelLedger(ckpt, decoder_dtype="bfloat16", device="cpu"))
    np.testing.assert_array_equal(videos[0], ref[0])
    # The JAX CLI's parse of the same flags builds the same RetakeConfig.
    from scripts.generate import build_parser

    jargs = build_parser().parse_args(["--pipeline", "retake", "--video", avi, *flags])
    assert (jargs.video, jargs.retake_start, jargs.retake_end, jargs.num_inference_steps, jargs.cfg_scale) == \
        (avi, 0.05, 0.2, 2, 3.0)
    for bad in (["--pipeline", "retake"], ["--video", avi], ["--pipeline", "one-stage", "--retake-end", "2"],
                ["--pipeline", "retake", "--video", avi, "--audio"],
                ["--pipeline", "retake", "--video", avi, "--image", "a.png"],
                ["--pipeline", "retake", "--video", avi, "--retake-start", "2", "--retake-end", "1"]):
        with pytest.raises((SystemExit, ValueError)):
            generate.main(bad + ["--device", "cpu", "--checkpoint", ckpt, "--output", out])
