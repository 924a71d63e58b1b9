"""Image-to-video in the port against the JAX package, in float32 on the CPU:

- the video VAE encoder (`video_encoder_apply`) on the small plan with every
  stride kind (scripts/generate.py's placeholder encoder), at 1 and 9
  frames, with conv_out's Cout odd (17, padded to 24) and a multiple of 8,
  within 1e-5 of max|latent|, and its conv count;
- the Cout-padded conv weight run through `conv3d_plain` against the
  unpadded conv (bit for bit: the added outputs are separate columns);
- the encoder checkpoint: written by `encoder_to_checkpoint`, read by the
  port's and the JAX package's `load_video_encoder_params` leaf by leaf bit
  for bit, the ledger's encoder, and the missing-key report;
- `VideoConditionByLatentIndex`: tokens, clean latent, mask, both errors;
- `LTX2Scheduler` exact in float32 over steps x tokens x stretch, and
  `get_sigma_schedule`;
- `CFGStarRescalingGuider`, `projection_coef`, `to_velocity` and
  `EulerDiffusionStep` to 1e-5;
- `load_image_tensor` against the JAX package's (PIL) on PNGs PIL writes,
  exactly: RGB, RGBA, L x same aspect, wider, taller x up- and downscale;
  the five PNG row filters; a JPEG written under a .png name (read by its
  signature) equal to PIL's too; unsupported formats raise;
- the distilled two-stage recipe with an image at frame 0 against the JAX
  package's `DistilledPipeline` on the same weights and noise (2-layer DiT,
  small encoder, upscaler and decoder, 64x64x9): the latent within 1e-4 of
  max|latent|, the frames within one level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ltx2_tpu import core as jcore
from ltx2_tpu.components import diffusion_steps as jsteps
from ltx2_tpu.components import guiders as jguiders
from ltx2_tpu.components import schedulers as jschedulers
from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning import latent as jlatent
from ltx2_tpu.conditioning.item import ConditioningError as JConditioningError
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.models.video_vae import weights as jvae_weights
from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.pipelines.distilled import DistilledConfig as JDistilledConfig
from ltx2_tpu.pipelines.distilled import DistilledPipeline as JDistilledPipeline
from ltx2_tpu.pipelines.one_stage import OneStageCFGConfig as JOneStageCFGConfig
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu_torch import core
from ltx2_tpu_torch.components import diffusion_steps, guiders, schedulers
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.item import ConditioningError
from ltx2_tpu_torch.conditioning.latent import VideoConditionByLatentIndex
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, spatial_upscaler_from_numpy, video_decoder_from_numpy, video_encoder_from_numpy,
)
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae import conv as vae_conv
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel, conv3d_plain, kernel_layout
from ltx2_tpu_torch.pipelines.common import ImageCondition, load_image_tensor
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline
from ltx2_tpu_torch.types import VideoLatentShape
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import (
    CFG, JCFG, assert_close, assert_module_matches_tree, numpy_tree, random_tree, t, write_png,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# scripts/generate.py's placeholder encoder: every stride kind at 16-32 channels.
PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None), ("down", 16, 16, (2, 1, 1)),
        ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)), ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)),
        ("res", 32, 1, None))
TOL_ENCODER = 1e-5


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _encoder_tree(latent_channels: int):
    jcfg = jencoder.VideoEncoderConfig(plan=PLAN, latent_channels=latent_channels)
    cfg = encoder.VideoEncoderConfig(plan=PLAN, latent_channels=latent_channels)
    return jcfg, cfg, random_tree(encoder.VideoEncoder(cfg, device="meta"), seed=latent_channels)


@pytest.mark.parametrize("latent_channels,frames", [(16, 1), (16, 9), (15, 1)])
def test_encoder_matches_jax(latent_channels, frames, monkeypatch):
    jcfg, cfg, tree = _encoder_tree(latent_channels)
    video = np.random.default_rng(frames).uniform(-1, 1, (1, 3, frames, 64, 96)).astype(np.float32)
    ref = jax.jit(lambda p, v: jencoder.video_encoder_apply(p, jcfg, v))(_jtree(tree), jnp.asarray(video))
    port = video_encoder_from_numpy(tree, cfg)
    calls = []
    conv = vae_conv.conv3d
    monkeypatch.setattr(vae_conv, "conv3d", lambda *a, **k: calls.append(a[1].shape[-1]) or conv(*a, **k))
    before = conv3d_ndhwc_kernel.launches
    out = encoder.video_encoder_apply(port, t(video))
    assert out.shape == ref.shape == (1, latent_channels, (frames - 1) // 8 + 1, 2, 3) and out.dtype == torch.float32
    assert_close(out, ref, rtol=TOL_ENCODER, msg="encoder")
    assert len(calls) == encoder.conv_launches(cfg) == 16  # 1 + 5 x 2 res + 4 down + 1
    assert calls[-1] == -(-(latent_channels + 1) // 8) * 8  # conv_out at the kernel's padded Cout
    assert conv3d_ndhwc_kernel.launches == before  # the CPU runs the plain version
    assert torch.equal(encoder.encode_video(t(video)[0], port), out)
    uint8 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (frames, 64, 96, 3), dtype=np.uint8))
    assert torch.equal(encoder.encode_video(uint8, port),
                       encoder.video_encoder_apply(port, (uint8.float() / 127.5 - 1.0).permute(3, 0, 1, 2)[None]))
    with pytest.raises(ValueError, match="1 \\+ 8\\*k"):
        encoder.video_encoder_apply(port, torch.zeros(1, 3, 2, 64, 96))


def test_padded_cout_conv_equals_unpadded():
    gen = torch.Generator().manual_seed(0)
    p = vae_conv.Conv3d(32, 17)
    with torch.no_grad():
        p.weight.uniform_(-0.1, 0.1, generator=gen)
        p.bias.uniform_(-0.1, 0.1, generator=gen)
    x = torch.randn(1, 3, 5, 7, 32, generator=gen)
    assert p.kernel_out == 24 and p.kernel_weight(torch.float32).shape == (3, 3, 3, 32, 24)
    assert p.tf32x3_weight().shape == (2, 27, 24, 32)
    w, b = p.padded()
    assert torch.equal(w[:17], p.weight) and not w[17:].any() and torch.equal(b[:17], p.bias) and not b[17:].any()
    args = (True, "zeros", "replicate")
    padded = conv3d_plain(x, kernel_layout(w), b, *args)
    assert padded.shape[-1] == 24 and not padded[..., 17:].sub(b[17:]).any()
    unpadded = conv3d_plain(x, kernel_layout(p.weight.detach()), p.bias.detach(), *args)
    assert torch.equal(padded[..., :17], unpadded)
    assert torch.equal(vae_conv.conv3d_ndhwc(p, x, spatial_mode="zeros"), unpadded)
    assert vae_conv.Conv3d(16, 24).padded()[0] is not None and vae_conv.Conv3d(16, 24).kernel_out == 24


def test_encoder_checkpoint_round_trip(tmp_path):
    jcfg, cfg, tree = _encoder_tree(16)
    port = video_encoder_from_numpy(tree, cfg)
    tensors = {k: v.numpy() for k, v in vae_weights.encoder_to_checkpoint(port).items()}
    assert "vae.encoder.down_blocks.1.conv.conv.weight" in tensors
    assert "vae.per_channel_statistics.std-of-means" in tensors
    path = str(tmp_path / "enc.safetensors")
    jst.write_safetensors(path, tensors)
    read_cfg = vae_weights.encoder_config_from_checkpoint(path)
    assert read_cfg == cfg
    loaded = vae_weights.load_video_encoder_params(path, read_cfg, device="cpu")
    assert_module_matches_tree(loaded, tree, stacked="")
    assert_module_matches_tree(loaded, jvae_weights.load_video_encoder_params(path, jcfg), stacked="")
    ledger = ModelLedger(path, device="cpu")
    assert ledger.video_encoder() is ledger.video_encoder()
    assert_module_matches_tree(ledger.video_encoder(), tree, stacked="")
    del tensors["vae.encoder.down_blocks.2.res_blocks.0.conv2.conv.weight"]
    broken = str(tmp_path / "broken.safetensors")
    jst.write_safetensors(broken, tensors)
    with pytest.raises(ValueError, match="missing 1 required video encoder key.*res_blocks.0.conv2.conv.weight"):
        vae_weights.load_video_encoder_params(broken, cfg, device="cpu")


def test_condition_by_latent_index_matches_jax():
    shape = (1, 16, 3, 2, 3)
    rng = np.random.default_rng(2)
    grid = rng.standard_normal(shape).astype(np.float32)
    cond = rng.standard_normal((1, 16, 1, 2, 3)).astype(np.float32)
    jtools = JTools(JPatchifier(1), JShape(*shape), fps=24.0)
    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*shape), fps=24.0)
    for idx, strength in ((0, 0.95), (2, 0.6)):
        jstate = jlatent.VideoConditionByLatentIndex(jnp.asarray(cond), strength, idx).apply_to(
            jtools.create_initial_state(initial_latent=jnp.asarray(grid)), jtools)
        state = VideoConditionByLatentIndex(t(cond), strength, idx).apply_to(
            tools.create_initial_state(initial_latent=t(grid)), tools)
        for name in ("latent", "denoise_mask", "positions", "clean_latent"):
            assert_close(getattr(state, name), getattr(jstate, name), rtol=0, msg=f"{name} at {idx}")
        assert float(state.denoise_mask[0, idx * 6, 0]) == np.float32(1 - strength)
    with pytest.raises(ConditioningError):
        VideoConditionByLatentIndex(torch.zeros(1, 16, 1, 4, 3), 1.0, 0).apply_to(tools.create_initial_state(), tools)
    with pytest.raises(JConditioningError):
        jlatent.VideoConditionByLatentIndex(jnp.zeros((1, 16, 1, 4, 3)), 1.0, 0).apply_to(
            jtools.create_initial_state(), jtools)
    with pytest.raises(ValueError, match="exceed latent sequence length"):
        VideoConditionByLatentIndex(t(cond), 1.0, 3).apply_to(tools.create_initial_state(), tools)


@pytest.mark.parametrize("stretch", [True, False])
@pytest.mark.parametrize("tokens", [None, 1024, 4290, 6144])
@pytest.mark.parametrize("steps", [1, 8, 30, 40])
def test_ltx2_scheduler_matches_jax(steps, tokens, stretch):
    ref = jschedulers.LTX2Scheduler().execute(steps, tokens=tokens, stretch=stretch)
    got = schedulers.LTX2Scheduler().execute(steps, tokens=tokens, stretch=stretch)
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    assert got[0] == 1.0 and got[-1] == 0.0 and np.isfinite(got).all()


def test_sigma_schedule_and_shape_anchor():
    assert np.array_equal(schedulers.get_sigma_schedule(30), jschedulers.get_sigma_schedule(30))
    assert np.array_equal(schedulers.get_sigma_schedule(8, distilled=True),
                          jschedulers.get_sigma_schedule(8, distilled=True))
    shape = (1, 128, 13, 15, 22)
    assert np.array_equal(schedulers.LTX2Scheduler().execute(30, latent_shape=shape),
                          jschedulers.LTX2Scheduler().execute(30, latent_shape=shape))


def test_guiders_and_euler_step_match_jax():
    rng = np.random.default_rng(4)
    cond, uncond, sample = (rng.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(3))
    assert_close(guiders.projection_coef(t(cond), t(uncond)), jguiders.projection_coef(cond, uncond), 1e-5, "coef")
    for scale in (3.0, 1.0):
        port, ref = guiders.CFGStarRescalingGuider(scale), jguiders.CFGStarRescalingGuider(scale)
        assert_close(port.guide(t(cond), t(uncond)), ref.guide(jnp.asarray(cond), jnp.asarray(uncond)), 1e-5, "cfg*")
        assert port.enabled() == ref.enabled() == (scale != 1.0)
    # The projection is per row: the second row alone gives its own coefficient.
    assert_close(guiders.projection_coef(t(cond[1:]), t(uncond[1:]))[0],
                 guiders.projection_coef(t(cond), t(uncond))[1], 1e-6, "per row")
    assert_close(core.to_velocity(t(sample), 0.7, t(cond)), jcore.to_velocity(sample, 0.7, cond), 1e-5, "velocity")
    got = diffusion_steps.EulerDiffusionStep().step(t(sample), t(cond), torch.tensor(0.7), torch.tensor(0.4))
    ref = jsteps.EulerDiffusionStep().step(jnp.asarray(sample), jnp.asarray(cond), 0.7, 0.4)
    assert got.dtype == torch.float32
    assert_close(got, ref, 1e-5, "euler")
    bf16 = diffusion_steps.EulerDiffusionStep().step(t(sample).bfloat16(), t(cond), 0.7, 0.4)
    assert bf16.dtype == torch.bfloat16


# (source width, height) against the target 96 x 64: same aspect (down and
# up), wider, taller (each down and up).
GEOMETRIES = {"same_down": (300, 200), "same_up": (48, 32), "wider_down": (250, 100), "wider_up": (60, 20),
              "taller_down": (120, 200), "taller_up": (30, 50)}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_load_image_tensor_matches_jax(tmp_path, mode, geometry):
    w, h = GEOMETRIES[geometry]
    rng = np.random.default_rng(len(mode) * 10 + len(geometry))
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = ((np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128).astype(np.uint8)
    channels = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    arr = np.stack([np.where(rng.random((h, w)) < 0.3, rng.integers(0, 256, (h, w)), smooth).astype(np.uint8)
                    for _ in range(channels)], axis=-1)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(path)
    ref = np.asarray(jcommon.load_image_tensor(path, 64, 96))
    got = load_image_tensor(path, 64, 96)
    assert got.shape == ref.shape == (1, 3, 1, 64, 96) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_png_filters_and_unsupported_formats(tmp_path):
    rng = np.random.default_rng(9)
    for shape in ((40, 70, 3), (33, 21, 4), (25, 44)):
        path = write_png(str(tmp_path / f"f{len(shape)}.png"), rng.integers(0, 256, shape, dtype=np.uint8))
        np.testing.assert_array_equal(load_image_tensor(path, 64, 96).numpy(),
                                      np.asarray(jcommon.load_image_tensor(path, 64, 96)))
    base = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    jpeg = str(tmp_path / "jpeg_named.png")  # dispatched on its signature, not its name
    Image.fromarray(base).save(jpeg, "JPEG")
    np.testing.assert_array_equal(load_image_tensor(jpeg, 64, 96).numpy(),
                                  np.asarray(jcommon.load_image_tensor(jpeg, 64, 96)))
    unsupported = {
        "GIF": lambda p: Image.fromarray(base).save(p, "GIF"),
        "palette": lambda p: Image.fromarray(base).convert("P").save(p),
        "16-bit": lambda p: Image.fromarray(base[..., 0].astype(np.uint16) * 257).save(p),
        "grayscale with alpha": lambda p: Image.fromarray(base[..., :2].copy(), "LA").save(p),
        "interlaced": lambda p: write_png(p, base, filters=(0,)) and _set_interlace(p),
    }
    for name, write in unsupported.items():
        path = str(tmp_path / f"u_{name.replace(' ', '_')}.png")
        write(path)
        with pytest.raises(ValueError, match=name):
            load_image_tensor(path, 64, 96)
    with pytest.raises(FileNotFoundError):
        load_image_tensor(str(tmp_path / "absent.png"), 64, 96)


def _set_interlace(path):
    """Flag a written PNG as Adam7-interlaced (the IHDR's last byte)."""
    import struct
    import zlib

    data = bytearray(open(path, "rb").read())
    data[28] = 1  # signature 8 + length 4 + type 4 + 12 bytes of IHDR fields
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    open(path, "wb").write(bytes(data))


# ---- the distilled recipe with an image ---------------------------------------

HEIGHT, WIDTH, FRAMES, SEED = 64, 64, 9, 11
JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
JUPCFG = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
UPCFG = SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)


def test_distilled_with_image_matches_jax(tmp_path):
    jecfg, ecfg, enc_tree = _encoder_tree(16)
    dit_tree = numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=1)
    dec_tree = random_tree(VideoDecoder(DCFG), seed=2)
    up_tree = random_tree(SpatialUpscaler(UPCFG), seed=4)
    context = (np.random.default_rng(5).standard_normal((1, 16, 256)) * 0.02).astype(np.float32)
    image = write_png(str(tmp_path / "i.png"), np.random.default_rng(6).integers(0, 256, (90, 100, 3), np.uint8))

    jpipe = JDistilledPipeline(
        transformer_params=_jtree(dit_tree), transformer_cfg=JCFG, video_encoder_params=_jtree(enc_tree),
        video_encoder_cfg=jecfg, video_decoder_params=_jtree(dec_tree), video_decoder_cfg=JDCFG,
        spatial_upscaler_params=_jtree(up_tree), spatial_upscaler_cfg=JUPCFG)
    jconfig = JDistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, dtype="float32",
                               latent_channels=16)
    images = [jcommon.ImageCondition(image, 0, 0.9)]
    ref = np.asarray(jpipe(jnp.asarray(context), None, jconfig, images=images, skip_decode=True))
    k1, k2, decode_key = jax.random.split(jax.random.PRNGKey(SEED), 3)
    ref_frames = jpipe._decode_video(jnp.asarray(ref), JOneStageCFGConfig(
        height=HEIGHT, width=WIDTH, num_frames=FRAMES, latent_channels=16), decode_key)
    noises = tuple(t(np.asarray(jax.random.normal(jax.random.split(k)[0], (1, n, 16), jnp.float32)))
                   for k, n in ((k1, 2), (k2, 8)))

    port_enc = video_encoder_from_numpy(enc_tree, ecfg)
    pipe = DistilledPipeline(dit_from_numpy(dit_tree, CFG), spatial_upscaler_from_numpy(up_tree, UPCFG),
                             video_decoder=video_decoder_from_numpy(dec_tree, DCFG), video_encoder=port_enc)
    config = DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16)
    phases = []
    latent = pipe(t(context), config, images=[ImageCondition(image, 0, 0.9)], skip_decode=True, noises=noises,
                  callback=lambda phase, z: phases.append((phase, tuple(z.shape))))
    assert [p for p, _ in phases] == ["stage1_image_encode", "stage1", "upscale", "stage2_image_encode", "stage2"]
    assert phases[0][1] == (1, 16, 1, 1, 1) and phases[3][1] == (1, 16, 1, 2, 2)  # encoded at each stage's size
    assert_close(latent, ref, msg="two-stage latent with an image")
    frames = pipe(t(context), config, images=[ImageCondition(image, 0, 0.9)], noises=noises)
    assert frames.shape == ref_frames.shape == (FRAMES, HEIGHT, WIDTH, 3) and frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - ref_frames.astype(int)).max() <= 1
    # Without a decoder the upscale bracket reads the encoder's statistics.
    stats_pipe = DistilledPipeline(pipe.transformer, pipe.spatial_upscaler, video_encoder=port_enc)
    assert stats_pipe._stats() is port_enc.per_channel_statistics
    assert dataclasses.replace(config).effective_tiling() is None
