"""The port's two-stage distilled recipe against the JAX package, in float32
on the CPU, on the same weights (2-layer DiT, mid-16 upscaler, base-16
decoder with random latent statistics) and the same noise:

- tiled VAE decode (models/video_vae/tiling.py): tile specs and ramps
  exactly; the blended video within 1e-4 of its largest magnitude and the
  uint8 frames of `decode_video` within 1 level of the JAX pipeline's tiled
  `_decode_video` conversion, with a small tiling that cuts T and W into
  several tiles;
- `DistilledPipeline(skip_decode=True)` at 64x64x9: the final latent within
  1e-4, each stage's noise drawn from the JAX keys (PRNGKey(seed) -> split
  3 -> split each);
- the whole recipe with decode through `generate_videos_distilled` (the
  entry behind `generate --pipeline distilled --device cpu`): frames within
  1 level.
Decode noise is switched off (scale 0): each package draws it from its own
RNG; tests/test_torch_port_vae.py holds the injection itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import tiling as jtiling
from ltx2_tpu.pipelines.distilled import DistilledConfig as JDistilledConfig
from ltx2_tpu.pipelines.distilled import DistilledPipeline as JDistilledPipeline
from ltx2_tpu.pipelines.one_stage import OneStageCFGConfig
from ltx2_tpu_torch.generate import generate_videos_distilled
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, spatial_upscaler_from_numpy, video_decoder_from_numpy
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae import tiling
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, video_decoder_apply
from ltx2_tpu_torch.pipelines.common import ImageCondition, decode_video
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline
from tests.torch_port_util import CFG, JCFG, assert_close, numpy_tree, t, write_png
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
JUPCFG = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
UPCFG = SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
HEIGHT, WIDTH, FRAMES, SEED = 64, 64, 9, 13
# Tiles of 2 latent frames / 2 latent columns with an overlap of 1: a
# (4, 2, 4) latent splits into 3 tiles in T and 3 in W.
SMALL_TILING = jtiling.TilingConfig(jtiling.SpatialTilingConfig(64, 32), jtiling.TemporalTilingConfig(16, 8))
PORT_SMALL_TILING = tiling.TilingConfig(tiling.SpatialTilingConfig(64, 32), tiling.TemporalTilingConfig(16, 8))


@pytest.fixture(scope="module")
def decoder_tree():
    return numpy_tree(jax.jit(lambda k: jdecoder.init_video_decoder(k, JDCFG))(jax.random.PRNGKey(1)), seed=2)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("shape,which", [
    ((1, 128, 16, 16, 24), "default"), ((1, 16, 4, 2, 4), "small"), ((1, 16, 9, 3, 7), "small"),
    ((1, 16, 5, 4, 4), "temporal"), ((1, 16, 1, 5, 3), "spatial"),
])
def test_tile_specs_match_jax(shape, which):
    configs = {
        "default": (jtiling.TilingConfig.default(), tiling.TilingConfig.default()),
        "small": (SMALL_TILING, PORT_SMALL_TILING),
        "temporal": (jtiling.TilingConfig(temporal_config=jtiling.TemporalTilingConfig(24, 8)),
                     tiling.TilingConfig(temporal_config=tiling.TemporalTilingConfig(24, 8))),
        "spatial": (jtiling.TilingConfig(spatial_config=jtiling.SpatialTilingConfig(96, 32)),
                    tiling.TilingConfig(spatial_config=tiling.SpatialTilingConfig(96, 32))),
    }
    jcfg, cfg = configs[which]
    ref = [dataclasses.asdict(s) for s in jtiling.generate_tile_specs(shape, jcfg)]
    got = [dataclasses.asdict(s) for s in tiling.generate_tile_specs(shape, cfg)]
    assert got == ref
    for s in jtiling.generate_tile_specs(shape, jcfg):
        for n, left, right, zero in ((s.out_t_end - s.out_t_start, s.ramp_t_left, s.ramp_t_right, s.out_t_start == 0),
                                     (s.out_w_end - s.out_w_start, s.ramp_w_left, s.ramp_w_right, False)):
            np.testing.assert_array_equal(tiling.compute_trapezoidal_mask_1d(n, left, right, zero),
                                          jtiling.compute_trapezoidal_mask_1d(n, left, right, zero))
    assert tiling.should_auto_tile(shape) == jtiling.should_auto_tile(shape)
    if which == "default":
        assert len(got) == 6  # the 512x768x121 latent: 3 tiles in T x 2 in W


def test_decode_tiled_matches_jax(decoder_tree):
    latent = np.random.default_rng(4).standard_normal((1, 16, 4, 2, 4)).astype(np.float32)
    jp = _jtree(decoder_tree)
    apply = jax.jit(lambda p, z, ts: jdecoder.video_decoder_apply(p, JDCFG, z, timestep=ts))
    ref = list(jtiling.decode_tiled(jnp.asarray(latent), lambda z, timestep=0.05: apply(jp, z, timestep),
                                    SMALL_TILING))[0]
    port = video_decoder_from_numpy(decoder_tree, DCFG)
    out = tiling.decode_tiled(t(latent), lambda z, timestep=0.05: video_decoder_apply(port, z, timestep=timestep),
                              PORT_SMALL_TILING)
    assert out.shape == ref.shape == (1, 3, 25, 64, 128) and out.dtype == torch.float32
    assert_close(out, ref, msg="tiled decode")

    # The pipelines' decode: uint8 frames, against the JAX pipeline's
    # conversion of the same blend (one_stage.py's tiled `_decode_video`).
    jframes = (np.clip((np.asarray(ref) + 1) / 2, 0, 1) * 255).astype(np.uint8)[0].transpose(1, 2, 3, 0)
    frames = decode_video(t(latent), port, PORT_SMALL_TILING, seed=0)
    assert frames.shape == jframes.shape == (25, 64, 128, 3) and frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - jframes.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def recipe(decoder_tree, tmp_path_factory):
    """The JAX pipeline's final latent and frames, and the trees and inputs
    that produced them (and a PNG for the image-conditioning refusal)."""
    dit_tree = numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=1)
    up_tree = numpy_tree(jspatial.init_spatial_upscaler(jax.random.PRNGKey(3), JUPCFG), seed=4)
    context = (np.random.default_rng(5).standard_normal((1, 16, 256)) * 0.02).astype(np.float32)
    pipe = JDistilledPipeline(transformer_params=_jtree(dit_tree), transformer_cfg=JCFG,
                              video_decoder_params=_jtree(decoder_tree), video_decoder_cfg=JDCFG,
                              spatial_upscaler_params=_jtree(up_tree), spatial_upscaler_cfg=JUPCFG)
    config = JDistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, dtype="float32",
                              latent_channels=16)
    latent = pipe(jnp.asarray(context), None, config, skip_decode=True)
    k1, k2, decode_key = jax.random.split(jax.random.PRNGKey(SEED), 3)
    frames = pipe._decode_video(jnp.asarray(latent), OneStageCFGConfig(
        height=HEIGHT, width=WIDTH, num_frames=FRAMES, latent_channels=16), decode_key)
    # Each stage's noise, as the JAX pipeline's noiser draws it: stage 1 at
    # 32x32 (2 x 1 x 1 tokens), stage 2 at 64x64 (2 x 2 x 2 tokens).
    noises = tuple(t(np.asarray(jax.random.normal(jax.random.split(k)[0], (1, n, 16), jnp.float32)))
                   for k, n in ((k1, 2), (k2, 8)))
    image = str(tmp_path_factory.mktemp("image") / "image.png")
    write_png(image, np.random.default_rng(6).integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
    return {"dit": dit_tree, "up": up_tree, "context": context, "latent": np.asarray(latent),
            "frames": frames, "noises": noises, "image": image}


def _port_modules(recipe, decoder_tree):
    return (dit_from_numpy(recipe["dit"], CFG), spatial_upscaler_from_numpy(recipe["up"], UPCFG),
            video_decoder_from_numpy(decoder_tree, DCFG))


def test_distilled_pipeline_latent_matches_jax(recipe, decoder_tree):
    dit, up, dec = _port_modules(recipe, decoder_tree)
    pipe = DistilledPipeline(dit, up, video_decoder=dec)
    config = DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16)
    phases = []
    latent = pipe(t(recipe["context"]), config, skip_decode=True, noises=recipe["noises"],
                  callback=lambda phase, z: phases.append((phase, tuple(z.shape))))
    assert phases == [("stage1", (1, 16, 2, 1, 1)), ("upscale", (1, 16, 2, 2, 2)), ("stage2", (1, 16, 2, 2, 2))]
    assert_close(latent, recipe["latent"], msg="two-stage latent")
    assert config.effective_tiling() is None
    assert DistilledConfig(height=512, width=768).effective_tiling() == tiling.TilingConfig.default()
    with pytest.raises(ValueError):
        DistilledConfig(height=96, width=64)
    with pytest.raises(ValueError, match="video encoder required"):
        pipe(t(recipe["context"]), config, images=[ImageCondition(recipe["image"], 0)])
    # A video-only DiT makes no audio, as in the JAX package, and freeze_audio
    # has nothing to freeze there: the video stream runs as without it (on
    # per-token timesteps, as the JAX package runs a freeze).
    assert pipe(t(recipe["context"]), DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED,
                                                      latent_channels=16, audio_enabled=True),
                skip_decode=True, noises=recipe["noises"])[1] is None
    frozen = pipe(t(recipe["context"]), config, freeze_audio=True, skip_decode=True, noises=recipe["noises"])
    assert_close(frozen, recipe["latent"], msg="freeze_audio on a video-only DiT")


def test_generate_distilled_matches_jax_within_one_level(recipe, decoder_tree):
    dit, up, dec = _port_modules(recipe, decoder_tree)
    videos, stats = generate_videos_distilled(
        [SEED], height=HEIGHT, width=WIDTH, frames=FRAMES, device="cpu", dit=dit, upscaler=up, decoder=dec,
        contexts=[t(recipe["context"])], noises=[recipe["noises"]],
    )
    assert videos[0].shape == recipe["frames"].shape == (FRAMES, HEIGHT, WIDTH, 3) and videos[0].dtype == np.uint8
    assert np.abs(videos[0].astype(int) - recipe["frames"].astype(int)).max() <= 1
    st = stats[0]
    assert st["stage1_latent_finite"] and st["stage2_latent_finite"] and st["decode_tiles"] == 0
    # CPU: the plain versions, never a kernel.
    assert st["attention_launches"] == st["upscale_conv_launches"] == st["decode_conv_launches"] == 0
