"""The port's 2x temporal latent upscaler (models/upscaler/temporal.py)
against the JAX package, in float32 on the CPU, on the same weights:

- `group_norm_per_frame` (contiguous groups, statistics per frame) and the
  temporal pixel shuffle's order (the factor the slowest packed channel
  axis), the shuffle exactly;
- the module against `temporal_upscaler_apply` at hidden 32, 1 + 1 res
  blocks, 8 groups: F latent frames -> 2F - 1;
- the loader from a written safetensors under either naming of the
  upsampler's conv, against the JAX loader's tree;
- the one-stage pipeline's post-hoc hook: spatial before temporal, each
  in its own un-normalize / re-normalize bracket, against the JAX
  pipeline on the same noise;
- `generate.main(["--pipeline", "one-stage", "--upscale-temporal",
  "--temporal-upscaler", FILE, ...])` from a tiny checkpoint: the
  upscaled latent against the JAX upscaler on the loop's latent in the
  decoder statistics' bracket, and the .y4m's frame count that of 2F - 1
  latent frames.

Tolerance: 1e-4 of the reference's largest magnitude (RTOL).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.upscaler import temporal as jtemporal
from ltx2_tpu.pipelines.one_stage import OneStageCFGConfig as JOneStageCFGConfig
from ltx2_tpu.pipelines.one_stage import OneStagePipeline as JOneStagePipeline
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, temporal_upscaler_from_numpy, video_decoder_from_numpy
from ltx2_tpu_torch.models.upscaler import temporal
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline
from ltx2_tpu_torch.utils.video_io import y4m_header
from tests.torch_port_util import CFG, JCFG, assert_close, one_intra_op_thread, random_tree, stacked_dit_tree, t

TCFG = temporal.TemporalUpscalerConfig(latent_channels=16, hidden_channels=32, num_res_blocks=1, num_groups=8)
JTCFG = jtemporal.TemporalUpscalerConfig(latent_channels=16, hidden_channels=32, num_res_blocks=1, num_groups=8)
JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
HEIGHT, WIDTH, FRAMES, SEED = 64, 96, 9, 7
TOKENS = 2 * 2 * 3

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def y4m_frames(path: str, height: int, width: int, fps: float = 24.0) -> int:
    """The frame count of a C444 .y4m `write_y4m` wrote, from its size."""
    return (os.path.getsize(path) - len(y4m_header(width, height, fps))) // (6 + 3 * height * width)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def tree():
    return random_tree(temporal.TemporalUpscaler(TCFG, device="meta"), seed=3)


def test_group_norm_per_frame_and_shuffle_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32) * 3 + 1
    x[:, 1] *= 10  # a frame of another scale: the statistics are per frame
    w, b = rng.standard_normal(16).astype(np.float32), rng.standard_normal(16).astype(np.float32)
    ref = jtemporal.group_norm_per_frame(jnp.asarray(x), 4, jnp.asarray(w), jnp.asarray(b))
    got = temporal.group_norm_per_frame(t(x), 4, t(w), t(b))
    assert_close(got, ref, msg="per-frame group norm")
    per_frame = temporal.group_norm_per_frame(t(x[:, 1:2]), 4, t(w), t(b))
    assert_close(got[:, 1:2], per_frame.numpy(), rtol=1e-6, msg="a frame normalized alone")
    y = rng.standard_normal((1, 3, 2, 2, 8)).astype(np.float32)
    shuffled = temporal.temporal_pixel_shuffle(t(y), 2)
    assert_close(shuffled, jtemporal._temporal_pixel_shuffle(jnp.asarray(y), 2), rtol=0, msg="shuffle")
    # "(p1 c)": output frame 2 i + p takes packed channels p * 4 .. p * 4 + 3 of frame i.
    np.testing.assert_array_equal(shuffled[0, 3].numpy(), y[0, 1, :, :, 4:8])


@pytest.mark.parametrize("shape", [(1, 16, 3, 4, 6), (2, 16, 1, 2, 3)], ids=["3x4x6", "batch2_f1"])
def test_temporal_upscaler_matches_jax(tree, shape):
    latent = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ref = jtemporal.temporal_upscaler_apply(_jtree(tree), JTCFG, jnp.asarray(latent))
    out = temporal.temporal_upscaler_apply(temporal_upscaler_from_numpy(tree, TCFG), t(latent))
    assert out.shape == (shape[0], 16, 2 * shape[2] - 1, shape[3], shape[4])
    assert_close(out, ref, msg=f"temporal upscaler {shape}")
    assert temporal.conv_launches(temporal.TemporalUpscalerConfig()) == 19


@pytest.mark.parametrize("naming", ["upsampler.0", "upsampler.conv"])
def test_loader_matches_jax(tree, tmp_path, naming):
    module = temporal_upscaler_from_numpy(tree, TCFG)
    tensors = {name.replace("upsampler.conv", naming): p.detach().numpy() for name, p in module.named_parameters()}
    path = str(tmp_path / "temporal.safetensors")
    jst.write_safetensors(path, tensors)
    loaded = temporal.load_temporal_upscaler_params(path, device="cpu")
    assert loaded.cfg == temporal.TemporalUpscalerConfig(latent_channels=16, hidden_channels=32, num_res_blocks=1)
    jparams = jtemporal.load_temporal_upscaler_params(path)
    latent = np.random.default_rng(4).standard_normal((1, 16, 2, 2, 3)).astype(np.float32)
    ref = jtemporal.temporal_upscaler_apply(jparams, jtemporal.TemporalUpscalerConfig(latent_channels=16,
                                                                                       hidden_channels=32),
                                            jnp.asarray(latent))
    assert_close(temporal.temporal_upscaler_apply(loaded, t(latent)), ref, msg=f"loaded from {naming}")


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(5)
    return {"dit": stacked_dit_tree(CFG, seed=6), "decoder": random_tree(VideoDecoder(DCFG), seed=7),
            "pos": (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32),
            "neg": (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32)}


def test_one_stage_hook_spatial_then_temporal_matches_jax(weights):
    """Both post-hoc upscalers on the JAX pipeline's noise: spatial first,
    then temporal, each inside the decoder statistics' bracket."""
    def spatial(z):
        return z * 1.5 + 0.25

    def frames(cat):  # F -> 2F - 1 frames, not commuting with `spatial`
        return lambda z: cat([z, z[:, :, 1:] * 0.5], 2)

    jpipe = JOneStagePipeline(transformer_params=_jtree(weights["dit"]), transformer_cfg=JCFG,
                              video_decoder_params=_jtree(weights["decoder"]), video_decoder_cfg=JDCFG)
    jconfig = JOneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=2,
                                 latent_channels=16)
    ref, _ = jpipe(jnp.asarray(weights["pos"]), jnp.asarray(weights["neg"]), jconfig, skip_decode=True,
                   spatial_upscaler=spatial, temporal_upscaler=frames(jnp.concatenate))
    noise_key = jax.random.split(jax.random.PRNGKey(SEED), 4)[1]
    noise = t(np.asarray(jax.random.normal(noise_key, (1, TOKENS, 16), jnp.float32)))
    pipe = OneStagePipeline(dit_from_numpy(weights["dit"], CFG), video_decoder=video_decoder_from_numpy(
        weights["decoder"], DCFG))
    config = OneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=2,
                               latent_channels=16)
    phases = []
    got, _ = pipe(t(weights["pos"]), t(weights["neg"]), config, skip_decode=True, noise=noise,
                  spatial_upscaler=spatial, temporal_upscaler=frames(torch.cat),
                  callback=lambda phase, z: phases.append((phase, tuple(z.shape))))
    assert phases == [("denoise", (1, 16, 2, 2, 3)), ("upscale", (1, 16, 2, 2, 3)),
                      ("upscale_temporal", (1, 16, 3, 2, 3))]
    assert_close(got, np.asarray(ref), msg="spatial then temporal, bracketed")


def test_generate_main_upscale_temporal(weights, tmp_path, tree):
    """--upscale-temporal with the upscaler's file and a checkpoint: the
    upscaled latent is the JAX upscaler's on the loop's latent in the
    bracket of the file's statistics; 2 latent frames decode to 17."""
    module = temporal_upscaler_from_numpy(tree, TCFG)
    up_path = str(tmp_path / "temporal.safetensors")
    jst.write_safetensors(up_path, {name.replace("upsampler.conv", "upsampler.0"): p.detach().numpy()
                                    for name, p in module.named_parameters()})
    ckpt = str(tmp_path / "ltx.safetensors")
    decoder = video_decoder_from_numpy(weights["decoder"], DCFG)
    jst.write_safetensors(ckpt, {**jexport.params_to_checkpoint(weights["dit"]), **{
        k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(decoder).items()}},
        metadata={"model_version": "2.0.0", "config": '{"transformer": {"num_attention_heads": 2}}'})
    latents = {}
    call = OneStagePipeline.__call__

    def record(self, positive, negative, config, callback=None, **kwargs):
        def on_phase(phase, z):
            latents[phase] = z
            callback(phase, z)
        return call(self, positive, negative, config, callback=on_phase, **kwargs)

    out = str(tmp_path / "clip.y4m")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OneStagePipeline, "__call__", record)
        videos, stats = generate.main(["--pipeline", "one-stage", "--device", "cpu", "--checkpoint", ckpt,
                                       "--num-inference-steps", "2", "--height", str(HEIGHT), "--width", str(WIDTH),
                                       "--frames", str(FRAMES), "--seed", str(SEED), "--output", out,
                                       "--upscale-temporal", "--temporal-upscaler-weights", up_path])
    assert videos[0].shape == (17, HEIGHT, WIDTH, 3) and y4m_frames(out, HEIGHT, WIDTH) == 17
    st = stats[0]
    assert st["upscale_temporal_latent_finite"] and st["upscale_temporal_conv_launches"] == 0
    statistics = vae_weights.load_per_channel_statistics(ckpt, 16, "cpu")
    mean, std = (np.asarray(getattr(statistics, n)).reshape(1, -1, 1, 1, 1) for n in ("mean_of_means", "std_of_means"))
    z = latents["denoise"].float().numpy()
    jparams = jtemporal.load_temporal_upscaler_params(up_path)
    jcfg = jtemporal.TemporalUpscalerConfig(latent_channels=16, hidden_channels=32, num_res_blocks=1)
    ref = (np.asarray(jtemporal.temporal_upscaler_apply(jparams, jcfg, jnp.asarray(z * std + mean))) - mean) / std
    assert latents["upscale_temporal"].shape == (1, 16, 3, 2, 3)
    assert_close(latents["upscale_temporal"], ref, msg="post-hoc temporal upscale from the file")
