"""Parity of the port's 2x spatial upscaler (ltx2_tpu_torch.models.upscaler)
and the latent (un-)normalization around it with the JAX package, in
float32 on the CPU, on the same weights carried across by
`loader/from_numpy.py` (mid 16 channels, 1 res block per stage, 4 groups).
Every conv takes the plain version of the implicit-GEMM kernel here (zero
padding; the resampler's per-frame conv with a temporal extent of 1).
Tolerance: 1e-4 of the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import ops as jops
from ltx2_tpu_torch.loader.from_numpy import spatial_upscaler_from_numpy
from ltx2_tpu_torch.models.upscaler import spatial
from ltx2_tpu_torch.models.video_vae import ops
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from tests.torch_port_util import assert_close, numpy_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

JCFG = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
CFG = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(jspatial.init_spatial_upscaler(jax.random.PRNGKey(3), JCFG), seed=4)


@pytest.mark.parametrize("shape", [(1, 16, 3, 4, 6), (1, 16, 2, 1, 1), (2, 16, 1, 3, 2)],
                         ids=["3x4x6", "2x1x1", "batch2_t1"])
def test_spatial_upscaler_matches_jax(tree, shape):
    latent = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    ref = jspatial.spatial_upscaler_apply(jax.tree_util.tree_map(jnp.asarray, tree), JCFG, jnp.asarray(latent))
    out = spatial.spatial_upscaler_apply(spatial_upscaler_from_numpy(tree, CFG), t(latent))
    assert out.shape == (shape[0], 16, shape[2], 2 * shape[3], 2 * shape[4])
    assert_close(out, ref, msg=f"upscaler {shape}")


def test_group_norm_and_pixel_shuffle_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 5, 8)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    ref = jspatial.group_norm_video(jnp.asarray(x), 2, jnp.asarray(w), jnp.asarray(b))
    assert_close(spatial.group_norm_video(t(x), 2, t(w), t(b)), ref, msg="group norm")
    y = rng.standard_normal((3, 4, 5, 16)).astype(np.float32)
    assert_close(spatial._pixel_shuffle_2d(t(y), 2), jspatial._pixel_shuffle_2d(jnp.asarray(y), 2),
                 rtol=0, msg="pixel shuffle")


def test_latent_normalization_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 16, 2, 3, 4)).astype(np.float32)
    stats = {"mean_of_means": rng.standard_normal(16).astype(np.float32),
             "std_of_means": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    port_stats = PerChannelStatistics(16)
    port_stats.mean_of_means.copy_(t(stats["mean_of_means"]))
    port_stats.std_of_means.copy_(t(stats["std_of_means"]))
    jstats = {k: jnp.asarray(v) for k, v in stats.items()}
    assert_close(ops.un_normalize_latent(t(x), port_stats), jops.un_normalize_latent(jnp.asarray(x), jstats),
                 msg="un-normalize")
    assert_close(ops.normalize_latent(t(x), port_stats), jops.normalize_latent(jnp.asarray(x), jstats),
                 msg="normalize")
    # bf16 latents are promoted by the fp32 statistics, as in JAX.
    assert ops.un_normalize_latent(t(x).bfloat16(), port_stats).dtype == torch.float32


def test_loader_is_strict_and_init_matches_the_distributions(tree):
    broken = dict(tree)
    del broken["final_conv"]
    with pytest.raises(RuntimeError, match="final_conv"):
        spatial_upscaler_from_numpy(broken, CFG)
    up = spatial.init_spatial_upscaler_(spatial.SpatialUpscaler(CFG), torch.Generator().manual_seed(0))
    assert up.upsampler.conv.weight.shape == (64, 16, 3, 3)
    assert up.upsampler.conv.weight.abs().max() <= (16 * 9) ** -0.5
    assert up.initial_conv.weight.abs().max() <= (16 * 27) ** -0.5
    assert torch.equal(up.initial_norm.weight, torch.ones(16)) and torch.equal(up.res_blocks[0].norm2.bias,
                                                                               torch.zeros(16))
    assert spatial.conv_launches(spatial.SpatialUpscalerConfig()) == 19
