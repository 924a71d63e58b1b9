"""Parity of the port's video VAE decoder (ltx2_tpu_torch.models.video_vae)
with the JAX package, in float32 on the CPU, on the same weights
(base_channels=16): conv3d padding rules, the decoder with and without
timestep conditioning (decode noise injected into both), and the chunked,
crossfaded decode to uint8 frames. Tolerance: a relative 1e-4 on the
decoded video, 1 level on uint8 frames (a value within 1e-4 of a level
boundary may truncate to either side).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx2_tpu.models.video_vae import chunking as jchunking
from ltx2_tpu.models.video_vae import conv as jconv
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu_torch.loader.from_numpy import video_decoder_from_numpy
from ltx2_tpu_torch.models.video_vae import chunking, conv, decoder
from tests.torch_port_util import assert_close, numpy_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

JCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32")
CFG = decoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32")
RNG = np.random.default_rng(7)


@pytest.fixture(scope="module")
def weights():
    init = jax.jit(lambda k: jdecoder.init_video_decoder(k, JCFG))  # eager init is op-by-op slow
    tree = numpy_tree(init(jax.random.PRNGKey(0)), seed=8)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


@pytest.mark.parametrize("causal", [True, False])
def test_conv3d_padding(causal):
    x = RNG.standard_normal((1, 4, 5, 6, 8)).astype(np.float32)
    w = (RNG.standard_normal((12, 8, 3, 3, 3)) * 0.1).astype(np.float32)
    b = RNG.standard_normal(12).astype(np.float32)
    ref = jconv.conv3d_ndhwc({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), causal=causal)
    p = conv.Conv3d(8, 12)
    p.weight.data, p.bias.data = t(w), t(b)
    assert_close(conv.conv3d_ndhwc(p, t(x), causal=causal), ref, msg=f"conv3d causal={causal}")


@pytest.mark.parametrize("timestep", [0.05, None])
def test_decoder(weights, timestep):
    jp, tree = weights
    port = video_decoder_from_numpy(tree, CFG)
    latent = RNG.standard_normal((1, 16, 3, 2, 2)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    apply = jax.jit(lambda p, x, k: jdecoder.video_decoder_apply(p, JCFG, x, timestep=timestep, noise_key=k))
    ref = apply(jp, jnp.asarray(latent), key)
    noise = np.asarray(jax.random.normal(key, latent.shape, jnp.float32))
    out = decoder.video_decoder_apply(port, t(latent), timestep=timestep, noise=t(noise))
    assert out.shape == (1, 3, 17, 64, 64)
    assert_close(out, ref, msg=f"decoder timestep={timestep}")


def test_chunked_decode_to_uint8(weights):
    jp, tree = weights
    # Noise scale 0: chunk noise comes from each package's own RNG, so it is
    # switched off here; the decoder test above holds the injection itself.
    jcfg = dataclasses.replace(JCFG, decode_noise_scale=0.0)
    port = video_decoder_from_numpy(tree, dataclasses.replace(CFG, decode_noise_scale=0.0))
    latent = RNG.standard_normal((1, 16, 5, 2, 2)).astype(np.float32)
    ref = jchunking.decode_latent(jnp.asarray(latent), jp, jcfg, temporal_chunk_size=4, temporal_overlap=2)
    out = chunking.decode_latent(t(latent), port, temporal_chunk_size=4, temporal_overlap=2)
    assert out.shape == ref.shape == (33, 64, 64, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        chunking.decode_latent(t(latent), port, temporal_chunk_size=2, temporal_overlap=2)
