"""The two VAE decodes over several ranks, and the conv's W-valid mode, on
the CPU against the JAX package.

- the conv's W-valid mode (`conv3d_plain(..., w_valid=True)`, the halo
  already in the input): each W slab with its halo columns gives its slice
  of the whole conv, bit for bit, for both padding modes;
- `decode_w_sharded` over 2 and 4 gloo ranks (at 4 each rank's latent slab
  is 1 column wide: as narrow as the halo) against the JAX package's
  `decode_w_sharded` on the host devices, and against the port's unsharded
  decode; the tile-parallel `decode_tiled(mesh=...)` at 2 and 4 ranks
  against the JAX package's tile-DP decode. No decode noise (the JAX
  package folds its key per shard; the port draws the whole latent's noise
  and slices it). fp32, to 1e-4 of max|x|.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import tiling as jtiling
from ltx2_tpu.parallel import mesh as jmesh
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.ops.conv3d import conv3d_plain
from tests.torch_port_util import assert_close, random_tree, spawn_ranks, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# The decoder at 16 base channels with one res layer a group (three
# compress_all upsamplers, so the published 8 x 32 x 32 scale).
BLOCKS = (("res_x", 1), ("compress_all", 2, True), ("res_x", 1), ("compress_all", 2, True), ("res_x", 1),
          ("compress_all", 2, True), ("res_x", 1))
DEC = dict(decoder_blocks=BLOCKS, base_channels=16, latent_channels=16, compute_dtype="float32",
           decode_noise_scale=0.0)
JDCFG = jdecoder.VideoDecoderConfig(**DEC)
LATENT = (1, 16, 2, 2, 4)  # W 4: 2 columns a rank at 2, 1 at 4
TILED_LATENT = (1, 16, 4, 2, 4)
TILING = ((64, 32), (16, 8))  # 2-column / 2-frame tiles: 3 x 1 x 3 of them


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_w_valid_slabs_give_the_whole_conv(mode):
    """A W slab with its halo columns (the neighbours', or the padding rule
    at the edges) through the W-valid conv is its slice of the whole conv."""
    rng = np.random.default_rng(2)
    x = t(rng.standard_normal((1, 3, 4, 6, 16)).astype(np.float32))
    w = t(rng.standard_normal((3, 3, 3, 16, 8)).astype(np.float32) * 0.1)
    b = t(rng.standard_normal(8).astype(np.float32))
    whole = conv3d_plain(x, w, b, True, mode, "replicate")
    if mode == "reflect":
        padded = torch.cat([x[:, :, :, 1:2], x, x[:, :, :, -2:-1]], dim=3)
    else:
        padded = torch.nn.functional.pad(x, (0, 0, 1, 1))
    for lo, hi in ((0, 2), (2, 3), (3, 6)):
        slab = conv3d_plain(padded[:, :, :, lo:hi + 2], w, b, True, mode, "replicate", w_valid=True)
        assert torch.equal(slab, whole[:, :, :, lo:hi]), (lo, hi)
    with pytest.raises(ValueError, match="W-valid"):
        conv3d_plain(padded, w, b, stride=(1, 1, 2), w_valid=True)


@pytest.fixture(scope="module")
def decoder_tree():
    return random_tree(VideoDecoder(VideoDecoderConfig(**DEC)), 3)


@pytest.fixture(scope="module")
def latents():
    rng = np.random.default_rng(4)
    return (rng.standard_normal(LATENT).astype(np.float32), rng.standard_normal(TILED_LATENT).astype(np.float32))


def _jmesh(n):
    return jmesh.create_mesh(data=n, model=1, devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def decodes(decoder_tree, latents, tmp_path_factory):
    """One launch of 4 ranks: W-sharded over all 4 and over the first 2
    (ranks 2 and 3 outside that mesh), tile-parallel over 4 and over 2."""
    from tests.torch_port_parallel_workers import run_jobs

    lat, tiled = latents
    cases = [("w2", "w", lat, 2), ("w4", "w", lat, 4), ("tiles2", "tiles", tiled, 2, TILING),
             ("tiles4", "tiles", tiled, 4, TILING)]
    return spawn_ranks(run_jobs, 4, tmp_path_factory.mktemp("vae"),
                       [("vae", "vae_decodes", (decoder_tree, DEC, cases))])


@pytest.mark.parametrize("n", [2, 4])
def test_w_sharded_decode_matches_jax(decodes, decoder_tree, latents, n):
    from ltx2_tpu_torch.loader.from_numpy import video_decoder_from_numpy
    from ltx2_tpu_torch.models.video_vae.decoder import video_decoder_apply

    lat = latents[0]
    outs = [r["vae"][f"w{n}"] for r in decodes[:n]]
    assert all(f"w{n}" not in r["vae"] for r in decodes[n:])  # outside the mesh: no decode
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    jp = jax.tree_util.tree_map(jnp.asarray, decoder_tree)
    ref = np.asarray(jtiling.decode_w_sharded(jnp.asarray(lat), jp, JDCFG, _jmesh(n), key=None))
    assert outs[0].shape == ref.shape == (1, 3, 9, 64, 128)
    assert_close(outs[0], ref, msg=f"W-sharded over {n}")
    whole = video_decoder_apply(video_decoder_from_numpy(decoder_tree, VideoDecoderConfig(**DEC)), t(lat))
    assert_close(outs[0], whole, msg=f"W-sharded over {n} against the unsharded decode")


@pytest.mark.parametrize("n", [2, 4])
def test_tile_parallel_decode_matches_jax(decodes, decoder_tree, latents, n):
    tiled = latents[1]
    outs = [r["vae"][f"tiles{n}"] for r in decodes[:n]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    jp = jax.tree_util.tree_map(jnp.asarray, decoder_tree)
    apply = jax.jit(lambda p, z, ts: jdecoder.video_decoder_apply(p, JDCFG, z, timestep=ts))
    (sp, tmp) = TILING
    jcfg = jtiling.TilingConfig(jtiling.SpatialTilingConfig(*sp), jtiling.TemporalTilingConfig(*tmp))
    ref = list(jtiling.decode_tiled(jnp.asarray(tiled), lambda z, timestep=0.05: apply(jp, z, timestep), jcfg,
                                    mesh=_jmesh(n)))[0]
    assert outs[0].shape == ref.shape == (1, 3, 25, 64, 128)
    assert_close(outs[0], ref, msg=f"tile-parallel over {n}")
