"""Parity of the port's primitives (ltx2_tpu_torch.core, ops.*) with the
JAX package, in float32 on the CPU, to a relative 1e-4.

`sdpa` in fp32 at these sizes takes its plain route (`sdpa_plain`, the JAX
package's einsum route), and `flash_attention` on a CPU tensor runs the
flash kernel's plain PyTorch version (`flash_attention_plain`); both are
held against JAX `sdpa` (its einsum path on the CPU) with and without a key
mask, for T_q != T_k and ragged T. The CUDA kernel itself is checked against
the same plain version by the `gpu`-marked tests in
tests/test_torch_port_gpu.py, and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu import core as jcore
from ltx2_tpu.ops import attention as jattn
from ltx2_tpu.ops import common as jcommon
from ltx2_tpu.ops import rope as jrope
from ltx2_tpu.ops import timestep_embedding as jts
from ltx2_tpu_torch import core
from ltx2_tpu_torch.ops import attention, common, rope, timestep_embedding
from tests.torch_port_util import assert_close, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RNG = np.random.default_rng(0)


def randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_and_to_denoised():
    x, w = randn(2, 5, 64), randn(64)
    assert_close(core.rms_norm(t(x), t(w)), jcore.rms_norm(jnp.asarray(x), jnp.asarray(w)), msg="rms_norm")
    assert_close(core.rms_norm(t(x)), jcore.rms_norm(jnp.asarray(x)), msg="rms_norm no weight")
    v = randn(2, 5, 64)
    assert_close(core.to_denoised(t(x), t(v), 0.7), jcore.to_denoised(jnp.asarray(x), jnp.asarray(v), 0.7))


def test_linear_layer_norm_pixel_norm():
    x, w, b = randn(3, 7, 32), randn(48, 32), randn(48)
    lin = common.Linear(32, 48)
    lin.weight.data, lin.bias.data = t(w), t(b)
    ref = jcommon.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    assert_close(common.linear(lin, t(x)), ref, msg="linear")
    g, bb = randn(32), randn(32)
    assert_close(
        common.layer_norm(t(x), t(g), t(bb)),
        jcommon.layer_norm({"weight": jnp.asarray(g), "bias": jnp.asarray(bb)}, jnp.asarray(x)),
        msg="layer_norm",
    )
    assert_close(common.layer_norm(t(x)), jcommon.layer_norm(None, jnp.asarray(x)), msg="layer_norm plain")
    y = randn(2, 8, 3, 4, 5)
    assert_close(common.pixel_norm(t(y), dim=1), jcommon.pixel_norm(jnp.asarray(y), axis=1), msg="pixel_norm")


def test_init_linear_distribution():
    gen = torch.Generator().manual_seed(0)
    lin = common.init_linear_(common.Linear(256, 512), gen)
    bound = 1 / 16
    for p in (lin.weight, lin.bias):
        assert float(p.abs().max()) <= bound
    # U(-a, a) has variance a^2 / 3.
    assert abs(float(lin.weight.var()) - bound**2 / 3) < 0.05 * bound**2 / 3


@pytest.mark.parametrize("use_middle", [True, False])
def test_rope_tables_and_rotation(use_middle):
    b, n_tok, heads, d_head = 2, 12, 2, 128
    grid = np.stack([RNG.integers(0, 9, (b, 3, n_tok)).astype(np.float32)] * 2, axis=-1)
    grid[..., 1] += 1.0
    grid[:, 0] /= 24.0  # temporal axis in seconds, as the latent tools give it
    kw = dict(dim=heads * d_head, theta=10000.0, max_pos=[20, 2048, 2048],
              use_middle_indices_grid=use_middle, num_attention_heads=heads)
    cos, sin = rope.precompute_freqs_cis(t(grid), **kw)
    jcos, jsin = jrope.precompute_freqs_cis(
        jnp.asarray(grid), rope_type=jrope.LTXRopeType.SPLIT, out_dtype=jnp.float32, **kw
    )
    assert_close(cos, jcos, msg="cos")
    assert_close(sin, jsin, msg="sin")
    x = randn(b, n_tok, heads * d_head)
    ref = jrope.apply_split_rotary_emb(jnp.asarray(x), jcos, jsin)
    assert_close(rope.apply_split_rotary_emb(t(x), cos, sin), ref, msg="token-major rotation")
    xh = randn(b, heads, n_tok, d_head)
    ref_h = jrope.apply_split_rotary_emb(jnp.asarray(xh), jcos, jsin)
    assert_close(rope.apply_split_rotary_emb(t(xh), cos, sin), ref_h, msg="head-major rotation")


def test_timestep_embedding_and_adaln():
    import jax

    steps = np.array([0.0, 3.5, 421.875, 1000.0], np.float32)
    for kw in ({}, {"flip_sin_to_cos": True, "downscale_freq_shift": 0.0}):
        assert_close(
            timestep_embedding.get_timestep_embedding(t(steps), 256, **kw),
            jts.get_timestep_embedding(jnp.asarray(steps), 256, **kw),
            msg=f"sinusoid {kw}",
        )
    jp = jts.init_adaln_single(jax.random.PRNGKey(0), 64, 6)
    port = timestep_embedding.AdaLayerNormSingle(64, 6)
    from ltx2_tpu_torch.loader.from_numpy import flatten_tree

    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in flatten_tree(jp).items()})
    emb, embedded = timestep_embedding.adaln_single_apply(port, t(steps))
    jemb, jembedded = jts.adaln_single_apply(jp, jnp.asarray(steps))
    assert_close(emb, jemb, msg="adaln params")
    assert_close(embedded, jembedded, msg="embedded timestep")


@pytest.mark.parametrize("t_q,t_k", [(64, 64), (37, 64), (64, 23)])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_plain_path_matches_jax(t_q, t_k, masked):
    b, h, d = 2, 2, 128
    q, k, v = randn(b, h, t_q, d), randn(b, h, t_k, d), randn(b, h, t_k, d)
    mask = valid = None
    if masked:
        valid = np.ones((b, t_k), bool)
        valid[0, t_k // 3:] = False
        valid[1, :2] = False
        mask = np.where(valid, 0.0, -0.7 * np.finfo(np.float32).max).astype(np.float32)[:, None, None, :]
    ref = jattn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), mask=None if mask is None else jnp.asarray(mask))
    out = attention.sdpa(t(q), t(k), t(v), mask=None if mask is None else t(mask))
    assert_close(out, ref, msg=f"sdpa masked={masked}")
    flash = attention.flash_attention(t(q), t(k), t(v), kv_valid=None if valid is None else torch.from_numpy(valid))
    assert_close(flash, ref, msg=f"flash_attention plain version masked={masked}")


def test_sdpa_tokens_matches_jax():
    b, tq, tk, heads, d = 1, 20, 9, 2, 128
    q, k, v = randn(b, tq, heads * d), randn(b, tk, heads * d), randn(b, tk, heads * d)
    ref = jattn.sdpa_tokens(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, d)
    assert_close(attention.sdpa_tokens(t(q), t(k), t(v), heads, d), ref, msg="sdpa_tokens")


def test_flash_plain_contract_edges():
    q, k, v = (torch.from_numpy(randn(1, 1, 4, 64)) for _ in range(3))
    valid = torch.zeros(1, 4, dtype=torch.bool)
    out = attention.flash_attention_plain(q, k, v, kv_valid=valid)
    assert torch.equal(out, torch.zeros_like(out)), "a row with no valid key returns 0"
    # A query-dependent mask takes the plain route; fp32 where the JAX package
    # runs its flash kernel has no route and raises.
    assert torch.equal(attention.sdpa(q, k, v, mask=torch.zeros(1, 1, 4, 4)), attention.sdpa_plain(q, k, v))
    long = torch.zeros(1, 1, 2048, 128)
    with pytest.raises(ValueError, match="flash route"):
        attention.sdpa(long, long, long)


def test_cpu_dispatch_counts_no_launch():
    before = attention.flash_attention.launches
    q = torch.from_numpy(randn(1, 2, 8, 128))
    attention.flash_attention(q, q, q)
    assert attention.flash_attention.launches == before

