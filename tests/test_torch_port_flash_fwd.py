"""The flash-attention forward kernel's arithmetic against the JAX package,
in float32 on the CPU, to a relative 1e-4.

The CUDA kernel (ltx2_tpu_torch/csrc/flash_attention.cu) cannot run here, so
`_kernel_order_fwd` repeats its order of work in fp32 torch: 128-row query
tiles split between two 64-row consumers, 128-key tiles zero-padded at the
ragged end, the scale folded into the exponent of exp2, the running max and
sum with their rescale of O, the rule for a row that has seen no valid key,
and the residuals l and m in Pallas's units. Its output is held against
`ltx2_tpu.ops.attention.sdpa`, its residuals against the port's plain version
and ring attention's `_dense_block_residuals`. The kernel itself is held
against the plain version on the card (tests/test_torch_port_gpu.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.ops import attention as jattn
from ltx2_tpu.parallel.ring_attention import _dense_block_residuals
from ltx2_tpu_torch.ops import attention
from tests.torch_port_util import assert_close, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RNG = np.random.default_rng(11)
MASKED = -0.7 * np.finfo(np.float32).max
LOG2E = 1.4426950408889634
BLOCK_M, HALF, BLOCK_N = 128, 64, 128  # query rows a CTA, a consumer's rows, keys a tile


def randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _rows(x, n, rows, value=0.0):
    """Rows n .. n + rows of the last-but-one axis (the last for a 2-D key
    row), padded with `value` past the end, as TMA zero-fills a tile."""
    axis = x.ndim - 2 if x.ndim == 4 else x.ndim - 1
    part = x.narrow(axis, min(n, x.shape[axis]), max(0, min(rows, x.shape[axis] - n)))
    shape = list(part.shape)
    shape[axis] = rows - part.shape[axis]
    return torch.cat([part, torch.full(shape, value, dtype=x.dtype)], axis)


def _kernel_order_fwd(q, k, v, scale, kv_valid=None):
    """(o, l, m) in the forward kernel's own order, in fp32. Per consumer
    (64 query rows of a 128-row CTA tile) and per 128-key tile: raw scores,
    -inf for padded and invalid keys; the running max m of the raw scores;
    P = exp2(s c - m c) with c = scale log2(e), m taken as 0 while the row has
    no valid key; alpha = exp2(m_old c - m c); l = l alpha + rowsum(P);
    O = O alpha + P V. Then o = O / l (0 where l = 0), l as summed and m times
    scale (the row max of the scaled logits, -inf for a row with no valid key).
    Rows past T_q are computed on zero queries and never stored."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    c = scale * LOG2E
    valid = torch.ones(b, t_k, dtype=torch.bool) if kv_valid is None else kv_valid.bool()
    o, l, m = torch.zeros(b, h, t_q, d), torch.zeros(b, h, t_q), torch.zeros(b, h, t_q)
    for m0 in range(0, t_q, BLOCK_M):
        for r0 in (m0, m0 + HALF):
            qt = _rows(q, r0, HALF)
            acc = torch.zeros(b, h, HALF, d)
            m_i = torch.full((b, h, HALF), float("-inf"))
            l_i = torch.zeros(b, h, HALF)
            for n0 in range(0, t_k, BLOCK_N):
                key_ok = _rows(valid, n0, BLOCK_N, False)[:, None, None, :]
                s = torch.where(key_ok, qt @ _rows(k, n0, BLOCK_N).transpose(-1, -2), float("-inf"))
                m_new = torch.maximum(m_i, s.amax(-1))
                ms = torch.where(torch.isneginf(m_new), torch.zeros(()), m_new) * c
                alpha = torch.exp2(m_i * c - ms)
                p = torch.exp2(s * c - ms[..., None])
                l_i = l_i * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ _rows(v, n0, BLOCK_N)
                m_i = m_new
            rows = min(HALF, t_q - r0)
            if rows <= 0:
                continue
            inv = torch.where(l_i > 0, 1.0 / l_i, torch.zeros(()))
            o[:, :, r0:r0 + rows] = (acc * inv[..., None])[:, :, :rows]
            l[:, :, r0:r0 + rows] = l_i[:, :, :rows]
            m[:, :, r0:r0 + rows] = (m_i * scale)[:, :, :rows]
    return o, l, m


def _key_mask(b, t_k, seed):
    valid = np.random.default_rng(seed).random((b, t_k)) > 0.3
    valid[:, 0] = True  # every row keeps a key: the JAX einsum path averages V over an all-masked row
    return valid, np.where(valid, 0.0, MASKED).astype(np.float32)[:, None, None, :]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_order_matches_jax(d, masked):
    b, h, t_q, t_k = 2, 2, 100, 333
    q, k, v = randn(b, h, t_q, d), randn(b, h, t_k, d), randn(b, h, t_k, d)
    valid, mask = _key_mask(b, t_k, 5) if masked else (None, None)
    scale = d ** -0.5
    kv_valid = None if valid is None else torch.from_numpy(valid)
    o, l, m = _kernel_order_fwd(t(q), t(k), t(v), scale, kv_valid)

    ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=None if mask is None else jnp.asarray(mask))
    assert_close(o, ref, msg=f"d={d} masked={masked} o")
    _, l_plain, m_plain = attention.flash_attention_residuals_plain(t(q), t(k), t(v), scale, kv_valid)
    assert_close(l, l_plain.numpy(), msg="l vs plain")
    assert_close(m, m_plain.numpy(), msg="m vs plain")
    # The ring's dense block has no mask: give it each batch row's valid keys.
    for i in range(b):
        keep = np.ones(t_k, bool) if valid is None else valid[i]
        jo, jl, jm = _dense_block_residuals(jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1][:, :, keep]),
                                            jnp.asarray(v[i:i + 1][:, :, keep]), scale)
        assert_close(o[i:i + 1], jo, msg=f"o vs ring dense block, batch row {i}")
        assert_close(l[i:i + 1], jl, msg=f"l vs ring dense block, batch row {i}")
        assert_close(m[i:i + 1], jm, msg=f"m vs ring dense block, batch row {i}")


def test_kernel_order_all_masked_row():
    q, k, v = (t(randn(2, 2, n, 64)) for n in (70, 130, 130))
    valid = torch.ones(2, 130, dtype=torch.bool)
    valid[1] = False  # every key of the second batch row, across both key tiles
    o, l, m = _kernel_order_fwd(q, k, v, 0.125, valid)
    assert torch.isfinite(o).all() and not torch.isnan(l).any() and not torch.isnan(m).any()
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.all(l[1] == 0) and torch.all(torch.isneginf(m[1]))
    o_plain, l_plain, m_plain = attention.flash_attention_residuals_plain(q, k, v, 0.125, valid)
    assert torch.equal(o_plain[1], o[1]) and torch.equal(l_plain[1], l[1]) and torch.equal(m_plain[1], m[1])
    assert_close(o[0], o_plain[0].numpy())
    assert_close(l[0], l_plain[0].numpy())
    assert_close(m[0], m_plain[0].numpy())
