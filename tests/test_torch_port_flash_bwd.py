"""The port's differentiable flash attention against the JAX package, in
float32 on the CPU, to a relative 1e-4.

On a CPU tensor `FlashAttention` runs the kernels' plain versions: the
forward with residuals (`flash_attention_residuals_plain`) and the backward
(`flash_attention_bwd_plain`, the math of the upstream `mha_reference_bwd`).
Their gradients are held against `jax.grad` of `ltx2_tpu.ops.attention.sdpa`
(its einsum path on the CPU), the residuals against ring attention's
`_dense_block_residuals`. The CUDA kernels are checked against the same
plain versions by tests/test_torch_port_gpu.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.ops import attention as jattn
from ltx2_tpu.parallel.ring_attention import _dense_block_residuals
from ltx2_tpu_torch.ops import attention
from tests.torch_port_util import assert_close, t

RNG = np.random.default_rng(7)
MASKED = -0.7 * np.finfo(np.float32).max


def randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _key_mask(b, t_k, seed):
    valid = np.random.default_rng(seed).random((b, t_k)) > 0.3
    valid[:, 0] = True  # every row keeps a key: the JAX einsum path averages V over an all-masked row
    return valid, np.where(valid, 0.0, MASKED).astype(np.float32)[:, None, None, :]


@pytest.mark.parametrize("case", ["self", "cross", "masked"])
def test_grads_match_jax(case):
    b, h, d = 2, 2, 64
    t_q, t_k = {"self": (256, 256), "cross": (96, 40), "masked": (48, 72)}[case]
    q, k, v, do = randn(b, h, t_q, d), randn(b, h, t_k, d), randn(b, h, t_k, d), randn(b, h, t_q, d)
    mask = _key_mask(b, t_k, 1)[1] if case == "masked" else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v):
        return jnp.sum(jattn.sdpa(q, k, v, mask=jmask) * jnp.asarray(do))

    jout = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    out = attention.sdpa(*leaves, mask=None if mask is None else t(mask))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, leaves, t(do))
    assert_close(out, jout, msg=f"{case} out")
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert_close(g, jg, msg=f"{case} {name}")


def test_residuals_match_ring_dense_block():
    b, h, t_q, t_k, d = 1, 2, 33, 50, 128
    q, k, v = randn(b, h, t_q, d), randn(b, h, t_k, d), randn(b, h, t_k, d)
    scale = d ** -0.5
    jo, jl, jm = _dense_block_residuals(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    o, l, m = attention.flash_attention_residuals(t(q), t(k), t(v), scale)
    assert l.dtype == m.dtype == torch.float32 and l.shape == (b, h, t_q)
    for name, x, ref in (("o", o, jo), ("l", l, jl), ("m", m, jm)):
        assert_close(x, ref, msg=f"residual {name}")
    assert torch.equal(o, attention.flash_attention_plain(t(q), t(k), t(v), scale))


@pytest.mark.parametrize("masked", [False, True])
def test_function_gradcheck_float64(masked):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, n, 8, generator=gen, dtype=torch.float64, requires_grad=True)
               for n in (5, 7, 7))
    kv_valid = torch.tensor([[1, 0, 1, 1, 0, 0, 1], [0, 1, 1, 0, 1, 1, 1]], dtype=torch.bool) if masked else None
    assert torch.autograd.gradcheck(
        lambda q, k, v: attention.FlashAttention.apply(q, k, v, 0.3, kv_valid), (q, k, v)
    )


def test_all_masked_row_gives_zero_grads_and_no_nan():
    q, k, v, do = (t(randn(2, 2, n, 64)) for n in (6, 9, 9, 6))
    valid = torch.ones(2, 9, dtype=torch.bool)
    valid[1] = False  # every key of the second batch row is masked
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention.flash_attention(*leaves, kv_valid=valid)
    grads = torch.autograd.grad(out, leaves, do)
    o, l, m = attention.flash_attention_residuals(q, k, v, kv_valid=valid)
    assert torch.all(l[1] == 0) and torch.all(torch.isneginf(m[1]))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    for g in grads:
        assert torch.isfinite(g).all()
        assert torch.equal(g[1], torch.zeros_like(g[1]))
        assert g[0].abs().max() > 0


def test_no_residuals_without_a_gradient():
    q = t(randn(1, 2, 8, 64))
    assert attention.flash_attention(q, q, q).grad_fn is None
    with torch.no_grad():
        assert attention.flash_attention(q.requires_grad_(), q, q).grad_fn is None



LOG2E = 1.4426950408889634


def _kernel_order_bwd(q, k, v, o, l, m, do, scale, kv_valid=None):
    """The backward in the fused CUDA kernel's own order, in fp32: 128-key
    blocks outer, 64-row query tiles inner (both zero-padded at the ragged
    end); lse2 = m log2(e) + log2(l), +inf for a padded or all-masked row;
    P = 0 for padded and invalid keys; dK and dV accumulated per key block,
    dQ * scale added across key blocks into an fp32 accumulator."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    di = (o * do).sum(-1)
    lse2 = torch.where(l > 0, m * LOG2E + torch.log2(l), torch.full_like(l, float("inf")))
    valid = torch.ones(b, t_k, dtype=torch.bool) if kv_valid is None else kv_valid.bool()

    def pad(x, n, rows, value=0.0):  # rows n .. n + rows of the token axis (-2 for tiles, -1 for rows)
        axis = x.ndim - 2 if x.ndim == 4 else x.ndim - 1
        part = x.narrow(axis, n, min(rows, x.shape[axis] - n))
        shape = list(part.shape)
        shape[axis] = rows - part.shape[axis]
        return torch.cat([part, torch.full(shape, value, dtype=x.dtype)], axis)

    dq_acc = torch.zeros(b, h, t_q, d)
    dk, dv = torch.zeros(b, h, t_k, d), torch.zeros(b, h, t_k, d)
    for n0 in range(0, t_k, 128):
        kb, vb = pad(k, n0, 128), pad(v, n0, 128)
        key_ok = pad(valid, n0, 128, False)[:, None, :, None]
        dkb, dvb = torch.zeros(b, h, 128, d), torch.zeros(b, h, 128, d)
        for q0 in range(0, t_q, 64):
            qt, dot = pad(q, q0, 64), pad(do, q0, 64)
            lse_t, di_t = pad(lse2, q0, 64, float("inf")), pad(di, q0, 64)
            st = kb @ qt.transpose(-1, -2)
            pt = torch.where(key_ok, torch.exp2(st * (scale * LOG2E) - lse_t[:, :, None, :]), torch.zeros(()))
            dst = pt * (vb @ dot.transpose(-1, -2) - di_t[:, :, None, :])
            dvb += pt @ dot
            dkb += dst @ qt
            rows = min(64, t_q - q0)
            dq_acc[:, :, q0:q0 + rows] += (dst.transpose(-1, -2) @ kb * scale)[:, :, :rows]
        rows = min(128, t_k - n0)
        dk[:, :, n0:n0 + rows] = dkb[:, :, :rows] * scale
        dv[:, :, n0:n0 + rows] = dvb[:, :, :rows]
    return dq_acc, dk, dv


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_order_matches_jax(d, masked):
    b, h, t_q, t_k = 2, 2, 100, 333
    q, k, v, do = randn(b, h, t_q, d), randn(b, h, t_k, d), randn(b, h, t_k, d), randn(b, h, t_q, d)
    valid, mask = _key_mask(b, t_k, 3) if masked else (None, None)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v):
        return jnp.sum(jattn.sdpa(q, k, v, mask=jmask) * jnp.asarray(do))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kv_valid = None if valid is None else torch.from_numpy(valid)
    scale = d ** -0.5
    o, l, m = attention.flash_attention_residuals_plain(t(q), t(k), t(v), scale, kv_valid)
    grads = _kernel_order_bwd(t(q), t(k), t(v), o, l, m, t(do), scale, kv_valid)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert_close(g, jg, msg=f"d={d} masked={masked} {name}")


def test_kernel_order_all_masked_row_gives_zero_grads():
    q, k, v, do = (t(randn(2, 2, n, 64)) for n in (70, 130, 130, 70))
    valid = torch.ones(2, 130, dtype=torch.bool)
    valid[1] = False
    o, l, m = attention.flash_attention_residuals_plain(q, k, v, 0.125, valid)
    grads = _kernel_order_bwd(q, k, v, o, l, m, do, 0.125, valid)
    plain = attention.flash_attention_bwd_plain(q, k, v, o, l, m, do, 0.125, valid)
    for g, p in zip(grads, plain):
        assert torch.isfinite(g).all()
        assert torch.equal(g[1], torch.zeros_like(g[1]))
        assert_close(g[0], p[0])
