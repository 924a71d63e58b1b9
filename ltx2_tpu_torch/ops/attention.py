"""Scaled dot-product attention for the H100, forward and backward.

Counterpart of ltx2_tpu/ops/attention.py. Every flash-attention call goes
through hand-written CUDA kernels for a CUDA tensor, and through their plain
PyTorch versions for a CPU tensor; there is no fallback between the two: a
CUDA tensor the kernels cannot take raises.

- `csrc/flash_attention.cu`: the forward (port of the Pallas TPU flash
  forward, plain and key-masked), one warp-specialised wgmma + TMA kernel,
  optionally writing the softmax residuals l and m
  (`flash_attention_residuals`, the counterpart of
  `ltx2_tpu/parallel/ring_attention.py::_flash_impl_residuals`);
- `csrc/flash_attention_bwd.cu`: the backward, one fused wgmma + TMA kernel
  for both Pallas backward kernels (dK/dV and dQ): dK and dV are written
  once per key block, dQ is added across key blocks into an fp32
  accumulator (`flash_attention_bwd_kernel`).

`flash_attention` is differentiable through `FlashAttention`, an autograd
Function whose forward saves (q, k, v, o, l, m) and whose backward launches
the backward kernel; without a gradient to compute it launches the
forward alone, without residuals. Each kernel is built from the repository's
source with nvcc into `ltx2_tpu_torch/_build/` on first use and loaded with
ctypes (`ops/_build.py`, shared with the conv kernel). Each wrapper counts its
launches in its `launches` attribute; the forward also counts those with a
key-valid mask in `flash_attention.key_valid_launches`, each head dim's in
`flash_attention.launches_by_head_dim`, each batch size's in
`flash_attention.launches_by_batch`, each head count's in
`flash_attention.launches_by_heads` and each (query, key) length pair's in
`flash_attention.launches_by_length`; `flash_attention_residuals.launches`
counts those with residuals (the ring's inner; in `launches` too); the
backward each head dim's in `flash_attention_bwd_kernel.launches_by_head_dim`
and each head count's in `flash_attention_bwd_kernel.launches_by_heads`.

`sdpa` sends a call to the kernels or to plain torch ops by contract alone
(`attention_route`), never because a kernel failed: the plain route takes
what the JAX package computes outside Pallas (query-dependent masks, and
fp32 operands where it takes its einsum route, such as Gemma's and the text
connector's attention). A bf16 call without a query-dependent mask always
goes to the kernels, which raise on a CUDA tensor they cannot take.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ltx2_tpu_torch.ops._build import kernel

KERNEL_HEAD_DIMS = (64, 128)

# The JAX package runs its Pallas flash kernel on the TPU only where the
# query count reaches FLASH_MIN_TOKENS, the token counts and the head dim
# are multiples of 128 and, without a mask, T_q == T_k; every other call,
# and every query-dependent mask, takes its einsum route
# (ltx2_tpu/ops/attention.py:27,201-211,231-245).
_JAX_FLASH_MIN_TOKENS = 2048
_JAX_FLASH_TILE = 128

# Additive masks are binary: 0 = attend, <= -1e30 = masked (the models write
# -0.7 * finfo.max). A key-only mask is binarized into key-valid flags here,
# exactly as the JAX package binarizes it into flash segment ids.
_MASK_VALID_THRESHOLD = -1e30

_I64 = ctypes.c_int64


def _accum_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for bf16/fp16/fp32 inputs, float64 for float64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _scores(q, k, scale, kv_valid):
    acc = _accum_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid.bool()[:, None, None, :], float("-inf"))
    return s


def _finite_max(m: torch.Tensor) -> torch.Tensor:
    """The row max with -inf (a row with no valid key) replaced by 0."""
    return torch.where(torch.isinf(m), torch.zeros_like(m), m)


def flash_attention_residuals_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's contract in plain PyTorch: (B, H, T_q, D) x
    (B, H, T_k, D) -> (o in q's dtype, l, m), with fp32 scores and softmax.

    m is the row max of the scaled logits and l the row sum of exp(s - m),
    both fp32 (B, H, T_q) (Pallas's residuals). kv_valid: optional bool/uint8
    (B, T_k); invalid keys get no weight. A query row with no valid key gets
    o = 0, l = 0 and m = -inf."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale, kv_valid)
    m = s.amax(dim=-1)
    p = torch.exp(s - _finite_max(m).detach()[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype))
    # l >= 1 wherever a key is valid; l = 0 (and out = 0) where none is.
    out = out * (1.0 / l.clamp_min(1.0))[..., None]
    return out.to(q.dtype), l, m


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The forward's output alone: see flash_attention_residuals_plain."""
    return flash_attention_residuals_plain(q, k, v, scale, kv_valid)[0]


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    l: torch.Tensor,
    m: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' contract in plain PyTorch, the math of the
    upstream `mha_reference_bwd`: P = exp(s - m) / l from the forward's
    residuals, Di = rowsum(dO * O), dS = P * (dO V^T - Di); returns
    (dQ, dK, dV) = (dS K * scale, dS^T Q * scale, P^T dO) in the inputs'
    dtypes, computed in fp32 (float64 for float64 inputs)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale, kv_valid)
    acc = s.dtype
    p = torch.exp(s - _finite_max(m.to(acc))[..., None]) * (1.0 / l.to(acc).clamp_min(1.0))[..., None]
    dof = do.to(acc)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.to(acc))
    di = (o.to(acc) * dof).sum(dim=-1, keepdim=True)
    ds = p * (dp - di)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"flash_attention: {name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"flash_attention: {name} must be (B, H, T, D), got {tuple(x.shape)}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs a unit stride on D, (B, H, T) strides that "
            f"are multiples of 8 and a 16-byte aligned base (strides {x.stride()})"
        )


def _check_shapes(q, k, v, kv_valid) -> int:
    """Validates q, k, v and kv_valid for the kernels; returns kv_valid's
    batch stride (0 without one)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if t_q == 0 or t_k == 0:
        raise ValueError("flash_attention: empty sequence")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: batch or heads too large for the launch grid {tuple(q.shape)}")
    if kv_valid is None:
        return 0
    if kv_valid.device != q.device or kv_valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("flash_attention: kv_valid must be bool/uint8 on q's device")
    if kv_valid.shape != (b, t_k) or kv_valid.stride(1) != 1:
        raise ValueError(f"flash_attention: kv_valid must be a unit-stride ({b}, {t_k}) tensor")
    return kv_valid.stride(0)


def _token_major(b: int, h: int, t: int, d: int, device) -> torch.Tensor:
    """An empty bf16 (B, H, T, D) view of token-major (B, T, H, D) storage."""
    return torch.empty((b, t, h, d), dtype=torch.bfloat16, device=device).transpose(1, 2)


def _bth(x: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    """(batch, token, head) strides of a (B, H, T, D) tensor, in elements."""
    return (0, 0, 0) if x is None else (x.stride(0), x.stride(2), x.stride(1))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(q, k, v, scale, kv_valid, residuals: bool):
    kv_sb = _check_shapes(q, k, v, kv_valid)
    b, h, t_q, d = q.shape
    fn = kernel("ltx_flash_attention_fwd")
    out = _token_major(b, h, t_q, d, q.device)
    l = m = None
    if residuals:
        l = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(kv_valid), _ptr(l), _ptr(m),
            b, h, t_q, k.shape[2], d, *_bth(q), *_bth(k), *_bth(v), *_bth(out), kv_sb,
            float(scale), _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_head_dim[d] = flash_attention.launches_by_head_dim.get(d, 0) + 1
    flash_attention.launches_by_batch[b] = flash_attention.launches_by_batch.get(b, 0) + 1
    flash_attention.launches_by_heads[h] = flash_attention.launches_by_heads.get(h, 0) + 1
    lengths = (t_q, k.shape[2])
    flash_attention.launches_by_length[lengths] = flash_attention.launches_by_length.get(lengths, 0) + 1
    if kv_valid is not None:
        flash_attention.key_valid_launches += 1
    return out, l, m


def flash_attention_residuals(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, l, m) of non-causal attention over (B, H, T, D) bf16 tensors: the
    output and the softmax residuals (see flash_attention_residuals_plain),
    the counterpart of ring_attention.py's `_flash_impl_residuals`. A CPU
    tensor takes the plain version; a CUDA tensor launches the forward
    kernel with residuals or raises. Not differentiable itself."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_residuals_plain(q, k, v, scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _launch_fwd(q, k, v, scale, kv_valid, residuals=True)
    flash_attention_residuals.launches += 1
    return out


# Launches of the forward kernel with residuals through this wrapper (the
# ring's inner, parallel/ring_attention.py), counted in flash_attention.launches too.
flash_attention_residuals.launches = 0


def _check_stats(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    b, h, t_q, _ = q.shape
    if x.device != q.device or x.dtype != torch.float32 or x.shape != (b, h, t_q) or not x.is_contiguous():
        raise ValueError(f"flash_attention backward: {name} must be contiguous fp32 ({b}, {h}, {t_q}) on "
                         f"{q.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def flash_attention_bwd_kernel(q, k, v, do, l, m, di, scale, kv_valid=None):
    """(dQ, dK, dV) from the fused backward kernel on CUDA (B, H, T, D) bf16
    tensors; l, m are the forward's residuals and di = rowsum(dO * O), fp32
    (B, H, T_q). The kernel adds each key block's share of dQ (scale
    included) into a zeroed fp32 token-major (B, T_q, H, D) accumulator,
    rounded to bf16 here by one cast; the outputs are views of token-major
    storage. Raises on what the kernel does not take."""
    kv_sb = _check_shapes(q, k, v, kv_valid)
    _check_operand("dO", do, q.device)
    if do.shape != q.shape:
        raise ValueError(f"flash_attention backward: dO {tuple(do.shape)} for q {tuple(q.shape)}")
    for name, x in (("l", l), ("m", m), ("Di", di)):
        _check_stats(name, x, q)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    dk, dv = _token_major(b, h, t_k, d, k.device), _token_major(b, h, t_k, d, k.device)
    dq_acc = torch.zeros((b, t_q, h, d), dtype=torch.float32, device=q.device)
    strides = (_I64 * 19)(*_bth(q), *_bth(k), *_bth(v), *_bth(do), *_bth(dk), *_bth(dv), kv_sb)
    with torch.cuda.device(q.device):
        err = kernel("ltx_flash_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), l.data_ptr(), m.data_ptr(), di.data_ptr(), _ptr(kv_valid),
            b, h, t_q, t_k, d, strides, float(scale), _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_attention backward: kernel launch failed with CUDA error {err}")
    flash_attention_bwd_kernel.launches += 1
    by_d = flash_attention_bwd_kernel.launches_by_head_dim
    by_d[d] = by_d.get(d, 0) + 1
    by_h = flash_attention_bwd_kernel.launches_by_heads
    by_h[h] = by_h.get(h, 0) + 1
    return dq_acc.to(torch.bfloat16).transpose(1, 2), dk, dv


flash_attention_bwd_kernel.launches = 0
flash_attention_bwd_kernel.launches_by_head_dim = {}  # {64: n, 128: n}, counted in `launches` too
flash_attention_bwd_kernel.launches_by_heads = {}  # {heads: n} (a TP rank's share), counted in `launches` too


def flash_attention_bwd(q, k, v, o, l, m, do, scale=None, kv_valid=None):
    """(dQ, dK, dV) of flash attention from the forward's saved tensors and
    residuals. A CPU tensor takes flash_attention_bwd_plain; a CUDA tensor
    computes Di = rowsum(dO * O) with torch ops (upstream does it outside
    its kernels too), then launches the fused backward kernel, or raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, l, m, do, scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()  # an upstream op handed back a layout the kernel cannot read
    di = (o.float() * do).sum(dim=-1).contiguous()  # fp32 products: do is promoted inside the multiply
    return flash_attention_bwd_kernel(q, k, v, do, l, m, di, scale, kv_valid)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel with residuals,
    then the backward kernel (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_valid):
        o, l, m = flash_attention_residuals(q, k, v, scale, kv_valid)
        ctx.save_for_backward(q, k, v, o, l, m, kv_valid)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m, kv_valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, l, m, do, ctx.scale, kv_valid)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Non-causal attention over (B, H, T, D) bf16 tensors, T_q may differ
    from T_k, with an optional key-valid mask (B, T_k). Differentiable.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels on the current stream or raises. With a gradient to compute it
    goes through FlashAttention (forward with residuals, backward kernel);
    without one it launches the forward alone and writes no residuals. Any
    (B, H, T) strides are taken (D must be unit-stride), so token-major
    (B, T, H*D) activations viewed as (B, H, T, D) go in without a copy. The
    output is a (B, H, T_q, D) view of token-major storage, so merging heads
    back costs nothing.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, kv_valid)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch_fwd(q, k, v, scale, kv_valid, residuals=False)[0]


flash_attention.launches = 0
flash_attention.key_valid_launches = 0  # the launches with a key-valid mask, counted in `launches` too
flash_attention.launches_by_head_dim = {}  # {64: n, 128: n}, counted in `launches` too
flash_attention.launches_by_batch = {}  # {batch size: n}, counted in `launches` too
flash_attention.launches_by_heads = {}  # {heads: n} (a TP rank's share), counted in `launches` too
flash_attention.launches_by_length = {}  # {(query tokens, key tokens): n}, counted in `launches` too


def mask_kind(mask: Optional[torch.Tensor]) -> Optional[str]:
    """None, "key" for a key-only additive mask (B|1, 1, 1, S), or "query"
    for any other (causal, windowed, per head)."""
    if mask is None:
        return None
    return "key" if mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1 else "query"


def attention_route(dtype: torch.dtype, t_q: int, t_k: int, head_dim: int, kind: Optional[str]) -> str:
    """Which implementation computes an `sdpa` call, decided by the call's
    contract alone (the same on the CPU and the card):

    - "kernel": bf16 operands with no mask or a key-only mask, at any head
      dim: the flash kernels (their plain versions on a CPU tensor). On a
      CUDA tensor they take head dims 64 and 128 and raise on any other;
    - "plain": a query-dependent mask, or operands of another dtype (fp32)
      at a call where the JAX package takes its einsum route: `sdpa_plain`,
      plain torch ops on either device, as the JAX package computes it
      outside any Pallas kernel;
    - anything else raises ValueError: operands of another dtype where the
      JAX package runs its flash kernel (e.g. fp32 unmasked at T >= 2048)."""
    if kind not in (None, "key", "query"):
        raise ValueError(f"attention_route: unknown mask kind {kind!r}")
    if kind == "query":
        return "plain"
    if dtype == torch.bfloat16:
        return "kernel"
    jax_flash = (
        t_q >= _JAX_FLASH_MIN_TOKENS
        and t_q % _JAX_FLASH_TILE == 0 and t_k % _JAX_FLASH_TILE == 0 and head_dim % _JAX_FLASH_TILE == 0
        and (kind == "key" or t_q == t_k)
    )
    if jax_flash:
        raise ValueError(
            f"sdpa: {dtype} attention at T_q={t_q}, T_k={t_k}, D={head_dim} is the JAX package's flash "
            f"route, and the flash kernels take bfloat16 only"
        )
    return "plain"


def sdpa_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The JAX package's einsum route (ltx2_tpu/ops/attention.py:306-316):
    logits in the inputs' dtype, the additive mask added in fp32, fp32
    softmax, probabilities cast to q's dtype for the product with V. A row
    whose keys are all masked by a finite mask averages V."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) * scale).float()
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head SDPA over (B, H, T, D) tensors with an optional additive
    mask broadcasting against (B, H, T_q, T_k): 0 = attend, <= -1e30 =
    masked. `attention_route` picks the flash kernels (a key-only mask
    becomes their key-valid flags) or `sdpa_plain`, or raises."""
    route = attention_route(q.dtype, q.shape[2], k.shape[2], q.shape[-1], mask_kind(mask))
    if route == "plain":
        return sdpa_plain(q, k, v, mask, scale)
    kv_valid = None
    if mask is not None:
        kv_valid = (mask[:, 0, 0, :] > _MASK_VALID_THRESHOLD).expand(q.shape[0], k.shape[2])
        kv_valid = kv_valid.contiguous()
    return flash_attention(q, k, v, scale, kv_valid)


def sdpa_tokens(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    dim_head: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over token-major (B, T, H*D) tensors (the DiT layout). The
    head split and merge are views: nothing is transposed in memory."""
    b, t_q, _ = q.shape
    t_k = k.shape[1]
    qh = q.view(b, t_q, heads, dim_head).transpose(1, 2)
    kh = k.view(b, t_k, heads, dim_head).transpose(1, 2)
    vh = v.view(b, t_k, heads, dim_head).transpose(1, 2)
    if mask is not None and mask.ndim == 2:
        mask = mask[None, None, :, :]
    elif mask is not None and mask.ndim == 3:
        mask = mask[:, None, :, :]
    out = sdpa(qh, kh, vh, mask=mask)
    return out.transpose(1, 2).reshape(b, t_q, heads * dim_head)
