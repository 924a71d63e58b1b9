"""NN primitives (counterpart of ltx2_tpu/ops/common.py).

Linear weights are stored [out_features, in_features] as in the checkpoint,
which is already F.linear's layout. A Linear may hold its weight as
fp8-E4M3 codes with a per-tensor `weight_scale` buffer (fp8 serving,
loader/fp8.py), which `linear` dequantizes at use, and may carry LoRA
adapters (`lora_A` (r, in), `lora_B` (out, r) parameters and a `lora_scale`
buffer, added by training/lora.py), which `linear` applies at run time. An
int8 W8A8 weight (`--int8`, loader/int8.py) holds int8 codes with a
per-out-channel fp32 `weight_cscale` (out,), and `linear` quantizes the
activations per token and multiplies in int32 (`w8a8_matmul`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Module):
    """Parameter holder for `linear`: weight (out, in) and optional bias.
    Parameters start uninitialised; see `init_linear_`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = (
            nn.Parameter(torch.empty(out_features, device=device, dtype=dtype), requires_grad=False)
            if bias else None
        )


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b in x's dtype; weights of another float dtype are cast
    to x's, as the JAX package does. An fp8 weight with its `weight_scale`
    dequantizes in the JAX package's order: the codes cast to x's dtype,
    then times the scale rounded to x's dtype, in x's dtype. With LoRA
    adapters on `p`, adds scale * (x A^T) B^T, A and B cast to x's dtype
    (ops/common.py:45-93 of the JAX package). An int8 weight with its
    `weight_cscale` goes through `w8a8_matmul`, then the bias in x's dtype."""
    w, b = p.weight, p.bias
    cscale = getattr(p, "weight_cscale", None)
    if b is not None and b.dtype != x.dtype:
        b = b.to(x.dtype)
    if cscale is not None:
        y = w8a8_matmul(x, w, cscale)
        if b is not None:
            y = y + b
    else:
        if w.dtype != x.dtype:
            w = w.to(x.dtype)
        scale = getattr(p, "weight_scale", None)
        if scale is not None:
            w = w * scale.to(x.dtype)
        y = F.linear(x, w, b)
    lora_a = getattr(p, "lora_A", None)
    if lora_a is not None:
        low = F.linear(F.linear(x, lora_a.to(x.dtype)), p.lora_B.to(x.dtype))
        y = y + low * p.lora_scale.to(x.dtype)
    return y


# torch._int_mm's contract on the card (cuBLASLt's int8 GEMM): more than 16
# rows, and the contraction and output widths multiples of 8.
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8

# Launches of torch._int_mm by `int8_matmul`, by the shape (rows, k, n) of
# each, for the callers that count where the int8 product ran.
int_mm_launches: dict = {}


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 codes -> the exact (M, N) int32 product.

    On a CUDA tensor: torch._int_mm (cuBLASLt's int8 GEMM), chosen by its
    stated contract (`INT_MM_MIN_ROWS` rows or more, K and N multiples of
    `INT_MM_MULTIPLE`); a shape outside it raises and names itself. The
    JAX package computes this product as an XLA dot_general, not a Pallas
    kernel. On the CPU: the plain version, a float64 product, which is the
    int32 product exactly (every partial sum is an integer below 2**53:
    at most K * 127**2)."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.device.type == "cuda":
        if m < INT_MM_MIN_ROWS or k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
            raise ValueError(f"int8 matmul of {m} rows x K {k} -> N {n}: torch._int_mm needs more than 16 rows and "
                             f"K and N multiples of {INT_MM_MULTIPLE}")
        int_mm_launches[(m, k, n)] = int_mm_launches.get((m, k, n), 0) + 1
        return torch._int_mm(x_q, w_q.t())
    if x_q.device.type != "cpu":
        raise ValueError(f"int8 matmul on {x_q.device}: the card (torch._int_mm) or the CPU's plain version only")
    return int8_matmul_plain(x_q, w_q)


def int8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 codes, computed in float64 (exact,
    see `int8_matmul`), on any device."""
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def quantize_activations_int8(x: torch.Tensor):
    """Per-token symmetric int8 of x's last axis: (codes int8, fp32 scale
    (..., 1)), xscale = max(amax, 1e-8) * (1 / 127), codes = round(x /
    xscale), half to even (the amax maps to exactly +-127, no clip)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    xscale = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)  # the Python scalars round to fp32, as in JAX
    return torch.round(xf / xscale).to(torch.int8), xscale


def w8a8_matmul(x: torch.Tensor, w_q: torch.Tensor, cscale: torch.Tensor) -> torch.Tensor:
    """The int8 W8A8 product of ltx2_tpu/ops/common.py::_w8a8_matmul:
    per-token dynamic activation codes against per-out-channel weight codes,
    accumulated in int32, then (y * xscale * cscale) in fp32, in that order,
    cast to x's dtype."""
    x_q, xscale = quantize_activations_int8(x)
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[0])
    return (y.float() * xscale * cscale.float()).to(x.dtype)


def dequantize_int8(p: Linear, dtype: torch.dtype) -> torch.Tensor:
    """An int8 weight dequantized per out-channel in fp32, cast to `dtype`
    (the JAX package's cached text-K/V route, model.py:376-405)."""
    return (p.weight.float() * p.weight_cscale.float()[:, None]).to(dtype)


def linear_row_parallel(p: Linear, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
    """`linear` whose in-features (and x's last dim) are split over the
    mesh axis `tp_axis` (Megatron row-parallel; ltx2_tpu/ops/common.py:95-114):
    each rank's partial product (its LoRA delta included), summed over the
    axis in fp32 (`collectives.all_reduce`), then the replicated bias added
    once, cast to x's dtype. An int8 weight quantizes the activations with
    the per-token amax over the whole in-features (the max over the axis),
    as the unsplit product does. tp_axis None, or of one rank: `linear`."""
    if tp_axis is None or tp_axis.size == 1:
        return linear(p, x)
    from ltx2_tpu_torch.parallel.collectives import all_reduce, all_reduce_max

    cscale = getattr(p, "weight_cscale", None)
    if cscale is not None:
        xf = x.float()
        amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), tp_axis)
        xscale = torch.clamp_min(amax, 1e-8) * (1.0 / 127.0)
        x_q = torch.round(xf / xscale).to(torch.int8)
        w_q = p.weight
        y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[0])
        y = y.float() * xscale * cscale.float()
    else:
        w = p.weight if p.weight.dtype == x.dtype else p.weight.to(x.dtype)
        scale = getattr(p, "weight_scale", None)
        if scale is not None:
            w = w * scale.to(x.dtype)
        y = F.linear(x, w)
    lora_a = getattr(p, "lora_A", None)
    if lora_a is not None:
        low = F.linear(F.linear(x, lora_a.to(x.dtype)), p.lora_B.to(x.dtype))
        y = y + low * p.lora_scale.to(x.dtype)
    y = all_reduce(y, tp_axis)
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)


@torch.no_grad()
def init_linear_(p: Linear, generator: torch.Generator) -> Linear:
    """LeCun-uniform U(-1/sqrt(in), 1/sqrt(in)) for weight and bias, the
    distribution of ltx2_tpu.ops.common.init_linear, drawn in place on the
    parameters' device from `generator`."""
    bound = 1.0 / (p.weight.shape[1] ** 0.5)
    p.weight.uniform_(-bound, bound, generator=generator)
    if p.bias is not None:
        p.bias.uniform_(-bound, bound, generator=generator)
    return p


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 math; weight/bias optional."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel axis 1 of (B, C, ...): fp32 statistics (biased
    variance) over each group's channels and every other non-batch axis,
    optional affine (C,) weight and bias in fp32, x's dtype out."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    var, mean = torch.var_mean(xf, dim=2, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    if weight is not None:
        out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def silu_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) * b (the gate of Gemma's MLP)."""
    return F.silu(a) * b


def pixel_norm(x: torch.Tensor, dim: int = 1, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization across one (channel) axis, fp32 math."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(dim=dim, keepdim=True) + eps)).to(x.dtype)
