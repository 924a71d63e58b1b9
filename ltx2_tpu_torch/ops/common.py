"""NN primitives (counterpart of ltx2_tpu/ops/common.py).

Linear weights are stored [out_features, in_features] as in the checkpoint,
which is already F.linear's layout. A Linear may hold its weight as
fp8-E4M3 codes with a per-tensor `weight_scale` buffer (fp8 serving,
loader/fp8.py), which `linear` dequantizes at use, and may carry LoRA
adapters (`lora_A` (r, in), `lora_B` (out, r) parameters and a `lora_scale`
buffer, added by training/lora.py), which `linear` applies at run time. Not
ported yet: the int8 W8A8 `weight_cscale` (it raises).
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
    (ops/common.py:45-93 of the JAX package)."""
    if getattr(p, "weight_cscale", None) is not None:
        raise NotImplementedError("int8 W8A8 weights (weight_cscale) are not ported yet: ROADMAP.md §1 item 6")
    w, b = p.weight, p.bias
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    scale = getattr(p, "weight_scale", None)
    if scale is not None:
        w = w * scale.to(x.dtype)
    if b is not None and b.dtype != x.dtype:
        b = b.to(x.dtype)
    y = F.linear(x, w, b)
    lora_a = getattr(p, "lora_A", None)
    if lora_a is not None:
        low = F.linear(F.linear(x, lora_a.to(x.dtype)), p.lora_B.to(x.dtype))
        y = y + low * p.lora_scale.to(x.dtype)
    return y


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


def silu_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) * b (the gate of Gemma's MLP)."""
    return F.silu(a) * b


def pixel_norm(x: torch.Tensor, dim: int = 1, eps: float = 1e-6) -> torch.Tensor:
    """RMS normalization across one (channel) axis, fp32 math."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(dim=dim, keepdim=True) + eps)).to(x.dtype)
