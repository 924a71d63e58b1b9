"""fp8-E4M3 weights kept quantized on the card (counterpart of
ltx2_tpu/loader/fp8.py).

A quantized `Linear` holds its weight as E4M3 codes with a per-tensor fp32
`weight_scale` buffer beside it, and `ops.common.linear` dequantizes at use.
The JAX package stacks the DiT's blocks and gives each block's slice of a
stacked weight its own scale (`per_leading_axis`); here every block's
`Linear` is its own tensor, so one scale per `Linear` is the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.ops.common import Linear

FP8_MAX = 448.0  # E4M3FN's largest normal
FP8_DTYPE = torch.float8_e4m3fn

# Linears whose dotted weight name holds one of these stay unquantized: norm
# weights, the AdaLN tables and linears, embeddings.
SKIP_MARKERS = ("norm", "scale_shift_table", "adaln", "embed")


def quantize_tensor_fp8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor E4M3 quantization -> (codes, fp32 0-d scale), in
    fp32 as the JAX package computes it: scale = max(amax / 448, 1e-12),
    codes = w / scale rounded to E4M3."""
    wf = w.to(torch.float32)
    scale = torch.clamp_min(wf.abs().amax() / FP8_MAX, 1e-12)
    return (wf / scale).to(FP8_DTYPE), scale


def set_fp8_weight_(lin: Linear, codes: torch.Tensor, scale: torch.Tensor) -> Linear:
    """Make `lin` an fp8 linear holding `codes` and `scale` (0-d fp32)."""
    if tuple(codes.shape) != tuple(lin.weight.shape):
        raise ValueError(f"fp8 codes {tuple(codes.shape)} for a weight of {tuple(lin.weight.shape)}")
    lin.weight = nn.Parameter(codes, requires_grad=False)
    lin.register_buffer("weight_scale", scale.reshape(()).to(torch.float32))
    return lin


def is_quantized(module: nn.Module) -> bool:
    return any(name.rsplit(".", 1)[-1] in ("weight_scale", "weight_cscale") for name, _ in module.named_buffers())


@torch.no_grad()
def quantize_params_fp8(module: nn.Module, path: str = "") -> nn.Module:
    """Quantize in place every `Linear` of `module` whose dotted weight name
    (prefixed by `path`, the module's own name in its model) holds no skip
    marker; its weight becomes E4M3 codes with a `weight_scale` beside it.
    Raises on a module that holds quantized weights already (their codes
    would be taken for values)."""
    if is_quantized(module):
        raise ValueError(f"fp8 quantization of an already quantized module (weight_scale/weight_cscale present) "
                         f"at '{path}': load it dequantized first")
    for name, mod in module.named_modules():
        full = ".".join(part for part in (path, name, "weight") if part)
        if (isinstance(mod, Linear) and mod.weight.dim() >= 2 and mod.weight.is_floating_point()
                and not any(m in full for m in SKIP_MARKERS)):
            set_fp8_weight_(mod, *quantize_tensor_fp8(mod.weight))
    return module


def weight_bytes(module: nn.Module) -> int:
    """Bytes of `module`'s parameters and buffers."""
    return sum(t.numel() * t.element_size() for t in (*module.parameters(), *module.buffers()))
