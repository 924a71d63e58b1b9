"""The loader's dtype conversions as torch ops (counterpart of
ltx2_tpu/loader/native.py and native/weight_convert.cpp), on whatever
device the tensor is on. They give the same bits as the JAX package's C++
conversions: bf16 -> f32 widening; f32 -> bf16 with round to nearest even,
a NaN kept NaN with its sign and high payload bits (the C++ form: the top
half of the word with the quiet bit set); fp8-E4M3 -> f32(code) *
f32(scale), then the target dtype.
"""

from __future__ import annotations

import torch


def bf16_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def f32_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest even; NaN -> (bits >> 16) | 0x0040."""
    x = x.to(torch.float32)
    out = x.to(torch.bfloat16)  # RNE for every non-NaN value, on the CPU and the card
    nan = torch.isnan(x)
    if bool(nan.any()):
        bits = x[nan].view(torch.int32) >> 16  # arithmetic shift: the sign stays in the int16 range
        out[nan] = (bits | 0x40).to(torch.int16).view(torch.bfloat16)
    return out


def to_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in `dtype`, narrowing to bf16 through `f32_to_bf16`."""
    if x.dtype == dtype:
        return x
    return f32_to_bf16(x) if dtype == torch.bfloat16 else x.to(dtype)


def fp8_e4m3_dequant(codes: torch.Tensor, scale: float, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """f32(code) * f32(scale), then `dtype`."""
    wide = codes.to(torch.float32) * torch.tensor(scale, dtype=torch.float32, device=codes.device)
    return to_dtype(wide, dtype)
