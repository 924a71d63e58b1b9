"""Core numerical utilities (counterpart of ltx2_tpu/core.py)."""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

Scalar = Union[float, torch.Tensor]


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent; never
    falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU; pass "
            "device='cpu' explicitly to run the plain PyTorch path"
        )
    return device


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """RMS-normalize `x` over its last dim; fp32 math, input dtype out."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def check_config_value(config: dict, key: str, expected: Any) -> None:
    """Raise ValueError unless config[key] is `expected`."""
    actual = config.get(key)
    if actual != expected:
        raise ValueError(f"Config value {key} is {actual}, expected {expected}")


def to_velocity(sample: torch.Tensor, sigma: Scalar, denoised_sample: torch.Tensor) -> torch.Tensor:
    """velocity = (x - x0) / sigma, computed in fp32, the sample's dtype out."""
    return ((sample.float() - denoised_sample.float()) / sigma).to(sample.dtype)


def to_denoised(sample: torch.Tensor, velocity: torch.Tensor, sigma: Scalar) -> torch.Tensor:
    """x0 = x - sigma * v, computed in fp32."""
    return (sample.float() - velocity.float() * sigma).to(sample.dtype)
