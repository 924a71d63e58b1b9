"""Diffusion steps (counterpart of ltx2_tpu/components/diffusion_steps.py):
Euler, in fp32 whatever the sample's dtype. Heun, ancestral and Res2s are
not ported (ROADMAP.md §1 items 4 and 6)."""

from __future__ import annotations

from typing import Union

import torch

Scalar = Union[float, torch.Tensor]


def _velocity_f32(sample: torch.Tensor, sigma: Scalar, denoised_sample: torch.Tensor) -> torch.Tensor:
    """(x - x0) / sigma in fp32: the steppers' fp32 island (the public
    core.to_velocity casts back to the sample's dtype)."""
    return (sample.float() - denoised_sample.float()) / torch.as_tensor(sigma, dtype=torch.float32)


class EulerDiffusionStep:
    """x <- x + v * (sigma_next - sigma), fp32 math, the sample's dtype out."""

    def step(self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigma: Scalar, sigma_next: Scalar,
             **_kwargs) -> torch.Tensor:
        velocity = _velocity_f32(sample, sigma, denoised_sample)
        dt = torch.as_tensor(sigma_next, dtype=torch.float32) - torch.as_tensor(sigma, dtype=torch.float32)
        return (sample.float() + velocity * dt).to(sample.dtype)
