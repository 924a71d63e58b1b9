"""Diffusion steps (counterpart of ltx2_tpu/components/diffusion_steps.py):
Euler and Heun, in fp32 whatever the sample's dtype. Ancestral and Res2s
are not ported (ROADMAP.md §1 item 5)."""

from __future__ import annotations

from typing import Optional, Union

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


class HeunDiffusionStep:
    """Predictor-corrector Heun; the caller supplies the model's second
    evaluation, at the Euler predictor (`predict`). Without it, an Euler
    step. At sigma_next == 0 the corrector's velocity is undefined and the
    step returns the predictor, which there is the denoised sample."""

    def step(self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigma: Scalar, sigma_next: Scalar,
             denoised_at_predicted: Optional[torch.Tensor] = None, **_kwargs) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
        sigma_next = torch.as_tensor(sigma_next, dtype=torch.float32, device=sample.device)
        dt = sigma_next - sigma
        velocity = _velocity_f32(sample, sigma, denoised_sample)
        predicted = sample.float() + velocity * dt
        if denoised_at_predicted is None:
            return predicted.to(sample.dtype)
        sn_safe = torch.where(sigma_next == 0.0, torch.ones_like(sigma_next), sigma_next)
        velocity_at_predicted = _velocity_f32(predicted, sn_safe, denoised_at_predicted)
        heun = sample.float() + 0.5 * (velocity + velocity_at_predicted) * dt
        return torch.where(sigma_next == 0.0, predicted, heun).to(sample.dtype)

    def predict(self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigma: Scalar,
                sigma_next: Scalar) -> torch.Tensor:
        """The Euler predictor, where the caller runs the second evaluation."""
        return EulerDiffusionStep().step(sample, denoised_sample, sigma, sigma_next)
