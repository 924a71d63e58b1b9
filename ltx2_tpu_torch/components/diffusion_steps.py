"""Diffusion steps (counterpart of ltx2_tpu/components/diffusion_steps.py):
Euler, Euler-ancestral, Heun and Res2s, in fp32 whatever the sample's
dtype. Res2s's SDE coefficients are host float math: its sigmas are
Python floats, as the ti2vid-hq loop drives it."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

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


def get_ancestral_step(sigma_from: Scalar, sigma_to: Scalar, eta: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigma_up, sigma_down) of an ancestral step, fp32:
    up = min(to, eta * sqrt(max(to^2 (from^2 - to^2) / from^2, 0))), 0 at
    to == 0; down = sqrt(max(to^2 - up^2, 0))."""
    sigma_from = torch.as_tensor(sigma_from, dtype=torch.float32)
    sigma_to = torch.as_tensor(sigma_to, dtype=torch.float32)
    safe_from = torch.where(sigma_from == 0.0, torch.ones_like(sigma_from), sigma_from)
    up = torch.minimum(sigma_to, eta * torch.sqrt(torch.clamp_min(
        sigma_to ** 2 * (sigma_from ** 2 - sigma_to ** 2) / safe_from ** 2, 0.0)))
    sigma_up = torch.where(sigma_to == 0.0, torch.zeros_like(up), up)
    sigma_down = torch.sqrt(torch.clamp_min(sigma_to ** 2 - sigma_up ** 2, 0.0))
    return sigma_up, sigma_down


class EulerAncestralDiffusionStep:
    """Euler-ancestral: a deterministic step to sigma_down, then noise *
    sigma_up. The noise is `noise`, or drawn from `generator` in fp32;
    with neither only the deterministic sub-step runs (a testing
    affordance: the sample then lands under-noised at sigma_down)."""

    def step(self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigma: Scalar, sigma_next: Scalar,
             noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
             **_kwargs) -> torch.Tensor:
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
        sigma_next = torch.as_tensor(sigma_next, dtype=torch.float32, device=sample.device)
        sigma_up, sigma_down = get_ancestral_step(sigma, sigma_next)
        velocity = _velocity_f32(sample, sigma, denoised_sample)
        result = sample.float() + velocity * (sigma_down - sigma)
        if noise is None and generator is not None:
            noise = torch.randn(result.shape, generator=generator, dtype=torch.float32, device=sample.device)
        if noise is not None:
            result = result + noise.float() * sigma_up
        return result.to(sample.dtype)


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


class Res2sDiffusionStep:
    """The 2nd-order exponential-integrator step with SDE noise mixing;
    sigma and sigma_next are Python floats (its coefficients are host
    float math over the static schedule)."""

    @staticmethod
    def get_sde_coeff(sigma_next: float, sigma_up: Optional[float] = None, sigma_down: Optional[float] = None,
                      sigma_max: Optional[float] = None) -> Tuple[float, float, float]:
        """(alpha_ratio, sigma_down, sigma_up), host floats."""
        if sigma_down is not None:
            alpha_ratio = (1 - sigma_next) / (1 - sigma_down)
            sigma_up = max(sigma_next ** 2 - sigma_down ** 2 * alpha_ratio ** 2, 0.0) ** 0.5
        elif sigma_up is not None:
            sigma_up = min(sigma_up, sigma_next * 0.9999)
            sigma_signal = (sigma_max if sigma_max is not None else 1.0) - sigma_next
            sigma_residual = max(sigma_next ** 2 - sigma_up ** 2, 0.0) ** 0.5
            alpha_ratio = sigma_signal + sigma_residual
            sigma_down = sigma_residual / alpha_ratio if alpha_ratio != 0 else sigma_next
        else:
            alpha_ratio, sigma_down, sigma_up = 1.0, sigma_next, 0.0
        if math.isnan(sigma_up):
            sigma_up = 0.0
        if math.isnan(sigma_down):
            sigma_down = sigma_next
        if math.isnan(alpha_ratio):
            alpha_ratio = 1.0
        return alpha_ratio, sigma_down, sigma_up

    def step(self, sample: torch.Tensor, denoised_sample: torch.Tensor, sigma: float, sigma_next: float,
             noise: Optional[torch.Tensor] = None, **_kwargs) -> torch.Tensor:
        """alpha_ratio * (denoised_next + sigma_down * eps_next) [+ sigma_up
        * noise] in fp32, the denoised sample's dtype out; the denoised
        sample itself where sigma_up or sigma_next is 0."""
        alpha_ratio, sigma_down, sigma_up = self.get_sde_coeff(float(sigma_next), sigma_up=float(sigma_next) * 0.5)
        if sigma_up == 0.0 or float(sigma_next) == 0.0:
            return denoised_sample
        sample_f32, denoised_f32 = sample.float(), denoised_sample.float()
        eps_next = (sample_f32 - denoised_f32) / (float(sigma) - float(sigma_next))
        denoised_next = sample_f32 - float(sigma) * eps_next
        x_noised = alpha_ratio * (denoised_next + sigma_down * eps_next)
        if noise is not None:
            x_noised = x_noised + sigma_up * noise.float()
        return x_noised.to(denoised_sample.dtype)
