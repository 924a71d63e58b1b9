"""Guidance (counterpart of ltx2_tpu/components/guiders.py): classic CFG,
CFG* (the unconditioned prediction rescaled by its projection onto the
conditioned one, per batch row), CFG with the variance rescale, STG, and
adaptive projected guidance (APG), also with a momentum carry that the
caller threads from step to step, and the audio-video `MultiModalGuider`
(CFG + STG + modality isolation with a std-ratio rescale). Every statistic
is per batch row, so clips batched together do not couple. Scale 1.0
disables the CFG guiders and modality isolation, 0.0 STG and the stateful
APG.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


def projection_coef(to_project: torch.Tensor, project_onto: torch.Tensor) -> torch.Tensor:
    """Per batch row: <a, b> / (<b, b> + 1e-8), shaped to broadcast over a."""
    batch = to_project.shape[0]
    a, b = to_project.reshape(batch, -1), project_onto.reshape(batch, -1)
    coef = (a * b).sum(dim=1, keepdim=True) / ((b * b).sum(dim=1, keepdim=True) + 1e-8)
    return coef.reshape(batch, *([1] * (to_project.ndim - 1)))


@dataclass(frozen=True)
class CFGGuider:
    """Classic classifier-free guidance."""

    scale: float

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return (self.scale - 1) * (cond - uncond)

    def guide(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return cond + self.delta(cond, uncond)

    def enabled(self) -> bool:
        return self.scale != 1.0


@dataclass(frozen=True)
class CFGStarRescalingGuider:
    """CFG*: uncond rescaled by projection_coef(cond, uncond) before the
    classic difference."""

    scale: float

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return (self.scale - 1) * (cond - projection_coef(cond, uncond) * uncond)

    def guide(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return cond + self.delta(cond, uncond)

    def enabled(self) -> bool:
        return self.scale != 1.0


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_cond: torch.Tensor, guidance_rescale: float = 0.7
                      ) -> torch.Tensor:
    """The guided prediction rescaled to the conditioned one's per-row mean
    and (population) standard deviation, blended by `guidance_rescale`
    (arXiv 2305.08891), fp32 math, noise_cfg's dtype out."""
    axes = tuple(range(1, noise_cfg.ndim))
    cfg32, cond32 = noise_cfg.float(), noise_cond.float()
    cfg_mean, cfg_std = cfg32.mean(dim=axes, keepdim=True), cfg32.std(dim=axes, keepdim=True, correction=0)
    cond_mean, cond_std = cond32.mean(dim=axes, keepdim=True), cond32.std(dim=axes, keepdim=True, correction=0)
    rescaled = (cfg32 - cfg_mean) / (cfg_std + 1e-8) * cond_std + cond_mean
    out = guidance_rescale * rescaled + (1.0 - guidance_rescale) * cfg32
    return out.to(noise_cfg.dtype)


@dataclass(frozen=True)
class RescaledCFGGuider:
    """Classic CFG followed by `rescale_noise_cfg`."""

    scale: float
    rescale: float = 0.7

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return self.guide(cond, uncond) - cond

    def guide(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return rescale_noise_cfg(cond + (self.scale - 1) * (cond - uncond), cond, self.rescale)

    def enabled(self) -> bool:
        return self.scale != 1.0


@dataclass(frozen=True)
class STGGuider:
    """Spatio-temporal guidance against a perturbed forward pass."""

    scale: float

    def delta(self, pos_denoised: torch.Tensor, perturbed_denoised: torch.Tensor) -> torch.Tensor:
        return self.scale * (pos_denoised - perturbed_denoised)

    def guide(self, pos_denoised: torch.Tensor, perturbed_denoised: torch.Tensor) -> torch.Tensor:
        return pos_denoised + self.delta(pos_denoised, perturbed_denoised)

    def enabled(self) -> bool:
        return self.scale != 0.0


def _clamp_norm(guidance: torch.Tensor, norm_threshold: float) -> torch.Tensor:
    """Clamp each row's L2 norm (over every axis but the batch) to
    `norm_threshold`."""
    axes = tuple(range(1, guidance.ndim))
    norm = guidance.square().sum(dim=axes, keepdim=True).sqrt()
    return guidance * torch.minimum(torch.ones_like(guidance), norm_threshold / norm)


def _apg_project(guidance: torch.Tensor, cond: torch.Tensor, eta: float) -> torch.Tensor:
    """The guidance's component along `cond` times eta plus the orthogonal rest."""
    g_parallel = projection_coef(guidance, cond) * cond
    return g_parallel * eta + (guidance - g_parallel)


@dataclass(frozen=True)
class LtxAPGGuider:
    """Adaptive projected guidance: cond - uncond, its norm clamped when
    `norm_threshold` > 0, projected by `_apg_project`, times (scale - 1)."""

    scale: float
    eta: float = 1.0
    norm_threshold: float = 0.0

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        guidance = cond - uncond
        if self.norm_threshold > 0:
            guidance = _clamp_norm(guidance, self.norm_threshold)
        return _apg_project(guidance, cond, self.eta) * (self.scale - 1)

    def guide(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        return cond + self.delta(cond, uncond)

    def enabled(self) -> bool:
        return self.scale != 1.0


@dataclass(frozen=True)
class StatefulAPGGuider:
    """APG with a momentum EMA of the guidance, in functional form: `delta`
    and `guide` take the carry and return the new one (None at the first
    step). The loop threads it by its `momentum` attribute, which it has
    whatever its value."""

    scale: float
    eta: float
    norm_threshold: float = 5.0
    momentum: float = 0.0

    def delta(self, cond: torch.Tensor, uncond: torch.Tensor, carry: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        guidance = cond - uncond
        if self.momentum != 0:
            carry = guidance if carry is None else self.momentum * carry + guidance
            guidance = carry
        else:
            carry = guidance if carry is None else carry
        if self.norm_threshold > 0:
            guidance = _clamp_norm(guidance, self.norm_threshold)
        return _apg_project(guidance, cond, self.eta) * self.scale, carry

    def guide(self, cond: torch.Tensor, uncond: torch.Tensor, carry: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        d, carry = self.delta(cond, uncond, carry)
        return cond + d, carry

    def enabled(self) -> bool:
        return self.scale != 0.0


# The reference's name for the stateful APG.
LegacyStatefulAPGGuider = StatefulAPGGuider


def std_ratio_rescale(pred: torch.Tensor, cond: torch.Tensor, rescale_scale: float) -> torch.Tensor:
    """pred * (rescale_scale * std(cond) / std(pred) + 1 - rescale_scale),
    each std the population one over every axis but the batch, plus 1e-8
    under the root: one clip's variance never rescales another's."""
    axes = tuple(range(1, pred.ndim))
    cond_std = torch.sqrt(torch.var(cond, dim=axes, keepdim=True, correction=0) + 1e-8)
    pred_std = torch.sqrt(torch.var(pred, dim=axes, keepdim=True, correction=0) + 1e-8)
    return pred * (rescale_scale * (cond_std / pred_std) + (1 - rescale_scale))


@dataclass(frozen=True)
class MultiModalGuiderParams:
    """The multi-modal guider's parameters."""

    cfg_scale: float = 1.0
    stg_scale: float = 0.0
    stg_blocks: Optional[List[int]] = field(default_factory=list)
    rescale_scale: float = 0.0
    modality_scale: float = 1.0
    skip_step: int = 0


@dataclass(frozen=True)
class MultiModalGuider:
    """CFG + STG + modality-isolation guidance over up to four passes a
    step (a pass that is None is left out), then the std-ratio rescale when
    `rescale_scale` != 0."""

    params: MultiModalGuiderParams
    negative_context: Optional[torch.Tensor] = None

    def calculate(self, cond: torch.Tensor, uncond_text, uncond_perturbed, uncond_modality) -> torch.Tensor:
        p = self.params
        pred = cond
        if isinstance(uncond_text, torch.Tensor):
            pred = pred + (p.cfg_scale - 1) * (cond - uncond_text)
        if isinstance(uncond_perturbed, torch.Tensor):
            pred = pred + p.stg_scale * (cond - uncond_perturbed)
        if isinstance(uncond_modality, torch.Tensor):
            pred = pred + (p.modality_scale - 1) * (cond - uncond_modality)
        if p.rescale_scale != 0:
            pred = std_ratio_rescale(pred, cond, p.rescale_scale)
        return pred

    def do_unconditional_generation(self) -> bool:
        return not math.isclose(self.params.cfg_scale, 1.0)

    def do_perturbed_generation(self) -> bool:
        return not math.isclose(self.params.stg_scale, 0.0)

    def do_isolated_modality_generation(self) -> bool:
        return not math.isclose(self.params.modality_scale, 1.0)

    def should_skip_step(self, step: int) -> bool:
        if self.params.skip_step == 0:
            return False
        return step % (self.params.skip_step + 1) != 0
