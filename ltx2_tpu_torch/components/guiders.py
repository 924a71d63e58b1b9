"""Guidance (counterpart of ltx2_tpu/components/guiders.py): classic CFG
and CFG* (the unconditioned prediction rescaled by its projection onto the
conditioned one, per batch row). Scale 1.0 disables either."""

from __future__ import annotations

from dataclasses import dataclass

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
