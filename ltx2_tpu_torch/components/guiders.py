"""Guidance (counterpart of ltx2_tpu/components/guiders.py). Only classic
CFG is ported; scale 1.0 disables it."""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
