"""The conditioning item protocol (counterpart of
ltx2_tpu/conditioning/item.py)."""

from __future__ import annotations

from typing import Protocol

from ltx2_tpu_torch.types import LatentState


class ConditioningError(Exception):
    """Raised when a conditioning cannot be applied to a latent state."""


class ConditioningItem(Protocol):
    def apply_to(self, latent_state: LatentState, latent_tools) -> LatentState: ...
