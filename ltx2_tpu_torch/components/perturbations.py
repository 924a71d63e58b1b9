"""Attention perturbations for STG guidance (counterpart of
ltx2_tpu/components/perturbations.py).

The configs are static, hashable descriptions: which attention a guidance
row skips, in which blocks. `BatchedPerturbationConfig.mask` turns one into
a per-row keep mask (1 = keep the attention's residual, 0 = skip it), a
tensor on the device the caller names.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple

import torch


class PerturbationType(Enum):
    SKIP_A2V_CROSS_ATTN = "skip_a2v_cross_attn"
    SKIP_V2A_CROSS_ATTN = "skip_v2a_cross_attn"
    SKIP_VIDEO_SELF_ATTN = "skip_video_self_attn"
    SKIP_AUDIO_SELF_ATTN = "skip_audio_self_attn"


@dataclass(frozen=True)
class Perturbation:
    """One attention-skip rule: which type, in which blocks (None = all)."""

    type: PerturbationType
    blocks: Optional[Tuple[int, ...]] = None

    def is_perturbed(self, perturbation_type: PerturbationType, block: int) -> bool:
        if self.type != perturbation_type:
            return False
        return self.blocks is None or block in self.blocks


@dataclass(frozen=True)
class PerturbationConfig:
    """Perturbation rules for a single sample."""

    perturbations: Optional[Tuple[Perturbation, ...]] = None

    def is_perturbed(self, perturbation_type: PerturbationType, block: int) -> bool:
        if self.perturbations is None:
            return False
        return any(p.is_perturbed(perturbation_type, block) for p in self.perturbations)

    @staticmethod
    def empty() -> "PerturbationConfig":
        return PerturbationConfig(perturbations=())


@dataclass(frozen=True)
class BatchedPerturbationConfig:
    """Per-sample perturbation configs for a batch."""

    perturbations: Tuple[PerturbationConfig, ...]

    def mask(self, perturbation_type: PerturbationType, block: int, dtype=torch.float32,
             device=None) -> torch.Tensor:
        """(batch,) mask on `device`: 1 = keep attention, 0 = skip."""
        values = [0.0 if cfg.is_perturbed(perturbation_type, block) else 1.0 for cfg in self.perturbations]
        return torch.tensor(values, dtype=dtype, device=device)

    def mask_like(self, perturbation_type: PerturbationType, block: int, values: torch.Tensor) -> torch.Tensor:
        """The mask in `values`' dtype and device, shaped to broadcast over it."""
        mask = self.mask(perturbation_type, block, values.dtype, values.device)
        return mask.reshape(mask.shape[0], *([1] * (values.ndim - 1)))

    def any_in_batch(self, perturbation_type: PerturbationType, block: int) -> bool:
        return any(cfg.is_perturbed(perturbation_type, block) for cfg in self.perturbations)

    def all_in_batch(self, perturbation_type: PerturbationType, block: int) -> bool:
        return all(cfg.is_perturbed(perturbation_type, block) for cfg in self.perturbations)

    @staticmethod
    def empty(batch_size: int) -> "BatchedPerturbationConfig":
        return BatchedPerturbationConfig(perturbations=tuple(PerturbationConfig.empty() for _ in range(batch_size)))


def create_stg_perturbation(
    skip_video_self_attn: bool = True,
    blocks: Optional[List[int]] = None,
    skip_audio_self_attn: bool = False,
) -> PerturbationConfig:
    """The STG row's rules: skip video (and/or audio) self-attention in
    `blocks` (None = every block)."""
    blocks_t = tuple(blocks) if blocks is not None else None
    perturbations = []
    if skip_video_self_attn:
        perturbations.append(Perturbation(type=PerturbationType.SKIP_VIDEO_SELF_ATTN, blocks=blocks_t))
    if skip_audio_self_attn:
        perturbations.append(Perturbation(type=PerturbationType.SKIP_AUDIO_SELF_ATTN, blocks=blocks_t))
    return PerturbationConfig(perturbations=tuple(perturbations))


def create_batched_stg_config(
    batch_size: int,
    skip_video_self_attn: bool = True,
    blocks: Optional[List[int]] = None,
) -> BatchedPerturbationConfig:
    config = create_stg_perturbation(skip_video_self_attn, blocks)
    return BatchedPerturbationConfig(perturbations=(config,) * batch_size)
