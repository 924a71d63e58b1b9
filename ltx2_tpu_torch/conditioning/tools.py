"""Latent-state construction (counterpart of ltx2_tpu/conditioning/tools.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ltx2_tpu_torch.components.patchifiers import AudioPatchifier, VideoLatentPatchifier, get_pixel_coords
from ltx2_tpu_torch.types import AudioLatentShape, LatentState, SpatioTemporalScaleFactors, VideoLatentShape

DEFAULT_SCALE_FACTORS = SpatioTemporalScaleFactors.default()


@dataclass(frozen=True)
class VideoLatentTools:
    """Builds video LatentStates. Positions: patch bounds -> pixel coords
    (causal fix), with the temporal axis divided by fps, i.e. seconds."""

    patchifier: VideoLatentPatchifier
    target_shape: VideoLatentShape
    fps: float
    scale_factors: SpatioTemporalScaleFactors = DEFAULT_SCALE_FACTORS
    causal_fix: bool = True

    def create_initial_state(
        self,
        dtype: torch.dtype = torch.float32,
        initial_latent: Optional[torch.Tensor] = None,
        device=None,
    ) -> LatentState:
        if initial_latent is not None:
            if tuple(initial_latent.shape) != self.target_shape.to_tuple():
                raise ValueError(
                    f"Initial latent shape {tuple(initial_latent.shape)} does not match "
                    f"target shape {self.target_shape.to_tuple()}"
                )
            device = initial_latent.device
        else:
            initial_latent = torch.zeros(self.target_shape.to_tuple(), dtype=dtype, device=device)
        denoise_mask = torch.ones(self.target_shape.mask_shape().to_tuple(), dtype=torch.float32, device=device)
        latent_coords = self.patchifier.get_patch_grid_bounds(self.target_shape, device=device)
        positions = get_pixel_coords(latent_coords, self.scale_factors, causal_fix=self.causal_fix).float()
        positions = torch.cat([positions[:, 0:1] / self.fps, positions[:, 1:]], dim=1)
        return self.patchify(LatentState(
            latent=initial_latent, denoise_mask=denoise_mask, positions=positions,
            clean_latent=initial_latent,
        ))

    def patchify(self, latent_state: LatentState) -> LatentState:
        return latent_state.replace(
            latent=self.patchifier.patchify(latent_state.latent),
            clean_latent=self.patchifier.patchify(latent_state.clean_latent),
            denoise_mask=self.patchifier.patchify(latent_state.denoise_mask),
        )

    def unpatchify(self, latent_state: LatentState) -> LatentState:
        return latent_state.replace(
            latent=self.patchifier.unpatchify(latent_state.latent, self.target_shape),
            clean_latent=self.patchifier.unpatchify(latent_state.clean_latent, self.target_shape),
            denoise_mask=self.patchifier.unpatchify(latent_state.denoise_mask, self.target_shape.mask_shape()),
        )

    def clear_conditioning(self, latent_state: LatentState) -> LatentState:
        """Truncate appended conditioning tokens (they are appended at the end)."""
        n = self.patchifier.get_token_count(self.target_shape)
        return LatentState(
            latent=latent_state.latent[:, :n],
            denoise_mask=torch.ones_like(latent_state.denoise_mask)[:, :n],
            positions=latent_state.positions[:, :, :n],
            clean_latent=latent_state.clean_latent[:, :n],
        )


@dataclass(frozen=True)
class AudioLatentTools:
    """Builds audio LatentStates: positions in seconds, always float32 (at
    the 0.04 s spacing bf16 would merge neighbouring timestamps)."""

    patchifier: AudioPatchifier
    target_shape: AudioLatentShape

    def create_initial_state(self, dtype: torch.dtype = torch.float32, initial_latent: Optional[torch.Tensor] = None,
                             device=None) -> LatentState:
        if initial_latent is not None:
            if tuple(initial_latent.shape) != self.target_shape.to_tuple():
                raise ValueError(f"Initial latent shape {tuple(initial_latent.shape)} does not match "
                                 f"target shape {self.target_shape.to_tuple()}")
            device = initial_latent.device
        else:
            initial_latent = torch.zeros(self.target_shape.to_tuple(), dtype=dtype, device=device)
        denoise_mask = torch.ones(self.target_shape.mask_shape().to_tuple(), dtype=torch.float32, device=device)
        positions = self.patchifier.get_patch_grid_bounds(self.target_shape, device=device)
        return self.patchify(LatentState(latent=initial_latent, denoise_mask=denoise_mask, positions=positions,
                                         clean_latent=initial_latent))

    def patchify(self, latent_state: LatentState) -> LatentState:
        return latent_state.replace(
            latent=self.patchifier.patchify(latent_state.latent),
            clean_latent=self.patchifier.patchify(latent_state.clean_latent),
            denoise_mask=self.patchifier.patchify(latent_state.denoise_mask),
        )

    def unpatchify(self, latent_state: LatentState) -> LatentState:
        return latent_state.replace(
            latent=self.patchifier.unpatchify(latent_state.latent, self.target_shape),
            clean_latent=self.patchifier.unpatchify(latent_state.clean_latent, self.target_shape),
            denoise_mask=self.patchifier.unpatchify(latent_state.denoise_mask, self.target_shape.mask_shape()),
        )

    def clear_conditioning(self, latent_state: LatentState) -> LatentState:
        n = self.patchifier.get_token_count(self.target_shape)
        return LatentState(
            latent=latent_state.latent[:, :n],
            denoise_mask=torch.ones_like(latent_state.denoise_mask)[:, :n],
            positions=latent_state.positions[:, :, :n],
            clean_latent=latent_state.clean_latent[:, :n],
        )
