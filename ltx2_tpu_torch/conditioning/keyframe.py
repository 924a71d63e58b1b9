"""Keyframe-append conditioning, keyframe interpolation (counterpart of
ltx2_tpu/conditioning/keyframe.py).

A keyframe's tokens are appended past the sequence's end, in the latent and
in the clean latent, with the denoise mask 1 - strength there and positions
offset in time by the keyframe's pixel frame; `clear_conditioning` truncates
them after the loop. The appended tokens lengthen self-attention.
"""

from __future__ import annotations

import torch

from ltx2_tpu_torch.components.patchifiers import get_pixel_coords
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.types import LatentState, VideoLatentShape


class VideoConditionByKeyframeIndex:
    """`keyframes` (B, C, F', H, W) appended at pixel frame `frame_idx`."""

    def __init__(self, keyframes: torch.Tensor, frame_idx: int, strength: float):
        self.keyframes = keyframes
        self.frame_idx = frame_idx
        self.strength = strength

    def apply_to(self, latent_state: LatentState, latent_tools: VideoLatentTools) -> LatentState:
        device = latent_state.latent.device
        tokens = latent_tools.patchifier.patchify(self.keyframes).to(device=device, dtype=latent_state.latent.dtype)
        keyframe_shape = VideoLatentShape(*self.keyframes.shape[:5])
        coords = latent_tools.patchifier.get_patch_grid_bounds(keyframe_shape, device=device)
        # The causal fix applies only to a keyframe at frame 0.
        positions = get_pixel_coords(coords, latent_tools.scale_factors,
                                     causal_fix=latent_tools.causal_fix if self.frame_idx == 0 else False).float()
        positions = torch.cat([(positions[:, 0:1] + self.frame_idx) / latent_tools.fps, positions[:, 1:]], dim=1)
        mask = latent_state.denoise_mask
        denoise_mask = torch.full((tokens.shape[0], tokens.shape[1], *mask.shape[2:]), 1.0 - self.strength,
                                  dtype=mask.dtype, device=device)
        return LatentState(
            latent=torch.cat([latent_state.latent, tokens], dim=1),
            denoise_mask=torch.cat([mask, denoise_mask], dim=1),
            positions=torch.cat([latent_state.positions, positions], dim=2),
            clean_latent=torch.cat([latent_state.clean_latent, tokens], dim=1),
        )
