"""Latent grid <-> token sequence (counterpart of
ltx2_tpu/components/patchifiers.py)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ltx2_tpu_torch.types import SpatioTemporalScaleFactors, VideoLatentShape


class VideoLatentPatchifier:
    """(B, C, F, H, W) <-> (B, N, D) with patch (1, p, p)."""

    def __init__(self, patch_size: int = 1):
        self._patch_size = (1, patch_size, patch_size)

    @property
    def patch_size(self) -> Tuple[int, int, int]:
        return self._patch_size

    def get_token_count(self, tgt_shape: VideoLatentShape) -> int:
        return (tgt_shape.frames * tgt_shape.height * tgt_shape.width) // math.prod(self._patch_size)

    def patchify(self, latents: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = latents.shape
        p1, p2, p3 = self._patch_size
        x = latents.reshape(b, c, f // p1, p1, h // p2, p2, w // p3, p3)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)  # grid dims first, channel + patch last
        return x.reshape(b, (f // p1) * (h // p2) * (w // p3), c * p1 * p2 * p3)

    def unpatchify(self, latents: torch.Tensor, output_shape: VideoLatentShape) -> torch.Tensor:
        b = latents.shape[0]
        c, f, h, w = output_shape.channels, output_shape.frames, output_shape.height, output_shape.width
        p1, p2, p3 = self._patch_size
        x = latents.reshape(b, f // p1, h // p2, w // p3, c, p1, p2, p3)
        return x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, c, f, h, w)

    def get_patch_grid_bounds(self, output_shape: VideoLatentShape, device=None) -> torch.Tensor:
        """(batch, 3, num_patches, 2) int32 start/end bounds per patch per axis."""
        grids = torch.meshgrid(
            *(torch.arange(0, n, p, device=device)
              for n, p in zip((output_shape.frames, output_shape.height, output_shape.width),
                              self._patch_size)),
            indexing="ij",
        )
        starts = torch.stack(grids, dim=0).reshape(3, -1)
        ends = starts + torch.tensor(self._patch_size, device=device).view(3, 1)
        coords = torch.stack([starts, ends], dim=-1)  # (3, N, 2)
        return coords[None].expand(output_shape.batch, -1, -1, -1).to(torch.int32)


def get_pixel_coords(
    latent_coords: torch.Tensor, scale_factors: SpatioTemporalScaleFactors, causal_fix: bool = False
) -> torch.Tensor:
    """Latent [start, end) bounds -> pixel-space bounds; with causal_fix the
    temporal coords shift by (1 - time_scale), clamped at 0 (the causal VAE
    maps the first latent frame to one pixel frame)."""
    scale = torch.tensor(
        [scale_factors.time, scale_factors.height, scale_factors.width], device=latent_coords.device
    ).view(1, 3, 1, 1)
    pixel = latent_coords * scale
    if causal_fix:
        t = (pixel[:, 0:1] + 1 - scale_factors.time).clamp_min(0)
        pixel = torch.cat([t, pixel[:, 1:]], dim=1)
    return pixel
