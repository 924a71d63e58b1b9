"""Latent grid <-> token sequence (counterpart of
ltx2_tpu/components/patchifiers.py)."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ltx2_tpu_torch.types import AudioLatentShape, SpatioTemporalScaleFactors, VideoLatentShape


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


class AudioPatchifier:
    """(B, C, T, F) <-> (B, T, C*F); positions are each latent frame's start
    and end in seconds (float32), shifted for the causal VAE."""

    def __init__(self, patch_size: int, sample_rate: int = 16000, hop_length: int = 160,
                 audio_latent_downsample_factor: int = 4, is_causal: bool = True, shift: int = 0):
        self.hop_length = hop_length
        self.sample_rate = sample_rate
        self.audio_latent_downsample_factor = audio_latent_downsample_factor
        self.is_causal = is_causal
        self.shift = shift
        self._patch_size = (1, patch_size, patch_size)

    @property
    def patch_size(self) -> Tuple[int, int, int]:
        return self._patch_size

    def get_token_count(self, tgt_shape: AudioLatentShape) -> int:
        return tgt_shape.frames

    def _latent_time_in_sec(self, start_latent: int, end_latent: int) -> np.ndarray:
        """Latent frames [start, end) -> seconds, in float32 as the JAX
        package computes them: mel frame = latent x factor, causally
        max(mel + 1 - factor, 0), times hop / rate."""
        frame = np.arange(start_latent, end_latent, dtype=np.float32)
        mel_frame = frame * self.audio_latent_downsample_factor
        if self.is_causal:
            mel_frame = np.maximum(mel_frame + 1 - self.audio_latent_downsample_factor, 0)
        return mel_frame * self.hop_length / self.sample_rate

    def patchify(self, audio_latents: torch.Tensor) -> torch.Tensor:
        b, c, t, f = audio_latents.shape
        return audio_latents.permute(0, 2, 1, 3).reshape(b, t, c * f)

    def unpatchify(self, audio_latents: torch.Tensor, output_shape: AudioLatentShape) -> torch.Tensor:
        b, t, _ = audio_latents.shape
        return audio_latents.reshape(b, t, output_shape.channels, output_shape.mel_bins).permute(0, 2, 1, 3)

    def get_patch_grid_bounds(self, output_shape: AudioLatentShape, device=None) -> torch.Tensor:
        """(batch, 1, frames, 2) float32 start and end seconds."""
        n = output_shape.frames
        start = self._latent_time_in_sec(self.shift, n + self.shift)
        end = self._latent_time_in_sec(self.shift + 1, n + self.shift + 1)
        timings = torch.from_numpy(np.stack([start, end], axis=-1).astype(np.float32)).to(device)
        return timings[None, None].expand(output_shape.batch, 1, n, 2).contiguous()
