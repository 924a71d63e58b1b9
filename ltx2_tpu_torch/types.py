"""Shape descriptors and diffusion state (counterpart of ltx2_tpu/types.py)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch


class VideoPixelShape(NamedTuple):
    """Shape of a video pixel tensor (batch, frames, height, width) @ fps."""

    batch: int
    frames: int
    height: int
    width: int
    fps: float = 25.0


class SpatioTemporalScaleFactors(NamedTuple):
    """VAE downscaling between pixel space and latent grid."""

    time: int
    width: int
    height: int

    @classmethod
    def default(cls) -> "SpatioTemporalScaleFactors":
        return cls(time=8, width=32, height=32)


VIDEO_SCALE_FACTORS = SpatioTemporalScaleFactors.default()


class VideoLatentShape(NamedTuple):
    """Video VAE latent shape, ordered (batch, channels, frames, height, width)."""

    batch: int
    channels: int
    frames: int
    height: int
    width: int

    def to_tuple(self) -> Tuple[int, int, int, int, int]:
        return tuple(self)

    def mask_shape(self) -> "VideoLatentShape":
        return self._replace(channels=1)

    @staticmethod
    def from_pixel_shape(
        shape: VideoPixelShape,
        latent_channels: int = 128,
        scale_factors: SpatioTemporalScaleFactors = VIDEO_SCALE_FACTORS,
    ) -> "VideoLatentShape":
        # Causal VAE: frame count must be 8k+1 -> (F-1)/8 + 1 latent frames.
        return VideoLatentShape(
            batch=shape.batch,
            channels=latent_channels,
            frames=(shape.frames - 1) // scale_factors.time + 1,
            height=shape.height // scale_factors.height,
            width=shape.width // scale_factors.width,
        )

    @property
    def tokens(self) -> int:
        return self.frames * self.height * self.width


class AudioLatentShape(NamedTuple):
    """Audio VAE latent shape (batch, channels, frames, mel_bins)."""

    batch: int
    channels: int
    frames: int
    mel_bins: int

    def to_tuple(self) -> Tuple[int, int, int, int]:
        return tuple(self)

    def mask_shape(self) -> "AudioLatentShape":
        return self._replace(channels=1, mel_bins=1)

    @staticmethod
    def from_duration(batch: int, duration: float, channels: int = 8, mel_bins: int = 16,
                      sample_rate: int = 16000, hop_length: int = 160,
                      audio_latent_downsample_factor: int = 4) -> "AudioLatentShape":
        """round(duration x latents per second) frames; 25 a second at the
        defaults (16 kHz, hop 160, downsampled 4x)."""
        latents_per_second = float(sample_rate) / float(hop_length) / float(audio_latent_downsample_factor)
        return AudioLatentShape(batch=batch, channels=channels, frames=round(duration * latents_per_second),
                                mel_bins=mel_bins)

    @staticmethod
    def from_video_pixel_shape(shape: VideoPixelShape, channels: int = 8, mel_bins: int = 16,
                               sample_rate: int = 16000, hop_length: int = 160,
                               audio_latent_downsample_factor: int = 4) -> "AudioLatentShape":
        """The audio latent of a clip's duration, frames / fps (121 frames at
        24 fps: 126 latent frames)."""
        return AudioLatentShape.from_duration(
            batch=shape.batch, duration=float(shape.frames) / float(shape.fps), channels=channels,
            mel_bins=mel_bins, sample_rate=sample_rate, hop_length=hop_length,
            audio_latent_downsample_factor=audio_latent_downsample_factor)


@dataclasses.dataclass(frozen=True)
class LatentState:
    """Token-space diffusion state.

    Attributes:
        latent: current noisy latent, patchified (B, N, D) or grid form.
        denoise_mask: per-token denoise strength (1 = denoise, 0 = frozen).
        positions: per-token positional bounds, (B, n_dims, N, 2).
        clean_latent: pre-noise latent (holds conditioning content).
    """

    latent: torch.Tensor
    denoise_mask: torch.Tensor
    positions: torch.Tensor
    clean_latent: torch.Tensor

    def replace(self, **kwargs) -> "LatentState":
        return dataclasses.replace(self, **kwargs)
