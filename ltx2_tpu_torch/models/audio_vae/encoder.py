"""Audio VAE encoder (counterpart of ltx2_tpu/models/audio_vae/encoder.py),
the a2vid pipeline's waveform -> frozen audio latent direction.

The decoder's mirror: stereo log-mel (B, 2, T, 64) -> conv_in 2 -> 128,
three down levels (128 -> 128 -> 256 -> 512, `num_res_blocks` res blocks
each, a stride-2 causal conv after the first two), two mid res blocks,
SiLU, conv_out -> 2 z channels (mean and log-variance; the mean is kept),
then normalized per patchified channel (statistics over C x F): (B, z,
(T + 3) / 4, 16) for T = 4 L - 3 mel frames. Every conv is causal along
the frame axis (front padding) and symmetric along the mel axis. fp32,
through the decoder module's `causal_conv2d` (PyTorch's conv2d): the JAX
package computes these convs with `lax.conv_general_dilated` at HIGHEST
precision outside any Pallas kernel, so the caller turns TF32 off on the
card (`generate.py` does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.models.audio_vae.decoder import Conv2d, ResBlock2d, _res_block, causal_conv2d
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics


@dataclass(frozen=True)
class AudioEncoderConfig:
    ch: int = 128
    in_ch: int = 2
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 3
    z_channels: int = 8
    mel_bins: int = 16
    double_z: bool = True
    is_causal: bool = True

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)


class AudioEncoder(nn.Module):
    """The encoder's parameters in the JAX package's tree layout
    (`down_blocks.{i}.res_blocks.{j}`, `down_blocks.{i}.downsample.conv`)."""

    def __init__(self, cfg: AudioEncoderConfig = AudioEncoderConfig(), *, device=None):
        super().__init__()
        self.cfg = cfg
        self.per_channel_statistics = PerChannelStatistics(cfg.z_channels * cfg.mel_bins, device=device)
        self.conv_in = Conv2d(cfg.in_ch, cfg.ch, device=device)
        self.down_blocks = nn.ModuleList()
        block_in = cfg.ch
        for level in range(cfg.num_resolutions):
            block_out = cfg.ch * cfg.ch_mult[level]
            down = nn.Module()
            down.res_blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                down.res_blocks.append(ResBlock2d(block_in, block_out, device=device))
                block_in = block_out
            if level != cfg.num_resolutions - 1:
                down.downsample = nn.Module()
                down.downsample.conv = Conv2d(block_out, block_out, device=device)
            self.down_blocks.append(down)
        base = cfg.ch * cfg.ch_mult[-1]
        self.mid_block_1 = ResBlock2d(base, base, device=device)
        self.mid_block_2 = ResBlock2d(base, base, device=device)
        self.conv_out = Conv2d(base, cfg.z_channels * (2 if cfg.double_z else 1), device=device)


@torch.no_grad()
def init_audio_encoder_(encoder: AudioEncoder, generator: torch.Generator) -> AudioEncoder:
    """Random weights in place: each conv U(+-1/sqrt(in k k)), weight and
    bias, as the JAX package's init_audio_encoder draws them; the
    statistics stay 0 and 1."""
    for m in encoder.modules():
        if isinstance(m, Conv2d):
            bound = 1.0 / (m.weight[0].numel() ** 0.5)
            for p in (m.weight, m.bias):
                p.copy_(torch.rand(p.shape, generator=generator, device=p.device) * 2 * bound - bound)
    return encoder


def normalize_audio_latent(sample: torch.Tensor, stats: PerChannelStatistics) -> torch.Tensor:
    """(B, C, T, F): patchified to (B, T, C F), (x - mean) / std, back."""
    b, c, t, f = sample.shape
    patched = sample.permute(0, 2, 1, 3).reshape(b, t, c * f)
    patched = (patched - stats.mean_of_means[None, None]) / stats.std_of_means[None, None]
    return patched.reshape(b, t, c, f).permute(0, 2, 1, 3)


@torch.no_grad()
def audio_encoder_apply(encoder: AudioEncoder, spectrogram: torch.Tensor) -> torch.Tensor:
    """Log-mel (B, in_ch, T, mel) -> normalized latent (B, z, (T + 3) / 4,
    mel / 4), fp32."""
    cfg, causal = encoder.cfg, encoder.cfg.is_causal
    h = causal_conv2d(encoder.conv_in, spectrogram.float(), causal)
    for level in encoder.down_blocks:
        for block in level.res_blocks:
            h = _res_block(block, h, causal)
        if hasattr(level, "downsample"):
            h = causal_conv2d(level.downsample.conv, h, causal, stride=2)
    h = _res_block(encoder.mid_block_2, _res_block(encoder.mid_block_1, h, causal), causal)
    h = causal_conv2d(encoder.conv_out, F.silu(h), causal)
    mean = h[:, :cfg.z_channels] if cfg.double_z else h
    return normalize_audio_latent(mean, encoder.per_channel_statistics)
