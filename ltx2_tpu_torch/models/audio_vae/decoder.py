"""Audio VAE decoder (counterpart of ltx2_tpu/models/audio_vae/decoder.py).

Latent (B, 8, T, 16) -> stereo log-mel (B, 2, 4T - 3, 64): the latent
de-normalized per patchified channel (statistics over C x F), conv_in
8 -> 512, two mid res blocks, three up levels (512 -> 512 -> 256 -> 128,
`num_res_blocks` res blocks each, a 2x upsample on the first two), pixel
norm, SiLU and conv_out -> 2, trimmed to the causal length. Every conv is
causal along the frame axis (front padding; the reference pads so whatever
`is_causal` says, which only sets the trim) and symmetric along the mel
axis; each upsample doubles both axes and drops the first frame. fp32
throughout, as the JAX package forces it (the vocoder's 108 convs follow),
with `F.conv2d`: the JAX package computes these convs with
`lax.conv_general_dilated` at HIGHEST precision, outside any Pallas kernel,
so the caller turns TF32 off on the card (`generate.py` does).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from ltx2_tpu_torch.ops.common import pixel_norm

LATENT_DOWNSAMPLE_FACTOR = 4


@dataclass(frozen=True)
class AudioDecoderConfig:
    ch: int = 128
    out_ch: int = 2
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 3
    z_channels: int = 8
    mel_bins: int = 16
    sample_rate: int = 16000
    mel_hop_length: int = 160
    is_causal: bool = True

    @property
    def base_block_channels(self) -> int:
        return self.ch * self.ch_mult[-1]

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)


class Conv2d(nn.Module):
    """A conv's (out, in, k, k) weight and bias, fp32, named as in the checkpoint."""

    def __init__(self, in_c: int, out_c: int, k: int = 3, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_c, in_c, k, k, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_c, device=device), requires_grad=False)


class ResBlock2d(nn.Module):
    def __init__(self, in_c: int, out_c: int, *, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_c, out_c, device=device)
        self.conv2 = Conv2d(out_c, out_c, device=device)
        if in_c != out_c:
            self.skip = Conv2d(in_c, out_c, 1, device=device)


class AudioDecoder(nn.Module):
    """The decoder's parameters in the JAX package's tree layout
    (`up_blocks.{i}.res_blocks.{j}`, `up_blocks.{i}.upsample.conv`)."""

    def __init__(self, cfg: AudioDecoderConfig = AudioDecoderConfig(), *, device=None):
        super().__init__()
        self.cfg = cfg
        base = cfg.base_block_channels
        self.per_channel_statistics = PerChannelStatistics(cfg.z_channels * cfg.mel_bins, device=device)
        self.conv_in = Conv2d(cfg.z_channels, base, device=device)
        self.mid_block_1 = ResBlock2d(base, base, device=device)
        self.mid_block_2 = ResBlock2d(base, base, device=device)
        self.up_blocks = nn.ModuleList()
        block_in = base
        for level in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[level]
            up = nn.Module()
            up.res_blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                up.res_blocks.append(ResBlock2d(block_in, block_out, device=device))
                block_in = block_out
            if level != 0:
                up.upsample = nn.Module()
                up.upsample.conv = Conv2d(block_out, block_out, device=device)
            self.up_blocks.append(up)
        self.conv_out = Conv2d(cfg.ch, cfg.out_ch, device=device)


@torch.no_grad()
def init_audio_decoder_(decoder: AudioDecoder, generator: torch.Generator) -> AudioDecoder:
    """Random weights in place: each conv U(+-1/sqrt(in k k)), weight and
    bias, as the JAX package's init_audio_decoder draws them."""
    for m in decoder.modules():
        if isinstance(m, Conv2d):
            bound = 1.0 / (m.weight[0].numel() ** 0.5)
            for p in (m.weight, m.bias):
                p.copy_(torch.rand(p.shape, generator=generator, device=p.device) * 2 * bound - bound)
    return decoder


def causal_conv2d(p: Conv2d, x: torch.Tensor, causal: bool = True, stride: int = 1) -> torch.Tensor:
    """Conv over (B, C, T, M) at `stride` on both axes: front padding along
    T (symmetric when not `causal`), symmetric along M."""
    k = p.weight.shape[-1]
    if k > 1:
        pad = k - 1
        t_pad = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        x = F.pad(x, (pad // 2, pad - pad // 2, *t_pad))
    return F.conv2d(x, p.weight, p.bias, stride=stride)


def _silu_norm(x: torch.Tensor) -> torch.Tensor:
    return F.silu(pixel_norm(x, 1))


def _res_block(p: ResBlock2d, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
    h = causal_conv2d(p.conv1, _silu_norm(x), causal)
    h = causal_conv2d(p.conv2, _silu_norm(h), causal)
    if hasattr(p, "skip"):
        x = causal_conv2d(p.skip, x, causal)
    return x + h


def denormalize_audio_latent(sample: torch.Tensor, stats: PerChannelStatistics) -> torch.Tensor:
    """(B, C, T, F): patchified to (B, T, C F), x * std + mean, back."""
    b, c, t, f = sample.shape
    patched = sample.permute(0, 2, 1, 3).reshape(b, t, c * f)
    patched = patched * stats.std_of_means[None, None] + stats.mean_of_means[None, None]
    return patched.reshape(b, t, c, f).permute(0, 2, 1, 3)


@torch.no_grad()
def audio_decoder_apply(decoder: AudioDecoder, sample: torch.Tensor) -> torch.Tensor:
    """Latent (B, z, T, mel) -> log-mel (B, out_ch, T', 4 mel), fp32;
    T' = 4T - 3 when causal, else 4T."""
    cfg = decoder.cfg
    sample = denormalize_audio_latent(sample.float(), decoder.per_channel_statistics)
    _, _, t, f = sample.shape
    frames = t * LATENT_DOWNSAMPLE_FACTOR
    if cfg.is_causal:
        frames = max(frames - (LATENT_DOWNSAMPLE_FACTOR - 1), 1)
    h = causal_conv2d(decoder.conv_in, sample)
    h = _res_block(decoder.mid_block_2, _res_block(decoder.mid_block_1, h))
    for level in decoder.up_blocks:
        for block in level.res_blocks:
            h = _res_block(block, h)
        if hasattr(level, "upsample"):
            h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            h = causal_conv2d(level.upsample.conv, h)[:, :, 1:]
    h = causal_conv2d(decoder.conv_out, _silu_norm(h))
    return h[:, :cfg.out_ch, :frames, :f * LATENT_DOWNSAMPLE_FACTOR]
