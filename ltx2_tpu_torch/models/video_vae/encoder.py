"""Causal video VAE encoder (counterpart of
ltx2_tpu/models/video_vae/encoder.py).

4x4 pixel patchify (3 -> 48 channels) -> conv_in 48 -> 128 -> res groups
and space-to-depth down blocks (ENCODER_PLAN: 128 x4 -> s2d (1, 2, 2) ->
256 x6 -> s2d (2, 1, 1) -> 512 x6 -> s2d (2, 2, 2) -> 1024 x2 -> s2d
(2, 2, 2) -> 1024 x2) -> pixel norm + SiLU -> conv_out -> 129 channels (128
means and one logvar channel, dropped) -> per-channel normalize in fp32.
Channels-last (B, T, H, W, C) inside. Every conv is causal with zero spatial
padding and replicate temporal padding, and runs through `conv3d_ndhwc`: on
the card the fp32 conv kernel (the encoder's dtype is fp32), conv_out on its
weight padded to 136 outputs. Frames must number 8k + 1.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc, from_ndhwc, to_ndhwc
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from ltx2_tpu_torch.models.video_vae.ops import normalize_latent, patchify, pixel_norm

# (kind, channels in, channels out or number of res blocks, stride)
ENCODER_PLAN: Tuple = (
    ("res", 128, 4, None),
    ("down", 128, 256, (1, 2, 2)),
    ("res", 256, 6, None),
    ("down", 256, 512, (2, 1, 1)),
    ("res", 512, 6, None),
    ("down", 512, 1024, (2, 2, 2)),
    ("res", 1024, 2, None),
    ("down", 1024, 1024, (2, 2, 2)),
    ("res", 1024, 2, None),
)


@dataclass(frozen=True)
class VideoEncoderConfig:
    patch_size: int = 4
    latent_channels: int = 128
    compute_dtype: str = "float32"
    plan: Tuple = ENCODER_PLAN

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def final_channels(self) -> int:
        kind, c_in, arg, _ = self.plan[-1]
        return c_in if kind == "res" else arg


class _EncResBlock(nn.Module):
    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv3d(channels, channels, device=device, dtype=dtype)
        self.conv2 = Conv3d(channels, channels, device=device, dtype=dtype)


class _EncResGroup(nn.Module):
    def __init__(self, num_blocks: int, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.res_blocks = nn.ModuleList(_EncResBlock(channels, device=device, dtype=dtype)
                                        for _ in range(num_blocks))


class _EncDown(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: Tuple[int, int, int], *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels // math.prod(stride), device=device, dtype=dtype)


class VideoEncoder(nn.Module):
    """Encoder parameters in the JAX tree's structure and names: convs in
    cfg.dtype, the per-channel statistics fp32."""

    def __init__(self, cfg: VideoEncoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        self.per_channel_statistics = PerChannelStatistics(cfg.latent_channels, device=device)
        self.conv_in = Conv3d(3 * cfg.patch_size ** 2, cfg.plan[0][1], device=device, dtype=dtype)
        self.down_blocks = nn.ModuleList(
            _EncResGroup(arg, c_in, device=device, dtype=dtype) if kind == "res"
            else _EncDown(c_in, arg, stride, device=device, dtype=dtype)
            for kind, c_in, arg, stride in cfg.plan
        )
        self.conv_out = Conv3d(cfg.final_channels, cfg.latent_channels + 1, device=device, dtype=dtype)


@torch.no_grad()
def init_video_encoder_(encoder: VideoEncoder, generator: torch.Generator) -> VideoEncoder:
    """Random weights in place with ltx2_tpu's init_video_encoder
    distributions: convs U(+-1/sqrt(inC * k^3)); statistics 0 and 1."""
    for m in encoder.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    return encoder


def conv_launches(cfg: VideoEncoderConfig) -> int:
    """Conv launches of one video_encoder_apply: conv_in, two per res block,
    one per down block, conv_out."""
    return 2 + sum(2 * arg if kind == "res" else 1 for kind, _c, arg, _s in cfg.plan)


def _silu_norm(x: torch.Tensor) -> torch.Tensor:
    """SiLU(pixel_norm(x)) in fp32, x's dtype out."""
    return F.silu(pixel_norm(x).float()).to(x.dtype)


def _enc_res_block(p: _EncResBlock, x: torch.Tensor, causal: bool) -> torch.Tensor:
    """pixel_norm -> SiLU -> conv, twice, + residual (no conditioning)."""
    h = conv3d_ndhwc(p.conv1, _silu_norm(x), causal=causal, spatial_mode="zeros")
    h = conv3d_ndhwc(p.conv2, _silu_norm(h), causal=causal, spatial_mode="zeros")
    return h + x


def _space_to_depth(x: torch.Tensor, stride: Tuple[int, int, int]) -> torch.Tensor:
    """Channels-last space-to-depth, packing order (c, st, sh, sw)."""
    b, t, h, w, c = x.shape
    st, sh, sw = stride
    x = x.reshape(b, t // st, st, h // sh, sh, w // sw, sw, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, t // st, h // sh, w // sw, c * st * sh * sw)


def _down_block(p: _EncDown, x: torch.Tensor, causal: bool, in_channels: int, out_channels: int,
                stride: Tuple[int, int, int]) -> torch.Tensor:
    """Conv -> space-to-depth, plus the group-mean of the input's
    space-to-depth as residual; the first frame is replicated in front when
    the temporal stride is 2."""
    if stride[0] == 2:
        x = torch.cat([x[:, :1], x], dim=1)
    group_size = in_channels * math.prod(stride) // out_channels
    res = _space_to_depth(x, stride)
    b, t, h, w, _ = res.shape
    res = res.reshape(b, t, h, w, out_channels, group_size).mean(dim=-1)
    return _space_to_depth(conv3d_ndhwc(p.conv, x, causal=causal, spatial_mode="zeros"), stride) + res


def video_encoder_apply(encoder: VideoEncoder, video: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Encode (B, 3, F, H, W) video in [-1, 1] -> the normalized fp32 latent
    (B, latent_channels, (F - 1) / 8 + 1, H / 32, W / 32)."""
    cfg = encoder.cfg
    frames = video.shape[2]
    if (frames - 1) % 8 != 0:
        raise ValueError(f"Invalid number of frames: {frames}. "
                         "Encoder input must have 1 + 8*k frames (e.g., 1, 9, 17, 25, 33...).")
    x = to_ndhwc(patchify(video.to(cfg.dtype), patch_size_hw=cfg.patch_size, patch_size_t=1))
    x = conv3d_ndhwc(encoder.conv_in, x, causal=causal, spatial_mode="zeros")
    for block, (kind, c_in, arg, stride) in zip(encoder.down_blocks, cfg.plan):
        if kind == "res":
            for rb in block.res_blocks:
                x = _enc_res_block(rb, x, causal)
        else:
            x = _down_block(block, x, causal, c_in, arg, stride)
    x = conv3d_ndhwc(encoder.conv_out, _silu_norm(x).to(cfg.dtype), causal=causal, spatial_mode="zeros")
    means = from_ndhwc(x)[:, :cfg.latent_channels]  # the logvar channel is dropped
    return normalize_latent(means.float(), encoder.per_channel_statistics).float()


def encode_video(video: torch.Tensor, encoder: VideoEncoder) -> torch.Tensor:
    """video_encoder_apply that also takes uint8 (T, H, W, 3) frames (mapped
    to [-1, 1]) or an unbatched (3, F, H, W) clip."""
    if video.ndim == 4 and video.shape[-1] == 3:
        video = video.permute(3, 0, 1, 2)[None]
        if video.dtype == torch.uint8:
            video = video.float() / 127.5 - 1.0
    if video.ndim == 4:
        video = video[None]
    return video_encoder_apply(encoder, video)
