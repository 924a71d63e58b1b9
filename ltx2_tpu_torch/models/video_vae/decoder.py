"""Causal video VAE decoder (counterpart of
ltx2_tpu/models/video_vae/decoder.py).

denormalize by per-channel stats -> optional noise injection -> conv_in ->
up blocks (timestep-conditioned res groups; depth-to-space upsamplers with
first-frame trim and a tiled d2s residual) -> pixel_norm + timestep-
conditioned last scale/shift -> SiLU -> conv_out -> 4x4 un-patchify -> RGB in
[-1, 1]. Channels-last (B, T, H, W, C) inside; scale/shift math fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc, from_ndhwc, to_ndhwc
from ltx2_tpu_torch.models.video_vae.ops import pixel_norm, unpatchify
from ltx2_tpu_torch.ops.common import Linear, init_linear_, linear

_STRIDE_MAP = {
    "compress_all": (2, 2, 2),
    "compress_time": (2, 1, 1),
    "compress_space": (1, 2, 2),
}

# Default V2.0 decoder blocks, in build (checkpoint config) order; the
# decoder runs them reversed.
DEFAULT_DECODER_BLOCKS: Tuple = (
    ("res_x", 5),
    ("compress_all", 2, True),
    ("res_x", 5),
    ("compress_all", 2, True),
    ("res_x", 5),
    ("compress_all", 2, True),
    ("res_x", 5),
)


@dataclass(frozen=True)
class VideoDecoderConfig:
    decoder_blocks: Tuple = DEFAULT_DECODER_BLOCKS
    base_channels: int = 128
    latent_channels: int = 128
    timestep_conditioning: bool = True
    compute_dtype: str = "float32"
    decode_noise_scale: float = 0.025
    patch_size: int = 4

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def plan(self) -> List[Tuple[str, Tuple, int]]:
        """Forward-order block plan [(kind, spec, in_channels)], starting from
        base_channels * 8 feature channels."""
        feature_channels = self.base_channels * 8
        plan = []
        for entry in reversed(self.decoder_blocks):
            if entry[0] == "res_x":
                plan.append(("res", (entry[1],), feature_channels))
            else:
                name, multiplier, residual = entry
                plan.append(("upsample", (_STRIDE_MAP[name], multiplier, residual), feature_channels))
                feature_channels //= multiplier
        return plan

    @property
    def num_temporal_upsamples(self) -> int:
        return sum(1 for e in self.decoder_blocks if e[0] != "res_x" and _STRIDE_MAP[e[0]][0] > 1)

    @property
    def final_channels(self) -> int:
        c = self.base_channels * 8
        for entry in self.decoder_blocks:
            if entry[0] != "res_x":
                c //= entry[1]
        return c


class _Embedder(nn.Module):
    def __init__(self, out_features: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Linear(256, 256, device=device, dtype=dtype)
        self.linear_2 = Linear(256, out_features, device=device, dtype=dtype)


class _ResBlock(nn.Module):
    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv3d(channels, channels, device=device, dtype=dtype)
        self.conv2 = Conv3d(channels, channels, device=device, dtype=dtype)
        self.scale_shift_table = nn.Parameter(torch.zeros(4, channels, device=device), requires_grad=False)


class _ResGroup(nn.Module):
    def __init__(self, num_layers: int, channels: int, timestep_conditioning: bool, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.res_blocks = nn.ModuleList(_ResBlock(channels, device=device, dtype=dtype) for _ in range(num_layers))
        if timestep_conditioning:
            self.time_embedder = _Embedder(4 * channels, device=device, dtype=dtype)


class _Upsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(in_channels, out_channels, device=device, dtype=dtype)


class PerChannelStatistics(nn.Module):
    """The latent's per-channel mean_of_means and std_of_means (defaults 0
    and 1, the values of a decoder with random weights)."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.register_buffer("mean_of_means", torch.zeros(channels, device=device))
        self.register_buffer("std_of_means", torch.ones(channels, device=device))


class VideoDecoder(nn.Module):
    """Decoder parameters, named as in the checkpoint. Conv and linear
    weights in cfg.dtype; statistics and scale/shift tables fp32."""

    def __init__(self, cfg: VideoDecoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        self.per_channel_statistics = PerChannelStatistics(cfg.latent_channels, device=device)
        self.conv_in = Conv3d(cfg.latent_channels, cfg.base_channels * 8, device=device, dtype=dtype)
        blocks = []
        for kind, spec, channels in cfg.plan():
            if kind == "res":
                blocks.append(_ResGroup(spec[0], channels, cfg.timestep_conditioning, device=device, dtype=dtype))
            else:
                stride, multiplier, _residual = spec
                blocks.append(_Upsample(channels, math.prod(stride) * channels // multiplier,
                                        device=device, dtype=dtype))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_out = Conv3d(cfg.final_channels, 3 * cfg.patch_size ** 2, device=device, dtype=dtype)
        self.last_scale_shift_table = nn.Parameter(torch.zeros(2, cfg.final_channels, device=device),
                                                   requires_grad=False)
        if cfg.timestep_conditioning:
            self.register_buffer("timestep_scale_multiplier", torch.tensor(1000.0, device=device))
            self.last_time_embedder = _Embedder(2 * cfg.final_channels, device=device, dtype=dtype)


@torch.no_grad()
def init_video_decoder_(decoder: VideoDecoder, generator: torch.Generator) -> VideoDecoder:
    """Random weights in place with ltx2_tpu's init_video_decoder
    distributions: convs U(+-1/sqrt(inC*k^3)), linears init_linear's."""
    for m in decoder.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Linear):
            init_linear_(m, generator)
    return decoder


def conv_launches(cfg: VideoDecoderConfig) -> int:
    """Conv launches of one video_decoder_apply: conv_in, two per res block,
    one per upsampler, conv_out."""
    return 2 + sum(2 * spec[0] if kind == "res" else 1 for kind, spec, _ in cfg.plan())


def decoder_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int = 256) -> torch.Tensor:
    """VAE-decoder sinusoidal embedding: concat(cos, sin) order."""
    half = embedding_dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.reshape(-1).float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def timestep_embedder_apply(p: _Embedder, t_emb: torch.Tensor) -> torch.Tensor:
    return linear(p.linear_2, F.silu(linear(p.linear_1, t_emb)))


def _res_block(p: _ResBlock, x: torch.Tensor, causal: bool, time_emb: Optional[torch.Tensor],
               channels: int) -> torch.Tensor:
    """pixel_norm -> scale/shift -> SiLU -> conv, twice, + residual."""
    table = p.scale_shift_table.float()
    if time_emb is not None:
        ss = table[None] + time_emb.reshape(-1, 4, channels)
        vals = [ss[:, i][:, None, None, None, :] for i in range(4)]
    else:
        vals = [table[i] for i in range(4)]
    shift1, scale1, shift2, scale2 = vals[0], 1 + vals[1], vals[2], 1 + vals[3]
    h = F.silu(pixel_norm(x).float() * scale1 + shift1).to(x.dtype)
    h = conv3d_ndhwc(p.conv1, h, causal=causal)
    h = F.silu(pixel_norm(h).float() * scale2 + shift2).to(x.dtype)
    h = conv3d_ndhwc(p.conv2, h, causal=causal)
    return h + x


def _depth_to_space(x: torch.Tensor, c_out: int, stride: Tuple[int, int, int]) -> torch.Tensor:
    """Channels-last depth-to-space, packing order (c_out, ft, fh, fw)."""
    b, t, h, w, _ = x.shape
    ft, fh, fw = stride
    x = x.reshape(b, t, h, w, c_out, ft, fh, fw).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, t * ft, h * fh, w * fw, c_out)


def _upsample_block(p: _Upsample, x: torch.Tensor, causal: bool, stride: Tuple[int, int, int],
                    multiplier: int, residual: bool, in_channels: int) -> torch.Tensor:
    """Conv -> depth-to-space (+ tiled d2s residual); the first frame is
    dropped when the temporal stride is > 1 (causal fix)."""
    ft = stride[0]
    stride_product = math.prod(stride)
    if residual:
        res = _depth_to_space(x, in_channels // stride_product, stride)
        if ft > 1:
            res = res[:, 1:]
        res = res.repeat(1, 1, 1, 1, stride_product // multiplier)
    x = _depth_to_space(conv3d_ndhwc(p.conv, x, causal=causal), in_channels // multiplier, stride)
    if ft > 1:
        x = x[:, 1:]
    return x + res if residual else x


def video_decoder_apply(
    decoder: VideoDecoder,
    latent: torch.Tensor,
    timestep: Optional[float] = 0.05,
    noise: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Decode a (B, 128, T, H, W) latent -> (B, 3, 8(T-1)+1, 32H, 32W) fp32
    video in [-1, 1].

    noise: standard-normal noise of the latent's shape, injected at
    cfg.decode_noise_scale when the decoder is timestep-conditioned and
    `timestep` is set (the caller draws it; see chunking.decode_latent)."""
    cfg = decoder.cfg
    batch = latent.shape[0]
    stats = decoder.per_channel_statistics
    x = latent.float() * stats.std_of_means.float().view(1, -1, 1, 1, 1)
    x = x + stats.mean_of_means.float().view(1, -1, 1, 1, 1)

    conditioned = cfg.timestep_conditioning and timestep is not None
    scaled_timestep = None
    if conditioned:
        scaled_timestep = torch.full((batch,), timestep, dtype=torch.float32, device=x.device)
        scaled_timestep = scaled_timestep * decoder.timestep_scale_multiplier.float()
        if noise is not None:
            x = noise.float() * cfg.decode_noise_scale + (1.0 - cfg.decode_noise_scale) * x

    x = conv3d_ndhwc(decoder.conv_in, to_ndhwc(x.to(cfg.dtype)), causal=causal)
    for block, (kind, spec, channels) in zip(decoder.up_blocks, cfg.plan()):
        if kind == "res":
            time_emb = None
            if scaled_timestep is not None:
                t_emb = decoder_timestep_embedding(scaled_timestep, 256)
                time_emb = timestep_embedder_apply(block.time_embedder, t_emb).float()
            for rb in block.res_blocks:
                x = _res_block(rb, x, causal, time_emb, channels)
        else:
            stride, multiplier, residual = spec
            x = _upsample_block(block, x, causal, stride, multiplier, residual, channels)

    x = pixel_norm(x)
    table = decoder.last_scale_shift_table.float()
    if scaled_timestep is not None:
        t_emb = decoder_timestep_embedding(scaled_timestep, 256)
        time_emb = timestep_embedder_apply(decoder.last_time_embedder, t_emb)
        ss = table[None] + time_emb.reshape(batch, 2, cfg.final_channels).float()
        shift, scale = ss[:, 0][:, None, None, None, :], 1 + ss[:, 1][:, None, None, None, :]
    else:
        shift, scale = table[0], 1 + table[1]
    x = F.silu(x.float() * scale + shift).to(cfg.dtype)
    x = conv3d_ndhwc(decoder.conv_out, x, causal=causal)
    return unpatchify(from_ndhwc(x), patch_size_hw=cfg.patch_size, patch_size_t=1).float()
