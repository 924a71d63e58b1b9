"""2x spatial latent upscaler (counterpart of
ltx2_tpu/models/upscaler/spatial.py).

conv3d 128 -> 1024 -> GroupNorm(32) over (C/g, T, H, W) -> SiLU -> 4 res
blocks -> rational resampler (per-frame 3 x 3 conv 1024 -> 4096 -> 2x pixel
shuffle; the stride-1 blur is the identity) -> 4 res blocks -> conv3d ->
128. Applied to un-normalized latents. Channels-last inside; every conv has
zero padding in space and time and runs through `ops/conv3d.py` (the
hand-written kernel on a CUDA tensor), the resampler's with a temporal
extent of 1. The JAX package runs it in fp32 (its weights load as fp32 and
the un-normalized latent is fp32), and so does the port. Its checkpoint is a
file of its own, named as the module, with the resampler's conv under
`upsampler.conv.*` (v1.0) or `upsampler.0.*` (v1.1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.modules import assign_, require_loaded
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc, from_ndhwc, to_ndhwc


@dataclass(frozen=True)
class SpatialUpscalerConfig:
    in_channels: int = 128
    mid_channels: int = 1024
    num_blocks_per_stage: int = 4
    num_groups: int = 32
    scale: int = 2


class _Norm(nn.Module):
    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype), requires_grad=False)


class _ResBlock(nn.Module):
    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv3d(channels, channels, device=device, dtype=dtype)
        self.norm1 = _Norm(channels, device=device, dtype=dtype)
        self.conv2 = Conv3d(channels, channels, device=device, dtype=dtype)
        self.norm2 = _Norm(channels, device=device, dtype=dtype)


class _Resampler(nn.Module):
    def __init__(self, channels: int, scale: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(channels, scale * scale * channels, per_frame=True, device=device, dtype=dtype)


class SpatialUpscaler(nn.Module):
    """Upscaler parameters, named as in the checkpoint and the JAX tree."""

    def __init__(self, cfg: SpatialUpscalerConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        mid = cfg.mid_channels
        self.initial_conv = Conv3d(cfg.in_channels, mid, device=device, dtype=dtype)
        self.initial_norm = _Norm(mid, device=device, dtype=dtype)
        self.res_blocks = nn.ModuleList(
            _ResBlock(mid, device=device, dtype=dtype) for _ in range(cfg.num_blocks_per_stage))
        self.upsampler = _Resampler(mid, cfg.scale, device=device, dtype=dtype)
        self.post_upsample_res_blocks = nn.ModuleList(
            _ResBlock(mid, device=device, dtype=dtype) for _ in range(cfg.num_blocks_per_stage))
        self.final_conv = Conv3d(mid, cfg.in_channels, device=device, dtype=dtype)


@torch.no_grad()
def init_spatial_upscaler_(upscaler: SpatialUpscaler, generator: torch.Generator) -> SpatialUpscaler:
    """Random weights in place with ltx2_tpu's init_spatial_upscaler
    distributions: every conv U(+-1/sqrt(inC * taps)), norms ones and zeros."""
    for m in upscaler.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, _Norm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return upscaler


def group_norm_video(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (C/g, T, H, W) of channels-last (B, T, H, W, C), fp32
    statistics (biased variance), x's dtype out."""
    b, t, h, w, c = x.shape
    xf = x.float().reshape(b, t, h, w, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 2, 3, 5), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, t, h, w, c)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def _conv(p: Conv3d, x: torch.Tensor) -> torch.Tensor:
    return conv3d_ndhwc(p, x, causal=False, spatial_mode="zeros", temporal_mode="zeros")


def _res_block(p: _ResBlock, x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """conv -> norm -> SiLU -> conv -> norm -> SiLU(x + residual)."""
    h = group_norm_video(_conv(p.conv1, x), num_groups, p.norm1.weight, p.norm1.bias)
    h = F.silu(h.float()).to(x.dtype)
    h = group_norm_video(_conv(p.conv2, h), num_groups, p.norm2.weight, p.norm2.bias)
    return F.silu((h + x).float()).to(x.dtype)


def _pixel_shuffle_2d(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H, W, C*r*r) -> (N, H*r, W*r, C), channel packing (C, r_h, r_w)."""
    n, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(n, h, w, c_out, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, c_out)


def _rational_resampler(p: _Resampler, x: torch.Tensor, scale: int) -> torch.Tensor:
    """Per-frame 3 x 3 conv (a conv with temporal extent 1) -> pixel shuffle."""
    b, t = x.shape[:2]
    y = _conv(p.conv, x)
    y = _pixel_shuffle_2d(y.reshape(b * t, *y.shape[2:]), scale)
    return y.reshape(b, t, *y.shape[1:])


def spatial_upscaler_apply(upscaler: SpatialUpscaler, latent: torch.Tensor) -> torch.Tensor:
    """(B, 128, F, H, W) un-normalized latent -> (B, 128, F, 2H, 2W), in
    the latent's dtype."""
    cfg = upscaler.cfg
    x = _conv(upscaler.initial_conv, to_ndhwc(latent))
    x = group_norm_video(x, cfg.num_groups, upscaler.initial_norm.weight, upscaler.initial_norm.bias)
    x = F.silu(x.float()).to(latent.dtype)
    for block in upscaler.res_blocks:
        x = _res_block(block, x, cfg.num_groups)
    x = _rational_resampler(upscaler.upsampler, x, cfg.scale)
    for block in upscaler.post_upsample_res_blocks:
        x = _res_block(block, x, cfg.num_groups)
    return from_ndhwc(_conv(upscaler.final_conv, x))


def conv_launches(cfg: SpatialUpscalerConfig) -> int:
    """Conv launches of one spatial_upscaler_apply: initial and final convs,
    two per res block, the resampler."""
    return 2 + 2 * 2 * cfg.num_blocks_per_stage + 1


def _count_blocks(f: SafetensorsFile, prefix: str) -> int:
    i = 0
    while f"{prefix}.{i}.conv1.weight" in f:
        i += 1
    return i


def _v11_name(name: str) -> str:
    return name.replace("upsampler.conv.", "upsampler.0.", 1)


@torch.no_grad()
def load_spatial_upscaler_params(path: str, device=None) -> SpatialUpscaler:
    """The fp32 upscaler of the file at `path` on `device` (default cuda),
    under either naming of the resampler; the widths and the res blocks of
    each stage are read off the file (both stages must have as many)."""
    device = resolve_device(device)
    f = SafetensorsFile(path)
    try:
        v11 = "upsampler.0.weight" in f
        mid, in_channels = f.info("initial_conv.weight")[1][:2]
        counts = [_count_blocks(f, stage) for stage in ("res_blocks", "post_upsample_res_blocks")]
        if counts[0] != counts[1]:
            raise ValueError(f"{path}: {counts[0]} res blocks before the resampler, {counts[1]} after; the port's "
                             "upscaler has as many in each stage")
        up_out = f.info("upsampler.0.weight" if v11 else "upsampler.conv.weight")[1][0]
        cfg = SpatialUpscalerConfig(in_channels=in_channels, mid_channels=mid, num_blocks_per_stage=counts[0],
                                    scale=math.isqrt(up_out // mid))
        upscaler = SpatialUpscaler(cfg, device="meta")
        for name, _t in upscaler.named_parameters():
            key = _v11_name(name) if v11 else name
            if key in f:
                assign_(upscaler, name, f.get(key).to(device, torch.float32, copy=True))
    finally:
        f.close()
    require_loaded(upscaler, path, "spatial upscaler")
    return upscaler


def upscaler_to_checkpoint(upscaler: SpatialUpscaler, v11: bool = True) -> Dict[str, torch.Tensor]:
    """The upscaler's tensors on the CPU under their file names, the
    resampler's under the v1.1 names (`upsampler.0.*`) or the v1.0 ones."""
    return {(_v11_name(name) if v11 else name): t.detach().cpu() for name, t in upscaler.named_parameters()}
