"""2x temporal latent upscaler (counterpart of
ltx2_tpu/models/upscaler/temporal.py).

conv3d 128 -> 512 -> GroupNorm(32) per frame -> SiLU -> 4 res blocks ->
temporal pixel shuffle (conv 512 -> 1024, channels to time, the first frame
trimmed) -> 4 res blocks -> conv3d -> 128: a latent of F frames becomes
2F - 1 frames. Applied to un-normalized latents. Channels-last inside;
every conv has zero padding in space and time, non-causal, and runs through
`ops/conv3d.py` (the hand-written kernel on a CUDA tensor), as the spatial
upscaler's do. The JAX package runs it in fp32 (its weights load as fp32),
and so does the port. Unlike the spatial upscaler's, the GroupNorm here is
per frame: over (H, W, C/g) of each frame, the groups contiguous (channel c
in group c // (C/G)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.modules import assign_, require_loaded
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.models.upscaler.spatial import _count_blocks, _conv, _Norm, _ResBlock
from ltx2_tpu_torch.models.video_vae.conv import Conv3d, from_ndhwc, to_ndhwc


@dataclass(frozen=True)
class TemporalUpscalerConfig:
    latent_channels: int = 128
    hidden_channels: int = 512
    num_res_blocks: int = 4
    num_groups: int = 32
    scale_factor: int = 2


class _Upsampler(nn.Module):
    def __init__(self, channels: int, scale: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(channels, channels * scale, device=device, dtype=dtype)


class TemporalUpscaler(nn.Module):
    """Upscaler parameters, named as in the checkpoint (the upsampler's conv
    is `upsampler.0.*` or `upsampler.conv.*` there) and the JAX tree."""

    def __init__(self, cfg: TemporalUpscalerConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        hid = cfg.hidden_channels
        self.initial_conv = Conv3d(cfg.latent_channels, hid, device=device, dtype=dtype)
        self.initial_norm = _Norm(hid, device=device, dtype=dtype)
        self.res_blocks = nn.ModuleList(_ResBlock(hid, device=device, dtype=dtype) for _ in range(cfg.num_res_blocks))
        self.upsampler = _Upsampler(hid, cfg.scale_factor, device=device, dtype=dtype)
        self.post_upsample_res_blocks = nn.ModuleList(
            _ResBlock(hid, device=device, dtype=dtype) for _ in range(cfg.num_res_blocks))
        self.final_conv = Conv3d(hid, cfg.latent_channels, device=device, dtype=dtype)


@torch.no_grad()
def init_temporal_upscaler_(upscaler: TemporalUpscaler, generator: torch.Generator) -> TemporalUpscaler:
    """Random weights in place with ltx2_tpu's init_temporal_upscaler
    distributions: every conv U(+-1/sqrt(inC * 27)), norms ones and zeros."""
    for m in upscaler.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, _Norm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return upscaler


def group_norm_per_frame(x: torch.Tensor, num_groups: int, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm per (frame, group) over (H, W, C/g) of channels-last
    (B, T, H, W, C), contiguous groups, fp32 statistics (biased variance),
    x's dtype out."""
    b, t, h, w, c = x.shape
    xf = x.float().reshape(b, t, h, w, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(2, 3, 5), keepdim=True, correction=0)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, t, h, w, c)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def _res_block(p: _ResBlock, x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """conv -> per-frame norm -> SiLU -> conv -> per-frame norm -> SiLU(x + residual)."""
    h = group_norm_per_frame(_conv(p.conv1, x), num_groups, p.norm1.weight, p.norm1.bias)
    h = F.silu(h.float()).to(x.dtype)
    h = group_norm_per_frame(_conv(p.conv2, h), num_groups, p.norm2.weight, p.norm2.bias)
    return F.silu((h + x).float()).to(x.dtype)


def temporal_pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, T, H, W, C*r) -> (B, T*r, H, W, C), the factor the slowest packed
    channel axis ("(p1 c)"): what the reference's reshape does, whatever
    its docstring says."""
    b, t, h, w, c = x.shape
    c_out = c // r
    x = x.reshape(b, t, h, w, r, c_out).permute(0, 1, 4, 2, 3, 5)
    return x.reshape(b, t * r, h, w, c_out)


def temporal_upscaler_apply(upscaler: TemporalUpscaler, latent: torch.Tensor) -> torch.Tensor:
    """(B, 128, F, H, W) un-normalized latent -> (B, 128, 2F - 1, H, W), in
    the latent's dtype."""
    cfg = upscaler.cfg
    x = _conv(upscaler.initial_conv, to_ndhwc(latent))
    x = group_norm_per_frame(x, cfg.num_groups, upscaler.initial_norm.weight, upscaler.initial_norm.bias)
    x = F.silu(x.float()).to(latent.dtype)
    for block in upscaler.res_blocks:
        x = _res_block(block, x, cfg.num_groups)
    x = temporal_pixel_shuffle(_conv(upscaler.upsampler.conv, x), cfg.scale_factor)
    # The first latent frame encodes one pixel frame: trimmed after the shuffle.
    x = x[:, 1:].contiguous()
    for block in upscaler.post_upsample_res_blocks:
        x = _res_block(block, x, cfg.num_groups)
    return from_ndhwc(_conv(upscaler.final_conv, x))


def conv_launches(cfg: TemporalUpscalerConfig) -> int:
    """Conv launches of one temporal_upscaler_apply: initial and final convs,
    two per res block, the upsampler."""
    return 2 + 2 * 2 * cfg.num_res_blocks + 1


@torch.no_grad()
def load_temporal_upscaler_params(path: str, device=None) -> TemporalUpscaler:
    """The fp32 upscaler of the file at `path` on `device` (default cuda),
    the upsampler's conv under `upsampler.0.*` (a torch Sequential's, the
    published file's) or `upsampler.conv.*`; the widths and the res blocks
    of each stage are read off the file (both stages must have as many), the
    groups the config's 32, as the JAX ledger builds it."""
    device = resolve_device(device)
    f = SafetensorsFile(path)
    try:
        seq = "upsampler.0.weight" in f
        hid, latent_channels = f.info("initial_conv.weight")[1][:2]
        counts = [_count_blocks(f, stage) for stage in ("res_blocks", "post_upsample_res_blocks")]
        if counts[0] != counts[1]:
            raise ValueError(f"{path}: {counts[0]} res blocks before the upsampler, {counts[1]} after; the port's "
                             "upscaler has as many in each stage")
        up_out = f.info("upsampler.0.weight" if seq else "upsampler.conv.weight")[1][0]
        cfg = TemporalUpscalerConfig(latent_channels=latent_channels, hidden_channels=hid, num_res_blocks=counts[0],
                                     scale_factor=up_out // hid)
        upscaler = TemporalUpscaler(cfg, device="meta")
        for name, _t in upscaler.named_parameters():
            key = name.replace("upsampler.conv.", "upsampler.0.", 1) if seq else name
            if key in f:
                assign_(upscaler, name, f.get(key).to(device, torch.float32, copy=True))
    finally:
        f.close()
    require_loaded(upscaler, path, "temporal upscaler")
    return upscaler
