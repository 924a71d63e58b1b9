"""Full-VAE building blocks, the non-"simple" path (counterpart of
ltx2_tpu/models/video_vae/resnet.py): DualConv3d (a separable 2D + 1D
conv), the causal 3D conv and its dispatch, ResnetBlock3D and
UNetMidBlock3D.

Channels-last (B, T, H, W, C) inside, as the rest of the VAE. Every 3D conv
and the dual conv's spatial 3 x 3 conv (a per-frame conv, kT = 1) run
through `conv3d_ndhwc`: on the card the hand-written conv kernels, on the
CPU their plain version. The dual conv's temporal kT x 1 x 1 conv is kT
shifted channel products summed in fp32 (the JAX package computes it with
an XLA conv outside any Pallas kernel).

Noise: the JAX package draws injected noise from `jax.random` keys; here it
is drawn from an explicit `torch.Generator`, or handed in (`noise=`) by a
caller that needs the JAX package's draws, in the shapes the JAX blocks
draw: (B, T, H, W, 1) after each conv.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc
from ltx2_tpu_torch.models.video_vae.ops import pixel_norm
from ltx2_tpu_torch.ops.common import Linear, group_norm, linear

# A block's two injected noises, each (B, T, H, W, 1), or None to draw them.
NoisePair = Optional[Tuple[torch.Tensor, torch.Tensor]]


class PaddingModeType(Enum):
    ZEROS = "zeros"
    REFLECT = "reflect"
    REPLICATE = "replicate"


class NormLayerType(Enum):
    GROUP_NORM = "group_norm"
    PIXEL_NORM = "pixel_norm"


def spatial_mode(mode: PaddingModeType) -> str:
    """The conv's spatial padding for a block's `spatial_padding_mode`."""
    return "zeros" if mode == PaddingModeType.ZEROS else mode.value


class NormParams(nn.Module):
    """A GroupNorm's affine (C,) weight and bias."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype), requires_grad=False)


class TemporalConv(nn.Module):
    """The dual conv's temporal kernel: weight (outC, midC, kT), bias (outC,)."""

    def __init__(self, in_channels: int, out_channels: int, kt: int = 3, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kt, device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype), requires_grad=False)


class DualConv3d(nn.Module):
    """conv1: the spatial (midC, inC, 3, 3) conv, midC = max(inC, outC);
    conv2: the temporal (outC, midC, 3) conv."""

    def __init__(self, in_channels: int, out_channels: int, *, device=None, dtype=torch.float32):
        super().__init__()
        mid = max(in_channels, out_channels)
        self.conv1 = Conv3d(in_channels, mid, per_frame=True, device=device, dtype=dtype)
        self.conv2 = TemporalConv(mid, out_channels, device=device, dtype=dtype)


def dual_conv3d(p: DualConv3d, x: torch.Tensor, stride: Tuple[int, int, int] = (1, 1, 1),
                skip_time_conv: bool = False) -> torch.Tensor:
    """Separable 3D conv, 2D spatial then 1D temporal, both zero-padded by
    k // 2 (symmetric in time): the spatial conv per frame at (sH, sW), the
    temporal one at sT. x (B, T, H, W, C) -> x's dtype."""
    x = conv3d_ndhwc(p.conv1, x, causal=False, spatial_mode="zeros", temporal_mode="zeros",
                     stride=(1, stride[1], stride[2]))
    if skip_time_conv:
        return x
    w, bias = p.conv2.weight, p.conv2.bias
    kt, st = w.shape[2], stride[0]
    pad = kt // 2
    t_out = (x.shape[1] + 2 * pad - kt) // st + 1
    xp = F.pad(x.float(), (0, 0, 0, 0, 0, 0, pad, pad))
    out = None
    for k in range(kt):
        term = xp[:, k:k + (t_out - 1) * st + 1:st] @ w[:, :, k].float().t()
        out = term if out is None else out.add_(term)
    return (out + bias.float()).to(x.dtype)


def causal_conv3d(p: Conv3d, x: torch.Tensor, causal: bool = True,
                  spatial_padding_mode: PaddingModeType = PaddingModeType.ZEROS) -> torch.Tensor:
    """CausalConv3d: the 3D conv with replicate-first-frame temporal padding."""
    return conv3d_ndhwc(p, x, causal=causal, spatial_mode=spatial_mode(spatial_padding_mode))


def make_conv_nd(in_channels: int, out_channels: int, dims: Union[int, Tuple[int, int]] = 3, *, device=None,
                 dtype=torch.float32) -> nn.Module:
    """The conv module `make_conv_nd_apply` takes for `dims`."""
    if dims == 3:
        return Conv3d(in_channels, out_channels, device=device, dtype=dtype)
    if dims == (2, 1) or dims == [2, 1]:
        return DualConv3d(in_channels, out_channels, device=device, dtype=dtype)
    raise ValueError(f"unsupported dims {dims}")


def make_conv_nd_apply(p: nn.Module, x: torch.Tensor, dims: Union[int, Tuple[int, int]] = 3, causal: bool = True,
                       spatial_padding_mode: PaddingModeType = PaddingModeType.ZEROS) -> torch.Tensor:
    """dims=3: the full causal 3D conv; dims=(2, 1): DualConv3d, whose only
    semantics are non-causal zero padding (anything else raises)."""
    if dims == 3:
        return causal_conv3d(p, x, causal, spatial_padding_mode)
    if dims == (2, 1) or dims == [2, 1]:
        if causal or spatial_padding_mode != PaddingModeType.ZEROS:
            raise NotImplementedError(
                "DualConv3d (dims=(2,1)) supports only non-causal zero padding; got "
                f"causal={causal}, spatial_padding_mode={spatial_padding_mode}")
        return dual_conv3d(p, x)
    raise ValueError(f"unsupported dims {dims}")


@dataclass(frozen=True)
class ResnetBlock3DConfig:
    dims: Union[int, Tuple[int, int]] = 3
    in_channels: int = 128
    out_channels: Optional[int] = None
    groups: int = 32
    eps: float = 1e-6
    norm_layer: NormLayerType = NormLayerType.PIXEL_NORM
    inject_noise: bool = False
    timestep_conditioning: bool = False
    spatial_padding_mode: PaddingModeType = PaddingModeType.ZEROS

    @property
    def out_ch(self) -> int:
        return self.out_channels or self.in_channels


class ResnetBlock3D(nn.Module):
    """ResnetBlock3D's parameters under the JAX tree's names: conv1, conv2
    (Conv3d, or DualConv3d for dims=(2, 1)); norm1, norm2 for group norm;
    scale_shift_table (4, inC) fp32 with timestep conditioning;
    per_channel_scale1/2 (outC,) fp32 with injected noise; conv_shortcut (a
    linear) and norm3 when the channels change."""

    def __init__(self, cfg: ResnetBlock3DConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        c_in, c_out = cfg.in_channels, cfg.out_ch
        self.conv1 = make_conv_nd(c_in, c_out, cfg.dims, device=device, dtype=dtype)
        self.conv2 = make_conv_nd(c_out, c_out, cfg.dims, device=device, dtype=dtype)
        if cfg.norm_layer == NormLayerType.GROUP_NORM:
            self.norm1 = NormParams(c_in, device=device, dtype=dtype)
            self.norm2 = NormParams(c_out, device=device, dtype=dtype)
        if cfg.timestep_conditioning:
            if c_in != c_out:
                raise ValueError("timestep_conditioning requires in_channels == out_channels "
                                 f"(got {c_in} != {c_out})")
            self.scale_shift_table = nn.Parameter(torch.zeros(4, c_in, device=device), requires_grad=False)
        if cfg.inject_noise:
            self.per_channel_scale1 = nn.Parameter(torch.zeros(c_out, device=device), requires_grad=False)
            self.per_channel_scale2 = nn.Parameter(torch.zeros(c_out, device=device), requires_grad=False)
        if c_in != c_out:
            self.conv_shortcut = Linear(c_in, c_out, device=device, dtype=dtype)
            self.norm3 = NormParams(c_in, device=device, dtype=dtype)


def group_norm_ndhwc(x: torch.Tensor, num_groups: int, p: Optional[NormParams], eps: float = 1e-6) -> torch.Tensor:
    """`group_norm` of channels-last (B, T, H, W, C), through the channels-first view."""
    out = group_norm(x.permute(0, 4, 1, 2, 3), num_groups, None if p is None else p.weight,
                     None if p is None else p.bias, eps)
    return out.permute(0, 2, 3, 4, 1)


def _norm(cfg: ResnetBlock3DConfig, p: Optional[NormParams], x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_layer == NormLayerType.PIXEL_NORM:
        return pixel_norm(x, eps=1e-8)
    return group_norm_ndhwc(x, cfg.groups, p, cfg.eps)


def draw_noise(shape, like: torch.Tensor, given: Optional[torch.Tensor],
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard-normal noise of `shape` in like's dtype and device: `given`
    (checked against the shape), or drawn from `generator`, which must then
    be given (no draw from torch's global stream)."""
    if given is not None:
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f"injected noise {tuple(given.shape)}, the block draws {tuple(shape)}")
        return given.to(like.device, like.dtype)
    if generator is None:
        raise ValueError("noise that is not handed in needs a torch.Generator")
    return torch.randn(shape, generator=generator, device=like.device, dtype=torch.float32).to(like.dtype)


def resnet_block_3d_apply(p: ResnetBlock3D, x: torch.Tensor, causal: bool = True,
                          timestep: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                          noise: NoisePair = None, conditioned: Optional[bool] = None) -> torch.Tensor:
    """norm -> [AdaLN] -> SiLU -> conv -> [noise], twice, + the (projected)
    shortcut. x (B, T, H, W, C); timestep (B, 4 C), pre-embedded, applied
    when `conditioned` (default: the block is timestep-conditioned). Noise
    is injected when the block has it and `generator` or `noise` is given."""
    cfg = p.cfg
    conditioned = cfg.timestep_conditioning if conditioned is None else conditioned
    h = _norm(cfg, getattr(p, "norm1", None), x)
    if conditioned:
        if timestep is None:
            raise ValueError("timestep must be provided when timestep_conditioning is True")
        ada = p.scale_shift_table.float()[None] + timestep.reshape(timestep.shape[0], 4, -1).float()
        shift1, scale1, shift2, scale2 = (ada[:, i][:, None, None, None, :] for i in range(4))
        h = (h.float() * (1 + scale1) + shift1).to(x.dtype)
    h = F.silu(h.float()).to(x.dtype)
    h = make_conv_nd_apply(p.conv1, h, cfg.dims, causal, cfg.spatial_padding_mode)
    inject = cfg.inject_noise and (generator is not None or noise is not None)
    if inject:
        n = draw_noise((*h.shape[:4], 1), h, noise[0] if noise is not None else None, generator)
        h = h + n * p.per_channel_scale1.to(h.dtype)
    h = _norm(cfg, getattr(p, "norm2", None), h)
    if conditioned:
        h = (h.float() * (1 + scale2) + shift2).to(x.dtype)
    h = F.silu(h.float()).to(x.dtype)
    h = make_conv_nd_apply(p.conv2, h, cfg.dims, causal, cfg.spatial_padding_mode)
    if inject:
        n = draw_noise((*h.shape[:4], 1), h, noise[1] if noise is not None else None, generator)
        h = h + n * p.per_channel_scale2.to(h.dtype)
    shortcut = x
    if hasattr(p, "norm3"):
        # Always GroupNorm(1), whatever cfg.norm_layer (the reference's shortcut norm).
        shortcut = group_norm_ndhwc(shortcut, 1, p.norm3, cfg.eps)
    if hasattr(p, "conv_shortcut"):
        shortcut = linear(p.conv_shortcut, shortcut)
    return shortcut + h


@dataclass(frozen=True)
class UNetMidBlock3DConfig:
    dims: Union[int, Tuple[int, int]] = 3
    in_channels: int = 128
    num_layers: int = 1
    resnet_eps: float = 1e-6
    resnet_groups: int = 32
    norm_layer: NormLayerType = NormLayerType.GROUP_NORM
    inject_noise: bool = False
    timestep_conditioning: bool = False
    spatial_padding_mode: PaddingModeType = PaddingModeType.ZEROS

    def block_config(self) -> ResnetBlock3DConfig:
        return ResnetBlock3DConfig(
            dims=self.dims, in_channels=self.in_channels, out_channels=self.in_channels,
            groups=self.resnet_groups, eps=self.resnet_eps, norm_layer=self.norm_layer,
            inject_noise=self.inject_noise, timestep_conditioning=self.timestep_conditioning,
            spatial_padding_mode=self.spatial_padding_mode,
        )


class UNetMidBlock3D(nn.Module):
    """`res_blocks`: num_layers ResnetBlock3Ds of one width."""

    def __init__(self, cfg: UNetMidBlock3DConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.res_blocks = nn.ModuleList(ResnetBlock3D(cfg.block_config(), device=device, dtype=dtype)
                                        for _ in range(cfg.num_layers))


def unet_mid_block_3d_apply(p: UNetMidBlock3D, x: torch.Tensor, causal: bool = True,
                            timestep: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                            noise: Optional[Sequence[NoisePair]] = None,
                            conditioned: Optional[bool] = None) -> torch.Tensor:
    """The ResnetBlock3Ds in order, each with noise of its own: drawn in turn
    from `generator`, or noise[i] for block i."""
    for i, block in enumerate(p.res_blocks):
        x = resnet_block_3d_apply(block, x, causal, timestep, generator, None if noise is None else noise[i],
                                  conditioned)
    return x


def conv_launches(p: nn.Module) -> int:
    """Conv kernel launches of one apply of a block: one per Conv3d, the
    dual convs' spatial convs included (their temporal convs are products)."""
    return sum(isinstance(m, Conv3d) for m in p.modules())


@torch.no_grad()
def init_blocks_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place with ltx2_tpu's init_resnet_block_3d
    distributions: 3D convs weight and bias U(+-1/sqrt(inC k^3)); a dual
    conv's spatial weight U(+-1/sqrt(inC 9)) and temporal U(+-1/sqrt(midC
    3)), their biases zero; linears U(+-1/sqrt(in)); norms 1 and 0;
    scale/shift tables and noise scales zero."""
    dual_spatial = {id(m.conv1) for m in module.modules() if isinstance(m, DualConv3d)}
    for m in module.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / m.weight[0].numel() ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if id(m) in dual_spatial:
                m.bias.zero_()
            else:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, TemporalConv):
            bound = 1.0 / m.weight[0].numel() ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        elif isinstance(m, Linear):
            bound = 1.0 / m.weight.shape[1] ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, NormParams):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, prm in module.named_parameters():
        if name.rsplit(".", 1)[-1] in ("scale_shift_table", "last_scale_shift_table", "per_channel_scale1",
                                       "per_channel_scale2"):
            prm.zero_()
    return module

