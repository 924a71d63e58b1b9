"""Full (non-"simple") config-driven video encoder and decoder (counterpart
of ltx2_tpu/models/video_vae/full_vae.py): block lists over ResnetBlock3D,
UNetMidBlock3D, strided causal convs and the residual space-to-depth (down)
and depth-to-space (up) blocks.

The configs and their `plan`s are the JAX package's, channel walk
included; the modules keep the JAX tree's names, so `from_numpy` loads a JAX
tree strictly. Channels-last (B, T, H, W, C) inside. Every 3D conv runs
through `conv3d_ndhwc`, the strided `compress_time`, `compress_space` and
`compress_all(_x_y)` convs too: on the card the hand-written conv kernels
(fp32: 3xTF32, bf16: wgmma), on the CPU their plain version. The residual
`compress_*_res` blocks are the simple encoder's `_down_block`, the decoder's
`compress_*` blocks the simple decoder's `_upsample_block`.

The port computes in its modules' dtype, as the JAX apply computes in the
input's. Noise (the decoder's decode noise and its blocks' injected noise)
is drawn from an explicit `torch.Generator`, or handed in; the JAX package
draws it from `jax.random` keys, so the two agree only on handed-in noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc, from_ndhwc, to_ndhwc
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics, _Upsample, _upsample_block
from ltx2_tpu_torch.models.video_vae.encoder import _down_block, _EncDown
from ltx2_tpu_torch.models.video_vae.ops import (
    normalize_latent, patchify, pixel_norm, un_normalize_latent, unpatchify,
)
from ltx2_tpu_torch.models.video_vae.resnet import (
    NormLayerType, NormParams, PaddingModeType, ResnetBlock3D, ResnetBlock3DConfig, UNetMidBlock3D,
    UNetMidBlock3DConfig, draw_noise, group_norm_ndhwc, init_blocks_, resnet_block_3d_apply, spatial_mode,
    unet_mid_block_3d_apply,
)

BlockSpec = Tuple[str, Union[int, Dict[str, Any]]]


def _block_config(params: Union[int, Dict[str, Any], None]) -> Dict[str, Any]:
    if params is None:
        return {}
    if isinstance(params, int):
        return {"num_layers": params}
    return dict(params)


# ---------------------------------------------------------------- encoder

DEFAULT_ENCODER_BLOCKS: Tuple[BlockSpec, ...] = (
    ("res_x", 4),
    ("compress_space_res", {"multiplier": 2}),
    ("res_x", 6),
    ("compress_time_res", {"multiplier": 2}),
    ("res_x", 6),
    ("compress_all_res", {"multiplier": 2}),
    ("res_x", 2),
    ("compress_all_res", {"multiplier": 2}),
    ("res_x", 2),
)

_COMPRESS_STRIDES = {
    "compress_time": (2, 1, 1),
    "compress_space": (1, 2, 2),
    "compress_all": (2, 2, 2),
    "compress_all_x_y": (2, 2, 2),
    "compress_all_res": (2, 2, 2),
    "compress_space_res": (1, 2, 2),
    "compress_time_res": (2, 1, 1),
}
_STRIDED = ("compress_time", "compress_space", "compress_all", "compress_all_x_y")


@dataclass(frozen=True)
class FullVideoEncoderConfig:
    in_channels: int = 3
    out_channels: int = 128
    patch_size: int = 4
    blocks: Tuple[BlockSpec, ...] = DEFAULT_ENCODER_BLOCKS
    norm_layer: NormLayerType = NormLayerType.PIXEL_NORM
    norm_num_groups: int = 32
    latent_log_var: str = "uniform"  # per_channel | uniform | constant | none
    spatial_padding_mode: PaddingModeType = PaddingModeType.ZEROS
    dims: Union[int, Tuple[int, int]] = 3
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def base_channels(self) -> int:
        """conv_in's output width: the latent's channels."""
        return self.out_channels

    @property
    def plan(self) -> List[Tuple[str, Dict[str, Any], int, int]]:
        """[(name, config, in_ch, out_ch)], the reference's channel walk."""
        out: List[Tuple[str, Dict[str, Any], int, int]] = []
        ch = self.base_channels
        for name, params in self.blocks:
            cfg = _block_config(params)
            in_ch = ch
            if name in ("res_x_y", "compress_all_x_y", "compress_all_res", "compress_space_res",
                        "compress_time_res"):
                ch = ch * cfg.get("multiplier", 2)
            elif name not in ("res_x", "compress_time", "compress_space", "compress_all"):
                raise ValueError(f"Unknown encoder block: {name}")
            out.append((name, cfg, in_ch, ch))
        return out

    @property
    def final_channels(self) -> int:
        return self.plan[-1][3] if self.blocks else self.base_channels

    @property
    def conv_out_channels(self) -> int:
        c = self.out_channels
        if self.latent_log_var == "per_channel":
            return 2 * c
        if self.latent_log_var in ("uniform", "constant"):
            return c + 1
        return c

    def mid_config(self, in_ch: int, bcfg: Dict[str, Any]) -> UNetMidBlock3DConfig:
        return UNetMidBlock3DConfig(dims=self.dims, in_channels=in_ch, num_layers=bcfg.get("num_layers", 1),
                                    resnet_groups=self.norm_num_groups, norm_layer=self.norm_layer,
                                    spatial_padding_mode=self.spatial_padding_mode)

    def res_config(self, in_ch: int, out_ch: int) -> ResnetBlock3DConfig:
        return ResnetBlock3DConfig(dims=self.dims, in_channels=in_ch, out_channels=out_ch,
                                   groups=self.norm_num_groups, norm_layer=self.norm_layer,
                                   spatial_padding_mode=self.spatial_padding_mode)


class FullVideoEncoder(nn.Module):
    """The full encoder's parameters under the JAX tree's names: conv_in,
    down_blocks.{i} (a UNetMidBlock3D, a ResnetBlock3D, a strided Conv3d or
    a residual block's `conv`), conv_norm_out with group norm, conv_out,
    per_channel_statistics (fp32); on `device`, the card by default."""

    def __init__(self, cfg: FullVideoEncoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, device = cfg.dtype, resolve_device(device)
        self.conv_in = Conv3d(cfg.in_channels * cfg.patch_size ** 2, cfg.base_channels, device=device, dtype=dtype)
        blocks = []
        for name, bcfg, in_ch, out_ch in cfg.plan:
            if name == "res_x":
                blocks.append(UNetMidBlock3D(cfg.mid_config(in_ch, bcfg), device=device, dtype=dtype))
            elif name == "res_x_y":
                blocks.append(ResnetBlock3D(cfg.res_config(in_ch, out_ch), device=device, dtype=dtype))
            elif name in _STRIDED:
                blocks.append(Conv3d(in_ch, out_ch, device=device, dtype=dtype))
            else:
                blocks.append(_EncDown(in_ch, out_ch, _COMPRESS_STRIDES[name], device=device, dtype=dtype))
        self.down_blocks = nn.ModuleList(blocks)
        if cfg.norm_layer == NormLayerType.GROUP_NORM:
            self.conv_norm_out = NormParams(cfg.final_channels, device=device, dtype=dtype)
        self.conv_out = Conv3d(cfg.final_channels, cfg.conv_out_channels, device=device, dtype=dtype)
        self.per_channel_statistics = PerChannelStatistics(cfg.out_channels, device=device)


def _out_norm(norm_layer: NormLayerType, p: Optional[NormParams], x: torch.Tensor, groups: int) -> torch.Tensor:
    if norm_layer == NormLayerType.PIXEL_NORM:
        return pixel_norm(x)
    return group_norm_ndhwc(x, groups, p)


def full_video_encoder_apply(encoder: FullVideoEncoder, sample: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """(B, 3, F, H, W) -> the normalized fp32 latent means (B, C, F', H',
    W'); F must be 8k + 1. The encoder is always causal (causal=False
    raises)."""
    cfg = encoder.cfg
    if not causal:
        raise ValueError("the full video encoder is always causal (reference encoder.py:264-280)")
    frames = sample.shape[2]
    if (frames - 1) % 8 != 0:
        raise ValueError(f"Invalid number of frames: {frames}. "
                         "Encoder input must have 1 + 8*k frames (e.g., 1, 9, 17, ...).")
    smode = spatial_mode(cfg.spatial_padding_mode)
    x = to_ndhwc(patchify(sample.to(cfg.dtype), patch_size_hw=cfg.patch_size, patch_size_t=1))
    x = conv3d_ndhwc(encoder.conv_in, x, causal=True, spatial_mode=smode)
    for block, (name, _bcfg, in_ch, out_ch) in zip(encoder.down_blocks, cfg.plan):
        if name == "res_x":
            x = unet_mid_block_3d_apply(block, x, causal=True)
        elif name == "res_x_y":
            x = resnet_block_3d_apply(block, x, causal=True)
        elif name in _STRIDED:
            x = conv3d_ndhwc(block, x, causal=True, spatial_mode=smode, stride=_COMPRESS_STRIDES[name])
        else:
            x = _down_block(block, x, True, in_ch, out_ch, _COMPRESS_STRIDES[name])
    x = _out_norm(cfg.norm_layer, getattr(encoder, "conv_norm_out", None), x, cfg.norm_num_groups)
    x = F.silu(x.float()).to(cfg.dtype)
    x = from_ndhwc(conv3d_ndhwc(encoder.conv_out, x, causal=True, spatial_mode=smode))
    return normalize_latent(x[:, :cfg.out_channels].float(), encoder.per_channel_statistics).float()


# ---------------------------------------------------------------- decoder

# Stored forward (un-reversed), as the metadata's `decoder_blocks`.
DEFAULT_DECODER_BLOCKS: Tuple[BlockSpec, ...] = (
    ("res_x", {"num_layers": 5, "inject_noise": False}),
    ("compress_all", {"residual": True, "multiplier": 2}),
    ("res_x", {"num_layers": 5, "inject_noise": False}),
    ("compress_all", {"residual": True, "multiplier": 2}),
    ("res_x", {"num_layers": 5, "inject_noise": False}),
    ("compress_all", {"residual": True, "multiplier": 2}),
    ("res_x", {"num_layers": 5, "inject_noise": False}),
)


@dataclass(frozen=True)
class FullVideoDecoderConfig:
    in_channels: int = 128
    out_channels: int = 3
    patch_size: int = 4
    blocks: Tuple[BlockSpec, ...] = DEFAULT_DECODER_BLOCKS
    norm_layer: NormLayerType = NormLayerType.PIXEL_NORM
    norm_num_groups: int = 32
    causal: bool = False
    timestep_conditioning: bool = False
    spatial_padding_mode: PaddingModeType = PaddingModeType.REFLECT
    dims: Union[int, Tuple[int, int]] = 3
    decode_noise_scale: float = 0.025
    decode_timestep: float = 0.05
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def initial_channels(self) -> int:
        """conv_in's output width: the reversed block list's channels
        multiplied back up."""
        ch = self.in_channels
        for name, params in reversed(self.blocks):
            bcfg = _block_config(params)
            if name == "res_x_y":
                ch *= bcfg.get("multiplier", 2)
            elif name == "compress_all":
                ch *= bcfg.get("multiplier", 1)
        return ch

    @property
    def plan(self) -> List[Tuple[str, Dict[str, Any], int, int]]:
        """[(name, config, in_ch, out_ch)] over the reversed block list."""
        out: List[Tuple[str, Dict[str, Any], int, int]] = []
        ch = self.initial_channels
        for name, params in reversed(self.blocks):
            bcfg = _block_config(params)
            in_ch = ch
            if name == "res_x_y":
                ch = ch // bcfg.get("multiplier", 2)
            elif name == "compress_all":
                ch = ch // bcfg.get("multiplier", 1)
            elif name not in ("res_x", "compress_time", "compress_space"):
                raise ValueError(f"Unknown decoder block: {name}")
            out.append((name, bcfg, in_ch, ch))
        return out

    @property
    def final_channels(self) -> int:
        return self.plan[-1][3] if self.blocks else self.initial_channels

    def mid_config(self, in_ch: int, bcfg: Dict[str, Any], conditioned: bool) -> UNetMidBlock3DConfig:
        return UNetMidBlock3DConfig(dims=self.dims, in_channels=in_ch, num_layers=bcfg.get("num_layers", 1),
                                    resnet_groups=self.norm_num_groups, norm_layer=self.norm_layer,
                                    inject_noise=bcfg.get("inject_noise", False),
                                    timestep_conditioning=conditioned,
                                    spatial_padding_mode=self.spatial_padding_mode)

    def res_config(self, in_ch: int, out_ch: int, bcfg: Dict[str, Any]) -> ResnetBlock3DConfig:
        return ResnetBlock3DConfig(dims=self.dims, in_channels=in_ch, out_channels=out_ch,
                                   groups=self.norm_num_groups, norm_layer=self.norm_layer,
                                   inject_noise=bcfg.get("inject_noise", False),
                                   spatial_padding_mode=self.spatial_padding_mode)


class FullVideoDecoder(nn.Module):
    """The full decoder's parameters under the JAX tree's names: conv_in,
    up_blocks.{i} (a UNetMidBlock3D, a ResnetBlock3D or a depth-to-space
    block's `conv`), conv_norm_out with group norm, conv_out,
    last_scale_shift_table (2, C) fp32 with timestep conditioning,
    per_channel_statistics (fp32); on `device`, the card by default."""

    def __init__(self, cfg: FullVideoDecoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype, device = cfg.dtype, resolve_device(device)
        self.conv_in = Conv3d(cfg.in_channels, cfg.initial_channels, device=device, dtype=dtype)
        blocks = []
        for name, bcfg, in_ch, out_ch in cfg.plan:
            if name == "res_x":
                blocks.append(UNetMidBlock3D(cfg.mid_config(in_ch, bcfg, cfg.timestep_conditioning), device=device,
                                             dtype=dtype))
            elif name == "res_x_y":
                blocks.append(ResnetBlock3D(cfg.res_config(in_ch, out_ch, bcfg), device=device, dtype=dtype))
            else:
                out = math.prod(_COMPRESS_STRIDES[name]) * in_ch // bcfg.get("multiplier", 1)
                blocks.append(_Upsample(in_ch, out, device=device, dtype=dtype))
        self.up_blocks = nn.ModuleList(blocks)
        if cfg.norm_layer == NormLayerType.GROUP_NORM:
            self.conv_norm_out = NormParams(cfg.final_channels, device=device, dtype=dtype)
        self.conv_out = Conv3d(cfg.final_channels, cfg.out_channels * cfg.patch_size ** 2, device=device,
                               dtype=dtype)
        if cfg.timestep_conditioning:
            self.last_scale_shift_table = nn.Parameter(torch.zeros(2, cfg.final_channels, device=device),
                                                       requires_grad=False)
        self.per_channel_statistics = PerChannelStatistics(cfg.in_channels, device=device)


def full_video_decoder_apply(
    decoder: FullVideoDecoder,
    sample: torch.Tensor,
    timestep_embeddings: Optional[Sequence[Optional[torch.Tensor]]] = None,
    last_timestep_embedding: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    decode_noise: Optional[torch.Tensor] = None,
    block_noise: Optional[Sequence[Optional[Sequence]]] = None,
) -> torch.Tensor:
    """Latent (B, C, F', H', W') -> fp32 video (B, 3, F, H, W), computed in
    the decoder's dtype.

    timestep_embeddings: per up block, None or a pre-embedded (B, 4 C) AdaLN
    timestep for its res_x blocks; last_timestep_embedding: (B, 2 C), the
    offset of the output scale/shift table (without it the table alone
    applies). Noise is drawn from `generator`, or handed in: `decode_noise`
    of the latent's shape, mixed in at cfg.decode_noise_scale before the
    latent is un-normalized (the full decoder's order) when the decoder is
    timestep-conditioned; `block_noise[i]` for up block i with injected
    noise (a UNetMidBlock3D's list of (noise1, noise2) pairs, or one pair
    for a ResnetBlock3D)."""
    cfg = decoder.cfg
    noisy = generator is not None or decode_noise is not None or block_noise is not None
    if cfg.timestep_conditioning and noisy:
        noise = draw_noise(sample.shape, sample, decode_noise, generator)
        sample = noise * cfg.decode_noise_scale + (1.0 - cfg.decode_noise_scale) * sample
    x = un_normalize_latent(sample.float(), decoder.per_channel_statistics)
    smode = spatial_mode(cfg.spatial_padding_mode)
    x = conv3d_ndhwc(decoder.conv_in, to_ndhwc(x.to(cfg.dtype)), causal=cfg.causal, spatial_mode=smode)
    plan = cfg.plan
    ts = list(timestep_embeddings) if timestep_embeddings is not None else [None] * len(plan)
    for i, (block, (name, bcfg, in_ch, _out_ch), t_emb) in enumerate(zip(decoder.up_blocks, plan, ts)):
        noise = block_noise[i] if block_noise is not None else None
        if name == "res_x":
            x = unet_mid_block_3d_apply(block, x, cfg.causal, t_emb, generator, noise,
                                        conditioned=cfg.timestep_conditioning and t_emb is not None)
        elif name == "res_x_y":
            x = resnet_block_3d_apply(block, x, cfg.causal, generator=generator, noise=noise)
        else:
            x = _upsample_block(block, x, cfg.causal, _COMPRESS_STRIDES[name], bcfg.get("multiplier", 1),
                                bcfg.get("residual", False), in_ch)
    x = _out_norm(cfg.norm_layer, getattr(decoder, "conv_norm_out", None), x, cfg.norm_num_groups)
    if cfg.timestep_conditioning:
        table = decoder.last_scale_shift_table.float()
        ada = table[None]
        if last_timestep_embedding is not None:
            ada = ada + last_timestep_embedding.reshape(-1, 2, table.shape[-1]).float()
        shift, scale = ada[:, 0][:, None, None, None, :], ada[:, 1][:, None, None, None, :]
        x = (x.float() * (1 + scale) + shift).to(x.dtype)
    x = F.silu(x.float()).to(x.dtype)
    x = conv3d_ndhwc(decoder.conv_out, x, causal=cfg.causal, spatial_mode=smode)
    return unpatchify(from_ndhwc(x), patch_size_hw=cfg.patch_size, patch_size_t=1).float()


# ---------------------------------------------------------------- init and counts


@torch.no_grad()
def init_full_video_encoder_(encoder: FullVideoEncoder, generator: torch.Generator) -> FullVideoEncoder:
    """Random weights in place with ltx2_tpu's init_full_video_encoder
    distributions (see `resnet.init_blocks_`); statistics 0 and 1."""
    return init_blocks_(encoder, generator)


@torch.no_grad()
def init_full_video_decoder_(decoder: FullVideoDecoder, generator: torch.Generator) -> FullVideoDecoder:
    """Random weights in place with ltx2_tpu's init_full_video_decoder
    distributions (see `resnet.init_blocks_`); tables zero, statistics 0
    and 1."""
    return init_blocks_(decoder, generator)


def conv_launches(cfg: Union[FullVideoEncoderConfig, FullVideoDecoderConfig]) -> Dict[str, int]:
    """Conv kernel launches of one apply: {"all": conv_in, conv_out, two per
    ResnetBlock3D (a dual conv's spatial conv is one launch, its temporal
    conv products), one per strided, space-to-depth or depth-to-space
    block; "strided": the strided compress_* convs among them}."""
    total, strided = 2, 0
    for name, bcfg, _in_ch, _out_ch in cfg.plan:
        if name == "res_x":
            total += 2 * bcfg.get("num_layers", 1)
        elif name == "res_x_y":
            total += 2
        else:
            total += 1
            strided += isinstance(cfg, FullVideoEncoderConfig) and name in _STRIDED
    return {"all": total, "strided": strided}
