"""LTX-2 video DiT (counterpart of ltx2_tpu/models/transformer/model.py).

The video-only model: patchify projection, AdaLN-single timestep embedding,
an `nn.ModuleList` of blocks run in a Python loop (the JAX package stacks
them on a leading layer axis and scans), each block rematerialised in the
backward when `remat` is on and a gradient is being recorded (as
`jax.checkpoint` around the JAX scan body), final LayerNorm + scale/shift +
projection, and the x0 (denoised) wrapper; with `caption_channels` set,
the V1 caption projection (linear -> gelu-tanh -> linear) maps the text
encoder's output to the model's width before the blocks. Not ported yet:
the audio and audio-video models, V2 (cross-attention AdaLN, gated
attention, prompt AdaLN), STG perturbations, text-KV caching and the
parallel variants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ltx2_tpu_torch.models.transformer.blocks import StreamArgs, StreamConfig, VideoBlock, av_block_apply
from ltx2_tpu_torch.ops.common import Linear, init_linear_, layer_norm, linear
from ltx2_tpu_torch.ops.rope import precompute_freqs_cis
from ltx2_tpu_torch.ops.timestep_embedding import AdaLayerNormSingle, adaln_single_apply


@dataclasses.dataclass
class Modality:
    """One modality's inputs."""

    latent: torch.Tensor  # (B, T, C) patchified latents
    context: torch.Tensor  # (B, S, C_ctx) text context
    context_mask: Optional[torch.Tensor]  # (B, S) bool / additive float
    timesteps: torch.Tensor  # (B,) or (B, T)
    positions: torch.Tensor  # (B, n_dims, T, 2) position bounds
    sigma: Optional[torch.Tensor] = None  # (B,)
    token_mask: Optional[torch.Tensor] = None  # (B, T) bool, False = padding

    def replace(self, **kwargs) -> "Modality":
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class LTXModelConfig:
    """Static video-DiT architecture config. The defaults are the LTX-2.0
    video model fed a 4096-d text context directly (`caption_channels`
    None, as scripts/bench_e2e.py sets it); with `caption_channels` (3840
    for the V1 text encoder, the JAX dataclass's default) a caption
    projection maps that many channels to the model's width."""

    num_attention_heads: int = 32
    attention_head_dim: int = 128
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 48
    cross_attention_dim: int = 4096
    norm_eps: float = 1e-6
    caption_channels: Optional[int] = None
    positional_embedding_theta: float = 10000.0
    positional_embedding_max_pos: Tuple[int, ...] = (20, 2048, 2048)
    timestep_scale_multiplier: int = 1000
    use_middle_indices_grid: bool = True
    compute_dtype: str = "bfloat16"
    remat: bool = True  # checkpoint each block when gradients are recorded

    @property
    def video_inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def video_stream_config(self) -> StreamConfig:
        return StreamConfig(
            dim=self.video_inner_dim,
            heads=self.num_attention_heads,
            d_head=self.attention_head_dim,
            context_dim=self.cross_attention_dim,
        )


class LTXModel(nn.Module):
    """Parameters of the video DiT, named as in the checkpoint. Linear
    weights are in cfg.dtype; AdaLN-single and the scale/shift tables fp32.
    Parameters start uninitialised: load them (loader/from_numpy.py) or
    draw them (`init_ltx_model_`)."""

    def __init__(self, cfg: LTXModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        inner, dtype = cfg.video_inner_dim, cfg.dtype
        self.patchify_proj = Linear(cfg.in_channels, inner, device=device, dtype=dtype)
        self.adaln_single = AdaLayerNormSingle(inner, 6, device=device)
        if cfg.caption_channels is not None:
            self.caption_projection = nn.Module()
            self.caption_projection.linear_1 = Linear(cfg.caption_channels, inner, device=device, dtype=dtype)
            self.caption_projection.linear_2 = Linear(inner, inner, device=device, dtype=dtype)
        self.scale_shift_table = nn.Parameter(
            torch.zeros(2, inner, device=device, dtype=torch.float32), requires_grad=False
        )
        self.proj_out = Linear(inner, cfg.out_channels, device=device, dtype=dtype)
        stream = cfg.video_stream_config()
        self.transformer_blocks = nn.ModuleList(
            VideoBlock(stream, cfg.norm_eps, device=device, dtype=dtype) for _ in range(cfg.num_layers)
        )


@torch.no_grad()
def init_ltx_model_(model: LTXModel, generator: torch.Generator) -> LTXModel:
    """Random weights in place, on the parameters' device: every linear gets
    init_linear's U(-1/sqrt(in), 1/sqrt(in)); norms stay ones and the
    scale/shift tables zeros, as in ltx2_tpu's init_ltx_model."""
    for m in model.modules():
        if isinstance(m, Linear):
            init_linear_(m, generator)
    return model


def _prepare_timestep(
    adaln: AdaLayerNormSingle, timestep: torch.Tensor, inner_dim: int, batch: int, scale_multiplier: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Timestep -> (B, T|1, n_emb, D) AdaLN embeddings + (B, T|1, D) raw, fp32."""
    t = (timestep.float() * scale_multiplier).reshape(-1)
    emb, embedded = adaln_single_apply(adaln, t)
    n_emb = emb.shape[-1] // inner_dim
    return emb.reshape(batch, -1, n_emb, inner_dim), embedded.reshape(batch, -1, inner_dim)


def _prepare_attention_mask(mask: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """bool (B, S) -> additive key-only (B, 1, 1, S) at -finfo(dtype).max;
    an additive float (B, S) mask is reshaped to the same layout."""
    if mask is None:
        return None
    if mask.is_floating_point():
        return mask.reshape(mask.shape[0], 1, 1, mask.shape[-1]).to(dtype) if mask.ndim == 2 else mask
    additive = (1.0 - mask.float()) * -torch.finfo(dtype).max
    return additive.reshape(mask.shape[0], 1, 1, mask.shape[-1]).to(dtype)


def prepare_stream_args(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> StreamArgs:
    """The video preprocessor: patchify projection, AdaLN embeddings, masks
    and (unless precomputed) the RoPE tables."""
    cfg = model.cfg
    dtype, inner = cfg.dtype, cfg.video_inner_dim
    x = linear(model.patchify_proj, video.latent.to(dtype))
    batch = x.shape[0]
    timestep_emb, embedded = _prepare_timestep(
        model.adaln_single, video.timesteps, inner, batch, cfg.timestep_scale_multiplier
    )
    context = video.context.to(dtype)
    if cfg.caption_channels is not None:
        proj = model.caption_projection
        context = linear(proj.linear_2, F.gelu(linear(proj.linear_1, context), approximate="tanh"))
    context = context.reshape(batch, -1, inner)
    if video_pe is None:
        video_pe = precompute_freqs_cis(
            video.positions, dim=inner, theta=cfg.positional_embedding_theta,
            max_pos=list(cfg.positional_embedding_max_pos),
            use_middle_indices_grid=cfg.use_middle_indices_grid,
            num_attention_heads=cfg.num_attention_heads,
        )
    return StreamArgs(
        x=x, context=context, timesteps=timestep_emb, pe=video_pe,
        context_mask=_prepare_attention_mask(video.context_mask, dtype),
        self_mask=_prepare_attention_mask(video.token_mask, dtype),
        embedded_timestep=embedded,
    )


def _process_output(
    table: torch.Tensor, norm_eps: float, proj: Linear, x: torch.Tensor, embedded_timestep: torch.Tensor
) -> torch.Tensor:
    """Final LayerNorm (no affine) + scale/shift (fp32) + proj_out."""
    ss = table[None, None].float() + embedded_timestep[:, :, None].float()
    shift, scale = ss[:, :, 0], ss[:, :, 1]
    out = layer_norm(x, eps=norm_eps).float() * (1.0 + scale) + shift
    return linear(proj, out.to(x.dtype))


def _block_x(block: VideoBlock, x: torch.Tensor, args: StreamArgs, stream: StreamConfig, eps: float):
    """One block on hidden states `x`: the unit that remat recomputes."""
    return av_block_apply(block, args.replace(x=x), stream, eps).x


def ltx_model_apply(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Forward pass -> fp32 velocity (B, T, out_channels)."""
    cfg = model.cfg
    args = prepare_stream_args(model, video, video_pe)
    stream = cfg.video_stream_config()
    remat = cfg.remat and torch.is_grad_enabled()
    for block in model.transformer_blocks:
        if remat:
            args = args.replace(x=checkpoint(_block_x, block, args.x, args, stream, cfg.norm_eps,
                                             use_reentrant=False))
        else:
            args = av_block_apply(block, args, stream, cfg.norm_eps)
    return _process_output(
        model.scale_shift_table, cfg.norm_eps, model.proj_out, args.x, args.embedded_timestep
    ).float()


def x0_model_apply(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Denoised sample x0 = latent - t * velocity, fp32."""
    velocity = ltx_model_apply(model, video, video_pe)
    t = video.timesteps.float()
    t = t[:, None, None] if t.ndim == 1 else t[:, :, None]
    return video.latent.float() - t * velocity
