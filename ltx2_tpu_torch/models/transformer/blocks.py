"""LTX-2 DiT transformer block, video stream (counterpart of
ltx2_tpu/models/transformer/blocks.py).

self-attention (AdaLN, RoPE) -> text cross-attention -> FFN, with the AdaLN
tables, modulation and gated residuals in fp32 and matmul inputs cast back
to the compute dtype; optional per-row keep masks on the residuals (STG),
a scale on the text cross-attention output (the late-block hook) and
precomputed text K/V (V1 caching). Not ported yet: the audio stream,
audio<->video cross-modal attention and V2 cross-attention AdaLN.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.core import rms_norm
from ltx2_tpu_torch.models.transformer.attention import (
    Attention,
    AttentionConfig,
    FeedForward,
    attention_apply,
    feed_forward_apply,
)


@dataclass(frozen=True)
class StreamConfig:
    """Static configuration of one DiT stream."""

    dim: int
    heads: int
    d_head: int
    context_dim: int


@dataclasses.dataclass
class StreamArgs:
    """Per-stream tensors threaded through the block stack."""

    x: torch.Tensor  # (B, T, D) hidden states
    context: torch.Tensor  # (B, S, D) projected text context
    timesteps: torch.Tensor  # (B, T|1, n_emb, D) AdaLN embeddings (fp32)
    pe: Tuple[torch.Tensor, torch.Tensor]  # RoPE (cos, sin)
    context_mask: Optional[torch.Tensor] = None  # additive (B, 1, 1, S)
    self_mask: Optional[torch.Tensor] = None  # additive (B, 1, 1, T)
    embedded_timestep: Optional[torch.Tensor] = None  # (B, T|1, D)

    def replace(self, **kwargs) -> "StreamArgs":
        return dataclasses.replace(self, **kwargs)


class VideoBlock(nn.Module):
    """One block's video-stream parameters, named as in the checkpoint."""

    def __init__(self, cfg: StreamConfig, norm_eps: float = 1e-6, *, device=None, dtype=torch.float32):
        super().__init__()
        base = AttentionConfig(query_dim=cfg.dim, heads=cfg.heads, dim_head=cfg.d_head, norm_eps=norm_eps)
        self.attn1 = Attention(base, device=device, dtype=dtype)
        self.attn2 = Attention(dataclasses.replace(base, context_dim=cfg.context_dim), device=device, dtype=dtype)
        self.ff = FeedForward(cfg.dim, cfg.dim, device=device, dtype=dtype)
        self.scale_shift_table = nn.Parameter(
            torch.zeros(6, cfg.dim, device=device, dtype=torch.float32), requires_grad=False
        )


def _ada_values(table: torch.Tensor, timestep: torch.Tensor, start: int, end: int) -> Tuple[torch.Tensor, ...]:
    """table (n, D) + timestep (B, T, n, D) -> per-index (B, T, D) fp32."""
    vals = table[None, None, start:end].float() + timestep[:, :, start:end].float()
    return tuple(vals[:, :, i] for i in range(end - start))


def _modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float) -> torch.Tensor:
    """rms_norm(x) * (1 + scale) + shift in fp32, back to x.dtype."""
    return (rms_norm(x, None, eps).float() * (1.0 + scale) + shift).to(x.dtype)


# Per-block keep masks, (B,) fp32 each: 1 = keep the residual, 0 = skip it.
PerturbMasks = Dict[str, torch.Tensor]


def _gated_residual(x: torch.Tensor, residual: torch.Tensor, gate: torch.Tensor,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + residual * gate [* keep per row] in fp32, back to x.dtype."""
    update = residual.float() * gate
    if keep is not None:
        update = update * keep[:, None, None]
    return (x.float() + update).to(x.dtype)


def _text_cross_attention(
    p: VideoBlock, attn_cfg: AttentionConfig, x: torch.Tensor, args: StreamArgs, norm_eps: float,
    cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """V1 text cross-attention: rms-normed queries, projected text keys (or
    this block's precomputed K/V)."""
    return attention_apply(
        p.attn2, attn_cfg, rms_norm(x, None, norm_eps), context=args.context, mask=args.context_mask,
        cached_kv=cached_kv,
    )


def av_block_apply(
    p: VideoBlock,
    video: StreamArgs,
    video_cfg: StreamConfig,
    norm_eps: float = 1e-6,
    perturb: Optional[PerturbMasks] = None,
    ca_scale: Optional[torch.Tensor] = None,
    video_text_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> StreamArgs:
    """One transformer block over the video stream. perturb: optional (B,)
    keep masks by name ("video_self" gates the self-attention residual);
    ca_scale: a scalar on the text cross-attention output, applied in its
    dtype; video_text_kv: this block's precomputed text (k, v)."""
    perturb = perturb or {}
    attn1 = AttentionConfig(
        query_dim=video_cfg.dim, heads=video_cfg.heads, dim_head=video_cfg.d_head, norm_eps=norm_eps
    )
    attn2 = dataclasses.replace(attn1, context_dim=video_cfg.context_dim)
    vx = video.x

    shift_msa, scale_msa, gate_msa = _ada_values(p.scale_shift_table, video.timesteps, 0, 3)
    attn_out = attention_apply(
        p.attn1, attn1, _modulate(vx, scale_msa, shift_msa, norm_eps), pe=video.pe, mask=video.self_mask
    )
    vx = _gated_residual(vx, attn_out, gate_msa, perturb.get("video_self"))

    cross_out = _text_cross_attention(p, attn2, vx, video, norm_eps, cached_kv=video_text_kv)
    if ca_scale is not None:
        cross_out = cross_out * ca_scale.to(cross_out.dtype)
    vx = (vx.float() + cross_out.float()).to(vx.dtype)

    shift_mlp, scale_mlp, gate_mlp = _ada_values(p.scale_shift_table, video.timesteps, 3, 6)
    ff_out = feed_forward_apply(p.ff, _modulate(vx, scale_mlp, shift_mlp, norm_eps))
    vx = _gated_residual(vx, ff_out, gate_mlp)
    return video.replace(x=vx)
