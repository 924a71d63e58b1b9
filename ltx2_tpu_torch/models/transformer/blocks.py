"""LTX-2 DiT transformer block, video and audio streams (counterpart of
ltx2_tpu/models/transformer/blocks.py).

Per stream: self-attention (AdaLN, RoPE) -> text cross-attention; then,
with both streams, audio->video and video->audio cross-modal attention
(5-row scale/shift/gate tables per side, the queries' and keys' own
temporal RoPE); then each stream's FFN. The AdaLN
tables, modulation and gated residuals in fp32 and matmul inputs cast back
to the compute dtype; optional per-row keep masks on the residuals (STG),
a scale on the text cross-attention output (the late-block hook) and
precomputed text K/V (V1 caching). V2 (LTX-2.3, `cross_attention_adaln`)
adds AdaLN rows 6-8 on the text cross-attention's queries and output, and a
per-step prompt table that modulates its context, so its K/V change every
step; the audio stream has the same switches, its own tables
(`audio_scale_shift_table`, `audio_prompt_scale_shift_table`) and gates.
Both cross-modal residuals read the streams' rms-normed states taken once,
after the text cross-attention and before either update. The audio-only
model's block (`AudioBlock`) holds the audio stream alone.

Scale-out: a stream's `sequence_axis` splits its tokens over the ranks
(self-attention on the ring; the cross-modal attentions gather the other
stream's K/V, each taking the KV side's axis; text cross-attention local)
and its `tp_axis` its heads and features (the FFN's project_out and every
`to_out` row-parallel), as the JAX package's blocks.py:55-59,204-342.
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
    cross_attention_adaln: bool = False  # V2: 9 AdaLN rows, prompt-modulated text K/V
    apply_gated_attention: bool = False  # V2: per-head attention output gates
    # Scale-out: the mesh axes of the token split and of the head/feature split.
    sequence_axis: Optional[object] = None
    tp_axis: Optional[object] = None

    def attention_config(self, norm_eps: float) -> AttentionConfig:
        """The self-attention's config; the text cross-attention's adds
        `context_dim` and drops `sequence_axis` (its context is whole)."""
        return AttentionConfig(query_dim=self.dim, heads=self.heads, dim_head=self.d_head, norm_eps=norm_eps,
                               apply_gated_attention=self.apply_gated_attention, sequence_axis=self.sequence_axis,
                               tp_axis=self.tp_axis)


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
    prompt_timestep: Optional[torch.Tensor] = None  # (B, 1, 2, D) V2 text K/V modulation (fp32)
    # Audio-video: the temporal RoPE of the cross-modal attention, and its
    # AdaLN embeddings from the other stream's sigma.
    cross_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    cross_scale_shift_timestep: Optional[torch.Tensor] = None  # (B, 1, 4, D)
    cross_gate_timestep: Optional[torch.Tensor] = None  # (B, 1, 1, D)

    def replace(self, **kwargs) -> "StreamArgs":
        return dataclasses.replace(self, **kwargs)


class VideoBlock(nn.Module):
    """One block's video-stream parameters, named as in the checkpoint."""

    def __init__(self, cfg: StreamConfig, norm_eps: float = 1e-6, *, device=None, dtype=torch.float32):
        super().__init__()
        base = cfg.attention_config(norm_eps)
        self.attn1 = Attention(base, device=device, dtype=dtype)
        self.attn2 = Attention(dataclasses.replace(base, context_dim=cfg.context_dim), device=device, dtype=dtype)
        self.ff = FeedForward(cfg.dim, cfg.dim, device=device, dtype=dtype)
        self.scale_shift_table = nn.Parameter(
            torch.zeros(9 if cfg.cross_attention_adaln else 6, cfg.dim, device=device, dtype=torch.float32),
            requires_grad=False,
        )
        if cfg.cross_attention_adaln:
            self.prompt_scale_shift_table = nn.Parameter(
                torch.zeros(2, cfg.dim, device=device, dtype=torch.float32), requires_grad=False
            )


def _cross_modal_configs(video: StreamConfig, audio: StreamConfig, norm_eps: float
                         ) -> Tuple[AttentionConfig, AttentionConfig]:
    """(audio->video, video->audio) attention configs: the audio stream's
    heads on both, each gated as its query stream is, each split over its
    KV side's sequence axis and its query side's TP axis."""
    a2v = AttentionConfig(query_dim=video.dim, context_dim=audio.dim, heads=audio.heads, dim_head=audio.d_head,
                          norm_eps=norm_eps, apply_gated_attention=video.apply_gated_attention,
                          sequence_axis=audio.sequence_axis, tp_axis=video.tp_axis)
    v2a = AttentionConfig(query_dim=audio.dim, context_dim=video.dim, heads=audio.heads, dim_head=audio.d_head,
                          norm_eps=norm_eps, apply_gated_attention=audio.apply_gated_attention,
                          sequence_axis=video.sequence_axis, tp_axis=audio.tp_axis)
    return a2v, v2a


def _table(rows: int, dim: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(rows, dim, device=device, dtype=torch.float32), requires_grad=False)


def _add_audio_stream_(block: nn.Module, audio: StreamConfig, norm_eps: float, device, dtype) -> None:
    """The audio stream's parameters (`audio_attn1`, `audio_attn2`,
    `audio_ff` and their tables), named as in the checkpoint."""
    base = audio.attention_config(norm_eps)
    block.audio_attn1 = Attention(base, device=device, dtype=dtype)
    block.audio_attn2 = Attention(dataclasses.replace(base, context_dim=audio.context_dim), device=device,
                                  dtype=dtype)
    block.audio_ff = FeedForward(audio.dim, audio.dim, device=device, dtype=dtype)
    block.audio_scale_shift_table = _table(9 if audio.cross_attention_adaln else 6, audio.dim, device)
    if audio.cross_attention_adaln:
        block.audio_prompt_scale_shift_table = _table(2, audio.dim, device)


class AudioBlock(nn.Module):
    """One block of the audio-only DiT: the audio stream's parameters alone."""

    def __init__(self, audio: StreamConfig, norm_eps: float = 1e-6, *, device=None, dtype=torch.float32):
        super().__init__()
        _add_audio_stream_(self, audio, norm_eps, device, dtype)


class AVBlock(VideoBlock):
    """One block of the audio-video DiT: the video stream's parameters, the
    audio stream's and the cross-modal attentions with their 5-row tables,
    named as in the checkpoint."""

    def __init__(self, cfg: StreamConfig, audio: StreamConfig, norm_eps: float = 1e-6, *, device=None,
                 dtype=torch.float32):
        super().__init__(cfg, norm_eps, device=device, dtype=dtype)
        _add_audio_stream_(self, audio, norm_eps, device, dtype)
        a2v, v2a = _cross_modal_configs(cfg, audio, norm_eps)
        self.audio_to_video_attn = Attention(a2v, device=device, dtype=dtype)
        self.video_to_audio_attn = Attention(v2a, device=device, dtype=dtype)
        self.scale_shift_table_a2v_ca_audio = _table(5, audio.dim, device)
        self.scale_shift_table_a2v_ca_video = _table(5, cfg.dim, device)


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
    attn: Attention, table: torch.Tensor, prompt_table: Optional[torch.Tensor], cfg: StreamConfig,
    attn_cfg: AttentionConfig, x: torch.Tensor, args: StreamArgs, norm_eps: float,
    cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Text cross-attention. V1: rms-normed queries, projected text keys
    (or this block's precomputed K/V). V2: the queries modulated by AdaLN
    rows 6-8 (shift, scale), the context by the prompt table plus the prompt
    timestep in fp32, the output times row 8's gate; no cached K/V."""
    if cfg.cross_attention_adaln:
        assert cached_kv is None, "text KV caching is incompatible with V2 KV modulation"
        shift_q, scale_q, gate = _ada_values(table, args.timesteps, 6, 9)
        kv_mod = prompt_table[None, None].float() + args.prompt_timestep.float()
        shift_kv, scale_kv = kv_mod[:, :, 0], kv_mod[:, :, 1]
        ctx = (args.context.float() * (1.0 + scale_kv) + shift_kv).to(x.dtype)
        out = attention_apply(attn, attn_cfg, _modulate(x, scale_q, shift_q, norm_eps), context=ctx,
                              mask=args.context_mask)
        return (out.float() * gate).to(x.dtype)
    return attention_apply(
        attn, attn_cfg, rms_norm(x, None, norm_eps), context=args.context, mask=args.context_mask,
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
    """One transformer block over the video stream alone (`joint_block_apply`
    without audio)."""
    return joint_block_apply(p, video, None, video_cfg, None, norm_eps, perturb, ca_scale, video_text_kv)[0]


def _stream_head(attn1: Attention, attn2: Attention, table: torch.Tensor, prompt_table: Optional[torch.Tensor],
                 cfg: StreamConfig, args: StreamArgs, norm_eps: float, keep: Optional[torch.Tensor],
                 text_kv, ca_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A stream's self-attention (AdaLN rows 0-2, gated residual, `keep`
    per row) and text cross-attention (scaled by `ca_scale`, in its dtype)."""
    self_cfg = cfg.attention_config(norm_eps)
    x = args.x
    shift, scale, gate = _ada_values(table, args.timesteps, 0, 3)
    out = attention_apply(attn1, self_cfg, _modulate(x, scale, shift, norm_eps), pe=args.pe, mask=args.self_mask)
    x = _gated_residual(x, out, gate, keep)
    cross = _text_cross_attention(attn2, table, prompt_table, cfg,
                                  dataclasses.replace(self_cfg, context_dim=cfg.context_dim, sequence_axis=None),
                                  x, args, norm_eps, cached_kv=text_kv)
    if ca_scale is not None:
        cross = cross * ca_scale.to(cross.dtype)
    return (x.float() + cross.float()).to(x.dtype)


def _stream_ff(ff: FeedForward, table: torch.Tensor, args: StreamArgs, x: torch.Tensor, norm_eps: float,
               tp_axis=None) -> torch.Tensor:
    shift, scale, gate = _ada_values(table, args.timesteps, 3, 6)
    return _gated_residual(x, feed_forward_apply(ff, _modulate(x, scale, shift, norm_eps), tp_axis), gate)


def _av_ca_values(table: torch.Tensor, ss_timestep: torch.Tensor, gate_timestep: torch.Tensor):
    """A 5-row cross-modal table -> (scale_a2v, shift_a2v, scale_v2a,
    shift_v2a, gate), each (B, 1, D) fp32: rows 0-3 plus the 4-embedding
    timestep, row 4 plus the gate timestep."""
    ss = table[None, None, :4].float() + ss_timestep.float()
    gate = table[None, None, 4:].float() + gate_timestep.float()
    return tuple(ss[:, :, i] for i in range(4)) + (gate[:, :, 0],)


def joint_block_apply(
    p: nn.Module,
    video: Optional[StreamArgs],
    audio: Optional[StreamArgs],
    video_cfg: Optional[StreamConfig],
    audio_cfg: Optional[StreamConfig],
    norm_eps: float = 1e-6,
    perturb: Optional[PerturbMasks] = None,
    ca_scale: Optional[torch.Tensor] = None,
    video_text_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    audio_text_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[Optional[StreamArgs], Optional[StreamArgs]]:
    """One transformer block -> (video, audio) stream args, each None when
    not given (the audio-only model gives no video). perturb: optional (B,)
    keep masks by name ("video_self", "audio_self", "a2v", "v2a" gate those
    residuals); ca_scale: a scalar on the video text cross-attention's
    output, applied in its dtype; video_text_kv / audio_text_kv: this
    block's precomputed text (k, v)."""
    perturb = perturb or {}
    vx = ax = None
    if video is not None:
        vx = _stream_head(p.attn1, p.attn2, p.scale_shift_table, getattr(p, "prompt_scale_shift_table", None),
                          video_cfg, video, norm_eps, perturb.get("video_self"), video_text_kv, ca_scale)
    if audio is not None:
        ax = _stream_head(p.audio_attn1, p.audio_attn2, p.audio_scale_shift_table,
                          getattr(p, "audio_prompt_scale_shift_table", None), audio_cfg, audio, norm_eps,
                          perturb.get("audio_self"), audio_text_kv)
    if video is not None and audio is not None:
        a2v_cfg, v2a_cfg = _cross_modal_configs(video_cfg, audio_cfg, norm_eps)
        # Both residuals read the states normed once, before either update.
        vx_norm, ax_norm = rms_norm(vx, None, norm_eps), rms_norm(ax, None, norm_eps)
        scale_a_a2v, shift_a_a2v, scale_a_v2a, shift_a_v2a, gate_v2a = _av_ca_values(
            p.scale_shift_table_a2v_ca_audio, audio.cross_scale_shift_timestep, audio.cross_gate_timestep)
        scale_v_a2v, shift_v_a2v, scale_v_v2a, shift_v_v2a, gate_a2v = _av_ca_values(
            p.scale_shift_table_a2v_ca_video, video.cross_scale_shift_timestep, video.cross_gate_timestep)

        vq = (vx_norm.float() * (1.0 + scale_v_a2v) + shift_v_a2v).to(vx.dtype)
        akv = (ax_norm.float() * (1.0 + scale_a_a2v) + shift_a_a2v).to(ax.dtype)
        a2v = attention_apply(p.audio_to_video_attn, a2v_cfg, vq, context=akv, pe=video.cross_pe,
                              k_pe=audio.cross_pe, gather_context=a2v_cfg.sequence_axis is not None)
        vx = _gated_residual(vx, a2v, gate_a2v, perturb.get("a2v"))

        aq = (ax_norm.float() * (1.0 + scale_a_v2a) + shift_a_v2a).to(ax.dtype)
        vkv = (vx_norm.float() * (1.0 + scale_v_v2a) + shift_v_v2a).to(vx.dtype)
        v2a = attention_apply(p.video_to_audio_attn, v2a_cfg, aq, context=vkv, pe=audio.cross_pe,
                              k_pe=video.cross_pe, gather_context=v2a_cfg.sequence_axis is not None)
        ax = _gated_residual(ax, v2a, gate_v2a, perturb.get("v2a"))

    if video is not None:
        vx = _stream_ff(p.ff, p.scale_shift_table, video, vx, norm_eps, video_cfg.tp_axis)
    if audio is not None:
        ax = _stream_ff(p.audio_ff, p.audio_scale_shift_table, audio, ax, norm_eps, audio_cfg.tp_axis)
    return (None if video is None else video.replace(x=vx)), (None if audio is None else audio.replace(x=ax))
