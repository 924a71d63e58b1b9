"""LTX-2 DiT attention layer (counterpart of
ltx2_tpu/models/transformer/attention.py).

QKV linears with bias, RMSNorm over the FULL inner dim of Q and K (not per
head), RoPE on Q/K (SPLIT in the DiT, INTERLEAVED in the text connector),
then `sdpa_tokens`, which on the GPU is the hand-written flash-attention
kernel for the DiT's bf16 attention (the connector's fp32 attention takes
`sdpa`'s plain route). A step-invariant context's K/V may be handed in
precomputed (`cached_kv`: V1 text-KV caching), and the keys may take their
own RoPE tables (`k_pe`: the audio<->video cross-modal attention rotates
each side by its own timeline). V2 (LTX-2.3) gates each head's output by
2 * sigmoid(`to_gate_logits`(x)) before `to_out`. Not ported yet: the
sequence- and tensor-parallel paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.core import rms_norm
from ltx2_tpu_torch.ops.attention import sdpa_tokens
from ltx2_tpu_torch.ops.common import Linear, linear
from ltx2_tpu_torch.ops.rope import LTXRopeType, apply_rotary_emb


@dataclass(frozen=True)
class AttentionConfig:
    query_dim: int
    context_dim: Optional[int] = None
    heads: int = 8
    dim_head: int = 64
    norm_eps: float = 1e-6
    rope_type: LTXRopeType = LTXRopeType.SPLIT
    apply_gated_attention: bool = False  # V2: per-head output gates

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head


class NormWeight(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype), requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: AttentionConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        context_dim = cfg.query_dim if cfg.context_dim is None else cfg.context_dim
        inner = cfg.inner_dim
        self.to_q = Linear(cfg.query_dim, inner, device=device, dtype=dtype)
        self.to_k = Linear(context_dim, inner, device=device, dtype=dtype)
        self.to_v = Linear(context_dim, inner, device=device, dtype=dtype)
        self.to_out = Linear(inner, cfg.query_dim, device=device, dtype=dtype)
        self.q_norm = NormWeight(inner, device=device, dtype=dtype)
        self.k_norm = NormWeight(inner, device=device, dtype=dtype)
        if cfg.apply_gated_attention:
            self.to_gate_logits = Linear(cfg.query_dim, cfg.heads, device=device, dtype=dtype)


def attention_apply(
    p: Attention,
    cfg: AttentionConfig,
    x: torch.Tensor,
    context: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cached_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    k_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Attention forward over (B, T, D) tokens; `context` None = self-attention.
    cached_kv: the context's (k, v), already projected and k-normed; the
    K/V projections are then skipped (RoPE is never applied to them).
    k_pe: the keys' RoPE tables when they differ from the queries' `pe`
    (applied only with `pe`, as in the JAX package)."""
    q = rms_norm(linear(p.to_q, x), p.q_norm.weight, cfg.norm_eps)
    if cached_kv is not None:
        k, v = cached_kv
    else:
        ctx = x if context is None else context
        k = rms_norm(linear(p.to_k, ctx), p.k_norm.weight, cfg.norm_eps)
        v = linear(p.to_v, ctx)
    if pe is not None:
        q = apply_rotary_emb(q, pe, cfg.rope_type)
        if cached_kv is None:
            k = apply_rotary_emb(k, pe if k_pe is None else k_pe, cfg.rope_type)
    out = sdpa_tokens(q, k, v, cfg.heads, cfg.dim_head, mask=mask)
    if cfg.apply_gated_attention:
        out = apply_gated_attention(p, cfg, x, out)
    return linear(p.to_out, out)


def apply_gated_attention(p: Attention, cfg: AttentionConfig, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """V2's per-head gate on the attention output (B, T, H * D): 2 *
    sigmoid(to_gate_logits(x)) in fp32, rounded to the output's dtype, then
    the product in that dtype."""
    gates = (2.0 * torch.sigmoid(linear(p.to_gate_logits, x).float())).to(out.dtype)
    b, t, _ = out.shape
    return (out.reshape(b, t, cfg.heads, cfg.dim_head) * gates[..., None]).reshape(b, t, cfg.inner_dim)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dim_out: int, mult: int = 4, *, device=None, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        self.project_in = nn.Module()
        self.project_in.proj = Linear(dim, inner, device=device, dtype=dtype)
        self.project_out = Linear(inner, dim_out, device=device, dtype=dtype)


def feed_forward_apply(p: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """Linear -> gelu_tanh -> Linear."""
    return linear(p.project_out, F.gelu(linear(p.project_in.proj, x), approximate="tanh"))
