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
2 * sigmoid(`to_gate_logits`(x)) before `to_out`.

Scale-out (the config's `sequence_axis` and `tp_axis`, mesh axes of
parallel/mesh.py; the JAX package's attention.py:33-43,90-124):
- with `sequence_axis` the token dim is this rank's shard: self-attention
  runs ring attention (parallel/ring_attention.py), cross-modal attention
  all-gathers its token-split K/V (`gather_context`), text cross-attention
  stays local (its context is whole on every rank); masked self-attention
  is refused;
- with `tp_axis` the module holds this rank's heads (column-parallel Q/K/V
  and gate logits, row-parallel `to_out`, parallel/sharding.py): Q and K
  are RMS-normed over the WHOLE inner dim (the sum of squares summed over
  the axis), RoPE and the V2 gates act on the rank's heads, and `to_out`'s
  partial products are summed over the axis (`linear_row_parallel`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.core import rms_norm
from ltx2_tpu_torch.ops.attention import sdpa_tokens
from ltx2_tpu_torch.ops.common import Linear, linear, linear_row_parallel
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
    # Scale-out: the mesh axis the token dim is split over (this rank holds
    # its shard), and the one the heads and features are split over.
    sequence_axis: Optional[object] = None
    tp_axis: Optional[object] = None

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head

    @property
    def local_heads(self) -> int:
        """The heads this rank computes: all, or its share under TP."""
        return self.heads // tp_size(self.tp_axis)


def tp_size(axis) -> int:
    return 1 if axis is None else axis.size


def rms_norm_tp(x: torch.Tensor, weight: torch.Tensor, eps: float, tp_axis) -> torch.Tensor:
    """`rms_norm` over a last dim split over `tp_axis`: the mean of squares
    over the whole dim (each rank's sum of squares summed over the axis),
    this rank's slice of the weight. tp_axis None: `rms_norm`."""
    if tp_axis is None or tp_axis.size == 1:
        return rms_norm(x, weight, eps)
    from ltx2_tpu_torch.parallel.collectives import all_reduce

    xf = x.float()
    ss = all_reduce(xf.pow(2).sum(dim=-1, keepdim=True), tp_axis)
    out = xf * torch.rsqrt(ss / (x.shape[-1] * tp_axis.size) + eps)
    return (out * weight.float()).to(x.dtype)


def local_pe(pe: Optional[Tuple[torch.Tensor, torch.Tensor]], tp_axis) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """SPLIT RoPE tables (B, H, T, D/2) cut to this rank's heads under TP."""
    if pe is None or tp_axis is None or tp_axis.size == 1:
        return pe
    h = pe[0].shape[1] // tp_axis.size
    return tuple(t.narrow(1, tp_axis.index * h, h) for t in pe)


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
    gather_context: bool = False,
) -> torch.Tensor:
    """Attention forward over (B, T, D) tokens; `context` None = self-attention.
    cached_kv: the context's (k, v), already projected and k-normed; the
    K/V projections are then skipped (RoPE is never applied to them).
    k_pe: the keys' RoPE tables when they differ from the queries' `pe`
    (applied only with `pe`, as in the JAX package). gather_context: under
    `cfg.sequence_axis`, the context is token-split too (cross-modal) and
    its K/V are all-gathered after RoPE. `pe`/`k_pe` are the tables of all
    heads; under TP this rank takes its own."""
    tp = cfg.tp_axis
    q = rms_norm_tp(linear(p.to_q, x), p.q_norm.weight, cfg.norm_eps, tp)
    if cached_kv is not None:
        k, v = cached_kv
    else:
        ctx = x if context is None else context
        k = rms_norm_tp(linear(p.to_k, ctx), p.k_norm.weight, cfg.norm_eps, tp)
        v = linear(p.to_v, ctx)
    if pe is not None:
        q = apply_rotary_emb(q, local_pe(pe, tp), cfg.rope_type)
        if cached_kv is None:
            k = apply_rotary_emb(k, local_pe(pe if k_pe is None else k_pe, tp), cfg.rope_type)
    heads, seq = cfg.local_heads, cfg.sequence_axis
    if seq is not None and context is None and mask is not None:
        raise NotImplementedError(
            "masked SELF-attention under sequence parallelism: the ring inner has no mask path — pad token "
            "counts to a multiple of the seq axis instead of bucketing (token_mask)")
    if seq is not None and context is None:
        from ltx2_tpu_torch.parallel.ring_attention import ring_attention_local

        b, t, _ = q.shape

        def heads_major(z):
            return z.view(b, t, heads, cfg.dim_head).transpose(1, 2)

        out = ring_attention_local(heads_major(q), heads_major(k), heads_major(v), seq)
        out = out.transpose(1, 2).reshape(b, t, heads * cfg.dim_head)
    else:
        if seq is not None and gather_context:
            from ltx2_tpu_torch.parallel.collectives import all_gather

            k, v = all_gather(k, seq, dim=1), all_gather(v, seq, dim=1)
        out = sdpa_tokens(q, k, v, heads, cfg.dim_head, mask=mask)
    if cfg.apply_gated_attention:
        out = apply_gated_attention(p, cfg, x, out)
    return linear_row_parallel(p.to_out, out, tp)


def apply_gated_attention(p: Attention, cfg: AttentionConfig, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """V2's per-head gate on the attention output (B, T, H * D): 2 *
    sigmoid(to_gate_logits(x)) in fp32, rounded to the output's dtype, then
    the product in that dtype."""
    gates = (2.0 * torch.sigmoid(linear(p.to_gate_logits, x).float())).to(out.dtype)
    b, t, width = out.shape
    return (out.reshape(b, t, cfg.local_heads, cfg.dim_head) * gates[..., None]).reshape(b, t, width)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dim_out: int, mult: int = 4, *, device=None, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        self.project_in = nn.Module()
        self.project_in.proj = Linear(dim, inner, device=device, dtype=dtype)
        self.project_out = Linear(inner, dim_out, device=device, dtype=dtype)


def feed_forward_apply(p: FeedForward, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
    """Linear -> gelu_tanh -> Linear; under `tp_axis` project_in is
    column-parallel and project_out row-parallel."""
    return linear_row_parallel(p.project_out, F.gelu(linear(p.project_in.proj, x), approximate="tanh"), tp_axis)
