"""The 1D embeddings connector (counterpart of
ltx2_tpu/models/text_encoder/connector.py), V1.

Learnable registers are tiled and appended to extend the sequence to at
least `min_sequence_length` tokens, and the attention mask is then cleared
so every token attends to every other; then blocks of RMSNorm ->
self-attention with INTERLEAVED RoPE over the token index -> residual,
RMSNorm -> feed-forward -> residual, and a final RMSNorm. The blocks are
the DiT's `Attention` and `FeedForward`. The connector runs in fp32, so its
attention takes `sdpa`'s plain route, as the JAX package takes its einsum
route below 2048 tokens. Not ported yet: V2's gated attention.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.core import rms_norm
from ltx2_tpu_torch.models.transformer.attention import (
    Attention, AttentionConfig, FeedForward, attention_apply, feed_forward_apply,
)
from ltx2_tpu_torch.ops.common import Linear, init_linear_
from ltx2_tpu_torch.ops.rope import LTXRopeType, precompute_freqs_cis


@dataclass(frozen=True)
class ConnectorConfig:
    attention_head_dim: int = 128
    num_attention_heads: int = 30
    num_layers: int = 2
    positional_embedding_theta: float = 10000.0
    positional_embedding_max_pos: Tuple[int, ...] = (1,)
    num_learnable_registers: Optional[int] = 128
    rope_type: LTXRopeType = LTXRopeType.INTERLEAVED
    norm_eps: float = 1e-6
    apply_gated_attention: bool = False
    double_precision_rope: bool = False
    min_sequence_length: int = 1024

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    def attention_config(self) -> AttentionConfig:
        return AttentionConfig(query_dim=self.inner_dim, heads=self.num_attention_heads,
                               dim_head=self.attention_head_dim, norm_eps=self.norm_eps, rope_type=self.rope_type)


class ConnectorBlock(nn.Module):
    def __init__(self, cfg: ConnectorConfig, *, device=None):
        super().__init__()
        self.attn1 = Attention(cfg.attention_config(), device=device)
        self.ff = FeedForward(cfg.inner_dim, cfg.inner_dim, device=device)


class Connector(nn.Module):
    """`transformer_1d_blocks` and the (registers, inner_dim)
    `learnable_registers`, fp32. Parameters start uninitialised (norms at
    one)."""

    def __init__(self, cfg: ConnectorConfig, *, device=None):
        super().__init__()
        if cfg.apply_gated_attention:
            raise NotImplementedError("the V2 connector's gated attention is not ported")
        self.cfg = cfg
        self.transformer_1d_blocks = nn.ModuleList(
            ConnectorBlock(cfg, device=device) for _ in range(cfg.num_layers))
        if cfg.num_learnable_registers:
            self.learnable_registers = nn.Parameter(
                torch.empty(cfg.num_learnable_registers, cfg.inner_dim, device=device), requires_grad=False)


@torch.no_grad()
def init_connector_(connector: Connector, generator: torch.Generator) -> Connector:
    """init_connector's distributions: every linear U(-1/sqrt(in),
    1/sqrt(in)), registers U(-1, 1); the q/k norms stay one."""
    for m in connector.modules():
        if isinstance(m, Linear):
            init_linear_(m, generator)
    if connector.cfg.num_learnable_registers:
        connector.learnable_registers.uniform_(-1.0, 1.0, generator=generator)
    return connector


def append_learnable_registers(registers: torch.Tensor, hidden_states: torch.Tensor,
                               attention_mask: Optional[torch.Tensor], min_sequence_length: int = 1024
                               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Extend (B, S, D) to max(min_sequence_length, S) tokens, rounded up to
    whole register tiles, with the tiled registers from position S on; the
    mask becomes all-attend zeros (1, 1, 1, S')."""
    batch, seq_len, hidden_dim = hidden_states.shape
    target_len = max(min_sequence_length, seq_len)
    tiled = registers.repeat(math.ceil(target_len / registers.shape[0]), 1)
    extra = tiled[seq_len:]
    if extra.shape[0] > 0:
        extra = extra[None].expand(batch, -1, hidden_dim).to(hidden_states.dtype)
        hidden_states = torch.cat([hidden_states, extra], dim=1)
    if attention_mask is not None:
        attention_mask = attention_mask.new_zeros(1, 1, 1, hidden_states.shape[1])
    return hidden_states, attention_mask


def connector_apply(connector: Connector, hidden_states: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) features and an additive key mask (B, 1, 1, S) -> (refined
    states, the mask they carry)."""
    cfg = connector.cfg
    if cfg.num_learnable_registers:
        hidden_states, attention_mask = append_learnable_registers(
            connector.learnable_registers, hidden_states, attention_mask, cfg.min_sequence_length)
    seq_len = hidden_states.shape[1]
    indices_grid = torch.arange(seq_len, dtype=torch.float32, device=hidden_states.device)[None, None, :]
    pe = precompute_freqs_cis(
        indices_grid, dim=cfg.inner_dim, theta=cfg.positional_embedding_theta,
        max_pos=list(cfg.positional_embedding_max_pos), num_attention_heads=cfg.num_attention_heads,
        rope_type=cfg.rope_type, use_double_precision=cfg.double_precision_rope,
    )
    attn_cfg = cfg.attention_config()
    x = hidden_states
    for block in connector.transformer_1d_blocks:
        x = x + attention_apply(block.attn1, attn_cfg, rms_norm(x, None, cfg.norm_eps), mask=attention_mask, pe=pe)
        x = x + feed_forward_apply(block.ff, rms_norm(x, None, cfg.norm_eps))
    x = rms_norm(x, None, cfg.norm_eps)
    if attention_mask is None:
        attention_mask = x.new_zeros(x.shape[0], 1, 1, x.shape[1])
    return x, attention_mask
