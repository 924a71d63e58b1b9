"""Timestep embeddings and AdaLN-single (counterpart of
ltx2_tpu/ops/timestep_embedding.py). Embedding math runs in fp32."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.ops.common import Linear, linear


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """DDPM sinusoidal embeddings of (N,) timesteps -> (N, embedding_dim)."""
    if timesteps.ndim != 1:
        raise ValueError("Timesteps should be a 1d-array")
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps[:, None].float() * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, embedding_dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Linear(256, embedding_dim, device=device, dtype=dtype)
        self.linear_2 = Linear(embedding_dim, embedding_dim, device=device, dtype=dtype)


class AdaLayerNormSingle(nn.Module):
    """Parameters of AdaLayerNormSingle: emb.timestep_embedder.{linear_1,
    linear_2} and linear (D -> num_embeddings * D). fp32, like the JAX init."""

    def __init__(self, embedding_dim: int, num_embeddings: int = 6, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.emb = nn.Module()
        self.emb.timestep_embedder = TimestepEmbedder(embedding_dim, device=device, dtype=dtype)
        self.linear = Linear(embedding_dim, num_embeddings * embedding_dim, device=device, dtype=dtype)


def timestep_embedding_apply(p: TimestepEmbedder, sample: torch.Tensor) -> torch.Tensor:
    """2-layer SiLU MLP over the sinusoidal embedding."""
    return linear(p.linear_2, F.silu(linear(p.linear_1, sample)))


def adaln_single_apply(p: AdaLayerNormSingle, timestep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (adaln_params (N, num_embeddings*D), embedded_timestep (N, D))."""
    proj = get_timestep_embedding(timestep, 256, flip_sin_to_cos=True, downscale_freq_shift=0.0)
    embedded_timestep = timestep_embedding_apply(p.emb.timestep_embedder, proj)
    return linear(p.linear, F.silu(embedded_timestep)), embedded_timestep
