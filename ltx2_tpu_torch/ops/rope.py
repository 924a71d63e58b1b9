"""Rotary position embeddings (counterpart of ltx2_tpu/ops/rope.py).

Two layouts: the LTX-2 DiT rotates the first half of each head against the
second half (SPLIT); the text connector rotates adjacent pairs over the
whole inner dim (INTERLEAVED). Frequencies come from a log-spaced grid
(float32, or float64 rounded to float32 as V2.3 checkpoints ask); positions
are fractions of max_pos scaled to [-1, 1]; rotation runs in fp32.

The connector's positions are raw token indices over max_pos (1,), so the
rotation angles reach 3.2e7, where one fp32 ulp is 2-4 radians: the angle
is built op by op in fp32 in the JAX package's order (fraction * 2, - 1,
* grid), never reassociated or contracted to an FMA (no torch.compile
here), or cos and sin change by O(1).
"""

from __future__ import annotations

import math
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import torch


class LTXRopeType(Enum):
    INTERLEAVED = "interleaved"
    SPLIT = "split"


def apply_rotary_emb(
    x: torch.Tensor, freqs_cis: Tuple[torch.Tensor, torch.Tensor], rope_type: LTXRopeType
) -> torch.Tensor:
    if rope_type == LTXRopeType.INTERLEAVED:
        return apply_interleaved_rotary_emb(x, *freqs_cis)
    if rope_type == LTXRopeType.SPLIT:
        return apply_split_rotary_emb(x, *freqs_cis)
    raise ValueError(f"invalid rope type {rope_type}")


def apply_interleaved_rotary_emb(
    x: torch.Tensor, cos_freqs: torch.Tensor, sin_freqs: torch.Tensor
) -> torch.Tensor:
    """Pair rotation: (x0, x1), (x2, x3), ... rotate together. x is (..., D),
    cos/sin broadcast against it. Rotation in fp32, x's dtype out."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xf * cos_freqs.float() + rotated * sin_freqs.float()).to(x.dtype)


def apply_split_rotary_emb(
    x: torch.Tensor, cos_freqs: torch.Tensor, sin_freqs: torch.Tensor
) -> torch.Tensor:
    """Half-rotation RoPE. x is token-major (B, T, H*D) or head-major
    (B, H, T, D); cos/sin are (B, H, T, D/2). Rotation in fp32, x's dtype out."""
    cos_f, sin_f = cos_freqs.float(), sin_freqs.float()
    if x.ndim == 4:
        xs = x.float().unflatten(-1, (2, -1))  # (B, H, T, 2, D/2)
        first, second = xs[..., 0, :], xs[..., 1, :]
        out = torch.stack([first * cos_f - second * sin_f, second * cos_f + first * sin_f], dim=-2)
        return out.flatten(-2).to(x.dtype)
    b, t, _ = x.shape
    h = cos_f.shape[1]
    # Work in (B, T, H, 2, D/2) so the token-major input needs no transpose.
    xs = x.float().view(b, t, h, 2, -1)
    first, second = xs[..., 0, :], xs[..., 1, :]
    cos_t, sin_t = cos_f.transpose(1, 2), sin_f.transpose(1, 2)  # (B, T, H, D/2)
    out = torch.stack([first * cos_t - second * sin_t, second * cos_t + first * sin_t], dim=-2)
    return out.reshape(b, t, -1).to(x.dtype)


def _freq_grid(theta: float, max_pos_count: int, inner_dim: int, use_double_precision: bool = False) -> np.ndarray:
    """Log-spaced frequency indices * pi/2, computed in float32 or float64,
    returned as float32 (rope.py:101-112)."""
    num = inner_dim // (2 * max_pos_count)
    dtype = np.float64 if use_double_precision else np.float32
    log_start = np.log(1.0) / np.log(theta)
    log_end = np.log(theta) / np.log(theta)
    pow_indices = np.power(theta, np.linspace(log_start, log_end, num, dtype=dtype))
    return (pow_indices * math.pi / 2).astype(np.float32)


def get_fractional_positions(indices_grid: torch.Tensor, max_pos: List[int]) -> torch.Tensor:
    """(B, n_dims, T) positions -> (B, T, n_dims) fractions of max_pos."""
    scale = torch.tensor(max_pos, dtype=torch.float32, device=indices_grid.device).view(1, -1, 1)
    return (indices_grid.float() / scale).transpose(1, 2)


def generate_freqs(
    indices: torch.Tensor,
    indices_grid: torch.Tensor,
    max_pos: List[int],
    use_middle_indices_grid: bool,
) -> torch.Tensor:
    """Positions -> per-token frequencies, flattened (B, T, n_freq*n_dims)."""
    if use_middle_indices_grid:
        if indices_grid.ndim != 4 or indices_grid.shape[-1] != 2:
            raise ValueError(f"middle-of-interval positions need (B, n, T, 2), got {tuple(indices_grid.shape)}")
        indices_grid = (indices_grid[..., 0] + indices_grid[..., 1]) / 2.0
    elif indices_grid.ndim == 4:
        indices_grid = indices_grid[..., 0]
    # Op by op in fp32, in the JAX package's order (see the module docstring).
    scaled = get_fractional_positions(indices_grid, max_pos) * 2 - 1  # (B, T, n_dims) in [-1, 1]
    freqs = indices.view(1, 1, 1, -1) * scaled[..., None]  # (B, T, n_dims, n_freq)
    return freqs.transpose(2, 3).reshape(freqs.shape[0], freqs.shape[1], -1)


def split_freqs_cis(
    freqs: torch.Tensor, pad_size: int, num_attention_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for SPLIT, identity padding at the FRONT, (B, H, T, D_head/2)."""
    cos_freq, sin_freq = torch.cos(freqs), torch.sin(freqs)
    if pad_size:
        b, t, _ = cos_freq.shape
        cos_freq = torch.cat([cos_freq.new_ones(b, t, pad_size), cos_freq], dim=-1)
        sin_freq = torch.cat([sin_freq.new_zeros(b, t, pad_size), sin_freq], dim=-1)
    b, t, _ = cos_freq.shape
    cos_freq = cos_freq.view(b, t, num_attention_heads, -1).transpose(1, 2).contiguous()
    sin_freq = sin_freq.view(b, t, num_attention_heads, -1).transpose(1, 2).contiguous()
    return cos_freq, sin_freq


def interleaved_freqs_cis(freqs: torch.Tensor, pad_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for INTERLEAVED: each frequency twice, identity padding at
    the FRONT, (B, T, dim)."""
    cos_freq = torch.cos(freqs).repeat_interleave(2, dim=-1)
    sin_freq = torch.sin(freqs).repeat_interleave(2, dim=-1)
    if pad_size:
        b, t, _ = cos_freq.shape
        cos_freq = torch.cat([cos_freq.new_ones(b, t, pad_size), cos_freq], dim=-1)
        sin_freq = torch.cat([sin_freq.new_zeros(b, t, pad_size), sin_freq], dim=-1)
    return cos_freq, sin_freq


def precompute_freqs_cis(
    indices_grid: torch.Tensor,
    dim: int,
    theta: float = 10000.0,
    max_pos: Optional[List[int]] = None,
    use_middle_indices_grid: bool = False,
    num_attention_heads: int = 32,
    rope_type: LTXRopeType = LTXRopeType.SPLIT,
    use_double_precision: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables (cos, sin), fp32: SPLIT (B, H, T, dim/H/2) or INTERLEAVED
    (B, T, dim). The default layout is SPLIT, the DiT's (the JAX package's
    default is INTERLEAVED)."""
    if max_pos is None:
        max_pos = [20, 2048, 2048]
    n_pos_dims = indices_grid.shape[1]
    grid = _freq_grid(float(theta), n_pos_dims, dim, use_double_precision)
    indices = torch.from_numpy(grid).to(indices_grid.device)
    freqs = generate_freqs(indices, indices_grid, max_pos, use_middle_indices_grid)
    if rope_type == LTXRopeType.SPLIT:
        return split_freqs_cis(freqs, dim // 2 - freqs.shape[-1], num_attention_heads)
    return interleaved_freqs_cis(freqs, dim % (2 * n_pos_dims))


def create_position_grid(batch_size: int, frames: int, height: int, width: int) -> torch.Tensor:
    """(B, 3, F*H*W) int32 integer position grid, frame-major (the training
    data's latent positions; ltx2_tpu/ops/rope.py:237-248)."""
    t_grid, h_grid, w_grid = np.meshgrid(np.arange(frames), np.arange(height), np.arange(width), indexing="ij")
    positions = np.stack([t_grid.ravel(), h_grid.ravel(), w_grid.ravel()], axis=0).astype(np.int32)
    return torch.from_numpy(positions)[None].expand(batch_size, -1, -1).contiguous()
