"""3D rotary position embeddings, SPLIT layout (counterpart of
ltx2_tpu/ops/rope.py).

The LTX-2 DiT rotates the first half of each head against the second half
(SPLIT). Frequencies come from a float32 log-spaced grid; positions are
fractional midpoints scaled to [-1, 1]; rotation runs in fp32. Not ported
yet: the INTERLEAVED layout and the float64 grid of V2.3.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch


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


def _freq_grid(theta: float, max_pos_count: int, inner_dim: int) -> np.ndarray:
    """Log-spaced frequency indices * pi/2, float32 (rope.py:100-112)."""
    num = inner_dim // (2 * max_pos_count)
    log_start = np.log(1.0) / np.log(theta)
    log_end = np.log(theta) / np.log(theta)
    pow_indices = np.power(theta, np.linspace(log_start, log_end, num, dtype=np.float32))
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


def precompute_freqs_cis(
    indices_grid: torch.Tensor,
    dim: int,
    theta: float = 10000.0,
    max_pos: Optional[List[int]] = None,
    use_middle_indices_grid: bool = False,
    num_attention_heads: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SPLIT RoPE tables (cos, sin), each (B, H, T, dim/H/2) fp32."""
    if max_pos is None:
        max_pos = [20, 2048, 2048]
    n_pos_dims = indices_grid.shape[1]
    indices = torch.from_numpy(_freq_grid(float(theta), n_pos_dims, dim)).to(indices_grid.device)
    freqs = generate_freqs(indices, indices_grid, max_pos, use_middle_indices_grid)
    return split_freqs_cis(freqs, dim // 2 - freqs.shape[-1], num_attention_heads)


def create_position_grid(batch_size: int, frames: int, height: int, width: int) -> torch.Tensor:
    """(B, 3, F*H*W) int32 integer position grid, frame-major (the training
    data's latent positions; ltx2_tpu/ops/rope.py:237-248)."""
    t_grid, h_grid, w_grid = np.meshgrid(np.arange(frames), np.arange(height), np.arange(width), indexing="ij")
    positions = np.stack([t_grid.ravel(), h_grid.ravel(), w_grid.ravel()], axis=0).astype(np.int32)
    return torch.from_numpy(positions)[None].expand(batch_size, -1, -1).contiguous()
