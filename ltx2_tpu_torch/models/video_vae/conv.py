"""3D convolution for the causal video VAE over channels-last tensors
(counterpart of ltx2_tpu/models/video_vae/conv.py).

Padding semantics are the VAE's: spatial 'reflect', then temporal replicate
padding, all k-1 frames in front when causal, else split around the clip.
The convolution itself is F.conv3d (cuDNN on the GPU), as the JAX package
leaves its conv to XLA. The (B, T, H, W, C) input is handed to F.conv3d as a
(B, C, T, H, W) view, which is the channels_last_3d layout cuDNN prefers.
Not ported yet: zero padding modes, strides and the W-sharded halo exchange.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv3d(nn.Module):
    """Parameter holder: weight (outC, inC, k, k, k), bias (outC,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, k, device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype), requires_grad=False)


def _reflect_pad(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    n = x.shape[dim]
    left = x.narrow(dim, 1, pad).flip(dim)
    right = x.narrow(dim, n - 1 - pad, pad).flip(dim)
    return torch.cat([left, x, right], dim=dim)


def _replicate_pad_t(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    parts = [x[:, :1].expand(-1, before, -1, -1, -1)] if before else []
    parts.append(x)
    if after:
        parts.append(x[:, -1:].expand(-1, after, -1, -1, -1))
    return torch.cat(parts, dim=1)


def conv3d_ndhwc(p: Conv3d, x: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """3D conv over (B, T, H, W, C) with the VAE's padding rules; stride 1,
    cubic kernel, 'same' output size."""
    k = p.weight.shape[2]
    pad = k // 2
    if pad > 0:
        x = _reflect_pad(_reflect_pad(x, 2, pad), 3, pad)
    t_pad = k - 1
    if t_pad > 0:
        before = t_pad if causal else t_pad // 2
        x = _replicate_pad_t(x, before, t_pad - before)
    w = p.weight.to(x.dtype)
    b = p.bias.to(x.dtype)
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b)
    return out.permute(0, 2, 3, 4, 1).contiguous()


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T, H, W, C), contiguous."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def from_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W) view."""
    return x.permute(0, 4, 1, 2, 3)
