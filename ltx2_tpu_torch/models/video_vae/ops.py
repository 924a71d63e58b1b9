"""Video VAE tensor ops (counterpart of ltx2_tpu/models/video_vae/ops.py):
pixel patchify and un-patchify, the per-frame pixel shuffle and unshuffle,
pixel norm, and the per-channel latent (un-)normalization.

The channel packing order (c, p, r_w, r_h) of the 5D patchify and
un-patchify matches the checkpoint's einops pattern and is parity-critical."""

from __future__ import annotations

import torch

from ltx2_tpu_torch.ops import common


def patchify(x: torch.Tensor, patch_size_hw: int, patch_size_t: int = 1) -> torch.Tensor:
    """Space-to-depth on (B, C, F, H, W) -> (B, C*p*r*r, F/p, H/r, W/r),
    channels packed (c, p, r_w, r_h)."""
    if patch_size_hw == 1 and patch_size_t == 1:
        return x
    if x.ndim != 5:
        raise ValueError(f"patchify: expected (B, C, F, H, W), got {tuple(x.shape)}")
    b, c, f, h, w = x.shape
    p, r = patch_size_t, patch_size_hw
    x = x.reshape(b, c, f // p, p, h // r, r, w // r, r).permute(0, 1, 3, 7, 5, 2, 4, 6)
    return x.reshape(b, c * p * r * r, f // p, h // r, w // r)


def unpatchify(x: torch.Tensor, patch_size_hw: int, patch_size_t: int = 1) -> torch.Tensor:
    """Depth-to-space on (B, C*p*r*r, F, H, W) -> (B, C, F*p, H*r, W*r)."""
    if patch_size_hw == 1 and patch_size_t == 1:
        return x
    b, c_packed, f, h, w = x.shape
    p, r = patch_size_t, patch_size_hw
    c = c_packed // (p * r * r)
    x = x.reshape(b, c, p, r, r, f, h, w).permute(0, 1, 5, 2, 6, 4, 7, 3)
    return x.reshape(b, c, f * p, h * r, w * r)


def pixel_shuffle_3d(x: torch.Tensor, upscale_factor: int) -> torch.Tensor:
    """(B, C*r^2, F, H, W) -> (B, C, F, H*r, W*r), channels packed (c, r_h, r_w)."""
    r = upscale_factor
    b, c_packed, f, h, w = x.shape
    x = x.reshape(b, c_packed // (r * r), r, r, f, h, w).permute(0, 1, 4, 5, 2, 6, 3)
    return x.reshape(b, c_packed // (r * r), f, h * r, w * r)


def pixel_unshuffle_3d(x: torch.Tensor, downscale_factor: int) -> torch.Tensor:
    """(B, C, F, H, W) -> (B, C*r^2, F, H/r, W/r), the inverse of `pixel_shuffle_3d`."""
    r = downscale_factor
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f, h // r, r, w // r, r).permute(0, 1, 4, 6, 2, 3, 5)
    return x.reshape(b, c * r * r, f, h // r, w // r)


def pixel_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm across the (channels-last) channel axis, fp32 math."""
    return common.pixel_norm(x, dim, eps)


def normalize_latent(x: torch.Tensor, stats) -> torch.Tensor:
    """(x - mean_of_means) / std_of_means over the channels of a
    (B, C, F, H, W) latent; `stats` holds the two (C,) vectors (the
    decoder's `per_channel_statistics`). fp32 statistics promote x."""
    return (x - stats.mean_of_means.view(1, -1, 1, 1, 1)) / stats.std_of_means.view(1, -1, 1, 1, 1)


def un_normalize_latent(x: torch.Tensor, stats) -> torch.Tensor:
    """The inverse: x * std_of_means + mean_of_means."""
    return x * stats.std_of_means.view(1, -1, 1, 1, 1) + stats.mean_of_means.view(1, -1, 1, 1, 1)
