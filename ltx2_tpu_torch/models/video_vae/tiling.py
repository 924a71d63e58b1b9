"""Tiled VAE decoding for high-resolution or long videos, on one device
(counterpart of ltx2_tpu/models/video_vae/tiling.py).

Tiling configs with the JAX package's validation and defaults (512 px tiles
with 64 px overlap, 64-frame tiles with 24 frames of overlap), tile specs
over the latent grid, and the weighted blend of decoded tiles with per-axis
trapezoidal ramps. Each tile is sliced from the latent and decoded on its
own, so every conv pads by reflection at the tile's own edges, as in the JAX
package. The blend accumulates on the latent's device in fp32.

Two decodes over several ranks (ltx2_tpu/models/video_vae/tiling.py:202-236,
322-380): `decode_tiled(..., mesh=)` decodes same-shape tiles in rounds of
one tile a rank of the mesh's data axis and all-gathers each round's tiles,
so every rank blends them all (a short round's idle ranks decode its first
tile, whose copies are dropped); `decode_w_sharded` splits ONE decode's W
over the ranks, each conv exchanging 1-column halos (models/video_vae/
conv.py). Both return the whole video on every rank of the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


def compute_trapezoidal_mask_1d(length: int, ramp_left: int, ramp_right: int,
                                left_starts_from_0: bool = False) -> np.ndarray:
    """1D trapezoidal blending mask (float32)."""
    if length <= 0:
        raise ValueError("Mask length must be positive.")
    ramp_left = max(0, min(ramp_left, length))
    ramp_right = max(0, min(ramp_right, length))
    mask = np.ones((length,), np.float32)
    if ramp_left > 0:
        interval = ramp_left + 1 if left_starts_from_0 else ramp_left + 2
        fade_in = np.linspace(0.0, 1.0, interval, dtype=np.float32)[:-1]
        if not left_starts_from_0:
            fade_in = fade_in[1:]
        mask[:ramp_left] = fade_in
    if ramp_right > 0:
        mask[length - ramp_right:] = np.linspace(1.0, 0.0, ramp_right + 2, dtype=np.float32)[1:-1]
    return np.clip(mask, 0, 1)


@dataclass(frozen=True)
class SpatialTilingConfig:
    tile_size_in_pixels: int
    tile_overlap_in_pixels: int = 0

    def __post_init__(self) -> None:
        if self.tile_size_in_pixels < 64:
            raise ValueError(f"tile_size_in_pixels must be at least 64, got {self.tile_size_in_pixels}")
        if self.tile_size_in_pixels % 32 != 0:
            raise ValueError(f"tile_size_in_pixels must be divisible by 32, got {self.tile_size_in_pixels}")
        if self.tile_overlap_in_pixels % 32 != 0:
            raise ValueError(f"tile_overlap_in_pixels must be divisible by 32, got {self.tile_overlap_in_pixels}")
        if self.tile_overlap_in_pixels >= self.tile_size_in_pixels:
            raise ValueError(f"Overlap must be less than tile size, got {self.tile_overlap_in_pixels} and "
                             f"{self.tile_size_in_pixels}")


@dataclass(frozen=True)
class TemporalTilingConfig:
    tile_size_in_frames: int
    tile_overlap_in_frames: int = 0

    def __post_init__(self) -> None:
        if self.tile_size_in_frames < 16:
            raise ValueError(f"tile_size_in_frames must be at least 16, got {self.tile_size_in_frames}")
        if self.tile_size_in_frames % 8 != 0:
            raise ValueError(f"tile_size_in_frames must be divisible by 8, got {self.tile_size_in_frames}")
        if self.tile_overlap_in_frames % 8 != 0:
            raise ValueError(f"tile_overlap_in_frames must be divisible by 8, got {self.tile_overlap_in_frames}")
        if self.tile_overlap_in_frames >= self.tile_size_in_frames:
            raise ValueError(f"Overlap must be less than tile size, got {self.tile_overlap_in_frames} and "
                             f"{self.tile_size_in_frames}")


@dataclass(frozen=True)
class TilingConfig:
    spatial_config: Optional[SpatialTilingConfig] = None
    temporal_config: Optional[TemporalTilingConfig] = None

    @classmethod
    def default(cls) -> "TilingConfig":
        return cls(
            spatial_config=SpatialTilingConfig(tile_size_in_pixels=512, tile_overlap_in_pixels=64),
            temporal_config=TemporalTilingConfig(tile_size_in_frames=64, tile_overlap_in_frames=24),
        )


@dataclass
class TileSpec:
    in_t_start: int
    in_t_end: int
    in_h_start: int
    in_h_end: int
    in_w_start: int
    in_w_end: int
    out_t_start: int
    out_t_end: int
    out_h_start: int
    out_h_end: int
    out_w_start: int
    out_w_end: int
    ramp_t_left: int
    ramp_t_right: int
    ramp_h_left: int
    ramp_h_right: int
    ramp_w_left: int
    ramp_w_right: int


def _gen_tiles_1d(length: int, tile_size: int, overlap: int) -> List[Tuple[int, int, int, int]]:
    """(start, end, ramp_left, ramp_right) tiles covering [0, length)."""
    if length <= tile_size:
        return [(0, length, 0, 0)]
    tiles = []
    stride = tile_size - overlap
    pos = 0
    while pos < length:
        end = min(pos + tile_size, length)
        start = max(0, end - tile_size)
        tiles.append((start, end, overlap if start > 0 else 0, overlap if end < length else 0))
        if end >= length:
            break
        pos += stride
    return tiles


def generate_tile_specs(
    latent_shape: Tuple[int, int, int, int, int],
    tiling_config: TilingConfig,
    scale_factors: Tuple[int, int, int] = (8, 32, 32),
) -> List[TileSpec]:
    """Tile specs over the (B, C, T, H, W) latent grid."""
    _, _, t, h, w = latent_shape
    scale_t, scale_h, scale_w = scale_factors
    if tiling_config.spatial_config:
        sc = tiling_config.spatial_config
        tile_h, tile_w = sc.tile_size_in_pixels // scale_h, sc.tile_size_in_pixels // scale_w
        ov_h, ov_w = sc.tile_overlap_in_pixels // scale_h, sc.tile_overlap_in_pixels // scale_w
    else:
        tile_h, tile_w, ov_h, ov_w = h, w, 0, 0
    if tiling_config.temporal_config:
        tc = tiling_config.temporal_config
        tile_t, ov_t = tc.tile_size_in_frames // scale_t, tc.tile_overlap_in_frames // scale_t
    else:
        tile_t, ov_t = t, 0

    specs = []
    for ts, te, rtl, rtr in _gen_tiles_1d(t, tile_t, ov_t):
        for hs, he, rhl, rhr in _gen_tiles_1d(h, tile_h, ov_h):
            for ws, we, rwl, rwr in _gen_tiles_1d(w, tile_w, ov_w):
                specs.append(TileSpec(
                    in_t_start=ts, in_t_end=te, in_h_start=hs, in_h_end=he, in_w_start=ws, in_w_end=we,
                    out_t_start=ts * scale_t if ts > 0 else 0,
                    out_t_end=(te - 1) * scale_t + 1 if te > 1 else 1,
                    out_h_start=hs * scale_h, out_h_end=he * scale_h,
                    out_w_start=ws * scale_w, out_w_end=we * scale_w,
                    ramp_t_left=rtl * scale_t, ramp_t_right=rtr * scale_t,
                    ramp_h_left=rhl * scale_h, ramp_h_right=rhr * scale_h,
                    ramp_w_left=rwl * scale_w, ramp_w_right=rwr * scale_w,
                ))
    return specs


@torch.no_grad()
def decode_tiled(
    latent: torch.Tensor,
    decoder_fn: Callable[..., torch.Tensor],
    tiling_config: TilingConfig,
    timestep: Optional[float] = 0.05,
    scale_factors: Tuple[int, int, int] = (8, 32, 32),
    mesh=None,
    data_axis: str = "data",
) -> torch.Tensor:
    """Decode tile by tile and blend with trapezoidal weights.
    decoder_fn(latent_tile, timestep=...) -> (B, 3, t, h, w). Returns the
    blended (B, 3, T_out, H_out, W_out) fp32 video on the latent's device
    (the JAX package yields the same array once). With `mesh`, the tiles
    decode data-parallel over its `data_axis` (`_decode_tiles_data_parallel`)
    and every rank blends them in the JAX package's order."""
    b, _c, t, h, w = latent.shape
    scale_t, scale_h, scale_w = scale_factors
    dev = latent.device
    out_t, out_h, out_w = (t - 1) * scale_t + 1, h * scale_h, w * scale_w
    output = torch.zeros((b, 3, out_t, out_h, out_w), dtype=torch.float32, device=dev)
    weights = torch.zeros((1, 1, out_t, out_h, out_w), dtype=torch.float32, device=dev)

    def ramp(n, left, right, from_0=False):
        return torch.from_numpy(compute_trapezoidal_mask_1d(n, min(left, n), min(right, n), from_0)).to(dev)

    def tile_of(spec):
        return latent[:, :, spec.in_t_start:spec.in_t_end, spec.in_h_start:spec.in_h_end,
                      spec.in_w_start:spec.in_w_end]

    specs = generate_tile_specs(tuple(latent.shape), tiling_config, scale_factors)
    from ltx2_tpu_torch.parallel.mesh import axis_of

    axis = axis_of(mesh, data_axis)
    if axis is None:
        decoded_tiles = ((spec, decoder_fn(tile_of(spec), timestep=timestep)) for spec in specs)
    else:
        decoded_tiles = _decode_tiles_data_parallel(specs, tile_of, decoder_fn, timestep, axis)
    for spec, decoded in decoded_tiles:
        dt, dh, dw = decoded.shape[2:]
        tile_t = min(dt, spec.out_t_end - spec.out_t_start)
        tile_h = min(dh, spec.out_h_end - spec.out_h_start)
        tile_w = min(dw, spec.out_w_end - spec.out_w_start)
        mask = (ramp(tile_t, spec.ramp_t_left, spec.ramp_t_right, spec.out_t_start == 0)[:, None, None]
                * ramp(tile_h, spec.ramp_h_left, spec.ramp_h_right)[None, :, None]
                * ramp(tile_w, spec.ramp_w_left, spec.ramp_w_right)[None, None, :])
        sl = (slice(None), slice(None), slice(spec.out_t_start, spec.out_t_start + tile_t),
              slice(spec.out_h_start, spec.out_h_start + tile_h),
              slice(spec.out_w_start, spec.out_w_start + tile_w))
        output[sl] += decoded[:, :, :tile_t, :tile_h, :tile_w].float() * mask
        weights[sl] += mask
        del decoded
    return output / weights.clamp_min(1e-8)


def _decode_tiles_data_parallel(specs, tile_of, decoder_fn, timestep, axis):
    """(spec, decoded) for every tile, same-shape tiles decoded in rounds of
    one a rank of `axis` and all-gathered (the JAX package's grouping and
    order; a short round's extra ranks decode the round's first tile)."""
    from collections import defaultdict

    from ltx2_tpu_torch.parallel.collectives import all_gather

    groups = defaultdict(list)
    for spec in specs:
        groups[(spec.in_t_end - spec.in_t_start, spec.in_h_end - spec.in_h_start,
                spec.in_w_end - spec.in_w_start)].append(spec)
    for group in groups.values():
        for i in range(0, len(group), axis.size):
            round_specs = group[i:i + axis.size]
            mine = round_specs[axis.index] if axis.index < len(round_specs) else round_specs[0]
            decoded = decoder_fn(tile_of(mine), timestep=timestep).float()
            b = decoded.shape[0]
            gathered = all_gather(decoded, axis, dim=0)
            for j, spec in enumerate(round_specs):
                yield spec, gathered[j * b:(j + 1) * b]


@torch.no_grad()
def decode_w_sharded(
    latent: torch.Tensor,
    decoder,
    mesh,
    axis: str = "data",
    timestep: Optional[float] = 0.05,
    noise: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Decode ONE latent (B, C, T, H, W) with its W split over the mesh's
    `axis`: each rank decodes its W slab, every conv exchanging 1-column
    halos with its ring neighbours (correct down to 1-wide slabs), and the
    slabs are all-gathered along the pixel W. Returns the whole (B, 3, T',
    H', W') fp32 video on every rank. `noise`: the decode noise of the whole
    latent's shape (drawn whole by the caller, so every layout injects the
    same noise; the JAX package folds its key per shard instead); None
    injects none."""
    from ltx2_tpu_torch.models.video_vae.decoder import video_decoder_apply
    from ltx2_tpu_torch.parallel.collectives import all_gather

    if latent.ndim == 4:
        latent = latent[None]
    ax = mesh.axis(axis)
    n, w = ax.size, latent.shape[-1]
    if w % n != 0:
        raise ValueError(f"latent W ({w}) must be divisible by the '{axis}' axis size ({n})")
    part = w // n

    def slab(x):
        return x.narrow(-1, ax.index * part, part)

    video = video_decoder_apply(decoder, slab(latent), timestep=timestep,
                                noise=None if noise is None else slab(noise), causal=causal, w_halo_axis=ax)
    return all_gather(video, ax, dim=4)


def should_auto_tile(latent_shape: Tuple[int, ...], voxel_threshold: int = 4000) -> bool:
    """Tiling turns on above `voxel_threshold` latent voxels."""
    _, _, t, h, w = latent_shape
    return t * h * w > voxel_threshold
