"""Image decoding and resampling without PIL, for image conditioning and
video frames.

The JAX package loads conditioning images with PIL (ltx2_tpu/pipelines/
common.py `load_image_tensor`: `Image.open`, `convert("RGB")`, a LANCZOS
resize) and resizes video frames with PIL's BILINEAR (ltx2_tpu/utils/
video_io.py `_resize_frame`). The port reproduces those steps itself, so one
code path serves every machine, PIL or not:

- `read_png`: 8-bit PNGs of color type L (0), RGB (2) and RGBA (6),
  non-interlaced, every row filter (None, Sub, Up, Average, Paeth), as
  uint8 (H, W, 3): RGBA loses its alpha, L is repeated into three channels,
  as `convert("RGB")` does. Anything else (other formats, palette,
  grayscale with alpha, 16-bit and interlaced PNGs) raises a ValueError
  naming it. JPEGs go through `utils/jpeg.py` (`pipelines/common.py
  read_image` dispatches on the file's signature, `sniff`).
- `resize` (`resize_lanczos` for LANCZOS): PIL's 8-bit LANCZOS and
  BILINEAR resampling (`ImagingResample` in Resample.c) in integer
  arithmetic: the filter (the a = 3 windowed sinc, support 3; the
  triangle, support 1), its support widened by the scale when
  downscaling, per-output-pixel coefficients normalized to sum 1 and
  rounded to 22-bit fixed point, a horizontal pass into uint8 then a
  vertical one, each only when its size changes, each rounded (half added)
  and clipped. The coefficients are computed in Python floats (C doubles,
  the C library's sin) in PIL's order of operations, the passes as int64
  torch sums, so the output equals PIL's.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import List, Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel
_UNSUPPORTED_COLOR = {3: "palette (color type 3)", 4: "grayscale with alpha (color type 4)"}
PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients


def sniff(head: bytes) -> str:
    """The image format a file's first bytes name."""
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if head.startswith(b"BM"):
        return "BMP"
    if head.startswith(b"RIFF") and head[8:12] == b"WEBP":
        return "WebP"
    return "an unknown format"


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """The five PNG row filters undone. Pixel (y, x) depends on its left,
    upper and upper-left neighbours, so the anti-diagonals d = y + x are
    reconstructed in turn, each at once over every row's filter type. The
    pixels are kept skewed, skew[d, y + 1] = pixel (y, d - y), so that a
    diagonal's left, upper and upper-left neighbours are contiguous slices
    of the two diagonals before it; zeros stand for the pixels before the
    first row and column."""
    rows = raw.reshape(height, 1 + width * bpp)
    ftype = rows[:, 0].astype(np.int16)
    if (ftype > 4).any():
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not one of the five")
    ys, xs = np.mgrid[0:height, 0:width]
    diagonals = height + width - 1
    filt = np.zeros((diagonals, height + 1, bpp), np.int16)
    filt[ys + xs, ys + 1] = rows[:, 1:].reshape(height, width, bpp)
    # Per row, 1 where it uses filter k (Sub, Up, Average, Paeth), else 0.
    use = [np.broadcast_to((ftype == k).astype(np.int16)[:, None], (height, bpp)) for k in (1, 2, 3, 4)]
    paeth_rows = np.flatnonzero(ftype == 4)
    # skew[d + 1] holds diagonal d; skew[0] and skew[-1] (written last) are
    # the zero diagonals before the first.
    skew = np.zeros((diagonals + 1, height + 1, bpp), np.int16)
    for d in range(diagonals):
        lo, hi = max(0, d - width + 1), min(height, d + 1)
        a, b, c = skew[d, lo + 1:hi + 1], skew[d, lo:hi], skew[d - 1, lo:hi]
        pred = a * use[0][lo:hi] + b * use[1][lo:hi] + ((a + b) >> 1) * use[2][lo:hi]
        if paeth_rows.size and paeth_rows[0] < hi and paeth_rows[-1] >= lo:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred += np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)) * use[3][lo:hi]
        skew[d + 1, lo + 1:hi + 1] = (filt[d, lo + 1:hi + 1] + pred) & 255
    return skew[ys + xs + 1, ys + 1].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit L, RGB or RGBA PNG -> uint8 (H, W, 3), as PIL's
    `Image.open(path).convert("RGB")` gives it."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"Unsupported image format: {sniff(data[:16])} ({path}); read_png reads 8-bit PNG "
                         "(L, RGB, RGBA)")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, compression, filter_method, interlace = header
    if color in _UNSUPPORTED_COLOR or color not in _CHANNELS:
        raise ValueError(f"Unsupported image format: {_UNSUPPORTED_COLOR.get(color, f'color type {color}')} PNG "
                         f"({path}); supported: 8-bit L, RGB, RGBA")
    if depth != 8:
        raise ValueError(f"Unsupported image format: {depth}-bit PNG ({path}); supported: 8-bit L, RGB, RGBA")
    if interlace:
        raise ValueError(f"Unsupported image format: interlaced (Adam7) PNG ({path})")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown PNG compression {compression} or filter method {filter_method}")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, {height} rows of {width} x {bpp} need "
                         f"{height * (1 + width * bpp)}")
    pixels = _unfilter(raw, height, width, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _lanczos(x: float) -> float:
    """PIL's lanczos_filter: sinc(x) * sinc(x / 3) on [-3, 3)."""
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    if -3.0 <= x < 3.0:
        return sinc(x) * sinc(x / 3)
    return 0.0


def _bilinear(x: float) -> float:
    """PIL's bilinear_filter: the triangle 1 - |x| on (-1, 1)."""
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


# PIL's filters: (support, filter function).
LANCZOS = (3.0, _lanczos)
BILINEAR = (1.0, _bilinear)


def resample_coefficients(in_size: int, out_size: int, filt=LANCZOS) -> Tuple[List[int], torch.Tensor]:
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for the box (0,
    in_size) and `filt` (LANCZOS or BILINEAR): each output pixel's first
    input pixel, and its coefficients as (out_size, ksize) int64 in 22-bit
    fixed point (zero past the pixel's own count)."""
    filter_support, filter_fn = filt
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts, kk = [], np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filter_fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            kk[xx, x] = int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0 else int(0.5 + w * (1 << PRECISION_BITS))
        starts.append(xmin)
    return starts, torch.from_numpy(kk)


def _resample_axis(img: torch.Tensor, out_size: int, axis: int, filt=LANCZOS) -> torch.Tensor:
    """One 8-bit pass of PIL's resampler along `axis` (0 rows, 1 columns)
    of uint8 (H, W, C): int64 sums from half a unit, then clip8."""
    in_size = img.shape[axis]
    starts, kk = resample_coefficients(in_size, out_size, filt)
    idx = (torch.tensor(starts)[:, None] + torch.arange(kk.shape[1])[None]).clamp(max=in_size - 1)
    src = img.long().movedim(axis, 0)  # (in, other, C)
    acc = torch.full((out_size, *src.shape[1:]), 1 << (PRECISION_BITS - 1), dtype=torch.int64)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * kk[:, j, None, None]
    out = torch.where(acc >= (1 << PRECISION_BITS << 8), 255, torch.where(acc <= 0, 0, acc >> PRECISION_BITS))
    return out.to(torch.uint8).movedim(0, axis)


def resize(img: torch.Tensor, width: int, height: int, filt=LANCZOS) -> torch.Tensor:
    """uint8 (H, W, C) -> (height, width, C) as PIL's `Image.resize((width,
    height), filter)`: the horizontal pass, then the vertical one, each only
    when its size changes."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1, filt)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0, filt)
    return img


def resize_lanczos(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """PIL's `Image.Resampling.LANCZOS` resize (`resize`)."""
    return resize(img, width, height, LANCZOS)
