"""Image decoding and resampling without PIL, for image conditioning and
video frames.

The JAX package loads conditioning images with PIL (ltx2_tpu/pipelines/
common.py `load_image_tensor`: `Image.open`, `convert("RGB")`, a LANCZOS
resize) and resizes video frames with PIL's BILINEAR (ltx2_tpu/utils/
video_io.py `_resize_frame`). The port reproduces those steps itself, so one
code path serves every machine, PIL or not:

- `decode_png` / `read_png`: every PNG Pillow opens (color types 0, 2, 3,
  4 and 6 at every bit depth PNG allows, Adam7-interlaced or not, every
  row filter), as uint8 (H, W, 3) equal to `convert("RGB")` from the mode
  Pillow gives the file (`PNG_MODES`: 1, L, I;16, RGB, P, LA, RGBA). A
  caller that takes only some modes passes them (`modes`, e.g.
  `STILL_MODES`, the JAX package's RGB, RGBA and L) and gets the JAX
  package's ValueError, "Unsupported image format: <mode>", before the
  pixels are decoded. The other stills go through `utils/jpeg.py` and
  `utils/still_io.py` (`pipelines/common.py read_image` dispatches on the
  file's signature, `sniff`).
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
- `read_apng` / `apng_info`: animated PNGs (`acTL`, `fcTL`, `fdAT`) as
  Pillow 12 composites their frames (its dispose and blend rules, the
  default image), over Pillow's canvas: L (gray at 1, 2, 4 and 8 bits),
  LA, RGB and RGBA (16-bit ones, and 16-bit gray with alpha, as their high
  bytes) and palettes at 1, 2, 4 and 8 bits; an Adam7 APNG's first frame
  (Pillow fails on its later ones, and so does the port, by name); 16-bit
  gray (mode I;16) and 16-bit RGB with a tRNS key raise a ValueError
  naming them.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, color type) -> (Pillow's mode, samples per pixel): PngImagePlugin's _MODES
PNG_MODES = {(1, 0): ("1", 1), (2, 0): ("L", 1), (4, 0): ("L", 1), (8, 0): ("L", 1), (16, 0): ("I;16", 1),
             (8, 2): ("RGB", 3), (16, 2): ("RGB", 3), (1, 3): ("P", 1), (2, 3): ("P", 1), (4, 3): ("P", 1),
             (8, 3): ("P", 1), (8, 4): ("LA", 2), (16, 4): ("RGBA", 2), (8, 6): ("RGBA", 4), (16, 6): ("RGBA", 4)}
# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# The modes the JAX package's load_image_tensor accepts (ltx2_tpu/pipelines/common.py:51).
STILL_MODES = ("RGB", "RGBA", "L")
PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients


def check_mode(mode: str, modes, what: str, name: str) -> None:
    """Refuse a still whose Pillow mode is not in `modes` (None takes
    every mode), in the JAX package's words."""
    if modes is not None and mode not in modes:
        raise ValueError(f"Unsupported image format: {mode}. Supported formats: {', '.join(modes)} ({what}, {name})")


def sniff(head: bytes) -> str:
    """The image format a file's first bytes name (TGA has no signature:
    `pipelines/common.read_image` tries it last)."""
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
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head[:4] in (b"II+\x00", b"MM\x00+"):
        return "BigTIFF"
    if len(head) >= 2 and head[:1] == b"P" and head[1] in b"0123456fy":  # PpmImagePlugin's _accept
        return "PPM"
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


def _png_pass(raw: np.ndarray, width: int, height: int, depth: int, samples: int) -> np.ndarray:
    """One image (or one Adam7 pass) of filtered rows -> its samples,
    (height, width, samples) uint8 (uint16 at 16 bits): the filters undone
    with bpp = max(1, depth * samples // 8), sub-byte rows unpacked MSB
    first and their padding dropped."""
    if depth >= 8:
        bpp = depth * samples // 8
        rows = _unfilter(raw, height, width, bpp)
        if depth == 16:
            pairs = rows.reshape(height, width, samples, 2).astype(np.uint16)
            return (pairs[..., 0] << 8) | pairs[..., 1]
        return rows
    row_bytes = -(-width * depth // 8)
    packed = _unfilter(raw, height, row_bytes, 1)[..., 0]
    bits = np.unpackbits(packed, axis=1).reshape(height, -1, depth)
    values = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)
    return values[:, :width, None]


def _png_samples(raw: bytes, width: int, height: int, depth: int, samples: int, interlace: int,
                name: str = "PNG") -> np.ndarray:
    """The inflated IDAT stream -> the image's samples (`_png_pass`), each
    of Adam7's seven passes (its own width, rows and filter state; empty
    passes hold no bytes) put at its pixels when `interlace` is 1."""
    data = np.frombuffer(raw, np.uint8)
    dtype = np.uint16 if depth == 16 else np.uint8
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    out = np.zeros((height, width, samples), dtype)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        size = h * (1 + -(-w * depth * samples // 8))
        if pos + size > data.size:
            raise ValueError(f"{name}: PNG data holds {data.size} bytes, its rows need more ({pos + size})")
        out[y0::dy, x0::dx] = _png_pass(data[pos:pos + size], w, h, depth, samples)
        pos += size
    return out


def _png_rgb(samples: np.ndarray, depth: int, color: int, palette: Optional[np.ndarray]) -> np.ndarray:
    """A PNG's samples -> uint8 (H, W, 3) as Pillow's `convert("RGB")`
    gives them from the mode it opens the file in (transparency, tRNS, is
    ignored): gray at 1, 2 and 4 bits scaled by 255, 85 and 17, 16-bit gray
    (mode I;16) clipped at 255, 16-bit colour and gray-with-alpha (RGB,
    RGBA) their high bytes, palette indices looked up (entries past the
    PLTE black), alpha dropped."""
    if color == 3:
        full = np.zeros((256, 3), np.uint8)
        if palette is not None:
            full[:min(len(palette), 256)] = palette[:256]
        return full[samples[..., 0]]
    if depth == 16:
        high = (np.minimum(samples, 255) if color == 0 else samples >> 8).astype(np.uint8)
        channels = high if color in (2, 6) else np.repeat(high[..., :1], 3, axis=2)
        return np.ascontiguousarray(channels[..., :3])
    if color in (0, 4):
        gray = samples[..., :1]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray, 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _png_header(data: bytes, name: str):
    """A PNG's IHDR fields, Pillow's mode, and its PLTE and IDAT chunks."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, color, compression, filter_method, interlace = header
    if (depth, color) not in PNG_MODES:
        raise ValueError(f"{name}: PNG of bit depth {depth} and color type {color} (Pillow knows no such mode)")
    if compression or filter_method or interlace > 1:
        raise ValueError(f"{name}: unknown PNG compression {compression}, filter method {filter_method} or "
                         f"interlace method {interlace}")
    return header, PNG_MODES[(depth, color)][0], palette, idat


def decode_png(data: bytes, name: str = "PNG", modes=None) -> np.ndarray:
    """A PNG's bytes -> uint8 (H, W, 3), as PIL's `Image.open(...)
    .convert("RGB")` gives it: every color type (0, 2, 3, 4, 6) at every
    bit depth PNG allows, Adam7 or not (`_png_samples`, `_png_rgb`). A mode
    outside `modes` (Pillow's: 1, L, I;16, RGB, P, LA, RGBA) is refused
    before the pixels are decoded."""
    header, mode, palette, idat = _png_header(data, name)
    width, height, depth, color, _, _, interlace = header
    check_mode(mode, modes, f"{depth}-bit PNG of color type {color}", name)
    samples = _png_samples(zlib.decompress(b"".join(idat)), width, height, depth, PNG_MODES[(depth, color)][1],
                          interlace, name)
    return _png_rgb(samples, depth, color, palette)


def read_png(path: str, modes=None) -> np.ndarray:
    """A PNG file -> uint8 (H, W, 3) (`decode_png`)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path, modes)


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


# ---- APNG ----------------------------------------------------------------------

# Pillow's mode -> the canvas it composites frames on (mode, samples a pixel):
# 1-bit gray is L at 0 and 255, 16-bit colour and gray-with-alpha its high bytes.
_APNG_CANVAS = {"1": ("L", 1), "L": ("L", 1), "P": ("P", 1), "LA": ("LA", 2), "RGB": ("RGB", 3), "RGBA": ("RGBA", 4)}
APNG_DISPOSE_NONE, APNG_DISPOSE_BACKGROUND, APNG_DISPOSE_PREVIOUS = 0, 1, 2
APNG_BLEND_SOURCE, APNG_BLEND_OVER = 0, 1


class _APNGFrame:
    def __init__(self, control: Optional[tuple]):
        # (x0, y0, x1, y1, delay ms, dispose_op, blend_op), None for the default image
        self.control = control
        self.data: List[bytes] = []


def _fctl(body: bytes, size: Tuple[int, int], path: str) -> tuple:
    _seq, w, h, x, y, num, den, dispose, blend = struct.unpack(">IIIIIHHBB", body[:26])
    if x + w > size[0] or y + h > size[1]:
        raise ValueError(f"{path}: APNG frame ({x}, {y}, {w}x{h}) reaches past the image")
    return x, y, x + w, y + h, float(num) / float(den or 100) * 1000, dispose, blend


def _apng_chunks(data: bytes, path: str):
    """The header, palette, transparency and animation control of an APNG,
    and its frames (the default image, when the IDAT is not the first
    frame, first), as Pillow reads them."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = palette = trns = None
    n_frames = None
    frames: List[_APNGFrame] = []
    pending: Optional[tuple] = None
    duration = 0.0
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"acTL" and not frames:
            n_frames = struct.unpack(">I", body[:4])[0]
        elif kind == b"fcTL":
            pending = _fctl(body, header[:2], path)
            if not frames:
                duration = pending[4]
        elif kind == b"IDAT":
            if not frames:  # the first frame, or the default image when no fcTL came first
                frames.append(_APNGFrame(pending))
                pending = None
            frames[0].data.append(body)
        elif kind == b"fdAT" and frames:
            if pending is not None:
                frames.append(_APNGFrame(pending))
                pending = None
            frames[-1].data.append(body[4:])
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    if n_frames is None or n_frames == 0:
        raise ValueError(f"{path}: not an animated PNG (no acTL before the image data)")
    count = n_frames + (1 if frames and frames[0].control is None else 0)
    return header, palette, trns, frames[:count], count, duration


def _apng_pixels(frame: _APNGFrame, header, width: int, height: int, path: str) -> np.ndarray:
    """One frame's image data (Adam7 or not) -> its pixels in the canvas
    mode: (h, w) indices or grey, else (h, w, samples)."""
    _, _, depth, color, _, _, interlace = header
    samples = _png_samples(zlib.decompress(b"".join(frame.data)), width, height, depth, PNG_MODES[(depth, color)][1],
                           interlace, path)
    if color == 3:
        return samples[..., 0]
    if color == 0:
        return _png_rgb(samples, depth, color, None)[..., 0]
    if depth == 16:
        high = (samples >> 8).astype(np.uint8)
        return np.concatenate([np.repeat(high[..., :1], 3, axis=2), high[..., 1:]], axis=2) if color == 4 else high
    return samples


def _div255(v: np.ndarray) -> np.ndarray:
    """Pillow's DIV255: (v + 128 + ((v + 128) >> 8)) >> 8."""
    tmp = v + 128
    return ((tmp >> 8) + tmp) >> 8


def _apng_alpha(updated: np.ndarray, mode: str, trns: Optional[bytes]) -> np.ndarray:
    """The mask Pillow pastes an OVER frame with: its alpha (RGBA, LA), the
    tRNS colour as 0 (RGB), the palette's tRNS alphas (P), else 255."""
    if mode == "RGBA":
        return updated[..., 3].astype(np.int64)
    if mode == "LA":
        return updated[..., 1].astype(np.int64)
    full = np.full(updated.shape[:2], 255, np.int64)
    if mode == "RGB" and trns is not None and len(trns) >= 6:
        key = struct.unpack(">HHH", trns[:6])
        return np.where((updated == np.array(key)).all(-1), 0, full)
    if mode == "P" and trns is not None:
        alphas = np.full(256, 255, np.int64)
        alphas[:min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
        return alphas[updated]
    return full


def _apng_rgb(canvas: np.ndarray, mode: str, palette: Optional[np.ndarray]) -> np.ndarray:
    """The canvas as `convert("RGB")` gives it."""
    if mode == "P":
        full = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        if palette is not None:
            full[:len(palette)] = palette[:256]
        return full[canvas]
    if mode == "L":
        return np.repeat(canvas[..., None], 3, axis=2)
    if mode == "LA":
        return np.repeat(canvas[..., :1], 3, axis=2)
    return np.array(canvas[..., :3])


def apng_info(path: str) -> Tuple[int, int, int, float]:
    """(width, height, frames, the first frame's delay in ms or 0), as
    PIL's `size`, `n_frames` and `info["duration"]` give them."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, _, _, _, count, duration = _apng_chunks(data, path)
    return header[0], header[1], count, duration


def read_apng(path: str, max_frames: Optional[int] = None) -> List[np.ndarray]:
    """An animated PNG's frames as uint8 (H, W, 3), as Pillow 12's
    `ImageSequence.Iterator` and `convert("RGB")` give them: each frame
    decoded into the canvas (in the image's own mode: L, LA, RGB, RGBA or
    palette) over its rectangle; blend_op OVER pastes it onto the canvas
    as it was before, each channel (palette indices too) lerped by the
    frame's alpha with Pillow's DIV255 rounding; dispose_op 1 clears the
    rectangle to zeros and 2 restores it before the next frame (2 on the
    first frame acts as 1). A default image (IDAT outside the animation)
    comes first and is the canvas of frame 1."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, palette, trns, frames, count, _ = _apng_chunks(data, path)
    width, height, depth, color = header[:4]
    if (depth, color) not in PNG_MODES:
        raise ValueError(f"{path}: PNG of bit depth {depth} and color type {color} (Pillow knows no such mode)")
    pil_mode = PNG_MODES[(depth, color)][0]
    if pil_mode not in _APNG_CANVAS or (depth == 16 and color == 2 and trns is not None):
        raise ValueError(f"Unsupported image format: {depth}-bit APNG of color type {color} (mode {pil_mode}"
                         f"{', with tRNS' if trns is not None else ''}; not ported) ({path})")
    mode, samples = _APNG_CANVAS[pil_mode]
    if header[6] and min(count, max_frames or count) > 1:
        raise ValueError(f"{path}: an interlaced (Adam7) APNG past its first frame (Pillow fails on its later "
                         "frames; not ported)")
    shape = (height, width) if samples == 1 else (height, width, samples)
    canvas = np.zeros(shape, np.uint8)
    prev: Optional[np.ndarray] = None
    dispose: Optional[np.ndarray] = None
    extent = None
    out: List[np.ndarray] = []
    for k, frame in enumerate(frames[:max_frames] if max_frames else frames):
        if k > 0:
            if dispose is not None:
                x0, y0, x1, y1 = extent
                canvas[y0:y1, x0:x1] = dispose
            prev = canvas.copy()
        ctl = frame.control
        dispose_op = ctl[5] if ctl else None
        blend_op = ctl[6] if ctl else None
        if ctl:
            extent = ctl[:4]
        if prev is None and dispose_op == APNG_DISPOSE_PREVIOUS:
            dispose_op = APNG_DISPOSE_BACKGROUND
        dispose = None
        if dispose_op == APNG_DISPOSE_PREVIOUS:
            dispose = prev[extent[1]:extent[3], extent[0]:extent[2]].copy()
        elif dispose_op == APNG_DISPOSE_BACKGROUND:
            dispose = np.zeros_like(canvas[extent[1]:extent[3], extent[0]:extent[2]])
        x0, y0, x1, y1 = ctl[:4] if ctl else (0, 0, width, height)
        canvas[y0:y1, x0:x1] = _apng_pixels(frame, header, x1 - x0, y1 - y0, path)
        if prev is not None and blend_op == APNG_BLEND_OVER:
            ex0, ey0, ex1, ey1 = extent
            updated = canvas[ey0:ey1, ex0:ex1]
            a = _apng_alpha(updated, mode, trns)
            if updated.ndim == 3:
                a = a[..., None]
            below = prev[ey0:ey1, ex0:ex1].astype(np.int64)
            prev[ey0:ey1, ex0:ex1] = _div255(below * (255 - a) + updated.astype(np.int64) * a)
            canvas = prev
        out.append(_apng_rgb(canvas, mode, palette))
    if not out:
        raise ValueError(f"{path}: no frame in the APNG")
    return out
