"""GIF in and out without PIL.

`decode_gif` gives the frames that the JAX package's reader takes from PIL
(ltx2_tpu/utils/video_io.py `read_pil_animation`: `ImageSequence.Iterator`
and `frame.convert("RGB")` under Pillow's default loading strategy,
RGB_AFTER_FIRST), bit for bit:
- LZW with variable code sizes and clear / end codes, read code by code
  (a full table stops growing, as Pillow's decoder does; an image whose
  data ends before its last pixel raises, as Pillow does);
- the global and local colour tables (a table that is the identity grey
  ramp makes the frame grey, mode "L"), interlaced images, frames that
  cover a sub-rectangle of the logical screen;
- frame 0 is a palette image on a canvas filled with its transparent index
  (else index 0); it becomes RGB when frame 1 is read, and every later
  frame's rectangle is looked up in its own palette and pasted onto the RGB
  canvas, its transparent pixels left out;
- the disposal method, sticky across frames as Pillow keeps it (a frame
  without one keeps the last): 2 fills the rectangle with the transparent
  colour, else the background colour, in the current frame's palette; 3
  puts back the rectangle as it was before the frame (on frame 0 the
  transparent index, when there is one). A disposal is applied when the
  next frame is read, before frame 1's conversion to RGB.
`gif_info` reads the size, the frame count and the first frame's delay
(PIL's `n_frames` and `info["duration"]`) without decoding a pixel.

`write_gif` writes the no-ffmpeg preview beside an MJPEG file. The JAX CLI
gets that file from PIL's `save_all`, which quantizes each frame to its own
median-cut palette, writes only the rectangle that changed and
LZW-compresses it. The port also gives each frame a palette of its own
(`quantize_frame`: a weighted k-means over the frame's 5-bit colour
histogram, seeded at even quantiles of the pixels along a Z curve), but
writes every frame whole in literal-only LZW codes of 9 bits, a clear code
every 254 of them, so the encoder is array code throughout. Any GIF reader
decodes it; its frames differ from PIL's file (another palette) and the
file is larger (PERF.md gives the sizes and errors).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

_INTERLACE_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def _sub_blocks(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The data sub-blocks from `pos` to their zero terminator, joined."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        parts.append(data[pos:pos + n])
        pos += n
    return b"".join(parts), pos


def _skip_sub_blocks(data: bytes, pos: int) -> int:
    while pos < len(data):
        n = data[pos]
        pos += 1 + n
        if n == 0:
            break
    return pos


def _palette_or_grey(raw: bytes):
    """A colour table as (N, 3) uint8, or False when it is the identity
    grey ramp (Pillow's `_is_palette_needed` is then false)."""
    table = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    if (table == np.arange(len(table))[:, None]).all():
        return False
    return table


def lzw_decode(data: bytes, min_size: int, count: int) -> np.ndarray:
    """GIF LZW codes (least significant bit first) -> `count` indices. An
    image whose data runs out, or whose end code (or a code past the next
    free entry) comes, before its last pixel raises, as Pillow raises
    ("broken data stream", "image file is truncated")."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    table: List[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, nxt = min_size + 1, clear + 2
    out: List[bytes] = []
    produced = 0
    prev: Optional[bytes] = None
    acc = nbits = 0
    pos, n = 0, len(data)
    while produced < count:
        while nbits < size and pos < n:
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            del table[clear + 2:]
            size, nxt, prev = min_size + 1, clear + 2, None
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                break
            entry = table[code]
        elif code < nxt:
            entry = table[code]
            if nxt < 4096:
                table.append(prev + entry[:1])
                nxt += 1
        elif code == nxt and nxt < 4096:
            entry = prev + prev[:1]
            table.append(entry)
            nxt += 1
        else:
            break
        if nxt == (1 << size) and size < 12:
            size += 1
        out.append(entry)
        produced += len(entry)
        prev = entry
    if produced < count:
        raise ValueError(f"GIF: image file is truncated ({produced} of {count} pixels decoded)")
    return np.frombuffer(b"".join(out), np.uint8)[:count]


def _rows_in_order(height: int, interlace: bool) -> np.ndarray:
    """The image rows in the order the data stores them."""
    if not interlace:
        return np.arange(height)
    return np.concatenate([np.arange(start, height, step) for start, step in _INTERLACE_PASSES])


def _image(indices: np.ndarray, height: int, width: int, interlace: bool) -> np.ndarray:
    """A frame's decoded indices as its (height, width) rectangle, the rows
    put back in order when the image is interlaced."""
    image = np.empty((height, width), np.uint8)
    image[_rows_in_order(height, interlace)] = indices.reshape(height, width)
    return image


def _lookup(palette, indices: np.ndarray) -> np.ndarray:
    """Indices -> RGB through a colour table, as Pillow's P -> RGB
    conversion reads its 256-entry palette (entries past the table keep
    the grey ramp a new palette starts with); grey when there is none."""
    if palette is False or palette is None:
        return np.repeat(indices[..., None], 3, axis=-1)
    full = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    full[:len(palette)] = palette[:256]
    return full[indices]


class _Frame:
    def __init__(self):
        self.transparency: Optional[int] = None
        self.duration: Optional[int] = None
        self.disposal = 0
        self.extent = (0, 0, 0, 0)
        self.interlace = False
        self.palette = None  # None: none; False: a grey identity table; else (N, 3)
        self.min_size = 8
        self.data = b""


def _parse(data: bytes, name: str, decode: bool = True):
    """The logical screen, the global table, the background index and each
    frame's control block, rectangle, table and LZW data."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{name}: not a GIF file")
    width, height, flags, background = struct.unpack_from("<HHBB", data, 6)
    pos = 13
    global_palette = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_palette = _palette_or_grey(data[pos:pos + n]) if decode else None
        pos += n
    else:
        background = None
    frames: List[_Frame] = []
    frame = _Frame()
    while pos < len(data):
        kind = data[pos]
        pos += 1
        if kind == 0x3B:  # trailer
            break
        if kind == 0x21:  # extension
            label = data[pos]
            pos += 1
            if label == 0xF9 and pos < len(data) and data[pos] >= 4:
                block = data[pos + 1:pos + 1 + data[pos]]
                if block[0] & 1:
                    frame.transparency = block[3]
                frame.duration = struct.unpack_from("<H", block, 1)[0] * 10
                frame.disposal = (block[0] >> 2) & 7
            pos = _skip_sub_blocks(data, pos)
        elif kind == 0x2C:  # image descriptor
            x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            frame.extent = (x0, y0, x0 + w, y0 + h)
            frame.interlace = bool(iflags & 64)
            if iflags & 128:
                n = 3 << ((iflags & 7) + 1)
                frame.palette = _palette_or_grey(data[pos:pos + n]) if decode else None
                pos += n
            frame.min_size = data[pos] if pos < len(data) else 8
            pos += 1
            if decode:
                frame.data, pos = _sub_blocks(data, pos)
            else:
                pos = _skip_sub_blocks(data, pos)
            frames.append(frame)
            frame = _Frame()
        else:
            break  # not a block Pillow reads: the file ends here
    return (width, height), global_palette, background, frames


def gif_info(data: bytes, name: str = "GIF") -> Tuple[int, int, int, int]:
    """(width, height, frames, the first frame's duration in ms or 0), as
    PIL's `size`, `n_frames` and `info.get("duration", 0)` give them."""
    (width, height), _, _, frames = _parse(data, name, decode=False)
    if not frames:
        raise ValueError(f"{name}: no image in the GIF")
    return width, height, len(frames), frames[0].duration or 0


def decode_gif(data: bytes, name: str = "GIF", max_frames: Optional[int] = None) -> List[np.ndarray]:
    """Every frame (or the first `max_frames`) as uint8 (H, W, 3) RGB, as
    Pillow 12 composites them (see the module's docstring)."""
    (width, height), global_palette, background, frames = _parse(data, name)
    if not frames:
        raise ValueError(f"{name}: no image in the GIF")
    out: List[np.ndarray] = []
    mode = "P"
    canvas: np.ndarray = np.zeros((height, width), np.uint8)
    canvas_palette = None
    info_transparency: Optional[int] = None
    disposal_method = 0
    dispose: Optional[np.ndarray] = None
    dispose_extent = None
    for f, fr in enumerate(frames[:max_frames] if max_frames else frames):
        x0, y0, x1, y1 = fr.extent
        if x1 > width or y1 > height:
            raise ValueError(f"{name}: frame {f} reaches past the logical screen ({x1}x{y1} > {width}x{height}); "
                             "the port does not grow the canvas as Pillow does")
        if fr.disposal:
            disposal_method = fr.disposal
        if dispose is not None:
            dx0, dy0, dx1, dy1 = dispose_extent
            canvas[dy0:dy1, dx0:dx1] = dispose
        frame_palette = fr.palette if fr.palette is not None else global_palette
        if f == 0:
            mode = "P" if frame_palette is not False and frame_palette is not None else "L"
            canvas_palette = fr.palette if (fr.palette is not None and fr.palette is not False) else global_palette
        elif mode == "P":
            canvas = _lookup(canvas_palette, canvas)
            mode, info_transparency = "RGB", None

        def rgb(color: int) -> np.ndarray:
            if frame_palette is not None and frame_palette is not False:
                if color * 3 + 3 > 3 * len(frame_palette):
                    color = 0
                return frame_palette[color]
            return np.array([color] * 3, np.uint8)

        dispose, dispose_extent = None, fr.extent
        dw, dh = x1 - x0, y1 - y0
        if disposal_method == 2:
            color = info_transparency if info_transparency is not None else fr.transparency
            if color is None:
                color = background or 0
            dispose = np.broadcast_to(rgb(color), (dh, dw, 3)) if mode == "RGB" else np.full((dh, dw), color, np.uint8)
        elif disposal_method >= 3:
            if f > 0:
                dispose = canvas[y0:y1, x0:x1].copy()
            elif fr.transparency is not None:
                dispose = np.full((dh, dw), fr.transparency, np.uint8)
        if f == 0 and fr.transparency is not None:
            info_transparency = fr.transparency

        image = _image(lzw_decode(fr.data, fr.min_size, dw * dh), dh, dw, fr.interlace)
        region = canvas[y0:y1, x0:x1]
        keep = image == fr.transparency if fr.transparency is not None else np.zeros(image.shape, bool)
        if f == 0:
            if fr.transparency is not None:
                canvas[:] = fr.transparency
            region[:] = image
            out.append(_lookup(canvas_palette if mode == "P" else None, canvas))
        elif mode == "RGB":
            has_palette = frame_palette is not None and frame_palette is not False
            region[:] = np.where(keep[..., None], region, _lookup(frame_palette if has_palette else None, image))
            out.append(canvas.copy())
        else:  # a grey ("L") GIF: indices straight onto the canvas, transparent ones left out
            region[:] = np.where(keep, region, image)
            out.append(_lookup(None, canvas))
    return out


# ---- writing -------------------------------------------------------------------


def _histogram(frame: np.ndarray):
    """A frame's 5-bit-per-channel histogram: each pixel's bin, and the
    occupied bins with their pixel counts and mean colours."""
    px = frame.reshape(-1, 3)
    bins = ((px[:, 0].astype(np.int32) >> 3) << 10) | ((px[:, 1] >> 3).astype(np.int32) << 5) | (px[:, 2] >> 3)
    counts = np.bincount(bins, minlength=1 << 15)
    occupied = np.flatnonzero(counts)
    weight = counts[occupied].astype(np.float64)
    means = np.stack([np.bincount(bins, px[:, c], minlength=1 << 15)[occupied] for c in range(3)], axis=1)
    return bins, occupied, weight, means / weight[:, None]


def _morton(occupied: np.ndarray) -> np.ndarray:
    """5-bit (r, g, b) bin numbers -> their order along a Z curve (the bits
    of the three channels interleaved), so bins near in colour sit near in
    the order."""
    key = np.zeros_like(occupied)
    for bit in range(5):
        for c, shift in enumerate((10, 5, 0)):
            key |= ((occupied >> (shift + bit)) & 1) << (3 * bit + 2 - c)
    return key


PALETTE_COLORS = 256  # a local colour table of 8-bit indices
KMEANS_ITERATIONS = 4


def _seed(occupied: np.ndarray, weight: np.ndarray, means: np.ndarray) -> np.ndarray:
    """Seeds spread by the pixels: the bins at `PALETTE_COLORS` evenly
    spaced quantiles of the cumulative pixel count, along the Z curve."""
    order = np.argsort(_morton(occupied), kind="stable")
    cum = np.cumsum(weight[order])
    picks = np.searchsorted(cum, (np.arange(PALETTE_COLORS) + 0.5) * (cum[-1] / PALETTE_COLORS))
    return means[order[np.minimum(picks, order.size - 1)]].copy()


def quantize_frame(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One frame -> (palette (256, 3) uint8, indices (H, W) uint8): a
    weighted k-means (`KMEANS_ITERATIONS` rounds) over the frame's 5-bit
    histogram bins (each at the mean of its pixels) from `_seed`; every
    pixel takes its bin's nearest palette colour. A frame of no more
    occupied bins than colours gets its bins' means."""
    bins, occupied, weight, means = _histogram(frame)
    lut = np.zeros(1 << 15, np.uint8)
    if occupied.size <= PALETTE_COLORS:
        palette = np.zeros((PALETTE_COLORS, 3))
        palette[:occupied.size] = means
        lut[occupied] = np.arange(occupied.size)
        return np.clip(np.round(palette), 0, 255).astype(np.uint8), lut[bins].reshape(frame.shape[:2])
    palette = _seed(occupied, weight, means)
    for _ in range(KMEANS_ITERATIONS):
        nearest = _nearest(means, palette)
        total = np.bincount(nearest, weight, minlength=PALETTE_COLORS)
        used = total > 0
        for c in range(3):
            palette[used, c] = np.bincount(nearest, weight * means[:, c], minlength=PALETTE_COLORS)[used] / total[used]
    palette = np.clip(np.round(palette), 0, 255)
    lut[occupied] = _nearest(means, palette)
    return palette.astype(np.uint8), lut[bins].reshape(frame.shape[:2])


def _nearest(points: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """The index of the nearest palette colour to each point (Euclidean,
    through a k-d tree over the palette)."""
    from scipy.spatial import cKDTree

    return cKDTree(palette).query(points)[1]


LITERALS_PER_CLEAR = 254  # 9-bit codes: the table reaches 511 entries, never 512


def lzw_literals(indices: np.ndarray) -> bytes:
    """8-bit indices as GIF LZW data of minimum code size 8 that uses no
    table entry: a clear code, then up to 254 literal codes, again and
    again, then the end code, every code 9 bits, least significant bit
    first (each 8 codes fill 9 bytes), in sub-blocks of 255 bytes."""
    idx = np.asarray(indices, np.uint32).ravel()
    n = idx.size
    groups = -(-n // LITERALS_PER_CLEAR) if n else 0
    total = n + groups + 1
    codes = np.zeros(-(-total // 8) * 8, np.uint32)
    codes[np.arange(groups) * (LITERALS_PER_CLEAR + 1)] = 256
    codes[np.arange(n) + np.arange(n) // LITERALS_PER_CLEAR + 1] = idx
    codes[total - 1] = 257
    c = codes.reshape(-1, 8)
    out = np.empty((c.shape[0], 9), np.uint8)
    for k in range(9):  # byte k of a group holds bits 8k ... 8k + 7
        j, s = divmod(8 * k, 9)
        v = c[:, j] >> s
        if j + 1 < 8:
            v = v | (c[:, j + 1] << (9 - s))
        out[:, k] = v & 0xFF
    return sub_blocks(out.ravel()[:(9 * total + 7) // 8])


def sub_blocks(packed: np.ndarray) -> bytes:
    """Bytes as GIF data sub-blocks (a length byte, up to 255 bytes) and
    the zero terminator."""
    n = packed.size
    full, rest = divmod(n, 255)
    blocks = np.empty((full, 256), np.uint8)
    blocks[:, 0] = 255
    blocks[:, 1:] = packed[:full * 255].reshape(full, 255)
    tail = bytes([rest]) + packed[full * 255:].tobytes() if rest else b""
    return blocks.tobytes() + tail + b"\x00"


def _encode_frame(frame: np.ndarray) -> bytes:
    """One frame's image descriptor, local colour table and LZW data."""
    palette, indices = quantize_frame(frame)
    h, w = indices.shape
    return b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + palette.tobytes() + b"\x08" + lzw_literals(indices)


def write_gif(path: str, frames: np.ndarray, duration_ms: int) -> None:
    """(F, H, W, 3) uint8 RGB -> an animated GIF89a: a NETSCAPE2.0 loop
    count of 0 (for ever), then per frame a graphic control block with the delay PIL
    writes for `duration_ms` (int(duration / 10) hundredths) and the whole
    screen with a local table of its own palette (`quantize_frame`) and
    literal-only LZW codes (`lzw_literals`); the frames are encoded on a
    pool of threads."""
    from concurrent.futures import ThreadPoolExecutor

    frames = np.asarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) uint8, got {frames.shape}")
    _, h, w, _ = frames.shape
    control = b"\x21\xf9\x04\x00" + struct.pack("<H", int(duration_ms / 10)) + b"\x00\x00"
    with open(path, "wb") as fh, ThreadPoolExecutor(min(len(frames), os.cpu_count() or 1, 8) or 1) as pool:
        fh.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0, 0, 0))
        fh.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for encoded in pool.map(_encode_frame, frames):
            fh.write(control + encoded)
        fh.write(b"\x3b")
