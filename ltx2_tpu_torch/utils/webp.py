"""The WebP container, still and animated, decoded as libwebp's
`WebPAnimDecoder` (the decoder PIL opens every WebP with) gives its frames:
RIFF chunks `VP8 `, `VP8L`, `VP8X`, `ALPH`, `ANIM` and `ANMF`; lossy frames
through `vp8.py`, lossless ones and compressed alpha through `vp8l.py`.

Alpha (`ALPH`): raw or lossless-compressed, then unfiltered (none,
horizontal, vertical or gradient). Animation: the canvas starts transparent
black; a frame is decoded over its rectangle and, unless it is a key frame,
blended (non-premultiplied, libwebp's integer arithmetic) with the previous
canvas where it is not opaque and its blend bit asks for it; a frame
disposed to the background clears its rectangle before the next. The RGB
frames are the canvas with its alpha dropped, as PIL's `convert("RGB")`
drops it. Host numpy, no PIL.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ltx2_tpu_torch.utils import vp8, vp8l

ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02


class WebPError(ValueError):
    pass


@dataclass
class Frame:
    x: int
    y: int
    width: int
    height: int
    duration: int
    dispose_background: bool
    blend: bool
    bitstream: bytes  # the VP8 or VP8L payload
    lossless: bool
    alpha: Optional[bytes] = None  # an ALPH payload

    @property
    def has_alpha(self) -> bool:
        if self.lossless:
            return vp8l.peek_header(self.bitstream)[2]
        return self.alpha is not None


@dataclass
class WebPFile:
    """The canvas and its frames; ANIM's background colour and loop count are
    not kept (the animation decoder starts from transparent black)."""

    width: int
    height: int
    frames: List[Frame] = field(default_factory=list)


def _chunks(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) != size:
            raise WebPError(f"WebP: truncated {kind!r} chunk")
        yield kind, body
        pos += 8 + size + (size & 1)


def _frame_from(chunks, x: int, y: int, w: Optional[int], h: Optional[int], duration: int, flags: int) -> Frame:
    alpha = None
    for kind, body in chunks:
        if kind == b"ALPH" and alpha is None:
            alpha = body
        elif kind in (b"VP8 ", b"VP8L"):
            lossless = kind == b"VP8L"
            if lossless:
                header = vp8l.peek_header(body)
                if header is None:
                    raise WebPError("WebP: bad VP8L header")
                bw, bh = header[:2]
            else:
                bw, bh = vp8.frame_size(body)
            if (w is not None and (bw, bh) != (w, h)):
                raise WebPError(f"WebP: a {bw}x{bh} bitstream in a {w}x{h} frame")
            return Frame(x, y, bw, bh, duration, bool(flags & 1), not flags & 2, body, lossless,
                         None if lossless else alpha)
    raise WebPError("WebP: a frame without a VP8 or VP8L bitstream")


def parse(data: bytes) -> WebPFile:
    """A WebP file's canvas and frames (not decoded)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebPError("WebP: not a RIFF WEBP file")
    end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise WebPError("WebP: no chunks")
    kind, body = chunks[0]
    if kind in (b"VP8 ", b"VP8L"):
        frame = _frame_from(chunks[:1], 0, 0, None, None, 0, 0)
        return WebPFile(frame.width, frame.height, [frame])
    if kind != b"VP8X" or len(body) < 10:
        raise WebPError(f"WebP: unknown first chunk {kind!r}")
    flags = body[0]
    width = 1 + int.from_bytes(body[4:7], "little")
    height = 1 + int.from_bytes(body[7:10], "little")
    out = WebPFile(width, height)
    if flags & ANIMATION_FLAG:
        for kind, body in chunks[1:]:
            if kind == b"ANMF":
                fx, fy = 2 * int.from_bytes(body[0:3], "little"), 2 * int.from_bytes(body[3:6], "little")
                fw, fh = 1 + int.from_bytes(body[6:9], "little"), 1 + int.from_bytes(body[9:12], "little")
                duration, fflags = int.from_bytes(body[12:15], "little"), body[15]
                if fx + fw > width or fy + fh > height:
                    raise WebPError("WebP: a frame outside the canvas")
                out.frames.append(_frame_from(_chunks(body, 16, len(body)), fx, fy, fw, fh, duration, fflags))
    else:
        image = [(k, b) for k, b in chunks[1:] if k in (b"ALPH", b"VP8 ", b"VP8L")]
        frame = _frame_from(image, 0, 0, None, None, 0, 0)
        if (frame.width, frame.height) != (width, height):
            raise WebPError("WebP: the image does not fill the canvas")
        out.frames.append(frame)
    if not out.frames:
        raise WebPError("WebP: no frames")
    return out


# ---------------------------------------------------------------- alpha


def _unfilter_alpha(plane: np.ndarray, method: int) -> np.ndarray:
    """The ALPH filters undone: horizontal (from the left; a row's first
    pixel from the one above), vertical (from above; row 0 from the left)
    and gradient (left + above - above-left, clipped; row 0 from the left,
    a row's first pixel from above)."""
    if method == 0:
        return plane
    h, w = plane.shape
    a = plane.astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[0] = np.cumsum(a[0]) & 0xFF
    if method == 1:
        for y in range(1, h):
            a[y, 0] += out[y - 1, 0]
            out[y] = np.cumsum(a[y]) & 0xFF
    elif method == 2:
        out[1:] = (np.cumsum(a[1:], axis=0) + out[0]) & 0xFF
    else:
        for y in range(1, h):
            prev, row, cur = out[y - 1].tolist(), a[y].tolist(), [0] * w
            left = top_left = prev[0]
            for x in range(w):
                top = prev[x]
                g = left + top - top_left
                left = cur[x] = (row[x] + (0 if g < 0 else 255 if g > 255 else g)) & 0xFF
                top_left = top
            out[y] = cur
    return out.astype(np.uint8)


def decode_alpha(chunk: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk -> (H, W) uint8."""
    if not chunk:
        raise WebPError("WebP: empty ALPH chunk")
    method, filt = chunk[0] & 3, (chunk[0] >> 2) & 3
    if method == 0:
        raw = np.frombuffer(chunk[1:1 + width * height], np.uint8)
        if raw.size != width * height:
            raise WebPError("WebP: truncated raw alpha")
        plane = raw.reshape(height, width)
    elif method == 1:
        plane = vp8l.decode_alpha_plane(chunk[1:], width, height)
    else:
        raise WebPError(f"WebP: alpha compression {method}")
    return _unfilter_alpha(plane, filt)


def decode_frame(frame: Frame) -> np.ndarray:
    """A frame's bitstream -> (h, w, 4) uint8 RGBA (non-premultiplied)."""
    if frame.lossless:
        rgba, _ = vp8l.decode_vp8l(frame.bitstream)
        return rgba
    rgb = vp8.decode_vp8(frame.bitstream)
    alpha = (decode_alpha(frame.alpha, frame.width, frame.height) if frame.alpha is not None
             else np.full(rgb.shape[:2], 255, np.uint8))
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


# ---------------------------------------------------------------- animation


def _blend(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """libwebp's non-premultiplied blend of src over dst where src is not
    opaque, both (..., 4) uint8."""
    s, d = src.astype(np.int64), dst.astype(np.int64)
    sa, da = s[..., 3], d[..., 3]
    dfa = (da * (256 - sa)) >> 8
    ba = sa + dfa
    scale = np.where(ba > 0, (1 << 24) // np.maximum(ba, 1), 0)
    rgb = ((s[..., :3] * sa[..., None] + d[..., :3] * dfa[..., None]) * scale[..., None]) >> 24
    out = np.concatenate([rgb, ba[..., None]], axis=-1).astype(np.uint8)
    keep_dst = sa == 0
    out[keep_dst] = dst[keep_dst]
    opaque = sa == 255
    out[opaque] = src[opaque]
    return out


def _is_key_frame(i: int, cur: Frame, prev: Optional[Frame], prev_key: bool, width: int, height: int) -> bool:
    if i == 0:
        return True
    full = (cur.width, cur.height) == (width, height)
    if (not cur.has_alpha or not cur.blend) and full:
        return True
    return prev.dispose_background and ((prev.width, prev.height) == (width, height) or prev_key)


def iter_canvases(info: WebPFile, max_frames: Optional[int] = None):
    """Yield (canvas (H, W, 4) uint8 RGBA, timestamp ms) after each frame, as
    `WebPAnimDecoderGetNext` gives them; at most `max_frames` frames."""
    w, h = info.width, info.height
    disposed = np.zeros((h, w, 4), np.uint8)  # the previous canvas, disposed
    prev, prev_key, timestamp = None, False, 0
    for i, fr in enumerate(info.frames[:max_frames]):
        key = _is_key_frame(i, fr, prev, prev_key, w, h)
        canvas = np.zeros((h, w, 4), np.uint8) if key else disposed.copy()
        rect = decode_frame(fr)
        ys, xs = slice(fr.y, fr.y + fr.height), slice(fr.x, fr.x + fr.width)
        canvas[ys, xs] = rect
        if i > 0 and fr.blend and not key:
            if not prev.dispose_background:
                canvas[ys, xs] = _blend(rect, disposed[ys, xs])
            else:
                # Outside the previous frame's rectangle only: inside it the
                # disposed canvas is transparent, and the decoded pixels stay.
                outside = np.ones((fr.height, fr.width), bool)
                py0, px0 = prev.y - fr.y, prev.x - fr.x
                outside[max(py0, 0):max(py0 + prev.height, 0), max(px0, 0):max(px0 + prev.width, 0)] = False
                blended = _blend(rect, disposed[ys, xs])
                region = canvas[ys, xs]
                region[outside] = blended[outside]
        timestamp += fr.duration
        yield canvas, timestamp
        prev, prev_key = fr, key
        disposed = canvas.copy()
        if fr.dispose_background:
            disposed[ys, xs] = 0


def read_webp_frames(data: bytes, max_frames: Optional[int] = None) -> List[np.ndarray]:
    """A WebP file's frames as PIL gives them through `convert("RGB")`:
    uint8 (H, W, 3) canvases, at most `max_frames`."""
    return [np.ascontiguousarray(c[..., :3]) for c, _ in iter_canvases(parse(data), max_frames)]


def webp_info(data: bytes) -> Tuple[int, int, int, int]:
    """(width, height, frames, the first frame's duration in ms)."""
    info = parse(data)
    return info.width, info.height, len(info.frames), info.frames[0].duration
