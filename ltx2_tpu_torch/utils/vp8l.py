"""A WebP lossless (VP8L) decoder in numpy: the `VP8L` chunk of a WebP file
and the lossless-compressed alpha plane of an `ALPH` chunk (RFC 9649).

Prefix codes (simple and normal, with meta prefix codes over an entropy
image), the colour cache, LZ77 backward references with the distance map,
and the four transforms (predictor, cross-colour, subtract-green and
colour-indexing with pixel bundling), undone in reverse order. Pixels are
ARGB packed in uint32, as libwebp keeps them. The entropy-coded stream is
read one symbol at a time in Python; the transforms other than the
predictor are vectorized, the predictor row by row.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

SIGNATURE = 0x2F
NUM_LITERAL_CODES = 256
NUM_LENGTH_CODES = 24
NUM_DISTANCE_CODES = 40
CODE_LENGTH_CODE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# The distance map's 120 (dy, 8 - dx) codes, dy * 16 + (8 - dx).
CODE_TO_PLANE = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
)
PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)


class VP8LError(ValueError):
    pass


class BitReader:
    """LSB-first bit reader over bytes."""

    def __init__(self, data: bytes, start: int = 0):
        self.data = data
        self.pos = 8 * start
        self.end = 8 * len(data)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        byte = self.pos >> 3
        v = int.from_bytes(self.data[byte:byte + 4], "little") >> (self.pos & 7)
        self.pos += n
        if self.pos > self.end:
            raise VP8LError("VP8L: the bitstream ends early")
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        byte = self.pos >> 3
        return (int.from_bytes(self.data[byte:byte + 4], "little") >> (self.pos & 7)) & ((1 << n) - 1)


class Huffman:
    """A canonical prefix code as a lookup table over the next `bits` bits
    (LSB-first, so the codes are bit-reversed): entry = length << 16 |
    symbol. A code of one symbol reads no bits."""

    def __init__(self, lengths: List[int]):
        used = [(n, s) for s, n in enumerate(lengths) if n]
        if not used:
            raise VP8LError("VP8L: a prefix code with no symbol")
        if len(used) == 1:
            self.bits, self.table = 0, [used[0][1]]
            return
        self.bits = max(n for n, _ in used)
        table = np.full(1 << self.bits, -1, np.int64)
        code, prev_len = 0, 0
        filled = 0
        for n, s in sorted(used):
            code <<= n - prev_len
            prev_len = n
            rev = int(format(code, f"0{n}b")[::-1], 2)
            table[rev::1 << n] = (n << 16) | s
            filled += 1 << (self.bits - n)
            code += 1
        if filled != 1 << self.bits:
            raise VP8LError("VP8L: an incomplete or over-subscribed prefix code")
        self.table = table.tolist()

    def read(self, br: BitReader) -> int:
        if not self.bits:
            return self.table[0]
        e = self.table[br.peek(self.bits)]
        br.pos += e >> 16
        return e & 0xFFFF


def _code_lengths(br: BitReader, alphabet: int) -> List[int]:
    lengths = [0] * alphabet
    if br.read(1):  # simple code: one or two symbols
        count = br.read(1) + 1
        lengths[br.read(8 if br.read(1) else 1)] = 1
        if count == 2:
            lengths[br.read(8)] = 1
        return lengths
    ll = [0] * 19
    for i in range(br.read(4) + 4):
        ll[CODE_LENGTH_CODE_ORDER[i]] = br.read(3)
    lcode = Huffman(ll)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise VP8LError("VP8L: max_symbol past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        n = lcode.read(br)
        if n < 16:
            lengths[sym] = n
            sym += 1
            if n:
                prev = n
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > alphabet:
                raise VP8LError("VP8L: code lengths past the alphabet")
            value = prev if n == 16 else 0
            lengths[sym:sym + repeat] = [value] * repeat
            sym += repeat
    return lengths


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _prefix_value(symbol: int, br: BitReader) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _decode_pixels(br: BitReader, width: int, height: int, level0: bool) -> np.ndarray:
    """One entropy-coded image: the colour cache, prefix codes (with a meta
    entropy image when `level0`) and the ARGB pixels, (height * width,)
    uint32."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise VP8LError(f"VP8L: colour cache bits {cache_bits}")
    meta, meta_bits, meta_w = None, 0, 0
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _subsample(width, meta_bits)
        entropy = decode_image_stream(br, meta_w, _subsample(height, meta_bits), level0=False)
        meta = ((entropy >> 8) & 0xFFFF).astype(np.int64).reshape(-1).tolist()
    groups = max(meta) + 1 if meta else 1
    cache_size = 1 << cache_bits if cache_bits else 0
    codes = []
    for _ in range(groups):
        codes.append([Huffman(_code_lengths(br, n)) for n in (
            NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size, 256, 256, 256, NUM_DISTANCE_CODES)])
    total = width * height
    out = [0] * total
    cache = [0] * cache_size
    cache_shift = 32 - cache_bits
    cached = 0  # pixels inserted into the colour cache so far (lazily, before a lookup)
    mask = (1 << meta_bits) - 1 if meta is not None else -1
    i, x, y = 0, 0, 0
    green, red, blue, alpha, dist = codes[0]
    while i < total:
        if meta is not None and (x & mask) == 0:
            green, red, blue, alpha, dist = codes[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        code = green.read(br)
        if code < NUM_LITERAL_CODES:
            r = red.read(br)
            b = blue.read(br)
            out[i] = (alpha.read(br) << 24) | (r << 16) | (code << 8) | b
            i += 1
            x += 1
            if x >= width:
                x, y = 0, y + 1
        elif code < NUM_LITERAL_CODES + NUM_LENGTH_CODES:
            length = _prefix_value(code - NUM_LITERAL_CODES, br)
            dcode = _prefix_value(dist.read(br), br)
            if dcode > 120:
                d = dcode - 120
            else:
                plane = CODE_TO_PLANE[dcode - 1]
                d = max((plane >> 4) * width + 8 - (plane & 0xF), 1)
            if d > i or i + length > total:
                raise VP8LError("VP8L: a backward reference outside the image")
            for k in range(i, i + length):
                out[k] = out[k - d]
            i += length
            x += length
            while x >= width:
                x -= width
                y += 1
            if meta is not None and i < total and (x & mask):
                green, red, blue, alpha, dist = codes[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        elif code < NUM_LITERAL_CODES + NUM_LENGTH_CODES + cache_size:
            while cached < i:
                cache[((out[cached] * 0x1E35A7BD) & 0xFFFFFFFF) >> cache_shift] = out[cached]
                cached += 1
            out[i] = cache[code - NUM_LITERAL_CODES - NUM_LENGTH_CODES]
            i += 1
            x += 1
            if x >= width:
                x, y = 0, y + 1
        else:
            raise VP8LError(f"VP8L: symbol {code} past the green alphabet")
    return np.array(out, dtype=np.uint32)


def decode_image_stream(br: BitReader, width: int, height: int, level0: bool = True) -> np.ndarray:
    """An image stream: with `level0` its transforms, then the entropy-coded
    pixels, the transforms undone; (height, width) uint32 ARGB."""
    transforms = []
    xsize = width
    if level0:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen & (1 << kind):
                raise VP8LError(f"VP8L: transform {kind} twice")
            seen |= 1 << kind
            if kind in (PREDICTOR, CROSS_COLOR):
                bits = br.read(3) + 2
                data = decode_image_stream(br, _subsample(xsize, bits), _subsample(height, bits), level0=False)
                transforms.append((kind, xsize, bits, data))
            elif kind == COLOR_INDEXING:
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                palette = decode_image_stream(br, n, 1, level0=False).reshape(-1)
                transforms.append((kind, xsize, bits, _expand_palette(palette, bits)))
                xsize = _subsample(xsize, bits)
            else:
                transforms.append((kind, xsize, 0, None))
    pixels = _decode_pixels(br, xsize, height, level0).reshape(height, xsize)
    for kind, xs, bits, data in reversed(transforms):
        if kind == PREDICTOR:
            pixels = _inverse_predictor(pixels, bits, data)
        elif kind == CROSS_COLOR:
            pixels = _inverse_cross_color(pixels, bits, data)
        elif kind == SUBTRACT_GREEN:
            pixels = _add_green(pixels)
        else:
            pixels = _inverse_color_indexing(pixels, xs, bits, data)
    return pixels


def _expand_palette(palette: np.ndarray, bits: int) -> np.ndarray:
    """The delta-coded palette summed per byte, padded with zeros (transparent
    black) to the 2^(8 >> bits) entries an index can name."""
    b = palette.view(np.uint8).reshape(-1, 4).astype(np.int64)
    full = np.zeros((1 << (8 >> bits), 4), np.uint8)
    full[:len(b)] = (np.cumsum(b, axis=0) & 0xFF).astype(np.uint8)
    return full.reshape(-1).view(np.uint32)


def _inverse_color_indexing(pixels: np.ndarray, width: int, bits: int, palette: np.ndarray) -> np.ndarray:
    index = (pixels >> 8) & 0xFF
    if bits:
        per = 1 << bits
        depth = 8 >> bits
        shifts = (np.arange(per, dtype=np.uint32) * depth)[None, None, :]
        index = ((index[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(pixels.shape[0], -1)[:, :width]
    return palette[index]


def _add_green(pixels: np.ndarray) -> np.ndarray:
    green = (pixels >> 8) & 0xFF
    rb = (((pixels & 0x00FF00FF) + (green << 16 | green)) & 0x00FF00FF)
    return ((pixels & 0xFF00FF00) | rb).astype(np.uint32)


def _sbyte(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int32) & 0xFF
    return v - ((v & 0x80) << 1)


def _inverse_cross_color(pixels: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    h, w = pixels.shape
    tiles = data[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r, g2b, r2b = _sbyte(tiles), _sbyte(tiles >> 8), _sbyte(tiles >> 16)
    green = _sbyte(pixels >> 8)
    red = ((pixels >> 16).astype(np.int32) + ((g2r * green) >> 5)) & 0xFF
    blue = ((pixels & 0xFF).astype(np.int32) + ((g2b * green) >> 5) + ((r2b * _sbyte(red)) >> 5)) & 0xFF
    return ((pixels & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)).astype(np.uint32)


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _select(t: int, l: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        c = (tl >> sh) & 0xFF
        s += abs(((l >> sh) & 0xFF) - c) - abs(((t >> sh) & 0xFF) - c)
    return t if s <= 0 else l


def _add_sub_full(l: int, t: int, tl: int) -> int:
    out = 0
    for sh in (24, 16, 8, 0):
        out |= _clip255(((l >> sh) & 0xFF) + ((t >> sh) & 0xFF) - ((tl >> sh) & 0xFF)) << sh
    return out


def _add_sub_half(avg: int, tl: int) -> int:
    out = 0
    for sh in (24, 16, 8, 0):
        a, b = (avg >> sh) & 0xFF, (tl >> sh) & 0xFF
        d = a - b
        out |= _clip255(a + (d // 2 if d >= 0 else -((-d) // 2))) << sh  # C's truncating division
    return out


def _predict(mode: int, l: int, t: int, tr: int, tl: int) -> int:
    if mode == 1:
        return l
    if mode == 2:
        return t
    if mode == 3:
        return tr
    if mode == 4:
        return tl
    if mode == 5:
        return _avg2(_avg2(l, tr), t)
    if mode == 6:
        return _avg2(l, tl)
    if mode == 7:
        return _avg2(l, t)
    if mode == 8:
        return _avg2(tl, t)
    if mode == 9:
        return _avg2(t, tr)
    if mode == 10:
        return _avg2(_avg2(l, tl), _avg2(t, tr))
    if mode == 11:
        return _select(t, l, tl)
    if mode == 12:
        return _add_sub_full(l, t, tl)
    if mode == 13:
        return _add_sub_half(_avg2(l, t), tl)
    return 0xFF000000  # 0, and 14-15 as libwebp reads them


def _inverse_predictor(pixels: np.ndarray, bits: int, data: np.ndarray) -> np.ndarray:
    """Row 0: pixel 0 from black, the rest from the left; every other row:
    pixel 0 from the top, the rest by their tile's mode. The top-right of a
    row's last pixel is the row's first pixel (libwebp's layout)."""
    h, w = pixels.shape
    res = pixels.tolist()
    modes = ((data >> 8) & 0xF).tolist()
    out: List[List[int]] = []
    row = [0] * w
    prev = 0xFF000000
    for x in range(w):
        prev = row[x] = _add(res[0][x], prev)
    out.append(row)
    for y in range(1, h):
        up, cur, r = out[y - 1], [0] * w, res[y]
        cur[0] = left = _add(r[0], up[0])
        tile = modes[y >> bits]
        for x in range(1, w):
            t = up[x]
            tr = up[x + 1] if x + 1 < w else cur[0]
            left = cur[x] = _add(r[x], _predict(tile[x >> bits], left, t, tr, up[x - 1]))
        out.append(cur)
    return np.array(out, dtype=np.uint32)


def decode_vp8l(data: bytes) -> Tuple[np.ndarray, bool]:
    """A VP8L chunk's payload -> ((H, W, 4) uint8 RGBA, the header's
    alpha-is-used bit)."""
    if len(data) < 5 or data[0] != SIGNATURE:
        raise VP8LError("VP8L: bad signature")
    br = BitReader(data, 1)
    width, height = br.read(14) + 1, br.read(14) + 1
    alpha_used = bool(br.read(1))
    if br.read(3) != 0:
        raise VP8LError("VP8L: unknown version")
    argb = decode_image_stream(br, width, height)
    rgba = np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF, argb >> 24], axis=-1)
    return rgba.astype(np.uint8), alpha_used


def decode_alpha_plane(data: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's lossless-compressed plane (a VP8L image stream without
    the header) -> (H, W) uint8, the green channel."""
    argb = decode_image_stream(BitReader(data), width, height)
    return ((argb >> 8) & 0xFF).astype(np.uint8)


def peek_header(data: bytes) -> Optional[Tuple[int, int, bool]]:
    """(width, height, alpha-is-used) of a VP8L payload."""
    if len(data) < 5 or data[0] != SIGNATURE:
        return None
    br = BitReader(data, 1)
    return br.read(14) + 1, br.read(14) + 1, bool(br.read(1))
