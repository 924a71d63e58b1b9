"""BMP, PPM/PGM, TGA and TIFF stills without PIL (the counterpart of what
the JAX package gets from `Image.open(path)` and `convert("RGB")` on such
a file: ltx2_tpu/pipelines/common.py `load_image_tensor`).

Each reader works out the mode Pillow 12 opens the file in, from the same
header fields and tables as Pillow's plugin (BmpImagePlugin,
PpmImagePlugin, TgaImagePlugin, TiffImagePlugin), and refuses it before
decoding a pixel when the caller's `modes` leave it out (the JAX package's
"Unsupported image format: <mode>"). Otherwise it returns uint8 (H, W, 3)
equal to `convert("RGB")` of Pillow's decode: alpha dropped, gray
repeated. A variant Pillow opens in an accepted mode but the port does not
decode raises a ValueError that names it; none is decoded differently.

- BMP: 24-bit; 32-bit BI_RGB (BGRX, alpha ignored) and BITFIELDS with
  Pillow's seven 32-bit layouts (RGB or RGBA); 16-bit 5-5-5 and, as
  BITFIELDS, 5-6-5 (Pillow's `* 255 / 31` and `/ 63` integer scaling);
  24-bit BITFIELDS; bottom-up rows or top-down (a negative height); rows
  padded to 4 bytes; 8-bit with the identity grey palette (mode L)
  uncompressed or RLE8 (Pillow's `BmpRleDecoder`); the OS/2 12-byte header.
  Colour palettes are mode P and 1-bit grey is mode 1: refused. Not
  ported: 4-bit grey (Pillow unpacks 4-bit rows as bytes), RLE4, and RLE8
  delta escapes (Pillow reads them misaligned).
- PPM/PGM: P6 and P5, binary, and P3 and P2, plain; maxval 255 read as is,
  any other scaled by Python's `round(v / maxval * 255)` (16-bit samples of
  P6 clipped at 255, as PpmDecoder does); comments where Pillow strips them
  (in the header; in plain data up to and with the line end). P5/P2 above
  255 is mode I, P1/P4 mode 1: refused.
- TGA (no signature: tried last): image types 2/10 (24-bit RGB, 32-bit and
  16-bit RGBA) and 3/11 (8-bit L), raw or RLE (a packet that runs past its
  row refused, as Pillow's decoder refuses it), the ID field, the
  descriptor's origin bits (bottom-up or top-down, and the right-to-left
  bit Pillow flips). Colour-mapped files (P), 1-bit (1) and 16-bit grey
  with alpha (LA) are refused; a type or depth Pillow opens but has no
  decoder for raises.
- TIFF, the first image file directory, both byte orders: strips,
  contiguous or planar (PlanarConfiguration 2); 8-bit L (BlackIsZero and
  WhiteIsZero), RGB, RGBA (unassociated alpha, none named, or associated:
  Pillow's `RGBa` rawmode divides the colour by alpha, `v * 255 / a`
  clipped, 0 where alpha is 0) and RGB with extra samples; uncompressed,
  PackBits, LZW (MSB-first codes with the early change, as libtiff) and
  Deflate (tags 8 and 32946), the horizontal predictor with LZW and
  Deflate; the Orientation tag applied as Pillow's `exif_transpose` does
  when it loads a TIFF. The modes come from a copy of Pillow's OPEN_INFO
  (fill order 1); refused there: 1, P, PA, LA, I, I;16, F, CMYK, LAB.
  Named and not ported: tiles, JPEG and old-JPEG, CCITT and other
  compressions, the floating-point predictor, fill order 2, 16-bit and
  sub-byte samples, signed or float samples, planar files other than RGB
  and RGBA with unassociated alpha (where Pillow's
  raw and libtiff routes part ways, or Pillow fails), BigTIFF, old-style
  LZW.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from ltx2_tpu_torch.utils.image_io import check_mode


def _rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W[, C]) uint8 in an accepted mode -> `convert("RGB")`."""
    if pixels.ndim == 2:
        return np.repeat(pixels[..., None], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def _rows(data: bytes, offset: int, height: int, stride: int, row_bytes: int, bottom_up: bool, name: str):
    """`height` rows of `row_bytes` bytes every `stride` bytes from
    `offset`, in image order (the file's last row first when bottom-up)."""
    if offset + stride * (height - 1) + row_bytes > len(data):
        raise ValueError(f"{name}: image file is truncated ({len(data)} bytes, the rows need "
                         f"{offset + stride * (height - 1) + row_bytes})")
    buf = np.frombuffer(data, np.uint8, stride * (height - 1) + row_bytes, offset)
    rows = np.lib.stride_tricks.as_strided(buf, (height, row_bytes), (stride, 1))
    return np.array(rows[::-1] if bottom_up else rows)


# ---- BMP ------------------------------------------------------------------------

# BmpImagePlugin's 32-bit BITFIELDS layouts (r, g, b, a masks) -> rawmode
_BMP_MASKS_32 = {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX", (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
                 (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR", (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
                 (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA", (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
                 (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR", (0x0, 0x0, 0x0, 0x0): "BGRA"}
_BMP_MASKS_16 = {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"}


def _bmp_rle8(data: bytes, pos: int, width: int, height: int, name: str) -> bytes:
    """Pillow's BmpRleDecoder on 8-bit data: encoded runs clipped at the
    row's end, end-of-line fills the row with zeros, absolute runs padded to
    an even file offset, end-of-bitmap stops."""
    out = bytearray()
    x, n = 0, width * height
    while len(out) < n and pos + 2 <= len(data):
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = max(0, width - x) if x + count > width else count
            out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            raise ValueError(f"{name}: a BMP RLE8 delta escape (not ported: Pillow reads it misaligned)")
        else:
            run = data[pos:pos + byte]
            pos += byte
            out += run
            if len(run) < byte:
                break
            x += byte
            pos += pos % 2
    if len(out) < n:
        raise ValueError(f"{name}: not enough image data (the RLE8 stream gives {len(out)} of {n} pixels)")
    return bytes(out[:n])


def decode_bmp(data: bytes, name: str = "BMP", modes=None) -> np.ndarray:
    """A BMP's bytes -> uint8 (H, W, 3) as Pillow decodes it (see the
    module's docstring)."""
    if not data.startswith(b"BM") or len(data) < 26:
        raise ValueError(f"{name}: not a BMP file")
    offset, hsize = struct.unpack_from("<II", data, 10)
    if hsize == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", data, 18)
        compression, colors, pad, bottom_up = 0, 0, 3, True
    elif hsize in (40, 52, 56, 64, 108, 124):
        hd = data[18:14 + hsize]
        if len(hd) < 36:
            raise ValueError(f"{name}: truncated BMP header")
        flip = hd[7] == 0xFF
        width, height = struct.unpack_from("<II", hd, 0)
        height = 2 ** 32 - height if flip else height
        _, bits, compression = struct.unpack_from("<HHI", hd, 8)
        colors = struct.unpack_from("<I", hd, 28)[0]
        pad, bottom_up = 4, not flip
        if compression == 3:
            if len(hd) >= 48:
                masks = struct.unpack_from("<III", hd, 36) + ((struct.unpack_from("<I", hd, 48)[0],)
                                                             if len(hd) >= 52 else (0,))
            else:
                masks = struct.unpack_from("<III", data, 14 + hsize) + (0,)
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({hsize})")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    modes_by_bits = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
                     32: ("RGB", "BGRX")}
    if bits not in modes_by_bits:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, rawmode = modes_by_bits[bits]
    if compression == 3:
        if bits == 32 and masks in _BMP_MASKS_32:
            rawmode = _BMP_MASKS_32[masks]
            mode = "RGBA" if "A" in rawmode else mode
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            rawmode = "BGR"
        elif bits == 16 and masks[:3] in _BMP_MASKS_16:
            rawmode = _BMP_MASKS_16[masks[:3]]
        else:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
    elif compression not in (0, 1, 2):
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        palette = data[14 + hsize:14 + hsize + pad * colors]
        grey = all(palette[i * pad:i * pad + 3] == bytes([v]) * 3
                   for i, v in enumerate((0, 255) if colors == 2 else range(colors)))
        if grey:
            mode = "1" if colors == 2 else "L"
    check_mode(mode, modes, f"{bits}-bit BMP", name)
    if mode == "L" and bits != 8 or compression == 2:
        raise ValueError(f"{name}: a {bits}-bit grey or RLE4 BMP (not ported)")
    if mode in ("P", "1"):
        raise ValueError(f"{name}: a {bits}-bit palette BMP (mode {mode}; not ported)")
    if compression == 1:
        if bits != 8:
            raise ValueError(f"{name}: RLE8 on a {bits}-bit BMP")
        pixels = np.frombuffer(_bmp_rle8(data, offset, width, height, name), np.uint8).reshape(height, width)
        return _rgb(pixels[::-1] if bottom_up else pixels)
    stride = ((width * bits + 31) >> 3) & ~3
    rows = _rows(data, offset, height, stride, width * bits // 8, bottom_up, name)
    if bits == 8:
        return _rgb(rows)
    if bits == 16:
        v = rows.reshape(height, width, 2).astype(np.int32)
        v = v[..., 0] | (v[..., 1] << 8)
        if rawmode == "BGR;16":
            r, g, b = ((v >> 11) & 31) * 255 // 31, ((v >> 5) & 63) * 255 // 63, (v & 31) * 255 // 31
        else:
            r, g, b = ((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31
        return np.stack([r, g, b], axis=-1).astype(np.uint8)
    px = rows.reshape(height, width, len(rawmode))
    return np.ascontiguousarray(px[..., [rawmode.index(c) for c in "RGB"]])


# ---- PPM / PGM ------------------------------------------------------------------

_PPM_WHITESPACE = b" \t\n\x0b\x0c\r"
_PPM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
              b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_PPM_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")


def _ppm_token(data: bytes, pos: int, name: str):
    """PpmImageFile._read_token: skip whitespace, read to the next
    whitespace (consumed); a '#' drops the rest of its line."""
    token = b""
    while len(token) <= 10:
        c = data[pos:pos + 1]
        pos += 1
        if not c:
            break
        if c in _PPM_WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token or len(token) > 10:
        raise ValueError(f"{name}: bad PPM header token {token[:11]!r}")
    return token, pos


def decode_ppm(data: bytes, name: str = "PPM", modes=None) -> np.ndarray:
    """A PBM/PGM/PPM's bytes -> uint8 (H, W, 3) as Pillow decodes it (see
    the module's docstring)."""
    pos, magic = 0, b""
    while pos < min(len(data), 6):
        c = data[pos:pos + 1]
        pos += 1
        if c in _PPM_WHITESPACE:
            break
        magic += c
    if magic not in _PPM_MODES:
        raise ValueError(f"{name}: not a PPM file")
    mode = _PPM_MODES[magic]
    fields = []
    for _ in range(2 if mode in ("1", "F") else 3):
        token, pos = _ppm_token(data, pos, name)
        fields.append(int(token))
    width, height = fields[:2]
    if mode not in ("1", "F"):
        maxval = fields[2]
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    check_mode(mode, modes, f"{magic.decode('latin-1')} file", name)
    if mode not in ("L", "RGB"):
        raise ValueError(f"{name}: a {magic.decode('latin-1')} file (mode {mode}; not ported)")
    count = width * height * (3 if mode == "RGB" else 1)
    if magic in (b"P2", b"P3"):
        tokens = _PPM_COMMENT.sub(b"", data[pos:]).split()[:count]
        if len(tokens) < count or any(len(t) > 10 for t in tokens):
            raise ValueError(f"{name}: not enough image data, or a token too long")
        values = np.array([int(t) for t in tokens], np.int64)
        if (values < 0).any() or (values > maxval).any():
            raise ValueError(f"{name}: a channel value below 0 or above maxval {maxval}")
    else:
        size = 1 if maxval < 256 else 2
        if pos + count * size > len(data):
            raise ValueError(f"{name}: image file is truncated")
        values = np.frombuffer(data, np.uint8 if size == 1 else ">u2", count, pos).astype(np.int64)
    if maxval != 255:
        values = np.minimum(255, np.round(values / maxval * 255)).astype(np.int64)
    return _rgb(values.astype(np.uint8).reshape((height, width, 3) if mode == "RGB" else (height, width)))


# ---- TGA ------------------------------------------------------------------------

# TgaImagePlugin's MODES: (image type & 7, depth) -> rawmode
_TGA_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
                 (2, 32): "BGRA"}


def _tga_rle(data: bytes, pos: int, width: int, height: int, bpp: int, name: str) -> bytes:
    """TGA run-length packets (a run of one pixel, or raw pixels), each
    within its row (Pillow's decoder refuses a packet that runs past it)."""
    out, need = bytearray(), width * height * bpp
    while len(out) < need:
        if pos >= len(data):
            raise ValueError(f"{name}: image file is truncated (RLE data ends early)")
        head = data[pos]
        n = (head & 0x7F) + 1
        if len(out) // bpp % width + n > width:
            raise ValueError(f"{name}: buffer overrun (a TGA RLE packet runs past its row)")
        if head & 0x80:
            out += data[pos + 1:pos + 1 + bpp] * n
            pos += 1 + bpp
        else:
            out += data[pos + 1:pos + 1 + n * bpp]
            pos += 1 + n * bpp
    return bytes(out[:need])


def is_tga(data: bytes) -> bool:
    """Whether TgaImagePlugin opens a file (TGA has no signature): its
    colour-map type, size, depth and image type are ones it knows."""
    return (len(data) >= 18 and data[1] in (0, 1) and data[2] in (1, 2, 3, 9, 10, 11) and data[16] in (1, 8, 16, 24, 32)
            and min(struct.unpack_from("<HH", data, 12)) > 0)


def decode_tga(data: bytes, name: str = "TGA", modes=None) -> np.ndarray:
    """A TGA's bytes -> uint8 (H, W, 3) as Pillow decodes it (see the
    module's docstring)."""
    if not is_tga(data):
        raise ValueError(f"{name}: not a TGA file")
    id_len, cmap_type, image_type = data[0], data[1], data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if id_len == 10 and cmap_type == 0:
        raise ValueError(f"{name}: a TGA whose first bytes read as a PCX header (Pillow opens it as PCX)")
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    pos = 18 + id_len
    if cmap_type and mode != "P":
        raise ValueError(f"{name}: a colour map on a TGA of image type {image_type} (Pillow fails on it)")
    if cmap_type:
        size, map_depth = struct.unpack_from("<H", data, 5)[0], data[7]
        if map_depth not in (16, 24, 32):
            raise ValueError(f"{name}: unknown TGA map depth ({map_depth})")
        pos += size * map_depth // 8
    check_mode(mode, modes, f"{depth}-bit TGA of image type {image_type}", name)
    rawmode = _TGA_RAWMODES.get((image_type & 7, depth))
    if rawmode not in ("L", "BGR", "BGRA", "BGRA;15Z"):
        raise ValueError(f"{name}: a TGA of image type {image_type} at {depth} bits (mode {mode}, rawmode "
                         f"{rawmode}; not ported)")
    bpp = (depth + 7) // 8
    if image_type & 8:
        raw = _tga_rle(data, pos, width, height, bpp, name)
    else:
        if pos + width * height * bpp > len(data):
            raise ValueError(f"{name}: image file is truncated")
        raw = data[pos:pos + width * height * bpp]
    px = np.frombuffer(raw, np.uint8).reshape(height, width, bpp)
    if not flags & 0x20:  # bottom-up
        px = px[::-1]
    if flags & 0x10:  # right-to-left
        px = px[:, ::-1]
    if rawmode == "L":
        return _rgb(px[..., 0])
    if rawmode == "BGRA;15Z":
        v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32) << 8)
        return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31],
                        axis=-1).astype(np.uint8)
    return np.ascontiguousarray(px[..., 2::-1])


# ---- TIFF -----------------------------------------------------------------------

# TiffImagePlugin's OPEN_INFO at fill order 1, sample format 1:
# (photometric, bits per sample, extra samples) -> mode (big-endian exceptions below)
_TIFF_MODES = {
    (0, (1,), ()): "1", (1, (1,), ()): "1", (0, (2,), ()): "L", (1, (2,), ()): "L", (0, (4,), ()): "L",
    (1, (4,), ()): "L", (0, (8,), ()): "L", (1, (8,), ()): "L", (1, (12,), ()): "I;16", (0, (16,), ()): "I;16",
    (1, (16,), ()): "I;16", (1, (32,), ()): "I", (1, (8, 8), (2,)): "LA", (2, (8, 8, 8), ()): "RGB",
    (2, (8, 8, 8, 8), ()): "RGBA", (2, (8, 8, 8, 8), (0,)): "RGB", (2, (8, 8, 8, 8, 8), (0, 0)): "RGB",
    (2, (8, 8, 8, 8, 8, 8), (0, 0, 0)): "RGB", (2, (8, 8, 8, 8), (1,)): "RGBA", (2, (8, 8, 8, 8, 8), (1, 0)): "RGBA",
    (2, (8, 8, 8, 8, 8, 8), (1, 0, 0)): "RGBA", (2, (8, 8, 8, 8), (2,)): "RGBA", (2, (8, 8, 8, 8, 8), (2, 0)): "RGBA",
    (2, (8, 8, 8, 8, 8, 8), (2, 0, 0)): "RGBA", (2, (8, 8, 8, 8), (999,)): "RGBA", (2, (16, 16, 16), ()): "RGB",
    (2, (16, 16, 16, 16), ()): "RGBA", (2, (16, 16, 16, 16), (0,)): "RGB", (2, (16, 16, 16, 16), (1,)): "RGBA",
    (2, (16, 16, 16, 16), (2,)): "RGBA", (3, (1,), ()): "P", (3, (2,), ()): "P", (3, (4,), ()): "P",
    (3, (8,), ()): "P", (3, (8, 8), (0,)): "P", (3, (8, 8), (2,)): "PA", (5, (8, 8, 8, 8), ()): "CMYK",
    (5, (8, 8, 8, 8, 8), (0,)): "CMYK", (5, (8, 8, 8, 8, 8, 8), (0, 0)): "CMYK", (5, (16, 16, 16, 16), ()): "CMYK",
    (6, (8,), ()): "L", (6, (8, 8, 8), ()): "RGB", (8, (8, 8, 8), ()): "LAB",
}
_TIFF_MODES_BIG_ENDIAN = {(1, (16,), ()): "I;16B", (1, (12,), ()): None, (0, (16,), ()): None, (1, (32,), ()): None}
_TIFF_COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw", 6: "tiff_jpeg",
                      7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16", 32773: "packbits",
                      32809: "tiff_thunderscan", 32946: "tiff_deflate", 34676: "tiff_sgilog",
                      34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd", 50001: "webp"}
_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}


def _tiff_tags(data: bytes, name: str):
    """The byte order and the first IFD's integer-valued tags as tuples."""
    order = "<" if data[:2] == b"II" else ">"
    magic, ifd = struct.unpack_from(order + "HI", data, 2)
    if magic == 43:
        raise ValueError(f"{name}: a BigTIFF (not ported)")
    if data[:2] not in (b"II", b"MM") or magic != 42 or ifd + 2 > len(data):
        raise ValueError(f"{name}: not a TIFF file")
    (count,) = struct.unpack_from(order + "H", data, ifd)
    tags = {}
    for i in range(count):
        tag, kind, n = struct.unpack_from(order + "HHI", data, ifd + 2 + 12 * i)
        if kind not in _TIFF_TYPES:
            continue
        fmt = order + _TIFF_TYPES[kind] * n
        size = struct.calcsize(fmt)
        at = ifd + 2 + 12 * i + 8
        if size > 4:
            (at,) = struct.unpack_from(order + "I", data, at)
        if at + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} runs past the end of the file")
        tags[tag] = struct.unpack_from(fmt, data, at)
    return order, tags


def _lzw(strip: bytes, name: str) -> bytes:
    """TIFF LZW (libtiff's new-style LZWDecode): codes MSB first from 9
    bits, ClearCode 256, EndOfInformation 257, the code width growing one
    entry early (when the table reaches 2^n - 1 entries), at most 12."""
    if strip[:2] == b"\x00\x01":
        raise ValueError(f"{name}: old-style (LSB-first) TIFF LZW (not ported)")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev, acc, nbits = 9, None, 0, 0
    for byte in strip:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            nbits -= width
            code = acc >> nbits
            acc &= (1 << nbits) - 1
            if code == 257:
                return bytes(out)
            if code == 256:
                del table[258:]
                width, prev = 9, None
                continue
            if code < len(table):
                entry = table[code]
                if prev is not None:
                    table.append(prev + entry[:1])
            elif code == len(table) and prev is not None:
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"{name}: corrupt TIFF LZW data (code {code} past the table)")
            out += entry
            prev = entry
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
    return bytes(out)


def _packbits(strip: bytes, need: int) -> bytes:
    out, i = bytearray(), 0
    while i < len(strip) and len(out) < need:
        head = strip[i]
        if head < 128:
            out += strip[i + 1:i + 2 + head]
            i += 2 + head
        elif head > 128:
            out += strip[i + 1:i + 2] * (257 - head)
            i += 2
        else:
            i += 1
    return bytes(out)


# Pillow's exif_transpose: Orientation -> the numpy view of that transpose
_ORIENT = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1), 7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
           8: lambda a: np.rot90(a, 1)}


def decode_tiff(data: bytes, name: str = "TIFF", modes=None) -> np.ndarray:
    """A TIFF's first image -> uint8 (H, W, 3) as Pillow decodes it (see
    the module's docstring)."""
    order, tags = _tiff_tags(data, name)
    compression = tags.get(259, (1,))[0]
    if compression not in _TIFF_COMPRESSIONS:
        raise ValueError(f"{name}: unknown TIFF compression {compression}")
    kind = _TIFF_COMPRESSIONS[compression]
    photo = 6 if kind == "tiff_jpeg" else tags.get(262, (0,))[0]
    fill = tags.get(266, (1,))[0]
    sample_format = tags.get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps, extra = tags.get(258, (1,)), tags.get(338, ())
    spp = tags.get(277, (3 if kind == "tiff_jpeg" and photo in (2, 6) else 1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if 256 not in tags or 257 not in tags or len(bps) != spp:
        raise ValueError(f"{name}: TIFF without its dimensions, or an unknown data organization")
    width, height = tags[256][0], tags[257][0]
    key = (photo, bps, extra)
    mode = _TIFF_MODES_BIG_ENDIAN.get(key, _TIFF_MODES.get(key)) if order == ">" else _TIFF_MODES.get(key)
    if fill != 1 or sample_format != (1,):
        raise ValueError(f"{name}: a TIFF of fill order {fill} or sample format {sample_format} (not ported)")
    if mode is None:
        raise ValueError(f"{name}: unknown TIFF pixel mode (photometric {photo}, bits {bps}, extra samples {extra})")
    check_mode(mode, modes, f"TIFF of photometric {photo} at {bps} bits", name)
    what = f"{name}: a TIFF"
    if kind not in ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate"):
        raise ValueError(f"{what} with {kind} compression (not ported)")
    if 322 in tags or 273 not in tags:
        raise ValueError(f"{what} in tiles, or without strips (not ported)")
    if set(bps) != {8} or photo not in (0, 1, 2) or (photo == 2) == (spp == 1):
        raise ValueError(f"{what} of photometric {photo} at {bps} bits (not ported)")
    predictor = tags.get(317, (1,))[0] if kind in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate") else 1
    planar = tags.get(284, (1,))[0]
    planar_ok = photo == 2 and (spp == 3 or extra == (2,))  # where Pillow decodes planar files
    if predictor not in (1, 2) or planar not in (1, 2) or (planar == 2 and not planar_ok):
        raise ValueError(f"{what} with predictor {predictor} or planar configuration {planar} (not ported at "
                         f"photometric {photo} with extra samples {extra})")
    offsets = tags[273]
    counts = tags.get(279)
    rps = min(tags.get(278, (height,))[0], height)
    planes = spp if planar == 2 else 1
    per_row = width * spp // planes
    strips_per_plane = -(-height // rps)
    if len(offsets) < planes * strips_per_plane or (counts is None and kind != "raw"):
        raise ValueError(f"{name}: TIFF with {len(offsets)} strips, {planes * strips_per_plane} needed")
    out = np.empty((planes, height, per_row), np.uint8)
    for plane in range(planes):
        for s in range(strips_per_plane):
            i = plane * strips_per_plane + s
            rows = min(rps, height - s * rps)
            need = rows * per_row
            strip = data[offsets[i]:offsets[i] + (counts[i] if counts is not None else need)]
            if kind == "tiff_lzw":
                strip = _lzw(strip, name)
            elif kind == "packbits":
                strip = _packbits(strip, need)
            elif kind != "raw":
                strip = zlib.decompressobj().decompress(strip)
            if len(strip) < need:
                raise ValueError(f"{name}: TIFF strip {i} holds {len(strip)} bytes, {need} needed")
            block = np.frombuffer(strip, np.uint8, need).reshape(rows, width, -1)
            if predictor == 2:  # horizontal differencing, per sample, modulo 256
                block = np.cumsum(block, axis=1, dtype=np.uint8)
            out[plane, s * rps:s * rps + rows] = block.reshape(rows, per_row)
    px = out.reshape(height, width, spp) if planes == 1 else out.transpose(1, 2, 0)
    if photo == 0:
        px = 255 - px
    elif photo == 2 and extra[:1] == (1,):  # RGBa: Pillow divides the colour by alpha
        alpha = px[..., 3:4].astype(np.int32)
        colour = np.minimum(255, px[..., :3].astype(np.int32) * 255 // np.maximum(alpha, 1))
        px = np.where(alpha == 0, 0, np.where(alpha == 255, px[..., :3], colour)).astype(np.uint8)
    px = _ORIENT.get(tags.get(274, (1,))[0], _ORIENT[1])(px if px.shape[2] > 1 else px[..., 0])
    return _rgb(np.ascontiguousarray(px))


# sniff()'s name -> reader (TGA, which has no signature, is the caller's last try: `is_tga`)
STILL_READERS = {"BMP": decode_bmp, "PPM": decode_ppm, "TIFF": decode_tiff, "BigTIFF": decode_tiff}
