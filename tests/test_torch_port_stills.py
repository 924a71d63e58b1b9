"""The stills PIL opens, in the port (ltx2_tpu_torch/utils/image_io.py,
jpeg.py, gif.py and still_io.py behind pipelines/common.read_image) against
the JAX package, bit for bit, on files PIL writes here or, where PIL writes
no such file, written by hand (tests/torch_port_media.py):

- `load_image_tensor` against `ltx2_tpu.pipelines.common.load_image_tensor`
  (PIL's `Image.open`, its refusal of modes other than RGB, RGBA and L,
  `convert("RGB")`, LANCZOS) over every PNG color type x bit depth x
  interlace, baseline, progressive and RGB-coded JPEG, BMP, PPM/PGM, TGA,
  TIFF and GIF variants, each at a few odd sizes up to 64x96: equal arrays
  where the JAX package takes the file, and where it refuses it a
  ValueError naming the same mode (so the two accept the same files);
  `read_image` equal to PIL's `convert("RGB")` as well;
- the still-.png video route (`read_pil_animation`, `probe_video`) against
  the JAX package's for every PNG color type, bit depth and interlace;
- progressive JPEGs with restart intervals and optimized tables, at 4:2:0,
  4:2:2, 4:4:4 and gray; an EXIF orientation left unapplied, as PIL's
  `open` leaves it; a file whose scans leave bits unsent, which libjpeg
  decodes with block smoothing, refused by name;
- the variants the port refuses by name although PIL opens them;
- the committed stills: what their recipes write, and PIL's hashes.

Tolerance: none.
"""

import io
import re
import struct

import numpy as np
import pytest
from PIL import Image

from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch.pipelines.common import load_image_tensor, read_image
from ltx2_tpu_torch.utils import video_io as vio
from ltx2_tpu_torch.utils.image_io import PNG_MODES, STILL_MODES, read_png, sniff
from ltx2_tpu_torch.utils.jpeg import JPEGFrame, decode_jpeg
from ltx2_tpu_torch.utils.still_io import decode_bmp, decode_ppm, decode_tga, decode_tiff
from tests import torch_port_media as media
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TARGET = (24, 40)  # load_image_tensor's (height, width): every still here is resized and cropped
SIZES = ((1, 1), (3, 5), (37, 53))
ODD_SIZES = ((5, 3), (37, 53), (64, 96))


def _pixels(h: int, w: int, seed: int, channels: int = 3) -> np.ndarray:
    """uint8 (h, w, channels): a gradient with noise and a flat patch (runs
    for the RLE coders)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy * 3 + 40 * c) % 256 for c in range(channels)], -1)
    px = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    px[: h // 2, : w // 2] = px[0, 0]
    return px


def _held(path) -> str:
    """The port's `load_image_tensor` against the JAX package's on `path`:
    equal, or both refusing; returns the refused mode ('' when taken). A
    taken file's `read_image` equals PIL's `convert("RGB")` too."""
    path = str(path)
    try:
        ref = np.asarray(jcommon.load_image_tensor(path, *TARGET))
    except ValueError as e:
        mode = re.match(r"Unsupported image format: (\S+)\. ", str(e)).group(1)
        with pytest.raises(ValueError, match=f"Unsupported image format: {re.escape(mode)}\\."):
            load_image_tensor(path, *TARGET)
        return mode
    np.testing.assert_array_equal(load_image_tensor(path, *TARGET).numpy(), ref)
    with Image.open(path) as im:
        np.testing.assert_array_equal(read_image(path), np.asarray(im.convert("RGB")))
    return ""


def _write(path, data: bytes):
    path.write_bytes(data)
    return path


def _pil(path, pixels: np.ndarray, mode: str, fmt: str, **options):
    Image.fromarray(pixels).convert(mode).save(path, fmt, **options)
    return path


# ---- PNG ------------------------------------------------------------------------

PNG_CASES = sorted(PNG_MODES)


def _png(path, depth: int, color: int, interlace: bool, h: int, w: int, seed: int):
    """A PNG of random samples at the depth and color type; palettes are
    shorter than the index range (entries past them read black), and the
    odd seeds carry a tRNS chunk (which `convert("RGB")` ignores)."""
    rng = np.random.default_rng(seed)
    samples = PNG_MODES[(depth, color)][1]
    px = rng.integers(0, 1 << depth, (h, w, samples))
    palette = trns = None
    if color == 3:
        palette = rng.integers(0, 256, ((1 << depth) * 3 // 4 + 1, 3))
        trns = bytes(rng.integers(0, 256, 3, dtype=np.uint8)) if seed % 2 else None
    elif color in (0, 2) and seed % 2:
        trns = struct.pack(">" + "H" * (1 if color == 0 else 3), *([int(px.flat[0])] * (1 if color == 0 else 3)))
    return _write(path, media.png_bytes(px, depth, color, interlace, palette, trns))


@pytest.mark.parametrize("interlace", [False, True], ids=["sequential", "adam7"])
@pytest.mark.parametrize("depth,color", PNG_CASES, ids=[f"{d}bit_type{c}" for d, c in PNG_CASES])
def test_png_still_matches_jax(tmp_path, depth, color, interlace):
    mode = PNG_MODES[(depth, color)][0]
    for i, (h, w) in enumerate(SIZES):
        path = _png(tmp_path / f"s{i}.png", depth, color, interlace, h, w, seed=depth * 10 + color + i)
        assert _held(path) == ("" if mode in STILL_MODES else mode)


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")  # PIL's, on the tRNS palettes
@pytest.mark.parametrize("interlace", [False, True], ids=["sequential", "adam7"])
@pytest.mark.parametrize("depth,color", PNG_CASES, ids=[f"{d}bit_type{c}" for d, c in PNG_CASES])
def test_png_video_route_matches_jax(tmp_path, depth, color, interlace):
    for i, (h, w) in enumerate(SIZES):
        path = str(_png(tmp_path / f"v{i}.png", depth, color, interlace, h, w, seed=depth * 10 + color + i + 5))
        np.testing.assert_array_equal(vio.read_pil_animation(path, 24, 40, 2),
                                      jvio.read_pil_animation(path, 24, 40, 2))
        with Image.open(path) as im:
            np.testing.assert_array_equal(read_png(path), np.asarray(im.convert("RGB")))
    assert vio.probe_video(path) == jvio.probe_video(path) == (24.0, 1, h, w)


# ---- JPEG -----------------------------------------------------------------------

def _exif_orientation(value: int):
    exif = Image.Exif()
    exif[0x0112] = value
    return exif


JPEG_CASES = {
    "baseline_420": ("RGB", {"quality": 85, "subsampling": "4:2:0"}),
    "progressive_420": ("RGB", {"progressive": True, "subsampling": "4:2:0"}),
    "progressive_422": ("RGB", {"progressive": True, "subsampling": "4:2:2", "quality": 60}),
    "progressive_444": ("RGB", {"progressive": True, "subsampling": "4:4:4", "quality": 95}),
    "progressive_gray": ("L", {"progressive": True, "quality": 80}),
    "progressive_restart_optimize": ("RGB", {"progressive": True, "optimize": True, "restart_marker_blocks": 2,
                                             "subsampling": "4:2:0"}),
    "progressive_restart_rows_gray": ("L", {"progressive": True, "optimize": True, "restart_marker_rows": 1}),
    "rgb_coded": ("RGB", {"keep_rgb": True, "subsampling": "4:4:4"}),
    "rgb_coded_progressive": ("RGB", {"keep_rgb": True, "subsampling": "4:4:4", "progressive": True}),
    "exif_orientation_6": ("RGB", {"progressive": True, "exif": _exif_orientation(6)}),
    "cmyk": ("CMYK", {}),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_still_matches_jax(tmp_path, case):
    mode, options = JPEG_CASES[case]
    for i, (h, w) in enumerate(ODD_SIZES):
        path = _pil(tmp_path / f"j{i}.jpg", _pixels(h, w, seed=i), mode, "JPEG", **options)
        assert _held(path) == ("CMYK" if mode == "CMYK" else "")
        if mode != "CMYK":
            frame = JPEGFrame(path.read_bytes())
            assert frame.progressive == bool(options.get("progressive"))
            assert frame.color_space() == ("RGB" if options.get("keep_rgb") else "L" if mode == "L" else "YCbCr")
            assert read_image(str(path)).shape == (h, w, 3)  # the EXIF orientation is not applied


def _scans(data: bytes) -> list:
    """The offsets of a JPEG's SOS markers (0xFF 0xDA occurs nowhere else:
    the entropy-coded data stuffs every 0xFF)."""
    return [m.start() for m in re.finditer(b"\xff\xda", data)]


def test_progressive_with_unsent_bits_is_refused():
    """A progressive file cut after its first scans (and closed with EOI)
    leaves the low AC bits unsent: libjpeg decodes it with block smoothing,
    which the port does not do, so it refuses the file by name. The whole
    file's scans, all of them sent, decode as PIL's."""
    buf = io.BytesIO()
    Image.fromarray(_pixels(37, 53, seed=4)).save(buf, "JPEG", progressive=True, quality=85)
    data = buf.getvalue()
    scans = _scans(data)
    assert len(scans) == 10  # libjpeg's simple progression for YCbCr
    np.testing.assert_array_equal(decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    for cut in (2, 5, 9):
        partial = data[:scans[cut]] + b"\xff\xd9"
        Image.open(io.BytesIO(partial)).convert("RGB")  # PIL decodes it (smoothed)
        with pytest.raises(ValueError, match="block smoothing"):
            decode_jpeg(partial)


# ---- BMP, PPM/PGM, TGA, TIFF, GIF -----------------------------------------------

GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def _bmp32(px: np.ndarray, masks) -> bytes:
    """32-bit BITFIELDS rows laid out by `masks` (r, g, b, a)."""
    h, w, _ = px.shape
    x = np.zeros((h, w), np.uint32)
    alpha = (px[..., 0] // 2 + 64).astype(np.uint32)
    for channel, mask in zip((px[..., 0], px[..., 1], px[..., 2], alpha), masks):
        if mask:
            x |= channel.astype(np.uint32) << ((mask & -mask).bit_length() - 1)
    return media.bmp_bytes(x.astype("<u4").view(np.uint8).reshape(h, -1), 32, 3, masks if masks[3] else masks[:3],
                           header=56 if masks[3] else 40)


def _rle8(g: np.ndarray) -> bytes:
    """RLE8 of bottom-up rows: encoded runs of 3 or more, absolute runs of
    3-5 (padded to even), single pixels as runs of 1, an end-of-line after
    each row, the end of the bitmap."""
    out = b""
    for row in g[::-1]:
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 3 or len(row) - i < 3:
                out += bytes([max(j - i, 1), row[i]])
                i = max(j, i + 1)
            else:
                n = min(len(row) - i, 5)
                out += bytes([0, n]) + bytes(row[i:i + n]) + b"\x00" * (n % 2)
                i += n
        out += b"\x00\x00"
    return out + b"\x00\x01"


def _bmp16(px: np.ndarray, masks) -> bytes:
    h, w, _ = px.shape
    v = ((px[..., 0].astype(np.uint16) << 8) | px[..., 1]).astype("<u2")
    return media.bmp_bytes(v.view(np.uint8).reshape(h, -1), 16, 3 if masks else 0, masks)


BMP_CASES = {
    "24bit": lambda p, px: _pil(p, px, "RGB", "BMP"),
    "24bit_top_down": lambda p, px: _write(p, media.bmp_bytes(px[..., ::-1].reshape(len(px), -1), 24, top_down=True)),
    "24bit_os2_header": lambda p, px: _write(p, media.bmp_bytes(px[..., ::-1].reshape(len(px), -1), 24, header=12)),
    "32bit_bi_rgb": lambda p, px: _pil(p, np.dstack([px, px[..., :1]]), "RGBA", "BMP"),
    "16bit_555": lambda p, px: _write(p, _bmp16(px, None)),
    "16bit_565": lambda p, px: _write(p, _bmp16(px, (0xF800, 0x7E0, 0x1F))),
    "8bit_grey": lambda p, px: _pil(p, px, "L", "BMP"),
    "8bit_grey_rle8": lambda p, px: _write(p, media.bmp_bytes((_rle8(px[..., 0] // 16 * 16), px.shape[:2]), 8, 1,
                                                              palette=GREY)),
    "palette": lambda p, px: _pil(p, px, "P", "BMP"),
    "1bit": lambda p, px: _pil(p, px, "1", "BMP"),
    **{f"32bit_bitfields_{i}": (lambda p, px, m=m: _write(p, _bmp32(px, m)))
       for i, m in enumerate([(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                              (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                              (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                              (0xFF000000, 0xFF00, 0xFF, 0xFF0000)])},
}
BMP_REFUSED = {"palette": "P", "1bit": "1"}


def _ppm(magic: bytes, px: np.ndarray, maxval: int) -> bytes:
    h, w = px.shape[:2]
    values = px[..., 0] if magic in (b"P2", b"P5") else px
    values = (values.astype(np.int64) * maxval // 255)
    head = magic + b"\n# written by hand\n%d %d # width height\n%d\n" % (w, h, maxval)
    if magic in (b"P5", b"P6"):
        return head + values.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    tokens = [str(v).encode() for v in values.reshape(-1)]
    return head + b"".join(b" ".join(tokens[i:i + 7]) + (b" # a comment\n" if i % 14 else b"\n")
                           for i in range(0, len(tokens), 7))


PPM_CASES = {
    "p6": lambda p, px: _pil(p, px, "RGB", "PPM"),
    "p5": lambda p, px: _pil(p, px, "L", "PPM"),
    "p6_maxval_100": lambda p, px: _write(p, _ppm(b"P6", px, 100)),
    "p6_16bit": lambda p, px: _write(p, _ppm(b"P6", px, 1000)),
    "p5_maxval_7": lambda p, px: _write(p, _ppm(b"P5", px, 7)),
    "p3_plain": lambda p, px: _write(p, _ppm(b"P3", px, 255)),
    "p2_plain_maxval_31": lambda p, px: _write(p, _ppm(b"P2", px, 31)),
    "p4_bitmap": lambda p, px: _pil(p, px, "1", "PPM"),
    "p5_16bit": lambda p, px: _pil(p, px[..., 0].astype(np.uint16) * 200, "I;16", "PPM"),
}
PPM_REFUSED = {"p4_bitmap": "1", "p5_16bit": "I"}


def _tga(px: np.ndarray, image_type: int, depth: int, flags: int) -> bytes:
    h, w = px.shape[:2]
    return struct.pack("<BBBHHBHHHHBB", 0, 0, image_type, 0, 0, 0, 0, 0, w, h, depth, flags) + px.tobytes()


TGA_CASES = {
    **{f"{mode}_{'rle' if rle else 'raw'}_{'top_down' if o > 0 else 'bottom_up'}":
       (lambda p, px, mode=mode, rle=rle, o=o: _pil(p, px, mode, "TGA", rle=rle, orientation=o,
                                                      id_section=b"an ID field" if rle else b""))
       for mode in ("RGB", "RGBA", "L") for rle in (False, True) for o in (-1, 1)},
    "rgb_right_to_left": lambda p, px: _write(p, _tga(px[..., ::-1], 2, 24, 0x10)),
    "rgba_16bit": lambda p, px: _write(p, _tga(px[..., :2], 2, 16, 0x30)),
    "palette": lambda p, px: _pil(p, px, "P", "TGA"),
    "la": lambda p, px: _pil(p, px, "LA", "TGA", rle=True),
    "1bit": lambda p, px: _pil(p, px, "1", "TGA"),
}
TGA_REFUSED = {"palette": "P", "la": "LA", "1bit": "1"}


def _pil_tiff(mode: str, compression=None, predictor: bool = False):
    info = {317: 2} if predictor else {}
    return lambda p, px: _pil(p, px, mode, "TIFF", compression=compression, tiffinfo=info)


TIFF_CASES = {
    **{f"{mode}_{c or 'raw'}": _pil_tiff(mode, c) for mode in ("RGB", "RGBA", "L")
       for c in (None, "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits")},
    "rgb_lzw_predictor": _pil_tiff("RGB", "tiff_lzw", predictor=True),
    "l_deflate_predictor": _pil_tiff("L", "tiff_adobe_deflate", predictor=True),
    "planar_rgb_raw": lambda p, px: _write(p, media.tiff_bytes(px, 2, planar=2, rows_per_strip=5)),
    "planar_rgba_lzw_predictor": lambda p, px: _write(p, media.tiff_bytes(np.dstack([px, px[..., :1]]), 2, (2,), 5,
                                                                          2, 2, 7)),
    "big_endian_rgb_deflate": lambda p, px: _write(p, media.tiff_bytes(px, 2, (), 32946, 2, 1, 3, True)),
    "white_is_zero_packbits": lambda p, px: _write(p, media.tiff_bytes(px[..., :1], 0, (), 32773)),
    "associated_alpha": lambda p, px: _write(p, media.tiff_bytes(np.dstack([px, px[..., 1:2]]), 2, (1,))),
    "rgb_extra_ignored": lambda p, px: _write(p, media.tiff_bytes(np.dstack([px, px[..., :1]]), 2, (0,), 5)),
    "orientation_6": lambda p, px: _write(p, media.tiff_bytes(px, 2, orientation=6)),
    "orientation_7_lzw": lambda p, px: _write(p, media.tiff_bytes(px, 2, (), 5, orientation=7)),
    "palette": _pil_tiff("P"),
    "la": _pil_tiff("LA", "tiff_lzw"),
    "bilevel": _pil_tiff("1"),
    "cmyk": _pil_tiff("CMYK"),
    "gray_16bit": lambda p, px: _pil(p, px[..., 0].astype(np.uint16) * 200, "I;16", "TIFF"),
}
TIFF_REFUSED = {"palette": "P", "la": "LA", "bilevel": "1", "cmyk": "CMYK", "gray_16bit": "I;16"}

GIF_CASES = {
    "grey_ramp": lambda p, px: _pil(p, np.tile(np.arange(256, dtype=np.uint8), (len(px), 1)), "L", "GIF"),
    "palette": lambda p, px: _pil(p, px, "RGB", "GIF"),
}
GIF_REFUSED = {"palette": "P"}

OTHER_CASES = [(fmt, name) for fmt, cases in (("bmp", BMP_CASES), ("ppm", PPM_CASES), ("tga", TGA_CASES),
                                               ("tif", TIFF_CASES), ("gif", GIF_CASES)) for name in sorted(cases)]
REFUSED = {"bmp": BMP_REFUSED, "ppm": PPM_REFUSED, "tga": TGA_REFUSED, "tif": TIFF_REFUSED, "gif": GIF_REFUSED}


@pytest.mark.parametrize("fmt,case", OTHER_CASES, ids=[f"{f}-{c}" for f, c in OTHER_CASES])
def test_still_matches_jax(tmp_path, fmt, case):
    write = {"bmp": BMP_CASES, "ppm": PPM_CASES, "tga": TGA_CASES, "tif": TIFF_CASES, "gif": GIF_CASES}[fmt][case]
    for i, (h, w) in enumerate(ODD_SIZES):
        path = write(tmp_path / f"x{i}.{fmt}", _pixels(h, w, seed=len(case) + i))
        assert _held(path) == REFUSED[fmt].get(case, "")


# ---- what the port refuses by name ----------------------------------------------

def _progressive_cut(data: bytes) -> bytes:
    return data[:_scans(data)[3]] + b"\xff\xd9"


def _jpeg_tiff() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_pixels(16, 16, seed=2)).save(buf, "TIFF", compression="jpeg")
    return buf.getvalue()


def _bmp_rle8_delta() -> bytes:
    return media.bmp_bytes((b"\x02\x07\x00\x02\x01\x00\x02\x05\x00\x00\x00\x01", (2, 2)), 8, 1, palette=GREY)


def _bmp_grey_4bit() -> bytes:
    rows = np.array([[0x12, 0x30]], np.uint8)
    return media.bmp_bytes(rows, 4, palette=np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, axis=1))


def _progressive() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_pixels(37, 53, seed=4)).save(buf, "JPEG", progressive=True)
    return buf.getvalue()


NAMED = {
    "progressive_unsent_bits": (lambda: _progressive_cut(_progressive()), "block smoothing"),
    "tiff_jpeg_compression": (_jpeg_tiff, "jpeg compression"),
    "tiff_tiled": (lambda: media.tiff_bytes(_pixels(6, 5, seed=1), 2, extra_tags=((322, 16),)), "tiles"),
    "tiff_fill_order_2": (lambda: media.tiff_bytes(_pixels(6, 5, seed=1), 2, extra_tags=((266, 2),)), "fill order"),
    "tiff_float_predictor": (lambda: media.tiff_bytes(_pixels(6, 5, seed=1), 2, (), 5, 3), "predictor 3"),
    "bmp_rle8_delta": (_bmp_rle8_delta, "delta escape"),
    "bmp_grey_4bit": (_bmp_grey_4bit, "4-bit grey"),
    "ppm_pil_rgba": (lambda: b"PyRGBA\n1 1\n255\n\x00\x00\x00\x00", "not ported"),
}


@pytest.mark.parametrize("case", sorted(NAMED))
def test_refused_by_name(tmp_path, case):
    """Files PIL opens as RGB, RGBA or L that the port does not decode: a
    ValueError naming the variant, never another decode."""
    make, match = NAMED[case]
    path = _write(tmp_path / f"{case}.bin", make())
    with Image.open(path) as im:
        assert im.mode in STILL_MODES
    with pytest.raises(ValueError, match=match):
        read_image(str(path))


def test_sniff_and_unknown_files(tmp_path):
    assert [sniff(h) for h in (b"II*\x00", b"MM\x00*", b"II+\x00", b"P6\n", b"P2 ", b"Pf", b"BM", b"\x00\x00\x02")] \
        == ["TIFF", "TIFF", "BigTIFF", "PPM", "PPM", "PPM", "BMP", "an unknown format"]
    path = _write(tmp_path / "text.txt", b"neither an image nor a TGA header\n")
    with pytest.raises(ValueError, match="Unsupported image format: an unknown format"):
        read_image(str(path))
    with pytest.raises(ValueError):
        jcommon.load_image_tensor(str(path), *TARGET)
    # The readers alone, without the caller's modes, decode every mode they port.
    px = _pixels(5, 7, seed=3)
    for decode, fmt, mode in ((decode_bmp, "BMP", "L"), (decode_ppm, "PPM", "RGB"), (decode_tga, "TGA", "RGBA"),
                              (decode_tiff, "TIFF", "RGB")):
        buf = io.BytesIO()
        Image.fromarray(px).convert(mode).save(buf, fmt)
        np.testing.assert_array_equal(decode(buf.getvalue()),
                                      np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))


# ---- the committed stills -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(media.STILLS))
def test_committed_still(tmp_path, name):
    """tests/fixtures_video's stills are what their recipes write here;
    media_io.json records PIL's mode and decode of each (the hashes
    chip_smoke.py holds the port to on the card's machine, which has no
    PIL); the port decodes each to them, or refuses it with that mode."""
    path = media.FIXTURES / name
    again = tmp_path / name
    media.write_still_fixture(again)
    assert again.read_bytes() == path.read_bytes()
    meta = media.committed_hashes()["stills"][name]
    mode, rgb = media.pil_still(path)
    assert (meta["mode"], meta["sha256_pil_rgb_uint8"], meta["sha256_file"]) == \
        (mode, media.sha256(rgb), media.file_sha256(path)) and mode == media.STILLS[name]
    if mode in STILL_MODES:
        assert media.sha256(read_image(str(path))) == meta["sha256_pil_rgb_uint8"]
    else:
        with pytest.raises(ValueError, match=f"Unsupported image format: {mode}\\."):
            read_image(str(path))
    if name.endswith(".png"):
        assert media.sha256(read_png(str(path))) == meta["sha256_pil_rgb_uint8"]
    assert sum((media.FIXTURES / n).stat().st_size for n in media.STILLS) < 600_000
