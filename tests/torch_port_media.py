"""The recipes of the media fixtures in tests/fixtures_video/ that the
media I/O tests (tests/test_torch_port_jpeg_encode.py, _mjpeg_writers.py,
_gif_apng.py, _canny.py) and chip_smoke.py share, and the hashes their
JSON files record, computed here with PIL, OpenCV and the JAX package's
writers (the card's machine has none of them, so chip_smoke.py holds the
port against these recorded hashes).

- `gif_96x144x9.gif`: 9 frames of a noisy sinusoid background (seed 31)
  with a block moving over it, saved by PIL (`save_all`, 40 ms, loop 0):
  PIL writes sub-rectangles after the first frame.
- `apng_96x144x9.apng`: the same frames with an alpha channel (a
  transparent stripe, a half-transparent block), saved by PIL as an APNG
  with dispose_op 0, 1, 2 and blend_op 0, 1 cycling over the frames.
- the WebP fixtures (`WEBPS`), written by PIL from the same frames: a
  lossy still at 256x384 (the frames' recipe at that size), a lossless
  still with alpha, a lossy animation with alpha and a lossless animation
  at 96x144x9.
- the stills (`STILLS`, `write_still_fixture`): a 512x768 progressive
  JPEG with an EXIF orientation tag, a 16-bit RGB PNG, an Adam7 palette
  PNG, a BMP, an RLE TGA and an LZW TIFF with the horizontal predictor, at
  96x144 but the JPEG.
- `media_io.json`: the SHA-256 of PIL's decoded frames of both files (and
  of each WebP fixture's frames, under "webp"; of each still's
  `convert("RGB")`, with its mode, under "stills"), of
  PIL's JPEGs (quality 92) of the committed AVI's 9 decoded frames, of the
  JAX package's `.avi`, `.mp4` and `.mov` of those frames with
  `fixture_audio()`, and of OpenCV's Canny (LANCZOS4 to 256x384, BGR2GRAY,
  Canny 20 / 60 and 100 / 200) of those frames, and of the JAX writer's
  `.control.avi` of the 20 / 60 signal padded to 121 frames.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).parent / "fixtures_video"
AVI = FIXTURES / "pattern_288x432x9.avi"
GIF = FIXTURES / "gif_96x144x9.gif"
APNG = FIXTURES / "apng_96x144x9.apng"
MEDIA_JSON = FIXTURES / "media_io.json"
# name -> (PIL's save options, still or animated, with alpha)
WEBPS = {
    "webp_lossy_256x384.webp": ({"quality": 80, "method": 4}, False, False),
    "webp_lossless_alpha_96x144.webp": ({"lossless": True, "quality": 60, "exact": True}, False, True),
    "webp_lossy_alpha_96x144x9.webp": ({"quality": 75, "duration": 40, "loop": 0}, True, True),
    "webp_lossless_96x144x9.webp": ({"lossless": True, "quality": 50, "duration": 40, "loop": 0}, True, False),
}
CANNY_SIZE = (256, 384)  # stage 1's size at 512x768
CANNY_THRESHOLDS = ((20, 60), (100, 200))
CONTROL_FRAMES = 121


# ---- stills written by hand (PIL writes neither sub-byte gray, 16-bit colour, Adam7 nor these TIFFs) ----

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filtered_rows(samples: np.ndarray, depth: int, first_filter: int) -> bytes:
    """(h, w, c) samples packed at `depth` bits MSB first, each row filtered
    with filter (first_filter + row) % 5 at bpp = max(1, depth * c // 8)."""
    h, w, c = samples.shape
    if depth == 16:
        packed = samples.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        packed = samples.astype(np.uint8).reshape(h, -1)
    else:
        bits = (samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
        packed = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    bpp = max(1, depth * c // 8)
    cur = packed.astype(np.int64)
    up = np.vstack([np.zeros((1, cur.shape[1]), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), cur[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    preds = [np.zeros_like(cur), left, up, (left + up) >> 1,
             np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))]
    out = b""
    for y in range(h):
        f = (first_filter + y) % 5
        out += bytes([f]) + ((cur[y] - preds[f][y]) & 255).astype(np.uint8).tobytes()
    return out


def png_bytes(samples: np.ndarray, depth: int, color: int, interlace: bool = False, palette=None,
              trns: bytes = None) -> bytes:
    """A PNG of (h, w, c) integer samples at any depth and color type,
    Adam7 or not, every row filter used, written with struct and zlib."""
    h, w, _ = samples.shape
    return (_png_head(w, h, depth, color, interlace, palette, trns)
            + _png_chunk(b"IDAT", _png_image_data(samples, depth, interlace)) + _png_chunk(b"IEND", b""))


def _png_head(w: int, h: int, depth: int, color: int, interlace: bool, palette, trns) -> bytes:
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out


def _png_image_data(samples: np.ndarray, depth: int, interlace: bool) -> bytes:
    """The compressed rows of one image: Adam7's passes one after another."""
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(_filtered_rows(samples[y0::dy, x0::dx], depth, i) for i, (x0, y0, dx, dy) in enumerate(ADAM7)
                       if x0 < w and y0 < h)
    else:
        raw = _filtered_rows(samples, depth, 0)
    return zlib.compress(raw, 9)


def apng_bytes(frames: list, depth: int, color: int, interlace: bool = False, palette=None, trns: bytes = None,
               dispose=(0,), blend=(0,)) -> bytes:
    """An APNG of (h, w, c) integer sample frames, each over the whole
    canvas, dispose_op and blend_op cycling through `dispose` and `blend`."""
    h, w, _ = frames[0].shape
    out = _png_head(w, h, depth, color, interlace, palette, trns)
    out += _png_chunk(b"acTL", struct.pack(">II", len(frames), 0))
    seq = 0
    for i, frame in enumerate(frames):
        out += _png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, 25, dispose[i % len(dispose)],
                                               blend[i % len(blend)]))
        seq += 1
        data = _png_image_data(frame, depth, interlace)
        if i == 0:
            out += _png_chunk(b"IDAT", data)
        else:
            out += _png_chunk(b"fdAT", struct.pack(">I", seq) + data)
            seq += 1
    return out + _png_chunk(b"IEND", b"")


def tiff_bytes(pixels: np.ndarray, photometric: int, extra=(), compression: int = 1, predictor: int = 1,
               planar: int = 1, rows_per_strip: int = 16, big_endian: bool = False, orientation: int = None,
               extra_tags=()) -> bytes:
    """A TIFF of (h, w, c) uint8 samples in strips, written with struct:
    uncompressed (1), LZW (5, literal codes with a clear every 250), Deflate
    (8 or 32946) or PackBits (32773, literal runs), the horizontal
    predictor (2) applied before LZW or Deflate, contiguous or planar;
    `extra_tags` adds (tag, SHORT value) entries."""
    o = ">" if big_endian else "<"
    h, w, c = pixels.shape
    planes = [pixels] if planar == 1 else [pixels[..., i:i + 1] for i in range(c)]
    strips = []
    for plane in planes:
        for y in range(0, h, rows_per_strip):
            block = plane[y:y + rows_per_strip].astype(np.uint8)
            if predictor == 2:
                block = np.concatenate([block[:, :1], np.diff(block, axis=1)], axis=1).astype(np.uint8)
            raw = block.tobytes()
            if compression == 5:
                raw = _tiff_lzw_literals(raw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = b"".join(bytes([len(raw[i:i + 128]) - 1]) + raw[i:i + 128] for i in range(0, len(raw), 128))
            strips.append(raw)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * c), (259, 3, [compression]), (262, 3, [photometric]),
               (273, 4, None), (277, 3, [c]), (278, 4, [rows_per_strip]), (279, 4, [len(s) for s in strips]),
               (284, 3, [planar])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra:
        entries.append((338, 3, list(extra)))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    entries += [(tag, 3, [value]) for tag, value in extra_tags]
    entries.sort(key=lambda e: e[0])
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(o + "I", 8)
    ifd_size = 2 + 12 * len(entries) + 4
    extra_at = 8 + ifd_size
    blobs, fields = b"", []
    sizes = [len(v) * (2 if t == 3 else 4) for _, t, v in entries if v]
    strip_at = extra_at + sum(n for n in sizes if n > 4)
    strip_at += 4 * len(strips) if len(strips) > 1 else 0
    offsets, at = [], strip_at
    for s in strips:
        offsets.append(at)
        at += len(s)
    for tag, kind, values in entries:
        values = offsets if values is None else values
        fmt = o + ("H" if kind == 3 else "I") * len(values)
        payload = struct.pack(fmt, *values)
        if len(payload) <= 4:
            fields.append(struct.pack(o + "HHI", tag, kind, len(values)) + payload.ljust(4, b"\x00"))
        else:
            fields.append(struct.pack(o + "HHII", tag, kind, len(values), extra_at + len(blobs)))
            blobs += payload
    ifd = struct.pack(o + "H", len(entries)) + b"".join(fields) + struct.pack(o + "I", 0)
    out = head + ifd + blobs
    assert len(out) == strip_at, (len(out), strip_at)
    return out + b"".join(strips)


def _tiff_lzw_literals(raw: bytes) -> bytes:
    """TIFF LZW of literal codes only: a clear code, then each byte, a clear
    code again before the table would widen the codes past 9 bits (the
    decoder still adds an entry per code), then EndOfInformation."""
    codes = [256]
    for i, b in enumerate(raw):
        if i and i % 250 == 0:
            codes.append(256)
        codes.append(b)
    codes.append(257)
    bits = "".join(format(c, "09b") for c in codes)
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def bmp_bytes(rows: np.ndarray, bits: int, compression: int = 0, masks=None, top_down: bool = False,
              palette: np.ndarray = None, header: int = 40) -> bytes:
    """A BMP of already-packed pixel rows ((h, row_bytes) uint8, or an RLE8
    byte string with `compression` 1), written with struct."""
    if compression == 1:
        data, (h, w) = rows
    else:
        h, row_bytes = rows.shape
        w = row_bytes * 8 // bits
        stride = ((w * bits + 31) >> 3) & ~3
        padded = np.zeros((h, stride), np.uint8)
        padded[:, :row_bytes] = rows
        data = (padded if top_down else padded[::-1]).tobytes()
    pal = b"" if palette is None else np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                                                       np.zeros((len(palette), 1), np.uint8)], 1).tobytes()
    mask_bytes = b"" if masks is None else struct.pack("<" + "I" * len(masks), *masks)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(data),
                           2835, 2835, 0 if palette is None else len(palette), 0)
        info = (info + (mask_bytes if header > 40 else b"")).ljust(header, b"\x00")
        if header == 40:
            info += mask_bytes
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + pal + data


def sha256(array) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def anim_frames(seed: int = 31, frames: int = 9, height: int = 96, width: int = 144) -> np.ndarray:
    """uint8 (F, H, W, 4): a noisy sinusoid background, fixed, with a 24x32
    block of its own colours moving right and down; alpha 255 but for a
    transparent stripe (rows 10-13) and the block at 128 on odd frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(2 * np.pi * xx / width), 128 + 100 * np.cos(2 * np.pi * yy / height),
                     128 + 90 * np.sin(2 * np.pi * (xx + yy) / (width + height))], -1)
    background = np.clip(np.round(base + rng.normal(0, 6, base.shape)), 0, 255).astype(np.uint8)
    block = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    out = np.empty((frames, height, width, 4), np.uint8)
    for t in range(frames):
        out[t, ..., :3] = background
        out[t, ..., 3] = 255
        y0, x0 = 4 + 6 * t, 8 + 10 * t
        out[t, y0:y0 + 24, x0:x0 + 32, :3] = block
        out[t, 10:14, :, 3] = 0
        if t % 2:
            out[t, y0:y0 + 24, x0:x0 + 32, 3] = 128
    return out


def write_gif_fixture(path) -> None:
    from PIL import Image

    images = [Image.fromarray(f[..., :3]) for f in anim_frames()]
    images[0].save(path, save_all=True, append_images=images[1:], duration=40, loop=0)


def write_apng_fixture(path) -> None:
    from PIL import Image

    images = [Image.fromarray(f, "RGBA") for f in anim_frames()]
    images[0].save(path, format="PNG", save_all=True, append_images=images[1:], duration=[40, 50] * 4 + [40],
                   loop=0, disposal=[0, 1, 2] * 3, blend=[0, 1] * 4 + [1])


def write_webp_fixture(path) -> None:
    """The WebP fixture `path.name` of WEBPS, written by PIL."""
    from PIL import Image

    options, animated, alpha = WEBPS[Path(path).name]
    frames = anim_frames(height=256, width=384)[:1] if "256x384" in Path(path).name else anim_frames()
    images = [Image.fromarray(f if alpha else f[..., :3], "RGBA" if alpha else "RGB") for f in frames]
    if animated:
        images[0].save(path, format="WEBP", save_all=True, append_images=images[1:], **options)
    else:
        images[1 if len(images) > 1 else 0].save(path, format="WEBP", **options)


# The committed stills (`write_still_fixture`): name -> what PIL opens it as.
STILLS = {
    "still_progressive_512x768.jpg": "RGB",  # progressive, 4:2:0, optimized tables, EXIF orientation 6
    "still_rgb16_96x144.png": "RGB",  # 16-bit RGB, every row filter
    "still_palette_adam7_96x144.png": "P",  # 8-bit palette, Adam7: refused by the still path
    "still_96x144.bmp": "RGB",  # 24-bit, bottom-up
    "still_rle_96x144.tga": "RGB",  # 24-bit, RLE, an ID field
    "still_lzw_predictor_96x144.tif": "RGB",  # LZW with the horizontal predictor
}


def still_pixels(height: int, width: int) -> np.ndarray:
    """uint8 (H, W, 3): frame 0 of `anim_frames` at that size."""
    return np.ascontiguousarray(anim_frames(frames=1, height=height, width=width)[0, ..., :3])


def write_still_fixture(path) -> None:
    """The committed still `path.name` of STILLS: written by PIL, or by
    hand where PIL writes no such file (16-bit colour, Adam7)."""
    from PIL import Image

    name = Path(path).name
    if name.endswith(".jpg"):
        exif = Image.Exif()
        exif[0x0112] = 6
        Image.fromarray(still_pixels(512, 768)).save(path, "JPEG", quality=90, progressive=True, optimize=True,
                                                     subsampling="4:2:0", exif=exif)
        return
    px = still_pixels(96, 144)
    if name == "still_rgb16_96x144.png":
        Path(path).write_bytes(png_bytes(px.astype(np.uint16) * 257 + np.arange(144, dtype=np.uint16)[:, None], 16, 2))
    elif name == "still_palette_adam7_96x144.png":
        indexed = Image.fromarray(px).quantize(64)
        palette = np.asarray(indexed.getpalette()[:192], np.uint8).reshape(64, 3)
        Path(path).write_bytes(png_bytes(np.asarray(indexed)[..., None], 8, 3, interlace=True, palette=palette))
    elif name.endswith(".bmp"):
        Image.fromarray(px).save(path, "BMP")
    elif name.endswith(".tga"):
        Image.fromarray(px).save(path, "TGA", rle=True, id_section=b"a still for the TGA reader")
    else:
        Image.fromarray(px).save(path, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})


def pil_still(path):
    """(PIL's mode, `convert("RGB")` as uint8) of a still."""
    from PIL import Image

    with Image.open(path) as im:
        return im.mode, np.asarray(im.convert("RGB"))


def pil_frames(path) -> np.ndarray:
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])


def avi_frames() -> np.ndarray:
    """The committed AVI's 9 frames as PIL decodes them (the port's decoder
    gives the same, tests/test_torch_port_video_io.py holds it to that)."""
    from PIL import Image

    from ltx2_tpu_torch.utils.video_io import _avi_chunks

    data = AVI.read_bytes()
    return np.stack([np.asarray(Image.open(io.BytesIO(data[o:o + n])).convert("RGB"))
                     for fourcc, o, n in _avi_chunks(data) if fourcc == b"00dc"])


def fixture_audio(frames: int = 9, rate: int = 24000, fps: float = 24.0) -> np.ndarray:
    """(2, N) float32 in [-1, 1], N one clip's worth at `rate`: two
    sawtooths made of integers (no transcendental function, so every
    machine draws the same samples)."""
    n = int(round(frames / fps * rate))
    i = np.arange(n, dtype=np.int64)
    return np.stack([((i * 37) % 2001 - 1000) / 1000.0, ((i * 11) % 1201 - 600) / 640.0]).astype(np.float32)


def pil_jpeg(frame: np.ndarray, quality: int = 92) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def cv2_canny(frames_rgb: np.ndarray, low: int, high: int, size=CANNY_SIZE) -> np.ndarray:
    """OpenCV's Canny signal of RGB frames as the JAX package computes it
    from BGR frames: (F, H, W, 3) uint8."""
    import cv2

    out = []
    for f in frames_rgb:
        small = cv2.resize(np.ascontiguousarray(f[..., ::-1]), (size[1], size[0]), interpolation=cv2.INTER_LANCZOS4)
        edges = cv2.Canny(cv2.cvtColor(small, cv2.COLOR_BGR2GRAY), low, high)
        out.append(cv2.cvtColor(edges, cv2.COLOR_GRAY2RGB))
    return np.stack(out)


def control_signal_u8(signal: np.ndarray, frames: int = CONTROL_FRAMES) -> np.ndarray:
    """A Canny signal padded with its last frame to `frames`, through the
    float tensor and back to uint8 as `create_video_conditionings` writes
    it for save_control."""
    padded = np.concatenate([signal, np.repeat(signal[-1:], frames - len(signal), axis=0)])
    tensor = (padded.astype(np.float32) / 127.5 - 1.0).transpose(3, 0, 1, 2)[None]
    return ((tensor[0].transpose(1, 2, 3, 0) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)


def file_sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def media_hashes(tmp_dir) -> dict:
    """Every hash of media_io.json, computed here (PIL, cv2, the JAX
    package's writers)."""
    from ltx2_tpu.utils import video_io as jvio

    tmp_dir = Path(tmp_dir)
    frames = avi_frames()
    audio = fixture_audio()
    rec = {"made_by": "tests/torch_port_media.py::media_hashes (PIL 12.1, libjpeg-turbo 6.2 API, OpenCV 5.0, "
                      "the JAX package's writers)",
           "gif": {"file": GIF.name, "sha256_file": file_sha256(GIF), "sha256_pil_frames_uint8": sha256(pil_frames(GIF)),
                   "frames": 9, "duration_ms": 40},
           "apng": {"file": APNG.name, "sha256_file": file_sha256(APNG),
                    "sha256_pil_frames_uint8": sha256(pil_frames(APNG)), "frames": 9, "duration_ms": 40.0},
           "avi_frames_sha256": sha256(frames),
           "jpeg_q92_sha256": [hashlib.sha256(pil_jpeg(f)).hexdigest() for f in frames],
           "audio": {"rate": 24000, "shape": list(audio.shape), "sha256_float32": sha256(audio)},
           "writers": {}, "canny": {}, "webp": {}, "stills": {}}
    for name in WEBPS:
        path = FIXTURES / name
        pil = pil_frames(path)
        rec["webp"][name] = {"sha256_file": file_sha256(path), "sha256_pil_frames_uint8": sha256(pil),
                             "frames": len(pil), "height": pil.shape[1], "width": pil.shape[2]}
    for name in STILLS:
        mode, rgb = pil_still(FIXTURES / name)
        rec["stills"][name] = {"sha256_file": file_sha256(FIXTURES / name), "mode": mode,
                               "sha256_pil_rgb_uint8": sha256(rgb), "height": rgb.shape[0], "width": rgb.shape[1]}
    for suffix in ("avi", "mp4", "mov"):
        for with_audio in (False, True):
            path = tmp_dir / f"w.{suffix}"
            writer = jvio.write_avi_mjpeg if suffix == "avi" else jvio.write_mp4_mjpeg
            writer(str(path), frames, 24.0, audio=audio if with_audio else None, sample_rate=24000)
            rec["writers"][f"{suffix}{'_audio' if with_audio else ''}"] = file_sha256(path)
    for low, high in CANNY_THRESHOLDS:
        signal = cv2_canny(frames, low, high)
        rec["canny"][f"{low}_{high}"] = {"sha256_uint8": sha256(signal), "edge_pixels": int((signal[..., 0] > 0).sum())}
    signal = control_signal_u8(cv2_canny(frames, *CANNY_THRESHOLDS[0]))
    control = tmp_dir / "control.avi"
    jvio.write_avi_mjpeg(str(control), signal, fps=24.0)
    rec["control_avi_20_60_sha256"] = file_sha256(control)
    return rec


def committed_hashes() -> dict:
    return json.loads(MEDIA_JSON.read_text())
