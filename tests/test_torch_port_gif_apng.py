"""The port's GIF and APNG readers (ltx2_tpu_torch/utils/gif.py,
utils/image_io.py `read_apng`) and GIF writer against PIL 12 and the JAX
package's PIL path (ltx2_tpu/utils/video_io.py `read_pil_animation`,
`probe_video`), on the CPU, bit for bit (tolerance none):

- GIFs PIL writes: RGB clips (adaptive local palettes, the rectangles that
  changed, interlaced rows), the disposal methods 0-3, a transparent
  index, grey (L) and small-palette (2- and 4-bit codes) clips;
- GIFs built byte by byte here with an LZW coder of the test's own:
  disposal 3 over a transparent first frame, disposal 2 to the background
  colour, a global table with local ones, an identity grey table (Pillow's
  mode "L"), interlacing, GIF87a, a frame without a graphic control
  block, a clear code mid-image and a full code table; data that ends, or
  an end code that comes, before the image's last pixel raising as in PIL;
- APNGs PIL writes in RGBA, RGB, palette (with tRNS), L and LA, with every
  dispose_op and blend_op, with a default image;
- each file through `read_video_any` and `probe_video` against the JAX
  package's, and the frames `decode_gif` / `read_apng` give against PIL's;
- `write_gif`: a GIF89a PIL reads back (frames, delay, loop) whose frames
  the port's decoder reads as PIL does;
- the committed fixtures (tests/fixtures_video/gif_96x144x9.gif,
  apng_96x144x9.apng, media_io.json): rewritten by their recipes byte for
  byte, every recorded hash recomputed with PIL, OpenCV and the JAX
  writers, and the port's decodes against the recorded SHA-256s.
"""

import json
import struct

import numpy as np
import pytest
from PIL import Image

from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch.utils import gif as G
from ltx2_tpu_torch.utils import video_io as vio
from ltx2_tpu_torch.utils.image_io import apng_info, read_apng
from tests import torch_port_media as media
from tests.torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def _same_as_jax(path: str, frames: int) -> None:
    """read_video_any at the file's size and resized, probe_video, and the
    raw frames, each equal to the JAX package's / PIL's."""
    fps, n, h, w = jvio.probe_video(path)
    assert vio.probe_video(path) == (fps, n, h, w)
    for size in ((h, w, frames), (h // 2 + 3, w + 5, frames + 2)):
        np.testing.assert_array_equal(vio.read_video_any(path, *size), jvio.read_video_any(path, *size))
    got = vio._animation_frames(path)
    ref = media.pil_frames(path)
    assert len(got) == len(ref) == n
    np.testing.assert_array_equal(np.stack(got), ref)


def _rgb_clip(frames: int, h: int, w: int, seed: int, moving_block: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    out = []
    for t in range(frames):
        f = base.copy()
        if moving_block:
            f[2 + t:8 + t, 3 + 2 * t:11 + 2 * t] = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
        else:
            f = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out.append(f)
    return np.stack(out)


PIL_GIF_CASES = {
    "rgb_subrects": dict(),
    "rgb_full_frames": dict(moving_block=False),
    "disposal_1": dict(disposal=1),
    "disposal_2": dict(disposal=2),
    "disposal_3": dict(disposal=3),
    "disposal_mixed": dict(disposal=[0, 2, 3, 1, 2]),
    "transparency": dict(transparency=0),
    "transparency_disposal_2": dict(transparency=0, disposal=2),
    "grey": dict(mode="L"),
    "four_colours": dict(mode="P4"),
    "two_colours": dict(mode="P2"),
    "small_not_interlaced": dict(size=(13, 22)),
}


@pytest.mark.parametrize("case", list(PIL_GIF_CASES))
def test_pil_written_gifs(tmp_path, case):
    opts = dict(PIL_GIF_CASES[case])
    mode, size = opts.pop("mode", None), opts.pop("size", (30, 44))
    clip = _rgb_clip(5, *size, seed=len(case), moving_block=opts.pop("moving_block", True))
    images = [Image.fromarray(f) for f in clip]
    if mode == "L":
        images = [im.convert("L") for im in images]
    elif mode in ("P4", "P2"):
        palette = Image.new("P", (1, 1))
        colours = [255, 0, 0, 0, 255, 0, 0, 0, 255, 250, 250, 250][:3 * int(mode[1])]
        palette.putpalette(colours)
        images = [im.quantize(palette=palette, dither=Image.Dither.NONE) for im in images]
    path = str(tmp_path / f"{case}.gif")
    images[0].save(path, save_all=True, append_images=images[1:], duration=[30, 40, 50, 60, 70], loop=2, **opts)
    _same_as_jax(path, 5)


# ---- GIFs built byte by byte ------------------------------------------------------


def _lzw(indices, min_size: int, clear_every: int = 0) -> bytes:
    """A plain GIF LZW coder (a dictionary of strings, codes growing to 12
    bits, a clear code when the table fills or every `clear_every` codes)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    codes = [clear]
    table = {bytes([i]): i for i in range(clear)}
    nxt, w, emitted = clear + 2, b"", 0
    for k in bytes(np.asarray(indices, np.uint8).ravel()):
        wk = w + bytes([k])
        if wk in table:
            w = wk
            continue
        codes.append(table[w])
        emitted += 1
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
        w = bytes([k])
        if clear_every and emitted % clear_every == 0:
            codes.append(clear)
            table = {bytes([i]): i for i in range(clear)}
            nxt = clear + 2
    if w:
        codes.append(table[w])
    codes.append(end)
    # Sizes as the decoder grows them: after each code that adds an entry.
    out, acc, nbits, size, dec_next, first = bytearray(), 0, 0, min_size + 1, clear + 2, True
    for code in codes:
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        if code == clear:
            size, dec_next, first = min_size + 1, clear + 2, True
        elif code != end:
            if not first and dec_next < 4096:
                dec_next += 1
            first = False
            if dec_next == (1 << size) and size < 12:
                size += 1
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def _interlaced(indices: np.ndarray) -> np.ndarray:
    h = indices.shape[0]
    order = np.concatenate([np.arange(s, h, step) for s, step in ((0, 8), (4, 8), (2, 4), (1, 2))])
    return indices[order]


def _build_gif(width, height, frames, global_palette=None, background=0, version=b"GIF89a") -> bytes:
    """frames: dicts of `indices` (h, w), and optional `pos`, `palette`,
    `transparency`, `disposal`, `delay`, `interlace`, `gce` (False: no
    graphic control block), `min_size`, `pixels` (how many are coded before
    the end code), `truncate` (bytes of LZW data kept), `clear_every`."""
    flags = 0
    out = bytearray(version + struct.pack("<HH", width, height))
    if global_palette is not None:
        bits = int(np.log2(len(global_palette))) - 1
        flags = 0x80 | bits
    out += bytes([flags, background, 0])
    if global_palette is not None:
        out += np.asarray(global_palette, np.uint8).tobytes()
    for fr in frames:
        if fr.get("gce", True):
            packed = (fr.get("disposal", 0) << 2) | (1 if fr.get("transparency") is not None else 0)
            out += b"\x21\xf9\x04" + bytes([packed]) + struct.pack("<H", fr.get("delay", 4)) + \
                bytes([fr.get("transparency") or 0, 0])
        idx = np.asarray(fr["indices"], np.uint8)
        h, w = idx.shape
        x0, y0 = fr.get("pos", (0, 0))
        iflags = 0x40 if fr.get("interlace") else 0
        palette = fr.get("palette")
        if palette is not None:
            iflags |= 0x80 | (int(np.log2(len(palette))) - 1)
        out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, iflags)
        if palette is not None:
            out += np.asarray(palette, np.uint8).tobytes()
        min_size = fr.get("min_size", 8)
        stored = (_interlaced(idx) if fr.get("interlace") else idx).ravel()[:fr.get("pixels")]
        data = _lzw(stored, min_size, fr.get("clear_every", 0))
        if "truncate" in fr:
            data = data[:fr["truncate"]]
        out += bytes([min_size]) + _sub_blocks(data)
    return bytes(out + b"\x3b")


def _pal(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3), dtype=np.uint8)


def _idx(h, w, n, seed):
    return np.random.default_rng(seed).integers(0, n, (h, w), dtype=np.uint8)


BUILT_GIFS = {
    "disposal_3_transparent_first": lambda: _build_gif(20, 16, [
        dict(indices=_idx(16, 20, 16, 1), transparency=3, disposal=3, palette=_pal(16, 2), min_size=4),
        dict(indices=_idx(6, 8, 16, 3), pos=(4, 5), transparency=5, disposal=3, palette=_pal(16, 4), min_size=4),
        dict(indices=_idx(7, 9, 16, 5), pos=(10, 2), disposal=1, palette=_pal(16, 6), min_size=4),
        dict(indices=_idx(5, 5, 16, 7), pos=(1, 1), transparency=0, palette=_pal(16, 8), min_size=4)]),
    "disposal_2_background": lambda: _build_gif(24, 18, [
        dict(indices=_idx(18, 24, 8, 1), disposal=2, min_size=3),
        dict(indices=_idx(9, 10, 8, 2), pos=(3, 4), disposal=2, min_size=3),
        dict(indices=_idx(9, 10, 8, 3), pos=(12, 6), disposal=0, min_size=3, palette=_pal(8, 9)),
        dict(indices=_idx(4, 4, 8, 4), pos=(0, 0), min_size=3)], global_palette=_pal(8, 10), background=6),
    "sticky_disposal": lambda: _build_gif(16, 16, [
        dict(indices=_idx(16, 16, 4, 1), disposal=2, transparency=1, min_size=2),
        dict(indices=_idx(8, 8, 4, 2), pos=(2, 2), gce=False, min_size=2),
        dict(indices=_idx(8, 8, 4, 3), pos=(6, 6), disposal=0, min_size=2),
        dict(indices=_idx(8, 8, 4, 4), pos=(4, 1), min_size=2)], global_palette=_pal(4, 11)),
    "grey_identity_table": lambda: _build_gif(12, 10, [
        dict(indices=_idx(10, 12, 16, 1), min_size=4, transparency=2, disposal=2),
        dict(indices=_idx(5, 6, 16, 2), pos=(3, 3), min_size=4, transparency=7)],
        global_palette=np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, axis=1)),
    "interlaced": lambda: _build_gif(23, 37, [
        dict(indices=_idx(37, 23, 256, 1), interlace=True, palette=_pal(256, 2)),
        dict(indices=_idx(13, 11, 256, 3), pos=(5, 9), interlace=True, palette=_pal(256, 4), transparency=9)]),
    "gif87a_global": lambda: _build_gif(10, 10, [dict(indices=_idx(10, 10, 2, 1), min_size=2, gce=False)],
                                        global_palette=_pal(2, 3), version=b"GIF87a"),
    "clears_and_a_full_table": lambda: _build_gif(96, 80, [
        dict(indices=_idx(80, 96, 256, 1), clear_every=700, palette=_pal(256, 5)),
        dict(indices=np.tile(_idx(1, 96, 40, 2), (80, 1)), palette=_pal(256, 6))]),
}


@pytest.mark.parametrize("case", list(BUILT_GIFS))
def test_gifs_built_byte_by_byte(tmp_path, case):
    data = BUILT_GIFS[case]()
    path = str(tmp_path / f"{case}.gif")
    with open(path, "wb") as fh:
        fh.write(data)
    _same_as_jax(path, 2)


@pytest.mark.parametrize("cut", [dict(truncate=40), dict(pixels=70)])
def test_truncated_gif_data_raises(tmp_path, cut):
    """Image data that ends before its end code, or an end code before the
    image's last pixel: PIL raises (OSError, "broken data stream" / "image
    file is truncated"), and so does the port (ValueError)."""
    path = str(tmp_path / "truncated.gif")
    with open(path, "wb") as fh:
        fh.write(_build_gif(16, 12, [dict(indices=_idx(12, 16, 16, 1), min_size=4, palette=_pal(16, 1), **cut)]))
    with pytest.raises(OSError):
        jvio.read_video_any(path, 12, 16, 1)
    with pytest.raises(ValueError, match="truncated"):
        vio.read_video_any(path, 12, 16, 1)


# ---- APNG ---------------------------------------------------------------------------


def _rgba_clip(frames: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)]
    for t in range(1, frames):
        f = out[-1].copy()
        f[2 + t:8 + t, 3 + 2 * t:12 + 2 * t] = rng.integers(0, 256, (6, 9, 4), dtype=np.uint8)
        f[4:6, :, 3] = 0
        f[t:t + 3, :5, 3] = 255
        out.append(f)
    return np.stack(out)


# Every dispose_op and blend_op in RGBA, RGB and LA; PIL's APNG writer
# cannot dispose the frames of an L image, or of a palette image with a
# transparent index, to the background or the previous one ("images do not
# match"), so L and P take dispose_op 0.
DISPOSE_OPS = [0, 1, 2, [2, 1, 0, 2, 1]]
BLEND_OPS = [0, 1, [1, 0, 1, 1, 0]]
APNG_CASES = [(mode, d, b) for mode, ops in (("RGBA", DISPOSE_OPS), ("RGB", DISPOSE_OPS), ("LA", DISPOSE_OPS),
                                            ("P", [0]), ("L", [0])) for d in ops for b in BLEND_OPS]


@pytest.mark.parametrize("mode,dispose,blend", APNG_CASES)
def test_pil_written_apngs(tmp_path, mode, dispose, blend):
    clip = _rgba_clip(5, 20, 28, seed=3)
    images = [Image.fromarray(f, "RGBA") for f in clip]
    extra = {}
    if mode == "P":
        palette = images[0].convert("RGB").quantize(32)
        images = [im.convert("RGB").quantize(palette=palette, dither=Image.Dither.NONE) for im in images]
        extra["transparency"] = 2
    elif mode != "RGBA":
        images = [im.convert(mode) for im in images]
    for default in (False, True):
        path = str(tmp_path / f"{mode}_{default}.apng")
        images[0].save(path, format="PNG", save_all=True, append_images=images[1:], duration=[40, 50, 60, 70, 80],
                       loop=0, disposal=dispose, blend=blend, default_image=default, **extra)
        _same_as_jax(path, 5)
        # The same file named .png (acTL) takes the same route.
        as_png = path[:-5] + ".png"
        with open(path, "rb") as src, open(as_png, "wb") as dst:
            dst.write(src.read())
        np.testing.assert_array_equal(vio.read_video_any(as_png, 20, 28, 5), jvio.read_video_any(as_png, 20, 28, 5))
        assert apng_info(path)[:3] == (28, 20, 5)  # with default_image, the first image is not a frame


def test_unsupported_pngs_raise_by_name(tmp_path):
    path = str(tmp_path / "deep.apng")
    images = [Image.fromarray(np.full((8, 8), v * 257, np.uint16)) for v in (10, 200)]
    images[0].save(path, format="PNG", save_all=True, append_images=images[1:])
    with pytest.raises(ValueError, match="16-bit APNG"):
        read_apng(path)


# ---- writing ----------------------------------------------------------------------


def test_write_gif_reads_back_in_pil(tmp_path):
    clip = _rgb_clip(6, 40, 56, seed=9)
    path = str(tmp_path / "preview.gif")
    G.write_gif(path, clip, 41)
    with Image.open(path) as im:
        assert (im.format, im.n_frames, im.info["duration"], im.info["loop"], im.size) == ("GIF", 6, 40, 0, (56, 40))
        assert im.info["version"] == b"GIF89a"
    ref = media.pil_frames(path)
    np.testing.assert_array_equal(np.stack(G.decode_gif(open(path, "rb").read())), ref)
    # Each frame is its own palette's nearest-bin colours: far from exact on
    # noise (256 colours for 40 x 56 random pixels), but bounded.
    rms = np.sqrt(np.mean((ref.astype(float) - clip) ** 2))
    assert rms < 20.0
    # A frame of few colours comes back exactly.
    flat = np.zeros((3, 16, 16, 3), np.uint8)
    flat[:, :8] = (200, 10, 30)
    flat[1, 8:] = (5, 250, 90)
    G.write_gif(path, flat, 100)
    np.testing.assert_array_equal(media.pil_frames(path), flat)


def test_lzw_literals_reads_back():
    rng = np.random.default_rng(0)
    for n in (1, 253, 254, 255, 509, 5000):
        idx = rng.integers(0, 256, n, dtype=np.uint8)
        data = G.lzw_literals(idx)
        raw, pos = G._sub_blocks(data, 0)
        assert pos == len(data)
        np.testing.assert_array_equal(G.lzw_decode(raw, 8, n), idx)


# ---- the committed fixtures -----------------------------------------------------


def test_committed_fixtures_recipes_and_hashes(tmp_path):
    """The fixtures are what their recipes write here; media_io.json holds
    what PIL, OpenCV and the JAX writers compute from them."""
    for path, write in ((media.GIF, media.write_gif_fixture), (media.APNG, media.write_apng_fixture)):
        again = tmp_path / path.name
        write(again)
        assert again.read_bytes() == path.read_bytes() and path.stat().st_size < 1_000_000
    assert media.media_hashes(tmp_path) == json.loads(media.MEDIA_JSON.read_text())


def test_committed_fixtures_decode_to_the_recorded_frames():
    meta = media.committed_hashes()
    gif = G.decode_gif(media.GIF.read_bytes())
    apng = read_apng(str(media.APNG))
    assert media.sha256(np.stack(gif)) == meta["gif"]["sha256_pil_frames_uint8"]
    assert media.sha256(np.stack(apng)) == meta["apng"]["sha256_pil_frames_uint8"]
    assert vio.probe_video(str(media.GIF)) == jvio.probe_video(str(media.GIF)) == (25.0, 9, 96, 144)
    assert vio.probe_video(str(media.APNG)) == jvio.probe_video(str(media.APNG)) == (25.0, 9, 96, 144)
