"""The port's WebP reader (ltx2_tpu_torch/utils/webp.py, vp8.py, vp8l.py)
against PIL's decode (libwebp's `WebPAnimDecoder`), bit for bit, and its
readers against the JAX package's PIL paths.

Files are written at test time: by PIL (lossy at several qualities and
methods, lossless, with and without alpha, animated, odd sizes), and by the
helpers here from PIL-encoded bitstreams: animations with frame offsets,
blending and disposal the encoder would not choose, raw alpha planes under
each of the four filters, and lossy frames whose first partition is
re-encoded with another loop filter (the simple one, other levels and
sharpness), which PIL's options cannot ask for.
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image, ImageSequence

from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch.pipelines.common import load_image_tensor, read_image
from ltx2_tpu_torch.utils import video_io as vio
from ltx2_tpu_torch.utils import vp8, vp8l, webp
from tests import torch_port_media as media
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


def pil_frames(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def assert_frames_equal(data: bytes, msg: str = ""):
    ref = pil_frames(data)
    got = webp.read_webp_frames(data)
    assert len(got) == len(ref), msg
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == np.uint8 and a.shape == b.shape, (msg, i)
        if not np.array_equal(a, b):
            bad = (a != b).any(-1)
            raise AssertionError(f"{msg}: frame {i} differs at {int(bad.sum())} pixels, max "
                                 f"{int(np.abs(a.astype(int) - b).max())}")


def scene(h: int, w: int, t: int = 0, seed: int = 0) -> np.ndarray:
    """RGB: smooth gradients, edges and a noisy band (every intra mode and
    both coefficient regimes), moving with t."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    rgb = np.stack([128 + 100 * np.sin((xx + 3 * t) / 7.0), 128 + 100 * np.cos((yy - 2 * t) / 5.0),
                    (xx * yy / 3 + 9 * t) % 256], -1)
    rgb[(xx // 9 + yy // 13) % 2 == 0] *= 0.6
    band = slice(h // 3, h // 3 + max(h // 5, 1))
    rgb[band] = np.random.default_rng(seed + t).integers(0, 256, rgb[band].shape)
    return rgb.clip(0, 255).astype(np.uint8)


def alpha_plane(h: int, w: int, t: int = 0) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.where((xx - 3 * t) % 23 < 9, 255, (xx * 5 + yy * 3) % 256)
    return np.where((xx + yy + t) % 7 == 0, 0, a).astype(np.uint8)


def save(images, **kw) -> bytes:
    buf = io.BytesIO()
    if len(images) > 1:
        Image.fromarray(images[0]).save(buf, "WEBP", save_all=True,
                                        append_images=[Image.fromarray(i) for i in images[1:]], **kw)
    else:
        Image.fromarray(images[0]).save(buf, "WEBP", **kw)
    return buf.getvalue()


def rgba_of(data: bytes) -> np.ndarray:
    """The first canvas with its alpha, (H, W, 4) uint8."""
    return next(webp.iter_canvases(webp.parse(data), 1))[0]


def chunks(data: bytes):
    return list(webp._chunks(data, 12, len(data)))


def riff(*parts: bytes) -> bytes:
    body = b"WEBP" + b"".join(parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


# ---------------------------------------------------------------- PIL-written files

STILL_SIZES = [(16, 16), (37, 53), (61, 90), (1, 7)]


@pytest.mark.parametrize("size", STILL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality,method", [(5, 0), (40, 4), (75, 6), (100, 2)])
def test_lossy_still_equals_pil(size, quality, method):
    data = save([scene(*size, seed=1)], quality=quality, method=method)
    assert chunks(data)[0][0] == b"VP8 "
    assert_frames_equal(data, f"lossy q{quality} m{method}")


@pytest.mark.parametrize("size", STILL_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "alpha"])
@pytest.mark.parametrize("quality,method", [(0, 0), (60, 4), (100, 6)])
def test_lossless_still_equals_pil(size, alpha, quality, method):
    rgb = scene(*size, seed=2)
    img = np.concatenate([rgb, alpha_plane(*size)[..., None]], -1) if alpha else rgb
    data = save([img], lossless=True, quality=quality, method=method, exact=True)
    assert chunks(data)[-1][0] == b"VP8L"
    assert_frames_equal(data, f"lossless alpha={alpha} q{quality} m{method}")
    if alpha:
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(rgba_of(data), ref)


@pytest.mark.parametrize("palette", [2, 4, 16, 200])
def test_lossless_palettes_equal_pil(palette):
    """Colour indexing with each pixel-bundling width (1, 2, 4 and 8 bits an index)."""
    rng = np.random.default_rng(palette)
    colours = rng.integers(0, 256, (palette, 3), dtype=np.uint8)
    img = colours[rng.integers(0, palette, (29, 43))]
    assert_frames_equal(save([img], lossless=True, quality=70), f"palette {palette}")


@pytest.mark.parametrize("size", [(40, 56), (33, 47)], ids=["even", "odd"])
def test_lossy_still_with_alpha_equals_pil(size):
    img = np.concatenate([scene(*size, seed=3), alpha_plane(*size)[..., None]], -1)
    data = save([img], quality=70)
    kinds = [k for k, _ in chunks(data)]
    assert kinds[:1] == [b"VP8X"] and b"ALPH" in kinds and b"VP8 " in kinds
    assert_frames_equal(data, "lossy + alpha")
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(rgba_of(data), ref)


ANIMATIONS = {
    "lossy": dict(quality=60),
    "lossless": dict(lossless=True, quality=50),
    "lossy_minimize": dict(quality=50, minimize_size=True),
    "lossless_keyframes": dict(lossless=True, kmax=1),
    "mixed": dict(quality=70, allow_mixed=True),
}


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "alpha"])
@pytest.mark.parametrize("kind", sorted(ANIMATIONS))
def test_animation_equals_pil(kind, alpha):
    h, w = 35, 51
    frames = []
    for t in range(5):
        rgb = scene(h, w, t=0, seed=4)
        rgb[10 + t:18 + t, 5 + 4 * t:15 + 4 * t] = (40 * t, 200, 255 - 30 * t)  # a small moving square
        frames.append(np.concatenate([rgb, alpha_plane(h, w, t)[..., None]], -1) if alpha else rgb)
    data = save(frames, duration=[40, 50, 60, 70, 80], **ANIMATIONS[kind])
    info = webp.parse(data)
    assert len(info.frames) == 5 and [f.duration for f in info.frames] == [40, 50, 60, 70, 80]
    assert_frames_equal(data, f"animation {kind} alpha={alpha}")


# ---------------------------------------------------------------- hand-assembled animations


def bitstream_chunks(img: np.ndarray, lossless: bool):
    """The frame chunks (ALPH + VP8, or VP8L) of `img` encoded by PIL."""
    data = save([img], lossless=lossless, quality=80, exact=True)
    return [(k, b) for k, b in chunks(data) if k in (b"ALPH", b"VP8 ", b"VP8L")]


def animation(canvas, frames, background=(255, 255, 255, 255)) -> bytes:
    """frames: (image, x, y, duration, blend, dispose_background, lossless)."""
    cw, ch = canvas
    flags = webp.ANIMATION_FLAG | webp.ALPHA_FLAG
    parts = [chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (cw - 1).to_bytes(3, "little") + (ch - 1).to_bytes(3, "little")),
             chunk(b"ANIM", bytes(background) + struct.pack("<H", 0))]
    for img, x, y, duration, blend, dispose, lossless in frames:
        h, w = img.shape[:2]
        head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (w - 1).to_bytes(3, "little")
                + (h - 1).to_bytes(3, "little") + duration.to_bytes(3, "little")
                + bytes([(0 if blend else 2) | (1 if dispose else 0)]))
        body = head + b"".join(chunk(k, b) for k, b in bitstream_chunks(img, lossless))
        parts.append(chunk(b"ANMF", body))
    return riff(*parts)


def rgba(h, w, seed, opaque=False):
    rgb = scene(h, w, seed=seed)
    a = np.full((h, w), 255, np.uint8) if opaque else alpha_plane(h, w, seed)
    return np.concatenate([rgb, a[..., None]], -1)


COMPOSITIONS = {
    # sub-rectangles blended over a full first frame, the previous kept
    "blend_keep": [(rgba(30, 40, 1, True), 0, 0, 40, True, False), (rgba(12, 16, 2), 4, 6, 40, True, False),
                   (rgba(10, 20, 3), 10, 14, 40, True, False)],
    # dispose to background: the next frame blends only outside the cleared rectangle
    "dispose_then_blend": [(rgba(30, 40, 4, True), 0, 0, 40, True, False), (rgba(14, 18, 5), 6, 4, 40, True, True),
                           (rgba(20, 24, 6), 2, 2, 40, True, False), (rgba(8, 8, 7), 30, 20, 40, True, True)],
    # no blending: the rectangle overwrites, transparency and all
    "overwrite": [(rgba(30, 40, 8), 0, 0, 40, True, False), (rgba(16, 16, 9), 8, 8, 40, False, False),
                  (rgba(30, 40, 10), 0, 0, 40, False, True), (rgba(10, 12, 11), 2, 4, 40, True, False)],
    # a full-canvas frame disposed: the next one is a key frame on a transparent canvas
    "key_after_full_dispose": [(rgba(30, 40, 12), 0, 0, 40, True, True), (rgba(14, 14, 13), 4, 4, 40, True, False),
                               (rgba(6, 10, 14), 24, 20, 40, True, False)],
}


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
@pytest.mark.parametrize("name", sorted(COMPOSITIONS))
def test_compositing_equals_pil(name, lossless):
    data = animation((40, 30), [(*f, lossless) for f in COMPOSITIONS[name]])
    assert_frames_equal(data, f"{name} lossless={lossless}")


# ---------------------------------------------------------------- alpha filters


def forward_filter(a: np.ndarray, method: int) -> np.ndarray:
    """The ALPH encoder's filters (none, horizontal, vertical, gradient)."""
    a = a.astype(np.int64)
    out = a.copy()
    if method == 0:
        return a.astype(np.uint8)
    out[0, 1:] = a[0, 1:] - a[0, :-1]
    if method == 1:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        out[1:, 1:] = a[1:, 1:] - a[1:, :-1]
    elif method == 2:
        out[1:] = a[1:] - a[:-1]
    else:
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        pred = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
        out[1:, 1:] = a[1:, 1:] - pred
    return (out & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("method", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_raw_alpha_filters_equal_pil(method):
    h, w = 27, 38
    alpha = alpha_plane(h, w, 2)
    alpha[5:9] = np.random.default_rng(3).integers(0, 256, (4, w))
    vp8_body = [b for k, b in chunks(save([scene(h, w, seed=5)], quality=80)) if k == b"VP8 "][0]
    alph = bytes([method << 2]) + forward_filter(alpha, method).tobytes()  # compression 0: raw
    data = riff(chunk(b"VP8X", bytes([webp.ALPHA_FLAG, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little")), chunk(b"ALPH", alph), chunk(b"VP8 ", vp8_body))
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(ref[..., 3], alpha)
    np.testing.assert_array_equal(rgba_of(data), ref)


# ---------------------------------------------------------------- the loop filters


class _Recorder(vp8.BoolDecoder):
    __slots__ = ("log",)
    made: list = []

    def __init__(self, *args):
        super().__init__(*args)
        self.log = []
        _Recorder.made.append(self)

    def bit(self, prob):
        b = super().bit(prob)
        self.log.append((prob, b))
        return b


class BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _filter_header_at(log) -> int:
    """The index in the first partition's bits of the filter header's
    `simple` bit, past the colour space, clamping and segment header."""
    i = 2
    use_segment = log[i][1]
    i += 1
    if use_segment:
        update_map, update_data = log[i][1], log[i + 1][1]
        i += 2
        if update_data:
            i += 1  # absolute delta
            for bits in (7,) * 4 + (6,) * 4:
                i += 1 + (bits + 1) * log[i][1]
        if update_map:
            for _ in range(3):
                i += 1 + 8 * log[i][1]
    return i


def refilter(data: bytes, simple: int, level: int, sharpness: int) -> bytes:
    """A lossy still with its first partition re-encoded under another loop
    filter: the `simple` bit, the 6-bit level and the 3-bit sharpness."""
    body = [b for k, b in chunks(data) if k == b"VP8 "][0]
    _Recorder.made = []
    saved, vp8.BoolDecoder = vp8.BoolDecoder, _Recorder
    try:
        vp8._parse(body)
    finally:
        vp8.BoolDecoder = saved
    log = list(_Recorder.made[0].log)
    at = _filter_header_at(log)
    bits = [simple] + [(level >> (5 - k)) & 1 for k in range(6)] + [(sharpness >> (2 - k)) & 1 for k in range(3)]
    for k, b in enumerate(bits):
        log[at + k] = (log[at + k][0], b)
    enc = BoolEncoder()
    for prob, b in log:
        enc.put(prob, b)
    part0 = enc.flush()
    old0 = (body[0] | body[1] << 8 | body[2] << 16) >> 5
    tag = (body[0] | body[1] << 8 | body[2] << 16) & 0x1F | len(part0) << 5
    frame = tag.to_bytes(3, "little") + body[3:10] + part0 + body[10 + old0:]
    return riff(chunk(b"VP8 ", frame))


@pytest.mark.parametrize("simple,level,sharpness", [(1, 20, 0), (1, 63, 3), (0, 50, 6), (0, 8, 2), (1, 0, 0),
                                                    (0, 35, 7)])
def test_loop_filters_equal_pil(simple, level, sharpness):
    data = save([scene(53, 75, seed=6)], quality=30, method=2)
    out = refilter(data, simple, level, sharpness)
    f = vp8._parse([b for k, b in chunks(out) if k == b"VP8 "][0])
    assert f.filter_type == (0 if level == 0 else 1 if simple else 2)
    assert_frames_equal(out, f"filter simple={simple} level={level} sharpness={sharpness}")


def test_refilter_round_trip_is_identity():
    """Re-encoding the first partition with its own filter header gives the same frame."""
    data = save([scene(33, 47, seed=7)], quality=50)
    body = [b for k, b in chunks(data) if k == b"VP8 "][0]
    _Recorder.made = []
    saved, vp8.BoolDecoder = vp8.BoolDecoder, _Recorder
    try:
        vp8._parse(body)
    finally:
        vp8.BoolDecoder = saved
    log = _Recorder.made[0].log
    at = _filter_header_at(log)
    simple = log[at][1]
    lv = int("".join(str(b) for _, b in log[at + 1:at + 7]), 2)
    sh = int("".join(str(b) for _, b in log[at + 7:at + 10]), 2)
    np.testing.assert_array_equal(webp.read_webp_frames(refilter(data, simple, lv, sh))[0],
                                  webp.read_webp_frames(data)[0])


def test_bitstream_features_are_exercised():
    """The lossy files above reach every intra mode, several segments and
    coefficient-probability updates."""
    imodes, ymodes, uvmodes, segments, updates = set(), set(), set(), set(), 0
    for size in ((61, 90), (37, 53)):
        for quality, method in ((5, 0), (40, 4), (75, 6), (100, 2)):
            data = save([scene(*size, seed=1)], quality=quality, method=method)
            f = vp8._parse([b for k, b in chunks(data) if k == b"VP8 "][0])
            for m, is4 in enumerate(f.is4):
                if is4:
                    imodes.update(f.imodes[m])
                else:
                    ymodes.add(f.ymode[m])
            uvmodes.update(f.uvmode)
            segments.update(f.segment)
            updates += f.proba_updates
    assert imodes == set(range(10)) and ymodes == set(range(4)) and uvmodes == set(range(4))
    assert len(segments) > 1 and updates > 0


# ---------------------------------------------------------------- the readers


def test_readers_match_jax(tmp_path):
    h, w = 45, 66
    frames = [np.concatenate([scene(h, w, t, seed=8), alpha_plane(h, w, t)[..., None]], -1) for t in range(4)]
    anim = tmp_path / "anim.webp"
    anim.write_bytes(save(frames, duration=50, quality=70))
    still = tmp_path / "still.webp"
    still.write_bytes(save([frames[0]], lossless=True))
    for path in (str(anim), str(still)):
        assert vio.probe_video(path) == jvio.probe_video(path)
        for size in ((32, 48, 3), (24, 40, 6)):
            np.testing.assert_array_equal(vio.read_pil_animation(path, *size), jvio.read_pil_animation(path, *size))
            np.testing.assert_array_equal(vio.read_video_any(path, *size), jvio.read_video_any(path, *size))
        np.testing.assert_array_equal(read_image(path), np.asarray(Image.open(path).convert("RGB")))
        np.testing.assert_array_equal(load_image_tensor(path, 40, 56).numpy(),
                                      np.asarray(jcommon.load_image_tensor(path, 40, 56)))


def test_malformed_files_raise(tmp_path):
    data = save([scene(16, 16)], quality=50)
    with pytest.raises(webp.WebPError, match="RIFF"):
        webp.parse(b"RIFX" + data[4:])
    with pytest.raises(webp.WebPError, match="truncated"):
        webp.parse(data[:-5])
    with pytest.raises(vp8.VP8Error, match="start code"):
        vp8.decode_vp8(b"\0" * 3 + b"\0\0\0" + b"\0" * 10)
    with pytest.raises(vp8l.VP8LError, match="signature"):
        vp8l.decode_vp8l(b"\0" * 8)
    with pytest.raises(webp.WebPError, match="alpha compression"):
        webp.decode_alpha(bytes([2, 0, 0]), 1, 1)


# ---------------------------------------------------------------- the committed fixtures


@pytest.mark.parametrize("name", sorted(media.WEBPS))
def test_committed_webp_fixture(tmp_path, name):
    """tests/fixtures_video's WebP files are what their recipes write here,
    and the port decodes them to the SHA-256 of PIL's frames that
    media_io.json records (the hashes chip_smoke.py checks on the card's
    machine, which has no PIL)."""
    path = media.FIXTURES / name
    again = tmp_path / name
    media.write_webp_fixture(again)
    assert again.read_bytes() == path.read_bytes()
    meta = media.committed_hashes()["webp"][name]
    frames = np.stack(webp.read_webp_frames(path.read_bytes()))
    assert media.sha256(frames) == meta["sha256_pil_frames_uint8"] == media.sha256(media.pil_frames(path))
    assert vio.probe_video(str(path)) == jvio.probe_video(str(path)) == (24.0, meta["frames"], meta["height"],
                                                                        meta["width"])
    assert sum(p.stat().st_size for p in media.FIXTURES.glob("webp_*.webp")) < 300_000
