"""The port's video readers (ltx2_tpu_torch/utils/video_io.py) against the
JAX package's (ltx2_tpu/utils/video_io.py, PIL for JPEG and BILINEAR), on
the CPU, bit for bit (tolerance none: the float32 frames are equal):

- `_resize_frame` (PIL's 8-bit BILINEAR) up and down, and `_pack`'s trim
  and edge repeat;
- `read_y4m` at C420jpeg, C420 and C444, odd sizes, padded and trimmed,
  and `probe_video` with per-frame parameters and a truncated last frame;
- `read_avi_mjpeg` on files from JAX's `write_avi_mjpeg` with audio,
  without, and with a second stream's `dc` chunk; `probe_video` on them;
- `read_mov_mjpeg`, `mov_is_mjpeg`, `mov_video_codec`, `probe_mov` on
  .mov and .mp4 from `write_mp4_mjpeg`, an `avc1` entry and an `mp4v` entry
  whose esds names MPEG-4 Visual (not JPEG);
- `read_video_any`'s dispatch (and OpenCV's decode where cv2 is
  installed), the formats that raise by name, `load_image_tensor` on a
  .jpg (PIL's LANCZOS and crop), and the committed MJPEG fixture
  (tests/fixtures_video): its recipe, and both recorded SHA-256s.
"""

import hashlib
import io
import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch.pipelines.common import load_image_tensor, read_image
from ltx2_tpu_torch.utils import video_io as vio
from ltx2_tpu_torch.utils.jpeg import decode_jpeg
from tests.torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
FIXTURE = Path(__file__).parent / "fixtures_video" / "pattern_288x432x9.avi"


def fixture_frames(seed: int = 17, frames: int = 9, height: int = 288, width: int = 432) -> np.ndarray:
    """The committed fixture's frames: three moving sinusoids with Gaussian
    noise (sigma 6), uint8 (F, H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = []
    for t in range(frames):
        r = 128 + 100 * np.sin(2 * np.pi * (xx / width + 0.05 * t))
        g = 128 + 100 * np.cos(2 * np.pi * (yy / height - 0.04 * t))
        b = 128 + 90 * np.sin(2 * np.pi * ((xx + yy) / (width + height) + 0.03 * t))
        img = np.stack([r, g, b], -1) + rng.normal(0, 6, (height, width, 3))
        out.append(np.clip(np.round(img), 0, 255).astype(np.uint8))
    return np.stack(out)


def _frames(f: int, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1), np.full((h, w), 90.0)], -1)
    return np.stack([np.clip(base + i * 9 + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
                     for i in range(f)])


def _same(port, ref):
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("size", [(16, 24), (64, 96), (37, 53), (80, 20), (3, 200), (41, 53)])
def test_resize_frame_equals_pil_bilinear(size):
    frame = _frames(1, 41, 53, seed=1)[0]
    np.testing.assert_array_equal(vio._resize_frame(frame, *size), jvio._resize_frame(frame, *size))
    frames = list(_frames(3, 41, 53, seed=2))
    for n in (2, 5):  # trimmed, then the last frame repeated
        _same(vio._pack(list(frames), *size, n), jvio._pack(list(frames), *size, n))


def _write_y4m(path, frames_u8, colorspace):
    """RGB -> limited-range BT.601 planes (tests/test_video_io.py's writer)."""
    f, h, w, _ = frames_u8.shape
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F24:1 Ip A1:1 {colorspace}\n".encode())
        for frame in frames_u8:
            r, g, b = (frame[..., i].astype(np.float32) for i in range(3))
            y = 16 + (219 / 255) * (0.299 * r + 0.587 * g + 0.114 * b)
            u = 128 + (224 / 255) * (-0.169 * r - 0.331 * g + 0.5 * b)
            v = 128 + (224 / 255) * (0.5 * r - 0.419 * g - 0.081 * b)
            if colorspace.startswith("C420"):
                u, v = u[::2, ::2], v[::2, ::2]
            fh.write(b"FRAME\n" + b"".join(np.clip(p, 0, 255).astype(np.uint8).tobytes() for p in (y, u, v)))
    return str(path)


@pytest.mark.parametrize("colorspace", ["C420jpeg", "C420", "C444"])
def test_read_y4m_matches_jax(tmp_path, colorspace):
    path = _write_y4m(tmp_path / "a.y4m", _frames(5, 37, 53, seed=3), colorspace)
    for geometry in ((37, 53, 5), (64, 96, 9), (16, 24, 3)):  # own size, padded up, trimmed
        _same(vio.read_y4m(path, *geometry), jvio.read_y4m(path, *geometry))
    assert vio.probe_video(path) == jvio.probe_video(path) == (24.0, 5, 37, 53)
    ours = str(tmp_path / "ours.y4m")
    vio.write_y4m(ours, _frames(3, 32, 48, seed=4), 25.0)  # the port's writer reads back
    _same(vio.read_y4m(ours, 32, 48, 3), jvio.read_y4m(ours, 32, 48, 3))


def test_probe_y4m_per_frame_parameters_and_truncation(tmp_path):
    frame = b"FRAME Ixyz\n" + bytes(range(16)) * 3
    path = tmp_path / "pf.y4m"
    path.write_bytes(b"YUV4MPEG2 W4 H4 F25:1 Ip A1:1 C444\n" + frame * 20)
    assert vio.probe_video(str(path)) == jvio.probe_video(str(path)) == (25.0, 20, 4, 4)
    _same(vio.read_y4m(str(path), 4, 4, 20), jvio.read_y4m(str(path), 4, 4, 20))
    trunc = tmp_path / "trunc.y4m"
    trunc.write_bytes(b"YUV4MPEG2 W4 H4 F25:1 C444\n" + frame * 2 + frame[:20])
    assert vio.probe_video(str(trunc))[1] == jvio.probe_video(str(trunc))[1] == 2
    for bad, word in ((b"YUV4MPEG2 W4 H4 C420p10\n", "8-bit"), (b"YUV4MPEG2 W4 H4 C422\n", "colorspace"),
                      (b"NOTY4M W4 H4\n", "YUV4MPEG2")):
        path.write_bytes(bad + frame)
        with pytest.raises(ValueError, match=word):
            vio.read_y4m(str(path), 4, 4, 1)


def _with_second_stream_chunk(path):
    """A non-JPEG '01dc' chunk first in the movi list (a second stream)."""
    raw = bytearray(open(path, "rb").read())
    mi = raw.find(b"movi")
    chunk = b"01dc" + struct.pack("<I", 4) + bytes(4)
    raw[mi + 4:mi + 4] = chunk
    struct.pack_into("<I", raw, mi - 4, struct.unpack_from("<I", raw, mi - 4)[0] + len(chunk))
    struct.pack_into("<I", raw, 4, struct.unpack_from("<I", raw, 4)[0] + len(chunk))
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("kind", ["audio", "silent", "second_stream"])
def test_read_avi_mjpeg_matches_jax(tmp_path, kind):
    path = str(tmp_path / "a.avi")
    audio = np.sin(np.linspace(0, 40, 2 * 4000)).reshape(2, 4000).astype(np.float32) * 0.3
    jvio.write_avi_mjpeg(path, _frames(4, 40, 56, seed=5), 12.0, audio=audio if kind == "audio" else None,
                         sample_rate=16000)
    if kind == "second_stream":
        _with_second_stream_chunk(path)
    for geometry in ((40, 56, 4), (32, 64, 9), (64, 96, 2)):
        _same(vio.read_avi_mjpeg(path, *geometry), jvio.read_avi_mjpeg(path, *geometry))
    assert vio.probe_video(path) == jvio.probe_video(path)
    _same(vio.read_video_any(path, 32, 48, 4), jvio.read_video_any(path, 32, 48, 4))


def test_avi_with_a_stream_that_is_not_mjpeg_raises(tmp_path):
    path = str(tmp_path / "a.avi")
    jvio.write_avi_mjpeg(path, _frames(2, 16, 16, seed=6), 24.0)
    raw = bytearray(open(path, "rb").read())
    at = raw.index(b"00dc", raw.index(b"movi")) + 8
    raw[at:at + 2] = b"\x00\x00"  # the first frame's payload no longer starts with SOI
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="not MJPEG"):
        vio.read_avi_mjpeg(path, 16, 16, 2)


@pytest.mark.parametrize("suffix", [".mov", ".mp4"])
def test_read_mov_mjpeg_matches_jax(tmp_path, suffix):
    path = str(tmp_path / f"a{suffix}")
    jvio.write_mp4_mjpeg(path, _frames(5, 40, 56, seed=7), 12.0)
    for geometry in ((40, 56, 5), (32, 64, 7)):
        _same(vio.read_mov_mjpeg(path, *geometry), jvio.read_mov_mjpeg(path, *geometry))
    assert vio.mov_video_codec(path) == jvio.mov_video_codec(path)
    assert vio.mov_is_mjpeg(path) and jvio.mov_is_mjpeg(path)
    assert vio.probe_video(path) == jvio.probe_video(path) == jvio.probe_mov(path) == vio.probe_mov(path)
    assert vio.decodes_pure_python(path) and jvio.decodes_pure_python(path)
    _same(vio.read_video_any(path, 32, 48, 5), jvio.read_video_any(path, 32, 48, 5))


@pytest.mark.parametrize("entry", ["avc1", "mp4v_mpeg4_visual"])
def test_mov_that_is_not_mjpeg(tmp_path, entry):
    path = str(tmp_path / "a.mp4")
    jvio.write_mp4_mjpeg(path, _frames(2, 16, 16, seed=8), 24.0)
    data = bytearray(open(path, "rb").read())
    fourcc = data.index(jvio.mov_video_codec(path), data.index(b"stsd"))
    if entry == "avc1":
        data[fourcc:fourcc + 4] = b"avc1"
    else:  # 'mp4v' whose esds objectTypeIndication is 0x20 (MPEG-4 Part 2)
        assert data[fourcc:fourcc + 4] == b"mp4v"
        esds = data.index(b"esds", fourcc)
        oti = data.index(b"\x04", data.index(b"\x03", esds + 8) + 5)
        assert data[oti + 2] == 0x6C
        data[oti + 2] = 0x20
    open(path, "wb").write(bytes(data))
    assert vio.mov_video_codec(path) == jvio.mov_video_codec(path) == data[fourcc:fourcc + 4]
    assert not vio.mov_is_mjpeg(path) and not jvio.mov_is_mjpeg(path)
    assert not vio.decodes_pure_python(path) and not jvio.decodes_pure_python(path)
    with pytest.raises(ValueError, match="not MJPEG"):
        vio.read_mov_mjpeg(path, 16, 16, 2)


def test_dispatch_and_formats_that_raise(tmp_path):
    frames = _frames(3, 24, 32, seed=9)
    png = str(tmp_path / "still.png")
    Image.fromarray(frames[0]).save(png)
    _same(vio.read_video_any(png, 16, 24, 3), jvio.read_video_any(png, 16, 24, 3))
    assert vio.probe_video(png) == jvio.probe_video(png) == (24.0, 1, 24, 32)
    y4m = str(tmp_path / "a.y4m")
    vio.write_y4m(y4m, frames, 24.0)
    _same(vio.read_video_any(y4m, 24, 32, 3), jvio.read_video_any(y4m, 24, 32, 3))
    assert vio.PURE_PYTHON_SUFFIXES == jvio.PURE_PYTHON_SUFFIXES and vio.PIL_SUFFIXES == jvio.PIL_SUFFIXES
    images = [Image.fromarray(f) for f in frames]
    animated = {"gif": "GIF", "webp": "WebP", "apng": "APNG"}
    for suffix, word in animated.items():
        path = str(tmp_path / f"anim.{suffix}")
        images[0].save(path, format="PNG" if suffix == "apng" else suffix.upper(), save_all=True,
                       append_images=images[1:], duration=40)
        for call in (lambda: vio.read_video_any(path, 16, 24, 3), lambda: vio.probe_video(path)):
            with pytest.raises(NotImplementedError, match=f"{word}.*GIF, APNG and WebP readers"):
                call()
    # An animated .png (acTL) raises too; a still one reads.
    apng_as_png = str(tmp_path / "anim2.png")
    images[0].save(apng_as_png, save_all=True, append_images=images[1:], duration=40)
    with pytest.raises(NotImplementedError, match="APNG"):
        vio.read_video_any(apng_as_png, 16, 24, 3)
    with pytest.raises(ValueError, match="no pure-Python probe"):
        vio.probe_video(str(tmp_path / "a.mkv"))


def test_opencv_decode_where_installed(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "p2.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12.0, (32, 24))
    assert writer.isOpened()
    for frame in _frames(4, 24, 32, seed=10):
        writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
    writer.release()
    assert not vio.mov_is_mjpeg(path)  # MPEG-4 Part 2: OpenCV decodes it
    _same(vio.read_video_any(path, 16, 24, 4), jvio.read_video_any(path, 16, 24, 4))
    assert vio.probe_cv2(path) == jvio.probe_cv2(path)


@pytest.mark.parametrize("size", [(48, 64), (32, 96)], ids=["same_aspect", "crop"])
def test_load_image_tensor_jpeg_matches_jax(tmp_path, size):
    path = str(tmp_path / "still.jpg")
    Image.fromarray(_frames(1, 75, 101, seed=11)[0]).save(path, quality=90)
    np.testing.assert_array_equal(load_image_tensor(path, *size).numpy(),
                                  np.asarray(jcommon.load_image_tensor(path, *size)))
    np.testing.assert_array_equal(read_image(path), np.asarray(Image.open(path).convert("RGB")))
    webp = str(tmp_path / "still.webp")
    Image.fromarray(_frames(1, 16, 16, seed=12)[0]).save(webp)
    with pytest.raises(ValueError, match="WebP"):
        read_image(webp)


def test_committed_fixture():
    """tests/fixtures_video: 9 frames of `fixture_frames()` written by the
    JAX package's `write_avi_mjpeg` (PIL, quality 92); its JSON holds the
    SHA-256 of PIL's decoded frames and of JAX's `read_avi_mjpeg` at
    256x384x121, which the port's readers must reproduce."""
    meta = json.loads(FIXTURE.with_suffix(".json").read_text())
    data = FIXTURE.read_bytes()
    assert hashlib.sha256(data).hexdigest() == meta["sha256_file"] and len(data) <= 600_000

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    chunks = [(off, size) for fourcc, off, size in vio._avi_chunks(data) if fourcc == b"00dc"]
    pil = np.stack([np.asarray(Image.open(io.BytesIO(data[o:o + n])).convert("RGB")) for o, n in chunks])
    port = np.stack([decode_jpeg(data[o:o + n]) for o, n in chunks])
    assert sha(pil) == sha(port) == meta["sha256_pil_frames_uint8"]
    assert sha(vio.read_avi_mjpeg(str(FIXTURE), 256, 384, 121)) == meta["sha256_read_avi_mjpeg_256x384x121_float32"]


def test_fixture_recipe(tmp_path):
    """The fixture is what its recipe writes here (PIL's encoder, quality 92)."""
    path = str(tmp_path / "again.avi")
    jvio.write_avi_mjpeg(path, fixture_frames(), 24.0, quality=92)
    assert open(path, "rb").read() == FIXTURE.read_bytes()
    assert os.path.getsize(path) == FIXTURE.stat().st_size


def test_committed_jpeg_still(tmp_path):
    """tests/fixtures_video/pattern_512x768.jpg: one `fixture_frames` frame at
    512x768 saved by PIL (quality 92); the port decodes PIL's RGB bit for
    bit, and the recipe writes the same bytes here."""
    still = FIXTURE.parent / "pattern_512x768.jpg"
    meta = json.loads(still.with_suffix(".json").read_text())
    data = still.read_bytes()
    assert hashlib.sha256(data).hexdigest() == meta["sha256_file"]
    rgb = read_image(str(still))
    assert rgb.shape == (512, 768, 3)
    assert hashlib.sha256(rgb.tobytes()).hexdigest() == meta["sha256_pil_rgb_uint8"]
    np.testing.assert_array_equal(rgb, np.asarray(Image.open(still).convert("RGB")))
    again = str(tmp_path / "again.jpg")
    Image.fromarray(fixture_frames(seed=23, frames=1, height=512, width=768)[0]).save(again, quality=92)
    assert open(again, "rb").read() == data
