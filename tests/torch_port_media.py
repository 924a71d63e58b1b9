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
- `media_io.json`: the SHA-256 of PIL's decoded frames of both files (and
  of each WebP fixture's frames, under "webp"), of
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
           "writers": {}, "canny": {}, "webp": {}}
    for name in WEBPS:
        path = FIXTURES / name
        pil = pil_frames(path)
        rec["webp"][name] = {"sha256_file": file_sha256(path), "sha256_pil_frames_uint8": sha256(pil),
                             "frames": len(pil), "height": pil.shape[1], "width": pil.shape[2]}
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
