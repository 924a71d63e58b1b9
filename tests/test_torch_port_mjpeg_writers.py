"""The port's MJPEG writers and save path (ltx2_tpu_torch/utils/video_io.py)
against the JAX package's (ltx2_tpu/utils/video_io.py, whose JPEGs come
from PIL) and the JAX CLI's `save_video` / `_save_video_fallback`
(scripts/generate.py), on the CPU:

- `write_avi_mjpeg` and `write_mp4_mjpeg` (.avi, .mov, .mp4) without audio
  and with mono, stereo and (1, 2, N) audio, at 24 and 23.976 fps: the
  files byte for byte (tolerance none), and the PCM read back by the port's
  readers equal to the written int16 samples;
- `save_video` with ffmpeg hidden for .mp4, .m4v, .webm, a name without a
  suffix, .avi, .mov and .y4m, with and without audio, and with `speed`:
  the same set of files, every file but the GIF byte for byte; the GIF
  preview (the port's own palette) opened by PIL with the JAX CLI's frame
  count, duration and loop, its rms error against the source frames no
  more than 2x that of the JAX CLI's GIF (PIL's median cut);
- the committed AVI's frames with `fixture_audio()` through the port's
  writers against the JAX writers' SHA-256s in media_io.json (what
  chip_smoke.py checks on the card's host).
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image, ImageSequence

from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch.utils import video_io as vio
from tests import torch_port_media as media
from tests.torch_port_util import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
RATE = 24000


def _clip(frames: int = 9, h: int = 40, w: int = 56, seed: int = 3) -> np.ndarray:
    """Moving sinusoids with noise, uint8 (F, H, W, 3)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for t in range(frames):
        rgb = np.stack([np.sin(2 * np.pi * (xx / w + 0.07 * t)), np.cos(2 * np.pi * (yy / h - 0.05 * t)),
                        np.sin(2 * np.pi * ((xx + yy) / (w + h) + 0.04 * t))], -1)
        out.append(np.clip(128 + 100 * rgb + rng.normal(0, 6, rgb.shape), 0, 255).astype(np.uint8))
    return np.stack(out)


def _audio(kind, frames: int = 9, fps: float = 24.0, seed: int = 4):
    if kind is None:
        return None
    n = int(frames / fps * RATE) + 7
    rng = np.random.default_rng(seed)
    shapes = {"mono": (n,), "stereo": (2, n), "batched": (1, 2, n)}
    return rng.uniform(-1.1, 1.1, shapes[kind]).astype(np.float32)


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("fps", [24.0, 24000 / 1001])
@pytest.mark.parametrize("audio", [None, "mono", "stereo", "batched"])
@pytest.mark.parametrize("suffix", ["avi", "mov", "mp4"])
def test_writers_match_jax(tmp_path, suffix, audio, fps):
    frames, wave = _clip(), _audio(audio, fps=fps)
    ours, theirs = str(tmp_path / f"port.{suffix}"), str(tmp_path / f"jax.{suffix}")
    if suffix == "avi":
        vio.write_avi_mjpeg(ours, frames, fps, audio=wave, sample_rate=RATE)
        jvio.write_avi_mjpeg(theirs, frames, fps, audio=wave, sample_rate=RATE)
    else:
        vio.write_mp4_mjpeg(ours, frames, fps, audio=wave, sample_rate=RATE)
        jvio.write_mp4_mjpeg(theirs, frames, fps, audio=wave, sample_rate=RATE)
    assert _read(ours) == _read(theirs)
    read = vio.read_avi_audio(ours) if suffix == "avi" else vio.read_mov_audio(ours)
    if wave is None:
        assert read is None
    else:
        pcm = vio._pcm_int16(wave)
        samples, rate = read
        assert rate == RATE
        np.testing.assert_array_equal(np.round(samples * 32767.0).astype(np.int16), pcm.T)


def _gif(path):
    with Image.open(path) as im:
        frames = np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])
        return frames, im.n_frames, im.info.get("duration"), im.info.get("loop")


def _rms(a, b) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


SAVE_CASES = [("out.mp4", 1.0, None), ("out.mp4", 1.0, "stereo"), ("out.m4v", 1.0, "batched"),
              ("out.webm", 1.0, None), ("out", 1.0, "stereo"), ("out.avi", 1.0, "stereo"), ("out.mov", 1.0, "mono"),
              ("out.y4m", 1.0, "stereo"), ("out.mp4", 0.5, "stereo"), ("out.avi", 2.0, None)]


@pytest.mark.parametrize("name,speed,audio", SAVE_CASES)
def test_save_video_matches_the_jax_cli_without_ffmpeg(tmp_path, monkeypatch, name, speed, audio):
    from scripts import generate as jgen

    monkeypatch.setattr(shutil, "which", lambda _name: None)
    frames, wave = _clip(), _audio(audio)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jgen.save_video(frames, str(tmp_path / "jax" / name), 24.0, audio=wave, audio_sample_rate=RATE, speed=speed)
    vio.save_video(frames, str(tmp_path / "port" / name), 24.0, speed=speed, audio=wave, audio_sample_rate=RATE)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for f in files:
        ours, theirs = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".gif"):
            got, n, duration, loop = _gif(ours)
            ref, ref_n, ref_duration, ref_loop = _gif(theirs)
            delay_ms = max(1, int(1000 / (24.0 * speed)))  # a GIF stores hundredths: PIL reads back 10 x int(ms / 10)
            assert (n, duration, loop) == (ref_n, ref_duration, ref_loop) == (9, 10 * int(delay_ms / 10), 0)
            assert got.shape == ref.shape == frames.shape
            assert _rms(got, frames) <= 2 * _rms(ref, frames), (_rms(got, frames), _rms(ref, frames))
        elif f.endswith(".npz"):
            a, b = np.load(ours), np.load(theirs)
            assert sorted(a.files) == sorted(b.files) == ["fps", "frames"]
            np.testing.assert_array_equal(a["frames"], b["frames"])
            assert float(a["fps"]) == float(b["fps"]) == 24.0 * speed
        else:
            assert _read(ours) == _read(theirs), f
    # Without ffmpeg only .mp4 / .m4v keep their name; a GIF comes with every MJPEG fallback.
    suffix = name.rsplit(".", 1)[-1] if "." in name else ""
    if suffix not in ("avi", "mov", "y4m"):
        assert "out.gif" in files and "out_frames.npz" in files
        assert (name if suffix in ("mp4", "m4v") else "out.avi") in files
    assert ("out.wav" in files) == (audio is not None and suffix not in ("avi", "mov"))


def test_committed_frames_through_the_writers_match_the_recorded_jax_hashes(tmp_path):
    meta = media.committed_hashes()
    frames, audio = media.avi_frames(), media.fixture_audio()
    assert media.sha256(audio) == meta["audio"]["sha256_float32"]
    for key, want in meta["writers"].items():
        suffix, with_audio = key.split("_")[0], key.endswith("_audio")
        path = str(tmp_path / f"w.{suffix}")
        writer = vio.write_avi_mjpeg if suffix == "avi" else vio.write_mp4_mjpeg
        writer(path, frames, 24.0, audio=audio if with_audio else None, sample_rate=RATE)
        assert media.file_sha256(path) == want, key
