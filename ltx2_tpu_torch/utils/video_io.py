"""Video files out, numpy only (counterpart of the writers in
ltx2_tpu/utils/video_io.py).

`write_y4m` writes lossless YUV4MPEG2 (C444, 8-bit, progressive), the
interchange format ffmpeg, x264 and mpv read, byte for byte as the JAX
package's `write_y4m` writes it; `write_wav` writes 16-bit PCM as the JAX
CLI's `_write_wav` does (clipped to +-1, x 32767, truncated), byte for byte;
`save_video` is the JAX CLI's `save_video` (scripts/generate.py:969-1045):
`.y4m` through `write_y4m` with the audio, when there is some, in a `.wav`
beside it, every other container through `ffmpeg` (H.264, with
minterpolate to `output_fps`, the audio muxed as AAC). The JAX package's MJPEG AVI/MP4 writers take
their JPEG encoder from PIL, which the port does not import, so `.avi` and
`.mov` (and any container when `ffmpeg` is not on PATH) are refused by
`check_output`, which the CLI runs before it builds any model.
"""

from __future__ import annotations

import os
import shutil
import wave
import subprocess
import tempfile
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

NO_JPEG = ("the MJPEG {suffix} writer needs a JPEG encoder, which the port does not have (the JAX package takes "
           "it from PIL): write .y4m, or another container through ffmpeg")
NO_FFMPEG = "writing {suffix} needs ffmpeg on PATH (not found): write .y4m instead"


def rgb_to_ycbcr601(frames_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(..., 3) uint8 RGB -> limited-range BT.601 (y, cb, cr) float32 planes:
    Y' in [16, 235], chroma in [16, 240] around 128."""
    rgb = frames_u8.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yf = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - yf) / 1.772
    cr = (r - yf) / 1.402
    y = yf * (219.0 / 255.0) + 16.0
    u = cb * (224.0 / 255.0) + 128.0
    v = cr * (224.0 / 255.0) + 128.0
    return y, u, v


def y4m_header(width: int, height: int, fps: float) -> bytes:
    rate = Fraction(fps).limit_denominator(1_000_000)
    return f"YUV4MPEG2 W{width} H{height} F{rate.numerator}:{rate.denominator} Ip A1:1 C444\n".encode("ascii")


def write_y4m(path: str, frames_u8: np.ndarray, fps: float) -> None:
    """Write (F, H, W, 3) uint8 RGB as YUV4MPEG2 C444: the header, then per
    frame `FRAME\\n` and the Y, Cb and Cr planes, each rounded and clipped
    to uint8. A file of len(header) + F * (6 + 3 * H * W) bytes."""
    frames_u8 = np.asarray(frames_u8, np.uint8)
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) uint8, got {frames_u8.shape}")
    f, h, w, _ = frames_u8.shape
    with open(path, "wb") as fh:
        fh.write(y4m_header(w, h, fps))
        planes = [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in rgb_to_ycbcr601(frames_u8)]
        for i in range(f):
            fh.write(b"FRAME\n")
            for plane in planes:
                fh.write(plane[i].tobytes())


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """(channels, samples) float audio -> 16-bit PCM WAV: clipped to +-1,
    times 32767, truncated toward zero."""
    audio = np.clip(np.asarray(audio, np.float32), -1, 1)
    pcm = (audio.T * 32767).astype(np.int16)
    with wave.open(path, "w") as wf:
        wf.setnchannels(audio.shape[0])
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def _suffix(path: str) -> str:
    return path.rsplit(".", 1)[-1].lower() if "." in os.path.basename(path) else ""


def check_output(path: str) -> None:
    """Raise ValueError if `save_video` could not write `path`: `.avi` and
    `.mov` (no JPEG encoder), or a container other than `.y4m` without
    `ffmpeg` on PATH."""
    suffix = _suffix(path)
    if suffix in ("avi", "mov"):
        raise ValueError(NO_JPEG.format(suffix=f".{suffix}"))
    if suffix != "y4m" and shutil.which("ffmpeg") is None:
        raise ValueError(NO_FFMPEG.format(suffix=f".{suffix}" if suffix else "a file without a suffix"))


def save_video(frames: np.ndarray, output: str, fps: float, output_fps: Optional[float] = None,
               speed: float = 1.0, audio: Optional[np.ndarray] = None, audio_sample_rate: int = 24000) -> None:
    """The JAX CLI's `save_video`: `speed` scales the container rate (and
    `output_fps`); `.y4m` through `write_y4m`, and the (channels, samples)
    or (1, channels, samples) `audio` at `audio_sample_rate` into
    `<base>.wav` beside it; any other container through ffmpeg's H.264
    (CRF 18, yuv420p), with minterpolate up to `output_fps` when it is above
    the rate, and the audio as AAC (`-shortest`)."""
    check_output(output)
    if speed != 1.0:
        fps = fps * speed
        if output_fps:
            output_fps = output_fps * speed
    if audio is not None:
        audio = np.asarray(audio, np.float32)
        audio = audio[0] if audio.ndim == 3 else audio
    if _suffix(output) == "y4m":
        write_y4m(output, frames, fps)
        if audio is not None:
            write_wav(output.rsplit(".", 1)[0] + ".wav", audio, audio_sample_rate)
        return
    h, w = frames.shape[1:3]
    with tempfile.TemporaryDirectory() as td:
        raw_path = os.path.join(td, "frames.raw")
        with open(raw_path, "wb") as f:
            f.write(np.ascontiguousarray(frames).tobytes())
        cmd = ["ffmpeg", "-y", "-v", "error", "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{w}x{h}",
               "-r", str(fps), "-i", raw_path]
        if audio is not None:
            audio_path = os.path.join(td, "audio.wav")
            write_wav(audio_path, audio, audio_sample_rate)
            cmd += ["-i", audio_path]
        if output_fps and output_fps > fps:
            cmd += ["-vf", f"minterpolate=fps={output_fps}:mi_mode=mci:mc_mode=aobmc:vsbmc=1"]
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", "-crf", "18"]
        if audio is not None:
            cmd += ["-c:a", "aac", "-shortest"]
        subprocess.run(cmd + [output], check=True)
