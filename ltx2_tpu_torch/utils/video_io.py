"""Video files out, numpy only (counterpart of the writers in
ltx2_tpu/utils/video_io.py and the JAX CLI's save path).

`write_y4m` writes lossless YUV4MPEG2 (C444, 8-bit, progressive), the
interchange format ffmpeg, x264 and mpv read, byte for byte as the JAX
package's `write_y4m` writes it; `write_wav` writes 16-bit PCM as the JAX
CLI's `_write_wav` does (clipped to +-1, x 32767, truncated), byte for byte.
`write_avi_mjpeg` (an MJPEG AVI with the audio interleaved as per-frame
`01wb` PCM chunks) and `write_mp4_mjpeg` (ISO-BMFF: a QuickTime `.mov` with
a `jpeg` sample entry, or an `.mp4`/`.m4v` whose `mp4v` entry's esds names
JPEG, the audio a `sowt` PCM track) write the JAX package's files byte for
byte: their JPEGs come from the port's encoder (`utils/jpeg.encode_jpeg`,
equal to PIL's at quality 92). `save_video` is the JAX CLI's `save_video`
and `_save_video_fallback` (scripts/generate.py:969-1078): `speed` scales
the rate; `.avi`, `.mov` and `.y4m` through the writers here (`.y4m` with
`<base>.wav` beside it); with `ffmpeg` on PATH every other container through
its H.264 (minterpolate to `output_fps`, the audio as AAC); without it an
`.mp4`/`.m4v` is written by `write_mp4_mjpeg` and any other name becomes
`<base>.avi`, each with `<base>.gif` (a preview, `utils/gif.write_gif`),
`<base>_frames.npz` (`frames`, `fps`) and `<base>.wav` when there is audio.
No container is refused, as the JAX CLI refuses none.

Audio in (the a2vid pipeline's source from a container): `read_avi_audio`
takes the 16-bit PCM stream of an AVI (the RIFF `hdrl` stream headers
walked for an `auds` stream, its `NNwb` chunks of the `movi` list
concatenated), `read_mov_audio` the `sowt` / `twos` 16-bit PCM track of a
.mov/.mp4 (the sample tables walked: `stsc` runs over `stco`/`co64` chunk
offsets and `stsz` sizes, the rate from `mdhd`'s timescale); each returns
((channels, N) float32 / 32767, rate), or None for a file without such a
track, as the JAX package's readers do. Bytes only, stdlib `struct`.

Video in (retake's source, ic-lora's control video, `prepare_data
--videos`), the JAX package's readers (ltx2_tpu/utils/video_io.py) without
PIL: every reader returns float32 (1, 3, F, H, W) in [-1, 1], each frame
resized with PIL's 8-bit BILINEAR (`_resize_frame`, `image_io.resize`, bit
for bit) and the count trimmed or its last frame repeated (`_pack`).
`read_y4m` reads YUV4MPEG2 at C420* and C444, 8-bit (nearest chroma
upsampling, the limited-range BT.601 inverse in the JAX reader's float32
order of operations); `read_avi_mjpeg` one MJPEG video stream of an AVI
(chosen by its `strl` headers, any `dc` chunk when they do not parse);
`read_mov_mjpeg` the MJPEG video track of a .mov/.mp4 (`jpeg`, `mjpa`,
`AVDJ`, `dmb1`, or `mp4v` whose esds names JPEG); each JPEG frame through the
port's baseline decoder (`utils/jpeg.py`, equal to PIL's decode). GIFs go
through `utils/gif.decode_gif` and animated PNGs (`.apng`, or a `.png` with
an `acTL` chunk) through `utils/image_io.read_apng`, each equal to PIL's
frames; a PNG without `acTL` is one frame (`read_png`: every color type,
bit depth and interlace, as `convert("RGB")` gives it). `probe_video` /
`probe_mov` give (fps, frames, height, width); `read_video_any` dispatches
by suffix and codec, then to OpenCV when it is installed (`read_cv2`,
optional, as in the JAX package), then to the ffmpeg pipe
(`pipelines/retake.load_video_frames`). WebP, still or animated, goes
through `utils/webp.read_webp_frames` (VP8, VP8L, alpha and animation
compositing as libwebp's `WebPAnimDecoder`, equal to PIL's frames).
"""

from __future__ import annotations

import os
import re
import shutil
import struct
import wave
import subprocess
import sys
import tempfile
from fractions import Fraction
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.utils.gif import decode_gif, gif_info, write_gif
from ltx2_tpu_torch.utils.image_io import BILINEAR, PNG_SIGNATURE, apng_info, read_apng, read_png, resize
from ltx2_tpu_torch.utils.jpeg import decode_jpeg, encode_jpegs
from ltx2_tpu_torch.utils.webp import read_webp_frames, webp_info

# What decodes without ffmpeg, as the JAX package's lists.
PIL_SUFFIXES = (".gif", ".webp", ".apng", ".png")
PURE_PYTHON_SUFFIXES = PIL_SUFFIXES + (".y4m", ".avi")
MOV_SUFFIXES = (".mov", ".mp4", ".m4v")


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


def _audio_2d(audio) -> Optional[np.ndarray]:
    """(channels, samples) float32 from (N,), (C, N) or (1, C, N) audio."""
    if audio is None:
        return None
    a = np.asarray(audio, np.float32)
    if a.ndim == 3:
        a = a[0]
    return a[None] if a.ndim == 1 else a


def save_video(frames: np.ndarray, output: str, fps: float, output_fps: Optional[float] = None,
               speed: float = 1.0, audio: Optional[np.ndarray] = None, audio_sample_rate: int = 24000) -> None:
    """The JAX CLI's `save_video`: `speed` scales the container rate (and
    `output_fps`); `.y4m` through `write_y4m` with the (channels, samples)
    or (1, channels, samples) `audio` at `audio_sample_rate` in
    `<base>.wav` beside it, `.mov` through `write_mp4_mjpeg` and `.avi`
    through `write_avi_mjpeg` with the audio inside; any other container
    through ffmpeg's H.264 (CRF 18, yuv420p), with minterpolate up to
    `output_fps` when it is above the rate and the audio as AAC
    (`-shortest`), or `_save_video_fallback` when ffmpeg is not on PATH.
    The JAX CLI's notes ("wrote ...") go to stderr: stdout carries the
    command line's and the server's JSON lines."""
    if speed != 1.0:
        fps = fps * speed
        if output_fps:
            output_fps = output_fps * speed
    suffix = _suffix(output)
    if suffix in ("avi", "y4m", "mov"):
        if suffix == "y4m":
            write_y4m(output, frames, fps)
            if audio is not None:
                write_wav(output.rsplit(".", 1)[0] + ".wav", _audio_2d(audio), audio_sample_rate)
        elif suffix == "mov":
            write_mp4_mjpeg(output, frames, fps, audio=audio, sample_rate=audio_sample_rate)
        else:
            write_avi_mjpeg(output, frames, fps, audio=audio, sample_rate=audio_sample_rate)
        print(f"wrote {output}", file=sys.stderr)
        return
    if shutil.which("ffmpeg") is None:
        _save_video_fallback(frames, output, fps, audio, audio_sample_rate)
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
            write_wav(audio_path, _audio_2d(audio), audio_sample_rate)
            cmd += ["-i", audio_path]
        if output_fps and output_fps > fps:
            cmd += ["-vf", f"minterpolate=fps={output_fps}:mi_mode=mci:mc_mode=aobmc:vsbmc=1"]
        cmd += ["-c:v", "libx264", "-pix_fmt", "yuv420p", "-crf", "18"]
        if audio is not None:
            cmd += ["-c:a", "aac", "-shortest"]
        subprocess.run(cmd + [output], check=True)


def _save_video_fallback(frames: np.ndarray, output: str, fps: float, audio, audio_sample_rate: int) -> None:
    """The JAX CLI's no-ffmpeg path: the requested `.mp4`/`.m4v` itself
    (`write_mp4_mjpeg`), any other name as `<base>.avi` (`write_avi_mjpeg`),
    each with the audio; then `<base>.gif` (`write_gif`: a frame every
    max(1, int(1000 / fps)) ms, looping), `<base>_frames.npz` (`frames`,
    `fps`) and `<base>.wav` when there is audio."""
    base = output.rsplit(".", 1)[0]
    if _suffix(output) in ("mp4", "m4v"):
        video_path = output
        write_mp4_mjpeg(output, frames, fps, audio=audio, sample_rate=audio_sample_rate)
    else:
        video_path = base + ".avi"
        write_avi_mjpeg(video_path, frames, fps, audio=audio, sample_rate=audio_sample_rate)
    gif_path = base + ".gif"
    write_gif(gif_path, frames, max(1, int(1000 / fps)))
    np.savez(base + "_frames.npz", frames=frames, fps=fps)
    if audio is not None:
        write_wav(base + ".wav", _audio_2d(audio), audio_sample_rate)
    print(f"ffmpeg not found - wrote {video_path}, {gif_path} and {base}_frames.npz", file=sys.stderr)


# ---- MJPEG writers -------------------------------------------------------------


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk: fourcc, little-endian size, payload padded to even."""
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list_chunk(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def _pcm_int16(audio) -> Optional[np.ndarray]:
    """(N, channels) interleaved little-endian int16 from float audio in
    [-1, 1]: rounded, as the MJPEG writers store it."""
    a = _audio_2d(audio)
    if a is None:
        return None
    return np.clip(np.round(a.T * 32767.0), -32768, 32767).astype("<i2")


def _check_frames(frames_u8) -> np.ndarray:
    frames_u8 = np.asarray(frames_u8, np.uint8)
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"expected (F, H, W, 3) uint8, got {frames_u8.shape}")
    return frames_u8


def write_avi_mjpeg(path: str, frames_u8: np.ndarray, fps: float, audio: Optional[np.ndarray] = None,
                    sample_rate: int = 24000, quality: int = 92) -> None:
    """(F, H, W, 3) uint8 RGB -> an AVI of MJPEG video (`00dc` chunks) and,
    with `audio` (float in [-1, 1], (N,), (C, N) or (1, C, N)), 16-bit PCM
    cut into one `01wb` chunk after each frame (the last takes the tail),
    with an idx1 index; the JAX package's bytes."""
    frames_u8 = _check_frames(frames_u8)
    num_frames, h, w, _ = frames_u8.shape
    jpegs = encode_jpegs(frames_u8, quality)
    pcm = _pcm_int16(audio)
    channels = 0 if pcm is None else pcm.shape[1]
    rate, scale = max(1, int(round(fps * 1000))), 1000
    usec_per_frame = int(round(1_000_000 * scale / rate))
    # MainAVIHeader: flags 0x10 = AVIF_HASINDEX.
    avih = struct.pack("<14I", usec_per_frame, 0, 0, 0x10, num_frames, 0, 2 if pcm is not None else 1, 0, w, h,
                       0, 0, 0, 0)
    strh_v = struct.pack("<4s4sI2H8I4H", b"vids", b"MJPG", 0, 0, 0, 0, scale, rate, 0, num_frames,
                         max(len(j) for j in jpegs), 0xFFFFFFFF, 0, 0, 0, w, h)
    # BITMAPINFOHEADER with 'MJPG' compression.
    strf_v = struct.pack("<I2i2H2I2i2I", 40, w, h, 1, 24, struct.unpack("<I", b"MJPG")[0], w * h * 3, 0, 0, 0, 0)
    strl = _list_chunk(b"strl", _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))
    audio_chunks: list = []
    if pcm is not None:
        block_align = 2 * channels
        strh_a = struct.pack("<4s4sI2H8I4H", b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0, 1, sample_rate, 0,
                             pcm.shape[0], sample_rate * block_align, 0xFFFFFFFF, block_align, 0, 0, 0, 0)
        strf_a = struct.pack("<2H2I2H", 1, channels, sample_rate, sample_rate * block_align, block_align, 16)
        strl += _list_chunk(b"strl", _chunk(b"strh", strh_a) + _chunk(b"strf", strf_a))
        edges = np.linspace(0, pcm.shape[0], num_frames + 1).astype(np.int64)
        audio_chunks = [pcm[edges[i]:edges[i + 1]].tobytes() for i in range(num_frames)]
    hdrl = _list_chunk(b"hdrl", _chunk(b"avih", avih) + strl)
    # The movi payload and idx1 (offsets from the 'movi' fourcc).
    movi_parts, idx_parts, offset = [], [], 4
    for i, jpeg in enumerate(jpegs):
        part = _chunk(b"00dc", jpeg)
        movi_parts.append(part)
        idx_parts.append(struct.pack("<4s3I", b"00dc", 0x10, offset, len(jpeg)))
        offset += len(part)
        if audio_chunks and audio_chunks[i]:
            part = _chunk(b"01wb", audio_chunks[i])
            movi_parts.append(part)
            idx_parts.append(struct.pack("<4s3I", b"01wb", 0x10, offset, len(audio_chunks[i])))
            offset += len(part)
    movi = _list_chunk(b"movi", b"".join(movi_parts))
    with open(path, "wb") as fh:
        fh.write(_chunk(b"RIFF", b"AVI " + hdrl + movi + _chunk(b"idx1", b"".join(idx_parts))))


def _box(box_type: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + box_type + payload


def _full_box(box_type: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(box_type, struct.pack(">I", (version << 24) | flags) + payload)


def _esds_mjpeg() -> bytes:
    """The elementary-stream descriptor of MJPEG in MP4: objectTypeIndication
    0x6C (JPEG), streamType 4 (visual), one-byte descriptor lengths."""
    dec_cfg = struct.pack(">BB3xII", 0x6C, (4 << 2) | 1, 0, 0)
    sl_cfg = b"\x02"  # predefined = 2 (MP4)
    inner = bytes([0x04, len(dec_cfg)]) + dec_cfg + bytes([0x06, len(sl_cfg)]) + sl_cfg
    es = struct.pack(">HB", 1, 0) + inner  # ES_ID 1, no flags
    return _full_box(b"esds", 0, 0, bytes([0x03, len(es)]) + es)


def _visual_sample_entry(fourcc: bytes, w: int, h: int, extra: bytes = b"") -> bytes:
    name = b"Motion JPEG"
    compressor = bytes([len(name)]) + name + b"\x00" * (31 - len(name))
    payload = (b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 16 + struct.pack(">HH", w, h)
               + struct.pack(">II", 0x00480000, 0x00480000) + b"\x00" * 4 + struct.pack(">H", 1) + compressor
               + struct.pack(">Hh", 24, -1) + extra)
    return _box(fourcc, payload)


def _sound_sample_entry_sowt(channels: int, sample_rate: int) -> bytes:
    """A QuickTime version-0 `sowt` (16-bit little-endian PCM) entry; its
    16.16 rate caps at 65535 Hz."""
    if not 0 < sample_rate < 0x10000:
        raise ValueError(f"sample_rate {sample_rate} does not fit 16.16 fixed")
    payload = (b"\x00" * 6 + struct.pack(">H", 1) + struct.pack(">HH4x", 0, 0)
               + struct.pack(">HHHH", channels, 16, 0, 0) + struct.pack(">I", sample_rate << 16))
    return _box(b"sowt", payload)


_MOV_MATRIX = b"\x00\x01\x00\x00" + b"\x00" * 12 + b"\x00\x01\x00\x00" + b"\x00" * 12 + b"\x40\x00\x00\x00"


def _tkhd(track_id: int, duration_mv: int, w: int = 0, h: int = 0, volume: int = 0) -> bytes:
    payload = (struct.pack(">II", 0, 0) + struct.pack(">I4xI8x", track_id, duration_mv)
               + struct.pack(">HHH2x", 0, 0, volume) + _MOV_MATRIX + struct.pack(">II", w << 16, h << 16))
    return _full_box(b"tkhd", 0, 7, payload)  # enabled | in_movie | in_preview


def _mdhd(timescale: int, duration: int) -> bytes:
    return _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))  # 'und'


def _hdlr(handler: bytes, name: bytes) -> bytes:
    return _full_box(b"hdlr", 0, 0, b"\x00" * 4 + handler + b"\x00" * 12 + name + b"\x00")


def _dinf() -> bytes:
    url = _full_box(b"url ", 0, 1, b"")  # flag 1: the data is in this file
    return _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1) + url))


def _stbl(sample_entry: bytes, sample_count: int, sample_delta: int, sample_sizes, chunk_offset: int) -> bytes:
    """The sample table of one track whose samples lie in one chunk."""
    stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + sample_entry)
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, sample_count, sample_delta))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, sample_count, 1))
    if isinstance(sample_sizes, int):  # constant-size samples (PCM)
        stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", sample_sizes, sample_count))
    else:
        stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, len(sample_sizes))
                         + b"".join(struct.pack(">I", s) for s in sample_sizes))
    stco = _full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    return _box(b"stbl", stsd + stts + stsc + stsz + stco)


def write_mp4_mjpeg(path: str, frames_u8: np.ndarray, fps: float, audio: Optional[np.ndarray] = None,
                    sample_rate: int = 24000, quality: int = 92) -> None:
    """(F, H, W, 3) uint8 RGB -> a `.mov` (QuickTime brand, `jpeg` entry) or,
    by any other suffix, an `.mp4` (`isom`, `mp4v` with a JPEG esds): the
    JPEGs then the PCM in one mdat, the moov last; video at round(fps x
    1000) ticks a second, 1000 a frame; the JAX package's bytes."""
    frames_u8 = _check_frames(frames_u8)
    num_frames, h, w, _ = frames_u8.shape
    is_mov = path.lower().endswith(".mov")
    jpegs = encode_jpegs(frames_u8, quality)
    video_bytes = b"".join(jpegs)
    pcm_i16 = _pcm_int16(audio)
    channels = 0 if pcm_i16 is None else pcm_i16.shape[1]
    pcm_frames = 0 if pcm_i16 is None else pcm_i16.shape[0]
    pcm = b"" if pcm_i16 is None else pcm_i16.tobytes()
    v_timescale, v_delta = max(1, int(round(fps * 1000))), 1000
    mv_timescale = 1000
    mv_duration = int(round(num_frames / fps * mv_timescale)) if fps else 0
    if pcm_frames:
        mv_duration = max(mv_duration, int(round(pcm_frames / sample_rate * mv_timescale)))
    if is_mov:
        ftyp = _box(b"ftyp", b"qt  " + struct.pack(">I", 0x20050300) + b"qt  ")
        v_entry = _visual_sample_entry(b"jpeg", w, h)
    else:
        ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isom" + b"mp41")
        v_entry = _visual_sample_entry(b"mp4v", w, h, extra=_esds_mjpeg())
    video_chunk_off = len(ftyp) + 8  # absolute file offsets into the mdat
    audio_chunk_off = video_chunk_off + len(video_bytes)
    mdat = _box(b"mdat", video_bytes + pcm)
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, mv_timescale, mv_duration)
                     + struct.pack(">IH2x8x", 0x00010000, 0x0100) + _MOV_MATRIX + b"\x00" * 24
                     + struct.pack(">I", 3 if pcm_frames else 2))
    v_minf = _box(b"minf", _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0)) + _dinf()
                  + _stbl(v_entry, num_frames, v_delta, [len(j) for j in jpegs], video_chunk_off))
    v_mdia = _box(b"mdia", _mdhd(v_timescale, num_frames * v_delta) + _hdlr(b"vide", b"VideoHandler") + v_minf)
    traks = _box(b"trak", _tkhd(1, mv_duration, w, h) + v_mdia)
    if pcm_frames:
        a_minf = _box(b"minf", _full_box(b"smhd", 0, 0, struct.pack(">Hxx", 0)) + _dinf()
                      + _stbl(_sound_sample_entry_sowt(channels, sample_rate), pcm_frames, 1, 2 * channels,
                              audio_chunk_off))
        a_mdia = _box(b"mdia", _mdhd(sample_rate, pcm_frames) + _hdlr(b"soun", b"SoundHandler") + a_minf)
        traks += _box(b"trak", _tkhd(2, mv_duration, volume=0x0100) + a_mdia)
    with open(path, "wb") as fh:
        fh.write(ftyp)
        fh.write(mdat)
        fh.write(_box(b"moov", mvhd + traks))


def _avi_chunks(data: bytes):
    """(fourcc, payload offset, size) of every chunk of the AVI's `movi`
    list (nested `rec ` lists included), in file order."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not a RIFF/AVI file")

    def walk(start: int, end: int):
        pos = start
        while pos + 8 <= end:
            fourcc = data[pos:pos + 4]
            (size,) = struct.unpack_from("<I", data, pos + 4)
            body = pos + 8
            if fourcc == b"LIST":
                if data[body:body + 4] in (b"movi", b"rec "):
                    yield from walk(body + 4, body + size)
            else:
                yield fourcc, body, size
            pos = body + size + (size % 2)

    (outer_size,) = struct.unpack_from("<I", data, 4)
    yield from walk(12, min(len(data), 8 + outer_size))


def _avi_stream_headers(data: bytes):
    """(stream index, fccType, strf payload) of each `strl` list of the
    `hdrl` list, walked by its structure (no byte scan can false-match)."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not a RIFF/AVI file")
    pos, end = 12, min(len(data), 8 + struct.unpack_from("<I", data, 4)[0])
    while pos + 12 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if fourcc == b"LIST" and data[body:body + 4] == b"hdrl":
            idx, p2, hend = 0, body + 4, body + size
            while p2 + 8 <= hend:
                fc2 = data[p2:p2 + 4]
                (sz2,) = struct.unpack_from("<I", data, p2 + 4)
                b2 = p2 + 8
                if fc2 == b"LIST" and data[b2:b2 + 4] == b"strl":
                    fcc_type = strf = None
                    p3, send = b2 + 4, b2 + sz2
                    while p3 + 8 <= send:
                        fc3 = data[p3:p3 + 4]
                        (sz3,) = struct.unpack_from("<I", data, p3 + 4)
                        if fc3 == b"strh":
                            fcc_type = data[p3 + 8:p3 + 12]
                        elif fc3 == b"strf":
                            strf = data[p3 + 8:p3 + 8 + sz3]
                        p3 += 8 + sz3 + (sz3 % 2)
                    yield idx, fcc_type, strf
                    idx += 1
                p2 = b2 + sz2 + (sz2 % 2)
            return
        pos = body + size + (size % 2)


def _pcm16(raw: bytes, dtype: str, channels: int) -> np.ndarray:
    pcm = np.frombuffer(raw, dtype)
    n = len(pcm) // channels
    return pcm[:n * channels].reshape(n, channels).T.astype(np.float32) / 32767.0


def read_avi_audio(path: str):
    """An AVI's first audio stream if it is 16-bit PCM: ((channels, N)
    float32 in [-1, 1], sample rate), else None."""
    with open(path, "rb") as fh:
        data = fh.read()
    stream = next(((idx, strf) for idx, fcc_type, strf in _avi_stream_headers(data)
                   if fcc_type == b"auds" and strf is not None and len(strf) >= 16), None)
    if stream is None:
        return None
    idx, strf = stream
    fmt_tag, channels, sample_rate = struct.unpack_from("<2HI", strf, 0)
    bits = struct.unpack_from("<H", strf, 14)[0]
    if fmt_tag != 1 or bits != 16 or channels == 0:  # PCM only
        return None
    stream_cc = b"%02d" % idx  # this stream's chunks only ('01wb', ...)
    parts = [data[off:off + size] for fourcc, off, size in _avi_chunks(data)
             if fourcc[2:] == b"wb" and fourcc[:2] == stream_cc and size > 0]
    if not parts:
        return None
    return _pcm16(b"".join(parts), "<i2", channels), int(sample_rate)


def _mov_boxes(data: bytes, start: int, end: int):
    """(type, body start, box end) of each ISO-BMFF box in a span (64-bit
    largesize and size 0, to the span's end, included)."""
    pos = start
    while pos + 8 <= end:
        (size,) = struct.unpack_from(">I", data, pos)
        typ, hdr = data[pos + 4:pos + 8], 8
        if size == 1:
            if pos + 16 > end:
                return
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield typ, pos + hdr, pos + size
        pos += size


def _mov_find(data: bytes, start: int, end: int, *path: bytes):
    """The first box along a nested type path: (body, end), or None."""
    for typ, body, box_end in _mov_boxes(data, start, end):
        if typ == path[0]:
            return (body, box_end) if len(path) == 1 else _mov_find(data, body, box_end, *path[1:])
    return None


def _mdhd_timescale(mdhd: bytes) -> int:
    """The media timescale: offset 20 in a version-1 mdhd (64-bit times), else 12."""
    (timescale,) = struct.unpack_from(">I", mdhd, 20 if mdhd[0] == 1 else 12)
    return timescale


def _mov_tracks(data: bytes):
    """(handler, stbl span, mdhd payload) of each trak of the moov."""
    moov = _mov_find(data, 0, len(data), b"moov")
    if moov is None:
        raise ValueError("not an ISO-BMFF (mov/mp4) file: no moov box")
    for typ, body, box_end in _mov_boxes(data, *moov):
        if typ != b"trak":
            continue
        mdia = _mov_find(data, body, box_end, b"mdia")
        if mdia is None:
            continue
        hdlr, mdhd = _mov_find(data, *mdia, b"hdlr"), _mov_find(data, *mdia, b"mdhd")
        stbl = _mov_find(data, *mdia, b"minf", b"stbl")
        if hdlr is None or stbl is None or mdhd is None:
            continue
        yield data[hdlr[0] + 8:hdlr[0] + 12], stbl, data[mdhd[0]:mdhd[1]]


def _mov_sample_table(data: bytes, stbl):
    """One track's (first sample entry's fourcc, its payload, sample
    offsets, sample sizes, stts (count, delta) entries)."""
    stsd, stsc, stsz, stts = (_mov_find(data, *stbl, box) for box in (b"stsd", b"stsc", b"stsz", b"stts"))
    stco, co64 = _mov_find(data, *stbl, b"stco"), _mov_find(data, *stbl, b"co64")
    if stsd is None or stsc is None or stsz is None or (stco is None and co64 is None):
        raise ValueError("mov/mp4 track is missing required sample tables")
    entry_off = stsd[0] + 8  # version/flags + entry_count
    (entry_size,) = struct.unpack_from(">I", data, entry_off)
    fourcc = data[entry_off + 4:entry_off + 8]
    entry_payload = data[entry_off + 8:entry_off + entry_size]
    table, fmt = (stco, "I") if stco is not None else (co64, "Q")
    (n_chunks,) = struct.unpack_from(">I", data, table[0] + 4)
    chunk_offsets = list(struct.unpack_from(f">{n_chunks}{fmt}", data, table[0] + 8))
    const_size, n_samples = struct.unpack_from(">II", data, stsz[0] + 4)
    sizes = ([const_size] * n_samples if const_size
             else list(struct.unpack_from(f">{n_samples}I", data, stsz[0] + 12)))
    (n_stsc,) = struct.unpack_from(">I", data, stsc[0] + 4)
    runs = [struct.unpack_from(">III", data, stsc[0] + 8 + 12 * i) for i in range(n_stsc)]
    per_chunk: list = []  # samples per chunk, from the first-chunk runs
    for i, (first, per, _desc) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else n_chunks
        per_chunk.extend([per] * max(0, last - first + 1))
    offsets, si = [], 0
    for ci, off in enumerate(chunk_offsets):
        for _ in range(per_chunk[ci] if ci < len(per_chunk) else 0):
            if si >= n_samples:
                break
            offsets.append(off)
            off += sizes[si]
            si += 1
    stts_entries = []
    if stts is not None:
        (n_stts,) = struct.unpack_from(">I", data, stts[0] + 4)
        stts_entries = [struct.unpack_from(">II", data, stts[0] + 8 + 8 * i) for i in range(n_stts)]
    return fourcc, entry_payload, offsets, sizes, stts_entries


def read_mov_audio(path: str):
    """A .mov/.mp4's first sound track if it is 16-bit PCM (`sowt` little-,
    `twos` big-endian): ((channels, N) float32 in [-1, 1], the track's
    timescale as the rate), else None."""
    with open(path, "rb") as fh:
        data = fh.read()
    for handler, stbl, mdhd in _mov_tracks(data):
        if handler != b"soun":
            continue
        fourcc, entry, offsets, sizes, _stts = _mov_sample_table(data, stbl)
        if fourcc not in (b"sowt", b"twos"):
            return None
        # A version-0 sound entry: channels at +16, bits at +18.
        channels, bits = struct.unpack_from(">HH", entry, 16)
        if bits != 16 or channels == 0:
            return None
        raw = b"".join(data[o:o + n] for o, n in zip(offsets, sizes))
        return _pcm16(raw, "<i2" if fourcc == b"sowt" else ">i2", channels), int(_mdhd_timescale(mdhd))
    return None


# ---- video readers -----------------------------------------------------------


def _resize_frame(frame_u8: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (height, width, 3) uint8, PIL's 8-bit BILINEAR."""
    if frame_u8.shape[0] == height and frame_u8.shape[1] == width:
        return frame_u8
    return resize(torch.from_numpy(np.ascontiguousarray(frame_u8)), width, height, BILINEAR).numpy()


def _pack(frames: list, height: int, width: int, num_frames: int) -> np.ndarray:
    """The first `num_frames` frames (the last repeated when fewer), each
    resized -> float32 (1, 3, F, H, W) in [-1, 1]."""
    frames = frames[:num_frames]
    while len(frames) < num_frames:
        frames.append(frames[-1])
    stack = np.stack([_resize_frame(f, height, width) for f in frames], axis=0)
    video = stack.astype(np.float32) / 127.5 - 1.0
    return video.transpose(3, 0, 1, 2)[None]


def _png_is_animated(path: str) -> bool:
    """True when a PNG holds an `acTL` chunk (APNG), read chunk by chunk up
    to the first IDAT."""
    with open(path, "rb") as fh:
        if fh.read(8) != PNG_SIGNATURE:
            raise ValueError(f"{path}: not a PNG file")
        while True:
            head = fh.read(8)
            if len(head) < 8:
                return False
            length, kind = struct.unpack(">I4s", head)
            if kind == b"acTL":
                return True
            if kind in (b"IDAT", b"IEND"):
                return False
            fh.seek(length + 4, os.SEEK_CUR)


def _animation_frames(path: str, max_frames: Optional[int] = None) -> list:
    """A GIF's, a WebP's or an animated PNG's frames, uint8 (H, W, 3), as PIL
    gives them."""
    suffix = Path(path).suffix.lower()
    if suffix == ".webp":
        with open(path, "rb") as fh:
            return read_webp_frames(fh.read(), max_frames)
    if suffix == ".gif":
        with open(path, "rb") as fh:
            return decode_gif(fh.read(), path, max_frames)
    return read_apng(path, max_frames)


def read_pil_animation(path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """A GIF, a WebP, an APNG (`.apng`, or a `.png` with `acTL`) or a still
    PNG -> (1, 3, F, H, W) in [-1, 1], the frames PIL's `ImageSequence`
    gives (`decode_gif`, `read_webp_frames`, `read_apng`, `read_png`)."""
    if Path(path).suffix.lower() == ".png" and not _png_is_animated(path):
        return _pack([read_png(path)], height, width, num_frames)
    frames = _animation_frames(path, num_frames)
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return _pack(frames, height, width, num_frames)


def _parse_y4m_header(raw_header: bytes, path: str):
    """The stream header line -> (w, h, fps, colorspace tag); raises on a
    stream that is not y4m or has no geometry."""
    header = raw_header.decode("ascii", "replace").strip()
    if not header.startswith("YUV4MPEG2"):
        raise ValueError(f"{path}: not a YUV4MPEG2 stream")
    w = h = None
    fps, cs = 24.0, "420"
    for token in header.split()[1:]:
        if token.startswith("W"):
            w = int(token[1:])
        elif token.startswith("H"):
            h = int(token[1:])
        elif token.startswith("F"):
            num, den = token[1:].split(":")
            fps = float(num) / float(den)
        elif token.startswith("C"):
            cs = token[1:]
    if not w or not h:
        raise ValueError(f"{path}: missing W/H in y4m header")
    return w, h, fps, cs


def _y4m_chroma_geometry(cs: str, w: int, h: int, path: str):
    """The colorspace tag -> (subsample, chroma_w, chroma_h), shared by
    read_y4m and probe_video."""
    if re.search(r"p(9|10|12|14|16)$", cs):
        # High bit depths double the plane bytes ("p" alone belongs to
        # chroma-siting tags such as 420paldv).
        raise ValueError(f"{path}: only 8-bit y4m supported, got C{cs}")
    if cs.startswith("420"):
        return 2, (w + 1) // 2, (h + 1) // 2
    if cs.startswith("444"):
        return 1, w, h
    raise ValueError(f"{path}: unsupported y4m colorspace C{cs}")


def read_y4m(path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """YUV4MPEG2 (C420* or C444, 8-bit) -> (1, 3, F, H, W) in [-1, 1]:
    nearest chroma upsampling, then the limited-range BT.601 inverse in
    float32, truncated to uint8 after clipping, as the JAX reader does."""
    with open(path, "rb") as fh:
        w, h, _fps, cs = _parse_y4m_header(fh.readline(), path)
        sub, cw, ch = _y4m_chroma_geometry(cs, w, h, path)
        ysize, csize = w * h, cw * ch
        frames = []
        while len(frames) < num_frames:
            marker = fh.readline()
            if not marker:
                break
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {marker[:16]!r}")
            raw = fh.read(ysize + 2 * csize)
            if len(raw) < ysize + 2 * csize:
                break
            y = np.frombuffer(raw, np.uint8, ysize).reshape(h, w).astype(np.float32)
            u = np.frombuffer(raw, np.uint8, csize, ysize).reshape(ch, cw)
            v = np.frombuffer(raw, np.uint8, csize, ysize + csize).reshape(ch, cw)
            if sub == 2:
                u = u.repeat(2, 0)[:h].repeat(2, 1)[:, :w]
                v = v.repeat(2, 0)[:h].repeat(2, 1)[:, :w]
            u = u.astype(np.float32) - 128.0
            v = v.astype(np.float32) - 128.0
            yf = (y - 16.0) * (255.0 / 219.0)
            uf = u * (255.0 / 224.0)
            vf = v * (255.0 / 224.0)
            r = yf + 1.402 * vf
            g = yf - 0.344136 * uf - 0.714136 * vf
            b = yf + 1.772 * uf
            frames.append(np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8))
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return _pack(frames, height, width, num_frames)


def read_avi_mjpeg(path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """An MJPEG AVI -> (1, 3, F, H, W) in [-1, 1]: the `dc` chunks of its
    first video stream (any `dc` chunk when the stream headers do not
    parse), each a JPEG (`decode_jpeg`); a payload that is not a JPEG
    raises."""
    with open(path, "rb") as fh:
        data = fh.read()
    video_cc = None
    try:
        for idx, fcc_type, _strf in _avi_stream_headers(data):
            if fcc_type == b"vids":
                video_cc = b"%02d" % idx
                break
    except ValueError:
        pass  # the hdrl does not parse: any dc chunk
    frames = []
    for fourcc, off, size in _avi_chunks(data):
        if fourcc[2:] == b"dc" and size > 0 and (video_cc is None or fourcc[:2] == video_cc):
            payload = data[off:off + size]
            if not payload.startswith(b"\xff\xd8"):
                raise ValueError(f"{path}: stream {fourcc[:2].decode()} is not MJPEG (only MJPEG AVIs decode "
                                 "without ffmpeg)")
            frames.append(decode_jpeg(payload, f"{path} frame {len(frames)}"))
            if len(frames) >= num_frames:
                break
    if not frames:
        raise ValueError(f"no MJPEG frames decoded from {path}")
    return _pack(frames, height, width, num_frames)


def _read_moov_bytes(path: str) -> bytes:
    """Only the moov box (its header included), found by seeking over the
    top-level boxes: a probe does not read the media data."""
    with open(path, "rb") as fh:
        fh.seek(0, 2)
        file_end = fh.tell()
        pos = 0
        while pos + 8 <= file_end:
            fh.seek(pos)
            hdr = fh.read(16)
            if len(hdr) < 8:
                break
            (size,) = struct.unpack_from(">I", hdr, 0)
            typ = hdr[4:8]
            if size == 1:
                if len(hdr) < 16:
                    break
                (size,) = struct.unpack_from(">Q", hdr, 8)
            elif size == 0:
                size = file_end - pos
            if size < 8 or pos + size > file_end:
                break
            if typ == b"moov":
                fh.seek(pos)
                return fh.read(size)
            pos += size
    raise ValueError(f"{path}: not an ISO-BMFF (mov/mp4) file: no moov box")


MOV_JPEG_FOURCCS = (b"jpeg", b"mjpa", b"AVDJ", b"dmb1")
VISUAL_ENTRY_FIXED = 78  # bytes of a VisualSampleEntry before its extension boxes


def _desc_len(buf: bytes, pos: int):
    """An MPEG-4 descriptor length: 7 bits a byte, the top bit continues."""
    length = 0
    while pos < len(buf):
        b = buf[pos]
        pos += 1
        length = (length << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return length, pos


def _esds_oti(entry_payload: bytes):
    """The objectTypeIndication of an mp4v entry's esds box (0x6C JPEG,
    0x20 MPEG-4 Visual, ...), or None."""
    for typ, body, end in _mov_boxes(entry_payload, VISUAL_ENTRY_FIXED, len(entry_payload)):
        if typ != b"esds":
            continue
        buf = entry_payload[body:end]
        pos = 4  # version/flags
        if pos >= len(buf) or buf[pos] != 0x03:  # ES_Descriptor
            return None
        _, pos = _desc_len(buf, pos + 1)
        if pos + 3 > len(buf):
            return None
        es_flags = buf[pos + 2]
        pos += 3  # ES_ID + flags/priority
        if es_flags & 0x80:  # streamDependenceFlag
            pos += 2
        if es_flags & 0x40:  # URL_Flag
            if pos >= len(buf):
                return None
            pos += 1 + buf[pos]
        if es_flags & 0x20:  # OCRstreamFlag
            pos += 2
        if pos >= len(buf) or buf[pos] != 0x04:  # DecoderConfigDescriptor
            return None
        _, pos = _desc_len(buf, pos + 1)
        return buf[pos] if pos < len(buf) else None
    return None


def _entry_is_mjpeg(fourcc: bytes, entry_payload: bytes) -> bool:
    """True when a video sample entry carries Motion-JPEG; `mp4v` only when
    its esds names JPEG (0x6C): MPEG-4 Part 2 uses the fourcc too."""
    if fourcc in MOV_JPEG_FOURCCS:
        return True
    if fourcc == b"mp4v":
        return _esds_oti(entry_payload) == 0x6C
    return False


def mov_video_codec(path: str) -> Optional[bytes]:
    """The video track's sample-entry fourcc (b'jpeg', b'avc1', ...), or
    None without a video track."""
    data = _read_moov_bytes(path)
    for handler, stbl, _mdhd in _mov_tracks(data):
        if handler == b"vide":
            stsd = _mov_find(data, *stbl, b"stsd")
            if stsd is None:
                return None
            return data[stsd[0] + 12:stsd[0] + 16]
    return None


def mov_is_mjpeg(path: str) -> bool:
    """Whether a .mov/.mp4's video track is MJPEG (decodes here) or needs a
    real codec (OpenCV or ffmpeg)."""
    data = _read_moov_bytes(path)
    for handler, stbl, _mdhd in _mov_tracks(data):
        if handler != b"vide":
            continue
        fourcc, entry, _offsets, _sizes, _stts = _mov_sample_table(data, stbl)
        return _entry_is_mjpeg(fourcc, entry)
    return False


def read_mov_mjpeg(path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """An MJPEG .mov/.mp4 -> (1, 3, F, H, W) in [-1, 1]: the video track's
    samples, each a JPEG (`decode_jpeg`)."""
    with open(path, "rb") as fh:
        data = fh.read()
    for handler, stbl, _mdhd in _mov_tracks(data):
        if handler != b"vide":
            continue
        fourcc, entry, offsets, sizes, _stts = _mov_sample_table(data, stbl)
        if not _entry_is_mjpeg(fourcc, entry):
            raise ValueError(f"{path}: video codec {fourcc!r} is not MJPEG (only MJPEG mov/mp4 decode without "
                             "ffmpeg)")
        frames = []
        for off, size in zip(offsets, sizes):
            payload = data[off:off + size]
            if not payload.startswith(b"\xff\xd8"):
                raise ValueError(f"{path}: sample at {off} is not a JPEG")
            frames.append(decode_jpeg(payload, f"{path} frame {len(frames)}"))
            if len(frames) >= num_frames:
                break
        if not frames:
            raise ValueError(f"no MJPEG frames decoded from {path}")
        return _pack(frames, height, width, num_frames)
    raise ValueError(f"{path}: no video track")


def probe_mov(path: str):
    """(fps, frames, height, width) of a .mov/.mp4's video track, any codec
    (the sample tables do not depend on it)."""
    data = _read_moov_bytes(path)
    for handler, stbl, mdhd in _mov_tracks(data):
        if handler != b"vide":
            continue
        _fourcc, entry, offsets, _sizes, stts = _mov_sample_table(data, stbl)
        timescale = _mdhd_timescale(mdhd)
        w, h = struct.unpack_from(">HH", entry, 24)
        fps = 24.0
        if stts and stts[0][1]:
            fps = timescale / stts[0][1]
        return fps, len(offsets), int(h), int(w)
    raise ValueError(f"{path}: no video track")


def probe_video(path: str):
    """(fps, frames, height, width) of the formats that decode without
    ffmpeg: AVI (its avih header), y4m (its frame records walked, a
    truncated last frame not counted), a still PNG (one frame at 24 fps), a
    GIF or an APNG (PIL's `n_frames`, and 1000 / its first frame's duration,
    24 without one), a WebP (its canvas and frames; 24 fps, as PIL's `info`
    holds no duration for a WebP before a frame is loaded), .mov/.mp4
    (`probe_mov`); other suffixes raise ValueError."""
    suffix = Path(path).suffix.lower()
    if suffix == ".avi":
        with open(path, "rb") as fh:
            data = fh.read(4096)
        pos = data.find(b"avih")
        if pos < 0:
            raise ValueError(f"{path}: no avih header")
        usec_per_frame, _, _, _, total_frames = struct.unpack_from("<5I", data, pos + 8)
        w, h = struct.unpack_from("<2I", data, pos + 8 + 32)
        fps = 1_000_000.0 / usec_per_frame if usec_per_frame else 24.0
        return fps, int(total_frames), int(h), int(w)
    if suffix == ".y4m":
        fsize = os.path.getsize(path)
        with open(path, "rb") as fh:
            w, h, fps, cs = _parse_y4m_header(fh.readline(), path)
            _, cw, ch = _y4m_chroma_geometry(cs, w, h, path)
            plane_bytes = w * h + 2 * cw * ch
            n = 0
            while True:
                marker = fh.readline()  # 'FRAME[ params]\n': per-frame parameters lengthen it
                if not marker:
                    break
                if not marker.startswith(b"FRAME"):
                    raise ValueError(f"{path}: bad frame marker {marker[:16]!r}")
                if fh.tell() + plane_bytes > fsize:
                    break
                fh.seek(plane_bytes, os.SEEK_CUR)
                n += 1
        return fps, int(n), int(h), int(w)
    if suffix in PIL_SUFFIXES:
        if suffix == ".png" and not _png_is_animated(path):
            with open(path, "rb") as fh:
                w, h = struct.unpack(">II", fh.read(24)[16:24])
            return 24.0, 1, int(h), int(w)
        if suffix == ".webp":
            with open(path, "rb") as fh:
                w, h, n, _ = webp_info(fh.read())
            return 24.0, int(n), int(h), int(w)
        if suffix == ".gif":
            with open(path, "rb") as fh:
                w, h, n, duration_ms = gif_info(fh.read(), path)
        else:
            w, h, n, duration_ms = apng_info(path)
        fps = 1000.0 / duration_ms if duration_ms else 24.0
        return fps, int(n), int(h), int(w)
    if suffix in MOV_SUFFIXES:
        return probe_mov(path)
    raise ValueError(f"{path}: no pure-Python probe for {suffix}")


def _cv2_or_none():
    """OpenCV when it is installed (its bundled FFMPEG decodes H.264, VP9,
    ...), else None; optional, as in the JAX package."""
    try:
        import cv2  # type: ignore

        return cv2
    except Exception:
        return None


def read_cv2(path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """Any video OpenCV decodes -> (1, 3, F, H, W) in [-1, 1]."""
    cv2 = _cv2_or_none()
    if cv2 is None:
        raise RuntimeError("OpenCV not available")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"OpenCV could not open {path}")
    frames = []
    try:
        while len(frames) < num_frames:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(np.ascontiguousarray(bgr[:, :, ::-1]))  # BGR -> RGB
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return _pack(frames, height, width, num_frames)


def probe_cv2(path: str):
    """(fps, frames, height, width) through OpenCV's demuxer (the frames
    walked when the stream reports no count)."""
    cv2 = _cv2_or_none()
    if cv2 is None:
        raise RuntimeError("OpenCV not available")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"OpenCV could not open {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    finally:
        cap.release()
    if n <= 0:
        cap = cv2.VideoCapture(path)
        n = 0
        try:
            while cap.read()[0]:
                n += 1
        finally:
            cap.release()
    if n <= 0 or h <= 0 or w <= 0:
        raise ValueError(f"OpenCV could not probe {path}")
    return float(fps), n, h, w


def decodes_pure_python(path: str) -> bool:
    """True when the file decodes without ffmpeg or OpenCV: the suffixes of
    PURE_PYTHON_SUFFIXES, and a .mov/.mp4 whose video track is MJPEG."""
    suffix = Path(path).suffix.lower()
    if suffix in PURE_PYTHON_SUFFIXES:
        return True
    if suffix in MOV_SUFFIXES:
        try:
            return mov_is_mjpeg(path)
        except (ValueError, OSError):
            return False
    return False


def read_video_any(path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """The reader a file's suffix (and a .mov/.mp4's codec) names: y4m, MJPEG
    AVI, GIF, WebP, APNG, a still PNG, MJPEG mov/mp4; else OpenCV
    when it is installed, else the ffmpeg pipe."""
    suffix = Path(path).suffix.lower()
    if suffix == ".y4m":
        return read_y4m(path, height, width, num_frames)
    if suffix == ".avi":
        return read_avi_mjpeg(path, height, width, num_frames)
    if suffix in PIL_SUFFIXES:
        return read_pil_animation(path, height, width, num_frames)
    if suffix in MOV_SUFFIXES:
        try:
            is_mjpeg = mov_is_mjpeg(path)
        except (ValueError, OSError):
            is_mjpeg = False
        if is_mjpeg:
            return read_mov_mjpeg(path, height, width, num_frames)
    if _cv2_or_none() is not None:
        return read_cv2(path, height, width, num_frames)
    from ltx2_tpu_torch.pipelines.retake import load_video_frames

    return load_video_frames(path, height, width, num_frames)
