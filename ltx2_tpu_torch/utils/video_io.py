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

Audio in (the a2vid pipeline's source from a container): `read_avi_audio`
takes the 16-bit PCM stream of an AVI (the RIFF `hdrl` stream headers
walked for an `auds` stream, its `NNwb` chunks of the `movi` list
concatenated), `read_mov_audio` the `sowt` / `twos` 16-bit PCM track of a
.mov/.mp4 (the sample tables walked: `stsc` runs over `stco`/`co64` chunk
offsets and `stsz` sizes, the rate from `mdhd`'s timescale); each returns
((channels, N) float32 / 32767, rate), or None for a file without such a
track, as the JAX package's readers do. Bytes only, stdlib `struct`.
"""

from __future__ import annotations

import os
import shutil
import struct
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
    offsets, sample sizes)."""
    stsd, stsc, stsz = (_mov_find(data, *stbl, box) for box in (b"stsd", b"stsc", b"stsz"))
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
    return fourcc, entry_payload, offsets, sizes


def read_mov_audio(path: str):
    """A .mov/.mp4's first sound track if it is 16-bit PCM (`sowt` little-,
    `twos` big-endian): ((channels, N) float32 in [-1, 1], the track's
    timescale as the rate), else None."""
    with open(path, "rb") as fh:
        data = fh.read()
    for handler, stbl, mdhd in _mov_tracks(data):
        if handler != b"soun":
            continue
        fourcc, entry, offsets, sizes = _mov_sample_table(data, stbl)
        if fourcc not in (b"sowt", b"twos"):
            return None
        # A version-0 sound entry: channels at +16, bits at +18.
        channels, bits = struct.unpack_from(">HH", entry, 16)
        if bits != 16 or channels == 0:
            return None
        raw = b"".join(data[o:o + n] for o, n in zip(offsets, sizes))
        return _pcm16(raw, "<i2" if fourcc == b"sowt" else ">i2", channels), int(_mdhd_timescale(mdhd))
    return None
