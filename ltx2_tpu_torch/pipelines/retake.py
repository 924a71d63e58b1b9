"""Retake: regenerate a time window of an existing video (counterpart of
ltx2_tpu/pipelines/retake.py).

The source keeps its own height, width and fps; its frame count is snapped
down to 8k + 1 (`get_video_metadata`, `load_video_frames`: the port's
readers for y4m, MJPEG AVI / mov / mp4 and still PNGs, OpenCV when it is
installed, else the ffmpeg and ffprobe pipes, as the JAX package chooses
by file type). The fp32 video encoder encodes it to the clean latent; a
`TemporalRegionMask` gives the latent frames inside [start, end) seconds
denoise mask 1, every other frame 0; the Gaussian noiser noises the window
only; the CFG loop (`cfg_interval` guidance reuse, per-token timesteps)
runs over LTX2Scheduler's sigmas at the fixed 4096-token anchor (the
clip's tokens under `token_dependent_shift`); the latent is cleared,
un-patchified and decoded (tiled above 4000 latent voxels).

Outside the window a token's noise blend, denoised value and Euler update
are exact no-ops (mask 0: noise x 0, clean x 1, velocity 0), so those tokens
come out of the loop bit for bit the encoder's latent.

Randomness: the JAX package splits PRNGKey(seed) into noise and decode
keys; the port draws (noise, decode) seeds with `stage_seeds(seed, 2)`. A
caller may hand the patchified noise in (the tests hand in the JAX
package's).
"""

from __future__ import annotations

import json
import subprocess
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig
from ltx2_tpu_torch.pipelines.common import decode_video, encode_image
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.pipelines.distilled import stage_seeds
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline
from ltx2_tpu_torch.types import LatentState, VideoLatentShape


@dataclass
class RetakeConfig:
    """The JAX package's RetakeConfig."""

    start_time: float = 0.0
    end_time: float = 1.0
    seed: int = 42
    num_inference_steps: int = 30
    cfg_scale: float = 3.0
    cfg_interval: int = 1
    dtype: str = "float32"
    latent_channels: int = 128
    tiling_config: Optional[TilingConfig] = None
    token_dependent_shift: bool = False

    def __post_init__(self):
        if self.end_time <= self.start_time:
            raise ValueError("end_time must be greater than start_time")


def get_video_metadata(video_path: str) -> Tuple[float, int, int, int]:
    """(fps, frames, height, width): the port's probes for what decodes
    without ffmpeg, OpenCV's when it is installed, else ffprobe's."""
    from ltx2_tpu_torch.utils.video_io import _cv2_or_none, decodes_pure_python, probe_cv2, probe_video

    if decodes_pure_python(video_path):
        return probe_video(video_path)
    if _cv2_or_none() is not None:
        return probe_cv2(video_path)
    cmd = ["ffprobe", "-v", "quiet", "-print_format", "json", "-show_streams", "-show_format", video_path]
    data = json.loads(subprocess.run(cmd, capture_output=True, text=True, check=True).stdout)
    for stream in data.get("streams", []):
        if stream.get("codec_type") != "video":
            continue
        width, height = int(stream["width"]), int(stream["height"])
        num, _, den = str(stream.get("r_frame_rate", "24/1")).partition("/")
        fps = float(num) / float(den or 1)
        nb = str(stream.get("nb_frames", "0"))
        num_frames = int(nb) if nb.isdigit() else 0
        if num_frames <= 0:  # MKV/WebM report N/A: duration x fps
            num_frames = int(float(data.get("format", {}).get("duration", 0) or 0) * fps)
        if num_frames <= 0:
            raise ValueError(f"{video_path}: could not determine frame count (no nb_frames and no container "
                             "duration)")
        return fps, num_frames, height, width
    raise ValueError(f"No video stream found in {video_path}")


def load_video_frames(video_path: str, height: int, width: int, num_frames: int) -> np.ndarray:
    """(1, 3, F, H, W) float32 in [-1, 1]: `read_video_any` for what decodes
    without ffmpeg, OpenCV when it is installed, else ffmpeg's rawvideo
    pipe scaled to the size (the last frame repeated to `num_frames`)."""
    from ltx2_tpu_torch.utils.video_io import _cv2_or_none, decodes_pure_python, read_cv2, read_video_any

    if decodes_pure_python(video_path):
        return read_video_any(video_path, height, width, num_frames)
    if _cv2_or_none() is not None:
        return read_cv2(video_path, height, width, num_frames)
    cmd = ["ffmpeg", "-v", "quiet", "-i", video_path, "-vf", f"scale={width}:{height}",
           "-frames:v", str(num_frames), "-f", "rawvideo", "-pix_fmt", "rgb24", "-"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    frames = np.frombuffer(raw, np.uint8)
    n = len(frames) // (height * width * 3)
    frames = frames[:n * height * width * 3].reshape(n, height, width, 3)
    while frames.shape[0] < num_frames:
        frames = np.concatenate([frames, frames[-1:]], axis=0)
    video = frames.astype(np.float32) / 127.5 - 1.0
    return video.transpose(3, 0, 1, 2)[None]


class TemporalRegionMask:
    """Denoise mask 1 on the latent frames [(start * fps - 1) // 8, (end *
    fps - 1) // 8 + 1) (clipped to the clip), 0 elsewhere."""

    def __init__(self, start_time: float, end_time: float, fps: float):
        self.start_time = start_time
        self.end_time = end_time
        self.fps = fps

    def latent_frames(self, frames: int) -> Tuple[int, int]:
        start_pixel, end_pixel = int(self.start_time * self.fps), int(self.end_time * self.fps)
        return max(0, (start_pixel - 1) // 8), min(frames, (end_pixel - 1) // 8 + 1)

    def apply_to(self, latent_state: LatentState, latent_tools: VideoLatentTools) -> LatentState:
        shape = latent_tools.target_shape
        start, end = self.latent_frames(shape.frames)
        per_frame = shape.height * shape.width
        mask = torch.zeros((1, shape.frames * per_frame, 1), dtype=latent_state.denoise_mask.dtype,
                           device=latent_state.denoise_mask.device)
        if start < end:
            mask[:, start * per_frame:end * per_frame] = 1.0
        return latent_state.replace(denoise_mask=mask)


class RetakePipeline(OneStagePipeline):
    """Masked re-generation of a temporal region over the one-stage
    pipeline's modules (the DiT, the video encoder and decoder)."""

    def __call__(  # type: ignore[override]
        self,
        video_path: Optional[str],
        positive_encoding: torch.Tensor,
        negative_encoding: torch.Tensor,
        config: RetakeConfig,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        source_video: Optional[torch.Tensor] = None,
        fps: Optional[float] = None,
        skip_decode: bool = False,
        noise: Optional[torch.Tensor] = None,
    ):
        """Retake `video_path` (or the pre-loaded (1, 3, F, H, W)
        `source_video` in [-1, 1], at `fps`, default 24) between
        `config.start_time` and `config.end_time`: uint8 (F, H, W, 3) frames
        on the host, or with skip_decode the (1, C, F', H', W') latent.
        `noise`: the patchified (1, tokens, C) initial noise, drawn from the
        seed when not given. `callback(phase, latent)` runs after "encode"
        (the clean latent) and "denoise"."""
        if source_video is None:
            fps_meta, n_frames, height, width = get_video_metadata(video_path)
            fps = fps or fps_meta
            n_frames = n_frames - (n_frames - 1) % 8  # snapped down to 8k + 1
            source_video = torch.from_numpy(load_video_frames(video_path, height, width, n_frames))
        if fps is None:
            fps = 24.0
        _, _, n_frames, height, width = source_video.shape
        device, dtype = positive_encoding.device, getattr(torch, config.dtype)
        noise_seed, decode_seed = stage_seeds(config.seed, 2)

        clean_latent = encode_image(self.video_encoder, source_video.to(device=device, dtype=torch.float32))
        clean_latent = clean_latent.to(dtype)
        if callback:
            callback("encode", clean_latent)
        latent_shape = VideoLatentShape(*clean_latent.shape)
        tools = VideoLatentTools(patchifier=self.patchifier, target_shape=latent_shape, fps=fps)
        state = tools.create_initial_state(dtype=dtype, initial_latent=clean_latent, device=device)
        state = TemporalRegionMask(config.start_time, config.end_time, fps).apply_to(state, tools)
        # The fixed 4096 anchor, as the JAX pipeline's scheduler call.
        sigmas = torch.from_numpy(self.scheduler.execute(
            steps=config.num_inference_steps, tokens=latent_shape.tokens if config.token_dependent_shift else None))
        gen = None if noise is not None else torch.Generator(device=device).manual_seed(noise_seed)
        state = GaussianNoiser()(gen, state, noise_scale=1.0, noise=noise)
        loop = make_video_denoise_loop(self.transformer.cfg, DenoiseLoopConfig(
            guider=CFGGuider(scale=config.cfg_scale), cfg_interval=config.cfg_interval))
        state = loop(self.transformer, state, sigmas, positive_encoding, negative_encoding)
        latent = tools.unpatchify(tools.clear_conditioning(state)).latent
        if callback:
            callback("denoise", latent)
        if skip_decode:
            return latent
        if self.video_decoder is None:
            raise ValueError("video decoder required to decode (or pass skip_decode=True)")
        tiling = OneStageCFGConfig(height=height, width=width, num_frames=n_frames, tiling_config=config.tiling_config,
                                   latent_channels=config.latent_channels).effective_tiling()
        return decode_video(latent, self.video_decoder, tiling, decode_seed)
