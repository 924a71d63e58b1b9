"""IC-LoRA control-signal video-to-video (counterpart of
ltx2_tpu/pipelines/ic_lora.py).

A control video (RAW: already a depth / pose / edge video; CANNY: edges
made by the port's own OpenCV steps, utils/canny.py, equal to the JAX
package's cv2 calls bit for bit) is read at stage 1's size
(`retake.load_video_frames`: the port's readers), encoded by the fp32 video
encoder and appended past stage 1's sequence at pixel frame 0 with its
strength (`VideoConditionByKeyframeIndex`): stage 1 runs over twice the
tokens, with per-token timesteps. The IC-LoRA is fused into the DiT for
stage 1 only: before it, and subtracted again when stage 1 ends (after its
"stage1" callback), or in a `finally` when anything fails; stage 2, the
distilled refinement, runs the base weights without the control. Audio
passes through as in the distilled pipeline. `save_control` writes the
signal that is encoded as `<video>.control.avi` (24 fps MJPEG), the JAX
package's bytes.

The Canny path reads the source frames with `cv2.VideoCapture` when OpenCV
is installed (the JAX package's frames, so the signal equals its bit for
bit), else at their own size through the port's readers (PIL's decode, as
the port's JPEG decoder gives it, or the y4m reader). The two decodes of
an MJPEG file differ: OpenCV's (FFmpeg's) differs from PIL's in 69 % of
the committed AVI's samples, by up to 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ltx2_tpu_torch.conditioning.keyframe import VideoConditionByKeyframeIndex
from ltx2_tpu_torch.loader.lora import LoRAConfig, fuse_lora_into_params, unfuse_lora_deltas
from ltx2_tpu_torch.pipelines.common import encode_image
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline
from ltx2_tpu_torch.utils.canny import bgr_to_gray, canny, resize_lanczos4
from ltx2_tpu_torch.utils.video_io import write_avi_mjpeg


class ControlType(Enum):
    RAW = "raw"  # a pre-processed control video (depth, pose, ...)
    CANNY = "canny"


@dataclass
class ICLoraConfig(DistilledConfig):
    """The JAX package's ICLoraConfig."""

    ic_lora_config: Optional[LoRAConfig] = None


@dataclass
class VideoCondition:
    """A control-signal video."""

    video_path: str
    strength: float = 0.95
    control_type: ControlType = ControlType.RAW
    canny_low: int = 100
    canny_high: int = 200
    save_control: bool = False


def _source_frames_bgr(video_path: str, num_frames: int) -> List[np.ndarray]:
    """Up to `num_frames` uint8 BGR frames at the video's own size: through
    `cv2.VideoCapture` when OpenCV is installed, as the JAX package reads
    them; else through the port's readers (`retake.load_video_frames`)."""
    from ltx2_tpu_torch.utils.video_io import _cv2_or_none

    cv2 = _cv2_or_none()
    frames: List[np.ndarray] = []
    if cv2 is not None:
        cap = cv2.VideoCapture(str(video_path))
        try:
            while len(frames) < num_frames:
                ret, frame = cap.read()
                if not ret:
                    break
                frames.append(frame)
        finally:
            cap.release()
        return frames
    from ltx2_tpu_torch.pipelines.retake import get_video_metadata, load_video_frames

    _fps, count, height, width = get_video_metadata(str(video_path))
    video = load_video_frames(str(video_path), height, width, min(num_frames, max(count, 1)))
    rgb = np.rint((video[0].transpose(1, 2, 3, 0) + 1.0) * 127.5).astype(np.uint8)
    return [np.ascontiguousarray(f[..., ::-1]) for f in rgb]


def preprocess_canny(video_path: Union[str, Path], height: int, width: int, num_frames: int,
                     low_threshold: int = 100, high_threshold: int = 200) -> np.ndarray:
    """Canny edges of the video's frames, (F, H, W, 3) uint8: the JAX
    package's cv2 steps through utils/canny.py (LANCZOS4 resize, BGR ->
    gray, Canny, gray -> RGB), the last frame repeated to `num_frames`."""
    frames = []
    for frame in _source_frames_bgr(str(video_path), num_frames):
        gray = bgr_to_gray(resize_lanczos4(frame, width, height))
        frames.append(np.repeat(canny(gray, low_threshold, high_threshold)[..., None], 3, axis=2))
    if not frames:
        raise ValueError(f"Could not read any frames from {video_path}")
    while len(frames) < num_frames:
        frames.append(frames[-1])
    return np.stack(frames, axis=0)


def preprocess_control_signal(video_path: Union[str, Path], control_type: ControlType, height: int, width: int,
                              num_frames: int, **kwargs) -> np.ndarray:
    """The control type's preprocessing (CANNY only; RAW needs none)."""
    if control_type == ControlType.CANNY:
        return preprocess_canny(video_path, height, width, num_frames, kwargs.get("low_threshold", 100),
                                kwargs.get("high_threshold", 200))
    raise ValueError(f"Control type {control_type} requires external preprocessing; use ControlType.RAW with a "
                     "pre-processed video.")


def load_control_signal_tensor(control_signal: np.ndarray) -> np.ndarray:
    """(F, H, W, 3) uint8 -> (1, 3, F, H, W) float32 in [-1, 1]."""
    video = control_signal.astype(np.float32) / 127.5 - 1.0
    return video.transpose(3, 0, 1, 2)[None]


def create_video_conditionings(videos: List[VideoCondition], encode_fn: Callable[[torch.Tensor], torch.Tensor],
                               height: int, width: int, num_frames: int, dtype=torch.float32,
                               device=None) -> List[VideoConditionByKeyframeIndex]:
    """Each control video read at (height, width, num_frames) (CANNY:
    `preprocess_canny`; RAW: `load_video_frames`), with `save_control` also
    written as `<video>.control.avi` (24 fps; the signal back in uint8 as
    the JAX package truncates it), encoded by `encode_fn` on `device` and
    appended at pixel frame 0 with its strength."""
    from ltx2_tpu_torch.pipelines.retake import load_video_frames

    conditionings = []
    for vc in videos:
        if vc.control_type == ControlType.CANNY:
            tensor = load_control_signal_tensor(preprocess_control_signal(
                vc.video_path, vc.control_type, height, width, num_frames, low_threshold=vc.canny_low,
                high_threshold=vc.canny_high))
        else:
            tensor = load_video_frames(vc.video_path, height, width, num_frames)
        if vc.save_control:
            frames_u8 = ((tensor[0].transpose(1, 2, 3, 0) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
            write_avi_mjpeg(str(vc.video_path) + ".control.avi", frames_u8, fps=24.0)
        encoded = encode_fn(torch.from_numpy(tensor).to(device=device, dtype=dtype))
        conditionings.append(VideoConditionByKeyframeIndex(keyframes=encoded, frame_idx=0, strength=vc.strength))
    return conditionings


class ICLoraPipeline(DistilledPipeline):
    """Control-signal two-stage generation with the IC-LoRA in stage 1 only."""

    def __call__(  # type: ignore[override]
        self,
        text_encoding: torch.Tensor,
        config: ICLoraConfig,
        videos: Optional[List[VideoCondition]] = None,
        control_conditionings: Optional[Sequence] = None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        audio_encoding=None,
        skip_decode: bool = False,
        noises: Optional[Sequence[torch.Tensor]] = None,
        audio_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """The distilled recipe with `videos` (or the pre-built
        `control_conditionings`) appended in stage 1 and
        `config.ic_lora_config` fused for it. Results, `noises` (stage 1's
        counts the appended tokens) and `audio_noises` as
        `DistilledPipeline.__call__`; `callback(phase, latent)` also runs
        after "lora_fuse" (with the text encoding), "control_encode" (the
        first control's latent) and "lora_unfuse" (stage 1's latent)."""
        videos = list(videos or [])
        self._ic_applied = None
        if config.ic_lora_config is not None:
            _, self._ic_applied = fuse_lora_into_params(self.transformer, [config.ic_lora_config],
                                                        return_deltas=True)
            if callback:
                callback("lora_fuse", text_encoding)

        def make_conditionings(height: int, width: int):
            if control_conditionings is not None:
                return list(control_conditionings)
            conditionings = create_video_conditionings(
                videos, lambda video: encode_image(self.video_encoder, video), height, width, config.num_frames,
                getattr(torch, config.dtype), text_encoding.device)
            if conditionings and callback:
                callback("control_encode", conditionings[0].keyframes)
            return conditionings

        def on_phase(phase: str, latent: torch.Tensor) -> None:
            if callback:
                callback(phase, latent)
            if phase == "stage1":
                self._unfuse()  # stage 2 runs the base weights
                if callback and config.ic_lora_config is not None:
                    callback("lora_unfuse", latent)

        self._stage_extra_conditionings = make_conditionings
        try:
            return super().__call__(text_encoding, config, images=None, callback=on_phase,
                                    audio_encoding=audio_encoding, skip_decode=skip_decode, noises=noises,
                                    audio_noises=audio_noises)
        finally:
            self._stage_extra_conditionings = None
            self._unfuse()

    def _unfuse(self) -> None:
        if getattr(self, "_ic_applied", None) is not None:
            unfuse_lora_deltas(self.transformer, self._ic_applied)
            self._ic_applied = None

    def _run_stage(self, pixel_shape, *args, **kwargs):
        """Stage 1 gets the control conditionings at its own size."""
        maker = getattr(self, "_stage_extra_conditionings", None)
        if maker is not None and kwargs.get("phase") == "stage1" and not kwargs.get("extra_conditionings"):
            kwargs["extra_conditionings"] = maker(pixel_shape.height, pixel_shape.width)
        return super()._run_stage(pixel_shape, *args, **kwargs)


def create_ic_lora_pipeline(**kwargs) -> ICLoraPipeline:
    return ICLoraPipeline(**kwargs)
