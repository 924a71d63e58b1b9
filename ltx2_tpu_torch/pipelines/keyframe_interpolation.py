"""Keyframe interpolation (counterpart of
ltx2_tpu/pipelines/keyframe_interpolation.py).

Keyframes are VAE-encoded and appended past the sequence's end with
positions offset to their pixel frames (`VideoConditionByKeyframeIndex`).
The recipe: stage 1 runs a CFG Euler loop (30 steps, CFG 7.5 by default,
against a zero negative context when none is given) at half resolution
over LTX2Scheduler's sigmas with the keyframe conditionings applied; stage
2 upscales the latent 2x (un-normalize -> upscale -> re-normalize),
applies the conditionings again at full resolution, noises at the first
distilled stage-2 sigma and refines over the first `stage_2_steps` of the
3-sigma tail without guidance. Without a spatial upscaler (or with
`use_two_stage` off) a single stage runs at full resolution. Video only:
with `audio_enabled` the result is (video, None), as in the JAX package.

Randomness: the JAX package splits PRNGKey(seed) into stage-1, stage-2
and decode keys; the port draws three seeds (`stage_seeds`). The tests hand
in each stage's noise, whose token count includes the appended keyframes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.schedulers import LTX2Scheduler, STAGE_2_DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.keyframe import VideoConditionByKeyframeIndex
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.pipelines.common import apply_conditionings, decode_video, encode_image, load_image_tensor, read_image
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline, stage_seeds
from ltx2_tpu_torch.types import VideoLatentShape, VideoPixelShape


@dataclass
class Keyframe:
    """A keyframe image pinned at a pixel-frame index."""

    image_path: str
    frame_index: int
    strength: float = 0.95


@dataclass
class KeyframeInterpolationConfig(DistilledConfig):
    """The JAX package's KeyframeInterpolationConfig."""

    num_inference_steps: int = 30
    cfg_scale: float = 7.5
    use_two_stage: bool = True
    stage_2_steps: int = 3
    token_dependent_shift: bool = False


def create_keyframe_conditionings(keyframes: List[Keyframe], encode_fn: Callable[[torch.Tensor], torch.Tensor],
                                  height: int, width: int, dtype=torch.float32, device=None,
                                  decoded: Optional[dict] = None) -> List[VideoConditionByKeyframeIndex]:
    """Each keyframe loaded at (height, width) (from `decoded`, {path:
    pixels}, when it holds the path), encoded by `encode_fn` and appended at
    its frame. The frame index stays in pixel frames: the conditioning
    offsets the pixel-frame time coordinate by it."""
    out = []
    for kf in keyframes:
        rgb = None if decoded is None else decoded.get(kf.image_path)
        encoded = encode_fn(load_image_tensor(kf.image_path, height, width, dtype, device, rgb))
        out.append(VideoConditionByKeyframeIndex(keyframes=encoded, frame_idx=kf.frame_index, strength=kf.strength))
    return out


class KeyframeInterpolationPipeline(DistilledPipeline):
    """Stage-1 CFG and stage-2 distilled refinement guided by appended
    keyframes, over the port's modules (the distilled pipeline's, whose
    video encoder encodes the keyframes)."""

    def _cfg_stage(self, config: KeyframeInterpolationConfig, height: int, width: int, conditionings,
                   sigmas: torch.Tensor, generator, noise_scale: float, text_encoding: torch.Tensor,
                   negative_encoding: torch.Tensor, cfg_scale: float, initial_latent=None, noise=None,
                   end_state: Optional[list] = None) -> torch.Tensor:
        """One stage: the state (zeros or `initial_latent`) with the
        keyframes appended, noised, through the (CFG) Euler loop, cleared
        and un-patchified. `end_state`, when given, receives the loop's
        final state, appended tokens included."""
        device, dtype = text_encoding.device, getattr(torch, config.dtype)
        pixel = VideoPixelShape(batch=1, frames=config.num_frames, height=height, width=width, fps=config.fps)
        tools = VideoLatentTools(patchifier=self.patchifier, fps=config.fps,
                                 target_shape=VideoLatentShape.from_pixel_shape(pixel, config.latent_channels))
        state = tools.create_initial_state(dtype=dtype, initial_latent=initial_latent, device=device)
        state = apply_conditionings(state, conditionings, tools)
        state = GaussianNoiser()(generator, state, noise_scale=noise_scale, noise=noise)
        loop = make_video_denoise_loop(self.transformer.cfg, DenoiseLoopConfig(
            guider=CFGGuider(cfg_scale), uniform_timesteps=not conditionings))
        state = loop(self.transformer, state, sigmas, text_encoding, negative_encoding)
        if end_state is not None:
            end_state.append(state)
        return tools.unpatchify(tools.clear_conditioning(state)).latent

    @torch.no_grad()
    def __call__(
        self,
        text_encoding: torch.Tensor,
        config: KeyframeInterpolationConfig,
        keyframes: Optional[List[Keyframe]] = None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        skip_decode: bool = False,
        negative_encoding: Optional[torch.Tensor] = None,
        noises: Optional[Sequence[torch.Tensor]] = None,
        end_states: Optional[list] = None,
    ):
        """Generate one clip for the (1, S, D) text encoding: uint8 (frames,
        height, width, 3) frames on the host, or with skip_decode the final
        (1, C, F, H, W) latent; with `config.audio_enabled` the pair (that,
        None). `noises`: each stage's patchified (1, tokens, C) noise, the
        appended keyframe tokens included, drawn from the stage seeds when
        not given. `callback(phase, latent)` runs after "stage1", "upscale"
        and "stage2". `end_states` receives each stage's final loop state."""
        keyframes = list(keyframes or [])
        device, dtype = text_encoding.device, getattr(torch, config.dtype)
        if negative_encoding is None:
            negative_encoding = torch.zeros_like(text_encoding)
        seeds = stage_seeds(config.seed)
        gens = ([None, None] if noises is not None
                else [torch.Generator(device=device).manual_seed(s) for s in seeds[:2]])
        noises = noises if noises is not None else (None, None)
        two_stage = config.use_two_stage and self.spatial_upscaler is not None
        s1_h, s1_w = (config.height // 2, config.width // 2) if two_stage else (config.height, config.width)
        decoded = {kf.image_path: read_image(kf.image_path) for kf in keyframes}

        def conditionings(height: int, width: int):
            return create_keyframe_conditionings(keyframes, lambda image: encode_image(self.video_encoder, image),
                                                 height, width, dtype, device, decoded)

        tokens = (((config.num_frames - 1) // 8 + 1) * (s1_h // 32) * (s1_w // 32)
                  if config.token_dependent_shift else None)
        sigmas = torch.from_numpy(LTX2Scheduler().execute(steps=config.num_inference_steps, tokens=tokens))
        latent = self._cfg_stage(config, s1_h, s1_w, conditionings(s1_h, s1_w), sigmas, gens[0], 1.0,
                                 text_encoding, negative_encoding, config.cfg_scale, noise=noises[0],
                                 end_state=end_states)
        if callback:
            callback("stage1", latent)
        if two_stage:
            upscaled = self._upscale_latent(latent, dtype)
            if callback:
                callback("upscale", upscaled)
            distilled = torch.tensor(STAGE_2_DISTILLED_SIGMA_VALUES[: config.stage_2_steps + 1], dtype=torch.float32)
            # The positive context on both rows under CFGGuider(1.0): no guidance.
            latent = self._cfg_stage(config, config.height, config.width, conditionings(config.height, config.width),
                                     distilled, gens[1], float(distilled[0]), text_encoding, text_encoding, 1.0,
                                     initial_latent=upscaled, noise=noises[1], end_state=end_states)
            if callback:
                callback("stage2", latent)
        if skip_decode:
            return (latent, None) if config.audio_enabled else latent
        video = decode_video(latent, self.video_decoder, config.effective_tiling(), seeds[2])
        return (video, None) if config.audio_enabled else video
