"""The two-stage CFG pipeline with the distilled LoRA for stage 2
(counterpart of ltx2_tpu/pipelines/two_stage.py).

Stage 1 denoises at half resolution on LTX2Scheduler's sigmas (the fixed
4096-token shift, or the clip's token count with `token_dependent_shift`)
under guidance: with an audio-video DiT the multi-modal loop (CFG on both
streams at `cfg_scale` / `audio_cfg_scale`, modality isolation at
`modality_scale`, the std-ratio rescale at `guidance_rescale`; three rows a
step by default), with a video-only DiT the video loop under CFG, or the
variance-rescaled CFG when `guidance_rescale` > 0. Then the latent is
un-normalized, upscaled 2x and re-normalized; the distilled LoRA, when
given, is fused into the DiT's weights; stage 2 refines at full resolution
on the distilled 3-sigma tail without guidance (the distilled recipe's
`_run_stage`); the LoRA is subtracted again in a `finally`, its deltas made
again from the file's terms (no copy of the model and no set of deltas is
kept). Then the video decode (tiled above 4000 latent voxels) and, with
`audio_enabled`, the audio decode. The resolution must be divisible by 64.

Randomness: the JAX package splits PRNGKey(seed) into five keys; the port
draws (stage 1, stage 2, decode) seeds as the distilled recipe does
(`stage_seeds`), video noise before audio noise in each stage; the tests
hand the JAX package's noise in. Not ported: meshes (the loops raise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ltx2_tpu_torch.components.guiders import CFGGuider, RescaledCFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.schedulers import LTX2Scheduler, STAGE_2_DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.lora import LoRAConfig, fuse_lora_into_params, unfuse_lora_deltas
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig
from ltx2_tpu_torch.pipelines.common import (
    ImageCondition, apply_conditionings, create_image_conditionings, decode_audio, decode_video, encode_image,
    read_image,
)
from ltx2_tpu_torch.pipelines.denoise import (
    DenoiseLoopConfig, MultiModalLoopConfig, make_multimodal_av_denoise_loop, make_video_denoise_loop,
)
from ltx2_tpu_torch.pipelines.distilled import AudioFields, DistilledConfig, DistilledPipeline, stage_seeds
from ltx2_tpu_torch.types import VideoLatentShape, VideoPixelShape


@dataclass
class TwoStageCFGConfig(AudioFields):
    """The JAX package's TwoStageCFGConfig."""

    height: int = 480
    width: int = 704
    num_frames: int = 97
    seed: int = 42
    fps: float = 25.0
    num_inference_steps: int = 30
    cfg_scale: float = 3.0
    audio_cfg_scale: float = 7.0
    guidance_rescale: float = 0.0
    modality_scale: float = 3.0
    cfg_interval: int = 1
    distilled_lora_config: Optional[LoRAConfig] = None
    stage_2_sigmas: Optional[list] = None
    tiling_config: Optional[TilingConfig] = None
    dtype: str = "float32"
    latent_channels: int = 128
    audio_output_sample_rate: int = 24000
    token_dependent_shift: bool = False

    def __post_init__(self):
        if self.num_frames % 8 != 1:
            raise ValueError(f"num_frames must be 8*k + 1, got {self.num_frames}. "
                             f"Valid values: 1, 9, 17, 25, 33, ..., 121")
        if self.height % 64 != 0 or self.width % 64 != 0:
            raise ValueError(f"Resolution ({self.height}x{self.width}) must be divisible by 64 for two-stage "
                             f"pipeline.")

    def effective_tiling(self) -> Optional[TilingConfig]:
        """The given tiling, else the default one above 4000 latent voxels."""
        return _distilled_view(self).effective_tiling()


def _distilled_view(config: TwoStageCFGConfig) -> DistilledConfig:
    """The DistilledConfig fields stage 2 (`_run_stage`) and the decode read."""
    return DistilledConfig(
        height=config.height, width=config.width, num_frames=config.num_frames, seed=config.seed, fps=config.fps,
        dtype=config.dtype, latent_channels=config.latent_channels, tiling_config=config.tiling_config,
        audio_enabled=config.audio_enabled, use_internal_audio_branch=config.use_internal_audio_branch,
        audio_vae_channels=config.audio_vae_channels, audio_mel_bins=config.audio_mel_bins,
        audio_sample_rate=config.audio_sample_rate, audio_hop_length=config.audio_hop_length,
        audio_downsample_factor=config.audio_downsample_factor)


class TwoStagePipeline(DistilledPipeline):
    """Stage 1 under guidance, stage 2 refined with the distilled LoRA."""

    def __call__(  # type: ignore[override]
        self,
        positive_encoding: torch.Tensor,
        negative_encoding: torch.Tensor,
        config: TwoStageCFGConfig,
        images: Optional[List[ImageCondition]] = None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        positive_audio_encoding: Optional[torch.Tensor] = None,
        negative_audio_encoding: Optional[torch.Tensor] = None,
        skip_decode: bool = False,
        noises: Optional[Sequence[torch.Tensor]] = None,
        audio_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Generate one clip from the (1, S, D) positive and negative
        encodings: (uint8 (frames, height, width, 3) frames on the host, the
        (1, 2, samples) waveform with `config.audio_enabled`, else None), or
        with skip_decode ((1, C, F, H, W) latent, the (1, C, T, F) audio
        latent of an audio-video DiT, else None). `noises` / `audio_noises`:
        each stage's patchified (1, tokens, C) noise, drawn from the stage
        seeds when not given. `callback(phase, latent)` runs after "stage1",
        "upscale", with the LoRA "lora_fuse", then "stage2", with the LoRA
        "lora_unfuse", with images after each stage's image encode, and after
        "audio_decode" with the waveform."""
        images = list(images or [])
        audio = self.is_av_model and (config.use_internal_audio_branch or config.audio_enabled)
        if (config.audio_enabled or audio) and (positive_audio_encoding is None or negative_audio_encoding is None):
            raise ValueError("Audio encoding required for AudioVideo generation. Provide positive_audio_encoding "
                             "and negative_audio_encoding.")
        device, dtype = positive_encoding.device, getattr(torch, config.dtype)
        seeds = stage_seeds(config.seed)
        given = noises is not None or audio_noises is not None
        gens = [None, None] if given else [torch.Generator(device=device).manual_seed(s) for s in seeds[:2]]
        noises = noises if noises is not None else (None, None)
        audio_noises = audio_noises if audio_noises is not None else (None, None)
        decoded = {c.image_path: read_image(c.image_path) for c in images}  # decoded once, resized per stage

        # Stage 1: half resolution, guided.
        stage_1 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height // 2,
                                  width=config.width // 2, fps=config.fps)
        shape = VideoLatentShape.from_pixel_shape(stage_1, latent_channels=config.latent_channels)
        tools = VideoLatentTools(patchifier=self.patchifier, target_shape=shape, fps=config.fps)
        conditionings = create_image_conditionings(
            images, lambda image: encode_image(self.video_encoder, image), stage_1.height, stage_1.width, dtype,
            device, decoded)
        if conditionings and callback:
            callback("stage1_image_encode", conditionings[0].latent)
        state = apply_conditionings(tools.create_initial_state(dtype=dtype, device=device), conditionings, tools)
        sigmas = torch.from_numpy(LTX2Scheduler().execute(
            steps=config.num_inference_steps, tokens=shape.tokens if config.token_dependent_shift else None))
        noiser = GaussianNoiser()
        state = noiser(gens[0], state, noise_scale=1.0, noise=noises[0])
        stage_1_audio = None
        if audio:
            audio_tools = config.audio_tools(stage_1)
            audio_state = audio_tools.create_initial_state(dtype=dtype, device=device)
            audio_state = noiser(gens[0], audio_state, noise_scale=1.0, noise=audio_noises[0])
            mm = MultiModalLoopConfig(
                video_cfg_scale=config.cfg_scale, audio_cfg_scale=config.audio_cfg_scale,
                rescale_scale=config.guidance_rescale, modality_scale=config.modality_scale,
                cfg_interval=config.cfg_interval, uniform_timesteps=not conditionings)
            state, audio_state = make_multimodal_av_denoise_loop(self.transformer.cfg, mm)(
                self.transformer, state, audio_state, sigmas, positive_encoding, negative_encoding,
                positive_audio_encoding, negative_audio_encoding)
            stage_1_audio = audio_tools.unpatchify(audio_tools.clear_conditioning(audio_state)).latent
        else:
            guider = (RescaledCFGGuider(scale=config.cfg_scale, rescale=config.guidance_rescale)
                      if config.guidance_rescale > 0 else CFGGuider(scale=config.cfg_scale))
            state = make_video_denoise_loop(self.transformer.cfg, DenoiseLoopConfig(
                guider=guider, uniform_timesteps=not conditionings, cfg_interval=config.cfg_interval))(
                self.transformer, state, sigmas, positive_encoding, negative_encoding)
        latent = tools.unpatchify(tools.clear_conditioning(state)).latent
        audio_latent = stage_1_audio
        if callback:
            callback("stage1", latent)

        # Stage 2: the upscaler, the distilled LoRA, the distilled tail.
        if self.spatial_upscaler is not None:
            upscaled = self._upscale_latent(latent, dtype)
            if callback:
                callback("upscale", upscaled)
            applied = None
            if config.distilled_lora_config is not None:
                _, applied = fuse_lora_into_params(self.transformer, [config.distilled_lora_config],
                                                   return_deltas=True)
                if callback:
                    callback("lora_fuse", upscaled)
            try:
                stage_2_sigmas = np.asarray(config.stage_2_sigmas or STAGE_2_DISTILLED_SIGMA_VALUES, np.float32)
                stage_2 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height,
                                          width=config.width, fps=config.fps)
                latent, stage_2_audio = self._run_stage(
                    stage_2, stage_2_sigmas.tolist(), positive_encoding, _distilled_view(config), images, decoded,
                    gens[1], float(stage_2_sigmas[0]), initial_video_latent=upscaled, noise=noises[1],
                    phase="stage2", callback=callback, audio_encoding=positive_audio_encoding if audio else None,
                    initial_audio_latent=stage_1_audio, audio_noise=audio_noises[1])
                if stage_2_audio is not None:
                    audio_latent = stage_2_audio
                if callback:
                    callback("stage2", latent)
            finally:
                if applied is not None:
                    unfuse_lora_deltas(self.transformer, applied)
            if applied is not None and callback:
                callback("lora_unfuse", latent)

        if skip_decode:
            return latent, audio_latent
        video = decode_video(latent, self.video_decoder, config.effective_tiling(), seeds[2])
        waveform = None
        if config.audio_enabled and audio_latent is not None:
            waveform = decode_audio(audio_latent, self.audio_decoder, self.vocoder)
            if callback:
                callback("audio_decode", waveform)
        return video, waveform


def create_two_stage_pipeline(**kwargs) -> TwoStagePipeline:
    return TwoStagePipeline(**kwargs)
