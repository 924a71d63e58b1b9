"""The two-stage distilled text-to-video recipe, video only (counterpart of
ltx2_tpu/pipelines/distilled.py).

Stage 1 denoises at half resolution with the 8 distilled sigmas; the latent
is un-normalized, upscaled 2x by the spatial upscaler and re-normalized;
stage 2 re-noises it to 0.909375 and refines it at full resolution with the
3-sigma tail; the VAE decodes it, tiled when the latent is large
(`DistilledConfig.effective_tiling`). No CFG: CFGGuider(1.0). Images
condition each stage: every image is loaded at that stage's size, encoded by
the video encoder and written over its latent frame after the initial
state is made (in stage 2 over the upscaled latent, in the latent and the
clean latent), then the noiser runs; timesteps are per token when a stage
has conditionings, else per batch row (`uniform_timesteps`).

Randomness: the JAX package splits PRNGKey(seed) into stage-1, stage-2 and
decode keys. The port draws three seeds from a torch.Generator seeded with
`config.seed` (`stage_seeds`) and seeds one generator per stage and one for
the decode noise; a caller may hand in each stage's noise instead (the
tests hand in the JAX package's). Not ported (each raises
NotImplementedError): the audio branch, freeze_audio.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.components.schedulers import DISTILLED_SIGMA_VALUES, STAGE_2_DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.models.transformer.model import LTXModel
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, spatial_upscaler_apply
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder
from ltx2_tpu_torch.models.video_vae.ops import normalize_latent, un_normalize_latent
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig
from ltx2_tpu_torch.pipelines.common import (
    ImageCondition, apply_conditionings, create_image_conditionings, decode_video, encode_image, read_image,
)
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.types import VideoLatentShape, VideoPixelShape


@dataclass
class DistilledConfig:
    """The video fields of the JAX package's DistilledConfig."""

    height: int = 704
    width: int = 1024
    num_frames: int = 121
    seed: int = 42
    fps: float = 24.0
    dtype: str = "float32"
    tiling_config: Optional[TilingConfig] = None
    latent_channels: int = 128
    audio_enabled: bool = False

    def __post_init__(self):
        if self.num_frames % 8 != 1:
            raise ValueError(f"num_frames must be 8*k + 1, got {self.num_frames}.")
        if self.height % 64 != 0 or self.width % 64 != 0:
            raise ValueError(f"Resolution ({self.height}x{self.width}) must be divisible by 64 for the "
                             f"distilled two-stage pipeline.")
        if self.audio_enabled:
            raise NotImplementedError("the audio branch of the distilled pipeline is not ported")

    def effective_tiling(self) -> Optional[TilingConfig]:
        """The given tiling, else the default one above 4000 latent voxels."""
        if self.tiling_config is not None:
            return self.tiling_config
        latent_frames = (self.num_frames - 1) // 8 + 1
        if latent_frames * (self.height // 32) * (self.width // 32) > 4000:
            return TilingConfig.default()
        return None


def stage_seeds(seed: int, count: int = 3) -> Tuple[int, ...]:
    """`count` seeds drawn from `seed`: here (stage 1, stage 2, decode)."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(int(s) for s in torch.randint(0, 2 ** 62, (count,), generator=gen))


class DistilledPipeline:
    """Two-stage distilled generation over the port's modules.

    `statistics` holds the latent's per-channel mean_of_means and
    std_of_means for the upscale bracket; default: the decoder's, else the
    encoder's. `video_encoder` encodes conditioning images."""

    def __init__(self, transformer: LTXModel, spatial_upscaler: Optional[SpatialUpscaler] = None,
                 video_decoder: Optional[VideoDecoder] = None, statistics=None,
                 video_encoder: Optional[VideoEncoder] = None):
        self.transformer = transformer
        self.spatial_upscaler = spatial_upscaler
        self.video_decoder = video_decoder
        self.video_encoder = video_encoder
        self.statistics = statistics
        self.patchifier = VideoLatentPatchifier(patch_size=1)
        self.loops = {uniform: make_video_denoise_loop(
            transformer.cfg, DenoiseLoopConfig(guider=CFGGuider(1.0), uniform_timesteps=uniform))
            for uniform in (True, False)}

    def _stats(self):
        if self.statistics is not None:
            return self.statistics
        if self.video_decoder is not None:
            return self.video_decoder.per_channel_statistics
        if self.video_encoder is not None:
            return self.video_encoder.per_channel_statistics
        raise ValueError("per-channel statistics unavailable (no VAE decoder, encoder or statistics)")

    @torch.no_grad()
    def _upscale_latent(self, latent: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Un-normalize (fp32 statistics promote the latent to fp32) -> 2x
        spatial upscale -> re-normalize -> cast."""
        stats = self._stats()
        upscaled = spatial_upscaler_apply(self.spatial_upscaler, un_normalize_latent(latent, stats))
        return normalize_latent(upscaled, stats).to(dtype)

    def _run_stage(self, pixel_shape: VideoPixelShape, sigmas: Sequence[float], text_encoding: torch.Tensor,
                   config: DistilledConfig, images: List[ImageCondition], decoded: dict,
                   generator: Optional[torch.Generator], noise_scale: float,
                   initial_video_latent: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                   phase: str = "", callback=None) -> torch.Tensor:
        """One stage: initial state (zeros, or the given latent as clean
        latent) -> the images (`decoded`: each path's pixels), resized to
        this stage's size, encoded and written over their frames -> Gaussian
        noise at `noise_scale` -> the denoise loop over `sigmas` -> the
        (B, C, F, H, W) latent. With images and a callback,
        `callback(phase + "_image_encode", first image's latent)` runs once
        they are encoded."""
        device, dtype = text_encoding.device, getattr(torch, config.dtype)
        shape = VideoLatentShape.from_pixel_shape(pixel_shape, latent_channels=config.latent_channels)
        tools = VideoLatentTools(patchifier=self.patchifier, target_shape=shape, fps=config.fps)
        conditionings = create_image_conditionings(
            images, lambda image: encode_image(self.video_encoder, image), pixel_shape.height, pixel_shape.width,
            dtype, device, decoded)
        if conditionings and callback:
            callback(f"{phase}_image_encode", conditionings[0].latent)
        state = tools.create_initial_state(dtype=dtype, initial_latent=initial_video_latent, device=device)
        state = apply_conditionings(state, conditionings, tools)
        state = GaussianNoiser()(generator, state, noise_scale=noise_scale, noise=noise)
        sig = torch.tensor(sigmas, dtype=torch.float32)
        state = self.loops[not conditionings](self.transformer, state, sig, text_encoding, text_encoding)
        return tools.unpatchify(tools.clear_conditioning(state)).latent

    def __call__(
        self,
        text_encoding: torch.Tensor,
        config: DistilledConfig,
        images: Optional[List[ImageCondition]] = None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        audio_encoding=None,
        skip_decode: bool = False,
        freeze_audio: bool = False,
        initial_audio_latent=None,
        noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Generate one clip for the (1, S, D) text encoding: uint8
        (frames, height, width, 3) frames on the host, or with skip_decode
        the final (1, C, F, H, W) latent. `noises`: each stage's patchified
        (1, tokens, C) noise, drawn from the stage seeds when not given.
        `images` condition both stages (the video encoder encodes each at
        the stage's size). `callback(phase, latent)` runs after "stage1",
        "upscale" and "stage2" with that phase's latent, and with images
        after "stage1_image_encode" and "stage2_image_encode"."""
        images = list(images or [])
        if audio_encoding is not None or freeze_audio or initial_audio_latent is not None:
            raise NotImplementedError("the audio branch of the distilled pipeline is not ported")
        device = text_encoding.device
        seeds = stage_seeds(config.seed)
        gens = [None, None] if noises is not None else [torch.Generator(device=device).manual_seed(s)
                                                         for s in seeds[:2]]
        noises = noises if noises is not None else (None, None)

        stage_1 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height // 2,
                                  width=config.width // 2, fps=config.fps)
        decoded = {c.image_path: read_image(c.image_path) for c in images}  # decoded once, resized per stage
        latent = self._run_stage(stage_1, DISTILLED_SIGMA_VALUES, text_encoding, config, images, decoded, gens[0],
                                 1.0, noise=noises[0], phase="stage1", callback=callback)
        if callback:
            callback("stage1", latent)

        if self.spatial_upscaler is not None:
            upscaled = self._upscale_latent(latent, getattr(torch, config.dtype))
            if callback:
                callback("upscale", upscaled)
            stage_2 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height,
                                      width=config.width, fps=config.fps)
            latent = self._run_stage(stage_2, STAGE_2_DISTILLED_SIGMA_VALUES, text_encoding, config, images,
                                     decoded, gens[1], float(STAGE_2_DISTILLED_SIGMA_VALUES[0]),
                                     initial_video_latent=upscaled, noise=noises[1], phase="stage2",
                                     callback=callback)
            if callback:
                callback("stage2", latent)

        if skip_decode:
            return latent
        return decode_video(latent, self.video_decoder, config.effective_tiling(), seeds[2])
