"""The single-stage CFG text/image-to-video pipeline (counterpart of
ltx2_tpu/pipelines/one_stage.py).

Image conditionings (each image encoded at the clip's size and written over
its latent frame) -> Gaussian noise -> LTX2Scheduler sigmas (the fixed
4096-token shift, or the clip's token count with `token_dependent_shift`)
-> the denoise loop with CFG* when `rescale_scale` > 0, else classic CFG
(or `guider_override`), the guidance rows on the batch axis (two, three
with STG), Euler or Heun steps, per-token timesteps when an image
conditions the mask -> clear and un-patchify -> optional post-hoc
upscales, spatial (2x H and W) before temporal (F latent frames -> 2F - 1),
each in its un-normalize / re-normalize bracket -> the VAE decode (tiled
above 4000 latent voxels).

With an audio-video DiT the audio stream denoises beside the video in the
joint loop (whether or not it is decoded, unless `use_internal_audio_branch`
is off and no audio is asked for, as the JAX package), guided by
its own guider at `audio_cfg_scale` (CFG* when `rescale_scale` > 0, else
CFG) on the positive and negative audio encodings; with `audio_enabled`
the audio latent goes through the audio decoder and the vocoder.

Randomness: the JAX package splits PRNGKey(seed) into noise, audio-noise
and decode keys; the port draws (noise, decode, audio noise) seeds from a
torch.Generator seeded with `config.seed` (`stage_seeds(seed, 3)`). A
caller may hand the noise in (the tests hand in the JAX package's). The
loop options are the JAX package's:
STG (`stg_scale`, `stg_blocks`, `stg_cutoff`, `stg_mode`), a
`guider_override` (APG, ...), GE (`ge_gamma`), `sampler` "heun", the late
cross-attention scale, `cache_text_kv`, and in the config `cfg_interval`
(guidance reuse) and `token_bucket` (the token count padded up to a
multiple of it, the padding masked out of self-attention's keys, sliced
off after the loop; video only, as in the JAX package). Not ported (it
raises NotImplementedError naming itself): every mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

from ltx2_tpu_torch.components.guiders import CFGGuider, CFGStarRescalingGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.components.schedulers import LTX2Scheduler
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.models.audio_vae.decoder import AudioDecoder
from ltx2_tpu_torch.models.transformer.model import LTXModel
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder
from ltx2_tpu_torch.models.video_vae.ops import normalize_latent, un_normalize_latent
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig
from ltx2_tpu_torch.pipelines.common import (
    ImageCondition, apply_conditionings, bucketed_tokens, create_image_conditionings, decode_audio, decode_video,
    encode_image, pad_state_tokens, slice_state_tokens,
)
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_av_denoise_loop, make_video_denoise_loop
from ltx2_tpu_torch.pipelines.distilled import AudioFields, stage_seeds
from ltx2_tpu_torch.types import VideoLatentShape, VideoPixelShape


@dataclass
class OneStageCFGConfig(AudioFields):
    """The JAX package's OneStageCFGConfig."""

    height: int = 480
    width: int = 704
    num_frames: int = 97
    seed: int = 42
    fps: float = 24.0
    num_inference_steps: int = 30
    cfg_scale: float = 3.0
    audio_cfg_scale: float = 7.0
    rescale_scale: float = 0.7
    cfg_interval: int = 1
    tiling_config: Optional[TilingConfig] = None
    dtype: str = "float32"
    latent_channels: int = 128
    token_bucket: int = 0
    token_dependent_shift: bool = False

    def __post_init__(self):
        if self.num_frames % 8 != 1:
            raise ValueError(f"num_frames must be 8*k + 1, got {self.num_frames}. "
                             f"Valid values: 1, 9, 17, 25, 33, ..., 121")
        if self.height % 32 != 0 or self.width % 32 != 0:
            raise ValueError(f"Resolution ({self.height}x{self.width}) must be divisible by 32 for single-stage "
                             f"pipeline.")

    def effective_tiling(self) -> Optional[TilingConfig]:
        """The given tiling, else the default one above 4000 latent voxels."""
        if self.tiling_config is not None:
            return self.tiling_config
        latent_frames = (self.num_frames - 1) // 8 + 1
        if latent_frames * (self.height // 32) * (self.width // 32) > 4000:
            return TilingConfig.default()
        return None


class OneStagePipeline:
    """Single-stage CFG generation over the port's modules: the DiT, the
    video encoder (for images) and decoder, and for audio the audio decoder
    and the vocoder."""

    def __init__(self, transformer: LTXModel, video_encoder: Optional[VideoEncoder] = None,
                 video_decoder: Optional[VideoDecoder] = None, sequence_mesh=None, pipeline_mesh=None,
                 vae_mesh=None, vae_w_mesh=None, audio_decoder: Optional[AudioDecoder] = None, vocoder=None):
        meshes = (sequence_mesh, pipeline_mesh, vae_mesh, vae_w_mesh)
        if any(m is not None for m in meshes):
            raise NotImplementedError("not ported to the one-stage pipeline: meshes (sequence, pipeline and VAE "
                                      "parallelism)")
        self.transformer = transformer
        self.video_encoder = video_encoder
        self.video_decoder = video_decoder
        self.audio_decoder = audio_decoder
        self.vocoder = vocoder
        self.is_av_model = transformer.cfg.is_av
        self.patchifier = VideoLatentPatchifier(patch_size=1)
        self.scheduler = LTX2Scheduler()

    def __call__(
        self,
        positive_encoding: torch.Tensor,
        negative_encoding: torch.Tensor,
        config: OneStageCFGConfig,
        images: Optional[List[ImageCondition]] = None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        positive_audio_encoding=None,
        negative_audio_encoding=None,
        stg_scale: float = 0.0,
        stg_blocks=None,
        stg_cutoff: float = 1.0,
        stg_mode: str = "video",
        guider_override=None,
        ge_gamma: float = 0.0,
        sampler: str = "euler",
        spatial_upscaler: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        temporal_upscaler=None,
        cross_attn_scale: float = 1.0,
        cross_attn_start_block: int = 40,
        skip_decode: bool = False,
        cache_text_kv: bool = False,
        noise: Optional[torch.Tensor] = None,
        audio_noise: Optional[torch.Tensor] = None,
    ) -> Tuple[object, Optional[torch.Tensor]]:
        """Generate one clip from the (1, S, D) positive and negative
        encodings: (uint8 (frames, height, width, 3) frames on the host,
        the (1, 2, samples) waveform with `config.audio_enabled`, else
        None), or with skip_decode ((1, C, F, H, W) latent, the (1, C, T, F)
        audio latent of an audio-video DiT, else None). `noise` /
        `audio_noise`: the patchified (1, tokens, C) initial noise, drawn
        from the seeds when not given. `callback(phase, latent)` runs after
        "image_encode" (with images), "denoise", with a spatial upscaler
        "upscale", with a temporal one "upscale_temporal", and with audio
        "audio_decode". Each upscaler maps a (B, C, F, H, W) latent to its
        upscaled latent (`temporal_upscaler_apply` bound to its module)."""
        audio = self.is_av_model and (config.use_internal_audio_branch or config.audio_enabled)
        if (config.audio_enabled or audio) and (positive_audio_encoding is None or negative_audio_encoding is None):
            raise ValueError("Audio encoding required for AudioVideo generation. Provide positive_audio_encoding "
                             "and negative_audio_encoding.")
        if stg_scale > 0 and stg_mode in ("audio", "both") and not audio:
            # Video only: there is no audio self-attention to perturb, so the
            # STG delta would be exactly 0 while every step paid its row.
            raise ValueError(f"stg_mode={stg_mode!r} requires the audio branch (--audio / "
                             f"use_internal_audio_branch); on a video-only run the audio perturbation is a no-op. "
                             f"Use stg_mode='video'.")
        if config.token_bucket and audio:
            raise ValueError("token_bucket is video-only: padded video keys would leak into the a2v/v2a "
                             "cross-modal attention unmasked")
        images = list(images or [])
        device, dtype = positive_encoding.device, getattr(torch, config.dtype)
        noise_seed, decode_seed, audio_seed = stage_seeds(config.seed, 3)
        guider_class = CFGStarRescalingGuider if config.rescale_scale > 0 else CFGGuider
        guider = guider_override if guider_override is not None else guider_class(scale=config.cfg_scale)

        pixel_shape = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height, width=config.width,
                                      fps=config.fps)
        latent_shape = VideoLatentShape.from_pixel_shape(pixel_shape, latent_channels=config.latent_channels)
        tools = VideoLatentTools(patchifier=self.patchifier, target_shape=latent_shape, fps=config.fps)
        conditionings = create_image_conditionings(
            images, lambda image: encode_image(self.video_encoder, image), config.height, config.width, dtype, device)
        if conditionings and callback:
            callback("image_encode", conditionings[0].latent)
        state = apply_conditionings(tools.create_initial_state(dtype=dtype, device=device), conditionings, tools)
        # The reference pipelines pass no latent to the scheduler: the shift
        # anchors at 4096 tokens unless token_dependent_shift asks for the clip's.
        sigmas = torch.from_numpy(self.scheduler.execute(
            steps=config.num_inference_steps,
            tokens=latent_shape.tokens if config.token_dependent_shift else None))
        gen = None if noise is not None else torch.Generator(device=device).manual_seed(noise_seed)
        state = GaussianNoiser()(gen, state, noise_scale=1.0, noise=noise)

        loop_cfg = DenoiseLoopConfig(
            guider=guider, audio_guider=guider_class(scale=config.audio_cfg_scale), stg_scale=stg_scale,
            stg_blocks=tuple(stg_blocks) if stg_blocks else None, stg_cutoff=stg_cutoff, stg_mode=stg_mode,
            ge_gamma=ge_gamma, sampler=sampler, cross_attn_scale=cross_attn_scale,
            cross_attn_start_block=cross_attn_start_block, cache_text_kv=cache_text_kv,
            uniform_timesteps=not conditionings, cfg_interval=config.cfg_interval)
        audio_latent = None
        if audio:
            audio_tools = config.audio_tools(pixel_shape)
            audio_state = audio_tools.create_initial_state(dtype=dtype, device=device)
            audio_gen = None if audio_noise is not None else torch.Generator(device=device).manual_seed(audio_seed)
            audio_state = GaussianNoiser()(audio_gen, audio_state, noise_scale=1.0, noise=audio_noise)
            state, audio_state = make_av_denoise_loop(self.transformer.cfg, loop_cfg)(
                self.transformer, state, audio_state, sigmas, positive_encoding, negative_encoding,
                positive_audio_encoding, negative_audio_encoding)
            audio_latent = audio_tools.unpatchify(audio_tools.clear_conditioning(audio_state)).latent
        else:
            n_real, token_mask = state.latent.shape[1], None
            if config.token_bucket:
                state, token_mask = pad_state_tokens(state, bucketed_tokens(n_real, config.token_bucket))
            state = make_video_denoise_loop(self.transformer.cfg, loop_cfg)(
                self.transformer, state, sigmas, positive_encoding, negative_encoding, token_mask=token_mask)
            state = slice_state_tokens(state, n_real)
        latent = tools.unpatchify(tools.clear_conditioning(state)).latent
        if callback:
            callback("denoise", latent)

        # Post-hoc upscaling, spatial before temporal, each in its own
        # un-normalize / re-normalize bracket (the normalized latent itself
        # without the decoder's statistics, as the reference).
        for phase, upscaler in (("upscale", spatial_upscaler), ("upscale_temporal", temporal_upscaler)):
            if upscaler is None:
                continue
            if self.video_decoder is None:
                latent = upscaler(latent)
            else:
                stats = self.video_decoder.per_channel_statistics
                latent = normalize_latent(upscaler(un_normalize_latent(latent, stats)), stats)
            if callback:
                callback(phase, latent)
        if skip_decode:
            return latent, audio_latent
        if self.video_decoder is None:
            raise ValueError("video decoder required to decode (or pass skip_decode=True)")
        video = decode_video(latent, self.video_decoder, config.effective_tiling(), decode_seed)
        waveform = None
        if config.audio_enabled and audio_latent is not None:
            waveform = decode_audio(audio_latent, self.audio_decoder, self.vocoder)
            if callback:
                callback("audio_decode", waveform)
        return video, waveform
