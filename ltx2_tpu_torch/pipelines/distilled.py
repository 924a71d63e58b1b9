"""The two-stage distilled text-to-video recipe (counterpart of
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

With an audio-video DiT the audio stream denoises beside the video in both
stages (the joint loop), whether or not the audio is decoded, unless
`use_internal_audio_branch` is off and the audio is not asked for (as the
JAX package): its 126 latent frames for
121 frames at 24 fps are noised in each stage; in stage 1 the noise is
normalized channelwise (`channelwise_normalize_audio`), and stage 2 starts
from stage 1's audio latent, re-noised to stage 2's first sigma. With
`audio_enabled` the final audio latent goes through the audio decoder and
the vocoder. The audio context is the text encoding unless
`audio_encoding` is given (V2's audio connector makes one).

Randomness: the JAX package splits PRNGKey(seed) into stage-1, stage-2 and
decode keys, and each stage's key into video and audio keys. The port draws
three seeds from a torch.Generator seeded with `config.seed`
(`stage_seeds`) and seeds one generator per stage (video noise, then audio
noise) and one for the decode noise; a caller may hand in each stage's
noise instead (the tests hand in the JAX package's).

Frozen audio (`freeze_audio`, the a2vid pipeline's): the audio latent keeps
denoise mask 0 and clean latent == latent through both stages, so the
Euler update is exactly 0 and the latent comes out bit for bit as it went
in; the audio tokens then see timestep 0, so the stages run per-token
timesteps. An `initial_audio_latent` (encoded from a waveform) is frozen
before the noiser, whose blend is then a no-op; without one the noised
zeros are frozen after it. The generator draws the audio noise either way,
so the video's noise does not depend on the freeze.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import AudioPatchifier, VideoLatentPatchifier
from ltx2_tpu_torch.components.schedulers import DISTILLED_SIGMA_VALUES, STAGE_2_DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.tools import AudioLatentTools, VideoLatentTools
from ltx2_tpu_torch.models.audio_vae.decoder import AudioDecoder
from ltx2_tpu_torch.models.transformer.model import LTXModel
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, spatial_upscaler_apply
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder
from ltx2_tpu_torch.models.video_vae.ops import normalize_latent, un_normalize_latent
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig
from ltx2_tpu_torch.pipelines.common import (
    ImageCondition, apply_conditionings, create_image_conditionings, decode_audio, decode_video, encode_image,
    read_image,
)
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_av_denoise_loop, make_video_denoise_loop
from ltx2_tpu_torch.types import AudioLatentShape, VideoLatentShape, VideoPixelShape


@dataclass
class AudioFields:
    """The audio fields the distilled and one-stage configs share: whether
    the audio is decoded, whether an AV model denoises it regardless, and
    the audio latent's geometry (8 channels x 16 mel bins, 25 latent frames
    a second)."""

    audio_enabled: bool = False
    use_internal_audio_branch: bool = True
    audio_vae_channels: int = 8
    audio_mel_bins: int = 16
    audio_sample_rate: int = 16000
    audio_hop_length: int = 160
    audio_downsample_factor: int = 4

    def audio_tools(self, pixel_shape: VideoPixelShape) -> AudioLatentTools:
        shape = AudioLatentShape.from_video_pixel_shape(
            pixel_shape, channels=self.audio_vae_channels, mel_bins=self.audio_mel_bins,
            sample_rate=self.audio_sample_rate, hop_length=self.audio_hop_length,
            audio_latent_downsample_factor=self.audio_downsample_factor)
        return AudioLatentTools(patchifier=AudioPatchifier(patch_size=1), target_shape=shape)


@dataclass
class DistilledConfig(AudioFields):
    """The JAX package's DistilledConfig (its scheduler's
    `token_dependent_shift` aside: the distilled stages use fixed sigmas)."""

    height: int = 704
    width: int = 1024
    num_frames: int = 121
    seed: int = 42
    fps: float = 24.0
    dtype: str = "float32"
    tiling_config: Optional[TilingConfig] = None
    latent_channels: int = 128

    def __post_init__(self):
        if self.num_frames % 8 != 1:
            raise ValueError(f"num_frames must be 8*k + 1, got {self.num_frames}.")
        if self.height % 64 != 0 or self.width % 64 != 0:
            raise ValueError(f"Resolution ({self.height}x{self.width}) must be divisible by 64 for the "
                             f"distilled two-stage pipeline.")

    def effective_tiling(self) -> Optional[TilingConfig]:
        """The given tiling, else the default one above 4000 latent voxels."""
        if self.tiling_config is not None:
            return self.tiling_config
        latent_frames = (self.num_frames - 1) // 8 + 1
        if latent_frames * (self.height // 32) * (self.width // 32) > 4000:
            return TilingConfig.default()
        return None


def channelwise_normalize_audio(latent: torch.Tensor) -> torch.Tensor:
    """Length-invariant audio noise: zero mean and unit (population) std
    over the whole tensor, then unit std per feature over the tokens, in
    fp32, the latent's dtype out."""
    x = latent.float()
    x = (x - x.mean()) / (x.std(correction=0) + 1e-8)
    mean = x.mean(dim=1, keepdim=True)
    std = x.std(dim=1, keepdim=True, correction=0) + 1e-8
    return ((x - mean) / std).to(latent.dtype)


def _freeze(state):
    """Mask 0 and clean latent == latent: the Euler update is exactly 0."""
    return state.replace(clean_latent=state.latent, denoise_mask=torch.zeros_like(state.denoise_mask))


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
                 video_encoder: Optional[VideoEncoder] = None, audio_decoder: Optional[AudioDecoder] = None,
                 vocoder=None):
        self.transformer = transformer
        self.spatial_upscaler = spatial_upscaler
        self.video_decoder = video_decoder
        self.video_encoder = video_encoder
        self.audio_decoder = audio_decoder
        self.vocoder = vocoder
        self.statistics = statistics
        self.is_av_model = transformer.cfg.is_av
        self.patchifier = VideoLatentPatchifier(patch_size=1)
        makers = {False: make_video_denoise_loop, True: make_av_denoise_loop}
        self.loops = {(audio, uniform): makers[audio](
            transformer.cfg, DenoiseLoopConfig(guider=CFGGuider(1.0), uniform_timesteps=uniform))
            for audio in {False, self.is_av_model} for uniform in (True, False)}

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
                   phase: str = "", callback=None, audio_encoding: Optional[torch.Tensor] = None,
                   initial_audio_latent: Optional[torch.Tensor] = None, audio_noise: Optional[torch.Tensor] = None,
                   normalize_audio_noise: bool = False, freeze_audio: bool = False,
                   extra_conditionings: Optional[Sequence] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One stage: initial state (zeros, or the given latent as clean
        latent) -> the images (`decoded`: each path's pixels), resized to
        this stage's size, encoded and written over their frames -> Gaussian
        noise at `noise_scale` -> the denoise loop over `sigmas` -> the
        (B, C, F, H, W) latent and, given an `audio_encoding` (an
        audio-video DiT's audio stream), the (B, C, T, F) audio latent
        (else None): its state from `initial_audio_latent` (zeros when
        None), noised after the video from the same generator (or
        `audio_noise`), normalized with `normalize_audio_noise` unless
        `freeze_audio` (then frozen: mask 0, clean latent == latent; an
        initial audio latent before the noiser, the noised zeros after it).
        With images and a callback, `callback(phase + "_image_encode", first
        image's latent)` runs once they are encoded. `extra_conditionings`
        (ic-lora's control videos) are applied after the images'; any
        conditioning switches the loop to per-token timesteps."""
        device, dtype = text_encoding.device, getattr(torch, config.dtype)
        shape = VideoLatentShape.from_pixel_shape(pixel_shape, latent_channels=config.latent_channels)
        tools = VideoLatentTools(patchifier=self.patchifier, target_shape=shape, fps=config.fps)
        conditionings = create_image_conditionings(
            images, lambda image: encode_image(self.video_encoder, image), pixel_shape.height, pixel_shape.width,
            dtype, device, decoded)
        if conditionings and callback:
            callback(f"{phase}_image_encode", conditionings[0].latent)
        if extra_conditionings:
            conditionings = conditionings + list(extra_conditionings)
        state = tools.create_initial_state(dtype=dtype, initial_latent=initial_video_latent, device=device)
        state = apply_conditionings(state, conditionings, tools)
        noiser = GaussianNoiser()
        state = noiser(generator, state, noise_scale=noise_scale, noise=noise)
        sig = torch.tensor(sigmas, dtype=torch.float32)
        # Frozen audio tokens must see timestep mask * sigma = 0: per token.
        loop = self.loops[(audio_encoding is not None, not conditionings and not freeze_audio)]
        if audio_encoding is None:
            state = loop(self.transformer, state, sig, text_encoding, text_encoding)
            return tools.unpatchify(tools.clear_conditioning(state)).latent, None
        audio_tools = config.audio_tools(pixel_shape)
        audio_state = audio_tools.create_initial_state(dtype=dtype, initial_latent=initial_audio_latent,
                                                       device=device)
        if freeze_audio and initial_audio_latent is not None:
            audio_state = _freeze(audio_state)
        audio_state = noiser(generator, audio_state, noise_scale=noise_scale, noise=audio_noise)
        if normalize_audio_noise and not freeze_audio:
            audio_state = audio_state.replace(latent=channelwise_normalize_audio(audio_state.latent))
        if freeze_audio and initial_audio_latent is None:
            audio_state = _freeze(audio_state)
        state, audio_state = loop(self.transformer, state, audio_state, sig, text_encoding, text_encoding,
                                  audio_encoding, audio_encoding)
        return (tools.unpatchify(tools.clear_conditioning(state)).latent,
                audio_tools.unpatchify(audio_tools.clear_conditioning(audio_state)).latent)

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
        audio_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Generate one clip for the (1, S, D) text encoding: uint8
        (frames, height, width, 3) frames on the host, or with skip_decode
        the final (1, C, F, H, W) latent; with `config.audio_enabled` (an
        audio-video DiT) the pair (that, the (1, 2, samples) waveform, or
        with skip_decode the (1, C, T, F) audio latent). `noises` /
        `audio_noises`: each stage's patchified (1, tokens, C) noise, drawn
        from the stage seeds when not given. `images` condition both stages
        (the video encoder encodes each at the stage's size).
        `callback(phase, latent)` runs after "stage1", "upscale" and
        "stage2" with that phase's latent, with images after
        "stage1_image_encode" and "stage2_image_encode", and after
        "audio_decode" with the waveform."""
        images = list(images or [])
        if not (self.is_av_model and (config.use_internal_audio_branch or config.audio_enabled)):
            audio_encoding = None  # the video stream alone, as the JAX package runs it
        elif audio_encoding is None:
            audio_encoding = text_encoding
        device = text_encoding.device
        seeds = stage_seeds(config.seed)
        given = noises is not None or audio_noises is not None
        gens = [None, None] if given else [torch.Generator(device=device).manual_seed(s) for s in seeds[:2]]
        noises = noises if noises is not None else (None, None)
        audio_noises = audio_noises if audio_noises is not None else (None, None)

        stage_1 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height // 2,
                                  width=config.width // 2, fps=config.fps)
        decoded = {c.image_path: read_image(c.image_path) for c in images}  # decoded once, resized per stage
        latent, audio_latent = self._run_stage(
            stage_1, DISTILLED_SIGMA_VALUES, text_encoding, config, images, decoded, gens[0], 1.0, noise=noises[0],
            phase="stage1", callback=callback, audio_encoding=audio_encoding, audio_noise=audio_noises[0],
            normalize_audio_noise=True, initial_audio_latent=initial_audio_latent, freeze_audio=freeze_audio)
        if callback:
            callback("stage1", latent)

        if self.spatial_upscaler is not None:
            upscaled = self._upscale_latent(latent, getattr(torch, config.dtype))
            if callback:
                callback("upscale", upscaled)
            stage_2 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height,
                                      width=config.width, fps=config.fps)
            latent, audio_latent = self._run_stage(
                stage_2, STAGE_2_DISTILLED_SIGMA_VALUES, text_encoding, config, images, decoded, gens[1],
                float(STAGE_2_DISTILLED_SIGMA_VALUES[0]), initial_video_latent=upscaled, noise=noises[1],
                phase="stage2", callback=callback, audio_encoding=audio_encoding,
                initial_audio_latent=audio_latent, audio_noise=audio_noises[1], freeze_audio=freeze_audio)
            if callback:
                callback("stage2", latent)

        if skip_decode:
            return (latent, audio_latent) if config.audio_enabled else latent
        video = decode_video(latent, self.video_decoder, config.effective_tiling(), seeds[2])
        if not config.audio_enabled:
            return video
        if audio_latent is None:  # a video-only DiT: no audio, as in the JAX package
            return video, None
        waveform = decode_audio(audio_latent, self.audio_decoder, self.vocoder)
        if callback:
            callback("audio_decode", waveform)
        return video, waveform
