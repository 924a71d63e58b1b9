"""TI2Vid-HQ: two-stage generation with the Res2s second-order sampler at
stage 1 (counterpart of ltx2_tpu/pipelines/ti2vid_hq.py).

Stage 1 runs at half resolution: a Res2s exponential-integrator RK loop
under CFG over LTX2Scheduler's sigmas, two guided evaluations a step (the
prompt and negative rows on the batch axis), images conditioning the
latent. The reference's 100-iteration anchor refinement is an affine
fixed-point iteration; the port, as the JAX package, takes its closed form
anchor = (x_mid - c * denoised) / (1 - c), c = h * a21. Then the 2x spatial
upscale and the distilled recipe's stage 2 (`DistilledPipeline._run_stage`:
the 3-sigma tail, no guidance, the images again), then the decodes. With
an audio-video DiT the audio stream runs beside the video in both stages
(its own guidance scale at stage 1), unless `use_internal_audio_branch` is
off and no audio is asked for. Without a spatial upscaler the stage-1
latent is the result.

Randomness: the port draws (stage 1, stage 2, decode) seeds as the
distilled recipe does (`stage_seeds`), video noise before audio noise in
each stage; the tests hand the JAX package's noise in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.res2s import get_res2s_coefficients
from ltx2_tpu_torch.components.schedulers import LTX2Scheduler, STAGE_2_DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.pipelines.common import (
    ImageCondition, apply_conditionings, create_image_conditionings, decode_audio, encode_image,
    modality_from_state, post_process_latent, read_image,
)
from ltx2_tpu_torch.pipelines.denoise import _precompute_video_pe, _tile_rows, mesh_forward
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline, stage_seeds
from ltx2_tpu_torch.types import LatentState, VideoLatentShape, VideoPixelShape


@dataclass
class TI2VidHQConfig(DistilledConfig):
    """The JAX package's TI2VidHQConfig."""

    num_inference_steps: int = 15
    cfg_scale: float = 3.0
    audio_cfg_scale: float = 7.0
    token_dependent_shift: bool = False


def _tiled(state: LatentState, latent: torch.Tensor, rows: int) -> LatentState:
    return LatentState(latent=_tile_rows(latent, rows), denoise_mask=_tile_rows(state.denoise_mask, rows),
                       positions=_tile_rows(state.positions, rows), clean_latent=_tile_rows(state.clean_latent, rows))


class TI2VidHQPipeline(DistilledPipeline):
    """The Res2s-sampled two-stage pipeline over the distilled pipeline's
    modules."""

    CFG_ROW = True  # stage 1's Res2s loop

    def _res2s_denoise(self, video_state: LatentState, audio_state: Optional[LatentState], sigmas: np.ndarray,
                       pos_v, neg_v, pos_a, neg_a, cfg_scale: float, audio_cfg_scale: float, callback=None):
        """The Res2s RK loop: per step a guided evaluation at sigma, the
        midpoint (with the closed-form anchor while h < 0.5 and sigma >
        0.03), a guided evaluation there at sqrt(sigma * sigma_next), the RK
        update in fp32. The schedule's final 0 becomes [0.0011, 0], and the
        loop keeps the original step count, so it ends with the step to
        0.0011, as the reference's executable does. Returns the states with
        their final latents."""
        av = audio_state is not None
        av_cfg = av and audio_cfg_scale != 1.0
        need_cfg = (cfg_scale != 1.0 or av_cfg) and neg_v is not None
        rows = 2 if need_cfg else 1
        model = self.transformer
        x0 = mesh_forward(sequence_axis="seq", microbatches=rows, **self.loop_kwargs)
        video_pe = _precompute_video_pe(model.cfg, video_state.positions, rows)
        sig = [float(s) for s in sigmas]
        if sig[-1] == 0.0:
            sig = sig[:-1] + [0.0011, 0.0]
        hs = [-math.log(sig[i + 1] / sig[i]) if sig[i] > 0 and sig[i + 1] > 0 else 0.0 for i in range(len(sig) - 1)]
        num_steps = len(sigmas) - 1
        phi_cache: dict = {}
        v_ctx = torch.cat([pos_v, neg_v]) if need_cfg else pos_v
        a_ctx = (torch.cat([pos_a, neg_a]) if need_cfg else pos_a) if av else None

        def guide(out, scale):
            if not need_cfg:
                return out[0:1]
            pos, neg = out[0:1], out[1:2]
            return neg + scale * (pos - neg)

        def cfg_eval(v_latent, a_latent, sigma: float):
            sigma_t = torch.tensor(sigma, dtype=torch.float32, device=v_latent.device)
            video = modality_from_state(_tiled(video_state, v_latent, rows), v_ctx, sigma_t)
            if not av:
                return guide(x0(model, video, video_pe=video_pe), cfg_scale), None
            audio = modality_from_state(_tiled(audio_state, a_latent, rows), a_ctx, sigma_t)
            v_out, a_out = x0(model, video, video_pe=video_pe, audio=audio)
            return guide(v_out, cfg_scale), guide(a_out, audio_cfg_scale)

        def post(d, state):
            return post_process_latent(d, state.denoise_mask, state.clean_latent)

        v_latent = video_state.latent
        a_latent = audio_state.latent if av else None
        for step in range(num_steps):
            sigma, sigma_next = sig[step], sig[step + 1]
            d_v, d_a = cfg_eval(v_latent, a_latent, sigma)
            d_v = post(d_v, video_state)
            d_a = post(d_a, audio_state) if av else None
            h = hs[step]
            if h == 0.0 or sigma_next <= 0.001:
                v_latent = d_v
                if av:
                    a_latent = d_a
                break
            a21, b1, b2 = get_res2s_coefficients(h, phi_cache, 0.5)
            c = h * a21
            refine = h < 0.5 and sigma > 0.03 and abs(1 - c) > 1e-6

            def advance(latent, denoised):
                anchor = latent.float()
                eps1 = denoised.float() - anchor
                x_mid = anchor + c * eps1
                if refine:  # the anchor iteration's fixed point, closed form
                    anchor = (x_mid - c * denoised.float()) / (1 - c)
                    eps1 = denoised.float() - anchor
                return anchor, eps1, x_mid

            anchor_v, eps1_v, x_mid_v = advance(v_latent, d_v)
            x_mid_a = None
            if av:
                anchor_a, eps1_a, x_mid_a = advance(a_latent, d_a)
            d_v2, d_a2 = cfg_eval(x_mid_v.to(v_latent.dtype),
                                  x_mid_a.to(a_latent.dtype) if av else None, math.sqrt(sigma * sigma_next))
            eps2_v = post(d_v2, video_state).float() - anchor_v
            v_latent = (anchor_v + h * (b1 * eps1_v + b2 * eps2_v)).to(v_latent.dtype)
            if av:
                eps2_a = post(d_a2, audio_state).float() - anchor_a
                a_latent = (anchor_a + h * (b1 * eps1_a + b2 * eps2_a)).to(a_latent.dtype)
            if callback:
                callback(step + 1, num_steps)
        return (video_state.replace(latent=v_latent),
                audio_state.replace(latent=a_latent) if av else None)

    @torch.no_grad()
    def __call__(
        self,
        positive_encoding: torch.Tensor,
        negative_encoding: torch.Tensor,
        config: TI2VidHQConfig,
        images: Optional[List[ImageCondition]] = None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        positive_audio_encoding: Optional[torch.Tensor] = None,
        negative_audio_encoding: Optional[torch.Tensor] = None,
        skip_decode: bool = False,
        noises: Optional[Sequence[torch.Tensor]] = None,
        audio_noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Generate one clip from the (1, S, D) positive and negative
        encodings: uint8 (frames, height, width, 3) frames on the host, or
        with skip_decode the final (1, C, F, H, W) latent; with
        `config.audio_enabled` the pair (that, the (1, 2, samples) waveform
        or with skip_decode the (1, C, T, F) audio latent; None from a
        video-only DiT). The audio encodings default to the video's.
        `noises` / `audio_noises`: each stage's patchified (1, tokens, C)
        noise, drawn from the stage seeds when not given. `images`
        condition both stages. `callback(phase, latent)` runs after
        "stage1", "upscale", "stage2" and "audio_decode"."""
        images = list(images or [])
        device, dtype = positive_encoding.device, getattr(torch, config.dtype)
        audio = self.is_av_model and (config.use_internal_audio_branch or config.audio_enabled)
        if audio and positive_audio_encoding is None:
            positive_audio_encoding, negative_audio_encoding = positive_encoding, negative_encoding
        seeds = stage_seeds(config.seed)
        given = noises is not None or audio_noises is not None
        gens = [None, None] if given else [torch.Generator(device=device).manual_seed(s) for s in seeds[:2]]
        noises = noises if noises is not None else (None, None)
        audio_noises = audio_noises if audio_noises is not None else (None, None)
        decoded = {c.image_path: read_image(c.image_path) for c in images}

        stage_1 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height // 2,
                                  width=config.width // 2, fps=config.fps)
        latent_shape = VideoLatentShape.from_pixel_shape(stage_1, latent_channels=config.latent_channels)
        tools = VideoLatentTools(patchifier=self.patchifier, target_shape=latent_shape, fps=config.fps)
        state = tools.create_initial_state(dtype=dtype, device=device)
        conditionings = create_image_conditionings(
            images, lambda image: encode_image(self.video_encoder, image), stage_1.height, stage_1.width, dtype,
            device, decoded)
        state = apply_conditionings(state, conditionings, tools)
        sigmas = LTX2Scheduler().execute(steps=config.num_inference_steps,
                                         tokens=latent_shape.tokens if config.token_dependent_shift else None)
        noiser = GaussianNoiser()
        state = noiser(gens[0], state, noise_scale=1.0, noise=noises[0])
        audio_state = audio_tools = None
        if audio:
            audio_tools = config.audio_tools(stage_1)
            audio_state = noiser(gens[0], audio_tools.create_initial_state(dtype=dtype, device=device), 1.0,
                                 noise=audio_noises[0])
        state, audio_state = self._res2s_denoise(
            state, audio_state, sigmas, positive_encoding, negative_encoding, positive_audio_encoding,
            negative_audio_encoding, config.cfg_scale, config.audio_cfg_scale)
        latent = tools.unpatchify(tools.clear_conditioning(state)).latent
        audio_latent = (audio_tools.unpatchify(audio_tools.clear_conditioning(audio_state)).latent
                        if audio else None)
        if callback:
            callback("stage1", latent)

        if self.spatial_upscaler is not None:
            upscaled = self._upscale_latent(latent, dtype)
            if callback:
                callback("upscale", upscaled)
            stage_2 = VideoPixelShape(batch=1, frames=config.num_frames, height=config.height, width=config.width,
                                      fps=config.fps)
            latent, audio_latent = self._run_stage(
                stage_2, STAGE_2_DISTILLED_SIGMA_VALUES, positive_encoding, config, images, decoded, gens[1],
                float(STAGE_2_DISTILLED_SIGMA_VALUES[0]), initial_video_latent=upscaled, noise=noises[1],
                phase="stage2", audio_encoding=positive_audio_encoding if audio else None,
                initial_audio_latent=audio_latent, audio_noise=audio_noises[1])
            if callback:
                callback("stage2", latent)

        if skip_decode:
            return (latent, audio_latent) if config.audio_enabled else latent
        video = self.decode(latent, config.effective_tiling(), seeds[2])
        if not config.audio_enabled:
            return video
        if audio_latent is None:
            return video, None
        waveform = decode_audio(audio_latent, self.audio_decoder, self.vocoder)
        if callback:
            callback("audio_decode", waveform)
        return video, waveform


def create_ti2vid_hq_pipeline(**kwargs) -> TI2VidHQPipeline:
    return TI2VidHQPipeline(**kwargs)
