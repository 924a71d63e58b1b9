"""Shared pipeline utilities (counterpart of ltx2_tpu/pipelines/common.py):
image loading and image -> latent-index conditionings, denoise-mask
post-processing, shape-bucketed serving (a state's token axis padded to a
bucket and sliced back), Modality construction with per-token timesteps, and the
video and audio decodes the pipelines share (`decode_video` and
`decode_audio`, the counterparts of `OneStagePipeline._decode_video` and
`_decode_audio` in ltx2_tpu/pipelines/one_stage.py)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.conditioning.item import ConditioningItem
from ltx2_tpu_torch.conditioning.latent import VideoConditionByLatentIndex
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.models.audio_vae.decoder import AudioDecoder, audio_decoder_apply
from ltx2_tpu_torch.models.audio_vae.vocoder import VocoderWithBWE, vocoder_apply, vocoder_with_bwe_apply
from ltx2_tpu_torch.models.transformer.model import Modality
from ltx2_tpu_torch.models.video_vae.chunking import _to_uint8_frames, decode_latent
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, video_decoder_apply
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder, video_encoder_apply
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, decode_tiled
from ltx2_tpu_torch.types import LatentState
from ltx2_tpu_torch.utils.image_io import read_png, resize_lanczos, sniff
from ltx2_tpu_torch.utils.jpeg import decode_jpeg


@dataclass
class ImageCondition:
    image_path: str
    frame_index: int
    strength: float = 0.95


def read_image(image_path: str) -> np.ndarray:
    """An image file -> uint8 (H, W, 3) RGB, dispatched on its signature:
    PNG to `read_png`, JPEG to the baseline decoder (`utils/jpeg.py`);
    anything else (WebP, GIF, BMP, ...) raises a ValueError naming it."""
    if not os.path.exists(image_path):
        raise FileNotFoundError(f"Image not found: {image_path}")
    with open(image_path, "rb") as fh:
        data = fh.read()
    kind = sniff(data[:16])
    if kind == "PNG":
        return read_png(image_path)
    if kind == "JPEG":
        return decode_jpeg(data, image_path)
    raise ValueError(f"Unsupported image format: {kind} ({image_path}); supported: 8-bit PNG (L, RGB, RGBA) and "
                     "baseline JPEG")


def load_image_tensor(image_path: str, height: int, width: int, dtype=torch.float32, device=None,
                      rgb: Optional[np.ndarray] = None) -> torch.Tensor:
    """An image file (or its decoded `rgb`, `read_image`'s) -> (1, 3, 1,
    height, width) in [-1, 1] on `device` (default the CPU): resized with
    PIL's LANCZOS (`resize_lanczos`) straight to the size when the aspect
    ratios differ by less than 0.01, else to cover it and centre-cropped,
    as the JAX package's PIL code does."""
    img = torch.from_numpy(read_image(image_path) if rgb is None else rgb)
    src_h, src_w = img.shape[:2]
    target_aspect, src_aspect = width / height, src_w / src_h
    if abs(src_aspect - target_aspect) < 0.01:
        img = resize_lanczos(img, width, height)
    else:
        if src_aspect > target_aspect:
            new_h, new_w = height, int(src_w * (height / src_h))
        else:
            new_w, new_h = width, int(src_h * (width / src_w))
        img = resize_lanczos(img, new_w, new_h)
        left, top = (new_w - width) // 2, (new_h - height) // 2
        img = img[top:top + height, left:left + width]
    arr = img.float() / 127.5 - 1.0
    return arr.permute(2, 0, 1)[None, :, None].to(device=device, dtype=dtype)


def encode_image(video_encoder: Optional[VideoEncoder], image: torch.Tensor) -> torch.Tensor:
    """(1, 3, 1, H, W) pixels -> the encoder's normalized latent (the
    pipelines' `_encode_image`)."""
    if video_encoder is None:
        raise ValueError("video encoder required for image conditioning")
    with torch.no_grad():
        return video_encoder_apply(video_encoder, image)


def create_image_conditionings(images: List[ImageCondition], encode_fn: Callable[[torch.Tensor], torch.Tensor],
                               height: int, width: int, dtype=torch.float32, device=None,
                               decoded: Optional[Dict[str, np.ndarray]] = None) -> List[ConditioningItem]:
    """Each image loaded at (height, width) on `device` (from `decoded`,
    {path: `read_image(path)`}, when it holds the path) and encoded by
    `encode_fn` ((1, 3, 1, H, W) pixels -> (1, C, 1, H/32, W/32) latent)
    into a latent-index conditioning at its frame."""
    conditionings = []
    for img_cond in images:
        rgb = None if decoded is None else decoded.get(img_cond.image_path)
        encoded = encode_fn(load_image_tensor(img_cond.image_path, height, width, dtype, device, rgb))
        conditionings.append(VideoConditionByLatentIndex(latent=encoded, strength=img_cond.strength,
                                                         latent_idx=img_cond.frame_index))
    return conditionings


def apply_conditionings(latent_state: LatentState, conditionings: List[ConditioningItem],
                        video_tools: VideoLatentTools) -> LatentState:
    for conditioning in conditionings:
        latent_state = conditioning.apply_to(latent_state, video_tools)
    return latent_state


def post_process_latent(
    denoised: torch.Tensor, denoise_mask: torch.Tensor, clean_latent: torch.Tensor
) -> torch.Tensor:
    """denoised*mask + clean*(1-mask), fp32 math, denoised's dtype out."""
    if denoise_mask.ndim == 2 and denoised.ndim == 3:
        denoise_mask = denoise_mask[..., None]
    mask = denoise_mask.float()
    return (denoised.float() * mask + clean_latent.float() * (1 - mask)).to(denoised.dtype)


def bucketed_tokens(n: int, bucket: int) -> int:
    """A token count rounded up to a multiple of `bucket`."""
    return ((n + bucket - 1) // bucket) * bucket


def pad_state_tokens(state: LatentState, n_bucket: int) -> Tuple[LatentState, Optional[torch.Tensor]]:
    """A state's token axis padded to `n_bucket`: (padded state, token mask
    (B, n_bucket) bool, False at the padding). The pads are zeros in the
    latent and the clean latent (masked out of attention's keys, so only
    finiteness matters), 1 in the denoise mask, and the last position
    repeated (RoPE stays finite). On the grid already: the state and no
    mask, so attention keeps its unmasked route."""
    n = state.latent.shape[1]
    pad = n_bucket - n
    if pad < 0:
        raise ValueError(f"token count {n} exceeds bucket {n_bucket}")
    if pad == 0:
        return state, None
    b, device = state.latent.shape[0], state.latent.device
    token_mask = torch.cat([torch.ones((b, n), dtype=torch.bool, device=device),
                            torch.zeros((b, pad), dtype=torch.bool, device=device)], dim=1)

    def pad1(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
        return torch.cat([x, x.new_full((x.shape[0], pad, *x.shape[2:]), value)], dim=1)

    last = state.positions[:, :, -1:]
    return LatentState(
        latent=pad1(state.latent),
        clean_latent=pad1(state.clean_latent),
        denoise_mask=pad1(state.denoise_mask, 1.0),
        positions=torch.cat([state.positions, last.expand(-1, -1, pad, -1)], dim=2),
    ), token_mask


def slice_state_tokens(state: LatentState, n: int) -> LatentState:
    """pad_state_tokens undone: the first n tokens."""
    if state.latent.shape[1] == n:
        return state
    return LatentState(
        latent=state.latent[:, :n],
        clean_latent=state.clean_latent[:, :n],
        denoise_mask=state.denoise_mask[:, :n],
        positions=state.positions[:, :, :n],
    )


def timesteps_from_mask(denoise_mask: torch.Tensor, sigma) -> torch.Tensor:
    """(B, N[, 1]) mask * sigma -> (B, N) per-token timesteps."""
    t = denoise_mask.float() * sigma
    return t[..., 0] if t.ndim == 3 else t


def modality_from_state(
    state: LatentState,
    context: torch.Tensor,
    sigma: torch.Tensor,
    uniform_timesteps: bool = False,
    token_mask=None,
) -> Modality:
    """LatentState + context + sigma -> transformer Modality.

    uniform_timesteps: a promise that the denoise mask is all ones, so the
    timesteps are per batch row (B,) and the AdaLN embeddings (B, 1, n, D)."""
    sigma_arr = torch.as_tensor(sigma, dtype=torch.float32, device=state.latent.device).reshape(-1)
    if sigma_arr.shape[0] != state.latent.shape[0]:
        sigma_arr = sigma_arr[:1].expand(state.latent.shape[0])
    return Modality(
        latent=state.latent,
        timesteps=sigma_arr if uniform_timesteps else timesteps_from_mask(state.denoise_mask, sigma),
        positions=state.positions,
        context=context,
        context_mask=None,
        sigma=sigma_arr,
        token_mask=token_mask,
    )


@torch.no_grad()
def decode_video(latent: torch.Tensor, decoder: VideoDecoder, tiling: Optional[TilingConfig],
                 seed: int) -> np.ndarray:
    """One clip's (1, C, T, H, W) latent -> uint8 (T', H', W', 3) frames on
    the host: a tiled decode when `tiling` is set, else one pass of
    `decode_latent`, as the JAX package's `_decode_video` chooses (meshes
    aside). Decode noise comes from `seed`; in a tiled decode every tile
    draws it from the same seed, as the JAX package hands every tile the
    same key."""
    if tiling is None:
        return decode_latent(latent, decoder, generator=torch.Generator(device=latent.device).manual_seed(seed))

    def decode_tile(tile: torch.Tensor, timestep: Optional[float] = 0.05) -> torch.Tensor:
        gen = torch.Generator(device=tile.device).manual_seed(seed)
        noise = torch.randn(tile.shape, generator=gen, dtype=torch.float32, device=tile.device)
        return video_decoder_apply(decoder, tile, timestep=timestep, noise=noise)

    return _to_uint8_frames(decode_tiled(latent, decode_tile, tiling)).cpu().numpy()


@torch.no_grad()
def decode_audio(latent: torch.Tensor, decoder: Optional[AudioDecoder], vocoder) -> torch.Tensor:
    """An audio latent (B, C, T, F) -> waveform (B, 2, samples) in fp32 on
    the latent's device: the audio decoder's log-mel, then the vocoder (or
    LTX-2.3's BWE chain)."""
    if decoder is None or vocoder is None:
        raise ValueError("Audio decoder and vocoder required for audio decoding")
    mel = audio_decoder_apply(decoder, latent)
    return vocoder_with_bwe_apply(vocoder, mel) if isinstance(vocoder, VocoderWithBWE) else vocoder_apply(vocoder, mel)
