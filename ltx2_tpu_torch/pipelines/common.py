"""Shared pipeline utilities (counterpart of ltx2_tpu/pipelines/common.py),
and the video decode the pipelines share (`decode_video`, the counterpart of
`OneStagePipeline._decode_video` in ltx2_tpu/pipelines/one_stage.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ltx2_tpu_torch.models.transformer.model import Modality
from ltx2_tpu_torch.models.video_vae.chunking import _to_uint8_frames, decode_latent
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, video_decoder_apply
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, decode_tiled
from ltx2_tpu_torch.types import LatentState


def post_process_latent(
    denoised: torch.Tensor, denoise_mask: torch.Tensor, clean_latent: torch.Tensor
) -> torch.Tensor:
    """denoised*mask + clean*(1-mask), fp32 math, denoised's dtype out."""
    if denoise_mask.ndim == 2 and denoised.ndim == 3:
        denoise_mask = denoise_mask[..., None]
    mask = denoise_mask.float()
    return (denoised.float() * mask + clean_latent.float() * (1 - mask)).to(denoised.dtype)


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
