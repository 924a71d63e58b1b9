"""Noise injection for the initial latent state (counterpart of
ltx2_tpu/components/noisers.py). Noise comes from an explicit
torch.Generator, or is handed in (the tests hand both packages the same)."""

from __future__ import annotations

from typing import Optional

import torch

from ltx2_tpu_torch.types import LatentState


def _blend(latent_state: LatentState, noise: torch.Tensor, noise_scale: float) -> LatentState:
    """latent = noise*mask*scale + latent*(1 - mask*scale), fp32 math."""
    mask = latent_state.denoise_mask
    if mask.ndim == 2:
        mask = mask[..., None]
    scaled = mask.float() * noise_scale
    latent = noise.float() * scaled + latent_state.latent.float() * (1 - scaled)
    return latent_state.replace(latent=latent.to(latent_state.latent.dtype))


class GaussianNoiser:
    """Gaussian noise blended by the denoise mask."""

    def __call__(
        self,
        generator: Optional[torch.Generator],
        latent_state: LatentState,
        noise_scale: float = 1.0,
        noise: Optional[torch.Tensor] = None,
    ) -> LatentState:
        if noise is None:
            noise = torch.randn(
                latent_state.latent.shape, generator=generator, dtype=torch.float32,
                device=latent_state.latent.device,
            )
        return _blend(latent_state, noise, noise_scale)
