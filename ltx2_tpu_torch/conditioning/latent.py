"""Latent-index conditioning, image-to-video (counterpart of
ltx2_tpu/conditioning/latent.py): the tokens of one latent frame are
replaced by encoded content, in the latent and in the clean latent, and the
denoise mask there is set to 1 - strength."""

from __future__ import annotations

import torch

from ltx2_tpu_torch.conditioning.item import ConditioningError
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.types import LatentState


class VideoConditionByLatentIndex:
    """`latent` (B, C, F', H, W), written over the tokens of latent frames
    latent_idx .. latent_idx + F' - 1."""

    def __init__(self, latent: torch.Tensor, strength: float, latent_idx: int):
        self.latent = latent
        self.strength = strength
        self.latent_idx = latent_idx

    def apply_to(self, latent_state: LatentState, latent_tools: VideoLatentTools) -> LatentState:
        cond_batch, cond_channels, _, cond_height, cond_width = self.latent.shape
        tgt = latent_tools.target_shape
        if (cond_batch, cond_channels, cond_height, cond_width) != (tgt.batch, tgt.channels, tgt.height, tgt.width):
            raise ConditioningError(
                f"Cannot apply image conditioning item to latent with shape {tgt}. "
                f"Expected shape is ({tgt.batch}, {tgt.channels}, _, {tgt.height}, {tgt.width}). "
                "Make sure the image and latent have the same spatial shape."
            )
        patchifier = latent_tools.patchifier
        tokens = patchifier.patchify(self.latent)
        start = patchifier.get_token_count(tgt._replace(frames=self.latent_idx))
        stop = start + tokens.shape[1]
        max_tokens = patchifier.get_token_count(tgt)
        if stop > max_tokens:
            raise ValueError(
                f"Conditioning tokens exceed latent sequence length: stop_token={stop} > max_tokens={max_tokens}. "
                f"latent_idx={self.latent_idx}, tokens.shape={tuple(tokens.shape)}"
            )
        tokens = tokens.to(device=latent_state.latent.device, dtype=latent_state.latent.dtype)
        mask = latent_state.denoise_mask
        cond_mask = torch.full((tokens.shape[0], tokens.shape[1], *mask.shape[2:]), 1.0 - self.strength,
                               dtype=mask.dtype, device=mask.device)

        def replace(x: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
            return torch.cat([x[:, :start], part, x[:, stop:]], dim=1)

        return LatentState(latent=replace(latent_state.latent, tokens),
                           denoise_mask=replace(mask, cond_mask),
                           positions=latent_state.positions,
                           clean_latent=replace(latent_state.clean_latent, tokens))
