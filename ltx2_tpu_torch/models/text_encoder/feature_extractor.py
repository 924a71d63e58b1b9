"""Gemma feature extractors, V1 and V2 (counterpart of
ltx2_tpu/models/text_encoder/feature_extractor.py).

V1: the 49 hidden states of Gemma are normalised per batch row and per
layer over the row's valid tokens (masked range normalisation), concatenated
in (B, T, D, L) order to (B, T, D * L) with padding zeroed, and projected by
one bias-free linear to D. V2 (LTX-2.3): each token's state in each layer is
RMS-normalised over D, concatenated the same way with padding zeroed, and
two heads project it straight to the video and the audio widths (4096 and
2048), their inputs scaled by sqrt(width / D); fp32 throughout.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.ops.common import Linear, linear


class FeatureExtractorV1(nn.Module):
    """`aggregate_embed`: (hidden_dim * num_layers) -> hidden_dim, no bias, fp32."""

    def __init__(self, hidden_dim: int = 3840, num_layers: int = 49, *, device=None):
        super().__init__()
        self.aggregate_embed = Linear(hidden_dim * num_layers, hidden_dim, bias=False, device=device)


def norm_and_concat_padded_batch(encoded_text: torch.Tensor, sequence_lengths: torch.Tensor,
                                 padding_side: str = "right") -> torch.Tensor:
    """(B, T, D, L) states -> (B, T, D * L): each row and layer shifted by
    its mean and scaled by 8 / its range over the row's valid tokens, in
    fp32; padding zeroed; encoded_text's dtype out."""
    b, t, d, num_layers = encoded_text.shape
    eps = 1e-6
    lengths = sequence_lengths.to(encoded_text.device)
    token = torch.arange(t, device=encoded_text.device)[None, :]
    if padding_side == "right":
        mask = token < lengths[:, None]
    elif padding_side == "left":
        mask = token >= (t - lengths[:, None])
    else:
        raise ValueError(f"padding_side must be 'left' or 'right', got {padding_side}")
    mask4 = mask[:, :, None, None]
    x = encoded_text.float()
    denom = (lengths * d).view(b, 1, 1, 1).float()
    mean = torch.where(mask4, x, 0.0).sum(dim=(1, 2), keepdim=True) / (denom + eps)
    x_min = torch.where(mask4, x, 1e9).amin(dim=(1, 2), keepdim=True)
    x_max = torch.where(mask4, x, -1e9).amax(dim=(1, 2), keepdim=True)
    normed = (8.0 * (x - mean) / (x_max - x_min + eps)).reshape(b, t, d * num_layers)
    return torch.where(mask[:, :, None], normed, 0.0).to(encoded_text.dtype)


def extract_features_v1(fe: FeatureExtractorV1, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                        padding_side: str = "left") -> torch.Tensor:
    """Gemma's stacked states (L, B, T, D) and (B, T) mask -> (B, T, D)."""
    stacked = hidden_states.permute(1, 2, 3, 0)  # (B, T, D, L), a view: the concat's order
    lengths = attention_mask.sum(dim=-1).int()
    return linear(fe.aggregate_embed, norm_and_concat_padded_batch(stacked, lengths, padding_side))


class FeatureExtractorV2(nn.Module):
    """`video_aggregate_embed` and `audio_aggregate_embed`: (hidden_dim *
    num_layers) -> the video and the audio widths, with bias, fp32."""

    def __init__(self, hidden_dim: int = 3840, num_layers: int = 49, video_dim: int = 4096, audio_dim: int = 2048, *,
                 device=None):
        super().__init__()
        self.video_aggregate_embed = Linear(hidden_dim * num_layers, video_dim, device=device)
        self.audio_aggregate_embed = Linear(hidden_dim * num_layers, audio_dim, device=device)


def norm_and_concat_per_token_rms(encoded_text: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, D, L) states -> (B, T, D * L): each token's state in each
    layer times rsqrt(its mean square over D + 1e-6), in fp32; padding
    zeroed; encoded_text's dtype out."""
    b, t, d, num_layers = encoded_text.shape
    x = encoded_text.float()
    normed = x * torch.rsqrt((x * x).mean(dim=2, keepdim=True) + 1e-6)
    normed = normed.reshape(b, t, d * num_layers)
    mask = attention_mask.to(device=encoded_text.device, dtype=torch.bool)[:, :, None]
    return torch.where(mask, normed, 0.0).to(encoded_text.dtype)


def extract_features_v2(fe: FeatureExtractorV2, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                        hidden_dim: int = 3840) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gemma's stacked states (L, B, T, D) and (B, T) mask -> the (video,
    audio) features, each head's input scaled by sqrt(its width /
    hidden_dim)."""
    normed = norm_and_concat_per_token_rms(hidden_states.permute(1, 2, 3, 0), attention_mask)
    v_dim, a_dim = fe.video_aggregate_embed.weight.shape[0], fe.audio_aggregate_embed.weight.shape[0]
    video = linear(fe.video_aggregate_embed, normed * math.sqrt(v_dim / hidden_dim))
    audio = linear(fe.audio_aggregate_embed, normed * math.sqrt(a_dim / hidden_dim))
    return video, audio
