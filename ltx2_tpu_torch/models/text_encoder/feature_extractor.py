"""Gemma feature extractor, V1 (counterpart of
ltx2_tpu/models/text_encoder/feature_extractor.py).

The 49 hidden states of Gemma are normalised per batch row and per layer
over the row's valid tokens (masked range normalisation), concatenated in
(B, T, D, L) order to (B, T, D * L) with padding zeroed, and projected by
one bias-free linear to D. Not ported yet: the V2 extractor (per-token RMS
norm, dual video/audio heads).
"""

from __future__ import annotations

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
