"""The video text encoder above Gemma (counterpart of
ltx2_tpu/models/text_encoder/encoder.py), V1: Gemma's 49 hidden states ->
feature extractor -> 1D connector -> the DiT's text context (B, S', 3840),
padding zeroed by the connector's output mask. Not ported yet: the V2 and
audio-video encoders and the checkpoint loader.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.models.text_encoder.connector import (
    Connector, ConnectorConfig, connector_apply, init_connector_,
)
from ltx2_tpu_torch.models.text_encoder.feature_extractor import FeatureExtractorV1, extract_features_v1
from ltx2_tpu_torch.ops.common import init_linear_


class VideoGemmaEncoderOutput(NamedTuple):
    video_encoding: torch.Tensor
    attention_mask: torch.Tensor


@dataclass(frozen=True)
class TextEncoderConfig:
    """The V1 projection stack above Gemma."""

    hidden_dim: int = 3840
    num_gemma_layers: int = 49
    connector: ConnectorConfig = field(default_factory=ConnectorConfig)


class VideoTextEncoder(nn.Module):
    """`feature_extractor` and `embeddings_connector`, fp32, named as in the
    JAX package's tree. Parameters start uninitialised: load them
    (loader/from_numpy.py) or draw them (`init_text_encoder_`)."""

    def __init__(self, cfg: TextEncoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractorV1(cfg.hidden_dim, cfg.num_gemma_layers, device=device)
        self.embeddings_connector = Connector(cfg.connector, device=device)


@torch.no_grad()
def init_text_encoder_(encoder: VideoTextEncoder, generator: torch.Generator) -> VideoTextEncoder:
    """init_text_encoder's distributions, in place on the device."""
    init_linear_(encoder.feature_extractor.aggregate_embed, generator)
    init_connector_(encoder.embeddings_connector, generator)
    return encoder


def default_text_encoder_config() -> TextEncoderConfig:
    """V1: the 2-block 30 x 128 connector with 128 registers."""
    return TextEncoderConfig()


def convert_to_additive_mask(attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Binary (B, S) -> additive (B, 1, 1, S): 0 or -finfo(dtype).max."""
    large = torch.finfo(dtype).max
    additive = (attention_mask.float() - 1.0) * large
    return additive.reshape(attention_mask.shape[0], 1, 1, attention_mask.shape[-1]).to(dtype)


def _binary_from_additive(output_mask: torch.Tensor) -> torch.Tensor:
    return (output_mask.squeeze(2).squeeze(1) >= -0.5).int()


@torch.no_grad()
def video_text_encoder_apply(encoder: VideoTextEncoder, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                             padding_side: str = "left") -> VideoGemmaEncoderOutput:
    """Gemma's states (L, B, S, D) and the (B, S) token mask -> the video
    encoding (B, S', D) and its binary mask (all ones once registers were
    appended)."""
    attention_mask = attention_mask.to(hidden_states.device)
    encoded = extract_features_v1(encoder.feature_extractor, hidden_states, attention_mask, padding_side)
    encoded, output_mask = connector_apply(encoder.embeddings_connector, encoded,
                                           convert_to_additive_mask(attention_mask, encoded.dtype))
    binary_mask = _binary_from_additive(output_mask)
    return VideoGemmaEncoderOutput(video_encoding=encoded * binary_mask[:, :, None], attention_mask=binary_mask)
