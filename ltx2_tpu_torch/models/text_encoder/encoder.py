"""The video text encoder above Gemma (counterpart of
ltx2_tpu/models/text_encoder/encoder.py), V1: Gemma's 49 hidden states ->
feature extractor -> 1D connector -> the DiT's text context (B, S', 3840),
padding zeroed by the connector's output mask. `load_text_encoder_params`
reads it from the unified checkpoint (`text_embedding_projection.*` and the
video connector). Not ported yet: the V2 and audio-video encoders.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.export import inverse_rewrite
from ltx2_tpu_torch.loader.modules import assign_, require_loaded
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.loader.weight_loader import AUDIO_NOT_PORTED, V2_NOT_PORTED, read_checkpoint_config
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


VIDEO_CONNECTOR_PREFIX = "model.diffusion_model.video_embeddings_connector."
GENERIC_CONNECTOR_PREFIX = "model.diffusion_model.embeddings_connector."
AUDIO_CONNECTOR_PREFIX = "model.diffusion_model.audio_embeddings_connector."
PROJECTION_KEY = "text_embedding_projection.aggregate_embed.weight"


def _connector_prefix(f: SafetensorsFile) -> str:
    video = any(k.startswith(VIDEO_CONNECTOR_PREFIX) for k in f.keys())
    return VIDEO_CONNECTOR_PREFIX if video else GENERIC_CONNECTOR_PREFIX


def text_encoder_checkpoint_keys(encoder: VideoTextEncoder, connector_prefix: str = VIDEO_CONNECTOR_PREFIX
                                 ) -> Dict[str, str]:
    """{module tensor name: checkpoint key}: the extractor's projection
    under `text_embedding_projection.`, the connector's tensors under
    `connector_prefix` with the reference's names (`to_out.0`, `ff.net.*`)."""
    keys = {}
    for name, _t in encoder.named_parameters():
        head, _, rest = name.partition(".")
        connector_key = connector_prefix + inverse_rewrite("." + rest)[1:]
        keys[name] = PROJECTION_KEY if head == "feature_extractor" else connector_key
    return keys


def text_encoder_config_from_checkpoint(path: str) -> TextEncoderConfig:
    """The V1 encoder's architecture read off the file: the extractor's
    widths and Gemma state count from the projection's shape, the
    connector's blocks, registers and width from its tensors, its head
    width from the metadata's `connector_attention_head_dim` (128 when
    absent). Raises for a V2 file (ROADMAP.md §1 item 4)."""
    f = SafetensorsFile(path)
    if PROJECTION_KEY not in f:
        if any(k.startswith("text_embedding_projection.") for k in f.keys()):
            raise NotImplementedError(V2_NOT_PORTED)
        raise ValueError(f"{path} holds no text_embedding_projection: no V1 text encoder in this file")
    hidden, stacked = f.info(PROJECTION_KEY)[1]
    prefix = _connector_prefix(f)
    blocks = 0
    while f"{prefix}transformer_1d_blocks.{blocks}.attn1.to_q.weight" in f:
        blocks += 1
    inner = f.info(f"{prefix}transformer_1d_blocks.0.attn1.to_q.weight")[1][0]
    meta = read_checkpoint_config(path)
    head_dim = int((meta.get("transformer", {}) or meta).get("connector_attention_head_dim", 128))
    registers = f.info(f"{prefix}learnable_registers")[1][0] if f"{prefix}learnable_registers" in f else None
    connector = ConnectorConfig(attention_head_dim=head_dim, num_attention_heads=inner // head_dim,
                                num_layers=blocks, num_learnable_registers=registers)
    return TextEncoderConfig(hidden_dim=hidden, num_gemma_layers=stacked // hidden, connector=connector)


@torch.no_grad()
def load_text_encoder_params(path: str, cfg: Optional[TextEncoderConfig] = None, device=None,
                             include_audio: bool = False) -> VideoTextEncoder:
    """The V1 video text encoder of the unified checkpoint at `path` on
    `device` (default cuda), fp32: `text_embedding_projection.aggregate_embed`
    and the connector under `video_embeddings_connector.` (or
    `embeddings_connector.`). The V2 extractor and gated connector raise
    (ROADMAP.md §1 item 4), as does the audio connector (item 5)."""
    if include_audio:
        raise NotImplementedError(AUDIO_NOT_PORTED)
    device = resolve_device(device)
    if cfg is None:
        cfg = text_encoder_config_from_checkpoint(path)
    f = SafetensorsFile(path)
    try:
        prefix = _connector_prefix(f)
        if any(k.startswith(prefix) and "to_gate_logits" in k for k in f.keys()):
            raise NotImplementedError(V2_NOT_PORTED)
        encoder = VideoTextEncoder(cfg, device="meta")
        for name, key in text_encoder_checkpoint_keys(encoder, prefix).items():
            if key in f:
                assign_(encoder, name, f.get(key).to(device, torch.float32, copy=True))
    finally:
        f.close()
    require_loaded(encoder, path, "text encoder")
    return encoder


def text_encoder_to_checkpoint(encoder: VideoTextEncoder) -> Dict[str, torch.Tensor]:
    """The encoder's tensors on the CPU under their checkpoint keys (the
    video connector's prefix)."""
    params = dict(encoder.named_parameters())
    return {key: params[name].detach().cpu() for name, key in text_encoder_checkpoint_keys(encoder).items()}
