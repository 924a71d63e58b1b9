"""The text encoder above Gemma (counterpart of
ltx2_tpu/models/text_encoder/encoder.py).

V1: Gemma's 49 hidden states -> feature extractor -> 1D connector -> the
DiT's text context (B, S', 3840), padding zeroed by the connector's output
mask; an audio-video V1 file adds an audio connector of the same shape fed
the same features. V2 (LTX-2.3): the V2 extractor's two heads -> the gated
video connector (32 x 128, the DiT's 4096-wide context) and the audio
connector (32 x 64). `av_text_encoder_apply` returns both encodings. `load_text_encoder_params`
reads either from the unified checkpoint (`text_embedding_projection.*` and
the connectors under `model.diffusion_model.`), the architecture read off
the file; `text_encoder_to_checkpoint` writes it back.
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
from ltx2_tpu_torch.loader.weight_loader import read_checkpoint_config
from ltx2_tpu_torch.models.text_encoder.connector import (
    Connector, ConnectorConfig, connector_apply, init_connector_,
)
from ltx2_tpu_torch.models.text_encoder.feature_extractor import (
    FeatureExtractorV1, FeatureExtractorV2, extract_features_v1, extract_features_v2,
)
from ltx2_tpu_torch.ops.common import init_linear_
from ltx2_tpu_torch.ops.rope import LTXRopeType


class VideoGemmaEncoderOutput(NamedTuple):
    video_encoding: torch.Tensor
    attention_mask: torch.Tensor


class AudioVideoGemmaEncoderOutput(NamedTuple):
    video_encoding: torch.Tensor
    audio_encoding: torch.Tensor
    attention_mask: torch.Tensor


@dataclass(frozen=True)
class TextEncoderConfig:
    """The projection stack above Gemma: V1, or V2 with `audio_connector`."""

    hidden_dim: int = 3840
    num_gemma_layers: int = 49
    connector: ConnectorConfig = field(default_factory=ConnectorConfig)
    v2: bool = False  # V2 = the dual direct-projection extractor (LTX-2.3)
    video_inner_dim: int = 4096  # V2's head widths
    audio_inner_dim: int = 2048
    audio_connector: Optional[ConnectorConfig] = None  # V2, or V1 audio-video


class VideoTextEncoder(nn.Module):
    """`feature_extractor` and `embeddings_connector` (V2, and V1 with an
    `audio_connector`: also `audio_embeddings_connector`), fp32, named as in
    the JAX package's tree.
    Parameters start uninitialised: load them (loader/from_numpy.py) or draw
    them (`init_text_encoder_`)."""

    def __init__(self, cfg: TextEncoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.v2:
            self.feature_extractor = FeatureExtractorV2(cfg.hidden_dim, cfg.num_gemma_layers, cfg.video_inner_dim,
                                                        cfg.audio_inner_dim, device=device)
        else:
            self.feature_extractor = FeatureExtractorV1(cfg.hidden_dim, cfg.num_gemma_layers, device=device)
        self.embeddings_connector = Connector(cfg.connector, device=device)
        if cfg.v2 or cfg.audio_connector is not None:
            self.audio_embeddings_connector = Connector(cfg.audio_connector or cfg.connector, device=device)


@torch.no_grad()
def init_text_encoder_(encoder: VideoTextEncoder, generator: torch.Generator) -> VideoTextEncoder:
    """init_text_encoder's distributions, in place on the device."""
    for m in encoder.feature_extractor.children():
        init_linear_(m, generator)
    init_connector_(encoder.embeddings_connector, generator)
    if hasattr(encoder, "audio_embeddings_connector"):
        init_connector_(encoder.audio_embeddings_connector, generator)
    return encoder


def default_text_encoder_config() -> TextEncoderConfig:
    """V1: the 2-block 30 x 128 connector with 128 registers."""
    return TextEncoderConfig()


def text_encoder_config_v2(hidden_dim: int = 3840, num_gemma_layers: int = 49, video_heads: int = 32,
                           video_head_dim: int = 128, audio_heads: int = 32, audio_head_dim: int = 64,
                           layers: int = 8, registers: Optional[int] = 128, **connector) -> TextEncoderConfig:
    """The V2 stack: the dual extractor and two gated connectors of `layers`
    blocks, video 32 x 128 and audio 32 x 64 by default (the JAX package's
    `av_text_encoder_config_v2_from_checkpoint` defaults); `connector`
    holds the fields both connectors share (RoPE type, max positions, f64
    grid, gating)."""
    connector.setdefault("apply_gated_attention", True)
    video = ConnectorConfig(attention_head_dim=video_head_dim, num_attention_heads=video_heads, num_layers=layers,
                            num_learnable_registers=registers, **connector)
    audio = ConnectorConfig(attention_head_dim=audio_head_dim, num_attention_heads=audio_heads, num_layers=layers,
                            num_learnable_registers=registers, **connector)
    return TextEncoderConfig(hidden_dim=hidden_dim, num_gemma_layers=num_gemma_layers, connector=video, v2=True,
                             video_inner_dim=video.inner_dim, audio_inner_dim=audio.inner_dim, audio_connector=audio)


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
    """V1: Gemma's states (L, B, S, D) and the (B, S) token mask -> the
    video encoding (B, S', D) and its binary mask (all ones once registers
    were appended). A V2 encoder goes through `av_text_encoder_apply`."""
    if encoder.cfg.v2:
        raise ValueError("a V2 text encoder makes a video and an audio encoding: use av_text_encoder_apply")
    attention_mask = attention_mask.to(hidden_states.device)
    encoded = extract_features_v1(encoder.feature_extractor, hidden_states, attention_mask, padding_side)
    encoded, output_mask = connector_apply(encoder.embeddings_connector, encoded,
                                           convert_to_additive_mask(attention_mask, encoded.dtype))
    binary_mask = _binary_from_additive(output_mask)
    return VideoGemmaEncoderOutput(video_encoding=encoded * binary_mask[:, :, None], attention_mask=binary_mask)


@torch.no_grad()
def av_text_encoder_apply(encoder: VideoTextEncoder, hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                          padding_side: str = "left") -> AudioVideoGemmaEncoderOutput:
    """Gemma's states (L, B, S, D) and the (B, S) token mask -> the video
    and the audio connectors' outputs: the video encoding (B, S', 4096 for
    V2, 3840 for V1) with padding zeroed by the connector's output mask, the
    audio encoding (B, S', 2048 for V2, 3840 for V1) as the audio connector
    gives it, and the binary mask. V2 feeds the connectors the extractor's
    two heads, V1 both the one extractor's features."""
    if not hasattr(encoder, "audio_embeddings_connector"):
        raise ValueError("this V1 text encoder has no audio connector: use video_text_encoder_apply")
    attention_mask = attention_mask.to(hidden_states.device)
    if encoder.cfg.v2:
        video_input, audio_input = extract_features_v2(encoder.feature_extractor, hidden_states, attention_mask,
                                                       encoder.cfg.hidden_dim)
    else:
        video_input = audio_input = extract_features_v1(encoder.feature_extractor, hidden_states, attention_mask,
                                                        padding_side)
    connector_mask = convert_to_additive_mask(attention_mask, video_input.dtype)
    video, output_mask = connector_apply(encoder.embeddings_connector, video_input, connector_mask)
    binary_mask = _binary_from_additive(output_mask)
    audio, _ = connector_apply(encoder.audio_embeddings_connector, audio_input, connector_mask)
    return AudioVideoGemmaEncoderOutput(video_encoding=video * binary_mask[:, :, None], audio_encoding=audio,
                                        attention_mask=binary_mask)


VIDEO_CONNECTOR_PREFIX = "model.diffusion_model.video_embeddings_connector."
GENERIC_CONNECTOR_PREFIX = "model.diffusion_model.embeddings_connector."
AUDIO_CONNECTOR_PREFIX = "model.diffusion_model.audio_embeddings_connector."
PROJECTION_KEY = "text_embedding_projection.aggregate_embed.weight"
V2_PROJECTION_PREFIX = "text_embedding_projection."
V2_VIDEO_KEY = V2_PROJECTION_PREFIX + "video_aggregate_embed.weight"
V2_AUDIO_KEY = V2_PROJECTION_PREFIX + "audio_aggregate_embed.weight"


def _connector_prefix(f: SafetensorsFile) -> str:
    video = any(k.startswith(VIDEO_CONNECTOR_PREFIX) for k in f.keys())
    return VIDEO_CONNECTOR_PREFIX if video else GENERIC_CONNECTOR_PREFIX


def text_encoder_checkpoint_keys(encoder: VideoTextEncoder, connector_prefix: str = VIDEO_CONNECTOR_PREFIX
                                 ) -> Dict[str, str]:
    """{module tensor name: checkpoint key}: the extractor's projection
    (V2: both heads, weight and bias) under `text_embedding_projection.`,
    the video connector's tensors under `connector_prefix` and V2's audio
    connector's under `audio_embeddings_connector.`, with the reference's
    names (`to_out.0`, `ff.net.*`)."""
    keys = {}
    for name, _t in encoder.named_parameters():
        head, _, rest = name.partition(".")
        if head == "feature_extractor":
            keys[name] = V2_PROJECTION_PREFIX + rest if encoder.cfg.v2 else PROJECTION_KEY
        else:
            prefix = AUDIO_CONNECTOR_PREFIX if head == "audio_embeddings_connector" else connector_prefix
            keys[name] = prefix + inverse_rewrite("." + rest)[1:]
    return keys


def _count_blocks(f: SafetensorsFile, prefix: str) -> int:
    blocks = 0
    while f"{prefix}transformer_1d_blocks.{blocks}.attn1.to_q.weight" in f:
        blocks += 1
    return blocks


def _registers(f: SafetensorsFile, prefix: str) -> Optional[int]:
    return f.info(f"{prefix}learnable_registers")[1][0] if f"{prefix}learnable_registers" in f else None


def av_text_encoder_config_v2_from_checkpoint(path: str, hidden_dim: int = 3840) -> TextEncoderConfig:
    """The V2 encoder's architecture above a Gemma of width `hidden_dim`
    (the file does not say it; Gemma-3-12B's 3840 by default): the
    extractor's widths, Gemma's state count and the connectors' blocks and
    registers from the file's shapes and names; the head counts and widths,
    RoPE type, max positions, f64 grid and gating from the metadata's
    config, with the JAX package's defaults (32 x 128 video, 32 x 64 audio,
    INTERLEAVED, gated); each connector's heads x width checked against its
    tensors."""
    f = SafetensorsFile(path)
    try:
        video_dim, stacked = f.info(V2_VIDEO_KEY)[1]
        audio_dim = f.info(V2_AUDIO_KEY)[1][0]
        prefix = _connector_prefix(f)
        tcfg = read_checkpoint_config(path)
        tcfg = tcfg.get("transformer", {}) or tcfg
        video_heads = int(tcfg.get("connector_num_attention_heads", 32))
        video_head_dim = int(tcfg.get("connector_attention_head_dim", 128))
        audio_heads = int(tcfg.get("audio_connector_num_attention_heads", video_heads))
        audio_head_dim = int(tcfg.get("audio_connector_attention_head_dim", 64))
        max_pos = tcfg.get("connector_positional_embedding_max_pos") or [1]
        if isinstance(max_pos, (int, float)):
            max_pos = [int(max_pos)]
        rope_raw = tcfg.get("rope_type", tcfg.get("split_rope"))
        rope = LTXRopeType.SPLIT if rope_raw in (True, "split", "SPLIT") else LTXRopeType.INTERLEAVED
        shared = dict(positional_embedding_max_pos=tuple(int(v) for v in max_pos), rope_type=rope,
                      apply_gated_attention=bool(tcfg.get("connector_apply_gated_attention", True)),
                      double_precision_rope=tcfg.get("frequencies_precision", "") == "float64")
        for name, heads, head_dim, width, pre in (("video", video_heads, video_head_dim, video_dim, prefix),
                                                  ("audio", audio_heads, audio_head_dim, audio_dim,
                                                   AUDIO_CONNECTOR_PREFIX)):
            inner = f.info(f"{pre}transformer_1d_blocks.0.attn1.to_q.weight")[1][0]
            if heads * head_dim != inner or inner != width:
                raise ValueError(f"{path}: the {name} connector's {heads} x {head_dim} heads, its width {inner} "
                                 f"and the extractor's {width} disagree")
        if stacked % hidden_dim:
            raise ValueError(f"{path}: the extractor's input width {stacked} is no multiple of Gemma's {hidden_dim}")
        layers, registers = _count_blocks(f, prefix), _registers(f, prefix)
        if (_count_blocks(f, AUDIO_CONNECTOR_PREFIX), _registers(f, AUDIO_CONNECTOR_PREFIX)) != (layers, registers):
            raise ValueError(f"{path}: the audio connector's blocks or registers differ from the video one's")
        return text_encoder_config_v2(
            hidden_dim=hidden_dim, num_gemma_layers=stacked // hidden_dim, video_heads=video_heads,
            video_head_dim=video_head_dim, audio_heads=audio_heads, audio_head_dim=audio_head_dim, layers=layers,
            registers=registers, **shared)
    finally:
        f.close()


def text_encoder_config_from_checkpoint(path: str, hidden_dim: int = 3840) -> TextEncoderConfig:
    """The encoder's architecture read off the file. V2 (the extractor's
    `video_aggregate_embed`): `av_text_encoder_config_v2_from_checkpoint`
    above a Gemma of width `hidden_dim`.
    V1: the extractor's widths and Gemma state count from the projection's
    shape, the connector's blocks, registers and width from its tensors, its
    head width from the metadata's `connector_attention_head_dim` (128 when
    absent); an audio connector when the file has one (the video one's
    shape, as the JAX package builds it)."""
    f = SafetensorsFile(path)
    if V2_VIDEO_KEY in f:
        f.close()
        return av_text_encoder_config_v2_from_checkpoint(path, hidden_dim)
    if PROJECTION_KEY not in f:
        raise ValueError(f"{path} holds no text_embedding_projection: no text encoder in this file")
    hidden, stacked = f.info(PROJECTION_KEY)[1]
    prefix = _connector_prefix(f)
    inner = f.info(f"{prefix}transformer_1d_blocks.0.attn1.to_q.weight")[1][0]
    meta = read_checkpoint_config(path)
    head_dim = int((meta.get("transformer", {}) or meta).get("connector_attention_head_dim", 128))
    connector = ConnectorConfig(attention_head_dim=head_dim, num_attention_heads=inner // head_dim,
                                num_layers=_count_blocks(f, prefix), num_learnable_registers=_registers(f, prefix))
    audio = any(k.startswith(AUDIO_CONNECTOR_PREFIX) for k in f.keys())
    return TextEncoderConfig(hidden_dim=hidden, num_gemma_layers=stacked // hidden, connector=connector,
                             audio_connector=connector if audio else None)


@torch.no_grad()
def load_text_encoder_params(path: str, cfg: Optional[TextEncoderConfig] = None, device=None) -> VideoTextEncoder:
    """The text encoder of the unified checkpoint at `path` on `device`
    (default cuda), fp32. V1: `text_embedding_projection.aggregate_embed`
    and the connector under `video_embeddings_connector.` (or
    `embeddings_connector.`), and the audio connector when `cfg` has one;
    V2: the extractor's two heads and both gated connectors."""
    device = resolve_device(device)
    if cfg is None:
        cfg = text_encoder_config_from_checkpoint(path)
    f = SafetensorsFile(path)
    try:
        encoder = VideoTextEncoder(cfg, device="meta")
        for name, key in text_encoder_checkpoint_keys(encoder, _connector_prefix(f)).items():
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
