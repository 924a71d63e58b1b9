"""Text encoding, V1 video only: Gemma-3 -> feature extractor -> 1D connector."""

from ltx2_tpu_torch.models.text_encoder.connector import (
    Connector, ConnectorConfig, append_learnable_registers, connector_apply, init_connector_,
)
from ltx2_tpu_torch.models.text_encoder.encoder import (
    TextEncoderConfig, VideoGemmaEncoderOutput, VideoTextEncoder, convert_to_additive_mask,
    default_text_encoder_config, init_text_encoder_, video_text_encoder_apply,
)
from ltx2_tpu_torch.models.text_encoder.feature_extractor import (
    FeatureExtractorV1, extract_features_v1, norm_and_concat_padded_batch,
)
from ltx2_tpu_torch.models.text_encoder.gemma3 import (
    GEMMA3_LAYER_TYPES, Gemma3, Gemma3Config, gemma3_apply, init_gemma3_,
)

__all__ = [
    "Connector", "ConnectorConfig", "append_learnable_registers", "connector_apply", "init_connector_",
    "TextEncoderConfig", "VideoGemmaEncoderOutput", "VideoTextEncoder", "convert_to_additive_mask",
    "default_text_encoder_config", "init_text_encoder_", "video_text_encoder_apply",
    "FeatureExtractorV1", "extract_features_v1", "norm_and_concat_padded_batch",
    "GEMMA3_LAYER_TYPES", "Gemma3", "Gemma3Config", "gemma3_apply", "init_gemma3_",
]
