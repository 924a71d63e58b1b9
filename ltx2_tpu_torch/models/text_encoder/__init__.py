"""Text encoding: Gemma-3 -> feature extractor (V1, or V2's two heads) -> 1D connector(s)."""

from ltx2_tpu_torch.models.text_encoder.connector import (
    Connector, ConnectorConfig, append_learnable_registers, connector_apply, init_connector_,
)
from ltx2_tpu_torch.models.text_encoder.encoder import (
    AudioVideoGemmaEncoderOutput, TextEncoderConfig, VideoGemmaEncoderOutput, VideoTextEncoder,
    av_text_encoder_apply, av_text_encoder_config_v2_from_checkpoint, convert_to_additive_mask,
    default_text_encoder_config, init_text_encoder_, text_encoder_config_v2, video_text_encoder_apply,
)
from ltx2_tpu_torch.models.text_encoder.feature_extractor import (
    FeatureExtractorV1, FeatureExtractorV2, extract_features_v1, extract_features_v2, norm_and_concat_padded_batch,
    norm_and_concat_per_token_rms,
)
from ltx2_tpu_torch.models.text_encoder.gemma3 import (
    GEMMA3_LAYER_TYPES, Gemma3, Gemma3Config, gemma3_apply, init_gemma3_,
)

__all__ = [
    "Connector", "ConnectorConfig", "append_learnable_registers", "connector_apply", "init_connector_",
    "AudioVideoGemmaEncoderOutput", "TextEncoderConfig", "VideoGemmaEncoderOutput", "VideoTextEncoder",
    "av_text_encoder_apply", "av_text_encoder_config_v2_from_checkpoint", "convert_to_additive_mask",
    "default_text_encoder_config", "init_text_encoder_", "text_encoder_config_v2", "video_text_encoder_apply",
    "FeatureExtractorV1", "FeatureExtractorV2", "extract_features_v1", "extract_features_v2",
    "norm_and_concat_padded_batch", "norm_and_concat_per_token_rms",
    "GEMMA3_LAYER_TYPES", "Gemma3", "Gemma3Config", "gemma3_apply", "init_gemma3_",
]
