from ltx2_tpu_torch.models.upscaler.spatial import (
    SpatialUpscaler,
    SpatialUpscalerConfig,
    group_norm_video,
    init_spatial_upscaler_,
    spatial_upscaler_apply,
)
from ltx2_tpu_torch.models.upscaler.temporal import (
    TemporalUpscaler,
    TemporalUpscalerConfig,
    group_norm_per_frame,
    init_temporal_upscaler_,
    temporal_upscaler_apply,
)

__all__ = [
    "SpatialUpscaler",
    "SpatialUpscalerConfig",
    "group_norm_video",
    "init_spatial_upscaler_",
    "spatial_upscaler_apply",
    "TemporalUpscaler",
    "TemporalUpscalerConfig",
    "group_norm_per_frame",
    "init_temporal_upscaler_",
    "temporal_upscaler_apply",
]
