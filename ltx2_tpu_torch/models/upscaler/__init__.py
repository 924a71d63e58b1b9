from ltx2_tpu_torch.models.upscaler.spatial import (
    SpatialUpscaler,
    SpatialUpscalerConfig,
    group_norm_video,
    init_spatial_upscaler_,
    spatial_upscaler_apply,
)

__all__ = [
    "SpatialUpscaler",
    "SpatialUpscalerConfig",
    "group_norm_video",
    "init_spatial_upscaler_",
    "spatial_upscaler_apply",
]
