"""The basic text-to-video pipeline (counterpart of
ltx2_tpu/pipelines/text_to_video.py): plain CFG at 5.0 with cond and uncond
in one forward, as a thin specialization of the one-stage pipeline."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig
from ltx2_tpu_torch.pipelines.common import ImageCondition
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline


@dataclass
class TextToVideoConfig:
    height: int = 480
    width: int = 704
    num_frames: int = 97
    seed: int = 42
    fps: float = 24.0
    num_inference_steps: int = 30
    cfg_scale: float = 5.0
    dtype: str = "float32"
    latent_channels: int = 128
    tiling_config: Optional[TilingConfig] = None

    def to_one_stage(self) -> OneStageCFGConfig:
        """The one-stage config: plain CFG, no CFG* rescale."""
        return OneStageCFGConfig(
            height=self.height, width=self.width, num_frames=self.num_frames, seed=self.seed, fps=self.fps,
            num_inference_steps=self.num_inference_steps, cfg_scale=self.cfg_scale, rescale_scale=0.0,
            dtype=self.dtype, latent_channels=self.latent_channels, tiling_config=self.tiling_config,
        )


class TextToVideoPipeline(OneStagePipeline):
    """Plain CFG text-to-video; takes a TextToVideoConfig or a one-stage config."""

    def __call__(self, positive_encoding, negative_encoding, config, images: Optional[List[ImageCondition]] = None,
                 callback: Optional[Callable] = None, **kwargs):
        one_stage_cfg = config.to_one_stage() if isinstance(config, TextToVideoConfig) else config
        return super().__call__(positive_encoding, negative_encoding, one_stage_cfg, images=images,
                                callback=callback, **kwargs)


def create_text_to_video_pipeline(**kwargs) -> TextToVideoPipeline:
    return TextToVideoPipeline(**kwargs)
