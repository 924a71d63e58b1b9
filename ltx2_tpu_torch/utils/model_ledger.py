"""Lazy loading of every component from one checkpoint (counterpart of
ltx2_tpu/utils/model_ledger.py).

One object loads and caches the transformer, the video encoder and
decoder, the audio encoder and decoder and the vocoder, the text encoder,
Gemma and the spatial and temporal upscalers from a unified checkpoint (and
the Gemma shards and upscaler files beside it), with LoRAs fused into the
transformer at load, per-component release and a `with_loras` view. Each
component is the port's module, on `device`, with its config on it. The
architectures are read off the files (their shapes and metadata), where the
JAX package assumes the published widths. A V2 (LTX-2.3) checkpoint gives
the V2 DiT (cross-attention AdaLN, gated attention, no caption projection)
and the V2 text encoder; `include_audio` gives the audio-video DiT, and the
vocoder is LTX-2.3's BWE chain when the metadata's `vocoder` config has a
`bwe` entry, as the JAX ledger chooses. With `int8` the DiT's matmul
weights are int8 W8A8 (loader/int8.py): quantized on the host at load, or,
with LoRAs, loaded in full precision, fused, then quantized on the card.
With `tp_axis` (a parallel/mesh.py model axis) the DiT loads as this rank's
tensor-parallel shard: each tensor the rules split is sliced as it is read
(the JAX ledger's `transformer_device_put`, utils/model_ledger.py:41-43), a
LoRA fused into the whole tensor's slice; int8 codes split with their
column-parallel scales, fp8 codes keep their per-tensor scale. With
`pipe_axis` (a mesh's pipe axis) only this rank's pipeline stage's L/P
blocks are read from the file (the JAX ledger's `pipeline_device_put`), a
LoRA fused into them; it composes with `tp_axis`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.int8 import quantize_params_int8
from ltx2_tpu_torch.loader.lora import LoRAConfig, fuse_lora_into_params
from ltx2_tpu_torch.loader.weight_loader import is_v2_model, load_transformer_params, read_checkpoint_config


@dataclass
class ModelLedger:
    """Factory and cache of the LTX-2 components of one checkpoint."""

    checkpoint_path: str
    gemma_path: Optional[str] = None
    spatial_upscaler_path: Optional[str] = None
    temporal_upscaler_path: Optional[str] = None
    loras: List[LoRAConfig] = field(default_factory=list)
    target_dtype: str = "bfloat16"
    include_audio: bool = False
    keep_fp8: bool = False  # serving: the file's fp8 weights stay E4M3 on the card
    int8: bool = False  # the DiT's matmul weights int8 W8A8
    gemma_fp8: bool = False  # Gemma's matmul weights quantized to fp8 at load
    decoder_dtype: str = "float32"  # the video decoder's compute dtype (the JAX package's is fp32)
    device: object = None  # default cuda
    tp_axis: object = None  # the DiT loads as this rank's TP shard over it
    pipe_axis: object = None  # the DiT loads as this rank's pipeline stage over it
    _cache: Dict[str, object] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _get(self, name: str, loader, force_reload: bool = False):
        if force_reload or name not in self._cache:
            self._cache[name] = loader()
        return self._cache[name]

    @property
    def is_v2(self) -> bool:
        return is_v2_model(self.checkpoint_path)

    @property
    def checkpoint_config(self) -> dict:
        return read_checkpoint_config(self.checkpoint_path)

    def transformer(self, force_reload: bool = False):
        """The DiT, audio-video with `include_audio` (V1: caption
        projections; V2: cross-attention AdaLN and gated attention, no
        caption projection; SPLIT RoPE on the f32 grid, no remat) in
        `target_dtype`, LoRAs fused at load. LoRAs need dequantized weights,
        so with LoRAs the fp8 weights are dequantized even under `keep_fp8`;
        `int8` quantizes at load without LoRAs, else after the fuse."""

        def load():
            tp = None if self.loras else self.tp_axis  # LoRAs fuse into whole tensors, sliced after
            model = load_transformer_params(self.checkpoint_path, target_dtype=self.target_dtype,
                                            device=self.device, keep_fp8=self.keep_fp8 and not self.loras,
                                            quantize_int8=self.int8 and not self.loras,
                                            include_audio=self.include_audio, tp_axis=tp,
                                            pipe_axis=self.pipe_axis)
            if self.loras:
                fuse_lora_into_params(model, self.loras)
                if self.int8:
                    quantize_params_int8(model)
                if self.tp_axis is not None:
                    from ltx2_tpu_torch.parallel.sharding import shard_model_

                    shard_model_(model, self.tp_axis)
            return model

        return self._get("transformer", load, force_reload)

    def video_decoder(self, force_reload: bool = False):
        def load():
            from ltx2_tpu_torch.models.video_vae.weights import (
                decoder_config_from_checkpoint, load_video_decoder_params,
            )

            cfg = decoder_config_from_checkpoint(self.checkpoint_path, self.decoder_dtype)
            return load_video_decoder_params(self.checkpoint_path, cfg, device=self.device)

        return self._get("video_decoder", load, force_reload)

    def text_encoder(self, force_reload: bool = False):
        def load():
            from ltx2_tpu_torch.models.text_encoder.encoder import (
                load_text_encoder_params, text_encoder_config_from_checkpoint,
            )
            from ltx2_tpu_torch.models.text_encoder.gemma3 import gemma_config_from_checkpoint

            # V2's extractor does not give Gemma's width: Gemma's shards do (3840 without them).
            hidden = gemma_config_from_checkpoint(self.gemma_path).hidden_size if self.gemma_path else 3840
            cfg = text_encoder_config_from_checkpoint(self.checkpoint_path, hidden)
            return load_text_encoder_params(self.checkpoint_path, cfg, device=self.device)

        return self._get("text_encoder", load, force_reload)

    def gemma(self, force_reload: bool = False):
        def load():
            from ltx2_tpu_torch.models.text_encoder.gemma3 import load_gemma3_params

            if self.gemma_path is None:
                raise ValueError("gemma_path required for the Gemma text encoder")
            return load_gemma3_params(self.gemma_path, quantize_fp8=self.gemma_fp8, device=self.device)

        return self._get("gemma", load, force_reload)

    def spatial_upscaler(self, force_reload: bool = False):
        """The spatial upscaler, or None without `spatial_upscaler_path`."""

        def load():
            from ltx2_tpu_torch.models.upscaler.spatial import load_spatial_upscaler_params

            if self.spatial_upscaler_path is None:
                return None
            return load_spatial_upscaler_params(self.spatial_upscaler_path, device=self.device)

        return self._get("spatial_upscaler", load, force_reload)

    def video_encoder(self, force_reload: bool = False):
        """The video VAE encoder, fp32 as the JAX package keeps it."""

        def load():
            from ltx2_tpu_torch.models.video_vae.weights import (
                encoder_config_from_checkpoint, load_video_encoder_params,
            )

            cfg = encoder_config_from_checkpoint(self.checkpoint_path)
            return load_video_encoder_params(self.checkpoint_path, cfg, device=self.device)

        return self._get("video_encoder", load, force_reload)

    def audio_encoder(self, force_reload: bool = False):
        """The audio VAE encoder (a2vid), fp32, or None when the file has none."""

        def load():
            from ltx2_tpu_torch.models.audio_vae.weights import load_audio_encoder_params

            return load_audio_encoder_params(self.checkpoint_path, device=self.device)

        return self._get("audio_encoder", load, force_reload)

    def audio_decoder(self, force_reload: bool = False):
        """The audio VAE decoder, fp32, or None when the file has none."""

        def load():
            from ltx2_tpu_torch.models.audio_vae.weights import load_audio_decoder_params

            return load_audio_decoder_params(self.checkpoint_path, device=self.device)

        return self._get("audio_decoder", load, force_reload)

    def vocoder(self, force_reload: bool = False):
        """The vocoder, fp32 (LTX-2.3's BWE chain when the metadata declares
        one; its `cfg.output_sample_rate` is the waveform's rate), or None
        when the file has none."""

        def load():
            from ltx2_tpu_torch.models.audio_vae.weights import load_vocoder_params

            return load_vocoder_params(self.checkpoint_path, device=self.device)

        return self._get("vocoder", load, force_reload)

    def temporal_upscaler(self, force_reload: bool = False):
        """The temporal upscaler, fp32, or None without `temporal_upscaler_path`."""

        def load():
            from ltx2_tpu_torch.models.upscaler.temporal import load_temporal_upscaler_params

            if self.temporal_upscaler_path is None:
                return None
            return load_temporal_upscaler_params(self.temporal_upscaler_path, device=self.device)

        return self._get("temporal_upscaler", load, force_reload)

    def clear_model(self, model_name: str) -> None:
        self._cache.pop(model_name, None)

    def clear_all_models(self) -> None:
        self._cache.clear()

    def with_loras(self, loras: List[LoRAConfig]) -> "ModelLedger":
        """A view with another LoRA set: a fresh transformer, every other
        setting carried over, the LoRA-independent components shared."""
        return ModelLedger(
            checkpoint_path=self.checkpoint_path, gemma_path=self.gemma_path,
            spatial_upscaler_path=self.spatial_upscaler_path, temporal_upscaler_path=self.temporal_upscaler_path,
            loras=list(loras), target_dtype=self.target_dtype,
            include_audio=self.include_audio, keep_fp8=self.keep_fp8, int8=self.int8, gemma_fp8=self.gemma_fp8,
            decoder_dtype=self.decoder_dtype,
            device=self.device, _cache={k: v for k, v in self._cache.items() if k != "transformer"},
        )
