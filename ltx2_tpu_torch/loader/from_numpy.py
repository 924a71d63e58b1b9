"""Build the port's modules from parameter trees given as numpy arrays.

The JAX package keeps parameters as nested dicts (and lists) whose leaf
names follow the checkpoint; the port's modules use the same names, so a
tree flattens to a state dict with dotted keys. The DiT's
`transformer_blocks` and Gemma's `layers` leaves carry a leading layer axis
L (the JAX package stacks them to scan them), which is split into the L
entries of the port's `nn.ModuleList`; the connector's blocks are a list in
both. Loading is strict: a leaf the module has no place for, or a parameter
the tree does not give, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ltx2_tpu_torch.models.audio_vae.decoder import AudioDecoder, AudioDecoderConfig
from ltx2_tpu_torch.models.audio_vae.vocoder import Vocoder, VocoderConfig, VocoderWithBWE, VocoderWithBWEConfig
from ltx2_tpu_torch.models.text_encoder.encoder import TextEncoderConfig, VideoTextEncoder
from ltx2_tpu_torch.models.text_encoder.gemma3 import Gemma3, Gemma3Config
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder, VideoEncoderConfig
from ltx2_tpu_torch.training.lora import attach_lora_


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a.b.0.c": array}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for key, sub in items:
        flat.update(flatten_tree(sub, f"{prefix}{key}."))
    return flat


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes' bfloat16 has no numpy <-> torch bridge
    return torch.tensor(arr)  # a copy: the tree's arrays may be read-only views


def _load(module: torch.nn.Module, flat: Dict[str, np.ndarray]) -> None:
    module.load_state_dict({k: _to_tensor(v) for k, v in flat.items()}, strict=True)


def _unstack(tree: Mapping, stacked: str, layers: int) -> Dict[str, np.ndarray]:
    """flatten_tree, with each leaf under `stacked` split along its leading
    layer axis into `stacked.{i}.<rest>`."""
    flat: Dict[str, np.ndarray] = {}
    for key, arr in flatten_tree(tree).items():
        head, _, rest = key.partition(".")
        if head != stacked:
            flat[key] = arr
            continue
        if arr.shape[0] != layers:
            raise ValueError(f"{key}: leading axis {arr.shape[0]} != num_layers {layers}")
        for i in range(layers):
            flat[f"{stacked}.{i}.{rest}"] = arr[i]
    return flat


def dit_from_numpy(tree: Mapping, cfg: LTXModelConfig, device=None) -> LTXModel:
    """A DiT parameter tree (stacked blocks; the audio stream's and the
    cross-modal leaves with an AudioVideo `cfg`) -> LTXModel on `device`; a
    `caption_projection` in the tree needs `cfg.caption_channels`.

    LoRA leaves of the tree (training/lora.py's stacked (L, r, in) `lora_A`,
    (L, out, r) `lora_B` and (L,) `lora_scale`) become each block's adapters."""
    flat = _unstack(tree, "transformer_blocks", cfg.num_layers)
    model = LTXModel(cfg, device=device)
    for key, arr in flat.items():
        if key.endswith(".lora_A"):
            attach_lora_(model.get_submodule(key[: -len(".lora_A")]), rank=arr.shape[0])
    _load(model, flat)
    return model


def gemma3_from_numpy(tree: Mapping, cfg: Gemma3Config, device=None) -> Gemma3:
    """A Gemma-3 parameter tree (`embed_tokens`, stacked `layers`, `norm`)
    -> Gemma3 on `device`."""
    model = Gemma3(cfg, device=device)
    _load(model, _unstack(tree, "layers", cfg.num_hidden_layers))
    return model


def text_encoder_from_numpy(tree: Mapping, cfg: TextEncoderConfig, device=None) -> VideoTextEncoder:
    """A V1 text-encoder tree (`feature_extractor.aggregate_embed`,
    `embeddings_connector` with its block list and registers) ->
    VideoTextEncoder on `device`."""
    encoder = VideoTextEncoder(cfg, device=device)
    _load(encoder, flatten_tree(tree))
    return encoder


def trainable_to_numpy(model: LTXModel) -> Dict[str, np.ndarray]:
    """The reverse direction for the trainable parameters (`requires_grad`):
    {dotted key: fp32 array} in the JAX tree's layout, the blocks' leaves
    stacked on a leading layer axis ("transformer_blocks.attn1.to_q.lora_A"
    -> (L, r, in)), so they compare with `flatten_tree` of a JAX tree."""
    stacked: Dict[str, list] = {}
    flat: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        arr = p.detach().float().cpu().numpy()
        head, _, rest = name.partition(".")
        if head == "transformer_blocks":
            index, _, leaf = rest.partition(".")
            stacked.setdefault(f"transformer_blocks.{leaf}", []).append((int(index), arr))
        else:
            flat[name] = arr
    for key, items in stacked.items():
        flat[key] = np.stack([arr for _, arr in sorted(items, key=lambda item: item[0])])
    return flat


def video_decoder_from_numpy(tree: Mapping, cfg: VideoDecoderConfig, device=None) -> VideoDecoder:
    """A video-decoder parameter tree -> VideoDecoder on `device`."""
    decoder = VideoDecoder(cfg, device=device)
    _load(decoder, flatten_tree(tree))
    return decoder


def video_encoder_from_numpy(tree: Mapping, cfg: VideoEncoderConfig, device=None) -> VideoEncoder:
    """A video-encoder parameter tree (`conv_in`, `down_blocks.{i}` with
    `res_blocks.{j}.conv1/conv2` or `conv`, `conv_out`,
    `per_channel_statistics`) -> VideoEncoder on `device`."""
    encoder = VideoEncoder(cfg, device=device)
    _load(encoder, flatten_tree(tree))
    return encoder


def spatial_upscaler_from_numpy(tree: Mapping, cfg: SpatialUpscalerConfig, device=None) -> SpatialUpscaler:
    """A spatial-upscaler parameter tree (`initial_conv`, `initial_norm`,
    `res_blocks.{i}`, `upsampler.conv` with its per-frame 4D weight,
    `post_upsample_res_blocks.{i}`, `final_conv`) -> fp32 SpatialUpscaler."""
    upscaler = SpatialUpscaler(cfg, device=device)
    _load(upscaler, flatten_tree(tree))
    return upscaler


def audio_decoder_from_numpy(tree: Mapping, cfg: AudioDecoderConfig, device=None) -> AudioDecoder:
    """An audio-decoder parameter tree (`conv_in`, `mid_block_{1,2}`,
    `up_blocks.{i}.res_blocks.{j}` / `.upsample.conv`, `conv_out`,
    `per_channel_statistics`) -> fp32 AudioDecoder."""
    decoder = AudioDecoder(cfg, device=device)
    _load(decoder, flatten_tree(tree))
    return decoder


def vocoder_from_numpy(tree: Mapping, cfg, device=None):
    """A vocoder tree (`conv_pre`, `ups.{i}`, `resblocks.{j}` with
    `convs1/2` and, for AMP1, `acts1/2` with their filters, `act_post`,
    `conv_post`) -> Vocoder for a VocoderConfig; the BWE chain's
    (`vocoder`, `bwe_generator`, `mel_stft`) -> VocoderWithBWE for a
    VocoderWithBWEConfig."""
    module = (VocoderWithBWE if isinstance(cfg, VocoderWithBWEConfig) else Vocoder)(cfg, device=device)
    _load(module, flatten_tree(tree))
    return module
