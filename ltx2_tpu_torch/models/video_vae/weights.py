"""Video VAE decoder checkpoint loading (counterpart of the decoder half of
ltx2_tpu/models/video_vae/weights.py).

The decoder's tensors are `vae.decoder.*` in the unified checkpoint: a conv's
weight and bias under `<name>.conv.`, a timestep embedder's linears under
`<name>.timestep_embedder.`; the per-channel statistics are
`vae.per_channel_statistics.*` with hyphenated names. Absent statistics
default to mean 0 and std 1, an absent timestep multiplier to 1000; every
other tensor of the decoder is required. Not ported yet: the encoder half
(`load_video_encoder_params`, ROADMAP.md §1 item 3).
"""

from __future__ import annotations

from typing import Dict

import torch

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.convert import to_dtype
from ltx2_tpu_torch.loader.modules import assign_
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.loader.weight_loader import read_checkpoint_config
from ltx2_tpu_torch.models.video_vae.conv import Conv3d
from ltx2_tpu_torch.models.video_vae.decoder import (
    _STRIDE_MAP, PerChannelStatistics, VideoDecoder, VideoDecoderConfig,
)

# The two statistics the decoder reads (checkpoint names are hyphenated).
_STAT_KEYS = {"std_of_means": "vae.per_channel_statistics.std-of-means",
              "mean_of_means": "vae.per_channel_statistics.mean-of-means"}
_DEFAULTS = {"per_channel_statistics.mean_of_means": 0.0, "per_channel_statistics.std_of_means": 1.0,
             "timestep_scale_multiplier": 1000.0}


def normalize_decoder_blocks(blocks) -> tuple:
    """Checkpoint-config JSON blocks -> the config's tuples. Takes
    ["res_x", {"num_layers": 5}], ["compress_all", {"multiplier": 2,
    "residual": true}] and ["res_x", 5]."""
    out = []
    for name, params in blocks:
        if isinstance(params, int):
            params = {"num_layers": params}
        if name == "res_x":
            out.append(("res_x", int(params["num_layers"])))
        elif name in _STRIDE_MAP:
            out.append((name, int(params.get("multiplier", 1)), bool(params.get("residual", False))))
        else:
            raise ValueError(f"Unknown decoder block: {name}")
    return tuple(out)


def decoder_checkpoint_keys(decoder: VideoDecoder) -> Dict[str, str]:
    """{module tensor name: checkpoint key} of every tensor of `decoder`."""
    keys = {}
    for name, _t in (*decoder.named_parameters(), *decoder.named_buffers()):
        owner_name, _, leaf = name.rpartition(".")
        if owner_name == "per_channel_statistics":
            keys[name] = _STAT_KEYS[leaf]
            continue
        key = f"{owner_name}.conv.{leaf}" if isinstance(decoder.get_submodule(owner_name), Conv3d) else name
        keys[name] = "vae.decoder." + key.replace("time_embedder.", "time_embedder.timestep_embedder.")
    return keys


def decoder_config_from_checkpoint(path: str, compute_dtype: str = "float32") -> VideoDecoderConfig:
    """The decoder's architecture: blocks from the metadata's
    `config.vae.decoder_blocks` (the V2.0 default when absent), channels and
    timestep conditioning from the file's tensors."""
    f = SafetensorsFile(path)
    blocks = read_checkpoint_config(path).get("vae", {}).get("decoder_blocks")
    kw = {"decoder_blocks": normalize_decoder_blocks(blocks)} if blocks else {}
    if "vae.decoder.conv_in.conv.weight" in f:
        features, latent = f.info("vae.decoder.conv_in.conv.weight")[1][:2]
        kw.update(base_channels=features // 8, latent_channels=latent)
    kw["timestep_conditioning"] = "vae.decoder.last_time_embedder.timestep_embedder.linear_1.weight" in f
    return VideoDecoderConfig(compute_dtype=compute_dtype, **kw)


@torch.no_grad()
def load_video_decoder_params(path: str, cfg: VideoDecoderConfig, device=None) -> VideoDecoder:
    """The decoder of the checkpoint at `path` on `device` (default cuda):
    convs and linears in cfg.dtype, statistics and tables fp32, read one
    tensor at a time through fp32, as the JAX package reads them. Raises
    with the missing checkpoint keys when the file lacks a required one
    (e.g. metadata blocks that disagree with the stored up_blocks)."""
    device = resolve_device(device)
    decoder = VideoDecoder(cfg, device="meta")
    f = SafetensorsFile(path)
    placeholders = dict((*decoder.named_parameters(), *decoder.named_buffers()))
    missing = []
    try:
        for name, key in decoder_checkpoint_keys(decoder).items():
            if key in f:
                assign_(decoder, name, to_dtype(f.get(key).to(device, torch.float32, copy=True),
                                                placeholders[name].dtype))
            elif name in _DEFAULTS:
                assign_(decoder, name, torch.full(placeholders[name].shape, _DEFAULTS[name], device=device))
            else:
                missing.append(key)
    finally:
        f.close()
    if missing:
        shown = ", ".join(missing[:8]) + (" ..." if len(missing) > 8 else "")
        raise ValueError(f"checkpoint {path} is missing {len(missing)} required video decoder key(s) — stored "
                         f"weights disagree with the derived architecture config: {shown}")
    return decoder


@torch.no_grad()
def load_per_channel_statistics(path: str, channels: int = 128, device=None) -> PerChannelStatistics:
    """The latent's per-channel statistics alone (the two-stage recipe's
    upscale bracket needs them before the decoder is loaded)."""
    stats = PerChannelStatistics(channels, device=resolve_device(device))
    f = SafetensorsFile(path)
    try:
        for attr in ("mean_of_means", "std_of_means"):
            if _STAT_KEYS[attr] in f:
                getattr(stats, attr).copy_(f.get(_STAT_KEYS[attr]).to(torch.float32))
    finally:
        f.close()
    return stats


def decoder_to_checkpoint(decoder: VideoDecoder) -> Dict[str, torch.Tensor]:
    """The decoder's tensors under their checkpoint keys, on the CPU in
    their dtypes (the writer's side of `load_video_decoder_params`)."""
    tensors = dict((*decoder.named_parameters(), *decoder.named_buffers()))
    return {key: tensors[name].detach().cpu() for name, key in decoder_checkpoint_keys(decoder).items()}
