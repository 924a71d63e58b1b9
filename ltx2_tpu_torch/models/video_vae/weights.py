"""Video VAE checkpoint loading (counterpart of
ltx2_tpu/models/video_vae/weights.py).

The decoder's tensors are `vae.decoder.*` in the unified checkpoint, the
encoder's `vae.encoder.*`: a conv's weight and bias under `<name>.conv.`, a
timestep embedder's linears under `<name>.timestep_embedder.`; the
per-channel statistics, which both share, are `vae.per_channel_statistics.*`
with hyphenated names. Absent statistics default to mean 0 and std 1, an
absent timestep multiplier to 1000; every other tensor is required.
"""

from __future__ import annotations

import math
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
from ltx2_tpu_torch.models.video_vae.encoder import ENCODER_PLAN, VideoEncoder, VideoEncoderConfig

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


def _vae_checkpoint_keys(vae, prefix: str) -> Dict[str, str]:
    """{module tensor name: checkpoint key} of every tensor of a VAE half."""
    keys = {}
    for name, _t in (*vae.named_parameters(), *vae.named_buffers()):
        owner_name, _, leaf = name.rpartition(".")
        if owner_name == "per_channel_statistics":
            keys[name] = _STAT_KEYS[leaf]
            continue
        key = f"{owner_name}.conv.{leaf}" if isinstance(vae.get_submodule(owner_name), Conv3d) else name
        keys[name] = prefix + key.replace("time_embedder.", "time_embedder.timestep_embedder.")
    return keys


def decoder_checkpoint_keys(decoder: VideoDecoder) -> Dict[str, str]:
    """{module tensor name: checkpoint key} of every tensor of `decoder`."""
    return _vae_checkpoint_keys(decoder, "vae.decoder.")


def encoder_checkpoint_keys(encoder: VideoEncoder) -> Dict[str, str]:
    """{module tensor name: checkpoint key} of every tensor of `encoder`."""
    return _vae_checkpoint_keys(encoder, "vae.encoder.")


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


def _load_vae(path: str, module, keys: Dict[str, str], device: torch.device, which: str):
    """Fill `module` (built on meta) from the file, one tensor at a time
    through fp32, each in its placeholder's dtype; raises with the missing
    required keys."""
    f = SafetensorsFile(path)
    placeholders = dict((*module.named_parameters(), *module.named_buffers()))
    missing = []
    try:
        for name, key in keys.items():
            if key in f:
                assign_(module, name, to_dtype(f.get(key).to(device, torch.float32, copy=True),
                                               placeholders[name].dtype))
            elif name in _DEFAULTS:
                assign_(module, name, torch.full(placeholders[name].shape, _DEFAULTS[name], device=device))
            else:
                missing.append(key)
    finally:
        f.close()
    if missing:
        shown = ", ".join(missing[:8]) + (" ..." if len(missing) > 8 else "")
        raise ValueError(f"checkpoint {path} is missing {len(missing)} required video {which} key(s) — stored "
                         f"weights disagree with the derived architecture config: {shown}")
    return module


@torch.no_grad()
def load_video_decoder_params(path: str, cfg: VideoDecoderConfig, device=None) -> VideoDecoder:
    """The decoder of the checkpoint at `path` on `device` (default cuda):
    convs and linears in cfg.dtype, statistics and tables fp32, read one
    tensor at a time through fp32, as the JAX package reads them. Raises
    with the missing checkpoint keys when the file lacks a required one
    (e.g. metadata blocks that disagree with the stored up_blocks)."""
    decoder = VideoDecoder(cfg, device="meta")
    return _load_vae(path, decoder, decoder_checkpoint_keys(decoder), resolve_device(device), "decoder")


def encoder_config_from_checkpoint(path: str, compute_dtype: str = "float32") -> VideoEncoderConfig:
    """The encoder's architecture: the published plan's block kinds and
    strides (ENCODER_PLAN; the file does not say them), its channels and res
    block counts from the file's tensors; the published config when the file
    holds no encoder."""
    f = SafetensorsFile(path)
    try:
        pre = "vae.encoder."
        if pre + "conv_in.conv.weight" not in f:
            return VideoEncoderConfig(compute_dtype=compute_dtype)
        plan = []
        for i, (kind, _c_in, _arg, stride) in enumerate(ENCODER_PLAN):
            block = f"{pre}down_blocks.{i}."
            if kind == "res":
                n = 0
                while f"{block}res_blocks.{n}.conv1.conv.weight" in f:
                    n += 1
                if not n:
                    raise ValueError(f"checkpoint {path}: {block}res_blocks.0 missing (plan {ENCODER_PLAN})")
                plan.append(("res", f.info(f"{block}res_blocks.0.conv1.conv.weight")[1][1], n, None))
            else:
                if f"{block}conv.conv.weight" not in f:
                    raise ValueError(f"checkpoint {path}: {block}conv missing (plan {ENCODER_PLAN})")
                c_out, c_in = f.info(f"{block}conv.conv.weight")[1][:2]
                plan.append(("down", c_in, c_out * math.prod(stride), stride))
        latent = f.info(pre + "conv_out.conv.weight")[1][0] - 1 if pre + "conv_out.conv.weight" in f else 128
        patch = math.isqrt(f.info(pre + "conv_in.conv.weight")[1][1] // 3)
    finally:
        f.close()
    return VideoEncoderConfig(patch_size=patch, latent_channels=latent, compute_dtype=compute_dtype,
                              plan=tuple(plan))


@torch.no_grad()
def load_video_encoder_params(path: str, cfg: VideoEncoderConfig, device=None) -> VideoEncoder:
    """The encoder of the checkpoint at `path` on `device` (default cuda):
    convs in cfg.dtype, statistics fp32, read one tensor at a time through
    fp32. Raises with the missing checkpoint keys when the file lacks a
    required one."""
    encoder = VideoEncoder(cfg, device="meta")
    return _load_vae(path, encoder, encoder_checkpoint_keys(encoder), resolve_device(device), "encoder")


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


def encoder_to_checkpoint(encoder: VideoEncoder) -> Dict[str, torch.Tensor]:
    """The encoder's tensors under their checkpoint keys (the statistics
    under the shared `vae.per_channel_statistics.*`), on the CPU in their
    dtypes: the writer's side of `load_video_encoder_params`."""
    tensors = dict((*encoder.named_parameters(), *encoder.named_buffers()))
    return {key: tensors[name].detach().cpu() for name, key in encoder_checkpoint_keys(encoder).items()}
