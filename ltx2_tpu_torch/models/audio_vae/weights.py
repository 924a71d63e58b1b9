"""The audio decoder and the vocoder from (and to) the unified checkpoint
(counterpart of the loaders in ltx2_tpu/models/audio_vae/decoder.py and
vocoder.py).

Keys: `audio_vae.decoder.*` (`conv_in.conv`, `mid.block_{1,2}`,
`up.{level}.block.{j}` with `conv1.conv`, `conv2.conv`,
`nin_shortcut.conv`, `up.{level}.upsample.conv.conv`, `conv_out.conv`) and
`audio_vae.per_channel_statistics.{mean,std}-of-means`; `vocoder.*` for the
plain vocoder, and for LTX-2.3's chain `vocoder.vocoder.*`,
`vocoder.bwe_generator.*` and `vocoder.mel_stft.*` (`stft_fn.forward_basis`,
`mel_basis`). A SnakeBeta activation's filters are
`upsample.filter` and `downsample.lowpass.filter`; the port's defaults stay
where the file has none, as the JAX package computes them. The
architectures are read off the file: the decoder's from its tensors'
shapes and names, the vocoder's from the metadata's `vocoder` config (its
`bwe` entry selects the chain, as the JAX ledger selects it), the
published defaults where the metadata says nothing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.modules import assign_, require_loaded
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.loader.weight_loader import read_checkpoint_config
from ltx2_tpu_torch.models.audio_vae.decoder import AudioDecoder, AudioDecoderConfig
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from ltx2_tpu_torch.models.audio_vae.vocoder import (
    Activation1d, Vocoder, VocoderConfig, VocoderWithBWE, VocoderWithBWEConfig, vocoder_with_bwe_config_from_checkpoint,
)

DECODER_PREFIX = "audio_vae.decoder."
STATS_PREFIX = "audio_vae.per_channel_statistics."


def audio_decoder_checkpoint_keys(decoder: AudioDecoder) -> Dict[str, str]:
    """{module tensor name: checkpoint key}."""
    levels = decoder.cfg.num_resolutions
    keys = {}
    for name, _ in (*decoder.named_parameters(), *decoder.named_buffers()):
        if name.startswith("per_channel_statistics."):
            stat = name.rpartition(".")[2].replace("_", "-")
            keys[name] = STATS_PREFIX + stat
            continue
        key = re.sub(r"^mid_block_(\d)\.", r"mid.block_\1.", name)
        key = re.sub(r"^up_blocks\.(\d+)\.res_blocks\.(\d+)\.",
                     lambda m: f"up.{levels - 1 - int(m.group(1))}.block.{m.group(2)}.", key)
        key = re.sub(r"^up_blocks\.(\d+)\.upsample\.conv\.",
                     lambda m: f"up.{levels - 1 - int(m.group(1))}.upsample.conv.", key)
        key = key.replace(".skip.", ".nin_shortcut.")
        owner, _, leaf = key.rpartition(".")
        keys[name] = f"{DECODER_PREFIX}{owner}.conv.{leaf}"
    return keys


def audio_decoder_config_from_checkpoint(path: str) -> AudioDecoderConfig:
    """The decoder's widths, levels and res blocks from the file's tensors;
    the mel bins from its statistics (16 without them)."""
    f = SafetensorsFile(path)
    try:
        def shape(name: str):
            return f.info(DECODER_PREFIX + name)[1]

        out_ch, ch = shape("conv_out.conv.weight")[:2]
        z = shape("conv_in.conv.weight")[1]
        levels = sorted({int(m.group(1)) for k in f.keys() if (m := re.match(rf"{DECODER_PREFIX}up\.(\d+)\.", k))})
        blocks = {int(m.group(1)) for k in f.keys() if (m := re.match(rf"{DECODER_PREFIX}up\.0\.block\.(\d+)\.", k))}
        mult = tuple(shape(f"up.{i}.block.0.conv2.conv.weight")[0] // ch for i in levels)
        stats = STATS_PREFIX + "mean-of-means"
        mel = f.info(stats)[1][0] // z if stats in f else 16
        return AudioDecoderConfig(ch=ch, out_ch=out_ch, ch_mult=mult, num_res_blocks=len(blocks), z_channels=z,
                                  mel_bins=mel)
    finally:
        f.close()


def _has(path: str, prefix: str) -> bool:
    f = SafetensorsFile(path)
    try:
        return any(k.startswith(prefix) for k in f.keys())
    finally:
        f.close()


@torch.no_grad()
def _fill(module: nn.Module, path: str, keys: Dict[str, str], device) -> None:
    """Each of `keys`' tensors the file holds, fp32, on `device`."""
    f = SafetensorsFile(path)
    try:
        for name, key in keys.items():
            if key in f:
                assign_(module, name, f.get(key).to(device, torch.float32, copy=True))
    finally:
        f.close()


def load_audio_decoder_params(path: str, cfg: Optional[AudioDecoderConfig] = None,
                              device=None) -> Optional[AudioDecoder]:
    """The audio decoder of the file on `device` (default cuda), fp32; None
    when the file holds no audio VAE. Statistics the file lacks stay 0 and 1."""
    if not _has(path, "audio_vae."):
        return None
    device = resolve_device(device)
    decoder = AudioDecoder(cfg or audio_decoder_config_from_checkpoint(path), device="meta")
    decoder.per_channel_statistics = PerChannelStatistics(decoder.per_channel_statistics.mean_of_means.numel(),
                                                          device=device)
    _fill(decoder, path, audio_decoder_checkpoint_keys(decoder), device)
    require_loaded(decoder, path, "audio decoder")
    return decoder


def audio_decoder_to_checkpoint(decoder: AudioDecoder) -> Dict[str, torch.Tensor]:
    tensors = dict((*decoder.named_parameters(), *decoder.named_buffers()))
    return {key: tensors[name].detach().cpu() for name, key in audio_decoder_checkpoint_keys(decoder).items()}


def vocoder_checkpoint_keys(vocoder: nn.Module) -> Dict[str, str]:
    """{module tensor name: checkpoint key}: `vocoder.` before the names
    (the chain's `vocoder.vocoder.`, `vocoder.bwe_generator.`,
    `vocoder.mel_stft.`), `downsample.filter` as `downsample.lowpass.filter`."""
    return {name: "vocoder." + name.replace(".downsample.filter", ".downsample.lowpass.filter")
            for name, _ in (*vocoder.named_parameters(), *vocoder.named_buffers())}


_VOCODER_FIELDS = {f.name for f in dataclasses.fields(VocoderConfig)}


def vocoder_config_from_checkpoint(path: str) -> Union[VocoderConfig, VocoderWithBWEConfig]:
    """The metadata's `vocoder` config: with a `bwe` entry LTX-2.3's chain
    (`vocoder_with_bwe_config_from_checkpoint`), else the plain vocoder
    with the fields it names over the defaults; the input width from
    conv_pre's weight."""
    meta = read_checkpoint_config(path).get("vocoder", {}) or {}
    if "bwe" in meta:
        return vocoder_with_bwe_config_from_checkpoint(meta)
    fields = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list) else v
              for k, v in meta.items() if k in _VOCODER_FIELDS}
    cfg = VocoderConfig(**fields)
    f = SafetensorsFile(path)
    try:
        in_channels = f.info("vocoder.conv_pre.weight")[1][1]
    finally:
        f.close()
    return cfg if in_channels == cfg.in_channels else dataclasses.replace(cfg, in_channels_override=in_channels)


def load_vocoder_params(path: str, cfg=None, device=None) -> Optional[Union[Vocoder, VocoderWithBWE]]:
    """The file's vocoder on `device` (default cuda), fp32: the plain one
    or, for a VocoderWithBWEConfig (the metadata's choice by default),
    LTX-2.3's chain; None when the file holds no vocoder."""
    if not _has(path, "vocoder."):
        return None
    device = resolve_device(device)
    cfg = cfg or vocoder_config_from_checkpoint(path)
    vocoder = (VocoderWithBWE if isinstance(cfg, VocoderWithBWEConfig) else Vocoder)(cfg, device="meta")
    default = Activation1d(1, device=device)  # the filters the file lacks keep these
    for m in vocoder.modules():
        if isinstance(m, Activation1d):
            m.upsample.filter = default.upsample.filter.clone()
            m.downsample.filter = default.downsample.filter.clone()
    _fill(vocoder, path, vocoder_checkpoint_keys(vocoder), device)
    require_loaded(vocoder, path, "vocoder")
    return vocoder


def vocoder_to_checkpoint(vocoder: nn.Module) -> Dict[str, torch.Tensor]:
    tensors = dict((*vocoder.named_parameters(), *vocoder.named_buffers()))
    return {key: tensors[name].detach().cpu() for name, key in vocoder_checkpoint_keys(vocoder).items()}
