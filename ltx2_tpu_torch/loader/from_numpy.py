"""Build the port's modules from parameter trees given as numpy arrays.

The JAX package keeps parameters as nested dicts (and lists) whose leaf
names follow the checkpoint; the port's modules use the same names, so a
tree flattens to a state dict with dotted keys. The DiT's
`transformer_blocks` leaves carry a leading layer axis L (the JAX package
stacks its blocks to scan them), which is split into the L entries of the
port's `nn.ModuleList`. Loading is strict: a leaf the module has no place
for, or a parameter the tree does not give, raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig


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


def dit_from_numpy(tree: Mapping, cfg: LTXModelConfig, device=None) -> LTXModel:
    """A video DiT parameter tree (stacked blocks) -> LTXModel on `device`."""
    flat: Dict[str, np.ndarray] = {}
    for key, arr in flatten_tree(tree).items():
        head, _, rest = key.partition(".")
        if head != "transformer_blocks":
            flat[key] = arr
            continue
        if arr.shape[0] != cfg.num_layers:
            raise ValueError(f"{key}: leading axis {arr.shape[0]} != num_layers {cfg.num_layers}")
        for i in range(cfg.num_layers):
            flat[f"transformer_blocks.{i}.{rest}"] = arr[i]
    model = LTXModel(cfg, device=device)
    _load(model, flat)
    return model


def video_decoder_from_numpy(tree: Mapping, cfg: VideoDecoderConfig, device=None) -> VideoDecoder:
    """A video-decoder parameter tree -> VideoDecoder on `device`."""
    decoder = VideoDecoder(cfg, device=device)
    _load(decoder, flatten_tree(tree))
    return decoder
