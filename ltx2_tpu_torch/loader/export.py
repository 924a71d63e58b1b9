"""The video DiT back to a reference-format safetensors checkpoint
(counterpart of ltx2_tpu/loader/export.py).

The inverse of the loader: module names through the inverse of
KEY_REWRITE_RULES, prefixed with `model.diffusion_model.`, one tensor
copied from the device to the host at a time, so a checkpoint fine-tuned on
the card reloads through `load_transformer_params` and stays loadable by
the reference implementation.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Optional

import torch
import torch.nn as nn

from ltx2_tpu_torch.loader.convert import to_dtype
from ltx2_tpu_torch.loader.fp8 import is_quantized
from ltx2_tpu_torch.loader.safetensors_io import DTYPES, SafetensorsFile, Spec, write_safetensors_streaming
from ltx2_tpu_torch.loader.weight_loader import DIFFUSION_PREFIX

# Inverse of weight_loader's KEY_REWRITE_RULES: module name -> checkpoint key.
INVERSE_KEY_RULES = [
    (r"\.audio_ff\.project_in\.proj\.", ".audio_ff.net.0.proj."),
    (r"\.audio_ff\.project_out\.", ".audio_ff.net.2."),
    (r"\.ff\.project_in\.proj\.", ".ff.net.0.proj."),
    (r"\.ff\.project_out\.", ".ff.net.2."),
    (r"\.to_out\.", ".to_out.0."),
]


def inverse_rewrite(name: str) -> str:
    """A module name -> its reference name (no prefix)."""
    for pat, repl in INVERSE_KEY_RULES:
        name = re.sub(pat, repl, name)
    return name


def _tensors(model: nn.Module) -> Iterator:
    yield from model.named_parameters()
    yield from model.named_buffers()


def iter_checkpoint_specs(model: nn.Module, dtype: torch.dtype = torch.float32) -> Iterator[Spec]:
    """Streaming-writer specs (name, dtype, shape, producer) of the DiT's
    tensors in `dtype`, without touching their data. Refuses a model that
    holds quantized weights: their codes written as values beside a stale
    scale would reload corrupted."""
    if is_quantized(model):
        raise ValueError("cannot export a quantized (fp8-kept / int8) model as a reference checkpoint: load it with "
                         "keep_fp8=False before exporting")
    for name, t in _tensors(model):
        yield (DIFFUSION_PREFIX + inverse_rewrite(name), dtype, tuple(t.shape),
               (lambda t=t: to_dtype(t.detach().to("cpu", torch.float32), dtype)))


def iter_fp8_checkpoint_specs(model: nn.Module) -> Iterator[Spec]:
    """Specs of a DiT whose linears are kept in fp8, in the layout of the
    reference's `-fp8` checkpoints: each quantized weight as F8_E4M3 codes
    with its per-tensor F32 `weight_scale` (0-d), every other tensor in its
    own dtype, all under the reference keys."""
    for name, t in _tensors(model):
        yield (DIFFUSION_PREFIX + inverse_rewrite(name), t.dtype, tuple(t.shape),
               (lambda t=t: t.detach().to("cpu")))


def params_to_checkpoint(model: nn.Module, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The DiT as a {reference key: host tensor} dict (eager: tests and
    small models; real exports stream through the specs)."""
    return {name: producer() for name, _dt, _shape, producer in iter_checkpoint_specs(model, dtype)}


def export_transformer_checkpoint(
    path: str, model: nn.Module, metadata: Optional[Dict[str, str]] = None,
    carry_from: Optional[str] = None, dtype: torch.dtype = torch.float32,
) -> None:
    """Write the DiT as a reference-format checkpoint, tensors in `dtype`.

    `carry_from`: the source checkpoint whose non-DiT tensors (the VAE, its
    statistics, the text projection and connectors, ...) are copied into the
    export byte for byte, so the file is complete on its own (the reference
    keeps every component in one file). A source `weight_scale` whose weight
    the export re-emits dequantized is dropped: on reload it would
    "dequantize" the new weight again. Host memory: one tensor."""
    specs = list(iter_checkpoint_specs(model, dtype))
    dit_keys = {name for name, _d, _s, _p in specs}
    src = SafetensorsFile(carry_from) if carry_from is not None else None
    try:
        if src is not None:
            for key in src.keys():
                if key in dit_keys or (key.endswith(".weight_scale") and key[: -len("_scale")] in dit_keys):
                    continue
                dt, shape = src.info(key)
                specs.append((key, DTYPES[dt], shape, (lambda key=key: src.get(key))))
        write_safetensors_streaming(path, specs, metadata=metadata)
    finally:
        if src is not None:
            src.close()
