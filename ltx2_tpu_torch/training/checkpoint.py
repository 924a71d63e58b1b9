"""Mid-run training state and exact resume (counterpart of
ltx2_tpu/training/checkpoint.py).

`save_train_state` persists what a run cannot derive again: the step, the
trainable tensors (the frozen base comes back from its checkpoint or its
seed), AdamW's two moments and its step count, and the fp32 EMA when one is
kept. Everything else in `train.py` is derived deterministically (batch
indices from a sequential RandomState that a resumed run fast-forwards, the
per-step generators from `seed + 2 + i`), so on the CPU a resumed run's
losses and weights are bit-identical to the uninterrupted run's.

Format: one safetensors file written with the port's streaming writer (one
tensor on the host at a time), keys `param.<name>`, `adam.mu.<name>`,
`adam.nu.<name>` and `ema.<name>` by the parameters' dotted names; the
metadata holds the step, AdamW's count and a fingerprint of every stored
name, shape and dtype, so another configuration (another LoRA rank, another
`--trainable` regex, EMA on or off) fails loudly instead of loading
tensors into the wrong places. The write goes to `path + ".tmp"` and is
renamed over `path`, so a crash mid-save leaves the previous state whole.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile, write_safetensors_streaming
from ltx2_tpu_torch.training.trainer import AdamW

StateEntry = Tuple[str, torch.Tensor]


def _entries(model: nn.Module, optimizer: AdamW, ema: Optional[Sequence[torch.Tensor]]) -> List[StateEntry]:
    """(key, live tensor) of everything the state holds, in a fixed order."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    names = [by_id.get(id(p)) for p in optimizer.params]
    if None in names:
        raise ValueError("train state: the optimizer holds a tensor that is not a parameter of the model")
    out = [(f"param.{n}", p) for n, p in zip(names, optimizer.params)]
    out += [(f"adam.mu.{n}", m) for n, m in zip(names, optimizer.mu)]
    out += [(f"adam.nu.{n}", v) for n, v in zip(names, optimizer.nu)]
    if ema is not None:
        out += [(f"ema.{n}", e) for n, e in zip(names, ema)]
    return out


def _fingerprint(entries: Sequence[StateEntry]) -> str:
    """A hash of every key, shape and dtype of the state, in order."""
    spec = "\n".join(f"{k}:{tuple(t.shape)}:{t.dtype}" for k, t in entries)
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def save_train_state(path: str, step: int, model: nn.Module, optimizer: AdamW,
                     ema: Optional[Sequence[torch.Tensor]] = None, metadata: Optional[Dict[str, str]] = None) -> None:
    """Atomically write (step, trainable tensors, AdamW's moments and
    count, EMA) to `path`; `step` is the index of the next step to run."""
    entries = _entries(model, optimizer, ema)
    meta = dict(metadata or {})
    meta.update(train_state_step=str(int(step)), train_state_adam_count=str(int(optimizer.count)),
                train_state_fingerprint=_fingerprint(entries))
    specs = [(k, t.dtype, tuple(t.shape), (lambda t=t: t.detach())) for k, t in entries]
    tmp = path + ".tmp"
    write_safetensors_streaming(tmp, specs, metadata=meta)
    os.replace(tmp, path)


@torch.no_grad()
def load_train_state(path: str, model: nn.Module, optimizer: AdamW,
                     ema: Optional[Sequence[torch.Tensor]] = None) -> int:
    """Restore a `save_train_state` file in place into the parameters,
    AdamW and the EMA of the current configuration (each tensor copied onto
    its live tensor's device); returns the step to run next. Raises
    ValueError when the file was saved under another configuration."""
    entries = _entries(model, optimizer, ema)
    f = SafetensorsFile(path)
    try:
        want, got = _fingerprint(entries), f.metadata.get("train_state_fingerprint")
        if got != want:
            raise ValueError(
                f"train state {path} was saved under a different configuration (fingerprint {got} != {want}): "
                "check that --trainable, --lora-rank and --ema-decay match the original run")
        for key, live in entries:
            if key not in f:
                raise ValueError(f"train state {path} is missing {key}")
            stored = f.get(key)
            if stored.dtype != live.dtype or tuple(stored.shape) != tuple(live.shape):
                raise ValueError(f"train state {key}: stored {stored.dtype}{tuple(stored.shape)} vs the current "
                                 f"configuration's {live.dtype}{tuple(live.shape)}")
            live.copy_(stored)
        optimizer.count = int(f.metadata["train_state_adam_count"])
        return int(f.metadata["train_state_step"])
    finally:
        f.close()
