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

Under ZeRO (AdamW's moments sharded over 'data') every rank calls
`save_train_state`: the moments' slices are all-gathered one tensor at a
time and rank 0 writes the same file world 1 writes, whole arrays as the
JAX state holds them (`device_get`); `load_train_state` takes each rank's
slice of it. Under tensor parallelism (the model's `cfg.tp_axis` set) the
parameters, both moments and the EMA are the rank's slices of the split
leaves: they are gathered over 'model' too (after the 'data' gather of a
ZeRO moment), and a load slices them again. Under ZeRO-3/FSDP the
parameters and the EMA are 'data' slices as the moments are, and join
their gathers. So a state saved at one world size, TP or DP or both, with
or without FSDP, resumes at another.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile, write_safetensors_streaming
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.runtime import world
from ltx2_tpu_torch.parallel.sharding import gather_tensor, model_tp_axis, shard_tensor, tp_split_dim, whole_shape
from ltx2_tpu_torch.training.trainer import AdamW, parameter_names

# (key, live tensor, the whole tensor's shape, the optimizer's index of the
# parameter whose moment, EMA or (FSDP) self this rank holds a slice of over
# 'data', or None, the parameter's dotted name: its TP spec)
StateEntry = Tuple[str, torch.Tensor, Tuple[int, ...], Optional[int], str]


def _entries(model: nn.Module, optimizer: AdamW, ema: Optional[Sequence[torch.Tensor]]) -> List[StateEntry]:
    """Everything the state holds, in a fixed order."""
    names = parameter_names(model, optimizer.params)
    tp = model_tp_axis(model)
    shapes = [whole_shape(n, optimizer.unsliced_shape(i), tp) for i, n in enumerate(names)]
    sliced = [None if d is None else i for i, d in enumerate(optimizer.shard_dims)]
    own = sliced if optimizer.params_sliced else [None] * len(names)  # the parameters and EMA: FSDP slices
    out = [(f"param.{n}", p, s, i, n) for n, p, s, i in zip(names, optimizer.params, shapes, own)]
    for kind, moments in (("mu", optimizer.mu), ("nu", optimizer.nu)):
        out += [(f"adam.{kind}.{n}", m, s, i, n) for n, m, s, i in zip(names, moments, shapes, sliced)]
    if ema is not None:
        out += [(f"ema.{n}", e, s, i, n) for n, e, s, i in zip(names, ema, shapes, own)]
    return out


def _fingerprint(entries: Sequence[StateEntry]) -> str:
    """A hash of every key, whole shape and dtype of the state, in order."""
    spec = "\n".join(f"{k}:{shape}:{t.dtype}" for k, t, shape, *_ in entries)
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def save_train_state(path: str, step: int, model: nn.Module, optimizer: AdamW,
                     ema: Optional[Sequence[torch.Tensor]] = None, metadata: Optional[Dict[str, str]] = None) -> None:
    """Atomically write (step, trainable tensors, AdamW's moments and
    count, EMA) to `path`; `step` is the index of the next step to run.
    With sharded moments, FSDP slices or under TP every rank calls it (each tensor is
    gathered whole, over 'data' then 'model', as the writer reaches it) and
    rank 0 alone writes."""
    entries = _entries(model, optimizer, ema)
    meta = dict(metadata or {})
    meta.update(train_state_step=str(int(step)), train_state_adam_count=str(int(optimizer.count)),
                train_state_fingerprint=_fingerprint(entries))
    tp = model_tp_axis(model)

    def gathered(i: Optional[int], name: str) -> bool:
        return i is not None or (tp is not None and tp_split_dim(name) is not None)

    def whole(t: torch.Tensor, i: Optional[int], name: str) -> torch.Tensor:
        t = t.detach()
        if i is not None:
            t = collectives.all_gather(t, optimizer.axis, optimizer.shard_dims[i])
        return gather_tensor(name, t, tp)

    specs = [(k, t.dtype, shape, (lambda t=t, i=i, n=n: whole(t, i, n))) for k, t, shape, i, n in entries]
    if world()[0] != 0:  # join the gathers in the writer's order; write nothing
        for _, t, _, i, n in entries:
            if gathered(i, n):
                whole(t, i, n)
        return
    tmp = path + ".tmp"
    write_safetensors_streaming(tmp, specs, metadata=meta)
    os.replace(tmp, path)


@torch.no_grad()
def load_train_state(path: str, model: nn.Module, optimizer: AdamW,
                     ema: Optional[Sequence[torch.Tensor]] = None) -> int:
    """Restore a `save_train_state` file in place into the parameters,
    AdamW and the EMA of the current configuration (each tensor copied onto
    its live tensor's device; under TP each split leaf takes this rank's
    slice, and a sharded moment (under FSDP also the parameter and its
    EMA) then its 'data' slice of that);
    returns the step to run next. Raises ValueError when the file was saved
    under another configuration."""
    entries = _entries(model, optimizer, ema)
    tp = model_tp_axis(model)
    f = SafetensorsFile(path)
    try:
        want, got = _fingerprint(entries), f.metadata.get("train_state_fingerprint")
        if got != want:
            raise ValueError(
                f"train state {path} was saved under a different configuration (fingerprint {got} != {want}): "
                "check that --trainable, --lora-rank and --ema-decay match the original run")
        for key, live, shape, i, name in entries:
            if key not in f:
                raise ValueError(f"train state {path} is missing {key}")
            stored = f.get(key)
            if stored.dtype != live.dtype or tuple(stored.shape) != shape:
                raise ValueError(f"train state {key}: stored {stored.dtype}{tuple(stored.shape)} vs the current "
                                 f"configuration's {live.dtype}{shape}")
            stored = shard_tensor(name, stored, tp)
            live.copy_(stored if i is None else optimizer.local(i, stored))
        optimizer.count = int(f.metadata["train_state_adam_count"])
        return int(f.metadata["train_state_step"])
    finally:
        f.close()
