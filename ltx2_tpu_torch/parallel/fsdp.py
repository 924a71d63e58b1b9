"""ZeRO-3 / FSDP: the parameters themselves sharded over a 'data' mesh axis
(the port's counterpart of the JAX package's `fsdp_param_shardings`
placement, which GSPMD turns into per-block gathers inside the remat'd scan
body and reduce-scatters of the gradients).

`shard_model_fsdp_` replaces each parameter the layout slices (its dim from
`training.trainer.fsdp_param_shardings`) in place with a copy of this
rank's contiguous slice along that dim, tags every parameter with its dim
(None: kept whole, replicated over 'data') and sets the config's
`fsdp_axis`; between steps a rank then holds only slices. Under TP it runs
on the rank's TP shard, so a leaf split over 'model' is sliced again over
'data' on another dim.

Where the weights become whole: `gathered(module, axis)` swaps each sliced
parameter of `module` for `collectives.gather_from_data` of it (all-gather
forward, fp32 reduce-scatter of the gradient backward) for the length of a
`with`, in `named_parameters` order, and puts the slices back after. The
DiT's forward (models/transformer/model.py) runs it once around the
non-block leaves and once inside each block's remat unit, so only one
block's whole weights live at a time and the recompute gathers again.
Buffers (an fp8 weight's `weight_scale`, LoRA's `lora_scale`) stay whole
on every rank, beside the gathered weight.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Sequence

import torch
import torch.nn as nn

from ltx2_tpu_torch.parallel.collectives import gather_from_data
from ltx2_tpu_torch.parallel.mesh import Axis

# The attribute that tags an FSDP model's parameter with its 'data' dim.
FSDP_DIM = "fsdp_dim"


def is_fsdp(p: torch.Tensor) -> bool:
    """Whether `p` is a parameter of a model sliced by `shard_model_fsdp_`."""
    return hasattr(p, FSDP_DIM)


def fsdp_dim(p: torch.Tensor) -> Optional[int]:
    """The dim `p` is sliced along over 'data', or None (kept whole, or not
    an FSDP parameter)."""
    return getattr(p, FSDP_DIM, None)


def model_fsdp_axis(model: nn.Module) -> Optional[Axis]:
    """The 'data' axis `model`'s parameters are sliced over (its
    `cfg.fsdp_axis`), or None."""
    axis = getattr(getattr(model, "cfg", None), "fsdp_axis", None)
    return axis if axis is not None and axis.size > 1 else None


@torch.no_grad()
def shard_model_fsdp_(model: nn.Module, axis: Axis, dims: Sequence[Optional[int]]) -> nn.Module:
    """Slice `model` over the 'data' `axis` in place: the parameter at each
    position of `named_parameters()` replaced by a copy of this rank's
    contiguous 1/D along its dim in `dims` (None: kept whole), its
    `requires_grad` kept, every parameter tagged with its dim, and the
    config's `fsdp_axis` set."""
    named = list(model.named_parameters())
    if len(dims) != len(named):
        raise ValueError(f"FSDP layout: {len(dims)} dims for {len(named)} parameters")
    if axis is None or axis.size < 2:
        raise ValueError("FSDP needs a 'data' axis of more than one rank")
    if model_fsdp_axis(model) is not None:
        raise ValueError("the model's parameters are FSDP slices already")
    for (name, p), d in zip(named, dims):
        if d is not None:
            if p.shape[d] % axis.size:
                raise ValueError(f"{name}: dim {d} of {tuple(p.shape)} does not divide over {axis.size} ranks")
            k = p.shape[d] // axis.size
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            p = nn.Parameter(p.narrow(d, axis.index * k, k).clone(), requires_grad=p.requires_grad)
            owner._parameters[leaf] = p
        setattr(p, FSDP_DIM, d)
    model.cfg = dataclasses.replace(model.cfg, fsdp_axis=axis)
    return model


@contextlib.contextmanager
def gathered(module: nn.Module, axis: Optional[Axis], skip: Optional[str] = None) -> Iterator[None]:
    """Within the `with`, each sliced parameter of `module` (but those whose
    name starts with `skip`) is its whole tensor, `gather_from_data` over
    `axis` of the slice; the slices are back after, also on an exception (a
    remat recompute that stops early). Nothing without an axis. Every rank
    of the axis enters it on the same module, so the gathers run in one
    order."""
    if axis is None or axis.size == 1:
        yield
        return
    swaps = []
    try:
        for name, p in list(module.named_parameters()):
            d = fsdp_dim(p)
            if d is None or (skip is not None and name.startswith(skip)):
                continue
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            owner._parameters[leaf] = gather_from_data(p, axis, d)
            swaps.append((owner, leaf, p))
        yield
    finally:
        for owner, leaf, p in reversed(swaps):
            owner._parameters[leaf] = p


def resident_bytes(model: nn.Module) -> int:
    """The bytes of the parameters this rank holds (slices under FSDP and
    TP)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())
