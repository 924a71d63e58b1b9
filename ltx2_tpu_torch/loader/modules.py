"""Filling a module's tensors one at a time from a checkpoint.

A loader builds its module on the `meta` device (shapes, no memory), then
puts each tensor it reads in its place, on the target device, in the dtype
the loader's policy gives it. No host state dict of the checkpoint is ever
built, and the module's random-init or default dtype never exists in memory.
A tensor the module has no place for, or of another shape, raises; so does a
place the checkpoint left empty (`require_loaded`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn


def assign_(module: nn.Module, name: str, tensor: torch.Tensor) -> None:
    """Put `tensor` as the parameter or buffer `name` (dotted) of `module`,
    in the tensor's own dtype and device; a parameter stays frozen."""
    owner_name, _, leaf = name.rpartition(".")
    try:
        owner = module.get_submodule(owner_name)
    except AttributeError:
        raise KeyError(f"{name}: the module has no place for this tensor") from None
    if leaf in owner._parameters:
        old = owner._parameters[leaf]
        store = owner._parameters
        tensor_in = nn.Parameter(tensor, requires_grad=False)
    elif leaf in owner._buffers:
        old = owner._buffers[leaf]
        store, tensor_in = owner._buffers, tensor
    else:
        raise KeyError(f"{name}: the module has no place for this tensor")
    if old is not None and tuple(old.shape) != tuple(tensor.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(tensor.shape)}, module shape {tuple(old.shape)}")
    store[leaf] = tensor_in


def unloaded(module: nn.Module) -> List[str]:
    """Names of the parameters and buffers still on the meta device."""
    return [name for name, t in (*module.named_parameters(), *module.named_buffers()) if t.is_meta]


def require_loaded(module: nn.Module, path: str, what: str) -> None:
    missing = unloaded(module)
    if missing:
        shown = ", ".join(missing[:8]) + (" ..." if len(missing) > 8 else "")
        raise ValueError(f"checkpoint {path} is missing {len(missing)} {what} tensor(s): {shown}")
