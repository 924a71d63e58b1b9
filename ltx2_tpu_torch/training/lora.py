"""LoRA adapters for fine-tuning (counterpart of ltx2_tpu/training/lora.py).

Low-rank adapters attach to selected `Linear`s of the DiT as `lora_A`
(r, in) and `lora_B` (out, r) fp32 parameters and a `lora_scale` buffer;
`ops.common.linear` applies y += scale * (x A^T) B^T whenever they are
present. B starts at zero (the adapted model starts exactly at the base
model), A at N(0, 1/r). Linears are matched by their dotted module names,
which are the checkpoint's names (`transformer_blocks.3.attn1.to_q`).
`export_lora_checkpoint` writes trained adapters as a reference-format LoRA
file, which `generate.py --lora` fuses back (loader/lora.py).

Under tensor parallelism the adapters attach to the whole model before it
is sharded, as the JAX CLI attaches them (scripts/train.py:244-257): every
rank draws world 1's adapters from the same generator and the TP rules
(parallel/sharding.py) then slice them with their base weights. Under
ZeRO-3/FSDP the adapters are then sliced over 'data' with every other
parameter. The export gathers each factor over 'data' where FSDP slices
it, then over 'model' where TP splits it, and world rank 0 writes the file
world 1 writes.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import torch
import torch.nn as nn

from ltx2_tpu_torch.loader.export import inverse_rewrite
from ltx2_tpu_torch.loader.safetensors_io import write_safetensors
from ltx2_tpu_torch.ops.common import Linear
from ltx2_tpu_torch.parallel.fsdp import fsdp_dim, model_fsdp_axis
from ltx2_tpu_torch.parallel.runtime import world
from ltx2_tpu_torch.parallel.sharding import gather_whole, model_tp_axis, shard_tensor, whole_shape
from ltx2_tpu_torch.training.trainer import trainable_mask

# Default targets: every attention projection + FFN linears in the blocks.
DEFAULT_TARGETS = r"transformer_blocks\..*(to_q|to_k|to_v|to_out|project_in\.proj|project_out)$"
LORA_PARAMS = ("lora_A", "lora_B")


def attach_lora_(lin: Linear, rank: int) -> Linear:
    """Give `lin` uninitialised fp32 adapters of rank `rank` (frozen until a
    trainable mask selects them) on its weight's device."""
    out_features, in_features = lin.weight.shape
    kw = dict(device=lin.weight.device, dtype=torch.float32)
    lin.lora_A = nn.Parameter(torch.empty(rank, in_features, **kw), requires_grad=False)
    lin.lora_B = nn.Parameter(torch.empty(out_features, rank, **kw), requires_grad=False)
    lin.register_buffer("lora_scale", torch.empty((), **kw))
    return lin


@torch.no_grad()
def add_lora_params_(
    model: nn.Module,
    generator: torch.Generator,
    rank: int = 16,
    alpha: float = 16.0,
    targets: str = DEFAULT_TARGETS,
) -> int:
    """Add adapters in place to every Linear whose dotted name matches
    `targets`: A ~ N(0, 1/rank) drawn from `generator` (on the model's
    device), B = 0, scale = alpha / rank. Returns the number added. On a
    model already made a TP shard (its `cfg.tp_axis` set; a checkpoint read
    sliced) each A is drawn whole, as world 1 draws it, and this rank keeps
    its slice."""
    if model_fsdp_axis(model) is not None:
        raise ValueError("attach LoRA adapters before the model is sliced for FSDP: the slices are of every parameter")
    axis = model_tp_axis(model)
    pat = re.compile(targets)
    n = 0
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and pat.search(name):
            attach_lora_(mod, rank)
            in_whole = whole_shape(f"{name}.weight", mod.weight.shape, axis)[1]
            a = torch.empty(rank, in_whole, device=mod.lora_A.device, dtype=torch.float32)
            a.normal_(generator=generator)
            mod.lora_A.copy_(shard_tensor(f"{name}.lora_A", a.div_(math.sqrt(rank)), axis))
            mod.lora_B.zero_()
            mod.lora_scale.fill_(alpha / rank)
            n += 1
    return n


def lora_trainable_mask(model: nn.Module):
    """Train ONLY the adapter matrices (the scale is a buffer and stays
    frozen): sets requires_grad and returns the trainable names."""
    return trainable_mask(model, lambda name: name.rsplit(".", 1)[-1] in LORA_PARAMS)


def strip_lora_params(model: nn.Module) -> nn.Module:
    """Remove every adapter in place (e.g. before using the base alone)."""
    for mod in model.modules():
        if isinstance(mod, Linear) and hasattr(mod, "lora_A"):
            del mod.lora_A, mod.lora_B, mod.lora_scale
    return model


@torch.no_grad()
def export_lora_checkpoint(path: str, model: nn.Module, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write the trained adapters as a reference-format LoRA file: keys
    `diffusion_model.<reference base key>.lora_A.weight` / `.lora_B.weight`,
    fp32, the alpha / rank scale baked into B, so that the standard fuse
    W += strength * (B @ A) gives the trained model at strength 1. A model
    made a TP shard (its `cfg.tp_axis` set): every rank of the 'model' line
    that holds world rank 0 calls it, each split factor is gathered over
    the axis, and rank 0 alone writes the whole adapters. Sliced for FSDP
    (its `cfg.fsdp_axis` set): every rank calls it, each factor is
    gathered over 'data' first."""
    axis, fsdp = model_tp_axis(model), model_fsdp_axis(model)
    tensors: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        if not (isinstance(mod, Linear) and hasattr(mod, "lora_A")):
            continue
        a, b = (gather_whole(f"{name}.{k}", getattr(mod, k).detach(), model, fsdp_dim(getattr(mod, k)))
                for k in ("lora_A", "lora_B"))
        # The rewrite rules match with a trailing dot, as in full keys.
        base = f"diffusion_model.{inverse_rewrite(name + '.')[:-1]}"
        tensors[f"{base}.lora_A.weight"] = a.to("cpu", torch.float32, copy=True)
        tensors[f"{base}.lora_B.weight"] = b.to("cpu", torch.float32) * mod.lora_scale.to("cpu", torch.float32)
    if not tensors:
        raise ValueError("no LoRA adapters found in the model")
    if (axis is None and fsdp is None) or world()[0] == 0:
        write_safetensors(path, tensors, metadata=metadata)
