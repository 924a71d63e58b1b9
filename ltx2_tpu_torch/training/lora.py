"""LoRA adapters for fine-tuning (counterpart of ltx2_tpu/training/lora.py).

Low-rank adapters attach to selected `Linear`s of the DiT as `lora_A`
(r, in) and `lora_B` (out, r) fp32 parameters and a `lora_scale` buffer;
`ops.common.linear` applies y += scale * (x A^T) B^T whenever they are
present. B starts at zero (the adapted model starts exactly at the base
model), A at N(0, 1/r). Linears are matched by their dotted module names,
which are the checkpoint's names (`transformer_blocks.3.attn1.to_q`).
`export_lora_checkpoint` writes trained adapters as a reference-format LoRA
file, which `generate.py --lora` fuses back (loader/lora.py).
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
    device), B = 0, scale = alpha / rank. Returns the number added."""
    pat = re.compile(targets)
    n = 0
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and pat.search(name):
            attach_lora_(mod, rank)
            mod.lora_A.normal_(generator=generator).div_(math.sqrt(rank))
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
    W += strength * (B @ A) gives the trained model at strength 1."""
    tensors: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        if not (isinstance(mod, Linear) and hasattr(mod, "lora_A")):
            continue
        # The rewrite rules match with a trailing dot, as in full keys.
        base = f"diffusion_model.{inverse_rewrite(name + '.')[:-1]}"
        tensors[f"{base}.lora_A.weight"] = mod.lora_A.detach().to("cpu", torch.float32, copy=True)
        tensors[f"{base}.lora_B.weight"] = (mod.lora_B.detach().to("cpu", torch.float32)
                                            * mod.lora_scale.to("cpu", torch.float32))
    if not tensors:
        raise ValueError("no LoRA adapters found in the model")
    write_safetensors(path, tensors, metadata=metadata)
