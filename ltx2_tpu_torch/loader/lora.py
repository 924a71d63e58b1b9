"""LoRA files fused into the DiT's weights (counterpart of
ltx2_tpu/loader/lora.py).

A LoRA file holds `lora_A` (rank, in) / `lora_B` (out, rank) pairs (or
`lora_down` / `lora_up`) under a base weight's key, with or without a
`diffusion_model.` prefix. Fusion adds strength * (B @ A) to the weight in
fp32 and rounds back to the weight's dtype; aliases of one weight (the same
key with and without a prefix) each add their delta. Every target is
resolved and checked before any weight changes. `return_deltas` returns
what `unfuse_lora_deltas` needs to subtract the deltas later: each fused
weight's LoRA terms (the A and B tensors stay in the files' host dicts),
from which each delta is made again, one weight at a time, by the same
`_delta`; no delta is kept on the device between the two (a distilled LoRA
on every linear of the 48-block audio-video DiT is 18.7e9 fp32 weights,
75 GB).

B @ A is computed in float64 on the weight's device and rounded once to
fp32: its rank-length sums of exact products then round the same on the
card and on the CPU, where the JAX package sums them in fp32 on the host.
Deltas are made one target at a time, so the host never holds all of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# {parameter name: one entry per fused alias, each that alias's LoRA terms}
AppliedLoRA = Dict[str, List[list]]

import torch
import torch.nn as nn

from ltx2_tpu_torch.loader.fp8 import FP8_DTYPE
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.loader.weight_loader import convert_checkpoint_key

@dataclass
class LoRAConfig:
    path: str
    strength: float = 1.0

    def __post_init__(self):
        if not -2.0 <= self.strength <= 2.0:
            raise ValueError(f"LoRA strength should be between -2.0 and 2.0, got {self.strength}")


def load_lora_weights(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the LoRA file on the CPU, in the file's dtype (the
    deltas are formed in float64, which holds bf16 and fp32 exactly, so a
    bf16 file is not widened on the host: half the host memory and the
    copies to the card)."""
    f = SafetensorsFile(path)
    try:
        return {k: f.get(k).clone() for k in f.keys()}
    finally:
        f.close()


_SUFFIX_PAIRS = [
    (".lora_A.weight", ".lora_B.weight"),
    (".lora_down.weight", ".lora_up.weight"),
    (".lora_A", ".lora_B"),
    (".lora_down", ".lora_up"),
]


def find_lora_keys_for_weight(lora_weights: Dict[str, torch.Tensor], base_key: str
                              ) -> Tuple[Optional[str], Optional[str]]:
    """The (A, B) keys of a base weight key, or (None, None)."""
    prefix = base_key.replace(".weight", "")
    candidates = [prefix]
    if not prefix.startswith("diffusion_model."):
        candidates.append(f"diffusion_model.{prefix}")
    if prefix.startswith("model."):
        candidates.append(prefix.replace("model.", "diffusion_model.", 1))
    for cand in candidates:
        for suff_a, suff_b in _SUFFIX_PAIRS:
            key_a, key_b = f"{cand}{suff_a}", f"{cand}{suff_b}"
            if key_a in lora_weights and key_b in lora_weights:
                return key_a, key_b
    return None, None


def compute_lora_delta(lora_weights: Dict[str, torch.Tensor], key_a: str, key_b: str, strength: float = 1.0,
                       device=None) -> torch.Tensor:
    """strength * (B @ A), fp32 on `device`: the product in float64, rounded
    once to fp32, then scaled in fp32. A and B go to the device in their own
    dtype and are widened there."""
    a = lora_weights[key_a].to(device).double()
    b = lora_weights[key_b].to(device).double()
    return (b @ a).to(torch.float32) * strength


def _lora_terms(lora_configs: List[LoRAConfig]) -> Dict[str, list]:
    """{base weight key: [(weights, key_a, key_b, strength), ...]} over all
    LoRAs, in the configs' order, keys sorted."""
    terms: Dict[str, list] = {}
    for config in lora_configs:
        weights = load_lora_weights(config.path)
        bases = {k[: -len(suff_a)] for k in weights for suff_a, _ in _SUFFIX_PAIRS if k.endswith(suff_a)}
        for base in sorted(bases):
            key_a, key_b = find_lora_keys_for_weight(weights, base + ".weight")
            if key_a is not None:
                terms.setdefault(base + ".weight", []).append((weights, key_a, key_b, config.strength))
    return terms


def _delta(terms: list, device=None) -> torch.Tensor:
    """The summed delta of one base key's terms, in fp32."""
    total = None
    for weights, key_a, key_b, strength in terms:
        d = compute_lora_delta(weights, key_a, key_b, strength, device)
        total = d if total is None else total + d
    return total


def collect_lora_deltas(lora_configs: List[LoRAConfig], device=None) -> Dict[str, torch.Tensor]:
    """All LoRAs -> {base key: summed fp32 delta} (eager: small adapters)."""
    return {name: _delta(terms, device) for name, terms in _lora_terms(lora_configs).items()}


def _canonical_tree_key(lora_base_key: str) -> Optional[str]:
    """A LoRA base key -> the DiT's parameter name."""
    key = lora_base_key
    for prefix in ("diffusion_model.", "model.diffusion_model.", "transformer."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    return convert_checkpoint_key(key, include_audio=True)


def _parameter(model: nn.Module, name: str) -> Optional[torch.Tensor]:
    owner_name, _, leaf = name.rpartition(".")
    try:
        owner = model.get_submodule(owner_name)
    except AttributeError:
        return None
    return owner._parameters.get(leaf)


@torch.no_grad()
def fuse_lora_into_params(model: nn.Module, lora_configs: List[LoRAConfig], return_deltas: bool = False):
    """W += sum_i strength_i * (B_i @ A_i), in fp32, cast back to W's dtype,
    in place on the model's weights. Raises, before any weight changes, on
    an fp8 or int8 target (additive deltas need full-precision weights: load
    dequantized when LoRAs are given). Keys the model has no weight for, or
    whose delta's shape differs, are skipped. With `return_deltas` also
    returns {parameter name: each alias's LoRA terms} (`AppliedLoRA`) for
    `unfuse_lora_deltas`, which makes the deltas again; no delta is kept."""
    plan = []
    for lora_key, terms in _lora_terms(lora_configs).items():
        tree_key = _canonical_tree_key(lora_key)
        param = None if tree_key is None else _parameter(model, tree_key)
        if param is None:
            continue
        if param.dtype == FP8_DTYPE:
            raise ValueError("Cannot fuse LoRA into fp8-serving weights (additive deltas need dequantized weights). "
                             "Load the transformer with keep_fp8=False when LoRAs are in play.")
        if param.dtype == torch.int8:
            raise ValueError("Cannot fuse LoRA into int8 W8A8 weights (additive deltas need full-precision weights).")
        weights, key_a, key_b, _strength = terms[0]
        if (weights[key_b].shape[0], weights[key_a].shape[1]) != tuple(param.shape):
            continue
        plan.append((tree_key, param, terms))

    applied: AppliedLoRA = {}
    for tree_key, param, terms in plan:
        param.copy_((param.float() + _delta(terms, param.device)).to(param.dtype))
        if return_deltas:
            applied.setdefault(tree_key, []).append(terms)
    if return_deltas:
        return model, applied
    return model


@torch.no_grad()
def unfuse_lora_deltas(model: nn.Module, applied: AppliedLoRA) -> nn.Module:
    """Subtract the deltas `fuse_lora_into_params(return_deltas=True)`
    added (restores the weights up to the rounding of their dtype): each
    weight's delta is made again from its terms, the same fp32 values the
    fuse added, its aliases summed in fuse order, and freed before the next
    weight's is made."""
    for name, alias_terms in applied.items():
        param = _parameter(model, name)
        total = None
        for terms in alias_terms:
            d = _delta(terms, param.device)
            total = d if total is None else total + d
        param.copy_((param.float() - total).to(param.dtype))
        del total
    return model
