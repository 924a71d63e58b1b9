"""Tensor-parallel sharding rules for the DiT (counterpart of
ltx2_tpu/parallel/sharding.py).

Megatron-style TP over the mesh's 'model' axis: column-parallel Q/K/V,
gate logits and FFN-in (out-features split), row-parallel output
projections (in-features split, the partial products summed over the axis
by `ops.common.linear_row_parallel`, the bias added once after). The rules
are the JAX package's, over the port's dotted names, each spec one entry per
tensor dim (the JAX specs without the leading layer axis of the stacked
blocks): "model" where the dim splits, None where it does not; an empty
spec replicates. Linear weights are (out, in), so a column split is dim 0
and a row split dim 1.

A rank holds its slice of every split tensor (`shard_tensor`): the TP
rank's contiguous 1/n of that dim. `shard_dit_params` slices a built DiT in
place; the loader (loader/weight_loader.py) makes its meta module's
tensors the rank's shapes with `shard_module_` and slices each tensor with
`shard_tensor` as it is read, so a rank reads only its own slice of each
leaf.
fp8 codes keep their per-tensor `weight_scale` (replicated), int8 codes
split with their column-parallel `weight_cscale`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from ltx2_tpu_torch.parallel.mesh import MODEL_AXIS, Axis

M = MODEL_AXIS

# (regex over the dotted name, spec): first match wins.
DIT_SHARDING_RULES: List[Tuple[str, tuple]] = [
    # Column-parallel: the out-features of Q/K/V, the gate logits, FFN-in.
    (r"transformer_blocks\.\d+\..*(to_q|to_k|to_v)\.weight$", (M, None)),
    (r"transformer_blocks\.\d+\..*(to_q|to_k|to_v)\.bias$", (M,)),
    (r"transformer_blocks\.\d+\..*to_gate_logits\.weight$", (M, None)),
    (r"transformer_blocks\.\d+\..*to_gate_logits\.bias$", (M,)),
    (r"transformer_blocks\.\d+\..*project_in\.proj\.weight$", (M, None)),
    (r"transformer_blocks\.\d+\..*project_in\.proj\.bias$", (M,)),
    (r"transformer_blocks\.\d+\..*w_(up|gate)\.weight$", (M, None)),
    # Row-parallel: the in-features of the output projections.
    (r"transformer_blocks\.\d+\..*to_out\.weight$", (None, M)),
    (r"transformer_blocks\.\d+\..*project_out\.weight$", (None, M)),
    (r"transformer_blocks\.\d+\..*w_down\.weight$", (None, M)),
    # The Q/K norms act on the split inner dim.
    (r"transformer_blocks\.\d+\..*(q_norm|k_norm)\.weight$", (M,)),
    # int8 per-out-channel scales: split with a column-parallel weight,
    # replicated (the default) with a row-parallel one.
    (r"transformer_blocks\.\d+\..*(to_q|to_k|to_v|project_in\.proj|w_up|w_gate)\.weight_cscale$", (M,)),
    # LoRA: B's out-features with a column-parallel base, A's in-features
    # with a row-parallel one; the other factor and the scale replicate.
    (r"transformer_blocks\.\d+\..*(to_q|to_k|to_v|project_in\.proj|w_up|w_gate)\.lora_B$", (M, None)),
    (r"transformer_blocks\.\d+\..*(to_out|project_out|w_down)\.lora_A$", (None, M)),
]


def spec_for_path(name: str, rules=DIT_SHARDING_RULES) -> tuple:
    """The spec of the tensor `name` (dotted): () when it replicates."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    return ()


def _split_dim(spec: tuple) -> Optional[int]:
    return next((i for i, s in enumerate(spec) if s == MODEL_AXIS), None)


def shard_tensor(name: str, tensor: torch.Tensor, axis: Optional[Axis], rules=DIT_SHARDING_RULES) -> torch.Tensor:
    """This rank's slice of `tensor` (a view) under the rules: the axis's
    index-th 1/n of the split dim; the tensor itself when it replicates or
    the axis has one rank. Raises when the dim does not divide."""
    dim = _split_dim(spec_for_path(name, rules))
    if axis is None or axis.size == 1 or dim is None:
        return tensor
    size = tensor.shape[dim]
    if size % axis.size:
        raise ValueError(f"{name}: dim {dim} of {tuple(tensor.shape)} does not divide the '{axis.name}' axis "
                         f"size {axis.size}")
    part = size // axis.size
    return tensor.narrow(dim, axis.index * part, part)


def check_tp_heads(cfg, axis: Optional[Axis]) -> None:
    """The heads of every attention must split evenly over the axis."""
    if axis is None or axis.size == 1:
        return
    heads = [cfg.num_attention_heads] + ([cfg.audio_heads] if cfg.has_audio else [])
    if any(h % axis.size for h in heads):
        raise ValueError(f"tensor parallelism over {axis.size} ranks needs heads divisible by it, got {heads}")


def _named_tensors(module: nn.Module):
    for name, p in module.named_parameters():
        yield name, p, True
    for name, b in module.named_buffers():
        yield name, b, False


def _replace_(module: nn.Module, name: str, tensor: torch.Tensor, is_param: bool) -> None:
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    if is_param:
        owner._parameters[leaf] = nn.Parameter(tensor, requires_grad=owner._parameters[leaf].requires_grad)
    else:
        owner._buffers[leaf] = tensor


@torch.no_grad()
def shard_module_(module: nn.Module, axis: Optional[Axis], rules=DIT_SHARDING_RULES, prefix: str = "") -> nn.Module:
    """Every split tensor of `module` (its names prefixed by `prefix`)
    replaced in place by a copy of this rank's slice; the rest kept."""
    if axis is None or axis.size == 1:
        return module
    for name, t, is_param in list(_named_tensors(module)):
        local = shard_tensor(prefix + name, t, axis, rules)
        if local is not t:
            _replace_(module, name, local if t.is_meta else local.clone(), is_param)
    return module


def shard_model_(model: nn.Module, axis: Optional[Axis]) -> nn.Module:
    """The whole DiT `model` made this rank's TP shard over `axis` in place:
    its split tensors sliced and its config's `tp_axis` set, so every
    forward runs the rank's heads and features and sums the row-parallel
    products over the axis. Nothing for an axis of one rank."""
    if axis is None or axis.size == 1:
        return model
    check_tp_heads(model.cfg, axis)
    shard_module_(model, axis)
    model.cfg = dataclasses.replace(model.cfg, tp_axis=axis)
    return model


def shard_dit_params(mesh, model: nn.Module) -> nn.Module:
    """`shard_model_` over `mesh`'s 'model' axis (nothing without one)."""
    from ltx2_tpu_torch.parallel.mesh import axis_of

    return shard_model_(model, axis_of(mesh, MODEL_AXIS))


# ---------------------------------------------------------------------------
# Gemma-3 text encoder TP (the JAX package's rules, sharding.py:132-152):
# column-parallel Q/K/V and gate/up, row-parallel o_proj and down; Gemma's
# q_norm / k_norm are per head and replicate, as do its norms and
# embeddings. The port's Gemma does not run tensor-parallel yet: these are
# the rules, for the slice that ports its TP serving.
# ---------------------------------------------------------------------------

GEMMA_SHARDING_RULES: List[Tuple[str, tuple]] = [
    (r"layers\.\d+\.self_attn\.(q_proj|k_proj|v_proj)\.weight$", (M, None)),
    (r"layers\.\d+\.self_attn\.o_proj\.weight$", (None, M)),
    (r"layers\.\d+\.mlp\.(gate_proj|up_proj)\.weight$", (M, None)),
    (r"layers\.\d+\.mlp\.down_proj\.weight$", (None, M)),
]


def gemma_spec_for_path(name: str) -> tuple:
    return spec_for_path(name, GEMMA_SHARDING_RULES)
