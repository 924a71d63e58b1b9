"""int8 W8A8 serving weights (counterpart of ltx2_tpu/loader/int8.py).

The JAX package's opt-in quantized serving mode (`generate.py --int8`):

- weights: symmetric per-out-channel int8, one fp32 scale per output row,
  quantized once at load;
- activations: symmetric per-token dynamic int8, quantized right before
  each matmul (`ops.common.linear`), the product accumulated in int32.

A quantized `Linear` holds its weight as int8 codes with a `weight_cscale`
buffer (out,) fp32 beside it. The JAX package stacks the DiT's blocks and
gives a stacked weight an (L, out) scale; the port keeps one `Linear` per
block, so each has its own (out,) row of that table, the same numbers.
`weight_cscale` is not the fp8 `weight_scale` (per tensor, other
broadcasting, its own training guards).

Codes are round(w * (1 / scale)) with an explicit fp32 reciprocal, not a
division: the JAX package's device twin is strength-reduced to that
multiply, and its host twin does the multiply to stay bit-identical at
round-half boundaries. Both twins here do the same, so the host twin (the
streaming loader's) and the device twin (a model quantized in place) give
the JAX package's codes bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from ltx2_tpu_torch.loader.fp8 import is_quantized
from ltx2_tpu_torch.ops.common import Linear

INT8_MAX = 127.0

# The projection and FFN linears that carry the DiT's matmul work. Norm
# weights, AdaLN tables and linears, embeddings and the per-head gate
# projection stay in their dtype.
INT8_TARGETS = ("to_q", "to_k", "to_v", "to_out", "project_in", "project_out", "w_up", "w_gate", "w_down")
SKIP_MARKERS = ("norm", "scale_shift_table", "adaln", "embed", "to_gate_logits")


def int8_eligible(tree_key: str) -> bool:
    """Whether a dotted parameter name names a matmul weight the W8A8
    recipe quantizes (the JAX package's predicate, over the port's names:
    its markers are substrings, so a block index changes nothing)."""
    return (tree_key.endswith(".weight") and any(t in tree_key for t in INT8_TARGETS)
            and not any(m in tree_key for m in SKIP_MARKERS))


def quantize_array_int8(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host twin of `quantize_tensor_int8` in numpy, for the streaming
    loader (the card never holds the unquantized tree): (int8 codes, fp32
    scales over the last axis)."""
    wf = np.asarray(w, np.float32)
    amax = np.max(np.abs(wf), axis=-1)
    scale = np.maximum(amax / INT8_MAX, 1e-12).astype(np.float32)
    q = np.clip(np.round(wf * (np.float32(1.0) / scale)[..., None]), -INT8_MAX, INT8_MAX)
    return q.astype(np.int8), scale


def quantize_tensor_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 quantization of a (out, in) or
    stacked (L, out, in) weight -> (codes, fp32 scale (out,) or (L, out)):
    scale = max(amax / 127, 1e-12) over the contraction axis, codes =
    round(w * (1 / scale)) clipped to +-127, on w's device."""
    wf = w.to(torch.float32)
    scale = torch.clamp_min(wf.abs().amax(dim=-1) / INT8_MAX, 1e-12)
    q = torch.clamp(torch.round(wf * (1.0 / scale)[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def set_int8_weight_(lin: Linear, codes: torch.Tensor, cscale: torch.Tensor) -> Linear:
    """Make `lin` an int8 linear holding `codes` (out, in) and `cscale` (out,)."""
    if tuple(codes.shape) != tuple(lin.weight.shape) or tuple(cscale.shape) != (codes.shape[0],):
        raise ValueError(f"int8 codes {tuple(codes.shape)} and scales {tuple(cscale.shape)} for a weight of "
                         f"{tuple(lin.weight.shape)}")
    lin.weight = nn.Parameter(codes.to(torch.int8), requires_grad=False)
    lin.register_buffer("weight_cscale", cscale.to(torch.float32))
    return lin


@torch.no_grad()
def quantize_params_int8(module: nn.Module, path: str = "") -> nn.Module:
    """Quantize in place every `Linear` of `module` whose dotted weight name
    (prefixed by `path`) is `int8_eligible`, on the weights' device. Refuses
    a module that holds fp8 or int8 weights already: int8 re-quantizes from
    full-precision weights (load dequantized, without keep_fp8)."""
    if is_quantized(module):
        raise ValueError(f"int8 quantization of an already quantized module (weight_scale/weight_cscale present) "
                         f"at '{path}': load dequantized (keep_fp8=False) before --int8")
    for name, mod in module.named_modules():
        full = ".".join(part for part in (path, name, "weight") if part)
        if isinstance(mod, Linear) and mod.weight.dim() == 2 and mod.weight.is_floating_point() \
                and int8_eligible(full):
            set_int8_weight_(mod, *quantize_tensor_int8(mod.weight))
    return module
