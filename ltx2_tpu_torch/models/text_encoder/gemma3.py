"""Gemma-3-12B text encoder (counterpart of
ltx2_tpu/models/text_encoder/gemma3.py).

48 layers: 40 sliding-window (window 1024, theta 1e4, no scaling) and 8 full
attention (every 6th layer, theta 1e6, linear position scaling 8); GQA with
16 query and 8 key/value heads of 256; RMSNorm with Gemma's (1 + weight)
offset in fp32, 4 norms per layer, per-head q/k norms; SiLU-gated MLP. The
forward returns all 49 hidden states: the input of each layer (the first is
the scaled embedding) and the final normed state. It runs in fp32
(docs/PARITY.md: Gemma's norm weights overflow fp16, and its drift poisons
everything downstream).

Masks follow the JAX package: causal AND padding [AND window] combined as
booleans and lowered once to a finite additive -0.7 * finfo.max, so a fully
padded query row of a left-padded batch attends uniformly instead of
turning to NaN. Each mask is query-dependent, so every attention takes
`sdpa`'s plain route, as the JAX package takes its einsum route.

The JAX package stacks the layers and scans them; here they are an
`nn.ModuleList` run in a Python loop. `load_gemma3_params` reads the HF
shards, optionally with fp8 matmul weights (E4M3 codes and per-tensor scales
dequantized at use by `linear`, embeddings in bf16; 12B in about 12.8 GB
instead of 47 GB in fp32). Not ported yet: greedy generation.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.convert import to_dtype
from ltx2_tpu_torch.loader.fp8 import FP8_DTYPE, FP8_MAX, set_fp8_weight_
from ltx2_tpu_torch.loader.modules import assign_, require_loaded
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.models.transformer.attention import NormWeight
from ltx2_tpu_torch.ops.attention import sdpa
from ltx2_tpu_torch.ops.common import Linear, linear, silu_mul

# Every 6th layer (5, 11, ..., 47) is full attention.
GEMMA3_LAYER_TYPES = tuple("sliding_attention" if i % 6 != 5 else "full_attention" for i in range(48))


@dataclass(frozen=True)
class Gemma3Config:
    vocab_size: int = 262208
    hidden_size: int = 3840
    intermediate_size: int = 15360
    num_hidden_layers: int = 48
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    sliding_window: int = 1024
    sliding_rope_theta: float = 10000.0
    sliding_rope_scaling_factor: float = 1.0
    full_rope_theta: float = 1000000.0
    full_rope_scaling_factor: float = 8.0
    layer_types: Tuple[str, ...] = GEMMA3_LAYER_TYPES
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @staticmethod
    def tiny(**kwargs) -> "Gemma3Config":
        """The small config of the tests (JAX's `Gemma3Config.tiny`)."""
        defaults = dict(
            vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=6,
            num_attention_heads=4, num_key_value_heads=2, head_dim=8, sliding_window=4,
            layer_types=tuple("sliding_attention" if i % 6 != 5 else "full_attention" for i in range(6)),
        )
        defaults.update(kwargs)
        return Gemma3Config(**defaults)


class GemmaAttention(nn.Module):
    def __init__(self, cfg: Gemma3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, qd, kvd = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
        self.q_proj = Linear(h, qd, bias=False, device=device, dtype=dtype)
        self.k_proj = Linear(h, kvd, bias=False, device=device, dtype=dtype)
        self.v_proj = Linear(h, kvd, bias=False, device=device, dtype=dtype)
        self.o_proj = Linear(qd, h, bias=False, device=device, dtype=dtype)
        self.q_norm = NormWeight(cfg.head_dim, device=device, dtype=dtype)
        self.k_norm = NormWeight(cfg.head_dim, device=device, dtype=dtype)


class GemmaMLP(nn.Module):
    def __init__(self, cfg: Gemma3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(h, inter, bias=False, device=device, dtype=dtype)
        self.up_proj = Linear(h, inter, bias=False, device=device, dtype=dtype)
        self.down_proj = Linear(inter, h, bias=False, device=device, dtype=dtype)


class GemmaLayer(nn.Module):
    def __init__(self, cfg: Gemma3Config, *, device=None, dtype=torch.float32):
        super().__init__()
        self.self_attn = GemmaAttention(cfg, device=device, dtype=dtype)
        self.mlp = GemmaMLP(cfg, device=device, dtype=dtype)
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            setattr(self, name, NormWeight(cfg.hidden_size, device=device, dtype=dtype))


class Gemma3(nn.Module):
    """Gemma-3's parameters, named as in the checkpoint's
    `language_model.model.*` keys; each norm holds the w of its (1 + w).
    Parameters start uninitialised: load them (loader/from_numpy.py) or
    draw them (`init_gemma3_`)."""

    def __init__(self, cfg: Gemma3Config, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        self.embed_tokens = nn.Module()
        self.embed_tokens.weight = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, device=device, dtype=dtype), requires_grad=False)
        self.layers = nn.ModuleList(GemmaLayer(cfg, device=device, dtype=dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = NormWeight(cfg.hidden_size, device=device, dtype=dtype)


@torch.no_grad()
def init_gemma3_(model: Gemma3, generator: torch.Generator) -> Gemma3:
    """Random weights in place, on the parameters' device, with the
    distributions of ltx2_tpu's init_gemma3: linears normal * 0.02, the
    embedding normal * 1.0, norms zero."""
    model.embed_tokens.weight.normal_(generator=generator)
    for m in model.modules():
        if isinstance(m, Linear):
            m.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, NormWeight):
            m.weight.zero_()
    return model


def gemma_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with Gemma's (1 + weight) offset, fp32 math, x's dtype out."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, base: float, scaling_factor: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin (S, head_dim/2), fp32, positions divided by scaling_factor."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / (base ** exponents)
    freqs = (positions.float() / scaling_factor)[:, None] * inv_freq[None, :]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Half-split rotation of (B, H, S, D) tensors by (S, D/2) tables, in
    fp32, each input's dtype out."""

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _attention(p: GemmaAttention, cfg: Gemma3Config, x: torch.Tensor, mask: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """GQA attention with per-head q/k RMSNorm (normed before the head
    transpose). Key/value head i // groups serves query head i, as
    `jnp.repeat` expands them."""
    b, s, _ = x.shape
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = gemma_rms_norm(linear(p.q_proj, x).view(b, s, h, d), p.q_norm.weight, cfg.rms_norm_eps)
    k = gemma_rms_norm(linear(p.k_proj, x).view(b, s, kv, d), p.k_norm.weight, cfg.rms_norm_eps)
    v = linear(p.v_proj, x).view(b, s, kv, d)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q, k = apply_rotary_pos_emb(q, k, cos, sin)
    if h > kv:
        k = k.repeat_interleave(h // kv, dim=1)
        v = v.repeat_interleave(h // kv, dim=1)
    out = sdpa(q, k, v, mask=mask, scale=d ** -0.5)
    return linear(p.o_proj, out.transpose(1, 2).reshape(b, s, h * d))


def _layer(p: GemmaLayer, cfg: Gemma3Config, x: torch.Tensor, mask: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One decoder layer with its 4 norms."""
    eps = cfg.rms_norm_eps
    h = _attention(p.self_attn, cfg, gemma_rms_norm(x, p.input_layernorm.weight, eps), mask, cos, sin)
    x = x + gemma_rms_norm(h, p.post_attention_layernorm.weight, eps)
    mlp = p.mlp
    h = gemma_rms_norm(x, p.pre_feedforward_layernorm.weight, eps)
    h = linear(mlp.down_proj, silu_mul(linear(mlp.gate_proj, h), linear(mlp.up_proj, h)))
    return x + gemma_rms_norm(h, p.post_feedforward_layernorm.weight, eps)


def _build_masks(cfg: Gemma3Config, attention_mask: Optional[torch.Tensor], seq_len: int, dtype: torch.dtype,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full, sliding) additive masks, (B|1, 1, S, S): causal AND padding
    [AND window] as booleans, lowered once to 0 / -0.7 * finfo(dtype).max.
    attention_mask None means no padding, not no mask: Gemma is causal."""
    idx = torch.arange(seq_len, device=device)
    row, col = idx[:, None], idx[None, :]
    full_bool = (col <= row)[None, None]
    if attention_mask is not None:
        full_bool = full_bool & attention_mask.to(device=device).bool()[:, None, None, :]
    sliding_bool = full_bool & ((row - col) < cfg.sliding_window)[None, None]
    neg = torch.tensor(-0.7 * torch.finfo(dtype).max, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(full_bool, zero, neg), torch.where(sliding_bool, zero, neg)


@torch.no_grad()
def gemma3_apply(model: Gemma3, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) token ids -> (final normed state (B, S, D), all hidden states
    (L + 1, B, S, D)): the input of every layer, then the final state.

    Positions are arange(S), also under left padding (the JAX package's and
    the reference's choice)."""
    cfg = model.cfg
    dtype, device = cfg.dtype, model.embed_tokens.weight.device
    input_ids = input_ids.to(device)
    _, seq_len = input_ids.shape
    position_ids = torch.arange(seq_len, device=device)

    x = F.embedding(input_ids, model.embed_tokens.weight).to(dtype)
    x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype, device=device)  # scaled in the compute dtype
    full_mask, sliding_mask = _build_masks(cfg, attention_mask, seq_len, dtype, device)
    tables = {
        "sliding_attention": rope_tables(position_ids, cfg.head_dim, cfg.sliding_rope_theta,
                                         cfg.sliding_rope_scaling_factor),
        "full_attention": rope_tables(position_ids, cfg.head_dim, cfg.full_rope_theta, cfg.full_rope_scaling_factor),
    }
    hidden = torch.empty((cfg.num_hidden_layers + 1, *x.shape), dtype=dtype, device=device)
    for i, (layer, kind) in enumerate(zip(model.layers, cfg.layer_types)):
        hidden[i] = x
        mask = full_mask if kind == "full_attention" else sliding_mask
        x = _layer(layer, cfg, x, mask, *tables[kind])
    hidden[-1] = gemma_rms_norm(x, model.norm.weight, cfg.rms_norm_eps)
    return hidden[-1], hidden


def quantize_gemma_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Gemma matmul weight -> (E4M3 codes, fp32 0-d scale), as the JAX
    package's Gemma loader computes them: the scale max(amax / 448, 1e-12)
    in float64 on the host, rounded to fp32, and the codes w / scale in
    fp32."""
    a32 = w.to(torch.float32)
    scale = torch.tensor(max(float(a32.abs().amax()) / FP8_MAX, 1e-12), dtype=torch.float32, device=w.device)
    return (a32 / scale).to(FP8_DTYPE), scale


@torch.no_grad()
def gemma_tensor_(model: Gemma3, name: str, t: torch.Tensor, target: torch.dtype, quantize_fp8: bool) -> None:
    """Put tensor `name` into `model` by the loader's policy: with
    `quantize_fp8` every `*proj.weight` becomes E4M3 with its scale and the
    embedding bf16; everything else goes to `target`."""
    if quantize_fp8 and name.endswith("proj.weight"):
        set_fp8_weight_(model.get_submodule(name[: -len(".weight")]), *quantize_gemma_weight(t))
    elif quantize_fp8 and "embed_tokens" in name:
        assign_(model, name, to_dtype(t, torch.bfloat16))
    else:
        assign_(model, name, to_dtype(t, target))


@torch.no_grad()
def quantize_gemma_fp8_(model: Gemma3) -> Gemma3:
    """`load_gemma3_params(quantize_fp8=True)`'s policy applied in place to
    a Gemma already in memory."""
    names = [name for name, _ in model.named_parameters() if name.endswith("proj.weight") or "embed_tokens" in name]
    for name in names:  # by name: each old weight is freed as its replacement lands
        p = model.get_parameter(name)
        gemma_tensor_(model, name, p.detach(), p.dtype, True)
    return model


def _shards(weights_dir: str):
    shards = sorted(Path(weights_dir).glob("model-*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"No safetensors files found in {weights_dir}")
    keys = SafetensorsFile(str(shards[0])).keys()
    # Multimodal Gemma-3 bundles use `language_model.model.*`, text-only
    # checkpoints `model.*`.
    prefix = "language_model.model." if any(k.startswith("language_model.model.") for k in keys) else "model."
    return shards, prefix


def gemma_config_from_checkpoint(weights_dir: str, compute_dtype: str = "float32") -> Gemma3Config:
    """Gemma-3's architecture read off the shards' tensors: vocabulary and
    widths from their shapes, the layer count from their names, every 6th
    layer full attention; window and RoPE as Gemma-3-12B's. For the 12B
    shards this is `Gemma3Config()`."""
    shards, prefix = _shards(weights_dir)
    shapes, layers = {}, set()
    for shard in shards:
        f = SafetensorsFile(str(shard))
        for key in f.keys():
            if key.startswith(prefix):
                shapes[key[len(prefix):]] = f.info(key)[1]
                m = re.match(r"layers\.(\d+)\.", key[len(prefix):])
                if m:
                    layers.add(int(m.group(1)))
    vocab, hidden = shapes["embed_tokens.weight"]
    head_dim = shapes["layers.0.self_attn.q_norm.weight"][0]
    n = max(layers) + 1
    return Gemma3Config(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=shapes["layers.0.mlp.gate_proj.weight"][0],
        num_hidden_layers=n, num_attention_heads=shapes["layers.0.self_attn.q_proj.weight"][0] // head_dim,
        num_key_value_heads=shapes["layers.0.self_attn.k_proj.weight"][0] // head_dim, head_dim=head_dim,
        layer_types=tuple("sliding_attention" if i % 6 != 5 else "full_attention" for i in range(n)),
        compute_dtype=compute_dtype,
    )


@torch.no_grad()
def load_gemma3_params(weights_dir: str, cfg: Optional[Gemma3Config] = None, target_dtype: str = "float32",
                       quantize_fp8: bool = False, device=None) -> Gemma3:
    """Gemma-3 from the HF shards `model-*.safetensors` of `weights_dir`
    (sorted; `language_model.model.*` or `model.*` keys) on `device`
    (default cuda), streamed shard by shard and tensor by tensor: each
    tensor is read, moved to the device and converted there (`gemma_tensor_`).
    `cfg` defaults to `gemma_config_from_checkpoint`."""
    device = resolve_device(device)
    shards, prefix = _shards(weights_dir)
    if cfg is None:
        cfg = gemma_config_from_checkpoint(weights_dir)
    target = getattr(torch, target_dtype)
    model = Gemma3(cfg, device="meta")
    for shard in shards:
        f = SafetensorsFile(str(shard))
        try:
            for key in f.keys():
                if key.startswith(prefix):
                    gemma_tensor_(model, key[len(prefix):], f.get(key).to(device, copy=True), target, quantize_fp8)
        finally:
            f.close()
    require_loaded(model, weights_dir, "Gemma")
    return model


def gemma_to_checkpoint(model: Gemma3, prefix: str = "language_model.model.") -> dict:
    """Gemma's tensors on the CPU under their HF names (one shard's worth;
    split the dict to write several)."""
    return {prefix + name: p.detach().cpu() for name, p in model.named_parameters()}
