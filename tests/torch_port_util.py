"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, the port with device="cpu", both in float32.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu_torch.loader.from_numpy import flatten_tree
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.ops import attention

# Relative tolerance of the float32 parity tests: the two packages sum in
# different orders, nothing else differs.
RTOL = 1e-4

# The small DiT of the parity tests: 2 layers, 2 heads x 128, 16 latent
# channels, 256-d text context.
JCFG = jmodel.LTXModelConfig(
    model_type=jmodel.LTXModelType.VideoOnly, num_attention_heads=2, attention_head_dim=128,
    in_channels=16, out_channels=16, num_layers=2, cross_attention_dim=256,
    caption_channels=None, compute_dtype="float32", remat=False,
)
CFG = model.LTXModelConfig(
    num_attention_heads=2, attention_head_dim=128, in_channels=16, out_channels=16,
    num_layers=2, cross_attention_dim=256, compute_dtype="float32",
)


def assert_close(port, ref, rtol: float = RTOL, msg: str = "") -> None:
    """|port - ref| <= rtol * max|ref| elementwise (a relative bound on the
    tensor's scale, so entries near zero do not dominate)."""
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, f"{msg}: shape {a.shape} vs {b.shape}"
    a, b = a.astype(np.float64), b.astype(np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    err = np.abs(a - b).max()
    assert err <= rtol * scale, f"{msg}: max abs err {err:.3e} > {rtol} * {scale:.3e}"


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32) if np.asarray(x).dtype.kind == "f" else np.array(x))


def numpy_tree(tree, seed: int, randomize=("scale_shift_table", "norm", "statistics")):
    """JAX param tree -> numpy tree; leaves whose path names one of
    `randomize` (zero/one-initialised tables, norms, VAE statistics) get
    random values so those code paths are exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, dtype=np.float32)
        name = jax.tree_util.keystr(path)
        if any(r in name for r in randomize):
            if "std_of_means" in name:
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return (rng.standard_normal(x.shape) * 0.3 + (1.0 if "norm" in name else 0.0)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def force_flash_route(monkeypatch) -> dict:
    """Sends every `sdpa` call without a query-dependent mask to the flash
    kernels' route whatever its dtype, the route the card takes for the
    DiT's bf16 attention, so that an fp32 model on the CPU runs the kernels'
    plain versions (forward, and FlashAttention's backward under a gradient)
    in place of `sdpa_plain`. Returns the counts of the calls it sees, by
    "forward" and "backward"."""
    seen = {"forward": 0, "backward": 0}
    fwd, bwd = attention.flash_attention, attention.flash_attention_bwd

    def forward(*args, **kwargs):
        seen["forward"] += 1
        return fwd(*args, **kwargs)

    def backward(*args, **kwargs):
        seen["backward"] += 1
        return bwd(*args, **kwargs)

    monkeypatch.setattr(attention, "attention_route", lambda dtype, t_q, t_k, d, kind:
                        "plain" if kind == "query" else "kernel")
    monkeypatch.setattr(attention, "flash_attention", forward)
    monkeypatch.setattr(attention, "flash_attention_bwd", backward)
    return seen


def bits(x):
    """(dtype name, shape, raw bytes) of a torch tensor or numpy/JAX array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return str(x.dtype).rsplit(".", 1)[-1], tuple(x.shape), x.reshape(-1).view(torch.uint8).numpy()
    a = np.asarray(x)  # (np.ascontiguousarray would make a 0-d array 1-d)
    return a.dtype.name, a.shape, np.ascontiguousarray(a.reshape(-1)).view(np.uint8)


def assert_bitwise(port, ref, msg=""):
    (pd, ps, pb), (rd, rs, rb) = bits(port), bits(ref)
    assert (pd, ps) == (rd, rs), f"{msg}: {pd}{ps} vs {rd}{rs}"
    assert np.array_equal(pb, rb), f"{msg}: bits differ"


def jax_leaves(tree, stacked="transformer_blocks"):
    """A JAX tree -> {port name: numpy leaf}, stacked leaves split per block."""
    out = {}
    for key, a in flatten_tree(tree).items():
        head, _, rest = key.partition(".")
        if head == stacked:
            out.update({f"{stacked}.{i}.{rest}": a[i] for i in range(a.shape[0])})
        else:
            out[key] = a
    return out


def port_leaves(module):
    return dict((*module.named_parameters(), *module.named_buffers()))


def assert_module_matches_tree(module, tree, stacked="transformer_blocks"):
    ref, got = jax_leaves(tree, stacked), port_leaves(module)
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))[:6]
    for name, leaf in got.items():
        assert_bitwise(leaf, ref[name], name)
