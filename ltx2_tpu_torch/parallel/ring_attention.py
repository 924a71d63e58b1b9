"""Ring attention: sequence-parallel self-attention over a mesh axis
(counterpart of ltx2_tpu/parallel/ring_attention.py).

Q, K and V are split along the token axis over the `seq` ranks. Each rank
keeps its query shard and sees every K/V shard pass by around the ring
(`collectives.ring_exchange_start`, the next shard in flight while the
current one is attended), accumulating block-online in fp32: running max m,
normaliser l and the unnormalised output, rescaled as each block arrives.
n ranks make n - 1 exchanges: the last block needs none after it.

Each block's (output, l, m) comes from the inner the operands' dtype picks
(bf16: "flash"; fp32: "dense", as `ops.attention.attention_route` sends
fp32 attention to plain torch ops), or the one the caller names:
- "flash": the forward kernel with its softmax residuals,
  `ops.attention.flash_attention_residuals` (K2, the port of
  `_flash_impl_residuals`; its plain version on a CPU tensor), whatever the
  shard's length: the kernel masks ragged tails, so the JAX package's
  Mosaic tiling gate (512 / 1024 / 128) does not apply;
- "dense": `flash_attention_residuals_plain`, the plain contract.

l and m follow the kernel's convention: m the row max of the scaled logits
(-inf for a row with no valid key, read as 0 by `_finite_max`), l the row
sum of exp(s - m). The merge is the JAX package's (`ring_attention.py:83-
91`). `RING_ENGAGEMENTS` counts the blocks each inner computed
("ring_flash", "ring_dense"), so tests on the CPU, where the kernel's
wrapper runs its plain version and counts no launch, can tell which route
ran.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ltx2_tpu_torch.ops.attention import (
    _finite_max, flash_attention_residuals, flash_attention_residuals_plain,
)
from ltx2_tpu_torch.parallel.collectives import all_gather, ring_exchange_start
from ltx2_tpu_torch.parallel.mesh import Axis, Mesh

INNERS = ("flash", "dense")

# Blocks computed by each inner, by key ("ring_flash", "ring_dense").
RING_ENGAGEMENTS: dict = {}


def _block(q, k, v, scale, inner: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    key = "ring_" + inner
    RING_ENGAGEMENTS[key] = RING_ENGAGEMENTS.get(key, 0) + 1
    fn = flash_attention_residuals_plain if inner == "dense" else flash_attention_residuals
    o, l, m = fn(q, k, v, scale)
    return o, l.float(), _finite_max(m.float())


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    scale: Optional[float] = None,
    inner: Optional[str] = None,
) -> torch.Tensor:
    """This rank's attention output (B, H, T_local, D) in q's dtype: its
    queries against the K/V shards of every rank of `axis`, q/k/v (B, H,
    T_local, D), the same T_local on every rank."""
    if inner is None:
        inner = "flash" if q.dtype == torch.bfloat16 else "dense"
    if inner not in INNERS:
        raise ValueError(f"ring attention inner {inner!r} not in {INNERS}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    m = torch.full(q.shape[:-1], float("-inf"), dtype=acc, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=acc, device=q.device)
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    k_blk, v_blk = k.contiguous(), v.contiguous()
    for step in range(axis.size):
        pending = ring_exchange_start([k_blk, v_blk], axis) if step < axis.size - 1 else None
        o_b, l_b, m_b = _block(q, k_blk, v_blk, scale, inner)
        m_new = torch.maximum(m, m_b)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
        l = l * alpha + l_b * beta
        o = o * alpha[..., None] + o_b.to(acc) * (l_b * beta)[..., None]
        m = m_new
        if pending is not None:
            k_blk, v_blk = pending.wait()
    return (o / l[..., None]).to(q.dtype)


def ring_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis_name: str = "seq",
    scale: Optional[float] = None,
    inner: Optional[str] = None,
) -> torch.Tensor:
    """Sequence-parallel SDPA over whole (B, H, T, D) tensors held alike by
    every rank of `mesh`'s `axis_name`: each rank attends its T / n queries
    around the ring, and the outputs are gathered back to (B, H, T, D) on
    every rank. T must divide the axis size."""
    axis = mesh.axis(axis_name)
    n, t = axis.size, q.shape[2]
    if t % n:
        raise ValueError(f"ring_sdpa: {t} tokens do not divide the '{axis_name}' axis size {n}")
    part = t // n

    def local(x):
        return x.narrow(2, axis.index * part, part)

    out = ring_attention_local(local(q), local(k), local(v), axis, scale, inner)
    return all_gather(out, axis, dim=2)
