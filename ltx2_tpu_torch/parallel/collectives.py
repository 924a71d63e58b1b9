"""The collectives the scale-out paths call, over one mesh `Axis`: the
port's counterparts of the `jax.lax` collectives the JAX package calls
inside shard_map.

- `ring_shift` / `ring_exchange_start`: `ppermute` by +1 (or -1) along the
  axis's ring, one `batch_isend_irecv` a call (ring attention's K/V, the
  VAE's W halos);
- `send_start` / `recv_start`: one rank's tensors to one other rank of the
  axis, and their receipt there (the pipeline's activation hop from stage
  s to stage s + 1, where `ppermute` rotates the whole ring);
- `broadcast`: one rank's tensor to every rank of the axis (the last
  pipeline stage's output, where the JAX package psums a masked output);
- `all_gather`: `all_gather(..., tiled=True)` along a tensor dim;
- `all_reduce`: `psum`, `dist.all_reduce` on an fp32 copy (every rank gets
  the same reduced bits from the backend);
- `all_reduce_max`: `pmax`, `dist.all_reduce` with `ReduceOp.MAX`.

Routes, by the world's backend and the tensor's device: "nccl" (CUDA
tensors), "gloo" (CPU tensors, and CUDA tensors in the collectives, which
gloo takes on the card) and "gloo_staged" (the point-to-point exchange of
CUDA tensors under gloo, whose send/recv read host memory only: copied into
pinned host buffers, exchanged there and copied back; how several ranks
share one card). The staging is the named route, chosen before the call,
never a fallback after a failure. Exchanges and gathers move their payload
as its bytes (a uint8 view), so any dtype goes through any backend.
`STATS` counts each rank's bytes sent and received (for an all-reduce the
2(n-1)/n of the payload a ring all-reduce moves each way), in all and by
"operation route", and its calls by operation and by route; `reset_stats`
zeroes it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ltx2_tpu_torch.parallel.mesh import Axis

STATS: Dict = {"bytes_sent": 0, "bytes_received": 0, "bytes": {}, "calls": {}, "routes": {}}


def reset_stats() -> None:
    STATS.update(bytes_sent=0, bytes_received=0, bytes={}, calls={}, routes={})


def route(x: torch.Tensor, axis: Axis, point_to_point: bool = False) -> str:
    """"nccl", "gloo" or "gloo_staged" for an operation on x over `axis`:
    a collective, or with `point_to_point` a send/recv."""
    if axis.backend == "nccl":
        if x.device.type != "cuda":
            raise ValueError(f"nccl collectives take CUDA tensors, got one on {x.device}")
        return "nccl"
    if axis.backend != "gloo":
        raise ValueError(f"collective over {axis!r}: no process group (backend {axis.backend!r})")
    return "gloo_staged" if point_to_point and x.device.type == "cuda" else "gloo"


def _count(op: str, rt: str, sent: int, received: int) -> None:
    STATS["bytes_sent"] += sent
    STATS["bytes_received"] += received
    by = STATS["bytes"].setdefault(f"{op} {rt}", {"sent": 0, "received": 0})
    by["sent"] += sent
    by["received"] += received
    STATS["calls"][op] = STATS["calls"].get(op, 0) + 1
    STATS["routes"][rt] = STATS["routes"].get(rt, 0) + 1


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def _host_buffer(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _wire(x: torch.Tensor, rt: str) -> torch.Tensor:
    """x's bytes where the backend reads them: pinned host memory on the
    staged route, else x's own (contiguous) storage."""
    data = _as_bytes(x)
    if rt != "gloo_staged":
        return data
    buf = _host_buffer(data.numel())
    buf.copy_(data)
    return buf


def _unwire(data: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bytes back into a tensor of `like`'s shape, dtype and device."""
    out = data.view(like.dtype).reshape(like.shape)
    return out.to(like.device) if out.device != like.device else out


class Pending:
    """Exchanges in flight: `wait()` returns the received tensors (none
    for sends alone). The buffers sent are held until then."""

    def __init__(self, works, received: List[torch.Tensor], like: Sequence[torch.Tensor], sent=()):
        self._works, self._received, self._like, self._sent = works, received, like, sent

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        return [_unwire(r, x) for r, x in zip(self._received, self._like)]


def ring_exchange_start(tensors: Sequence[torch.Tensor], axis: Axis, shift: int = 1) -> Pending:
    """Start sending each tensor to the rank `shift` places on along the
    axis's ring and receiving the same tensors' counterparts from the rank
    `shift` places back (`ppermute` by `shift`): one batch_isend_irecv for
    all of them. The tensors must have the same shapes on every rank."""
    if axis.size == 1:
        return Pending([], [_as_bytes(x) for x in tensors], tensors)
    dst, src = axis.rank_at(shift), axis.rank_at(-shift)
    ops, received = [], []
    for x in tensors:
        rt = route(x, axis, point_to_point=True)
        send = _wire(x, rt)
        recv = _host_buffer(send.numel()) if rt == "gloo_staged" else torch.empty_like(send)
        ops += [dist.P2POp(dist.isend, send, dst, axis.group), dist.P2POp(dist.irecv, recv, src, axis.group)]
        received.append(recv)
        _count("ring_shift", rt, send.numel(), recv.numel())
    return Pending(dist.batch_isend_irecv(ops), received, tensors)


def ring_shift(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """What the rank `shift` places back along the ring sent (x goes to
    the rank `shift` places on)."""
    return ring_exchange_start([x], axis, shift).wait()[0]


def send_start(tensors: Sequence[torch.Tensor], axis: Axis, index: int) -> Pending:
    """Start sending each tensor to the rank at `index` along the axis (one
    batch_isend_irecv); its `wait()` returns [] once they are gone. The
    receiver posts `recv_start` with tensors of the same shapes and dtypes."""
    dst = axis.ranks[index]
    ops, sent = [], []
    for x in tensors:
        rt = route(x, axis, point_to_point=True)
        send = _wire(x, rt)
        ops.append(dist.P2POp(dist.isend, send, dst, axis.group))
        sent.append(send)
        _count("send", rt, send.numel(), 0)
    return Pending(dist.batch_isend_irecv(ops) if ops else [], [], [], sent)


def recv_start(like: Sequence[torch.Tensor], axis: Axis, index: int) -> Pending:
    """Start receiving, from the rank at `index` along the axis, tensors of
    `like`'s shapes, dtypes and devices (their values are not read); `wait()`
    returns them."""
    src = axis.ranks[index]
    ops, received = [], []
    for x in like:
        rt = route(x, axis, point_to_point=True)
        nbytes = x.numel() * x.element_size()
        recv = _host_buffer(nbytes) if rt == "gloo_staged" else torch.empty(nbytes, dtype=torch.uint8,
                                                                             device=x.device)
        ops.append(dist.P2POp(dist.irecv, recv, src, axis.group))
        received.append(recv)
        _count("recv", rt, 0, nbytes)
    return Pending(dist.batch_isend_irecv(ops) if ops else [], received, like)


def broadcast(x: torch.Tensor, axis: Optional[Axis], index: int) -> torch.Tensor:
    """The tensor of the rank at `index` along the axis, on every rank of
    it (each other rank passes a tensor of the same shape and dtype, whose
    values are not read). The source sends its bytes once to each other
    rank; each other rank receives them once. Axis None or of size 1: x."""
    if axis is None or axis.size == 1:
        return x
    rt = route(x, axis)
    source = axis.index == index
    data = _as_bytes(x) if source else torch.empty(x.numel() * x.element_size(), dtype=torch.uint8,
                                                   device=x.device)
    dist.broadcast(data, src=axis.ranks[index], group=axis.group)
    n = data.numel()
    _count("broadcast", rt, n * (axis.size - 1) if source else 0, 0 if source else n)
    return _unwire(data, x)


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int) -> torch.Tensor:
    """Every rank's x along the axis, concatenated along `dim` in axis order
    (`jax.lax.all_gather(..., tiled=True)`). Shapes must agree on every
    rank. Axis None or of size 1: x."""
    if axis is None or axis.size == 1:
        return x
    rt = route(x, axis)
    send = _as_bytes(x)
    parts = [torch.empty_like(send) for _ in range(axis.size)]
    dist.all_gather(parts, send, group=axis.group)
    _count("all_gather", rt, send.numel() * (axis.size - 1), send.numel() * (axis.size - 1))
    return torch.cat([_unwire(p, x) for p in parts], dim=dim)


def _reduce(x: torch.Tensor, axis: Axis, dtype: torch.dtype, op, name: str) -> torch.Tensor:
    out = x.to(dtype, memory_format=torch.contiguous_format, copy=True)
    rt = route(out, axis)
    dist.all_reduce(out, op=op, group=axis.group)
    moved = 2 * (axis.size - 1) * out.numel() * out.element_size() // axis.size
    _count(name, rt, moved, moved)
    return out


def all_reduce(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum over the axis's ranks in fp32 (float64 stays float64), the
    same bits on every rank (`psum`). Axis None or of size 1: x in that
    dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    if axis is None or axis.size == 1:
        return x.to(acc)
    return _reduce(x, axis, acc, dist.ReduceOp.SUM, "all_reduce")


def all_reduce_max(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The elementwise max over the axis's ranks (`pmax`), in x's dtype
    (taken in fp32 or wider, which holds every bf16 and fp16 value)."""
    if axis is None or axis.size == 1:
        return x
    acc = torch.promote_types(x.dtype, torch.float32)
    return _reduce(x, axis, acc, dist.ReduceOp.MAX, "all_reduce_max").to(x.dtype)
