"""The process-per-rank runtime (counterpart of ltx2_tpu/parallel/runtime.py).

The JAX package wires hosts together under one controller
(`jax.distributed.initialize`). The port runs one process per rank, as
`torchrun` launches it: `initialize_distributed` joins this process to the
world (`torch.distributed.init_process_group`) from explicit arguments or
the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), and `rank_device` binds it to `cuda:{local_rank %
device_count}`, so several ranks may share one card.

Backends: "nccl" when each rank has a card of its own, "gloo" when the
caller names it (ranks sharing one card, or the CPU; collectives on CUDA
tensors then stage through pinned host buffers, `parallel/collectives.py`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def launch_env() -> Tuple[int, int, int]:
    """(rank, world size, local rank) from the launcher's environment;
    (0, 1, 0) outside a launch."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    return rank, world, local


def default_backend(device: torch.device, local_world: int) -> str:
    """gloo on the CPU; nccl on the card when every rank of the host has a
    card of its own. Ranks that share a card need the caller to name gloo."""
    if device.type != "cuda":
        return "gloo"
    if torch.cuda.device_count() >= local_world:
        return "nccl"
    raise ValueError(
        f"{local_world} ranks on this host share {torch.cuda.device_count()} card(s): nccl needs a card per "
        f"rank; name the gloo backend to share one")


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout=None,
) -> bool:
    """Join this process to the world; returns whether a process group is
    up. Explicit arguments win over the launcher's environment; a world of
    one rank without explicit arguments is a no-op (single-process run). A
    call with explicit arguments that fails raises, as the JAX package's
    does: a misconfigured launch must not degrade into a silent
    single-process run that hangs at its first collective. Already
    initialised: a no-op. `timeout` (a timedelta) bounds each collective's
    wait (torch's default otherwise)."""
    if dist.is_initialized():
        return True
    env_rank, env_world, env_local = launch_env()
    explicit = init_method is not None or world_size is not None or rank is not None
    world = env_world if world_size is None else world_size
    rank = env_rank if rank is None else rank
    if world <= 1 and not explicit:
        return False
    device = rank_device(env_local, device)
    backend = backend or default_backend(device, int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method or "env://", world_size=world, rank=rank,
                            **kwargs)
    return True


def rank_device(local_rank: Optional[int] = None, device=None) -> torch.device:
    """This rank's device: `device` when the caller names one ("cpu" in the
    tests, or a numbered card), else `cuda:{local_rank % device_count}`; a
    card is set as the current device."""
    if device is not None:
        out = torch.device(device)
        if out.type != "cuda":
            return out
        if out.index is not None:
            torch.cuda.set_device(out)
            return out
    if local_rank is None:
        local_rank = launch_env()[2]
    out = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(out)
    return out


def axis_layout(n_ranks: int, data: int = 1, seq: int = 1, model: Optional[int] = None) -> Tuple[int, int, int]:
    """A (data, seq, model) factorisation of `n_ranks`; model=None takes
    every remaining rank. Raises if the product does not match: axis sizes
    are a deployment decision, not something to guess."""
    if model is None:
        if n_ranks % (data * seq) != 0:
            raise ValueError(f"{n_ranks} ranks not divisible by data*seq = {data * seq}")
        model = n_ranks // (data * seq)
    if data * seq * model != n_ranks:
        raise ValueError(f"mesh {data}x{seq}x{model} != {n_ranks} ranks")
    return data, seq, model


def world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _spawned_rank(fn, rank: int, world: int, directory: str, backend: str, device: str, threads: Optional[int],
                  timeout, args: tuple) -> None:
    """One rank of `spawn_ranks`: the process group through a file in
    `directory`, fn(rank, world, *args) saved as result_<rank>.pt there."""
    if threads is not None:
        torch.set_num_threads(threads)
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    initialize_distributed(init_method=f"file://{os.path.join(directory, 'pg_init')}", world_size=world,
                           rank=rank, backend=backend, device=device, timeout=timeout)
    try:
        torch.save(fn(rank, world, *args), os.path.join(directory, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, directory, *args, backend: str = "gloo", device: str = "cpu",
                threads: Optional[int] = None, timeout: float = 240.0, collective_timeout=None) -> list:
    """Run fn(rank, world, *args) in `world` fresh processes joined over
    `backend` (the process group initialised through a file in `directory`,
    never a fixed port) and return each rank's result in rank order. fn
    must be importable by name (a module-level function). `device`: "cpu",
    or "cuda" for `cuda:{rank % device_count}`; `threads`: each rank's
    intra-op threads (torch's default when None); `collective_timeout` (a
    timedelta) bounds each collective's wait. A rank that fails, or a
    launch past `timeout` seconds (its ranks are then killed), raises."""
    import time

    import torch.multiprocessing as mp

    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):
        if name.startswith("result_") or name == "pg_init":
            os.remove(os.path.join(directory, name))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawned_rank,
                         args=(fn, r, world, directory, backend, device, threads, collective_timeout, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(c != 0 for c in codes):
        raise RuntimeError(f"{world} ranks over {backend}: exit codes {codes}"
                           f"{f' (killed at the {timeout} s limit)' if alive else ''}")
    return [torch.load(os.path.join(directory, f"result_{r}.pt"), weights_only=False) for r in range(world)]
