"""The ranks' side of tests/test_torch_port_train_dp.py: module-level
functions that `tests.torch_port_util.spawn_ranks` runs in each gloo rank on
the CPU. They import no JAX: each builds the port's DiT from the numpy tree
the test hands in, trains it data-parallel over the world's 'data' axis and
returns numpy results for the test to hold against the JAX package's."""

from __future__ import annotations

import contextlib
import copy
import io

import numpy as np
import torch

from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, trainable_to_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.mesh import axis_of, create_mesh
from ltx2_tpu_torch.training import (
    AdamW, TrainBatch, TrainConfig, make_optimizer, make_train_step, trainable_mask, zero1_opt_state_shardings,
)
from ltx2_tpu_torch.training.checkpoint import load_train_state, save_train_state
from ltx2_tpu_torch.training.lora import lora_trainable_mask


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _data_axis(world):
    return axis_of(create_mesh(data=world, model=1), "data")


def _dit(tree, cfg_kwargs, lora: bool):
    """The DiT from `tree` with its adapters (lora) or every parameter
    trainable, and its trainable parameters."""
    dit = dit_from_numpy(tree, model.LTXModelConfig(**cfg_kwargs))
    if lora:
        lora_trainable_mask(dit)
    else:
        trainable_mask(dit, lambda name: True)
    return dit, [p for p in dit.parameters() if p.requires_grad]


def _step(dit, params, world, job):
    """(optimizer, step) of `job`'s mode over the world's 'data' axis."""
    axis = _data_axis(world)
    tc = TrainConfig(**job["tc"])
    opt = make_optimizer(tc, params)
    layout = None if job["mode"] == "dp" else zero1_opt_state_shardings(params, axis)
    step = make_train_step(dit, opt, tc, accum_steps=job["accum"], data_axis=axis, opt_state_shardings=layout,
                           grad_shardings=layout if job["mode"] == "zero2" else None)
    return opt, step


def train(rank, world, tree, cfg_kwargs, job):
    """`job`: {"mode": "dp" | "zero1" | "zero2", "accum", "lora", "tc"
    (TrainConfig kwargs), "batch" (numpy fields of the whole batch), "draws"
    (per step: sigmas, noise, audio noise or None, for the whole batch),
    "save": a state file to write at the end, or None}. Returns the losses,
    the trainable parameters in the JAX tree's layout, each parameter's
    whole and moment shapes, the gradient shapes and bytes the last update
    read (and the first update's gradients, this rank's slices under
    ZeRO-2), and the bytes by route."""
    dit, params = _dit(tree, cfg_kwargs, job["lora"])
    opt, step = _step(dit, params, world, job)
    names = {id(p): n for n, p in dit.named_parameters()}
    seen = {}
    update = opt.step

    def spy(grads=None, sharded_grads=False):
        seen.setdefault("first_grads", {names[id(p)]: g.numpy().copy() for p, g in zip(params, grads)})
        seen["grad_shapes"] = [tuple(g.shape) for g in grads]
        return update(grads, sharded_grads)

    opt.step = spy
    collectives.reset_stats()
    batch = TrainBatch(**{k: _t(v) for k, v in job["batch"].items()})
    losses = [float(step(batch, None, *map(_t, draws))) for draws in job["draws"]]
    out = {"losses": losses, "params": trainable_to_numpy(dit), "first_grads": seen["first_grads"],
           "moment_bytes": opt.moment_bytes(),
           "grad_bytes": step.stats["grad_bytes"], "bytes": copy.deepcopy(collectives.STATS["bytes"]),
           "layout": {names[id(p)]: (tuple(p.shape), tuple(m.shape), g)
                      for p, m, g in zip(params, opt.mu, seen["grad_shapes"])}}
    if job["save"]:
        save_train_state(job["save"], len(losses), dit, opt)
        out["slices"] = {names[id(p)]: (m.numpy().copy(), v.numpy().copy())
                         for p, m, v in zip(params, opt.mu, opt.nu)}
        # This world reads its own file back into fresh moments, each
        # rank its slices.
        dit2, params2 = _dit(tree, cfg_kwargs, job["lora"])
        opt2, _ = _step(dit2, params2, world, job)
        out["reloaded_step"] = load_train_state(job["save"], dit2, opt2)
        out["reloaded_equal"] = all(torch.equal(a, b) for a, b in zip(opt.mu + opt.nu + opt.params,
                                                                     opt2.mu + opt2.nu + opt2.params))
    return out


def resume(rank, world, tree, cfg_kwargs, job, path):
    """A world-1 state file read at this world under `job`'s ZeRO layout:
    the step it names, and whether each rank's moments are its slices of
    the file's whole ones."""
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile

    dit, params = _dit(tree, cfg_kwargs, job["lora"])
    opt, _ = _step(dit, params, world, job)
    at = load_train_state(path, dit, opt)
    names = {id(p): n for n, p in dit.named_parameters()}
    f = SafetensorsFile(path)
    try:
        equal = all(torch.equal(m, opt.local(i, f.get(f"adam.{kind}.{names[id(p)]}")))
                    for kind, moments in (("mu", opt.mu), ("nu", opt.nu))
                    for i, (p, m) in enumerate(zip(params, moments)))
    finally:
        f.close()
    return {"step": at, "slices_equal": equal, "sharded": sum(d is not None for d in opt.shard_dims)}


def adamw_leaves(rank, world, shapes, grads, tc_kwargs, steps):
    """AdamW over leaves of `shapes` (some with no dim the rule shards)
    under ZeRO-1 (the mean gradient whole) and ZeRO-2 (its slices:
    reduce-scattered, a whole leaf all-reduced), from this rank's
    gradients `grads[rank]` each step: the parameters after `steps`."""
    axis = _data_axis(world)
    out = {}
    for mode in ("zero1", "zero2"):
        params = [torch.linspace(-1.0, 1.0, int(np.prod(s))).reshape(s) for s in shapes]
        opt = AdamW(params, TrainConfig(**tc_kwargs))
        opt.shard_(zero1_opt_state_shardings(params, axis), axis)
        for _ in range(steps):
            local = [_t(g) for g in grads[rank]]
            if mode == "zero1":
                opt.step([collectives.all_reduce(g, axis) / world for g in local])
            else:
                opt.step([(collectives.all_reduce(g, axis) if d is None else
                           collectives.reduce_scatter(g, axis, d)) / world
                          for g, d in zip(local, opt.shard_dims)], sharded_grads=True)
        out[mode] = [p.numpy().copy() for p in params]
    out["dims"] = list(opt.shard_dims)
    return out


def scatter(rank, world, xs):
    """reduce_scatter of this rank's `xs[rank]` along each dim, and the
    bytes it counted."""
    axis = _data_axis(world)
    collectives.reset_stats()
    x = _t(xs[rank])
    out = {f"dim{d}": collectives.reduce_scatter(x, axis, d).numpy() for d in range(x.ndim)}
    out["bf16_dtype"] = str(collectives.reduce_scatter(x.bfloat16(), axis, 0).dtype)
    out["bytes"] = copy.deepcopy(collectives.STATS["bytes"])
    return out


def cli(rank, world, argv):
    """`train.main(argv)` on this rank, its stdout captured and the
    exports it made counted."""
    from ltx2_tpu_torch import train as T

    exports = []
    export = T.export_lora_checkpoint
    T.export_lora_checkpoint = lambda path, model, **kw: (exports.append(path), export(path, model, **kw))
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            res = T.main(argv)
    finally:
        T.export_lora_checkpoint = export
    return {"losses": res["losses"], "exports": exports, "stdout": text.getvalue(), "rank": res["rank"],
            "params": trainable_to_numpy(res["model"]), "moment_bytes": res["moment_bytes"],
            "grad_bytes": res["grad_bytes"]}


def run_jobs(rank, world, jobs):
    """Several of the functions above in one launch: jobs [(key, function
    name, args)] -> {key: result}, so the test module spawns its ranks once."""
    return {key: globals()[name](rank, world, *args) for key, name, args in jobs}
