"""The ranks' side of tests/test_torch_port_train_fsdp.py: module-level
functions that `tests.torch_port_util.spawn_ranks` runs in each of four gloo
ranks on the CPU. They import no JAX: each builds the port's DiT whole from
the numpy tree the test hands in, makes it this rank's TP shard over the
'model' axis of a (data, model) mesh, slices every parameter over 'data'
(ZeRO-3/FSDP), trains it there and returns numpy results (whole tensors
gathered over 'data' and 'model' where the test holds them against the JAX
package's, this rank's own slices where it checks the layout)."""

from __future__ import annotations

import copy

import numpy as np
import torch

from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.fsdp import fsdp_dim, resident_bytes
from ltx2_tpu_torch.parallel.sharding import gather_whole, shard_model_, shard_model_fsdp_, shard_tensor, tp_split_dim
from ltx2_tpu_torch.training import (
    AdamW, TrainBatch, TrainConfig, data_shard_dim, fsdp_param_shardings, make_optimizer, make_train_step,
    trainable_mask, zero2_grad_shardings,
)
from ltx2_tpu_torch.training.checkpoint import load_train_state, save_train_state
from ltx2_tpu_torch.training.lora import lora_trainable_mask
from tests.torch_port_train_tp_workers import _axes, _stacked, _t, cli


def _dit(tree, cfg_kwargs, lora: bool, axes):
    """The DiT from `tree` with its adapters (lora) or every parameter
    trainable, made this rank's TP shard and then sliced over 'data';
    (dit, trainable parameters, their names)."""
    data_axis, tp_axis = axes
    dit = dit_from_numpy(tree, model.LTXModelConfig(**cfg_kwargs))
    if lora:
        lora_trainable_mask(dit)
    else:
        trainable_mask(dit, lambda name: True)
    shard_model_(dit, tp_axis)
    shard_model_fsdp_(dit, data_axis, fsdp_param_shardings(dit, data_axis))
    named = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    return dit, [p for _, p in named], [n for n, _ in named]


def _step(dit, params, names, axes, job):
    """(optimizer, step) under FSDP on the (data, model) axes: the ZeRO
    layouts from the helpers (which pass the slices' dims through)."""
    data_axis, tp_axis = axes
    tc = TrainConfig(**job["tc"])
    opt = make_optimizer(tc, params)
    zero = zero2_grad_shardings(params, data_axis, names if tp_axis is not None else None)
    step = make_train_step(dit, opt, tc, accum_steps=job["accum"], data_axis=data_axis, opt_state_shardings=zero,
                           grad_shardings=zero, param_shardings=fsdp_param_shardings(dit, data_axis, names))
    return opt, step


def _whole(dit, name, x, dim):
    """The whole tensor `name` from this rank's `x`, sliced along `dim` over
    'data' (None: not) and over 'model' by the TP rules."""
    return gather_whole(name, x.detach(), dit, dim).numpy().copy()


def train(rank, world, tree, cfg_kwargs, job):
    """`job`: {"tp", "dp", "accum", "lora", "tc" (TrainConfig kwargs),
    "batch" (numpy fields of the whole batch), "draws" (per step: sigmas,
    noise, audio noise or None, for the whole batch), "save": a state file
    to write at the end, or None}. Returns the losses; the trained
    parameters gathered whole in the JAX tree's layout; every parameter's
    own slice and its gathered whole tensor (frozen ones too); the first
    update's gradients gathered whole; each parameter's layout (local shape,
    moment shape, gradient shape, TP dim, 'data' dim, trainable); the
    resident parameter bytes; the last step's bytes by operation and axis;
    the global norm the clip read at the first step."""
    axes = _axes(job["tp"], job["dp"])
    dit, params, names = _dit(tree, cfg_kwargs, job["lora"], axes)
    opt, step = _step(dit, params, names, axes, job)
    seen = {}
    update, norm = opt.step, opt._global_norm

    def spy(grads=None, sharded_grads=False):
        seen.setdefault("first_grads", [g.clone() for g in grads])
        seen["grad_shapes"] = [tuple(g.shape) for g in grads]
        return update(grads, sharded_grads)

    def spy_norm(grads, sharded_grads):
        out = norm(grads, sharded_grads)
        seen.setdefault("norm", float(out))
        return out

    opt.step, opt._global_norm = spy, spy_norm
    collectives.reset_stats()
    batch = TrainBatch(**{k: _t(v) for k, v in job["batch"].items()})
    losses = [float(step(batch, None, *map(_t, draws))) for draws in job["draws"]]
    trainable = set(names)
    grad_shapes = dict(zip(names, seen["grad_shapes"]))
    moments = dict(zip(names, opt.mu))
    everything = list(dit.named_parameters())
    out = {"losses": losses, "param_bytes": resident_bytes(dit), "moment_bytes": opt.moment_bytes(),
           "grad_bytes": step.stats["grad_bytes"], "op_bytes": copy.deepcopy(step.stats["op_bytes"]),
           "step_bytes": copy.deepcopy(step.stats["bytes"]), "norm": seen["norm"],
           "local": {n: p.detach().numpy().copy() for n, p in everything},
           "gathered": {n: _whole(dit, n, p, fsdp_dim(p)) for n, p in everything},
           "layout": {n: (tuple(p.shape), tuple(moments[n].shape) if n in trainable else None,
                          grad_shapes.get(n), tp_split_dim(n), fsdp_dim(p), n in trainable)
                      for n, p in everything},
           "shard_dims": list(opt.shard_dims), "model_split": list(opt.model_split)}
    out["first_grads"] = {n: _whole(dit, n, g, d) for n, g, d in zip(names, seen["first_grads"], opt.shard_dims)}
    out["params"] = _stacked({n: out["gathered"][n] for n in names})
    if job["save"]:
        save_train_state(job["save"], len(losses), dit, opt)
        out["moments"] = {n: [_whole(dit, n, m, d) for m in (opt.mu[i], opt.nu[i])]
                          for i, (n, d) in enumerate(zip(names, opt.shard_dims))}
        # This layout reads its own file back into fresh slices and moments.
        dit2, params2, names2 = _dit(tree, cfg_kwargs, job["lora"], axes)
        opt2, _ = _step(dit2, params2, names2, axes, job)
        out["reloaded_step"] = load_train_state(job["save"], dit2, opt2)
        out["reloaded_equal"] = all(torch.equal(a, b) for a, b in zip(opt.mu + opt.nu + opt.params,
                                                                     opt2.mu + opt2.nu + opt2.params))
    return out


def resume(rank, world, tree, cfg_kwargs, job, path):
    """A world-1 state file read under `job`'s FSDP layout: the step it
    names, and whether each rank's parameters and moments are its slices
    (over 'model', then 'data') of the file's whole ones."""
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile

    axes = _axes(job["tp"], job["dp"])
    dit, params, names = _dit(tree, cfg_kwargs, job["lora"], axes)
    opt, _ = _step(dit, params, names, axes, job)
    at = load_train_state(path, dit, opt)
    f = SafetensorsFile(path)
    try:
        def mine(key, i, name):
            return opt.local(i, shard_tensor(name, f.get(key), axes[1]))

        equal = all(torch.equal(t, mine(f"{kind}.{n}", i, n))
                    for kind, tensors in (("param", opt.params), ("adam.mu", opt.mu), ("adam.nu", opt.nu))
                    for i, (n, t) in enumerate(zip(names, tensors)))
    finally:
        f.close()
    return {"step": at, "slices_equal": equal, "data_sliced": sum(d is not None for d in opt.shard_dims),
            "model_split": sum(opt.model_split)}


def adamw_fsdp_leaves(rank, world, shapes, tp_dims, grads, tc_kwargs, steps):
    """AdamW over whole leaves of `shapes`, each rank holding its slice of
    those with a TP dim in `tp_dims` over the 'model' axis of a (data=2,
    model=2) mesh and of that its FSDP slice over 'data' where the rule
    finds a dim: the parameters themselves are the slices (ZeRO-3). Each
    gradient of this rank's TP slice is reduce-scattered over 'data' (a
    leaf without a dim all-reduced) from this data rank's whole gradients
    `grads[data index]`, as the gathers' backward gives it. Returns the
    parameters after `steps`, gathered whole, and the 'data' dims."""
    data_axis, tp_axis = _axes(2, 2)

    def mine(x, d, axis):
        if d is None:
            return x
        k = x.shape[d] // 2
        return x.narrow(d, axis.index * k, k).contiguous()

    tp_local = [mine(torch.linspace(-1.0, 1.0, int(np.prod(s))).reshape(s), d, tp_axis)
                for s, d in zip(shapes, tp_dims)]
    dims = [data_shard_dim(tuple(p.shape), 2, d) for p, d in zip(tp_local, tp_dims)]
    params = [mine(p, d, data_axis).clone() for p, d in zip(tp_local, dims)]
    opt = AdamW(params, TrainConfig(**tc_kwargs))
    opt.shard_(dims, data_axis, params_sliced=True)
    opt.split_over_model_([d is not None for d in tp_dims], tp_axis)
    for _ in range(steps):
        local = [mine(_t(g), d, tp_axis) for g, d in zip(grads[data_axis.index], tp_dims)]
        opt.step([(collectives.all_reduce(g, data_axis) if s is None else
                   collectives.reduce_scatter(g, data_axis, s)) / 2 for g, s in zip(local, dims)])
    whole = []
    for p, d, t in zip(params, dims, tp_dims):
        p = p if d is None else collectives.all_gather(p.contiguous(), data_axis, d)
        whole.append((p if t is None else collectives.all_gather(p.contiguous(), tp_axis, t)).numpy().copy())
    return {"params": whole, "dims": dims, "moment_shapes": [tuple(m.shape) for m in opt.mu]}


def run_jobs(rank, world, jobs):
    """Several of the functions above (and the TP file's `cli`) in one
    launch: jobs [(key, function name, args)] -> {key: result}, so the test
    module spawns its ranks once."""
    fns = {"train": train, "resume": resume, "adamw_fsdp_leaves": adamw_fsdp_leaves, "cli": cli}
    return {key: fns[name](rank, world, *args) for key, name, args in jobs}
