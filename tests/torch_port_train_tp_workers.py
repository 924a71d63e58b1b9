"""The ranks' side of tests/test_torch_port_train_tp.py: module-level
functions that `tests.torch_port_util.spawn_ranks` runs in each of four gloo
ranks on the CPU. They import no JAX: each builds the port's DiT whole from
the numpy tree the test hands in, makes it this rank's TP shard over the
'model' axis of a (data, model) mesh, trains it there and returns numpy
results (whole tensors gathered over 'model' and 'data' where the test holds
them against the JAX package's, this rank's own slices where it checks the
layout) for the test."""

from __future__ import annotations

import contextlib
import copy
import io

import numpy as np
import torch
import torch.distributed as dist

from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.fsdp import fsdp_dim
from ltx2_tpu_torch.parallel.mesh import Axis, axis_of, create_mesh
from ltx2_tpu_torch.parallel.sharding import gather_tensor, gather_whole, shard_model_, shard_tensor, tp_split_dim
from ltx2_tpu_torch.training import (
    AdamW, TrainBatch, TrainConfig, data_shard_dim, make_optimizer, make_train_step, trainable_mask,
    zero1_opt_state_shardings,
)
from ltx2_tpu_torch.training.checkpoint import load_train_state, save_train_state
from ltx2_tpu_torch.training.lora import lora_trainable_mask


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _axes(tp: int, dp: int):
    """(data axis, model axis) of the (data=dp, model=tp) mesh, each None at
    one rank."""
    mesh = create_mesh(data=dp, model=tp)
    return axis_of(mesh, "data"), axis_of(mesh, "model")


def _dit(tree, cfg_kwargs, lora: bool, tp_axis):
    """The DiT from `tree` with its adapters (lora) or every parameter
    trainable, made this rank's TP shard; (dit, trainable parameters, their
    names)."""
    dit = dit_from_numpy(tree, model.LTXModelConfig(**cfg_kwargs))
    if lora:
        lora_trainable_mask(dit)
    else:
        trainable_mask(dit, lambda name: True)
    shard_model_(dit, tp_axis)
    named = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    return dit, [p for _, p in named], [n for n, _ in named]


def _step(dit, params, names, axes, job):
    """(optimizer, step) of `job`'s mode on the (data, model) axes."""
    data_axis, tp_axis = axes
    tc = TrainConfig(**job["tc"])
    opt = make_optimizer(tc, params)
    layout = None
    if job["mode"] != "dp":
        layout = zero1_opt_state_shardings(params, data_axis, names if tp_axis is not None else None)
    step = make_train_step(dit, opt, tc, accum_steps=job["accum"], data_axis=data_axis, opt_state_shardings=layout,
                           grad_shardings=layout if job["mode"] == "zero2" else None)
    return opt, step


def _whole(name, x, opt, i, tp_axis, data_sliced: bool):
    """The whole tensor of parameter i's `x` (a slice over 'data' when
    `data_sliced`, over 'model' where the TP rules split it), every rank
    joining the gathers in the same order."""
    if data_sliced and opt.shard_dims[i] is not None:
        x = collectives.all_gather(x, opt.axis, opt.shard_dims[i])
    return gather_tensor(name, x, tp_axis)


def _stacked(named):
    """{dotted name: array} -> the JAX tree's flattened layout, the blocks'
    leaves stacked on a leading layer axis."""
    stacked, flat = {}, {}
    for name, arr in named.items():
        head, _, rest = name.partition(".")
        if head == "transformer_blocks":
            index, _, leaf = rest.partition(".")
            stacked.setdefault(f"transformer_blocks.{leaf}", []).append((int(index), arr))
        else:
            flat[name] = arr
    for key, items in stacked.items():
        flat[key] = np.stack([a for _, a in sorted(items, key=lambda item: item[0])])
    return flat


def train(rank, world, tree, cfg_kwargs, job):
    """`job`: {"tp", "dp", "mode": "dp" | "zero1" | "zero2", "accum", "lora",
    "tc" (TrainConfig kwargs), "batch" (numpy fields of the whole batch),
    "draws" (per step: sigmas, noise, audio noise or None, for the whole
    batch), "save": a state file to write at the end, or None}. Returns the
    losses; the trained parameters gathered whole in the JAX tree's layout
    and this rank's own slices; the first update's gradients gathered whole;
    each parameter's local, moment and gradient shapes and TP dim; the bytes
    of the moments and the gradients, by operation and by axis; the global
    norm the clip read at the first step."""
    axes = _axes(job["tp"], job["dp"])
    data_axis, tp_axis = axes
    dit, params, names = _dit(tree, cfg_kwargs, job["lora"], tp_axis)
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
    out = {"losses": losses, "moment_bytes": opt.moment_bytes(), "grad_bytes": step.stats["grad_bytes"],
           "bytes": copy.deepcopy(collectives.STATS["bytes"]), "axes": copy.deepcopy(collectives.STATS["axes"]),
           "step_bytes": copy.deepcopy(step.stats["bytes"]), "norm": seen["norm"],
           "local": {n: p.detach().numpy().copy() for n, p in zip(names, params)},
           "layout": {n: (tuple(p.shape), tuple(m.shape), g, tp_split_dim(n))
                      for n, p, m, g in zip(names, params, opt.mu, seen["grad_shapes"])},
           "model_split": list(opt.model_split), "shard_dims": list(opt.shard_dims)}
    zero2 = job["mode"] == "zero2" and data_axis is not None
    out["first_grads"] = {n: _whole(n, g, opt, i, tp_axis, zero2).numpy().copy()
                          for i, (n, g) in enumerate(zip(names, seen["first_grads"]))}
    out["params"] = _stacked({n: gather_tensor(n, p.detach(), tp_axis).numpy().copy()
                              for n, p in zip(names, params)})
    if job["save"]:
        save_train_state(job["save"], len(losses), dit, opt)
        out["moments"] = {n: [_whole(n, m, opt, i, tp_axis, True).numpy().copy() for m in (opt.mu[i], opt.nu[i])]
                          for i, n in enumerate(names)}
        # This layout reads its own file back into fresh moments, each rank
        # its slices.
        dit2, params2, names2 = _dit(tree, cfg_kwargs, job["lora"], tp_axis)
        opt2, _ = _step(dit2, params2, names2, axes, job)
        out["reloaded_step"] = load_train_state(job["save"], dit2, opt2)
        out["reloaded_equal"] = all(torch.equal(a, b) for a, b in zip(opt.mu + opt.nu + opt.params,
                                                                     opt2.mu + opt2.nu + opt2.params))
    return out


def resume(rank, world, tree, cfg_kwargs, job, path):
    """A world-1 state file read under `job`'s layout: the step it names,
    and whether each rank's parameters and moments are its slices (over
    'model', then 'data') of the file's whole ones."""
    from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile

    axes = _axes(job["tp"], job["dp"])
    dit, params, names = _dit(tree, cfg_kwargs, job["lora"], axes[1])
    opt, _ = _step(dit, params, names, axes, job)
    at = load_train_state(path, dit, opt)
    f = SafetensorsFile(path)
    try:
        def mine(key, i, name, data_sliced):
            x = shard_tensor(name, f.get(key), axes[1])
            return opt.local(i, x) if data_sliced else x

        equal = all(torch.equal(p, mine(f"param.{n}", i, n, False)) for i, (n, p) in enumerate(zip(names, params)))
        equal = equal and all(torch.equal(m, mine(f"adam.{kind}.{n}", i, n, True))
                              for kind, moments in (("mu", opt.mu), ("nu", opt.nu))
                              for i, (n, m) in enumerate(zip(names, moments)))
    finally:
        f.close()
    return {"step": at, "slices_equal": equal, "data_sharded": sum(d is not None for d in opt.shard_dims),
            "model_split": sum(opt.model_split)}


def _one_rank_axis(rank, world):
    """A 'model' axis of this rank alone, with a group of its own (every
    rank creates every rank's group, in order)."""
    groups = [dist.new_group([r]) for r in range(world)]
    return Axis("model", 1, 0, (rank,), groups[rank], "gloo")


def collectives_autograd(rank, world, xs, ws, vs):
    """Megatron's pair and the norm's sum: `gradcheck` of each Function on
    float64 over a one-rank axis with a group; on the 2-rank 'model' axis of
    the (data=2, model=2) mesh the input gradients of a column-parallel then
    row-parallel product and of an RMS norm over a split dim, each rank's
    slice of `ws` / `vs` / the input; the same with the old identity
    backward (`collectives.all_reduce` where `copy_to_model` and
    `all_reduce_sum` stand); the backward's bytes by operation."""
    one = _one_rank_axis(rank, world)
    x64 = torch.linspace(-1.0, 1.0, 12, dtype=torch.float64).reshape(3, 4).requires_grad_()
    out = {"gradcheck": {name: bool(torch.autograd.gradcheck(lambda x, f=fn: f.apply(x, one) * x, (x64,)))
                         for name, fn in (("copy_to_model", collectives._CopyToModel),
                                          ("reduce_from_model", collectives._ReduceFromModel),
                                          ("all_reduce_sum", collectives._AllReduceSum))}}
    out["float64_stays"] = str(collectives._AllReduceSum.apply(x64, one).dtype)
    _, axis = _axes(2, 2)
    m = axis.index
    w = _t(ws)  # (hidden, in): column-parallel, split on dim 0
    v = _t(vs)  # (out, hidden): row-parallel, split on dim 1
    h = w.shape[0] // 2
    w_r, v_r = w[m * h:(m + 1) * h], v[:, m * h:(m + 1) * h]

    def mlp(x, new: bool):
        xin = collectives.copy_to_model(x, axis) if new else x
        y = torch.tanh(xin @ w_r.t()) @ v_r.t()
        return (collectives.reduce_from_model(y, axis) if new else collectives.all_reduce(y, axis)).pow(2).sum()

    def norm(x_r, new: bool):
        ss = x_r.pow(2).sum(-1, keepdim=True)
        ss = collectives.all_reduce_sum(ss, axis) if new else collectives.all_reduce(ss, axis)
        return (x_r * torch.rsqrt(ss / (2 * x_r.shape[-1]) + 1e-6) * torch.arange(x_r.numel()).reshape(
            x_r.shape)).sum()

    collectives.reset_stats()
    for key, fn in (("mlp", mlp), ("norm", norm)):
        for new in (True, False):
            x = _t(xs).clone()
            if key == "norm":
                x = x[:, m * (x.shape[1] // 2):(m + 1) * (x.shape[1] // 2)].clone()
            x.requires_grad_()
            fn(x, new).backward()
            out[f"{key}_{'new' if new else 'old'}"] = x.grad.numpy().copy()
    out["bytes"] = copy.deepcopy(collectives.STATS["bytes"])
    return out


def adamw_tp_leaves(rank, world, shapes, tp_dims, grads, tc_kwargs, steps):
    """AdamW over whole leaves of `shapes`, each rank holding its slice of
    those with a TP dim in `tp_dims` over the 'model' axis of a (data=2,
    model=2) mesh, under ZeRO-2 (each gradient of this rank's TP slice
    reduce-scattered over 'data', a leaf without a dim the rule takes
    all-reduced) from this data rank's whole gradients `grads[data index]`:
    the parameters after `steps`, gathered whole, and the 'data' dims."""
    data_axis, tp_axis = _axes(2, 2)

    def mine(x, d):
        if d is None:
            return x
        k = x.shape[d] // 2
        return x.narrow(d, tp_axis.index * k, k).contiguous()

    params = [mine(torch.linspace(-1.0, 1.0, int(np.prod(s))).reshape(s), d) for s, d in zip(shapes, tp_dims)]
    opt = AdamW(params, TrainConfig(**tc_kwargs))
    dims = [data_shard_dim(tuple(p.shape), 2, d) for p, d in zip(params, tp_dims)]
    opt.shard_(dims, data_axis)
    opt.split_over_model_([d is not None for d in tp_dims], tp_axis)
    for _ in range(steps):
        local = [mine(_t(g), d) for g, d in zip(grads[data_axis.index], tp_dims)]
        opt.step([(collectives.all_reduce(g, data_axis) if s is None else
                   collectives.reduce_scatter(g, data_axis, s)) / 2 for g, s in zip(local, opt.shard_dims)],
                 sharded_grads=True)
    whole = []
    for p, d in zip(params, tp_dims):
        whole.append((p if d is None else collectives.all_gather(p.contiguous(), tp_axis, d)).numpy().copy())
    return {"params": whole, "dims": dims}


def cli(rank, world, argv):
    """`train.main(argv)` on this rank, its stdout captured, the exports it
    called and the files it wrote counted."""
    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.loader import export as E
    from ltx2_tpu_torch.training import checkpoint as C
    from ltx2_tpu_torch.training import lora as L

    calls, writes = [], []
    saved = (T.export_lora_checkpoint, T.export_transformer_checkpoint, L.write_safetensors,
             E.write_safetensors_streaming, C.write_safetensors_streaming)
    T.export_lora_checkpoint = lambda path, m, **kw: (calls.append(path), saved[0](path, m, **kw))
    T.export_transformer_checkpoint = lambda path, m, **kw: (calls.append(path), saved[1](path, m, **kw))
    L.write_safetensors = lambda path, *a, **kw: (writes.append(path), saved[2](path, *a, **kw))
    E.write_safetensors_streaming = lambda path, *a, **kw: (writes.append(path), saved[3](path, *a, **kw))
    C.write_safetensors_streaming = lambda path, *a, **kw: (writes.append(path), saved[4](path, *a, **kw))
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            res = T.main(argv)
    finally:
        (T.export_lora_checkpoint, T.export_transformer_checkpoint, L.write_safetensors,
         E.write_safetensors_streaming, C.write_safetensors_streaming) = saved
    dit = res["model"]
    # Whole tensors: over 'data' where FSDP slices them, then over 'model'.
    trained = {n: gather_whole(n, p.detach(), dit, fsdp_dim(p)).float().numpy().copy()
               for n, p in dit.named_parameters() if p.requires_grad}
    return {"losses": res["losses"], "calls": calls, "writes": writes, "stdout": text.getvalue(),
            "rank": res["rank"], "param_bytes": res["param_bytes"], "moment_bytes": res["moment_bytes"],
            "grad_bytes": res["grad_bytes"], "step_bytes": res["step_bytes"], "trained": trained}


def run_jobs(rank, world, jobs):
    """Several of the functions above in one launch: jobs [(key, function
    name, args)] -> {key: result}, so the test module spawns its ranks once."""
    return {key: globals()[name](rank, world, *args) for key, name, args in jobs}
