"""The ranks' side of the pipeline-parallel parity tests: module-level
functions that `tests.torch_port_util.spawn_ranks` runs in each gloo rank on
the CPU. They import no JAX: each builds the port's modules from the numpy
trees the test hands in, runs one layout and returns numpy results (and
what each rank holds and sent) for the test to hold against the JAX
package's."""

from __future__ import annotations

import numpy as np
import torch

from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.mesh import create_mesh
from ltx2_tpu_torch.parallel.pipeline_parallel import (
    make_pipeline_parallel_forward, resident_blocks, shard_pipeline_params,
)
from tests.torch_port_parallel_workers import _modality, _np, _perturbations, _t


def _mesh(layout):
    data, pipe, seq, tp = layout
    return create_mesh(data=data, pipe=pipe, seq=seq, model=tp)


def pp_forwards(rank, world, tree, cfg_kwargs, cases):
    """x0 of the DiT built from `tree` under each case's layout: (name,
    (data, pipe, seq, model), microbatches, video dict, audio dict or None,
    perturbation spec, ca_scales or None). Returns {name: x0 (or (video,
    audio)), name + "_blocks": the blocks this rank holds, name + "_calls":
    its collectives by operation}."""
    cfg = model.LTXModelConfig(**cfg_kwargs)
    out = {}
    for name, layout, m, video, audio, perturb, ca in cases:
        mesh = _mesh(layout)
        dit = shard_pipeline_params(mesh, dit_from_numpy(tree, cfg))
        kwargs = dict(perturbations=_perturbations(perturb), ca_scales=None if ca is None else _t(ca))
        if audio is not None:
            kwargs["audio"] = _modality(audio)
        collectives.reset_stats()
        res = make_pipeline_parallel_forward(mesh, num_microbatches=m)(dit, _modality(video), **kwargs)
        out[name] = tuple(_np(r) for r in res) if isinstance(res, tuple) else _np(res)
        out[name + "_blocks"] = resident_blocks(dit)
        out[name + "_calls"] = dict(collectives.STATS["calls"])
    return out


def pp_loops(rank, world, tree, cfg_kwargs, cases):
    """The port's denoise loops over a pipeline mesh: each case (name, kind
    "video" | "av" | "mm", (data, pipe, seq, model), loop kwargs (with the
    factory's `pipeline_microbatches`), state dicts, sigmas, contexts) ->
    the final latents as numpy, and under name + "_calls" the rank's
    collectives by operation."""
    from ltx2_tpu_torch.components.guiders import CFGGuider
    from ltx2_tpu_torch.pipelines.denoise import (
        DenoiseLoopConfig, MultiModalLoopConfig, make_av_denoise_loop, make_multimodal_av_denoise_loop,
        make_video_denoise_loop,
    )
    from ltx2_tpu_torch.types import LatentState

    cfg = model.LTXModelConfig(**cfg_kwargs)
    out = {}
    for name, kind, layout, opts, states, sigmas, ctxs in cases:
        mesh = _mesh(layout)
        dit = shard_pipeline_params(mesh, dit_from_numpy(tree, cfg))
        opts = dict(opts)
        st = [LatentState(**{k: _t(v) for k, v in s.items()}) for s in states]
        ctxs = [_t(c) for c in ctxs]
        pp = dict(mesh=mesh, pipeline_axis="pipe", pipeline_microbatches=opts.pop("pipeline_microbatches", 0))
        collectives.reset_stats()
        if kind == "mm":
            loop = make_multimodal_av_denoise_loop(cfg, MultiModalLoopConfig(**opts), **pp)
            v, a = loop(dit, st[0], st[1], _t(sigmas), *ctxs)
            out[name] = (_np(v.latent), _np(a.latent))
        else:
            loop_cfg = DenoiseLoopConfig(guider=CFGGuider(opts.pop("cfg_scale", 1.0)),
                                         audio_guider=CFGGuider(opts.pop("audio_cfg_scale", 1.0)), **opts)
            if kind == "video":
                out[name] = _np(make_video_denoise_loop(cfg, loop_cfg, **pp)(dit, st[0], _t(sigmas), *ctxs).latent)
            else:
                v, a = make_av_denoise_loop(cfg, loop_cfg, **pp)(dit, st[0], st[1], _t(sigmas), *ctxs)
                out[name] = (_np(v.latent), _np(a.latent))
        out[name + "_calls"] = dict(collectives.STATS["calls"])
    return out


def _to_torch(x):
    """numpy arrays -> tensors, through lists, tuples and dicts."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    return x


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return _np(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


MESH_LAYOUTS = {"seq": dict(seq=2, model=1), "pipe": dict(pipe=2, model=1), "w": dict(data=2, model=1),
                "tp": dict(model=2)}


def pipeline_call(rank, world, spec):
    """One pipeline call over 2 ranks: spec {"cls": dotted class name,
    "modules": {constructor kwarg: (loader_name of loader/from_numpy, numpy
    tree, config)}, "ctor": other constructor kwargs, "meshes": {constructor kwarg: "seq" | "pipe" | "w",
    or "tp_mesh": "tp" for the DiT made its TP shard},
    "args", "kwargs": the call's (numpy arrays become tensors)} -> the
    call's result as numpy. Under a pipeline mesh the DiT keeps its stage's
    blocks alone."""
    import importlib

    from ltx2_tpu_torch.loader import from_numpy

    module, _, name = spec["cls"].rpartition(".")
    cls = getattr(importlib.import_module(module), name)
    kwargs = {k: getattr(from_numpy, loader)(tree, cfg) for k, (loader, tree, cfg) in spec["modules"].items()}
    kwargs.update(_to_torch(spec.get("ctor", {})))
    for key, layout in spec["meshes"].items():
        kwargs[key] = create_mesh(**MESH_LAYOUTS[layout])
    if "pipeline_mesh" in kwargs:
        shard_pipeline_params(kwargs["pipeline_mesh"], kwargs["transformer"])
    if "tp_mesh" in kwargs:  # the DiT a TP shard; the loops take no mesh
        from ltx2_tpu_torch.parallel.sharding import shard_dit_params

        shard_dit_params(kwargs.pop("tp_mesh"), kwargs["transformer"])
    pipe = cls(**kwargs)
    return _to_numpy(pipe(*_to_torch(spec["args"]), **_to_torch(spec["kwargs"])))


def pipeline_calls(rank, world, specs):
    return [pipeline_call(rank, world, spec) for spec in specs]


def run_jobs(rank, world, jobs):
    """Several of the functions above in one launch: jobs [(key, function
    name, args)] -> {key: result}, so a test module spawns its ranks once."""
    torch.manual_seed(0)
    return {key: globals()[name](rank, world, *args) for key, name, args in jobs}
