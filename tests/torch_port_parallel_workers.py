"""The ranks' side of the scale-out parity tests: module-level functions that
`tests.torch_port_util.spawn_ranks` runs in each gloo rank on the CPU. They
import no JAX: each builds the port's modules from the numpy trees the test
hands in, runs one layout and returns numpy results for the test to hold
against the JAX package's."""

from __future__ import annotations

import numpy as np
import torch

from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, video_decoder_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.mesh import create_mesh
from ltx2_tpu_torch.parallel.ring_attention import RING_ENGAGEMENTS, ring_sdpa
from ltx2_tpu_torch.parallel.sequence_parallel import make_sequence_parallel_forward
from ltx2_tpu_torch.parallel.sharding import shard_dit_params


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().float().numpy()


def ring_and_collectives(rank, world, q, k, v):
    """ring_sdpa over a `world`-rank seq axis, both inners, fp32 and bf16,
    the ring shift and the fp32 all-reduce, and the K/V exchanges counted."""
    mesh = create_mesh(seq=world, model=1)
    axis = mesh.axis("seq")
    out = {}
    for inner in ("dense", "flash"):
        RING_ENGAGEMENTS.clear()
        collectives.reset_stats()
        out[f"fp32_{inner}"] = _np(ring_sdpa(_t(q), _t(k), _t(v), mesh, inner=inner))
        out[f"engaged_{inner}"] = dict(RING_ENGAGEMENTS)
        out[f"ring_calls_{inner}"] = collectives.STATS["calls"].get("ring_shift", 0)
    qb, kb, vb = (_t(x).bfloat16() for x in (q, k, v))
    out["bf16_flash"] = _np(ring_sdpa(qb, kb, vb, mesh))
    shifted = collectives.ring_shift(torch.full((3,), float(rank)), axis, 1)
    out["shift_from"] = float(shifted[0])
    part = torch.arange(4, dtype=torch.float32) * (rank + 1)
    out["all_reduce"] = _np(collectives.all_reduce(part, axis))
    return out


def _modality(d):
    """A port Modality from a dict of numpy arrays (None kept)."""
    return model.Modality(**{k: (None if v is None else _t(v)) for k, v in d.items()})


def _perturbations(spec):
    """(rows, {row: [(type name, blocks)]}) -> BatchedPerturbationConfig or None."""
    if spec is None:
        return None
    from ltx2_tpu_torch.components import perturbations as pert

    rows, by_row = spec
    configs = []
    for r in range(rows):
        items = tuple(pert.Perturbation(type=getattr(pert.PerturbationType, name), blocks=tuple(blocks))
                      for name, blocks in by_row.get(r, []))
        configs.append(pert.PerturbationConfig(perturbations=items) if items else pert.PerturbationConfig.empty())
    return pert.BatchedPerturbationConfig(perturbations=tuple(configs))


def dit_layouts(rank, world, tree, cfg_kwargs, cases):
    """x0 of the DiT built from `tree` under each case's layout: (name, seq,
    model, int8, video dict, audio dict or None, perturbation spec). Returns
    {name: x0 (or (video, audio))} and the ring's engagements."""
    from ltx2_tpu_torch.loader.int8 import quantize_params_int8

    cfg = model.LTXModelConfig(**cfg_kwargs)
    out = {}
    for name, seq, tp, int8, video, audio, perturb in cases:
        dit = dit_from_numpy(tree, cfg)
        if int8:
            quantize_params_int8(dit)
        mesh = create_mesh(seq=seq, model=tp)
        shard_dit_params(mesh, dit)
        kwargs = dict(perturbations=_perturbations(perturb))
        if audio is not None:
            kwargs["audio"] = _modality(audio)
        RING_ENGAGEMENTS.clear()
        if seq > 1:
            res = make_sequence_parallel_forward(mesh)(dit, _modality(video), **kwargs)
        else:
            res = model.x0_model_apply(dit, _modality(video), **kwargs)
        out[name] = tuple(_np(r) for r in res) if isinstance(res, tuple) else _np(res)
        out[name + "_engaged"] = dict(RING_ENGAGEMENTS)
    return out


def tp_norm_check(rank, world, x, weight, eps):
    """rms_norm_tp over a last dim split over a `world`-rank model axis:
    this rank's slice of the normed result, and the local-only norm's."""
    from ltx2_tpu_torch.core import rms_norm
    from ltx2_tpu_torch.models.transformer.attention import rms_norm_tp

    mesh = create_mesh(model=world)
    axis = mesh.axis("model")
    part = x.shape[-1] // world
    xs, ws = _t(x)[..., rank * part:(rank + 1) * part], _t(weight)[rank * part:(rank + 1) * part]
    return {"global": _np(rms_norm_tp(xs, ws, eps, axis)), "local": _np(rms_norm(xs, ws, eps))}


def loops(rank, world, tree, cfg_kwargs, cases):
    """The port's denoise loops over a `world`-rank seq mesh: each case
    (name, kind, loop kwargs, state dicts, sigmas, contexts) -> the final
    latents as numpy."""
    from ltx2_tpu_torch.components.guiders import CFGGuider
    from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_av_denoise_loop, make_video_denoise_loop
    from ltx2_tpu_torch.types import LatentState

    cfg = model.LTXModelConfig(**cfg_kwargs)
    dit = dit_from_numpy(tree, cfg)
    mesh = create_mesh(seq=world, model=1)
    out = {}
    for name, kind, opts, states, sigmas, ctxs in cases:
        guider = CFGGuider(opts.pop("cfg_scale", 1.0))
        audio_guider = CFGGuider(opts.pop("audio_cfg_scale", 1.0))
        loop_cfg = DenoiseLoopConfig(guider=guider, audio_guider=audio_guider, **opts)
        st = [LatentState(**{k: _t(v) for k, v in s.items()}) for s in states]
        ctxs = [_t(c) for c in ctxs]
        RING_ENGAGEMENTS.clear()
        if kind == "video":
            res = make_video_denoise_loop(cfg, loop_cfg, mesh=mesh)(dit, st[0], _t(sigmas), *ctxs)
            out[name] = _np(res.latent)
        else:
            v, a = make_av_denoise_loop(cfg, loop_cfg, mesh=mesh)(dit, st[0], st[1], _t(sigmas), *ctxs)
            out[name] = (_np(v.latent), _np(a.latent))
        out[name + "_engaged"] = dict(RING_ENGAGEMENTS)
    return out


def vae_decodes(rank, world, tree, cfg_kwargs, cases):
    """The decoder built from `tree` under each case: ("w", latent, ranks):
    decode_w_sharded over the first `ranks` ranks; ("tiles", latent, ranks,
    tiling kwargs): the tile-parallel decode_tiled. No decode noise."""
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, video_decoder_apply
    from ltx2_tpu_torch.models.video_vae.tiling import (
        SpatialTilingConfig, TemporalTilingConfig, TilingConfig, decode_tiled, decode_w_sharded,
    )

    cfg = VideoDecoderConfig(**cfg_kwargs)
    decoder = video_decoder_from_numpy(tree, cfg)
    out = {}
    for case in cases:
        name, kind, latent, ranks = case[:4]
        mesh = create_mesh(data=ranks, model=1, ranks=range(ranks))
        if not mesh.member:
            continue
        if kind == "w":
            out[name] = _np(decode_w_sharded(_t(latent), decoder, mesh, timestep=0.05))
        else:
            sp, tmp = case[4]
            tiling = TilingConfig(spatial_config=SpatialTilingConfig(*sp) if sp else None,
                                  temporal_config=TemporalTilingConfig(*tmp) if tmp else None)
            out[name] = _np(decode_tiled(_t(latent), lambda z, timestep=0.05: video_decoder_apply(
                decoder, z, timestep=timestep), tiling, mesh=mesh))
    return out


def run_jobs(rank, world, jobs):
    """Several of the functions above in one launch: jobs [(key, function
    name, args)] -> {key: result}, so a test module spawns its ranks once."""
    return {key: globals()[name](rank, world, *args) for key, name, args in jobs}
