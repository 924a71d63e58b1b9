"""Pipeline-parallel DiT forward: the block stack staged over a mesh's
'pipe' axis (counterpart of ltx2_tpu/parallel/pipeline_parallel.py).

Each of P stages holds L/P contiguous blocks (`stage_layers`); the others'
places in `transformer_blocks` hold an `AbsentBlock`, which has no tensors
(`keep_stage_blocks_`, or the loader's `pipe_axis`), so a rank's resident
DiT is about 1/P of the blocks plus the replicated rest. The batch rows
(the denoise loops' guidance passes x clips) become M microbatches.

The schedule is GPipe over the real microbatches only. The JAX package runs
one program on every device, so each stage computes M + P - 1 ticks, the
bubble ticks on don't-care data, and rotates the last stage's activation
back to stage 0. A process per rank needs neither: stage 0 runs its blocks
on microbatch j and sends the activations to stage 1
(`collectives.send_start`, one point-to-point hop, staged through pinned
host memory under gloo as the ring's exchanges are) while it goes on to
microbatch j + 1; stage s receives microbatch j from stage s - 1
(`recv_start`), runs its blocks and sends on. So the blocks' launches
summed over the ranks are world 1's times the microbatches. The last stage
applies the output head to its activations and sends the x0 to every stage
(`collectives.broadcast`), where the JAX package psums the last stage's
masked output: the same result, half the bytes on the wire, and the
smaller tensor (x0 is out_channels wide, the activation inner_dim).

Preprocessing (patchify, AdaLN tables, RoPE, the cross-modal tables) runs
on every stage, as in the JAX package: it is token-pointwise and small.

Compositions, each as in the JAX package:
- PP x SP: the mesh's 'seq' axis splits the tokens (`shard_modality`); each
  stage's self-attention is ring attention over the stage's seq line; the
  x0 is gathered along the tokens after the broadcast;
- PP x TP: the blocks are the rank's TP shard over the 'model' axis (the
  model's `cfg.tp_axis`), each row-parallel product summed over the stage's
  model line;
- PP x DP: the rows split over the 'data' axis and the schedule runs over
  each shard's local rows; the x0 is gathered along the rows.
Every rank of the mesh returns the whole x0, as the SP forward does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn as nn

from ltx2_tpu_torch.parallel.collectives import all_gather, broadcast, recv_start, send_start
from ltx2_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Axis, Mesh, axis_of


class AbsentBlock(nn.Module):
    """The place of a block another pipeline stage holds: no tensors."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this transformer block lives on another pipeline stage")


def stage_layers(num_layers: int, axis: Optional[Axis]) -> range:
    """The blocks of this rank's stage: L/P contiguous blocks (all of them
    without a pipe axis). Raises when the stages do not divide the blocks,
    as the JAX package does."""
    if axis is None or axis.size == 1:
        return range(num_layers)
    if num_layers % axis.size:
        raise ValueError(f"pipeline stages {axis.size} must divide num_layers {num_layers}")
    per = num_layers // axis.size
    return range(axis.index * per, (axis.index + 1) * per)


def is_resident(block: nn.Module) -> bool:
    return not isinstance(block, AbsentBlock)


def resident_blocks(model: nn.Module) -> List[int]:
    """The indices of the blocks `model` holds."""
    return [i for i, b in enumerate(model.transformer_blocks) if is_resident(b)]


def keep_stage_blocks_(model: nn.Module, axis: Optional[Axis]) -> nn.Module:
    """`model` made this rank's pipeline stage in place: every block outside
    `stage_layers` replaced by an `AbsentBlock` (its tensors released).
    Nothing for an axis of one rank."""
    if axis is None or axis.size == 1:
        return model
    keep = stage_layers(len(model.transformer_blocks), axis)
    for i in range(len(model.transformer_blocks)):
        if i not in keep:
            model.transformer_blocks[i] = AbsentBlock()
    return model


def check_stage_blocks(model: nn.Module, axis: Optional[Axis]) -> range:
    """This rank's blocks, each of which the model must hold."""
    layers = stage_layers(model.cfg.num_layers, axis)
    missing = [i for i in layers if not is_resident(model.transformer_blocks[i])]
    if missing:
        raise ValueError(f"pipeline stage {0 if axis is None else axis.index} needs blocks {missing}, which this "
                         "rank does not hold")
    return layers


def _row_slice(x, start: int, n: int, total: int):
    """Rows [start, start + n) of a tensor whose first dim is the batch
    (`total` rows); a tensor broadcast over the batch (first dim 1 < total)
    and None pass through; tuples slice element by element."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_row_slice(t, start, n, total) for t in x)
    if x.ndim == 0 or x.shape[0] != total or (start == 0 and n == total):
        return x
    return x.narrow(0, start, n)


def _args_rows(args, start: int, n: int):
    """A StreamArgs' rows [start, start + n)."""
    if args is None:
        return None
    total = args.x.shape[0]
    return dataclasses.replace(args, **{f.name: _row_slice(getattr(args, f.name), start, n, total)
                                        for f in dataclasses.fields(args)})


def _modality_rows(m, start: int, n: int):
    if m is None:
        return None
    total = m.latent.shape[0]
    return m.replace(**{k: _row_slice(getattr(m, k), start, n, total)
                        for k in ("latent", "context", "context_mask", "timesteps", "positions", "sigma")})


def _pe_rows(pe, start: int, n: int):
    return None if pe is None else tuple(_row_slice(t, start, n, pe[0].shape[0]) for t in pe)


def _x0(modality, velocity: torch.Tensor) -> torch.Tensor:
    t = modality.timesteps.float()
    t = t[:, None, None] if t.ndim == 1 else t[:, :, None]
    return modality.latent.float() - t * velocity


def make_pipeline_parallel_forward(mesh: Mesh, num_microbatches: int = 2, axis: str = PIPE_AXIS):
    """The pipelined forward: fn(model, video[, video_pe=...], audio=...,
    audio_pe=..., perturbations=..., ca_scales=..., text_kv=None) -> the
    whole fp32 x0 on every rank, as
    `x0_model_apply` gives it on one device: the (video, audio) pair with
    audio on an audio-video model, the audio's on the audio-only model.

    `mesh` has a 'pipe' axis (its stages), and may have 'seq' (PP x SP),
    'model' (PP x TP: the model must be this rank's TP shard, its
    `cfg.tp_axis` set) and 'data' (PP x DP) axes. `num_microbatches` M
    microbatches are drawn from the local rows (each data shard's under
    PP x DP), which M must divide.
    The model must hold this rank's stage's blocks (it may hold more).
    Text-KV caching is refused, as in the JAX package."""
    from ltx2_tpu_torch.models.transformer.model import (
        _block_x, _perturbation_mask_array, _process_output, prepare_av_args,
    )
    from ltx2_tpu_torch.parallel.sequence_parallel import _pe_slice, check_seq_divisible, shard_modality

    pipe = mesh.axis(axis)
    seq, data = axis_of(mesh, SEQ_AXIS), axis_of(mesh, DATA_AXIS)
    local_m = num_microbatches

    def run(model, video=None, video_pe=None, audio=None, audio_pe=None, perturbations=None, ca_scales=None,
            text_kv=None):
        if text_kv is not None:
            raise ValueError("cache_text_kv is incompatible with pipeline_axis")
        cfg = model.cfg
        if audio is not None and not cfg.has_audio:
            raise ValueError("an audio modality needs the audio-video model (model_type AudioVideo)")
        if not cfg.has_video:
            video, video_pe = None, None
        layers = check_stage_blocks(model, pipe)
        first = video if video is not None else audio
        batch = first.latent.shape[0]
        row0, rows = 0, batch
        if data is not None:
            if batch % data.size:
                raise ValueError(f"batch {batch} must divide the '{data.name}' mesh axis size {data.size}")
            rows = batch // data.size
            row0 = data.index * rows
            video, audio = _modality_rows(video, row0, rows), _modality_rows(audio, row0, rows)
            video_pe, audio_pe = _pe_rows(video_pe, row0, rows), _pe_rows(audio_pe, row0, rows)
        if rows % local_m:
            raise ValueError(f"num_microbatches {local_m} must divide batch {rows}")
        mb = rows // local_m
        run_cfg = cfg
        if seq is not None:
            for m, what in ((video, "video"), (audio, "audio")):
                if m is not None:
                    check_seq_divisible(m.latent.shape[1], seq, what)
            video = None if video is None else shard_modality(video, seq)
            audio = None if audio is None else shard_modality(audio, seq)
            video_pe, audio_pe = _pe_slice(video_pe, seq), _pe_slice(audio_pe, seq)
            run_cfg = dataclasses.replace(cfg, sequence_axis=seq)
        args, audio_args = prepare_av_args(model, video, audio, video_pe, audio_pe)
        lead = args if args is not None else audio_args
        masks = None
        if perturbations is not None:
            masks = _perturbation_mask_array(perturbations, cfg.num_layers, batch, lead.x.device)

        def stage(j: int, vx, ax):
            """This stage's blocks on microbatch j's activations."""
            start = j * mb
            v_in, a_in = _args_rows(args, start, mb), _args_rows(audio_args, start, mb)
            for i in layers:
                perturb = None if masks is None else {k: m[i, row0 + start:row0 + start + mb]
                                                      for k, m in masks.items()}
                vx, ax = _block_x(model.transformer_blocks[i], vx, ax, v_in, a_in, run_cfg, perturb,
                                  None if ca_scales is None else ca_scales[i])
            return vx, ax

        last = pipe.index == pipe.size - 1
        sends, outs = [], []
        for j in range(local_m):
            start = j * mb
            streams = [None if a is None else a.x.narrow(0, start, mb) for a in (args, audio_args)]
            if pipe.index > 0:
                got = iter(recv_start([s for s in streams if s is not None], pipe, pipe.index - 1).wait())
                streams = [None if s is None else next(got) for s in streams]
            vx, ax = stage(j, *streams)
            if last:
                outs.append((vx, ax))
            else:
                sends.append(send_start([s for s in (vx, ax) if s is not None], pipe, pipe.index + 1))
        for pending in sends:
            pending.wait()

        results = []
        for s, (a, m, prefix) in enumerate(((args, video, ""), (audio_args, audio, "audio_"))):
            if a is None:
                continue
            if last:
                hidden = torch.cat([o[s] for o in outs], dim=0) if len(outs) > 1 else outs[0][s]
                out = _process_output(getattr(model, f"{prefix}scale_shift_table"), cfg.norm_eps,
                                      getattr(model, f"{prefix}proj_out"), hidden, a.embedded_timestep).float()
                out = _x0(m, out)
            else:
                out = torch.empty((*m.latent.shape[:2], cfg.audio_out_channels if prefix else cfg.out_channels),
                                  dtype=torch.float32, device=m.latent.device)
            out = broadcast(out, pipe, pipe.size - 1)
            out = all_gather(all_gather(out, seq, dim=1), data, dim=0)
            results.append(out)
        return tuple(results) if len(results) == 2 else results[0]

    return run


def shard_pipeline_params(mesh: Mesh, model: nn.Module, axis: str = PIPE_AXIS) -> nn.Module:
    """`model` made this rank's placement on `mesh` in place (the JAX
    package's `shard_pipeline_params`, whose `pp_tp_param_spec` places
    each tensor): with a pipe axis the blocks of its stage kept, the others
    released; with a 'model' axis each kept tensor the TP rules split
    sliced to this rank's part (`shard_model_`), unless the model already
    is that shard."""
    from ltx2_tpu_torch.parallel.sharding import shard_model_

    keep_stage_blocks_(model, axis_of(mesh, axis))
    tp = axis_of(mesh, MODEL_AXIS)
    if tp is not None and model.cfg.tp_axis is not tp:
        shard_model_(model, tp)
    return model
