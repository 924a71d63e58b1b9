"""Sequence-parallel DiT forward (counterpart of
ltx2_tpu/parallel/sequence_parallel.py).

The DiT is token-parallel almost everywhere: the patchify projection,
AdaLN, the FFN, the norms and the output projection act on each token
alone. The only ops across tokens are self-attention (ring attention), the
audio<->video cross-modal attention (the other stream's K/V all-gathered)
and text cross-attention (its context is whole on every rank: nothing to
do). So each rank takes its 1/n of every per-token tensor of a modality
(`shard_modality`: the latent, the positions, per-token timesteps; the
context, its mask and sigma stay whole), runs the ordinary forward with the
config's `sequence_axis` set, and the outputs are all-gathered back along
the token axis (`pipelines.common.consolidate_latent`), so every rank
holds the whole result and the loop around the forward runs on whole
tensors, as the JAX package's loops do outside their shard_map.

With tensor parallelism too (SP x TP) the model arrives as this rank's TP
shard (parallel/sharding.py::shard_dit_params), its `cfg.tp_axis` set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ltx2_tpu_torch.parallel.mesh import SEQ_AXIS, Axis, Mesh


def _token_slice(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    part = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * part, part)


def check_seq_divisible(tokens: int, axis: Axis, what: str) -> None:
    """The JAX package's refusal of a token count the axis does not divide."""
    n = axis.size
    if tokens % n != 0:
        raise ValueError(
            f"{what} token count {tokens} must be divisible by the '{axis.name}' mesh axis size {n} for sequence "
            f"parallelism (pad frames/resolution up to a multiple of {n}).")


def shard_modality(m, axis: Axis):
    """This rank's token shard of a Modality (the JAX package's
    `modality_specs`): latent (B, T, C) and positions (B, n, T, 2) split on
    T, timesteps too when per token (B, T); context, context mask and sigma
    whole. A token mask (shape-bucketed serving) is refused: pad the token
    count to a multiple of the axis instead."""
    if m.token_mask is not None:
        raise NotImplementedError("shape-bucketed serving (token_mask) does not compose with SP/PP meshes — pad "
                                  "to a multiple of the mesh axis instead")
    return m.replace(
        latent=_token_slice(m.latent, axis, 1),
        positions=_token_slice(m.positions, axis, 2),
        timesteps=m.timesteps if m.timesteps.ndim == 1 else _token_slice(m.timesteps, axis, 1),
    )


def _pe_slice(pe: Optional[Tuple[torch.Tensor, torch.Tensor]], axis: Axis):
    """SPLIT RoPE tables (B, H, T, D/2) cut to this rank's tokens."""
    return None if pe is None else tuple(_token_slice(t, axis, 2) for t in pe)


def make_sequence_parallel_forward(mesh: Mesh, axis: str = SEQ_AXIS):
    """The token-split x0 forward: fn(model, video[, video_pe=...],
    audio=..., audio_pe=..., **options) -> the whole (B, T, C) x0 on every
    rank (the (video, audio) pair with audio), as `x0_model_apply` gives it
    on one device. Each modality's token count must divide the axis size.
    The model's `cfg.tp_axis` says whether it is a TP shard."""
    from ltx2_tpu_torch.models.transformer.model import x0_model_apply
    from ltx2_tpu_torch.pipelines.common import consolidate_latent

    seq = mesh.axis(axis)

    def run(model, video=None, video_pe=None, audio=None, audio_pe=None, **options):
        base = model.cfg
        sp_cfg = dataclasses.replace(base, sequence_axis=seq)
        if options.get("text_kv") is not None and base.tp_axis is not None and base.tp_axis.size > 1:
            raise ValueError("cache_text_kv is incompatible with SP x TP (the cached K/V would need head "
                             "sharding) — drop --cache-text-kv")
        for m, what in ((video, "video"), (audio, "audio")):
            if m is not None:
                check_seq_divisible(m.latent.shape[1], seq, what)
        out = x0_model_apply(
            model, None if video is None else shard_modality(video, seq), _pe_slice(video_pe, seq),
            audio=None if audio is None else shard_modality(audio, seq), audio_pe=_pe_slice(audio_pe, seq),
            cfg=sp_cfg, **options)
        if isinstance(out, tuple):
            return tuple(consolidate_latent(o, seq) for o in out)
        return consolidate_latent(out, seq)

    return run
