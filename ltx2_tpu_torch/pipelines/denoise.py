"""The video and the joint audio-video denoise loops (counterpart of
ltx2_tpu/pipelines/denoise.py).

One DiT forward per step with the guidance passes on the batch axis,
pass-major: [cond x B, uncond x B (CFG), stg x B (STG)], B clips a pass.
RoPE tables (and, with `cache_text_kv`, the blocks' text K/V) are computed
once per generation for each row plan; timesteps per batch row
(`uniform_timesteps`) or per token (mask * sigma: image conditioning); fp32
step math; a Python loop in place of the JAX package's lax.scan. The
options of the JAX package's video loop, each computing what it computes:

- guiders: CFG, CFG*, the variance-rescaled CFG, APG, and the stateful
  (momentum) APG, whose fp32 carry threads through the steps;
- STG: a third row with self-attention skipped in `stg_blocks` (all when
  None), applied while (i + 1) / steps <= `stg_cutoff`; the row runs on
  every step, after the cutoff too, as in the JAX package;
- GE velocity momentum (`ge_gamma`);
- Euler or Heun; Heun's corrector is CFG-only (no STG row) and takes the
  step's delta under guidance reuse. At sigma_next == 0 the step returns
  the denoised sample, and the corrector's forward, whose result the JAX
  package computes and discards there, is not run;
- guidance reuse (`cfg_interval` k > 1): the uncond row runs on steps
  i % k == 0; the others run the cond-only forward and take
  neg = pos - delta, the fp32 delta of the last full step;
- the late-block cross-attention scale, and text-KV caching (V1; a V2
  model modulates its K/V every step, so the loop skips the cache, as the
  JAX loop does);
- shape-bucketed serving: with `token_mask` (B, T) the padding is masked
  out of self-attention's keys and the model's outputs there are zeroed
  before any guider, so every guider's sums equal the unpadded run's.

The joint loop (`make_av_denoise_loop`) runs both streams through one
forward per step with the same row plan: per-stream guiders (`guider` for
the video, `audio_guider` for the audio), STG perturbing the video, the
audio or both streams' self-attention (`stg_mode`; the delta applies only
to the perturbed streams), APG and the stateful APG per stream, guidance
reuse with separate video and audio deltas, Heun on both, GE on the video
stream only, as the JAX loop does.

The multi-modal loop (`make_multimodal_av_denoise_loop`, the two-stage CFG
pipeline's stage 1) guides both streams with the MultiModalGuider's
arithmetic in delta form: rows [cond, uncond (CFG), stg (STG: video
self-attention skipped), mod (modality isolation: both audio<->video
cross-attentions skipped in every block)] x B, pass-major; per stream
pred = cond + (cfg - 1) d_uncond + stg (cond - ptb) + (modality - 1) d_mod,
the fp32 deltas cast to the row's dtype before they are scaled, then the
per-sample std-ratio rescale; steps flagged by `skip_step` take cond
alone. Under guidance reuse (`cfg_interval` k > 1) the uncond and
modality rows run on steps i % k == 0 only and their fp32 deltas, per
stream, carry between; the STG row always runs. Euler steps.

Sequence parallelism (`mesh`, a parallel/mesh.py grid with a `seq` axis,
and with a `model` axis for SP x TP): each forward runs token-split over the
mesh's `sequence_axis` (parallel/sequence_parallel.py: ring attention, the
outputs gathered back whole on every rank), and everything around it
(guidance, steppers, noise) runs on whole tensors, identically on every
rank, as the JAX loops run outside their shard_map. Token counts the axis
does not divide, shape-bucketed serving (`token_mask`) and text-KV caching
under SP x TP are refused with the JAX package's messages.

Pipeline parallelism (`mesh` with a 'pipe' axis and `pipeline_axis`): each
forward runs the block stack GPipe-staged over that axis
(parallel/pipeline_parallel.py), its microbatches
`pipeline_microbatches`, or the row plan's guidance rows when 0; with the
mesh's 'seq', 'model' and 'data' axes it composes with SP, TP and DP.
Guidance reuse (`cfg_interval` > 1) and text-KV caching are refused under
it, with the JAX package's messages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.components.diffusion_steps import EulerDiffusionStep
from ltx2_tpu_torch.components.guiders import CFGGuider, std_ratio_rescale
from ltx2_tpu_torch.components.perturbations import (
    BatchedPerturbationConfig, Perturbation, PerturbationConfig, PerturbationType, create_stg_perturbation,
)
from ltx2_tpu_torch.models.transformer.model import (
    LTXModel, LTXModelConfig, precompute_text_kv, stream_pe, x0_model_apply,
)
from ltx2_tpu_torch.ops.rope import precompute_freqs_cis
from ltx2_tpu_torch.pipelines.common import modality_from_state, post_process_latent
from ltx2_tpu_torch.types import LatentState


@dataclass(frozen=True)
class DenoiseLoopConfig:
    """Static configuration of a video denoise loop."""

    guider: object = CFGGuider(scale=1.0)
    audio_guider: object = CFGGuider(scale=1.0)  # the joint loop's audio stream
    stg_scale: float = 0.0
    stg_blocks: Optional[Tuple[int, ...]] = None
    stg_cutoff: float = 1.0
    # Which stream(s) the STG row perturbs: "video" | "audio" | "both"; on
    # the video-only loop "audio" perturbs nothing (the pipeline refuses it).
    stg_mode: str = "video"
    ge_gamma: float = 0.0
    sampler: str = "euler"  # "euler" | "heun"
    cross_attn_scale: float = 1.0
    cross_attn_start_block: int = 40
    cache_text_kv: bool = False
    # A promise that the denoise mask is all ones: per-row timesteps.
    uniform_timesteps: bool = False
    cfg_interval: int = 1

    @property
    def need_cfg(self) -> bool:
        return self.guider.enabled()

    @property
    def need_stg(self) -> bool:
        return self.stg_scale != 0.0

    @property
    def rows(self) -> int:
        return 1 + int(self.need_cfg) + int(self.need_stg)


def _build_perturbations(loop_cfg: DenoiseLoopConfig, rows: int, batch: int = 1
                         ) -> Optional[BatchedPerturbationConfig]:
    """Per-row perturbation config: only the STG pass's `batch` rows, the
    last pass, skip self-attention."""
    if not loop_cfg.need_stg:
        return None
    stg = create_stg_perturbation(
        skip_video_self_attn=loop_cfg.stg_mode in ("video", "both"),
        blocks=list(loop_cfg.stg_blocks) if loop_cfg.stg_blocks else None,
        skip_audio_self_attn=loop_cfg.stg_mode in ("audio", "both"),
    )
    plain = [PerturbationConfig.empty()] * ((rows - 1) * batch)
    return BatchedPerturbationConfig(perturbations=tuple(plain + [stg] * batch))


def _ca_scales(loop_cfg: DenoiseLoopConfig, num_layers: int, device=None) -> Optional[torch.Tensor]:
    """(L,) fp32 scales of the text cross-attention output: 1 before
    `cross_attn_start_block`, `cross_attn_scale` from it on; None at 1."""
    if loop_cfg.cross_attn_scale == 1.0:
        return None
    scales = torch.ones(num_layers, dtype=torch.float32)
    scales[loop_cfg.cross_attn_start_block:] = loop_cfg.cross_attn_scale
    return scales.to(device)


def _tile_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([x] * rows, dim=0) if rows > 1 else x


def _precompute_video_pe(model_cfg: LTXModelConfig, positions: torch.Tensor, rows: int):
    """RoPE tables once per generation, for every guidance row."""
    return precompute_freqs_cis(
        _tile_rows(positions, rows),
        dim=model_cfg.video_inner_dim,
        theta=model_cfg.positional_embedding_theta,
        max_pos=list(model_cfg.positional_embedding_max_pos),
        use_middle_indices_grid=model_cfg.use_middle_indices_grid,
        num_attention_heads=model_cfg.num_attention_heads,
    )


def _split_rows(outs: torch.Tensor, batch: int, with_cfg: bool, need_stg: bool):
    """Pass-major rows -> (pos, neg, perturbed); absent rows None."""
    pos = outs[0:batch]
    neg = outs[batch:2 * batch] if with_cfg else None
    off = (1 + int(with_cfg)) * batch
    perturbed = outs[off:off + batch] if need_stg else None
    return pos, neg, perturbed


def _stack_guidance_ctx(pos: torch.Tensor, neg: Optional[torch.Tensor], with_cfg: bool, need_stg: bool
                        ) -> torch.Tensor:
    """The passes' text contexts in _split_rows' order (STG takes pos)."""
    ctxs = [pos]
    if with_cfg:
        ctxs.append(neg)
    if need_stg:
        ctxs.append(pos)
    return torch.cat(ctxs, dim=0) if len(ctxs) > 1 else pos


def _combine_rows(loop_cfg: DenoiseLoopConfig, guider, pos, neg, perturbed, stg_flag: float):
    """The guided prediction from split rows: the guider on (pos, neg),
    then stg_flag * stg_scale * (denoised - perturbed)."""
    denoised = guider.guide(pos, neg) if loop_cfg.need_cfg else pos
    if loop_cfg.need_stg:
        denoised = denoised + stg_flag * (loop_cfg.stg_scale * (denoised - perturbed))
    return denoised


def _combine_rows_stateful(loop_cfg: DenoiseLoopConfig, guider, pos, neg, perturbed, stg_flag: float, ema):
    """_combine_rows for a guider that may carry state: with a `momentum`
    attribute the guidance EMA goes in and comes out; else it passes through."""
    if hasattr(guider, "momentum"):
        denoised, ema = guider.guide(pos, neg, ema)
        denoised = denoised.to(pos.dtype)
        if loop_cfg.need_stg:
            denoised = denoised + stg_flag * (loop_cfg.stg_scale * (denoised - perturbed))
        return denoised, ema
    return _combine_rows(loop_cfg, guider, pos, neg, perturbed, stg_flag), ema


def _stg_step_flags(num_steps: int, cutoff: float) -> Tuple[np.ndarray, np.ndarray]:
    """(step ids, STG flags): flag 1 while (i + 1) / num_steps <= cutoff, in
    float32 as the JAX package compares them."""
    step_ids = np.arange(num_steps)
    flags = ((step_ids + 1).astype(np.float32) / np.float32(num_steps) <= np.float32(cutoff)).astype(np.float32)
    return step_ids, flags


def _ge_correct(loop_cfg: DenoiseLoopConfig, latent, denoised, sigma, prev_velocity, step_idx: int):
    """GE velocity momentum: from the second step on, the denoised sample
    whose velocity is prev + ge_gamma * (current - prev). Returns
    (denoised, current velocity)."""
    if loop_cfg.ge_gamma <= 0:
        return denoised, prev_velocity
    current_velocity = (latent - denoised) / sigma
    total_velocity = loop_cfg.ge_gamma * (current_velocity - prev_velocity) + prev_velocity
    if step_idx > 0:
        denoised = latent - total_velocity * sigma
    return denoised, current_velocity


def mesh_loop_kwargs(sequence_mesh=None, pipeline_mesh=None) -> dict:
    """The loop factories' kwargs for a multi-rank mode: sequence_mesh ->
    token sharding (ring attention); pipeline_mesh -> GPipe staging over
    'pipe'. Mutually exclusive."""
    if pipeline_mesh is not None:
        if sequence_mesh is not None:
            raise ValueError("set sequence_mesh OR pipeline_mesh, not both")
        return {"mesh": pipeline_mesh, "pipeline_axis": "pipe"}
    return {"mesh": sequence_mesh}


def mesh_forward(mesh, sequence_axis: str, pipeline_axis: Optional[str] = None, microbatches: int = 1):
    """x0_model_apply, or under `mesh` the token-split forward over its
    `sequence_axis`, or with `pipeline_axis` the GPipe-staged forward over
    it in `microbatches` microbatches of the whole batch (of each data
    shard's local rows max(1, microbatches // data ranks), as the JAX
    package's `_make_pp_forward` takes them)."""
    if mesh is None:
        return x0_model_apply
    if pipeline_axis is not None:
        from ltx2_tpu_torch.parallel.pipeline_parallel import make_pipeline_parallel_forward

        local = max(1, microbatches // mesh.axis("data").size)
        return make_pipeline_parallel_forward(mesh, num_microbatches=local, axis=pipeline_axis)
    from ltx2_tpu_torch.parallel.sequence_parallel import make_sequence_parallel_forward

    return make_sequence_parallel_forward(mesh, axis=sequence_axis)


PP_REUSE_MESSAGE = ("cfg_interval > 1 does not compose with pipeline parallelism: the GPipe microbatch schedule is "
                    "built from the guidance rows, which differ between recompute and reuse steps")


def _check_mesh_tokens(mesh, sequence_axis: str, token_mask, *states_and_names) -> None:
    """The JAX loops' refusals under a mesh: a token mask, and a token count
    the sequence axis does not divide."""
    if mesh is None:
        return
    if token_mask is not None:
        raise NotImplementedError("shape-bucketed serving (token_mask) does not compose with SP/PP meshes — pad "
                                  "to a multiple of the mesh axis instead")
    from ltx2_tpu_torch.parallel.sequence_parallel import check_seq_divisible

    for state, what in states_and_names:
        check_seq_divisible(state.latent.shape[1], mesh.axis(sequence_axis), what)


def _check_loop(loop_cfg: DenoiseLoopConfig, mesh, pipeline_axis, stateful: bool) -> bool:
    """The JAX loops' refusals; returns whether guidance is reused."""
    if loop_cfg.cfg_interval < 1:
        raise ValueError(f"cfg_interval must be >= 1, got {loop_cfg.cfg_interval}")
    reuse_cfg = loop_cfg.need_cfg and loop_cfg.cfg_interval > 1
    if reuse_cfg and pipeline_axis is not None:
        raise NotImplementedError(PP_REUSE_MESSAGE)
    if stateful and reuse_cfg:
        raise ValueError("APG momentum (stateful guidance EMA) does not compose with cfg_interval > 1 — the EMA "
                         "needs a fresh uncond every step")
    return reuse_cfg


def _guide_corrector(loop_cfg: DenoiseLoopConfig, guider, pos, neg, ema):
    """Heun's corrector guidance: CFG only; a stateful guider reads the
    step's EMA without advancing it."""
    if not loop_cfg.need_cfg:
        return pos
    if hasattr(guider, "momentum"):
        return guider.guide(pos, neg, ema)[0]
    return guider.guide(pos, neg)


def _heun(latent, denoised, predicted, denoised2, sigma, sigma_next):
    v1 = (latent.float() - denoised) / sigma
    v2 = (predicted.float() - denoised2) / sigma_next
    return (latent.float() + 0.5 * (v1 + v2) * (sigma_next - sigma)).to(latent.dtype)


def make_video_denoise_loop(
    model_cfg: LTXModelConfig,
    loop_cfg: DenoiseLoopConfig,
    mesh=None,
    pipeline_axis: Optional[str] = None,
    sequence_axis: str = "seq",
    pipeline_microbatches: int = 0,
):
    """Build the video-only denoise loop.

    Returns fn(model, state, sigmas (S+1,), pos_ctx, neg_ctx, token_mask=None)
    -> final LatentState (still padded when `token_mask` is given). neg_ctx
    is read only when CFG is on. `mesh`: each forward token-split over its
    `sequence_axis`, or with `pipeline_axis` staged over that axis in
    `pipeline_microbatches` microbatches (0: the guidance rows)."""
    # A StatefulAPGGuider returns (denoised, carry) whatever its momentum, so
    # the carry path is chosen by the attribute, not its value.
    stateful = loop_cfg.need_cfg and hasattr(loop_cfg.guider, "momentum")
    reuse_cfg = _check_loop(loop_cfg, mesh, pipeline_axis, stateful)
    heun = loop_cfg.sampler == "heun"
    stepper = EulerDiffusionStep()

    @torch.no_grad()
    def loop(model: LTXModel, state: LatentState, sigmas: torch.Tensor, pos_ctx, neg_ctx=None,
             token_mask: Optional[torch.Tensor] = None) -> LatentState:
        _check_mesh_tokens(mesh, sequence_axis, token_mask, (state, "video"))
        batch, device = state.latent.shape[0], state.latent.device
        mask, clean = state.denoise_mask, state.clean_latent
        ca_scales = _ca_scales(loop_cfg, model_cfg.num_layers, device)

        def build_forward(with_cfg: bool, with_stg: Optional[bool] = None):
            """One DiT forward over a row plan: [cond, uncond if with_cfg,
            stg if with_stg] x batch, with its contexts, RoPE tables,
            perturbations, text K/V and tiled token mask."""
            with_stg = loop_cfg.need_stg if with_stg is None else with_stg
            r = 1 + int(with_cfg) + int(with_stg)
            context = _stack_guidance_ctx(pos_ctx, neg_ctx, with_cfg, with_stg)
            positions = _tile_rows(state.positions, r)
            video_pe = _precompute_video_pe(model_cfg, state.positions, r)
            perturb = _build_perturbations(loop_cfg, r, batch) if with_stg else None
            x0 = mesh_forward(mesh, sequence_axis, pipeline_axis, pipeline_microbatches or r)
            # V2 modulates the text K/V every step: the cache is skipped, as in the JAX loop.
            text_kv = (precompute_text_kv(model, context)
                       if loop_cfg.cache_text_kv and not model_cfg.cross_attention_adaln else None)
            tiled_mask = None if token_mask is None else _tile_rows(token_mask, r)
            tiled_denoise_mask, tiled_clean = _tile_rows(mask, r), _tile_rows(clean, r)

            def forward(latent: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
                tiled = LatentState(latent=_tile_rows(latent, r), denoise_mask=tiled_denoise_mask,
                                    positions=positions, clean_latent=tiled_clean)
                modality = modality_from_state(tiled, context, sigma, uniform_timesteps=loop_cfg.uniform_timesteps,
                                               token_mask=tiled_mask)
                out = x0(model, modality, video_pe=video_pe, perturbations=perturb, ca_scales=ca_scales,
                         text_kv=text_kv)
                if tiled_mask is not None:
                    # The padding is masked out of attention's keys only, so
                    # the model's outputs there are garbage; zeroed, the
                    # guiders' sums over the token axis (CFG*'s projection,
                    # APG's projection and norm) equal the unpadded run's.
                    out = torch.where(tiled_mask[:, :, None], out, torch.zeros((), dtype=out.dtype, device=device))
                return out

            return forward

        forward_full = build_forward(loop_cfg.need_cfg)
        forward_reduced = build_forward(False) if reuse_cfg else None
        # Heun's corrector is CFG-only: STG applies to the first evaluation.
        forward_corr = forward_corr_reduced = None
        if heun:
            forward_corr = build_forward(loop_cfg.need_cfg, with_stg=False) if loop_cfg.need_stg else forward_full
            if reuse_cfg:
                forward_corr_reduced = build_forward(False, with_stg=False) if loop_cfg.need_stg else forward_reduced

        guider = loop_cfg.guider
        sigmas = sigmas.to(device=device, dtype=torch.float32)
        sigma_values = sigmas.tolist()
        num_steps = len(sigma_values) - 1
        _, stg_flags = _stg_step_flags(num_steps, loop_cfg.stg_cutoff)
        latent = state.latent
        prev_velocity = torch.zeros_like(latent, dtype=torch.float32)
        carry = torch.zeros_like(latent, dtype=torch.float32)  # the APG EMA, or the reused delta
        for i in range(num_steps):
            sigma, sigma_next, stg_flag = sigmas[i], sigmas[i + 1], float(stg_flags[i])
            if reuse_cfg and i % loop_cfg.cfg_interval == 0:
                pos, neg, perturbed = _split_rows(forward_full(latent, sigma), batch, True, loop_cfg.need_stg)
                carry = pos.float() - neg.float()
                denoised = _combine_rows(loop_cfg, guider, pos, neg, perturbed, stg_flag)
            elif reuse_cfg:
                pos, _, perturbed = _split_rows(forward_reduced(latent, sigma), batch, False, loop_cfg.need_stg)
                neg = (pos.float() - carry).to(pos.dtype)
                denoised = _combine_rows(loop_cfg, guider, pos, neg, perturbed, stg_flag)
            elif stateful:
                pos, neg, perturbed = _split_rows(forward_full(latent, sigma), batch, True, loop_cfg.need_stg)
                denoised, carry = _combine_rows_stateful(loop_cfg, guider, pos, neg, perturbed, stg_flag, carry)
            else:
                pos, neg, perturbed = _split_rows(forward_full(latent, sigma), batch, loop_cfg.need_cfg,
                                                  loop_cfg.need_stg)
                denoised = _combine_rows(loop_cfg, guider, pos, neg, perturbed, stg_flag)
            denoised, prev_velocity = _ge_correct(loop_cfg, latent, denoised, sigma, prev_velocity, i)
            denoised = post_process_latent(denoised, mask, clean)

            if not heun:
                latent = stepper.step(latent, denoised, sigma, sigma_next)
            elif sigma_values[i + 1] == 0:
                latent = denoised.to(latent.dtype)  # the last step: the denoised sample
            else:
                predicted = stepper.step(latent, denoised, sigma, sigma_next)
                if reuse_cfg:
                    p2, _, _ = _split_rows(forward_corr_reduced(predicted, sigma_next), batch, False, False)
                    n2 = (p2.float() - carry).to(p2.dtype)
                else:
                    p2, n2, _ = _split_rows(forward_corr(predicted, sigma_next), batch, loop_cfg.need_cfg, False)
                denoised2 = _guide_corrector(loop_cfg, guider, p2, n2, carry if stateful else None)
                denoised2 = post_process_latent(denoised2, mask, clean)
                latent = _heun(latent, denoised, predicted, denoised2, sigma, sigma_next)
        return state.replace(latent=latent)

    return loop


def make_av_denoise_loop(
    model_cfg: LTXModelConfig,
    loop_cfg: DenoiseLoopConfig,
    mesh=None,
    pipeline_axis: Optional[str] = None,
    sequence_axis: str = "seq",
    pipeline_microbatches: int = 0,
):
    """Build the joint audio-video denoise loop (an AudioVideo model).

    Returns fn(model, video_state, audio_state, sigmas (S+1,), pos_v, neg_v,
    pos_a, neg_a) -> (video LatentState, audio LatentState). The negative
    contexts are read only when CFG is on. `mesh`: both streams token-split
    over its `sequence_axis` (the cross-modal K/V gathered), or staged as
    the video loop's."""
    stateful = loop_cfg.need_cfg and (hasattr(loop_cfg.guider, "momentum")
                                      or hasattr(loop_cfg.audio_guider, "momentum"))
    reuse_cfg = _check_loop(loop_cfg, mesh, pipeline_axis, stateful)
    heun = loop_cfg.sampler == "heun"
    stepper = EulerDiffusionStep()
    # The STG delta applies to the streams whose attention the row perturbs.
    v_stg_on = 1.0 if loop_cfg.stg_mode in ("video", "both") else 0.0
    a_stg_on = 1.0 if loop_cfg.stg_mode in ("audio", "both") else 0.0

    @torch.no_grad()
    def loop(model: LTXModel, video_state: LatentState, audio_state: LatentState, sigmas: torch.Tensor,
             pos_v, neg_v, pos_a, neg_a) -> Tuple[LatentState, LatentState]:
        _check_mesh_tokens(mesh, sequence_axis, None, (video_state, "video"), (audio_state, "audio"))
        batch, device = video_state.latent.shape[0], video_state.latent.device
        v_mask, v_clean = video_state.denoise_mask, video_state.clean_latent
        a_mask, a_clean = audio_state.denoise_mask, audio_state.clean_latent
        ca_scales = _ca_scales(loop_cfg, model_cfg.num_layers, device)

        def build_forward(with_cfg: bool, with_stg: Optional[bool] = None):
            """One joint forward over a row plan (as the video loop's)."""
            with_stg = loop_cfg.need_stg if with_stg is None else with_stg
            r = 1 + int(with_cfg) + int(with_stg)
            v_ctx = _stack_guidance_ctx(pos_v, neg_v, with_cfg, with_stg)
            a_ctx = _stack_guidance_ctx(pos_a, neg_a, with_cfg, with_stg)
            tiled = [(_tile_rows(s.positions, r), _tile_rows(s.denoise_mask, r), _tile_rows(s.clean_latent, r))
                     for s in (video_state, audio_state)]
            video_pe = _precompute_video_pe(model_cfg, video_state.positions, r)
            audio_pe = stream_pe(model, tiled[1][0], audio=True)
            perturb = _build_perturbations(loop_cfg, r, batch) if with_stg else None
            x0 = mesh_forward(mesh, sequence_axis, pipeline_axis, pipeline_microbatches or r)
            text_kv = (precompute_text_kv(model, v_ctx, a_ctx)
                       if loop_cfg.cache_text_kv and not model_cfg.cross_attention_adaln else None)

            def forward(v_latent: torch.Tensor, a_latent: torch.Tensor, sigma: torch.Tensor):
                mods = [modality_from_state(
                    LatentState(latent=_tile_rows(latent, r), denoise_mask=m, positions=pos, clean_latent=c),
                    ctx, sigma, uniform_timesteps=loop_cfg.uniform_timesteps)
                    for latent, (pos, m, c), ctx in zip((v_latent, a_latent), tiled, (v_ctx, a_ctx))]
                return x0(model, mods[0], video_pe=video_pe, audio=mods[1], audio_pe=audio_pe,
                          perturbations=perturb, ca_scales=ca_scales, text_kv=text_kv)

            return forward

        forward_full = build_forward(loop_cfg.need_cfg)
        forward_reduced = build_forward(False) if reuse_cfg else None
        forward_corr = forward_corr_reduced = None
        if heun:
            forward_corr = build_forward(loop_cfg.need_cfg, with_stg=False) if loop_cfg.need_stg else forward_full
            if reuse_cfg:
                forward_corr_reduced = build_forward(False, with_stg=False) if loop_cfg.need_stg else forward_reduced

        guiders = (loop_cfg.guider, loop_cfg.audio_guider)
        stg_on = (v_stg_on, a_stg_on)
        sigmas = sigmas.to(device=device, dtype=torch.float32)
        sigma_values = sigmas.tolist()
        num_steps = len(sigma_values) - 1
        _, stg_flags = _stg_step_flags(num_steps, loop_cfg.stg_cutoff)
        latents = [video_state.latent, audio_state.latent]
        prev_velocity = torch.zeros_like(latents[0], dtype=torch.float32)
        # Per stream: the APG EMA, or the reused guidance delta.
        carries = [torch.zeros_like(x, dtype=torch.float32) for x in latents]
        masks, cleans = (v_mask, a_mask), (v_clean, a_clean)
        for i in range(num_steps):
            sigma, sigma_next, stg_flag = sigmas[i], sigmas[i + 1], float(stg_flags[i])
            full = not reuse_cfg or i % loop_cfg.cfg_interval == 0
            outs = (forward_full if full else forward_reduced)(latents[0], latents[1], sigma)
            denoised = []
            for s in range(2):
                flag = stg_flag * stg_on[s]
                pos, neg, perturbed = _split_rows(outs[s], batch, loop_cfg.need_cfg and full, loop_cfg.need_stg)
                if reuse_cfg and full:
                    carries[s] = pos.float() - neg.float()
                elif reuse_cfg:
                    neg = (pos.float() - carries[s]).to(pos.dtype)
                if stateful:
                    d, carries[s] = _combine_rows_stateful(loop_cfg, guiders[s], pos, neg, perturbed, flag,
                                                           carries[s])
                else:
                    d = _combine_rows(loop_cfg, guiders[s], pos, neg, perturbed, flag)
                denoised.append(d)
            denoised[0], prev_velocity = _ge_correct(loop_cfg, latents[0], denoised[0], sigma, prev_velocity, i)
            denoised = [post_process_latent(d, masks[s], cleans[s]) for s, d in enumerate(denoised)]

            if not heun:
                latents = [stepper.step(x, d, sigma, sigma_next) for x, d in zip(latents, denoised)]
            elif sigma_values[i + 1] == 0:
                latents = [d.to(x.dtype) for x, d in zip(latents, denoised)]  # the last step: the denoised samples
            else:
                predicted = [stepper.step(x, d, sigma, sigma_next) for x, d in zip(latents, denoised)]
                corr = (forward_corr_reduced if reuse_cfg else forward_corr)(predicted[0], predicted[1], sigma_next)
                new = []
                for s in range(2):
                    p2, n2, _ = _split_rows(corr[s], batch, loop_cfg.need_cfg and not reuse_cfg, False)
                    if reuse_cfg:
                        n2 = (p2.float() - carries[s]).to(p2.dtype)
                    d2 = _guide_corrector(loop_cfg, guiders[s], p2, n2, carries[s] if stateful else None)
                    d2 = post_process_latent(d2, masks[s], cleans[s])
                    new.append(_heun(latents[s], denoised[s], predicted[s], d2, sigma, sigma_next))
                latents = new
        return video_state.replace(latent=latents[0]), audio_state.replace(latent=latents[1])

    return loop


@dataclass(frozen=True)
class MultiModalLoopConfig:
    """Static configuration of the multi-modal AV loop: the
    MultiModalGuiderParams of both streams (CFG + STG + modality isolation,
    the std-ratio rescale, step skipping) and guidance reuse (`cfg_interval`
    k: the uncond and modality rows every k-th step only, their fp32 deltas
    carried between; 1 = exact). `uniform_timesteps` is the promise that
    both denoise masks are all ones (per-row timesteps); the JAX loop
    always runs per token, which computes the same values."""

    video_cfg_scale: float = 3.0
    audio_cfg_scale: float = 7.0
    stg_scale: float = 0.0
    stg_blocks: Optional[Tuple[int, ...]] = None
    rescale_scale: float = 0.0
    modality_scale: float = 3.0
    skip_step: int = 0
    cfg_interval: int = 1
    uniform_timesteps: bool = False

    @property
    def need_cfg(self) -> bool:
        return not math.isclose(self.video_cfg_scale, 1.0) or not math.isclose(self.audio_cfg_scale, 1.0)

    @property
    def need_stg(self) -> bool:
        return not math.isclose(self.stg_scale, 0.0)

    @property
    def need_mod(self) -> bool:
        return not math.isclose(self.modality_scale, 1.0)

    @property
    def rows(self) -> int:
        return 1 + int(self.need_cfg) + int(self.need_stg) + int(self.need_mod)


def _build_mm_perturbations(mm: MultiModalLoopConfig, with_guidance: bool = True, batch: int = 1
                            ) -> Optional[BatchedPerturbationConfig]:
    """Per-row perturbations in _mm_split's order: the STG pass's rows skip
    video self-attention (in `stg_blocks`), the modality pass's rows both
    audio<->video cross-attentions in every block. Without `with_guidance`
    (a reuse step) the uncond and modality rows are absent."""
    if not (mm.need_stg or (mm.need_mod and with_guidance)):
        return None
    rows = [PerturbationConfig.empty()] * batch
    if mm.need_cfg and with_guidance:
        rows += [PerturbationConfig.empty()] * batch
    if mm.need_stg:
        stg = Perturbation(type=PerturbationType.SKIP_VIDEO_SELF_ATTN,
                           blocks=None if mm.stg_blocks is None else tuple(mm.stg_blocks))
        rows += [PerturbationConfig(perturbations=(stg,))] * batch
    if mm.need_mod and with_guidance:
        rows += [PerturbationConfig(perturbations=(Perturbation(type=PerturbationType.SKIP_A2V_CROSS_ATTN),
                                                   Perturbation(type=PerturbationType.SKIP_V2A_CROSS_ATTN)))] * batch
    return BatchedPerturbationConfig(perturbations=tuple(rows))


def _mm_split(mm: MultiModalLoopConfig, outs: torch.Tensor, batch: int = 1, with_guidance: bool = True):
    """Pass-major rows -> (cond, uncond, ptb, mod), absent rows None; without
    `with_guidance` the reduced reuse-step layout (no uncond, no mod)."""
    passes = [True, mm.need_cfg and with_guidance, mm.need_stg, mm.need_mod and with_guidance]
    out, idx = [], 0
    for present in passes:
        out.append(outs[idx * batch:(idx + 1) * batch] if present else None)
        idx += int(present)
    return tuple(out)


def _mm_combine_deltas(mm: MultiModalLoopConfig, cond, d_uncond, ptb, d_mod, cfg_scale: float, skip: bool):
    """MultiModalGuider.calculate in delta form: d_uncond = cond - uncond and
    d_mod = cond - mod (fp32, cast to cond's dtype before they are scaled),
    the STG term from the live perturbed row; cond alone on a skipped step."""
    if skip:
        return cond
    pred = cond
    if mm.need_cfg:
        pred = pred + (cfg_scale - 1.0) * d_uncond.to(cond.dtype)
    if mm.need_stg:
        pred = pred + mm.stg_scale * (cond - ptb)
    if mm.need_mod:
        pred = pred + (mm.modality_scale - 1.0) * d_mod.to(cond.dtype)
    if mm.rescale_scale != 0:
        pred = std_ratio_rescale(pred, cond, mm.rescale_scale)
    return pred


def _mm_combine(mm: MultiModalLoopConfig, outs: torch.Tensor, cfg_scale: float, skip: bool, batch: int = 1):
    """MultiModalGuider.calculate over a full step's rows."""
    cond, uncond, ptb, mod = _mm_split(mm, outs, batch)
    d_uncond = (cond - uncond) if mm.need_cfg else None
    d_mod = (cond - mod) if mm.need_mod else None
    return _mm_combine_deltas(mm, cond, d_uncond, ptb, d_mod, cfg_scale, skip)


def _mm_skip_flags(mm: MultiModalLoopConfig, num_steps: int) -> list:
    """Per step: guidance skipped (cond alone) when skip_step > 0 and
    i % (skip_step + 1) != 0."""
    if mm.skip_step <= 0:
        return [False] * num_steps
    return [i % (mm.skip_step + 1) != 0 for i in range(num_steps)]


def make_multimodal_av_denoise_loop(
    model_cfg: LTXModelConfig,
    mm: MultiModalLoopConfig,
    mesh=None,
    pipeline_axis: Optional[str] = None,
    sequence_axis: str = "seq",
    pipeline_microbatches: int = 0,
):
    """Build the joint AV loop under the multi-modal guider.

    Returns fn(model, video_state, audio_state, sigmas (S+1,), pos_v, neg_v,
    pos_a, neg_a) -> (video LatentState, audio LatentState). The negative
    contexts are read only when CFG is on. `mesh`, `pipeline_axis`: as the
    joint loop's."""
    if mm.cfg_interval < 1:
        raise ValueError(f"cfg_interval must be >= 1, got {mm.cfg_interval}")
    reuse = mm.cfg_interval > 1 and (mm.need_cfg or mm.need_mod)
    if reuse and pipeline_axis is not None:
        raise NotImplementedError(PP_REUSE_MESSAGE)
    stepper = EulerDiffusionStep()
    scales = (mm.video_cfg_scale, mm.audio_cfg_scale)

    @torch.no_grad()
    def loop(model: LTXModel, video_state: LatentState, audio_state: LatentState, sigmas: torch.Tensor,
             pos_v, neg_v, pos_a, neg_a) -> Tuple[LatentState, LatentState]:
        _check_mesh_tokens(mesh, sequence_axis, None, (video_state, "video"), (audio_state, "audio"))
        batch, device = video_state.latent.shape[0], video_state.latent.device
        if audio_state.latent.shape[0] != batch:
            raise ValueError(f"video batch {batch} != audio batch {audio_state.latent.shape[0]}")
        states = (video_state, audio_state)

        def build_forward(with_guidance: bool):
            """One joint forward over [cond, uncond, stg, mod] x batch (the
            uncond and mod rows only `with_guidance`)."""
            r = 1 + int(mm.need_stg) + ((int(mm.need_cfg) + int(mm.need_mod)) if with_guidance else 0)
            perturb = _build_mm_perturbations(mm, with_guidance, batch)
            x0 = mesh_forward(mesh, sequence_axis, pipeline_axis, pipeline_microbatches or r)

            def stack_ctx(pos, neg):
                ctxs = [pos]
                if mm.need_cfg and with_guidance:
                    ctxs.append(neg)
                if mm.need_stg:
                    ctxs.append(pos)
                if mm.need_mod and with_guidance:
                    ctxs.append(pos)
                return torch.cat(ctxs, dim=0) if len(ctxs) > 1 else pos

            ctxs = (stack_ctx(pos_v, neg_v), stack_ctx(pos_a, neg_a))
            tiled = [(_tile_rows(s.positions, r), _tile_rows(s.denoise_mask, r), _tile_rows(s.clean_latent, r))
                     for s in states]
            video_pe = _precompute_video_pe(model_cfg, video_state.positions, r)
            audio_pe = stream_pe(model, tiled[1][0], audio=True)

            def forward(v_latent: torch.Tensor, a_latent: torch.Tensor, sigma: torch.Tensor):
                mods = [modality_from_state(
                    LatentState(latent=_tile_rows(latent, r), denoise_mask=m, positions=pos, clean_latent=c),
                    ctx, sigma, uniform_timesteps=mm.uniform_timesteps)
                    for latent, (pos, m, c), ctx in zip((v_latent, a_latent), tiled, ctxs)]
                return x0(model, mods[0], video_pe=video_pe, audio=mods[1], audio_pe=audio_pe,
                          perturbations=perturb)

            return forward

        forward_full = build_forward(True)
        forward_reduced = build_forward(False) if reuse else None
        sigmas = sigmas.to(device=device, dtype=torch.float32)
        num_steps = sigmas.shape[0] - 1
        skips = _mm_skip_flags(mm, num_steps)
        latents = [video_state.latent, audio_state.latent]
        # Per stream: the fp32 (cond - uncond, cond - mod) deltas of the last full step.
        deltas = [(torch.zeros_like(x, dtype=torch.float32),) * 2 for x in latents]
        for i in range(num_steps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            full = not reuse or i % mm.cfg_interval == 0
            outs = (forward_full if full else forward_reduced)(latents[0], latents[1], sigma)
            new = []
            for s in range(2):
                cond, uncond, ptb, mod = _mm_split(mm, outs[s], batch, with_guidance=full)
                if full:
                    d_uncond = (cond - uncond).float() if mm.need_cfg else deltas[s][0]
                    d_mod = (cond - mod).float() if mm.need_mod else deltas[s][1]
                    if reuse:
                        deltas[s] = (d_uncond, d_mod)
                else:
                    d_uncond, d_mod = deltas[s]
                denoised = _mm_combine_deltas(mm, cond, d_uncond, ptb, d_mod, scales[s], skips[i])
                denoised = post_process_latent(denoised, states[s].denoise_mask, states[s].clean_latent)
                new.append(stepper.step(latents[s], denoised, sigma, sigma_next))
            latents = new
        return video_state.replace(latent=latents[0]), audio_state.replace(latent=latents[1])

    return loop
