"""The video denoise loop (counterpart of ltx2_tpu/pipelines/denoise.py).

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
- the late-block cross-attention scale, and text-KV caching (V1);
- shape-bucketed serving: with `token_mask` (B, T) the padding is masked
  out of self-attention's keys and the model's outputs there are zeroed
  before any guider, so every guider's sums equal the unpadded run's.

Not ported: sequence/pipeline parallelism (a mesh raises).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.components.diffusion_steps import EulerDiffusionStep
from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.perturbations import (
    BatchedPerturbationConfig, PerturbationConfig, create_stg_perturbation,
)
from ltx2_tpu_torch.models.transformer.model import (
    LTXModel, LTXModelConfig, precompute_text_kv, x0_model_apply,
)
from ltx2_tpu_torch.ops.rope import precompute_freqs_cis
from ltx2_tpu_torch.pipelines.common import modality_from_state, post_process_latent
from ltx2_tpu_torch.types import LatentState


@dataclass(frozen=True)
class DenoiseLoopConfig:
    """Static configuration of a video denoise loop."""

    guider: object = CFGGuider(scale=1.0)
    stg_scale: float = 0.0
    stg_blocks: Optional[Tuple[int, ...]] = None
    stg_cutoff: float = 1.0
    # Which stream(s) the STG row perturbs: "video" | "audio" | "both"; on
    # this video-only loop "audio" perturbs nothing (the pipeline refuses it).
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


def make_video_denoise_loop(
    model_cfg: LTXModelConfig,
    loop_cfg: DenoiseLoopConfig,
    mesh=None,
    pipeline_axis: Optional[str] = None,
):
    """Build the video-only denoise loop.

    Returns fn(model, state, sigmas (S+1,), pos_ctx, neg_ctx, token_mask=None)
    -> final LatentState (still padded when `token_mask` is given). neg_ctx
    is read only when CFG is on."""
    if mesh is not None or pipeline_axis is not None:
        raise NotImplementedError("not ported to the PyTorch denoise loop yet: sequence/pipeline parallelism "
                                  "(mesh, pipeline_axis)")
    if loop_cfg.cfg_interval < 1:
        raise ValueError(f"cfg_interval must be >= 1, got {loop_cfg.cfg_interval}")
    reuse_cfg = loop_cfg.need_cfg and loop_cfg.cfg_interval > 1
    # A StatefulAPGGuider returns (denoised, carry) whatever its momentum, so
    # the carry path is chosen by the attribute, not its value.
    stateful = loop_cfg.need_cfg and hasattr(loop_cfg.guider, "momentum")
    if stateful and reuse_cfg:
        raise ValueError("APG momentum (stateful guidance EMA) does not compose with cfg_interval > 1 — the EMA "
                         "needs a fresh uncond every step")
    heun = loop_cfg.sampler == "heun"
    stepper = EulerDiffusionStep()

    @torch.no_grad()
    def loop(model: LTXModel, state: LatentState, sigmas: torch.Tensor, pos_ctx, neg_ctx=None,
             token_mask: Optional[torch.Tensor] = None) -> LatentState:
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
            text_kv = precompute_text_kv(model, context) if loop_cfg.cache_text_kv else None
            tiled_mask = None if token_mask is None else _tile_rows(token_mask, r)
            tiled_denoise_mask, tiled_clean = _tile_rows(mask, r), _tile_rows(clean, r)

            def forward(latent: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
                tiled = LatentState(latent=_tile_rows(latent, r), denoise_mask=tiled_denoise_mask,
                                    positions=positions, clean_latent=tiled_clean)
                modality = modality_from_state(tiled, context, sigma, uniform_timesteps=loop_cfg.uniform_timesteps,
                                               token_mask=tiled_mask)
                out = x0_model_apply(model, modality, video_pe=video_pe, perturbations=perturb,
                                     ca_scales=ca_scales, text_kv=text_kv)
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
                if not loop_cfg.need_cfg:
                    denoised2 = p2
                elif stateful:
                    denoised2, _ = guider.guide(p2, n2, carry)  # the EMA is read, not advanced
                else:
                    denoised2 = guider.guide(p2, n2)
                denoised2 = post_process_latent(denoised2, mask, clean)
                v1 = (latent.float() - denoised) / sigma
                v2 = (predicted.float() - denoised2) / sigma_next
                latent = (latent.float() + 0.5 * (v1 + v2) * (sigma_next - sigma)).to(latent.dtype)
        return state.replace(latent=latent)

    return loop
