"""The video denoise loop (counterpart of ltx2_tpu/pipelines/denoise.py).

One DiT forward per step with the guidance passes on the batch axis (row 0
conditioned, row 1 unconditioned when CFG or CFG* is on), RoPE tables
computed once per generation, timesteps per batch row (`uniform_timesteps`)
or per token (mask * sigma: image conditioning), fp32 Euler steps
(`EulerDiffusionStep`), and a Python loop in place of the JAX package's
lax.scan. Not ported yet (each raises NotImplementedError): STG, Heun, APG
and the other guiders, cfg_interval > 1, GE momentum, the late-block
cross-attention scale, text-KV caching, and sequence/pipeline parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ltx2_tpu_torch.components.diffusion_steps import EulerDiffusionStep
from ltx2_tpu_torch.components.guiders import CFGGuider, CFGStarRescalingGuider
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig, x0_model_apply
from ltx2_tpu_torch.ops.rope import precompute_freqs_cis
from ltx2_tpu_torch.pipelines.common import modality_from_state, post_process_latent
from ltx2_tpu_torch.types import LatentState


@dataclass(frozen=True)
class DenoiseLoopConfig:
    """Static configuration of a denoise loop. Fields other than `guider`
    and `uniform_timesteps` exist to be refused at their non-default values."""

    guider: object = CFGGuider(scale=1.0)
    uniform_timesteps: bool = False
    sampler: str = "euler"
    stg_scale: float = 0.0
    ge_gamma: float = 0.0
    cross_attn_scale: float = 1.0
    cache_text_kv: bool = False
    cfg_interval: int = 1

    @property
    def need_cfg(self) -> bool:
        return self.guider.enabled()

    @property
    def rows(self) -> int:
        return 1 + int(self.need_cfg)


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


def _check_supported(loop_cfg: DenoiseLoopConfig, mesh, pipeline_axis) -> None:
    unsupported = {
        "sequence/pipeline parallelism (mesh, pipeline_axis)": mesh is not None or pipeline_axis is not None,
        f"guider {type(loop_cfg.guider).__name__}": type(loop_cfg.guider) not in (CFGGuider, CFGStarRescalingGuider),
        f"sampler {loop_cfg.sampler!r}": loop_cfg.sampler != "euler",
        "STG (stg_scale != 0)": loop_cfg.stg_scale != 0.0,
        "GE momentum (ge_gamma > 0)": loop_cfg.ge_gamma > 0,
        "cross_attn_scale != 1": loop_cfg.cross_attn_scale != 1.0,
        "cache_text_kv": loop_cfg.cache_text_kv,
        "cfg_interval != 1": loop_cfg.cfg_interval != 1,
    }
    missing = [name for name, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(f"not ported to the PyTorch denoise loop yet: {', '.join(missing)}")


def make_video_denoise_loop(
    model_cfg: LTXModelConfig,
    loop_cfg: DenoiseLoopConfig,
    mesh=None,
    pipeline_axis: Optional[str] = None,
):
    """Build the video-only denoise loop.

    Returns fn(model, state, sigmas (S+1,), pos_ctx, neg_ctx) -> final
    LatentState. neg_ctx is read only when CFG is on."""
    _check_supported(loop_cfg, mesh, pipeline_axis)
    stepper = EulerDiffusionStep()

    @torch.no_grad()
    def loop(model: LTXModel, state: LatentState, sigmas: torch.Tensor, pos_ctx, neg_ctx=None) -> LatentState:
        rows, batch = loop_cfg.rows, state.latent.shape[0]
        mask, clean = state.denoise_mask, state.clean_latent
        context = torch.cat([pos_ctx, neg_ctx], dim=0) if loop_cfg.need_cfg else pos_ctx
        positions = _tile_rows(state.positions, rows)
        video_pe = _precompute_video_pe(model_cfg, state.positions, rows)
        sigmas = sigmas.to(device=state.latent.device, dtype=torch.float32)

        latent = state.latent
        for i in range(sigmas.shape[0] - 1):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            tiled = LatentState(
                latent=_tile_rows(latent, rows), denoise_mask=_tile_rows(mask, rows),
                positions=positions, clean_latent=_tile_rows(clean, rows),
            )
            modality = modality_from_state(tiled, context, sigma, uniform_timesteps=loop_cfg.uniform_timesteps)
            outs = x0_model_apply(model, modality, video_pe=video_pe)
            denoised = outs[:batch]
            if loop_cfg.need_cfg:
                denoised = loop_cfg.guider.guide(denoised, outs[batch:2 * batch])
            denoised = post_process_latent(denoised, mask, clean)
            latent = stepper.step(latent, denoised, sigma, sigma_next)
        return state.replace(latent=latent)

    return loop
