"""LTX-2 video DiT (counterpart of ltx2_tpu/models/transformer/model.py).

The video-only model: patchify projection, AdaLN-single timestep embedding,
an `nn.ModuleList` of blocks run in a Python loop (the JAX package stacks
them on a leading layer axis and scans), each block rematerialised in the
backward when `remat` is on and a gradient is being recorded (as
`jax.checkpoint` around the JAX scan body), final LayerNorm + scale/shift +
projection, and the x0 (denoised) wrapper; with `caption_channels` set,
the V1 caption projection (linear -> gelu-tanh -> linear) maps the text
encoder's output to the model's width before the blocks. The forward takes
the denoise loop's options: static STG perturbation configs (per-row keep
masks on each block's self-attention residual), per-block scales of the
text cross-attention output, and text K/V precomputed once per generation
(`precompute_text_kv`, V1). V2 (LTX-2.3) is three switches: cross-attention
AdaLN (9 AdaLN embeddings, and `prompt_adaln_single`, driven by the
modality's sigma, whose 2 embeddings modulate the text K/V every step),
gated attention, and no caption projection (`caption_channels` None: the
text encoder projects to the model's width itself). Not ported yet: the
audio and audio-video models and the parallel variants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ltx2_tpu_torch.components.perturbations import BatchedPerturbationConfig, PerturbationType
from ltx2_tpu_torch.core import rms_norm
from ltx2_tpu_torch.models.transformer.blocks import StreamArgs, StreamConfig, VideoBlock, av_block_apply
from ltx2_tpu_torch.ops.common import Linear, init_linear_, layer_norm, linear
from ltx2_tpu_torch.ops.rope import precompute_freqs_cis
from ltx2_tpu_torch.ops.timestep_embedding import AdaLayerNormSingle, adaln_single_apply


@dataclasses.dataclass
class Modality:
    """One modality's inputs."""

    latent: torch.Tensor  # (B, T, C) patchified latents
    context: torch.Tensor  # (B, S, C_ctx) text context
    context_mask: Optional[torch.Tensor]  # (B, S) bool / additive float
    timesteps: torch.Tensor  # (B,) or (B, T)
    positions: torch.Tensor  # (B, n_dims, T, 2) position bounds
    sigma: Optional[torch.Tensor] = None  # (B,)
    token_mask: Optional[torch.Tensor] = None  # (B, T) bool, False = padding

    def replace(self, **kwargs) -> "Modality":
        return dataclasses.replace(self, **kwargs)


@dataclass(frozen=True)
class LTXModelConfig:
    """Static video-DiT architecture config. The defaults are the LTX-2.0
    video model fed a 4096-d text context directly (`caption_channels`
    None, as scripts/bench_e2e.py sets it); with `caption_channels` (3840
    for the V1 text encoder, the JAX dataclass's default) a caption
    projection maps that many channels to the model's width."""

    num_attention_heads: int = 32
    attention_head_dim: int = 128
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 48
    cross_attention_dim: int = 4096
    norm_eps: float = 1e-6
    caption_channels: Optional[int] = None
    positional_embedding_theta: float = 10000.0
    positional_embedding_max_pos: Tuple[int, ...] = (20, 2048, 2048)
    timestep_scale_multiplier: int = 1000
    use_middle_indices_grid: bool = True
    compute_dtype: str = "bfloat16"
    remat: bool = True  # checkpoint each block when gradients are recorded
    cross_attention_adaln: bool = False  # V2 (LTX-2.3)
    apply_gated_attention: bool = False  # V2

    @property
    def video_inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def adaln_num_embeddings(self) -> int:
        return 9 if self.cross_attention_adaln else 6

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def video_stream_config(self) -> StreamConfig:
        return StreamConfig(
            dim=self.video_inner_dim,
            heads=self.num_attention_heads,
            d_head=self.attention_head_dim,
            context_dim=self.cross_attention_dim,
            cross_attention_adaln=self.cross_attention_adaln,
            apply_gated_attention=self.apply_gated_attention,
        )


class LTXModel(nn.Module):
    """Parameters of the video DiT, named as in the checkpoint. Linear
    weights are in cfg.dtype; AdaLN-single and the scale/shift tables fp32.
    Parameters start uninitialised: load them (loader/from_numpy.py) or
    draw them (`init_ltx_model_`)."""

    def __init__(self, cfg: LTXModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        inner, dtype = cfg.video_inner_dim, cfg.dtype
        self.patchify_proj = Linear(cfg.in_channels, inner, device=device, dtype=dtype)
        self.adaln_single = AdaLayerNormSingle(inner, cfg.adaln_num_embeddings, device=device)
        if cfg.cross_attention_adaln:
            self.prompt_adaln_single = AdaLayerNormSingle(inner, 2, device=device)
        if cfg.caption_channels is not None:
            self.caption_projection = nn.Module()
            self.caption_projection.linear_1 = Linear(cfg.caption_channels, inner, device=device, dtype=dtype)
            self.caption_projection.linear_2 = Linear(inner, inner, device=device, dtype=dtype)
        self.scale_shift_table = nn.Parameter(
            torch.zeros(2, inner, device=device, dtype=torch.float32), requires_grad=False
        )
        self.proj_out = Linear(inner, cfg.out_channels, device=device, dtype=dtype)
        stream = cfg.video_stream_config()
        self.transformer_blocks = nn.ModuleList(
            VideoBlock(stream, cfg.norm_eps, device=device, dtype=dtype) for _ in range(cfg.num_layers)
        )


@torch.no_grad()
def init_ltx_model_(model: LTXModel, generator: torch.Generator) -> LTXModel:
    """Random weights in place, on the parameters' device: every linear gets
    init_linear's U(-1/sqrt(in), 1/sqrt(in)); norms stay ones and the
    scale/shift tables zeros, as in ltx2_tpu's init_ltx_model."""
    for m in model.modules():
        if isinstance(m, Linear):
            init_linear_(m, generator)
    return model


def _prepare_timestep(
    adaln: AdaLayerNormSingle, timestep: torch.Tensor, inner_dim: int, batch: int, scale_multiplier: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Timestep -> (B, T|1, n_emb, D) AdaLN embeddings + (B, T|1, D) raw, fp32."""
    t = (timestep.float() * scale_multiplier).reshape(-1)
    emb, embedded = adaln_single_apply(adaln, t)
    n_emb = emb.shape[-1] // inner_dim
    return emb.reshape(batch, -1, n_emb, inner_dim), embedded.reshape(batch, -1, inner_dim)


def _prepare_attention_mask(mask: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """bool (B, S) -> additive key-only (B, 1, 1, S) at -finfo(dtype).max;
    an additive float (B, S) mask is reshaped to the same layout."""
    if mask is None:
        return None
    if mask.is_floating_point():
        return mask.reshape(mask.shape[0], 1, 1, mask.shape[-1]).to(dtype) if mask.ndim == 2 else mask
    additive = (1.0 - mask.float()) * -torch.finfo(dtype).max
    return additive.reshape(mask.shape[0], 1, 1, mask.shape[-1]).to(dtype)


def _project_context(model: LTXModel, context: torch.Tensor) -> torch.Tensor:
    """The text context in the compute dtype, through the caption projection
    when the model has one, as (B, S, inner)."""
    cfg = model.cfg
    context = context.to(cfg.dtype)
    if cfg.caption_channels is not None:
        proj = model.caption_projection
        context = linear(proj.linear_2, F.gelu(linear(proj.linear_1, context), approximate="tanh"))
    return context.reshape(context.shape[0], -1, cfg.video_inner_dim)


def prepare_stream_args(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> StreamArgs:
    """The video preprocessor: patchify projection, AdaLN embeddings (V2:
    also the prompt AdaLN's, from the modality's sigma, per-token timesteps
    taking the first token's), masks and (unless precomputed) the RoPE
    tables."""
    cfg = model.cfg
    dtype, inner = cfg.dtype, cfg.video_inner_dim
    x = linear(model.patchify_proj, video.latent.to(dtype))
    batch = x.shape[0]
    timestep_emb, embedded = _prepare_timestep(
        model.adaln_single, video.timesteps, inner, batch, cfg.timestep_scale_multiplier
    )
    prompt_timestep = None
    if cfg.cross_attention_adaln:
        sigma = video.sigma if video.sigma is not None else video.timesteps
        if sigma.ndim > 1:
            sigma = sigma[:, 0]
        prompt_timestep, _ = _prepare_timestep(
            model.prompt_adaln_single, sigma, inner, batch, cfg.timestep_scale_multiplier
        )
    context = _project_context(model, video.context)
    if video_pe is None:
        video_pe = precompute_freqs_cis(
            video.positions, dim=inner, theta=cfg.positional_embedding_theta,
            max_pos=list(cfg.positional_embedding_max_pos),
            use_middle_indices_grid=cfg.use_middle_indices_grid,
            num_attention_heads=cfg.num_attention_heads,
        )
    return StreamArgs(
        x=x, context=context, timesteps=timestep_emb, pe=video_pe,
        context_mask=_prepare_attention_mask(video.context_mask, dtype),
        self_mask=_prepare_attention_mask(video.token_mask, dtype),
        embedded_timestep=embedded, prompt_timestep=prompt_timestep,
    )


def _process_output(
    table: torch.Tensor, norm_eps: float, proj: Linear, x: torch.Tensor, embedded_timestep: torch.Tensor
) -> torch.Tensor:
    """Final LayerNorm (no affine) + scale/shift (fp32) + proj_out."""
    ss = table[None, None].float() + embedded_timestep[:, :, None].float()
    shift, scale = ss[:, :, 0], ss[:, :, 1]
    out = layer_norm(x, eps=norm_eps).float() * (1.0 + scale) + shift
    return linear(proj, out.to(x.dtype))


@lru_cache(maxsize=32)
def _perturbation_mask_array(perturbations: Optional[BatchedPerturbationConfig], num_layers: int, batch: int,
                             device=None) -> Dict[str, torch.Tensor]:
    """Static perturbation config -> (L, B) fp32 keep masks per type, on
    `device` (all ones without a config). Built once per config and device:
    the tensors are constants, never written."""
    key_to_type = {
        "video_self": PerturbationType.SKIP_VIDEO_SELF_ATTN,
        "audio_self": PerturbationType.SKIP_AUDIO_SELF_ATTN,
        "a2v": PerturbationType.SKIP_A2V_CROSS_ATTN,
        "v2a": PerturbationType.SKIP_V2A_CROSS_ATTN,
    }
    if perturbations is None:
        return {name: torch.ones((num_layers, batch), dtype=torch.float32, device=device) for name in key_to_type}
    return {name: torch.stack([perturbations.mask(ptype, layer, device=device) for layer in range(num_layers)])
            for name, ptype in key_to_type.items()}


def _stacked_linear(layers: Sequence[Linear], x: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) through each of L linears -> (L, B, S, O), each as `linear`
    computes it (an fp8 weight dequantized in the JAX package's order; int8
    raises as there). Unfused runtime LoRA is refused: the cached K/V would
    drop its delta."""
    if any(getattr(p, "lora_A", None) is not None or getattr(p, "lora_B", None) is not None for p in layers):
        raise ValueError(
            "cache_text_kv is unsupported with unfused runtime LoRA adapters on the K/V projections — fuse the "
            "LoRA first (loader/lora.py) or disable --cache-text-kv")
    out = None
    for i, p in enumerate(layers):
        y = linear(p, x)
        if out is None:
            out = y.new_empty((len(layers), *y.shape))
        out[i] = y
    return out


@torch.no_grad()
def precompute_text_kv(model: LTXModel, video_context: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every block's text cross-attention K (k-normed) and V from the video
    context, computed once per generation: {"video": (k, v)}, each
    (L, B, S, inner) in the compute dtype (48 x 3 x 1024 x 4096 bf16 is 1.2
    GB each). V1 only: V2 modulates K/V per step, so it raises ValueError."""
    if model.cfg.cross_attention_adaln:
        raise ValueError("text KV caching is V1-only (V2 modulates KV per step)")
    blocks = model.transformer_blocks
    ctx = _project_context(model, video_context)
    k = _stacked_linear([b.attn2.to_k for b in blocks], ctx)
    v = _stacked_linear([b.attn2.to_v for b in blocks], ctx)
    k_w = torch.stack([b.attn2.k_norm.weight for b in blocks])
    return {"video": (rms_norm(k, k_w[:, None, None, :], model.cfg.norm_eps), v)}


def _block_x(block: VideoBlock, x: torch.Tensor, args: StreamArgs, stream: StreamConfig, eps: float,
             perturb=None, ca_scale=None, text_kv=None):
    """One block on hidden states `x`: the unit that remat recomputes."""
    return av_block_apply(block, args.replace(x=x), stream, eps, perturb, ca_scale, text_kv).x


def ltx_model_apply(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    perturbations: Optional[BatchedPerturbationConfig] = None,
    ca_scales: Optional[torch.Tensor] = None,
    text_kv: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
) -> torch.Tensor:
    """Forward pass -> fp32 velocity (B, T, out_channels). perturbations: a
    static per-row config (STG); ca_scales: (L,) scales of each block's text
    cross-attention output; text_kv: `precompute_text_kv`'s output. Each
    None leaves its part of the forward as it is without the option."""
    cfg = model.cfg
    args = prepare_stream_args(model, video, video_pe)
    stream = cfg.video_stream_config()
    masks = None
    if perturbations is not None:
        masks = _perturbation_mask_array(perturbations, cfg.num_layers, args.x.shape[0], args.x.device)
    vkv = (text_kv or {}).get("video")
    remat = cfg.remat and torch.is_grad_enabled()
    for i, block in enumerate(model.transformer_blocks):
        extra = (None if masks is None else {name: m[i] for name, m in masks.items()},
                 None if ca_scales is None else ca_scales[i],
                 None if vkv is None else (vkv[0][i], vkv[1][i]))
        if remat:
            args = args.replace(x=checkpoint(_block_x, block, args.x, args, stream, cfg.norm_eps, *extra,
                                             use_reentrant=False))
        else:
            args = av_block_apply(block, args, stream, cfg.norm_eps, *extra)
    return _process_output(
        model.scale_shift_table, cfg.norm_eps, model.proj_out, args.x, args.embedded_timestep
    ).float()


def x0_model_apply(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    **kwargs,
) -> torch.Tensor:
    """Denoised sample x0 = latent - t * velocity, fp32; kwargs as
    ltx_model_apply takes them."""
    velocity = ltx_model_apply(model, video, video_pe, **kwargs)
    t = video.timesteps.float()
    t = t[:, None, None] if t.ndim == 1 else t[:, :, None]
    return video.latent.float() - t * velocity
