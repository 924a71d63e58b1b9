"""LTX-2 DiT, video-only or audio-video (counterpart of
ltx2_tpu/models/transformer/model.py).

The video stream: patchify projection, AdaLN-single timestep embedding,
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
text encoder projects to the model's width itself).

The audio-video model (`model_type` AudioVideo) adds the audio stream
beside it, 32 x 64 wide at the published size: `audio_patchify_proj`,
`audio_adaln_single` (V2 also `audio_prompt_adaln_single`), V1's
`audio_caption_projection`, `audio_proj_out`, its RoPE over the latent's
seconds (always the middle of each interval, whatever the config says, as
the reference's audio preprocessor), and per block the audio stream and the
cross-modal attentions (`AVBlock`). The cross-modal attention's RoPE uses
the temporal axis only, the audio stream's width and heads on both sides
and max position `audio_cross_pe_max_pos`; its AdaLN embeddings come from
the OTHER stream's sigma (the first token's under per-token timesteps), the
gate's scaled by av_ca_timestep_scale_multiplier / timestep_scale_multiplier.
The audio-only model (`model_type` AudioOnly) has the audio stream alone
(`AudioBlock`s); it takes no video and returns the audio velocity.

Scale-out (the JAX package's model.py:100-109): the config's
`sequence_axis` (the forward then runs on this rank's token shard; see
parallel/sequence_parallel.py, which sets it for one forward through
`ltx_model_apply(..., cfg=)`) and `tp_axis` (the module holds this rank's
TP shard: parallel/sharding.py::shard_dit_params sets it on `model.cfg`)
reach every block's streams and attentions. The RoPE tables stay those of
all heads; each attention takes its rank's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ltx2_tpu_torch.components.perturbations import BatchedPerturbationConfig, PerturbationType
from ltx2_tpu_torch.models.transformer.attention import rms_norm_tp
from ltx2_tpu_torch.models.transformer.blocks import (
    AudioBlock, AVBlock, StreamArgs, StreamConfig, VideoBlock, joint_block_apply,
)
from ltx2_tpu_torch.ops.common import Linear, dequantize_int8, init_linear_, layer_norm, linear
from ltx2_tpu_torch.ops.rope import precompute_freqs_cis
from ltx2_tpu_torch.ops.timestep_embedding import AdaLayerNormSingle, adaln_single_apply


class LTXModelType(Enum):
    AudioVideo = "ltx av model"
    VideoOnly = "ltx video only model"
    AudioOnly = "ltx audio only model"


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
    model_type: LTXModelType = LTXModelType.VideoOnly
    av_ca_timestep_scale_multiplier: int = 1
    # The audio stream (AudioVideo).
    audio_heads: int = 32
    audio_head_dim: int = 64
    audio_in_channels: int = 128
    audio_out_channels: int = 128
    audio_cross_pe_max_pos: int = 20
    # Scale-out: mesh axes (parallel/mesh.py) of the token split and of the
    # head/feature split; None on one device.
    sequence_axis: Optional[object] = None
    tp_axis: Optional[object] = None

    @property
    def video_inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def audio_inner_dim(self) -> int:
        return self.audio_heads * self.audio_head_dim

    @property
    def is_av(self) -> bool:
        return self.model_type == LTXModelType.AudioVideo

    @property
    def has_video(self) -> bool:
        return self.model_type != LTXModelType.AudioOnly

    @property
    def has_audio(self) -> bool:
        return self.model_type != LTXModelType.VideoOnly

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
            sequence_axis=self.sequence_axis,
            tp_axis=self.tp_axis,
        )

    def audio_stream_config(self) -> StreamConfig:
        """The audio stream: its text context is as wide as the stream."""
        return StreamConfig(
            dim=self.audio_inner_dim,
            heads=self.audio_heads,
            d_head=self.audio_head_dim,
            context_dim=self.audio_inner_dim,
            cross_attention_adaln=self.cross_attention_adaln,
            apply_gated_attention=self.apply_gated_attention,
            sequence_axis=self.sequence_axis,
            tp_axis=self.tp_axis,
        )


def _caption_projection(in_channels: int, inner: int, device, dtype) -> nn.Module:
    proj = nn.Module()
    proj.linear_1 = Linear(in_channels, inner, device=device, dtype=dtype)
    proj.linear_2 = Linear(inner, inner, device=device, dtype=dtype)
    return proj


def make_block(cfg: LTXModelConfig, device=None) -> nn.Module:
    """One uninitialised block of the DiT `cfg` describes."""
    if cfg.is_av:
        return AVBlock(cfg.video_stream_config(), cfg.audio_stream_config(), cfg.norm_eps, device=device,
                       dtype=cfg.dtype)
    if cfg.has_audio:
        return AudioBlock(cfg.audio_stream_config(), cfg.norm_eps, device=device, dtype=cfg.dtype)
    return VideoBlock(cfg.video_stream_config(), cfg.norm_eps, device=device, dtype=cfg.dtype)


class LTXModel(nn.Module):
    """Parameters of the DiT (video-only, audio-video or audio-only), named
    as in the checkpoint. Linear weights are in cfg.dtype; AdaLN-single and
    the scale/shift tables fp32.
    Parameters start uninitialised: load them (loader/from_numpy.py) or
    draw them (`init_ltx_model_`)."""

    def __init__(self, cfg: LTXModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        streams = []
        if cfg.has_video:
            streams.append(("", cfg.video_inner_dim, cfg.in_channels, cfg.out_channels))
        if cfg.has_audio:
            streams.append(("audio_", cfg.audio_inner_dim, cfg.audio_in_channels, cfg.audio_out_channels))
        for prefix, inner, in_channels, out_channels in streams:
            setattr(self, f"{prefix}patchify_proj", Linear(in_channels, inner, device=device, dtype=dtype))
            setattr(self, f"{prefix}adaln_single",
                    AdaLayerNormSingle(inner, cfg.adaln_num_embeddings, device=device))
            if cfg.cross_attention_adaln:
                setattr(self, f"{prefix}prompt_adaln_single", AdaLayerNormSingle(inner, 2, device=device))
            if cfg.caption_channels is not None:
                setattr(self, f"{prefix}caption_projection",
                        _caption_projection(cfg.caption_channels, inner, device, dtype))
            setattr(self, f"{prefix}scale_shift_table", nn.Parameter(
                torch.zeros(2, inner, device=device, dtype=torch.float32), requires_grad=False))
            setattr(self, f"{prefix}proj_out", Linear(inner, out_channels, device=device, dtype=dtype))
        if cfg.is_av:
            video, audio = cfg.video_inner_dim, cfg.audio_inner_dim
            self.av_ca_video_scale_shift_adaln_single = AdaLayerNormSingle(video, 4, device=device)
            self.av_ca_a2v_gate_adaln_single = AdaLayerNormSingle(video, 1, device=device)
            self.av_ca_audio_scale_shift_adaln_single = AdaLayerNormSingle(audio, 4, device=device)
            self.av_ca_v2a_gate_adaln_single = AdaLayerNormSingle(audio, 1, device=device)
        self.transformer_blocks = nn.ModuleList(make_block(cfg, device) for _ in range(cfg.num_layers))


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


def _project_context(model: LTXModel, context: torch.Tensor, prefix: str = "") -> torch.Tensor:
    """A stream's text context in the compute dtype, through its caption
    projection when the model has one, as (B, S, inner); `prefix` "audio_"
    for the audio stream."""
    cfg = model.cfg
    context = context.to(cfg.dtype)
    if cfg.caption_channels is not None:
        proj = getattr(model, f"{prefix}caption_projection")
        context = linear(proj.linear_2, F.gelu(linear(proj.linear_1, context), approximate="tanh"))
    return context.reshape(context.shape[0], -1, cfg.audio_inner_dim if prefix else cfg.video_inner_dim)


def _first_sigma(modality: Modality) -> torch.Tensor:
    """The modality's sigma (B,), else its timesteps; per-token timesteps
    give the first token's."""
    sigma = modality.sigma if modality.sigma is not None else modality.timesteps
    return sigma[:, 0] if sigma.ndim > 1 else sigma


def stream_pe(model: LTXModel, positions: torch.Tensor, audio: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stream's RoPE tables from its (B, n, T, 2) positions: the video's
    over (frame, height, width) as the config says, the audio's over its
    seconds, always at the interval's middle."""
    cfg = model.cfg
    if audio:
        return precompute_freqs_cis(positions, dim=cfg.audio_inner_dim, theta=cfg.positional_embedding_theta,
                                    max_pos=[cfg.audio_cross_pe_max_pos], use_middle_indices_grid=True,
                                    num_attention_heads=cfg.audio_heads)
    return precompute_freqs_cis(positions, dim=cfg.video_inner_dim, theta=cfg.positional_embedding_theta,
                                max_pos=list(cfg.positional_embedding_max_pos),
                                use_middle_indices_grid=cfg.use_middle_indices_grid,
                                num_attention_heads=cfg.num_attention_heads)


def prepare_stream_args(
    model: LTXModel,
    video: Modality,
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    prefix: str = "",
) -> StreamArgs:
    """A stream's preprocessor (`prefix` "" video, "audio_" audio):
    patchify projection, AdaLN embeddings (V2: also the prompt AdaLN's,
    from the modality's sigma, per-token timesteps taking the first
    token's), masks and (unless precomputed) the RoPE tables."""
    cfg = model.cfg
    dtype = cfg.dtype
    inner = cfg.audio_inner_dim if prefix else cfg.video_inner_dim
    x = linear(getattr(model, f"{prefix}patchify_proj"), video.latent.to(dtype))
    batch = x.shape[0]
    timestep_emb, embedded = _prepare_timestep(
        getattr(model, f"{prefix}adaln_single"), video.timesteps, inner, batch, cfg.timestep_scale_multiplier
    )
    prompt_timestep = None
    if cfg.cross_attention_adaln:
        prompt_timestep, _ = _prepare_timestep(
            getattr(model, f"{prefix}prompt_adaln_single"), _first_sigma(video), inner, batch,
            cfg.timestep_scale_multiplier
        )
    context = _project_context(model, video.context, prefix)
    if video_pe is None:
        video_pe = stream_pe(model, video.positions, audio=bool(prefix))
    return StreamArgs(
        x=x, context=context, timesteps=timestep_emb, pe=video_pe,
        context_mask=_prepare_attention_mask(video.context_mask, dtype),
        self_mask=_prepare_attention_mask(video.token_mask, dtype),
        embedded_timestep=embedded, prompt_timestep=prompt_timestep,
    )


def _prepare_cross_modal(model: LTXModel, args: StreamArgs, modality: Modality, other: Modality,
                         prefix: str) -> StreamArgs:
    """A stream's cross-modal inputs: the temporal RoPE (the audio stream's
    width and heads, max position `audio_cross_pe_max_pos`, middle of the
    interval) and the AdaLN embeddings from the other modality's sigma (the
    gate's scaled by av_ca_timestep_scale_multiplier /
    timestep_scale_multiplier)."""
    cfg = model.cfg
    inner = cfg.audio_inner_dim if prefix == "audio" else cfg.video_inner_dim
    cross_pe = precompute_freqs_cis(
        modality.positions[:, 0:1], dim=cfg.audio_inner_dim, theta=cfg.positional_embedding_theta,
        max_pos=[cfg.audio_cross_pe_max_pos], use_middle_indices_grid=True, num_attention_heads=cfg.audio_heads)
    sigma, batch = _first_sigma(other), args.x.shape[0]
    gate_key = "av_ca_v2a_gate_adaln_single" if prefix == "audio" else "av_ca_a2v_gate_adaln_single"
    ss_emb, _ = _prepare_timestep(getattr(model, f"av_ca_{prefix}_scale_shift_adaln_single"), sigma, inner, batch,
                                  cfg.timestep_scale_multiplier)
    gate_emb, _ = _prepare_timestep(
        getattr(model, gate_key),
        sigma.float() * (cfg.av_ca_timestep_scale_multiplier / cfg.timestep_scale_multiplier), inner, batch,
        cfg.timestep_scale_multiplier)
    return args.replace(cross_pe=cross_pe, cross_scale_shift_timestep=ss_emb, cross_gate_timestep=gate_emb)


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
    computes it (an fp8 weight dequantized in the JAX package's order), but
    an int8 weight dequantized per out-channel in fp32 and cast to x's dtype
    for a plain product, as the JAX package's cached route does
    (model.py:376-405), not the W8A8 route. Unfused runtime LoRA is refused:
    the cached K/V would drop its delta."""
    if any(getattr(p, "lora_A", None) is not None or getattr(p, "lora_B", None) is not None for p in layers):
        raise ValueError(
            "cache_text_kv is unsupported with unfused runtime LoRA adapters on the K/V projections — fuse the "
            "LoRA first (loader/lora.py) or disable --cache-text-kv")
    out = None
    for i, p in enumerate(layers):
        if getattr(p, "weight_cscale", None) is not None:
            b = None if p.bias is None else p.bias.to(x.dtype)
            y = F.linear(x, dequantize_int8(p, x.dtype), b)
        else:
            y = linear(p, x)
        if out is None:
            out = y.new_empty((len(layers), *y.shape))
        out[i] = y
    return out


@torch.no_grad()
def precompute_text_kv(model: LTXModel, video_context: torch.Tensor, audio_context: Optional[torch.Tensor] = None
                       ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Every block's text cross-attention K (k-normed) and V from the video
    context (and, when given, the audio stream's from `audio_context`),
    computed once per generation: {"video": (k, v)[, "audio": (k, v)]},
    each (L, B, S, inner) in the compute dtype (48 x 3 x 1024 x 4096 bf16
    is 1.2 GB each). V1 only: V2 modulates K/V per step, so it raises
    ValueError."""
    if model.cfg.cross_attention_adaln:
        raise ValueError("text KV caching is V1-only (V2 modulates KV per step)")
    blocks = model.transformer_blocks
    out = {}
    for name, context, prefix in (("video", video_context, ""), ("audio", audio_context, "audio_")):
        if context is None:
            continue
        ctx = _project_context(model, context, prefix)
        attns = [getattr(b, f"{prefix}attn2") for b in blocks]
        k = _stacked_linear([a.to_k for a in attns], ctx)
        v = _stacked_linear([a.to_v for a in attns], ctx)
        k_w = torch.stack([a.k_norm.weight for a in attns])
        out[name] = (rms_norm_tp(k, k_w[:, None, None, :], model.cfg.norm_eps, model.cfg.tp_axis), v)
    return out


def prepare_av_args(model: LTXModel, video: Optional[Modality], audio: Optional[Modality] = None,
                    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    audio_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[Optional[StreamArgs], Optional[StreamArgs]]:
    """The preprocessors of the streams that run (each None when it does
    not), each with its cross-modal inputs when both run: (video args,
    audio args)."""
    args = None if video is None else prepare_stream_args(model, video, video_pe)
    audio_args = None if audio is None else prepare_stream_args(model, audio, audio_pe, prefix="audio_")
    if args is None or audio_args is None:
        return args, audio_args
    return (_prepare_cross_modal(model, args, video, audio, "video"),
            _prepare_cross_modal(model, audio_args, audio, video, "audio"))


def _block_x(block: nn.Module, x: Optional[torch.Tensor], ax: Optional[torch.Tensor], args: Optional[StreamArgs],
             audio: Optional[StreamArgs], cfg: LTXModelConfig, perturb=None, ca_scale=None, vkv=None, akv=None):
    """One block on hidden states `x` and the audio stream's `ax` (either
    None where its stream does not run): the unit that remat recomputes."""
    v, a = joint_block_apply(block, None if args is None else args.replace(x=x),
                             None if audio is None else audio.replace(x=ax),
                             cfg.video_stream_config() if args is not None else None,
                             cfg.audio_stream_config() if audio is not None else None,
                             cfg.norm_eps, perturb, ca_scale, vkv, akv)
    return None if v is None else v.x, None if a is None else a.x


def ltx_model_apply(
    model: LTXModel,
    video: Optional[Modality],
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    perturbations: Optional[BatchedPerturbationConfig] = None,
    ca_scales: Optional[torch.Tensor] = None,
    text_kv: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
    audio: Optional[Modality] = None,
    audio_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cfg: Optional[LTXModelConfig] = None,
):
    """Forward pass -> the fp32 velocity (B, T, out_channels) of the stream
    the model runs: the video's, with `audio` on an audio-video model the
    pair (video velocity, audio velocity), and on the audio-only model the
    audio velocity (`video` is then ignored and may be None).
    perturbations: a static per-row config (STG); ca_scales: (L,) scales of
    each block's video text cross-attention output; text_kv:
    `precompute_text_kv`'s output; video_pe / audio_pe: precomputed RoPE
    tables (`stream_pe`). Each None leaves its part of the forward as it is
    without the option. cfg: the config the forward runs under (default
    `model.cfg`; the sequence-parallel forward sets its `sequence_axis`)."""
    cfg = model.cfg if cfg is None else cfg
    if audio is not None and not cfg.has_audio:
        raise ValueError("an audio modality needs the audio-video model (model_type AudioVideo)")
    if not cfg.has_video:
        if audio is None:
            raise ValueError("the audio-only model needs an audio modality")
        video = None
    elif video is None:
        raise ValueError("a video modality is required for a video-enabled model")
    args, audio_args = prepare_av_args(model, video, audio, video_pe, audio_pe)
    first = args if args is not None else audio_args
    masks = None
    if perturbations is not None:
        masks = _perturbation_mask_array(perturbations, cfg.num_layers, first.x.shape[0], first.x.device)
    vkv, akv = (text_kv or {}).get("video"), (text_kv or {}).get("audio")
    remat = cfg.remat and torch.is_grad_enabled()
    vx = None if args is None else args.x
    ax = None if audio_args is None else audio_args.x
    for i, block in enumerate(model.transformer_blocks):
        extra = (None if masks is None else {name: m[i] for name, m in masks.items()},
                 None if ca_scales is None else ca_scales[i],
                 None if vkv is None else (vkv[0][i], vkv[1][i]),
                 None if akv is None else (akv[0][i], akv[1][i]))
        if remat:
            vx, ax = checkpoint(_block_x, block, vx, ax, args, audio_args, cfg, *extra, use_reentrant=False)
        else:
            vx, ax = _block_x(block, vx, ax, args, audio_args, cfg, *extra)
    velocity = audio_velocity = None
    if args is not None:
        velocity = _process_output(
            model.scale_shift_table, cfg.norm_eps, model.proj_out, vx, args.embedded_timestep
        ).float()
    if audio_args is not None:
        audio_velocity = _process_output(model.audio_scale_shift_table, cfg.norm_eps, model.audio_proj_out, ax,
                                         audio_args.embedded_timestep).float()
    if audio_args is None:
        return velocity
    return audio_velocity if args is None else (velocity, audio_velocity)


def _denoise(modality: Modality, velocity: torch.Tensor) -> torch.Tensor:
    t = modality.timesteps.float()
    t = t[:, None, None] if t.ndim == 1 else t[:, :, None]
    return modality.latent.float() - t * velocity


def x0_model_apply(
    model: LTXModel,
    video: Optional[Modality],
    video_pe: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    **kwargs,
):
    """Denoised sample x0 = latent - t * velocity, fp32 (with `audio` on an
    audio-video model, the (video, audio) pair); kwargs as ltx_model_apply
    takes them. The audio-only model denoises against the audio latent
    even when a video modality is passed too (the JAX package's rule)."""
    out = ltx_model_apply(model, video, video_pe, **kwargs)
    audio = kwargs.get("audio")
    if not model.cfg.has_video:
        return _denoise(audio, out)
    if audio is None:
        return _denoise(video, out)
    return _denoise(video, out[0]), _denoise(audio, out[1])
