"""Text- and image-to-video generation, video only, on one GPU.

Four flows, chosen with `--pipeline`:

- `bench-e2e` (the default; `generate_videos`): the steps of the JAX
  package's `scripts/bench_e2e.py`: Gaussian noise -> 8-sigma distilled
  Euler loop with CFGGuider(1.0) and uniform timesteps over the video DiT at
  full resolution, its weights kept in fp8 on the card (E4M3 codes with a
  per-tensor scale, dequantized at use; 12.9 GB instead of 25.8 GB in bf16)
  -> un-patchify -> VAE decode in temporal chunks -> uint8 frames.
- `distilled` (`generate_videos_distilled`): the two-stage recipe of the
  JAX package's `scripts/generate.py --pipeline distilled`
  (pipelines/distilled.py): stage 1 at half resolution with the 8 distilled
  sigmas -> 2x spatial upscaler -> stage 2 at full resolution on the 3-sigma
  tail -> tiled VAE decode.
- `one-stage` and `text-to-video` (`generate_videos_one_stage`): the JAX
  package's single-stage CFG pipelines (pipelines/one_stage.py,
  text_to_video.py): LTX2Scheduler sigmas, `--num-inference-steps` Euler
  steps with the prompt and the negative prompt as two guidance rows
  (CFG* at `--cfg-scale` when `--rescale-scale` > 0; text-to-video is plain
  CFG), VAE decode (tiled above 4000 latent voxels). They take the JAX
  CLI's loop options with its names and defaults: `--stg-scale`,
  `--stg-blocks`, `--stg-cutoff`, `--stg-mode` (a third guidance row with
  self-attention skipped in those blocks), `--apg-scale`, `--apg-eta`,
  `--apg-norm-threshold`, `--apg-momentum` (APG in place of CFG),
  `--ge-gamma`, `--sampler euler|heun`, `--cfg-interval` (the uncond row on
  every k-th step only), `--token-bucket` (the token count padded up to a
  multiple, the padding masked out of self-attention's keys),
  `--cross-attn-scale` from `--cross-attn-start-block`, `--cache-text-kv`,
  and `--upscale-spatial` (the 2x spatial upscaler after the loop).

`--image PATH[:FRAME[:STRENGTH]]` (repeatable; frame 0 and `--image-strength`
by default) conditions the distilled and the CFG flows on 8-bit PNGs: each is
resized to the stage's size, encoded by the fp32 video VAE encoder and
written over its latent frame (image-to-video).

Weights are random, drawn on the device from a seed, unless the two-stage
recipe or a CFG flow is given a reference-format checkpoint (`--checkpoint`,
with `--spatial-upscaler` for the two-stage recipe and, for
`--text-encoder`, `--gemma-dir`): then every component comes from the files
through `ModelLedger` (utils/model_ledger.py),
with `--fp8-serving` (the file's fp8 DiT weights stay fp8 on the card),
`--gemma-fp8` (Gemma's matmul weights quantized to fp8 at load) and
`--lora PATH[:STRENGTH]` (repeatable; fused into the DiT at load). The text
context is
the dummy embedding of `generate.py --no-gemma` (normal * 0.02, 1024 x 4096;
the CFG flows draw a negative one after it), except with `--text-encoder`
(the two-stage and the CFG flows): there each request's prompt and negative
prompt, token ids drawn from the request's seed and left-padded to 1024
(there is no tokenizer here), go through the fp32 Gemma-3-12B and the V1
text encoder (feature extractor, 1D connector) in one batch of 2, and the
DiT's caption projection maps the encoding (1024 x 3840) to its width.
Every DiT attention call runs the flash kernel, every VAE and upscaler conv
the implicit-GEMM conv kernel; Gemma's and the connector's fp32 attention
runs as plain torch ops, as the JAX package runs it outside Pallas.

From Python: `generate_video(seed=0)`, `generate_videos([0, 1, ...])` or
`generate_videos_distilled([0, 1, ...], text_encoder=True)`. From the shell
(N clips in one process, seeds seed..seed+N-1):

    python -m ltx2_tpu_torch.generate --requests 2
    python -m ltx2_tpu_torch.generate --pipeline distilled --requests 2
    python -m ltx2_tpu_torch.generate --pipeline distilled --text-encoder --requests 2
    python -m ltx2_tpu_torch.generate --pipeline distilled --image cat.png:0:0.95
    python -m ltx2_tpu_torch.generate --pipeline one-stage --height 480 --width 704 --frames 97 --image cat.png
    python -m ltx2_tpu_torch.generate --pipeline text-to-video --num-inference-steps 30 --cfg-scale 5
    python -m ltx2_tpu_torch.generate --pipeline one-stage --image cat.png --stg-scale 1 --stg-blocks 29 \
        --sampler heun --ge-gamma 0.5 --cross-attn-scale 0.5 --cache-text-kv --token-bucket 512
    python -m ltx2_tpu_torch.generate --pipeline text-to-video --apg-scale 3 --apg-eta 0.5 \
        --apg-norm-threshold 5 --cfg-interval 2
    python -m ltx2_tpu_torch.generate --pipeline distilled --checkpoint ltx-2.safetensors \
        --spatial-upscaler upscaler.safetensors --gemma-dir gemma-3-12b --text-encoder --fp8-serving --gemma-fp8
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ltx2_tpu_torch.components.guiders import CFGGuider, LtxAPGGuider, StatefulAPGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.components.schedulers import DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.fp8 import quantize_params_fp8, weight_bytes
from ltx2_tpu_torch.loader.lora import LoRAConfig
from ltx2_tpu_torch.models.text_encoder import (
    Gemma3, Gemma3Config, TextEncoderConfig, VideoTextEncoder, gemma3_apply, init_gemma3_, init_text_encoder_,
    video_text_encoder_apply,
)
from ltx2_tpu_torch.models.transformer.blocks import VideoBlock
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig, init_ltx_model_
from ltx2_tpu_torch.models.upscaler.spatial import (
    SpatialUpscaler, SpatialUpscalerConfig, init_spatial_upscaler_, spatial_upscaler_apply,
)
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder, VideoEncoderConfig, init_video_encoder_
from ltx2_tpu_torch.models.video_vae.chunking import decode_latent
from ltx2_tpu_torch.models.video_vae.decoder import (
    PerChannelStatistics, VideoDecoder, VideoDecoderConfig, init_video_decoder_,
)
from ltx2_tpu_torch.models.video_vae.ops import normalize_latent, un_normalize_latent
from ltx2_tpu_torch.models.video_vae.tiling import generate_tile_specs
from ltx2_tpu_torch.models.video_vae.weights import load_per_channel_statistics
from ltx2_tpu_torch.ops.attention import flash_attention
from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel
from ltx2_tpu_torch.pipelines.common import ImageCondition, decode_video
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline, stage_seeds
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline
from ltx2_tpu_torch.types import LatentState, VideoLatentShape, VideoPixelShape
from ltx2_tpu_torch.utils.model_ledger import ModelLedger

CONTEXT_TOKENS = 1024
# A request's prompt and negative prompt lengths in tokens, drawn from its
# seed in [low, high); token ids: BOS, then uniform over the vocabulary
# above the special ids; padding id 0 on the left.
PROMPT_TOKENS = (128, 512)
NEGATIVE_TOKENS = (32, 160)
PAD_ID, BOS_ID, FIRST_TEXT_ID = 0, 2, 3
FPS = 24.0
TEMPORAL_CHUNK = 7  # latent frames per decode chunk, the JAX bench's setting


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, make):
    """(make(), the seconds it took, synchronised)."""
    t0 = time.perf_counter()
    out = make()
    _sync(device)
    return out, time.perf_counter() - t0


def _free(device: torch.device) -> None:
    """Return released modules' device memory to the allocator's pool."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _phase_peak(device: torch.device, on: bool) -> Optional[float]:
    """With `on`, on the card: the peak device memory since the last reset,
    GB, and resets it (the process's peak statistics, which the caller owns).
    Otherwise None, and nothing is reset."""
    if not on or device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def make_dit(layers: int, device: torch.device, seed: int = 0, base: LTXModelConfig = LTXModelConfig(),
             fp8: bool = False) -> LTXModel:
    """The video DiT of config `base` (default: full width) at `layers`
    depth, random weights drawn on the device from `seed`. With `fp8` its
    linears are then kept in fp8 (`quantize_params_fp8`), as
    scripts/bench_e2e.py does; each block is drawn and quantized before the
    next is drawn, so the model in `base`'s dtype never exists whole, and
    the draws are those of the model without `fp8`."""
    cfg = dataclasses.replace(base, num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    if not fp8:
        return init_ltx_model_(LTXModel(cfg, device=device), gen)
    dit = quantize_params_fp8(init_ltx_model_(LTXModel(dataclasses.replace(cfg, num_layers=0), device=device), gen))
    for i in range(layers):
        block = VideoBlock(cfg.video_stream_config(), cfg.norm_eps, device=device, dtype=cfg.dtype)
        dit.transformer_blocks.append(quantize_params_fp8(init_ltx_model_(block, gen), f"transformer_blocks.{i}"))
    dit.cfg = cfg
    return dit


def make_decoder(compute_dtype: str, device: torch.device) -> VideoDecoder:
    """The full-width video decoder, random weights from seed 1."""
    decoder = VideoDecoder(VideoDecoderConfig(compute_dtype=compute_dtype), device=device)
    return init_video_decoder_(decoder, torch.Generator(device=device).manual_seed(1))


def make_encoder(device: torch.device, seed: int = 5, cfg: VideoEncoderConfig = VideoEncoderConfig()) -> VideoEncoder:
    """The video VAE encoder of config `cfg` (default: full width, the
    published plan, fp32 as in the JAX package), random weights from `seed`."""
    return init_video_encoder_(VideoEncoder(cfg, device=device), torch.Generator(device=device).manual_seed(seed))


def make_upscaler(device: torch.device) -> SpatialUpscaler:
    """The full-width spatial upscaler (mid 1024), fp32 as in the JAX
    package, random weights from seed 2."""
    upscaler = SpatialUpscaler(SpatialUpscalerConfig(), device=device)
    return init_spatial_upscaler_(upscaler, torch.Generator(device=device).manual_seed(2))


def make_gemma(device: torch.device, seed: int = 3, cfg: Gemma3Config = Gemma3Config()) -> Gemma3:
    """Gemma-3 of config `cfg` (default: the full-width 12B, 48 layers,
    fp32), random weights drawn on the device from `seed`."""
    return init_gemma3_(Gemma3(cfg, device=device), torch.Generator(device=device).manual_seed(seed))


def make_text_encoder(device: torch.device, seed: int = 4, cfg: TextEncoderConfig = TextEncoderConfig()
                      ) -> VideoTextEncoder:
    """The V1 text encoder above Gemma (feature extractor over 49 states of
    3840, 2-block 30 x 128 connector), fp32, random weights from `seed`."""
    return init_text_encoder_(VideoTextEncoder(cfg, device=device), torch.Generator(device=device).manual_seed(seed))


def prompt_tokens(seed: int, vocab_size: int, length: int = CONTEXT_TOKENS) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """A request's (prompt, negative prompt) token batch, drawn from `seed`
    on the CPU: ids (2, length) int64 and mask (2, length), left-padded, and
    the two real lengths."""
    gen = torch.Generator().manual_seed(seed)
    lengths = [int(torch.randint(low, high, (1,), generator=gen)) for low, high in (PROMPT_TOKENS, NEGATIVE_TOKENS)]
    ids = torch.full((2, length), PAD_ID, dtype=torch.long)
    mask = torch.zeros(2, length, dtype=torch.long)
    for row, n in enumerate(lengths):
        ids[row, length - n] = BOS_ID
        ids[row, length - n + 1:] = torch.randint(FIRST_TEXT_ID, vocab_size, (n - 1,), generator=gen)
        mask[row, length - n:] = 1
    return ids, mask, lengths


def encode_prompts(seeds: Sequence[int], gemma: Gemma3, text_encoder: VideoTextEncoder, device: torch.device,
                   stats: Sequence[dict], negatives: bool = False) -> List[torch.Tensor]:
    """Each request's prompt and negative prompt through Gemma and the text
    encoder as one batch of 2; returns the prompts' (1, S, 3840) contexts
    (with `negatives` the (2, S, 3840) prompt and negative pair) and writes
    into each request's stats the encode's seconds, the token lengths used
    and the prompt context's finiteness and std."""
    contexts = []
    for seed, st in zip(seeds, stats):
        ids, mask, (st["prompt_tokens"], st["negative_tokens"]) = prompt_tokens(seed, gemma.cfg.vocab_size)
        ids, mask = ids.to(device), mask.to(device)
        _sync(device)
        t0 = time.perf_counter()
        _, hidden = gemma3_apply(gemma, ids, mask)
        encoding = video_text_encoder_apply(text_encoder, hidden, mask).video_encoding
        _sync(device)
        st["text_encode_s"] = time.perf_counter() - t0
        del hidden
        context = encoding[0:1]
        st["context_finite"] = bool(torch.isfinite(encoding).all())
        st["context_std"] = float(context.std())
        contexts.append(encoding if negatives else context)
    return contexts


def _encode_phase(seeds, stats, device, gemma: Optional[Gemma3], text_encoder: Optional[VideoTextEncoder],
                  phase_peaks: bool, negatives: bool = False):
    """The text-encode phase: builds what is not given, encodes every
    request (`encode_prompts`) and returns the contexts; the modules it
    built are released when it returns."""
    if gemma is None:
        gemma, stats[0]["gemma_init_s"] = _timed(device, lambda: make_gemma(device))
    if text_encoder is None:
        text_encoder, stats[0]["text_encoder_init_s"] = _timed(device, lambda: make_text_encoder(device))
    contexts = encode_prompts(seeds, gemma, text_encoder, device, stats, negatives)
    stats[0]["text_encode_peak_gb"] = _phase_peak(device, phase_peaks)
    return contexts


def _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks: bool,
                   negatives: bool = False):
    """The contexts of the two-stage and the CFG flows: those given, or with
    `text_encoder` (True or a module) each request's prompts encoded, Gemma
    and the text encoder built (or read through `ledger`) and released
    before the DiT; None when neither (the dummy contexts are drawn later).
    Returns (contexts, whether they were encoded)."""
    encode = text_encoder is True or isinstance(text_encoder, VideoTextEncoder)
    if gemma is not None and not encode:
        raise ValueError("gemma is given but text encoding is off (text_encoder=False)")
    if encode and contexts is not None:
        raise ValueError("contexts and text_encoder are exclusive: the encoder makes the contexts")
    if not encode:
        return contexts, False
    if ledger is not None:
        gemma, stats[0]["gemma_init_s"] = _timed(device, ledger.gemma)
        text_encoder, stats[0]["text_encoder_init_s"] = _timed(device, ledger.text_encoder)
        ledger.clear_model("gemma")
        ledger.clear_model("text_encoder")
    contexts = _encode_phase(seeds, stats, device, gemma,
                             text_encoder if isinstance(text_encoder, VideoTextEncoder) else None, phase_peaks,
                             negatives)
    gemma = text_encoder = None
    _free(device)
    _phase_peak(device, phase_peaks)  # the next phase's peak starts from what is left
    return contexts, True


def _dit_and_encoder(stats, device, layers: int, dit, encoder, images, ledger, caption_channels):
    """The DiT (given, from `ledger`, or random at `layers` with a
    `caption_channels` projection when set) and, when there are images, the
    video encoder (given, from `ledger`, or random), each timed."""
    if dit is None and ledger is not None:
        dit, stats[0]["dit_init_s"] = _timed(device, ledger.transformer)
    elif dit is None:
        base = LTXModelConfig(caption_channels=caption_channels) if caption_channels else LTXModelConfig()
        dit, stats[0]["dit_init_s"] = _timed(device, lambda: make_dit(layers, device, base=base))
    stats[0]["dit_weight_gb"] = weight_bytes(dit) / 1e9
    if caption_channels and dit.cfg.caption_channels != caption_channels:
        raise ValueError(f"the DiT's caption_channels {dit.cfg.caption_channels} do not take the "
                         f"{caption_channels}-channel text encoding")
    if images and encoder is None and ledger is not None:
        encoder, stats[0]["encoder_init_s"] = _timed(device, ledger.video_encoder)
    elif images and encoder is None:
        encoder, stats[0]["encoder_init_s"] = _timed(device, lambda: make_encoder(device))
    return dit, encoder


def _spatial_upscaler(stats, device, upscaler, ledger, needed_by: str) -> SpatialUpscaler:
    """The spatial upscaler (given, from `ledger`, or random), timed."""
    if upscaler is None and ledger is not None:
        upscaler, stats[0]["upscaler_init_s"] = _timed(device, ledger.spatial_upscaler)
        if upscaler is None:
            raise ValueError(f"{needed_by} needs the spatial upscaler's file (spatial_upscaler_path)")
    elif upscaler is None:
        upscaler, stats[0]["upscaler_init_s"] = _timed(device, lambda: make_upscaler(device))
    return upscaler


def _latent_statistics(cfg: LTXModelConfig, decoder, ledger, device) -> PerChannelStatistics:
    """The latent statistics of the upscale bracket: the decoder's, the
    checkpoint's, or the defaults (0, 1) a random decoder holds."""
    if decoder is not None:
        return decoder.per_channel_statistics
    if ledger is not None:
        return load_per_channel_statistics(ledger.checkpoint_path, cfg.in_channels, device)
    return PerChannelStatistics(cfg.in_channels, device=device)


def _phase_timer(device, st: dict, phase_peaks: bool):
    """A pipeline callback that writes each phase's seconds (`{phase}_s`,
    from the previous phase's end), peak memory and conv launches into
    `st`, and the finiteness of its latent; `marks` holds the request's
    start (time, flash, key-valid flash and conv launch counts)."""
    _sync(device)
    marks = {"t": time.perf_counter(), "attention": flash_attention.launches,
             "key_valid": flash_attention.key_valid_launches, "conv": conv3d_ndhwc_kernel.launches}

    def on_phase(phase: str, latent: torch.Tensor) -> None:
        _sync(device)
        now = time.perf_counter()
        st[f"{phase}_s"] = now - marks["t"]
        st[f"{phase}_peak_gb"] = _phase_peak(device, phase_peaks)
        st[f"{phase}_conv_launches"] = conv3d_ndhwc_kernel.launches - marks["conv"]
        st[f"{phase}_latent_finite"] = bool(torch.isfinite(latent.float()).all())
        marks["t"], marks["conv"] = now, conv3d_ndhwc_kernel.launches

    return on_phase, marks


def make_latent_tools(cfg: LTXModelConfig, height: int, width: int, frames: int) -> VideoLatentTools:
    pixel = VideoPixelShape(batch=1, frames=frames, height=height, width=width, fps=FPS)
    return VideoLatentTools(
        patchifier=VideoLatentPatchifier(1),
        target_shape=VideoLatentShape.from_pixel_shape(pixel, latent_channels=cfg.in_channels),
        fps=FPS,
    )


def make_distilled_loop(cfg: LTXModelConfig):
    return make_video_denoise_loop(cfg, DenoiseLoopConfig(guider=CFGGuider(1.0), uniform_timesteps=True))


def distilled_sigmas(steps: int) -> torch.Tensor:
    if steps > len(DISTILLED_SIGMA_VALUES) - 1:
        raise ValueError(f"the distilled schedule has {len(DISTILLED_SIGMA_VALUES) - 1} steps, asked {steps}")
    return torch.tensor(DISTILLED_SIGMA_VALUES[: steps + 1], dtype=torch.float32)


def make_request(
    cfg: LTXModelConfig,
    tools: VideoLatentTools,
    seed: int,
    device: torch.device,
    context: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[LatentState, torch.Tensor]:
    """One request's noised initial state and text context, both drawn from
    `seed` unless given (context first, then noise)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if context is None:
        context = dummy_context(cfg, gen, device)
    state = GaussianNoiser()(gen, tools.create_initial_state(dtype=cfg.dtype, device=device), 1.0, noise=noise)
    return state, context


def dummy_context(cfg: LTXModelConfig, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """The `--no-gemma` text context: normal * 0.02, (1, 1024, the DiT's
    text input width: its caption projection's, else its context dim)."""
    width = cfg.caption_channels or cfg.cross_attention_dim
    return torch.randn(1, CONTEXT_TOKENS, width, generator=generator, device=device) * 0.02


def generate_videos(
    seeds: Sequence[int],
    *,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    steps: int = 8,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    decoder: Optional[VideoDecoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """Generate one clip per seed; returns (uint8 (frames, height, width, 3)
    arrays, per-request stats).

    All clips are denoised first, then the DiT is released and the decoder
    built, so the two never hold device memory together. `dit`, `decoder`,
    `contexts` and `noises` replace the random weights, the dummy text
    context and the initial noise (the tests hand in the JAX package's).
    Random weights are drawn from seed 0 (DiT, kept in fp8 as
    scripts/bench_e2e.py keeps it) and 1 (decoder). Stats per request: the
    denoise and decode seconds, the kernels' launches, the latent's
    finiteness and std; the first also the DiT's weight bytes (GB).
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sigmas = distilled_sigmas(steps)

    stats = [{"seed": seed, "dit_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    if dit is None:
        dit, stats[0]["dit_init_s"] = _timed(device, lambda: make_dit(layers, device, fp8=True))
    stats[0]["dit_weight_gb"] = weight_bytes(dit) / 1e9
    cfg = dit.cfg
    tools = make_latent_tools(cfg, height, width, frames)
    loop = make_distilled_loop(cfg)

    latents = []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        state, context = make_request(
            cfg, tools, seed, device,
            context=None if contexts is None else contexts[i], noise=None if noises is None else noises[i],
        )
        launches = flash_attention.launches
        _sync(device)
        t0 = time.perf_counter()
        out = loop(dit, state, sigmas, context)
        _sync(device)
        st["denoise_s"] = time.perf_counter() - t0
        st["attention_launches"] = flash_attention.launches - launches
        latent = tools.unpatchify(out).latent
        st["latent_finite"] = bool(torch.isfinite(latent.float()).all())
        st["latent_std"] = float(latent.float().std())
        latents.append(latent)

    del dit, loop
    _free(device)

    if decoder is None:
        decoder, stats[0]["decoder_init_s"] = _timed(device, lambda: make_decoder(cfg.compute_dtype, device))

    videos = []
    for latent, st in zip(latents, stats):
        convs = conv3d_ndhwc_kernel.launches
        t0 = time.perf_counter()
        videos.append(decode_chunked(latent, decoder, st["seed"]))
        st["decode_s"] = time.perf_counter() - t0  # decode_latent returns host frames: synchronised
        st["conv_launches"] = conv3d_ndhwc_kernel.launches - convs
    return videos, stats


def decode_chunked(latent: torch.Tensor, decoder: VideoDecoder, seed: int) -> np.ndarray:
    """The entry's VAE decode: 7-latent-frame chunks, decode noise from `seed`."""
    return decode_latent(
        latent, decoder, timestep=0.05,
        generator=torch.Generator(device=latent.device).manual_seed(seed),
        temporal_chunk_size=TEMPORAL_CHUNK,
    )


def generate_videos_distilled(
    seeds: Sequence[int],
    *,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    upscaler: Optional[SpatialUpscaler] = None,
    decoder: Optional[VideoDecoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    images: Optional[Sequence[ImageCondition]] = None,
    encoder: Optional[VideoEncoder] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """The two-stage distilled recipe, one clip per seed; returns (uint8
    (frames, height, width, 3) arrays, per-request stats).

    With `text_encoder` (True, or a VideoTextEncoder to use) every request's
    prompts are encoded first (`encode_prompts`), by a full-width fp32
    Gemma-3-12B (or `gemma`) and the V1 text encoder; both are then released
    before the DiT, built with a 3840-channel caption projection, is made
    (fp32 Gemma alone holds 47 GB). Without it each request gets the dummy
    context. `images` condition every request (image-to-video): the fp32
    video encoder (`encoder`, else random from seed 5, or the ledger's)
    encodes each at both stages' sizes. The DiT, the encoder and the
    upscaler serve both stages of every request; then they are released and
    the decoder decodes each clip (tiled above 4000 latent voxels, as
    `DistilledConfig.effective_tiling` decides), so the decoder never shares
    device memory with them. `dit`, `upscaler`, `decoder`, `contexts` and
    `noises` (each request's (stage-1, stage-2) noise) replace the random
    weights, the text context and the noise drawn from the request's seed.
    Random weights come from seeds 3 (Gemma), 4 (text encoder), 0 (DiT), 5
    (encoder), 2 (upscaler) and 1 (decoder); the upscale bracket uses
    `decoder`'s statistics, or the defaults (0, 1) that a random decoder
    holds. With `ledger` every component comes from its files instead
    (`ModelLedger`: Gemma and the text encoder, the DiT, the encoder, the
    upscaler, the decoder and the upscale bracket's statistics), each
    released from the ledger when its phase is over; then none of `dit`,
    `encoder`, `upscaler`, `decoder`, `gemma` or a text encoder module may
    be given, and the tokens still come from each request's seed. Stats per
    request: seconds of the text encode, each stage's image encode, stage 1,
    upscale, stage 2 and decode (the first also the DiT's weight bytes),
    attention launches, conv launches of each image encode, the upscale and
    the decode, decode tiles, the latents' finiteness after each stage, the
    context's finiteness and std, and, with `phase_peaks` on the card, each
    phase's peak memory (GB; None otherwise). `phase_peaks` resets the
    process's peak memory statistics at every phase boundary, so only a
    caller that owns them asks for it.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = list(images or [])
    modules = (dit, upscaler, decoder, encoder, gemma,
               text_encoder if isinstance(text_encoder, VideoTextEncoder) else None)
    if ledger is not None and any(m is not None for m in modules):
        raise ValueError("with a ledger every component comes from its files: pass no module")
    stats = [{"seed": seed, "dit_init_s": 0.0, "upscaler_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    _phase_peak(device, phase_peaks)
    contexts, encoded = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks)
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    contexts[0].shape[-1] if encoded else None)
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, "the two-stage recipe")
    cfg = dit.cfg
    statistics = _latent_statistics(cfg, decoder, ledger, device)
    pipe = DistilledPipeline(dit, upscaler, statistics=statistics, video_encoder=encoder)

    configs, latents = [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = DistilledConfig(height=height, width=width, num_frames=frames, seed=seed, dtype=cfg.compute_dtype,
                                 latent_channels=cfg.in_channels)
        context = contexts[i] if contexts is not None else dummy_context(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        latent = pipe(context, config, images=images, callback=on_phase, skip_decode=True,
                      noises=None if noises is None else noises[i])
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)

    del dit, upscaler, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder"):
            ledger.clear_model(name)
    return _decode_phase(latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                         lambda seed: stage_seeds(seed)[2]), stats


def _decode_phase(latents, configs, stats, device, decoder, ledger, compute_dtype: str, phase_peaks: bool,
                  decode_seed) -> List[np.ndarray]:
    """After the denoise phase's modules are released: the decoder (given,
    from `ledger`, or random), then each clip decoded (tiled as its config
    decides, decode noise from `decode_seed(config.seed)`), with its
    seconds, peak memory, tiles and conv launches in its stats."""
    _free(device)
    _phase_peak(device, phase_peaks)
    if decoder is None and ledger is not None:
        decoder, stats[0]["decoder_init_s"] = _timed(device, ledger.video_decoder)
    elif decoder is None:
        decoder, stats[0]["decoder_init_s"] = _timed(device, lambda: make_decoder(compute_dtype, device))
    videos = []
    for latent, config, st in zip(latents, configs, stats):
        tiling_used = config.effective_tiling()
        st["decode_tiles"] = len(generate_tile_specs(tuple(latent.shape), tiling_used)) if tiling_used else 0
        convs = conv3d_ndhwc_kernel.launches
        t0 = time.perf_counter()
        videos.append(decode_video(latent, decoder, tiling_used, decode_seed(config.seed)))
        st["decode_s"] = time.perf_counter() - t0  # host frames: synchronised
        st["decode_peak_gb"] = _phase_peak(device, phase_peaks)
        st["decode_conv_launches"] = conv3d_ndhwc_kernel.launches - convs
    return videos


def generate_videos_one_stage(
    seeds: Sequence[int],
    *,
    height: int = 480,
    width: int = 704,
    frames: int = 97,
    steps: int = 30,
    cfg_scale: float = 3.0,
    rescale_scale: float = 0.7,
    token_shift: bool = False,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    encoder: Optional[VideoEncoder] = None,
    decoder: Optional[VideoDecoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    images: Optional[Sequence[ImageCondition]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    cfg_interval: int = 1,
    token_bucket: int = 0,
    upscale_spatial: bool = False,
    **loop_options,
) -> Tuple[List[np.ndarray], List[dict]]:
    """The single-stage CFG pipeline, one clip per seed at the JAX
    package's OneStageCFGConfig defaults (480x704x97, 30 steps, CFG* at 3.0
    with rescale 0.7; `rescale_scale=0` is plain CFG, the CLI's
    text-to-video); returns (uint8 (frames, height, width, 3) arrays,
    per-request stats).

    Each request's contexts: `contexts[i]`, a (2, S, D) prompt and negative
    pair; or with `text_encoder` the request's prompt and negative prompt
    encoded as in `generate_videos_distilled`; else two dummy contexts drawn
    from its seed (prompt, then negative). `images`, `encoder`, `ledger`,
    `gemma`, `phase_peaks` and the random weights' seeds are as in
    `generate_videos_distilled`; `noises[i]` replaces request i's noise. The
    DiT and the encoder are released before the decoder is built. Stats per
    request: seconds of the text encode, the image encode, the denoise (and
    a step) and the decode, attention launches (and those with a key-valid
    mask), conv launches of the image encode and the decode, decode tiles,
    the latent's finiteness and std, and with `phase_peaks` each phase's
    peak memory.

    The loop options: `cfg_interval` and `token_bucket` go into the
    config; `loop_options` (stg_scale, stg_blocks, stg_cutoff, stg_mode,
    guider_override, ge_gamma, sampler, cross_attn_scale,
    cross_attn_start_block, cache_text_kv) to `OneStagePipeline`. With
    `upscale_spatial` the 2x spatial upscaler (the ledger's, or random from
    seed 2) runs after the loop in the un-normalize /
    re-normalize bracket of the decoder's statistics (its phase "upscale"
    in the stats), and the decoder decodes the upscaled latent.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = list(images or [])
    modules = (dit, decoder, encoder, gemma, text_encoder if isinstance(text_encoder, VideoTextEncoder) else None)
    if ledger is not None and any(m is not None for m in modules):
        raise ValueError("with a ledger every component comes from its files: pass no module")
    stats = [{"seed": seed, "dit_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    _phase_peak(device, phase_peaks)
    contexts, encoded = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                       negatives=True)
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    contexts[0].shape[-1] if encoded else None)
    cfg = dit.cfg
    pipe = OneStagePipeline(dit, video_encoder=encoder)
    spatial = upscaler = None
    if upscale_spatial:
        upscaler = _spatial_upscaler(stats, device, None, ledger, "--upscale-spatial")
        statistics = _latent_statistics(cfg, decoder, ledger, device)

        def spatial(latent: torch.Tensor) -> torch.Tensor:
            # Pipeline without a decoder: the bracket is applied here.
            upscaled = spatial_upscaler_apply(upscaler, un_normalize_latent(latent, statistics))
            return normalize_latent(upscaled, statistics)

    configs, latents = [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = OneStageCFGConfig(height=height, width=width, num_frames=frames, seed=seed,
                                   num_inference_steps=steps, cfg_scale=cfg_scale, rescale_scale=rescale_scale,
                                   token_dependent_shift=token_shift, dtype=cfg.compute_dtype,
                                   latent_channels=cfg.in_channels, cfg_interval=cfg_interval,
                                   token_bucket=token_bucket)
        if contexts is not None:
            positive, negative = contexts[i][0:1], contexts[i][1:2]
        else:
            gen = torch.Generator(device=device).manual_seed(seed)
            positive, negative = dummy_context(cfg, gen, device), dummy_context(cfg, gen, device)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        latent, _ = pipe(positive, negative, config, images=images, callback=on_phase, skip_decode=True,
                         noise=None if noises is None else noises[i], spatial_upscaler=spatial, **loop_options)
        st["denoise_step_s"] = st["denoise_s"] / steps
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["key_valid_attention_launches"] = flash_attention.key_valid_launches - marks["key_valid"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)

    del dit, encoder, pipe, upscaler, spatial
    if ledger is not None:
        for name in ("transformer", "video_encoder", "spatial_upscaler"):
            ledger.clear_model(name)
    return _decode_phase(latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                         lambda seed: stage_seeds(seed, 2)[1]), stats


def generate_video(seed: int = 0, **kwargs) -> np.ndarray:
    """One clip: uint8 (frames, height, width, 3). See generate_videos."""
    videos, _ = generate_videos([seed], **kwargs)
    return videos[0]


def parse_lora_spec(spec: str) -> LoRAConfig:
    """'path[:strength]' -> LoRAConfig (strength 1 when absent)."""
    if ":" in spec:
        path, strength = spec.rsplit(":", 1)
        return LoRAConfig(path=path, strength=float(strength))
    return LoRAConfig(path=spec)


def parse_image_spec(spec: str, default_strength: float = 0.95) -> ImageCondition:
    """'path[:frame[:strength]]' -> ImageCondition (frame 0 and
    `default_strength` when absent), as scripts/generate.py parses --image."""
    parts = spec.split(":")
    return ImageCondition(image_path=parts[0], frame_index=int(parts[1]) if len(parts) > 1 else 0,
                          strength=float(parts[2]) if len(parts) > 2 else default_strength)


# The one-stage / text-to-video loop options' argparse names.
LOOP_FLAGS = ("stg_scale", "stg_blocks", "stg_cutoff", "stg_mode", "apg_scale", "apg_eta", "apg_norm_threshold",
              "apg_momentum", "ge_gamma", "sampler", "cfg_interval", "token_bucket", "cross_attn_scale",
              "cross_attn_start_block", "cache_text_kv", "upscale_spatial")


def apg_guider(args) -> Optional[Union[LtxAPGGuider, StatefulAPGGuider]]:
    """The guider `--apg-*` asks for, as scripts/generate.py builds it: none
    at scale 0, the stateful APG with a momentum, else LtxAPGGuider."""
    if not args.apg_scale:
        return None
    if args.apg_momentum:
        return StatefulAPGGuider(scale=args.apg_scale, eta=args.apg_eta, norm_threshold=args.apg_norm_threshold,
                                 momentum=args.apg_momentum)
    return LtxAPGGuider(scale=args.apg_scale, eta=args.apg_eta, norm_threshold=args.apg_norm_threshold)


def main(argv=None) -> Tuple[List[np.ndarray], List[dict]]:
    """The command line; prints one JSON line per request and returns
    (frames, stats) as the generate functions do."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pipeline", choices=("bench-e2e", "distilled", "one-stage", "text-to-video"),
                    default="bench-e2e",
                    help="bench-e2e: one stage at full resolution, chunked decode; distilled: the two-stage "
                         "recipe (half-resolution stage 1, 2x upscaler, 3-sigma stage 2, tiled decode); one-stage: "
                         "the CFG pipeline (CFG* with --rescale-scale > 0); text-to-video: its plain-CFG form")
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--frames", type=int, default=121)
    ap.add_argument("--steps", type=int, default=8, help="bench-e2e only: distilled steps")
    ap.add_argument("--num-inference-steps", type=int, default=30, help="one-stage, text-to-video: Euler steps")
    ap.add_argument("--cfg-scale", type=float, default=3.0, help="one-stage, text-to-video: guidance scale")
    ap.add_argument("--rescale-scale", type=float, default=0.7,
                    help="one-stage: > 0 selects CFG* (CFGStarRescalingGuider), 0 classic CFG; text-to-video "
                         "always runs 0")
    ap.add_argument("--token-shift", action="store_true",
                    help="one-stage, text-to-video: shift the sigma schedule by the clip's token count, not the fixed 4096")
    ap.add_argument("--image", action="append", default=[], metavar="PATH[:FRAME[:STRENGTH]]",
                    help="distilled, one-stage, text-to-video: an 8-bit PNG conditioning latent frame FRAME "
                         "(default 0), repeatable")
    ap.add_argument("--image-strength", type=float, default=0.95,
                    help="the strength of --image specs without one")
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=1, help="clips to generate, seeds seed..seed+N-1")
    ap.add_argument("--text-encoder", action="store_true",
                    help="distilled, one-stage, text-to-video: encode each request's prompt and negative prompt "
                         "tokens (drawn from its seed) with the fp32 Gemma-3-12B and V1 text encoder (random "
                         "weights) in place of the dummy contexts")
    ap.add_argument("--checkpoint", default=None,
                    help="distilled, one-stage, text-to-video: a unified LTX-2 safetensors checkpoint (DiT, VAE "
                         "encoder and decoder, text projection and connector), loaded through ModelLedger in place "
                         "of the random weights")
    ap.add_argument("--spatial-upscaler", default=None,
                    help="distilled with --checkpoint: the spatial upscaler's safetensors")
    ap.add_argument("--gemma-dir", default=None,
                    help="with --checkpoint --text-encoder: the directory of Gemma-3's model-*.safetensors shards")
    ap.add_argument("--fp8-serving", action="store_true",
                    help="with --checkpoint: keep the file's fp8 DiT weights fp8 on the card (dequantized at use)")
    ap.add_argument("--gemma-fp8", action="store_true",
                    help="with --gemma-dir: quantize Gemma's matmul weights to fp8 at load (embeddings bf16)")
    ap.add_argument("--lora", action="append", default=[], metavar="PATH[:STRENGTH]",
                    help="with --checkpoint: a LoRA file fused into the DiT at load, repeatable")
    loop = ap.add_argument_group("one-stage and text-to-video loop options (the JAX CLI's names and defaults)")
    loop.add_argument("--stg-scale", type=float, default=0.0,
                      help="STG: a third guidance row with self-attention skipped in --stg-blocks")
    loop.add_argument("--stg-blocks", type=str, default=None, help="comma-separated block indices (default: all)")
    loop.add_argument("--stg-cutoff", type=float, default=1.0,
                      help="STG applies on steps with (i + 1) / steps <= this")
    loop.add_argument("--stg-mode", choices=["video", "audio", "both"], default="video",
                      help="the stream(s) STG perturbs; audio needs the audio branch, which is not ported")
    loop.add_argument("--apg-scale", type=float, default=0.0, help="APG in place of CFG at this scale (0 = off)")
    loop.add_argument("--apg-eta", type=float, default=1.0)
    loop.add_argument("--apg-norm-threshold", type=float, default=0.0,
                      help="APG guidance-norm clamp (0 = disabled)")
    loop.add_argument("--apg-momentum", type=float, default=0.0,
                      help="APG momentum EMA of the guidance delta (0 = disabled)")
    loop.add_argument("--ge-gamma", type=float, default=0.0, help="GE velocity momentum (0 = off)")
    loop.add_argument("--sampler", choices=["euler", "heun"], default="euler")
    loop.add_argument("--cfg-interval", type=int, default=1,
                      help="guidance reuse: the unconditional row on every k-th step only (1 = exact CFG)")
    loop.add_argument("--token-bucket", type=int, default=0,
                      help="round the token count up to a multiple of this and mask the padding (0 = off)")
    loop.add_argument("--cross-attn-scale", type=float, default=1.0,
                      help="scale of the text cross-attention output from --cross-attn-start-block on")
    loop.add_argument("--cross-attn-start-block", type=int, default=40)
    loop.add_argument("--cache-text-kv", action="store_true",
                      help="compute the blocks' text cross-attention K/V once per generation")
    loop.add_argument("--upscale-spatial", action="store_true",
                      help="the 2x spatial upscaler after the loop (random weights, or --spatial-upscaler's file "
                           "with --checkpoint)")
    args = ap.parse_args(argv)
    cfg_flow = args.pipeline in ("one-stage", "text-to-video")
    loop_flags = [f"--{dest.replace('_', '-')}" for dest in LOOP_FLAGS if getattr(args, dest) != ap.get_default(dest)]
    if loop_flags and not cfg_flow:
        ap.error(f"{', '.join(loop_flags)} need --pipeline one-stage or text-to-video")
    if args.pipeline == "bench-e2e":
        for flag, used in (("--text-encoder", args.text_encoder), ("--checkpoint", args.checkpoint),
                           ("--image", args.image)):
            if used:
                ap.error(f"{flag} needs --pipeline distilled, one-stage or text-to-video")
    if args.spatial_upscaler and args.pipeline != "distilled" and not args.upscale_spatial:
        ap.error("--spatial-upscaler needs --pipeline distilled, or --upscale-spatial")
    file_flags = {"--spatial-upscaler": args.spatial_upscaler, "--gemma-dir": args.gemma_dir,
                  "--fp8-serving": args.fp8_serving, "--gemma-fp8": args.gemma_fp8, "--lora": args.lora}
    if not args.checkpoint and any(file_flags.values()):
        ap.error(f"{', '.join(k for k, v in file_flags.items() if v)} need --checkpoint")
    if args.gemma_fp8 and not args.gemma_dir:
        ap.error("--gemma-fp8 needs --gemma-dir")
    seeds = [args.seed + i for i in range(args.requests)]
    common = dict(height=args.height, width=args.width, frames=args.frames, layers=args.layers, device=args.device)
    if args.pipeline == "bench-e2e":
        videos, stats = generate_videos(seeds, steps=args.steps, **common)
    else:
        ledger = None
        if args.checkpoint:
            ledger = ModelLedger(
                checkpoint_path=args.checkpoint, gemma_path=args.gemma_dir, spatial_upscaler_path=args.spatial_upscaler,
                loras=[parse_lora_spec(spec) for spec in args.lora], keep_fp8=args.fp8_serving,
                gemma_fp8=args.gemma_fp8, decoder_dtype="bfloat16", device=args.device,
            )
        images = [parse_image_spec(spec, args.image_strength) for spec in args.image]
        flow = dict(text_encoder=args.text_encoder, phase_peaks=True, ledger=ledger, images=images, **common)
        if cfg_flow:
            # text-to-video is the one-stage pipeline with plain CFG, as in
            # scripts/generate.py: rescale 0, every other flag as given.
            rescale = 0.0 if args.pipeline == "text-to-video" else args.rescale_scale
            videos, stats = generate_videos_one_stage(
                seeds, steps=args.num_inference_steps, cfg_scale=args.cfg_scale, rescale_scale=rescale,
                token_shift=args.token_shift, cfg_interval=args.cfg_interval, token_bucket=args.token_bucket,
                upscale_spatial=args.upscale_spatial, stg_scale=args.stg_scale,
                stg_blocks=[int(b) for b in args.stg_blocks.split(",")] if args.stg_blocks else None,
                stg_cutoff=args.stg_cutoff, stg_mode=args.stg_mode, guider_override=apg_guider(args),
                ge_gamma=args.ge_gamma, sampler=args.sampler, cross_attn_scale=args.cross_attn_scale,
                cross_attn_start_block=args.cross_attn_start_block, cache_text_kv=args.cache_text_kv, **flow)
        else:
            videos, stats = generate_videos_distilled(seeds, **flow)
    for video, st in zip(videos, stats):
        print(json.dumps({**st, "frames": list(video.shape), "dtype": str(video.dtype)}))
    return videos, stats


if __name__ == "__main__":
    main()
