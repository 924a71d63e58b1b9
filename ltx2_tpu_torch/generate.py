"""Text-, image- and audio-to-video generation, with or without audio, on
one GPU.

Ten flows, chosen with `--pipeline`:

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
  `--upscale-spatial` (the 2x spatial upscaler after the loop) and
  `--upscale-temporal` (the 2x temporal upscaler after it: F latent frames
  become 2F - 1).
- `two-stage` (`generate_videos_two_stage`): the JAX package's two-stage
  CFG pipeline (pipelines/two_stage.py): stage 1 at half resolution on
  `--num-inference-steps` (`--steps-stage1`) steps guided at `--cfg-scale`
  (`--cfg-stage1`) with the guidance rescale `--rescale-scale` (with
  `--audio` the multi-modal guider: `--audio-cfg-scale`,
  `--modality-scale`; three rows a step), the 2x upscaler, `--distilled-lora`
  fused into the DiT for the 3-sigma stage 2 and subtracted after it, the
  decodes; the resolution is rounded up to a multiple of 64. A DiT that
  takes the LoRA is bf16 (`--fp8-serving` is refused with it).
- `a2vid` (`generate_videos_a2vid`): audio-to-video
  (pipelines/a2vid_two_stage.py): `--audio-file`'s first frames / fps
  seconds at 16 kHz, encoded by the audio VAE encoder into the audio
  latent, frozen through both stages of the distilled recipe on the
  audio-video DiT; with `--audio` the source is the output's .wav.
- `keyframe` (`generate_videos_keyframe`): keyframe interpolation
  (pipelines/keyframe_interpolation.py): `--keyframe PATH:FRAME[:STRENGTH]`
  stills (strength 0.95 by default) encoded and appended past the sequence's
  end at their pixel frames, a CFG stage 1 at half resolution against a
  zero negative context (30 steps, CFG 7.5: the config's, as the JAX CLI
  runs it), the upscaler, a distilled stage 2 without guidance; video only.
- `ti2vid-hq` (`generate_videos_ti2vid_hq`): pipelines/ti2vid_hq.py: stage
  1 at half resolution through the Res2s second-order sampler under CFG
  (`--num-inference-steps`, `--cfg-scale`, `--audio-cfg-scale`), images at
  both stages, the upscaler, the distilled stage 2. Without an upscaler's
  file from a checkpoint, keyframe and ti2vid-hq run one stage, as the JAX
  CLI does.
- `retake` (`generate_videos_retake`): pipelines/retake.py: `--video`
  (its own height, width and fps; frames snapped down to 8k+1; .y4m, MJPEG
  .avi/.mov/.mp4, GIF and APNG read by the port, other codecs through
  OpenCV or ffmpeg) encoded by the fp32 video encoder, the latent frames between
  `--retake-start` and `--retake-end` seconds re-noised and denoised over
  `--num-inference-steps` CFG steps at `--cfg-scale` (`--cfg-interval`,
  `--token-shift`), every other frame kept bit for bit, the decode.
- `ic-lora` (`generate_videos_ic_lora`): pipelines/ic_lora.py: the
  distilled recipe with `--control-video` (`--control-type raw`, or
  `canny` through the port's own OpenCV steps, `--canny-low/--canny-high`)
  read at stage 1's size, encoded and appended at frame 0 with
  `--control-strength`, and `--ic-lora-weights PATH[:STRENGTH]` (the first
  `--lora` when absent) fused into the DiT for stage 1 only;
  `--save-control` writes the signal as `<video>.control.avi`; `--int8` is
  refused.

`--audio` on the distilled and the CFG flows generates sound with the
audio-video DiT (the checkpoint's, loaded with its audio stream; else random
at full width, 32 x 128 video and 32 x 64 audio heads, kept in fp8): the
audio stream denoises beside the video in the joint loop (the CFG flows
guide it at `--audio-cfg-scale`, 7.0), then the audio VAE decoder and the
vocoder (LTX-2.3's BWE chain when the checkpoint declares one: 48 kHz,
else 24 kHz) make a stereo waveform, written as `<base>.wav` beside a
`.y4m` (16-bit PCM, as the JAX CLI writes it), inside an MJPEG `.avi`,
`.mov` or no-ffmpeg `.mp4`, or muxed by ffmpeg into other containers. `--no-internal-audio` leaves the audio stream of an AV DiT out
when audio is not asked for, as in the JAX CLI.

`--int8` (every flow) serves the DiT's matmul weights as int8 W8A8
(loader/int8.py: per-out-channel codes quantized on the host at load, or on
the card for random weights; activations quantized per token at each
matmul, int32 products by torch._int_mm); it excludes `--fp8-serving` and
`--distilled-lora`. The JAX CLI's aliases (`--cfg`, `--guidance-rescale`,
`--weights`, `--gemma-path`, `--spatial-upscaler-weights`,
`--temporal-upscaler-weights`) and compatibility flags (`--fp8`, `--fp16`,
`--fp32`/`--no-fp16`, `--low-memory`, `--fast-mode`, `--lora-strength`,
`--tiled-vae`, `--placeholder`, `--no-gemma`, `--model-variant`,
`--profile-dir`, `--compile-cache`) reach the settings the JAX CLI gives
them (`_apply_reference_compat`).

`--image PATH[:FRAME[:STRENGTH]]` (repeatable; frame 0 and `--image-strength`
by default) conditions the distilled and the CFG flows on stills: any file
PIL opens as RGB, RGBA or L (PNG at every depth and Adam7, baseline and
progressive JPEG, WebP, BMP, PPM/PGM, TGA, TIFF, a grey GIF), decoded by the
port's readers equal to PIL (`pipelines/common.read_image`); each is
resized to the stage's size, encoded by the fp32 video VAE encoder and
written over its latent frame (image-to-video).

Weights are random, drawn on the device from a seed, unless the two-stage
recipe or a CFG flow is given a reference-format checkpoint (`--checkpoint`,
LTX-2.0 or LTX-2.3, with `--spatial-upscaler` for the two-stage recipe and
`--gemma-dir`): then every component comes from the files through
`ModelLedger` (utils/model_ledger.py), with `--fp8-serving` (the file's fp8
DiT weights stay fp8 on the card), `--gemma-fp8` (Gemma's matmul weights
quantized to fp8 at load) and `--lora PATH[:STRENGTH]` (repeatable; fused
into the DiT at load). An LTX-2.3 (V2) file gives the V2 DiT (cross-attention
AdaLN, gated attention, prompt AdaLN, no caption projection) and the V2 text
encoder (two extractor heads, two gated connectors; the audio encoding it
also makes is the audio stream's context under `--audio`).

Prompts: `--prompt` and `--negative-prompt` (the JAX CLI's defaults) are
tokenized from `--gemma-dir`'s tokenizer.json by the port's own reader
(utils/tokenizer.py: left padding to 1024, right truncation, the template's
<bos>, as the JAX CLI's AutoTokenizer call) and go through Gemma-3 and the
checkpoint's text encoder; `--gemma-dir` turns text encoding on. Without a
checkpoint, `--text-encoder` runs the fp32 Gemma-3-12B and V1 text encoder
on random weights with token ids drawn from each request's seed (no
tokenizer: an explicit `--prompt` is refused there). `--embedding` reads the
contexts from an npz with the JAX CLI's keys (`positive`, `negative`),
`--save-embedding` writes them (V2: also `positive_audio`,
`negative_audio`). Otherwise the text context is the dummy embedding of
`generate.py --no-gemma` (normal * 0.02, 1024 x the DiT's text width; the CFG
flows draw a negative one after it). Each request's stats name the
`prompt_source`.

Files out: `--output` (default output.mp4; several requests get
`<base>_<i><ext>`), as the JAX CLI's `save_video` writes them
(utils/video_io.py): `.y4m`, `.avi` and `.mov` by the port's writers (MJPEG
from the port's JPEG encoder, equal to PIL's), any other container through
ffmpeg (`--output-fps` minterpolate, `--speed`); without ffmpeg on PATH an
`.mp4`/`.m4v` is written as MJPEG by the port and any other name as
`<base>.avi`, each with `<base>.gif` (a preview), `<base>_frames.npz` and,
with audio, `<base>.wav`. `--skip-vae` writes
`<base>_latent.npz` (`latent`) and builds no decoder. `--fps` is the
position grid's rate and the file's; `--tile-size`, `--tile-overlap`,
`--temporal-tile-size` and `--temporal-tile-overlap` set the decode's
tiling; `--num-frames` is `--frames`; `--dtype` the DiT's compute dtype.

Every DiT attention call runs the flash kernel (the audio stream's and the
cross-modal ones at head dim 64), every VAE and upscaler conv the
implicit-GEMM conv kernel; Gemma's and the connector's fp32 attention, and
the audio decoder's and the vocoder's fp32 convs, run as plain torch ops
(TF32 off), as the JAX package runs them outside Pallas.

`--enhance-prompt` (with `--gemma-dir`) expands `--prompt` with the same
Gemma before it is encoded (models/text_encoder/generation.py, sampled
from `--seed`; the stats' `enhanced_prompt`); `--early-layers-only`
conditions a V1 checkpoint's DiT on Gemma's layer-0 hidden state in place
of the text encoder.

The command line is `build_parser()`, `check_request(args)` (every
refusal a ValueError, before any model is built), `setup(args)` and
`execute_request(args, models, ledger)`: `main` runs them once with no
resident models, so each module is released when its phase is over; the
server (`python -m ltx2_tpu_torch.serve`) keeps the launch's modules
resident (`ResidentModels`) and runs one `execute_request` a request.

Scale-out (every pipeline but bench-e2e; parallel/): one process per
rank, launched by `torchrun`; `--sp-devices S` splits the tokens over S
ranks (ring attention), `--tp-devices T` the DiT's heads and features over
T ranks (S x T x P with `--pp-stages`; the DiT's layout must use every rank
of the launch), `--vae-dp-devices N` decodes tiles data-parallel over
N ranks and `--vae-w-shard N` decodes an untiled latent W-sharded over N
ranks. Backend: nccl when every rank has a card of its own, else name
`--dist-backend gloo` (ranks sharing one card, or the CPU). Every rank
draws the same noise; rank 0 writes the outputs. `--pp-stages P` stages
the DiT's blocks over P ranks (GPipe; composes with SP and TP in one
(pipe, seq, model) mesh) and `--auto-shard N` picks the layout of N ranks
from the advisor's cost model.

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
        --spatial-upscaler upscaler.safetensors --gemma-dir gemma-3-12b --fp8-serving --gemma-fp8 \
        --prompt "A cinematic shot of the ocean at sunset" --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline one-stage --checkpoint ltx-2.3.safetensors \
        --gemma-dir gemma-3-12b --prompt "..." --save-embedding emb.npz --output clip.mp4
    python -m ltx2_tpu_torch.generate --pipeline distilled --checkpoint ltx-2.3.safetensors \
        --spatial-upscaler upscaler.safetensors --embedding emb.npz --skip-vae --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline distilled --audio --requests 2 --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline one-stage --checkpoint ltx-2.3.safetensors --audio \
        --audio-cfg-scale 7 --gemma-dir gemma-3-12b --prompt "..." --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline two-stage --audio --steps-stage1 30 \
        --distilled-lora ltx-2-19b-distilled-lora-384.safetensors --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline a2vid --audio --audio-file speech.wav --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline one-stage --int8 --upscale-temporal --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline keyframe --keyframe first.png:0 --keyframe last.png:120 \
        --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline ti2vid-hq --image first.png --audio --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline retake --video source.y4m --retake-start 1 --retake-end 3 \
        --output clip.y4m
    python -m ltx2_tpu_torch.generate --pipeline ic-lora --control-video depth.avi --ic-lora-weights ic.safetensors \
        --output clip.y4m
    torchrun --nproc-per-node 2 -m ltx2_tpu_torch.generate --pipeline distilled --sp-devices 2 --output clip.y4m
    torchrun --nproc-per-node 4 -m ltx2_tpu_torch.generate --pipeline one-stage --sp-devices 2 --tp-devices 2 \
        --dist-backend gloo --output clip.y4m
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import dataclasses
import functools
import gc
import json
import os
import sys
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
from ltx2_tpu_torch.loader.int8 import quantize_params_int8
from ltx2_tpu_torch.loader.lora import LoRAConfig
from ltx2_tpu_torch.models.text_encoder import (
    Gemma3, Gemma3Config, TextEncoderConfig, VideoTextEncoder, av_text_encoder_apply, gemma3_apply, init_gemma3_,
    init_text_encoder_, video_text_encoder_apply,
)
from ltx2_tpu_torch.models.audio_vae.decoder import AudioDecoder, AudioDecoderConfig, init_audio_decoder_
from ltx2_tpu_torch.models.audio_vae.encoder import AudioEncoder, AudioEncoderConfig, init_audio_encoder_
from ltx2_tpu_torch.models.audio_vae.vocoder import Vocoder, VocoderConfig, init_vocoder_
from ltx2_tpu_torch.models.transformer.model import (
    LTXModel, LTXModelConfig, LTXModelType, init_ltx_model_, make_block,
)
from ltx2_tpu_torch.models.upscaler.spatial import (
    SpatialUpscaler, SpatialUpscalerConfig, init_spatial_upscaler_, spatial_upscaler_apply,
)
from ltx2_tpu_torch.models.upscaler.temporal import (
    TemporalUpscaler, TemporalUpscalerConfig, init_temporal_upscaler_, temporal_upscaler_apply,
)
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder, VideoEncoderConfig, init_video_encoder_
from ltx2_tpu_torch.models.video_vae.chunking import decode_latent
from ltx2_tpu_torch.models.video_vae.decoder import (
    PerChannelStatistics, VideoDecoder, VideoDecoderConfig, init_video_decoder_,
)
from ltx2_tpu_torch.models.video_vae.ops import normalize_latent, un_normalize_latent
from ltx2_tpu_torch.models.video_vae.tiling import (
    SpatialTilingConfig, TemporalTilingConfig, TilingConfig, generate_tile_specs,
)
from ltx2_tpu_torch.models.video_vae.weights import load_per_channel_statistics
from ltx2_tpu_torch.ops.attention import flash_attention
from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel
from ltx2_tpu_torch.pipelines.common import ImageCondition, decode_audio, decode_video
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline, stage_seeds
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline
from ltx2_tpu_torch.types import LatentState, VideoLatentShape, VideoPixelShape
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from ltx2_tpu_torch.utils.tokenizer import has_tokenizer, tokenize
from ltx2_tpu_torch.utils.video_io import save_video

CONTEXT_TOKENS = 1024
# A request's prompt and negative prompt lengths in tokens, drawn from its
# seed in [low, high); token ids: BOS, then uniform over the vocabulary
# above the special ids; padding id 0 on the left.
PROMPT_TOKENS = (128, 512)
NEGATIVE_TOKENS = (32, 160)
PAD_ID, BOS_ID, FIRST_TEXT_ID = 0, 2, 3
# The JAX CLI's default prompts (scripts/generate.py:42-45).
DEFAULT_PROMPT = "A cinematic shot of the ocean at sunset"
DEFAULT_NEGATIVE_PROMPT = "worst quality, inconsistent motion, blurry, jittery, distorted"
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
    """Return released modules' device memory to the allocator's pool;
    inside `resident` nothing is released, and nothing is done."""
    if _RESIDENT.get() is not None:
        return
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


class ResidentModels(dict):
    """The modules a server keeps between requests (`setup`), each under the
    key of what built it: a component's name for the ledger's, the name and
    the construction's settings for random weights."""

    def weight_gb(self) -> float:
        """The resident modules' parameters and buffers, GB."""
        seen = {id(m): m for m in self.values() if isinstance(m, torch.nn.Module)}
        return sum(weight_bytes(m) for m in seen.values()) / 1e9


_RESIDENT: contextvars.ContextVar = contextvars.ContextVar("resident_models", default=None)


@contextlib.contextmanager
def resident(models: Optional[ResidentModels]):
    """Inside, every module a flow builds comes from `models` when it holds
    one built the same way, and what is built is kept there; the flows'
    releases then release nothing (`models` keeps a reference). None: each
    flow builds and releases its modules, the one-shot command line's
    peaks."""
    token = _RESIDENT.set(models)
    try:
        yield
    finally:
        _RESIDENT.reset(token)


def _built(device: torch.device, st: dict, stat: str, key, make):
    """make()'s module, its seconds in st[stat]; inside `resident`, the one
    kept under `key` (0 seconds), or make()'s, then kept."""
    models = _RESIDENT.get()
    if models is not None and key in models:
        st[stat] = 0.0
        return models[key]
    module, st[stat] = _timed(device, make)
    if models is not None:
        models[key] = module
    return module


@contextlib.contextmanager
def _weights_restored(model, loras: Sequence[LoRAConfig]):
    """Inside `resident`, the weights a runtime LoRA fuse changes are copied
    to the host and written back bit for bit at the end: the unfuse restores
    them only up to their dtype's rounding, which would drift a resident DiT
    from request to request. Outside, nothing."""
    from ltx2_tpu_torch.loader.lora import lora_targets

    if _RESIDENT.get() is None or not loras:
        yield
        return
    saved = {name: model.get_parameter(name).detach().to("cpu", copy=True) for name in lora_targets(model, loras)}
    try:
        yield
    finally:
        with torch.no_grad():
            for name, host in saved.items():
                model.get_parameter(name).copy_(host)


def make_dit(layers: int, device: torch.device, seed: int = 0, base: LTXModelConfig = LTXModelConfig(),
             fp8: bool = False, int8: bool = False, pipe_axis=None) -> LTXModel:
    """The video DiT of config `base` (default: full width) at `layers`
    depth, random weights drawn on the device from `seed`. With `fp8` its
    linears are then kept in fp8 (`quantize_params_fp8`), as
    scripts/bench_e2e.py does; with `int8` its matmul weights are int8 W8A8
    (`quantize_params_int8`, as the JAX CLI's --int8 quantizes a random
    DiT). Either way each block is drawn and quantized before the next is
    drawn, so the model in `base`'s dtype never exists whole, and the draws
    are those of the unquantized model. With `pipe_axis` (a mesh's pipe
    axis) the model is this rank's pipeline stage: every block is drawn, one
    at a time, and only the stage's are kept (the others' places hold an
    `AbsentBlock`), so the kept weights are world 1's."""
    if fp8 and int8:
        raise ValueError("fp8 and int8 are exclusive")
    cfg = dataclasses.replace(base, num_layers=layers)
    gen = torch.Generator(device=device).manual_seed(seed)
    staged = pipe_axis is not None and pipe_axis.size > 1
    if not (fp8 or int8 or staged):
        return init_ltx_model_(LTXModel(cfg, device=device), gen)
    from ltx2_tpu_torch.parallel.pipeline_parallel import AbsentBlock, stage_layers

    keep = stage_layers(layers, pipe_axis if staged else None)
    quantize = quantize_params_fp8 if fp8 else quantize_params_int8 if int8 else (lambda m, prefix="": m)
    dit = quantize(init_ltx_model_(LTXModel(dataclasses.replace(cfg, num_layers=0), device=device), gen))
    for i in range(layers):
        block = init_ltx_model_(make_block(cfg, device), gen)
        dit.transformer_blocks.append(quantize(block, f"transformer_blocks.{i}") if i in keep else AbsentBlock())
    dit.cfg = cfg
    return dit


def av_config(base: LTXModelConfig = LTXModelConfig()) -> LTXModelConfig:
    """`base` as the audio-video DiT (the audio stream 32 x 64 wide)."""
    return dataclasses.replace(base, model_type=LTXModelType.AudioVideo)


def make_audio_decoder(device: torch.device, seed: int = 6, cfg: AudioDecoderConfig = AudioDecoderConfig()
                       ) -> AudioDecoder:
    """The audio VAE decoder of config `cfg` (default: the published one),
    fp32, random weights from `seed`."""
    return init_audio_decoder_(AudioDecoder(cfg, device=device), torch.Generator(device=device).manual_seed(seed))


def make_audio_encoder(device: torch.device, seed: int = 8, cfg: AudioEncoderConfig = AudioEncoderConfig()
                       ) -> AudioEncoder:
    """The audio VAE encoder of config `cfg` (default: the published one),
    fp32, random weights from `seed`."""
    return init_audio_encoder_(AudioEncoder(cfg, device=device), torch.Generator(device=device).manual_seed(seed))


def make_vocoder(device: torch.device, seed: int = 7, cfg=VocoderConfig()):
    """The vocoder of config `cfg` (default: LTX-2's HiFi-GAN, 1024
    channels in, 24 kHz; a VocoderWithBWEConfig gives LTX-2.3's chain),
    fp32, random weights from `seed`."""
    from ltx2_tpu_torch.models.audio_vae.vocoder import VocoderWithBWE, VocoderWithBWEConfig

    module = (VocoderWithBWE if isinstance(cfg, VocoderWithBWEConfig) else Vocoder)(cfg, device=device)
    return init_vocoder_(module, torch.Generator(device=device).manual_seed(seed))


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


def make_temporal_upscaler(device: torch.device, seed: int = 9) -> TemporalUpscaler:
    """The full-width temporal upscaler (hidden 512), fp32 as in the JAX
    package, random weights from `seed`."""
    upscaler = TemporalUpscaler(TemporalUpscalerConfig(), device=device)
    return init_temporal_upscaler_(upscaler, torch.Generator(device=device).manual_seed(seed))


def make_gemma(device: torch.device, seed: int = 3, cfg: Gemma3Config = Gemma3Config()) -> Gemma3:
    """Gemma-3 of config `cfg` (default: the full-width 12B, 48 layers,
    fp32), random weights drawn on the device from `seed`."""
    return init_gemma3_(Gemma3(cfg, device=device), torch.Generator(device=device).manual_seed(seed))


def make_text_encoder(device: torch.device, seed: int = 4, cfg: TextEncoderConfig = TextEncoderConfig(),
                      audio: bool = False) -> VideoTextEncoder:
    """The V1 text encoder above Gemma (feature extractor over 49 states of
    3840, 2-block 30 x 128 connector; with `audio` an audio connector of the
    same shape), fp32, random weights from `seed`."""
    if audio:
        cfg = dataclasses.replace(cfg, audio_connector=cfg.connector)
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


def tokenize_prompts(gemma_dir: str, prompt: str, negative_prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prompt and the negative prompt through the tokenizer.json of
    `gemma_dir`, as the JAX CLI tokenizes them: (2, 1024) int64 ids and
    mask, left-padded, truncated on the right, with the template's <bos>."""
    ids, mask = tokenize(gemma_dir, [prompt, negative_prompt], CONTEXT_TOKENS)
    return torch.from_numpy(ids), torch.from_numpy(mask)


def encode_prompts(seeds: Sequence[int], gemma: Gemma3, text_encoder: Optional[VideoTextEncoder],
                   device: torch.device, stats: Sequence[dict], negatives: bool = False,
                   tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   embeddings: Optional[list] = None, audio_contexts: Optional[list] = None
                   ) -> List[torch.Tensor]:
    """Each request's prompt and negative prompt through Gemma and the text
    encoder as one batch of 2; returns the prompts' (1, S, D) video contexts
    (with `negatives` the (2, S, D) prompt and negative pair; D 3840 for V1,
    4096 for V2, whose encoder also makes the audio encodings) and writes
    into each request's stats the encode's seconds, the token lengths and
    their source and the prompt context's finiteness and std. `tokens`: the
    (2, L) ids and mask of the tokenized prompts (`tokenize_prompts`), the
    same for every request; None draws them from each request's seed
    (`prompt_tokens`). `embeddings`, when given, receives each request's
    encodings as host arrays under the JAX CLI's npz keys (`positive`,
    `negative`; with an audio connector also `positive_audio`,
    `negative_audio`); `audio_contexts`, when given, each request's audio
    encodings as the contexts are returned (None without an audio
    connector). `text_encoder` None is `--early-layers-only`: the contexts
    are Gemma's layer-0 hidden state (the scaled embedding) with the padding
    zeroed, as the JAX CLI makes them."""
    contexts = []
    for seed, st in zip(seeds, stats):
        if tokens is None:
            ids, mask, (st["prompt_tokens"], st["negative_tokens"]) = prompt_tokens(seed, gemma.cfg.vocab_size)
            st["prompt_source"] = "seeded"
        else:
            ids, mask = tokens
            st["prompt_tokens"], st["negative_tokens"] = (int(n) for n in mask.sum(dim=1))
            st["prompt_source"] = "tokenizer"
            if int(ids.max()) >= gemma.cfg.vocab_size:
                raise ValueError(f"token id {int(ids.max())} is outside Gemma's vocabulary of {gemma.cfg.vocab_size}: "
                                 "the tokenizer does not belong to this Gemma")
        ids, mask = ids.to(device), mask.to(device)
        _sync(device)
        t0 = time.perf_counter()
        _, hidden = gemma3_apply(gemma, ids, mask)
        audio = None
        if text_encoder is None:
            encoding = hidden[0] * mask[:, :, None].to(hidden.dtype)
        elif hasattr(text_encoder, "audio_embeddings_connector"):
            out = av_text_encoder_apply(text_encoder, hidden, mask)
            encoding, audio = out.video_encoding, out.audio_encoding
        else:
            encoding = video_text_encoder_apply(text_encoder, hidden, mask).video_encoding
        _sync(device)
        st["text_encode_s"] = time.perf_counter() - t0
        del hidden
        if embeddings is not None:
            saved = {"positive": encoding[0:1], "negative": encoding[1:2]}
            if audio is not None:
                saved.update(positive_audio=audio[0:1], negative_audio=audio[1:2])
            embeddings.append({k: v.float().cpu().numpy() for k, v in saved.items()})
        if audio_contexts is not None:
            audio_contexts.append(None if audio is None else audio if negatives else audio[0:1])
        del audio
        context = encoding[0:1]
        st["context_finite"] = bool(torch.isfinite(encoding).all())
        st["context_std"] = float(context.std())
        contexts.append(encoding if negatives else context)
    return contexts


# The flows' `text_encoder` for `--early-layers-only`: Gemma's layer-0 state, no encoder.
EARLY_LAYERS = "early-layers"


def _gemma(stats, device, ledger) -> Gemma3:
    """Gemma: the ledger's, else the full-width fp32 12B from seed 3."""
    return _built(device, stats[0], "gemma_init_s", "gemma",
                  ledger.gemma if ledger is not None else (lambda: make_gemma(device)))


def _text_encoder(stats, device, ledger, audio: bool) -> VideoTextEncoder:
    """The text encoder: the ledger's, else the V1 one from seed 4 (with
    `audio` its audio connector too)."""
    if ledger is not None:
        return _built(device, stats[0], "text_encoder_init_s", "text_encoder", ledger.text_encoder)
    return _built(device, stats[0], "text_encoder_init_s", ("text_encoder", audio),
                  lambda: make_text_encoder(device, audio=audio))


def _encode_phase(seeds, stats, device, gemma: Optional[Gemma3], text_encoder: Optional[VideoTextEncoder],
                  phase_peaks: bool, negatives: bool = False, tokens=None, embeddings=None, audio_contexts=None):
    """The text-encode phase: builds what is not given (with `audio_contexts`
    a V1 encoder with its audio connector; `text_encoder` EARLY_LAYERS: no
    encoder, Gemma's layer-0 state), encodes every request (`encode_prompts`)
    and returns the contexts; the modules it built are released when it
    returns."""
    if gemma is None:
        gemma = _gemma(stats, device, None)
    if text_encoder == EARLY_LAYERS:
        text_encoder = None
    elif text_encoder is None:
        text_encoder = _text_encoder(stats, device, None, audio_contexts is not None)
    contexts = encode_prompts(seeds, gemma, text_encoder, device, stats, negatives, tokens, embeddings,
                              audio_contexts)
    stats[0]["text_encode_peak_gb"] = _phase_peak(device, phase_peaks)
    return contexts


def _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks: bool,
                   negatives: bool = False, tokens=None, embeddings=None, audio_contexts=None):
    """The contexts of the two-stage and the CFG flows: those given, or with
    `text_encoder` (True or a module) each request's prompts (`tokens`, or
    seeded ids) encoded, Gemma and the text encoder built (or read through
    `ledger`) and released before the DiT (with EARLY_LAYERS Gemma's layer-0
    state, no encoder: `--early-layers-only`); None when neither (the dummy
    contexts are drawn later). Each request's stats get its
    `prompt_source` ("tokenizer", "seeded", "contexts" or "dummy").
    `audio_contexts`: a list that receives each request's audio encodings
    (None where the encoder has no audio connector). Returns (contexts,
    whether they were encoded)."""
    encode = text_encoder is True or text_encoder == EARLY_LAYERS or isinstance(text_encoder, VideoTextEncoder)
    if gemma is not None and not encode:
        raise ValueError("gemma is given but text encoding is off (text_encoder=False)")
    if encode and contexts is not None:
        raise ValueError("contexts and text_encoder are exclusive: the encoder makes the contexts")
    if (tokens is not None or embeddings is not None) and not encode:
        raise ValueError("prompt tokens and embeddings need text encoding (text_encoder)")
    if not encode:
        for st in stats:
            st["prompt_source"] = "dummy" if contexts is None else "contexts"
        return contexts, False
    if ledger is not None:
        gemma = _gemma(stats, device, ledger)
        if text_encoder != EARLY_LAYERS:
            text_encoder = _text_encoder(stats, device, ledger, False)
        ledger.clear_model("gemma")
        ledger.clear_model("text_encoder")
    contexts = _encode_phase(seeds, stats, device, gemma,
                             text_encoder if isinstance(text_encoder, VideoTextEncoder) or text_encoder == EARLY_LAYERS
                             else None, phase_peaks, negatives, tokens, embeddings, audio_contexts)
    gemma = text_encoder = None
    _free(device)
    _phase_peak(device, phase_peaks)  # the next phase's peak starts from what is left
    return contexts, True


def _dit_and_encoder(stats, device, layers: int, dit, encoder, images, ledger, context_width: Optional[int],
                     dtype: str = "bfloat16", audio: bool = False, fp8: bool = True, int8: bool = False,
                     meshes: Optional[dict] = None):
    """The DiT (given, from `ledger`, or random at `layers` in `dtype`, with
    a caption projection from `context_width` channels when the contexts
    are not the model's 4096 wide; with `audio` the audio-video DiT, kept in
    fp8 when random and `fp8`; a random DiT's matmul weights int8 W8A8 with
    `int8`) and, when there are images, the video
    encoder (given, from `ledger`, or random), each timed. Raises when the
    DiT's text input (its caption projection's, else its context width)
    does not take `context_width` channels, and when `audio` is asked of a
    video-only DiT. Under `meshes` the DiT is this rank's placement
    (`place_transformer`; a random one drawn as its stage, `make_dit`), and
    its weight bytes in the stats are the rank's."""
    if dit is None and ledger is not None:
        dit = _built(device, stats[0], "dit_init_s", "transformer", ledger.transformer)
    elif dit is None:
        base = av_config(LTXModelConfig(compute_dtype=dtype)) if audio else LTXModelConfig(compute_dtype=dtype)
        if context_width not in (None, base.cross_attention_dim):
            base = dataclasses.replace(base, caption_channels=context_width)
        check_pipe_stages(layers, meshes)
        dit = _random_dit(stats, device, layers, base, fp8=audio and fp8 and not int8, int8=int8,
                          pipe_axis=pipe_axis_of(meshes))
    if meshes:
        dit = place_transformer(dit, meshes)
    stats[0]["dit_weight_gb"] = weight_bytes(dit) / 1e9
    if audio and not dit.cfg.is_av:
        raise ValueError("audio needs the audio-video DiT (a checkpoint loaded with include_audio, or av_config)")
    takes = dit.cfg.caption_channels or dit.cfg.cross_attention_dim
    if context_width is not None and takes != context_width:
        raise ValueError(f"the DiT's text input (caption_channels {dit.cfg.caption_channels}, else its "
                         f"cross_attention_dim {dit.cfg.cross_attention_dim}) does not take the "
                         f"{context_width}-channel text context")
    if images and encoder is None:
        encoder = _built(device, stats[0], "encoder_init_s", "video_encoder",
                         ledger.video_encoder if ledger is not None else (lambda: make_encoder(device)))
    return dit, encoder


def _random_dit(stats, device, layers: int, base: LTXModelConfig, fp8: bool = False, int8: bool = False,
                pipe_axis=None) -> LTXModel:
    """`make_dit(layers, base=base, fp8=fp8, int8=int8, pipe_axis=pipe_axis)`,
    timed (kept by its settings inside `resident`)."""
    stage = None if pipe_axis is None else (pipe_axis.index, pipe_axis.size)
    return _built(device, stats[0], "dit_init_s", ("dit", layers, repr(base), fp8, int8, stage),
                  lambda: make_dit(layers, device, base=base, fp8=fp8, int8=int8, pipe_axis=pipe_axis))


def _spatial_upscaler(stats, device, upscaler, ledger, needed_by: Optional[str]) -> Optional[SpatialUpscaler]:
    """The spatial upscaler (given, from `ledger`, or random), timed. A
    ledger without the upscaler's file raises naming `needed_by`, or with
    `needed_by` None gives None (keyframe and ti2vid-hq then run one stage,
    as the JAX CLI runs them without --spatial-upscaler)."""
    if upscaler is None:
        upscaler = _built(device, stats[0], "upscaler_init_s", "spatial_upscaler",
                          ledger.spatial_upscaler if ledger is not None else (lambda: make_upscaler(device)))
        if upscaler is None and needed_by is not None:
            raise ValueError(f"{needed_by} needs the spatial upscaler's file (spatial_upscaler_path)")
    return upscaler


def _temporal_upscaler(stats, device, ledger) -> TemporalUpscaler:
    """The temporal upscaler (from `ledger`, or random), timed."""
    upscaler = _built(device, stats[0], "temporal_upscaler_init_s", "temporal_upscaler",
                      ledger.temporal_upscaler if ledger is not None else (lambda: make_temporal_upscaler(device)))
    if upscaler is None:
        raise ValueError("--upscale-temporal needs the temporal upscaler's file (temporal_upscaler_path)")
    return upscaler


def _latent_statistics(cfg: LTXModelConfig, decoder, ledger, device) -> PerChannelStatistics:
    """The latent statistics of the upscale bracket: the decoder's, the
    checkpoint's, or the defaults (0, 1) a random decoder holds."""
    if decoder is not None:
        return decoder.per_channel_statistics
    if ledger is not None:
        return _built(device, {}, "statistics_s", "latent_statistics",
                      lambda: load_per_channel_statistics(ledger.checkpoint_path, cfg.in_channels, device))
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


def make_latent_tools(cfg: LTXModelConfig, height: int, width: int, frames: int, fps: float = FPS
                      ) -> VideoLatentTools:
    pixel = VideoPixelShape(batch=1, frames=frames, height=height, width=width, fps=fps)
    return VideoLatentTools(
        patchifier=VideoLatentPatchifier(1),
        target_shape=VideoLatentShape.from_pixel_shape(pixel, latent_channels=cfg.in_channels),
        fps=fps,
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


def dummy_context(cfg: LTXModelConfig, generator: torch.Generator, device: torch.device,
                  audio: bool = False) -> torch.Tensor:
    """The `--no-gemma` text context: normal * 0.02, (1, 1024, the DiT's
    text input width: its caption projection's, else its context dim; for
    the audio stream its caption projection's, else the stream's width)."""
    width = cfg.caption_channels or (cfg.audio_inner_dim if audio else cfg.cross_attention_dim)
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
    fps: float = FPS,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    int8: bool = False,
) -> Tuple[List[np.ndarray], List[dict]]:
    """Generate one clip per seed; returns (uint8 (frames, height, width, 3)
    arrays, per-request stats); with `skip_decode` the (1, C, F, H, W)
    fp32 latents in place of the frames, and no decoder is built. `fps`
    goes into the position grid; `dtype` is the random DiT's compute dtype;
    `int8` draws the random DiT with int8 W8A8 matmul weights in place of fp8.

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
        dit = _random_dit(stats, device, layers, LTXModelConfig(compute_dtype=dtype), fp8=not int8, int8=int8)
    stats[0]["dit_weight_gb"] = weight_bytes(dit) / 1e9
    cfg = dit.cfg
    tools = make_latent_tools(cfg, height, width, frames, fps)
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
    if skip_decode:
        return [latent.float().cpu().numpy() for latent in latents], stats

    if decoder is None:
        decoder = _video_decoder(stats, device, None, cfg.compute_dtype)

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
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    audio: bool = False,
    audio_contexts: Optional[Sequence[torch.Tensor]] = None,
    audio_noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    audio_decoder: Optional[AudioDecoder] = None,
    vocoder=None,
    internal_audio: bool = True,
    int8: bool = False,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """The two-stage distilled recipe, one clip per seed; returns (uint8
    (frames, height, width, 3) arrays, per-request stats); with
    `skip_decode` the (1, C, F, H, W) fp32 latents in place of the frames,
    and no decoder is built.

    With `audio` the audio-video DiT (the ledger's, loaded with
    `include_audio`; else random at full width, kept in fp8) denoises the
    audio stream beside the video in both stages, and each entry of the
    result is the pair (frames, (2, samples) fp32 waveform), or with
    `skip_decode` (latent, (1, C, T, F) audio latent): after the video
    decode the audio decoder and the vocoder (given, the ledger's, or
    random: the published AudioDecoderConfig() from seed 6, VocoderConfig()
    from seed 7) decode each clip's audio latent; the stats hold the
    waveform's `audio_sample_rate`, `audio_samples` and the audio decode's
    seconds and peak. `audio_contexts[i]` is request i's (1, S, D) audio
    context (default: the text encoder's audio encoding, else the dummy one
    drawn after the video context, else the video context itself when that
    was given); `audio_noises[i]` its (stage-1, stage-2) audio noise;
    `internal_audio` is the configs' `use_internal_audio_branch` (off: a
    given audio-video DiT runs its video stream alone unless `audio`).

    `tokens` (the tokenized prompt and negative prompt, `tokenize_prompts`)
    and `embeddings` go to `encode_prompts`; `fps` into the position grids;
    `tiling` replaces the decode's tiling (`DistilledConfig.tiling_config`);
    `dtype` is the random DiT's compute dtype.

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
    caller that owns them asks for it. `meshes` (`build_meshes`): the
    loops token-split over "sequence_mesh" or staged over "pipeline_mesh",
    the DiT this rank's TP shard or pipeline stage (`place_transformer`),
    the decode over "vae_mesh" / "vae_w_mesh".
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
    encoded_audio = [] if audio and audio_contexts is None else None
    contexts, encoded = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                       tokens=tokens, embeddings=embeddings, audio_contexts=encoded_audio)
    if encoded_audio and all(a is not None for a in encoded_audio):
        audio_contexts = encoded_audio
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, audio,
                                    int8=int8, meshes=meshes)
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, "the two-stage recipe")
    cfg = dit.cfg
    statistics = _latent_statistics(cfg, decoder, ledger, device)
    pipe = DistilledPipeline(dit, upscaler, statistics=statistics, video_encoder=encoder,
                             **loop_meshes(meshes))

    configs, latents, audio_latents = [], [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = DistilledConfig(height=height, width=width, num_frames=frames, seed=seed, dtype=cfg.compute_dtype,
                                 latent_channels=cfg.in_channels, fps=fps, tiling_config=tiling, audio_enabled=audio,
                                 use_internal_audio_branch=internal_audio)
        gen = torch.Generator(device=device).manual_seed(seed)
        context = contexts[i] if contexts is not None else dummy_context(cfg, gen, device)
        audio_context = None
        if audio:
            audio_context = (audio_contexts[i] if audio_contexts is not None else
                             context if contexts is not None else dummy_context(cfg, gen, device, audio=True))
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        out = pipe(context, config, images=images, callback=on_phase, skip_decode=True,
                   noises=None if noises is None else noises[i], audio_encoding=audio_context,
                   audio_noises=None if audio_noises is None else audio_noises[i])
        latent, audio_latent = out if audio else (out, None)
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)
        audio_latents.append(audio_latent)

    del dit, upscaler, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder"):
            ledger.clear_model(name)
    return _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                    lambda seed: stage_seeds(seed)[2], skip_decode, audio_decoder, vocoder, meshes), stats


def generate_videos_keyframe(
    seeds: Sequence[int],
    keyframes: Sequence,
    *,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    steps: int = 30,
    cfg_scale: float = 7.5,
    stage_2_steps: int = 3,
    token_shift: bool = False,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    upscaler: Optional[SpatialUpscaler] = None,
    decoder: Optional[VideoDecoder] = None,
    encoder: Optional[VideoEncoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    int8: bool = False,
    end_states: Optional[list] = None,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """Keyframe interpolation (pipelines/keyframe_interpolation.py), one
    clip per seed: `keyframes` (`Keyframe`s: PNG, pixel frame, strength)
    encoded by the video encoder and appended past the sequence's end;
    stage 1 at half size, `steps` CFG Euler steps at `cfg_scale` against a
    zero negative context; the 2x upscaler; stage 2 on the first
    `stage_2_steps` sigmas of the distilled tail, no guidance; the decode.
    Without an upscaler (a ledger without the upscaler's file) one stage at
    full size, as the JAX CLI runs it. Contexts (each request's (1, S, D)
    prompt), the ledger, Gemma, the tokens and embeddings, the random
    weights' seeds, `phase_peaks`, `tiling`, `skip_decode` and `int8` as in
    `generate_videos_distilled`; `noises[i]` request i's (stage-1, stage-2)
    noise, the appended tokens included; `end_states`, when given,
    receives each stage's final loop state (its keyframe tokens too). Stats
    per request: the seconds and peaks of the text encode, stage 1,
    upscale, stage 2 and decode, the launches, the latents' finiteness.
    `meshes` as in `generate_videos_distilled`."""
    from ltx2_tpu_torch.pipelines.keyframe_interpolation import (
        KeyframeInterpolationConfig, KeyframeInterpolationPipeline,
    )

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keyframes = list(keyframes)
    modules = (dit, upscaler, decoder, encoder, gemma,
               text_encoder if isinstance(text_encoder, VideoTextEncoder) else None)
    if ledger is not None and any(m is not None for m in modules):
        raise ValueError("with a ledger every component comes from its files: pass no module")
    stats = [{"seed": seed, "dit_init_s": 0.0, "upscaler_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    _phase_peak(device, phase_peaks)
    contexts, _ = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                 tokens=tokens, embeddings=embeddings)
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, keyframes, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, int8=int8,
                                    meshes=meshes)
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, None)
    cfg = dit.cfg
    pipe = KeyframeInterpolationPipeline(dit, upscaler, statistics=_latent_statistics(cfg, decoder, ledger, device),
                                         video_encoder=encoder, **loop_meshes(meshes))
    configs, latents = [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = KeyframeInterpolationConfig(
            height=height, width=width, num_frames=frames, seed=seed, fps=fps, num_inference_steps=steps,
            cfg_scale=cfg_scale, stage_2_steps=stage_2_steps, token_dependent_shift=token_shift,
            tiling_config=tiling, dtype=cfg.compute_dtype, latent_channels=cfg.in_channels)
        gen = torch.Generator(device=device).manual_seed(seed)
        context = contexts[i] if contexts is not None else dummy_context(cfg, gen, device)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        latent = pipe(context, config, keyframes=keyframes, callback=on_phase, skip_decode=True,
                      noises=None if noises is None else noises[i], end_states=end_states)
        st["stage1_step_s"] = st["stage1_s"] / steps
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)

    del dit, upscaler, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder"):
            ledger.clear_model(name)
    return _outputs(latents, [None] * len(latents), configs, stats, device, decoder, ledger, cfg.compute_dtype,
                    phase_peaks, lambda seed: stage_seeds(seed)[2], skip_decode, None, None, meshes), stats


def generate_videos_ti2vid_hq(
    seeds: Sequence[int],
    *,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    steps: int = 15,
    cfg_scale: float = 3.0,
    audio_cfg_scale: float = 7.0,
    token_shift: bool = False,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    upscaler: Optional[SpatialUpscaler] = None,
    decoder: Optional[VideoDecoder] = None,
    encoder: Optional[VideoEncoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    images: Optional[Sequence[ImageCondition]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    audio: bool = False,
    audio_contexts: Optional[Sequence[torch.Tensor]] = None,
    audio_noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    audio_decoder: Optional[AudioDecoder] = None,
    vocoder=None,
    internal_audio: bool = True,
    int8: bool = False,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """TI2Vid-HQ (pipelines/ti2vid_hq.py), one clip per seed: stage 1 at
    half size, `steps` LTX2Scheduler sigmas through the Res2s RK loop
    under CFG at `cfg_scale` (two guided evaluations a step, each on the
    prompt and negative rows; with `audio` the audio stream at
    `audio_cfg_scale`), the 2x upscaler, the distilled stage 2, the
    decodes. Without an upscaler (a ledger without its file) the stage-1
    latent is the result, as the JAX CLI runs it. Arguments as in
    `generate_videos_two_stage`. Stats per request: the seconds and peaks
    of the text encode, stage 1 (and a step), upscale, stage 2, decode and
    audio decode, the launches, the latents' finiteness.
    `meshes` as in `generate_videos_distilled`."""
    from ltx2_tpu_torch.pipelines.ti2vid_hq import TI2VidHQConfig, TI2VidHQPipeline

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
    encoded_audio = [] if audio and audio_contexts is None else None
    contexts, _ = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                 negatives=True, tokens=tokens, embeddings=embeddings, audio_contexts=encoded_audio)
    if encoded_audio and all(a is not None for a in encoded_audio):
        audio_contexts = encoded_audio
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, audio, int8=int8,
                                    meshes=meshes)
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, None)
    cfg = dit.cfg
    pipe = TI2VidHQPipeline(dit, upscaler, statistics=_latent_statistics(cfg, decoder, ledger, device),
                            video_encoder=encoder, **loop_meshes(meshes))
    configs, latents, audio_latents = [], [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = TI2VidHQConfig(
            height=height, width=width, num_frames=frames, seed=seed, fps=fps, num_inference_steps=steps,
            cfg_scale=cfg_scale, audio_cfg_scale=audio_cfg_scale, token_dependent_shift=token_shift,
            tiling_config=tiling, dtype=cfg.compute_dtype, latent_channels=cfg.in_channels, audio_enabled=audio,
            use_internal_audio_branch=internal_audio)
        gen = torch.Generator(device=device).manual_seed(seed)
        (positive, negative), (positive_a, negative_a) = _context_pairs(cfg, contexts, audio_contexts, i, gen,
                                                                        device, audio)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        out = pipe(positive, negative, config, images=images, callback=on_phase, skip_decode=True,
                   positive_audio_encoding=positive_a, negative_audio_encoding=negative_a,
                   noises=None if noises is None else noises[i],
                   audio_noises=None if audio_noises is None else audio_noises[i])
        latent, audio_latent = out if audio else (out, None)
        st["stage1_step_s"] = st["stage1_s"] / steps
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)
        audio_latents.append(audio_latent)

    del dit, upscaler, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder"):
            ledger.clear_model(name)
    return _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                    lambda seed: stage_seeds(seed)[2], skip_decode, audio_decoder, vocoder, meshes), stats


def generate_videos_retake(
    seeds: Sequence[int],
    video: str,
    *,
    start_time: float = 0.0,
    end_time: float = 1.0,
    steps: int = 30,
    cfg_scale: float = 3.0,
    cfg_interval: int = 1,
    token_shift: bool = False,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    encoder: Optional[VideoEncoder] = None,
    decoder: Optional[VideoDecoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    int8: bool = False,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """Retake (pipelines/retake.py), one clip per seed: `video` (probed and
    read once, at its own height, width and fps, its frames snapped down to
    8k + 1) encoded by the fp32 video encoder, the latent frames of
    [`start_time`, `end_time`) seconds re-noised and denoised over `steps`
    CFG Euler steps at `cfg_scale` (`cfg_interval` guidance reuse,
    `token_shift`), every other frame kept, the decode. Contexts (each
    request's (2, S, D) prompt and negative pair), the ledger, Gemma, the
    tokens and embeddings, the random weights' seeds, `phase_peaks`,
    `tiling`, `skip_decode` and `int8` as in `generate_videos_one_stage`;
    `noises[i]` request i's patchified noise. Stats per request: the read's
    seconds, the seconds and peaks of the encode, denoise (and a step) and
    decode, the launches, the latent's finiteness, the retaken latent frames
    and `frozen_exact`: whether every token outside them came out of the
    loop bit for bit the encoder's latent.
    `meshes` as in `generate_videos_distilled`."""
    from ltx2_tpu_torch.pipelines.retake import (
        RetakeConfig, RetakePipeline, TemporalRegionMask, get_video_metadata, load_video_frames,
    )

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modules = (dit, decoder, encoder, gemma, text_encoder if isinstance(text_encoder, VideoTextEncoder) else None)
    if ledger is not None and any(m is not None for m in modules):
        raise ValueError("with a ledger every component comes from its files: pass no module")
    stats = [{"seed": seed, "dit_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    t0 = time.perf_counter()
    fps, n_frames, src_h, src_w = get_video_metadata(video)
    n_frames = n_frames - (n_frames - 1) % 8  # 8k + 1
    source_video = torch.from_numpy(load_video_frames(video, src_h, src_w, n_frames))
    stats[0]["read_s"] = time.perf_counter() - t0
    _phase_peak(device, phase_peaks)
    contexts, _ = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                 negatives=True, tokens=tokens, embeddings=embeddings)
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, [video], ledger,  # the source is encoded
                                    None if contexts is None else contexts[0].shape[-1], dtype, int8=int8,
                                    meshes=meshes)
    cfg = dit.cfg
    pipe = RetakePipeline(dit, video_encoder=encoder, **loop_meshes(meshes))
    configs, latents = [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        # The latent state in RetakeConfig's float32, as the JAX CLI runs it.
        config = RetakeConfig(start_time=start_time, end_time=end_time, seed=seed, num_inference_steps=steps,
                              cfg_scale=cfg_scale, cfg_interval=cfg_interval, latent_channels=cfg.in_channels,
                              tiling_config=tiling, token_dependent_shift=token_shift)
        gen = torch.Generator(device=device).manual_seed(seed)
        (positive, negative), _ = _context_pairs(cfg, contexts, None, i, gen, device, False)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        clean = {}

        def record(phase: str, latent: torch.Tensor, on_phase=on_phase, clean=clean) -> None:
            on_phase(phase, latent)
            if phase == "encode":
                clean["latent"] = latent

        latent = pipe(None, positive, negative, config, callback=record, source_video=source_video, fps=fps,
                      skip_decode=True, noise=None if noises is None else noises[i])
        first, last = TemporalRegionMask(start_time, end_time, fps).latent_frames(latent.shape[2])
        kept = torch.ones(latent.shape[2], dtype=torch.bool)
        kept[first:last] = False
        st["retake_latent_frames"] = [first, last]
        st["frozen_exact"] = bool(torch.equal(latent[:, :, kept], clean.pop("latent")[:, :, kept]))
        st["denoise_step_s"] = st["denoise_s"] / steps
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(OneStageCFGConfig(height=src_h, width=src_w, num_frames=n_frames, seed=seed,
                                         tiling_config=tiling, latent_channels=cfg.in_channels))
        latents.append(latent)

    del dit, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "video_encoder"):
            ledger.clear_model(name)
    return _outputs(latents, [None] * len(latents), configs, stats, device, decoder, ledger, cfg.compute_dtype,
                    phase_peaks, lambda seed: stage_seeds(seed, 2)[1], skip_decode, None, None, meshes), stats


def generate_videos_ic_lora(
    seeds: Sequence[int],
    control_video: Optional[str] = None,
    *,
    control_type: str = "raw",
    control_strength: float = 0.95,
    canny_low: int = 100,
    canny_high: int = 200,
    save_control: bool = False,
    ic_lora: Optional[LoRAConfig] = None,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    upscaler: Optional[SpatialUpscaler] = None,
    decoder: Optional[VideoDecoder] = None,
    encoder: Optional[VideoEncoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    audio: bool = False,
    audio_contexts: Optional[Sequence[torch.Tensor]] = None,
    audio_noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    audio_decoder: Optional[AudioDecoder] = None,
    vocoder=None,
    internal_audio: bool = True,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """IC-LoRA control (pipelines/ic_lora.py), one clip per seed: the
    distilled recipe with `control_video` (`control_type` "raw" or "canny",
    the port's OpenCV steps) read at stage 1's size, encoded and appended
    at frame 0 with `control_strength` (with `save_control` also written as
    `<video>.control.avi`), and
    `ic_lora` fused into the DiT for stage 1 only; stage 2 on the base
    weights, the decodes. The DiT takes the LoRA's deltas, so a random one
    is drawn in `dtype` (bf16), never kept in fp8. Without an upscaler (a
    ledger without its file) the stage-1 latent is the result, as the JAX
    pipeline runs it. Other arguments as in `generate_videos_distilled`.
    Stats per request: the seconds and peaks of the text encode, LoRA fuse,
    control encode, stage 1, LoRA unfuse, upscale, stage 2, decode and audio
    decode, the launches, the latents' finiteness.
    `meshes` as in `generate_videos_distilled`."""
    from ltx2_tpu_torch.pipelines.ic_lora import ControlType, ICLoraConfig, ICLoraPipeline, VideoCondition

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modules = (dit, upscaler, decoder, encoder, gemma,
               text_encoder if isinstance(text_encoder, VideoTextEncoder) else None)
    if ledger is not None and any(m is not None for m in modules):
        raise ValueError("with a ledger every component comes from its files: pass no module")
    videos = [] if control_video is None else [VideoCondition(
        video_path=control_video, strength=control_strength, control_type=ControlType(control_type),
        canny_low=canny_low, canny_high=canny_high, save_control=save_control)]
    stats = [{"seed": seed, "dit_init_s": 0.0, "upscaler_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    _phase_peak(device, phase_peaks)
    encoded_audio = [] if audio and audio_contexts is None else None
    contexts, _ = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                 tokens=tokens, embeddings=embeddings, audio_contexts=encoded_audio)
    if encoded_audio and all(a is not None for a in encoded_audio):
        audio_contexts = encoded_audio
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, videos, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, audio, fp8=False,
                                    meshes=meshes)
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, None)
    cfg = dit.cfg
    pipe = ICLoraPipeline(dit, upscaler, statistics=_latent_statistics(cfg, decoder, ledger, device),
                          video_encoder=encoder, **loop_meshes(meshes))
    configs, latents, audio_latents = [], [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = ICLoraConfig(height=height, width=width, num_frames=frames, seed=seed, dtype=cfg.compute_dtype,
                              latent_channels=cfg.in_channels, fps=fps, tiling_config=tiling, audio_enabled=audio,
                              use_internal_audio_branch=internal_audio, ic_lora_config=ic_lora)
        gen = torch.Generator(device=device).manual_seed(seed)
        context = contexts[i] if contexts is not None else dummy_context(cfg, gen, device)
        audio_context = None
        if audio:
            audio_context = (audio_contexts[i] if audio_contexts is not None else
                             context if contexts is not None else dummy_context(cfg, gen, device, audio=True))
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        with _weights_restored(dit, [ic_lora] if ic_lora is not None else []):
            out = pipe(context, config, videos=videos, callback=on_phase,
                       audio_encoding=audio_context, skip_decode=True, noises=None if noises is None else noises[i],
                       audio_noises=None if audio_noises is None else audio_noises[i])
        latent, audio_latent = out if audio else (out, None)
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)
        audio_latents.append(audio_latent)

    del dit, upscaler, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder"):
            ledger.clear_model(name)
    return _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                    lambda seed: stage_seeds(seed)[2], skip_decode, audio_decoder, vocoder, meshes), stats


def _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, compute_dtype: str, phase_peaks: bool,
             decode_seed, skip_decode: bool, audio_decoder, vocoder, meshes: Optional[dict] = None) -> list:
    """Each request's result: its latent (and audio latent) as fp32 host
    arrays with `skip_decode`, else its decoded frames (`_decode_phase`) and,
    where there is an audio latent, its waveform (`_audio_decode_phase`), as
    pairs when there is audio."""
    audio = any(a is not None for a in audio_latents)

    def host(x):
        return x.float().cpu().numpy()

    if skip_decode:
        outs = [host(z) for z in latents]
        return [(z, host(a)) for z, a in zip(outs, audio_latents)] if audio else outs
    videos = _decode_phase(latents, configs, stats, device, decoder, ledger, compute_dtype, phase_peaks, decode_seed,
                           meshes)
    if not audio:
        return videos
    waves = _audio_decode_phase(audio_latents, stats, device, audio_decoder, vocoder, ledger, phase_peaks)
    return list(zip(videos, waves))


def _audio_decode_phase(audio_latents, stats, device, audio_decoder, vocoder, ledger, phase_peaks: bool
                        ) -> List[np.ndarray]:
    """After the video decode: the audio decoder and the vocoder (given,
    from `ledger`, or random), each clip's audio latent decoded to a (2,
    samples) fp32 waveform on the host, with the seconds, peak memory,
    sample rate and length in its stats. TF32 stays off: the JAX package
    runs these convs at HIGHEST precision."""
    _free(device)
    _phase_peak(device, phase_peaks)
    if audio_decoder is None:
        audio_decoder = _audio_decoder(stats, device, ledger)
    if vocoder is None:
        vocoder = _vocoder(stats, device, ledger)
    if audio_decoder is None or vocoder is None:
        raise ValueError("the checkpoint holds no audio decoder or no vocoder: audio cannot be decoded")
    waves = []
    for latent, st in zip(audio_latents, stats):
        t0 = time.perf_counter()
        wave = decode_audio(latent, audio_decoder, vocoder)[0].cpu().numpy()
        st["audio_decode_s"] = time.perf_counter() - t0  # host waveform: synchronised
        st["audio_decode_peak_gb"] = _phase_peak(device, phase_peaks)
        st["audio_sample_rate"] = vocoder.cfg.output_sample_rate
        st["audio_samples"] = int(wave.shape[-1])
        st["audio_finite"] = bool(np.isfinite(wave).all())
        waves.append(wave)
    if ledger is not None:
        ledger.clear_model("audio_decoder")
        ledger.clear_model("vocoder")
    return waves


def _audio_decoder(stats, device, ledger) -> Optional[AudioDecoder]:
    """The audio VAE decoder: the ledger's (None when the file has none),
    else the published one from seed 6."""
    return _built(device, stats[0], "audio_decoder_init_s", "audio_decoder",
                  ledger.audio_decoder if ledger is not None else (lambda: make_audio_decoder(device)))


def _vocoder(stats, device, ledger):
    """The vocoder: the ledger's (None when the file has none), else LTX-2's
    from seed 7."""
    return _built(device, stats[0], "vocoder_init_s", "vocoder",
                  ledger.vocoder if ledger is not None else (lambda: make_vocoder(device)))


def _decode_phase(latents, configs, stats, device, decoder, ledger, compute_dtype: str, phase_peaks: bool,
                  decode_seed, meshes: Optional[dict] = None) -> List[np.ndarray]:
    """After the denoise phase's modules are released: the decoder (given,
    from `ledger`, or random), then each clip decoded (tiled as its config
    decides, decode noise from `decode_seed(config.seed)`; over the meshes'
    "vae_mesh" / "vae_w_mesh"), with its seconds, peak memory, tiles and
    conv launches in its stats."""
    meshes = meshes or {}
    _free(device)
    _phase_peak(device, phase_peaks)
    if decoder is None:
        decoder = _video_decoder(stats, device, ledger, compute_dtype)
    videos = []
    for latent, config, st in zip(latents, configs, stats):
        tiling_used = config.effective_tiling()
        st["decode_tiles"] = len(generate_tile_specs(tuple(latent.shape), tiling_used)) if tiling_used else 0
        convs = conv3d_ndhwc_kernel.launches
        t0 = time.perf_counter()
        videos.append(decode_video(latent, decoder, tiling_used, decode_seed(config.seed),
                                   vae_mesh=meshes.get("vae_mesh"), vae_w_mesh=meshes.get("vae_w_mesh")))
        st["decode_s"] = time.perf_counter() - t0  # host frames: synchronised
        st["decode_peak_gb"] = _phase_peak(device, phase_peaks)
        st["decode_conv_launches"] = conv3d_ndhwc_kernel.launches - convs
    return videos


def _video_decoder(stats, device, ledger, compute_dtype: str) -> VideoDecoder:
    """The video decoder: the ledger's, else the full-width one in
    `compute_dtype` from seed 1."""
    if ledger is not None:
        return _built(device, stats[0], "decoder_init_s", "video_decoder", ledger.video_decoder)
    return _built(device, stats[0], "decoder_init_s", ("video_decoder", compute_dtype),
                  lambda: make_decoder(compute_dtype, device))


def _context_pairs(cfg: LTXModelConfig, contexts, audio_contexts, i: int, gen: torch.Generator, device,
                   audio: bool):
    """Request i's (positive, negative) video contexts and, with `audio`,
    its audio pair: the given (2, S, D) pairs, else dummy ones drawn from
    `gen` (the video pair first)."""
    if contexts is not None:
        video = (contexts[i][0:1], contexts[i][1:2])
    else:
        video = (dummy_context(cfg, gen, device), dummy_context(cfg, gen, device))
    if not audio:
        return video, (None, None)
    pair = audio_contexts[i] if audio_contexts is not None else torch.cat(
        [dummy_context(cfg, gen, device, audio=True) for _ in range(2)])
    return video, (pair[0:1], pair[1:2])


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
    upscale_temporal: bool = False,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    audio: bool = False,
    audio_cfg_scale: float = 7.0,
    audio_contexts: Optional[Sequence[torch.Tensor]] = None,
    audio_noises: Optional[Sequence[torch.Tensor]] = None,
    audio_decoder: Optional[AudioDecoder] = None,
    vocoder=None,
    internal_audio: bool = True,
    int8: bool = False,
    meshes: Optional[dict] = None,
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
    in the stats), and the decoder decodes the upscaled latent; with
    `upscale_temporal` the 2x temporal upscaler (the ledger's, or random
    from seed 9) runs after it in its own bracket (phase
    "upscale_temporal"): F latent frames become 2F - 1.
    `tokens`, `embeddings`, `fps`, `tiling`, `dtype` and `skip_decode` as in
    `generate_videos_distilled`; so is `audio` (the audio stream guided at
    `audio_cfg_scale`, CFG* when `rescale_scale` > 0), with
    `audio_contexts[i]` a (2, S, D) audio prompt and negative pair (default:
    the text encoder's, else two dummy ones drawn after the video pair) and
    `audio_noises[i]` request i's audio noise; `internal_audio` and
    `meshes` as there.
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
    encoded_audio = [] if audio and audio_contexts is None else None
    contexts, encoded = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                       negatives=True, tokens=tokens, embeddings=embeddings,
                                       audio_contexts=encoded_audio)
    if encoded_audio and all(a is not None for a in encoded_audio):
        audio_contexts = encoded_audio
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, audio,
                                    int8=int8, meshes=meshes)
    cfg = dit.cfg
    pipe = OneStagePipeline(dit, video_encoder=encoder, **loop_meshes(meshes))
    spatial = upscaler = temporal = temporal_upscaler = None
    if upscale_spatial or upscale_temporal:
        statistics = _latent_statistics(cfg, decoder, ledger, device)

        def bracket(apply, module):
            # Pipeline without a decoder: the bracket is applied here.
            return lambda latent: normalize_latent(apply(module, un_normalize_latent(latent, statistics)), statistics)

        if upscale_spatial:
            upscaler = _spatial_upscaler(stats, device, None, ledger, "--upscale-spatial")
            spatial = bracket(spatial_upscaler_apply, upscaler)
        if upscale_temporal:
            temporal_upscaler = _temporal_upscaler(stats, device, ledger)
            temporal = bracket(temporal_upscaler_apply, temporal_upscaler)

    configs, latents, audio_latents = [], [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = OneStageCFGConfig(height=height, width=width, num_frames=frames, seed=seed,
                                   num_inference_steps=steps, cfg_scale=cfg_scale, rescale_scale=rescale_scale,
                                   token_dependent_shift=token_shift, dtype=cfg.compute_dtype,
                                   latent_channels=cfg.in_channels, cfg_interval=cfg_interval,
                                   token_bucket=token_bucket, fps=fps, tiling_config=tiling, audio_enabled=audio,
                                   audio_cfg_scale=audio_cfg_scale, use_internal_audio_branch=internal_audio)
        gen = torch.Generator(device=device).manual_seed(seed)
        (positive, negative), audio_pair = _context_pairs(cfg, contexts, audio_contexts, i, gen, device, audio)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        latent, audio_latent = pipe(
            positive, negative, config, images=images, callback=on_phase, skip_decode=True,
            noise=None if noises is None else noises[i], spatial_upscaler=spatial, temporal_upscaler=temporal,
            positive_audio_encoding=audio_pair[0], negative_audio_encoding=audio_pair[1],
            audio_noise=None if audio_noises is None else audio_noises[i], **loop_options)
        audio_latents.append(audio_latent if audio else None)
        st["denoise_step_s"] = st["denoise_s"] / steps
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["key_valid_attention_launches"] = flash_attention.key_valid_launches - marks["key_valid"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)

    del dit, encoder, pipe, upscaler, spatial, temporal_upscaler, temporal
    if ledger is not None:
        for name in ("transformer", "video_encoder", "spatial_upscaler", "temporal_upscaler"):
            ledger.clear_model(name)
    return _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                    lambda seed: stage_seeds(seed, 2)[1], skip_decode, audio_decoder, vocoder, meshes), stats


def generate_videos_two_stage(
    seeds: Sequence[int],
    *,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    steps: int = 30,
    cfg_scale: float = 3.0,
    audio_cfg_scale: float = 7.0,
    rescale_scale: float = 0.7,
    modality_scale: float = 3.0,
    cfg_interval: int = 1,
    token_shift: bool = False,
    distilled_lora: Optional[LoRAConfig] = None,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    upscaler: Optional[SpatialUpscaler] = None,
    decoder: Optional[VideoDecoder] = None,
    encoder: Optional[VideoEncoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    images: Optional[Sequence[ImageCondition]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    audio: bool = False,
    audio_contexts: Optional[Sequence[torch.Tensor]] = None,
    audio_noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    audio_decoder: Optional[AudioDecoder] = None,
    vocoder=None,
    internal_audio: bool = True,
    int8: bool = False,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """The two-stage CFG pipeline (pipelines/two_stage.py), one clip per
    seed: stage 1 at half size, `steps` LTX2Scheduler steps guided at
    `cfg_scale` with the std-ratio / variance rescale at `rescale_scale`
    (with `audio` the multi-modal loop: the audio stream at
    `audio_cfg_scale`, modality isolation at `modality_scale`, three rows a
    step), the spatial upscaler, `distilled_lora` fused into the DiT for the
    3-sigma stage 2 and subtracted after it, then the decodes. Returns
    (uint8 frames, or (frames, (2, samples) waveform) pairs with `audio`;
    per-request stats).

    Contexts, images, the ledger, Gemma, the tokens and embeddings, the
    random weights' seeds, `phase_peaks`, `tiling`, `skip_decode` and the
    audio modules as in `generate_videos_one_stage` (pairs of prompt and
    negative) and `generate_videos_distilled` (the upscaler and the
    decode); `noises[i]` / `audio_noises[i]` request i's (stage-1, stage-2)
    noise. A random audio-video DiT is kept in fp8 unless a distilled LoRA
    is given: fusing needs its weights in `dtype`, so with one it is built
    in bf16 (a DiT kept in fp8 raises). Stats per request: the seconds and
    peaks of the text encode, stage 1 (and a step), upscale, lora_fuse,
    stage 2, lora_unfuse, decode and audio decode, the launches, the
    latents' finiteness.
    `meshes` as in `generate_videos_distilled`."""
    from ltx2_tpu_torch.loader.fp8 import is_quantized
    from ltx2_tpu_torch.pipelines.two_stage import TwoStageCFGConfig, TwoStagePipeline

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
    encoded_audio = [] if audio and audio_contexts is None else None
    contexts, _ = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                 negatives=True, tokens=tokens, embeddings=embeddings, audio_contexts=encoded_audio)
    if encoded_audio and all(a is not None for a in encoded_audio):
        audio_contexts = encoded_audio
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, audio,
                                    fp8=distilled_lora is None, int8=int8, meshes=meshes)
    if distilled_lora is not None and is_quantized(dit):
        raise ValueError("the distilled LoRA cannot be fused into a DiT kept in fp8: load it in bf16 "
                         "(no --fp8-serving)")
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, "the two-stage pipeline")
    cfg = dit.cfg
    pipe = TwoStagePipeline(dit, upscaler, statistics=_latent_statistics(cfg, decoder, ledger, device),
                            video_encoder=encoder, **loop_meshes(meshes))

    configs, latents, audio_latents = [], [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = TwoStageCFGConfig(
            height=height, width=width, num_frames=frames, seed=seed, fps=fps, num_inference_steps=steps,
            cfg_scale=cfg_scale, audio_cfg_scale=audio_cfg_scale, guidance_rescale=rescale_scale,
            modality_scale=modality_scale, cfg_interval=cfg_interval, distilled_lora_config=distilled_lora,
            tiling_config=tiling, dtype=cfg.compute_dtype, latent_channels=cfg.in_channels, audio_enabled=audio,
            use_internal_audio_branch=internal_audio, token_dependent_shift=token_shift)
        gen = torch.Generator(device=device).manual_seed(seed)
        (positive, negative), (positive_a, negative_a) = _context_pairs(cfg, contexts, audio_contexts, i, gen,
                                                                        device, audio)
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        with _weights_restored(dit, [distilled_lora] if distilled_lora is not None else []):
            latent, audio_latent = pipe(
                positive, negative, config, images=images, callback=on_phase, skip_decode=True,
                positive_audio_encoding=positive_a, negative_audio_encoding=negative_a,
                noises=None if noises is None else noises[i],
                audio_noises=None if audio_noises is None else audio_noises[i])
        st["stage1_step_s"] = st["stage1_s"] / steps
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)
        audio_latents.append(audio_latent if audio else None)

    del dit, upscaler, encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder"):
            ledger.clear_model(name)
    return _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, cfg.compute_dtype, phase_peaks,
                    lambda seed: stage_seeds(seed)[2], skip_decode, audio_decoder, vocoder, meshes), stats


def generate_videos_a2vid(
    seeds: Sequence[int],
    *,
    audio_file: Optional[str] = None,
    audio_start_time: float = 0.0,
    source_waveform: Optional[np.ndarray] = None,
    height: int = 512,
    width: int = 768,
    frames: int = 121,
    layers: int = 48,
    device=None,
    dit: Optional[LTXModel] = None,
    upscaler: Optional[SpatialUpscaler] = None,
    decoder: Optional[VideoDecoder] = None,
    encoder: Optional[VideoEncoder] = None,
    audio_encoder: Optional[AudioEncoder] = None,
    contexts: Optional[Sequence[torch.Tensor]] = None,
    noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    images: Optional[Sequence[ImageCondition]] = None,
    text_encoder: Union[bool, VideoTextEncoder] = False,
    gemma: Optional[Gemma3] = None,
    phase_peaks: bool = False,
    ledger: Optional[ModelLedger] = None,
    tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    embeddings: Optional[list] = None,
    fps: float = FPS,
    tiling: Optional[TilingConfig] = None,
    dtype: str = "bfloat16",
    skip_decode: bool = False,
    audio: bool = False,
    audio_contexts: Optional[Sequence[torch.Tensor]] = None,
    audio_noises: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    int8: bool = False,
    meshes: Optional[dict] = None,
) -> Tuple[List[np.ndarray], List[dict]]:
    """Audio-to-video (pipelines/a2vid_two_stage.py), one clip per seed: the
    source (`audio_file`'s first frames / fps seconds from
    `audio_start_time`, loaded once at 16 kHz, or `source_waveform`, (channels,
    samples) at 16 kHz) is encoded by the audio encoder (given, the
    ledger's, or random at the published widths from seed 8) into the audio
    latent, which stays frozen through both stages of the distilled recipe
    on the audio-video DiT (given, the ledger's, or random at full width
    kept in fp8) while the video denoises against it. With `audio` each
    result is (frames, the (channels, samples) source at 16 kHz). Without
    an encoder (a file without one) or a source, the noised initial audio
    latent is frozen (the reference's fallback), and with `audio` the
    decoded audio is returned. The other arguments as in
    `generate_videos_distilled`; with `skip_decode` and a source each
    result is (latent, None). Stats per request: `audio_load_s` (the
    first), the seconds and peaks of the text encode, the audio encode,
    stage 1, upscale, stage 2 and decode, the launches,
    `audio_frozen_by_stage` (per stage, the audio latent bit for bit
    unchanged) and the .wav's rate and samples.
    `meshes` as in `generate_videos_distilled`."""
    from ltx2_tpu_torch.pipelines.a2vid_two_stage import A2VidConfig, A2VidPipelineTwoStage, load_audio_file

    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = list(images or [])
    modules = (dit, upscaler, decoder, encoder, audio_encoder, gemma,
               text_encoder if isinstance(text_encoder, VideoTextEncoder) else None)
    if ledger is not None and any(m is not None for m in modules):
        raise ValueError("with a ledger every component comes from its files: pass no module")
    stats = [{"seed": seed, "dit_init_s": 0.0, "upscaler_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    _phase_peak(device, phase_peaks)
    encoded_audio = [] if audio_contexts is None else None
    contexts, _ = _text_contexts(seeds, stats, device, contexts, text_encoder, gemma, ledger, phase_peaks,
                                 tokens=tokens, embeddings=embeddings, audio_contexts=encoded_audio)
    if encoded_audio and all(a is not None for a in encoded_audio):
        audio_contexts = encoded_audio
    gemma = text_encoder = None
    dit, encoder = _dit_and_encoder(stats, device, layers, dit, encoder, images, ledger,
                                    None if contexts is None else contexts[0].shape[-1], dtype, audio=True,
                                    int8=int8, meshes=meshes)
    upscaler = _spatial_upscaler(stats, device, upscaler, ledger, "the a2vid pipeline")
    if audio_encoder is None:
        audio_encoder = _audio_encoder(stats, device, ledger)
    cfg = dit.cfg
    pipe = A2VidPipelineTwoStage(dit, upscaler, statistics=_latent_statistics(cfg, decoder, ledger, device),
                                 video_encoder=encoder, audio_encoder=audio_encoder, **loop_meshes(meshes))
    rate = A2VidConfig.audio_sample_rate
    if source_waveform is None and audio_file:
        t0 = time.perf_counter()
        source_waveform, rate = load_audio_file(audio_file, target_sr=rate, start_time=audio_start_time,
                                                max_duration=frames / fps)
        stats[0]["audio_load_s"] = time.perf_counter() - t0

    configs, latents, audio_latents = [], [], []
    for i, (seed, st) in enumerate(zip(seeds, stats)):
        config = A2VidConfig(height=height, width=width, num_frames=frames, seed=seed, dtype=cfg.compute_dtype,
                             latent_channels=cfg.in_channels, fps=fps, tiling_config=tiling, audio_enabled=audio,
                             audio_path=audio_file or "", audio_start_time=audio_start_time)
        gen = torch.Generator(device=device).manual_seed(seed)
        context = contexts[i] if contexts is not None else dummy_context(cfg, gen, device)
        audio_context = (audio_contexts[i] if audio_contexts is not None else
                         context if contexts is not None else dummy_context(cfg, gen, device, audio=True))
        on_phase, marks = _phase_timer(device, st, phase_peaks)
        out = pipe(context, config, callback=on_phase, images=images, audio_encoding=audio_context,
                   source_waveform=source_waveform, skip_decode=True, noises=None if noises is None else noises[i],
                   audio_noises=None if audio_noises is None else audio_noises[i])
        st["attention_launches"] = flash_attention.launches - marks["attention"]
        st["audio_frozen_by_stage"] = list(pipe.frozen_by_stage)
        latent = out[0] if audio else out
        st["latent_std"] = float(latent.float().std())
        configs.append(config)
        latents.append(latent)
        audio_latents.append(None)
        if audio and source_waveform is None:  # the reference's fallback: the generated audio
            audio_latents[-1] = out[1]

    del dit, upscaler, encoder, audio_encoder, pipe
    if ledger is not None:
        for name in ("transformer", "spatial_upscaler", "video_encoder", "audio_encoder"):
            ledger.clear_model(name)
    results = _outputs(latents, audio_latents, configs, stats, device, decoder, ledger, cfg.compute_dtype,
                       phase_peaks, lambda seed: stage_seeds(seed)[2], skip_decode, None, None, meshes)
    if not audio or source_waveform is None:
        return results, stats
    wave = None if skip_decode else np.asarray(source_waveform, np.float32)  # the passthrough
    if wave is not None:
        for st in stats:
            st["audio_sample_rate"], st["audio_samples"] = rate, int(wave.shape[-1])
            st["audio_finite"] = bool(np.isfinite(wave).all())
    return [(r, wave) for r in results], stats


def _audio_encoder(stats, device, ledger) -> Optional[AudioEncoder]:
    """The audio VAE encoder: the ledger's (None when the file has none),
    else the published one from seed 8."""
    return _built(device, stats[0], "audio_encoder_init_s", "audio_encoder",
                  ledger.audio_encoder if ledger is not None else (lambda: make_audio_encoder(device)))


def generate_video(seed: int = 0, **kwargs) -> np.ndarray:
    """One clip: uint8 (frames, height, width, 3). See generate_videos."""
    videos, _ = generate_videos([seed], **kwargs)
    return videos[0]


def parse_lora_spec(spec: str, default_strength: float = 1.0) -> LoRAConfig:
    """'path[:strength]' -> LoRAConfig (`default_strength` when absent)."""
    if ":" in spec:
        path, strength = spec.rsplit(":", 1)
        return LoRAConfig(path=path, strength=float(strength))
    return LoRAConfig(path=spec, strength=default_strength)


def parse_keyframe_spec(spec: str):
    """'path:frame[:strength]' -> Keyframe (frame 0 and strength 0.95 when
    absent), as scripts/generate.py parses --keyframe."""
    from ltx2_tpu_torch.pipelines.keyframe_interpolation import Keyframe

    parts = spec.split(":")
    return Keyframe(image_path=parts[0], frame_index=int(parts[1]) if len(parts) > 1 else 0,
                    strength=float(parts[2]) if len(parts) > 2 else 0.95)


def parse_image_spec(spec: str, default_strength: float = 0.95) -> ImageCondition:
    """'path[:frame[:strength]]' -> ImageCondition (frame 0 and
    `default_strength` when absent), as scripts/generate.py parses --image."""
    parts = spec.split(":")
    return ImageCondition(image_path=parts[0], frame_index=int(parts[1]) if len(parts) > 1 else 0,
                          strength=float(parts[2]) if len(parts) > 2 else default_strength)


PIPELINES = ("bench-e2e", "distilled", "one-stage", "text-to-video", "two-stage", "a2vid", "keyframe", "ti2vid-hq",
             "retake", "ic-lora")
# The pipelines with a spatial upscaler between two stages.
STAGED = ("distilled", "two-stage", "a2vid", "keyframe", "ti2vid-hq", "ic-lora")
# The ic-lora pipeline's own flags (argparse names).
IC_LORA_FLAGS = ("control_video", "control_type", "canny_low", "canny_high", "control_strength", "ic_lora_weights",
                 "save_control")
RETAKE_FLAGS = ("video", "retake_start", "retake_end")
# The temporal upscaler's file under the reference layout, the default of
# --upscale-temporal with a checkpoint (scripts/generate.py:392-394).
DEFAULT_TEMPORAL_UPSCALER = "weights/ltx-2/ltx-2-temporal-upscaler-x2-1.0.safetensors"
# The two-stage pipeline's own flags (argparse names).
TWO_STAGE_FLAGS = ("cfg_stage1", "steps_stage1", "steps_stage2", "modality_scale", "distilled_lora",
                   "distilled_lora_scale")


def _round_two_stage_geometry(args) -> None:
    """Two-stage rounds the resolution up to a multiple of 64, as the JAX
    CLI does, with a note on stderr."""
    if args.height % 64 or args.width % 64:
        height, width = -(-args.height // 64) * 64, -(-args.width // 64) * 64
        print(f"two-stage requires resolution divisible by 64; adjusting {args.height}x{args.width} -> "
              f"{height}x{width}", file=sys.stderr)
        args.height, args.width = height, width


# The one-stage / text-to-video loop options' argparse names.
LOOP_FLAGS = ("stg_scale", "stg_blocks", "stg_cutoff", "stg_mode", "apg_scale", "apg_eta", "apg_norm_threshold",
              "apg_momentum", "ge_gamma", "sampler", "cfg_interval", "token_bucket", "cross_attn_scale",
              "cross_attn_start_block", "cache_text_kv", "upscale_spatial", "upscale_temporal")


def apg_guider(args) -> Optional[Union[LtxAPGGuider, StatefulAPGGuider]]:
    """The guider `--apg-*` asks for, as scripts/generate.py builds it: none
    at scale 0, the stateful APG with a momentum, else LtxAPGGuider."""
    if not args.apg_scale:
        return None
    if args.apg_momentum:
        return StatefulAPGGuider(scale=args.apg_scale, eta=args.apg_eta, norm_threshold=args.apg_norm_threshold,
                                 momentum=args.apg_momentum)
    return LtxAPGGuider(scale=args.apg_scale, eta=args.apg_eta, norm_threshold=args.apg_norm_threshold)


def tiling_config(args) -> Optional[TilingConfig]:
    """`--tile-size/--tile-overlap` and `--temporal-tile-size/--temporal-
    tile-overlap` -> the decode's tiling, as scripts/generate.py builds it;
    with neither size the default tiling under `--tiled-vae`, else None
    (each pipeline's own choice)."""
    spatial = SpatialTilingConfig(args.tile_size, args.tile_overlap) if args.tile_size else None
    temporal = (TemporalTilingConfig(args.temporal_tile_size, args.temporal_tile_overlap)
                if args.temporal_tile_size else None)
    if spatial or temporal:
        return TilingConfig(spatial_config=spatial, temporal_config=temporal)
    if getattr(args, "tiled_vae", False):
        return TilingConfig.default()
    return None


def _profile(profile_dir: Optional[str]):
    """`--profile-dir`: a torch.profiler trace of the run written there as
    trace.json (the JAX CLI writes its profiler's trace there); nothing
    without a directory."""
    import contextlib

    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def traced():
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        with profile(activities=activities) as prof:
            yield
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    return traced()


def load_embedding(path: str, device, negatives: bool, audio: bool = False) -> Optional[torch.Tensor]:
    """An `--embedding` npz (the JAX CLI's keys) -> the video context: the
    (1, S, D) `positive`, or with `negatives` the (2, S, D) `positive` and
    `negative` pair; with `audio` the same of `positive_audio` and
    `negative_audio` (None when the file has none)."""
    names = ("positive_audio", "negative_audio") if audio else ("positive", "negative")
    with np.load(path) as data:
        if names[0] not in data:
            return None
        keys = names if negatives else names[:1]
        context = torch.cat([torch.from_numpy(np.asarray(data[k], np.float32)) for k in keys])
    return context.to(resolve_device(device))


def output_paths(output: str, n: int, suffix: str = "") -> List[str]:
    """The file of each of `n` requests: `output` itself for one, else
    `<base>_<i><ext>`; `suffix` replaces the extension (`--skip-vae`'s
    `_latent.npz`)."""
    base, ext = (output.rsplit(".", 1)[0], "." + output.rsplit(".", 1)[1]) if "." in output else (output, "")
    ext = suffix or ext
    return [f"{base}{ext}"] if n == 1 else [f"{base}_{i}{ext}" for i in range(n)]


def build_parser() -> argparse.ArgumentParser:
    """The command line's parser (also the server's parent parser)."""
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pipeline", choices=PIPELINES, default="bench-e2e",
                    help="bench-e2e: one stage at full resolution, chunked decode; distilled: the two-stage "
                         "recipe (half-resolution stage 1, 2x upscaler, 3-sigma stage 2, tiled decode); one-stage: "
                         "the CFG pipeline (CFG* with --rescale-scale > 0); text-to-video: its plain-CFG form; "
                         "two-stage: a guided stage 1 (--num-inference-steps, CFG with the rescale; with --audio "
                         "the multi-modal guider), the upscaler, --distilled-lora fused for the distilled stage 2; "
                         "a2vid: the distilled recipe with the audio latent encoded from --audio-file and frozen; "
                         "keyframe: --keyframe stills appended past the sequence, a CFG stage 1 and a distilled stage "
                         "2; ti2vid-hq: a Res2s CFG stage 1 and a distilled stage 2; retake: --video's frames "
                         "between --retake-start and --retake-end regenerated under CFG; ic-lora: the distilled recipe "
                         "with --control-video appended and --ic-lora-weights fused in stage 1")
    ap.add_argument("--prompt", default=None,
                    help=f"tokenized from --gemma-dir's tokenizer.json (default {DEFAULT_PROMPT!r})")
    ap.add_argument("--negative-prompt", default=None,
                    help=f"the CFG flows' negative prompt (default {DEFAULT_NEGATIVE_PROMPT!r})")
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--frames", "--num-frames", type=int, default=121)
    ap.add_argument("--fps", type=float, default=FPS, help="frame rate of the position grid and the output")
    ap.add_argument("--output-fps", type=float, default=None, help="mux at this fps via minterpolate if > --fps")
    ap.add_argument("--speed", type=float, default=1.0, help="playback speed multiplier of the container rate")
    ap.add_argument("--output", default="output.mp4",
                    help=".y4m/.avi/.mov are written by the port; other containers through ffmpeg, or without it "
                         "an MJPEG .mp4/.m4v (any other name: <base>.avi) with <base>.gif and <base>_frames.npz; "
                         "with several requests <base>_<i><ext>")
    ap.add_argument("--skip-vae", action="store_true", help="write <base>_latent.npz (key latent), no decode")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="bfloat16", help="the DiT's compute dtype")
    ap.add_argument("--steps", type=int, default=8, help="bench-e2e only: distilled steps")
    ap.add_argument("--num-inference-steps", type=int, default=30,
                    help="one-stage, text-to-video, two-stage (stage 1): Euler steps")
    ap.add_argument("--cfg-scale", "--cfg", type=float, default=3.0,
                    help="one-stage, text-to-video, two-stage (stage 1): guidance scale")
    ap.add_argument("--rescale-scale", "--guidance-rescale", type=float, default=0.7,
                    help="one-stage: > 0 selects CFG* (CFGStarRescalingGuider), 0 classic CFG; text-to-video "
                         "always runs 0; two-stage: the guidance rescale of stage 1 (std-ratio with --audio, else "
                         "RescaledCFGGuider; 0 classic CFG)")
    ap.add_argument("--token-shift", action="store_true",
                    help="one-stage, text-to-video: shift the sigma schedule by the clip's token count, not the fixed 4096")
    ap.add_argument("--image", action="append", default=[], metavar="PATH[:FRAME[:STRENGTH]]",
                    help="every flow but bench-e2e, retake and ic-lora: a still (PNG, JPEG, WebP, BMP, PPM, TGA, "
                         "TIFF or GIF that PIL opens as RGB, RGBA or L) conditioning latent frame FRAME "
                         "(default 0), repeatable")
    ap.add_argument("--image-strength", type=float, default=0.95,
                    help="the strength of --image specs without one")
    ap.add_argument("--tile-size", type=int, default=None, help="every flow but bench-e2e: spatial decode tile (px)")
    ap.add_argument("--tile-overlap", type=int, default=64)
    ap.add_argument("--temporal-tile-size", type=int, default=None, help="temporal decode tile (frames)")
    ap.add_argument("--temporal-tile-overlap", type=int, default=24)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=1, help="clips to generate, seeds seed..seed+N-1")
    scale = ap.add_argument_group("scale-out (one process per rank, under torchrun)")
    scale.add_argument("--sp-devices", type=int, default=0,
                       help="shard the video-token axis over this many devices (sequence parallelism / ring "
                            "attention); 0 = off")
    scale.add_argument("--tp-devices", type=int, default=0,
                       help="tensor-parallel the DiT over this many devices (Megatron QKV/FFN sharding); weights "
                            "stream directly onto their shards; 0 = off")
    scale.add_argument("--vae-dp-devices", type=int, default=0,
                       help="decode VAE tiles data-parallel over this many devices (same-shape tiles one per "
                            "rank; requires tiling, composes with any DiT parallelism); 0 = off")
    scale.add_argument("--vae-w-shard", type=int, default=0,
                       help="decode the video W-sharded over this many devices with explicit per-conv halo "
                            "exchange (untiled decode of one oversized frame; latent W must divide the count). "
                            "0 = single-device decode")
    scale.add_argument("--pp-stages", type=int, default=0,
                       help="GPipe pipeline parallelism: stage the DiT's blocks over this many ranks (each holds "
                            "L/P blocks; the guidance rows are the microbatches); composes with --sp-devices and "
                            "--tp-devices in one (pipe, seq, model) mesh; 0 = off")
    scale.add_argument("--auto-shard", type=int, default=0,
                       help="pick --tp-devices/--sp-devices/--pp-stages for this many ranks from the layout "
                            "advisor's cost model of the card (parallel/advisor.py); explicit layout flags win; "
                            "0 = off")
    scale.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                       help="torch.distributed backend (default: nccl when every rank has a card of its own, gloo "
                            "on the CPU); gloo lets ranks share one card")
    scale.add_argument("--dist-init", default=None,
                       help="the process group's init method (default env://, torchrun's environment)")
    ap.add_argument("--text-encoder", action="store_true",
                    help="every flow but bench-e2e: encode each request's prompt and negative prompt "
                         "with Gemma-3 and the text encoder in place of the dummy contexts; without --gemma-dir the "
                         "token ids are drawn from the request's seed and the fp32 Gemma-3-12B and V1 text encoder "
                         "have random weights")
    ap.add_argument("--embedding", default=None,
                    help="every flow but bench-e2e: an npz of text encodings (positive, negative), "
                         "in place of the text encoder")
    ap.add_argument("--save-embedding", default=None, help="write the first request's encodings as an npz")
    ap.add_argument("--checkpoint", "--weights", default=None,
                    help="every flow but bench-e2e: a unified LTX-2 or LTX-2.3 safetensors checkpoint "
                         "(DiT, VAE encoder and decoder, text projection and connectors), loaded through ModelLedger "
                         "in place of the random weights")
    ap.add_argument("--spatial-upscaler", "--spatial-upscaler-weights", default=None,
                    help="distilled, two-stage, a2vid, keyframe, ti2vid-hq with --checkpoint: the spatial "
                         "upscaler's safetensors (keyframe and ti2vid-hq run one stage without it)")
    ap.add_argument("--temporal-upscaler", "--temporal-upscaler-weights", default=None,
                    help="with --checkpoint and --upscale-temporal: the temporal upscaler's safetensors (default "
                         f"{DEFAULT_TEMPORAL_UPSCALER})")
    ap.add_argument("--gemma-dir", "--gemma-path", default=None,
                    help="with --checkpoint: the directory of Gemma-3's model-*.safetensors shards and its "
                         "tokenizer.json (and tokenizer_config.json); turns text encoding on")
    ap.add_argument("--fp8-serving", action="store_true",
                    help="with --checkpoint: keep the file's fp8 DiT weights fp8 on the card (dequantized at use)")
    ap.add_argument("--int8", action="store_true",
                    help="the DiT's matmul weights int8 W8A8 (per-out-channel weights quantized at load, per-token "
                         "activations quantized at each matmul, int32 products); excludes --fp8-serving and a "
                         "runtime LoRA fuse (--distilled-lora)")
    ap.add_argument("--gemma-fp8", action="store_true",
                    help="with --gemma-dir: quantize Gemma's matmul weights to fp8 at load (embeddings bf16)")
    ap.add_argument("--lora", action="append", default=[], metavar="PATH[:STRENGTH]",
                    help="with --checkpoint: a LoRA file fused into the DiT at load, repeatable")
    ap.add_argument("--keyframe", action="append", default=[], metavar="PATH:FRAME[:STRENGTH]",
                    help="keyframe: a still (as --image takes) pinned at pixel frame FRAME (strength 0.95 by "
                         "default), repeatable")
    ic = ap.add_argument_group("retake and ic-lora (the JAX CLI's names and defaults)")
    ic.add_argument("--video", default=None,
                    help="retake: the source video (.y4m, an MJPEG .avi/.mov/.mp4, a GIF, an APNG, a still PNG; "
                         "others through OpenCV or ffmpeg); its own height, width and fps, its frames snapped down "
                         "to 8k+1")
    ic.add_argument("--retake-start", type=float, default=0.0, help="retake: the window's start (seconds)")
    ic.add_argument("--retake-end", type=float, default=1.0, help="retake: the window's end (seconds)")
    ic.add_argument("--control-video", default=None, help="ic-lora: the control video, read at stage 1's size")
    ic.add_argument("--control-type", choices=["raw", "canny"], default="raw",
                    help="ic-lora: raw (already a control signal) or canny (edges, the port's OpenCV steps)")
    ic.add_argument("--canny-low", type=int, default=100, help="canny low threshold for --control-type canny")
    ic.add_argument("--canny-high", type=int, default=200, help="canny high threshold for --control-type canny")
    ic.add_argument("--control-strength", type=float, default=0.95, help="ic-lora control conditioning strength")
    ic.add_argument("--ic-lora-weights", default=None, metavar="PATH[:STRENGTH]",
                    help="ic-lora: the IC-LoRA safetensors, fused for stage 1 only (the first --lora when absent)")
    ic.add_argument("--save-control", action="store_true",
                    help="ic-lora: write the control signal beside the source as <video>.control.avi")
    ap.add_argument("--audio", "--generate-audio", action="store_true",
                    help="every flow but bench-e2e: generate audio with the audio-video DiT (the checkpoint's, "
                         "loaded with its audio stream, else random at full width, kept in fp8) and write it beside "
                         "a .y4m as <base>.wav (inside .avi/.mov/no-ffmpeg .mp4; muxed by ffmpeg into other "
                         "containers); a2vid writes the source")
    ap.add_argument("--no-internal-audio", action="store_true",
                    help="an audio-video DiT leaves the audio stream out when --audio is not given")
    ap.add_argument("--audio-cfg-scale", type=float, default=7.0,
                    help="one-stage, text-to-video, two-stage with --audio: the audio stream's guidance scale")
    two = ap.add_argument_group("two-stage and a2vid (the JAX CLI's names and defaults)")
    two.add_argument("--cfg-stage1", type=float, default=None, help="two-stage: stage 1's CFG (default --cfg-scale)")
    two.add_argument("--steps-stage1", type=int, default=None,
                     help="two-stage: stage 1's steps (sets --num-inference-steps)")
    two.add_argument("--steps-stage2", type=int, default=None,
                     help="two-stage: stage 2 runs the fixed 3-sigma distilled tail; other values are ignored")
    two.add_argument("--modality-scale", type=float, default=3.0,
                     help="two-stage with --audio: the modality-isolation guidance scale (1 = off)")
    two.add_argument("--distilled-lora", default=None,
                     help="two-stage: a LoRA file fused into the DiT for stage 2 and subtracted after it (the DiT "
                          "must be bf16: not with --fp8-serving)")
    two.add_argument("--distilled-lora-scale", type=float, default=1.0, help="the distilled LoRA's strength")
    two.add_argument("--audio-file", default=None,
                     help="a2vid: the source audio (a .wav; 16-bit PCM is read by the port, other formats "
                          "through ffmpeg; or the PCM track of an .avi/.mov/.mp4), its first frames / fps "
                          "seconds encoded and frozen; with --audio it is the output's .wav at 16 kHz")
    loop = ap.add_argument_group("one-stage and text-to-video loop options (the JAX CLI's names and defaults)")
    loop.add_argument("--stg-scale", type=float, default=0.0,
                      help="STG: a third guidance row with self-attention skipped in --stg-blocks")
    loop.add_argument("--stg-blocks", type=str, default=None, help="comma-separated block indices (default: all)")
    loop.add_argument("--stg-cutoff", type=float, default=1.0,
                      help="STG applies on steps with (i + 1) / steps <= this")
    loop.add_argument("--stg-mode", choices=["video", "audio", "both"], default="video",
                      help="the stream(s) STG perturbs; audio and both need --audio")
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
    loop.add_argument("--upscale-temporal", action="store_true",
                      help="the 2x temporal upscaler after the loop and any spatial one: F latent frames become "
                           "2F - 1 (random weights, or --temporal-upscaler's file with --checkpoint)")
    ap.add_argument("--enhance-prompt", action="store_true",
                    help="with --gemma-dir: expand --prompt with Gemma-3 before encoding it (sampled at temperature "
                         "0.7, top_p 0.9 from --seed; the image-to-video system prompt with --image)")
    ap.add_argument("--early-layers-only", action="store_true",
                    help="with --gemma-dir and a V1 checkpoint: condition on Gemma's layer-0 hidden state (the "
                         "scaled embedding, padding zeroed) in place of the text encoder (experimental, as in the "
                         "JAX CLI)")
    compat = ap.add_argument_group("the JAX CLI's compatibility flags (its names and settings)")
    compat.add_argument("--fp8", action="store_true", help="same as --fp8-serving")
    compat.add_argument("--fp16", action="store_true", help="16-bit compute: bfloat16 (the default --dtype)")
    compat.add_argument("--fp32", "--no-fp16", action="store_true", dest="fp32", help="same as --dtype float32")
    compat.add_argument("--low-memory", action="store_true", help="accepted, no effect")
    compat.add_argument("--fast-mode", action="store_true", help="accepted, no effect")
    compat.add_argument("--lora-strength", type=float, default=1.0,
                        help="the strength of --lora specs without one")
    compat.add_argument("--tiled-vae", action="store_true",
                        help="tiled decode at the default tiling when no tile size is given")
    compat.add_argument("--placeholder", action="store_true",
                        help="random weights and dummy text contexts (the checkpoint, if given, is not loaded)")
    compat.add_argument("--no-gemma", action="store_true", help="dummy text contexts (no text encoding)")
    compat.add_argument("--model-variant", choices=["distilled", "dev"], default="distilled",
                        help="without --checkpoint: weights/ltx-2/ltx-2-19b-<variant>[-fp8].safetensors when "
                             "that file exists")
    compat.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the run (trace.json) into this directory")
    compat.add_argument("--compile-cache", default=None,
                        help="the JAX CLI's XLA compilation cache: accepted and ignored (the port compiles no XLA)")
    return ap


@functools.lru_cache(maxsize=1)
def _defaults() -> dict:
    """Every setting's default, by its argparse name."""
    return vars(build_parser().parse_args([]))


def _flag(dest: str) -> str:
    return f"--{dest.replace('_', '-')}"


def _encodes(args) -> bool:
    """Whether the request's prompts go through Gemma and the text encoder."""
    return not args.no_gemma and (args.text_encoder or (args.gemma_dir is not None and not args.embedding))


def check_request(args) -> None:
    """The command line's settings made consistent and checked, before any
    model is built: the JAX CLI's compatibility flags applied
    (`_apply_reference_compat`), the two-stage resolution rounded up to a
    multiple of 64, and every refusal raised as a ValueError (`main` turns
    it into a usage error, the server into a `bad_request` response). No
    --output is refused: `save_video` writes every container, as the JAX
    CLI does. Mutates `args`."""
    defaults = _defaults()
    _apply_reference_compat(args)
    cfg_flow = args.pipeline in ("one-stage", "text-to-video")
    two_stage = args.pipeline == "two-stage"
    if args.pipeline not in PIPELINES:
        raise ValueError(f"--pipeline {args.pipeline!r}: not one of {', '.join(PIPELINES)}")
    if args.sampler not in ("euler", "heun"):
        raise ValueError(f"--sampler {args.sampler!r}: not euler or heun")
    _check_layout(args)
    loop_flags = [_flag(dest) for dest in LOOP_FLAGS if getattr(args, dest) != defaults[dest]
                  and not (args.pipeline in ("two-stage", "retake") and dest == "cfg_interval")]
    if loop_flags and not cfg_flow:
        raise ValueError(f"{', '.join(loop_flags)} need --pipeline one-stage or text-to-video")
    two_flags = [_flag(dest) for dest in TWO_STAGE_FLAGS if getattr(args, dest) != defaults[dest]
                 and not (args.pipeline == "ti2vid-hq" and dest == "steps_stage1")]
    if two_flags and not two_stage:
        raise ValueError(f"{', '.join(two_flags)} need --pipeline two-stage")
    if args.pipeline == "ti2vid-hq" and args.steps_stage1 is not None:
        args.num_inference_steps = args.steps_stage1
    if args.audio_file and args.pipeline != "a2vid":
        raise ValueError("--audio-file needs --pipeline a2vid")
    for flags, name in ((IC_LORA_FLAGS, "ic-lora"), (RETAKE_FLAGS, "retake")):
        given = [_flag(dest) for dest in flags if getattr(args, dest) != defaults[dest]]
        if given and args.pipeline != name:
            raise ValueError(f"{', '.join(given)} need --pipeline {name}")
    if args.pipeline == "retake" and not args.video:
        raise ValueError("--pipeline retake needs --video (the source video)")
    for flag, used in (("--image", args.image), ("--audio", args.audio)):
        if used and args.pipeline == "retake":
            raise ValueError(f"{flag} does not apply to --pipeline retake (video only, conditioned by --video)")
    if args.image and args.pipeline == "ic-lora":
        raise ValueError("--image does not apply to --pipeline ic-lora (conditioned by --control-video)")
    if args.keyframe and args.pipeline != "keyframe":
        raise ValueError("--keyframe needs --pipeline keyframe")
    if args.pipeline == "keyframe":
        for flag, used in (("--image", args.image), ("--audio", args.audio)):
            if used:
                raise ValueError(f"{flag} does not apply to --pipeline keyframe (video only, conditioned by --keyframe)")
        for flag, dest, value in (("--num-inference-steps", "num_inference_steps", 30),
                                  ("--cfg-scale", "cfg_scale", 7.5)):
            if getattr(args, dest) != defaults[dest]:
                print(f"{flag}: --pipeline keyframe runs its config's {value}, as the JAX CLI does; ignored",
                      file=sys.stderr)
    if args.distilled_lora and args.fp8_serving:
        raise ValueError("--distilled-lora is fused into the DiT's weights, which --fp8-serving keeps in fp8: drop "
                         "--fp8-serving (the DiT loads in bf16)")
    if two_stage:
        _round_two_stage_geometry(args)
        if args.steps_stage1 is not None:
            args.num_inference_steps = args.steps_stage1
        if args.steps_stage2 is not None and args.steps_stage2 != 3:
            print(f"--steps-stage2 {args.steps_stage2}: stage 2 runs the fixed 3-sigma distilled tail; ignored",
                  file=sys.stderr)
    if args.pipeline == "bench-e2e":
        for flag, used in (("--text-encoder", args.text_encoder), ("--checkpoint", args.checkpoint),
                           ("--audio", args.audio),
                           ("--image", args.image), ("--prompt", args.prompt is not None),
                           ("--negative-prompt", args.negative_prompt is not None), ("--embedding", args.embedding),
                           ("--save-embedding", args.save_embedding),
                           ("--tile-size", args.tile_size), ("--temporal-tile-size", args.temporal_tile_size),
                           ("--enhance-prompt", args.enhance_prompt), ("--early-layers-only", args.early_layers_only)):
            if used:
                raise ValueError(f"{flag} needs another --pipeline than bench-e2e")
    if args.spatial_upscaler and args.pipeline not in STAGED and not args.upscale_spatial:
        raise ValueError("--spatial-upscaler needs --pipeline distilled, two-stage, a2vid, keyframe or ti2vid-hq, or "
                         "--upscale-spatial")
    if args.temporal_upscaler and not args.upscale_temporal:
        print("--temporal-upscaler given without --upscale-temporal: the post-hoc 2x applies only with "
              "--upscale-temporal; ignoring the weights", file=sys.stderr)
        args.temporal_upscaler = None
    if args.upscale_temporal and args.checkpoint and args.temporal_upscaler is None:
        args.temporal_upscaler = DEFAULT_TEMPORAL_UPSCALER
    file_flags = {"--spatial-upscaler": args.spatial_upscaler, "--temporal-upscaler": args.temporal_upscaler,
                  "--gemma-dir": args.gemma_dir, "--fp8-serving": args.fp8_serving, "--gemma-fp8": args.gemma_fp8,
                  "--lora": args.lora}
    if not args.checkpoint and any(file_flags.values()):
        raise ValueError(f"{', '.join(k for k, v in file_flags.items() if v)} need --checkpoint")
    if args.gemma_fp8 and not args.gemma_dir:
        raise ValueError("--gemma-fp8 needs --gemma-dir")
    encode = _encodes(args)
    if args.embedding and args.text_encoder:
        raise ValueError("--embedding and --text-encoder are exclusive: the npz holds the encodings")
    if args.save_embedding and not encode:
        raise ValueError("--save-embedding needs the text encoder (--gemma-dir or --text-encoder)")
    explicit = [flag for flag, v in (("--prompt", args.prompt), ("--negative-prompt", args.negative_prompt)) if v is not None]
    if args.gemma_dir and encode and not has_tokenizer(args.gemma_dir):
        raise ValueError(f"--gemma-dir {args.gemma_dir} holds no tokenizer.json: the prompts cannot be tokenized")
    if explicit and not (args.gemma_dir and encode):
        raise ValueError(f"{', '.join(explicit)} need the tokenizer.json of --gemma-dir (with --checkpoint); without "
                         "it the random-weight flows draw token ids from each request's seed")
    for flag, on in (("--enhance-prompt", args.enhance_prompt), ("--early-layers-only", args.early_layers_only)):
        if on and not (args.gemma_dir and encode):
            raise ValueError(f"{flag} needs Gemma's weights and tokenizer: --gemma-dir (with --checkpoint), and no "
                             "--embedding or --no-gemma")
    if args.early_layers_only:
        _check_early_layers(args)


LAYOUT_FLAGS = ("sp_devices", "tp_devices", "pp_stages", "vae_dp_devices", "vae_w_shard")
DIT_LAYOUT_FLAGS = ("--sp-devices", "--pp-stages", "--tp-devices")


def _layout(args) -> dict:
    """The scale-out flags above 1, by flag: {"--sp-devices": 2, ...}."""
    return {_flag(dest): getattr(args, dest) for dest in LAYOUT_FLAGS if (getattr(args, dest) or 0) > 1}


def _check_layout(args) -> None:
    """The scale-out flags' refusals: a negative count is a usage error, and
    so is a layout flag on bench-e2e (the port's benchmark flow runs one
    card)."""
    for dest in (*LAYOUT_FLAGS, "auto_shard"):
        if (getattr(args, dest) or 0) < 0:
            raise ValueError(f"{_flag(dest)} must be >= 0")
    layout = _layout(args)
    if args.pipeline == "bench-e2e" and (layout or (args.auto_shard or 0) > 1):
        raise ValueError(f"{', '.join(layout) or '--auto-shard'} on --pipeline bench-e2e: the layout flags apply to "
                         "the nine pipelines of the JAX CLI")


# The class of each --pipeline but bench-e2e, under ltx2_tpu_torch/pipelines/.
PIPELINE_CLASSES = {
    "distilled": "distilled.DistilledPipeline", "one-stage": "one_stage.OneStagePipeline",
    "text-to-video": "text_to_video.TextToVideoPipeline", "two-stage": "two_stage.TwoStagePipeline",
    "a2vid": "a2vid_two_stage.A2VidPipelineTwoStage", "keyframe": "keyframe_interpolation.KeyframeInterpolationPipeline",
    "ti2vid-hq": "ti2vid_hq.TI2VidHQPipeline", "retake": "retake.RetakePipeline", "ic-lora": "ic_lora.ICLoraPipeline",
}


def pipeline_class(name: str):
    """The pipeline class of a --pipeline name (imported on first use)."""
    import importlib

    module, _, cls = PIPELINE_CLASSES[name].rpartition(".")
    return getattr(importlib.import_module(f"ltx2_tpu_torch.pipelines.{module}"), cls)


def apply_auto_shard(args, backend: Optional[str] = None):
    """--auto-shard N: --tp-devices, --sp-devices and --pp-stages filled with
    the advisor's best modelled layout for N ranks at this request's token
    count (parallel/advisor.py, the card's constants: the route by the
    world's backend, `backend` or --dist-backend; nccl when neither names
    one), as scripts/generate.py::apply_auto_shard does; explicit layout
    flags win. The choice and its one-line justification go to stderr.
    Returns the LayoutEstimate, or None. The pipeline's class states its
    guidance rows (`CFG_ROW`) and the token counts of its other stages
    (`stage_token_counts`), which SP must divide with the audio stream's.
    Two departures from the JAX CLI's choice follow (ROADMAP.md section 3):
    every pipeline with a half-resolution stage 1 constrains SP by its token
    count, where the JAX CLI adds it for two-stage alone
    (scripts/generate.py:715), and a2vid and ic-lora count one guidance row,
    where the JAX CLI counts the CFG row for all but distilled (:737)."""
    n = args.auto_shard or 0
    if n <= 1:
        return None
    if args.sp_devices or args.pp_stages or args.tp_devices:
        print(f"--auto-shard {n} ignored: explicit layout flags win (--tp-devices/--sp-devices/--pp-stages)",
              file=sys.stderr)
        return None
    from ltx2_tpu_torch.parallel import advisor
    from ltx2_tpu_torch.types import AudioLatentShape

    cfg = advisor.flagship_serving_config()
    if args.checkpoint is None:
        # The random DiT of --layers blocks at full width.
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    else:
        layers, heads = advisor.peek_checkpoint_arch(args.checkpoint)
        cfg = dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                                  num_attention_heads=heads or cfg.num_attention_heads)
    pipe = pipeline_class(args.pipeline)
    n_tokens = advisor.video_token_count(args.frames, args.height, args.width)
    rows = 1 + int(pipe.CFG_ROW and args.cfg_scale > 1.0) + int(args.stg_scale != 0.0)
    constraints = pipe.stage_token_counts(args.frames, args.height, args.width, len(args.keyframe or ()))
    if args.audio or args.pipeline == "a2vid":
        pixel = VideoPixelShape(batch=1, frames=args.frames, height=args.height, width=args.width, fps=args.fps or 24.0)
        constraints += (AudioLatentShape.from_video_pixel_shape(pixel).frames,)
    route = advisor.route_of_backend(backend or args.dist_backend, args.device)
    best, _ = advisor.choose(cfg, n, n_tokens, rows=rows, extra_sp_constraints=constraints,
                             bytes_per_s=advisor.ROUTE_BYTES_PER_S[route])
    args.tp_devices = best.tp if best.tp > 1 else 0
    args.sp_devices = best.sp if best.sp > 1 else 0
    args.pp_stages = best.pp if best.pp > 1 else 0
    print(best.justification(n_tokens), file=sys.stderr)
    return best


# The meshes of each layout, built once per process: a server's requests
# reuse them (group creation is collective and costs a round trip).
_MESHES: dict = {}


def build_meshes(args) -> dict:
    """The layout flags -> this rank's meshes, after the process group is up
    (scripts/generate.py::build_meshes): "pipeline_mesh" (pipe, seq, model)
    with --pp-stages, composing --sp-devices and --tp-devices; else
    "sequence_mesh" with SP, carrying a 'model' axis with TP too; "tp_mesh"
    with TP alone; "vae_mesh", "vae_w_mesh". Every rank builds them in the
    same order (group creation is collective), once per layout. A flag that
    asks for more ranks than the world has exits as the JAX CLI does; the
    DiT's layout must use every rank. Nothing without a layout flag."""
    layout = _layout(args)
    if not layout:
        return {}
    key = tuple(sorted(layout.items()))
    if key in _MESHES:
        return _MESHES[key]
    from ltx2_tpu_torch.parallel.mesh import create_mesh
    from ltx2_tpu_torch.parallel.runtime import initialize_distributed, world

    initialize_distributed(init_method=args.dist_init, backend=args.dist_backend, device=args.device)
    _, n_world = world()
    sp, tp, pp = (layout.get(f, 0) for f in ("--sp-devices", "--tp-devices", "--pp-stages"))
    meshes = {}
    for flag, name in (("--vae-w-shard", "vae_w_mesh"), ("--vae-dp-devices", "vae_mesh")):
        n = layout.get(flag, 0)
        if n:
            if n_world < n:
                raise SystemExit(f"{flag} {n} but only {n_world} ranks in the world")
            meshes[name] = create_mesh(data=n, model=1, ranks=range(n))
    if sp or tp or pp:
        n = (sp or 1) * (tp or 1) * (pp or 1)
        flag = " x ".join(f for f, v in (("sp-devices", sp), ("pp-stages", pp), ("tp-devices", tp)) if v)
        if n_world < n:
            raise SystemExit(f"--{flag} needs {n} devices but only {n_world} ranks in the world")
        if n != n_world:
            raise SystemExit(f"--{flag} uses {n} of the world's {n_world} ranks: the DiT's layout must use every rank")
        if pp:
            meshes["pipeline_mesh"] = create_mesh(data=1, model=tp or 1, seq=sp or 1, pipe=pp)
        elif sp:
            meshes["sequence_mesh"] = create_mesh(data=1, model=tp or 1, seq=sp)
        else:
            meshes["tp_mesh"] = create_mesh(data=1, model=tp)
    _MESHES[key] = meshes
    return meshes


def loop_meshes(meshes: Optional[dict]) -> dict:
    """The pipelines' DiT mesh kwargs of `build_meshes`'s meshes."""
    return {name: (meshes or {}).get(name) for name in ("sequence_mesh", "pipeline_mesh")}


def _dit_mesh(meshes: Optional[dict]):
    meshes = meshes or {}
    return meshes.get("pipeline_mesh") or meshes.get("tp_mesh") or meshes.get("sequence_mesh")


def tp_axis_of(meshes: Optional[dict]):
    """The DiT's tensor-parallel axis of the meshes (the 'model' axis of the
    pipeline, TP or sequence mesh), or None."""
    from ltx2_tpu_torch.parallel.mesh import MODEL_AXIS, axis_of

    return axis_of(_dit_mesh(meshes), MODEL_AXIS)


def pipe_axis_of(meshes: Optional[dict]):
    """The DiT's pipeline axis of the meshes (the pipeline mesh's 'pipe'
    axis), or None."""
    from ltx2_tpu_torch.parallel.mesh import PIPE_AXIS, axis_of

    return axis_of((meshes or {}).get("pipeline_mesh"), PIPE_AXIS)


def check_pipe_stages(num_layers: int, meshes: Optional[dict]) -> None:
    """--pp-stages must divide the DiT's blocks: a usage exit with the JAX
    CLI's message (scripts/generate.py:620-630)."""
    pipe = pipe_axis_of(meshes)
    if pipe is not None and num_layers % pipe.size:
        raise SystemExit(f"--pp-stages {pipe.size} must divide {num_layers} transformer blocks")


def place_transformer(dit: LTXModel, meshes: Optional[dict]) -> LTXModel:
    """The DiT as this rank's placement (scripts/generate.py::_place_transformer):
    under a pipeline mesh only its stage's blocks kept; under TP its tensors
    sliced to the rank's shard. A DiT loaded whole (random weights, or a
    LoRA fused) is cut in place; one the ledger loaded as its placement is
    kept."""
    check_pipe_stages(dit.cfg.num_layers, meshes)
    mesh = _dit_mesh(meshes)
    if mesh is None:
        return dit
    from ltx2_tpu_torch.parallel.pipeline_parallel import shard_pipeline_params

    return shard_pipeline_params(mesh, dit)


def _rank() -> int:
    from ltx2_tpu_torch.parallel.runtime import world

    return world()[0]


def _check_early_layers(args) -> None:
    """`--early-layers-only` feeds Gemma's hidden state to the DiT's caption
    projection: refused, with the JAX CLI's message, when the checkpoint's
    DiT does not take Gemma's width (a V2 DiT has no caption projection)."""
    from ltx2_tpu_torch.loader.weight_loader import transformer_config_from_checkpoint
    from ltx2_tpu_torch.models.text_encoder.gemma3 import gemma_config_from_checkpoint

    dit_cfg = transformer_config_from_checkpoint(args.checkpoint)
    hidden = gemma_config_from_checkpoint(args.gemma_dir).hidden_size
    if dit_cfg.caption_channels != hidden:
        raise ValueError(f"--early-layers-only needs a V1 checkpoint whose caption projection takes {hidden}-d input "
                         f"(this model consumes {dit_cfg.caption_channels or dit_cfg.cross_attention_dim}-d context)")


def setup(args, resident_models: bool = True) -> Tuple[Optional[ResidentModels], Optional[ModelLedger]]:
    """A launch's (models, ledger), on settings `check_request` passed: with
    `resident_models` the ledger of --checkpoint (`make_ledger`) and the modules the launch's pipeline runs, built (or
    loaded) once into a `ResidentModels` that `execute_request` reuses for
    every request, as the JAX CLI's `setup` keeps its models resident: the
    DiT, the upscaler(s), the decoder, the video encoder when the launch
    encodes images or video, Gemma and the text encoder when it encodes
    prompts, the audio decoder and vocoder (a2vid: the audio encoder) with
    audio. A request on another pipeline builds what it needs on its first
    run, then keeps it. Without `resident_models` (the one-shot command
    line) both are None: the request makes its ledger, and each flow builds
    its modules and releases each when its phase is over. `--auto-shard`
    fills the layout flags first (`apply_auto_shard`); under layout flags
    the meshes are built here (`build_meshes`) and the DiT is loaded or
    drawn as this rank's placement."""
    apply_auto_shard(args)
    if not resident_models:
        return None, None
    meshes = build_meshes(args)
    ledger = make_ledger(args, meshes)
    models = ResidentModels()
    with resident(models):
        _build_launch(args, ledger, meshes)
    return models, ledger


def make_ledger(args, meshes: Optional[dict] = None) -> Optional[ModelLedger]:
    """The ledger of --checkpoint and the files beside it (None without a
    checkpoint, and for bench-e2e); it loads nothing until asked. Under
    tensor or pipeline parallelism (`meshes`) it loads the DiT as this
    rank's shard, or stage."""
    if not args.checkpoint or args.pipeline == "bench-e2e":
        return None
    return ModelLedger(
        checkpoint_path=args.checkpoint, gemma_path=args.gemma_dir, spatial_upscaler_path=args.spatial_upscaler,
        temporal_upscaler_path=args.temporal_upscaler,
        loras=[parse_lora_spec(spec, args.lora_strength) for spec in args.lora], target_dtype=args.dtype,
        keep_fp8=args.fp8_serving, int8=args.int8, gemma_fp8=args.gemma_fp8, decoder_dtype="bfloat16",
        device=args.device, include_audio=args.audio or args.pipeline == "a2vid", tp_axis=tp_axis_of(meshes),
        pipe_axis=pipe_axis_of(meshes),
    )


def _build_launch(args, ledger, meshes: Optional[dict] = None) -> None:
    """The modules `_run_flow` builds for the launch's pipeline, built with
    the flows' own helpers (so a request finds each under its key)."""
    device = resolve_device(args.device)
    stats = [{}]
    flow, audio = args.pipeline, args.audio or args.pipeline == "a2vid"
    if flow == "bench-e2e":
        base = LTXModelConfig(compute_dtype=args.dtype)
        _random_dit(stats, device, args.layers, base, fp8=not args.int8, int8=args.int8)
        if not args.skip_vae:
            _video_decoder(stats, device, None, base.compute_dtype)
        return
    width = None
    if _encodes(args):
        _gemma(stats, device, ledger)
        if not args.early_layers_only:
            encoder = _text_encoder(stats, device, ledger, audio and flow not in ("keyframe", "retake"))
            width = encoder.cfg.connector.inner_dim
    elif args.embedding:
        with np.load(args.embedding) as data:
            width = int(data["positive"].shape[-1])
    encodes_video = ((args.image and flow not in ("retake", "ic-lora")) or flow in ("keyframe", "retake")
                     or (flow == "ic-lora" and args.control_video))
    runtime_lora = (flow == "two-stage" and args.distilled_lora) or flow == "ic-lora"
    dit, _ = _dit_and_encoder(stats, device, args.layers, None, None, [None] if encodes_video else [], ledger,
                              None if ledger is not None else width, args.dtype,
                              audio and flow not in ("keyframe", "retake"), fp8=not runtime_lora,
                              int8=args.int8 and flow != "ic-lora", meshes=meshes)
    if flow in STAGED or args.upscale_spatial:
        _spatial_upscaler(stats, device, None, ledger, None)
    if args.upscale_temporal:
        _temporal_upscaler(stats, device, ledger)
    if flow in STAGED or args.upscale_spatial or args.upscale_temporal:
        _latent_statistics(dit.cfg, None, ledger, device)
    if flow == "a2vid":
        _audio_encoder(stats, device, ledger)
    if not args.skip_vae:
        _video_decoder(stats, device, ledger, dit.cfg.compute_dtype)
        if args.audio and flow not in ("a2vid", "keyframe", "retake"):
            _audio_decoder(stats, device, ledger)
            _vocoder(stats, device, ledger)


def enhance_request_prompt(args, ledger) -> Tuple[str, dict]:
    """`--enhance-prompt`: the request's prompt expanded by the launch's
    Gemma (the ledger's, loaded once and kept with the resident models),
    as the JAX CLI expands it: the T2V system prompt (512 new tokens), or
    with --image the I2V one (256), sampled at temperature 0.7 and top_p 0.9
    from --seed (the port's torch.Generator stream: the text differs from
    the JAX CLI's at the same seed). Returns (prompt, stats: the enhanced
    prompt, its seconds, Gemma's load seconds)."""
    from ltx2_tpu_torch.models.text_encoder.generation import generate_text
    from ltx2_tpu_torch.utils.prompt_enhancement import T2V_SYSTEM_PROMPT, enhance_prompt, enhance_prompt_i2v
    from ltx2_tpu_torch.utils.tokenizer import load_tokenizer

    device = resolve_device(args.device)
    st: dict = {}
    gemma = _built(device, st, "enhance_gemma_init_s", "gemma", ledger.gemma)
    tokenizer = load_tokenizer(args.gemma_dir)

    def gen_fn(text, n, temperature=0.7, top_p=0.9):
        return generate_text(gemma, tokenizer, text, max_new_tokens=n, temperature=temperature, top_p=top_p,
                             seed=args.seed)

    prompt = DEFAULT_PROMPT if args.prompt is None else args.prompt
    t0 = time.perf_counter()
    if args.image:
        prompt = enhance_prompt_i2v(prompt, parse_image_spec(args.image[0]).image_path, gen_fn)
    else:
        prompt = enhance_prompt(prompt, lambda text, n: gen_fn(text, n), system_prompt=T2V_SYSTEM_PROMPT)
    st["enhance_s"] = time.perf_counter() - t0
    st["enhanced_prompt"] = prompt
    print(f"enhanced prompt: {prompt}", file=sys.stderr)
    return prompt, st


def execute_request(args, models: Optional[ResidentModels] = None, ledger: Optional[ModelLedger] = None
                    ) -> Tuple[list, List[dict]]:
    """One request on settings `check_request` passed: the flow
    `args.pipeline` names on `models` and `ledger` (`setup`'s; inside
    `resident(models)`, so a server reuses them), each clip's file written
    (`--output`, `<base>_<i><ext>` for several, the latent's npz with
    --skip-vae). Returns (each clip's frames, or (frames, waveform) with
    --audio, or its latent with --skip-vae; each clip's stats, its file's
    path under "output" and the seconds of writing it under "save_s"). With
    layout flags every rank runs it (`build_meshes`) and rank 0 alone writes
    the files."""
    seeds = [args.seed + i for i in range(args.requests)]
    meshes = build_meshes(args)
    common = dict(height=args.height, width=args.width, frames=args.frames, layers=args.layers, device=args.device,
                  fps=args.fps, dtype=args.dtype, skip_decode=args.skip_vae, int8=args.int8)
    if meshes:
        common["meshes"] = meshes
    cfg_flow = args.pipeline in ("one-stage", "text-to-video")
    with _profile(args.profile_dir), resident(models):
        videos, stats = _run_flow(args, seeds, common, _encodes(args), cfg_flow, args.pipeline == "two-stage", ledger)
    if _rank() != 0:  # rank 0 writes every output
        return videos, stats
    paths = output_paths(args.output, len(videos), "_latent.npz" if args.skip_vae else "")
    for out, path, st in zip(videos, paths, stats):
        video, wave = out if args.audio else (out, None)
        t0 = time.perf_counter()
        if args.skip_vae:
            np.savez(path, latent=video, **({} if wave is None else {"audio_latent": wave}))
        else:
            # The vocoder's own rate: LTX-2.3's BWE chain writes 48 kHz.
            save_video(video, path, args.fps, output_fps=args.output_fps, speed=args.speed, audio=wave,
                       audio_sample_rate=st.get("audio_sample_rate", 24000))
        st["output"], st["save_s"] = path, time.perf_counter() - t0
    return videos, stats


def main(argv=None) -> Tuple[List[np.ndarray], List[dict]]:
    """The command line: `setup` without resident models, then
    `execute_request`, so every module is released when its phase is over;
    writes each request's video (or latent) file, prints one JSON line per
    request and returns (frames, stats) as the generate functions do (the
    latents with --skip-vae)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        check_request(args)
    except ValueError as err:
        ap.error(str(err))
    models, ledger = setup(args, resident_models=False)
    videos, stats = execute_request(args, models, ledger)
    if _rank() != 0:
        return videos, stats
    for out, st in zip(videos, stats):
        video = out[0] if args.audio else out
        print(json.dumps({**st, "frames": list(video.shape), "dtype": str(video.dtype)}))
    return videos, stats


def _run_flow(args, seeds, common: dict, encode: bool, cfg_flow: bool, two_stage: bool, ledger=None):
    """The flow `args.pipeline` names, on the settings `check_request`
    passed, with `ledger` (`setup`'s, else made here) for the components
    of a checkpoint."""
    if args.pipeline == "bench-e2e":
        videos, stats = generate_videos(seeds, steps=args.steps, **common)
    else:
        if ledger is None:
            ledger = make_ledger(args, common.get("meshes"))
        prompt, enhanced = DEFAULT_PROMPT if args.prompt is None else args.prompt, {}
        if args.enhance_prompt:
            prompt, enhanced = enhance_request_prompt(args, ledger)
        tokens = None
        if args.gemma_dir and encode:
            tokens = tokenize_prompts(args.gemma_dir, prompt,
                                      DEFAULT_NEGATIVE_PROMPT if args.negative_prompt is None else args.negative_prompt)
        contexts = audio_contexts = None
        pairs = cfg_flow or two_stage or args.pipeline in ("ti2vid-hq", "retake")
        if args.embedding:
            context = load_embedding(args.embedding, args.device, negatives=pairs)
            contexts = [context] * len(seeds)
            audio_context = load_embedding(args.embedding, args.device, negatives=pairs, audio=True)
            if (args.audio or args.pipeline == "a2vid") and audio_context is not None:
                audio_contexts = [audio_context] * len(seeds)
        embeddings = [] if args.save_embedding else None
        images = [parse_image_spec(spec, args.image_strength) for spec in args.image]
        flow = dict(text_encoder=EARLY_LAYERS if encode and args.early_layers_only else encode,
                    phase_peaks=True, ledger=ledger, images=images, contexts=contexts,
                    tokens=tokens, embeddings=embeddings, tiling=tiling_config(args), audio=args.audio,
                    audio_contexts=audio_contexts, internal_audio=not args.no_internal_audio, **common)
        if cfg_flow:
            # text-to-video is the one-stage pipeline with plain CFG, as in
            # scripts/generate.py: rescale 0, every other flag as given.
            rescale = 0.0 if args.pipeline == "text-to-video" else args.rescale_scale
            videos, stats = generate_videos_one_stage(
                seeds, steps=args.num_inference_steps, cfg_scale=args.cfg_scale, rescale_scale=rescale,
                token_shift=args.token_shift, cfg_interval=args.cfg_interval, token_bucket=args.token_bucket,
                upscale_spatial=args.upscale_spatial, upscale_temporal=args.upscale_temporal, stg_scale=args.stg_scale,
                stg_blocks=[int(b) for b in args.stg_blocks.split(",")] if args.stg_blocks else None,
                stg_cutoff=args.stg_cutoff, stg_mode=args.stg_mode, guider_override=apg_guider(args),
                ge_gamma=args.ge_gamma, sampler=args.sampler, cross_attn_scale=args.cross_attn_scale,
                cross_attn_start_block=args.cross_attn_start_block, cache_text_kv=args.cache_text_kv,
                audio_cfg_scale=args.audio_cfg_scale, **flow)
        elif two_stage:
            lora = LoRAConfig(args.distilled_lora, args.distilled_lora_scale) if args.distilled_lora else None
            videos, stats = generate_videos_two_stage(
                seeds, steps=args.num_inference_steps,
                cfg_scale=args.cfg_scale if args.cfg_stage1 is None else args.cfg_stage1,
                audio_cfg_scale=args.audio_cfg_scale, rescale_scale=args.rescale_scale,
                modality_scale=args.modality_scale, cfg_interval=args.cfg_interval, token_shift=args.token_shift,
                distilled_lora=lora, **flow)
        elif args.pipeline == "a2vid":
            flow.pop("internal_audio")
            videos, stats = generate_videos_a2vid(seeds, audio_file=args.audio_file, **flow)
        elif args.pipeline == "keyframe":
            for key in ("images", "audio", "audio_contexts", "internal_audio"):
                flow.pop(key)
            videos, stats = generate_videos_keyframe(
                seeds, [parse_keyframe_spec(spec) for spec in args.keyframe], token_shift=args.token_shift, **flow)
        elif args.pipeline == "ti2vid-hq":
            videos, stats = generate_videos_ti2vid_hq(
                seeds, steps=args.num_inference_steps, cfg_scale=args.cfg_scale, audio_cfg_scale=args.audio_cfg_scale,
                token_shift=args.token_shift, **flow)
        elif args.pipeline == "retake":
            # The source's own height, width, frames and fps.
            for key in ("images", "audio", "audio_contexts", "internal_audio", "height", "width", "frames", "fps"):
                flow.pop(key)
            videos, stats = generate_videos_retake(
                seeds, args.video, start_time=args.retake_start, end_time=args.retake_end,
                steps=args.num_inference_steps, cfg_scale=args.cfg_scale, cfg_interval=args.cfg_interval,
                token_shift=args.token_shift, **flow)
        elif args.pipeline == "ic-lora":
            for key in ("images", "int8"):
                flow.pop(key)
            videos, stats = generate_videos_ic_lora(
                seeds, args.control_video, control_type=args.control_type, control_strength=args.control_strength,
                canny_low=args.canny_low, canny_high=args.canny_high, save_control=args.save_control,
                ic_lora=parse_lora_spec(args.ic_lora_weights) if args.ic_lora_weights else None, **flow)
        else:
            videos, stats = generate_videos_distilled(seeds, **flow)
        if args.embedding:
            for st in stats:
                st["prompt_source"] = "embedding"
        if args.save_embedding:
            np.savez(args.save_embedding, **embeddings[0])
        for st in stats:
            st.update(enhanced)
    return videos, stats


def _apply_reference_compat(args) -> None:
    """The JAX CLI's compatibility flags mapped onto the port's settings
    (scripts/generate.py:350-394): --fp32 sets --dtype float32 (--fp16 keeps
    bfloat16), --fp8 is --fp8-serving, --int8 refuses --fp8-serving and a
    runtime LoRA fuse, --tiled-vae asks for the default tiling,
    --placeholder drops the checkpoint and text encoding, --model-variant
    picks the reference checkpoint when it exists; --low-memory,
    --fast-mode and --compile-cache are accepted with a note on stderr."""
    if args.fp32:
        args.dtype = "float32"
    elif args.fp16:
        print("--fp16: using bfloat16", file=sys.stderr)
    if args.fp8:
        args.fp8_serving = True
    if args.int8 and args.fp8_serving:
        raise ValueError("--int8 and --fp8-serving are mutually exclusive: int8 W8A8 re-quantizes from full-precision "
                 "weights (load dequantized, i.e. drop --fp8-serving/--fp8, to use --int8)")
    runtime_fuse = None
    if args.distilled_lora and args.pipeline in ("two-stage", "ti2vid-hq"):
        runtime_fuse = "--distilled-lora (fused into stage 2 at runtime)"
    elif args.pipeline == "ic-lora":
        runtime_fuse = "ic-lora's stage-boundary fuse/unfuse"
    if args.int8 and runtime_fuse:
        raise ValueError(f"--int8 is incompatible with {runtime_fuse}: LoRA deltas need full-precision weights to fuse "
                 "into. Drop --int8 for this pipeline.")
    if args.pipeline == "ic-lora":
        # The IC-LoRA is fused for stage 1 only inside the pipeline: the
        # first --lora stands for it when --ic-lora-weights is absent, and it
        # is kept out of the ledger's load-time fuse.
        if args.lora and not args.ic_lora_weights:
            args.ic_lora_weights = args.lora[0]
        if args.ic_lora_weights:
            ic_path = args.ic_lora_weights.split(":")[0]
            args.lora = [spec for spec in args.lora if spec.split(":")[0] != ic_path]
    for flag, on in (("--low-memory", args.low_memory), ("--fast-mode", args.fast_mode)):
        if on:
            print(f"{flag}: accepted, no effect", file=sys.stderr)
    if args.compile_cache:
        print(f"--compile-cache {args.compile_cache}: the JAX CLI's XLA compilation cache; the port compiles no "
              "XLA, ignored", file=sys.stderr)
    if args.placeholder:
        if args.checkpoint:
            print("--placeholder: random weights, the checkpoint is not loaded", file=sys.stderr)
        args.checkpoint = None
        args.no_gemma = True
    elif args.checkpoint is None and args.model_variant:
        candidate = (f"weights/ltx-2/ltx-2-19b-{args.model_variant}{'-fp8' if args.fp8_serving else ''}"
                     ".safetensors")
        if os.path.exists(candidate):
            args.checkpoint = candidate
            print(f"--model-variant {args.model_variant}: using {candidate}", file=sys.stderr)


if __name__ == "__main__":
    main()
