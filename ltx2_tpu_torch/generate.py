"""Distilled text-to-video generation, video only, on one GPU.

The same steps as the JAX package's `scripts/bench_e2e.py` (and the second
stage of `generate.py --pipeline distilled`): Gaussian noise -> 8-sigma
distilled Euler loop with CFGGuider(1.0) and uniform timesteps over the
video DiT -> un-patchify -> VAE decode in temporal chunks -> uint8 frames.
Weights are random, drawn on the device from a seed; the text context is
the dummy embedding of `generate.py --no-gemma` (normal * 0.02, 1024 x 4096).

From Python: `generate_video(seed=0)` or `generate_videos([0, 1, ...])`.
From the shell (N clips in one process, seeds seed..seed+N-1):

    python -m ltx2_tpu_torch.generate --requests 2
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.components.schedulers import DISTILLED_SIGMA_VALUES
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig, init_ltx_model_
from ltx2_tpu_torch.models.video_vae.chunking import decode_latent
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig, init_video_decoder_
from ltx2_tpu_torch.ops.attention import flash_attention
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.types import LatentState, VideoLatentShape, VideoPixelShape

CONTEXT_TOKENS = 1024
FPS = 24.0
TEMPORAL_CHUNK = 7  # latent frames per decode chunk, the JAX bench's setting


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_dit(layers: int, device: torch.device, seed: int = 0, base: LTXModelConfig = LTXModelConfig()) -> LTXModel:
    """The video DiT of config `base` (default: full width) at `layers`
    depth, random weights drawn on the device from `seed`."""
    dit = LTXModel(dataclasses.replace(base, num_layers=layers), device=device)
    return init_ltx_model_(dit, torch.Generator(device=device).manual_seed(seed))


def make_decoder(compute_dtype: str, device: torch.device) -> VideoDecoder:
    """The full-width video decoder, random weights from seed 1."""
    decoder = VideoDecoder(VideoDecoderConfig(compute_dtype=compute_dtype), device=device)
    return init_video_decoder_(decoder, torch.Generator(device=device).manual_seed(1))


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
        context = torch.randn(1, CONTEXT_TOKENS, cfg.cross_attention_dim, generator=gen, device=device) * 0.02
    state = GaussianNoiser()(gen, tools.create_initial_state(dtype=cfg.dtype, device=device), 1.0, noise=noise)
    return state, context


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
    Random weights are drawn from seed 0 (DiT) and 1 (decoder).
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sigmas = distilled_sigmas(steps)

    stats = [{"seed": seed, "dit_init_s": 0.0, "decoder_init_s": 0.0} for seed in seeds]
    if dit is None:
        t0 = time.perf_counter()
        dit = make_dit(layers, device)
        _sync(device)
        stats[0]["dit_init_s"] = time.perf_counter() - t0
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
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if decoder is None:
        t0 = time.perf_counter()
        decoder = make_decoder(cfg.compute_dtype, device)
        _sync(device)
        stats[0]["decoder_init_s"] = time.perf_counter() - t0

    videos = []
    for latent, st in zip(latents, stats):
        t0 = time.perf_counter()
        videos.append(decode_chunked(latent, decoder, st["seed"]))
        st["decode_s"] = time.perf_counter() - t0  # decode_latent returns host frames: synchronised
    return videos, stats


def decode_chunked(latent: torch.Tensor, decoder: VideoDecoder, seed: int) -> np.ndarray:
    """The entry's VAE decode: 7-latent-frame chunks, decode noise from `seed`."""
    return decode_latent(
        latent, decoder, timestep=0.05,
        generator=torch.Generator(device=latent.device).manual_seed(seed),
        temporal_chunk_size=TEMPORAL_CHUNK,
    )


def generate_video(seed: int = 0, **kwargs) -> np.ndarray:
    """One clip: uint8 (frames, height, width, 3). See generate_videos."""
    videos, _ = generate_videos([seed], **kwargs)
    return videos[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--frames", type=int, default=121)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=1, help="clips to generate, seeds seed..seed+N-1")
    args = ap.parse_args(argv)
    videos, stats = generate_videos(
        [args.seed + i for i in range(args.requests)], height=args.height, width=args.width,
        frames=args.frames, steps=args.steps, layers=args.layers, device=args.device,
    )
    for video, st in zip(videos, stats):
        print(json.dumps({**st, "frames": list(video.shape), "dtype": str(video.dtype)}))


if __name__ == "__main__":
    main()
