"""Where the time of the distilled video slice, or of a LoRA train step,
goes on one GPU.

    python -m ltx2_tpu_torch.profile_slice [--layers 48]
    python -m ltx2_tpu_torch.profile_slice --train [--layers 48]

Traces, with torch.profiler, one step of the entry's denoise loop (the DiT
forward, modality rebuild and fp32 Euler step at 512x768x121f = 6144 tokens,
plus the loop's once-per-clip RoPE tables; random weights, bf16), the
bench-e2e decode of one 7-latent-frame chunk to uint8 frames, the
two-stage recipe's decode of one default tile (8 x 16 x 16 latent voxels)
and its fp32 spatial-upscaler call on the stage-1 latent, each after a
warm-up run. The model, inputs and decode come from generate.py's own
helpers. With --train it traces instead one rank-16 LoRA train step of the
full-width DiT at scripts/bench_train.py's shape (6144 tokens, 1024 text
tokens: forward, remat recompute, backward and AdamW), after a warm-up step,
built by train.py's own helpers. Prints one JSON line per phase: device time
by kernel class (the flash-attention forward and backward kernels, the
implicit-GEMM conv kernel, matrix products, library convolutions, the
rest), the top kernels, the host wall time of the traced run and the
device's busy share of it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ltx2_tpu_torch import train
from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.generate import (
    decode_chunked, distilled_sigmas, make_decoder, make_dit, make_distilled_loop, make_latent_tools, make_request,
    make_upscaler,
)
from ltx2_tpu_torch.models.upscaler.spatial import spatial_upscaler_apply
from ltx2_tpu_torch.models.video_vae.decoder import video_decoder_apply
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_attention_fwd"
    if "flash_bwd_kernel" in n:
        return "flash_attention_bwd"
    if "conv3d_bf16_kernel" in n or "conv3d_f32_kernel" in n:
        return "conv3d_implicit_gemm"
    if "fprop" in n or "conv" in n or "dgrad" in n or "implicit" in n:
        return "convolution"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "xmma" in n or "matmul" in n:
        return "matmul"
    return "other"


def _traced(fn, device: torch.device) -> dict:
    fn()  # warm-up: kernel build, cuDNN/cuBLAS heuristics, allocator
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict = {}
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us <= 0 or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, e.count, e.key[:90]))
    device_ms = sum(by_class.values())
    kernels.sort(reverse=True)
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if wall_ms else None,
        "device_ms_by_class": by_class,
        "top_kernels": [{"ms": ms, "count": c, "name": n} for ms, c, n in kernels[:8]],
    }


def _train_step(layers: int, device: torch.device, card: str) -> None:
    dit = train.make_model(layers, device, seed=0)
    train.select_trainable(dit, train.build_parser().parse_args(["--lora-rank", "16"]), device)
    step, batch, flops = train.bench_step(dit, device)
    gen = torch.Generator(device=device)
    rec = _traced(lambda: step(batch, gen.manual_seed(0)), device)
    print(json.dumps({"phase": "train_step", "layers": layers, "tokens": batch.x0.shape[1],
                      "text_tokens": batch.context.shape[1], "lora_rank": 16,
                      "tflops_per_s_wall": flops / rec["wall_ms"] / 1e9, "card": card, **rec}), flush=True)


def _serving(layers: int, device: torch.device, card: str) -> None:
    dit = make_dit(layers, device)
    tools = make_latent_tools(dit.cfg, 512, 768, 121)
    state, context = make_request(dit.cfg, tools, 0, device)
    loop, sigmas = make_distilled_loop(dit.cfg), distilled_sigmas(1)
    step = _traced(lambda: loop(dit, state, sigmas, context), device)
    print(json.dumps({"phase": "denoise_step", "layers": layers, "tokens": tools.target_shape.tokens,
                      "card": card, **step}), flush=True)
    compute_dtype, latent_dtype = dit.cfg.compute_dtype, dit.cfg.dtype
    del dit, loop, state, context
    torch.cuda.empty_cache()

    decoder = make_decoder(compute_dtype, device)
    gen = torch.Generator(device=device).manual_seed(0)
    shape = tools.target_shape
    chunk = torch.randn(1, shape.channels, 7, shape.height, shape.width, generator=gen, device=device)
    chunk = chunk.to(latent_dtype)
    dec = _traced(lambda: decode_chunked(chunk, decoder, 0), device)
    print(json.dumps({"phase": "decode_chunk", "latent_frames": 7, "card": card, **dec}), flush=True)

    # The two-stage recipe's decode: one tile of TilingConfig.default() (8 x
    # 16 x 16 latent voxels), decoded as pipelines/common.decode_video does.
    spec = generate_tile_specs(shape.to_tuple(), TilingConfig.default())[0]
    tile_shape = (1, shape.channels, spec.in_t_end - spec.in_t_start, spec.in_h_end - spec.in_h_start,
                  spec.in_w_end - spec.in_w_start)
    tile = torch.randn(tile_shape, generator=gen, device=device).to(latent_dtype)
    noise = torch.randn(tile_shape, generator=gen, device=device)
    rec = _traced(lambda: video_decoder_apply(decoder, tile, timestep=0.05, noise=noise), device)
    print(json.dumps({"phase": "decode_tile", "latent_shape": list(tile_shape), "card": card, **rec}), flush=True)
    del decoder
    torch.cuda.empty_cache()

    # The two-stage recipe's upscale: one fp32 spatial-upscaler call on the
    # stage-1 latent (16 x 8 x 12 voxels at 256x384x121).
    upscaler = make_upscaler(device)
    latent = torch.randn(1, shape.channels, shape.frames, shape.height // 2, shape.width // 2, generator=gen,
                         device=device)
    rec = _traced(lambda: spatial_upscaler_apply(upscaler, latent), device)
    print(json.dumps({"phase": "upscale", "latent_shape": list(latent.shape), "card": card, **rec}), flush=True)



def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--train", action="store_true", help="trace a LoRA train step instead of the serving path")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    if args.train:
        _train_step(args.layers, device, card)
        return
    with torch.no_grad():
        _serving(args.layers, device, card)

if __name__ == "__main__":
    main()
