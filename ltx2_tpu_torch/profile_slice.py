"""Where the time of the distilled video slice, or of a LoRA train step,
goes on one GPU.

    python -m ltx2_tpu_torch.profile_slice [--layers 48]
    python -m ltx2_tpu_torch.profile_slice --train [--audio] [--layers 48]
    python -m ltx2_tpu_torch.profile_slice --one-stage-options [--layers 48]
    python -m ltx2_tpu_torch.profile_slice --audio [--layers 48]
    python -m ltx2_tpu_torch.profile_slice --two-stage [--layers 48]

Traces, with torch.profiler, one text encode of the two-stage recipe's
`--text-encoder` flow (the full-width fp32 Gemma-3-12B and V1 encoder on one
request's 2 x 1024 prompt tokens; its device time also by the op that
launched each kernel: matrix products, the plain attention's products and
softmax, the rest), one step of the entry's denoise loop (the DiT
forward, modality rebuild and fp32 Euler step at 512x768x121f = 6144 tokens,
plus the loop's once-per-clip RoPE tables; random weights kept in fp8 as the
entry keeps them, then the same weights in bf16), the bf16
step at the two-stage recipe's stage-1 size (256x384x121f, 1536 tokens), one
step of the one-stage CFG* loop at the JAX defaults' 480x704x97 (4290
tokens, two guidance rows) with the first latent frame conditioned by an
image (per-token timesteps) and without (uniform), the bench-e2e decode of
one 7-latent-frame chunk to uint8 frames, the two-stage recipe's decode of
one default tile (8 x 16 x 16 latent voxels), its fp32 spatial-upscaler
call on the stage-1 latent and one fp32 video-encoder call on a 512x768
frame, each after a warm-up run. The model, inputs and decode come from generate.py's own
helpers. With --train it traces instead one rank-16 LoRA train step of the
full-width DiT at scripts/bench_train.py's shape (6144 tokens, 1024 text
tokens: forward, remat recompute, backward and AdamW), after a warm-up step,
built by train.py's own helpers; with --train --audio one such step of the
audio-video DiT at `train.bench_arrays`' sample (126 audio tokens with their
own 1024-token masked context) in bf16, then on its fp8 frozen base. With --one-stage-options it traces instead,
at 480x704x97 (4290 tokens) with the first latent frame conditioned, one
step of the one-stage loop with the options of chip_smoke.py's request A
but Heun and GE (CFG* at 3.0, STG on block 29: three guidance rows; the
cross-attention scale from block 40; cached text K/V; a 512-token bucket:
4608 tokens, the key-valid route), and then text-to-video's APG loop with
guidance reuse every second step (uniform timesteps) over two steps and
over one: the second step is a reduced one (the cond row alone), and its
device time by class is the difference. Each traced loop call includes
its once-per-clip RoPE tables (and text K/V). With --audio it traces
instead one step of the distilled loop over the video-only DiT and over
the audio-video DiT (both kept in fp8, 6144 video tokens; the AV step also
the 126 audio tokens of 121 frames at 24 fps), and one audio decode (the
published audio decoder and the 1024-channel vocoder, fp32) of that audio
latent. With --two-stage it traces instead one step of the two-stage CFG
pipeline's stage 1 over the audio-video DiT in bf16 (the multi-modal loop:
cond, uncond and modality-isolated rows, 3 x 1536 video and 3 x 126 audio
tokens, CFG 3.0, audio CFG 7.0, modality 3.0, rescale 0.7) beside the
1-row distilled AV step at the same size. Prints one JSON line per phase: device time
by kernel class (the flash-attention forward and backward kernels, the
implicit-GEMM conv kernels with the fp32 one's split-K sum, matrix
products, library convolutions, the rest), the top kernels, the host wall
time of the traced run and the device's busy share of it. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ltx2_tpu_torch import train
from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.loader.fp8 import weight_bytes
from ltx2_tpu_torch.components.guiders import CFGStarRescalingGuider, LtxAPGGuider
from ltx2_tpu_torch.components.schedulers import LTX2Scheduler
from ltx2_tpu_torch.conditioning.latent import VideoConditionByLatentIndex
from ltx2_tpu_torch.generate import (
    av_config, decode_chunked, distilled_sigmas, dummy_context, make_audio_decoder, make_decoder, make_dit,
    make_distilled_loop, make_encoder, make_gemma, make_latent_tools, make_request, make_text_encoder, make_upscaler,
    make_vocoder, prompt_tokens,
)
from ltx2_tpu_torch.pipelines.common import decode_audio
from ltx2_tpu_torch.pipelines.distilled import AudioFields
from ltx2_tpu_torch.types import VideoPixelShape
from ltx2_tpu_torch.models.text_encoder import gemma3_apply, video_text_encoder_apply
from ltx2_tpu_torch.models.upscaler.spatial import spatial_upscaler_apply
from ltx2_tpu_torch.models.video_vae.decoder import video_decoder_apply
from ltx2_tpu_torch.models.video_vae.encoder import video_encoder_apply
from ltx2_tpu_torch.pipelines.common import bucketed_tokens, pad_state_tokens
from ltx2_tpu_torch.pipelines.denoise import (
    DenoiseLoopConfig, MultiModalLoopConfig, make_av_denoise_loop, make_multimodal_av_denoise_loop,
    make_video_denoise_loop,
)
from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_attention_fwd"
    if "flash_bwd_kernel" in n:
        return "flash_attention_bwd"
    if "conv3d_wgmma_kernel" in n or "conv3d_tf32x3" in n:
        return "conv3d_implicit_gemm"
    if "fprop" in n or "conv" in n or "dgrad" in n or "implicit" in n:
        return "convolution"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "xmma" in n or "matmul" in n:
        return "matmul"
    return "other"


def _encode_op_class(op: str) -> str:
    """The class of the device time an op launched, in the text encode:
    `sdpa_plain`'s products (bmm) and softmax, the linears' products, the
    rest (norms, RoPE, masks, the extractor's normalisation, casts)."""
    if op in ("aten::bmm", "aten::_softmax"):
        return "attention_plain"
    if op in ("aten::mm", "aten::addmm"):
        return "matmul"
    return "elementwise"


def _traced(fn, device: torch.device, op_class=None) -> dict:
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
    rec = {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if wall_ms else None,
        "device_ms_by_class": by_class,
        "top_kernels": [{"ms": ms, "count": c, "name": n} for ms, c, n in kernels[:8]],
    }
    if op_class is not None:
        # Device time by the aten op that launched each kernel (its own
        # kernels only). Runtime events such as "Command Buffer Full" (the
        # host waiting for room in the launch queue) carry copies of their
        # op's kernels and are left out; the sum must equal device_ms.
        by_op: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CPU and e.kernels and e.name.startswith("aten::"):
                by_op[e.name] = by_op.get(e.name, 0.0) + sum(k.duration for k in e.kernels) / 1e3
        by_op_class: dict = {}
        for name, ms in by_op.items():
            by_op_class[op_class(name)] = by_op_class.get(op_class(name), 0.0) + ms
        rec["device_ms_by_op_class"] = by_op_class
        rec["device_ms_attributed"] = sum(by_op.values())
        rec["top_ops"] = [{"op": n, "ms": ms} for n, ms in sorted(by_op.items(), key=lambda kv: -kv[1])[:8]]
    return rec


def _text_encode(device: torch.device, card: str) -> None:
    gemma, encoder = make_gemma(device), make_text_encoder(device)
    ids, mask, lengths = prompt_tokens(0, gemma.cfg.vocab_size)
    ids, mask = ids.to(device), mask.to(device)

    def encode():
        return video_text_encoder_apply(encoder, gemma3_apply(gemma, ids, mask)[1], mask)

    rec = _traced(encode, device, op_class=_encode_op_class)
    print(json.dumps({"phase": "text_encode", "tokens": list(ids.shape), "prompt_tokens": lengths, "card": card,
                      **rec}), flush=True)


def _train_step(layers: int, device: torch.device, card: str, audio: bool = False, fp8: bool = False) -> None:
    dit = train.make_model(layers, device, seed=0, audio=audio, fp8=fp8)
    train.select_trainable(dit, train.build_parser().parse_args(["--lora-rank", "16"]), device)
    step, batch, flops = train.bench_step(dit, device)
    gen = torch.Generator(device=device)
    rec = _traced(lambda: step(batch, gen.manual_seed(0)), device)
    extra = {} if batch.audio_x0 is None else {"audio_tokens": batch.audio_x0.shape[1],
                                               "audio_text_tokens": batch.audio_context.shape[1]}
    phase = "train_step" + ("_av" if audio else "") + ("_fp8" if fp8 else "")
    print(json.dumps({"phase": phase, "layers": layers, "tokens": batch.x0.shape[1],
                      "text_tokens": batch.context.shape[1], **extra, "lora_rank": 16,
                      "tflops_per_s_wall": flops / rec["wall_ms"] / 1e9, "card": card, **rec}), flush=True)


def denoise_step(dit, height: int, width: int, phase: str, device: torch.device, card: str):
    """One traced step of the distilled loop at height x width x 121f,
    printed; returns (the latent tools, the step's record)."""
    tools = make_latent_tools(dit.cfg, height, width, 121)
    state, context = make_request(dit.cfg, tools, 0, device)
    loop, sigmas = make_distilled_loop(dit.cfg), distilled_sigmas(1)
    step = _traced(lambda: loop(dit, state, sigmas, context), device)
    rec = {"phase": phase, "layers": dit.cfg.num_layers, "tokens": tools.target_shape.tokens,
           "weight_gb": weight_bytes(dit) / 1e9, "card": card, **step}
    print(json.dumps(rec), flush=True)
    return tools, rec


def av_denoise_step(dit, height: int, width: int, phase: str, device: torch.device, card: str,
                    multimodal: bool = False):
    """One traced step of the distilled joint loop of an audio-video DiT at
    height x width x 121f (the audio latent of 121 frames at 24 fps), or
    with `multimodal` of the two-stage CFG pipeline's stage-1 loop (three
    rows: cond, uncond, modality-isolated), printed; returns (the audio
    latent it made, the step's record)."""
    tools = make_latent_tools(dit.cfg, height, width, 121)
    state, context = make_request(dit.cfg, tools, 0, device)
    gen = torch.Generator(device=device).manual_seed(1)
    audio_tools = AudioFields().audio_tools(VideoPixelShape(1, 121, height, width, 24.0))
    audio_state = audio_tools.create_initial_state(dtype=dit.cfg.dtype, device=device)
    audio_state = audio_state.replace(latent=torch.randn(audio_state.latent.shape, generator=gen, device=device)
                                      .to(dit.cfg.dtype))
    audio_context = dummy_context(dit.cfg, gen, device, audio=True)
    if multimodal:
        mm = MultiModalLoopConfig(rescale_scale=0.7, uniform_timesteps=True)
        loop, rows = make_multimodal_av_denoise_loop(dit.cfg, mm), mm.rows
        negative, audio_negative = dummy_context(dit.cfg, gen, device), dummy_context(dit.cfg, gen, device, audio=True)
        sigmas = torch.from_numpy(LTX2Scheduler().execute(steps=8))[:2]
    else:
        loop, rows = make_av_denoise_loop(dit.cfg, DenoiseLoopConfig(uniform_timesteps=True)), 1
        negative, audio_negative = context, audio_context
        sigmas = distilled_sigmas(1)
    out = {}

    def run():
        out["audio"] = loop(dit, state, audio_state, sigmas, context, negative, audio_context, audio_negative)[1]

    step = _traced(run, device)
    rec = {"phase": phase, "layers": dit.cfg.num_layers, "rows": rows, "tokens": tools.target_shape.tokens,
           "audio_tokens": audio_tools.target_shape.frames, "weight_gb": weight_bytes(dit) / 1e9, "card": card,
           **step}
    print(json.dumps(rec), flush=True)
    return audio_tools.unpatchify(out["audio"]).latent, rec


def audio_decode(audio_latent: torch.Tensor, device: torch.device, card: str) -> dict:
    """One traced audio decode (the published audio decoder and vocoder,
    fp32, random weights) of `audio_latent`, printed and returned."""
    decoder, vocoder = make_audio_decoder(device), make_vocoder(device)
    rec = {"phase": "audio_decode", "latent_shape": list(audio_latent.shape), "card": card,
           **_traced(lambda: decode_audio(audio_latent, decoder, vocoder), device)}
    print(json.dumps(rec), flush=True)
    return rec


def _audio(layers: int, device: torch.device, card: str) -> None:
    dit = make_dit(layers, device, fp8=True)
    denoise_step(dit, 512, 768, "denoise_step", device, card)
    del dit
    torch.cuda.empty_cache()
    dit = make_dit(layers, device, base=av_config(), fp8=True)
    audio_latent, _ = av_denoise_step(dit, 512, 768, "av_denoise_step", device, card)
    del dit
    torch.cuda.empty_cache()
    audio_decode(audio_latent, device, card)


def one_stage_step(dit, image: bool, phase: str, device: torch.device, card: str) -> dict:
    """One traced step of the one-stage CFG* loop (scale 3.0, two guidance
    rows) at 480x704x97, the first of 30 LTX2Scheduler sigmas; with `image`
    the first latent frame is conditioned at strength 0.95 (per-token
    timesteps), else the timesteps are uniform. Printed and returned."""
    tools = make_latent_tools(dit.cfg, 480, 704, 97)
    state, positive = make_request(dit.cfg, tools, 0, device)
    gen = torch.Generator(device=device).manual_seed(1)
    negative = dummy_context(dit.cfg, gen, device)
    if image:
        shape = tools.target_shape
        frame = torch.randn(1, shape.channels, 1, shape.height, shape.width, generator=gen, device=device)
        state = VideoConditionByLatentIndex(frame, 0.95, 0).apply_to(state, tools)
    loop = make_video_denoise_loop(dit.cfg, DenoiseLoopConfig(guider=CFGStarRescalingGuider(3.0),
                                                              uniform_timesteps=not image))
    sigmas = torch.from_numpy(LTX2Scheduler().execute(30)[:2])
    rec = {"phase": phase, "layers": dit.cfg.num_layers, "tokens": tools.target_shape.tokens, "rows": 2,
           "per_token_timesteps": image, "card": card,
           **_traced(lambda: loop(dit, state, sigmas, positive, negative), device)}
    print(json.dumps(rec), flush=True)
    return rec


def one_stage_options_steps(dit, device: torch.device, card: str) -> dict:
    """The one-stage option steps (see the module's docstring), printed;
    returns the records by phase."""
    tools = make_latent_tools(dit.cfg, 480, 704, 97)
    state, positive = make_request(dit.cfg, tools, 0, device)
    gen = torch.Generator(device=device).manual_seed(1)
    negative = dummy_context(dit.cfg, gen, device)
    shape = tools.target_shape
    frame = torch.randn(1, shape.channels, 1, shape.height, shape.width, generator=gen, device=device)
    tokens = shape.tokens
    padded, token_mask = pad_state_tokens(VideoConditionByLatentIndex(frame, 0.95, 0).apply_to(state, tools),
                                          bucketed_tokens(tokens, 512))
    sigmas = torch.from_numpy(LTX2Scheduler().execute(30))
    stg = make_video_denoise_loop(dit.cfg, DenoiseLoopConfig(
        guider=CFGStarRescalingGuider(3.0), stg_scale=1.0, stg_blocks=(29,), cross_attn_scale=0.5,
        cache_text_kv=True))
    recs = {"one_stage_stg_bucket_step": {
        "rows": 3, "tokens": tokens, "bucket_tokens": padded.latent.shape[1],
        **_traced(lambda: stg(dit, padded, sigmas[:2], positive, negative, token_mask=token_mask), device)}}
    reuse = make_video_denoise_loop(dit.cfg, DenoiseLoopConfig(
        guider=LtxAPGGuider(3.0, eta=0.5, norm_threshold=5.0), cfg_interval=2, uniform_timesteps=True))
    full = _traced(lambda: reuse(dit, state, sigmas[:2], positive, negative), device)
    both = _traced(lambda: reuse(dit, state, sigmas[:3], positive, negative), device)
    classes = set(full["device_ms_by_class"]) | set(both["device_ms_by_class"])
    recs["text_to_video_reuse_full_step"] = {"rows": 2, "tokens": tokens, **full}
    recs["text_to_video_reuse_two_steps"] = {"rows": [2, 1], "tokens": tokens, **both}
    recs["text_to_video_reduced_step"] = {
        "rows": 1, "tokens": tokens, "wall_ms": both["wall_ms"] - full["wall_ms"],
        "device_ms": both["device_ms"] - full["device_ms"],
        "device_ms_by_class": {c: both["device_ms_by_class"].get(c, 0.0) - full["device_ms_by_class"].get(c, 0.0)
                               for c in classes}}
    for phase, rec in recs.items():
        print(json.dumps({"phase": phase, "layers": dit.cfg.num_layers, "card": card, **rec}), flush=True)
    return recs


def _two_stage(layers: int, device: torch.device, card: str) -> None:
    dit = make_dit(layers, device, base=av_config())
    av_denoise_step(dit, 256, 384, "av_stage1_step", device, card)
    av_denoise_step(dit, 256, 384, "mm_stage1_step", device, card, multimodal=True)


def _serving(layers: int, device: torch.device, card: str) -> None:
    _text_encode(device, card)  # first: fp32 Gemma holds 47 GB, and the recipe releases it before the DiT
    torch.cuda.empty_cache()
    dit = make_dit(layers, device, fp8=True)
    denoise_step(dit, 512, 768, "denoise_step", device, card)
    del dit
    torch.cuda.empty_cache()
    dit = make_dit(layers, device)
    tools, _ = denoise_step(dit, 512, 768, "denoise_step_bf16", device, card)
    # The two-stage recipe's stage 1: the same loop at half resolution (1536 tokens).
    denoise_step(dit, 256, 384, "stage1_step", device, card)
    # The one-stage CFG* pipeline's step, with and without an image.
    one_stage_step(dit, True, "one_stage_step_image", device, card)
    one_stage_step(dit, False, "one_stage_step_uniform", device, card)
    compute_dtype, latent_dtype = dit.cfg.compute_dtype, dit.cfg.dtype
    del dit
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
    del upscaler
    torch.cuda.empty_cache()

    # Image conditioning: one fp32 video-encoder call on a 512x768 frame.
    encoder = make_encoder(device)
    pixels = torch.rand(1, 3, 1, 512, 768, generator=gen, device=device) * 2 - 1
    rec = _traced(lambda: video_encoder_apply(encoder, pixels), device)
    print(json.dumps({"phase": "encode_image", "pixels": list(pixels.shape), "card": card, **rec}), flush=True)



def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--train", action="store_true", help="trace a LoRA train step instead of the serving path")
    ap.add_argument("--one-stage-options", action="store_true",
                    help="trace the one-stage loop options' steps instead of the serving path")
    ap.add_argument("--audio", action="store_true",
                    help="trace the audio-video step beside the video-only one, and an audio decode; with --train "
                         "the audio-video LoRA step, bf16 and on the fp8 base")
    ap.add_argument("--two-stage", action="store_true",
                    help="trace the two-stage CFG pipeline's 3-row stage-1 step beside the 1-row AV step (bf16)")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    if args.train:
        if not args.audio:
            _train_step(args.layers, device, card)
            return
        for fp8 in (False, True):
            _train_step(args.layers, device, card, audio=True, fp8=fp8)
            torch.cuda.empty_cache()
        return
    if args.one_stage_options:
        with torch.no_grad():
            one_stage_options_steps(make_dit(args.layers, device), device, card)
        return
    if args.audio:
        with torch.no_grad():
            _audio(args.layers, device, card)
        return
    if args.two_stage:
        with torch.no_grad():
            _two_stage(args.layers, device, card)
        return
    with torch.no_grad():
        _serving(args.layers, device, card)


if __name__ == "__main__":
    main()
