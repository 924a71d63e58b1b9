"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one CUDA
card and nvcc; it exits non-zero without them, and without the package
`ltx2_tpu_torch` beside it. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the three kernel libraries from csrc/ with nvcc (flash
   forward, flash backward, conv3d), one process per source, started
   together;
3. kernel check: the flash forward against `flash_attention_plain` on the
   card in bf16, at the DiT's self-attention (1, 32, 6144, 128), its text
   cross-attention (6144 queries x 1024 keys) and a ragged key-masked case,
   within limits relative to the plain output that two planted faults must
   fail; with kernel, plain, bound and scaled_dot_product_attention times;
4. conv kernel check: the implicit-GEMM conv against `conv3d_plain` at the
   serving paths' shapes (the decoder's stages S4 and S3 and its conv_out on
   a decode tile in bf16 with reflect/replicate padding, a causal case with
   ragged H and W, the upscaler's 1024 -> 1024 conv and its per-frame
   1024 -> 4096 resampler in fp32 with zero padding), within relative limits
   that two planted faults (a tap left out, the output x 1.03) must fail;
   with kernel, plain, bound and cuDNN (F.conv3d) times; a shape the kernel
   does not take must raise;
5. serving path: `generate_videos` at full width and depth (48 layers, bf16,
   512x768x121f = 6144 tokens, 8 distilled steps, VAE decode in 7-frame
   chunks) for 2 requests of different seeds; checks the frames, the
   latents and that every attention call went through the forward kernel
   (none through a backward kernel) and every decoder conv through the conv
   kernel;
6. two-stage path: `generate_videos_distilled` (stage 1 at 256x384, the
   fp32 spatial upscaler, stage 2 at 512x768 on the 3-sigma tail, tiled VAE
   decode) at full width and depth for 2 requests; checks the frames,
   finite latents after each stage, 1056 flash launches a clip, the conv
   launches the code implies (19 in the upscaler, 45 per decoder call and
   tile) and two distinct clips; then the same recipe at a small size
   (2-layer DiT, 128x128x17, tiled decode) through the kernels against the
   same pipeline with every flash and conv call on its plain version;
7. backward check: at the flash cases, the forward's residuals l, m
   against `flash_attention_residuals_plain`, and dq, dk, dv from the fused
   backward kernel against `flash_attention_bwd_plain` and against autograd of
   `flash_attention_plain` in fp32, within relative limits that planted
   faults (dq x 1.03, a 64-key tile left out of dk and dv) must fail; with
   the kernel's own device time, the whole backward's (Di, accumulator,
   kernel, dQ conversion), the five-product bound, the plain version's and
   SDPA's backward (and the names of the kernels SDPA ran);
8. training path: (a) `ltx2_tpu_torch.train.main` for 3 LoRA steps of the
   full-width 48-block DiT at 6144 tokens, checking finite losses, non-zero
   lora_B after step 1, a bit-identical base and the launch counts; (b) the
   step's time, TF/s and peak memory at scripts/bench_train.py's shape (1024
   text tokens); (c) adapter gradients of 2 full-width blocks through the
   kernels against the same model on plain attention.

The second-to-last line of output is the kernels' JSON record, the last the
device record.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# The kernel rounds P and O to bf16, so its error scales with the output,
# whose size falls as 1/sqrt(keys) (randn q, k, v, scale d^-0.5: RMS about
# sqrt(e / keys), 0.021 at 6144 keys). Both limits are therefore relative to
# the plain output. Each case also plants two faults that must be rejected: a
# 64-key tile dropped from the softmax and the output off by 3 %.
TOL_MAX_REL = 2e-2  # max|kernel - plain| / max|plain|
TOL_RMS_REL = 1e-2  # rms(kernel - plain) / rms(plain)
# The backward kernels round P and dS to bf16 as product operands and write
# bf16 gradients; limits relative to the fp32 reference, as above.
TOL_BWD_MAX_REL = 2e-2
TOL_BWD_RMS_REL = 1e-2
# l and m are fp32 sums and maxima that differ from the plain version only
# in summation order (measured at most 1.1e-6 relative).
TOL_RES_REL = 1e-4
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
# The conv kernel and its plain version both sum exact products in fp32 and
# round once; they differ in summation order only, which in bf16 can move an
# output by one rounding step (2^-8 relative). Limits relative to the plain
# output: (max|err| / max|plain|, rms(err) / rms(plain)). Planted faults (a
# tap left out, the output x 1.03) must fail them.
CONV_TOL = {"bfloat16": (1e-2, 5e-3), "float32": (1e-4, 1e-4)}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FRAMES, HEIGHT, WIDTH, STEPS, LAYERS = 121, 512, 768, 8, 48
SEEDS = (1, 2)
LAUNCHES_PER_CLIP = 2 * LAYERS * STEPS  # self + text cross-attention in every block and step
# The two-stage recipe: 8 distilled steps at half resolution, then 3 at full.
TWO_STAGE_LAUNCHES_PER_CLIP = 2 * LAYERS * (8 + 3)
# The two-stage recipe at a small size, kernels against plain versions on
# the card: the kernels' bf16 rounding (attention P and O, one rounding step
# per conv) carried through 11 DiT steps, the upscaler and the decoder
# (measured: latents rms 0.20-0.23 %, frames 0.46 levels on average).
TOL_SMALL_LATENT_RMS_REL = 1e-2
TOL_SMALL_MEAN_LEVELS = 2.0
TRAIN_STEPS = 3
# Adapter gradients of 2 full-width blocks, kernels against plain attention:
# both runs share every other op, so the difference is the kernels' bf16 P,
# dS and output rounding carried through two blocks.
TOL_GRAD_MAX_REL = 2e-2
TOL_GRAD_RMS_REL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from ltx2_tpu_torch.ops._build import KERNEL_FUNCTIONS, build_kernels, kernel

    t0 = time.perf_counter()
    info = build_kernels()  # one nvcc per source, started together
    wall = time.perf_counter() - t0
    if set(info) != {"fwd", "bwd", "conv3d"}:
        raise AssertionError(f"built libraries {sorted(info)}")
    for fn in KERNEL_FUNCTIONS:
        kernel(fn)
    for name, rec in info.items():
        log(f"build {name}: {rec['path'].name} in {rec['seconds']:.1f} s")
        for ln in rec["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln or "C75" in ln:
                log(f"  ptxas: {ln.strip()}")
    log(f"build: wall {wall:.1f} s")
    return wall


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int) -> dict:
    """{kernel name: (device ms per call, launches per call)} of `iters`
    calls of fn, from one torch.profiler pass after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = (dev_us / 1e3 / iters, e.count / iters)
    return out


def _mismatch(out, ref) -> dict:
    import torch

    out, ref = out.float(), ref.float()
    diff = out - ref
    ref_rms = ref.square().mean().sqrt().item()
    return {
        "max_abs_err": diff.abs().max().item(),
        "max_rel_err": diff.abs().max().item() / ref.abs().max().item(),
        "rms_rel_err": diff.square().mean().sqrt().item() / ref_rms,
        "ref_rms": ref_rms,
        "finite": bool(torch.isfinite(out).all()),
    }


def _accepted(m: dict, max_rel: float = TOL_MAX_REL, rms_rel: float = TOL_RMS_REL) -> bool:
    return m["finite"] and m["max_rel_err"] <= max_rel and m["rms_rel_err"] <= rms_rel


def _check_case(name, b, h, t_q, t_k, d, n_valid, gen):
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    dev = torch.device("cuda")
    # Token-major (B, T, H*D) storage viewed as (B, H, T, D): the layout the
    # DiT hands the kernel.
    q = torch.randn(b, t_q, h * d, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, t_k, h * d, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, t_k, h * d, device=dev, generator=gen).to(torch.bfloat16)
    qh, kh, vh = (x.view(b, -1, h, d).transpose(1, 2) for x in (q, k, v))
    kv_valid = None
    if n_valid is not None:
        kv_valid = torch.zeros(b, t_k, dtype=torch.bool, device=dev)
        kv_valid[:, :n_valid] = True
        kv_valid[1:, n_valid // 2:] = True  # the second row keeps more keys
    scale = d ** -0.5

    out = flash_attention(qh, kh, vh, scale, kv_valid)
    ref = flash_attention_plain(qh, kh, vh, scale, kv_valid)
    m = _mismatch(out, ref)

    # Planted faults, checked against the same limits.
    dropped = torch.ones(b, t_k, dtype=torch.bool, device=dev) if kv_valid is None else kv_valid.clone()
    dropped[:, 64:128] = False
    planted = {
        "tile_dropped": _mismatch(flash_attention_plain(qh, kh, vh, scale, dropped), ref),
        "scaled_1.03": _mismatch(ref.float() * 1.03, ref),
    }
    torch.cuda.synchronize()

    ms = _time_ms(lambda: flash_attention(qh, kh, vh, scale, kv_valid), 20)
    plain_ms = _time_ms(lambda: flash_attention_plain(qh, kh, vh, scale, kv_valid), 3)
    qc, kc, vc = (x.contiguous() for x in (qh, kh, vh))
    lib_mask = None if kv_valid is None else kv_valid[:, None, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=lib_mask, scale=scale), 20
    )
    keys = t_k * b if kv_valid is None else int(kv_valid.sum().item())
    flops = 4.0 * h * t_q * d * keys
    nbytes = 2.0 * (2 * b * h * t_q * d + 2 * b * h * t_k * d) + (0 if kv_valid is None else b * t_k)
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    rec = {
        "case": name, "shape": [b, h, t_q, t_k, d], **{k: m[k] for k in m if k != "finite"},
        "tol_max_rel": TOL_MAX_REL, "tol_rms_rel": TOL_RMS_REL,
        "planted_rms_rel": {k: p["rms_rel_err"] for k, p in planted.items()},
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "tflops": flops / ms / 1e9,
    }
    log(f"kernel check {name}: {json.dumps(rec)}")
    if not _accepted(m):
        raise AssertionError(f"flash_attention {name}: {m} outside max_rel {TOL_MAX_REL}, rms_rel {TOL_RMS_REL}")
    for fault, p in planted.items():
        if _accepted(p):
            raise AssertionError(f"flash_attention {name}: the check accepts a planted fault {fault}: {p}")
    return rec


def phase_kernels():
    import torch

    from ltx2_tpu_torch.ops.attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    before = flash_attention.launches
    recs = [
        _check_case("self", 1, 32, 6144, 6144, 128, None, gen),
        _check_case("cross", 1, 32, 6144, 1024, 128, None, gen),
        _check_case("masked_ragged", 2, 32, 1000, 333, 128, 200, gen),
    ]
    flash_attention.launches = before  # comparison launches are not the main path's
    return recs


# Conv cases: (name, x shape (B, T, H, W, Cin), Cout, kT, dtype, causal,
# spatial mode, temporal mode), at the shapes the two serving paths give
# the kernel.
CONV_CASES = (
    ("S4", (1, 121, 128, 192, 128), 128, 3, "bfloat16", False, "reflect", "replicate"),
    ("S3", (1, 61, 64, 96, 256), 256, 3, "bfloat16", False, "reflect", "replicate"),
    ("conv_out_tile", (1, 57, 128, 128, 128), 48, 3, "bfloat16", False, "reflect", "replicate"),
    ("causal_ragged", (2, 7, 30, 44, 128), 128, 3, "bfloat16", True, "reflect", "replicate"),
    ("upscaler", (1, 16, 16, 24, 1024), 1024, 3, "float32", False, "zeros", "zeros"),
    ("resampler", (1, 16, 8, 12, 1024), 4096, 1, "float32", False, "zeros", "zeros"),
)


def _conv_case(name, shape, cout, kt, dtype_name, causal, spatial_mode, temporal_mode, gen):
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel, conv3d_plain, kernel_layout

    dev, dtype = torch.device("cuda"), getattr(torch, dtype_name)
    b, t, h, w, cin = shape
    bound_w = (cin * kt * 9) ** -0.5  # the models' init: U(+-1/sqrt(fan_in))
    x = torch.randn(shape, device=dev, generator=gen).to(dtype)
    weight = ((torch.rand(cout, cin, kt, 3, 3, device=dev, generator=gen) * 2 - 1) * bound_w).to(dtype)
    bias = (torch.rand(cout, device=dev, generator=gen) * 2 - 1) * bound_w
    wk = kernel_layout(weight)
    args = (causal, spatial_mode, temporal_mode)

    out = conv3d_ndhwc_kernel(x, wk, bias, *args)
    ref = conv3d_plain(x, wk, bias, *args)
    m = _mismatch(out, ref)
    del out
    # Planted faults, held to the same limits: one tap left out, and the
    # output off by 3 %.
    dropped = wk.clone()
    dropped[kt // 2, 1, 1] = 0
    planted = {"tap_dropped": _mismatch(conv3d_plain(x, dropped, bias, *args), ref),
               "scaled_1.03": _mismatch(ref.float() * 1.03, ref)}
    del dropped, ref
    torch.cuda.synchronize()

    ms = _time_ms(lambda: conv3d_ndhwc_kernel(x, wk, bias, *args), 10)
    plain_ms = _time_ms(lambda: conv3d_plain(x, wk, bias, *args), 2)
    # Library yardstick, never called by the port: cuDNN's conv3d in the same
    # dtype (TF32 off), on the NCDHW view of the channels-last input. Zero
    # padding is its own; reflect/replicate padding is applied beforehand and
    # not timed.
    if spatial_mode == "zeros" and temporal_mode == "zeros":
        lib_in, lib_pad = x.permute(0, 4, 1, 2, 3), ((kt - 1) // 2, 1, 1)
    else:
        from ltx2_tpu_torch.ops.conv3d import _pad

        lib_in, lib_pad = _pad(x, kt, causal, spatial_mode, temporal_mode).permute(0, 4, 1, 2, 3), 0
    lib_b = bias.to(dtype)
    library_ms = _time_ms(lambda: F.conv3d(lib_in, weight, lib_b, padding=lib_pad), 10)
    del lib_in

    flops = 2.0 * b * t * h * w * cin * cout * kt * 9
    nbytes = x.element_size() * (x.numel() + wk.numel() + b * t * h * w * cout) + 4 * cout
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    bound_ms = max(flops / peak, nbytes / PEAK_BYTES_PER_S) * 1e3
    tol = CONV_TOL[dtype_name]
    rec = {
        "case": name, "shape": list(shape), "cout": cout, "kt": kt, "dtype": dtype_name, "causal": causal,
        "spatial_mode": spatial_mode, "temporal_mode": temporal_mode,
        **{k: m[k] for k in m if k != "finite"}, "tol_max_rel": tol[0], "tol_rms_rel": tol[1],
        "planted_rms_rel": {k: p["rms_rel_err"] for k, p in planted.items()},
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / peak >= nbytes / PEAK_BYTES_PER_S else "bytes",
        "tflops": flops / ms / 1e9,
    }
    log(f"conv kernel check {name}: {json.dumps(rec)}")
    if not _accepted(m, *tol):
        raise AssertionError(f"conv3d {name}: {m} outside max_rel {tol[0]}, rms_rel {tol[1]}")
    for fault, p in planted.items():
        if _accepted(p, *tol):
            raise AssertionError(f"conv3d {name}: the check accepts a planted fault {fault}: {p}")
    del x, weight, wk
    torch.cuda.empty_cache()
    return rec


def phase_conv_kernels():
    import torch

    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel

    gen = torch.Generator(device="cuda").manual_seed(2)
    before = conv3d_ndhwc_kernel.launches
    recs = [_conv_case(*case, gen) for case in CONV_CASES]
    # A shape the kernel does not take raises on the card; nothing falls back.
    from ltx2_tpu_torch.ops.conv3d import conv3d

    x = torch.zeros(1, 2, 4, 4, 24, device="cuda", dtype=torch.bfloat16)
    try:
        conv3d(x, torch.zeros(3, 3, 3, 24, 8, device="cuda", dtype=torch.bfloat16))
    except ValueError:
        pass
    else:
        raise AssertionError("conv3d accepted Cin = 24 on the card")
    conv3d_ndhwc_kernel.launches = before  # comparison launches are not the main path's
    return recs


def _bwd_inputs(b, h, t_q, t_k, d, n_valid, gen):
    import torch

    dev = torch.device("cuda")
    # Token-major (B, T, H*D) storage viewed as (B, H, T, D), as the DiT
    # hands the kernels its activations and gets gradients back.
    q, k, v, do = (torch.randn(b, t, h * d, device=dev, generator=gen).to(torch.bfloat16).view(b, t, h, d)
                   .transpose(1, 2) for t in (t_q, t_k, t_k, t_q))
    kv_valid = None
    if n_valid is not None:
        kv_valid = torch.zeros(b, t_k, dtype=torch.bool, device=dev)
        kv_valid[:, :n_valid] = True
        kv_valid[1:, n_valid // 2:] = True
    return q, k, v, do, kv_valid


def _bwd_case(name, b, h, t_q, t_k, d, n_valid, gen):
    import torch
    import torch.nn.functional as F

    from ltx2_tpu_torch.ops import attention as A

    q, k, v, do, kv_valid = _bwd_inputs(b, h, t_q, t_k, d, n_valid, gen)
    scale = d ** -0.5

    # Forward residuals: kernel against plain.
    o, l, m = A.flash_attention_residuals(q, k, v, scale, kv_valid)
    o_ref, l_ref, m_ref = A.flash_attention_residuals_plain(q, k, v, scale, kv_valid)
    res = {"l": _mismatch(l, l_ref), "m": _mismatch(m, m_ref)}
    del o_ref

    grads = A.flash_attention_bwd(q, k, v, o, l, m, do, scale, kv_valid)
    torch.cuda.synchronize()
    # Reference 1: the plain backward from the plain forward's residuals.
    ref1 = A.flash_attention_bwd_plain(q, k, v, *A.flash_attention_residuals_plain(q, k, v, scale, kv_valid),
                                       do, scale, kv_valid)
    checks = {f"{g}_vs_plain_bwd": _mismatch(x, r) for g, x, r in zip(("dq", "dk", "dv"), grads, ref1)}
    del ref1
    # Reference 2: autograd of the plain forward in fp32.
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    out = A.flash_attention_plain(*leaves, scale, kv_valid)
    ref2 = torch.autograd.grad(out, leaves, do.float())
    del out, leaves
    checks.update({f"{g}_vs_autograd": _mismatch(x, r) for g, x, r in zip(("dq", "dk", "dv"), grads, ref2)})

    # Planted faults, held to the same limits: dq x 1.03, and one 64-key
    # tile left out of dk and dv.
    dq, dk, dv = grads
    dk_drop, dv_drop = dk.clone(), dv.clone()
    dk_drop[:, :, 64:128] = 0
    dv_drop[:, :, 64:128] = 0
    planted = {
        "dq_scaled_1.03": _mismatch(dq.float() * 1.03, ref2[0]),
        "dk_tile_dropped": _mismatch(dk_drop, ref2[1]),
        "dv_tile_dropped": _mismatch(dv_drop, ref2[2]),
    }
    del ref2, dk_drop, dv_drop
    torch.cuda.synchronize()

    bwd_ms = _time_ms(lambda: A.flash_attention_bwd(q, k, v, o, l, m, do, scale, kv_valid), 10)
    # The fused kernel's own device time, apart from the accumulator's
    # zeroing, the dQ conversion and Di, from one profiled pass.
    by_kernel = _device_ms(lambda: A.flash_attention_bwd(q, k, v, o, l, m, do, scale, kv_valid), 5)
    kernel_ms = sum(ms for n, (ms, _) in by_kernel.items() if "flash_bwd_kernel" in n)
    plain_ms = _time_ms(lambda: A.flash_attention_bwd_plain(q, k, v, o, l, m, do, scale, kv_valid), 2)
    # Library yardstick, never called by the port: the backward alone of
    # scaled_dot_product_attention on the same (contiguous) inputs, and the
    # kernels it ran.
    qc, kc, vc = (x.contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(
        qc, kc, vc, attn_mask=None if kv_valid is None else kv_valid[:, None, None, :], scale=scale)
    doc = do.contiguous()
    lib_bwd = lambda: torch.autograd.grad(lib_out, (qc, kc, vc), doc, retain_graph=True)  # noqa: E731
    library_ms = _time_ms(lib_bwd, 10)
    library_kernels = {n[:100]: round(ms, 4) for n, (ms, _) in sorted(_device_ms(lib_bwd, 3).items(),
                                                                        key=lambda kv: -kv[1][0])[:4]}
    del lib_out, qc, kc, vc

    keys = t_k * b if kv_valid is None else int(kv_valid.sum().item())
    unit = 2.0 * h * t_q * d * keys  # FLOP of one (T_q x keys x D) product over the batch
    elems_q, elems_k = b * h * t_q * d, b * h * t_k * d
    stats_bytes = 3 * 4 * b * h * t_q + (0 if kv_valid is None else b * t_k)
    # The whole backward: five products (S, dP, dV, dK, dQ); reads q, k, v,
    # o, dO, l, m and writes dq, dk, dv (Di is made inside).
    flops = 5 * unit
    nbytes = 2.0 * (3 * elems_q + 2 * elems_k) + 2.0 * (elems_q + 2 * elems_k) + stats_bytes - 4 * b * h * t_q
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    rec = {
        "case": name, "shape": [b, h, t_q, t_k, d], "valid_keys": keys,
        "residuals": {k_: {x: r[x] for x in ("max_rel_err", "rms_rel_err", "max_abs_err")} for k_, r in res.items()},
        "grads": {k_: {x: r[x] for x in ("max_rel_err", "rms_rel_err", "max_abs_err")} for k_, r in checks.items()},
        "tol_max_rel": TOL_BWD_MAX_REL, "tol_rms_rel": TOL_BWD_RMS_REL, "tol_residuals_rel": TOL_RES_REL,
        "planted_rms_rel": {k_: p["rms_rel_err"] for k_, p in planted.items()},
        "bwd_ms": bwd_ms, "kernel_ms": kernel_ms,
        "device_ms_by_kernel": {n[:80]: v_[0] for n, v_ in by_kernel.items()},
        "plain_ms": plain_ms, "library_ms": library_ms, "library_kernels": library_kernels,
        "bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bwd_tflops": flops / bwd_ms / 1e9, "kernel_tflops": flops / kernel_ms / 1e9 if kernel_ms else None,
        "max_abs_err_grads": max(checks[f"{g}_vs_autograd"]["max_abs_err"] for g in ("dq", "dk", "dv")),
        "max_abs_err_fwd_residuals": max(r["max_abs_err"] for r in res.values()),
    }
    log(f"backward check {name}: {json.dumps(rec)}")
    for what, r in res.items():
        if not _accepted(r, TOL_RES_REL, TOL_RES_REL):
            raise AssertionError(f"flash residual {name} {what}: {r} outside {TOL_RES_REL} relative")
    for what, r in checks.items():
        if not _accepted(r, TOL_BWD_MAX_REL, TOL_BWD_RMS_REL):
            raise AssertionError(f"flash backward {name} {what}: {r} outside max_rel {TOL_BWD_MAX_REL}, "
                                 f"rms_rel {TOL_BWD_RMS_REL}")
    for fault, p in planted.items():
        if _accepted(p, TOL_BWD_MAX_REL, TOL_BWD_RMS_REL):
            raise AssertionError(f"flash backward {name}: the check accepts a planted fault {fault}: {p}")
    return rec


def phase_bwd_kernels():
    import torch

    from ltx2_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(1)
    counters = (A.flash_attention, A.flash_attention_bwd_kernel)
    before = [c.launches for c in counters]
    recs = []
    for case in (("self", 1, 32, 6144, 6144, 128, None), ("cross", 1, 32, 6144, 1024, 128, None),
                 ("masked_ragged", 2, 32, 1000, 333, 128, 200)):
        recs.append(_bwd_case(*case, gen))
        torch.cuda.empty_cache()
    for c, n in zip(counters, before):  # comparison launches are not the main path's
        c.launches = n
    return recs


def phase_main_path(smi: str):
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import TEMPORAL_CHUNK, generate_videos
    from ltx2_tpu_torch.models.video_vae.chunking import temporal_chunks
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.ops.attention import flash_attention

    # Every decoder call runs 45 convs; the decode runs one call per chunk.
    convs_per_clip = conv_launches(VideoDecoderConfig()) * len(temporal_chunks((FRAMES - 1) // 8 + 1, TEMPORAL_CHUNK))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    frames, stats = generate_videos(
        list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES, steps=STEPS,
        layers=LAYERS, device="cuda",
    )
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for s in stats:
        log(f"request seed={s['seed']}: denoise {s['denoise_s']:.3f} s, decode {s['decode_s']:.3f} s, "
            f"attention launches {s['attention_launches']}, conv launches {s['conv_launches']} | {smi}")
    log(f"main path: {len(SEEDS)} requests {WIDTH}x{HEIGHT}x{FRAMES}f, {LAYERS} layers, {STEPS} steps, "
        f"wall {wall:.1f} s (weight init {stats[0]['dit_init_s']:.1f} s + decoder init "
        f"{stats[0]['decoder_init_s']:.1f} s included), peak memory {peak_gb:.1f} GB | {smi}")

    for f in frames:
        if f.shape != (FRAMES, HEIGHT, WIDTH, 3) or f.dtype != np.uint8:
            raise AssertionError(f"frames {f.shape} {f.dtype}")
    for s in stats:
        if not s["latent_finite"]:
            raise AssertionError(f"seed {s['seed']}: non-finite latent")
        if s["attention_launches"] != LAUNCHES_PER_CLIP:
            raise AssertionError(f"seed {s['seed']}: {s['attention_launches']} attention launches, "
                                 f"expected {LAUNCHES_PER_CLIP}")
        if s["conv_launches"] != convs_per_clip:
            raise AssertionError(f"seed {s['seed']}: {s['conv_launches']} conv launches, expected {convs_per_clip}")
    if launches != LAUNCHES_PER_CLIP * len(SEEDS):
        raise AssertionError(f"{launches} kernel launches in the main path")
    if counts["conv"] != convs_per_clip * len(SEEDS) or counts["bwd"]:
        raise AssertionError(f"launches in the main path {counts}")
    if np.array_equal(frames[0], frames[1]):
        raise AssertionError("the two requests produced identical clips")
    log(f"frames: {[f.shape for f in frames]} uint8, latent std {[s['latent_std'] for s in stats]}, "
        f"frame mean/std {[(float(f.mean()), float(f.std())) for f in frames]}, mean |clip 1 - clip 2| "
        f"{float(np.abs(frames[0].astype(np.int16) - frames[1]).mean())} levels")
    return counts


def phase_two_stage(smi: str):
    """The two-stage distilled recipe through `generate_videos_distilled` at
    full width and depth for 2 requests of different seeds: frames, finite
    latents after each stage, the launches the code implies, distinct clips."""
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import generate_videos_distilled
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig, conv_launches
    from ltx2_tpu_torch.models.video_vae.tiling import TilingConfig, generate_tile_specs

    latent_shape = (1, 128, (FRAMES - 1) // 8 + 1, HEIGHT // 32, WIDTH // 32)
    tiles = len(generate_tile_specs(latent_shape, TilingConfig.default()))  # 6144 voxels > 4000: tiled
    expected = {"upscale": upscaler_convs(SpatialUpscalerConfig()),
                "decode": conv_launches(VideoDecoderConfig()) * tiles}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    frames, stats = generate_videos_distilled(list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES,
                                              layers=LAYERS, device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for s in stats:
        log(f"two-stage request seed={s['seed']}: stage 1 {s['stage1_s']:.3f} s, upscale {s['upscale_s']:.3f} s, "
            f"stage 2 {s['stage2_s']:.3f} s, decode {s['decode_s']:.3f} s ({s['decode_tiles']} tiles), "
            f"attention launches {s['attention_launches']}, conv launches {s['upscale_conv_launches']} upscale + "
            f"{s['decode_conv_launches']} decode | {smi}")
    log(f"two-stage path: {len(SEEDS)} requests {WIDTH}x{HEIGHT}x{FRAMES}f (stage 1 {WIDTH // 2}x{HEIGHT // 2}), "
        f"{LAYERS} layers, wall {wall:.1f} s (init DiT {stats[0]['dit_init_s']:.1f} s, upscaler "
        f"{stats[0]['upscaler_init_s']:.1f} s, decoder {stats[0]['decoder_init_s']:.1f} s), peak memory "
        f"{peak_gb:.1f} GB, launches {counts} | {smi}")

    for f in frames:
        if f.shape != (FRAMES, HEIGHT, WIDTH, 3) or f.dtype != np.uint8:
            raise AssertionError(f"two-stage frames {f.shape} {f.dtype}")
    for s in stats:
        if not (s["stage1_latent_finite"] and s["stage2_latent_finite"]):
            raise AssertionError(f"seed {s['seed']}: non-finite latent {s}")
        got = {"attention": s["attention_launches"], "upscale": s["upscale_conv_launches"],
               "decode": s["decode_conv_launches"], "tiles": s["decode_tiles"]}
        want = {"attention": TWO_STAGE_LAUNCHES_PER_CLIP, **expected, "tiles": tiles}
        if got != want:
            raise AssertionError(f"seed {s['seed']}: launches {got}, expected {want}")
    per_clip = {"fwd": TWO_STAGE_LAUNCHES_PER_CLIP, "bwd": 0, "conv": expected["upscale"] + expected["decode"]}
    if counts != {k: v * len(SEEDS) for k, v in per_clip.items()}:
        raise AssertionError(f"two-stage launches {counts}, expected {per_clip} a clip")
    if np.array_equal(frames[0], frames[1]):
        raise AssertionError("the two two-stage requests produced identical clips")
    log(f"two-stage frames: {[f.shape for f in frames]} uint8, latent std {[s['latent_std'] for s in stats]}, "
        f"frame mean/std {[(float(f.mean()), float(f.std())) for f in frames]}, mean |clip 1 - clip 2| "
        f"{float(np.abs(frames[0].astype(np.int16) - frames[1]).mean())} levels")
    return counts, stats, peak_gb


def phase_two_stage_small(smi: str) -> dict:
    """The two-stage recipe end to end (decode included, tiled into 2 x 3 x 3
    tiles) at a small size, through the kernels, against the same pipeline
    on the same card with every flash and conv call on its plain version
    (whose agreement with the JAX package the CPU tests show): a 2-layer DiT
    of 2 x 128-wide heads, a mid-16 upscaler, a base-16 bf16 decoder,
    128x128x17. A run from another seed must fail the same limits."""
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig
    from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig, init_spatial_upscaler_
    from ltx2_tpu_torch.models.upscaler.spatial import conv_launches as upscaler_convs
    from ltx2_tpu_torch.models.video_vae import conv as vae_conv
    from ltx2_tpu_torch.models.video_vae.decoder import (
        VideoDecoder, VideoDecoderConfig, conv_launches, init_video_decoder_,
    )
    from ltx2_tpu_torch.models.video_vae.tiling import (
        SpatialTilingConfig, TemporalTilingConfig, TilingConfig, generate_tile_specs,
    )
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.ops.conv3d import conv3d_plain
    from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    dit = make_dit(2, dev, seed=22, base=LTXModelConfig(num_attention_heads=2, in_channels=16, out_channels=16,
                                                         cross_attention_dim=256))
    up_cfg = SpatialUpscalerConfig(16, 16, 1, 4)
    dec_cfg = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="bfloat16")
    up = init_spatial_upscaler_(SpatialUpscaler(up_cfg, device=dev), gen)
    dec = init_video_decoder_(VideoDecoder(dec_cfg, device=dev), gen)
    with torch.no_grad():
        dec.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.3)
        dec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
    pipe = DistilledPipeline(dit, up, video_decoder=dec)
    context = torch.randn(1, 16, 256, generator=gen, device=dev) * 0.02
    tiling = TilingConfig(SpatialTilingConfig(64, 32), TemporalTilingConfig(16, 8))

    def run(seed):
        latents = {}
        config = DistilledConfig(height=128, width=128, num_frames=17, seed=seed, dtype="bfloat16",
                                 latent_channels=16, tiling_config=tiling)
        frames = pipe(context, config, callback=lambda phase, z: latents.setdefault(phase, z.float()))
        return frames, latents

    _reset_counts()
    frames_k, lat_k = run(5)
    counts = _counts()
    kernel_flash, kernel_conv = A.flash_attention, vae_conv.conv3d
    A.flash_attention = lambda q, k, v, scale=None, kv_valid=None: A.flash_attention_plain(q, k, v, scale, kv_valid)
    vae_conv.conv3d = conv3d_plain
    try:
        frames_p, lat_p = run(5)
        frames_other, _ = run(6)
    finally:
        A.flash_attention, vae_conv.conv3d = kernel_flash, kernel_conv

    def frame_diff(a, b):
        d = np.abs(a.astype(np.int16) - b)
        return {"mean_levels": float(d.mean()), "max_levels": int(d.max())}

    rec = {"launches": counts, "frames": list(frames_k.shape),
           "latents": {k: {x: v for x, v in _mismatch(lat_k[k], lat_p[k]).items() if x != "ref_rms"} for k in lat_k},
           "frames_vs_plain": frame_diff(frames_k, frames_p),
           "planted_other_seed": frame_diff(frames_other, frames_p),
           "tol_latent_rms_rel": TOL_SMALL_LATENT_RMS_REL, "tol_mean_levels": TOL_SMALL_MEAN_LEVELS}
    log(f"two-stage small-input check (kernels vs plain on the card): {json.dumps(rec)} | {smi}")
    del pipe, dit, up, dec
    torch.cuda.empty_cache()
    # 8 + 3 steps x 2 layers x (self + cross attention); the upscaler's convs
    # and 45 a decoder call, one call a tile.
    tiles = len(generate_tile_specs((1, 16, 3, 4, 4), tiling))
    want = {"fwd": 2 * 2 * (8 + 3), "bwd": 0,
            "conv": upscaler_convs(up_cfg) + conv_launches(dec_cfg) * tiles}
    if counts != want:
        raise AssertionError(f"small two-stage launches {counts}, expected {want}")
    if frames_k.shape != (17, 128, 128, 3) or any(not r["finite"] for r in rec["latents"].values()):
        raise AssertionError(f"small two-stage output {rec}")
    if any(r["rms_rel_err"] > TOL_SMALL_LATENT_RMS_REL for r in rec["latents"].values()):
        raise AssertionError(f"small two-stage latents disagree with the plain path: {rec['latents']}")
    if rec["frames_vs_plain"]["mean_levels"] > TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"small two-stage frames disagree with the plain path: {rec['frames_vs_plain']}")
    if rec["planted_other_seed"]["mean_levels"] <= TOL_SMALL_MEAN_LEVELS:
        raise AssertionError(f"the small two-stage check accepts another seed's clip: {rec}")
    return rec


def _counters():
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel

    return {"fwd": A.flash_attention, "bwd": A.flash_attention_bwd_kernel, "conv": conv3d_ndhwc_kernel}


def _reset_counts():
    for c in _counters().values():
        c.launches = 0


def _counts() -> dict:
    return {k: c.launches for k, c in _counters().items()}


def _adapter_grads(model) -> dict:
    return {n: p.grad.detach().float().clone() for n, p in model.named_parameters() if p.requires_grad}


def phase_train_steps(smi: str):
    """(a) the entry: 3 full-width, full-depth LoRA steps through
    `ltx2_tpu_torch.train.main`; finite losses, non-zero lora_B after step 1,
    a bit-identical base, and the launch counts the code implies."""
    import torch

    from ltx2_tpu_torch import train as T

    zero_b_after_step1 = []

    def on_step(i, model, loss):
        if i == 0:
            zero_b_after_step1.extend(n for n, p in model.named_parameters()
                                      if n.endswith(".lora_B") and not bool(p.detach().abs().amax() > 0))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = T.main(["--synthetic", *map(str, T.BENCH_SHAPE), "--lora-rank", "16", "--steps", str(TRAIN_STEPS),
                  "--layers", str(LAYERS), "--device", "cuda", "--log-every", "1"], on_step=on_step)
    wall = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    model = res["model"]
    log(f"train entry: {TRAIN_STEPS} steps, {LAYERS} layers, {res['adapters']} adapters, losses {res['losses']}, "
        f"step s {res['step_s']}, wall {wall:.1f} s, peak {peak_gb:.1f} GB, launches {counts} | {smi}")

    if len(res["losses"]) != TRAIN_STEPS or not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"training losses {res['losses']}")
    if res["adapters"] != 10 * LAYERS:  # q, k, v, out of both attentions + the two FF linears
        raise AssertionError(f"{res['adapters']} adapters, expected 10 linears x {LAYERS} blocks")
    if zero_b_after_step1:
        raise AssertionError(f"lora_B still zero after step 1: {zero_b_after_step1[:4]}")
    # With adapters on to_q/to_k/to_v of both attentions every attention call
    # needs dq, dk and dv: each step runs 2 * LAYERS forward launches, the
    # remat recompute 2 * LAYERS more, and one fused backward launch per call.
    expected = {"fwd": TRAIN_STEPS * 4 * LAYERS, "bwd": TRAIN_STEPS * 2 * LAYERS, "conv": 0}
    if counts != expected:
        raise AssertionError(f"training launches {counts}, expected {expected}")
    # The base: the same random weights drawn again must be bit-identical.
    fresh = dict(T.make_model(LAYERS, torch.device("cuda"), seed=0).named_parameters())
    changed = [n for n, p in model.named_parameters() if n in fresh and not torch.equal(p, fresh[n])]
    missing = [n for n, _ in model.named_parameters() if n not in fresh and not n.endswith(("lora_A", "lora_B"))]
    del fresh
    torch.cuda.empty_cache()
    if changed or missing:
        raise AssertionError(f"base weights changed by training: {changed[:4]} {missing[:4]}")
    log(f"train entry checks: losses finite, every lora_B non-zero after step 1, base bit-identical, "
        f"launches as reckoned {expected}")
    return model, counts


def phase_train_timing(model, smi: str) -> dict:
    """(b) the step at scripts/bench_train.py's shape (6144 tokens, 1024
    text tokens, uniform sigmas): 1 warm-up + 4 timed steps."""
    import torch

    from ltx2_tpu_torch import train as T

    dev = torch.device("cuda")
    step, batch, flops = T.bench_step(model, dev)
    loss = step(batch, torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(4):
        loss = step(batch, torch.Generator(device=dev).manual_seed(4 + i))
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / 4
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = batch.x0.shape[1]
    rec = {"layers": model.cfg.num_layers, "tokens": tokens, "text_tokens": batch.context.shape[1],
           "ms_per_step": sec * 1e3, "tflops": flops / sec / 1e12,
           "pct_of_bf16_peak": 100 * flops / sec / PEAK_BF16_FLOPS, "peak_memory_gb": peak_gb,
           "loss": float(loss), "card": smi}
    log(f"train step timing: {json.dumps(rec)}")
    if not math.isfinite(rec["loss"]):
        raise AssertionError(f"train step loss {rec['loss']}")
    return rec


def phase_train_gradcheck(smi: str) -> dict:
    """(c) adapter gradients of one loss on 2 full-width blocks at 6144
    tokens (1024 text tokens), through the kernels against the same model
    with attention through autograd of `flash_attention_plain`."""
    import torch

    from ltx2_tpu_torch import train as T
    from ltx2_tpu_torch.ops import attention as A
    from ltx2_tpu_torch.training import TrainConfig, rectified_flow_loss
    from ltx2_tpu_torch.training.lora import add_lora_params_, lora_trainable_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    model = T.make_model(2, dev, seed=5)
    add_lora_params_(model, gen, rank=16, alpha=16.0)
    lora_trainable_mask(model)
    with torch.no_grad():  # random B, so that A gets a gradient too
        for n, p in model.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(generator=gen).mul_(0.02)
    arrays = T.synthetic_dataset(*T.BENCH_SHAPE, 1, model.cfg, seed=1, context_tokens=T.BENCH_CONTEXT_TOKENS)
    batch = T.make_batch(arrays, [0], dev)
    sigmas = torch.tensor([0.6], device=dev)
    noise = torch.randn(batch.x0.shape, generator=gen, device=dev)
    tc = TrainConfig()

    def grads():
        loss = rectified_flow_loss(model, batch, None, tc, sigmas, noise)
        loss.backward()
        g = _adapter_grads(model)
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    _reset_counts()
    loss_k, g_k = grads()
    counts = _counts()
    kernel = A.flash_attention
    A.flash_attention = lambda q, k, v, scale=None, kv_valid=None: A.flash_attention_plain(q, k, v, scale, kv_valid)
    try:
        loss_p, g_p = grads()
    finally:
        A.flash_attention = kernel
    flat_k = torch.cat([g_k[n].flatten() for n in sorted(g_k)])
    flat_p = torch.cat([g_p[n].flatten() for n in sorted(g_p)])
    overall = _mismatch(flat_k, flat_p)
    per_tensor = {n: _mismatch(g_k[n], g_p[n]) for n in sorted(g_k)}
    worst = max(per_tensor, key=lambda n: per_tensor[n]["rms_rel_err"])
    rec = {"loss_kernels": loss_k, "loss_plain": loss_p, "tensors": len(g_k), "launches": counts,
           "max_rel_err": overall["max_rel_err"], "rms_rel_err": overall["rms_rel_err"],
           "worst_tensor": worst, "worst_rms_rel_err": per_tensor[worst]["rms_rel_err"],
           "worst_max_rel_err": per_tensor[worst]["max_rel_err"],
           "tol_max_rel": TOL_GRAD_MAX_REL, "tol_rms_rel": TOL_GRAD_RMS_REL}
    log(f"train gradient check (2 blocks, kernels vs plain attention): {json.dumps(rec)}")
    del model
    torch.cuda.empty_cache()
    if counts != {"fwd": 8, "bwd": 4, "conv": 0}:
        raise AssertionError(f"gradient check launches {counts}")
    if not all(_accepted(per_tensor[n], TOL_GRAD_MAX_REL, TOL_GRAD_RMS_REL) for n in per_tensor):
        raise AssertionError(f"adapter gradients through the kernels disagree: {worst} {per_tensor[worst]}")
    return rec


def main():
    from pathlib import Path

    import ltx2_tpu_torch  # fails outside a checkout, before any result

    here = Path(__file__).resolve().parent
    if Path(ltx2_tpu_torch.__file__).resolve().parent.parent != here:
        log(f"chip_smoke: ltx2_tpu_torch comes from {ltx2_tpu_torch.__file__}, not this checkout {here}")
        sys.exit(2)
    smi = phase_device()
    phase_build()
    recs = phase_kernels()
    conv_recs = phase_conv_kernels()
    serve_counts = phase_main_path(smi)

    import torch

    torch.cuda.empty_cache()
    two_stage_counts, two_stage_stats, two_stage_peak_gb = phase_two_stage(smi)
    torch.cuda.empty_cache()
    two_stage_small = phase_two_stage_small(smi)
    bwd = phase_bwd_kernels()
    model, train_counts = phase_train_steps(smi)
    timing = phase_train_timing(model, smi)
    del model
    torch.cuda.empty_cache()
    gradcheck = phase_train_gradcheck(smi)

    self_rec, self_bwd = recs[0], bwd[0]
    record = {"kernels": [
        {
            "name": "flash_attention_fwd",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/flash_attention.cu",
            "replaces": "ltx2_tpu/ops/attention.py:188",
            "launches": serve_counts["fwd"] + two_stage_counts["fwd"] + train_counts["fwd"],
            "launches_by_path": {"serve": serve_counts["fwd"], "serve_two_stage": two_stage_counts["fwd"],
                                 "train": train_counts["fwd"]},
            "max_abs_err": max(max(r["max_abs_err"] for r in recs),
                               max(r["max_abs_err_fwd_residuals"] for r in bwd)),
            "ms": self_rec["ms"],
            "plain_ms": self_rec["plain_ms"],
            "bound_ms": self_rec["bound_ms"],
            "bound_by": self_rec["bound_by"],
            "library_ms": self_rec["library_ms"],
            "cases": recs,
        },
        {
            "name": "flash_attention_bwd",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 (_flash_attention_bwd_dkv, "
                        "pallas_call :1121) and :1287 (_flash_attention_bwd_dq, pallas_call :1456); reached from "
                        "ltx2_tpu/ops/attention.py:188",
            "launches": train_counts["bwd"],
            "max_abs_err": max(r["max_abs_err_grads"] for r in bwd),
            "ms": self_bwd["kernel_ms"],
            "whole_bwd_ms": self_bwd["bwd_ms"],
            "plain_ms": self_bwd["plain_ms"],
            "bound_ms": self_bwd["bound_ms"],
            "bound_by": self_bwd["bound_by"],
            "library_ms": self_bwd["library_ms"],
            "cases": bwd,
        },
        {
            "name": "conv3d_implicit_gemm",
            "route": "cuda",
            "source": "ltx2_tpu_torch/csrc/conv3d.cu",
            "replaces": "scripts/bench_conv_pallas.py:116 (conv3d_pallas, pallas_call :140); "
                        "scripts/bench_conv_pallas.py:223 (conv3d_pallas_v2, pallas_call :247); "
                        "scripts/bench_conv_pallas.py:357 (conv3d_pallas_v3, pallas_call :378)",
            "launches": serve_counts["conv"] + two_stage_counts["conv"],
            "launches_by_path": {"serve": serve_counts["conv"], "serve_two_stage": two_stage_counts["conv"]},
            "max_abs_err": max(r["max_abs_err"] for r in conv_recs),
            "ms": conv_recs[0]["ms"],
            "plain_ms": conv_recs[0]["plain_ms"],
            "bound_ms": conv_recs[0]["bound_ms"],
            "bound_by": conv_recs[0]["bound_by"],
            "library_ms": conv_recs[0]["library_ms"],
            "cases": conv_recs,
        },
    ], "train": {"timing": timing, "gradcheck": gradcheck},
        "two_stage": {"requests": two_stage_stats, "peak_memory_gb": two_stage_peak_gb,
                      "small_input_check": two_stage_small}}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
