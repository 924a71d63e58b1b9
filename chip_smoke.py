"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one CUDA
card and nvcc; it exits non-zero without them, and without the package
`ltx2_tpu_torch` beside it. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the flash-attention kernel from csrc/ with nvcc;
3. kernel check: the kernel against `flash_attention_plain` on the card in
   bf16, at the DiT's self-attention (1, 32, 6144, 128), its text
   cross-attention (6144 queries x 1024 keys) and a ragged key-masked case,
   within limits relative to the plain output that two planted faults must
   fail; with kernel, plain, bound and scaled_dot_product_attention times;
4. main path: `generate_videos` at full width and depth (48 layers, bf16,
   512x768x121f = 6144 tokens, 8 distilled steps, VAE decode in 7-frame
   chunks) for 2 requests of different seeds; checks the frames, the
   latents and that every attention call went through the kernel.

The second-to-last line of output is the kernels' JSON record, the last the
device record.
"""

from __future__ import annotations

import json
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
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FRAMES, HEIGHT, WIDTH, STEPS, LAYERS = 121, 512, 768, 8, 48
SEEDS = (1, 2)
LAUNCHES_PER_CLIP = 2 * LAYERS * STEPS  # self + text cross-attention in every block and step


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
    from ltx2_tpu_torch.ops.attention import _library, build_flash_attention

    info = build_flash_attention()
    _library()
    ptxas = [ln for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    log(f"build: {info['path'].name} in {info['seconds']:.1f} s")
    for ln in ptxas:
        log(f"  ptxas: {ln.strip()}")
    return info["seconds"]


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


def _accepted(m: dict) -> bool:
    return m["finite"] and m["max_rel_err"] <= TOL_MAX_REL and m["rms_rel_err"] <= TOL_RMS_REL


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


def phase_main_path(smi: str):
    import numpy as np
    import torch

    from ltx2_tpu_torch.generate import generate_videos
    from ltx2_tpu_torch.ops.attention import flash_attention

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    frames, stats = generate_videos(
        list(SEEDS), height=HEIGHT, width=WIDTH, frames=FRAMES, steps=STEPS,
        layers=LAYERS, device="cuda",
    )
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for s in stats:
        log(f"request seed={s['seed']}: denoise {s['denoise_s']:.3f} s, decode {s['decode_s']:.3f} s, "
            f"attention launches {s['attention_launches']} | {smi}")
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
    if launches != LAUNCHES_PER_CLIP * len(SEEDS):
        raise AssertionError(f"{launches} kernel launches in the main path")
    if np.array_equal(frames[0], frames[1]):
        raise AssertionError("the two requests produced identical clips")
    log(f"frames: {[f.shape for f in frames]} uint8, latent std {[s['latent_std'] for s in stats]}, "
        f"frame mean/std {[(float(f.mean()), float(f.std())) for f in frames]}, mean |clip 1 - clip 2| "
        f"{float(np.abs(frames[0].astype(np.int16) - frames[1]).mean())} levels")
    return launches


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
    launches = phase_main_path(smi)

    import torch

    self_rec = recs[0]
    record = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ltx2_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ltx2_tpu/ops/attention.py:188",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": self_rec["ms"],
        "plain_ms": self_rec["plain_ms"],
        "bound_ms": self_rec["bound_ms"],
        "bound_by": self_rec["bound_by"],
        "library_ms": self_rec["library_ms"],
        "cases": recs,
    }]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
