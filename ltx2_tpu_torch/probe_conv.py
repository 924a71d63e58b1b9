"""What sets the pace of the conv kernels on one GPU, and what the fp32
kernel's two-level accumulation buys.

    python -m ltx2_tpu_torch.probe_conv [--cases S4,S3,upscaler]

Builds csrc/conv3d.cu four times with nvcc for sm_90a, into
`ltx2_tpu_torch/_build/probe/`: as shipped; for the bf16 kernel
(`conv3d_wgmma_kernel`) loads only (LTX_CONV_PROBE=1: the producer's
gather and weight loads through the ring, no products) and products only
(LTX_CONV_PROBE=2: the wgmma products on whatever the ring holds, no
loads); for the fp32 kernel (`conv3d_tf32x3_kernel`) one accumulation
chain a piece (LTX_CONV_PROBE=3: the wgmma accumulator carries all of a
piece's K, no fp32 sum between chains, the waits between them kept: its
accuracy, not the cost of the waits). Times each variant with CUDA
events at chip_smoke.py's conv shapes (chip_smoke.py times cuDNN's conv
beside the kernel; the package calls no library conv), checks the shipped
bf16 variant against `conv3d_plain`, and holds both fp32 variants against
`conv3d_plain` in float64 (rms and max error relative to it). Each variant
runs in a process of its own with a time limit, so that a kernel that
never ends cannot hold the card. Prints the card's name and power limit,
then one JSON line per variant and case. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

# name -> (x shape (B, T, H, W, Cin), Cout, kT, dtype): chip_smoke.py's
# conv cases on the serving paths, symmetric; bf16 with reflect/replicate
# padding (the decoder), fp32 with zeros (the spatial upscaler).
CASES = {
    "S4": ((1, 121, 128, 192, 128), 128, 3, "bfloat16"),
    "S3": ((1, 61, 64, 96, 256), 256, 3, "bfloat16"),
    "conv_out_tile": ((1, 57, 128, 128, 128), 48, 3, "bfloat16"),
    "S1_tile_res": ((1, 8, 16, 16, 1024), 1024, 3, "bfloat16"),
    "S2_tile_up": ((1, 15, 32, 32, 512), 2048, 3, "bfloat16"),
    "upscaler_in": ((1, 16, 8, 12, 128), 1024, 3, "float32"),
    "upscaler_lowres": ((1, 16, 8, 12, 1024), 1024, 3, "float32"),
    "resampler": ((1, 16, 8, 12, 1024), 4096, 1, "float32"),
    "upscaler": ((1, 16, 16, 24, 1024), 1024, 3, "float32"),
    "upscaler_out": ((1, 16, 16, 24, 1024), 128, 3, "float32"),
}
# variant -> (LTX_CONV_PROBE, the dtypes whose kernel it changes)
VARIANTS = {"kernel": (0, ("bfloat16", "float32")), "loads_only": (1, ("bfloat16",)),
            "products_only": (2, ("bfloat16",)), "single_chain": (3, ("float32",))}
ITERS = 10  # timed calls a case, after one warm-up call
TIMEOUT_S = 180  # a variant's process, build excluded


def _build() -> dict:
    from ltx2_tpu_torch.ops._build import _CSRC, _NVCC_FLAGS, BUILD_DIR, cuda_tool

    out_dir = BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (probe, _) in VARIANTS.items():
        lib = out_dir / f"libconv3d_{name}.so"
        procs[name] = (subprocess.Popen([cuda_tool("nvcc"), *_NVCC_FLAGS, f"-DLTX_CONV_PROBE={probe}", "-o", str(lib),
                                         str(_CSRC / "conv3d.cu")],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building the {name} variant:\n{log}")
        libs[name] = lib
    return libs


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


def _run(variant: str, lib_path: str, cases, iters: int) -> None:
    """One variant at those of `cases` whose dtype it changes, one JSON line each."""
    import torch

    from ltx2_tpu_torch.ops.conv3d import conv3d_plain, kernel_layout, tf32x3_plan, tf32x3_split

    fn = ctypes.CDLL(lib_path).ltx_conv3d_ndhwc
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case in cases:
        shape, cout, kt, dtype_name = CASES[case]
        if dtype_name not in VARIANTS[variant][1]:
            continue
        fp32 = dtype_name == "float32"
        dtype = getattr(torch, dtype_name)
        b, t, h, w, cin = shape
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        bound_w = (cin * kt * 9) ** -0.5
        weight = ((torch.rand(cout, cin, kt, 3, 3, device="cuda", generator=gen) * 2 - 1) * bound_w).to(dtype)
        bias = (torch.rand(cout, device="cuda", generator=gen) * 2 - 1) * bound_w
        flops = 2.0 * b * t * h * w * cin * cout * kt * 9
        rec = {"variant": variant, "case": case, "dtype": dtype_name}
        wk = kernel_layout(weight, k_major=not fp32)
        w_kernel = tf32x3_split(wk) if fp32 else wk.transpose(3, 4)
        splits = tf32x3_plan(b * t * h * w, cout, cin, kt, sms)[0] if fp32 else 1
        ws = torch.empty(splits, b * t * h * w, cout, device="cuda") if splits > 1 else None
        out = torch.empty(b, t, h, w, cout, device="cuda", dtype=dtype)
        stream = torch.cuda.current_stream().cuda_stream
        modes = (0, 1, 1) if fp32 else (0, 0, 0)  # causal, zeros in space, zeros in time

        def call():
            err = fn(x.data_ptr(), w_kernel.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     None if ws is None else ws.data_ptr(), int(fp32), splits, b, t, h, w, cin, cout, kt, *modes,
                     stream)
            if err:
                raise RuntimeError(f"{variant} {case}: launch failed with CUDA error {err}")

        ms = _time_ms(call, iters)
        if fp32:  # against float64: what the accumulation order costs
            ref = conv3d_plain(x.double(), wk.double(), bias.double(), False, "zeros", "zeros")
            err = out.double() - ref
            rec["rms_rel_err_f64"] = (err.square().mean().sqrt() / ref.square().mean().sqrt()).item()
            rec["max_rel_err_f64"] = (err.abs().max() / ref.abs().max()).item()
            rec["splits"] = splits
            del ref, err
        elif variant == "kernel":
            ref = conv3d_plain(x, wk, bias).float()
            rec["rms_rel_err"] = ((out.float() - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()
            del ref
        rec.update({"ms": ms, "tflops": flops / ms / 1e9})
        print(json.dumps(rec), flush=True)
        del x, w_kernel, ws
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--run", nargs=2, metavar=("VARIANT", "LIBRARY"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if args.run:
        _run(args.run[0], args.run[1], cases, ITERS)
        return

    import torch

    from ltx2_tpu_torch.core import resolve_device

    resolve_device("cuda")  # raises without a card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "device": torch.cuda.get_device_name(0)}), flush=True)
    t0 = time.perf_counter()
    libs = _build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    failed = []
    for variant, lib in libs.items():
        cmd = [sys.executable, "-m", "ltx2_tpu_torch.probe_conv", "--run", variant, str(lib), "--cases", args.cases]
        try:
            proc = subprocess.run(cmd, timeout=TIMEOUT_S, capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            failed.append(f"{variant}: no end within {TIMEOUT_S} s")
            continue
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            failed.append(f"{variant}: exit {proc.returncode}\n{proc.stderr[-2000:]}")
    if failed:
        raise SystemExit("probe_conv: " + "\n".join(failed))


if __name__ == "__main__":
    main()
