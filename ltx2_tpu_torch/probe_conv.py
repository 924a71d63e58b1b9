"""What sets the pace of the bf16 conv kernel (`conv3d_wgmma_kernel`) on one
GPU.

    python -m ltx2_tpu_torch.probe_conv [--cases S4,S3]

Builds csrc/conv3d.cu three times with nvcc for sm_90a, into
`ltx2_tpu_torch/_build/probe/`: as shipped, loads only (LTX_CONV_PROBE=1:
the producer's gather and weight loads through the ring, no products) and
products only (LTX_CONV_PROBE=2: the wgmma products on whatever the ring
holds, no loads). Times each variant
with CUDA events at chip_smoke.py's bf16 conv shapes (chip_smoke.py times
cuDNN's conv beside the kernel; the package calls no library conv) and
checks the shipped variant against `conv3d_plain`. Each variant runs in
a process of its own with a time limit, so that a kernel that never ends
cannot hold the card. Prints the card's name and power limit, then one JSON
line per variant and case. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

# name -> (x shape (B, T, H, W, Cin), Cout), reflect/replicate padding,
# kT = 3, symmetric: chip_smoke.py's bf16 cases on the serving paths.
CASES = {
    "S4": ((1, 121, 128, 192, 128), 128),
    "S3": ((1, 61, 64, 96, 256), 256),
    "conv_out_tile": ((1, 57, 128, 128, 128), 48),
    "S1_tile_res": ((1, 8, 16, 16, 1024), 1024),
    "S2_tile_up": ((1, 15, 32, 32, 512), 2048),
}
VARIANTS = {"kernel": 0, "loads_only": 1, "products_only": 2}
ITERS = 10  # timed calls a case, after one warm-up call
TIMEOUT_S = 180  # a variant's process, build excluded


def _build() -> dict:
    from ltx2_tpu_torch.ops._build import _CSRC, _NVCC_FLAGS, BUILD_DIR, cuda_tool

    out_dir = BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, probe in VARIANTS.items():
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
    """One variant at `cases`, one JSON line each."""
    import torch

    from ltx2_tpu_torch.ops.conv3d import conv3d_plain, kernel_layout

    fn = ctypes.CDLL(lib_path).ltx_conv3d_ndhwc
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in cases:
        shape, cout = CASES[case]
        b, t, h, w, cin = shape
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16()
        bound_w = (cin * 27) ** -0.5
        weight = ((torch.rand(cout, cin, 3, 3, 3, device="cuda", generator=gen) * 2 - 1) * bound_w).bfloat16()
        bias = (torch.rand(cout, device="cuda", generator=gen) * 2 - 1) * bound_w
        flops = 2.0 * b * t * h * w * cin * cout * 27
        rec = {"variant": variant, "case": case}
        wk = kernel_layout(weight, k_major=True)
        w_nk = wk.transpose(3, 4)
        out = torch.empty(b, t, h, w, cout, device="cuda", dtype=torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = fn(x.data_ptr(), w_nk.data_ptr(), bias.data_ptr(), out.data_ptr(), 0, b, t, h, w, cin, cout, 3,
                     0, 0, 0, stream)
            if err:
                raise RuntimeError(f"{variant} {case}: launch failed with CUDA error {err}")

        ms = _time_ms(call, iters)
        if variant == "kernel":
            ref = conv3d_plain(x, wk, bias).float()
            rec["rms_rel_err"] = ((out.float() - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()
            del ref
        rec.update({"ms": ms, "tflops": flops / ms / 1e9})
        print(json.dumps(rec), flush=True)
        del x
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
