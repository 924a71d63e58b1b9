"""Build and load the port's hand-written CUDA kernels.

Each source in KERNEL_SOURCES is compiled with nvcc for sm_90a into its own
shared library with a plain C interface, under `ltx2_tpu_torch/_build/`,
named by the hash of its sources (a changed source builds anew), and loaded
with ctypes. `build_kernels()` starts one nvcc per missing library, all
together, and waits for them; `kernel(fn)` returns a C entry point with its
argument types set, building on first use. Nothing here runs at import
time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
KERNEL_SOURCES = {
    "fwd": _CSRC / "flash_attention.cu",
    "bwd": _CSRC / "flash_attention_bwd.cu",
    "conv3d": _CSRC / "conv3d.cu",
}
_HEADERS = (_CSRC / "flash_common.cuh", _CSRC / "sm90_common.cuh")
BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry -> (library, argument types). Every entry returns the launch's
# cudaError_t as an int (0 = launched).
KERNEL_FUNCTIONS = {
    # q, k, v, o, kv_valid, l, m; batch, heads, t_q, t_k, head_dim; 13 strides; scale, stream
    "ltx_flash_attention_fwd": ("fwd", [_P] * 7 + [_I] * 5 + [_I64] * 13 + [ctypes.c_float, _P]),
    # q, k, v, dO, dQ accumulator (fp32), dK, dV, l, m, Di, kv_valid; batch, heads,
    # t_q, t_k, head_dim; 19 strides; scale, stream
    "ltx_flash_attention_bwd": ("bwd", [_P] * 11 + [_I] * 5 + [ctypes.POINTER(_I64), ctypes.c_float, _P]),
    # x, w, bias, out, fp32 workspace; fp32 flag, K ranges, batch, t, h, w,
    # cin, cout, kt, causal, spatial zeros, temporal zeros; stream
    "ltx_conv3d_ndhwc": ("conv3d", [_P] * 5 + [_I] * 12 + [_P]),
}
_libs: Dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (nvcc, cuobjdump)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", name)


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(f.read_bytes() for f in (KERNEL_SOURCES[name], *_HEADERS))
    ).hexdigest()[:16]
    return BUILD_DIR / f"libltx_{name}_{digest}.so"


def build_kernels() -> Dict[str, dict]:
    """Compile every source in KERNEL_SOURCES for sm_90a into its own shared
    library, one nvcc per source, all started together, unless a library
    built from the same sources exists. Returns {name: {"path", "seconds",
    "log"}}; raises with the compiler's output if any nvcc fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, running = {}, {}
    for name, src in KERNEL_SOURCES.items():
        out = _library_path(name)
        if out.exists():
            info[name] = {"path": out, "seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [cuda_tool("nvcc"), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {KERNEL_SOURCES[name].name}:\n{log}")
            continue
        os.replace(tmp, out)
        info[name] = {"path": out, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return info


def kernel(fn_name: str):
    """The C entry `fn_name`, building and loading its library on first use."""
    name = KERNEL_FUNCTIONS[fn_name][0]
    if name not in _libs:
        lib = ctypes.CDLL(str(build_kernels()[name]["path"]))
        for fn, (lib_name, argtypes) in KERNEL_FUNCTIONS.items():
            if lib_name == name:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return getattr(_libs[name], fn_name)
