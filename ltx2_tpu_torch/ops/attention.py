"""Scaled dot-product attention for the H100.

Counterpart of ltx2_tpu/ops/attention.py. Every attention call goes through
one hand-written CUDA kernel, `csrc/flash_attention.cu` (the port of the
Pallas TPU flash-attention forward, plain and key-masked), for a CUDA
tensor, and through its plain PyTorch version `flash_attention_plain` for a
CPU tensor. There is no fallback between the two: a CUDA tensor the kernel
cannot take raises.

The kernel is built from the repository's source with nvcc into
`ltx2_tpu_torch/_build/` on first use and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
FLASH_SOURCE = _PKG / "csrc" / "flash_attention.cu"
BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEAD_DIMS = (64, 128)

# Additive masks are binary: 0 = attend, <= -1e30 = masked (the models write
# -0.7 * finfo.max). A key-only mask is binarized into key-valid flags here,
# exactly as the JAX package binarizes it into flash segment ids.
_MASK_VALID_THRESHOLD = -1e30

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is needed to build the kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_flash_attention() -> dict:
    """Compile csrc/flash_attention.cu for sm_90a unless a library built from
    the same source exists. Returns {"path", "seconds", "log"}; raises with
    the compiler's output if nvcc fails."""
    digest = hashlib.sha256(FLASH_SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libltx_flash_attention_{digest}.so"
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(FLASH_SOURCE)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {FLASH_SOURCE.name}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout + proc.stderr}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_flash_attention()["path"]))
        fn = lib.ltx_flash_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5
            + [ctypes.c_int64] * 13
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: (B, H, T_q, D) x (B, H, T_k, D)
    -> (B, H, T_q, D) in q's dtype, with fp32 scores and fp32 softmax.

    kv_valid: optional bool/uint8 (B, T_k); invalid keys get no weight. A
    query row with no valid key returns 0."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid.bool()[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return out.to(q.dtype)


def _check_operand(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"flash_attention: {name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"flash_attention: {name} must be (B, H, T, D), got {tuple(x.shape)}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} needs a unit stride on D, (B, H, T) strides that "
            f"are multiples of 8 and a 16-byte aligned base (strides {x.stride()})"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Non-causal attention over (B, H, T, D) bf16 tensors, T_q may differ
    from T_k, with an optional key-valid mask (B, T_k).

    A CPU tensor takes `flash_attention_plain`; a CUDA tensor launches the
    kernel on the current stream or raises. Any (B, H, T) strides are taken
    (D must be unit-stride), so token-major (B, T, H*D) activations viewed as
    (B, H, T, D) go in without a copy. The output is a (B, H, T_q, D) view of
    token-major storage, so merging heads back costs nothing.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.device)
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    if k.shape != (b, h, t_k, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    if t_q == 0 or t_k == 0:
        raise ValueError("flash_attention: empty sequence")
    if h > 65535 or b > 65535:
        raise ValueError(f"flash_attention: batch or heads too large for the launch grid {tuple(q.shape)}")
    kv_ptr, kv_sb = None, 0
    if kv_valid is not None:
        if kv_valid.device != q.device or kv_valid.dtype not in (torch.bool, torch.uint8):
            raise TypeError("flash_attention: kv_valid must be bool/uint8 on q's device")
        if kv_valid.shape != (b, t_k) or kv_valid.stride(1) != 1:
            raise ValueError(f"flash_attention: kv_valid must be a unit-stride ({b}, {t_k}) tensor")
        kv_ptr, kv_sb = kv_valid.data_ptr(), kv_valid.stride(0)

    lib = _library()
    out = torch.empty((b, t_q, h, d), dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ltx_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kv_ptr,
            b, h, t_q, t_k, d,
            q.stride(0), q.stride(2), q.stride(1),
            k.stride(0), k.stride(2), k.stride(1),
            v.stride(0), v.stride(2), v.stride(1),
            out.stride(0), out.stride(2), out.stride(1),
            kv_sb, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head SDPA over (B, H, T, D) tensors with an optional additive
    key-only mask (B|1, 1, 1, S): 0 = attend, <= -1e30 = masked.

    A query-dependent mask raises NotImplementedError: the kernel takes key
    masks only, and no caller of this slice passes another kind."""
    kv_valid = None
    if mask is not None:
        if mask.ndim != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
            raise NotImplementedError(
                f"sdpa: only key-only (B, 1, 1, S) masks are supported, got {tuple(mask.shape)}"
            )
        kv_valid = (mask[:, 0, 0, :] > _MASK_VALID_THRESHOLD).expand(q.shape[0], k.shape[2])
        kv_valid = kv_valid.contiguous()
    return flash_attention(q, k, v, scale, kv_valid)


def sdpa_tokens(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    dim_head: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over token-major (B, T, H*D) tensors (the DiT layout). The
    head split and merge are views: nothing is transposed in memory."""
    b, t_q, _ = q.shape
    t_k = k.shape[1]
    qh = q.view(b, t_q, heads, dim_head).transpose(1, 2)
    kh = k.view(b, t_k, heads, dim_head).transpose(1, 2)
    vh = v.view(b, t_k, heads, dim_head).transpose(1, 2)
    if mask is not None and mask.ndim == 2:
        mask = mask[None, None, :, :]
    elif mask is not None and mask.ndim == 3:
        mask = mask[:, None, :, :]
    out = sdpa(qh, kh, vh, mask=mask)
    return out.transpose(1, 2).reshape(b, t_q, heads * dim_head)
