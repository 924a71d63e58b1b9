"""3D convolution over channels-last (B, T, H, W, C) tensors for the H100:
the hand-written implicit-GEMM kernels of `csrc/conv3d.cu` and their plain
PyTorch version.

Counterpart of the Pallas TPU kernels of scripts/bench_conv_pallas.py
(`conv3d_pallas`, `conv3d_pallas_v2`, `conv3d_pallas_v3`), which compute
one function: a kT x 3 x 3 conv with 'same' output size, fp32 accumulation
plus bias, output in x's dtype. Padding: spatial "reflect" (the VAE) or
"zeros" (the upscalers); temporal "replicate" (kT - 1 frames in front when
causal, else split around the clip) or "zeros". kT is 3, or 1 for a
per-frame 3 x 3 conv (the upscaler's resampler). Strides (sT, sH, sW), each
1 or 2, sample the padded input on a strided grid (the full video VAE's
strided causal convs, ltx2_tpu/models/video_vae/conv.py:135-170): the output
is (B, (T - 1) // sT + 1, (H - 1) // sH + 1, (W - 1) // sW + 1, Cout).

Weights are taken in the layout (kT, 3, 3, Cin, Cout) (the Pallas wrapper's
`w_flat`); `kernel_layout` reorders a checkpoint-shaped (Cout, Cin, kT, 3, 3)
or (Cout, Cin, 3, 3) weight into it, once per module (models/video_vae/conv.py
caches it). Both kernels read the weights K-major:
- bf16 (`conv3d_wgmma_kernel`) from (kT, 3, 3, Cout, Cin) storage: a weight
  whose `transpose(3, 4)` is contiguous (`kernel_layout(..., k_major=True)`,
  the form the module caches for bf16) goes in as it is, any other is copied
  into that order on each call;
- fp32 (`conv3d_tf32x3_kernel`, 3xTF32 on the tensor cores) from the
  weights' TF32 split (`tf32x3_split`: hi and lo parts, (2, kT * 9, Cout,
  Cin)), passed as `w_split` (the module caches it; the kernel then reads
  nothing else of w) or made from w on each call. Its tiles and K ranges
  come from `tf32x3_plan`; when K is split, the wrapper allocates the fp32
  partials' workspace.

`conv3d` dispatches on the input's device: a CPU tensor takes
`conv3d_plain`; a CUDA tensor launches the kernel (`conv3d_ndhwc_kernel`,
bf16 or fp32) or raises, for any shape or dtype the kernel does not take.
The kernel is built from the repository's source with nvcc on first use
(`ops/_build.py`) and counts its launches in `conv3d_ndhwc_kernel.launches`
(one a call, the split-K sum included), the strided ones also in
`conv3d_ndhwc_kernel.strided_launches`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ltx2_tpu_torch.ops._build import kernel

SPATIAL_MODES = ("reflect", "zeros")
TEMPORAL_MODES = ("replicate", "zeros")


def kernel_layout(weight: torch.Tensor, k_major: bool = False, copy: bool = True) -> torch.Tensor:
    """(Cout, Cin, kT, kH, kW) or per-frame (Cout, Cin, kH, kW) ->
    (kT, kH, kW, Cin, Cout), kT = 1 for the per-frame form: contiguous, or
    with `k_major` a view of contiguous (kT, kH, kW, Cout, Cin) storage, the
    order the bf16 kernel reads; without `copy` a view of the weight."""
    if weight.ndim == 4:
        weight = weight[:, :, None]
    if not copy:
        return weight.permute(2, 3, 4, 1, 0)
    if k_major:
        return weight.permute(2, 3, 4, 0, 1).contiguous().transpose(3, 4)
    return weight.permute(2, 3, 4, 1, 0).contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 explicit mantissa bits, ties away
    from zero) in fp32, as `cvt.rna.tf32.f32` rounds it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_split(w: torch.Tensor) -> torch.Tensor:
    """w (kT, 3, 3, Cin, Cout) -> its 3xTF32 parts, K-major, as the fp32
    kernel reads them: (2, kT * 9, Cout, Cin) contiguous fp32, [0] = hi
    (w rounded to TF32), [1] = lo = w - hi (exact; the tensor core reads its
    top 19 bits)."""
    kt, _, _, cin, cout = w.shape
    wk = w.float().reshape(kt * 9, cin, cout).transpose(1, 2).contiguous()
    hi = tf32_round(wk)
    return torch.stack([hi, wk - hi])


# The fp32 kernel's output tile (voxels, outputs), channels per K step (one
# tap), K steps per accumulation chain, and most K ranges (csrc/conv3d.cu).
TF32X3_TILE = (128, 128)
TF32X3_K_STEP = 32
TF32X3_CHAIN = 2
TF32X3_MAX_SPLITS = 8


def tf32x3_plan(m: int, cout: int, cin: int, kt: int, sms: int) -> tuple:
    """(K ranges, K steps a range) of the fp32 kernel for M = m output
    voxels on `sms` SMs. A range is a whole number of chains; the last may
    end in phantom steps. Where the 128 x 128 tiles number fewer than the
    SMs, K is split into the ranges that give the fewest K steps on the
    busiest SM (rounds of pieces x steps a piece), fewer ranges on a tie,
    each at least two chains long."""
    def cdiv(a, b):
        return -(-a // b)

    bm, bn = TF32X3_TILE
    tiles = cdiv(m, bm) * cdiv(cout, bn)
    n_iter = kt * 9 * cdiv(cin, TF32X3_K_STEP)
    best, best_cost = None, None
    for splits in range(1, TF32X3_MAX_SPLITS + 1 if tiles < sms else 2):
        steps = cdiv(cdiv(n_iter, splits), TF32X3_CHAIN) * TF32X3_CHAIN  # as the C launcher reckons it
        if splits > 1 and (cdiv(n_iter, steps) != splits or steps < 2 * TF32X3_CHAIN):
            continue
        cost = cdiv(tiles * splits, sms) * steps
        if best is None or cost < best_cost:
            best, best_cost = (splits, steps), cost
    return best


def wgmma_tile(cout: int) -> tuple:
    """(BM voxels, BN outputs) of the bf16 kernel's output tile for `cout`
    outputs, as the C entry picks it: an N tile fitted to Cout."""
    if cout <= 48:
        return 256, 48
    if cout % 256 == 0:
        return 128, 256
    return 256, 128


def _check_modes(spatial_mode: str, temporal_mode: str) -> None:
    if spatial_mode not in SPATIAL_MODES:
        raise ValueError(f"conv3d: spatial_mode {spatial_mode!r} not in {SPATIAL_MODES}")
    if temporal_mode not in TEMPORAL_MODES:
        raise ValueError(f"conv3d: temporal_mode {temporal_mode!r} not in {TEMPORAL_MODES}")


def _check_shapes(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], spatial_mode: str,
                  stride: tuple = (1, 1, 1)) -> None:
    if x.ndim != 5 or w.ndim != 5:
        raise ValueError(f"conv3d: x must be (B, T, H, W, Cin) and w (kT, 3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    kt, kh, kw, cin, cout = w.shape
    if kt not in (1, 3) or (kh, kw) != (3, 3) or cin != x.shape[-1]:
        raise ValueError(f"conv3d: weight {tuple(w.shape)} for input {tuple(x.shape)}: needs "
                         f"(kT in (1, 3), 3, 3, {x.shape[-1]}, Cout)")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"conv3d: bias {tuple(b.shape)} for {cout} outputs")
    if spatial_mode == "reflect" and min(x.shape[2], x.shape[3]) < 2:
        raise ValueError(f"conv3d: reflect padding needs H, W >= 2, got {tuple(x.shape)}")
    if len(stride) != 3 or any(s not in (1, 2) for s in stride):
        raise ValueError(f"conv3d: stride {tuple(stride)} must be three of 1 or 2")


def out_shape(x_shape: tuple, cout: int, stride: tuple = (1, 1, 1)) -> tuple:
    """The conv's output shape for input (B, T, H, W, Cin) at `stride`."""
    b, t, h, w, _ = x_shape
    st, sh, sw = stride
    return b, (t - 1) // st + 1, (h - 1) // sh + 1, (w - 1) // sw + 1, cout


def _pad(x: torch.Tensor, kt: int, causal: bool, spatial_mode: str, temporal_mode: str) -> torch.Tensor:
    """The padded input (B, T + kT - 1, H + 2, W + 2, C), in x's dtype."""
    b, t, h, w, c = x.shape
    if spatial_mode == "reflect":
        x = torch.cat([x[:, :, 1:2], x, x[:, :, h - 2:h - 1]], dim=2)
        x = torch.cat([x[:, :, :, 1:2], x, x[:, :, :, w - 2:w - 1]], dim=3)
    else:
        x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    front = kt - 1 if causal else (kt - 1) // 2
    back = kt - 1 - front
    if front or back:
        if temporal_mode == "replicate":
            parts = [x[:, :1].expand(-1, front, -1, -1, -1), x, x[:, -1:].expand(-1, back, -1, -1, -1)]
        else:
            zeros = x.new_zeros(b, 1, h + 2, w + 2, c)
            parts = [zeros.expand(-1, front, -1, -1, -1), x, zeros.expand(-1, back, -1, -1, -1)]
        x = torch.cat(parts, dim=1)
    return x


def conv3d_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    causal: bool = False,
    spatial_mode: str = "reflect",
    temporal_mode: str = "replicate",
    stride: tuple = (1, 1, 1),
) -> torch.Tensor:
    """The kernel's contract in plain PyTorch, as the Pallas kernel computes
    it (`conv3d_pallas` with its default group of 9 taps): pad, then for
    each temporal tap the 9 shifted input slabs side by side (an im2col
    block; with strides, slabs sampled on the strided grid of the padded
    input) times those taps' (9 * Cin, Cout) weights, summed in fp32
    (float64 for float64 input), plus bias, cast once to x's dtype.
    x (B, T, H, W, Cin), w (kT, 3, 3, Cin, Cout) -> `out_shape`."""
    _check_modes(spatial_mode, temporal_mode)
    _check_shapes(x, w, b, spatial_mode, stride)
    kt, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    _, t, h, wd, _ = out_shape(x.shape, cout, stride)
    st, sh, sw = stride
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = _pad(x, kt, causal, spatial_mode, temporal_mode)
    out = None
    for dt in range(kt):
        cols = torch.cat([xp[:, dt:dt + (t - 1) * st + 1:st, dh:dh + (h - 1) * sh + 1:sh, dw:dw + (wd - 1) * sw + 1:sw]
                          for dh in range(3) for dw in range(3)], dim=-1)
        term = cols.to(acc_dtype) @ w[dt].reshape(9 * cin, cout).to(acc_dtype)
        out = term if out is None else out.add_(term)
    if b is not None:
        out = out + b.to(acc_dtype)
    return out.to(x.dtype)


def conv3d_ndhwc_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    causal: bool = False,
    spatial_mode: str = "reflect",
    temporal_mode: str = "replicate",
    w_split: Optional[torch.Tensor] = None,
    stride: tuple = (1, 1, 1),
) -> torch.Tensor:
    """Launch the implicit-GEMM kernel on CUDA tensors: x (B, T, H, W, Cin)
    contiguous bf16 or fp32, w (kT, 3, 3, Cin, Cout) in x's dtype (for bf16
    read through its K-major transpose; for fp32 through `w_split`, w's
    `tf32x3_split`, made here when not given; see the module note), b (Cout,)
    any float dtype (added in fp32), strides of 1 or 2. Raises for anything
    the kernel does not take: another device or dtype, Cin % 16 != 0,
    Cout % 8 != 0, a non-contiguous or misaligned operand."""
    _check_modes(spatial_mode, temporal_mode)
    stride = tuple(stride)
    _check_shapes(x, w, b, spatial_mode, stride)
    if x.device.type != "cuda" or w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError(f"conv3d kernel: operands must be on one CUDA device, got x on {x.device}, "
                         f"w on {w.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"conv3d kernel: x and w must both be bfloat16 or float32, got {x.dtype}, {w.dtype}")
    kt, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    if cin % 16 or cout % 8:
        raise ValueError(f"conv3d kernel: needs Cin % 16 == 0 and Cout % 8 == 0, got Cin {cin}, Cout {cout}")
    bsz, t, h, wd, _ = x.shape
    oshape = out_shape(x.shape, cout, stride)
    m = math.prod(oshape[:4])
    if bsz * t * h * wd >= 2 ** 31:
        raise ValueError(f"conv3d kernel: too many voxels for 32-bit voxel indices {tuple(x.shape)}")
    splits, workspace = 1, None
    if x.dtype == torch.float32:
        if w_split is None:
            w_split = tf32x3_split(w)
        elif (tuple(w_split.shape) != (2, kt * 9, cout, cin) or w_split.dtype != torch.float32
              or w_split.device != x.device):
            raise ValueError(f"conv3d kernel: w_split {tuple(w_split.shape)} {w_split.dtype} on "
                             f"{w_split.device} is not the TF32 split of w {tuple(w.shape)}")
        w = w_split
        splits, _ = tf32x3_plan(m, cout, cin, kt, torch.cuda.get_device_properties(x.device).multi_processor_count)
        if splits > 1:
            workspace = torch.empty((splits, m, cout), dtype=torch.float32, device=x.device)
    else:
        w = w.transpose(3, 4)  # the K-major storage (kT, 3, 3, Cout, Cin)
        if not w.is_contiguous():
            w = w.contiguous()
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3d kernel: x and w must be contiguous with 16-byte aligned bases")
    bias = None if b is None else b.to(torch.float32).contiguous()
    out = torch.empty(oshape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = kernel("ltx_conv3d_ndhwc")(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if workspace is None else workspace.data_ptr(), int(x.dtype == torch.float32), splits,
            bsz, t, h, wd, cin, cout, kt, int(causal), int(spatial_mode == "zeros"), int(temporal_mode == "zeros"),
            *stride, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3d kernel: launch failed with CUDA error {err}")
    conv3d_ndhwc_kernel.launches += 1
    if stride != (1, 1, 1):
        conv3d_ndhwc_kernel.strided_launches += 1
    return out


conv3d_ndhwc_kernel.launches = 0
conv3d_ndhwc_kernel.strided_launches = 0  # the strided ones among `launches`


def conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    causal: bool = False,
    spatial_mode: str = "reflect",
    temporal_mode: str = "replicate",
    w_split: Optional[torch.Tensor] = None,
    stride: tuple = (1, 1, 1),
) -> torch.Tensor:
    """The conv on x's device: `conv3d_plain` for a CPU tensor (`w_split`
    unused), the kernel for a CUDA tensor (or an error; there is no
    fallback)."""
    stride = tuple(stride)
    if x.device.type == "cpu":
        return conv3d_plain(x, w, b, causal, spatial_mode, temporal_mode, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d: unsupported device {x.device}")
    return conv3d_ndhwc_kernel(x, w, b, causal, spatial_mode, temporal_mode, w_split, stride)
