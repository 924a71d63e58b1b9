"""3D convolution for the video VAE and the upscalers over channels-last
tensors (counterpart of ltx2_tpu/models/video_vae/conv.py).

Padding semantics are the JAX package's: spatial "reflect" (the VAE) or
"zeros" (the upscalers); temporal "replicate" (all k-1 frames in front when
causal, else split around the clip) or "zeros". Every conv runs through
`ops/conv3d.py`: the hand-written implicit-GEMM kernel for a CUDA tensor,
its plain version for a CPU tensor. Kernel sizes: 3 x 3 x 3, and the
per-frame 3 x 3 (a 4D weight) of the upscaler's resampler. The kernel takes
output counts that are multiples of 8: a conv with another Cout (the
encoder's conv_out, 129) runs on its weight and bias padded with zero
outputs to the next multiple of 8, on every device, and the padding is
sliced off the output. Strides (1 or 2 per axis; the full VAE's strided
causal convs) run in the same kernels.

W-sharded convs (`w_halo_axis`, a parallel/mesh.py axis the W dim is split
over; the JAX package's conv.py:34-84,110-127): each rank receives its
neighbours' boundary columns (`_pad_w_halo`: one ring shift a side), the
ranks at the global edges put the conv's padding rule in their place, and
the haloed slab goes through the kernels' W-valid mode (no W padding; T and
H keep their rules).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ltx2_tpu_torch.ops.conv3d import conv3d, kernel_layout, tf32x3_split


def _pad_w_halo(x: torch.Tensor, axis, pad: int, mode: str) -> torch.Tensor:
    """A W-split (B, T, H, W_local, C) slab with `pad` columns of halo each
    side: its ring neighbours' boundary columns, and at the global edges
    the padding rule (reflect or zeros). Correct down to W_local == pad (a
    reflect column that lives on the neighbour is exactly what the other
    direction's shift delivered), as the JAX package's `_pad_w_halo`."""
    from ltx2_tpu_torch.parallel.collectives import ring_shift

    w_local = x.shape[3]
    if w_local < pad:
        raise ValueError(f"W shard ({w_local}) narrower than conv halo ({pad}): use fewer devices on the W axis")
    from_left = ring_shift(x[:, :, :, -pad:], axis, 1)
    from_right = ring_shift(x[:, :, :, :pad], axis, -1)
    if mode == "reflect":
        if w_local > pad:
            edge_l = x[:, :, :, 1:pad + 1].flip(3)
            edge_r = x[:, :, :, -pad - 1:-1].flip(3)
        elif pad == 1:
            edge_l, edge_r = from_right, from_left
        else:
            raise ValueError(f"reflect halo with W shard ({w_local}) == pad ({pad}) > 1 needs columns from two "
                             f"shards; use fewer devices on W")
    else:
        edge_l, edge_r = torch.zeros_like(from_left), torch.zeros_like(from_right)
    left = edge_l if axis.index == 0 else from_left
    right = edge_r if axis.index == axis.size - 1 else from_right
    return torch.cat([left, x, right], dim=3)


class Conv3d(nn.Module):
    """Parameter holder: weight (outC, inC, 3, 3, 3), or (outC, inC, 3, 3)
    when `per_frame`; bias (outC,). What the kernels read is made once and
    kept until the weight changes: the (kT, kH, kW, inC, outC') reordering
    (in bf16 a view of K-major (kT, kH, kW, outC', inC) storage, the order
    the bf16 kernel reads), and for the fp32 kernel the weight's TF32 hi and
    lo parts (`tf32x3_split`, twice the fp32 weight's bytes); outC' is
    `kernel_out`, outC rounded up to a multiple of 8, the added outputs'
    weights and biases zero."""

    def __init__(self, in_channels: int, out_channels: int, *, per_frame: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        shape = (out_channels, in_channels, 3, 3) if per_frame else (out_channels, in_channels, 3, 3, 3)
        self.weight = nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_channels, device=device, dtype=dtype), requires_grad=False)
        self._kernel_weight = None
        self._kernel_weight_key = None
        self._tf32x3 = None
        self._tf32x3_key = None
        self._padded = None
        self._padded_key = None

    @property
    def kernel_out(self) -> int:
        """The outputs the kernels compute: outC rounded up to a multiple of 8."""
        return -(-self.weight.shape[0] // 8) * 8

    def padded(self) -> tuple:
        """(weight, bias) with `kernel_out` outputs, the added ones zero;
        the parameters themselves when outC is a multiple of 8."""
        pad = self.kernel_out - self.weight.shape[0]
        if not pad:
            return self.weight.detach(), self.bias.detach()
        w, b = self.weight, self.bias
        key = (w.data_ptr(), w._version, b.data_ptr(), b._version, w.device)
        if self._padded_key != key:
            self._padded = (torch.cat([w.detach(), w.new_zeros(pad, *w.shape[1:])]),
                            torch.cat([b.detach(), b.new_zeros(pad)]))
            self._padded_key = key
        return self._padded

    def kernel_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The padded weight as (kT, kH, kW, inC, kernel_out) in `dtype`, cached."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device, dtype)
        if self._kernel_weight_key != key:
            self._kernel_weight = kernel_layout(self.padded()[0].to(dtype), k_major=dtype == torch.bfloat16)
            self._kernel_weight_key = key
        return self._kernel_weight

    def tf32x3_weight(self) -> torch.Tensor:
        """The padded weight's TF32 split (2, kT * 9, kernel_out, inC), cached."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._tf32x3_key != key:
            self._tf32x3 = tf32x3_split(kernel_layout(self.padded()[0], copy=False))
            self._tf32x3_key = key
        return self._tf32x3


def conv3d_ndhwc(
    p: Conv3d,
    x: torch.Tensor,
    causal: bool = True,
    spatial_mode: str = "reflect",
    temporal_mode: str = "replicate",
    stride: tuple = (1, 1, 1),
    w_halo_axis=None,
) -> torch.Tensor:
    """Conv over (B, T, H, W, C) with the JAX package's padding rules and
    defaults: 'same' output size at stride 1, the padded input sampled on
    the strided grid otherwise. An fp32 CUDA input goes in with
    the cached TF32 split, the only form of the weight the fp32 kernel
    reads, beside a view of the weight for the wrapper's checks. A Cout
    padded to `kernel_out` is sliced off the output (a view). `w_halo_axis`:
    x is this rank's W slab; its halo comes from the neighbours
    (`_pad_w_halo`) and the conv runs W-valid (W stride 1 only)."""
    weight, bias = p.padded()
    stride = tuple(stride)
    w_valid = w_halo_axis is not None and w_halo_axis.size > 1
    if w_valid:
        if stride[2] != 1:
            raise ValueError("w_halo_axis requires W stride 1")
        x = _pad_w_halo(x, w_halo_axis, 1, spatial_mode)
    if x.device.type == "cuda" and x.dtype == torch.float32:
        w = kernel_layout(weight.float(), copy=False)
        out = conv3d(x.contiguous(), w, bias, causal, spatial_mode, temporal_mode, w_split=p.tf32x3_weight(),
                     stride=stride, w_valid=w_valid)
    else:
        out = conv3d(x.contiguous(), p.kernel_weight(x.dtype), bias, causal, spatial_mode, temporal_mode,
                     stride=stride, w_valid=w_valid)
    cout = p.weight.shape[0]
    return out if out.shape[-1] == cout else out[..., :cout]


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, T, H, W, C), contiguous."""
    return x.permute(0, 2, 3, 4, 1).contiguous()


def from_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, C, T, H, W) view."""
    return x.permute(0, 4, 1, 2, 3)
