"""Parity of the port's 3D convolution (ltx2_tpu_torch.ops.conv3d and
models/video_vae/conv.py) with the JAX package, in float32 on the CPU.

The CUDA kernel (csrc/conv3d.cu) is the counterpart of the Pallas TPU
kernels of scripts/bench_conv_pallas.py. Those use TPU DMA copies and
semaphores and cannot run on the CPU, even in interpret mode, so they are
not run here: their own check holds them against the JAX package's
`conv3d_ndhwc` (bench_conv_pallas.py:403-429), and so is the port's plain
version here, through the port's `conv3d_ndhwc` (the path a CPU tensor
takes). The kernel itself is held against the plain version on the card
(tests/test_torch_port_gpu.py, chip_smoke.py). Tolerance: 1e-4 of the
output's largest magnitude (the two sum the taps in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.video_vae import conv as jconv
from ltx2_tpu_torch.models.video_vae import conv
from ltx2_tpu_torch.ops import conv3d as C
from tests.torch_port_util import assert_close, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# (name, x shape (B, T, H, W, Cin), Cout, causal, spatial mode, temporal mode)
CASES = [
    ("reflect_replicate_causal", (1, 4, 5, 6, 8), 12, True, "reflect", "replicate"),
    ("reflect_replicate_symmetric", (1, 4, 5, 6, 8), 12, False, "reflect", "replicate"),
    ("zeros_zeros", (1, 4, 5, 6, 8), 12, False, "zeros", "zeros"),
    ("zeros_replicate", (1, 3, 4, 5, 8), 8, True, "zeros", "replicate"),
    ("reflect_zeros", (1, 3, 4, 5, 8), 8, False, "reflect", "zeros"),
    ("ragged_batch2_cout_lt_cin", (2, 5, 7, 3, 16), 6, False, "reflect", "replicate"),
    ("t1_causal", (1, 1, 4, 4, 8), 16, True, "reflect", "replicate"),
    ("t1_symmetric", (1, 1, 3, 5, 8), 8, False, "reflect", "replicate"),
    ("t1_zeros", (1, 1, 3, 5, 8), 8, False, "zeros", "zeros"),
]


def _weights(rng, cout, cin, kt=3):
    w = (rng.standard_normal((cout, cin, kt, 3, 3)) * 0.1).astype(np.float32)
    return w, rng.standard_normal(cout).astype(np.float32)


@pytest.mark.parametrize("name,shape,cout,causal,spatial_mode,temporal_mode", CASES, ids=[c[0] for c in CASES])
def test_conv3d_matches_jax(name, shape, cout, causal, spatial_mode, temporal_mode):
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal(shape).astype(np.float32)
    w, b = _weights(rng, cout, shape[-1])
    ref = jconv.conv3d_ndhwc({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), causal=causal,
                             spatial_mode=spatial_mode, temporal_mode=temporal_mode)
    p = conv.Conv3d(shape[-1], cout)
    p.weight.data, p.bias.data = t(w), t(b)
    out = conv.conv3d_ndhwc(p, t(x), causal=causal, spatial_mode=spatial_mode, temporal_mode=temporal_mode)
    assert_close(out, ref, msg=name)


def test_per_frame_conv_matches_the_resampler_conv():
    """kT = 1 with zero padding against the per-frame conv_general_dilated
    of the JAX upscaler's resampler (models/upscaler/spatial.py:81-100)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 4, 5, 16)).astype(np.float32)
    w = (rng.standard_normal((64, 16, 3, 3)) * 0.1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.reshape(3, 4, 5, 16)), jnp.asarray(w.transpose(2, 3, 1, 0)), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST,
    ) + jnp.asarray(b)
    p = conv.Conv3d(16, 64, per_frame=True)
    p.weight.data, p.bias.data = t(w), t(b)
    out = conv.conv3d_ndhwc(p, t(x), causal=False, spatial_mode="zeros", temporal_mode="zeros")
    assert_close(out, np.asarray(ref).reshape(1, 3, 4, 5, 64), msg="per-frame conv")


def test_plain_version_sums_in_float64_for_float64():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 2, 3, 3, 4)))
    w = C.kernel_layout(torch.from_numpy(rng.standard_normal((4, 4, 3, 3, 3))))
    out = C.conv3d_plain(x, w, None, True, "reflect", "replicate")
    assert out.dtype == torch.float64
    ref = C.conv3d_plain(x.float(), w.float(), None, True, "reflect", "replicate")
    assert ref.dtype == torch.float32 and torch.allclose(out.float(), ref, atol=1e-5)


def test_kernel_weight_is_reordered_once_and_follows_the_weight():
    p = conv.Conv3d(4, 8)
    torch.nn.init.normal_(p.weight)
    w1 = p.kernel_weight(torch.float32)
    assert w1.shape == (3, 3, 3, 4, 8) and w1.is_contiguous()
    assert p.kernel_weight(torch.float32) is w1  # cached
    assert torch.equal(w1[1, 2, 0], p.weight[:, :, 1, 2, 0].T)
    with torch.no_grad():
        p.weight.mul_(2.0)  # an in-place change invalidates the cache
    assert torch.equal(p.kernel_weight(torch.float32), 2 * w1)
    assert p.kernel_weight(torch.bfloat16).dtype == torch.bfloat16
    frame = conv.Conv3d(4, 8, per_frame=True)
    assert frame.weight.shape == (8, 4, 3, 3) and frame.kernel_weight(torch.float32).shape == (1, 3, 3, 4, 8)


def test_boundaries_raise():
    x = torch.zeros(1, 2, 4, 4, 16)
    p = conv.Conv3d(16, 8)
    torch.nn.init.zeros_(p.weight)
    from ltx2_tpu_torch.parallel.mesh import Axis

    with pytest.raises(ValueError, match="halo"):  # the W-sharded conv takes W stride 1 only
        conv.conv3d_ndhwc(p, x, stride=(1, 1, 2), w_halo_axis=Axis("data", 2, 0, (0, 1), None, "gloo"))
    with pytest.raises(ValueError, match="stride"):
        conv.conv3d_ndhwc(p, x, stride=(1, 3, 2))
    with pytest.raises(ValueError, match="spatial_mode"):
        conv.conv3d_ndhwc(p, x, spatial_mode="replicate")
    with pytest.raises(ValueError, match="reflect padding needs"):
        conv.conv3d_ndhwc(p, torch.zeros(1, 2, 1, 4, 16))
    # The kernel's wrapper takes CUDA tensors only: a CPU tensor goes to the
    # plain version through `conv3d`, never silently through the wrapper.
    with pytest.raises(ValueError, match="CUDA"):
        C.conv3d_ndhwc_kernel(x, p.kernel_weight(torch.float32))
    assert C.conv3d_ndhwc_kernel.launches == 0


# The audio VAE decoder's 2D convs and the vocoders' 1D, transposed and
# depthwise convs: the JAX package computes them with lax.conv_general_dilated
# at HIGHEST precision, outside any Pallas kernel
# (ltx2_tpu/models/audio_vae/decoder.py, vocoder.py:36), so the port runs
# them as F.conv* in fp32. Their attention-free modules are the only ones.
LIBRARY_CONV_MODULES = ("ltx2_tpu_torch/models/audio_vae/decoder.py", "ltx2_tpu_torch/models/audio_vae/vocoder.py")


def test_no_library_conv_or_attention_in_the_port():
    """Every conv and attention call of the port goes through its own
    kernels (or their plain versions): cuDNN's conv and PyTorch's fused
    attention appear only in chip_smoke.py, as yardsticks, and in the audio
    modules whose convs the JAX package runs outside Pallas (library convs,
    never attention)."""
    from pathlib import Path

    pkg = Path(conv.__file__).resolve().parents[2]
    calls = ("F.conv", "functional.conv", "scaled_dot_product_attention")
    found = [(str(f.relative_to(pkg.parent)), c) for f in sorted(pkg.rglob("*.py")) for c in calls
             if c in f.read_text()]
    assert not [(f, c) for f, c in found if f not in LIBRARY_CONV_MODULES or "attention" in c], found
    assert {f for f, _ in found} == set(LIBRARY_CONV_MODULES), found


# ---- the bf16 kernel's own order -------------------------------------------
# csrc/conv3d.cu's `conv3d_wgmma_kernel` cannot run here; this is its tiling
# in numpy, fp32: output tiles of BM voxels x BN outputs (M tiles fastest),
# per tile the producer's separable row table (frame, row and column parts
# of the input voxel index, kPad where zeros are read or past M), then K in
# steps of 64 channels of one tap: the A tile gathered row by row (zero
# where the table says kPad or the channel is past Cin), the B tile a box of
# the K-major (taps, Cout, Cin) weights (zero past Cout and Cin, as TMA
# fills it), A B^T summed into the tile's accumulator; bias added once.
KPAD = -2 ** 31


def _pad_index(i, n, zeros):
    if 0 <= i < n:
        return i
    if zeros:
        return KPAD
    return -i if i < 0 else 2 * n - 2 - i


def _row_table(m0, bm, dims, kt, causal, spatial_zeros, temporal_zeros):
    b, t, h, w = dims
    t_front = kt - 1 if causal else (kt - 1) // 2
    tab = np.full((9, bm), KPAD, np.int64)
    for r in range(bm):
        m = m0 + r
        if m >= b * t * h * w:
            continue
        col, q = m % w, m // w
        row, bt = q % h, q // h
        frame = bt % t
        for d in range(3):
            ti = frame + d - t_front
            if not 0 <= ti < t:
                ti = KPAD if temporal_zeros else min(max(ti, 0), t - 1)
            tab[d, r] = KPAD if ti == KPAD else (bt - frame + ti) * h * w
            hi = _pad_index(row + d - 1, h, spatial_zeros)
            tab[3 + d, r] = KPAD if hi == KPAD else hi * w
            tab[6 + d, r] = _pad_index(col + d - 1, w, spatial_zeros)
    return tab


def _kernel_order_conv(x, w, bias, causal, spatial_mode, temporal_mode):
    """x (B, T, H, W, Cin), w (kT, 3, 3, Cin, Cout), numpy fp32, in the
    kernel's order. Returns the output and the tiles' batch/frame/row spans."""
    bsz, t, h, wd, cin = x.shape
    kt, cout = w.shape[0], w.shape[4]
    bm, bn = C.wgmma_tile(cout)
    w_nk = w.transpose(0, 1, 2, 4, 3).reshape(kt * 9, cout, cin)  # the K-major storage
    xf = x.reshape(-1, cin)
    m_total = bsz * t * h * wd
    m_tiles, n_tiles, k_chunks = -(-m_total // bm), -(-cout // bn), -(-cin // 64)
    out = np.zeros((m_total, cout), np.float32)
    spans = []
    for tile in range(m_tiles * n_tiles):
        m0, n0 = (tile % m_tiles) * bm, (tile // m_tiles) * bn
        tab = _row_table(m0, bm, (bsz, t, h, wd), kt, causal, spatial_mode == "zeros", temporal_mode == "zeros")
        acc = np.zeros((bm, bn), np.float32)
        for k in range(kt * 9 * k_chunks):
            tap, c0 = k // k_chunks, (k % k_chunks) * 64
            dt, dh, dw = tap // 9, (tap // 3) % 3, tap % 3
            parts = tab[dt], tab[3 + dh], tab[6 + dw]
            ok = (parts[0] >= 0) & (parts[1] >= 0) & (parts[2] >= 0)
            vox = parts[0] + parts[1] + parts[2]
            ch = min(64, cin - c0)
            a = np.zeros((bm, 64), np.float32)
            a[ok, :ch] = xf[vox[ok], c0:c0 + ch]
            nb = min(bn, cout - n0)
            b_tile = np.zeros((bn, 64), np.float32)
            b_tile[:nb, :ch] = w_nk[tap, n0:n0 + nb, c0:c0 + ch]
            acc += a @ b_tile.T
        rows, cols = min(bm, m_total - m0), min(bn, cout - n0)
        out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols] + bias[n0:n0 + cols]
        spans.append((m0 // (t * h * wd) != (m0 + rows - 1) // (t * h * wd),
                      m0 // (h * wd) != (m0 + rows - 1) // (h * wd), m0 // wd != (m0 + rows - 1) // wd))
    return out.reshape(bsz, t, h, wd, cout), spans


# (name, x shape, Cout, kT, causal, spatial mode, temporal mode): Cin = 16
# and Cout = 48 (the small decoder's conv_out), M tiles across rows, frames
# and batches with ragged tails, W = 44 (not a multiple of anything the
# kernel tiles by), Cin = 80 (a partly filled channel step), Cout 136 and
# 256 (two N tiles with a ragged one; BN = 256), kT = 1.
ORDER_CASES = [
    ("reflect_replicate_causal_cin16_cout48", (1, 4, 5, 6, 16), 48, 3, True, "reflect", "replicate"),
    ("reflect_replicate_symmetric_batch2", (2, 3, 7, 9, 32), 24, 3, False, "reflect", "replicate"),
    ("zeros_zeros_cin80_cout136", (1, 3, 5, 6, 80), 136, 3, False, "zeros", "zeros"),
    ("causal_w44", (1, 2, 6, 44, 16), 48, 3, True, "reflect", "replicate"),
    ("kt1_zeros_cout256", (1, 3, 4, 5, 16), 256, 1, False, "zeros", "zeros"),
]


@pytest.mark.parametrize("name,shape,cout,kt,causal,spatial_mode,temporal_mode", ORDER_CASES,
                         ids=[c[0] for c in ORDER_CASES])
def test_kernel_order_matches_jax(name, shape, cout, kt, causal, spatial_mode, temporal_mode):
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal(shape).astype(np.float32)
    w, b = _weights(rng, cout, shape[-1], kt)
    out, spans = _kernel_order_conv(x, w.transpose(2, 3, 4, 1, 0), b, causal, spatial_mode, temporal_mode)
    if kt == 1:  # the resampler's per-frame conv (models/upscaler/spatial.py:81-100)
        ref = jax.lax.conv_general_dilated(
            jnp.asarray(x.reshape(-1, *shape[2:])), jnp.asarray(w[:, :, 0].transpose(2, 3, 1, 0)), (1, 1),
            [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST,
        ).reshape(*shape[:4], cout) + b
    else:
        ref = jconv.conv3d_ndhwc({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), causal=causal,
                                 spatial_mode=spatial_mode, temporal_mode=temporal_mode)
    assert_close(out, ref, msg=name)
    # The M tiles cross frame and row boundaries (and batches where there are two).
    assert any(frame for _, frame, _ in spans) and any(row for _, _, row in spans)
    assert any(batch for batch, _, _ in spans) == (shape[0] > 1)


# ---- the fp32 kernel's arithmetic (3xTF32) ---------------------------------
# csrc/conv3d.cu's `conv3d_tf32x3_kernel` in numpy: output tiles of 128
# voxels x 128 outputs; K in steps of 32 channels of one tap (the row table
# above gathers A); K split into the ranges `tf32x3_plan` gives for 132 SMs,
# each a whole number of chains of TF32X3_CHAIN steps (phantom steps past
# the last tap add nothing). Operands split as the kernel splits them: hi =
# rounded to TF32 (cvt.rna.tf32.f32), lo = the exact fp32 remainder with its
# low 13 bits dropped, as the tensor core reads it. Per k8 step three
# products lo(x) hi(w), hi(x) lo(w), hi(x) hi(w), each added into the
# chain's fp32 accumulator with one rounding; a chain's accumulator joins
# the range's fp32 sum, the ranges are summed in order, then the bias. With
# passes=1 the same order with hi(x) hi(w) alone: single-pass TF32. The
# tensor core's own accumulation is not round to nearest (one wgmma chain
# over all of K errs 200x more than fp32 on the card, PERF.md); rounding
# each addition toward zero (rz) models it to within a factor of 2 there,
# and is why the kernel keeps its chains short.
TF32_MASK = np.uint32(0xFFFFE000)


def _tf32_rna(a):
    return ((np.asarray(a, np.float32).view(np.uint32) + np.uint32(0x1000)) & TF32_MASK).view(np.float32)


def _tf32_trunc(a):
    return (np.asarray(a, np.float32).view(np.uint32) & TF32_MASK).view(np.float32)


def _add_rz(acc, prod):
    """fp32 acc + float64 prod, rounded toward zero."""
    s = acc.astype(np.float64) + prod
    r = s.astype(np.float32)
    return np.where(np.abs(r) > np.abs(s), np.nextafter(r, np.float32(0)), r)


def _tf32x3_kernel_conv(x, w, bias, causal, spatial_mode, temporal_mode, passes=3, sms=132,
                        chain=C.TF32X3_CHAIN, rz=False):
    """x (B, T, H, W, Cin), w (kT, 3, 3, Cin, Cout), numpy fp32, in the
    kernel's arithmetic, with chains of `chain` K steps; `rz` rounds each
    product's addition into the chain's accumulator toward zero instead of
    to nearest. Returns the output and the number of K ranges."""
    bsz, t, h, wd, cin = x.shape
    kt, cout = w.shape[0], w.shape[4]
    bm, bn = C.TF32X3_TILE
    m_total = bsz * t * h * wd
    splits, steps = C.tf32x3_plan(m_total, cout, cin, kt, sms)
    k_chunks = -(-cin // C.TF32X3_K_STEP)
    n_iter = kt * 9 * k_chunks
    w_nk = w.transpose(0, 1, 2, 4, 3).reshape(kt * 9, cout, cin)
    w_hi = _tf32_rna(w_nk)
    w_lo = _tf32_trunc(w_nk - w_hi)
    xf = x.reshape(-1, cin)
    partials = np.zeros((splits, m_total, cout), np.float32)
    for m0 in range(0, m_total, bm):
        tab = _row_table(m0, bm, (bsz, t, h, wd), kt, causal, spatial_mode == "zeros", temporal_mode == "zeros")
        rows = min(bm, m_total - m0)
        for n0 in range(0, cout, bn):
            cols = min(bn, cout - n0)
            for r in range(splits):
                total = np.zeros((rows, cols), np.float32)
                for k0 in range(r * steps, (r + 1) * steps, chain):
                    acc = np.zeros((rows, cols), np.float32)
                    for k in range(k0, min(k0 + chain, (r + 1) * steps, n_iter)):
                        tap, c0 = k // k_chunks, (k % k_chunks) * C.TF32X3_K_STEP
                        dt, dh, dw = tap // 9, (tap // 3) % 3, tap % 3
                        parts = tab[dt, :rows], tab[3 + dh, :rows], tab[6 + dw, :rows]
                        ok = (parts[0] >= 0) & (parts[1] >= 0) & (parts[2] >= 0)
                        ch = min(C.TF32X3_K_STEP, cin - c0)
                        a = np.zeros((rows, C.TF32X3_K_STEP), np.float32)
                        a[ok, :ch] = xf[(parts[0] + parts[1] + parts[2])[ok], c0:c0 + ch]
                        a_hi = _tf32_rna(a)
                        a_lo = _tf32_trunc(a - a_hi)
                        b_hi = np.zeros((cols, C.TF32X3_K_STEP), np.float32)
                        b_lo = np.zeros_like(b_hi)
                        b_hi[:, :ch] = w_hi[tap, n0:n0 + cols, c0:c0 + ch]
                        b_lo[:, :ch] = w_lo[tap, n0:n0 + cols, c0:c0 + ch]
                        terms = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if passes == 3 else ((a_hi, b_hi),)
                        for kk in range(0, C.TF32X3_K_STEP, 8):
                            for pa, pb in terms:
                                prod = pa[:, kk:kk + 8].astype(np.float64) @ pb[:, kk:kk + 8].T.astype(np.float64)
                                acc = _add_rz(acc, prod) if rz else (acc + prod).astype(np.float32)
                    total += acc
                partials[r, m0:m0 + rows, n0:n0 + cols] = total
    out = partials[0]
    for r in range(1, splits):
        out = out + partials[r]
    return (out + bias).reshape(bsz, t, h, wd, cout), splits


def _conv_f64_zeros(x, w, b):
    """The symmetric zero-padded conv in float64 numpy: x (B, T, H, W, Cin),
    w (kT, 3, 3, Cin, Cout)."""
    kt = w.shape[0]
    t, h, wd = x.shape[1:4]
    xp = np.pad(x.astype(np.float64), ((0, 0), ((kt - 1) // 2, kt // 2), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((*x.shape[:4], w.shape[4]))
    for dt in range(kt):
        for dh in range(3):
            for dw in range(3):
                out += xp[:, dt:dt + t, dh:dh + h, dw:dw + wd] @ w[dt, dh, dw].astype(np.float64)
    return out + b


def _rel_errors(out, ref):
    err = np.asarray(out, np.float64) - ref
    return np.sqrt((err ** 2).mean() / (ref ** 2).mean()), np.abs(err).max() / np.abs(ref).max()


# The float64 limits chip_smoke.py and the card-only test hold the kernel to.
TF32X3_RMS_REL, TF32X3_MAX_REL = 2e-6, 1e-5


@pytest.mark.parametrize("kt", [3, 1])
def test_tf32x3_arithmetic_is_fp32_accurate(kt):
    """The kernel's arithmetic at the upscaler's real K (Cin 1024, kT x 9
    taps) on a small spatial size: within the float64 limits, as JAX's fp32
    HIGHEST conv is; single-pass TF32 in the same order fails them."""
    rng = np.random.default_rng(11 + kt)
    cin, cout = 1024, 64
    x = rng.standard_normal((1, 2, 3, 4, cin)).astype(np.float32)
    bound = (cin * kt * 9) ** -0.5  # the upscaler's init: U(+-1/sqrt(fan_in))
    w = rng.uniform(-bound, bound, (cout, cin, kt, 3, 3)).astype(np.float32)
    b = rng.uniform(-bound, bound, cout).astype(np.float32)
    wk = w.transpose(2, 3, 4, 1, 0)  # (kT, 3, 3, Cin, Cout)
    n_iter = kt * 9 * cin // C.TF32X3_K_STEP
    ref = _conv_f64_zeros(x, wk, b)
    out, splits = _tf32x3_kernel_conv(x, wk, b, False, "zeros", "zeros")
    assert splits > 1  # one tile: K split into ranges, the sum crosses their boundaries
    rms, mx = _rel_errors(out, ref)
    assert rms <= TF32X3_RMS_REL and mx <= TF32X3_MAX_REL, (rms, mx)
    single, _ = _tf32x3_kernel_conv(x, wk, b, False, "zeros", "zeros", passes=1)
    rms1, mx1 = _rel_errors(single, ref)
    assert rms1 > 20 * TF32X3_RMS_REL and mx1 > TF32X3_MAX_REL, (rms1, mx1)
    # Accumulating toward zero, the kernel's short chains stay within the
    # limits; one chain over each K range does not.
    rz, _ = _tf32x3_kernel_conv(x, wk, b, False, "zeros", "zeros", rz=True)
    rms_rz, mx_rz = _rel_errors(rz, ref)
    assert rms_rz <= TF32X3_RMS_REL / 2 and mx_rz <= TF32X3_MAX_REL, (rms_rz, mx_rz)
    long_chain, _ = _tf32x3_kernel_conv(x, wk, b, False, "zeros", "zeros", chain=n_iter, rz=True)
    assert _rel_errors(long_chain, ref)[0] > 2 * TF32X3_RMS_REL
    if kt == 3:
        jref = jconv.conv3d_ndhwc({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), causal=False,
                                  spatial_mode="zeros", temporal_mode="zeros")
    else:  # the resampler's per-frame conv, as models/upscaler/spatial.py:81-100 runs it
        jref = jax.lax.conv_general_dilated(
            jnp.asarray(x.reshape(2, 3, 4, cin)), jnp.asarray(w[:, :, 0].transpose(2, 3, 1, 0)), (1, 1),
            [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST,
        ).reshape(1, 2, 3, 4, cout) + b
    jref = np.asarray(jref)
    assert max(_rel_errors(jref, ref)) <= TF32X3_MAX_REL  # the JAX package's own fp32 error
    rms_j, mx_j = _rel_errors(out, np.asarray(jref, np.float64))
    assert rms_j <= TF32X3_RMS_REL and mx_j <= TF32X3_MAX_REL, (rms_j, mx_j)


def test_tf32x3_order_matches_the_plain_version_with_ragged_tiles():
    """The model's tiling, row table and ranges (ragged M and N tiles,
    Cin = 48 in a partly filled step, reflect/replicate, causal, phantom
    steps) against the port's plain version in float64."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 9, 13, 48)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 48, 136)) * 0.05).astype(np.float32)
    b = rng.standard_normal(136).astype(np.float32)
    out, splits = _tf32x3_kernel_conv(x, w, b, True, "reflect", "replicate")
    m = x.size // 48
    assert splits > 1 and splits * C.tf32x3_plan(m, 136, 48, 3, 132)[1] > 3 * 9 * 2  # phantom steps
    ref = C.conv3d_plain(torch.from_numpy(x).double(), torch.from_numpy(w).double(), torch.from_numpy(b).double(),
                         True, "reflect", "replicate").numpy()
    rms, mx = _rel_errors(out, ref)
    assert rms <= TF32X3_RMS_REL and mx <= TF32X3_MAX_REL, (rms, mx)


def test_tf32_split_matches_the_model():
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(np.float32)
    a[:4] = [0.0, -0.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11)]  # ties round away from zero
    hi = C.tf32_round(torch.from_numpy(a)).numpy()
    assert np.array_equal(hi, _tf32_rna(a)) and hi[2] == 1.0 + 2 ** -10 and hi[3] == -(1.0 + 2 ** -10)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(hi - a) <= np.abs(a) * 2.0 ** -11)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 16, 8)).astype(np.float32))
    split = C.tf32x3_split(w)
    assert split.shape == (2, 27, 8, 16) and split.is_contiguous()
    wk = w.reshape(27, 16, 8).transpose(1, 2)
    assert torch.equal(split[0], C.tf32_round(wk)) and torch.equal(split[0] + split[1], wk)


# (x shape, Cout, kT) at the spatial upscaler's five fp32 shapes -> K ranges
# on 132 SMs: enough tiles for the card (the high-res res conv, the
# resampler) keep one range; the others split K.
PLAN_CASES = [
    ((1, 16, 16, 24, 1024), 1024, 3, 1),
    ((1, 16, 8, 12, 1024), 4096, 1, 1),
    ((1, 16, 8, 12, 1024), 1024, 3, 4),
    ((1, 16, 16, 24, 1024), 128, 3, 8),
    ((1, 16, 8, 12, 128), 1024, 3, 4),
]


@pytest.mark.parametrize("shape,cout,kt,splits", PLAN_CASES, ids=[f"{c[0][2]}x{c[0][3]}_{c[0][4]}to{c[1]}_kt{c[2]}"
                                                                  for c in PLAN_CASES])
def test_tf32x3_plan_fills_the_card(shape, cout, kt, splits):
    m = shape[0] * shape[1] * shape[2] * shape[3]
    got, steps = C.tf32x3_plan(m, cout, shape[-1], kt, 132)
    n_iter = kt * 9 * -(-shape[-1] // C.TF32X3_K_STEP)
    assert got == splits and steps % C.TF32X3_CHAIN == 0
    assert (got - 1) * steps < n_iter <= got * steps  # every range holds a real step


def test_tf32x3_weight_is_split_once_and_follows_the_weight():
    p = conv.Conv3d(16, 8)
    torch.nn.init.normal_(p.weight)
    s1 = p.tf32x3_weight()
    assert s1.shape == (2, 27, 8, 16) and p.tf32x3_weight() is s1  # cached
    assert torch.equal(s1, C.tf32x3_split(p.kernel_weight(torch.float32)))
    with torch.no_grad():
        p.weight.mul_(2.0)
    assert torch.equal(p.tf32x3_weight(), 2 * s1)  # x 2 is exact in both parts
    frame = conv.Conv3d(16, 8, per_frame=True)
    torch.nn.init.normal_(frame.weight)
    assert frame.tf32x3_weight().shape == (2, 9, 8, 16)
