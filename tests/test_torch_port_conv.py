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
    with pytest.raises(NotImplementedError):
        conv.conv3d_ndhwc(p, x, stride=(1, 2, 2))
    with pytest.raises(ValueError, match="spatial_mode"):
        conv.conv3d_ndhwc(p, x, spatial_mode="replicate")
    with pytest.raises(ValueError, match="reflect padding needs"):
        conv.conv3d_ndhwc(p, torch.zeros(1, 2, 1, 4, 16))
    # The kernel's wrapper takes CUDA tensors only: a CPU tensor goes to the
    # plain version through `conv3d`, never silently through the wrapper.
    with pytest.raises(ValueError, match="CUDA"):
        C.conv3d_ndhwc_kernel(x, p.kernel_weight(torch.float32))
    assert C.conv3d_ndhwc_kernel.launches == 0


def test_no_library_conv_or_attention_in_the_port():
    """Every conv and attention call of the port goes through its own
    kernels (or their plain versions): cuDNN's conv and PyTorch's fused
    attention appear only in chip_smoke.py, as yardsticks."""
    from pathlib import Path

    pkg = Path(conv.__file__).resolve().parents[2]
    calls = ("F.conv", "functional.conv", "scaled_dot_product_attention")
    found = [(str(f.relative_to(pkg.parent)), c) for f in sorted(pkg.rglob("*.py")) for c in calls
             if c in f.read_text()]
    assert not found, found
