"""The port's CUDA kernels (flash attention forward and backward, the
implicit-GEMM conv) against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card. The file
imports neither JAX nor the tests package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest -m gpu tests/test_torch_port_gpu.py

Limits are relative to the reference, as chip_smoke.py states them.
"""

import pytest
import torch

from ltx2_tpu_torch.ops import attention


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU with python -m pytest -m gpu")


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_gpu():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(2, 100, 4 * 128, device="cuda", generator=gen).bfloat16()
    kv = torch.randn(2, 333, 4 * 128, device="cuda", generator=gen).bfloat16()
    qh, kh = q.view(2, 100, 4, 128).transpose(1, 2), kv.view(2, 333, 4, 128).transpose(1, 2)
    valid = torch.ones(2, 333, dtype=torch.bool, device="cuda")
    valid[0, 200:] = False
    for mask in (None, valid):
        out = attention.flash_attention(qh, kh, kh, kv_valid=mask)
        ref = attention.flash_attention_plain(qh, kh, kh, kv_valid=mask)
        out, ref = out.float(), ref.float()  # limits relative to the output, as chip_smoke.py states them
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
        assert (out - ref).square().mean().sqrt() <= 1e-2 * ref.square().mean().sqrt()
    with pytest.raises(TypeError):
        attention.flash_attention(qh.float(), kh.float(), kh.float())


@pytest.mark.gpu
def test_backward_kernels_match_plain_on_gpu():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h = 2, 4
    for d in (128, 64):
        x = {n: torch.randn(b, t_, h * d, device="cuda", generator=gen).bfloat16().view(b, t_, h, d).transpose(1, 2)
             for n, t_ in (("q", 100), ("k", 333), ("v", 333), ("do", 100))}
        valid = torch.ones(b, 333, dtype=torch.bool, device="cuda")
        valid[0, 200:] = False
        for mask in (None, valid):
            leaves = [x[n].float().requires_grad_() for n in ("q", "k", "v")]
            ref = torch.autograd.grad(attention.flash_attention_plain(*leaves, None, mask), leaves, x["do"].float())
            o, l, m = attention.flash_attention_residuals(x["q"], x["k"], x["v"], None, mask)
            _, l_ref, m_ref = attention.flash_attention_residuals_plain(x["q"], x["k"], x["v"], None, mask)
            assert (l - l_ref).abs().max() <= 1e-4 * l_ref.abs().max()
            assert (m - m_ref).abs().max() <= 1e-4 * m_ref.abs().max()
            before = attention.flash_attention_bwd_kernel.launches
            grads = attention.flash_attention_bwd(x["q"], x["k"], x["v"], o, l, m, x["do"], None, mask)
            again = attention.flash_attention_bwd(x["q"], x["k"], x["v"], o, l, m, x["do"], None, mask)
            torch.cuda.synchronize()
            assert attention.flash_attention_bwd_kernel.launches == before + 2  # one fused launch a call
            for g, r in zip(grads, ref):  # limits relative to the reference, as chip_smoke.py states them
                g = g.float()
                assert (g - r).abs().max() <= 2e-2 * r.abs().max(), d
                assert (g - r).square().mean().sqrt() <= 1e-2 * r.square().mean().sqrt(), d
            # dK and dV are written once per key block: bitwise reproducible.
            # dQ is summed over key blocks in fp32 in the order they finish.
            assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2])
            dq, dq2 = grads[0].float(), again[0].float()
            assert (dq - dq2).abs().max() <= 1e-2 * dq.abs().max()
    # What the kernel does not take raises on the card; nothing falls back.
    q = torch.randn(1, 2, 64, 96, device="cuda").bfloat16()
    l = torch.ones(1, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention_bwd(q, q, q, q, l, l, q)


@pytest.mark.gpu
def test_conv_kernel_matches_plain_on_gpu():
    _need_card()
    from ltx2_tpu_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (x shape, Cout, kT, dtype, causal, spatial, temporal, limits relative to the plain output)
    cases = [
        ((2, 5, 30, 44, 64), 128, 3, torch.bfloat16, True, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 3, 9, 13, 128), 48, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 4, 6, 7, 32), 40, 3, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 3, 5, 6, 48), 64, 1, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 1, 4, 4, 16), 8, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
    ]
    for shape, cout, kt, dtype, causal, sm, tm, (max_rel, rms_rel) in cases:
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(kt, 3, 3, shape[-1], cout, device="cuda", generator=gen) * 0.05).to(dtype)
        b = torch.randn(cout, device="cuda", generator=gen)
        before = C.conv3d_ndhwc_kernel.launches
        out = C.conv3d(x, w, b, causal, sm, tm).float()
        assert C.conv3d_ndhwc_kernel.launches == before + 1
        ref = C.conv3d_plain(x, w, b, causal, sm, tm).float()
        torch.cuda.synchronize()
        assert out.shape == ref.shape == (*shape[:4], cout)
        assert (out - ref).abs().max() <= max_rel * ref.abs().max(), (shape, dtype)
        assert (out - ref).square().mean().sqrt() <= rms_rel * ref.square().mean().sqrt(), (shape, dtype)
    # What the kernel does not take raises on the card; nothing falls back.
    x = torch.randn(1, 2, 4, 4, 24, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="Cin % 16"):
        C.conv3d(x, torch.zeros(3, 3, 3, 24, 8, device="cuda").bfloat16())
    x = torch.randn(1, 2, 4, 4, 16, device="cuda")
    with pytest.raises(ValueError, match="Cout % 8"):
        C.conv3d(x, torch.zeros(3, 3, 3, 16, 12, device="cuda"))
    with pytest.raises(TypeError):
        C.conv3d(x.half(), torch.zeros(3, 3, 3, 16, 8, device="cuda").half())
    with pytest.raises(ValueError, match="contiguous"):
        C.conv3d(x.transpose(2, 3), torch.zeros(3, 3, 3, 16, 8, device="cuda"))
