"""The port's CUDA kernels (flash attention forward and backward, the
implicit-GEMM conv, also at the video encoder's shapes and strided) against their plain
PyTorch versions (the backward also at head dim 64 on the audio-video
training shapes), the fp32 text encoder (Gemma-3 at full width, 2 layers,
and the V1 encoder; also with Gemma in fp8), the fp32 video encoder (a
reduced plan) and the published audio encoder with its mel analysis
and the temporal upscaler (a reduced width) against the same modules on
the CPU, the int8 W8A8 product's torch._int_mm route against its plain
int32 route, a full-width DiT block loaded kept in
fp8 onto the card, and a full-width V2 (LTX-2.3) forward, an audio-video
forward and the two-stage CFG pipeline's 3-row multi-modal loop through
the kernels against plain attention, on the card.

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
    b, h = 2, 4
    # Both head dims; T_q and T_k multiples of neither the 128-row query tile
    # nor the 128-key tile, and a T_k shorter than one key tile.
    for d in (128, 64):
        for t_q, t_k in ((100, 333), (300, 77)):
            q = torch.randn(b, t_q, h * d, device="cuda", generator=gen).bfloat16()
            kv = torch.randn(b, t_k, h * d, device="cuda", generator=gen).bfloat16()
            qh, kh = q.view(b, t_q, h, d).transpose(1, 2), kv.view(b, t_k, h, d).transpose(1, 2)
            valid = torch.ones(b, t_k, dtype=torch.bool, device="cuda")
            valid[0, t_k // 2:] = False
            for mask in (None, valid):
                out = attention.flash_attention(qh, kh, kh, kv_valid=mask)
                ref = attention.flash_attention_plain(qh, kh, kh, kv_valid=mask)
                out, ref = out.float(), ref.float()  # limits relative to the output, as chip_smoke.py states them
                assert (out - ref).abs().max() <= 2e-2 * ref.abs().max(), (d, t_q, t_k)
                assert (out - ref).square().mean().sqrt() <= 1e-2 * ref.square().mean().sqrt(), (d, t_q, t_k)
                # The residuals differ from the plain version in summation order only.
                o, l, m = attention.flash_attention_residuals(qh, kh, kh, None, mask)
                _, l_ref, m_ref = attention.flash_attention_residuals_plain(qh, kh, kh, None, mask)
                assert torch.equal(o, attention.flash_attention(qh, kh, kh, kv_valid=mask))
                assert (l - l_ref).abs().max() <= 1e-4 * l_ref.abs().max(), (d, t_q, t_k)
                assert (m - m_ref).abs().max() <= 1e-4 * m_ref.abs().max(), (d, t_q, t_k)
    # What the kernel does not take raises on the card; nothing falls back.
    with pytest.raises(TypeError):
        attention.flash_attention(qh.float(), kh.float(), kh.float())
    x = torch.randn(1, 2, 64, 96, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(x, x, x)


@pytest.mark.gpu
def test_flash_kernel_key_valid_at_a_bucket_shape_on_gpu():
    """The key-valid route as a token bucket uses it: every row keeps the
    first 520 of 768 keys (key tile 4 partly valid, tile 5 wholly masked),
    through sdpa's additive key mask as the DiT hands it in. Each launch
    counts in `key_valid_launches` too; the kernel without its mask must
    fail the limits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, t, d, n = 3, 4, 768, 128, 520
    q, k, v = (torch.randn(b, t, h * d, device="cuda", generator=gen).bfloat16() for _ in range(3))
    qh, kh, vh = (x.view(b, t, h, d).transpose(1, 2) for x in (q, k, v))
    valid = torch.zeros(b, t, dtype=torch.bool, device="cuda")
    valid[:, :n] = True
    additive = ((~valid).float() * -torch.finfo(torch.bfloat16).max).bfloat16()[:, None, None, :]
    before, before_kv = attention.flash_attention.launches, attention.flash_attention.key_valid_launches
    out = attention.sdpa(qh, kh, vh, mask=additive).float()
    assert attention.flash_attention.launches == before + 1
    assert attention.flash_attention.key_valid_launches == before_kv + 1
    ref = attention.flash_attention_plain(qh, kh, vh, kv_valid=valid).float()
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert (out - ref).square().mean().sqrt() <= 1e-2 * ref.square().mean().sqrt()
    unmasked = attention.flash_attention(qh, kh, vh).float()
    assert (unmasked - ref).square().mean().sqrt() > 1e-2 * ref.square().mean().sqrt()
    assert attention.flash_attention.key_valid_launches == before_kv + 1


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
def test_backward_kernel_at_head_dim_64_on_the_av_training_shapes_on_gpu():
    """The fused backward at head dim 64 where audio-video training takes
    it: the audio tokens' self-attention (126 keys, under one 128-key block,
    the second 64-row query tile ragged), audio -> video (many query tiles,
    126 keys), video -> audio (126 queries gathering dQ from many key
    blocks) and the audio text cross-attention with a key mask, against
    autograd of the plain version in fp32, each launch counted by head dim;
    a 64-key tile dropped from dK and dV must fail the limits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    h, d = 4, 64
    for t_q, t_k, n_valid in ((126, 126, None), (1536, 126, None), (126, 1536, None), (126, 1024, 700)):
        q, k, v, do = (torch.randn(1, t, h * d, device="cuda", generator=gen).bfloat16().view(1, t, h, d)
                       .transpose(1, 2) for t in (t_q, t_k, t_k, t_q))
        mask = None
        if n_valid is not None:
            mask = torch.zeros(1, t_k, dtype=torch.bool, device="cuda")
            mask[:, :n_valid] = True
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        ref = torch.autograd.grad(attention.flash_attention_plain(*leaves, None, mask), leaves, do.float())
        before = dict(attention.flash_attention_bwd_kernel.launches_by_head_dim)
        o, l, m = attention.flash_attention_residuals(q, k, v, None, mask)
        grads = attention.flash_attention_bwd(q, k, v, o, l, m, do, None, mask)
        torch.cuda.synchronize()
        assert attention.flash_attention_bwd_kernel.launches_by_head_dim.get(64, 0) == before.get(64, 0) + 1
        for g, r in zip(grads, ref):
            g = g.float()
            assert (g - r).abs().max() <= 2e-2 * r.abs().max(), (t_q, t_k)
            assert (g - r).square().mean().sqrt() <= 1e-2 * r.square().mean().sqrt(), (t_q, t_k)
        dk = grads[1].float().clone()
        dk[:, :, 64:128] = 0
        assert (dk - ref[1]).square().mean().sqrt() > 1e-2 * ref[1].square().mean().sqrt(), (t_q, t_k)


@pytest.mark.gpu
def test_conv_kernel_matches_plain_on_gpu():
    _need_card()
    from ltx2_tpu_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (x shape, Cout, kT, dtype, causal, spatial, temporal, limits relative to the plain output):
    # every bf16 N tile (48, 128, 256), the two-stage decode tile's stage-1
    # res conv and stage-2 upsample conv, the one-stage decode tile's stage-1
    # res conv (15 latent rows), Cin = 16 with Cout = 48, ragged W,
    # a partly filled channel step (Cin = 80), bf16 with zero padding and kT = 1.
    # fp32 (3xTF32): Cin = 1024 with kT = 3 and kT = 1 (K split into 8
    # ranges), Cin = 128 (the upscaler's first conv: 4 ranges, the last
    # ending in phantom steps), tiles enough to fill the card (one range),
    # ragged M and N tiles (Cout = 136) with a partly filled channel step
    # (Cin = 48) and reflect/replicate padding, Cin = 16 with kT = 1.
    cases = [
        ((2, 5, 30, 44, 64), 128, 3, torch.bfloat16, True, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 3, 9, 13, 128), 48, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 8, 16, 16, 1024), 1024, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 15, 32, 32, 512), 2048, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 8, 15, 16, 1024), 1024, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 5, 12, 44, 16), 48, 3, torch.bfloat16, True, "reflect", "replicate", (1e-2, 5e-3)),
        ((2, 3, 5, 6, 80), 136, 3, torch.bfloat16, False, "zeros", "zeros", (1e-2, 5e-3)),
        ((1, 3, 4, 5, 32), 256, 1, torch.bfloat16, False, "zeros", "zeros", (1e-2, 5e-3)),
        ((1, 4, 6, 7, 32), 40, 3, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 3, 5, 6, 48), 64, 1, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 1, 4, 4, 16), 8, 3, torch.bfloat16, False, "reflect", "replicate", (1e-2, 5e-3)),
        ((1, 4, 6, 8, 1024), 64, 3, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 3, 6, 8, 1024), 256, 1, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 16, 8, 12, 128), 1024, 3, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
        ((1, 8, 16, 24, 64), 1024, 3, torch.float32, True, "zeros", "replicate", (1e-4, 1e-4)),
        ((2, 3, 9, 13, 48), 136, 3, torch.float32, False, "reflect", "replicate", (1e-4, 1e-4)),
        ((1, 2, 3, 5, 16), 8, 1, torch.float32, False, "zeros", "zeros", (1e-4, 1e-4)),
    ]
    plans = set()
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
        if dtype == torch.float32:
            # 3xTF32 is held to fp32 accuracy: against float64, rms 2e-6 and
            # max 1e-5 relative (single-pass TF32 errs by about 3e-4).
            ref64 = C.conv3d_plain(x.double(), w.double(), b.double(), causal, sm, tm)
            err = out.double() - ref64
            assert err.square().mean().sqrt() <= 2e-6 * ref64.square().mean().sqrt(), shape
            assert err.abs().max() <= 1e-5 * ref64.abs().max(), shape
            # The split-K partials are summed in a fixed order: bitwise reproducible.
            assert torch.equal(C.conv3d(x, w, b, causal, sm, tm), out)
            plans.add(C.tf32x3_plan(shape[0] * shape[1] * shape[2] * shape[3], cout, shape[-1], kt, sms)[0])
    assert 1 in plans and len(plans) > 1, plans  # one K range and split K both ran
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
    with pytest.raises(ValueError, match="TF32 split"):
        C.conv3d(x, torch.zeros(3, 3, 3, 16, 8, device="cuda"), w_split=torch.zeros(2, 27, 16, 8, device="cuda"))


@pytest.mark.gpu
def test_encoder_conv_shapes_match_plain_on_gpu():
    """The video encoder's four conv shapes of chip_smoke.py (fp32, causal,
    zero spatial and replicate temporal padding): conv_in 48 -> 128, a 512
    res conv, conv_out 1024 -> 129 through the module (its weight padded to
    136 outputs, sliced after), a 1024 res conv over 96 voxels (split K),
    each held to fp32 accuracy against the plain version in float64 (rms
    2e-6, max 1e-5 relative) and launching the kernel once."""
    _need_card()
    from ltx2_tpu_torch.models.video_vae.conv import Conv3d, conv3d_ndhwc
    from ltx2_tpu_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, cout in (((1, 1, 128, 192, 48), 128), ((1, 1, 64, 96, 512), 512), ((1, 1, 16, 24, 1024), 129),
                        ((1, 1, 8, 12, 1024), 1024)):
        p = Conv3d(shape[-1], cout, device="cuda")
        bound = (shape[-1] * 27) ** -0.5
        with torch.no_grad():
            p.weight.uniform_(-bound, bound, generator=gen)
            p.bias.uniform_(-bound, bound, generator=gen)
        x = torch.randn(shape, device="cuda", generator=gen)
        before = C.conv3d_ndhwc_kernel.launches
        out = conv3d_ndhwc(p, x, causal=True, spatial_mode="zeros")
        assert C.conv3d_ndhwc_kernel.launches == before + 1 and out.shape == (*shape[:4], cout)
        ref64 = C.conv3d_plain(x.double(), C.kernel_layout(p.weight.double()), p.bias.double(), True, "zeros",
                               "replicate")
        err = out.double() - ref64
        assert err.square().mean().sqrt() <= 2e-6 * ref64.square().mean().sqrt(), shape
        assert err.abs().max() <= 1e-5 * ref64.abs().max(), shape
    with pytest.raises(ValueError, match="Cout % 8"):  # the kernel itself still refuses 129
        C.conv3d(x, C.kernel_layout(torch.zeros(129, 1024, 3, 3, 3, device="cuda")))


@pytest.mark.gpu
def test_strided_conv_kernel_matches_plain_on_gpu():
    """Both conv kernels at strides (1, 2, 2), (2, 1, 1) and (2, 2, 2) on
    ragged causal shapes (odd T, H and W: the causal front pad of 2 frames
    meets sT = 2 there), reflect and zero padding, against the plain
    version (bf16 max 1e-2 and rms 5e-3 relative, fp32 against float64 rms
    2e-6 and max 1e-5), one launch each, the output (T - 1) // s + 1 long
    on each axis; a stride of 3 raises."""
    _need_card()
    from ltx2_tpu_torch.ops import conv3d as C

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [
        ((1, 9, 17, 23, 64), 64, (2, 2, 2), True, "zeros", "replicate"),
        ((2, 5, 13, 11, 32), 48, (1, 2, 2), True, "reflect", "replicate"),
        ((1, 7, 9, 15, 128), 256, (2, 1, 1), True, "zeros", "replicate"),
        ((1, 4, 6, 7, 48), 136, (2, 2, 2), False, "reflect", "zeros"),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, cout, stride, causal, sm, tm in cases:
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            w = (torch.randn(3, 3, 3, shape[-1], cout, device="cuda", generator=gen) * 0.05).to(dtype)
            b = torch.randn(cout, device="cuda", generator=gen)
            before = C.conv3d_ndhwc_kernel.launches
            out = C.conv3d(x, w, b, causal, sm, tm, stride=stride)
            assert C.conv3d_ndhwc_kernel.launches == before + 1
            want = C.out_shape(shape, cout, stride)
            assert out.shape == want == (shape[0], *((n - 1) // s + 1 for n, s in zip(shape[1:4], stride)), cout)
            if dtype == torch.bfloat16:
                ref = C.conv3d_plain(x, w, b, causal, sm, tm, stride).float()
                err = out.float() - ref
                assert err.abs().max() <= 1e-2 * ref.abs().max(), (shape, stride)
                assert err.square().mean().sqrt() <= 5e-3 * ref.square().mean().sqrt(), (shape, stride)
            else:
                ref64 = C.conv3d_plain(x.double(), w.double(), b.double(), causal, sm, tm, stride)
                err = out.double() - ref64
                assert err.square().mean().sqrt() <= 2e-6 * ref64.square().mean().sqrt(), (shape, stride)
                assert err.abs().max() <= 1e-5 * ref64.abs().max(), (shape, stride)
    with pytest.raises(ValueError, match="stride"):
        C.conv3d(x, w, b, stride=(3, 1, 1))


@pytest.mark.gpu
def test_video_encoder_matches_cpu_on_gpu():
    """The fp32 video encoder at a reduced plan with every stride kind (64-
    and 128-wide, 33 latent channels: conv_out's 34 outputs padded to 40) on
    the card against the same weights on the CPU, one 128x192 frame, within
    relative rms 1e-5 and max 1e-4 (models/video_vae/card_check.py, which
    chip_smoke.py runs at the published plan)."""
    _need_card()
    from ltx2_tpu_torch.generate import make_encoder
    from ltx2_tpu_torch.models.video_vae.card_check import encoder_against_cpu
    from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoderConfig

    plan = (("res", 64, 1, None), ("down", 64, 64, (1, 2, 2)), ("res", 64, 1, None), ("down", 64, 128, (2, 1, 1)),
            ("res", 128, 1, None), ("down", 128, 128, (2, 2, 2)), ("res", 128, 1, None),
            ("down", 128, 128, (2, 2, 2)), ("res", 128, 1, None))
    enc = make_encoder(torch.device("cuda"), cfg=VideoEncoderConfig(plan=plan, latent_channels=33))
    pixels = torch.rand(1, 3, 1, 128, 192, generator=torch.Generator().manual_seed(4)) * 2 - 1
    rec = encoder_against_cpu(enc, pixels)
    assert rec["latent_shape"] == [1, 33, 1, 4, 6] and rec["launches"] == rec["expected_launches"] == 16
    assert rec["ok"], rec["errors"]


@pytest.mark.gpu
def test_sdpa_raises_on_head_dims_the_kernels_do_not_take_on_gpu():
    """bf16 attention without a query-dependent mask goes to the kernels at
    any head dim; on the card they refuse D outside {64, 128} and nothing
    takes over."""
    _need_card()
    for d in (32, 256):
        q = torch.zeros(1, 2, 128, d, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            attention.sdpa(q, q, q)
        with pytest.raises(ValueError, match="head dim"):
            attention.sdpa(q, q, q, mask=torch.zeros(1, 1, 1, 128, device="cuda"))


@pytest.mark.gpu
def test_text_encoder_matches_cpu_on_gpu():
    """A 2-layer, full-width Gemma-3 and the V1 encoder on the card against
    the same weights on the CPU, every state and the encoding within
    relative rms 1e-5 and max 1e-4 (ltx2_tpu_torch/models/text_encoder/
    card_check.py, which chip_smoke.py runs too; its run on an NVIDIA H100
    80GB HBM3 at 700 W measured the states within 1.2e-7 rms and 2.1e-7 max,
    the encoding 1.3e-6 rms and 4.6e-6 max)."""
    _need_card()
    from ltx2_tpu_torch.models.text_encoder.card_check import encoder_against_cpu

    rec = encoder_against_cpu("cuda")
    assert rec["encoding_shape"] == rec["reference_shape"] == [2, 1024, 3840]  # registers up to 1024 tokens
    assert rec["ok"], rec["errors"]


@pytest.mark.gpu
def test_text_encoder_matches_cpu_on_gpu_fp8():
    """The same check with Gemma's matmul weights kept in fp8 on both
    devices (the same codes: the quantization is exact arithmetic), at the
    same limits."""
    _need_card()
    from ltx2_tpu_torch.models.text_encoder.card_check import encoder_against_cpu

    rec = encoder_against_cpu("cuda", fp8=True)
    assert rec["fp8"] and rec["ok"], rec["errors"]


@pytest.mark.gpu
def test_fp8_block_loaded_onto_the_card(tmp_path):
    """A full-width block written in the reference `-fp8` layout and loaded
    kept in fp8 onto the card keeps float8_e4m3fn weights (no bf16 copy),
    and its linears give on the card what the same file gives on the CPU."""
    _need_card()
    from ltx2_tpu_torch.generate import make_dit
    from ltx2_tpu_torch.loader.export import iter_fp8_checkpoint_specs
    from ltx2_tpu_torch.loader.safetensors_io import write_safetensors_streaming
    from ltx2_tpu_torch.loader.weight_loader import load_transformer_params
    from ltx2_tpu_torch.ops.common import linear

    torch.backends.cuda.matmul.allow_tf32 = False
    path = str(tmp_path / "block-fp8.safetensors")
    dit = make_dit(1, torch.device("cuda"), seed=1, fp8=True)
    write_safetensors_streaming(path, iter_fp8_checkpoint_specs(dit),
                                metadata={"config": '{"num_attention_heads": 32}'})
    del dit
    card = load_transformer_params(path, keep_fp8=True, device="cuda")
    cpu = load_transformer_params(path, keep_fp8=True, device="cpu")
    block, block_cpu = card.transformer_blocks[0], cpu.transformer_blocks[0]
    for name, lin in (("attn1.to_q", block.attn1.to_q), ("ff.project_in.proj", block.ff.project_in.proj)):
        assert lin.weight.dtype == torch.float8_e4m3fn and lin.weight.is_cuda, name
        ref = block_cpu.get_submodule(name)
        assert torch.equal(lin.weight.cpu().view(torch.uint8), ref.weight.view(torch.uint8))
        x = torch.randn(2, 64, lin.weight.shape[1], generator=torch.Generator().manual_seed(2)).bfloat16()
        out, want = linear(lin, x.cuda()).float().cpu(), linear(ref, x).float()
        # bf16 products summed in another order: a bf16 rounding of the output.
        assert (out - want).abs().max() <= 1e-2 * want.abs().max(), name


@pytest.mark.gpu
def test_v2_forward_through_the_kernels_matches_plain_on_gpu(monkeypatch):
    """Two full-width LTX-2.3 (V2) blocks in bf16 (cross-attention AdaLN
    with random tables, prompt-modulated text K/V, gated attention) at
    384 tokens: x0 through the flash kernel (2 launches a block) against
    the same forward on the plain attention, within 2e-2 of max|x0| (the
    kernel's bf16 P and O rounding through two blocks)."""
    _need_card()
    from ltx2_tpu_torch.generate import make_dit, make_latent_tools, make_request
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig, x0_model_apply
    from ltx2_tpu_torch.pipelines.common import modality_from_state

    dev = torch.device("cuda")
    dit = make_dit(2, dev, seed=3, base=LTXModelConfig(cross_attention_adaln=True, apply_gated_attention=True))
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    tools = make_latent_tools(dit.cfg, 256, 384, 25)
    state, context = make_request(dit.cfg, tools, 1, dev)
    video = modality_from_state(state, context, torch.tensor([0.7], device=dev), uniform_timesteps=True)
    before = attention.flash_attention.launches
    with torch.no_grad():
        out = x0_model_apply(dit, video)
    assert attention.flash_attention.launches - before == 4
    plain = attention.flash_attention_plain
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, scale=None, kv_valid=None: plain(q, k, v, scale, kv_valid))
    with torch.no_grad():
        ref = x0_model_apply(dit, video)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.gpu
def test_audio_decoder_and_vocoders_match_cpu_on_gpu():
    _need_card()
    from ltx2_tpu_torch.models.audio_vae.card_check import audio_against_cpu

    rec = audio_against_cpu()
    assert rec["ok"], rec


@pytest.mark.gpu
def test_av_forward_through_the_kernels_matches_plain_on_gpu(monkeypatch):
    """Two full-width audio-video blocks in bf16 (32 x 128 video, 32 x 64
    audio heads; random AdaLN and cross-modal tables) at 384 video and 26
    audio tokens: both x0 outputs through the flash kernel (6 launches a
    block: 4 at head dim 64) against the same forward on the plain
    attention, within 2e-2 of max|x0|."""
    _need_card()
    from ltx2_tpu_torch.generate import av_config, make_dit, make_latent_tools, make_request
    from ltx2_tpu_torch.models.transformer.model import x0_model_apply
    from ltx2_tpu_torch.pipelines.common import modality_from_state
    from ltx2_tpu_torch.pipelines.distilled import AudioFields
    from ltx2_tpu_torch.types import VideoPixelShape

    dev = torch.device("cuda")
    dit = make_dit(2, dev, seed=5, base=av_config())
    gen = torch.Generator(device=dev).manual_seed(6)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    tools = make_latent_tools(dit.cfg, 256, 384, 25)
    state, context = make_request(dit.cfg, tools, 1, dev)
    audio_tools = AudioFields().audio_tools(VideoPixelShape(1, 25, 256, 384, 24.0))
    audio_state = audio_tools.create_initial_state(device=dev)
    audio_state = audio_state.replace(latent=torch.randn(audio_state.latent.shape, generator=gen, device=dev))
    audio_context = torch.randn(1, 64, dit.cfg.audio_inner_dim, generator=gen, device=dev) * 0.5
    sigma = torch.tensor([0.7], device=dev)
    video = modality_from_state(state, context, sigma, uniform_timesteps=True)
    audio = modality_from_state(audio_state, audio_context, sigma, uniform_timesteps=True)
    before = dict(attention.flash_attention.launches_by_head_dim)
    with torch.no_grad():
        out = x0_model_apply(dit, video, audio=audio)
    launched = {d: n - before.get(d, 0) for d, n in attention.flash_attention.launches_by_head_dim.items()}
    assert launched == {64: 8, 128: 4}
    plain = attention.flash_attention_plain
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, scale=None, kv_valid=None: plain(q, k, v, scale, kv_valid))
    with torch.no_grad():
        ref = x0_model_apply(dit, video, audio=audio)
    for got, want in zip(out, ref):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 2e-2 * want.abs().max()


@pytest.mark.gpu
def test_multimodal_loop_through_the_kernels_matches_plain_on_gpu(monkeypatch):
    """The two-stage CFG pipeline's stage-1 loop (cond, uncond and
    modality-isolated rows: the flash kernel at batch 3) over two full-width
    audio-video blocks in bf16 at 384 video and 26 audio tokens, 2 steps:
    both latents through the kernels against the same loop on the plain
    attention, within 2e-2 of max|latent|."""
    _need_card()
    from ltx2_tpu_torch.components.schedulers import LTX2Scheduler
    from ltx2_tpu_torch.generate import av_config, dummy_context, make_dit, make_latent_tools, make_request
    from ltx2_tpu_torch.pipelines.denoise import MultiModalLoopConfig, make_multimodal_av_denoise_loop
    from ltx2_tpu_torch.pipelines.distilled import AudioFields
    from ltx2_tpu_torch.types import VideoPixelShape

    dev = torch.device("cuda")
    dit = make_dit(2, dev, seed=7, base=av_config())
    gen = torch.Generator(device=dev).manual_seed(8)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    tools = make_latent_tools(dit.cfg, 256, 384, 25)
    state, positive = make_request(dit.cfg, tools, 1, dev)
    negative = dummy_context(dit.cfg, gen, dev)
    audio_tools = AudioFields().audio_tools(VideoPixelShape(1, 25, 256, 384, 24.0))
    audio_state = audio_tools.create_initial_state(device=dev)
    audio_state = audio_state.replace(latent=torch.randn(audio_state.latent.shape, generator=gen, device=dev))
    audio_ctx = [dummy_context(dit.cfg, gen, dev, audio=True) * 25 for _ in range(2)]
    loop = make_multimodal_av_denoise_loop(dit.cfg, MultiModalLoopConfig(rescale_scale=0.7))
    sigmas = torch.from_numpy(LTX2Scheduler().execute(steps=2))
    before = dict(attention.flash_attention.launches_by_batch)
    out = loop(dit, state, audio_state, sigmas, positive, negative, *audio_ctx)
    launched = {b: n - before.get(b, 0) for b, n in attention.flash_attention.launches_by_batch.items()}
    assert launched == {3: 6 * 2 * 2}
    plain = attention.flash_attention_plain
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, scale=None, kv_valid=None: plain(q, k, v, scale, kv_valid))
    ref = loop(dit, state, audio_state, sigmas, positive, negative, *audio_ctx)
    for got, want in zip(out, ref):
        assert torch.isfinite(got.latent).all()
        assert (got.latent.float() - want.latent.float()).abs().max() <= 2e-2 * want.latent.float().abs().max()


@pytest.mark.gpu
def test_audio_encoder_matches_cpu_on_gpu():
    """The published audio VAE encoder (random weights, fp32, TF32 off) and
    its mel analysis on the card against the same on the CPU: relative rms
    1e-5 of the latent of a 1 s stereo waveform."""
    _need_card()
    from ltx2_tpu_torch.generate import make_audio_encoder
    from ltx2_tpu_torch.models.audio_vae.analysis import AudioAnalysisConfig, waveform_to_latent

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = make_audio_encoder(torch.device("cuda"))
    cpu = make_audio_encoder(torch.device("cpu"))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    wave = torch.randn(2, 16000, generator=torch.Generator().manual_seed(9)) * 0.3
    got = waveform_to_latent(wave, card, AudioAnalysisConfig(), 25).cpu()
    want = waveform_to_latent(wave, cpu, AudioAnalysisConfig(), 25)
    assert got.shape == (1, 8, 25, 16) and torch.isfinite(got).all()
    assert (got - want).square().mean().sqrt() <= 1e-5 * want.square().mean().sqrt()


@pytest.mark.gpu
def test_int_mm_route_matches_the_plain_int32_route_on_gpu():
    """torch._int_mm (the int8 W8A8 product on the card) bit for bit the
    plain int32 route on the same codes, at the DiT's widths (4096 and
    16384) and the audio stream's 126 tokens; a shape outside its contract
    raises and names itself, nothing falls back."""
    _need_card()
    from ltx2_tpu_torch.loader.int8 import quantize_tensor_int8, set_int8_weight_
    from ltx2_tpu_torch.ops.common import (
        Linear, int8_matmul, int8_matmul_plain, linear, quantize_activations_int8, w8a8_matmul,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, k, n in ((6144, 4096, 4096), (126, 2048, 8192), (1024, 16384, 4096)):
        x = torch.randn(rows, k, device="cuda", generator=gen).bfloat16()
        w_q, cscale = quantize_tensor_int8(torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5)
        x_q, xscale = quantize_activations_int8(x)
        assert torch.equal(int8_matmul(x_q, w_q), int8_matmul_plain(x_q, w_q)), (rows, k, n)
        y = w8a8_matmul(x, w_q, cscale)
        ref = (int8_matmul_plain(x_q, w_q).float() * xscale * cscale).bfloat16()
        assert y.dtype == torch.bfloat16 and torch.equal(y, ref)
    for rows, k, n in ((16, 4096, 4096), (64, 4100, 4096), (64, 4096, 4100)):
        with pytest.raises(ValueError, match="_int_mm"):
            int8_matmul(torch.zeros(rows, k, dtype=torch.int8, device="cuda"),
                        torch.zeros(n, k, dtype=torch.int8, device="cuda"))
    lin = set_int8_weight_(Linear(w_q.shape[1], w_q.shape[0], bias=False, device="cuda"), w_q, cscale)
    assert torch.equal(linear(lin, x), y)


@pytest.mark.gpu
def test_temporal_upscaler_matches_cpu_on_gpu():
    """The temporal upscaler at a reduced width (hidden 64, 1 + 1 blocks,
    8 groups) on the card against the CPU, through the fp32 conv kernel."""
    _need_card()
    from ltx2_tpu_torch.models.upscaler.card_check import temporal_upscaler_against_cpu
    from ltx2_tpu_torch.models.upscaler.temporal import (
        TemporalUpscaler, TemporalUpscalerConfig, init_temporal_upscaler_,
    )

    cfg = TemporalUpscalerConfig(hidden_channels=64, num_res_blocks=1, num_groups=8)
    up = init_temporal_upscaler_(TemporalUpscaler(cfg, device="cuda"), torch.Generator(device="cuda").manual_seed(1))
    latent = torch.randn(1, 128, 3, 4, 6, generator=torch.Generator().manual_seed(2))
    rec = temporal_upscaler_against_cpu(up, latent)
    assert rec["ok"] and rec["out_shape"] == [1, 128, 5, 4, 6], rec
