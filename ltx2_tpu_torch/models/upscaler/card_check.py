"""The fp32 temporal upscaler on the card against the same weights on the
CPU.

On the card every conv runs the fp32 conv kernel (3xTF32 on the tensor
cores); on the CPU the plain version in fp32. The upscaled latents are held
to a relative rms of 1e-5 and a relative max of 1e-4, the video encoder's
card check limits. chip_smoke.py runs it at full width on a 512x768x121
latent, the `gpu`-marked tests on a reduced one:

    from ltx2_tpu_torch.models.upscaler.card_check import temporal_upscaler_against_cpu
    rec = temporal_upscaler_against_cpu(upscaler, latent)   # rec["ok"], rec["errors"]
"""

from __future__ import annotations

import time

import torch

from ltx2_tpu_torch.models.text_encoder.card_check import relative_error
from ltx2_tpu_torch.models.upscaler.temporal import TemporalUpscaler, conv_launches, temporal_upscaler_apply
from ltx2_tpu_torch.models.video_vae.card_check import MAX_REL_LIMIT, RMS_REL_LIMIT
from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel


def temporal_upscaler_against_cpu(upscaler: TemporalUpscaler, latent: torch.Tensor) -> dict:
    """Upscales the (B, C, F, H, W) `latent` with `upscaler` on its device
    and with a CPU copy of its weights; returns the output's shape, the
    errors, finiteness, the kernel launches of the device's call (19 at the
    published config on a card), the CPU's seconds, the limits and "ok"."""
    device = next(upscaler.parameters()).device
    cpu = TemporalUpscaler(upscaler.cfg, device="cpu")
    cpu.load_state_dict(upscaler.state_dict())
    with torch.no_grad():
        before = conv3d_ndhwc_kernel.launches
        out = temporal_upscaler_apply(upscaler, latent.to(device))
        launches = conv3d_ndhwc_kernel.launches - before
        t0 = time.perf_counter()
        ref = temporal_upscaler_apply(cpu, latent.cpu())
        cpu_s = time.perf_counter() - t0
    errors = relative_error(out, ref)
    finite = bool(torch.isfinite(out).all())
    want = conv_launches(upscaler.cfg) if device.type == "cuda" else 0
    return {"latent": list(latent.shape), "out_shape": list(out.shape), "errors": errors, "finite": finite,
            "launches": launches, "expected_launches": want, "cpu_s": cpu_s, "tol_rms_rel": RMS_REL_LIMIT,
            "tol_max_rel": MAX_REL_LIMIT,
            "ok": finite and launches == want and errors["rms_rel"] <= RMS_REL_LIMIT
            and errors["max_rel"] <= MAX_REL_LIMIT}
