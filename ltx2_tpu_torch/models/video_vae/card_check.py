"""The fp32 video VAE encoder on the card against the same weights on the CPU.

On the card every conv runs the fp32 conv kernel (3xTF32 on the tensor
cores, conv_out on its weight padded to a multiple of 8 outputs); on the CPU
the plain version in fp32. The normalized latents are held to a relative rms
of 1e-5 and a relative max of 1e-4, the text encoder's card check limits.
chip_smoke.py runs it at the full plan, the `gpu`-marked tests at a reduced
one:

    from ltx2_tpu_torch.models.video_vae.card_check import encoder_against_cpu
    rec = encoder_against_cpu(encoder, pixels)   # rec["ok"], rec["errors"]
"""

from __future__ import annotations

import time

import torch

from ltx2_tpu_torch.models.text_encoder.card_check import relative_error
from ltx2_tpu_torch.models.video_vae.encoder import VideoEncoder, conv_launches, video_encoder_apply
from ltx2_tpu_torch.ops.conv3d import conv3d_ndhwc_kernel

RMS_REL_LIMIT = 1e-5
MAX_REL_LIMIT = 1e-4


def encoder_against_cpu(encoder: VideoEncoder, pixels: torch.Tensor) -> dict:
    """Encodes (1, 3, F, H, W) `pixels` with `encoder` on its device and
    with a CPU copy of its weights; returns the latent's shape, the errors,
    finiteness, the kernel launches of the device's encode (the conv count
    of the plan where the device is a card), the CPU's seconds, the limits
    and "ok"."""
    device = next(encoder.parameters()).device
    cpu = VideoEncoder(encoder.cfg, device="cpu")
    cpu.load_state_dict(encoder.state_dict())
    with torch.no_grad():
        before = conv3d_ndhwc_kernel.launches
        out = video_encoder_apply(encoder, pixels.to(device))
        launches = conv3d_ndhwc_kernel.launches - before
        t0 = time.perf_counter()
        ref = video_encoder_apply(cpu, pixels.cpu())
        cpu_s = time.perf_counter() - t0
    errors = relative_error(out, ref)
    finite = bool(torch.isfinite(out).all())
    want = conv_launches(encoder.cfg) if device.type == "cuda" else 0
    return {"pixels": list(pixels.shape), "latent_shape": list(out.shape), "errors": errors, "finite": finite,
            "launches": launches, "expected_launches": want, "cpu_s": cpu_s, "tol_rms_rel": RMS_REL_LIMIT,
            "tol_max_rel": MAX_REL_LIMIT,
            "ok": finite and launches == want and errors["rms_rel"] <= RMS_REL_LIMIT
            and errors["max_rel"] <= MAX_REL_LIMIT}
