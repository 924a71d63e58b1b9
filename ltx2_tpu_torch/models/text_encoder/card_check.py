"""The fp32 text encoder on the card against the same weights on the CPU.

A 2-layer, full-width Gemma-3 (a sliding layer, window 16, then a full one)
and the V1 encoder over its 3 states, 2 x 64 tokens left-padded to lengths
64 and 23, TF32 off: every Gemma state and the encoding are held to a
relative rms of 1e-5 and a relative max of 1e-4. With `fp8` both copies
first get the fp8 Gemma of `load_gemma3_params(quantize_fp8=True)`
(`quantize_gemma_fp8_`: the same codes on both devices), held to the same
limits. chip_smoke.py and the `gpu`-marked tests run it:

    from ltx2_tpu_torch.models.text_encoder.card_check import encoder_against_cpu
    rec = encoder_against_cpu()   # rec["ok"], rec["errors"]
"""

from __future__ import annotations

import time

import torch

from ltx2_tpu_torch.models.text_encoder.encoder import (
    TextEncoderConfig, VideoTextEncoder, init_text_encoder_, video_text_encoder_apply,
)
from ltx2_tpu_torch.models.text_encoder.gemma3 import (
    Gemma3, Gemma3Config, gemma3_apply, init_gemma3_, quantize_gemma_fp8_,
)

RMS_REL_LIMIT = 1e-5
MAX_REL_LIMIT = 1e-4
TOKENS = 64
LENGTHS = (64, 23)


def relative_error(x: torch.Tensor, ref: torch.Tensor) -> dict:
    """rms(x - ref) / rms(ref) and max|x - ref| / max|ref|, in float64 on
    ref's device."""
    err = x.detach().to(ref.device).double() - ref.double()
    return {"rms_rel": (err.square().mean().sqrt() / ref.double().square().mean().sqrt()).item(),
            "max_rel": (err.abs().max() / ref.double().abs().max()).item()}


def encoder_against_cpu(device="cuda", seed: int = 7, fp8: bool = False) -> dict:
    """Runs the check on `device`; returns the token shape and lengths, the
    encoding's shape, each state's and the encoding's errors, finiteness,
    the CPU's seconds, the limits and "ok". Weights come from `seed` (Gemma)
    and seed + 1 (encoder), the token ids from seed + 2; with `fp8` Gemma's
    matmul weights are quantized on each device."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Gemma3Config(num_hidden_layers=2, sliding_window=16, layer_types=("sliding_attention", "full_attention"))
    te_cfg = TextEncoderConfig(num_gemma_layers=cfg.num_hidden_layers + 1)
    gemma = init_gemma3_(Gemma3(cfg, device=device), torch.Generator(device=device).manual_seed(seed))
    enc = init_text_encoder_(VideoTextEncoder(te_cfg, device=device),
                             torch.Generator(device=device).manual_seed(seed + 1))
    gemma_cpu, enc_cpu = Gemma3(cfg, device="cpu"), VideoTextEncoder(te_cfg, device="cpu")
    gemma_cpu.load_state_dict(gemma.state_dict())
    enc_cpu.load_state_dict(enc.state_dict())
    if fp8:
        quantize_gemma_fp8_(gemma)
        quantize_gemma_fp8_(gemma_cpu)

    gen = torch.Generator().manual_seed(seed + 2)
    ids = torch.randint(3, cfg.vocab_size, (len(LENGTHS), TOKENS), generator=gen)
    mask = torch.zeros(len(LENGTHS), TOKENS, dtype=torch.long)
    for row, n in enumerate(LENGTHS):
        mask[row, TOKENS - n:] = 1
    ids[mask == 0] = 0

    with torch.no_grad():
        _, hidden = gemma3_apply(gemma, ids.to(device), mask.to(device))
        out = video_text_encoder_apply(enc, hidden, mask.to(device)).video_encoding
        t0 = time.perf_counter()
        _, hidden_ref = gemma3_apply(gemma_cpu, ids, mask)
        ref = video_text_encoder_apply(enc_cpu, hidden_ref, mask).video_encoding
        cpu_s = time.perf_counter() - t0
    errors = {f"state_{i}": relative_error(hidden[i], hidden_ref[i]) for i in range(hidden.shape[0])}
    errors["encoding"] = relative_error(out, ref)
    finite = bool(torch.isfinite(out).all() and torch.isfinite(hidden).all())
    within = all(e["rms_rel"] <= RMS_REL_LIMIT and e["max_rel"] <= MAX_REL_LIMIT for e in errors.values())
    return {"fp8": fp8, "tokens": [len(LENGTHS), TOKENS], "lengths": list(LENGTHS), "encoding_shape": list(out.shape),
            "reference_shape": list(ref.shape), "errors": errors, "finite": finite, "cpu_s": cpu_s,
            "tol_rms_rel": RMS_REL_LIMIT, "tol_max_rel": MAX_REL_LIMIT, "ok": finite and within}
