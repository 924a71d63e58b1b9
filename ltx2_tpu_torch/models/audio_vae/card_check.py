"""The fp32 audio decoder and vocoders on the card against the same weights
on the CPU.

The published audio decoder (`AudioDecoderConfig()`), LTX-2's vocoder
(`VocoderConfig()`: HiFi-GAN, 1024 channels in) and an LTX-2.3-shaped BWE
chain (`LTX23_VOCODER`: the AMP1 vocoder and a 512-channel BWE generator
upsampling 480x, 2048-point re-analysis at hop 240, 128 mels), random
weights, on a (1, 8, FRAMES, 16) latent, TF32 off: the log-mel and both
waveforms are held to a relative rms of 1e-5, as the text and video
encoders are held. chip_smoke.py and the `gpu`-marked tests run it:

    from ltx2_tpu_torch.models.audio_vae.card_check import audio_against_cpu
    rec = audio_against_cpu()   # rec["ok"], rec["errors"]
"""

from __future__ import annotations

import time

import torch

from ltx2_tpu_torch.models.audio_vae.decoder import (
    AudioDecoder, AudioDecoderConfig, audio_decoder_apply, init_audio_decoder_,
)
from ltx2_tpu_torch.models.audio_vae.vocoder import (
    Vocoder, VocoderConfig, VocoderWithBWE, init_vocoder_, vocoder_apply, vocoder_with_bwe_apply,
    vocoder_with_bwe_config_from_checkpoint,
)
from ltx2_tpu_torch.models.text_encoder.card_check import relative_error

RMS_REL_LIMIT = 1e-5
FRAMES = 16  # 61 mel frames, 14640 samples at 24 kHz
# An LTX-2.3 checkpoint's `vocoder` metadata, as far as its shapes go: the
# BWE generator's rates multiply to (48000 / 24000) x hop 240.
LTX23_VOCODER = {
    "vocoder": {"resblock": "AMP1"},
    "bwe": {"upsample_rates": [6, 5, 4, 2, 2], "upsample_kernel_sizes": [12, 11, 8, 4, 4],
            "upsample_initial_channel": 512, "num_mels": 128, "n_fft": 2048, "hop_length": 240,
            "input_sampling_rate": 24000, "output_sampling_rate": 48000},
}


def _on_cpu(module: torch.nn.Module, make) -> torch.nn.Module:
    cpu = make("cpu")
    cpu.load_state_dict(module.state_dict())
    return cpu


def audio_against_cpu(device="cuda", seed: int = 9) -> dict:
    """Runs the check on `device`; returns the shapes, each output's
    errors, finiteness, the CPU's seconds, the limit and "ok"."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bwe_cfg = vocoder_with_bwe_config_from_checkpoint(LTX23_VOCODER)
    makers = {"decoder": lambda d: AudioDecoder(AudioDecoderConfig(), device=d),
              "vocoder": lambda d: Vocoder(VocoderConfig(), device=d),
              "bwe": lambda d: VocoderWithBWE(bwe_cfg, device=d)}
    gens = [torch.Generator(device=device).manual_seed(seed + i) for i in range(3)]
    modules = {"decoder": init_audio_decoder_(makers["decoder"](device), gens[0]),
               "vocoder": init_vocoder_(makers["vocoder"](device), gens[1]),
               "bwe": init_vocoder_(makers["bwe"](device), gens[2])}
    cpu = {name: _on_cpu(m, makers[name]) for name, m in modules.items()}
    latent = torch.randn(1, 8, FRAMES, 16, generator=torch.Generator().manual_seed(seed + 3))

    def run(mods, z):
        mel = audio_decoder_apply(mods["decoder"], z)
        return {"mel": mel, "waveform": vocoder_apply(mods["vocoder"], mel),
                "waveform_bwe": vocoder_with_bwe_apply(mods["bwe"], mel)}

    with torch.no_grad():
        out = run(modules, latent.to(device))
        t0 = time.perf_counter()
        ref = run(cpu, latent)
        cpu_s = time.perf_counter() - t0
    errors = {k: relative_error(out[k], ref[k]) for k in out}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    within = all(e["rms_rel"] <= RMS_REL_LIMIT for e in errors.values())
    return {"latent": list(latent.shape), "shapes": {k: list(v.shape) for k, v in out.items()}, "errors": errors,
            "finite": finite, "cpu_s": cpu_s, "tol_rms_rel": RMS_REL_LIMIT, "ok": finite and within}
