"""The audio VAE decoder and the vocoder (with LTX-2.3's bandwidth extension)."""

from ltx2_tpu_torch.models.audio_vae.decoder import (
    AudioDecoder, AudioDecoderConfig, audio_decoder_apply, causal_conv2d, denormalize_audio_latent,
    init_audio_decoder_,
)
from ltx2_tpu_torch.models.audio_vae.vocoder import (
    MelSTFTConfig, Vocoder, VocoderConfig, VocoderWithBWE, VocoderWithBWEConfig, init_vocoder_,
    kaiser_sinc_filter1d, mel_spectrogram, snake_beta, vocoder_apply, vocoder_with_bwe_apply,
    vocoder_with_bwe_config_from_checkpoint,
)

__all__ = [
    "AudioDecoder", "AudioDecoderConfig", "audio_decoder_apply", "causal_conv2d", "denormalize_audio_latent",
    "init_audio_decoder_",
    "MelSTFTConfig", "Vocoder", "VocoderConfig", "VocoderWithBWE", "VocoderWithBWEConfig", "init_vocoder_",
    "kaiser_sinc_filter1d", "mel_spectrogram", "snake_beta", "vocoder_apply", "vocoder_with_bwe_apply",
    "vocoder_with_bwe_config_from_checkpoint",
]
