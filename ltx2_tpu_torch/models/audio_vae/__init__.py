"""The audio VAE decoder and encoder, the encoder's mel analysis and the
vocoder (with LTX-2.3's bandwidth extension)."""

from ltx2_tpu_torch.models.audio_vae.analysis import (
    AudioAnalysisConfig, make_analysis_params, make_mel_basis, waveform_to_latent,
)
from ltx2_tpu_torch.models.audio_vae.decoder import (
    AudioDecoder, AudioDecoderConfig, audio_decoder_apply, causal_conv2d, denormalize_audio_latent,
    init_audio_decoder_,
)
from ltx2_tpu_torch.models.audio_vae.encoder import (
    AudioEncoder, AudioEncoderConfig, audio_encoder_apply, init_audio_encoder_, normalize_audio_latent,
)
from ltx2_tpu_torch.models.audio_vae.vocoder import (
    MelSTFT, MelSTFTConfig, Vocoder, VocoderConfig, VocoderWithBWE, VocoderWithBWEConfig, init_vocoder_,
    kaiser_sinc_filter1d, mel_spectrogram, snake_beta, vocoder_apply, vocoder_with_bwe_apply,
    vocoder_with_bwe_config_from_checkpoint,
)

__all__ = [
    "AudioAnalysisConfig", "make_analysis_params", "make_mel_basis", "waveform_to_latent",
    "AudioEncoder", "AudioEncoderConfig", "audio_encoder_apply", "init_audio_encoder_", "normalize_audio_latent",
    "MelSTFT",
    "AudioDecoder", "AudioDecoderConfig", "audio_decoder_apply", "causal_conv2d", "denormalize_audio_latent",
    "init_audio_decoder_",
    "MelSTFTConfig", "Vocoder", "VocoderConfig", "VocoderWithBWE", "VocoderWithBWEConfig", "init_vocoder_",
    "kaiser_sinc_filter1d", "mel_spectrogram", "snake_beta", "vocoder_apply", "vocoder_with_bwe_apply",
    "vocoder_with_bwe_config_from_checkpoint",
]
