"""Waveform -> log-mel analysis for the audio VAE encoder (counterpart of
ltx2_tpu/models/audio_vae/analysis.py), the a2vid pipeline's way in.

The analysis is built here, not read from a checkpoint (the checkpoint
holds bases only for the vocoder's 128-mel BWE re-analysis): the windowed
DFT basis of `make_stft_basis` and a Slaney-normalized triangular mel
filterbank on the Slaney mel scale (librosa's default), built in float64
numpy and cast to float32, both through `mel_spectrogram`. Each channel's
log-mel (stereo; mono is duplicated) is padded at its edge or cut to
4 L - 3 frames, the causal decoder's frame count for L latent frames, so
the encoder's two stride-2 causal convs give exactly L, then encoded.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ltx2_tpu_torch.models.audio_vae.vocoder import MelSTFT, MelSTFTConfig, mel_spectrogram


@dataclass(frozen=True)
class AudioAnalysisConfig:
    """The VAE's 64-mel stereo spectrogram space (the decoder's output
    (B, 2, T, 64); this is its inverse direction)."""

    sample_rate: int = 16000
    filter_length: int = 1024
    win_length: int = 1024
    hop_length: int = 160
    n_mels: int = 64

    def mel_cfg(self) -> MelSTFTConfig:
        return MelSTFTConfig(filter_length=self.filter_length, hop_length=self.hop_length,
                             win_length=self.win_length, n_mel_channels=self.n_mels)


_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    mel = f / _F_SP
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_HZ / _F_SP + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP, mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    min_log_mel = _MIN_LOG_HZ / _F_SP
    return np.where(m >= min_log_mel, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - min_log_mel)), m * _F_SP)


def make_mel_basis(sample_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) Slaney-normalized triangular filterbank,
    float64 math, float32 out."""
    if fmax is None:
        fmax = sample_rate / 2
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_freqs), np.float64)
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]  # Slaney area normalization
    return weights.astype(np.float32)


def make_analysis_params(cfg: AudioAnalysisConfig, device=None) -> MelSTFT:
    """The analysis' buffers (`stft_fn.forward_basis`, `mel_basis`) for
    `mel_spectrogram`, on `device`."""
    return MelSTFT(cfg.mel_cfg(), make_mel_basis(cfg.sample_rate, cfg.filter_length, cfg.n_mels), device=device)


@lru_cache(maxsize=4)
def _analysis_params(cfg: AudioAnalysisConfig, device: torch.device) -> MelSTFT:
    return make_analysis_params(cfg, device)


@torch.no_grad()
def waveform_to_latent(waveform, encoder, analysis_cfg: AudioAnalysisConfig, target_latent_frames: int
                       ) -> torch.Tensor:
    """(channels, samples) waveform (numpy or a tensor) -> the normalized
    audio latent (1, z, target_latent_frames, mel_bins), fp32 on the
    encoder's device: each channel's log-mel (mono duplicated to the
    encoder's two channels) as (1, C, T_mel, n_mels), T_mel padded at its
    edge or cut to 4 L - 3, then `audio_encoder_apply`."""
    from ltx2_tpu_torch.models.audio_vae.encoder import audio_encoder_apply

    device = encoder.conv_in.weight.device
    wav = torch.as_tensor(waveform, dtype=torch.float32, device=device)
    if wav.ndim == 1:
        wav = wav[None]
    if wav.shape[0] == 1 and encoder.cfg.in_ch == 2:
        wav = wav.repeat(2, 1)
    log_mel = mel_spectrogram(_analysis_params(analysis_cfg, device), analysis_cfg.mel_cfg(), wav)
    spec = log_mel.transpose(1, 2)[None]  # (1, C, T_mel, n_mels)
    t_target = 4 * target_latent_frames - 3
    t_mel = spec.shape[2]
    if t_mel < t_target:
        spec = F.pad(spec, (0, 0, 0, t_target - t_mel), mode="replicate")
    elif t_mel > t_target:
        spec = spec[:, :, :t_target]
    return audio_encoder_apply(encoder, spec)
