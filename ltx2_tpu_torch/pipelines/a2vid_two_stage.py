"""Audio-to-video, two stages (counterpart of
ltx2_tpu/pipelines/a2vid_two_stage.py).

An audio file drives the video: its waveform is loaded at
`audio_sample_rate` (16 kHz), analysed into the VAE's 64-mel stereo
spectrogram and encoded by the audio VAE encoder into the audio latent,
which stays frozen (denoise mask 0, clean latent == latent: the Euler
update is exactly 0) through both stages of the distilled recipe while the
video denoises against it through the audio<->video attentions. Without an
encoder the noised initial audio latent is frozen instead, as in the
reference. With `audio_enabled` the output audio is the source waveform at
its own rate, not a decode of the latent.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import wave
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.models.audio_vae.analysis import AudioAnalysisConfig, waveform_to_latent
from ltx2_tpu_torch.models.audio_vae.encoder import AudioEncoder
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline
from ltx2_tpu_torch.types import AudioLatentShape, VideoPixelShape


@dataclass
class A2VidConfig(DistilledConfig):
    """The JAX package's A2VidConfig: the distilled config and the source."""

    audio_path: str = ""
    audio_start_time: float = 0.0


def _read_wave(path: str) -> Tuple[np.ndarray, int]:
    """A 16-bit PCM .wav by the stdlib: ((N, channels) float32 / 32768,
    rate). Other sample widths raise wave.Error (ffmpeg converts them)."""
    with wave.open(path, "r") as wf:
        if wf.getsampwidth() != 2:
            raise wave.Error(f"{wf.getsampwidth() * 8}-bit PCM needs ffmpeg")
        raw = np.frombuffer(wf.readframes(wf.getnframes()), dtype=np.int16)
        return (raw.astype(np.float32) / 32768.0).reshape(-1, wf.getnchannels()), wf.getframerate()


def load_audio_file(audio_path: str, target_sr: int = 16000, start_time: float = 0.0,
                    max_duration: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """An audio file -> ((channels, samples) float32, target_sr). The
    readers, in order: the PCM track of an .avi/.mov/.mp4/.m4v container
    (utils/video_io; an AVI without one raises), `soundfile` if it imports
    and decodes the file, the stdlib `wave` for 16-bit PCM, else ffmpeg
    (converting to a 16-bit stereo .wav at target_sr). Cut from
    `start_time` for `max_duration` seconds, then resampled to target_sr by
    picking samples at truncated `linspace` indices (no interpolation), as
    the reference does."""
    suffix = audio_path.lower().rsplit(".", 1)[-1] if "." in audio_path else ""
    pcm_out = None
    if suffix in ("avi", "mov", "mp4", "m4v"):
        from ltx2_tpu_torch.utils.video_io import read_avi_audio, read_mov_audio

        pcm_out = (read_avi_audio if suffix == "avi" else read_mov_audio)(audio_path)
        if pcm_out is None and suffix == "avi":
            raise ValueError(f"{audio_path}: no PCM audio stream")
    if pcm_out is not None:
        pcm, sr = pcm_out
        data = pcm.T
    else:
        try:
            import soundfile as sf

            data, sr = sf.read(audio_path)
        except Exception:  # not installed, or its libsndfile cannot decode this file
            try:
                data, sr = _read_wave(audio_path)
            except (wave.Error, EOFError):
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
                    pass
                try:
                    subprocess.run(["ffmpeg", "-v", "quiet", "-i", audio_path, "-ar", str(target_sr), "-ac", "2",
                                    "-y", tmp.name], check=True)
                    data, sr = _read_wave(tmp.name)
                finally:
                    os.unlink(tmp.name)
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if data.shape[0] > data.shape[1]:
        data = data.T
    data = data[:, int(start_time * sr):]
    if max_duration is not None:
        data = data[:, :int(max_duration * sr)]
    if sr != target_sr:
        indices = np.linspace(0, data.shape[1] - 1, int(data.shape[1] * target_sr / sr)).astype(int)
        data = data[:, indices]
        sr = target_sr
    return data.astype(np.float32), sr


class A2VidPipelineTwoStage(DistilledPipeline):
    """The distilled two-stage recipe driven by a source waveform."""

    def __init__(self, *args, audio_encoder: Optional[AudioEncoder] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.audio_encoder = audio_encoder
        # Per stage of the last call that was handed a latent to freeze:
        # whether its audio latent came out bit for bit as it went in.
        self.frozen_by_stage: List[bool] = []

    def _run_stage(self, *args, initial_audio_latent=None, freeze_audio: bool = False, **kwargs):
        latent, audio_latent = super()._run_stage(*args, initial_audio_latent=initial_audio_latent,
                                                  freeze_audio=freeze_audio, **kwargs)
        if freeze_audio and initial_audio_latent is not None and audio_latent is not None:
            self.frozen_by_stage.append(bool(torch.equal(audio_latent, initial_audio_latent)))
        return latent, audio_latent

    def _encode_audio_to_latent(self, waveform: np.ndarray, sr: int, config: A2VidConfig
                                ) -> Optional[torch.Tensor]:
        """Waveform -> the (1, z, L, mel_bins) latent to freeze, L the
        clip's audio latent frames (64-mel analysis, `waveform_to_latent`);
        None without an encoder."""
        if self.audio_encoder is None:
            return None
        shape = AudioLatentShape.from_video_pixel_shape(
            VideoPixelShape(batch=1, frames=config.num_frames, height=config.height, width=config.width,
                            fps=config.fps),
            channels=config.audio_vae_channels, mel_bins=config.audio_mel_bins,
            sample_rate=config.audio_sample_rate, hop_length=config.audio_hop_length,
            audio_latent_downsample_factor=config.audio_downsample_factor)
        analysis = AudioAnalysisConfig(sample_rate=sr, hop_length=config.audio_hop_length,
                                       n_mels=config.audio_mel_bins * config.audio_downsample_factor)
        return waveform_to_latent(waveform, self.audio_encoder, analysis, shape.frames)

    def __call__(  # type: ignore[override]
        self,
        text_encoding: torch.Tensor,
        config: A2VidConfig,
        images=None,
        callback: Optional[Callable[[str, torch.Tensor], None]] = None,
        audio_encoding=None,
        source_waveform: Optional[np.ndarray] = None,
        skip_decode: bool = False,
        noises=None,
        audio_noises=None,
    ):
        """As DistilledPipeline.__call__ with the audio frozen: the latent
        encoded from `source_waveform` ((channels, samples) at
        `config.audio_sample_rate`), else from `config.audio_path` (its
        first num_frames / fps seconds from `audio_start_time`). With
        `config.audio_enabled` returns (frames or latent, the (1, channels,
        samples) source waveform, its rate), or (frames or latent, the
        decoded audio or latent, None) when there is no source. A callback's
        "audio_encode" phase gets the encoded latent; `frozen_by_stage`
        then says, per stage, whether the audio latent came out unchanged
        (stage 1 from the encoded latent, stage 2 from stage 1's)."""
        self.frozen_by_stage = []
        if source_waveform is None and config.audio_path:
            source_waveform, _ = load_audio_file(config.audio_path, target_sr=config.audio_sample_rate,
                                                 start_time=config.audio_start_time,
                                                 max_duration=config.num_frames / config.fps)
        initial_audio_latent = None
        if source_waveform is not None:
            initial_audio_latent = self._encode_audio_to_latent(source_waveform, config.audio_sample_rate, config)
            if initial_audio_latent is not None and callback:
                callback("audio_encode", initial_audio_latent)
        result = super().__call__(text_encoding, config, images=images, callback=callback,
                                  audio_encoding=audio_encoding, skip_decode=skip_decode, freeze_audio=True,
                                  initial_audio_latent=initial_audio_latent, noises=noises,
                                  audio_noises=audio_noises)
        if not config.audio_enabled:
            return result
        video, generated = result
        if source_waveform is not None:
            return video, np.asarray(source_waveform, np.float32)[None], int(config.audio_sample_rate)
        return video, generated, None


def create_a2vid_pipeline(**kwargs) -> A2VidPipelineTwoStage:
    return A2VidPipelineTwoStage(**kwargs)
