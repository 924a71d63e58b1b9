"""HiFi-GAN / BigVGAN-v2 vocoder and LTX-2.3's bandwidth extension
(counterpart of ltx2_tpu/models/audio_vae/vocoder.py).

`vocoder_apply`: stereo mel (B, 2, T, 64) stacked to 128 channels ->
conv_pre -> per upsample stage a transposed conv (rates 6, 5, 2, 2, 2 by
default: 240 samples a mel frame) and the mean of three multi-receptive-
field res blocks (kernels 3, 7, 11): `resblock="1"` HiFi-GAN blocks with
leaky ReLU, `"AMP1"` BigVGAN-v2 blocks whose SnakeBeta activation runs
anti-aliased (kaiser-windowed sinc 2x up, SnakeBeta, low-pass 2x down) ->
the last activation -> conv_post -> tanh. `vocoder_with_bwe_apply` (LTX-2.3):
the vocoder at 24 kHz, the waveform padded to a hop multiple and
re-analysed into a log-mel (STFT as a strided conv with the checkpoint's
DFT basis, the mel basis), a second generator's residual on it, plus the
waveform resampled 2x with a hann-windowed sinc -> 48 kHz, clipped to +-1.

fp32 throughout, with `F.conv1d` / `F.conv_transpose1d`: the JAX package
runs these convs with `lax.conv_general_dilated` at HIGHEST precision,
outside any Pallas kernel, so the caller turns TF32 off on the card. The
checkpoint's transposed-conv weights are (in, out, k), the layout
`F.conv_transpose1d` takes as it is (the JAX package flips them for its
lhs-dilated conv, which computes the same). The filters' math (kaiser and
hann sinc, the STFT basis) is the port's own copy of the JAX package's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass filter, (1, 1, K) float32 (BigVGAN-v2's
    anti-aliasing design constants)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    amplitude = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if amplitude > 50.0:
        beta = 0.1102 * (amplitude - 8.7)
    elif amplitude >= 21.0:
        beta = 0.5842 * (amplitude - 21) ** 0.4 + 0.07886 * (amplitude - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = np.arange(-half_size, half_size) + 0.5 if even else np.arange(kernel_size) - half_size
    if cutoff == 0:
        filter_ = np.zeros_like(time)
    else:
        x = 2 * cutoff * time
        safe_denom = np.where(x == 0, 1.0, np.pi * x)
        sinc = np.where(x == 0, 1.0, np.sin(np.pi * x) / safe_denom)
        filter_ = 2 * cutoff * window * sinc
        filter_ /= filter_.sum()
    return filter_.reshape(1, 1, kernel_size).astype(np.float32)


def hann_sinc_filter1d(ratio: int) -> Tuple[np.ndarray, int, int, int]:
    """Hann-windowed sinc of a torchaudio-style resample by `ratio`:
    (filter (1, 1, K), K, pad_left, pad_right)."""
    rolloff, lowpass_filter_width = 0.99, 6
    width = math.ceil(lowpass_filter_width / rolloff)
    kernel_size = 2 * width * ratio + 1
    time_axis = np.arange(kernel_size) / ratio - width
    t_roll = time_axis * rolloff
    t_clamped = np.clip(t_roll, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t_clamped * math.pi / lowpass_filter_width / 2) ** 2
    safe_denom = np.where(t_roll == 0, 1.0, np.pi * t_roll)
    sinc_vals = np.where(t_roll == 0, 1.0, np.sin(np.pi * t_roll) / safe_denom)
    filt = (sinc_vals * window * rolloff / ratio).reshape(1, 1, -1).astype(np.float32)
    return filt, kernel_size, 2 * width * ratio, kernel_size - ratio


@dataclass(frozen=True)
class ResamplerSpec:
    """The geometry of an anti-aliased 1D upsample."""

    ratio: int
    kernel_size: int
    pad: int
    pad_left: int
    pad_right: int

    @staticmethod
    def kaiser(ratio: int, kernel_size: Optional[int] = None) -> "ResamplerSpec":
        k = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        pad = k // ratio - 1
        return ResamplerSpec(ratio=ratio, kernel_size=k, pad=pad, pad_left=pad * ratio + (k - ratio) // 2,
                             pad_right=pad * ratio + (k - ratio + 1) // 2)

    @staticmethod
    def hann(ratio: int) -> "ResamplerSpec":
        _, k, pad_left, pad_right = hann_sinc_filter1d(ratio)
        return ResamplerSpec(ratio=ratio, kernel_size=k, pad=math.ceil(6 / 0.99), pad_left=pad_left,
                             pad_right=pad_right)


def make_stft_basis(filter_length: int, win_length: int) -> np.ndarray:
    """(2 n_freqs, 1, filter_length) periodic-hann-windowed DFT rows, real
    then imaginary (torch-stft's forward basis; a shorter window centred)."""
    if win_length > filter_length:
        raise ValueError(f"win_length ({win_length}) > filter_length ({filter_length})")
    fourier = np.fft.fft(np.eye(filter_length))
    cutoff = filter_length // 2 + 1
    basis = np.vstack([np.real(fourier[:cutoff]), np.imag(fourier[:cutoff])])
    n = np.arange(win_length)
    hann = 0.5 - 0.5 * np.cos(2 * math.pi * n / win_length)
    if win_length < filter_length:
        pad = (filter_length - win_length) // 2
        hann = np.pad(hann, (pad, filter_length - win_length - pad))
    return (basis * hann)[:, None, :].astype(np.float32)


@dataclass(frozen=True)
class VocoderConfig:
    """The vocoder's architecture: LTX-2's defaults; a checkpoint's
    metadata overrides them."""

    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    upsample_rates: Tuple[int, ...] = (6, 5, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 15, 8, 4, 4)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_initial_channel: int = 1024
    stereo: bool = True
    output_sample_rate: int = 24000
    resblock: str = "1"  # "1" (HiFi-GAN) | "AMP1" (BigVGAN v2)
    activation: str = "snakebeta"
    apply_final_activation: bool = True
    use_tanh_at_final: bool = True
    in_channels_override: Optional[int] = None  # the BWE generator's re-analysis mel width

    @property
    def is_amp(self) -> bool:
        return self.resblock == "AMP1"

    @property
    def num_kernels(self) -> int:
        return len(self.resblock_kernel_sizes)

    @property
    def in_channels(self) -> int:
        if self.in_channels_override is not None:
            return self.in_channels_override
        return 128 if self.stereo else 64


@dataclass(frozen=True)
class MelSTFTConfig:
    filter_length: int = 2048
    hop_length: int = 240
    win_length: int = 2048
    n_mel_channels: int = 128


@dataclass(frozen=True)
class VocoderWithBWEConfig:
    """LTX-2.3's chain: the vocoder, the mel re-analysis and the BWE generator."""

    vocoder: VocoderConfig = field(default_factory=lambda: VocoderConfig(resblock="AMP1"))
    bwe: VocoderConfig = field(default_factory=lambda: VocoderConfig(
        resblock="AMP1", upsample_rates=(2,), upsample_kernel_sizes=(4,), upsample_initial_channel=256,
        output_sample_rate=48000, apply_final_activation=False))
    mel_stft: MelSTFTConfig = MelSTFTConfig()
    input_sampling_rate: int = 24000
    output_sampling_rate: int = 48000
    hop_length: int = 240

    @property
    def output_sample_rate(self) -> int:
        return self.output_sampling_rate


def vocoder_with_bwe_config_from_checkpoint(vocoder_cfg: dict) -> VocoderWithBWEConfig:
    """The chain's config from a checkpoint's `vocoder` metadata (its
    `vocoder` and `bwe` dicts over the defaults), as the JAX package reads
    it."""
    inner_cfg = vocoder_cfg.get("vocoder", {}) or {}
    bwe_cfg = vocoder_cfg.get("bwe", {}) or {}

    def tups(v):
        return tuple(tuple(x) for x in v)

    def stage(cfg: dict, resblock_default: str, **kw) -> dict:
        return dict(
            resblock_kernel_sizes=tuple(cfg.get("resblock_kernel_sizes", (3, 7, 11))),
            resblock_dilation_sizes=tups(cfg.get("resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5), (1, 3, 5)))),
            resblock=cfg.get("resblock", resblock_default), activation=cfg.get("activation", "snakebeta"),
            use_tanh_at_final=cfg.get("use_tanh_at_final", True), **kw)

    inner = VocoderConfig(**stage(
        inner_cfg, "AMP1", upsample_rates=tuple(inner_cfg.get("upsample_rates", (6, 5, 2, 2, 2))),
        upsample_kernel_sizes=tuple(inner_cfg.get("upsample_kernel_sizes", (16, 15, 8, 4, 4))),
        upsample_initial_channel=inner_cfg.get("upsample_initial_channel", 1024),
        output_sample_rate=bwe_cfg.get("input_sampling_rate", 24000)))
    bwe = VocoderConfig(**stage(
        bwe_cfg, "AMP1", upsample_rates=tuple(bwe_cfg.get("upsample_rates", (2,))),
        upsample_kernel_sizes=tuple(bwe_cfg.get("upsample_kernel_sizes", (4,))),
        upsample_initial_channel=bwe_cfg.get("upsample_initial_channel", 256),
        output_sample_rate=bwe_cfg.get("output_sampling_rate", 48000), apply_final_activation=False,
        in_channels_override=(2 if inner.stereo else 1) * bwe_cfg.get("num_mels", 128)))
    mel = MelSTFTConfig(filter_length=bwe_cfg.get("n_fft", 2048), hop_length=bwe_cfg.get("hop_length", 240),
                        win_length=bwe_cfg.get("n_fft", 2048), n_mel_channels=bwe_cfg.get("num_mels", 128))
    return VocoderWithBWEConfig(
        vocoder=inner, bwe=bwe, mel_stft=mel, input_sampling_rate=bwe_cfg.get("input_sampling_rate", 24000),
        output_sampling_rate=bwe_cfg.get("output_sampling_rate", 48000), hop_length=bwe_cfg.get("hop_length", 240))


class Conv1d(nn.Module):
    """A conv's weight ((out, in, k), or a transposed conv's (in, out, k))
    and bias, fp32."""

    def __init__(self, shape: Tuple[int, int, int], out_c: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(out_c, device=device), requires_grad=False)


class ConvTranspose1d(Conv1d):
    """A transposed conv: weight (in, out, k)."""


class _Filter(nn.Module):
    def __init__(self, filt: np.ndarray, *, device=None):
        super().__init__()
        self.register_buffer("filter", torch.from_numpy(filt).to(device))


class Activation1d(nn.Module):
    """SnakeBeta's alpha and beta (`act`) and the anti-aliasing filters
    (`upsample.filter`, `downsample.filter`), the defaults unless a
    checkpoint holds its own."""

    def __init__(self, channels: int, up_kernel: int = 12, down_kernel: int = 12, *, device=None):
        super().__init__()
        self.act = nn.Module()
        self.act.alpha = nn.Parameter(torch.zeros(channels, device=device), requires_grad=False)
        self.act.beta = nn.Parameter(torch.zeros(channels, device=device), requires_grad=False)
        spec = ResamplerSpec.kaiser(2, up_kernel)
        self.upsample = _Filter(kaiser_sinc_filter1d(0.5 / spec.ratio, 0.6 / spec.ratio, spec.kernel_size),
                                device=device)
        self.downsample = _Filter(kaiser_sinc_filter1d(0.25, 0.3, down_kernel), device=device)


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations, amp: bool, *, device=None):
        super().__init__()
        n = len(dilations)
        shape = (channels, channels, kernel_size)
        self.convs1 = nn.ModuleList(Conv1d(shape, channels, device=device) for _ in range(n))
        self.convs2 = nn.ModuleList(Conv1d(shape, channels, device=device) for _ in range(n))
        if amp:
            self.acts1 = nn.ModuleList(Activation1d(channels, device=device) for _ in range(n))
            self.acts2 = nn.ModuleList(Activation1d(channels, device=device) for _ in range(n))


class Vocoder(nn.Module):
    """One generator's parameters, named as in the checkpoint."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig(), *, device=None):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d((c0, cfg.in_channels, 7), c0, device=device)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, k in enumerate(cfg.upsample_kernel_sizes):
            in_c, out_c = c0 // 2 ** i, c0 // 2 ** (i + 1)
            self.ups.append(ConvTranspose1d((in_c, out_c, k), out_c, device=device))
            for rk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(out_c, rk, dil, cfg.is_amp, device=device))
        final = c0 // 2 ** len(cfg.upsample_rates)
        if cfg.is_amp:
            self.act_post = Activation1d(final, device=device)
        self.conv_post = Conv1d((2 if cfg.stereo else 1, final, 7), 2 if cfg.stereo else 1, device=device)


class VocoderWithBWE(nn.Module):
    """LTX-2.3's chain: `vocoder`, `bwe_generator` and `mel_stft`
    (`stft_fn.forward_basis`, `mel_basis`)."""

    def __init__(self, cfg: VocoderWithBWEConfig = VocoderWithBWEConfig(), *, device=None):
        super().__init__()
        self.cfg = cfg
        n_ch = 2 if cfg.vocoder.stereo else 1
        bwe_cfg = cfg.bwe
        if bwe_cfg.in_channels_override is None:
            bwe_cfg = replace(bwe_cfg, in_channels_override=n_ch * cfg.mel_stft.n_mel_channels)
        self.vocoder = Vocoder(cfg.vocoder, device=device)
        self.bwe_generator = Vocoder(bwe_cfg, device=device)
        m = cfg.mel_stft
        self.mel_stft = nn.Module()
        self.mel_stft.stft_fn = nn.Module()
        self.mel_stft.stft_fn.register_buffer(
            "forward_basis", torch.from_numpy(make_stft_basis(m.filter_length, m.win_length)).to(device))
        self.mel_stft.register_buffer("mel_basis", torch.zeros(m.n_mel_channels, m.filter_length // 2 + 1,
                                                               device=device))


@torch.no_grad()
def init_vocoder_(vocoder: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights in place: each conv U(+-1/sqrt(in k)) (a transposed
    conv's in = its first axis), weight and bias, as the JAX package's
    init_vocoder draws them; SnakeBeta's alpha and beta stay 0, the filters
    and the STFT basis their defaults; a BWE chain's mel basis U(0,
    1/n_freqs)."""
    for m in vocoder.modules():
        if isinstance(m, Conv1d):
            w = m.weight
            fan_in = w.shape[0 if isinstance(m, ConvTranspose1d) else 1] * w.shape[2]
            bound = 1.0 / fan_in ** 0.5
            for p in (m.weight, m.bias):
                p.copy_(torch.rand(p.shape, generator=generator, device=p.device) * 2 * bound - bound)
    if isinstance(vocoder, VocoderWithBWE):
        basis = vocoder.mel_stft.mel_basis
        basis.copy_(torch.rand(basis.shape, generator=generator, device=basis.device) / basis.shape[1])
    return vocoder


def _replicate_pad(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(x, (left, right), mode="replicate")


def _depthwise(filt: torch.Tensor, channels: int) -> torch.Tensor:
    return filt.reshape(1, 1, -1).expand(channels, 1, -1)


def upsample1d(x: torch.Tensor, filt: torch.Tensor, spec: ResamplerSpec) -> torch.Tensor:
    """Anti-aliased upsample by spec.ratio: replicate padding, a depthwise
    transposed conv with the filter, x ratio, trimmed."""
    c = x.shape[1]
    x = _replicate_pad(x, spec.pad, spec.pad)
    x = spec.ratio * F.conv_transpose1d(x, _depthwise(filt, c), stride=spec.ratio, groups=c)
    return x[:, :, spec.pad_left:x.shape[2] - spec.pad_right]


def lowpass1d(x: torch.Tensor, filt: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Low-pass with replicate padding, a depthwise conv at `stride`."""
    k = filt.shape[-1]
    x = _replicate_pad(x, k // 2 - int(k % 2 == 0), k // 2)
    return F.conv1d(x, _depthwise(filt, x.shape[1]), stride=stride, groups=x.shape[1])


def snake_beta(act: nn.Module, x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x + 1 / (exp(beta) + eps) * sin(x exp(alpha))^2."""
    alpha = torch.exp(act.alpha)[None, :, None]
    beta = torch.exp(act.beta)[None, :, None]
    return x + (1.0 / (beta + eps)) * torch.sin(x * alpha).square()


def activation1d(p: Activation1d, x: torch.Tensor) -> torch.Tensor:
    """Up 2x, SnakeBeta, low-pass and down 2x."""
    x = upsample1d(x, p.upsample.filter, ResamplerSpec.kaiser(2, p.upsample.filter.shape[-1]))
    return lowpass1d(snake_beta(p.act, x), p.downsample.filter, stride=2)


def _conv(p: Conv1d, x: torch.Tensor, padding: int = 0, dilation: int = 1, stride: int = 1) -> torch.Tensor:
    return F.conv1d(x, p.weight, p.bias, stride=stride, padding=padding, dilation=dilation)


def _res_block(p: ResBlock, x: torch.Tensor, kernel_size: int, dilations, amp: bool) -> torch.Tensor:
    for i, d in enumerate(dilations):
        xt = activation1d(p.acts1[i], x) if amp else F.leaky_relu(x, LRELU_SLOPE)
        xt = _conv(p.convs1[i], xt, padding=(kernel_size - 1) * d // 2, dilation=d)
        xt = activation1d(p.acts2[i], xt) if amp else F.leaky_relu(xt, LRELU_SLOPE)
        xt = _conv(p.convs2[i], xt, padding=(kernel_size - 1) // 2)
        x = x + xt
    return x


@torch.no_grad()
def vocoder_apply(vocoder: Vocoder, mel: torch.Tensor) -> torch.Tensor:
    """Mel (B, S, T, M) -> waveform (B, 2 or 1, T x prod(upsample_rates)), fp32."""
    cfg = vocoder.cfg
    x = mel.float().permute(0, 1, 3, 2)
    b, s, m, t = x.shape
    x = _conv(vocoder.conv_pre, x.reshape(b, s * m, t), padding=3)
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        if not cfg.is_amp:
            x = F.leaky_relu(x, LRELU_SLOPE)
        up = vocoder.ups[i]
        x = F.conv_transpose1d(x, up.weight, up.bias, stride=rate, padding=(k - rate) // 2)
        outs = [_res_block(vocoder.resblocks[i * cfg.num_kernels + j], x, rk, dil, cfg.is_amp)
                for j, (rk, dil) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))]
        x = torch.stack(outs).mean(dim=0)
    x = activation1d(vocoder.act_post, x) if cfg.is_amp else F.leaky_relu(x, 0.01)
    x = _conv(vocoder.conv_post, x, padding=3)
    if cfg.apply_final_activation:
        x = torch.tanh(x) if cfg.use_tanh_at_final else x.clamp(-1, 1)
    return x


def mel_spectrogram(chain: VocoderWithBWE, y: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform -> log-mel (B, n_mel, frames): STFT magnitude by a
    strided conv with the DFT basis (left padding win - hop), the mel
    basis, log of max(mel, 1e-5)."""
    cfg = chain.cfg.mel_stft
    y = F.pad(y[:, None, :], (max(0, cfg.win_length - cfg.hop_length), 0))
    spec = F.conv1d(y, chain.mel_stft.stft_fn.forward_basis, stride=cfg.hop_length)
    n_freqs = spec.shape[1] // 2
    magnitude = torch.sqrt(spec[:, :n_freqs] ** 2 + spec[:, n_freqs:] ** 2)
    mel = torch.einsum("mf,bft->bmt", chain.mel_stft.mel_basis, magnitude)
    return torch.log(mel.clamp_min(1e-5))


@lru_cache(maxsize=8)
def _hann_filter(ratio: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hann_sinc_filter1d(ratio)[0]).to(device)


@torch.no_grad()
def vocoder_with_bwe_apply(chain: VocoderWithBWE, mel: torch.Tensor) -> torch.Tensor:
    """Mel (B, 2, T, 64) -> 48 kHz waveform (B, 2, 2 x T x hop) in [-1, 1],
    fp32: the vocoder, the re-analysis, the BWE residual plus the 2x
    hann-resampled skip."""
    cfg = chain.cfg
    x = vocoder_apply(chain.vocoder, mel)
    length = x.shape[2]
    output_length = length * cfg.output_sampling_rate // cfg.input_sampling_rate
    if length % cfg.hop_length:
        x = F.pad(x, (0, cfg.hop_length - length % cfg.hop_length))
    b, n_ch, t = x.shape
    log_mel = mel_spectrogram(chain, x.reshape(b * n_ch, t))
    log_mel = log_mel.reshape(b, n_ch, log_mel.shape[1], log_mel.shape[2]).permute(0, 1, 3, 2)
    residual = vocoder_apply(chain.bwe_generator, log_mel)
    ratio = cfg.output_sampling_rate // cfg.input_sampling_rate
    skip = upsample1d(x, _hann_filter(ratio, x.device), ResamplerSpec.hann(ratio))
    n = min(residual.shape[2], skip.shape[2])
    return (residual[:, :, :n] + skip[:, :, :n]).clamp(-1, 1)[:, :, :output_length]
