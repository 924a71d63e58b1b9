"""The port's audio VAE decoder and vocoder (ltx2_tpu_torch/models/audio_vae/)
against ltx2_tpu's on the same numpy-drawn weights, in float32 on the CPU.

Tolerance: 1e-5 relative rms (rms(port - JAX) / rms(JAX)), the fp32 convs
summing in different orders and nothing else; the waveform's .wav bytes are
held exactly."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models import audio_vae as jaudio
from ltx2_tpu_torch.loader.from_numpy import audio_decoder_from_numpy, vocoder_from_numpy
from ltx2_tpu_torch.models import audio_vae
from tests.torch_port_util import random_tree
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

TOL_RMS_REL = 1e-5

# Small decoder: 3 levels (two 2x upsamples), 1 res block each, 16 -> 8 -> 8 channels.
DEC = dict(ch=8, ch_mult=(1, 1, 2), num_res_blocks=1, z_channels=4, mel_bins=4)
# A vocoder with one upsample stage (x4), two kernels, 16 channels.
VOC = dict(resblock_kernel_sizes=(3, 5), upsample_rates=(4,), upsample_kernel_sizes=(8,),
           resblock_dilation_sizes=((1, 3), (1,)), upsample_initial_channel=16, stereo=True)


def _rms_rel(port, ref) -> float:
    a = port.detach().cpu().numpy().astype(np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree(v) for v in tree]
    return jnp.asarray(tree)


def test_audio_decoder_matches_jax():
    cfg = audio_vae.AudioDecoderConfig(**DEC)
    tree = random_tree(audio_vae.AudioDecoder(cfg, device="meta"), 1)
    port = audio_decoder_from_numpy(tree, cfg)
    z = np.random.default_rng(2).standard_normal((1, 4, 6, 4)).astype(np.float32)
    ref = jaudio.audio_decoder_apply(jax_tree(tree), jaudio.AudioDecoderConfig(**DEC), jnp.asarray(z))
    out = audio_vae.audio_decoder_apply(port, torch.from_numpy(z))
    assert tuple(out.shape) == (1, 2, 4 * 6 - 3, 16)
    assert _rms_rel(out, ref) <= TOL_RMS_REL


@pytest.mark.parametrize("resblock", ["1", "AMP1"])
def test_vocoder_matches_jax(resblock):
    cfg = audio_vae.VocoderConfig(resblock=resblock, **VOC)
    tree = random_tree(audio_vae.Vocoder(cfg, device="meta"), 3)
    port = vocoder_from_numpy(tree, cfg)
    mel = np.random.default_rng(4).standard_normal((1, 2, 9, 64)).astype(np.float32)
    ref = jaudio.vocoder_apply(jax_tree(tree), jaudio.VocoderConfig(resblock=resblock, **VOC), jnp.asarray(mel))
    out = audio_vae.vocoder_apply(port, torch.from_numpy(mel))
    assert tuple(out.shape) == (1, 2, 9 * 4)
    assert _rms_rel(out, ref) <= TOL_RMS_REL


def _bwe_configs(package):
    inner = package.VocoderConfig(resblock="AMP1", **{**VOC, "upsample_rates": (4, 2), "upsample_kernel_sizes": (8, 4),
                                                      "upsample_initial_channel": 32})
    bwe = package.VocoderConfig(resblock="AMP1", upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                                upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                                resblock_dilation_sizes=((1, 3),), output_sample_rate=48000,
                                apply_final_activation=False, in_channels_override=2 * 16)
    mel = package.MelSTFTConfig(filter_length=32, hop_length=8, win_length=32, n_mel_channels=16)
    return package.VocoderWithBWEConfig(vocoder=inner, bwe=bwe, mel_stft=mel, hop_length=8)


def test_vocoder_with_bwe_matches_jax():
    """The BWE chain at a small size: vocoder x8 at "24 kHz", re-analysis
    (32-point STFT, hop 8, 16 mels), a x16 BWE generator and the 2x
    hann-resampled skip."""
    cfg = _bwe_configs(audio_vae)
    tree = random_tree(audio_vae.VocoderWithBWE(cfg, device="meta"), 5)
    # The STFT basis and the kaiser filters as the modules hold them by default.
    defaults = audio_vae.VocoderWithBWE(cfg)
    tree["mel_stft"]["stft_fn"]["forward_basis"] = defaults.mel_stft.stft_fn.forward_basis.numpy()
    tree["mel_stft"]["mel_basis"] = np.abs(tree["mel_stft"]["mel_basis"])
    port = vocoder_from_numpy(tree, cfg)
    mel = np.random.default_rng(6).standard_normal((1, 2, 7, 64)).astype(np.float32)
    ref = jaudio.vocoder_with_bwe_apply(jax_tree(tree), _bwe_configs(jaudio), jnp.asarray(mel))
    out = audio_vae.vocoder_with_bwe_apply(port, torch.from_numpy(mel))
    assert tuple(out.shape) == (1, 2, 7 * 8 * 2)
    assert _rms_rel(out, ref) <= TOL_RMS_REL


def test_filters_and_bwe_config_match_jax():
    for args in ((0.25, 0.3, 12), (0.5 / 2, 0.6 / 2, 12), (0.1, 0.2, 7)):
        np.testing.assert_array_equal(audio_vae.kaiser_sinc_filter1d(*args), jaudio.kaiser_sinc_filter1d(*args))
    from ltx2_tpu.models.audio_vae import vocoder as jvoc
    from ltx2_tpu_torch.models.audio_vae import vocoder as pvoc

    np.testing.assert_array_equal(pvoc.hann_sinc_filter1d(2)[0], jvoc.hann_sinc_filter1d(2)[0])
    np.testing.assert_array_equal(pvoc.make_stft_basis(64, 48), jvoc.make_stft_basis(64, 48))
    meta = {"vocoder": {"upsample_rates": [5, 4, 3, 2, 2], "resblock": "AMP1"},
            "bwe": {"upsample_rates": [6, 5, 4, 2], "num_mels": 96, "n_fft": 1024, "hop_length": 120}}
    port, ref = (m.vocoder_with_bwe_config_from_checkpoint(meta) for m in (audio_vae, jaudio))
    assert str(port) .replace("ltx2_tpu_torch.models.audio_vae.vocoder.", "") == \
        str(ref).replace("ltx2_tpu.models.audio_vae.vocoder.", "")
