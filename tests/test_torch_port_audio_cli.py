"""Audio files out, and audio-video checkpoints in, on the CPU:

- `ltx2_tpu_torch.utils.video_io.write_wav` against the JAX CLI's
  `_write_wav`, byte for byte (clipping, x 32767, truncation toward zero);
- `python -m ltx2_tpu_torch.generate --pipeline distilled|one-stage|
  text-to-video --audio --output x.y4m` from a tiny V1 audio-video file
  written here: the .y4m and an x.wav of 2 channels at 24000 Hz whose bytes
  are the JAX writer's of the returned waveform;
- a tiny V2 file whose metadata declares `vocoder.bwe`: the BWE chain, a
  48000 Hz .wav of twice the vocoder's samples;
- both files load in both packages (the DiT with its audio stream, the
  audio decoder, the vocoder or the BWE chain), every tensor bit for bit;
- refusals: `--audio` on bench-e2e, and on a video-only file.
"""

import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

from ltx2_tpu.loader import weight_loader as jwl
from ltx2_tpu.models import audio_vae as jaudio
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.export import iter_checkpoint_specs
from ltx2_tpu_torch.loader.from_numpy import flatten_tree
from ltx2_tpu_torch.loader.safetensors_io import write_safetensors, write_safetensors_streaming
from ltx2_tpu_torch.models import audio_vae
from ltx2_tpu_torch.models.audio_vae import weights as audio_weights
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelType, init_ltx_model_
from ltx2_tpu_torch.models.upscaler import spatial
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig, init_video_decoder_
from ltx2_tpu_torch.utils import video_io
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import CFG, assert_bitwise, jax_leaves, port_leaves

BLOCKS = [["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}]]
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                          decoder_blocks=vae_weights.normalize_decoder_blocks(BLOCKS))
UPCFG = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
# The audio stream at the CLI's latent geometry (8 channels x 16 mel bins =
# 128 in and out), 2 heads x 16; a small audio decoder (-> 64 mel bins,
# stereo: the vocoder's 128 channels in); one-stage x4 vocoders.
AV = dataclasses.replace(CFG, model_type=LTXModelType.AudioVideo, audio_heads=2, audio_head_dim=16)
ADEC = audio_vae.AudioDecoderConfig(ch=8, ch_mult=(1, 1, 2), num_res_blocks=1)
VOC = {"upsample_rates": [4], "upsample_kernel_sizes": [8], "resblock_kernel_sizes": [3],
       "resblock_dilation_sizes": [[1, 3]], "upsample_initial_channel": 16}
BWE = {"vocoder": {**VOC, "resblock": "AMP1"},
       "bwe": {"upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8], "resblock_kernel_sizes": [3],
               "resblock_dilation_sizes": [[1, 3]], "upsample_initial_channel": 16, "num_mels": 16, "n_fft": 32,
               "hop_length": 8, "input_sampling_rate": 24000, "output_sampling_rate": 48000}}
H = W = 64
FRAMES = 9  # 9 audio latent frames at 24 fps: 33 mel frames, 132 samples at 24 kHz


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _voc_cfg(meta):
    if "bwe" in meta:
        return audio_vae.vocoder_with_bwe_config_from_checkpoint(meta)
    return audio_vae.VocoderConfig(**{k: _tuples(v) for k, v in meta.items()})


def _write(path, version: str, gen) -> dict:
    v2 = version == "v2"
    cfg = dataclasses.replace(AV, cross_attention_adaln=v2, apply_gated_attention=v2)
    dit = init_ltx_model_(LTXModel(cfg), gen)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    meta_voc = BWE if v2 else VOC
    voc = audio_vae.init_vocoder_((audio_vae.VocoderWithBWE if v2 else audio_vae.Vocoder)(_voc_cfg(meta_voc)), gen)
    adec = audio_vae.init_audio_decoder_(audio_vae.AudioDecoder(ADEC), gen)
    with torch.no_grad():
        adec.per_channel_statistics.mean_of_means.normal_(generator=gen).mul_(0.1)
        adec.per_channel_statistics.std_of_means.uniform_(0.5, 1.5, generator=gen)
    others = {**vae_weights.decoder_to_checkpoint(init_video_decoder_(VideoDecoder(DCFG), gen)),
              **audio_weights.audio_decoder_to_checkpoint(adec), **audio_weights.vocoder_to_checkpoint(voc)}
    meta = {"config": json.dumps({"transformer": {"num_attention_heads": 2, "audio_num_attention_heads": 2},
                                  "vae": {"decoder_blocks": BLOCKS}, "vocoder": meta_voc})}
    if v2:
        meta["model_version"] = "2.3.0"
    write_safetensors_streaming(path, [*iter_checkpoint_specs(dit), *(
        (k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in others.items())], metadata=meta)
    return meta


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("av_files")
    gen = torch.Generator().manual_seed(0)
    paths = {v: str(d / f"ltx-{v}-av.safetensors") for v in ("v1", "v2")}
    metas = {v: _write(p, v, gen) for v, p in paths.items()}
    paths["upscaler"] = str(d / "upscaler.safetensors")
    write_safetensors(paths["upscaler"], spatial.upscaler_to_checkpoint(
        spatial.init_spatial_upscaler_(spatial.SpatialUpscaler(UPCFG), gen)))
    return paths, metas


def _argv(paths, version, out, pipeline="distilled", *extra):
    argv = ["--pipeline", pipeline, "--device", "cpu", "--height", str(H), "--width", str(W), "--num-frames",
            str(FRAMES), "--seed", "3", "--checkpoint", paths[version], "--audio", "--output", str(out), *extra]
    if pipeline == "distilled":
        return argv + ["--spatial-upscaler", paths["upscaler"]]
    return argv + ["--num-inference-steps", "2"]


def _wav(path):
    with wave.open(str(path)) as w:
        return w.getnchannels(), w.getframerate(), w.getnframes(), w.getsampwidth()


def test_write_wav_matches_jax(tmp_path):
    from scripts.generate import _write_wav as jax_write_wav

    audio = np.random.default_rng(0).standard_normal((2, 1001)).astype(np.float32) * 0.7
    audio[0, :4] = (1.5, -1.5, -0.99999, 0.50001)
    for rate in (24000, 48000):
        video_io.write_wav(str(tmp_path / "a.wav"), audio, rate)
        jax_write_wav(str(tmp_path / "b.wav"), audio, rate)
        assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
        assert _wav(tmp_path / "a.wav") == (2, rate, 1001, 2)


@pytest.mark.parametrize("pipeline", ["distilled", "one-stage", "text-to-video"])
def test_v1_audio_cli_writes_y4m_and_wav(files, tmp_path, pipeline):
    from scripts.generate import _write_wav as jax_write_wav

    paths, _ = files
    out = tmp_path / "clip.y4m"
    extra = () if pipeline == "distilled" else ("--audio-cfg-scale", "5")
    results, stats = generate.main(_argv(paths, "v1", out, pipeline, *extra))
    frames, waveform = results[0]
    st = stats[0]
    assert frames.shape == (FRAMES, H, W, 3) and waveform.shape == (2, (4 * FRAMES - 3) * 4)
    assert st["audio_sample_rate"] == 24000 and st["audio_samples"] == waveform.shape[1] and st["audio_finite"]
    assert _wav(tmp_path / "clip.wav") == (2, 24000, waveform.shape[1], 2)
    jax_write_wav(str(tmp_path / "jax.wav"), waveform, 24000)
    assert (tmp_path / "clip.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    assert out.stat().st_size == len(video_io.y4m_header(W, H, 24.0)) + FRAMES * (6 + 3 * H * W)
    assert np.abs(waveform).max() > 0


def test_v2_bwe_writes_48khz(files, tmp_path):
    paths, _ = files
    out = tmp_path / "clip.y4m"
    results, stats = generate.main(_argv(paths, "v2", out))
    _, waveform = results[0]
    assert stats[0]["audio_sample_rate"] == 48000
    assert waveform.shape == (2, 2 * (4 * FRAMES - 3) * 4)
    assert _wav(tmp_path / "clip.wav") == (2, 48000, waveform.shape[1], 2)
    # --skip-vae keeps the audio latent beside the video's.
    results, _ = generate.main(_argv(paths, "v2", out, "distilled", "--skip-vae"))
    with np.load(tmp_path / "clip_latent.npz") as data:
        assert data["latent"].shape == (1, 16, 2, 2, 2) and data["audio_latent"].shape == (1, 8, FRAMES, 16)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_av_checkpoint_loads_in_both_packages(files, version):
    paths, metas = files
    path = paths[version]
    ledger = ModelLedger(path, include_audio=True, target_dtype="float32", device="cpu")
    dit = ledger.transformer()
    assert dit.cfg.is_av and dit.cfg.audio_inner_dim == 32 and dit.cfg.cross_attention_adaln == (version == "v2")
    ref = jax_leaves(jwl.load_transformer_params(path, include_audio=True, target_dtype="float32", num_layers=2))
    got = port_leaves(dit)
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))[:6]
    for name, leaf in got.items():
        assert_bitwise(leaf, ref[name], name)
    assert sum("audio" in n or "a2v" in n or "av_ca" in n for n in got) > 50

    decoder = ledger.audio_decoder()
    assert decoder.cfg == ADEC
    vocoder = ledger.vocoder()
    meta = json.loads(metas[version]["config"])["vocoder"]
    if version == "v2":
        jcfg = jaudio.vocoder_with_bwe_config_from_checkpoint(meta)
        jvoc = jaudio.load_vocoder_with_bwe_params(path, jcfg)
        assert isinstance(vocoder, audio_vae.VocoderWithBWE) and vocoder.cfg.output_sample_rate == 48000
    else:
        jcfg = jaudio.VocoderConfig(**{k: _tuples(v) for k, v in meta.items()})
        jvoc = jaudio.load_vocoder_params(path, jcfg)
        assert isinstance(vocoder, audio_vae.Vocoder) and vocoder.cfg.output_sample_rate == 24000
    jdec = jaudio.load_audio_decoder_params(path, jaudio.AudioDecoderConfig(ch=8, ch_mult=(1, 1, 2), num_res_blocks=1))
    for module, tree in ((decoder, jdec), (vocoder, jvoc)):
        ref = {k: v for k, v in flatten_tree(tree).items() if v.dtype != object}
        got = port_leaves(module)
        assert set(got) == set(ref), sorted(set(got) ^ set(ref))[:6]
        for name, leaf in got.items():
            assert_bitwise(leaf, ref[name], name)


def test_audio_refusals(files, tmp_path):
    paths, _ = files
    with pytest.raises(SystemExit):
        generate.main(["--audio", "--device", "cpu", "--layers", "1", "--output", str(tmp_path / "x.y4m")])
    video_only = dataclasses.replace(CFG)
    path = str(tmp_path / "video.safetensors")
    write_safetensors_streaming(path, list(iter_checkpoint_specs(init_ltx_model_(LTXModel(video_only),
                                                                                 torch.Generator()))))
    with pytest.raises(ValueError, match="no audio stream"):
        ModelLedger(path, include_audio=True, device="cpu").transformer()
