"""The port's audio-to-video path against ltx2_tpu, in float32 on the CPU,
on the same numpy-drawn weights, files and noise:

- the mel analysis: `make_mel_basis` and `waveform_to_latent` (mono and
  stereo, shorter and longer than the 4 L - 3 frames the encoder takes);
- the audio VAE encoder (`audio_encoder_apply`, its stride-2 causal conv)
  and its weights through a file, `load_audio_encoder_params` and
  `ModelLedger.audio_encoder`, bit for bit in both packages;
- `load_audio_file` on 16-bit .wav files written here at 16 and 44.1 kHz,
  and the PCM readers `read_avi_audio` / `read_mov_audio` on files the JAX
  package's writers make (PIL's JPEG for their video, in the test only);
- the distilled pipeline with `freeze_audio`, with an encoded latent and
  with the noise fallback: the latents against the JAX pipeline's, the
  audio latent bit for bit frozen through both stages;
- `A2VidPipelineTwoStage` against the JAX pipeline, the source waveform
  passed through at 16 kHz;
- `generate.main --pipeline a2vid --audio --audio-file` from tiny files:
  a 16 kHz .wav of the source's length.

Tolerance: RTOL (1e-4 of the reference's largest magnitude,
tests/torch_port_util.py), the two packages summing in different orders.
"""

from __future__ import annotations

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.audio_vae import analysis as janalysis
from ltx2_tpu.models.audio_vae import decoder as jdecoder
from ltx2_tpu.models.audio_vae import encoder as jencoder
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.pipelines import a2vid_two_stage as ja2vid
from ltx2_tpu.pipelines import distilled as jdistilled
from ltx2_tpu.utils import video_io as jvideo_io
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.from_numpy import audio_encoder_from_numpy, dit_from_numpy, spatial_upscaler_from_numpy
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile, write_safetensors
from ltx2_tpu_torch.models.audio_vae import analysis, decoder, encoder
from ltx2_tpu_torch.models.audio_vae import weights as audio_weights
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics
from ltx2_tpu_torch.pipelines import a2vid_two_stage, distilled
from ltx2_tpu_torch.utils import video_io
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import assert_bitwise, assert_close, random_tree, stacked_dit_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

# A small encoder at the pipelines' audio geometry below: 4 latent channels
# x 4 mel bins from a stereo 16-mel analysis.
ENC = dict(ch=8, ch_mult=(1, 1, 2), num_res_blocks=1, z_channels=4, mel_bins=4)
AV = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
          cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
          audio_out_channels=16, caption_channels=24)
AUDIO = dict(audio_vae_channels=4, audio_mel_bins=4)
UP = dict(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
HEIGHT, WIDTH, FRAMES, FPS, SEED = 64, 64, 9, 24.0, 19
AUDIO_FRAMES = 9  # 9 frames at 24 fps


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def enc():
    cfg = encoder.AudioEncoderConfig(**ENC)
    tree = random_tree(encoder.AudioEncoder(cfg, device="meta"), 41)
    return cfg, jencoder.AudioEncoderConfig(**ENC), tree, audio_encoder_from_numpy(tree, cfg)


def test_mel_basis_matches_jax():
    for sr, n_fft, n_mels in ((16000, 1024, 64), (16000, 1024, 16), (44100, 2048, 128)):
        got = analysis.make_mel_basis(sr, n_fft, n_mels)
        ref = janalysis.make_mel_basis(sr, n_fft, n_mels)
        assert got.dtype == np.float32
        assert_bitwise(torch.from_numpy(got), ref, f"mel basis {sr} {n_fft} {n_mels}")
    np.testing.assert_array_equal(analysis._hz_to_mel([0.0, 500.0, 1000.0, 7999.0]),
                                  janalysis._hz_to_mel([0.0, 500.0, 1000.0, 7999.0]))
    np.testing.assert_array_equal(analysis._mel_to_hz([0.0, 10.0, 15.0, 40.0]),
                                  janalysis._mel_to_hz([0.0, 10.0, 15.0, 40.0]))
    cfg = analysis.AudioAnalysisConfig(n_mels=16)
    params = analysis.make_analysis_params(cfg)
    jparams = janalysis.make_analysis_params(janalysis.AudioAnalysisConfig(n_mels=16))
    assert_bitwise(params.mel_basis, jparams["mel_basis"], "analysis mel basis")
    assert_bitwise(params.stft_fn.forward_basis, jparams["stft_fn"]["forward_basis"], "analysis stft basis")


def test_encoder_matches_jax(enc):
    cfg, jcfg, tree, port = enc
    spec = np.random.default_rng(2).standard_normal((2, 2, 33, 16)).astype(np.float32)
    out = encoder.audio_encoder_apply(port, t(spec))
    ref = jencoder.audio_encoder_apply(_jtree(tree), jcfg, jnp.asarray(spec))
    assert tuple(out.shape) == (2, 4, 9, 4)
    assert_close(out, ref, msg="encoder")
    # The stride-2 causal conv alone, channels last in the JAX package.
    conv = port.down_blocks[0].downsample.conv
    x = np.random.default_rng(3).standard_normal((1, 8, 33, 16)).astype(np.float32)
    got = decoder.causal_conv2d(conv, t(x), stride=2)
    jconv = tree["down_blocks"][0]["downsample"]["conv"]
    ref = jdecoder.causal_conv2d(_jtree(jconv), jnp.asarray(x.transpose(0, 2, 3, 1)), 3, True, stride=2)
    assert tuple(got.shape) == (1, 8, 17, 8)
    assert_close(got, np.asarray(ref).transpose(0, 3, 1, 2), msg="stride-2 causal conv")


@pytest.mark.parametrize("channels,seconds", [(1, 0.2), (2, 0.2), (2, 0.6)], ids=["mono", "stereo", "long"])
def test_waveform_to_latent_matches_jax(enc, channels, seconds):
    """0.2 s at 16 kHz gives 21 mel frames (padded at the edge to 33 =
    4 x 9 - 3), 0.6 s gives 61 (cut to 33)."""
    cfg, jcfg, tree, port = enc
    wav = (np.random.default_rng(4).standard_normal((channels, int(16000 * seconds))) * 0.3).astype(np.float32)
    a_cfg = analysis.AudioAnalysisConfig(n_mels=16)
    out = analysis.waveform_to_latent(wav, port, a_cfg, AUDIO_FRAMES)
    ref = janalysis.waveform_to_latent(wav, _jtree(tree), jcfg, janalysis.AudioAnalysisConfig(n_mels=16),
                                       AUDIO_FRAMES)
    assert tuple(out.shape) == (1, 4, AUDIO_FRAMES, 4)
    assert_close(out, ref, msg=f"waveform_to_latent {channels}ch {seconds}s")
    if channels == 1:  # mono is duplicated to stereo
        assert_close(out, analysis.waveform_to_latent(np.repeat(wav, 2, axis=0), port, a_cfg, AUDIO_FRAMES).numpy(),
                     rtol=0, msg="mono")


def test_encoder_weights_through_a_file(enc, tmp_path):
    cfg, jcfg, tree, _ = enc
    port = audio_encoder_from_numpy(tree, cfg)  # a copy: its statistics are drawn here
    with torch.no_grad():
        port.per_channel_statistics.mean_of_means.uniform_(-0.2, 0.2)
    path = str(tmp_path / "enc.safetensors")
    write_safetensors(path, audio_weights.audio_encoder_to_checkpoint(port))
    assert audio_weights.audio_encoder_config_from_checkpoint(path) == cfg
    loaded = ModelLedger(path, device="cpu").audio_encoder()
    ref = jencoder.load_audio_encoder_params(path, jcfg)
    got = dict((*loaded.named_parameters(), *loaded.named_buffers()))
    from ltx2_tpu_torch.loader.from_numpy import flatten_tree

    flat = flatten_tree(ref)
    assert set(got) == set(flat)
    for name, leaf in got.items():
        assert_bitwise(leaf, np.asarray(flat[name]), name)
        assert_bitwise(leaf, dict((*port.named_parameters(), *port.named_buffers()))[name], name)
    empty = str(tmp_path / "none.safetensors")
    write_safetensors(empty, {"x": torch.zeros(1)})
    assert audio_weights.load_audio_encoder_params(empty, device="cpu") is None
    assert ModelLedger(empty, device="cpu").audio_encoder() is None


def _write_wav(path, pcm: np.ndarray, rate: int, width: int = 2) -> str:
    with wave.open(str(path), "w") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(np.ascontiguousarray(pcm.T).tobytes())
    return str(path)


@pytest.mark.parametrize("rate,channels", [(16000, 2), (44100, 2), (44100, 1)])
def test_load_audio_file_matches_jax(tmp_path, rate, channels):
    pcm = np.random.default_rng(5).integers(-20000, 20000, (channels, rate // 2), dtype=np.int16)
    path = _write_wav(tmp_path / "a.wav", pcm, rate)
    for kw in (dict(), dict(start_time=0.1, max_duration=0.3)):
        got, sr = a2vid_two_stage.load_audio_file(path, **kw)
        ref, jsr = ja2vid.load_audio_file(path, **kw)
        assert sr == jsr == 16000 and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert got.shape == (channels, int(int(0.3 * rate) * 16000 / rate))


def test_container_audio_readers_match_jax(tmp_path):
    pytest.importorskip("PIL")  # the JAX package's MJPEG writers take their JPEG encoder from PIL
    frames = np.zeros((3, 16, 16, 3), np.uint8)
    audio = (np.random.default_rng(6).standard_normal((2, 3000)) * 0.3).astype(np.float32)
    avi, mov = str(tmp_path / "a.avi"), str(tmp_path / "a.mov")
    jvideo_io.write_avi_mjpeg(avi, frames, 24.0, audio=audio, sample_rate=16000)
    jvideo_io.write_mp4_mjpeg(mov, frames, 24.0, audio=audio, sample_rate=22050)
    for reader, jreader, path, rate in ((video_io.read_avi_audio, jvideo_io.read_avi_audio, avi, 16000),
                                        (video_io.read_mov_audio, jvideo_io.read_mov_audio, mov, 22050)):
        got, sr = reader(path)
        ref, jsr = jreader(path)
        assert sr == jsr == rate and got.shape == ref.shape == (2, 3000)
        np.testing.assert_array_equal(got, ref)
        loaded, _ = a2vid_two_stage.load_audio_file(path)
        np.testing.assert_array_equal(loaded, ja2vid.load_audio_file(path)[0])
    silent = str(tmp_path / "silent.avi")
    jvideo_io.write_avi_mjpeg(silent, frames, 24.0)
    assert video_io.read_avi_audio(silent) is None and jvideo_io.read_avi_audio(silent) is None
    with pytest.raises(ValueError, match="no PCM audio stream"):
        a2vid_two_stage.load_audio_file(silent)


@pytest.fixture(scope="module")
def av():
    cfg = model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo, **AV)
    jcfg = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, remat=False, **AV)
    tree = stacked_dit_tree(cfg, seed=42)
    up_tree = random_tree(SpatialUpscaler(SpatialUpscalerConfig(**UP), device="meta"), 43)
    stats = {"mean_of_means": np.linspace(-0.2, 0.2, 16, dtype=np.float32),
             "std_of_means": np.linspace(0.8, 1.2, 16, dtype=np.float32)}
    return cfg, jcfg, tree, up_tree, stats


def _pipelines(av, enc, a2vid: bool):
    """(JAX pipeline, port pipeline) on the same weights."""
    cfg, jcfg, tree, up_tree, stats = av
    jkw = dict(transformer_params=_jtree(tree), transformer_cfg=jcfg,
               video_decoder_params={"per_channel_statistics": _jtree(stats)},
               spatial_upscaler_params=_jtree(up_tree), spatial_upscaler_cfg=jspatial.SpatialUpscalerConfig(**UP))
    statistics = PerChannelStatistics(16)
    statistics.mean_of_means.copy_(t(stats["mean_of_means"]))
    statistics.std_of_means.copy_(t(stats["std_of_means"]))
    args = (dit_from_numpy(tree, cfg), spatial_upscaler_from_numpy(up_tree, SpatialUpscalerConfig(**UP)))
    if not a2vid:
        return jdistilled.DistilledPipeline(**jkw), distilled.DistilledPipeline(*args, statistics=statistics)
    _, jenc_cfg, enc_tree, port_enc = enc
    return (ja2vid.A2VidPipelineTwoStage(audio_encoder_params=_jtree(enc_tree), audio_encoder_cfg=jenc_cfg, **jkw),
            a2vid_two_stage.A2VidPipelineTwoStage(*args, statistics=statistics, audio_encoder=port_enc))


def _noises(seed: int):
    """Each stage's video and audio noise from the JAX keys (split 3, then 2)."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    keys = [jax.random.split(k) for k in (k1, k2)]
    video = [t(np.asarray(jax.random.normal(k[0], (1, n, 16), jnp.float32))) for k, n in zip(keys, (2, 8))]
    audio = [t(np.asarray(jax.random.normal(k[1], (1, AUDIO_FRAMES, 16), jnp.float32))) for k in keys]
    return video, audio


@pytest.mark.parametrize("branch", ["encoded", "noise_fallback"])
def test_distilled_freeze_audio_matches_jax(av, enc, branch):
    jpipe, pipe = _pipelines(av, enc, a2vid=False)
    rng = np.random.default_rng(9)
    context = (rng.standard_normal((1, 6, 24)) * 0.5).astype(np.float32)
    initial = rng.standard_normal((1, 4, AUDIO_FRAMES, 4)).astype(np.float32) if branch == "encoded" else None
    common = dict(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16, audio_enabled=True,
                  **AUDIO)
    ref_v, ref_a = jpipe(jnp.asarray(context), None, jdistilled.DistilledConfig(dtype="float32", **common),
                         skip_decode=True, freeze_audio=True,
                         initial_audio_latent=None if initial is None else jnp.asarray(initial))
    noises, audio_noises = _noises(SEED)
    audio_out = {}
    run_stage = pipe._run_stage

    def record(*args, **kwargs):
        out = run_stage(*args, **kwargs)
        audio_out.setdefault("stages", []).append((kwargs.get("initial_audio_latent"), out[1]))
        return out

    pipe._run_stage = record
    out_v, out_a = pipe(t(context), distilled.DistilledConfig(**common), skip_decode=True, freeze_audio=True,
                        initial_audio_latent=None if initial is None else t(initial), noises=noises,
                        audio_noises=audio_noises)
    assert_close(out_v, np.asarray(ref_v), msg=f"{branch} video latent")
    assert_close(out_a, np.asarray(ref_a), msg=f"{branch} audio latent")
    (in1, out1), (in2, out2) = audio_out["stages"]
    if branch == "encoded":
        assert torch.equal(out1, t(initial)) and torch.equal(out2, t(initial))
        assert_bitwise(np.asarray(ref_a), initial, "JAX frozen")
    else:  # the noised zeros, frozen: stage 1 is the noise itself, stage 2 keeps it
        assert torch.equal(out1, audio_noises[0].reshape(1, AUDIO_FRAMES, 4, 4).permute(0, 2, 1, 3))
        assert torch.equal(out2, out1) and in2 is out1
    # The video noise does not depend on the freeze: the same draws.
    unfrozen_v, _ = pipe(t(context), distilled.DistilledConfig(**common), skip_decode=True, noises=noises,
                         audio_noises=audio_noises)
    assert (unfrozen_v - out_v).abs().max() > 0


def test_a2vid_pipeline_matches_jax(av, enc):
    jpipe, pipe = _pipelines(av, enc, a2vid=True)
    rng = np.random.default_rng(10)
    context = (rng.standard_normal((1, 6, 24)) * 0.5).astype(np.float32)
    wave_in = (rng.standard_normal((2, 6000)) * 0.3).astype(np.float32)
    common = dict(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16, audio_enabled=True,
                  **AUDIO)
    ref = jpipe(jnp.asarray(context), None, ja2vid.A2VidConfig(dtype="float32", **common), source_waveform=wave_in,
                skip_decode=True)
    noises, audio_noises = _noises(SEED)
    phases = {}
    out = pipe(t(context), a2vid_two_stage.A2VidConfig(**common), source_waveform=wave_in, skip_decode=True,
               noises=noises, audio_noises=audio_noises, callback=lambda p, z: phases.setdefault(p, z))
    assert len(out) == len(ref) == 3 and out[2] == ref[2] == 16000
    assert_close(out[0], np.asarray(ref[0]), msg="a2vid video latent")
    np.testing.assert_array_equal(out[1], np.asarray(ref[1]))
    assert out[1].shape == (1, 2, 6000)
    assert pipe.frozen_by_stage == [True, True]
    encoded = phases["audio_encode"]
    jenc = jpipe._encode_audio_to_latent(wave_in, 16000, ja2vid.A2VidConfig(dtype="float32", **common))
    assert_close(encoded, jenc, msg="a2vid encoded latent")


def _a2vid_file(tmp_path) -> tuple:
    """The audio CLI test's tiny V1 AV file with a small audio encoder at
    the CLI's audio geometry (8 channels x 16 mel bins from 64 mels), and
    the upscaler's file."""
    from ltx2_tpu_torch.models.upscaler import spatial
    from tests.test_torch_port_audio_cli import UPCFG, _write

    gen = torch.Generator().manual_seed(1)
    base = str(tmp_path / "av.safetensors")
    meta = _write(base, "v1", gen)
    enc_module = encoder.init_audio_encoder_(encoder.AudioEncoder(encoder.AudioEncoderConfig(
        ch=8, ch_mult=(1, 1, 2), num_res_blocks=1)), gen)
    f = SafetensorsFile(base)
    try:
        tensors = {k: f.get(k).clone() for k in f.keys()}
    finally:
        f.close()
    enc_tensors = audio_weights.audio_encoder_to_checkpoint(enc_module)
    enc_tensors.update({k: v for k, v in tensors.items() if k.startswith(audio_weights.STATS_PREFIX)})
    path = str(tmp_path / "av_enc.safetensors")
    write_safetensors(path, {**tensors, **enc_tensors}, metadata=meta)
    up = str(tmp_path / "up.safetensors")
    write_safetensors(up, spatial.upscaler_to_checkpoint(spatial.init_spatial_upscaler_(
        spatial.SpatialUpscaler(UPCFG), gen)))
    return path, up


def test_a2vid_cli_writes_the_source_at_16khz(tmp_path):
    path, up = _a2vid_file(tmp_path)
    pcm = np.random.default_rng(11).integers(-20000, 20000, (2, 44100), dtype=np.int16)
    source = _write_wav(tmp_path / "source.wav", pcm, 44100)
    out = tmp_path / "clip.y4m"
    results, stats = generate.main(["--pipeline", "a2vid", "--device", "cpu", "--height", "64", "--width", "64",
                                    "--num-frames", str(FRAMES), "--checkpoint", path, "--spatial-upscaler", up,
                                    "--audio", "--audio-file", source, "--output", str(out)])
    frames, wave_out = results[0]
    ref, _ = ja2vid.load_audio_file(source, max_duration=FRAMES / FPS)
    np.testing.assert_array_equal(wave_out, ref)
    st = stats[0]
    assert frames.shape == (FRAMES, 64, 64, 3)
    assert st["audio_sample_rate"] == 16000 and st["audio_samples"] == ref.shape[1] == int(
        int(FRAMES / FPS * 44100) * 16000 / 44100)
    assert st["audio_frozen_by_stage"] == [True, True] and "audio_encode_s" in st
    with wave.open(str(tmp_path / "clip.wav")) as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes(), w.getsampwidth()) == (2, 16000, ref.shape[1], 2)
    with pytest.raises(SystemExit):
        generate.main(["--pipeline", "distilled", "--device", "cpu", "--audio-file", source,
                       "--output", str(out)])


def test_a2vid_pipeline_on_2_ranks_matches_jax(av, enc, tmp_path):
    """a2vid on 2 gloo ranks under SP-2 at 64x128x17 (6 video tokens at
    stage 1, 24 at stage 2, 18 frozen audio tokens: the audio stream and the
    cross-modal attentions split too) against the JAX pipeline on a
    2-device sequence mesh; every rank's video latent identical."""
    from ltx2_tpu.parallel import mesh as jmesh
    from tests.torch_port_pp_workers import pipeline_call
    from tests.torch_port_util import spawn_ranks

    cfg, jcfg, tree, up_tree, stats = av
    _, jenc_cfg, enc_tree, port_enc = enc
    rng = np.random.default_rng(10)
    context = (rng.standard_normal((1, 6, 24)) * 0.5).astype(np.float32)
    wave_in = (rng.standard_normal((2, 12000)) * 0.3).astype(np.float32)
    common = dict(height=64, width=128, num_frames=17, seed=SEED, latent_channels=16, audio_enabled=True, **AUDIO)
    keys = [jax.random.split(k) for k in jax.random.split(jax.random.PRNGKey(SEED), 3)[:2]]
    noises = [np.asarray(jax.random.normal(k[0], (1, n, 16), jnp.float32)) for k, n in zip(keys, (6, 24))]
    audio_noises = [np.asarray(jax.random.normal(k[1], (1, 18, 16), jnp.float32)) for k in keys]
    statistics = PerChannelStatistics(16)
    statistics.mean_of_means.copy_(t(stats["mean_of_means"]))
    statistics.std_of_means.copy_(t(stats["std_of_means"]))
    spec = {"cls": "ltx2_tpu_torch.pipelines.a2vid_two_stage.A2VidPipelineTwoStage",
            "modules": {"transformer": ("dit_from_numpy", tree, cfg),
                        "spatial_upscaler": ("spatial_upscaler_from_numpy", up_tree, SpatialUpscalerConfig(**UP))},
            "ctor": {"statistics": statistics, "audio_encoder": port_enc}, "meshes": {"sequence_mesh": "seq"},
            "args": (context, a2vid_two_stage.A2VidConfig(**common)),
            "kwargs": dict(source_waveform=wave_in, skip_decode=True, noises=noises, audio_noises=audio_noises)}
    results = spawn_ranks(pipeline_call, 2, tmp_path, spec)
    np.testing.assert_array_equal(results[1][0], results[0][0])
    jpipe = ja2vid.A2VidPipelineTwoStage(
        audio_encoder_params=_jtree(enc_tree), audio_encoder_cfg=jenc_cfg, transformer_params=_jtree(tree),
        transformer_cfg=jcfg, video_decoder_params={"per_channel_statistics": _jtree(stats)},
        spatial_upscaler_params=_jtree(up_tree), spatial_upscaler_cfg=jspatial.SpatialUpscalerConfig(**UP),
        sequence_mesh=jmesh.create_mesh(data=1, model=1, seq=2, devices=jax.devices()[:2]))
    ref = jpipe(jnp.asarray(context), None, ja2vid.A2VidConfig(dtype="float32", **common), source_waveform=wave_in,
                skip_decode=True)
    assert_close(results[0][0], np.asarray(ref[0]), msg="a2vid video latent under SP-2")
