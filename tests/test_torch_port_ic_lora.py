"""IC-LoRA control (ltx2_tpu_torch/pipelines/ic_lora.py), on the CPU,
against the JAX package (ltx2_tpu/pipelines/ic_lora.py) on the same
weights: a 2-layer DiT (video-only, and the small audio-video one), the
small encoder plan, a mid-16 upscaler, random latent statistics, a rank-2
LoRA on every block linear.

- `create_video_conditionings`: a RAW control (an MJPEG AVI read at stage
  1's size) and a CANNY one (the port's Canny against OpenCV's, where cv2
  is installed), encoded and appended at frame 0: the latents within RTOL,
  frame and strength equal; `save_control`'s AVI byte for byte the JAX
  package's; without cv2 the Canny equal to cv2's calls on the port's
  frames;
- the distilled `_run_stage` with `extra_conditionings` (per-token
  timesteps) against JAX's;
- `ICLoraPipeline(skip_decode=True)` video and AV with `videos=`: the
  latents (and the audio latent) within RTOL with the JAX keys' noise
  handed in; the IC-LoRA in stage 1 only (without it stage 1 moves, stage
  2 alone does not see it); the DiT's weights after the run as JAX's
  (rtol 1e-6), and after an exception raised inside stage 1;
- the CLI: `--lora` routed to `--ic-lora-weights` and kept out of the
  ledger's fuse, `--int8` refused, `--save-control` writing the JAX bytes, the
  flags as the JAX CLI parses them, and a run from tiny files.

Tolerance: RTOL (1e-4 of the reference's largest magnitude), the two
packages summing in different orders.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ltx2_tpu.conditioning import keyframe as jkeyframe
from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import lora as jlora
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.pipelines import distilled as jdistilled
from ltx2_tpu.pipelines import ic_lora as jic
from ltx2_tpu.types import VideoPixelShape as JPixelShape
from ltx2_tpu.utils import video_io as jvio
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.conditioning.keyframe import VideoConditionByKeyframeIndex
from ltx2_tpu_torch.loader import lora
from ltx2_tpu_torch.loader.export import inverse_rewrite
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, spatial_upscaler_from_numpy, video_decoder_from_numpy, video_encoder_from_numpy,
)
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import PerChannelStatistics, VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.models.video_vae.encoder import video_encoder_apply
from ltx2_tpu_torch.pipelines import distilled, ic_lora
from ltx2_tpu_torch.types import VideoPixelShape
from tests.torch_port_util import (  # noqa: F401 (one_intra_op_thread: the fixture)
    assert_close, jax_leaves, one_intra_op_thread, port_leaves, random_tree, stacked_dit_tree, t,
)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None), ("down", 16, 16, (2, 1, 1)),
        ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)), ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)),
        ("res", 32, 1, None))
JECFG = jencoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
ECFG = encoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
UP = dict(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
VIDEO = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=2,
             cross_attention_dim=64, compute_dtype="float32")
AV = dict(VIDEO, audio_heads=2, audio_head_dim=16, audio_in_channels=16, audio_out_channels=16, caption_channels=24)
AUDIO = dict(audio_vae_channels=4, audio_mel_bins=4)
AUDIO_FRAMES = 9  # 9 frames at 24 fps
HEIGHT, WIDTH, FRAMES, SEED = 64, 64, 9, 21
STATS = {"mean_of_means": np.linspace(-0.2, 0.2, 16, dtype=np.float32),
         "std_of_means": np.linspace(0.8, 1.2, 16, dtype=np.float32)}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _control_frames(seed: int = 5, frames: int = FRAMES, size: int = HEIGHT) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    edges = ((xx // 8 + yy // 8) % 2 * 200).astype(np.float64)
    return np.stack([np.clip(np.stack([edges] * 3, -1) + 4 * i + rng.normal(0, 10, (size, size, 3)), 0, 255)
                     .astype(np.uint8) for i in range(frames)])


def _lora_file(path, cfg, rank: int = 2, seed: int = 3, scale: float = 0.05) -> str:
    """A LoRA on every linear weight of every block of `cfg`'s DiT."""
    rng = np.random.default_rng(seed)
    w = {}
    for name, p in model.LTXModel(cfg, device="meta").named_parameters():
        if name.startswith("transformer_blocks.") and name.endswith(".weight") and p.ndim == 2:
            base = "diffusion_model." + inverse_rewrite(name)[: -len(".weight")]
            out_f, in_f = p.shape
            w[f"{base}.lora_A.weight"] = (rng.standard_normal((rank, in_f)) * scale).astype(np.float32)
            w[f"{base}.lora_B.weight"] = (rng.standard_normal((out_f, rank)) * scale).astype(np.float32)
    jst.write_safetensors(path, w)
    return path


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    d = tmp_path_factory.mktemp("ic_lora")
    control = str(d / "control.avi")
    jvio.write_avi_mjpeg(control, _control_frames(), 24.0)
    video_cfg, av_cfg = model.LTXModelConfig(**VIDEO), model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo,
                                                                             **AV)
    return {
        "dir": d, "control": control,
        "encoder": random_tree(encoder.VideoEncoder(ECFG, device="meta"), seed=2),
        "up": random_tree(SpatialUpscaler(SpatialUpscalerConfig(**UP), device="meta"), 33),
        "video": (video_cfg, jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None,
                                                   remat=False, **VIDEO), stacked_dit_tree(video_cfg, seed=41)),
        "av": (av_cfg, jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, remat=False, **AV),
               stacked_dit_tree(av_cfg, seed=42)),
        "lora": {kind: _lora_file(str(d / f"{kind}.safetensors"), cfg, seed=7)
                 for kind, cfg in (("video", video_cfg), ("av", av_cfg))},
    }


def _jencode(parts):
    params = _jtree(parts["encoder"])
    return lambda video: jencoder.video_encoder_apply(params, JECFG, video)


@pytest.mark.parametrize("control_type", ["raw", "canny"])
def test_create_video_conditionings_matches_jax(parts, control_type):
    if control_type == "canny":
        pytest.importorskip("cv2")
    enc = video_encoder_from_numpy(parts["encoder"], ECFG)
    jvc = jic.VideoCondition(parts["control"], strength=0.8, control_type=jic.ControlType(control_type))
    vc = ic_lora.VideoCondition(parts["control"], strength=0.8, control_type=ic_lora.ControlType(control_type))
    ref = jic.create_video_conditionings([jvc], _jencode(parts), 32, 32, FRAMES)
    got = ic_lora.create_video_conditionings([vc], lambda v: video_encoder_apply(enc, v), 32, 32, FRAMES)
    assert len(got) == len(ref) == 1 and isinstance(got[0], VideoConditionByKeyframeIndex)
    assert (got[0].frame_idx, got[0].strength) == (ref[0].frame_idx, ref[0].strength) == (0, 0.8)
    assert tuple(got[0].keyframes.shape) == (1, 16, 2, 1, 1)
    assert_close(got[0].keyframes, np.asarray(ref[0].keyframes), msg=f"{control_type} control latent")
    if control_type == "canny":
        edges = ic_lora.preprocess_canny(parts["control"], 32, 32, FRAMES, 100, 200)
        np.testing.assert_array_equal(edges, jic.preprocess_canny(parts["control"], 32, 32, FRAMES, 100, 200))
    # save_control writes the encoded signal as the JAX package's MJPEG AVI, byte for byte.
    control_avi = parts["control"] + ".control.avi"
    jic.create_video_conditionings([dataclasses.replace(jvc, save_control=True)], _jencode(parts), 32, 32, FRAMES)
    with open(control_avi, "rb") as fh:
        ref_bytes = fh.read()
    os.unlink(control_avi)
    ic_lora.create_video_conditionings([dataclasses.replace(vc, save_control=True)],
                                       lambda v: video_encoder_apply(enc, v), 32, 32, FRAMES)
    with open(control_avi, "rb") as fh:
        assert fh.read() == ref_bytes
    os.unlink(control_avi)


def test_canny_without_opencv_names_its_roadmap_item(parts, monkeypatch):
    """Without OpenCV the Canny signal is the port's own (utils/canny.py) on
    the frames the port's readers give at the video's size: equal to cv2's
    three calls on those frames."""
    cv2 = pytest.importorskip("cv2")
    from ltx2_tpu_torch.utils.video_io import probe_video, read_video_any

    _fps, count, h, w = probe_video(parts["control"])
    video = read_video_any(parts["control"], h, w, min(count, FRAMES))
    rgb = np.rint((video[0].transpose(1, 2, 3, 0) + 1.0) * 127.5).astype(np.uint8)
    expected = [cv2.cvtColor(cv2.Canny(cv2.cvtColor(cv2.resize(np.ascontiguousarray(f[..., ::-1]), (40, 24),
                                                                  interpolation=cv2.INTER_LANCZOS4),
                                                       cv2.COLOR_BGR2GRAY), 30, 90), cv2.COLOR_GRAY2RGB)
                for f in rgb]
    expected += [expected[-1]] * (FRAMES - len(expected))
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = ic_lora.preprocess_canny(parts["control"], 24, 40, FRAMES, 30, 90)
    np.testing.assert_array_equal(got, np.stack(expected))
    assert got.any()


def _stage_noise(seed: int, tokens, audio: bool):
    """Each stage's video (and audio) noise as the JAX distilled pipeline
    draws it: PRNGKey(seed) -> 3 keys, each stage's key -> (video, audio)."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    keys = [jax.random.split(k) for k in (k1, k2)]

    def normal(key, n):
        return t(np.asarray(jax.random.normal(key, (1, n, 16), jnp.float32)))

    return ([normal(k[0], n) for k, n in zip(keys, tokens)],
            [normal(k[1], AUDIO_FRAMES) for k in keys] if audio else None)


def test_run_stage_with_extra_conditionings_matches_jax(parts):
    cfg, jcfg, tree = parts["video"]
    keyframes = np.random.default_rng(9).standard_normal((1, 16, 2, 1, 1)).astype(np.float32)
    context = (np.random.default_rng(10).standard_normal((1, 6, 64)) * 0.5).astype(np.float32)
    jpipe = jdistilled.DistilledPipeline(transformer_params=_jtree(tree), transformer_cfg=jcfg)
    jconfig = jdistilled.DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, dtype="float32",
                                         latent_channels=16)
    sigmas = np.asarray([1.0, 0.725, 0.421875, 0.0], np.float32)
    key = jax.random.PRNGKey(4)
    ref, _ = jpipe._run_stage(JPixelShape(batch=1, frames=FRAMES, height=32, width=32, fps=24.0), sigmas,
                              jnp.asarray(context), None, jconfig, [], key, 1.0, False,
                              extra_conditionings=[jkeyframe.VideoConditionByKeyframeIndex(
                                  jnp.asarray(keyframes), 0, 0.9)])
    noise = t(np.asarray(jax.random.normal(jax.random.split(key)[0], (1, 4, 16), jnp.float32)))
    pipe = distilled.DistilledPipeline(dit_from_numpy(tree, cfg))
    config = distilled.DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16)
    got, _ = pipe._run_stage(VideoPixelShape(batch=1, frames=FRAMES, height=32, width=32, fps=24.0),
                             sigmas.tolist(), t(context), config, [], {}, None, 1.0, noise=noise,
                             extra_conditionings=[VideoConditionByKeyframeIndex(t(keyframes), 0, 0.9)])
    assert tuple(got.shape) == (1, 16, 2, 1, 1)  # the appended tokens cleared
    assert_close(got, np.asarray(ref), msg="stage with an appended control")


def _pipelines(parts, kind, lora_path, strength=0.8):
    cfg, jcfg, tree = parts[kind]
    statistics = PerChannelStatistics(16)
    statistics.mean_of_means.copy_(t(STATS["mean_of_means"]))
    statistics.std_of_means.copy_(t(STATS["std_of_means"]))
    jpipe = jic.ICLoraPipeline(
        transformer_params=_jtree(tree), transformer_cfg=jcfg,
        video_encoder_params=_jtree(parts["encoder"]), video_encoder_cfg=JECFG,
        video_decoder_params={"per_channel_statistics": _jtree(STATS)},
        spatial_upscaler_params=_jtree(parts["up"]), spatial_upscaler_cfg=jspatial.SpatialUpscalerConfig(**UP))
    pipe = ic_lora.ICLoraPipeline(dit_from_numpy(tree, cfg),
                                  spatial_upscaler_from_numpy(parts["up"], SpatialUpscalerConfig(**UP)),
                                  statistics=statistics, video_encoder=video_encoder_from_numpy(parts["encoder"], ECFG))
    common = dict(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16)
    if kind == "av":
        common.update(audio_enabled=True, **AUDIO)
    jconfig = jic.ICLoraConfig(dtype="float32", ic_lora_config=jlora.LoRAConfig(lora_path, strength), **common)
    config = ic_lora.ICLoraConfig(ic_lora_config=lora.LoRAConfig(lora_path, strength), **common)
    return jpipe, pipe, jconfig, config


@pytest.mark.parametrize("kind", ["video", "av"])
def test_ic_lora_pipeline_matches_jax(parts, kind):
    audio = kind == "av"
    jpipe, pipe, jconfig, config = _pipelines(parts, kind, parts["lora"][kind])
    width = 24 if audio else 64
    context = (np.random.default_rng(11).standard_normal((1, 6, width)) * 0.5).astype(np.float32)
    jvideos = [jic.VideoCondition(parts["control"], strength=0.9)]
    videos = [ic_lora.VideoCondition(parts["control"], strength=0.9)]
    ref = jpipe(jnp.asarray(context), None, jconfig, videos=jvideos, skip_decode=True)
    ref_v, ref_a = ref if audio else (ref, None)
    noises, audio_noises = _stage_noise(SEED, (2 + 2, 8), audio)
    before = {k: v.clone() for k, v in port_leaves(pipe.transformer).items()}
    phases = []
    out = pipe(t(context), config, videos=videos, skip_decode=True, noises=noises, audio_noises=audio_noises,
               callback=lambda phase, z: phases.append(phase))
    out_v, out_a = out if audio else (out, None)
    assert phases == ["lora_fuse", "control_encode", "stage1", "lora_unfuse", "upscale", "stage2"]
    assert tuple(out_v.shape) == (1, 16, 2, 2, 2)
    assert_close(out_v, np.asarray(ref_v), msg=f"{kind} ic-lora latent")
    if audio:
        assert tuple(out_a.shape) == (1, 4, AUDIO_FRAMES, 4)
        assert_close(out_a, np.asarray(ref_a), msg=f"{kind} ic-lora audio latent")
    ref_leaves = jax_leaves(jpipe.transformer_params)
    for name, leaf in port_leaves(pipe.transformer).items():
        assert_close(leaf, ref_leaves[name], rtol=1e-6, msg=f"restored {name}")
        assert (leaf - before[name]).abs().max() <= 2.0 ** -20 * before[name].abs().max(), name
    # The LoRA reaches stage 1 and only stage 1: without it the stage-1
    # latent moves; with it, stage 2 runs the base weights (the JAX match).
    stage1 = {}
    pipe(t(context), dataclasses.replace(config, ic_lora_config=None), videos=videos, skip_decode=True,
         noises=noises, audio_noises=audio_noises, callback=lambda phase, z: stage1.setdefault(phase, z))
    with_lora = {}
    pipe(t(context), config, videos=videos, skip_decode=True, noises=noises, audio_noises=audio_noises,
         callback=lambda phase, z: with_lora.setdefault(phase, z))
    assert (stage1["stage1"] - with_lora["stage1"]).abs().max() > 1e-4


def test_weights_restored_after_a_failure_in_stage_1(parts):
    _, pipe, _, config = _pipelines(parts, "video", parts["lora"]["video"])
    before = {k: v.clone() for k, v in port_leaves(pipe.transformer).items()}
    context = t((np.random.default_rng(12).standard_normal((1, 6, 64)) * 0.5).astype(np.float32))
    seen = []
    with pytest.raises((FileNotFoundError, ValueError, OSError)):
        pipe(context, config, videos=[ic_lora.VideoCondition(str(parts["dir"] / "absent.avi"))], skip_decode=True,
             callback=lambda phase, z: seen.append(phase))
    assert seen == ["lora_fuse"] and pipe._ic_applied is None
    for name, leaf in port_leaves(pipe.transformer).items():
        assert (leaf - before[name]).abs().max() <= 2.0 ** -20 * before[name].abs().max(), name


@pytest.fixture(scope="module")
def files(parts):
    d = parts["dir"]
    cfg, _, tree = parts["video"]
    dcfg = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
    ckpt = str(d / "ltx.safetensors")
    jst.write_safetensors(ckpt, {
        **jexport.params_to_checkpoint(tree),
        **{k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(
            video_decoder_from_numpy(random_tree(VideoDecoder(dcfg), seed=13), dcfg)).items()},
        **{k: v.float().numpy() for k, v in vae_weights.encoder_to_checkpoint(
            video_encoder_from_numpy(parts["encoder"], ECFG)).items()}},
        metadata={"model_version": "2.0.0", "config": '{"transformer": {"num_attention_heads": 2, '
                                                      '"attention_head_dim": 32, "cross_attention_dim": 64}}'})
    up_cfg = SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
    from ltx2_tpu_torch.models.upscaler import spatial

    up = str(d / "upscaler.safetensors")
    jst.write_safetensors(up, {k: v.float().numpy() for k, v in spatial.upscaler_to_checkpoint(
        spatial_upscaler_from_numpy(random_tree(SpatialUpscaler(up_cfg, device="meta"), seed=8), up_cfg)).items()})
    return ckpt, up


def test_generate_main_ic_lora(parts, files, monkeypatch):
    ckpt, up = files
    out = str(parts["dir"] / "clip.y4m")
    flags = ["--control-video", parts["control"], "--control-strength", "0.9", "--height", str(HEIGHT), "--width",
             str(WIDTH), "--frames", str(FRAMES), "--seed", str(SEED)]
    videos, stats = generate.main(["--pipeline", "ic-lora", "--device", "cpu", "--checkpoint", ckpt,
                                   "--spatial-upscaler", up, "--ic-lora-weights", parts["lora"]["video"] + ":0.8",
                                   "--save-control", "--output", out, *flags])
    st = stats[0]
    assert videos[0].shape == (FRAMES, HEIGHT, WIDTH, 3) and videos[0].dtype == np.uint8 and os.path.getsize(out)
    assert all(st[f"{p}_latent_finite"] for p in ("lora_fuse", "control_encode", "stage1", "upscale", "stage2"))

    # --lora stands for the IC-LoRA when --ic-lora-weights is absent, and
    # only the other LoRAs reach the ledger's load-time fuse.
    seen = []

    def fake(seeds, control_video, **kwargs):
        seen.append((control_video, kwargs))
        return [np.zeros((FRAMES, HEIGHT, WIDTH, 3), np.uint8)], [{}]

    monkeypatch.setattr(generate, "generate_videos_ic_lora", fake)
    generate.main(["--pipeline", "ic-lora", "--device", "cpu", "--lora", "ic.safetensors:0.5", "--output", out,
                   *flags])
    control, kwargs = seen[-1]
    assert control == parts["control"] and kwargs["control_strength"] == 0.9 and kwargs["control_type"] == "raw"
    assert (kwargs["ic_lora"].path, kwargs["ic_lora"].strength) == ("ic.safetensors", 0.5)
    assert kwargs["ledger"] is None  # the routed --lora leaves nothing for a checkpoint's fuse
    from scripts.generate import _apply_reference_compat, build_parser

    jargs = _apply_reference_compat(build_parser().parse_args(
        ["--pipeline", "ic-lora", "--lora", "ic.safetensors:0.5", "--placeholder", *flags]))
    assert jargs.ic_lora_weights == "ic.safetensors:0.5" and jargs.lora == []
    assert (jargs.control_video, jargs.control_strength, jargs.control_type, jargs.canny_low, jargs.canny_high) == \
        (parts["control"], 0.9, "raw", 100, 200)
    for bad in (["--pipeline", "ic-lora", "--int8"], ["--pipeline", "distilled", "--control-video", "c.avi"],
                ["--pipeline", "ic-lora", "--image", "a.png"]):
        with pytest.raises(SystemExit):
            generate.main(bad + ["--device", "cpu", "--output", out])
    # --save-control wrote the signal stage 1 encoded (at half the size), the JAX package's bytes.
    control_avi = parts["control"] + ".control.avi"
    with open(control_avi, "rb") as fh:
        written = fh.read()
    os.unlink(control_avi)
    from ltx2_tpu_torch.utils.video_io import probe_video

    jic.create_video_conditionings([jic.VideoCondition(parts["control"], save_control=True)], lambda v: v,
                                   HEIGHT // 2, WIDTH // 2, FRAMES)
    assert probe_video(control_avi)[1:] == (FRAMES, HEIGHT // 2, WIDTH // 2)
    with open(control_avi, "rb") as fh:
        assert fh.read() == written
    os.unlink(control_avi)
