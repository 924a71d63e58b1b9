"""The port's single-stage CFG pipelines against the JAX package, in float32
on the CPU, on the same weights (2-layer DiT, the small encoder plan with
every stride kind, base-16 decoder, random latent statistics) and the same
initial noise:

- the denoise loop with CFG* (`CFGStarRescalingGuider`) and per-token
  timesteps (a conditioned frame at mask 0.05) over 3 Euler steps, to 1e-4
  of max|latent|;
- `OneStagePipeline` with an image at frame 0 (CFG* at 3.0, rescale 0.7,
  3 steps, 64x96x9): the latent within 1e-4 of max|latent|, the frames
  within one level; and with the image at strength 1.0 the frame-0 tokens
  of the final latent equal the encoder's latent bit for bit;
- `TextToVideoPipeline` (plain CFG at 5.0, 2 steps): latent and frames,
  and a post-hoc upscaler in the un-normalize / re-normalize bracket;
- every loop option (token bucket, guidance reuse, STG, a guider
  override, GE, Heun, the cross-attention scale, text-KV caching) through
  the pipeline against the JAX package's, the latent to 1e-4; STG on the
  audio stream raises ValueError on this video-only pipeline, and each
  unported option (meshes, prepare_data --videos on a GIF, the training
  mesh flags) raises NotImplementedError naming itself;
- `generate.main(["--pipeline", "one-stage", "--image", ...])` from a tiny
  checkpoint against `generate_videos_one_stage` on the same ledger, and
  `--pipeline text-to-video`; with `--token-shift` its config and sigmas
  against the JAX CLI's.
Decode noise is off (scale 0): each package draws it from its own RNG.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import CFGStarRescalingGuider as JCFGStar
from ltx2_tpu.components import schedulers as jschedulers
from ltx2_tpu.components.noisers import _blend as jblend
from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning import latent as jlatent
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.pipelines import denoise as jdenoise
from ltx2_tpu.pipelines.one_stage import OneStageCFGConfig as JOneStageCFGConfig
from ltx2_tpu.pipelines.one_stage import OneStagePipeline as JOneStagePipeline
from ltx2_tpu.pipelines.text_to_video import TextToVideoConfig as JTextToVideoConfig
from ltx2_tpu.pipelines.text_to_video import TextToVideoPipeline as JTextToVideoPipeline
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu_torch import generate, prepare_data, train
from ltx2_tpu_torch.components import schedulers
from ltx2_tpu_torch.components.guiders import CFGStarRescalingGuider, LtxAPGGuider, StatefulAPGGuider
from ltx2_tpu_torch.components.noisers import GaussianNoiser
from ltx2_tpu_torch.components.patchifiers import VideoLatentPatchifier
from ltx2_tpu_torch.conditioning.latent import VideoConditionByLatentIndex
from ltx2_tpu_torch.conditioning.tools import VideoLatentTools
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, video_decoder_from_numpy, video_encoder_from_numpy
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.models.video_vae.encoder import video_encoder_apply
from ltx2_tpu_torch.pipelines.common import ImageCondition, load_image_tensor
from ltx2_tpu_torch.pipelines.denoise import (
    DenoiseLoopConfig, MultiModalLoopConfig, make_multimodal_av_denoise_loop, make_video_denoise_loop,
)
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline
from ltx2_tpu_torch.pipelines.text_to_video import TextToVideoConfig, TextToVideoPipeline
from ltx2_tpu_torch.types import VideoLatentShape
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import CFG, JCFG, assert_close, make_guiders, numpy_tree, random_tree, t, write_png
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None), ("down", 16, 16, (2, 1, 1)),
        ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)), ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)),
        ("res", 32, 1, None))
JECFG = jencoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
ECFG = encoder.VideoEncoderConfig(plan=PLAN, latent_channels=16)
JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
HEIGHT, WIDTH, FRAMES, SEED = 64, 96, 9, 7
TOKENS = 2 * 2 * 3


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("one_stage")
    return {
        "dit": numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=1),
        "encoder": random_tree(encoder.VideoEncoder(ECFG, device="meta"), seed=2),
        "decoder": random_tree(VideoDecoder(DCFG), seed=3),
        "pos": (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32),
        "neg": (rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32),
        "image": write_png(str(d / "image.png"), rng.integers(0, 256, (80, 100, 3), dtype=np.uint8)),
    }


def _port(weights):
    return (dit_from_numpy(weights["dit"], CFG), video_encoder_from_numpy(weights["encoder"], ECFG),
            video_decoder_from_numpy(weights["decoder"], DCFG))


def _jax_pipeline(cls, weights):
    return cls(transformer_params=_jtree(weights["dit"]), transformer_cfg=JCFG,
               video_encoder_params=_jtree(weights["encoder"]), video_encoder_cfg=JECFG,
               video_decoder_params=_jtree(weights["decoder"]), video_decoder_cfg=JDCFG)


def _jax_noise(seed: int) -> torch.Tensor:
    """The one-stage noise as the JAX pipeline draws it: PRNGKey(seed) split
    in 4, the second key."""
    noise_key = jax.random.split(jax.random.PRNGKey(seed), 4)[1]
    return t(np.asarray(jax.random.normal(noise_key, (1, TOKENS, 16), jnp.float32)))


def test_denoise_loop_cfg_star_per_token(weights):
    shape = (1, 16, 2, 2, 3)
    rng = np.random.default_rng(8)
    clean = rng.standard_normal((1, 16, 1, 2, 3)).astype(np.float32)
    noise = rng.standard_normal((1, TOKENS, 16)).astype(np.float32)
    sigmas = np.array([1.0, 0.8, 0.3, 0.0], np.float32)
    jtools = JTools(JPatchifier(1), JShape(*shape), fps=24.0)
    jstate = jlatent.VideoConditionByLatentIndex(jnp.asarray(clean), 0.95, 0).apply_to(
        jtools.create_initial_state(), jtools)
    jstate = jblend(jstate, jnp.asarray(noise), 1.0)
    jloop = jdenoise.make_video_denoise_loop(JCFG, jdenoise.DenoiseLoopConfig(guider=JCFGStar(3.0)))
    ref = jloop(_jtree(weights["dit"]), jstate, jnp.asarray(sigmas), jnp.asarray(weights["pos"]),
                jnp.asarray(weights["neg"]))

    tools = VideoLatentTools(VideoLatentPatchifier(1), VideoLatentShape(*shape), fps=24.0)
    state = VideoConditionByLatentIndex(t(clean), 0.95, 0).apply_to(tools.create_initial_state(), tools)
    state = GaussianNoiser()(None, state, 1.0, noise=t(noise))
    loop = make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=CFGStarRescalingGuider(3.0)))
    out = loop(_port(weights)[0], state, t(sigmas), t(weights["pos"]), t(weights["neg"]))
    assert_close(out.latent, ref.latent, msg="CFG* loop, per-token timesteps")
    assert_close(out.denoise_mask, ref.denoise_mask, rtol=0, msg="mask")


def test_one_stage_with_image_matches_jax(weights):
    jpipe = _jax_pipeline(JOneStagePipeline, weights)
    jconfig = JOneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                                 latent_channels=16)
    images = [jcommon.ImageCondition(weights["image"], 0, 0.9)]
    pos, neg = jnp.asarray(weights["pos"]), jnp.asarray(weights["neg"])
    ref_latent, _ = jpipe(pos, neg, jconfig, images=images, skip_decode=True)
    ref_frames, _ = jpipe(pos, neg, jconfig, images=images)

    dit, enc, dec = _port(weights)
    pipe = OneStagePipeline(dit, video_encoder=enc, video_decoder=dec)
    config = OneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                               latent_channels=16)
    cond = [ImageCondition(weights["image"], 0, 0.9)]
    phases = []
    latent, audio = pipe(t(weights["pos"]), t(weights["neg"]), config, images=cond, skip_decode=True,
                         noise=_jax_noise(SEED), callback=lambda phase, z: phases.append(phase))
    assert audio is None and phases == ["image_encode", "denoise"]
    assert_close(latent, np.asarray(ref_latent), msg="one-stage latent with an image")
    frames, _ = pipe(t(weights["pos"]), t(weights["neg"]), config, images=cond, noise=_jax_noise(SEED))
    assert frames.shape == ref_frames.shape == (FRAMES, HEIGHT, WIDTH, 3) and frames.dtype == np.uint8
    assert np.abs(frames.astype(int) - np.asarray(ref_frames).astype(int)).max() <= 1

    # Strength 1.0: mask 0 keeps frame 0's tokens clean through every step,
    # bit for bit the encoder's latent; at 0.9 they move.
    encoded = video_encoder_apply(enc, load_image_tensor(weights["image"], HEIGHT, WIDTH))
    for strength, exact in ((1.0, True), (0.9, False)):
        out, _ = pipe(t(weights["pos"]), t(weights["neg"]), config, skip_decode=True, noise=_jax_noise(SEED),
                      images=[ImageCondition(weights["image"], 0, strength)])
        assert torch.equal(out[:, :, :1], encoded) == exact, strength


def test_text_to_video_matches_jax(weights):
    jpipe = _jax_pipeline(JTextToVideoPipeline, weights)
    jconfig = JTextToVideoConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=2,
                                 latent_channels=16)
    pos, neg = jnp.asarray(weights["pos"]), jnp.asarray(weights["neg"])
    ref_latent, _ = jpipe(pos, neg, jconfig, skip_decode=True)
    ref_frames, _ = jpipe(pos, neg, jconfig)

    dit, enc, dec = _port(weights)
    pipe = TextToVideoPipeline(dit, video_decoder=dec)
    config = TextToVideoConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=2,
                               latent_channels=16)
    one = config.to_one_stage()
    assert (one.cfg_scale, one.rescale_scale) == (5.0, 0.0) and dataclasses.asdict(one) == {
        k: v for k, v in dataclasses.asdict(jconfig.to_one_stage()).items() if k in dataclasses.asdict(one)}
    latent, _ = pipe(t(weights["pos"]), t(weights["neg"]), config, skip_decode=True, noise=_jax_noise(SEED))
    assert_close(latent, np.asarray(ref_latent), msg="text-to-video latent")
    frames, _ = pipe(t(weights["pos"]), t(weights["neg"]), config, noise=_jax_noise(SEED))
    assert np.abs(frames.astype(int) - np.asarray(ref_frames).astype(int)).max() <= 1
    # The post-hoc upscaler runs inside the un-normalize / re-normalize bracket.
    ref_up, _ = jpipe(pos, neg, jconfig, skip_decode=True, spatial_upscaler=lambda z: z * 1.5 + 0.25)
    phases = []
    up, _ = pipe(t(weights["pos"]), t(weights["neg"]), config, skip_decode=True, noise=_jax_noise(SEED),
                 spatial_upscaler=lambda z: z * 1.5 + 0.25, callback=lambda phase, z: phases.append(phase))
    assert phases == ["denoise", "upscale"]
    assert_close(up, np.asarray(ref_up), msg="post-hoc upscale bracket")
    assert OneStageCFGConfig(height=480, width=704, num_frames=97).effective_tiling() is not None  # 13x15x22 > 4000


def _gif_directory() -> str:
    """A directory holding one GIF, which prepare_data --videos refuses."""
    import tempfile

    directory = tempfile.mkdtemp(prefix="ltx2_gif_")
    with open(os.path.join(directory, "anim.gif"), "wb") as fh:
        fh.write(b"GIF89a")
    return directory


# option -> (a word its message must name, the call that must refuse it)
UNPORTED = {
    "prepare_data_videos": ("GIF, APNG and WebP readers", lambda p, c, x: prepare_data.main(
        ["--videos", _gif_directory(), "--context-dim", "8", "--device", "cpu"])),
    "train_mesh_flags": ("one device", lambda p, c, x: train.main(
        ["--placeholder", "--device", "cpu", "--synthetic", "1", "2", "2", "--zero1"])),
    "meshes": ("meshes", lambda p, c, x: OneStagePipeline(p.transformer, sequence_mesh=object())),
    "multimodal_loop_meshes": ("parallelism", lambda p, c, x: make_multimodal_av_denoise_loop(
        p.transformer.cfg, MultiModalLoopConfig(), mesh=object())),
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_options_raise(weights, option):
    pipe = OneStagePipeline(_port(weights)[0])
    config = OneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, latent_channels=16)
    word, call = UNPORTED[option]
    with pytest.raises(NotImplementedError) as err:
        call(pipe, config, t(weights["pos"]))
    assert "not ported" in str(err.value) and word in str(err.value), str(err.value)


def test_stg_mode_audio_refused_on_a_video_only_run(weights):
    pipe = OneStagePipeline(_port(weights)[0])
    config = OneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, latent_channels=16)
    x = t(weights["pos"])
    for mode in ("audio", "both"):
        with pytest.raises(ValueError, match="requires the audio branch"):
            pipe(x, x, config, stg_scale=1.0, stg_mode=mode)


# option -> (OneStageCFGConfig fields, pipeline keywords); a guider is given
# as (class name, kwargs) and built in each package. 3 steps, no image but
# for the token bucket (per-token timesteps and the padding together).
OPTIONS = {
    "token_bucket": ({"token_bucket": 16}, {"stg_scale": 1.0}),
    "cfg_interval": ({"cfg_interval": 2}, {}),
    "STG": ({}, {"stg_scale": 1.0, "stg_blocks": [1], "stg_cutoff": 0.7}),
    "guider_override": ({}, {"guider_override": ("LtxAPGGuider", {"scale": 3.0, "eta": 0.5, "norm_threshold": 1.0})}),
    "GE": ({}, {"ge_gamma": 0.5}),
    "Heun": ({}, {"sampler": "heun"}),
    "cross_attn_scale": ({}, {"cross_attn_scale": 0.5, "cross_attn_start_block": 1}),
    "cache_text_kv": ({}, {"cache_text_kv": True}),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_one_stage_option_matches_jax(weights, option):
    """Each loop option through OneStagePipeline against the JAX package's
    pipeline (CFG* at 3.0, rescale 0.7), the final latent to 1e-4."""
    fields, kwargs = OPTIONS[option]
    jkwargs, kwargs = dict(kwargs), dict(kwargs)
    if "guider_override" in kwargs:
        jkwargs["guider_override"], kwargs["guider_override"] = make_guiders(kwargs["guider_override"])
    images = option == "token_bucket"
    jpipe = _jax_pipeline(JOneStagePipeline, weights)
    jconfig = JOneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                                 latent_channels=16, **fields)
    ref, _ = jpipe(jnp.asarray(weights["pos"]), jnp.asarray(weights["neg"]), jconfig, skip_decode=True,
                   images=[jcommon.ImageCondition(weights["image"], 0, 0.9)] if images else None, **jkwargs)
    dit, enc, _ = _port(weights)
    config = OneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                               latent_channels=16, **fields)
    latent, _ = OneStagePipeline(dit, video_encoder=enc)(
        t(weights["pos"]), t(weights["neg"]), config, skip_decode=True, noise=_jax_noise(SEED),
        images=[ImageCondition(weights["image"], 0, 0.9)] if images else None, **kwargs)
    assert_close(latent, np.asarray(ref), msg=option)


SIZE = ["--height", str(HEIGHT), "--width", str(WIDTH), "--frames", str(FRAMES), "--seed", str(SEED)]


def _out(checkpoint):
    """The CLI's --output: a .y4m beside the checkpoint (the default .mp4 needs ffmpeg)."""
    return ["--output", os.path.join(os.path.dirname(checkpoint), "out.y4m")]


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    """A tiny unified checkpoint: the DiT, decoder and encoder as the ledger
    loads them (bf16 DiT and decoder, fp32 encoder)."""
    tensors = {**jexport.params_to_checkpoint(weights["dit"]),
               **{k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(_port(weights)[2]).items()},
               **{k: v.float().numpy() for k, v in vae_weights.encoder_to_checkpoint(_port(weights)[1]).items()}}
    path = str(tmp_path_factory.mktemp("one_stage_ckpt") / "ltx.safetensors")
    jst.write_safetensors(path, tensors, metadata={"model_version": "2.0.0", "config": '{"transformer": '
                                                   '{"num_attention_heads": 2}}'})
    return path


def test_generate_main_one_stage_and_text_to_video(weights, checkpoint):
    """The CLI from a tiny checkpoint against the entry function on the
    same ledger; then the plain-CFG text-to-video route."""
    path, size = checkpoint, SIZE + _out(checkpoint)
    videos, stats = generate.main(["--pipeline", "one-stage", "--device", "cpu", "--checkpoint", path, "--image",
                                   f"{weights['image']}:0", "--image-strength", "0.8", "--num-inference-steps", "2",
                                   *size])
    st = stats[0]
    assert videos[0].shape == (FRAMES, HEIGHT, WIDTH, 3) and videos[0].dtype == np.uint8
    assert st["denoise_latent_finite"] and st["image_encode_latent_finite"] and st["decode_tiles"] == 0
    assert st["attention_launches"] == 0 and st["image_encode_conv_launches"] == st["decode_conv_launches"] == 0
    ref, _ = generate.generate_videos_one_stage(
        [SEED], height=HEIGHT, width=WIDTH, frames=FRAMES, steps=2, device="cpu",
        images=[ImageCondition(weights["image"], 0, 0.8)],
        ledger=ModelLedger(path, decoder_dtype="bfloat16", device="cpu"))
    np.testing.assert_array_equal(videos[0], ref[0])
    t2v, _ = generate.main(["--pipeline", "text-to-video", "--device", "cpu", "--checkpoint", path,
                            "--num-inference-steps", "2", *size])
    assert t2v[0].shape == (FRAMES, HEIGHT, WIDTH, 3) and not np.array_equal(t2v[0], videos[0])
    with pytest.raises(SystemExit):
        generate.main(["--image", weights["image"], "--device", "cpu"])  # bench-e2e takes no image
    assert generate.parse_image_spec("a.png:2:0.5") == ImageCondition("a.png", 2, 0.5)
    assert generate.parse_image_spec("a.png", 0.7) == ImageCondition("a.png", 0, 0.7)


def test_generate_main_text_to_video_token_shift(checkpoint, monkeypatch):
    """`--pipeline text-to-video --token-shift` builds the JAX CLI's config
    (scripts/generate.py: the one-stage config at --cfg-scale with rescale
    0 and the token shift) and schedules the JAX package's sigmas at the
    clip's token count, not the 4096-token anchor (3 steps: at 2 the
    stretch gives [1, 0.1, 0] whatever the shift)."""
    seen = {}
    call, execute = OneStagePipeline.__call__, schedulers.LTX2Scheduler.execute

    def record_call(self, positive, negative, config, **kwargs):
        seen["config"] = config
        return call(self, positive, negative, config, **kwargs)

    def record_execute(self, *args, **kwargs):
        seen["sigmas"] = execute(self, *args, **kwargs)
        return seen["sigmas"]

    monkeypatch.setattr(OneStagePipeline, "__call__", record_call)
    monkeypatch.setattr(schedulers.LTX2Scheduler, "execute", record_execute)
    generate.main(["--pipeline", "text-to-video", "--token-shift", "--device", "cpu", "--checkpoint", checkpoint,
                   "--num-inference-steps", "3", *SIZE, *_out(checkpoint)])
    jconfig = JOneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                                 cfg_scale=3.0, rescale_scale=0.0, token_dependent_shift=True)
    config = dataclasses.asdict(seen["config"])
    assert {k: v for k, v in config.items() if k not in ("dtype", "latent_channels")} == {
        k: v for k, v in dataclasses.asdict(jconfig).items() if k in config and k not in ("dtype", "latent_channels")}
    want = jschedulers.LTX2Scheduler().execute(steps=3, tokens=TOKENS)
    assert seen["sigmas"].dtype == np.float32 and np.array_equal(seen["sigmas"], want)
    assert not np.array_equal(want, jschedulers.LTX2Scheduler().execute(steps=3))  # the shift moves them


def test_generate_main_loop_flags(checkpoint, monkeypatch):
    """The loop flags keep the JAX CLI's names and defaults
    (scripts/generate.py's parser), reach the pipeline as that CLI passes
    them (`--apg-*` builds LtxAPGGuider, or with a momentum
    StatefulAPGGuider, as the JAX CLI does), and run; off the CFG flows
    they are refused."""
    from scripts.generate import build_parser as jax_parser

    argv = ["--stg-scale", "1.0", "--stg-blocks", "0,1", "--stg-cutoff", "0.7", "--apg-scale", "3", "--apg-eta", "0.5",
            "--apg-norm-threshold", "1.0", "--ge-gamma", "0.5", "--sampler", "heun", "--cfg-interval", "2",
            "--token-bucket", "16", "--cross-attn-scale", "0.5", "--cross-attn-start-block", "1", "--cache-text-kv"]
    jdefaults, jargs = jax_parser().parse_args([]), jax_parser().parse_args(argv)
    seen = {}
    call = OneStagePipeline.__call__

    def record_call(self, positive, negative, config, **kwargs):
        seen["config"], seen["kwargs"] = config, kwargs
        return call(self, positive, negative, config, **kwargs)

    monkeypatch.setattr(OneStagePipeline, "__call__", record_call)
    generate.main(["--pipeline", "text-to-video", "--device", "cpu", "--checkpoint", checkpoint,
                   "--num-inference-steps", "3", *SIZE, *_out(checkpoint)])  # every loop flag at its default
    assert set(generate.LOOP_FLAGS) <= set(vars(jdefaults))  # the JAX CLI's names
    defaults = seen["kwargs"]
    assert seen["config"].cfg_interval == jdefaults.cfg_interval == 1
    assert seen["config"].token_bucket == jdefaults.token_bucket == 0
    assert defaults["guider_override"] is None and not jdefaults.apg_scale
    for name in ("stg_scale", "stg_cutoff", "stg_mode", "ge_gamma", "sampler", "cross_attn_scale",
                 "cross_attn_start_block", "cache_text_kv"):
        assert defaults[name] == getattr(jdefaults, name), name
    assert defaults["stg_blocks"] is None and jdefaults.stg_blocks is None

    videos, stats = generate.main(["--pipeline", "text-to-video", "--device", "cpu", "--checkpoint", checkpoint,
                                   "--num-inference-steps", "3", *SIZE, *_out(checkpoint), *argv])
    assert videos[0].shape == (FRAMES, HEIGHT, WIDTH, 3) and stats[0]["denoise_latent_finite"]
    kwargs, config = seen["kwargs"], seen["config"]
    assert (config.cfg_interval, config.token_bucket) == (jargs.cfg_interval, jargs.token_bucket) == (2, 16)
    assert kwargs["stg_blocks"] == [int(b) for b in jargs.stg_blocks.split(",")] == [0, 1]
    for name in ("stg_scale", "stg_cutoff", "stg_mode", "ge_gamma", "sampler", "cross_attn_scale",
                 "cross_attn_start_block", "cache_text_kv"):
        assert kwargs[name] == getattr(jargs, name), name
    assert kwargs["guider_override"] == LtxAPGGuider(scale=3.0, eta=0.5, norm_threshold=1.0)
    generate.main(["--pipeline", "one-stage", "--device", "cpu", "--checkpoint", checkpoint, "--num-inference-steps",
                   "2", *SIZE, *_out(checkpoint), "--apg-scale", "3", "--apg-momentum", "0.5"])
    assert seen["kwargs"]["guider_override"] == StatefulAPGGuider(scale=3.0, eta=1.0, norm_threshold=0.0,
                                                                  momentum=0.5)
    for pipeline in ("bench-e2e", "distilled"):
        with pytest.raises(SystemExit):
            generate.main(["--pipeline", pipeline, "--device", "cpu", "--sampler", "heun"])


def test_generate_main_upscale_spatial(weights, checkpoint, tmp_path):
    """`--upscale-spatial` with the upscaler's file: the 2x upscaler runs
    after the loop in the decoder statistics' bracket (the JAX package's
    spatial upscaler on the same weights and latent), and the decoder
    decodes at twice the size."""
    from ltx2_tpu.models.upscaler import spatial as jspatial
    from ltx2_tpu_torch.loader.from_numpy import spatial_upscaler_from_numpy
    from ltx2_tpu_torch.models.upscaler import spatial

    up_cfg = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
    jup_cfg = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
    tree = random_tree(spatial.SpatialUpscaler(up_cfg, device="meta"), seed=9)
    path = str(tmp_path / "upscaler.safetensors")
    jst.write_safetensors(path, {k: v.float().numpy() for k, v in spatial.upscaler_to_checkpoint(
        spatial_upscaler_from_numpy(tree, up_cfg)).items()})
    latents = {}
    call = OneStagePipeline.__call__

    def record(self, positive, negative, config, callback=None, **kwargs):
        def on_phase(phase, z):
            latents[phase] = z
            callback(phase, z)
        return call(self, positive, negative, config, callback=on_phase, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(OneStagePipeline, "__call__", record)
        videos, stats = generate.main(["--pipeline", "one-stage", "--device", "cpu", "--checkpoint", checkpoint,
                                       "--num-inference-steps", "2", *SIZE, *_out(checkpoint), "--upscale-spatial",
                                       "--spatial-upscaler", path])
    assert videos[0].shape == (FRAMES, 2 * HEIGHT, 2 * WIDTH, 3)
    assert stats[0]["upscale_latent_finite"] and stats[0]["upscale_conv_launches"] == 0
    stats_ = vae_weights.load_per_channel_statistics(checkpoint, 16, "cpu")
    mean, std = (np.asarray(getattr(stats_, n)).reshape(1, -1, 1, 1, 1) for n in ("mean_of_means", "std_of_means"))
    z = latents["denoise"].float().numpy()
    ref = (np.asarray(jspatial.spatial_upscaler_apply(_jtree(tree), jup_cfg, jnp.asarray(z * std + mean))) - mean) / std
    assert_close(latents["upscale"], ref, rtol=1e-4, msg="post-hoc upscale from the file")
    with pytest.raises(SystemExit):
        generate.main(["--pipeline", "one-stage", "--device", "cpu", "--spatial-upscaler", path])
