"""Real prompts in and video files out, on the CPU:

- `ltx2_tpu_torch.utils.video_io.write_y4m` against the JAX package's
  `write_y4m`, byte for byte;
- `python -m ltx2_tpu_torch.generate --pipeline distilled --checkpoint
  <V2 file> --gemma-dir <shards + tokenizer.json> --spatial-upscaler ...
  --prompt ... --output out.y4m` from tiny files written here: the prompt
  ids Gemma receives equal `transformers.AutoTokenizer`'s (the JAX CLI's
  call), the .y4m equals the JAX writer's bytes of the returned frames,
  `--save-embedding` writes the JAX CLI's four V2 keys, `--embedding` of
  that file gives the same clip, `--skip-vae` writes `latent`; the same
  prompt through `--pipeline one-stage` and `text-to-video`;
- `--fps`, `--speed`, `--num-frames`, `--dtype` and the tile flags reach
  the pipeline (the position grid at fps 12 against the JAX package's);
- refusals at argument parsing, before any model is built: `.avi`, `.mov`,
  and `.mp4` without ffmpeg, `--prompt` without a tokenizer.json.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu.utils import video_io as jvideo_io
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.export import iter_checkpoint_specs
from ltx2_tpu_torch.loader.safetensors_io import write_safetensors, write_safetensors_streaming
from ltx2_tpu_torch.models.text_encoder import encoder, gemma3
from ltx2_tpu_torch.models.transformer.model import LTXModel, init_ltx_model_
from ltx2_tpu_torch.models.upscaler import spatial
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig, init_video_decoder_
from ltx2_tpu_torch.pipelines.distilled import DistilledPipeline
from ltx2_tpu_torch.utils import video_io
from tests.torch_port_util import CFG, write_tokenizer

transformers = pytest.importorskip("transformers")

BLOCKS = [["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}]]
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                          decoder_blocks=vae_weights.normalize_decoder_blocks(BLOCKS))
UPCFG = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
GCFG = gemma3.Gemma3Config.tiny()
# The V2 text encoder above the tiny Gemma: the video connector 4 x 64 (the
# DiT's 256-wide context), the audio one 4 x 16, 2 gated blocks each.
TE2 = encoder.text_encoder_config_v2(hidden_dim=GCFG.hidden_size, num_gemma_layers=GCFG.num_hidden_layers + 1,
                                     video_heads=4, video_head_dim=64, audio_heads=4, audio_head_dim=16, layers=2,
                                     registers=8)
V2 = dataclasses.replace(CFG, cross_attention_adaln=True, apply_gated_attention=True)
V2_META = {"model_version": "2.3.0", "config": json.dumps({
    "transformer": {"num_attention_heads": 2, "connector_num_attention_heads": 4, "connector_attention_head_dim": 64,
                    "audio_connector_num_attention_heads": 4, "audio_connector_attention_head_dim": 16},
    "vae": {"decoder_blocks": BLOCKS}})}
H = W = 64
FRAMES, SEED = 9, 5
PROMPT = "a red fox runs through snow at dawn <extra> 😀"


@pytest.mark.parametrize("shape,fps", [((3, 16, 24), 24.0), ((2, 7, 5), 23.976), ((1, 8, 8), 12.5)])
def test_write_y4m_matches_jax(tmp_path, shape, fps):
    frames = np.random.default_rng(0).integers(0, 256, (*shape, 3), dtype=np.uint8)
    frames[0, 0, 0] = (255, 0, 0)
    frames[-1, -1, -1] = (0, 0, 255)
    ours, theirs = str(tmp_path / "a.y4m"), str(tmp_path / "b.y4m")
    video_io.write_y4m(ours, frames, fps)
    jvideo_io.write_y4m(theirs, frames, fps)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    f, h, w = shape
    assert len(data) == len(video_io.y4m_header(w, h, fps)) + f * (6 + 3 * h * w)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny V2 checkpoint (2-layer 2 x 128 V2 DiT, base-16 VAE decoder,
    the V2 projection and both gated connectors), the upscaler's file and a
    Gemma directory (tiny Gemma-3 shard and a tokenizer.json), by the port's
    writers; random weights from torch generators."""
    d = tmp_path_factory.mktemp("v2_files")
    gen = torch.Generator().manual_seed(0)
    dit = init_ltx_model_(LTXModel(V2), gen)
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).mul_(0.3)
    decoder = init_video_decoder_(VideoDecoder(DCFG), gen)
    te = encoder.init_text_encoder_(encoder.VideoTextEncoder(TE2), gen)
    others = {**vae_weights.decoder_to_checkpoint(decoder), **encoder.text_encoder_to_checkpoint(te)}
    paths = {"checkpoint": str(d / "ltx-2.3.safetensors"), "upscaler": str(d / "upscaler.safetensors"),
             "gemma": write_tokenizer(d / "gemma")}
    write_safetensors_streaming(paths["checkpoint"], [
        *iter_checkpoint_specs(dit), *((k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in others.items())],
        metadata=V2_META)
    write_safetensors(paths["upscaler"], spatial.upscaler_to_checkpoint(
        spatial.init_spatial_upscaler_(spatial.SpatialUpscaler(UPCFG), gen)))
    gemma = gemma3.init_gemma3_(gemma3.Gemma3(GCFG), gen)
    write_safetensors(os.path.join(paths["gemma"], "model-00001-of-00001.safetensors"),
                      gemma3.gemma_to_checkpoint(gemma))
    return paths


def _argv(files, out, *extra, pipeline="distilled"):
    return ["--pipeline", pipeline, "--device", "cpu", "--height", str(H), "--width", str(W), "--num-frames",
            str(FRAMES), "--seed", str(SEED), "--checkpoint", files["checkpoint"], "--gemma-dir", files["gemma"],
            "--output", str(out), *extra] + (["--spatial-upscaler", files["upscaler"]] if pipeline == "distilled"
                                             else ["--num-inference-steps", "2"])


def _record_ids(monkeypatch):
    seen = []
    apply = generate.gemma3_apply

    def record(model, ids, mask, *args, **kwargs):
        seen.append((ids.cpu().numpy(), mask.cpu().numpy()))
        return apply(model, ids, mask, *args, **kwargs)

    monkeypatch.setattr(generate, "gemma3_apply", record)
    return seen


def test_v2_prompt_to_y4m(files, tmp_path, monkeypatch):
    seen = _record_ids(monkeypatch)
    out, emb = tmp_path / "clip.y4m", str(tmp_path / "emb.npz")
    videos, stats = generate.main(_argv(files, out, "--prompt", PROMPT, "--save-embedding", emb))
    st = stats[0]
    assert videos[0].shape == (FRAMES, H, W, 3) and videos[0].dtype == np.uint8
    assert st["prompt_source"] == "tokenizer" and st["output"] == str(out)
    assert st["context_finite"] and st["stage1_latent_finite"] and st["stage2_latent_finite"]

    ref = transformers.AutoTokenizer.from_pretrained(files["gemma"], padding_side="left")
    enc = ref([PROMPT, generate.DEFAULT_NEGATIVE_PROMPT], return_tensors="np", padding="max_length",
              truncation=True, max_length=1024)
    (ids, mask), = seen
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])
    assert (st["prompt_tokens"], st["negative_tokens"]) == tuple(int(n) for n in enc["attention_mask"].sum(1))

    jvideo_io.write_y4m(str(tmp_path / "jax.y4m"), videos[0], 24.0)
    assert out.read_bytes() == (tmp_path / "jax.y4m").read_bytes()

    with np.load(emb) as data:
        saved = {k: data[k] for k in data.files}
    assert set(saved) == {"positive", "negative", "positive_audio", "negative_audio"}
    assert saved["positive"].shape == (1, 1024, 256) and saved["positive_audio"].shape == (1, 1024, 64)
    assert not np.array_equal(saved["positive"], saved["negative"])

    again, stats2 = generate.main(_argv(files, tmp_path / "again.y4m", "--embedding", emb))
    assert stats2[0]["prompt_source"] == "embedding" and len(seen) == 1  # Gemma did not run
    np.testing.assert_array_equal(again[0], videos[0])

    latents, _ = generate.main(_argv(files, tmp_path / "lat.y4m", "--embedding", emb, "--skip-vae"))
    with np.load(tmp_path / "lat_latent.npz") as data:
        assert data.files == ["latent"] and data["latent"].shape == (1, 16, 2, 2, 2)
        np.testing.assert_array_equal(data["latent"], latents[0])


@pytest.mark.parametrize("pipeline", ["one-stage", "text-to-video"])
def test_v2_prompt_cfg_flows(files, tmp_path, monkeypatch, pipeline):
    seen = _record_ids(monkeypatch)
    videos, stats = generate.main(_argv(files, tmp_path / "c.y4m", "--prompt", PROMPT, "--negative-prompt",
                                        "blurry", pipeline=pipeline))
    assert videos[0].shape == (FRAMES, H, W, 3) and stats[0]["denoise_latent_finite"]
    ref = transformers.AutoTokenizer.from_pretrained(files["gemma"], padding_side="left")
    want = ref([PROMPT, "blurry"], return_tensors="np", padding="max_length", truncation=True, max_length=1024)
    np.testing.assert_array_equal(seen[0][0], want["input_ids"])
    assert (tmp_path / "c.y4m").stat().st_size == len(video_io.y4m_header(W, H, 24.0)) + FRAMES * (6 + 3 * H * W)


def test_fps_tiles_and_dtype_reach_the_pipeline(files, tmp_path, monkeypatch):
    """--fps 12 is the config's rate (the position grid's temporal axis in
    seconds: the JAX package's tools at fps 12 give the same positions),
    --speed scales the container's, the tile flags make the JAX CLI's
    tiling, --dtype the DiT's compute dtype; two requests write two files."""
    seen = {}
    call = DistilledPipeline.__call__

    def record(self, context, config, **kwargs):
        seen["config"], seen["dtype"] = config, self.transformer.cfg.compute_dtype
        return call(self, context, config, **kwargs)

    monkeypatch.setattr(DistilledPipeline, "__call__", record)
    out = tmp_path / "clip.y4m"
    generate.main(_argv(files, out, "--fps", "12", "--speed", "2", "--tile-size", "64", "--tile-overlap", "32",
                        "--temporal-tile-size", "16", "--temporal-tile-overlap", "8", "--dtype", "float32",
                        "--requests", "2", "--embedding", _embedding(files, tmp_path)))
    config = seen["config"]
    assert config.fps == 12.0 and seen["dtype"] == "float32"
    tiling = config.tiling_config
    assert (tiling.spatial_config.tile_size_in_pixels, tiling.spatial_config.tile_overlap_in_pixels) == (64, 32)
    assert (tiling.temporal_config.tile_size_in_frames, tiling.temporal_config.tile_overlap_in_frames) == (16, 8)
    for i in range(2):
        assert (tmp_path / f"clip_{i}.y4m").read_bytes().startswith(video_io.y4m_header(W, H, 24.0))
    tools = generate.make_latent_tools(V2, H, W, FRAMES, fps=config.fps)
    jtools = JTools(JPatchifier(1), JShape(1, 16, 2, 2, 2), fps=12.0)
    np.testing.assert_array_equal(tools.create_initial_state().positions.numpy(),
                                  np.asarray(jtools.create_initial_state().positions))
    assert not np.array_equal(generate.make_latent_tools(V2, H, W, FRAMES).create_initial_state().positions.numpy(),
                              np.asarray(jtools.create_initial_state().positions))


def _embedding(files, tmp_path):
    path = str(tmp_path / "e.npz")
    rng = np.random.default_rng(1)
    np.savez(path, positive=rng.standard_normal((1, 32, 256)).astype(np.float32) * 0.1,
             negative=rng.standard_normal((1, 32, 256)).astype(np.float32) * 0.1)
    return path


@pytest.mark.parametrize("output,word", [("o.avi", "JPEG"), ("o.mov", "JPEG"), ("o.mp4", "ffmpeg"),
                                         ("o.mkv", "ffmpeg")])
def test_outputs_refused_before_any_model(files, tmp_path, monkeypatch, capsys, output, word):
    monkeypatch.setattr(video_io.shutil, "which", lambda name: None)

    def built(*args, **kwargs):
        raise AssertionError("a model was built before the output was checked")

    monkeypatch.setattr(generate, "ModelLedger", built)
    monkeypatch.setattr(generate, "make_dit", built)
    for pipeline in ("distilled", "bench-e2e"):
        argv = ["--pipeline", pipeline, "--device", "cpu", "--output", str(tmp_path / output)]
        with pytest.raises(SystemExit):
            generate.main(argv)
        assert word in capsys.readouterr().err
    with pytest.raises(ValueError, match=word):
        video_io.save_video(np.zeros((1, 8, 8, 3), np.uint8), str(tmp_path / output), 24.0)


def test_prompt_refusals(files, tmp_path, capsys, monkeypatch):
    """An explicit --prompt needs a tokenizer.json (no quiet switch to
    seeded ids); so does --gemma-dir; --embedding excludes
    --text-encoder; --save-embedding needs the encoder."""
    monkeypatch.setattr(generate, "ModelLedger", lambda *a, **k: pytest.fail("a model was built"))
    bare = tmp_path / "bare"
    bare.mkdir()
    cases = [
        (["--pipeline", "distilled", "--prompt", "x"], "tokenizer.json"),
        (["--pipeline", "distilled", "--text-encoder", "--negative-prompt", "x"], "tokenizer.json"),
        (["--pipeline", "distilled", "--checkpoint", files["checkpoint"], "--gemma-dir", str(bare)], "tokenizer.json"),
        (["--pipeline", "distilled", "--embedding", "e.npz", "--text-encoder"], "exclusive"),
        (["--pipeline", "one-stage", "--save-embedding", "e.npz"], "--save-embedding"),
        (["--prompt", "x"], "--pipeline"),
    ]
    for argv, word in cases:
        with pytest.raises(SystemExit):
            generate.main([*argv, "--device", "cpu", "--output", str(tmp_path / "o.y4m")])
        assert word in capsys.readouterr().err, argv
    assert generate.output_paths("a/b.c.y4m", 1) == ["a/b.c.y4m"]
    assert generate.output_paths("out.y4m", 2, "_latent.npz") == ["out_0_latent.npz", "out_1_latent.npz"]
    ids, mask = generate.tokenize_prompts(files["gemma"], "", generate.DEFAULT_NEGATIVE_PROMPT)
    assert ids.dtype == mask.dtype == torch.int64 and ids.shape == (2, 1024) and int(mask[0].sum()) == 1
