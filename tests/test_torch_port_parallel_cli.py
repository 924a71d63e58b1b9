"""The command line's scale-out flags on the CPU.

- the flags, their defaults and help against scripts/generate.py's parser;
- world 1: every layout flag at 0 or 1 gives today's frames bit for bit;
- a layout flag that asks for more ranks than the world has exits
  (SystemExit, as the JAX CLI), on every pipeline and for every flag:
  --pp-stages, the layout --auto-shard picks, two-stage's SP and keyframe's
  W-sharded decode (their meshes are taken);
- `python -m ltx2_tpu_torch.generate` launched as 2 gloo ranks (the
  launcher's environment, the process group through a file in tmp_path):
  --sp-devices 2 with --vae-w-shard 2, and --tp-devices 2 (the ledger
  loading each rank's DiT shard) with a tile-parallel --vae-dp-devices 2,
  each against the one-process run of the same tiny checkpoint (an fp32
  DiT: latents to 1e-5, frames within 2 levels but for stray samples at 3
  from the bf16 decode); rank 0 alone writes the file; and the layouts this
  command line took later: --pp-stages 2 (the ledger loading each rank's
  blocks), and ti2vid-hq (one of the six pipelines whose meshes came after
  the first three's) at --sp-devices 2 --vae-w-shard 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.from_numpy import video_decoder_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from tests.torch_port_util import CFG, assert_close, random_tree
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
HEIGHT, WIDTH, FRAMES, SEED = 64, 128, 9, 3  # 2 x 4 latent columns: W splits over 2 ranks
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny unified checkpoint (the 2-layer, 2-head DiT and the decoder)."""
    tree = random_tree(model.LTXModel(CFG, device="meta"), 41)
    tree["transformer_blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *tree["transformer_blocks"])
    decoder = video_decoder_from_numpy(random_tree(VideoDecoder(DCFG), 42), DCFG)
    tensors = {**jexport.params_to_checkpoint(tree),
               **{k: v.float().numpy() for k, v in vae_weights.decoder_to_checkpoint(decoder).items()}}
    path = str(tmp_path_factory.mktemp("parallel_cli") / "ltx.safetensors")
    jst.write_safetensors(path, tensors, metadata={"model_version": "2.0.0", "config": '{"transformer": '
                                                   '{"num_attention_heads": 2}}'})
    return path


def _argv(checkpoint, output, *extra):
    return ["--pipeline", "text-to-video", "--device", "cpu", "--checkpoint", checkpoint, "--num-inference-steps",
            "2", "--height", str(HEIGHT), "--width", str(WIDTH), "--frames", str(FRAMES), "--seed", str(SEED),
            "--output", output, *extra]


def test_layout_flags_match_the_jax_cli():
    from scripts.generate import build_parser as jax_parser

    ours, theirs = generate.build_parser(), jax_parser()
    for flag in ("--sp-devices", "--tp-devices", "--vae-dp-devices", "--vae-w-shard", "--pp-stages",
                 "--auto-shard"):
        mine = next(a for a in ours._actions if flag in a.option_strings)
        ref = next(a for a in theirs._actions if flag in a.option_strings)
        assert (mine.default, mine.type) == (ref.default, ref.type), flag


def test_world_1_layout_flags_change_nothing(checkpoint, tmp_path):
    """Every layout flag at 0 or 1: today's path, bit for bit."""
    ref, _ = generate.main(_argv(checkpoint, str(tmp_path / "a.y4m")))
    out, _ = generate.main(_argv(checkpoint, str(tmp_path / "b.y4m"), "--sp-devices", "1", "--tp-devices", "0",
                                 "--vae-dp-devices", "1", "--vae-w-shard", "0", "--pp-stages", "1"))
    np.testing.assert_array_equal(out[0], ref[0])


@pytest.mark.parametrize("argv,kind,word", [
    (["--pipeline", "one-stage", "--pp-stages", "2"], SystemExit, "--pp-stages needs 2 devices"),
    (["--auto-shard", "4", "--pipeline", "distilled"], SystemExit, "needs 4 devices"),
    (["--pipeline", "two-stage", "--sp-devices", "2"], SystemExit, "--sp-devices needs 2 devices"),
    (["--pipeline", "keyframe", "--vae-w-shard", "2"], SystemExit, "--vae-w-shard 2 but only 1 ranks"),
    (["--pipeline", "distilled", "--sp-devices", "2", "--device", "cpu"], SystemExit, "needs 2 devices"),
    (["--pipeline", "one-stage", "--vae-dp-devices", "4", "--device", "cpu"], SystemExit, "only 1 ranks"),
])
def test_layout_refusals(argv, kind, word, capsys):
    with pytest.raises(kind) as err:
        generate.main(["--layers", "1", *argv])
    assert word in str(err.value), str(err.value)


def _launch(argv, world: int, tmp_path):
    """`python -m ltx2_tpu_torch.generate` as `world` ranks over gloo."""
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ltx2_tpu_torch.generate", *argv, "--dist-backend", "gloo",
             "--dist-init", f"file://{tmp_path / 'pg_init'}"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


@pytest.mark.parametrize("layout", [
    ["--sp-devices", "2", "--vae-w-shard", "2"],
    ["--tp-devices", "2", "--vae-dp-devices", "2", "--tile-size", "64", "--tile-overlap", "32"],
], ids=["sp2_vae_w2", "tp2_vae_dp2"])
def test_generate_on_2_ranks_matches_one_process(checkpoint, tmp_path, layout):
    """An fp32 DiT: the latents agree to 1e-5 of max|x| (measured 5e-7),
    the frames within 2 levels but for a stray sample at 3 (measured: 1e-5
    of the samples; the checkpoint's decoder runs in bf16, whose rounding
    turns the latents' last bits into a level or two on random weights)."""
    tiled = ("--tile-size", "64", "--tile-overlap", "32") if "--tile-size" in layout else ()
    fp32 = ("--dtype", "float32")
    ref, _ = generate.main(_argv(checkpoint, str(tmp_path / "one.y4m"), *fp32, *tiled))
    # A .mp4 without ffmpeg also writes <base>_frames.npz: the frames themselves.
    outs = _launch(_argv(checkpoint, str(tmp_path / "two.mp4"), *fp32, *layout), 2, tmp_path)
    assert json.loads(outs[0].strip().splitlines()[-1])["frames"] == [FRAMES, HEIGHT, WIDTH, 3]
    assert outs[1].strip() == ""  # rank 0 alone reports and writes
    with np.load(tmp_path / "two_frames.npz") as data:
        frames = data["frames"]
    assert frames.shape == ref[0].shape and frames.dtype == np.uint8
    diff = np.abs(frames.astype(int) - ref[0].astype(int))
    assert diff.max() <= 3 and (diff > 2).mean() < 1e-4, (diff.max(), (diff > 2).mean())

    ref, _ = generate.main(_argv(checkpoint, str(tmp_path / "one.y4m"), *fp32, "--skip-vae"))
    _launch(_argv(checkpoint, str(tmp_path / "two.y4m"), *fp32, *layout[:2], "--skip-vae"), 2, tmp_path)
    with np.load(tmp_path / "two_latent.npz") as data:
        assert_close(data["latent"], ref[0], rtol=1e-5, msg="latent")


@pytest.mark.parametrize("layout", [
    ["--pp-stages", "2"],
    ["--pipeline", "ti2vid-hq", "--height", "128", "--width", "128", "--sp-devices", "2", "--vae-w-shard", "2"],
], ids=["pp2", "ti2vid_hq_sp2_vae_w2"])
def test_later_layouts_on_2_ranks_match_one_process(checkpoint, tmp_path, layout):
    """As test_generate_on_2_ranks_matches_one_process, for pipeline
    parallelism and for a pipeline whose meshes this command line took
    later (ti2vid-hq without an upscaler's file runs its Res2s stage alone,
    at half size under CFG: 2 rows of 8 tokens; latent W 2, 1 column a
    rank in the W-sharded decode)."""
    fp32 = ("--dtype", "float32", *layout[:6]) if layout[0] == "--pipeline" else ("--dtype", "float32")
    ref, _ = generate.main(_argv(checkpoint, str(tmp_path / "one.y4m"), *fp32, "--skip-vae"))
    _launch(_argv(checkpoint, str(tmp_path / "two.y4m"), *fp32, *layout, "--skip-vae"), 2, tmp_path)
    with np.load(tmp_path / "two_latent.npz") as data:
        assert_close(data["latent"], ref[0], rtol=1e-5, msg="latent")
    ref, _ = generate.main(_argv(checkpoint, str(tmp_path / "one.y4m"), *fp32))
    outs = _launch(_argv(checkpoint, str(tmp_path / "two.mp4"), *fp32, *layout), 2, tmp_path)
    assert outs[1].strip() == ""
    with np.load(tmp_path / "two_frames.npz") as data:
        frames = data["frames"]
    diff = np.abs(frames.astype(int) - ref[0].astype(int))
    assert frames.shape == ref[0].shape and diff.max() <= 3 and (diff > 2).mean() < 1e-4, (diff.max(), (diff > 2).mean())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_loader_reads_each_ranks_slice(checkpoint, int8):
    """`load_transformer_params(tp_axis=...)` gives each rank of a 2-rank
    model axis exactly its slice of every tensor the whole load gives (int8:
    codes and column-parallel scales split, row-parallel scales whole), and
    sets the config's axis. No exchange: the ranks' axes need no group."""
    from ltx2_tpu_torch.loader.weight_loader import load_transformer_params
    from ltx2_tpu_torch.parallel.mesh import Axis
    from ltx2_tpu_torch.parallel.sharding import shard_tensor

    whole = load_transformer_params(checkpoint, device="cpu", quantize_int8=int8)
    tensors = dict((*whole.named_parameters(), *whole.named_buffers()))
    split = 0
    for index in range(2):
        axis = Axis("model", 2, index, (0, 1), None, "gloo")
        part = load_transformer_params(checkpoint, device="cpu", quantize_int8=int8, tp_axis=axis)
        assert part.cfg.tp_axis is axis
        got = dict((*part.named_parameters(), *part.named_buffers()))
        assert got.keys() == tensors.keys()
        for name, t in got.items():
            ref = shard_tensor(name, tensors[name], axis)
            assert t.dtype == ref.dtype and torch.equal(t, ref), name
            split += ref.shape != tensors[name].shape
    assert split > 20
