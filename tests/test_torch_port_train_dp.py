"""Data-parallel training with ZeRO-1 and ZeRO-2: the port's train step over
two gloo ranks on the CPU against the JAX package's `make_train_step` on a
(data=2, model=1) mesh of tests/conftest.py's host devices.

One launch of two ranks (`spawn_ranks`; the rank side is
tests/torch_port_train_workers.py) runs every job while the test process
runs the JAX references. The DiT has 2 layers of 4 heads x 16, float32, its
weights from `random_tree`; the batch is 4 samples; JAX's sigmas and noise,
drawn from its key splits (per microbatch under accumulation), are handed
in whole and each rank takes its rows of every microbatch. Checked:

- plain DP, ZeRO-1 and ZeRO-2 (ZeRO-2 also with 2 microbatches), an AV
  batch under ZeRO-2 and LoRA (partitioned) under ZeRO-1, three steps of
  clip + AdamW each: losses and parameters to RTOL (1e-4 of the largest
  magnitude), the tolerance of the one-device optax test;
- ZeRO-1's parameters bit for bit plain DP's; every rank's bit for bit;
- each moment and ZeRO-2 gradient slice half its leaf where the rule finds
  a dim, the leaves whose layout differs from JAX's listed and explained
  (JAX puts 'data' on the stacked layer axis, or a TP spec holds the dim);
- whole leaves under ZeRO-2 counted once in the global-norm clip;
- `reduce_scatter` against `psum_scatter`;
- a ZeRO-2 state file written at world 2 read at world 1, and a world-1
  file read at world 2;
- `train.main --dp-devices 2 --zero2 --lora-rank 4`: only rank 0 prints
  and writes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.ops import rope as jrope
from ltx2_tpu.parallel import mesh as jmesh
from ltx2_tpu.parallel import sharding as jsharding
from ltx2_tpu.training import lora as jlora
from ltx2_tpu.training import trainer as jtrainer
from ltx2_tpu_torch import train
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, flatten_tree, trainable_to_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel.mesh import Axis
from ltx2_tpu_torch.training import (
    TrainBatch, TrainConfig, data_shard_dim, make_optimizer, make_train_step, trainable_mask,
)
from ltx2_tpu_torch.training.checkpoint import load_train_state, save_train_state
from tests.torch_port_util import assert_close, random_tree, spawn_ranks
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

VIDEO = dict(num_attention_heads=4, attention_head_dim=16, in_channels=16, out_channels=16, num_layers=2,
             cross_attention_dim=64, compute_dtype="float32")
AV = dict(VIDEO, audio_heads=2, audio_head_dim=16, audio_in_channels=16, audio_out_channels=16, caption_channels=24,
          model_type=model.LTXModelType.AudioVideo)
JVIDEO = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.VideoOnly, caption_channels=None, remat=False, **VIDEO)
JAV = jmodel.LTXModelConfig(remat=False, **{**AV, "model_type": jmodel.LTXModelType.AudioVideo})
BATCH, STEPS, LORA_RANK = 4, 3, 4
# The one-device optax test's schedule (the clip always bites, weight decay, warmup into a cosine) at a
# learning rate of 1e-3: AdamW normalises each element's gradient, so where an element's gradient is near
# zero the packages' fp32 summation orders (their gradients agree to ~2e-6 of the largest) become a step
# difference in proportion to the rate; at 1e-2 the AV adapters' worst element differs by 5.7e-4 of
# max|B| at world 1 already, with no rank in play. Adam and the clip are blind to the gradient's scale:
# `test_averaged_gradients_are_world_1s` holds the averaged gradients themselves.
KW = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip_norm=1e-3, warmup_steps=1, lr_schedule="cosine",
          total_steps=STEPS)
# Port job -> (JAX reference, mode, microbatches): ZeRO-1 is held to JAX's plain DP run (the moments'
# layout changes no number; the port's ZeRO-1 is also held to its own DP bit for bit).
CASES = {"dp": ("dp", "dp", 1), "zero1": ("dp", "zero1", 1), "zero2": ("zero2", "zero2", 1),
         "zero2_accum2": ("zero2_accum2", "zero2", 2)}
CLI = ["--placeholder", "--device", "cpu", "--layers", "1", "--synthetic", "1", "2", "2", "--synthetic-samples", "4",
       "--val-fraction", "0.5", "--eval-every", "1", "--steps", "2", "--batch-size", "2", "--lora-rank", "4",
       "--log-every", "1", "--lr", "1e-3"]


def _stacked(tree):
    tree = dict(tree)
    tree["transformer_blocks"] = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *tree["transformer_blocks"])
    return tree


def _lora_tree(base):
    """JAX's adapters on `base` (stacked), B randomised so A gets a gradient."""
    jp, _ = jlora.add_lora_params(jax.random.PRNGKey(5), jax.tree_util.tree_map(jnp.asarray, base), rank=LORA_RANK,
                                  alpha=8.0)
    rng = np.random.default_rng(4)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("['lora_B']"):
            return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jp)


def _batch(av: bool):
    """The whole batch's fields as numpy: 12 video tokens, a 5-token
    context, with `av` 8 audio tokens and their own 4-token context."""
    rng = np.random.default_rng(6)
    grid = np.asarray(jrope.create_position_grid(BATCH, 2, 2, 3), np.float32)
    f = dict(x0=rng.standard_normal((BATCH, 12, 16)).astype(np.float32), positions=np.stack([grid, grid + 1], -1),
             context=(rng.standard_normal((BATCH, 5, 24 if av else 64)) * 0.5).astype(np.float32))
    if av:
        secs = np.arange(8, dtype=np.float32)[None, None, :] * 0.04
        f["audio_x0"] = rng.standard_normal((BATCH, 8, 16)).astype(np.float32)
        f["audio_positions"] = np.repeat(np.stack([secs, secs + 0.04], axis=-1), BATCH, axis=0)
        f["audio_context"] = (rng.standard_normal((BATCH, 4, 24)) * 0.5).astype(np.float32)
    return f


def _draws(fields, accum: int):
    """Per step, JAX's sigmas, noise and audio noise for the whole batch:
    the draws of each microbatch's key, concatenated in row order."""
    jtc = jtrainer.TrainConfig(**KW)
    mb = BATCH // accum
    out = []
    for i in range(STEPS):
        key = jax.random.PRNGKey(20 + i)
        keys = [key] if accum == 1 else list(jax.random.split(key, accum))
        parts = []
        for k in keys:
            k_sigma, k_v, k_a = jax.random.split(k, 3)
            draw = [np.asarray(jtrainer._sample_sigmas(k_sigma, mb, jtc)),
                    np.asarray(jax.random.normal(k_v, (mb,) + fields["x0"].shape[1:], jnp.float32))]
            if "audio_x0" in fields:
                draw.append(np.asarray(jax.random.normal(k_a, (mb,) + fields["audio_x0"].shape[1:], jnp.float32)))
            parts.append(draw)
        out.append([np.concatenate(xs) for xs in zip(*parts)] + [None] * (3 - len(parts[0])))
    return out


def _jmesh():
    return jmesh.create_mesh(data=2, model=1, devices=jax.devices()[:2])


def _jax_train(tree, jcfg, fields, mode: str, accum: int, lora: bool = False):
    """JAX's CLI path under --dp-devices 2 [--zero1 | --zero2]: TP-sharded
    params on the (data=2, model=1) mesh, the batch sharded over 'data',
    the ZeRO shardings of the moments (and gradients); STEPS steps. Returns
    (losses, the trained leaves flattened)."""
    mesh = _jmesh()
    jtc = jtrainer.TrainConfig(**KW)
    params = jsharding.shard_dit_params(mesh, jax.tree_util.tree_map(jnp.asarray, tree))
    opt = jtrainer.make_optimizer(jtc)
    mask = jlora.lora_trainable_mask(params) if lora else None
    target, frozen = jtrainer.partition_params(params, mask) if lora else (params, None)
    state = opt.init(target)
    opt_sh = grad_sh = None
    if mode != "dp":
        p_sh = jsharding.dit_param_shardings(mesh, target)
        opt_sh = jtrainer.zero1_opt_state_shardings(state, target, p_sh, mesh)
        state = jax.tree_util.tree_map(jax.device_put, state, opt_sh)
        if mode == "zero2":
            grad_sh = jtrainer.zero2_grad_shardings(target, p_sh, mesh)
    step = jtrainer.make_train_step(jcfg, opt, jtc, trainable_mask=mask, accum_steps=accum,
                                    opt_state_shardings=opt_sh, grad_shardings=grad_sh)
    batch = jtrainer.TrainBatch(**{k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
                                   for k, v in fields.items()})
    losses = []
    for i in range(STEPS):
        args = (target, state, frozen) if lora else (target, state)
        loss, target, state = step(*args, batch, jax.random.PRNGKey(20 + i))
        losses.append(float(loss))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, target))
    return losses, {k: v for k, v in flat.items() if v.dtype != object}


def _job(mode, accum, fields, lora=False, save=None):
    return {"mode": mode, "accum": accum, "lora": lora, "tc": KW, "batch": fields, "draws": _draws(fields, accum),
            "save": save}


# Leaves of different shapes, two with no dim the rule shards over 2 ranks.
LEAF_SHAPES = ((6, 4), (3, 5), (5,), (4,))


def _leaf_grads():
    rng = np.random.default_rng(11)
    return [[rng.standard_normal(s).astype(np.float32) for s in LEAF_SHAPES] for _ in range(2)]


def _world1_state(tree, path):
    """A world-1 state file of the video DiT after one step (the job's
    first draws)."""
    dit = dit_from_numpy(tree, model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: True)
    tc = TrainConfig(**KW)
    opt = make_optimizer(tc, [p for p in dit.parameters() if p.requires_grad])
    fields = _batch(False)
    step = make_train_step(dit, opt, tc)
    step(TrainBatch(**{k: torch.from_numpy(v) for k, v in fields.items()}), None,
         *(torch.from_numpy(x) for x in _draws(fields, 1)[0][:2]))
    save_train_state(path, 1, dit, opt)


@pytest.fixture(scope="module")
def trees():
    video = _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**VIDEO), device="meta"), 41))
    av = _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**AV), device="meta"), 42))
    return {"video": video, "av_lora": _lora_tree(av), "lora": _lora_tree(video)}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """(each rank's results, the JAX references): the ranks run while the
    JAX steps compile here."""
    from tests.torch_port_train_workers import run_jobs

    directory = tmp_path_factory.mktemp("train_dp")
    video, av = _batch(False), _batch(True)
    _world1_state(trees["video"], str(directory / "world1_state.safetensors"))
    jobs = [(name, "train", (trees["video"], VIDEO, _job(mode, accum, video,
                                                         save=str(directory / "zero2.safetensors")
                                                         if name == "zero2" else None)))
            for name, (_, mode, accum) in CASES.items()]
    jobs += [("av_zero2", "train", (trees["av_lora"], AV, _job("zero2", 1, av, lora=True))),
             ("lora_zero1", "train", (trees["lora"], VIDEO, _job("zero1", 1, video, lora=True))),
             ("resume", "resume", (trees["video"], VIDEO, _job("zero1", 1, video),
                                   str(directory / "world1_state.safetensors"))),
             ("leaves", "adamw_leaves", (LEAF_SHAPES, _leaf_grads(), KW, 2)),
             ("scatter", "scatter", ([np.arange(24, dtype=np.float32).reshape(4, 6) * (r + 1) - 7.25 * r
                                      for r in range(2)],)),
             ("cli", "cli", (CLI + ["--dp-devices", "2", "--zero2", "--save", str(directory / "adapter.safetensors"),
                                    "--save-state", str(directory / "cli_state.safetensors")],))]
    refs = {"dp": (trees["video"], JVIDEO, video, "dp", 1), "zero2": (trees["video"], JVIDEO, video, "zero2", 1),
            "zero2_accum2": (trees["video"], JVIDEO, video, "zero2", 2),
            "av_zero2": (trees["av_lora"], JAV, av, "zero2", 1, True),
            "lora_zero1": (trees["lora"], JVIDEO, video, "zero1", 1, True)}
    # XLA compiles with the GIL released: the references compile side by side.
    with concurrent.futures.ThreadPoolExecutor(1 + len(refs)) as pool:
        ranks = pool.submit(spawn_ranks, run_jobs, 2, directory / "ranks", jobs, timeout=600)
        refs = {k: pool.submit(_jax_train, *args) for k, args in refs.items()}
        return ranks.result(), {k: f.result() for k, f in refs.items()}, directory


def _held(port, ref, msg):
    losses, params = port["losses"], port["params"]
    assert_close(np.array(losses), np.array(ref[0]), msg=f"{msg} losses")
    assert set(params) == set(ref[1]), msg
    for k, v in ref[1].items():
        assert_close(params[k], v, msg=f"{msg} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_and_zero_steps_match_jax(runs, case):
    ranks, refs, _ = runs
    _held(ranks[0][case], refs[CASES[case][0]], case)


def _world1_grads(tree, cfg_kwargs, fields, draws, accum, lora):
    """The port's one-device gradient of the whole batch (the mean over
    its microbatches) at the first step's draws, by parameter name."""
    from ltx2_tpu_torch.training import rectified_flow_loss
    from ltx2_tpu_torch.training.lora import lora_trainable_mask

    dit = dit_from_numpy(tree, model.LTXModelConfig(**cfg_kwargs))
    lora_trainable_mask(dit) if lora else trainable_mask(dit, lambda name: True)
    mb = BATCH // accum
    for i in range(accum):
        part = slice(i * mb, (i + 1) * mb)
        batch = TrainBatch(**{k: torch.from_numpy(v[part]) for k, v in fields.items()})
        loss = rectified_flow_loss(dit, batch, None, TrainConfig(**KW),
                                   *(None if x is None else torch.from_numpy(x[part]) for x in draws))
        (loss / accum).backward()
    return {n: p.grad.numpy() for n, p in dit.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("job", [*CASES, "av_zero2", "lora_zero1"])
def test_averaged_gradients_are_world_1s(runs, trees, job):
    """The first update's gradient, averaged over 'data' (ZeRO-2: the
    ranks' slices put together), against the port's one-device gradient of
    the whole batch, which the one-device tests hold to JAX's."""
    ranks, _, _ = runs
    av, lora = job == "av_zero2", job != "av_zero2" and job.startswith("lora")
    tree = trees["av_lora"] if av else trees["lora"] if lora else trees["video"]
    fields = _batch(av)
    accum = CASES.get(job, (None, None, 1))[2]
    ref = _world1_grads(tree, AV if av else VIDEO, fields, _draws(fields, accum)[0], accum, lora or av)
    layout = ranks[0][job]["layout"]
    assert set(ranks[0][job]["first_grads"]) == set(ref)
    for name, want in ref.items():
        shape, moment, grad = layout[name]
        got = ranks[0][job]["first_grads"][name]
        if tuple(grad) != tuple(shape):  # this rank's slice
            d = data_shard_dim(shape, 2)
            got = np.concatenate([r[job]["first_grads"][name] for r in ranks], axis=d)
        assert_close(got, want, rtol=1e-5, msg=f"{job} {name}")


def test_av_batch_under_zero2_matches_jax(runs):
    """LoRA on the AV DiT, as the one-device AV optax test trains it: the
    audio rows and audio noise split over the ranks with the video's."""
    ranks, refs, _ = runs
    port = ranks[0]["av_zero2"]
    assert any(k.startswith("transformer_blocks.audio_attn1.") for k in port["params"])
    _held(port, refs["av_zero2"], "AV ZeRO-2")


def test_lora_under_zero1_matches_jax(runs, trees):
    ranks, refs, _ = runs
    port = ranks[0]["lora_zero1"]
    assert all(k.rsplit(".", 1)[-1] in ("lora_A", "lora_B") for k in port["params"])
    _held(port, refs["lora_zero1"], "LoRA ZeRO-1")
    base = flatten_tree(trees["lora"])
    assert all(not np.array_equal(v, base[k]) for k, v in port["params"].items()), "an adapter did not move"


def test_zero1_is_plain_dp_bit_for_bit(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["zero1"]["losses"] == r["dp"]["losses"]
        for k, v in r["dp"]["params"].items():
            np.testing.assert_array_equal(r["zero1"]["params"][k], v, err_msg=k)


def test_every_rank_holds_the_same_parameters(runs):
    ranks, _, _ = runs
    for job in (*CASES, "av_zero2", "lora_zero1", "cli"):
        assert ranks[0][job]["losses"] == ranks[1][job]["losses"], job
        for k, v in ranks[0][job]["params"].items():
            np.testing.assert_array_equal(ranks[1][job]["params"][k], v, err_msg=f"{job} {k}")


def _jax_data_dims(tree):
    """JAX's ZeRO layout of each leaf: {flattened key: (index of 'data' in
    the moment's spec or None, the spec)} on the (data=2, model=1) mesh."""
    mesh = _jmesh()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    p_sh = jsharding.dit_param_shardings(mesh, params)
    state = jtrainer.make_optimizer(jtrainer.TrainConfig()).init(params)
    mu = jtrainer.zero1_opt_state_shardings(state, params, p_sh, mesh)[1][0].mu
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(mu)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = tuple(sh.spec)
        out[key] = (spec.index("data") if "data" in spec else None, spec)
    return out


def test_moment_and_gradient_slices_halve(runs, trees):
    """Every leaf the rule shards holds half its moments (ZeRO-1, ZeRO-2)
    and half its ZeRO-2 gradient on each rank; the total bytes halve. The
    leaves whose 'data' dim differs from JAX's are listed: a stacked block
    leaf where JAX shards the layer axis L, or a leaf whose TP spec holds
    the port's dim (JAX puts 'data' on the next free one; the port trains
    without TP)."""
    ranks, _, _ = runs
    jax_dims = _jax_data_dims(trees["video"])
    differs = {}
    for r in ranks:
        for job in ("zero1", "zero2", "zero2_accum2"):
            layout, whole = r[job]["layout"], 0
            for name, (shape, moment, grad) in layout.items():
                d = data_shard_dim(shape, 2)
                assert d is not None, name  # every leaf of this DiT has a dim the rule shards
                assert moment == shape[:d] + (shape[d] // 2,) + shape[d + 1:], name
                assert grad == (shape if job == "zero1" else moment), f"{job} {name}"
                whole += int(np.prod(shape)) * 4
                key = re.sub(r"^transformer_blocks\.\d+\.", "transformer_blocks.", name)
                jd, spec = jax_dims[key]
                if key != name:  # a block leaf: JAX's dims are one on (the layer axis first)
                    jd, spec = ("L" if jd == 0 else jd - 1), spec[1:]
                if jd != d:
                    differs[key] = "L" if jd == "L" else "tp" if len(spec) > d and spec[d] is not None else "?"
            assert r[job]["moment_bytes"] == whole, job  # mu and nu, each half its fp32 leaf
            assert r[job]["grad_bytes"] == (whole if job == "zero1" else whole // 2), job
    # Where the layouts part: every stacked leaf JAX shards on L, and the
    # leaves whose TP spec holds the port's dim.
    stacked_on_l = {k for k, (jd, _) in jax_dims.items() if k.startswith("transformer_blocks.") and jd == 0}
    assert stacked_on_l and {k for k, why in differs.items() if why == "L"} == stacked_on_l
    assert set(differs.values()) <= {"L", "tp"}, differs


def test_whole_leaves_count_once_in_the_clip(runs):
    """AdamW over leaves with and without a dim the rule shards (ZeRO-1 on
    the mean gradient, ZeRO-2 on its slices) against optax's clip + adamw on
    the mean of the ranks' gradients, the clip biting."""
    ranks, _, _ = runs
    out = ranks[0]["leaves"]
    assert out["dims"] == [0, None, None, 0]
    grads = _leaf_grads()
    params = [jnp.linspace(-1.0, 1.0, int(np.prod(s))).reshape(s) for s in LEAF_SHAPES]
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig(**KW))
    state, update = opt.init(params), jax.jit(opt.update)
    for _ in range(2):
        mean = [jnp.asarray((a + b) / 2) for a, b in zip(*grads)]
        updates, state = update(mean, state, params)
        params = optax.apply_updates(params, updates)
    for mode in ("zero1", "zero2"):
        for got, want in zip(out[mode], params):
            assert_close(got, np.asarray(want), msg=mode)
    for i in range(len(LEAF_SHAPES)):
        np.testing.assert_array_equal(ranks[1]["leaves"]["zero2"][i], out["zero2"][i])


def test_reduce_scatter_matches_psum_scatter(runs):
    ranks, _, _ = runs
    xs = np.stack([np.arange(24, dtype=np.float32).reshape(4, 6) * (r + 1) - 7.25 * r for r in range(2)])
    mesh = _jmesh()
    for dim in (0, 1):
        fn = jax.shard_map(lambda x, d=dim: jax.lax.psum_scatter(x[0], "data", scatter_dimension=d, tiled=True)[None],
                           mesh=mesh, in_specs=P("data"), out_specs=P("data"))
        ref = np.asarray(fn(jnp.asarray(xs)))
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res["scatter"][f"dim{dim}"], ref[r], err_msg=f"dim {dim} rank {r}")
    assert ranks[0]["scatter"]["bf16_dtype"] == "torch.float32"  # summed in fp32
    # Each call sends and receives (n - 1) / n of its 96-byte fp32 input; the bf16 one's 48 bytes in fp32.
    assert ranks[0]["scatter"]["bytes"] == {"reduce_scatter gloo": {"sent": 48 * 3, "received": 48 * 3}}


def test_zero2_state_saved_at_world_2_reloads_at_world_1(runs, trees):
    ranks, _, directory = runs
    for r in ranks:
        assert r["zero2"]["reloaded_step"] == STEPS and r["zero2"]["reloaded_equal"]
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: True)
    params = [p for p in dit.parameters() if p.requires_grad]
    opt = make_optimizer(TrainConfig(**KW), params)
    assert load_train_state(str(directory / "zero2.safetensors"), dit, opt) == STEPS
    assert opt.count == STEPS
    names = [n for n, p in dit.named_parameters() if p.requires_grad]
    for name, p, mu, nu in zip(names, params, opt.mu, opt.nu):
        shape, moment, _ = ranks[0]["zero2"]["layout"][name]
        d = next(i for i, (a, b) in enumerate(zip(shape, moment)) if a != b)
        for i, kind in enumerate((mu, nu)):
            whole = np.concatenate([r["zero2"]["slices"][name][i] for r in ranks], axis=d)
            np.testing.assert_array_equal(kind.numpy(), whole, err_msg=name)
    loaded = trainable_to_numpy(dit)
    for k, v in ranks[0]["zero2"]["params"].items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_world_1_state_resumes_at_world_2(runs, trees):
    ranks, _, _ = runs
    n = len(list(model.LTXModel(model.LTXModelConfig(**VIDEO), device="meta").parameters()))
    for r in ranks:
        assert r["resume"] == {"step": 1, "slices_equal": True, "sharded": n}


def test_cli_dp_zero2_lora_prints_and_writes_on_rank_0_only(runs):
    ranks, _, directory = runs
    r0, r1 = (r["cli"] for r in ranks)
    assert r0["exports"] == [str(directory / "adapter.safetensors")] and r1["exports"] == []
    assert r1["stdout"] == "" and '"data_parallel": 2' in r0["stdout"] and '"val_loss"' in r0["stdout"]
    assert (directory / "adapter.safetensors").exists() and (directory / "cli_state.safetensors").exists()
    assert r0["grad_bytes"] * 2 == r0["moment_bytes"]  # fp32 adapters: one slice of gradient, two of moments
    world1 = train.main(CLI)
    assert_close(np.array(r0["losses"]), np.array(world1["losses"]), rtol=2e-2, msg="CLI losses vs world 1")
    assert world1["moment_bytes"] == 2 * r0["moment_bytes"]


def test_batch_and_world_refusals():
    """The JAX CLI's refusals with its words, and the world check."""
    with pytest.raises(SystemExit, match=r"--batch-size 3 must be divisible by --dp-devices 2 \(each data shard "
                                         r"takes batch/dp samples\)"):
        train.main(CLI + ["--batch-size", "3", "--dp-devices", "2"])
    for flag in ("--zero1", "--zero2"):
        with pytest.raises(SystemExit, match=rf"{flag} needs --dp-devices > 1 \(a 'data' axis to shard over\)"):
            train.main(CLI + [flag])
    with pytest.raises(SystemExit, match="--dp-devices needs 2 devices but only 1 ranks in the world"):
        train.main(CLI + ["--dp-devices", "2"])
    with pytest.raises(SystemExit, match="microbatches of 1 samples, not divisible by --dp-devices 2"):
        train.main(CLI + ["--dp-devices", "2", "--accum-steps", "2"])


def test_refusal_words_are_the_jax_clis():
    """The messages above, as scripts/train.py words them (its adjacent
    string literals joined)."""
    source = (Path(__file__).resolve().parents[1] / "scripts" / "train.py").read_text()
    joined = re.sub(r'"\s*\n\s*f?"', "", source)
    assert "must be divisible by --dp-devices {dp} (each data shard takes batch/dp samples)" in joined
    assert "{which} needs --dp-devices > 1 (a 'data' axis to shard over)" in joined


def test_sharding_arguments_refused_by_name(trees):
    """Training under sequence parallelism still raises, naming itself
    (training under TP and ZeRO-3/FSDP are ported); an FSDP layout for a
    model that is not sliced over a 'data' axis is refused by name."""
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: "attn1" in name)
    opt = make_optimizer(TrainConfig(), [p for p in dit.parameters() if p.requires_grad])
    with pytest.raises(ValueError, match="param_shardings: the model is not sliced over a 'data' axis"):
        make_train_step(dit, opt, param_shardings=[0])
    dit.cfg = dataclasses.replace(dit.cfg, sequence_axis=Axis("seq", 2, 0, (0, 1)))
    with pytest.raises(NotImplementedError, match="sequence_axis: training under sequence parallelism"):
        make_train_step(dit, opt)
