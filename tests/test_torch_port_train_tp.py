"""Megatron-TP training, alone and on a (data, model) mesh with ZeRO-1 and
ZeRO-2: the port's train step over four gloo ranks on the CPU against the
JAX package's `make_train_step` on the same mesh of tests/conftest.py's host
devices, after `shard_dit_params`.

One launch of four ranks (`spawn_ranks`; the rank side is
tests/torch_port_train_tp_workers.py) runs every job while the test process
runs the JAX references. The DiT, batch, draws and schedule are the
data-parallel file's (tests/test_torch_port_train_dp.py): 2 layers of 4
heads x 16 in float32 (the AV DiT's audio stream 2 heads x 16), a batch of
4, RTOL 1e-4 of the largest magnitude over 3 steps at lr 1e-3. The mesh's
ranks are laid out model innermost: rank = data index x TP + model index.
Checked:

- TP-4; TP-2 x DP-2 plain, ZeRO-1, ZeRO-2 (also with 2 microbatches); LoRA
  under ZeRO-1 and an AV batch with LoRA under ZeRO-2, both at TP-2 x
  DP-2: losses and parameters gathered over 'model' against JAX's;
- the first update's averaged gradient, gathered over 'model' (and 'data'
  under ZeRO-2), against the port's one-device gradient within 1e-5 of its
  largest element, by name: the Q/K norms and LoRA's whole factors
  (`lora_A` of column-parallel targets, `lora_B` of row-parallel ones)
  named;
- the ranks of each 'model' line hold the replicated leaves bit for bit,
  the 'data' ranks the same slices; the moments are each rank's slices
  under the TP half of the ZeRO rule, against JAX's rule on each block's
  own leaf, the stacked (L, ...) leaves listed where JAX shards L;
- the clip counts each leaf once across both axes (against optax);
- Megatron's differentiable collectives: `gradcheck`, and at 2 ranks the
  input gradients of the unsplit functions, which the old identity
  backward misses;
- state files round-trip between TP-2 x DP-2 and world 1;
- `train.main --tp-devices 2 --dp-devices 2 --zero2 --lora-rank 4`, a
  full fine-tune's `--save` and LoRA on a `--checkpoint` read sliced: rank
  0 alone prints and writes, the files are world 1's names and shapes and
  the run's own tensors gathered; `--audio --fp8-serving` under ZeRO-1
  near world 1's losses.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ltx2_tpu.parallel import mesh as jmesh
from ltx2_tpu.parallel import sharding as jsharding
from ltx2_tpu.training import lora as jlora
from ltx2_tpu.training import trainer as jtrainer
from ltx2_tpu_torch import train
from ltx2_tpu_torch.loader.export import export_transformer_checkpoint, inverse_rewrite
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, flatten_tree, trainable_to_numpy
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
from ltx2_tpu_torch.loader.weight_loader import DIFFUSION_PREFIX
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel import sharding
from ltx2_tpu_torch.parallel.mesh import Axis
from ltx2_tpu_torch.training import TrainConfig, data_shard_dim, make_optimizer, trainable_mask
from ltx2_tpu_torch.training.checkpoint import load_train_state
from tests.test_torch_port_train_dp import (
    AV, BATCH, CLI, JAV, JVIDEO, KW, STEPS, VIDEO, _batch, _draws, _lora_tree, _stacked, _world1_grads,
    _world1_state,
)
from tests.torch_port_util import assert_close, random_tree, spawn_ranks
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

WORLD = 4
# Port job -> (TP, DP, JAX reference, mode, microbatches): ZeRO-1 is held to JAX's plain run (the moments'
# layout changes no number).
CASES = {"tp4": (4, 1, "tp4", "dp", 1), "tp2_dp2": (2, 2, "dp", "dp", 1), "zero1": (2, 2, "dp", "zero1", 1),
         "zero2": (2, 2, "zero2", "zero2", 1), "zero2_accum2": (2, 2, "zero2_accum2", "zero2", 2)}
LAYOUTS = {**{k: v[:2] for k, v in CASES.items()}, "lora_zero1": (2, 2), "av_zero2": (2, 2)}
TP_CLI = ["--tp-devices", "2", "--dp-devices", "2"]
# The CLI run without adapters: a full fine-tune of attn1.
FULL_CLI = CLI[:CLI.index("--lora-rank")] + CLI[CLI.index("--lora-rank") + 2:] + ["--trainable", "attn1"]
# A reference-format checkpoint of the video DiT (`_write_checkpoint`) trained with LoRA: the adapters are
# drawn whole and sliced on a model the loader read as this rank's shard.
CKPT_METADATA = {"model_version": "2.0.0", "config": json.dumps({"transformer": {"num_attention_heads": 4}})}
CKPT_CLI = ["--device", "cpu", "--synthetic", "1", "2", "2", "--synthetic-samples", "4", "--steps", "2",
            "--batch-size", "2", "--lora-rank", "4", "--log-every", "1", "--lr", "1e-3"]
# Leaves (whole shapes) and the dim TP splits of each: split and sliced over 'data', split alone, sliced
# alone, and whole on every rank.
LEAF_SHAPES, LEAF_TP_DIMS = ((6, 4), (4,), (3, 6), (3,)), (0, 0, None, None)


def _jax_train(tree, jcfg, fields, mode: str, accum: int, lora: bool, tp: int, dp: int):
    """JAX's CLI path under --tp-devices tp --dp-devices dp [--zero1 |
    --zero2]: TP-sharded params on the (data=dp, model=tp) mesh, the batch
    sharded over 'data', the ZeRO shardings of the moments (and gradients);
    STEPS steps. Returns (losses, the trained leaves flattened)."""
    mesh = jmesh.create_mesh(data=dp, model=tp, devices=jax.devices()[:dp * tp])
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


def _job(tp, dp, mode, accum, fields, lora=False, save=None):
    return {"tp": tp, "dp": dp, "mode": mode, "accum": accum, "lora": lora, "tc": KW, "batch": fields,
            "draws": _draws(fields, accum), "save": save}


def _leaf_grads():
    rng = np.random.default_rng(12)
    return [[rng.standard_normal(s).astype(np.float32) for s in LEAF_SHAPES] for _ in range(2)]


def _autograd_inputs():
    rng = np.random.default_rng(13)
    return (rng.standard_normal((3, 8)).astype(np.float32), (rng.standard_normal((6, 8)) * 0.3).astype(np.float32),
            (rng.standard_normal((5, 6)) * 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def trees():
    video = _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**VIDEO), device="meta"), 41))
    av = _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**AV), device="meta"), 42))
    return {"video": video, "av_lora": _lora_tree(av), "lora": _lora_tree(video)}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """(each rank's results, the JAX references, the directory): the ranks
    run while the JAX steps compile here."""
    from tests.torch_port_train_tp_workers import run_jobs

    directory = tmp_path_factory.mktemp("train_tp")
    video, av = _batch(False), _batch(True)
    _world1_state(trees["video"], str(directory / "world1_state.safetensors"))
    ckpt = str(directory / "dit.safetensors")
    export_transformer_checkpoint(ckpt, dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO)),
                                  metadata=CKPT_METADATA)
    jobs = [(name, "train", (trees["video"], VIDEO, _job(tp, dp, mode, accum, video,
                                                         save=str(directory / "zero2.safetensors")
                                                         if name == "zero2" else None)))
            for name, (tp, dp, _, mode, accum) in CASES.items()]
    jobs += [("av_zero2", "train", (trees["av_lora"], AV, _job(2, 2, "zero2", 1, av, lora=True))),
             ("lora_zero1", "train", (trees["lora"], VIDEO, _job(2, 2, "zero1", 1, video, lora=True))),
             ("resume", "resume", (trees["video"], VIDEO, _job(2, 2, "zero1", 1, video),
                                   str(directory / "world1_state.safetensors"))),
             ("leaves", "adamw_tp_leaves", (LEAF_SHAPES, LEAF_TP_DIMS, _leaf_grads(), KW, 2)),
             ("autograd", "collectives_autograd", _autograd_inputs()),
             ("cli", "cli", (CLI + TP_CLI + ["--zero2", "--save", str(directory / "adapter.safetensors"),
                                             "--save-state", str(directory / "cli_state.safetensors")],)),
             ("cli_full", "cli", (FULL_CLI + TP_CLI + ["--save", str(directory / "full.safetensors")],)),
             ("cli_av_fp8", "cli", (CLI + TP_CLI + ["--audio", "--fp8-serving", "--zero1"],)),
             ("cli_checkpoint", "cli", (["--checkpoint", ckpt] + CKPT_CLI + TP_CLI
                                        + ["--save", str(directory / "ckpt_adapter.safetensors")],))]
    refs = {"tp4": (trees["video"], JVIDEO, video, "dp", 1, False, 4, 1),
            "dp": (trees["video"], JVIDEO, video, "dp", 1, False, 2, 2),
            "zero2": (trees["video"], JVIDEO, video, "zero2", 1, False, 2, 2),
            "zero2_accum2": (trees["video"], JVIDEO, video, "zero2", 2, False, 2, 2),
            "av_zero2": (trees["av_lora"], JAV, av, "zero2", 1, True, 2, 2),
            "lora_zero1": (trees["lora"], JVIDEO, video, "zero1", 1, True, 2, 2)}
    # XLA compiles with the GIL released: the references compile side by side.
    with concurrent.futures.ThreadPoolExecutor(1 + len(refs)) as pool:
        ranks = pool.submit(spawn_ranks, run_jobs, WORLD, directory / "ranks", jobs, timeout=600)
        refs = {k: pool.submit(_jax_train, *args) for k, args in refs.items()}
        return ranks.result(), {k: f.result() for k, f in refs.items()}, directory


def _held(port, ref, msg):
    losses, params = port["losses"], port["params"]
    assert_close(np.array(losses), np.array(ref[0]), msg=f"{msg} losses")
    assert set(params) == set(ref[1]), msg
    for k, v in ref[1].items():
        assert_close(params[k], v, msg=f"{msg} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_steps_match_jax(runs, case):
    ranks, refs, _ = runs
    _held(ranks[0][case], refs[CASES[case][2]], case)
    assert any(ranks[0][case]["model_split"]) and not all(ranks[0][case]["model_split"])


def test_av_batch_at_tp2_dp2_under_zero2_matches_jax(runs):
    ranks, refs, _ = runs
    port = ranks[0]["av_zero2"]
    assert any(k.startswith("transformer_blocks.audio_to_video_attn.") for k in port["params"])
    _held(port, refs["av_zero2"], "AV ZeRO-2")


def test_lora_at_tp2_dp2_under_zero1_matches_jax(runs, trees):
    ranks, refs, _ = runs
    port = ranks[0]["lora_zero1"]
    _held(port, refs["lora_zero1"], "LoRA ZeRO-1")
    base = flatten_tree(trees["lora"])
    assert all(not np.array_equal(v, base[k]) for k, v in port["params"].items()), "an adapter did not move"


# The parameters whose gradient each rank holds only a share of before the store sums it over 'model'.
WHOLE_FACTORS = r"(to_q|to_k|to_v|project_in\.proj)\.lora_A$|(to_out|project_out)\.lora_B$"


@pytest.mark.parametrize("job", [*CASES, "av_zero2", "lora_zero1"])
def test_averaged_gradients_are_world_1s(runs, trees, job):
    """The first update's gradient, averaged over 'data' and gathered over
    'model' (and over 'data' under ZeRO-2), against the port's one-device
    gradient of the whole batch, which the one-device tests hold to JAX's."""
    ranks, _, _ = runs
    av, lora = job == "av_zero2", job == "lora_zero1"
    tree = trees["av_lora"] if av else trees["lora"] if lora else trees["video"]
    fields = _batch(av)
    accum = CASES.get(job, (None,) * 4 + (1,))[4]
    ref = _world1_grads(tree, AV if av else VIDEO, fields, _draws(fields, accum)[0], accum, lora or av)
    got = ranks[0][job]["first_grads"]
    assert set(got) == set(ref)
    named = [n for n in ref if re.search(WHOLE_FACTORS, n)] if (lora or av) else \
        [n for n in ref if re.search(r"\.(q_norm|k_norm)\.weight$", n)]
    assert named  # the leaves this test is about are among those checked
    for name, want in ref.items():
        assert_close(got[name], want, rtol=1e-5, msg=f"{job} {name}")
    for r in ranks[1:]:  # every rank gathers the same whole gradient
        for name in named:
            np.testing.assert_array_equal(r[job]["first_grads"][name], got[name], err_msg=f"{job} {name}")


def _lines(tp, dp):
    """The 'model' lines and the 'data' lines of the mesh, as rank lists."""
    model_lines = [[d * tp + m for m in range(tp)] for d in range(dp)]
    data_lines = [[d * tp + m for d in range(dp)] for m in range(tp)]
    return model_lines, data_lines


@pytest.mark.parametrize("job", sorted(LAYOUTS))
def test_replicas_hold_the_same_bits(runs, job):
    """Every rank returns the same losses; the ranks of a 'model' line hold
    every replicated leaf bit for bit, the ranks of a 'data' line the same
    slices of every leaf."""
    ranks, _, _ = runs
    tp, dp = LAYOUTS[job]
    model_lines, data_lines = _lines(tp, dp)
    assert all(r[job]["losses"] == ranks[0][job]["losses"] for r in ranks)
    layout = ranks[0][job]["layout"]
    replicated = [n for n, (*_, tp_dim) in layout.items() if tp_dim is None]
    assert replicated and len(replicated) < len(layout)
    for line in model_lines:
        for n in replicated:
            for r in line[1:]:
                np.testing.assert_array_equal(ranks[r][job]["local"][n], ranks[line[0]][job]["local"][n], err_msg=n)
    for line in data_lines:
        for n in layout:
            for r in line[1:]:
                np.testing.assert_array_equal(ranks[r][job]["local"][n], ranks[line[0]][job]["local"][n], err_msg=n)


def _jax_block_rule(tree):
    """{flattened key: (JAX's 'data' dim of the stacked leaf's moment, or
    None; JAX's rule on one block's own leaf and its TP spec, or None)} on
    the (data=2, model=2) mesh."""
    mesh = jmesh.create_mesh(data=2, model=2, devices=jax.devices()[:4])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    p_sh = jsharding.dit_param_shardings(mesh, params)
    state = jtrainer.make_optimizer(jtrainer.TrainConfig()).init(params)
    mu = jtrainer.zero1_opt_state_shardings(state, params, p_sh, mesh)[1][0].mu
    flat_p = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_sh = dict(jax.tree_util.tree_flatten_with_path(p_sh)[0])
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(mu)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = tuple(sh.spec)
        stacked = spec.index("data") if "data" in spec else None
        block = stacked
        if key.startswith("transformer_blocks."):  # the rule on one block's leaf, the spec without L
            leaf = flat_p[path][0]
            one = NamedSharding(mesh, P(*tuple(flat_sh[path].spec)[1:]))
            bspec = tuple(jtrainer._data_extended_sharding(leaf, one, mesh, "data").spec)
            block = bspec.index("data") if "data" in bspec else None
        out[key] = (stacked, block)
    return out


def test_moment_slices_follow_the_tp_half_of_the_zero_rule(runs, trees):
    """Each rank's moments are its TP slice, then under ZeRO its 'data'
    slice on the first dim other than the TP one that divides (JAX's rule
    on each block's own leaf, every one); the stacked (L, ...) leaves where
    JAX puts 'data' on L are listed. The bytes follow: each split leaf's
    1/TP, each sliced one's 1/DP more; ZeRO-2's gradients are the slices."""
    ranks, _, _ = runs
    rule = _jax_block_rule(trees["video"])
    whole_bytes = {n: 4 * int(np.prod(v.shape[1:] if n.startswith("transformer_blocks.") else v.shape))
                   for n, v in flatten_tree(trees["video"]).items()}
    on_l = set()
    for job in ("zero1", "zero2", "zero2_accum2", "tp2_dp2", "tp4"):
        tp, dp = CASES[job][:2]
        for r in ranks:
            expected = 0
            for name, (local, moment, grad, tp_dim) in r[job]["layout"].items():
                key = re.sub(r"^transformer_blocks\.\d+\.", "transformer_blocks.", name)
                d = data_shard_dim(local, dp, tp_dim) if CASES[job][3] != "dp" else None
                assert moment == (local if d is None else local[:d] + (local[d] // dp,) + local[d + 1:]), name
                assert grad == (moment if CASES[job][3] == "zero2" else local), f"{job} {name}"
                expected += 2 * whole_bytes[key] // (tp if tp_dim is not None else 1) // (dp if d is not None else 1)
                if CASES[job][3] != "dp":
                    stacked, block = rule[key]
                    if key != name:
                        assert block == d, f"{job} {name}: JAX's rule on the block's leaf puts 'data' on {block}"
                        if stacked == 0:
                            on_l.add(key)
                    else:
                        assert stacked == d, name
            assert r[job]["moment_bytes"] == expected, job
    block_leaves = {k for k in rule if k.startswith("transformer_blocks.")}
    assert on_l == block_leaves  # L = 2 divides over 2 ranks: JAX shards every stacked leaf there


def test_clip_counts_each_leaf_once_across_both_axes(runs):
    """AdamW over leaves split over 'model' and sliced over 'data', split
    alone, sliced alone and whole, under ZeRO-2 at TP-2 x DP-2, against
    optax's clip + adamw on the whole leaves and the mean gradient, the clip
    biting; the global norm each rank read is the same."""
    ranks, _, _ = runs
    out = ranks[0]["leaves"]
    assert out["dims"] == [1, None, 1, None]
    grads = _leaf_grads()
    params = [jnp.linspace(-1.0, 1.0, int(np.prod(s))).reshape(s) for s in LEAF_SHAPES]
    opt = jtrainer.make_optimizer(jtrainer.TrainConfig(**KW))
    state, update = opt.init(params), jax.jit(opt.update)
    for _ in range(2):
        mean = [jnp.asarray((a + b) / 2) for a, b in zip(*grads)]
        updates, state = update(mean, state, params)
        params = optax.apply_updates(params, updates)
    for r in ranks:
        for got, want in zip(r["leaves"]["params"], params):
            assert_close(got, np.asarray(want))
    for job in LAYOUTS:
        assert len({r[job]["norm"] for r in ranks}) == 1, job


def _whole_mlp(x, w, v):
    x = torch.from_numpy(x).requires_grad_()
    (torch.tanh(x @ torch.from_numpy(w).t()) @ torch.from_numpy(v).t()).pow(2).sum().backward()
    return x.grad.numpy()


def _whole_norm(x):
    x = torch.from_numpy(x).requires_grad_()
    ss = x.pow(2).sum(-1, keepdim=True)
    (x * torch.rsqrt(ss / x.shape[-1] + 1e-6) * _norm_weights(x.shape)).sum().backward()
    return x.grad.numpy()


def _norm_weights(shape):
    """The worker's per-element weights of each rank's half, put side by side."""
    half = torch.arange(shape[0] * shape[1] // 2).reshape(shape[0], shape[1] // 2)
    return torch.cat([half, half], dim=1)


def test_differentiable_collectives(runs):
    """`gradcheck` of each Function (float64 through a one-rank group); at
    2 ranks copy_to_model / reduce_from_model give a column- then
    row-parallel product the unsplit input gradient and all_reduce_sum an
    RMS norm over a split dim its own, where the old identity backward of
    `all_reduce` gives another dx; the backward's bytes under their own
    name."""
    ranks, _, _ = runs
    xs, ws, vs = _autograd_inputs()
    mlp, norm = _whole_mlp(xs, ws, vs), _whole_norm(xs)
    for r, res in enumerate(ranks):
        assert res["autograd"]["gradcheck"] == {"copy_to_model": True, "reduce_from_model": True,
                                                "all_reduce_sum": True}
        assert res["autograd"]["float64_stays"] == "torch.float64"
        m = r % 2
        assert_close(res["autograd"]["mlp_new"], mlp, rtol=1e-6, msg="column/row dx")
        assert_close(res["autograd"]["norm_new"], norm[:, m * 4:(m + 1) * 4], rtol=1e-6, msg="norm dx")
        for key, want in (("mlp_old", mlp), ("norm_old", norm[:, m * 4:(m + 1) * 4])):
            assert np.abs(res["autograd"][key] - want).max() > 1e-3 * np.abs(want).max(), key
        by_op = res["autograd"]["bytes"]
        assert by_op["all_reduce_bwd gloo"]["sent"] > 0 and by_op["all_reduce gloo"]["sent"] > 0


def test_step_bytes_by_axis(runs):
    """The bytes a step moved, 'model' and 'data' apart: both axes under
    TP x DP, 'model' alone under TP-4, and the backward's all-reduce on
    'model'."""
    ranks, _, _ = runs
    assert set(ranks[0]["tp4"]["step_bytes"]) == {"model gloo"}
    for job in ("tp2_dp2", "zero2"):
        step = ranks[0][job]["step_bytes"]
        assert set(step) == {"model gloo", "data gloo"} and all(v["sent"] > 0 for v in step.values()), job
        assert ranks[0][job]["bytes"]["all_reduce_bwd gloo"]["sent"] > 0
    assert ranks[0]["zero2"]["bytes"]["reduce_scatter gloo"]["sent"] > 0


def test_tp2_dp2_zero2_state_reloads_at_world_1(runs, trees):
    """The ZeRO-2 state written at TP-2 x DP-2 (whole tensors, gathered
    over 'data' and 'model') read back at that layout, and at world 1."""
    ranks, _, directory = runs
    for r in ranks:
        assert r["zero2"]["reloaded_step"] == STEPS and r["zero2"]["reloaded_equal"]
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: True)
    names = [n for n, p in dit.named_parameters() if p.requires_grad]
    opt = make_optimizer(TrainConfig(**KW), [p for p in dit.parameters() if p.requires_grad])
    assert load_train_state(str(directory / "zero2.safetensors"), dit, opt) == STEPS
    for name, mu, nu in zip(names, opt.mu, opt.nu):
        np.testing.assert_array_equal(mu.numpy(), ranks[0]["zero2"]["moments"][name][0], err_msg=name)
        np.testing.assert_array_equal(nu.numpy(), ranks[0]["zero2"]["moments"][name][1], err_msg=name)
    loaded = trainable_to_numpy(dit)
    for k, v in ranks[0]["zero2"]["params"].items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_world_1_state_resumes_at_tp2_dp2(runs):
    ranks, _, _ = runs
    n = len(list(model.LTXModel(model.LTXModelConfig(**VIDEO), device="meta").parameters()))
    for r in ranks:
        res = r["resume"]
        assert res["step"] == 1 and res["slices_equal"], res
        assert 0 < res["model_split"] < n and 0 < res["data_sharded"] <= n


def _file(path):
    f = SafetensorsFile(str(path))
    try:
        return {k: f.get(k).float().numpy() for k in f.keys()}
    finally:
        f.close()


# A written tensor against world 1's after the same two steps at lr 1e-3: AdamW moves an element by about
# the rate a step whatever its gradient, so where a gradient is near zero the two runs' fp32 summation
# orders may move it either way (bf16 weights add one rounding).
ATOL_CLI_STEPS = 2 * 2 * 1e-3 + 5e-4


def _held_file(written, world1, trained, key_of):
    """The file has world 1's names and shapes, each trained tensor is the
    run's own gathered over 'model' bit for bit (`key_of` maps its name to
    its file keys and values), and every tensor is near world 1's."""
    assert {k: v.shape for k, v in written.items()} == {k: v.shape for k, v in world1.items()}
    for name, value in trained.items():
        for key, want in key_of(name, value):
            np.testing.assert_array_equal(written[key], want, err_msg=key)
    for k, v in world1.items():
        assert np.abs(written[k] - v).max() <= ATOL_CLI_STEPS, k


def test_cli_tp_dp_zero2_lora_prints_and_writes_on_rank_0_only(runs, tmp_path):
    """Rank 0 alone prints and writes (the LoRA file and the state); rank 1,
    of its 'model' line, joins the adapters' gathers; the LoRA file has world
    1's names and shapes and values near world 1's after the same steps."""
    ranks, _, directory = runs
    out = [r["cli"] for r in ranks]
    adapter, state = str(directory / "adapter.safetensors"), str(directory / "cli_state.safetensors")
    assert out[0]["calls"] == [adapter] and out[1]["calls"] == [adapter] and out[2]["calls"] == out[3]["calls"] == []
    assert sorted(out[0]["writes"]) == sorted([adapter, state + ".tmp"]) and all(not o["writes"] for o in out[1:])
    assert all(o["stdout"] == "" for o in out[1:])
    assert '"tensor_parallel": 2' in out[0]["stdout"] and '"val_loss"' in out[0]["stdout"]
    assert all(o["losses"] == out[0]["losses"] for o in out)
    world1 = train.main(CLI + ["--save", str(tmp_path / "adapter.safetensors")])
    assert_close(np.array(out[0]["losses"]), np.array(world1["losses"]), rtol=2e-2, msg="CLI losses vs world 1")

    def key_of(name, value):  # alpha = rank: B is written unscaled
        module, _, leaf = name.rpartition(".")
        return [(f"diffusion_model.{inverse_rewrite(module + '.')[:-1]}.{leaf}.weight", value)]

    _held_file(_file(adapter), _file(tmp_path / "adapter.safetensors"), out[0]["trained"], key_of)


def test_cli_full_fine_tune_save_under_tp(runs, tmp_path):
    """`--trainable attn1 --save` at TP-2 x DP-2: rank 0 writes whole
    tensors with world 1's names and shapes, near world 1's values."""
    ranks, _, directory = runs
    out = [r["cli_full"] for r in ranks]
    full = str(directory / "full.safetensors")
    assert out[0]["writes"] == [full] and all(not o["writes"] for o in out[1:])
    assert out[1]["calls"] == [full] and out[2]["calls"] == out[3]["calls"] == []
    train.main(FULL_CLI + ["--save", str(tmp_path / "full.safetensors")])
    _held_file(_file(full), _file(tmp_path / "full.safetensors"), out[0]["trained"],
               lambda name, value: [(DIFFUSION_PREFIX + inverse_rewrite(name), value)])


def test_cli_av_on_the_fp8_base_under_tp(runs):
    """`--audio --fp8-serving --lora-rank 4 --zero1` at TP-2 x DP-2: the AV
    DiT's fp8 base sliced with its replicated scales, every rank's losses
    alike and near world 1's."""
    ranks, _, _ = runs
    out = [r["cli_av_fp8"] for r in ranks]
    assert '"fp8_base": true' in out[0]["stdout"] and '"model_type": "AudioVideo"' in out[0]["stdout"]
    assert all(o["losses"] == out[0]["losses"] for o in out) and all(np.isfinite(out[0]["losses"]))
    world1 = train.main(CLI + ["--audio", "--fp8-serving"])
    assert_close(np.array(out[0]["losses"]), np.array(world1["losses"]), rtol=2e-2, msg="AV fp8 losses vs world 1")


def test_cli_checkpoint_lora_under_tp(runs, tmp_path):
    """LoRA on a checkpoint the loader reads sliced at TP-2 x DP-2: the
    adapters drawn whole (world 1's draw) and sliced, the saved file world
    1's after the same steps."""
    ranks, _, directory = runs
    out = [r["cli_checkpoint"] for r in ranks]
    adapter = str(directory / "ckpt_adapter.safetensors")
    assert out[0]["writes"] == [adapter] and all(not o["writes"] for o in out[1:])
    train.main(["--checkpoint", str(directory / "dit.safetensors")] + CKPT_CLI
               + ["--save", str(tmp_path / "adapter.safetensors")])

    def key_of(name, value):
        module, _, leaf = name.rpartition(".")
        return [(f"diffusion_model.{inverse_rewrite(module + '.')[:-1]}.{leaf}.weight", value)]

    _held_file(_file(adapter), _file(tmp_path / "adapter.safetensors"), out[0]["trained"], key_of)


def test_tp_names_and_heads():
    """The rules' split dims, the partial LoRA factors and the heads check
    over every attention of an AV config, the cross-modal ones included."""
    assert sharding.tp_split_dim("transformer_blocks.0.attn1.to_q.weight") == 0
    assert sharding.tp_split_dim("transformer_blocks.0.attn1.to_out.weight") == 1
    assert sharding.tp_split_dim("transformer_blocks.0.attn1.to_out.bias") is None
    partial = {n: sharding.tp_partial_grad(f"transformer_blocks.3.{n}")
               for n in ("attn1.to_q.lora_A", "attn1.to_q.lora_B", "attn1.to_out.lora_A", "attn1.to_out.lora_B",
                         "ff.project_in.proj.lora_A", "ff.project_out.lora_B", "attn1.to_q.weight",
                         "attn1.to_out.bias", "scale_shift_table")}
    assert [n for n, v in partial.items() if v] == ["attn1.to_q.lora_A", "attn1.to_out.lora_B",
                                                    "ff.project_in.proj.lora_A", "ff.project_out.lora_B"]
    cfg = model.LTXModelConfig(**{**AV, "audio_heads": 3})
    assert [h for _, h in sharding.tp_attention_heads(cfg)] == [4, 3, 3, 3]
    with pytest.raises(ValueError, match=r"audio 3, audio_to_video 3, video_to_audio 3 do not divide"):
        sharding.check_tp_heads(cfg, Axis("model", 2, 0, (0, 1)))
    sharding.check_tp_heads(dataclasses.replace(cfg, audio_heads=2), Axis("model", 2, 0, (0, 1)))


def test_tp_world_refusals():
    """tp x dp must be the world, and --fsdp needs a 'data' axis (the JAX
    CLI's words)."""
    with pytest.raises(SystemExit, match="--tp-devices needs 2 devices but only 1 ranks in the world"):
        train.main(CLI + ["--tp-devices", "2"])
    with pytest.raises(SystemExit, match=r"--tp-devices x --dp-devices needs 4 devices but only 1 ranks"):
        train.main(CLI + TP_CLI)
    with pytest.raises(SystemExit, match=r"--fsdp needs --dp-devices > 1 \(a 'data' axis to shard over\)"):
        train.main(CLI + ["--tp-devices", "2", "--fsdp"])
