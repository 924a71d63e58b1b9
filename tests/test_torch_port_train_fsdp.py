"""ZeRO-3/FSDP training, alone and under Megatron-TP: the port's train step
over four gloo ranks on the CPU, every parameter sliced over 'data', against
the JAX package's `make_train_step(param_shardings=fsdp_param_shardings(...),
opt_state_shardings=..., grad_shardings=...)` on the same mesh of
tests/conftest.py's host devices, the parameters placed by that layout as
scripts/train.py places them.

One launch of four ranks (`spawn_ranks`; the rank side is
tests/torch_port_train_fsdp_workers.py) runs every job while the test
process runs the JAX references. The DiT, batch, draws and schedule are the
data-parallel file's (tests/test_torch_port_train_dp.py): 2 layers of 4
heads x 16 in float32, a batch of 4, RTOL 1e-4 of the largest magnitude
over 3 steps at lr 1e-3. The mesh's ranks are laid out model innermost:
rank = data index x TP + model index. Checked:

- FSDP at DP-4; at TP-2 x DP-2 a full fine-tune, the same with 2
  microbatches, LoRA (the frozen base sliced too) and an AV batch with
  LoRA: losses and the parameters gathered whole against JAX's, and the
  first update's gradient against the port's one-device gradient (a
  gradient reduced twice, or not averaged, would pass the first check:
  the clip and Adam are blind to its scale);
- the layout, with no ranks: every leaf of the tiny video and AV DiT, with
  and without LoRA, at (data, model) = (2, 4), (2, 2) and (4, 1), against
  JAX's `fsdp_param_shardings` on the stacked tree with L removed; the ZeRO
  helpers give the FSDP layout of sliced parameters unchanged;
- each rank's resident parameter bytes are world 1's over DP x TP but the
  listed leaves; a rank's slices differ from its 'data' peers', and
  gathered they are the same on every rank;
- a step's 'data' bytes equal the reckoning (the gathers of the forward and
  of the remat recompute, the fp32 reduce-scatter, the all-reduce of the
  leaves kept whole, the loss and the clip; nothing gathered after the
  update);
- the clip counts each leaf once across both axes (against optax);
- state files round-trip between FSDP at TP-2 x DP-2 and world 1;
- `train.main --dp-devices 2 --tp-devices 2 --fsdp --save` (JAX's
  `test_fsdp_cli_smoke`): rank 0 alone prints and writes, the file has
  world 1's names and shapes, the run's own tensors, and loads back;
  `--audio --fp8-serving --lora-rank 4 --fsdp` near world 1's losses;
- the refusals: `--fsdp` without `--dp-devices > 1`, a sequence axis, a
  layout that is not the slices'.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ltx2_tpu.parallel import mesh as jmesh
from ltx2_tpu.parallel import sharding as jsharding
from ltx2_tpu.training import lora as jlora
from ltx2_tpu.training import trainer as jtrainer
from ltx2_tpu_torch import train
from ltx2_tpu_torch.loader.export import inverse_rewrite
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, flatten_tree, trainable_to_numpy
from ltx2_tpu_torch.loader.weight_loader import DIFFUSION_PREFIX, load_transformer_params
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.parallel.mesh import Axis
from ltx2_tpu_torch.parallel.sharding import shard_model_fsdp_, tp_split_dim
from ltx2_tpu_torch.training import (
    TrainConfig, data_shard_dim, fsdp_param_shardings, make_optimizer, make_train_step, trainable_mask,
    zero1_opt_state_shardings, zero2_grad_shardings,
)
from ltx2_tpu_torch.training.checkpoint import load_train_state
from tests.test_torch_port_train_dp import (
    AV, CLI, JAV, JVIDEO, KW, STEPS, VIDEO, _batch, _draws, _lora_tree, _stacked, _world1_grads, _world1_state,
)
from tests.test_torch_port_train_tp import ATOL_CLI_STEPS, TP_CLI, _file, _lines
from tests.torch_port_util import assert_close, random_tree, spawn_ranks
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

WORLD = 4
# Port job -> (TP, DP, microbatches, tree).
CASES = {"dp4": (1, 4, 1, "video"), "tp2_dp2": (2, 2, 1, "video"), "tp2_dp2_accum2": (2, 2, 2, "video"),
         "lora": (2, 2, 1, "lora"), "av_lora": (2, 2, 1, "av_lora")}
# JAX's test_fsdp_cli_smoke, on the CPU; the port's run also keeps an EMA (on the slices) and a state file.
FSDP_CLI = ["--placeholder", "--device", "cpu", "--synthetic", "2", "2", "3", "--steps", "2", "--batch-size", "2",
            "--lr", "1e-3", "--seed", "0", "--ema-decay", "0.5"]
FSDP_FLAGS = ["--dp-devices", "2", "--tp-devices", "2", "--fsdp"]
# The leaves FSDP keeps whole on the video DiT (per block), at any TP size as JAX does: the 1-D leaves
# whose one dim the TP rules split (the column-parallel biases, the Q/K norms).
WHOLE_OVER_DATA = {f"{a}.{leaf}" for a in ("attn1", "attn2")
                   for leaf in ("to_q.bias", "to_k.bias", "to_v.bias", "q_norm.weight", "k_norm.weight")}
WHOLE_OVER_DATA.add("ff.project_in.proj.bias")
# The leaves TP replicates (in a block: the row-parallel biases, the tables, LoRA's factors beside a split
# base; every non-block leaf), which are sliced over 'data' alone.
TP_REPLICATED = (r"^(?!transformer_blocks\.)|\.(to_out|project_out)\.bias$|scale_shift_table|"
                 r"(to_q|to_k|to_v|project_in\.proj)\.lora_A$|(to_out|project_out)\.lora_B$")


def _fsdp_layout(mesh, tree):
    """scripts/train.py's `_fsdp_shardings`: the FSDP layout of `tree` on
    `mesh`, for the placement and the step alike."""
    return jtrainer.fsdp_param_shardings(tree, jsharding.dit_param_shardings(mesh, tree), mesh)


def _jax_fsdp_train(tree, jcfg, fields, accum: int, lora: bool, tp: int, dp: int):
    """JAX's CLI path under --tp-devices tp --dp-devices dp --fsdp: the
    whole tree placed by the FSDP layout, the moments and gradients taking
    it through the ZeRO helpers, the step pinning its parameters to it, the
    batch sharded over 'data'; STEPS steps. Returns (losses, the trained
    leaves flattened)."""
    mesh = jmesh.create_mesh(data=dp, model=tp, devices=jax.devices()[:dp * tp])
    jtc = jtrainer.TrainConfig(**KW)
    raw = jax.tree_util.tree_map(jnp.asarray, tree)
    params = jax.tree_util.tree_map(jax.device_put, raw, _fsdp_layout(mesh, raw))
    opt = jtrainer.make_optimizer(jtc)
    mask = jlora.lora_trainable_mask(params) if lora else None
    target, frozen = jtrainer.partition_params(params, mask) if lora else (params, None)
    p_sh = _fsdp_layout(mesh, target)
    state = opt.init(target)
    opt_sh = jtrainer.zero1_opt_state_shardings(state, target, p_sh, mesh)
    state = jax.tree_util.tree_map(jax.device_put, state, opt_sh)
    grad_sh = jtrainer.zero2_grad_shardings(target, p_sh, mesh)
    step = jtrainer.make_train_step(jcfg, opt, jtc, trainable_mask=mask, accum_steps=accum,
                                    opt_state_shardings=opt_sh, grad_shardings=grad_sh, param_shardings=p_sh)
    batch = jtrainer.TrainBatch(**{k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
                                   for k, v in fields.items()})
    losses = []
    for i in range(STEPS):
        args = (target, state, frozen) if lora else (target, state)
        loss, target, state = step(*args, batch, jax.random.PRNGKey(20 + i))
        losses.append(float(loss))
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, target))
    return losses, {k: v for k, v in flat.items() if v.dtype != object}


def _job(tp, dp, accum, fields, lora=False, save=None):
    return {"tp": tp, "dp": dp, "accum": accum, "lora": lora, "tc": KW, "batch": fields,
            "draws": _draws(fields, accum), "save": save}


# Leaves (whole shapes) and the dim TP splits of each, as the TP file's: sliced over both axes, split over
# 'model' alone (its one dim the TP one), sliced over 'data' alone, and whole on every rank.
LEAF_SHAPES, LEAF_TP_DIMS = ((6, 4), (4,), (3, 6), (3,)), (0, 0, None, None)


def _leaf_grads():
    rng = np.random.default_rng(14)
    return [[rng.standard_normal(s).astype(np.float32) for s in LEAF_SHAPES] for _ in range(2)]


@pytest.fixture(scope="module")
def trees():
    video = _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**VIDEO), device="meta"), 51))
    av = _stacked(random_tree(model.LTXModel(model.LTXModelConfig(**AV), device="meta"), 52))
    return {"video": video, "av": av, "av_lora": _lora_tree(av), "lora": _lora_tree(video)}


def _cfg_of(tree_key):
    return AV if tree_key.startswith("av") else VIDEO


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """(each rank's results, the JAX references, the directory): the ranks
    run while the JAX steps compile here."""
    from tests.torch_port_train_fsdp_workers import run_jobs

    directory = tmp_path_factory.mktemp("train_fsdp")
    fields = {False: _batch(False), True: _batch(True)}
    _world1_state(trees["video"], str(directory / "world1_state.safetensors"))
    jobs = [(name, "train", (trees[key], _cfg_of(key),
                             _job(tp, dp, accum, fields[key.startswith("av")], lora=key != "video",
                                  save=str(directory / "fsdp_state.safetensors") if name == "tp2_dp2" else None)))
            for name, (tp, dp, accum, key) in CASES.items()]
    jobs += [("resume", "resume", (trees["video"], VIDEO, _job(2, 2, 1, fields[False]),
                                   str(directory / "world1_state.safetensors"))),
             ("leaves", "adamw_fsdp_leaves", (LEAF_SHAPES, LEAF_TP_DIMS, _leaf_grads(), KW, 2)),
             ("cli", "cli", (FSDP_CLI + FSDP_FLAGS + ["--save", str(directory / "fsdp.safetensors"),
                                                     "--save-state", str(directory / "cli_state.safetensors")],)),
             ("cli_av_fp8", "cli", (CLI + TP_CLI + ["--audio", "--fp8-serving", "--fsdp"],))]
    refs = {name: (trees[key], JAV if key.startswith("av") else JVIDEO, fields[key.startswith("av")], accum,
                   key != "video", tp, dp)
            for name, (tp, dp, accum, key) in CASES.items()}
    # XLA compiles with the GIL released: the references compile side by side.
    with concurrent.futures.ThreadPoolExecutor(1 + len(refs)) as pool:
        ranks = pool.submit(spawn_ranks, run_jobs, WORLD, directory / "ranks", jobs, timeout=900)
        refs = {k: pool.submit(_jax_fsdp_train, *args) for k, args in refs.items()}
        return ranks.result(), {k: f.result() for k, f in refs.items()}, directory


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_steps_match_jax(runs, case):
    """Losses and the trained parameters, gathered over 'data' and 'model',
    against JAX's FSDP step on the same mesh."""
    ranks, refs, _ = runs
    port, (losses, params) = ranks[0][case], refs[case]
    assert_close(np.array(port["losses"]), np.array(losses), msg=f"{case} losses")
    assert set(port["params"]) == set(params), case
    for k, v in params.items():
        assert_close(port["params"][k], v, msg=f"{case} {k}")
    assert sum(d is not None for d in port["shard_dims"]) > 0
    if CASES[case][0] > 1:
        assert any(port["model_split"]) and not all(port["model_split"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fsdp_averaged_gradients_are_world_1s(runs, trees, case):
    """The first update's gradient, each slice gathered whole, against the
    port's one-device gradient of the whole batch (which the one-device
    tests hold to JAX's): reduce-scattered once by the gathers' backward,
    averaged once."""
    ranks, _, _ = runs
    tp, dp, accum, key = CASES[case]
    fields = _batch(key.startswith("av"))
    ref = _world1_grads(trees[key], _cfg_of(key), fields, _draws(fields, accum)[0], accum, key != "video")
    got = ranks[0][case]["first_grads"]
    assert set(got) == set(ref)
    for name, want in ref.items():
        assert_close(got[name], want, rtol=1e-5, msg=f"{case} {name}")


def _jax_flat_specs(tree, data, tp):
    """{flattened key: JAX's FSDP spec} of the stacked `tree` on the (data,
    model) mesh."""
    mesh = jmesh.create_mesh(data=data, model=tp, devices=jax.devices()[:data * tp])
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(_fsdp_layout(mesh, params))[0]:
        out[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = tuple(sh.spec)
    return out


def _block_key(name):
    return re.sub(r"^transformer_blocks\.\d+\.", "transformer_blocks.", name)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2), (4, 1)])
@pytest.mark.parametrize("kind", ["video", "lora", "av", "av_lora"])
def test_fsdp_layout_is_jaxs(trees, kind, mesh_shape):
    """For every leaf, the port's 'data' dim (on each block's own leaf) is
    where JAX's `fsdp_param_shardings` puts 'data' on the stacked leaf, L
    removed; the buffers (LoRA's scales) are whole in both."""
    data, tp = mesh_shape
    specs = _jax_flat_specs(trees[kind], data, tp)
    dit = dit_from_numpy(trees[kind], model.LTXModelConfig(**_cfg_of(kind)))
    names = [n for n, _ in dit.named_parameters()]
    dims = fsdp_param_shardings(dit, Axis("data", data, 0, tuple(range(data))))
    buffers = {_block_key(n) for n, _ in dit.named_buffers()}
    assert {_block_key(n) for n in names} | buffers == set(specs)
    for name, d in zip(names, dims):
        key = _block_key(name)
        spec = specs[key][1:] if key != name else specs[key]
        assert d == (spec.index("data") if "data" in spec else None), (kind, mesh_shape, name, specs[key])
    assert all("data" not in specs[k] for k in buffers)
    if mesh_shape == (2, 4):  # JAX's own assertion (tests/test_training.py)
        assert specs["transformer_blocks.attn1.to_q.weight"] == (None, "model", "data")
        assert dims[names.index("transformer_blocks.0.attn1.to_q.weight")] == 1


@pytest.mark.parametrize("data", [2, 4])
def test_zero_helpers_keep_the_fsdp_layout(trees, data):
    """On a model sliced for FSDP, the ZeRO-1/2 helpers give the trainable
    parameters' FSDP dims unchanged (JAX's pass-through of a spec holding
    'data'), also where the rule on a slice's own shape would pick another
    dim; a model is sliced once."""
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: True)
    axis = Axis("data", data, data - 1, tuple(range(data)))
    layout = fsdp_param_shardings(dit, axis)
    shard_model_fsdp_(dit, axis, layout)
    named = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    params, names = [p for _, p in named], [n for n, _ in named]
    assert fsdp_param_shardings(dit, axis) == layout
    assert fsdp_param_shardings(dit, axis, names) == layout  # every parameter trains
    for helper in (zero1_opt_state_shardings, zero2_grad_shardings):
        assert helper(params, axis, names) == layout and helper(params, axis) == layout
    if data == 2:  # the rule on (3, 64), half of a (6, 64) table, would pick dim 1
        assert any(data_shard_dim(tuple(p.shape), data, tp_split_dim(n)) != d for (n, p), d in zip(named, layout))
    with pytest.raises(ValueError, match="FSDP slices already"):
        shard_model_fsdp_(dit, axis, layout)


def _whole_numel(trees, key):
    """{port name: the whole leaf's element count} of world 1's DiT."""
    out = {}
    for name, arr in flatten_tree(trees[key]).items():
        if name.startswith("transformer_blocks."):
            rest = name.partition(".")[2]
            out.update({f"transformer_blocks.{i}.{rest}": int(np.prod(arr.shape[1:])) for i in range(arr.shape[0])})
        else:
            out[name] = int(arr.size)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_bytes_are_world_1s_over_dp_tp(runs, trees, case):
    """Each rank holds world 1's parameter bytes over DP x TP, but the
    leaves FSDP keeps whole (listed: the 1-D leaves TP splits, at any TP
    size) and those TP replicates (listed by pattern), each of which holds
    its own share; every local shape is the whole one sliced."""
    ranks, _, _ = runs
    tp, dp, _, key = CASES[case]
    numel = _whole_numel(trees, key)
    for r in ranks:
        held = listed_held = listed_world1 = 0
        kept, replicated = set(), set()
        for name, (local, _, _, tp_dim, d, _) in r[case]["layout"].items():
            split = tp > 1 and tp_dim is not None
            n = numel[name] // (tp if split else 1) // (dp if d is not None else 1)
            assert int(np.prod(local)) == n, name
            held += 4 * n
            if d is None:
                kept.add(_block_key(name))
            if tp > 1 and not split:
                replicated.add(_block_key(name))
            if d is None or (tp > 1 and not split):
                listed_held, listed_world1 = listed_held + 4 * n, listed_world1 + 4 * numel[name]
        assert r[case]["param_bytes"] == held
        world1 = 4 * sum(numel[name] for name in r[case]["layout"])
        assert (held - listed_held) * dp * tp == world1 - listed_world1
        if key == "video":
            assert kept == {f"transformer_blocks.{k}" for k in WHOLE_OVER_DATA}, kept
        assert all(re.search(TP_REPLICATED, k) for k in replicated), [k for k in replicated
                                                                     if not re.search(TP_REPLICATED, k)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_slices_differ_and_gather_alike(runs, case):
    """Every rank returns the same losses; a rank's slices differ from its
    'data' peers' (frozen leaves too), the leaves kept whole are equal along
    'data'; gathered whole, every parameter is the same on every rank."""
    ranks, _, _ = runs
    tp, dp = CASES[case][:2]
    assert all(r[case]["losses"] == ranks[0][case]["losses"] for r in ranks)
    layout = ranks[0][case]["layout"]
    sliced = [n for n, v in layout.items() if v[4] is not None]
    frozen = [n for n, v in layout.items() if not v[5]]
    assert sliced and bool(frozen) == (CASES[case][3] != "video")
    for line in _lines(tp, dp)[1]:
        for n in layout:
            for r in line[1:]:
                a, b = ranks[r][case]["local"][n], ranks[line[0]][case]["local"][n]
                assert np.array_equal(a, b) == (layout[n][4] is None), n
    for r in ranks[1:]:
        for n, v in ranks[0][case]["gathered"].items():
            np.testing.assert_array_equal(r[case]["gathered"][n], v, err_msg=n)


def _op(op_bytes, op):
    return op_bytes.get(f"{op} data gloo", {"sent": 0})["sent"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_data_bytes_equal_the_reckoning(runs, case):
    """The last step's bytes over 'data', by operation: each microbatch
    gathers every sliced block leaf twice (the forward, the remat
    recompute) and every sliced non-block leaf once, and reduce-scatters
    the fp32 gradient of every sliced trainable leaf; the leaves kept whole
    are all-reduced once, beside the loss and the clip's two sums. Nothing
    is gathered after the update, no gradient reduced twice."""
    ranks, _, _ = runs
    tp, dp, accum, _ = CASES[case]
    for r in ranks:
        out = r[case]
        gather = scatter = 0
        reduce = 2 * (dp - 1) * 4 // dp + 2 * (dp - 1) * 8 // dp  # the loss, the clip's (2,) sums
        for name, (local, _, _, _, d, trainable) in out["layout"].items():
            n = int(np.prod(local))
            if d is not None:
                gather += accum * (2 if name.startswith("transformer_blocks.") else 1) * (dp - 1) * 4 * n
                scatter += accum * (dp - 1) * 4 * n if trainable else 0
            elif trainable:
                reduce += 2 * (dp - 1) * 4 * n // dp
        got = out["op_bytes"]
        assert {k for k in got if " data " in k} == {f"{op} data gloo" for op in
                                                     ("all_gather", "reduce_scatter", "all_reduce")}, got
        assert (_op(got, "all_gather"), _op(got, "reduce_scatter"), _op(got, "all_reduce")) == \
            (gather, scatter, reduce), case
        assert out["step_bytes"]["data gloo"]["sent"] == gather + scatter + reduce
        assert out["grad_bytes"] == 4 * sum(int(np.prod(v[2])) for v in out["layout"].values() if v[5])
        assert all(v[1] == v[2] == v[0] for v in out["layout"].values() if v[5])  # moments, gradients: slices


def test_fsdp_clip_counts_each_leaf_once_across_both_axes(runs):
    """AdamW over FSDP slices of leaves split over 'model' (and sliced over
    'data'), split alone, sliced alone and whole, at TP-2 x DP-2, against
    optax's clip + adamw on the whole leaves and the mean gradient, the
    clip biting; each rank's moments are its slices."""
    ranks, _, _ = runs
    out = ranks[0]["leaves"]
    assert out["dims"] == [1, None, 1, None]
    assert out["moment_shapes"] == [(3, 2), (2,), (3, 3), (3,)]
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
    for job in CASES:
        assert len({r[job]["norm"] for r in ranks}) == 1, job


def test_fsdp_state_round_trips_with_world_1(runs, trees):
    """The state written under FSDP at TP-2 x DP-2 (whole tensors, gathered
    over 'data' and 'model') reads back at that layout and at world 1; a
    world-1 state reads into the FSDP layout, each rank its slices."""
    ranks, _, directory = runs
    for r in ranks:
        assert r["tp2_dp2"]["reloaded_step"] == STEPS and r["tp2_dp2"]["reloaded_equal"]
        res = r["resume"]
        assert res["step"] == 1 and res["slices_equal"] and res["model_split"] > 0 and res["data_sliced"] > 0, res
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: True)
    names = [n for n, p in dit.named_parameters() if p.requires_grad]
    opt = make_optimizer(TrainConfig(**KW), [p for p in dit.parameters() if p.requires_grad])
    assert load_train_state(str(directory / "fsdp_state.safetensors"), dit, opt) == STEPS
    for name, mu, nu in zip(names, opt.mu, opt.nu):
        np.testing.assert_array_equal(mu.numpy(), ranks[0]["tp2_dp2"]["moments"][name][0], err_msg=name)
        np.testing.assert_array_equal(nu.numpy(), ranks[0]["tp2_dp2"]["moments"][name][1], err_msg=name)
    loaded = trainable_to_numpy(dit)
    for k, v in ranks[0]["tp2_dp2"]["params"].items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)


def test_fsdp_cli_smoke(runs, tmp_path):
    """JAX's test_fsdp_cli_smoke through the port: `train.main
    --dp-devices 2 --tp-devices 2 --fsdp --save` on four ranks, with an
    EMA and `--save-state`. Rank 0 alone prints and writes (every rank
    joins the gathers); the checkpoint and the state file have world 1's
    names and shapes, the checkpoint holds the run's own tensors gathered
    whole, near world 1's, and loads back."""
    ranks, _, directory = runs
    out = [r["cli"] for r in ranks]
    path, state = str(directory / "fsdp.safetensors"), str(directory / "cli_state.safetensors")
    assert all(o["calls"] == [path] for o in out)
    assert sorted(out[0]["writes"]) == sorted([path, state + ".tmp"]) and all(not o["writes"] for o in out[1:])
    assert all(o["stdout"] == "" for o in out[1:]) and '"zero": 3' in out[0]["stdout"]
    assert all(o["losses"] == out[0]["losses"] for o in out) and len(out[0]["losses"]) == 2
    assert all(o["param_bytes"] == out[0]["param_bytes"] for o in out)
    world1 = train.main(FSDP_CLI + ["--save", str(tmp_path / "world1.safetensors"),
                                    "--save-state", str(tmp_path / "world1_state.safetensors")])
    assert out[0]["param_bytes"] * 2 <= world1["param_bytes"]
    written, reference = _file(state), _file(tmp_path / "world1_state.safetensors")
    assert {k: v.shape for k, v in written.items()} == {k: v.shape for k, v in reference.items()}
    assert any(k.startswith("ema.") for k in written)
    for k, v in reference.items():
        if not k.startswith("adam."):  # the weights and their EMA; Adam's moments follow the gradients' sums
            assert np.abs(written[k] - v).max() <= ATOL_CLI_STEPS, k
    written, reference = _file(path), _file(tmp_path / "world1.safetensors")
    assert {k: v.shape for k, v in written.items()} == {k: v.shape for k, v in reference.items()}
    for name, value in out[0]["trained"].items():
        np.testing.assert_array_equal(written[DIFFUSION_PREFIX + inverse_rewrite(name)], value, err_msg=name)
    for k, v in reference.items():
        assert np.abs(written[k] - v).max() <= ATOL_CLI_STEPS, k
    back = load_transformer_params(path, train.PLACEHOLDER_CONFIG, device="cpu")
    for name, p in back.named_parameters():
        np.testing.assert_array_equal(p.float().numpy(), out[0]["trained"][name], err_msg=name)


def test_cli_av_fp8_lora_under_fsdp(runs):
    """`--audio --fp8-serving --lora-rank 4 --fsdp` at TP-2 x DP-2: the AV
    DiT's fp8 codes sliced and gathered beside their whole per-tensor
    scales, every rank's losses alike and near world 1's."""
    ranks, _, _ = runs
    out = [r["cli_av_fp8"] for r in ranks]
    stdout = out[0]["stdout"]
    assert '"fp8_base": true' in stdout and '"model_type": "AudioVideo"' in stdout and '"zero": 3' in stdout
    assert all(o["losses"] == out[0]["losses"] for o in out) and all(np.isfinite(out[0]["losses"]))
    world1 = train.main(CLI + ["--audio", "--fp8-serving"])
    assert_close(np.array(out[0]["losses"]), np.array(world1["losses"]), rtol=2e-2, msg="AV fp8 losses vs world 1")


def test_fsdp_refusals(trees):
    """--fsdp needs a 'data' axis (the JAX CLI's words); the step refuses
    a sequence axis, a layout on a model not sliced, a sliced model
    without its layout and a layout other than the slices'."""
    for flags in ([], ["--tp-devices", "2"]):
        with pytest.raises(SystemExit, match=r"--fsdp needs --dp-devices > 1 \(a 'data' axis to shard over\)"):
            train.main(CLI + flags + ["--fsdp"])
    dit = dit_from_numpy(trees["video"], model.LTXModelConfig(**VIDEO))
    trainable_mask(dit, lambda name: "attn1" in name)
    params = [p for p in dit.parameters() if p.requires_grad]
    with pytest.raises(ValueError, match="param_shardings: the model is not sliced"):
        make_train_step(dit, make_optimizer(TrainConfig(), params), param_shardings=[None] * len(params))
    axis = Axis("data", 2, 0, (0, 1))
    shard_model_fsdp_(dit, axis, fsdp_param_shardings(dit, axis))
    named = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    params, names = [p for _, p in named], [n for n, _ in named]
    layout = fsdp_param_shardings(dit, axis, names)
    with pytest.raises(ValueError, match="FSDP slices over 'data': pass param_shardings"):
        make_train_step(dit, make_optimizer(TrainConfig(), params), data_axis=axis)
    wrong = [None if d is not None else 0 for d in layout]
    with pytest.raises(ValueError, match=r"param_shardings: transformer_blocks\.0\.attn1"):
        make_train_step(dit, make_optimizer(TrainConfig(), params), data_axis=axis, param_shardings=wrong)
    with pytest.raises(ValueError, match="data_axis must be the 'data' axis"):
        make_train_step(dit, make_optimizer(TrainConfig(), params), param_shardings=layout)
    dit.cfg = dataclasses.replace(dit.cfg, sequence_axis=Axis("seq", 2, 0, (0, 1)))
    with pytest.raises(NotImplementedError, match="sequence_axis: training under sequence parallelism"):
        make_train_step(dit, make_optimizer(TrainConfig(), params), data_axis=axis, param_shardings=layout)
