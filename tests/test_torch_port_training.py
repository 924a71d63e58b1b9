"""The port's training path (ltx2_tpu_torch.training, train.py) against the
JAX package's (ltx2_tpu.training), in float32 on the CPU, to a relative
1e-4, on the small DiT of tests/torch_port_util.py with LoRA adapters.

The JAX tree (LoRA leaves included) reaches the port through
loader/from_numpy.py; sigmas and noise are JAX's own draws from its key
splits, handed to the port; updated adapters come back through
`trainable_to_numpy` and are held against optax's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.ops import common as jcommon
from ltx2_tpu.ops import rope as jrope
from ltx2_tpu.training import lora as jlora
from ltx2_tpu.training import trainer as jtrainer
from ltx2_tpu.utils.flops import dit_step_flops
from ltx2_tpu_torch import train
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, flatten_tree, trainable_to_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.ops import common, rope
from ltx2_tpu_torch.training import lora, trainer
from tests.torch_port_util import CFG, JCFG, assert_close, force_flash_route, numpy_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RANK, ALPHA = 4, 8.0
ADAPTER_LEAVES = ("lora_A", "lora_B")


@pytest.fixture(scope="module")
def lora_tree():
    """A numpy DiT tree with stacked adapters from JAX add_lora_params; B is
    randomised so that A gets a gradient too."""
    base = jax.tree_util.tree_map(jnp.asarray, numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), 3))
    jp, n = jlora.add_lora_params(jax.random.PRNGKey(5), base, rank=RANK, alpha=ALPHA)
    rng = np.random.default_rng(4)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("['lora_B']"):
            return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jp), n


def _batches(masked: bool, batch: int = 2):
    rng = np.random.default_rng(6)
    grid = np.asarray(jrope.create_position_grid(batch, 2, 2, 3), np.float32)
    positions = np.stack([grid, grid + 1], axis=-1)
    x0 = rng.standard_normal((batch, 12, 16)).astype(np.float32)
    context = (rng.standard_normal((batch, 5, 256)) * 0.1).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((batch, 5), bool)
        mask[1, 3:] = False
    jb = jtrainer.TrainBatch(x0=jnp.asarray(x0), positions=jnp.asarray(positions), context=jnp.asarray(context),
                             context_mask=None if mask is None else jnp.asarray(mask))
    pb = trainer.TrainBatch(x0=t(x0), positions=t(positions), context=t(context),
                            context_mask=None if mask is None else torch.from_numpy(mask))
    return jb, pb


def _jax_draws(key, shape, tc, accum_steps=1):
    """The sigmas and noise JAX's rectified_flow_loss draws from `key`
    (per microbatch key when the step accumulates)."""
    keys = [key] if accum_steps == 1 else list(jax.random.split(key, accum_steps))
    micro = (shape[0] // accum_steps,) + tuple(shape[1:])
    sig, noise = [], []
    for k in keys:
        k_sigma, k_v, _ = jax.random.split(k, 3)
        sig.append(np.asarray(jtrainer._sample_sigmas(k_sigma, micro[0], tc)))
        noise.append(np.asarray(jax.random.normal(k_v, micro, jnp.float32)))
    return t(np.concatenate(sig)), t(np.concatenate(noise))


def _port(tree, **cfg):
    m = dit_from_numpy(tree, dataclasses.replace(CFG, **cfg))
    lora.lora_trainable_mask(m)
    return m


def _adapters(flat):
    return {k: v for k, v in flat.items() if k.rsplit(".", 1)[-1] in ADAPTER_LEAVES}


def test_lora_linear_matches_jax():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((3, 7, 32), (48, 32), (48,)))
    a, bb = (rng.standard_normal(s).astype(np.float32) for s in ((RANK, 32), (48, RANK)))
    lin = lora.attach_lora_(common.Linear(32, 48), RANK)
    for name, v in (("weight", w), ("bias", b), ("lora_A", a), ("lora_B", bb)):
        getattr(lin, name).data = t(v)
    lin.lora_scale.fill_(2.0)
    ref = jcommon.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b), "lora_A": jnp.asarray(a),
                          "lora_B": jnp.asarray(bb), "lora_scale": jnp.float32(2.0)}, jnp.asarray(x))
    assert_close(common.linear(lin, t(x)), ref, msg="lora linear")


def test_add_lora_identity_targets_and_strip(lora_tree):
    tree, n_jax = lora_tree
    dit = model.init_ltx_model_(model.LTXModel(CFG), torch.Generator().manual_seed(0))
    _, pb = _batches(masked=False)
    video = model.Modality(latent=pb.x0, context=pb.context, context_mask=None, timesteps=torch.tensor([0.3, 0.7]),
                           positions=pb.positions)
    with torch.no_grad():
        base = model.ltx_model_apply(dit, video)
        n = lora.add_lora_params_(dit, torch.Generator().manual_seed(1), rank=RANK, alpha=ALPHA)
        assert torch.equal(model.ltx_model_apply(dit, video), base), "B = 0: the adapted model is the base"
    assert n == n_jax * CFG.num_layers
    stacked = {k[: -len(".lora_A")] for k in flatten_tree(tree) if k.endswith(".lora_A")}
    expected = {f"transformer_blocks.{i}.{s[len('transformer_blocks.'):]}" for s in stacked
                for i in range(CFG.num_layers)}
    assert {name for name, m in dit.named_modules() if hasattr(m, "lora_A")} == expected
    a = torch.cat([m.lora_A.flatten() for m in dit.modules() if hasattr(m, "lora_A")])
    assert abs(float(a.std()) - RANK ** -0.5) < 0.05 * RANK ** -0.5
    assert all(float(m.lora_scale) == ALPHA / RANK for m in dit.modules() if hasattr(m, "lora_A"))
    names = lora.lora_trainable_mask(dit)
    assert len(names) == 2 * n and all(p.requires_grad == (nm in names) for nm, p in dit.named_parameters())
    lora.strip_lora_params(dit)
    assert not any(hasattr(m, "lora_A") for m in dit.modules())
    with torch.no_grad():
        assert torch.equal(model.ltx_model_apply(dit, video), base)


def test_from_numpy_carries_adapters_both_ways(lora_tree):
    tree, _ = lora_tree
    back = trainable_to_numpy(_port(tree))
    ref = _adapters(flatten_tree(tree))
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_adapter_grads_match_jax(lora_tree, masked):
    tree, _ = lora_tree
    jb, pb = _batches(masked)
    tc = jtrainer.TrainConfig()
    key = jax.random.PRNGKey(9)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.value_and_grad(lambda p: jtrainer.rectified_flow_loss(p, JCFG, jb, key, tc))(jp)

    dit = _port(tree)
    sigmas, noise = _jax_draws(key, pb.x0.shape, tc)
    loss = trainer.rectified_flow_loss(dit, pb, None, trainer.TrainConfig(), sigmas, noise)
    loss.backward()
    assert_close(loss, jloss, msg="loss")
    for key_, ref in _adapters(flatten_tree(jgrads)).items():
        leaf = key_[len("transformer_blocks."):]
        got = np.stack([dit.get_parameter(f"transformer_blocks.{i}.{leaf}").grad.numpy()
                        for i in range(CFG.num_layers)])
        assert np.abs(ref).max() > 0
        assert_close(got, ref, msg=f"grad {key_}")


@pytest.mark.parametrize("remat", [False, True])
def test_adapter_grads_on_the_flash_route_match_jax(lora_tree, monkeypatch, remat):
    """The loss and adapter gradients through FlashAttention's custom
    backward (the kernels' plain versions), the card's bf16 route, with and
    without remat; fp32 `sdpa` at these sizes takes sdpa_plain."""
    seen = force_flash_route(monkeypatch)
    tree, _ = lora_tree
    jb, pb = _batches(masked=True)
    tc = jtrainer.TrainConfig()
    key = jax.random.PRNGKey(9)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jloss, jgrads = jax.value_and_grad(lambda p: jtrainer.rectified_flow_loss(p, JCFG, jb, key, tc))(jp)

    dit = _port(tree, remat=remat)
    sigmas, noise = _jax_draws(key, pb.x0.shape, tc)
    loss = trainer.rectified_flow_loss(dit, pb, None, trainer.TrainConfig(), sigmas, noise)
    loss.backward()
    assert seen["backward"] == 2 * CFG.num_layers  # self- and cross-attention of each block
    assert_close(loss, jloss, msg="loss")
    for key_, ref in _adapters(flatten_tree(jgrads)).items():
        leaf = key_[len("transformer_blocks."):]
        got = np.stack([dit.get_parameter(f"transformer_blocks.{i}.{leaf}").grad.numpy()
                        for i in range(CFG.num_layers)])
        assert_close(got, ref, msg=f"grad {key_}")


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_optax(lora_tree, accum_steps):
    """Two steps of clip + AdamW (weight decay, 1-step warmup into a cosine
    decay) on the adapters only, against JAX's partitioned train step."""
    tree, _ = lora_tree
    kw = dict(learning_rate=1e-2, weight_decay=0.01, grad_clip_norm=1e-3, warmup_steps=1, lr_schedule="cosine",
              total_steps=3)
    jtc, tc = jtrainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    jb, pb = _batches(masked=True)

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    mask = jlora.lora_trainable_mask(jp)
    opt = jtrainer.make_optimizer(jtc)
    jstep = jtrainer.make_train_step(JCFG, opt, jtc, trainable_mask=mask, accum_steps=accum_steps)
    trainable, frozen = jtrainer.partition_params(jp, mask)
    opt_state = opt.init(trainable)

    dit = _port(tree)
    params = [p for p in dit.parameters() if p.requires_grad]
    step = trainer.make_train_step(dit, trainer.make_optimizer(tc, params), tc, accum_steps=accum_steps)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        jl, trainable, opt_state = jstep(trainable, opt_state, frozen, jb, key)
        loss = step(pb, None, *_jax_draws(key, pb.x0.shape, jtc, accum_steps))
        assert_close(loss, jl, msg=f"loss {i}")
    got = trainable_to_numpy(dit)
    ref = _adapters(flatten_tree(jax.tree_util.tree_map(np.asarray, trainable)))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert not np.array_equal(v, _adapters(flatten_tree(tree))[k]), f"{k} did not move"
        assert_close(got[k], v, msg=f"updated {k}")


def test_remat_gives_the_same_grads(lora_tree):
    tree, _ = lora_tree
    _, pb = _batches(masked=True)
    sigmas, noise = t(np.array([0.3, 0.8], np.float32)), t(np.random.default_rng(2).standard_normal((2, 12, 16)))
    grads = []
    for remat in (True, False):
        dit = _port(tree, remat=remat)
        trainer.rectified_flow_loss(dit, pb, None, trainer.TrainConfig(), sigmas, noise).backward()
        grads.append({n: p.grad for n, p in dit.named_parameters() if p.requires_grad})
    for n in grads[0]:
        assert_close(grads[0][n], grads[1][n].numpy(), rtol=1e-6, msg=n)


@pytest.mark.parametrize("kw", [
    dict(learning_rate=3e-4),
    dict(learning_rate=1e-3, warmup_steps=4),
    dict(learning_rate=1e-3, warmup_steps=10, lr_schedule="cosine", total_steps=110),
    dict(learning_rate=1e-3, lr_schedule="linear", total_steps=100),
    dict(learning_rate=1e-3, warmup_steps=5, lr_schedule="linear", total_steps=50),
])
def test_learning_rate_schedule_matches_optax(kw):
    ref = jtrainer.learning_rate_schedule(jtrainer.TrainConfig(**kw))
    got = trainer.learning_rate_schedule(trainer.TrainConfig(**kw))
    assert callable(got) == callable(ref)
    for step in range(0, 125):
        want = float(ref(step)) if callable(ref) else ref
        have = got(step) if callable(got) else got
        # optax evaluates in float32: hold each value to 1e-6 of the peak rate.
        np.testing.assert_allclose(have, want, rtol=0, atol=1e-6 * kw["learning_rate"], err_msg=f"step {step}")
    with pytest.raises(ValueError, match="total_steps"):
        trainer.learning_rate_schedule(trainer.TrainConfig(lr_schedule="cosine"))
    with pytest.raises(ValueError, match="lr_schedule"):
        trainer.learning_rate_schedule(trainer.TrainConfig(lr_schedule="poly"))


def test_ema_matches_jax():
    target = [torch.full((3,), 2.0), torch.full((2,), 4.0, dtype=torch.bfloat16)]
    ema = trainer.init_ema(target)
    target[0].add_(1.0)  # the EMA holds copies, not aliases
    assert torch.equal(ema[0], torch.full((3,), 2.0)) and ema[1].dtype == torch.float32
    jema = jtrainer.init_ema({"a": jnp.full((3,), 2.0, jnp.float32), "b": jnp.full((2,), 4.0, jnp.bfloat16)})
    update, jupdate = trainer.make_ema_update(0.9), jtrainer.make_ema_update(0.9)
    new = [torch.full((3,), 10.0), torch.full((2,), 10.0, dtype=torch.bfloat16)]
    jnew = {"a": jnp.full((3,), 10.0, jnp.float32), "b": jnp.full((2,), 10.0, jnp.bfloat16)}
    for _ in range(2):
        ema, jema = update(ema, new), jupdate(jema, jnew)
    assert_close(ema[0], jema["a"], rtol=1e-6, msg="ema a")
    assert_close(ema[1], jema["b"], rtol=1e-6, msg="ema b")
    out = trainer.ema_params(ema, target)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.bfloat16


def test_flops_and_position_grid_match_jax():
    jcfg = dataclasses.replace(JCFG, num_layers=48, num_attention_heads=32, cross_attention_dim=4096, in_channels=128)
    assert train.dit_forward_flops(model.LTXModelConfig(), 6144, 1024) == dit_step_flops(jcfg, 6144, 1024)
    np.testing.assert_array_equal(rope.create_position_grid(2, 3, 2, 5).numpy(),
                                  np.asarray(jrope.create_position_grid(2, 3, 2, 5)))


def test_unported_options_raise(lora_tree):
    tree, _ = lora_tree
    dit = _port(tree)
    opt = trainer.make_optimizer(trainer.TrainConfig(), [p for p in dit.parameters() if p.requires_grad])
    with pytest.raises(NotImplementedError):
        trainer.make_train_step(dit, opt, grad_shardings=object())
    for flag in (["--fsdp"], ["--zero2"], ["--tp-devices", "2"], ["--dp-devices", "2"]):
        with pytest.raises(NotImplementedError, match="one device"):
            train.main(["--placeholder", "--device", "cpu", "--synthetic", "1", "2", "2", *flag])
    # Audio fields on a video-only model: the JAX package's ValueError.
    _, pb = _batches(masked=False)
    with pytest.raises(ValueError, match="video-only"):
        trainer.rectified_flow_loss(dit, dataclasses.replace(pb, audio_x0=pb.x0))


def test_train_entry_on_cpu():
    zero_b = []

    def on_step(i, dit, loss):
        if i == 0:
            zero_b.extend(n for n, p in dit.named_parameters() if n.endswith("lora_B") and not p.abs().max() > 0)

    res = train.main(["--placeholder", "--device", "cpu", "--layers", "2", "--synthetic", "2", "2", "3",
                      "--steps", "2", "--lora-rank", "4", "--log-every", "1", "--val-fraction", "0.25",
                      "--eval-every", "1", "--ema-decay", "0.5"], on_step=on_step)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"])) and len(res["val_losses"]) == 2
    assert res["adapters"] == 20 and not zero_b
    fresh = dict(train.make_model(2, torch.device("cpu"), 0, placeholder=True).named_parameters())
    for name, p in res["model"].named_parameters():
        if name in fresh:
            assert torch.equal(p, fresh[name]), f"base weight {name} changed"
    with pytest.raises(SystemExit):
        train.main(["--placeholder", "--device", "cpu", "--synthetic", "2", "2", "3", "--lora-rank", "4",
                    "--trainable", "attn"])


def test_train_entry_trainable_regex_on_cpu():
    res = train.main(["--placeholder", "--device", "cpu", "--layers", "1", "--synthetic", "1", "2", "2",
                      "--steps", "1", "--trainable", r"attn1\.to_q\.weight", "--lr", "1e-3"])
    assert res["trainable"] == ["transformer_blocks.0.attn1.to_q.weight"]
    fresh = dict(train.make_model(1, torch.device("cpu"), 0, placeholder=True).named_parameters())
    for name, p in res["model"].named_parameters():
        assert torch.equal(p, fresh[name]) != (name in res["trainable"]), name
