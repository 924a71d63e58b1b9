"""The port's audio-video training, fp8 frozen base, audio-only DiT and
prepare_data against the JAX package, in float32 on the CPU.

A 2-layer audio-video parity DiT (video 2 heads x 32, audio 2 heads x 16)
drawn with `random_tree`, the same numpy weights in both packages, LoRA
adapters added by JAX's `add_lora_params` (B randomised so that A gets a
gradient too); the sigmas and both streams' noise are JAX's own draws from
its key splits, handed to the port. Checked: the AV loss (the audio with its
own context, and sharing the video's masked context), adapter gradients on
the fp32 route and on the flash route's plain versions, two AdamW steps
against optax, the adapters' names and their exported LoRA file, the
audio-branch freeze name for name and bit for bit under weight decay, the
fp8 frozen base's loss against JAX's `quantize_params_fp8` tree and its
refusals, the audio-only DiT, `prepare_data` against
scripts/prepare_data.py's npz, and `train.main --audio` on the CPU.
Tolerance: RTOL (1e-4 of the reference's largest magnitude,
tests/torch_port_util.py) unless stated.
"""

from __future__ import annotations

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import fp8 as jfp8
from ltx2_tpu.loader.lora import load_lora_weights
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.video_vae import encoder as jencoder
from ltx2_tpu.ops import rope as jrope
from ltx2_tpu.parallel.sharding import path_to_str
from ltx2_tpu.training import lora as jlora
from ltx2_tpu.training import trainer as jtrainer
from ltx2_tpu_torch import prepare_data, train
from ltx2_tpu_torch.loader import fp8
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy, flatten_tree, trainable_to_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.video_vae import encoder
from ltx2_tpu_torch.training import lora, trainer
from tests.torch_port_util import (
    assert_close, force_flash_route, jax_leaves, port_leaves, random_tree, stacked_dit_tree, t, write_png,
)

RANK, ALPHA, LAYERS = 4, 8.0, 2
# V1 with caption projections, so that the audio can share the video's context.
AV = dict(num_attention_heads=2, attention_head_dim=32, in_channels=16, out_channels=16, num_layers=LAYERS,
          cross_attention_dim=64, compute_dtype="float32", audio_heads=2, audio_head_dim=16, audio_in_channels=16,
          audio_out_channels=16, caption_channels=24)
CFG = model.LTXModelConfig(model_type=model.LTXModelType.AudioVideo, **AV)
JCFG = jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioVideo, remat=False, **AV)
ADAPTER_LEAVES = ("lora_A", "lora_B")
VIDEO_TOKENS, AUDIO_TOKENS = 12, 9


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's side here is tiny: one intra-op thread runs it fastest,
    above all when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def lora_tree():
    """The AV tree with JAX's adapters (stacked), B randomised."""
    jp, n = jlora.add_lora_params(jax.random.PRNGKey(5), _jtree(stacked_dit_tree(CFG, seed=11)), rank=RANK,
                                  alpha=ALPHA)
    rng = np.random.default_rng(4)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("['lora_B']"):
            return (rng.standard_normal(x.shape) * 0.05).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, jp), n


def _port(tree, **cfg):
    m = dit_from_numpy(tree, dataclasses.replace(CFG, **cfg))
    lora.lora_trainable_mask(m)
    return m


def _adapters(flat):
    return {k: v for k, v in flat.items() if k.rsplit(".", 1)[-1] in ADAPTER_LEAVES}


def _batches(case: str, batch: int = 2):
    """(JAX TrainBatch, port TrainBatch): 12 video tokens with a 5-token
    context, 9 audio tokens; "own": the audio's own 4-token context and
    mask; "shared": the audio shares the video's masked context; "video":
    no audio fields."""
    rng = np.random.default_rng(6)
    grid = np.asarray(jrope.create_position_grid(batch, 2, 2, 3), np.float32)
    f = dict(positions=np.stack([grid, grid + 1], axis=-1),
             x0=rng.standard_normal((batch, VIDEO_TOKENS, 16)).astype(np.float32),
             context=(rng.standard_normal((batch, 5, 24)) * 0.5).astype(np.float32))
    if case == "shared":
        mask = np.ones((batch, 5), bool)
        mask[1, 3:] = False
        f["context_mask"] = mask
    if case != "video":
        secs = np.arange(AUDIO_TOKENS, dtype=np.float32)[None, None, :] * 0.04
        f["audio_x0"] = rng.standard_normal((batch, AUDIO_TOKENS, 16)).astype(np.float32)
        f["audio_positions"] = np.repeat(np.stack([secs, secs + 0.04], axis=-1), batch, axis=0)
    if case == "own":
        f["audio_context"] = (rng.standard_normal((batch, 4, 24)) * 0.5).astype(np.float32)
        mask = np.ones((batch, 4), bool)
        mask[0, 2:] = False
        f["audio_context_mask"] = mask
    jb = jtrainer.TrainBatch(**{k: jnp.asarray(v) for k, v in f.items()})
    pb = trainer.TrainBatch(**{k: torch.from_numpy(v) for k, v in f.items()})
    return jb, pb


def _jax_loss(tree, batch, key, cfg=JCFG):
    return jax.jit(lambda p: jtrainer.rectified_flow_loss(p, cfg, batch, key, jtrainer.TrainConfig()))(_jtree(tree))


@pytest.fixture(scope="module")
def jax_own(lora_tree):
    """JAX's loss and gradients on the "own"-context batch at key 10."""
    tree, _ = lora_tree
    jb, _ = _batches("own")
    key = jax.random.PRNGKey(10)
    fn = jax.jit(jax.value_and_grad(lambda p: jtrainer.rectified_flow_loss(p, JCFG, jb, key, jtrainer.TrainConfig())))
    return key, fn(_jtree(tree))


def _jax_draws(key, batch, tc):
    """The sigmas and both streams' noise JAX's rectified_flow_loss draws."""
    k_sigma, k_v, k_a = jax.random.split(key, 3)
    sigmas = np.asarray(jtrainer._sample_sigmas(k_sigma, batch.x0.shape[0], tc))
    noise = np.asarray(jax.random.normal(k_v, batch.x0.shape, jnp.float32))
    out = [t(sigmas), t(noise)]
    if batch.audio_x0 is not None:
        out.append(t(np.asarray(jax.random.normal(k_a, batch.audio_x0.shape, jnp.float32))))
    return out


def _grads_by_tree_key(dit):
    """Adapter gradients stacked as the JAX tree holds them."""
    out = {}
    for name, p in dit.named_parameters():
        if p.grad is None:
            continue
        _, i, leaf = name.split(".", 2)
        out.setdefault(f"transformer_blocks.{leaf}", {})[int(i)] = p.grad.numpy()
    return {k: np.stack([v[i] for i in range(LAYERS)]) for k, v in out.items()}


@pytest.mark.parametrize("case", ["own", "shared"])
def test_av_loss_matches_jax(lora_tree, jax_own, case):
    tree, _ = lora_tree
    jb, pb = _batches(case)
    tc = jtrainer.TrainConfig()
    key, (jloss, _) = jax_own
    if case != "own":
        jloss = _jax_loss(tree, jb, key)
    loss = trainer.rectified_flow_loss(_port(tree), pb, None, trainer.TrainConfig(), *_jax_draws(key, pb, tc))
    assert_close(loss, jloss, msg=f"{case} loss")
    # The generator's own draws: sigmas, then the video noise, then the audio's.
    gen = torch.Generator().manual_seed(3)
    draws = [trainer._sample_sigmas(gen, 2, trainer.TrainConfig(), torch.device("cpu")),
             torch.randn(pb.x0.shape, generator=gen), torch.randn(pb.audio_x0.shape, generator=gen)]
    with torch.no_grad():
        dit = _port(tree)
        by_gen = trainer.rectified_flow_loss(dit, pb, torch.Generator().manual_seed(3))
        assert torch.equal(by_gen, trainer.rectified_flow_loss(dit, pb, None, trainer.TrainConfig(), *draws))


@pytest.mark.parametrize("route", ["fp32", "flash"])
def test_av_adapter_grads_match_jax(lora_tree, jax_own, monkeypatch, route):
    """Adapter gradients of the AV loss against jax.grad: on the fp32 route
    (`sdpa_plain`) and through FlashAttention's custom backward (the
    kernels' plain versions), with remat on the flash route."""
    seen = force_flash_route(monkeypatch) if route == "flash" else None
    tree, _ = lora_tree
    _, pb = _batches("own")
    tc = jtrainer.TrainConfig()
    key, (jloss, jgrads) = jax_own
    dit = _port(tree, remat=route == "flash")
    loss = trainer.rectified_flow_loss(dit, pb, None, trainer.TrainConfig(), *_jax_draws(key, pb, tc))
    loss.backward()
    if seen is not None:
        assert seen["backward"] == 6 * LAYERS  # every attention of each AV block
    assert_close(loss, jloss, msg="loss")
    got = _grads_by_tree_key(dit)
    ref = _adapters(flatten_tree(jgrads))
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.abs(v).max() > 0, k
        assert_close(got[k], v, msg=f"grad {k}")


def test_av_train_step_matches_optax(lora_tree):
    """Two clip + AdamW steps (weight decay, warmup into cosine) on the
    adapters, against JAX's partitioned step: the losses at RTOL, and the
    adapters in rms relative to what the steps moved them (1e-3). AdamW's
    update g / (sqrt(v) + 1e-8) is sign-like where |g| nears its eps, and
    such elements turn the packages' fp32 summation differences into
    percent-sized differences of their update, so no elementwise bound
    holds there."""
    tree, _ = lora_tree
    kw = dict(learning_rate=1e-2, weight_decay=0.01, grad_clip_norm=1.0, warmup_steps=1, lr_schedule="cosine",
              total_steps=3)
    jtc, tc = jtrainer.TrainConfig(**kw), trainer.TrainConfig(**kw)
    jb, pb = _batches("own")
    jp = _jtree(tree)
    mask = jlora.lora_trainable_mask(jp)
    opt = jtrainer.make_optimizer(jtc)
    jstep = jtrainer.make_train_step(JCFG, opt, jtc, trainable_mask=mask)
    trainable, frozen = jtrainer.partition_params(jp, mask)
    opt_state = opt.init(trainable)
    dit = _port(tree)
    step = trainer.make_train_step(dit, trainer.make_optimizer(tc, [p for p in dit.parameters() if p.requires_grad]),
                                   tc)
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        jl, trainable, opt_state = jstep(trainable, opt_state, frozen, jb, key)
        assert_close(step(pb, None, *_jax_draws(key, pb, jtc)), jl, msg=f"loss {i}")
    got, ref = trainable_to_numpy(dit), _adapters(flatten_tree(jax.tree_util.tree_map(np.asarray, trainable)))
    start = _adapters(flatten_tree(tree))
    assert set(got) == set(ref)
    for k, v in ref.items():
        moved = np.sqrt(np.mean((v - start[k]) ** 2))
        assert moved > 0, k
        assert np.sqrt(np.mean((got[k] - v) ** 2)) <= 1e-3 * moved, k


def test_av_lora_targets_and_export_match_jax(lora_tree, tmp_path):
    """The adapters `add_lora_params_` puts on the AV DiT are JAX's, name for
    name (the audio stream's and the cross-modal attentions' included), and
    the port's LoRA file holds JAX's keys and values and loads in the JAX
    package's load_lora_weights."""
    tree, n_jax = lora_tree
    dit = model.init_ltx_model_(model.LTXModel(CFG), torch.Generator().manual_seed(0))
    assert lora.add_lora_params_(dit, torch.Generator().manual_seed(1), rank=RANK, alpha=ALPHA) == n_jax * LAYERS
    stacked = {k[: -len(".lora_A")] for k in flatten_tree(tree) if k.endswith(".lora_A")}
    expected = {f"transformer_blocks.{i}.{s[len('transformer_blocks.'):]}" for s in stacked for i in range(LAYERS)}
    got = {name for name, m in dit.named_modules() if hasattr(m, "lora_A")}
    assert got == expected and any("video_to_audio_attn" in n for n in got) and any("audio_ff" in n for n in got)

    lora.export_lora_checkpoint(str(tmp_path / "port.safetensors"), _port(tree))
    jlora.export_lora_checkpoint(str(tmp_path / "jax.safetensors"), _jtree(tree))
    mine, ref = (load_lora_weights(str(tmp_path / f"{w}.safetensors")) for w in ("port", "jax"))
    assert set(mine) == set(ref) and any(".audio_attn1." in k for k in ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.mark.parametrize("with_mask", [False, True])
def test_freeze_audio_branch_mask_matches_jax(lora_tree, with_mask):
    """The frozen set, name for name, against JAX's mask over the stacked
    tree: alone (every leaf outside the audio branch trainable) and
    intersected with the LoRA mask."""
    tree, _ = lora_tree
    jp = _jtree(tree)
    jmask = jtrainer.freeze_audio_branch_mask(jp, jlora.lora_trainable_mask(jp) if with_mask else None)
    jflat = {}
    for path, m in jax.tree_util.tree_flatten_with_path(jmask)[0]:
        key = path_to_str(path).replace("/", ".")
        if key.startswith("transformer_blocks."):
            jflat.update({f"transformer_blocks.{i}.{key[len('transformer_blocks.'):]}": bool(m)
                          for i in range(LAYERS)})
        else:
            jflat[key] = bool(m)
    dit = dit_from_numpy(tree, CFG)
    names = lora.lora_trainable_mask(dit) if with_mask else None
    trained = trainer.freeze_audio_branch_mask(dit, names)
    params = dict(dit.named_parameters())
    assert set(params) <= set(jflat)
    assert {n for n in params if jflat[n]} == set(trained)
    assert all(p.requires_grad == (n in trained) for n, p in params.items())
    frozen = [n for n in params if not jflat[n]]
    assert any(".audio_attn1." in n for n in frozen) and any("video_to_audio_attn" in n for n in frozen)
    assert any(n.startswith("av_ca_") for n in frozen)


def test_frozen_audio_branch_is_bitwise_under_weight_decay(lora_tree):
    """Video-only batches on the AV DiT with weight decay: with the audio
    branch frozen every audio-branch tensor is bit for bit its start while
    the video adapters move; without the freeze the decay alone moves the
    audio adapters (their gradients are exactly zero)."""
    tree, _ = lora_tree
    _, pb = _batches("video")
    tc = trainer.TrainConfig(learning_rate=1e-2, weight_decay=0.1)
    audio_re = re.compile(trainer.AUDIO_BRANCH_PATTERN)
    moved = {}
    for freeze in (True, False):
        dit = _port(tree)
        names = trainer.freeze_audio_branch_mask(dit, lora.lora_trainable_mask(dit)) if freeze else None
        start = {n: p.detach().clone() for n, p in dit.named_parameters()}
        params = [p for p in dit.parameters() if p.requires_grad]
        step = trainer.make_train_step(dit, trainer.make_optimizer(tc, params), tc)
        for i in range(2):
            step(pb, torch.Generator().manual_seed(i))
        now = dict(dit.named_parameters())
        moved[freeze] = {n for n in start if not torch.equal(now[n], start[n])}
        if freeze:
            assert names and not any(audio_re.search(n) for n in names)
    assert moved[True] and not any(audio_re.search(n) for n in moved[True])
    assert any(audio_re.search(n) and n.endswith("lora_A") for n in moved[False])


def test_fp8_base_loss_matches_jax(lora_tree):
    """The frozen fp8 base: JAX's quantize_params_fp8 tree with the same
    adapters against the port's quantized model, the loss; the backward
    reaches the adapters (and nothing of the base) through `linear`'s
    dequantization."""
    tree, _ = lora_tree
    lora_keys = ("lora_A", "lora_B", "lora_scale")

    def strip(node):
        return {k: strip(v) for k, v in node.items() if k not in lora_keys} if isinstance(node, dict) else node

    def put_back(q, src):
        """The quantized tree `q` with `src`'s adapters where they were."""
        out = dict(q)
        for k, v in src.items():
            if k in lora_keys:
                out[k] = jnp.asarray(v)
            elif isinstance(v, dict):
                out[k] = put_back(q[k], v)
        return out

    jq = put_back(jfp8.quantize_params_fp8(_jtree(strip(tree))), tree)
    jb, pb = _batches("own")
    key = jax.random.PRNGKey(12)
    jloss = jax.jit(lambda p: jtrainer.rectified_flow_loss(p, JCFG, jb, key, jtrainer.TrainConfig()))(jq)
    dit = fp8.quantize_params_fp8(_port(tree))
    assert dit.transformer_blocks[0].audio_attn1.to_q.weight.dtype == torch.float8_e4m3fn
    loss = trainer.rectified_flow_loss(dit, pb, None, trainer.TrainConfig(), *_jax_draws(key, pb, jtrainer.TrainConfig()))
    assert_close(loss, jloss, msg="fp8 loss")
    loss.backward()
    assert {n for n, p in dit.named_parameters() if p.grad is not None} == {
        n for n, _ in dit.named_parameters() if n.endswith(ADAPTER_LEAVES)}


@pytest.mark.parametrize("flags, word", [
    ([], "requires --lora-rank or --trainable"),
    (["--trainable", r"attn1\.to_q"], "fp8-quantized"),
    (["--trainable", "weight_scale"], "fp8-quantized"),
])
def test_fp8_serving_refusals(flags, word):
    with pytest.raises(SystemExit) as err:
        train.main(["--placeholder", "--device", "cpu", "--layers", "1", "--synthetic", "1", "2", "2", "--steps", "1",
                    "--fp8-serving", *flags])
    assert word in str(err.value.code)


def test_fp8_serving_trains_the_unquantized_leaves_on_cpu():
    """--fp8-serving with a regex that names no fp8 weight (the biases):
    the fp8 codes and scales stay bit for bit their quantized draws."""
    res = train.main(["--placeholder", "--device", "cpu", "--layers", "1", "--synthetic", "1", "2", "2", "--steps",
                      "1", "--fp8-serving", "--trainable", r"attn1\.to_q\.bias", "--lr", "1e-2"])
    assert res["trainable"] == ["transformer_blocks.0.attn1.to_q.bias"]
    fresh = port_leaves(train.make_model(1, torch.device("cpu"), 0, placeholder=True, fp8=True))
    for name, p in port_leaves(res["model"]).items():
        same = torch.equal(p.view(torch.uint8), fresh[name].view(torch.uint8)) if p.dtype == torch.float8_e4m3fn \
            else torch.equal(p, fresh[name])
        assert same != (name in res["trainable"]), name


def _audio_only_configs():
    kw = {k: v for k, v in AV.items()}
    return (model.LTXModelConfig(model_type=model.LTXModelType.AudioOnly, **kw),
            jmodel.LTXModelConfig(model_type=jmodel.LTXModelType.AudioOnly, remat=False, **kw))


def test_audio_only_dit_matches_jax():
    """The audio-only DiT: its parameters are JAX's init tree's, name for
    name; `ltx_model_apply` (video=None) and `x0_model_apply` with BOTH
    modalities passed (the audio latent is denoised) against JAX."""
    cfg, jcfg = _audio_only_configs()
    init = model.init_ltx_model_(model.LTXModel(cfg), torch.Generator().manual_seed(0))
    jinit = jax_leaves(jmodel.init_ltx_model(jax.random.PRNGKey(0), jcfg))
    assert set(port_leaves(init)) == set(jinit)
    assert all(tuple(p.shape) == jinit[n].shape for n, p in port_leaves(init).items())
    tree = stacked_dit_tree(cfg, seed=13)
    dit, jp = dit_from_numpy(tree, cfg), _jtree(tree)
    assert not hasattr(dit, "patchify_proj") and not hasattr(dit.transformer_blocks[0], "attn1")
    jb, pb = _batches("own")
    rng = np.random.default_rng(2)
    sig = np.array([0.3, 0.8], np.float32)
    v_lat = rng.standard_normal((2, VIDEO_TOKENS, 16)).astype(np.float32)
    jv = jmodel.Modality(latent=jnp.asarray(v_lat), context=jb.context, context_mask=None, timesteps=jnp.asarray(sig),
                         positions=jb.positions, sigma=jnp.asarray(sig))
    ja = jmodel.Modality(latent=jb.audio_x0, context=jb.audio_context, context_mask=jb.audio_context_mask,
                         timesteps=jnp.asarray(sig), positions=jb.audio_positions, sigma=jnp.asarray(sig))
    pv = model.Modality(latent=t(v_lat), context=pb.context, context_mask=None, timesteps=t(sig),
                        positions=pb.positions, sigma=t(sig))
    pa = model.Modality(latent=pb.audio_x0, context=pb.audio_context, context_mask=pb.audio_context_mask,
                        timesteps=t(sig), positions=pb.audio_positions, sigma=t(sig))
    with torch.no_grad():
        velocity = model.ltx_model_apply(dit, None, audio=pa)
        assert torch.equal(model.ltx_model_apply(dit, pv, audio=pa), velocity)  # the video is ignored
        x0 = model.x0_model_apply(dit, pv, audio=pa)
    assert_close(velocity, jmodel.ltx_model_apply(jp, jcfg, audio=ja), msg="audio-only velocity")
    ref = jmodel.x0_model_apply(jp, jcfg, video=jv, audio=ja)
    assert ref.shape == (2, AUDIO_TOKENS, 16)
    assert_close(x0, ref, msg="audio-only x0 with both modalities")
    with pytest.raises(ValueError, match="audio modality"):
        model.ltx_model_apply(dit, pv)


def test_video_model_refuses_audio_fields():
    """JAX's ValueError: audio fields on a video-only model."""
    dit = model.init_ltx_model_(model.LTXModel(dataclasses.replace(CFG, model_type=model.LTXModelType.VideoOnly)),
                                torch.Generator().manual_seed(0))
    _, pb = _batches("own")
    with pytest.raises(ValueError, match="video-only"):
        trainer.rectified_flow_loss(dit, pb, torch.Generator().manual_seed(0))


# prepare_data's tiny encoder: every stride kind at 16-32 channels.
PLAN = (("res", 16, 1, None), ("down", 16, 16, (1, 2, 2)), ("res", 16, 1, None), ("down", 16, 16, (2, 1, 1)),
        ("res", 16, 1, None), ("down", 16, 32, (2, 2, 2)), ("res", 32, 1, None), ("down", 32, 32, (2, 2, 2)),
        ("res", 32, 1, None))


@pytest.mark.parametrize("source", ["pixels_float", "pixels_uint8", "images", "images_jpeg", "videos"])
def test_prepare_data_matches_jax(source, tmp_path, monkeypatch):
    """The port's npz against scripts/prepare_data.py's on the same tiny
    encoder (the JAX script's placeholder encoder replaced by the same
    numpy weights): x0 at RTOL, positions and context exactly. The sources:
    pixel npz (float and uint8), PNG and JPEG stills, and --videos over a
    .y4m and an MJPEG .avi (12 frames asked, snapped to 9)."""
    import ltx2_tpu.models.video_vae as jvae
    from scripts import prepare_data as jprep

    ecfg, jecfg = (encoder.VideoEncoderConfig(plan=PLAN, latent_channels=16),
                   jencoder.VideoEncoderConfig(plan=PLAN, latent_channels=16))
    tree = random_tree(encoder.VideoEncoder(ecfg, device="meta"), seed=2)
    monkeypatch.setattr(jvae, "VideoEncoderConfig", lambda: jecfg)
    monkeypatch.setattr(jvae, "init_video_encoder", lambda key, cfg: _jtree(tree))
    rng = np.random.default_rng(1)
    if source.startswith("images"):
        (tmp_path / "img").mkdir()
        for i in range(2):
            pixels = rng.integers(0, 256, (70, 100, 3), dtype=np.uint8)
            if source == "images_jpeg":
                from PIL import Image

                Image.fromarray(pixels).save(str(tmp_path / "img" / f"{i}.jpg"), quality=90)
            else:
                write_png(str(tmp_path / "img" / f"{i}.png"), pixels)
        flags = ["--images", str(tmp_path / "img"), "--height", "64", "--width", "96"]
    elif source == "videos":
        from ltx2_tpu.utils import video_io as jvio

        (tmp_path / "vid").mkdir()
        jvio.write_y4m(str(tmp_path / "vid" / "a.y4m"), rng.integers(0, 256, (12, 70, 100, 3), dtype=np.uint8), 24.0)
        jvio.write_avi_mjpeg(str(tmp_path / "vid" / "b.avi"), rng.integers(0, 256, (5, 48, 64, 3), dtype=np.uint8),
                             24.0)  # 5 frames: the last repeated to 9
        flags = ["--videos", str(tmp_path / "vid"), "--num-frames", "12", "--height", "64", "--width", "96"]
    else:
        px = rng.integers(0, 256, (2, 3, 10, 64, 96), dtype=np.uint8)  # 10 frames: trimmed to 9
        np.savez(tmp_path / "px.npz", pixels=px if source == "pixels_uint8" else px.astype(np.float32) / 127.5 - 1)
        flags = ["--pixels", str(tmp_path / "px.npz")]
    flags += ["--context-dim", "8", "--fps", "25"]
    jprep.main(flags + ["--placeholder", "--output", str(tmp_path / "jax.npz")])
    from ltx2_tpu_torch.loader.from_numpy import video_encoder_from_numpy

    got = prepare_data.main(flags + ["--device", "cpu", "--output", str(tmp_path / "port.npz")],
                            encoder=video_encoder_from_numpy(tree, ecfg))
    ref, written = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(written.files) == sorted(ref.files) == ["context", "positions", "x0"]
    assert_close(written["x0"], ref["x0"], msg="x0")
    np.testing.assert_array_equal(written["positions"], ref["positions"])
    np.testing.assert_array_equal(written["context"], ref["context"])
    assert got["x0"].shape == ref["x0"].shape


def test_prepare_data_refusals(tmp_path):
    with pytest.raises(SystemExit):  # a directory without clips
        prepare_data.main(["--videos", str(tmp_path), "--context-dim", "8", "--device", "cpu"])
    (tmp_path / "anim.gif").write_bytes(b"GIF89a")
    with pytest.raises(NotImplementedError, match="GIF, APNG and WebP readers"):
        prepare_data.main(["--videos", str(tmp_path), "--context-dim", "8", "--device", "cpu"])
    with pytest.raises(SystemExit):
        prepare_data.main(["--context-dim", "8", "--device", "cpu"])


def test_train_entry_audio_on_cpu(tmp_path):
    """`train.main --audio --synthetic`: joint AV steps with every lora_B
    (the audio stream's too) non-zero after step 1 and the base bit for bit
    its draw; then `--data` with audio arrays, a `--val-data` file (which
    must carry the same audio arrays), and a video-only dataset, which
    freezes the audio branch."""
    zero_b = []

    def on_step(i, dit, loss):
        if i == 0:
            zero_b.extend(n for n, p in dit.named_parameters() if n.endswith("lora_B") and not p.abs().max() > 0)

    flags = ["--placeholder", "--device", "cpu", "--layers", "1", "--audio", "--lora-rank", "2"]
    # 2 latent frames: 2 audio tokens (over a single key dq and dk are exactly 0).
    res = train.main(flags + ["--synthetic", "2", "2", "2", "--steps", "2", "--val-fraction", "0.25"],
                     on_step=on_step)
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"])) and len(res["val_losses"]) == 1
    assert res["adapters"] == 28 and not zero_b
    fresh = dict(train.make_model(1, torch.device("cpu"), 0, placeholder=True, audio=True).named_parameters())
    assert all(torch.equal(p, fresh[n]) for n, p in res["model"].named_parameters() if n in fresh)

    arrays = train.synthetic_dataset(1, 2, 2, 3, res["model"].cfg, seed=1)
    assert arrays["audio_x0"].shape == (3, 1, 32) and arrays["audio_context"].shape == (3, 8, 64)
    np.savez(tmp_path / "av.npz", **arrays)
    np.savez(tmp_path / "val.npz", **{k: v[:1] for k, v in arrays.items()})
    np.savez(tmp_path / "val_video.npz", **{k: v[:1] for k, v in arrays.items() if not k.startswith("audio")})
    np.savez(tmp_path / "video.npz", **{k: v for k, v in arrays.items() if not k.startswith("audio")})
    np.savez(tmp_path / "no_pos.npz", **{k: v for k, v in arrays.items() if k != "audio_positions"})
    data = ["--data", str(tmp_path / "av.npz"), "--steps", "1"]
    res = train.main(flags + data + ["--val-data", str(tmp_path / "val.npz"), "--eval-every", "1"])
    assert len(res["val_losses"]) == 1 and np.isfinite(res["val_losses"][0])
    with pytest.raises(SystemExit):
        train.main(flags + data + ["--val-data", str(tmp_path / "val_video.npz")])
    with pytest.raises(SystemExit):
        train.main(flags + ["--data", str(tmp_path / "no_pos.npz"), "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(["--placeholder", "--device", "cpu", "--layers", "1", "--lora-rank", "2"] + data)
    res = train.main(flags + ["--data", str(tmp_path / "video.npz"), "--steps", "1", "--weight-decay", "0.1"])
    audio_re = re.compile(trainer.AUDIO_BRANCH_PATTERN)
    assert res["trainable"] and not any(audio_re.search(n) for n in res["trainable"])
