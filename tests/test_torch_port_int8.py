"""int8 W8A8 serving, on the CPU, against the JAX package:

- weight codes and scales (`quantize_tensor_int8`, its host twin
  `quantize_array_int8`, 2-D and stacked) bit for bit, and
  `quantize_params_int8` over a small audio-video DiT selecting and
  quantizing exactly what the JAX package's does;
- `linear` with a `weight_cscale` against `_w8a8_matmul`: bit for bit
  where the activation codes agree; the codes may differ by one only where
  x / xscale is within an fp32 rounding of a .5 tie, and each such code
  moves an output by at most 127 * xscale * cscale (one weight code), the
  bound held where they differ; a zero row and an outlier token;
- the 2-block V1 and AV forward, int8 against the JAX package's int8, and
  the text-K/V cache under int8 against its `_stacked_linear` route;
- quantizing at load equals quantizing after load (bitwise, and the JAX
  loader's codes); the ledger with and without LoRAs; every guard;
- the JAX CLI's aliases and compatibility flags parse to the JAX parser's
  settings.

Forward tolerance: RTOL (1e-4 of max|x0|), the fp32 tests' own. Both
packages quantize every matmul's activations to 127 levels per token, so
an fp32 difference of summation order upstream (1e-6 relative) could flip an
activation code where x / xscale lies that close to a .5 boundary, each
flip moving its output by one weight code times xscale; on these inputs no
code flips and the forwards agree to 2.5e-7 of max|x0|.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import int8 as jint8
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.loader import weight_loader as jwl
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.ops import common as jcommon
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.generate import make_dit
from ltx2_tpu_torch.loader import int8, lora, weight_loader
from ltx2_tpu_torch.loader.fp8 import quantize_params_fp8
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.ops.common import Linear, int8_matmul, linear, quantize_activations_int8, w8a8_matmul
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import (
    CFG, JCFG, RTOL, assert_bitwise, assert_close, assert_module_matches_tree, jax_leaves, one_intra_op_thread,
    port_leaves, stacked_dit_tree, t,
)

FWD_RTOL = RTOL
AV = dict(model_type=model.LTXModelType.AudioVideo, num_attention_heads=2, attention_head_dim=32, in_channels=16,
          out_channels=16, num_layers=2, cross_attention_dim=64, compute_dtype="float32", audio_heads=2,
          audio_head_dim=16, audio_in_channels=16, audio_out_channels=16, caption_channels=24)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_weight_codes_bitwise(scale):
    """Device twin, host twin, 2-D and stacked: the JAX package's codes and
    scales bit for bit, the host and device twins equal (a zero row gets
    the 1e-12 floor and zero codes)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 96)) * scale).astype(np.float32)
    w[0, 0] = 0.0
    w[1, 1, :3] = [0.5, -0.5, 1.5]  # exact ratios after scaling by the row's own amax
    jq, js = jint8.quantize_tensor_int8(jnp.asarray(w))
    jhq, jhs = jint8.quantize_array_int8(w)
    q, s = int8.quantize_tensor_int8(torch.from_numpy(w))
    hq, hs = int8.quantize_array_int8(w)
    for got in ((q, s), (torch.from_numpy(hq), torch.from_numpy(hs))):
        assert_bitwise(got[0], jq, "stacked codes")
        assert_bitwise(got[1], js, "stacked scales")
    assert_bitwise(torch.from_numpy(hq), jhq, "host codes")
    for i in range(3):
        q2, s2 = int8.quantize_tensor_int8(torch.from_numpy(w[i]))
        jq2, js2 = jint8.quantize_tensor_int8(jnp.asarray(w[i]))
        assert_bitwise(q2, jq2, f"codes {i}")
        assert_bitwise(s2, js2, f"scales {i}")
        assert_bitwise(q2, np.asarray(jq)[i], f"codes {i} as a slice of the stacked ones")
    assert float(s[0, 0]) == np.float32(1e-12) and not q[0, 0].any()


@pytest.fixture(scope="module")
def av_tree():
    cfg = model.LTXModelConfig(**AV)
    return cfg, stacked_dit_tree(cfg, seed=21)


def test_eligibility_and_quantize_params_match_jax(av_tree):
    """Over every leaf of a small AV DiT: the predicate selects what the JAX
    predicate selects, and the quantized trees agree bit for bit."""
    cfg, tree = av_tree
    port = dit_from_numpy(tree, cfg)
    for name, _ in port.named_parameters():
        jname = ".".join(p for p in name.split(".") if not p.isdigit())
        assert int8.int8_eligible(name) == jint8.int8_eligible(jname), name
    jq = jint8.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    int8.quantize_params_int8(port)
    assert_module_matches_tree(port, jq)
    blk = port.transformer_blocks[0]
    assert blk.attn1.to_q.weight.dtype == torch.int8 and blk.audio_ff.project_in.proj.weight.dtype == torch.int8
    assert blk.attn1.q_norm.weight.dtype == torch.float32 and port.adaln_single.linear.weight.dtype == torch.float32
    assert port.proj_out.weight.dtype == torch.float32  # not a target
    with pytest.raises(ValueError, match="already quantized"):
        int8.quantize_params_int8(port)


def _w8a8_pair(rng, x_shape, out_f=48, dtype="float32"):
    w = rng.standard_normal((out_f, x_shape[-1])).astype(np.float32) * 0.1
    b = rng.standard_normal(out_f).astype(np.float32) * 0.1
    jq, js = jint8.quantize_tensor_int8(jnp.asarray(w))
    lin = Linear(x_shape[-1], out_f)
    with torch.no_grad():
        lin.bias.copy_(torch.from_numpy(b))
    int8.set_int8_weight_(lin, torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(js)))
    return lin, {"weight": jq, "weight_cscale": js, "bias": jnp.asarray(b)}


def _tie_bound(x: np.ndarray, lin: Linear, dtype) -> np.ndarray:
    """Per output: 127 * xscale * cscale times the number of activation codes
    that may round either way (x / xscale within 2 ulps of a .5 tie)."""
    xt = torch.from_numpy(x).to(dtype)
    xf = xt.float().numpy()
    _, xscale = quantize_activations_int8(xt)
    ratio = xf / xscale.numpy()
    near = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) <= 2 * np.spacing(np.abs(ratio).astype(np.float32))
    return near.sum(-1, keepdims=True) * 127.0 * xscale.numpy() * lin.weight_cscale.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_w8a8_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 96)).astype(np.float32)
    x[0, 3] = 0.0  # a zero row: xscale at its floor, codes 0, the output the bias
    x[1, 5] *= 1e3  # an outlier token scales its own codes only
    lin, p = _w8a8_pair(rng, x.shape)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    out = linear(lin, torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    # The product without the bias bit for bit (the jitted bias add may fuse
    # into an FMA); with it within an ulp of the output's dtype.
    ref = np.asarray(jax.jit(jcommon._w8a8_matmul)(jnp.asarray(x).astype(jdt), p["weight"], p["weight_cscale"])
                     .astype(jnp.float32))
    got = w8a8_matmul(torch.from_numpy(x).to(tdt), lin.weight, lin.weight_cscale).float().numpy()
    full = np.asarray(jax.jit(jcommon.linear)(p, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    eps = np.finfo(np.float32).eps if dtype == "float32" else 2.0 ** -8
    addends = np.abs(got) + np.abs(lin.bias.to(tdt).float().numpy())
    assert (np.abs(out.float().numpy() - full) <= eps * addends + _tie_bound(x, lin, tdt) + 1e-30).all()
    jx = jnp.asarray(x).astype(jdt).astype(jnp.float32)
    jxs = jnp.maximum(jnp.max(jnp.abs(jx), axis=-1, keepdims=True), 1e-8) * (1.0 / 127.0)
    jcodes = np.asarray(jax.jit(lambda a, s: jnp.round(a / s))(jx, jxs))
    codes, _ = quantize_activations_int8(torch.from_numpy(x).to(tdt))
    same = (codes.numpy() == jcodes).all(-1)
    assert np.abs(codes.numpy() - jcodes).max() <= 1
    assert np.array_equal(got[same], ref[same]), "rows with the same codes: bit for bit"
    assert (np.abs(got - ref) <= _tie_bound(x, lin, tdt) + 1e-30).all()
    np.testing.assert_array_equal(out[0, 3].float().numpy(), lin.bias.to(tdt).float().numpy())
    # The outlier moved only its own token: every other row is the one of x without it.
    x2 = x.copy()
    x2[1, 5] /= 1e3
    again = linear(lin, torch.from_numpy(x2).to(tdt)).float().numpy()
    rows = np.ones(37, bool)
    rows[5] = False
    np.testing.assert_array_equal(again[1, rows], out.float().numpy()[1, rows])


def test_int8_product_plain_is_exact():
    """The plain version's int32 product equals an int64 product, also at
    the extreme codes and the DiT's widest contraction (16384)."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (20, 16384), dtype=np.int8)
    b = rng.integers(-127, 128, (24, 16384), dtype=np.int8)
    a[0], b[0] = 127, 127
    a[1], b[1] = -127, 127
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64).T
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    x = torch.randn(3, 17, 32)
    w_q, cs = int8.quantize_tensor_int8(torch.randn(16, 32))
    y = w8a8_matmul(x, w_q, cs)
    xq, xs = quantize_activations_int8(x)
    ref = (xq.long() @ w_q.long().T).float() * xs * cs
    assert torch.equal(y, ref)


@pytest.mark.parametrize("version", ["v1", "av"])
def test_int8_forward_matches_jax(version, av_tree):
    if version == "v1":
        cfg, jcfg = CFG, JCFG
        tree = stacked_dit_tree(cfg, seed=22)
    else:
        cfg, tree = av_tree
        jcfg = jmodel.LTXModelConfig(remat=False, **{**AV, "model_type": jmodel.LTXModelType.AudioVideo})
    jq = jint8.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    port = int8.quantize_params_int8(dit_from_numpy(tree, cfg))
    rng = np.random.default_rng(3)

    def modality(pkg, tokens, channels, width, positions):
        latent = rng.standard_normal((1, tokens, channels)).astype(np.float32)
        context = rng.standard_normal((1, 6, width)).astype(np.float32) * 0.5
        ts = np.full((1,), 0.7, np.float32)
        return [(pkg.Modality(latent=jnp.asarray(latent), context=jnp.asarray(context), context_mask=None,
                              timesteps=jnp.asarray(ts), positions=jnp.asarray(positions), sigma=jnp.asarray(ts)),
                 model.Modality(latent=t(latent), context=t(context), context_mask=None, timesteps=t(ts),
                                positions=t(positions), sigma=t(ts)))]

    vpos = np.stack(np.meshgrid(np.arange(2.0), np.arange(4.0), np.arange(4.0), indexing="ij"), 0).reshape(3, -1)
    vpos = np.stack([vpos, vpos + 1], -1)[None].astype(np.float32)
    (jv, pv), = modality(jmodel, 32, cfg.in_channels, cfg.caption_channels or cfg.cross_attention_dim, vpos)
    if version == "v1":
        assert_close(model.x0_model_apply(port, pv), jmodel.x0_model_apply(jq, jcfg, video=jv), FWD_RTOL, "v1 x0")
        return
    apos = np.stack([np.arange(20.0), np.arange(1.0, 21.0)], -1)[None, None].astype(np.float32) * 0.04
    (ja, pa), = modality(jmodel, 20, 16, 24, apos)
    ref_v, ref_a = jmodel.x0_model_apply(jq, jcfg, video=jv, audio=ja)
    out_v, out_a = model.x0_model_apply(port, pv, audio=pa)
    assert_close(out_v, ref_v, FWD_RTOL, "av video x0")
    assert_close(out_a, ref_a, FWD_RTOL, "av audio x0")


def test_text_kv_cache_under_int8_matches_jax():
    """The cached K/V dequantize each int8 weight per out-channel in fp32
    (the JAX package's `_stacked_linear`), not the W8A8 route."""
    tree = stacked_dit_tree(CFG, seed=23)
    jq = jint8.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    port = int8.quantize_params_int8(dit_from_numpy(tree, CFG))
    ctx = np.random.default_rng(4).standard_normal((2, 6, 256)).astype(np.float32)
    jkv = jmodel.precompute_text_kv(jq, JCFG, video_context=jnp.asarray(ctx))
    kv = model.precompute_text_kv(port, t(ctx))
    for i in range(2):
        assert_close(kv["video"][i], jkv["video"][i], msg="int8 text kv")
    ref = jmodel._stacked_linear(jq["transformer_blocks"]["attn2"]["to_v"], jnp.asarray(ctx))
    got = model._stacked_linear([b.attn2.to_v for b in port.transformer_blocks], t(ctx))
    assert_close(got, ref, rtol=1e-5, msg="_stacked_linear")
    w8a8 = linear(port.transformer_blocks[0].attn2.to_v, t(ctx))
    assert (got[0] - w8a8).abs().max() > 0  # a different route from the step's W8A8 product


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 2-block DiT checkpoint in bf16, written by the port's exporter."""
    import json

    from ltx2_tpu_torch.loader.export import export_transformer_checkpoint

    path = str(tmp_path_factory.mktemp("int8") / "dit.safetensors")
    export_transformer_checkpoint(path, dit_from_numpy(stacked_dit_tree(CFG, seed=24), CFG), dtype=torch.bfloat16,
                                  metadata={"config": json.dumps({"transformer": {"num_attention_heads": 2}})})
    return path


def test_quantize_at_load_equals_after_load_and_jax(ckpt):
    at_load = weight_loader.load_transformer_params(ckpt, CFG, device="cpu", quantize_int8=True)
    after = int8.quantize_params_int8(weight_loader.load_transformer_params(ckpt, CFG, device="cpu"))
    got, want = port_leaves(at_load), port_leaves(after)
    assert list(got) == list(want)
    for name in want:
        assert_bitwise(got[name], want[name], name)
    assert at_load.transformer_blocks[1].ff.project_out.weight.dtype == torch.int8
    jtree = jwl.load_transformer_params(ckpt, quantize_int8=True)
    ref = jax_leaves(jtree)
    for name in ("transformer_blocks.1.attn1.to_q.weight", "transformer_blocks.1.attn1.to_q.weight_cscale",
                 "transformer_blocks.0.ff.project_in.proj.weight"):
        assert_bitwise(got[name], ref[name], name)
    with pytest.raises(ValueError, match="mutually exclusive"):
        weight_loader.load_transformer_params(ckpt, CFG, device="cpu", keep_fp8=True, quantize_int8=True)


def test_ledger_int8_with_and_without_loras(ckpt, tmp_path):
    ledger = ModelLedger(ckpt, device="cpu", int8=True)
    dit = ledger.transformer()
    assert dit.transformer_blocks[0].attn1.to_k.weight.dtype == torch.int8
    rng = np.random.default_rng(5)
    a = rng.standard_normal((4, 256)).astype(np.float32) * 0.1
    path = str(tmp_path / "lora.safetensors")
    jst.write_safetensors(path, {
        "diffusion_model.transformer_blocks.0.attn1.to_q.lora_A.weight": a,
        "diffusion_model.transformer_blocks.0.attn1.to_q.lora_B.weight": rng.standard_normal((256, 4)).astype(
            np.float32) * 0.1})
    view = ledger.with_loras([lora.LoRAConfig(path, 0.5)])
    assert view.int8 and view.temporal_upscaler_path == ledger.temporal_upscaler_path
    fused = view.transformer()  # fused in full precision, then quantized
    plain = ModelLedger(ckpt, device="cpu", loras=[lora.LoRAConfig(path, 0.5)]).transformer()
    want = int8.quantize_params_int8(plain)
    for name, leaf in port_leaves(want).items():
        assert_bitwise(port_leaves(fused)[name], leaf, name)
    assert not torch.equal(fused.transformer_blocks[0].attn1.to_q.weight, dit.transformer_blocks[0].attn1.to_q.weight)
    with pytest.raises(ValueError, match="int8"):  # the deep guard: no fuse into int8 weights
        lora.fuse_lora_into_params(dit, [lora.LoRAConfig(path, 0.5)])


def test_guards():
    fp8_dit = quantize_params_fp8(make_dit(1, torch.device("cpu"), base=dataclasses.replace(CFG, num_layers=1)))
    with pytest.raises(ValueError, match="already quantized"):
        int8.quantize_params_int8(fp8_dit)
    with pytest.raises(ValueError, match="fp8-kept"):
        jint8.quantize_params_int8({"weight": jnp.zeros((2, 2)), "weight_scale": jnp.ones(())})
    with pytest.raises(ValueError, match="exclusive"):
        make_dit(1, torch.device("cpu"), base=CFG, fp8=True, int8=True)
    base = ["--device", "cpu", "--output", "x.y4m"]
    for argv, match in ((["--int8", "--fp8", "--checkpoint", "c"], "mutually exclusive"),
                        (["--int8", "--fp8-serving", "--checkpoint", "c"], "mutually exclusive"),
                        (["--int8", "--pipeline", "two-stage", "--distilled-lora", "l"], "incompatible"),
                        (["--int8", "--pipeline", "ti2vid-hq", "--distilled-lora", "l"], "incompatible")):
        with pytest.raises(SystemExit):
            generate.main(base + argv)
        from scripts.generate import _apply_reference_compat, build_parser

        with pytest.raises(SystemExit, match=match):
            _apply_reference_compat(build_parser().parse_args(argv))


def test_int8_dit_drawn_block_by_block_is_the_model_quantized():
    base = dataclasses.replace(CFG, compute_dtype="bfloat16", caption_channels=64)
    built = make_dit(2, torch.device("cpu"), seed=3, base=base, int8=True)
    ref = int8.quantize_params_int8(make_dit(2, torch.device("cpu"), seed=3, base=base))
    for name, leaf in port_leaves(ref).items():
        assert_bitwise(port_leaves(built)[name], leaf, name)


def _port_args(monkeypatch, argv):
    """The settings `generate.main` parses from argv (the flow not run)."""
    seen = {}

    def run(args, seeds, common, encode, cfg_flow, two_stage, ledger=None):
        seen.update(args=args, common=common, encode=encode)
        return [], []

    monkeypatch.setattr(generate, "_run_flow", run)
    generate.main(argv)
    return seen


def test_jax_cli_names_parse_to_the_jax_settings(monkeypatch, tmp_path):
    """A JAX command line with every new alias and compatibility flag, in
    both parsers: the same settings."""
    from scripts.generate import _apply_reference_compat, build_parser
    from scripts.generate import parse_loras as jparse_loras
    from scripts.generate import tiling_config as jtiling_config

    monkeypatch.chdir(tmp_path)
    argv = ["--pipeline", "one-stage", "--cfg", "4.5", "--guidance-rescale", "0.3", "--weights", "ckpt.safetensors",
            "--gemma-path", "gemma", "--no-gemma", "--spatial-upscaler-weights", "up.safetensors", "--upscale-spatial",
            "--temporal-upscaler-weights", "tu.safetensors", "--upscale-temporal", "--fp32", "--fp16",
            "--low-memory", "--fast-mode", "--lora", "a.safetensors", "--lora", "b.safetensors:0.25",
            "--lora-strength", "0.7", "--tiled-vae", "--model-variant", "dev", "--int8",
            "--profile-dir", str(tmp_path / "prof"), "--compile-cache", "cache", "--output", "x.y4m"]
    jargs = _apply_reference_compat(build_parser().parse_args(argv))
    seen = _port_args(monkeypatch, argv + ["--device", "cpu"])
    args = seen["args"]
    for dest in ("cfg_scale", "rescale_scale", "checkpoint", "gemma_dir", "spatial_upscaler", "temporal_upscaler",
                 "dtype", "fp8_serving", "int8", "upscale_spatial", "upscale_temporal", "no_gemma", "model_variant"):
        assert getattr(args, dest) == getattr(jargs, dest), dest
    assert not seen["encode"]  # --no-gemma: dummy contexts, as the JAX CLI
    assert [(c.path, c.strength) for c in map(lambda s: generate.parse_lora_spec(s, args.lora_strength), args.lora)] \
        == [(c.path, c.strength) for c in jparse_loras(jargs)]
    assert dataclasses.asdict(generate.tiling_config(args)) == dataclasses.asdict(jtiling_config(jargs))
    assert os.path.exists(tmp_path / "prof" / "trace.json")

    # --fp8 is --fp8-serving; --placeholder drops the checkpoint; the
    # reference checkpoint of --model-variant when it exists.
    seen = _port_args(monkeypatch, ["--pipeline", "distilled", "--fp8", "--weights", "c", "--output", "x.y4m"])
    assert seen["args"].fp8_serving and _apply_reference_compat(build_parser().parse_args(["--fp8"])).fp8_serving
    seen = _port_args(monkeypatch, ["--pipeline", "distilled", "--placeholder", "--weights", "c", "--output", "x.y4m"])
    assert seen["args"].checkpoint is None and not seen["encode"]
    os.makedirs("weights/ltx-2")
    open("weights/ltx-2/ltx-2-19b-dev.safetensors", "wb").close()
    argv = ["--pipeline", "distilled", "--model-variant", "dev", "--output", "x.y4m"]
    assert _port_args(monkeypatch, argv)["args"].checkpoint == \
        _apply_reference_compat(build_parser().parse_args(argv)).checkpoint == "weights/ltx-2/ltx-2-19b-dev.safetensors"
    # --temporal-upscaler alone: ignored with a warning; --upscale-temporal with a
    # checkpoint defaults to the reference file, as in the JAX CLI.
    argv = ["--pipeline", "one-stage", "--weights", "c", "--temporal-upscaler", "tu", "--output", "x.y4m"]
    assert _port_args(monkeypatch, argv)["args"].temporal_upscaler is None
    argv = ["--pipeline", "one-stage", "--weights", "c", "--upscale-temporal", "--output", "x.y4m"]
    assert _port_args(monkeypatch, argv)["args"].temporal_upscaler == \
        _apply_reference_compat(build_parser().parse_args(argv)).temporal_upscaler
    with pytest.raises(SystemExit):  # a loop flag of the CFG flows, as --upscale-spatial
        generate.main(["--pipeline", "distilled", "--upscale-temporal", "--output", "x.y4m"])
