"""The port's checkpoint layer against the JAX package's, on the CPU:
safetensors in both directions, the host conversions, the DiT loader (f32,
bf16 and kept fp8, leaf by leaf and bit for bit, then x0), the export and
its refusals, LoRA fusion and export, the registry.

Files are written by the JAX package's own writers (`write_safetensors`,
`params_to_checkpoint`, `export_transformer_checkpoint`,
`export_lora_checkpoint`) from the small parity DiT of
tests/torch_port_util.py, and the port's files are read back by the JAX
package's readers. Limits: bit for bit where both sides do the same
arithmetic; x0 at 1e-5 of max|x0| in f32 and 1e-2 in bf16 with fp8 weights;
LoRA fusion at one fp32 (or bf16) rounding, as the port forms B @ A in
float64 and the JAX package in fp32.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import fp8 as jfp8
from ltx2_tpu.loader import lora as jlora
from ltx2_tpu.loader import native as jnative
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.loader import weight_loader as jwl
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.training import lora as jtlora
from ltx2_tpu_torch.loader import convert, export, lora, registry, safetensors_io, weight_loader
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.training.lora import add_lora_params_, export_lora_checkpoint
from tests.torch_port_util import (
    CFG, JCFG, assert_bitwise, assert_close, assert_module_matches_tree, bits, jax_leaves, numpy_tree, port_leaves, t,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

JCFG_CAP = dataclasses.replace(JCFG, caption_channels=64)
CFG_CAP = dataclasses.replace(CFG, caption_channels=64, remat=False)
METADATA = {"model_version": "2.0.0", "config": json.dumps({"transformer": {"num_attention_heads": 2}})}
SKIP = ("norm", "scale_shift_table", "adaln", "embed")


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG_CAP), seed=3)


def fp8_checkpoint(tree):
    """The reference `-fp8` layout, by the JAX package's quantizer: each
    eligible weight as E4M3 codes with a 0-d F32 scale."""
    ckpt = jexport.params_to_checkpoint(tree)
    for key in list(ckpt):
        arr = ckpt[key]
        if key.endswith(".weight") and arr.ndim >= 2 and not any(m in key for m in SKIP):
            q, scale = jfp8.quantize_tensor_fp8(jnp.asarray(arr))
            ckpt[key] = np.asarray(q)
            ckpt[key[: -len(".weight")] + ".weight_scale"] = np.asarray(scale, np.float32).reshape(())
    return ckpt


@pytest.fixture(scope="module")
def files(tree, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    paths = {"f32": str(d / "dit.safetensors"), "fp8": str(d / "dit-fp8.safetensors")}
    jst.write_safetensors(paths["f32"], jexport.params_to_checkpoint(tree), metadata=METADATA)
    jst.write_safetensors(paths["fp8"], fp8_checkpoint(tree), metadata=METADATA)
    return paths


# ---- safetensors -----------------------------------------------------------

ALL_DTYPES = [np.float64, np.float32, np.float16, ml_dtypes.bfloat16, ml_dtypes.float8_e4m3fn,
              ml_dtypes.float8_e5m2, np.int64, np.int32, np.int16, np.int8, np.uint8, np.bool_, np.uint16,
              np.uint32, np.uint64]


def _arrays(rng):
    out = {}
    for i, dt in enumerate(ALL_DTYPES):
        raw = rng.integers(0, 256, size=(3, 5) if i % 2 else (7,), dtype=np.uint8)
        itemsize = np.dtype(dt).itemsize
        raw = rng.integers(0, 256, size=raw.size * itemsize, dtype=np.uint8)
        arr = raw.view(dt).reshape((3, 5) if i % 2 else (7,))
        if dt is np.bool_:
            arr = raw.astype(bool).reshape(arr.shape)
        out[f"t.{np.dtype(dt).name}"] = arr
    out["scalar"] = np.asarray(np.float32(1.5))  # a 0-d tensor stays 0-d
    out["tail"] = np.arange(3, dtype=np.uint8)  # puts what follows it off its alignment
    out["misaligned"] = rng.standard_normal(5).astype(np.float32)
    return out


def test_safetensors_port_reads_jax_file(tmp_path):
    arrays = _arrays(np.random.default_rng(0))
    path = str(tmp_path / "a.safetensors")
    jst.write_safetensors(path, arrays, metadata={"model_version": "2.0.0", "k": "v"})
    f = safetensors_io.SafetensorsFile(path)
    assert f.metadata == {"model_version": "2.0.0", "k": "v"} == safetensors_io.read_metadata(path)
    assert list(f.keys()) == list(arrays)
    for key, arr in arrays.items():
        assert_bitwise(f.get(key), arr, key)
        assert f.info(key) == jst.SafetensorsFile(path).info(key)
    offset = f._data_start + f._entries["misaligned"]["data_offsets"][0]
    assert offset % 4 and f.get("misaligned").shape == (5,)
    assert f.get("scalar").dim() == 0


def test_safetensors_jax_reads_port_file(tmp_path):
    arrays = _arrays(np.random.default_rng(1))
    tensors = {}
    for key, arr in arrays.items():
        raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy())
        dtype = safetensors_io.DTYPES[jst._DTYPE_NAMES[np.dtype(arr.dtype)]]
        tensors[key] = raw.view(dtype).reshape(arr.shape)
    path = str(tmp_path / "b.safetensors")
    safetensors_io.write_safetensors(path, tensors, metadata={"a": "1"})
    f = jst.SafetensorsFile(path)
    assert f.metadata == {"a": "1"}
    for key, arr in arrays.items():
        assert_bitwise(f.get(key), arr, key)


def test_safetensors_streaming_writer_checks_its_producers(tmp_path):
    spec = ("x", torch.float32, (2,), lambda: torch.zeros(3))
    with pytest.raises(ValueError, match="declared"):
        safetensors_io.write_safetensors_streaming(str(tmp_path / "c.safetensors"), [spec])


# ---- host conversions --------------------------------------------------------

def _specials():
    words = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FA12345, 0x7F800000, 0xFF800000, 0,
                      0x80000000, 0x00000001, 0x807FFFFF, 0x7F7FFFFF, 0x3F808000, 0x3F818000], np.uint32)
    rng = np.random.default_rng(2)
    normal = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    return np.concatenate([words.view(np.float32), normal])


@pytest.mark.parametrize("which", ["bf16_to_f32", "f32_to_bf16", "fp8_to_f32", "fp8_to_bf16"])
def test_conversions_match_native_bitwise(which):
    assert jnative.native_available()
    if which == "bf16_to_f32":
        words = np.arange(1 << 16, dtype=np.uint16)
        got = convert.bf16_to_f32(torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16))
        ref = jnative.bf16_to_f32(words.view(ml_dtypes.bfloat16))
    elif which == "f32_to_bf16":
        x = _specials()
        got, ref = convert.f32_to_bf16(torch.from_numpy(x)), jnative.f32_to_bf16(x)
    else:
        codes = np.arange(256, dtype=np.uint8)
        target = "float32" if which == "fp8_to_f32" else "bfloat16"
        got = convert.fp8_e4m3_dequant(torch.from_numpy(codes).view(torch.float8_e4m3fn), 0.37,
                                       getattr(torch, target))
        ref = jnative.fp8_e4m3_dequant(codes.view(ml_dtypes.float8_e4m3fn), 0.37, target=target)
        nan = np.isnan(np.asarray(ref, np.float32))
        assert torch.isnan(got.float()).numpy().tolist() == nan.tolist()
        got, ref = got[torch.from_numpy(~nan)], np.asarray(ref)[~nan]
    assert_bitwise(got, ref, which)


# ---- DiT loader ---------------------------------------------------------------

def test_key_rules_and_metadata(files, tmp_path):
    for key in ("transformer_blocks.0.attn1.to_out.0.weight", "transformer_blocks.3.ff.net.0.proj.bias",
                "transformer_blocks.3.ff.net.2.weight", "audio_patchify_proj.weight", "av_ca_x.weight",
                "video_embeddings_connector.transformer_1d_blocks.0.attn1.to_q.weight", "proj_out.weight"):
        assert weight_loader.convert_checkpoint_key(key) == jwl.convert_checkpoint_key(key), key
    for path in files.values():
        assert weight_loader.detect_model_version(path) == jwl.detect_model_version(path) == "2.0.0"
        assert weight_loader.read_checkpoint_config(path) == jwl.read_checkpoint_config(path)
        assert weight_loader.is_fp8_checkpoint(path) == jwl.is_fp8_checkpoint(path)
        assert not weight_loader.is_v2_model(path)
    assert weight_loader.is_fp8_checkpoint(files["fp8"]) and not weight_loader.is_fp8_checkpoint(files["f32"])
    cfg = weight_loader.transformer_config_from_checkpoint(files["f32"], "float32")
    assert cfg == dataclasses.replace(CFG_CAP, remat=False)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "fp8"])
def test_load_transformer_params_matches_jax(files, mode):
    """Leaf by leaf, bit for bit, against JAX's tree; then x0."""
    target = "bfloat16" if mode == "fp8" else mode
    keep = mode == "fp8"
    path = files["fp8"] if keep else files["f32"]
    jtree = jwl.load_transformer_params(path, target_dtype=target, keep_fp8=keep)
    port = weight_loader.load_transformer_params(path, target_dtype=target, keep_fp8=keep, device="cpu")
    assert_module_matches_tree(port, jtree)
    if keep:
        assert port.transformer_blocks[1].ff.project_out.weight.dtype == torch.float8_e4m3fn
        assert port.adaln_single.linear.weight.dtype == torch.float32

    rng = np.random.default_rng(4)
    from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
    from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
    from ltx2_tpu.types import VideoLatentShape as JShape

    positions = np.asarray(JTools(JPatchifier(1), JShape(1, 16, 2, 2, 3), fps=24.0).create_initial_state().positions)
    latent = rng.standard_normal((1, 12, 16)).astype(np.float32)
    context = rng.standard_normal((1, 8, 64)).astype(np.float32)
    ts = np.array([0.6], np.float32)
    jm = jmodel.Modality(latent=jnp.asarray(latent), context=jnp.asarray(context), context_mask=None,
                         timesteps=jnp.asarray(ts), positions=jnp.asarray(positions))
    pm = model.Modality(latent=t(latent), context=t(context), context_mask=None, timesteps=t(ts),
                        positions=t(positions))
    ref = jmodel.x0_model_apply(jtree, dataclasses.replace(JCFG_CAP, compute_dtype=target), video=jm)
    out = model.x0_model_apply(port, pm).float()
    assert torch.isfinite(out).all()
    assert_close(out, jnp.asarray(ref, jnp.float32), rtol=1e-5 if mode == "float32" else 1e-2, msg=f"x0 {mode}")


def test_loader_refusals(files, tmp_path):
    v2 = str(tmp_path / "v2.safetensors")
    jst.write_safetensors(v2, {"model.diffusion_model.proj_out.weight": np.zeros((2, 2), np.float32)},
                          metadata={"model_version": "2.3.0"})
    with pytest.raises(KeyError):  # V2 is read now: this file lacks the DiT's tensors
        weight_loader.load_transformer_params(v2, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):  # as the JAX loader (weight_loader.py:147)
        weight_loader.load_transformer_params(files["f32"], keep_fp8=True, quantize_int8=True, device="cpu")
    with pytest.raises(ValueError, match="no audio stream"):  # a video-only file
        weight_loader.load_transformer_params(files["f32"], include_audio=True, device="cpu")
    f = jst.SafetensorsFile(files["fp8"])
    ckpt = {k: np.asarray(f.get(k)) for k in f.keys()}
    key = "model.diffusion_model.transformer_blocks.0.attn1.to_q.weight_scale"
    ckpt[key] = np.ones(4, np.float32)
    multi = str(tmp_path / "multi.safetensors")
    jst.write_safetensors(multi, ckpt, metadata=METADATA)
    with pytest.raises(ValueError, match="per-tensor"):
        weight_loader.load_transformer_params(multi, device="cpu")
    del ckpt[key], ckpt["model.diffusion_model.transformer_blocks.0.attn1.to_q.weight"]
    missing = str(tmp_path / "missing.safetensors")
    jst.write_safetensors(missing, ckpt, metadata=METADATA)
    with pytest.raises(ValueError, match="missing 1 DiT"):
        weight_loader.load_transformer_params(missing, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            weight_loader.load_transformer_params(files["f32"])  # the card unless the caller names the CPU


# ---- export -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_export_read_back_by_jax(tree, tmp_path, dtype):
    port = dit_from_numpy(tree, CFG_CAP)
    path_p, path_j = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    export.export_transformer_checkpoint(path_p, port, metadata=METADATA, dtype=getattr(torch, dtype))
    jexport.export_transformer_checkpoint(path_j, tree, metadata=METADATA,
                                          dtype=np.float32 if dtype == "float32" else ml_dtypes.bfloat16)
    fp, fj = jst.SafetensorsFile(path_p), jst.SafetensorsFile(path_j)
    assert set(fp.keys()) == set(fj.keys()) and fp.metadata == fj.metadata
    for key in fj.keys():
        assert_bitwise(fp.get(key), fj.get(key), key)
    if dtype == "float32":
        assert_module_matches_tree(port, jwl.load_transformer_params(path_p, target_dtype="float32"))
    assert set(export.params_to_checkpoint(port)) == set(jexport.params_to_checkpoint(tree))


def test_export_carry_from_and_refusal(tree, files, tmp_path):
    f = jst.SafetensorsFile(files["fp8"])
    src = {k: np.asarray(f.get(k)) for k in f.keys()}
    src["vae.decoder.conv_in.conv.weight"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    src["model.diffusion_model.video_embeddings_connector.transformer_1d_blocks.0.attn1.to_q.weight_scale"] = (
        np.float32(0.25))
    source = str(tmp_path / "source.safetensors")
    jst.write_safetensors(source, src, metadata=METADATA)
    port = dit_from_numpy(tree, CFG_CAP)
    path_p, path_j = str(tmp_path / "p.safetensors"), str(tmp_path / "j.safetensors")
    export.export_transformer_checkpoint(path_p, port, carry_from=source)
    jexport.export_transformer_checkpoint(path_j, tree, carry_from=source)
    fp, fj = jst.SafetensorsFile(path_p), jst.SafetensorsFile(path_j)
    assert set(fp.keys()) == set(fj.keys())
    assert "model.diffusion_model.transformer_blocks.0.attn1.to_q.weight_scale" not in set(fp.keys())
    assert "vae.decoder.conv_in.conv.weight" in set(fp.keys())
    for key in fj.keys():
        assert_bitwise(fp.get(key), fj.get(key), key)
    kept = weight_loader.load_transformer_params(files["fp8"], keep_fp8=True, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        export.export_transformer_checkpoint(str(tmp_path / "x.safetensors"), kept)


def test_fp8_checkpoint_specs_read_back_by_jax(files, tmp_path):
    """A kept-fp8 model written in the reference `-fp8` layout reloads in
    JAX (keep_fp8) leaf for leaf."""
    kept = weight_loader.load_transformer_params(files["fp8"], keep_fp8=True, device="cpu")
    path = str(tmp_path / "fp8-out.safetensors")
    safetensors_io.write_safetensors_streaming(path, export.iter_fp8_checkpoint_specs(kept), metadata=METADATA)
    assert_module_matches_tree(kept, jwl.load_transformer_params(path, keep_fp8=True))


# ---- LoRA ---------------------------------------------------------------------

def _lora_file(path, rng, rank=4, prefix="diffusion_model."):
    w = {}
    for base, (out_f, in_f) in {"transformer_blocks.0.attn1.to_q": (256, 256),
                                "transformer_blocks.1.ff.net.0.proj": (1024, 256),
                                "transformer_blocks.1.attn2.to_k": (256, 256),
                                "proj_out": (16, 256)}.items():
        w[f"{prefix}{base}.lora_A.weight"] = rng.standard_normal((rank, in_f)).astype(np.float32) * 0.1
        w[f"{prefix}{base}.lora_B.weight"] = rng.standard_normal((out_f, rank)).astype(np.float32) * 0.1
    # An alias of one weight without the prefix, and the down/up naming.
    w["transformer_blocks.1.ff.net.0.proj.lora_A.weight"] = rng.standard_normal((rank, 256)).astype(np.float32)
    w["transformer_blocks.1.ff.net.0.proj.lora_B.weight"] = rng.standard_normal((1024, rank)).astype(np.float32)
    w[f"{prefix}transformer_blocks.0.attn2.to_v.lora_down.weight"] = rng.standard_normal((rank, 256)).astype(np.float32)
    w[f"{prefix}transformer_blocks.0.attn2.to_v.lora_up.weight"] = rng.standard_normal((256, rank)).astype(np.float32)
    jst.write_safetensors(path, w)
    return path


ALIASED = "transformer_blocks.1.ff.project_in.proj.weight"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_fuse_and_unfuse_match_jax(files, tmp_path, dtype):
    rng = np.random.default_rng(5)
    configs = [(_lora_file(str(tmp_path / "a.safetensors"), rng), 0.8),
               (_lora_file(str(tmp_path / "b.safetensors"), rng), -0.5)]
    jtree = jwl.load_transformer_params(files["f32"], target_dtype=dtype)
    port = weight_loader.load_transformer_params(files["f32"], target_dtype=dtype, device="cpu")
    before = {k: v.clone() for k, v in port_leaves(port).items()}
    jfused, japplied = jlora.fuse_lora_into_params(jtree, [jlora.LoRAConfig(p, s) for p, s in configs],
                                                   return_deltas=True)
    _, applied = lora.fuse_lora_into_params(port, [lora.LoRAConfig(p, s) for p, s in configs], return_deltas=True)
    ref = jax_leaves(jfused)
    assert set(applied) == {"transformer_blocks.0.attn1.to_q.weight", "transformer_blocks.1.ff.project_in.proj.weight",
                            "transformer_blocks.1.attn2.to_k.weight", "proj_out.weight",
                            "transformer_blocks.0.attn2.to_v.weight"}
    fused = {}
    for name, leaf in port_leaves(port).items():
        if name in applied:
            assert not torch.equal(leaf, before[name]), name
            want = torch.from_numpy(np.array(ref[name], np.float32))
            if dtype == "float32":
                assert_close(leaf, want, rtol=1e-6, msg=name)
            else:  # a bf16 rounding apart, rarely; an aliased weight rounds once per alias, in the
                # JAX package in the order of a set's iteration, so there often
                diff = (leaf.float() - want).abs()
                assert diff.max() <= 2.0 ** -7 * want.abs().max(), name
                assert name == ALIASED or (diff > 0).float().mean() < 0.01, name
            fused[name] = leaf.detach().float().abs().max()
        else:
            assert_bitwise(leaf, ref[name], name)
    lora.unfuse_lora_deltas(port, applied)
    eps = 2.0 ** -22 if dtype == "float32" else 2.0 ** -7  # a rounding at the fused weight's size
    for name in applied:
        err = (port_leaves(port)[name].float() - before[name].float()).abs().max()
        assert err <= eps * fused[name], f"unfused {name}: {err}"
    deltas = lora.collect_lora_deltas([lora.LoRAConfig(p, s) for p, s in configs])
    jdeltas = jlora.collect_lora_deltas([jlora.LoRAConfig(p, s) for p, s in configs])
    assert set(deltas) == set(jdeltas)
    for key, d in deltas.items():
        assert_close(d, jdeltas[key], rtol=1e-6, msg=key)
    assert len(japplied) == len(applied)


def test_lora_refuses_fp8_before_any_change(tree, tmp_path):
    """Only attn1.to_q is fp8; the LoRA's to_k entry comes first and must
    not be fused when to_q then refuses."""
    ckpt, full = jexport.params_to_checkpoint(tree), fp8_checkpoint(tree)
    for key in [k for k in full if "attn1.to_q.weight" in k]:
        ckpt[key] = full[key]
    path_ckpt = str(tmp_path / "to_q-fp8.safetensors")
    jst.write_safetensors(path_ckpt, ckpt, metadata=METADATA)
    rng = np.random.default_rng(6)
    path = str(tmp_path / "l.safetensors")
    jst.write_safetensors(path, {f"diffusion_model.transformer_blocks.0.attn1.{n}.lora_{ab}.weight":
                                 rng.standard_normal((4, 256) if ab == "A" else (256, 4)).astype(np.float32)
                                 for n in ("to_k", "to_q") for ab in "AB"})
    kept = weight_loader.load_transformer_params(path_ckpt, keep_fp8=True, device="cpu")
    assert kept.transformer_blocks[0].attn1.to_q.weight.dtype == torch.float8_e4m3fn
    before = {k: bits(v) for k, v in port_leaves(kept).items()}
    with pytest.raises(ValueError, match="fp8"):
        lora.fuse_lora_into_params(kept, [lora.LoRAConfig(path)])
    with pytest.raises(ValueError, match="fp8"):
        jlora.fuse_lora_into_params(jwl.load_transformer_params(path_ckpt, keep_fp8=True), [jlora.LoRAConfig(path)])
    for name, leaf in port_leaves(kept).items():
        assert np.array_equal(bits(leaf)[2], before[name][2]), name
    with pytest.raises(ValueError, match="between -2.0 and 2.0"):
        lora.LoRAConfig(path, strength=2.5)


def test_export_lora_checkpoint_matches_jax(tree, tmp_path):
    jtree, _ = jtlora.add_lora_params(jax.random.PRNGKey(1), jax.tree_util.tree_map(jnp.asarray, tree), rank=4,
                                      alpha=8.0)
    rng = np.random.default_rng(7)

    def randomize_b(path, x):
        name = jax.tree_util.keystr(path)
        return jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)) if "lora_B" in name else x

    jtree = jax.tree_util.tree_map_with_path(randomize_b, jtree)
    port = dit_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), CFG_CAP)
    path_p, path_j = str(tmp_path / "p.safetensors"), str(tmp_path / "j.safetensors")
    export_lora_checkpoint(path_p, port)
    jtlora.export_lora_checkpoint(path_j, jtree)
    fp, fj = jst.SafetensorsFile(path_p), jst.SafetensorsFile(path_j)
    assert set(fp.keys()) == set(fj.keys()) and len(fj.keys()) == 2 * 10 * 2  # blocks x linears x (A, B)
    for key in fj.keys():
        assert_bitwise(fp.get(key), fj.get(key), key)
    bare = dit_from_numpy(tree, CFG_CAP)
    with pytest.raises(ValueError, match="no LoRA adapters"):
        export_lora_checkpoint(str(tmp_path / "none.safetensors"), bare)
    assert add_lora_params_(bare, torch.Generator().manual_seed(0), rank=2) == 20


# ---- registry -----------------------------------------------------------------

def test_registry():
    reg = registry.StateDictRegistry()
    sd = {"a": 1}
    reg.add(["/x/a.safetensors"], "vae", sd)
    assert reg.get(["/x/a.safetensors"], "vae") is sd and len(reg) == 1
    with pytest.raises(ValueError, match="already added"):
        reg.add(["/x/a.safetensors"], "vae", {})
    assert reg.add_or_get(["/x/a.safetensors"], "vae", {"b": 2}) is sd
    assert reg.pop(["/x/a.safetensors"], "vae") is sd and reg.get(["/x/a.safetensors"], "vae") is None
    assert registry.DummyRegistry().get(["/x"], None) is None
    assert reg._generate_id(["/x/a"], "op") == registry.StateDictRegistry()._generate_id(["/x/a"], "op")
