"""fp8 weights kept quantized, on the CPU, against the JAX package:
`quantize_tensor_fp8` and `quantize_params_fp8` (codes and scales bit for
bit), the bench-e2e DiT built block by block in fp8 (the same as the bf16
model quantized), and `linear` with a `weight_scale` (the dequantized
weight bit for bit in fp32 and bf16, outputs at 1e-5 / 1e-2 of max|y|,
runtime LoRA on an fp8 linear, int8 quantization of an fp8 linear refused).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import fp8 as jfp8
from ltx2_tpu.loader import int8 as jint8
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.ops import common as jcommon
from ltx2_tpu_torch.generate import make_dit
from ltx2_tpu_torch.loader import fp8
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.loader.int8 import quantize_params_int8
from ltx2_tpu_torch.ops.common import Linear, linear
from tests.torch_port_util import (
    CFG, JCFG, assert_bitwise, assert_close, assert_module_matches_tree, numpy_tree, port_leaves,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_quantize_tensor_fp8_bitwise(scale):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 64, 96)) * scale).astype(np.float32)
    w[0, 0, :4] = [0.0, -0.0, 1e-9, -1e-9]  # E4M3 subnormals and zeros
    q, s = fp8.quantize_tensor_fp8(torch.from_numpy(w[1]))
    jq, js = jfp8.quantize_tensor_fp8(jnp.asarray(w[1]))
    assert_bitwise(q, jq)
    assert_bitwise(s, js)
    # The stacked layout's per-block scales are one scale per block's tensor.
    jq3, js3 = jfp8.quantize_tensor_fp8(jnp.asarray(w), per_leading_axis=True)
    for i in range(3):
        q, s = fp8.quantize_tensor_fp8(torch.from_numpy(w[i]))
        assert_bitwise(q, np.asarray(jq3)[i])
        assert_bitwise(s, np.asarray(js3)[i].reshape(()))


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=5)


def test_quantize_params_fp8_matches_jax(tree):
    jq = jfp8.quantize_params_fp8(jax.tree_util.tree_map(jnp.asarray, tree))
    port = fp8.quantize_params_fp8(dit_from_numpy(tree, CFG))
    # JAX keeps a stacked (L, 1, 1) scale; per block it is the port's 0-d one.
    jq["transformer_blocks"] = jax.tree_util.tree_map(
        lambda a: a.reshape(a.shape[0]) if a.ndim == 3 and a.shape[1:] == (1, 1) else a, jq["transformer_blocks"])
    assert_module_matches_tree(port, jq)
    assert port.transformer_blocks[0].attn1.to_q.weight.dtype == torch.float8_e4m3fn
    assert port.adaln_single.linear.weight.dtype == torch.float32  # "adaln": skipped
    assert port.transformer_blocks[0].attn1.q_norm.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="already quantized"):
        fp8.quantize_params_fp8(port)
    with pytest.raises(ValueError, match="already-quantized"):
        jfp8.quantize_params_fp8(jq["transformer_blocks"]["attn1"]["to_q"])


def test_fp8_dit_drawn_block_by_block_is_the_bf16_model_quantized():
    """bench-e2e's DiT: drawn and quantized block by block, equal to the
    whole bf16 model drawn from the same seed and then quantized."""
    base = dataclasses.replace(CFG, compute_dtype="bfloat16", caption_channels=64)
    built = make_dit(2, torch.device("cpu"), seed=3, base=base, fp8=True)
    ref = fp8.quantize_params_fp8(make_dit(2, torch.device("cpu"), seed=3, base=base))
    got, want = port_leaves(built), port_leaves(ref)
    assert list(got) == list(want) and built.cfg == ref.cfg
    for name in want:
        assert_bitwise(got[name], want[name], name)
    bf16_blocks = make_dit(2, torch.device("cpu"), seed=3, base=base).transformer_blocks
    assert fp8.weight_bytes(built.transformer_blocks) < 0.6 * fp8.weight_bytes(bf16_blocks)


def _fp8_pair(rng, out_f=48, in_f=80):
    w = rng.standard_normal((out_f, in_f)).astype(np.float32) * 0.2
    b = rng.standard_normal(out_f).astype(np.float32)
    jq, js = jfp8.quantize_tensor_fp8(jnp.asarray(w))
    lin = Linear(in_f, out_f)
    with torch.no_grad():
        lin.bias.copy_(torch.from_numpy(b))
    fp8.set_fp8_weight_(lin, torch.from_numpy(np.asarray(jq).view(np.uint8).copy()).view(torch.float8_e4m3fn),
                        torch.tensor(float(np.asarray(js)), dtype=torch.float32))
    return lin, {"weight": jq, "weight_scale": js, "bias": jnp.asarray(b)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_fp8_matches_jax(dtype):
    rng = np.random.default_rng(1)
    lin, p = _fp8_pair(rng)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    # Through an identity the output is the dequantized weight itself (one
    # product per output): bit for bit, cast then scaled in x's dtype.
    eye = np.eye(80, dtype=np.float32)
    no_bias = {k: v for k, v in p.items() if k != "bias"}
    lin_nb = Linear(80, 48, bias=False)
    fp8.set_fp8_weight_(lin_nb, lin.weight.detach(), lin.weight_scale)
    assert_bitwise(linear(lin_nb, torch.from_numpy(eye).to(tdt)),
                   np.asarray(jcommon.linear(no_bias, jnp.asarray(eye).astype(jdt))))
    x = rng.standard_normal((2, 7, 80)).astype(np.float32)
    out = linear(lin, torch.from_numpy(x).to(tdt)).float()
    ref = np.asarray(jcommon.linear(p, jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    assert out.dtype == torch.float32 and linear(lin, torch.from_numpy(x).to(tdt)).dtype == tdt
    assert_close(out, ref, rtol=1e-5 if dtype == "float32" else 1e-2)


def test_linear_fp8_with_runtime_lora_and_int8_refusal():
    rng = np.random.default_rng(2)
    lin, p = _fp8_pair(rng)
    a = rng.standard_normal((4, 80)).astype(np.float32)
    b = rng.standard_normal((48, 4)).astype(np.float32)
    from ltx2_tpu_torch.training.lora import attach_lora_

    attach_lora_(lin, 4)
    with torch.no_grad():
        lin.lora_A.copy_(torch.from_numpy(a))
        lin.lora_B.copy_(torch.from_numpy(b))
        lin.lora_scale.fill_(0.5)
    p.update(lora_A=jnp.asarray(a), lora_B=jnp.asarray(b), lora_scale=jnp.asarray(0.5, jnp.float32))
    x = rng.standard_normal((3, 80)).astype(np.float32)
    assert_close(linear(lin, torch.from_numpy(x)), np.asarray(jcommon.linear(p, jnp.asarray(x))), rtol=1e-5)
    # int8 re-quantizes from full-precision weights: an fp8 linear is
    # refused, as the JAX package refuses an fp8-kept tree.
    with pytest.raises(ValueError, match="already quantized"):
        quantize_params_int8(lin)
    with pytest.raises(ValueError, match="fp8-kept"):
        jint8.quantize_params_int8(p)


def test_e4m3_table_matches_ml_dtypes():
    """Every E4M3 code widens to the same fp32 in torch and ml_dtypes, and
    every fp32 the quantizer can produce (|v| <= 448) narrows alike."""
    codes = np.arange(256, dtype=np.uint8)
    got = torch.from_numpy(codes.copy()).view(torch.float8_e4m3fn).float().numpy()
    want = codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(want)].view(np.uint32), want[~np.isnan(want)].view(np.uint32))
    v = np.linspace(-448.0, 448.0, 200001, dtype=np.float32)
    assert_bitwise(torch.from_numpy(v).to(torch.float8_e4m3fn), v.astype(ml_dtypes.float8_e4m3fn))
