"""Parity of the port's video DiT (ltx2_tpu_torch.models.transformer) with
the JAX package on the same weights, in float32 on the CPU, to a relative
1e-4: 2 layers, 2 heads x 128, 12 tokens, 16 text tokens. One test runs both
in bfloat16, the card's dtype, to a relative 1e-2.

Weights come from JAX `init_ltx_model` (tables and norms randomised) and
reach the port through loader/from_numpy.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.models.transformer import attention as jattention
from ltx2_tpu.models.transformer import blocks as jblocks
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import attention, blocks, model
from tests.torch_port_util import CFG, JCFG, assert_close, force_flash_route, numpy_tree, t
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

RNG = np.random.default_rng(1)


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=2)


@pytest.fixture(scope="module")
def weights(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), dit_from_numpy(tree, CFG)


@pytest.fixture(scope="module")
def inputs():
    tools = JTools(JPatchifier(1), JShape(2, 16, 2, 2, 3), fps=24.0)
    positions = np.asarray(tools.create_initial_state().positions)
    latent = RNG.standard_normal((2, 12, 16)).astype(np.float32)
    context = (RNG.standard_normal((2, 16, 256)) * 0.5).astype(np.float32)
    context_mask = np.ones((2, 16), bool)
    context_mask[1, 11:] = False
    return positions, latent, context, context_mask


def _modalities(inputs, per_token: bool, masked: bool):
    positions, latent, context, context_mask = inputs
    timesteps = RNG.uniform(0.05, 1.0, (2, 12) if per_token else (2,)).astype(np.float32)
    cm = context_mask if masked else None
    jm = jmodel.Modality(
        latent=jnp.asarray(latent), context=jnp.asarray(context),
        context_mask=None if cm is None else jnp.asarray(cm), timesteps=jnp.asarray(timesteps),
        positions=jnp.asarray(positions),
    )
    pm = model.Modality(
        latent=t(latent), context=t(context), context_mask=None if cm is None else t(cm),
        timesteps=t(timesteps), positions=t(positions),
    )
    return jm, pm


def test_attention_self_and_cross(weights, inputs):
    jp, port = weights
    jm, pm = _modalities(inputs, per_token=False, masked=True)
    jargs, _, _, _ = jmodel.prepare_stream_args(jp, JCFG, video=jm)
    pargs = model.prepare_stream_args(port, pm)
    assert_close(pargs.x, jargs.x, msg="patchify projection")
    assert_close(pargs.pe[0], jargs.pe[0], msg="rope cos")
    assert_close(pargs.timesteps, jargs.timesteps, msg="adaln embeddings")
    block0 = jax.tree_util.tree_map(lambda a: a[0], jp["transformer_blocks"])
    jcfg = jattention.AttentionConfig(query_dim=256, heads=2, dim_head=128)
    pcfg = attention.AttentionConfig(query_dim=256, heads=2, dim_head=128)
    ref = jattention.attention_apply(block0["attn1"], jcfg, jargs.x, pe=jargs.pe)
    out = attention.attention_apply(port.transformer_blocks[0].attn1, pcfg, pargs.x, pe=pargs.pe)
    assert_close(out, ref, msg="self-attention")
    cross_j = dataclasses.replace(jcfg, context_dim=256)
    cross_p = dataclasses.replace(pcfg, context_dim=256)
    ref = jattention.attention_apply(block0["attn2"], cross_j, jargs.x, context=jargs.context,
                                     mask=jargs.context_mask)
    out = attention.attention_apply(port.transformer_blocks[0].attn2, cross_p, pargs.x,
                                    context=pargs.context, mask=pargs.context_mask)
    assert_close(out, ref, msg="masked cross-attention")
    ref = jattention.feed_forward_apply(block0["ff"], jargs.x)
    assert_close(attention.feed_forward_apply(port.transformer_blocks[0].ff, pargs.x), ref, msg="ff")


def test_block(weights, inputs):
    jp, port = weights
    jm, pm = _modalities(inputs, per_token=True, masked=False)
    jargs, _, _, _ = jmodel.prepare_stream_args(jp, JCFG, video=jm)
    pargs = model.prepare_stream_args(port, pm)
    block1 = jax.tree_util.tree_map(lambda a: a[1], jp["transformer_blocks"])
    jout, _ = jblocks.av_block_apply(block1, jargs, None, JCFG.video_stream_config(), None)
    pout = blocks.av_block_apply(port.transformer_blocks[1], pargs, CFG.video_stream_config())
    assert_close(pout.x, jout.x, msg="block")


@pytest.mark.parametrize("per_token,masked", [(False, False), (True, True)])
def test_x0_model(weights, inputs, per_token, masked):
    jp, port = weights
    jm, pm = _modalities(inputs, per_token=per_token, masked=masked)
    ref = jmodel.x0_model_apply(jp, JCFG, video=jm)
    out = model.x0_model_apply(port, pm)
    assert_close(out, ref, msg="x0")
    assert_close(model.ltx_model_apply(port, pm), jmodel.ltx_model_apply(jp, JCFG, video=jm), msg="velocity")


@pytest.mark.parametrize("masked", [False, True])
def test_x0_model_on_the_flash_route(weights, inputs, monkeypatch, masked):
    """The fp32 model through the flash kernels' plain versions, the route
    the card takes in bf16 (fp32 `sdpa` at these sizes takes sdpa_plain)."""
    seen = force_flash_route(monkeypatch)
    jp, port = weights
    jm, pm = _modalities(inputs, per_token=True, masked=masked)
    out = model.x0_model_apply(port, pm)
    assert seen["forward"] == 2 * CFG.num_layers  # self- and cross-attention of each block
    assert_close(out, jmodel.x0_model_apply(jp, JCFG, video=jm), msg="x0")


def test_x0_model_bf16(tree, inputs):
    """bf16 compute in both packages on the same fp32 tree (the port stores
    its weights in bf16, JAX casts them at use): the dtype placement of
    docs/PARITY.md (fp32 AdaLN, softmax, RoPE and step math), which the fp32
    tests cannot see. The port's bf16 x0 against JAX's fp32 and JAX's bf16, to
    1e-2 of max|x0| (bf16 rounding through 2 blocks: measured 2.7e-3 and
    3.6e-3; JAX rounds its logits and probabilities to bf16 off the flash
    route, the port keeps them in fp32)."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jcfg16 = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    port16 = dit_from_numpy(tree, dataclasses.replace(CFG, compute_dtype="bfloat16"))
    assert port16.transformer_blocks[0].attn1.to_q.weight.dtype == torch.bfloat16
    jm, pm = _modalities(inputs, per_token=False, masked=True)
    out = model.x0_model_apply(port16, pm).float()
    assert torch.isfinite(out).all()
    assert_close(out, jmodel.x0_model_apply(jp, JCFG, video=jm), rtol=1e-2, msg="port bf16 vs JAX fp32")
    assert_close(out, jnp.asarray(jmodel.x0_model_apply(jp, jcfg16, video=jm), jnp.float32), rtol=1e-2,
                 msg="port bf16 vs JAX bf16")


def test_from_numpy_checks_layer_count():
    tree = numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG), seed=0)
    with pytest.raises(ValueError, match="num_layers"):
        dit_from_numpy(tree, dataclasses.replace(CFG, num_layers=3))
