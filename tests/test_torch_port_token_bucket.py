"""Shape-bucketed serving, text-KV caching and the late cross-attention
scale in the port's video denoise loop, against the JAX package on the CPU:

- the loop in float32 on the 2-layer parity DiT (12 tokens, 3 steps) to
  1e-4 of max|latent| (`assert_close`) against the JAX loop: a token bucket
  of 16 (4 padded tokens) with CFG*, with APG's norm clamp and STG, and
  with every option of the one-stage request of chip_smoke.py at once;
  the cross-attention scale from block 1; text-KV caching, also with the
  DiT's weights kept in fp8;
- the port's bucketed loop against its own unpadded loop (the padding's
  outputs are zeroed before every guider: CFG*'s projection and APG's norm
  reduce over all tokens), and a bucket on the grid adds no mask;
- `bucketed_tokens`, `pad_state_tokens`, `slice_state_tokens`,
  `_perturbation_mask_array` and `precompute_text_kv` against the JAX
  package's; cached K/V refuse unfused runtime LoRA and serve int8 weights
  dequantized per out-channel, as the JAX package's cache does;
- in bf16 on the flash kernels' route (their plain versions, `kv_valid`
  from the token mask) against the JAX package's bf16 loop, to 2e-2 of
  max|latent| (bf16 rounding through 3 steps of 2 blocks; the JAX package
  takes its einsum route at 16 tokens and rounds its logits to bf16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components import perturbations as jperturbations
from ltx2_tpu.loader import fp8 as jfp8
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.pipelines import common as jcommon
from ltx2_tpu.types import LatentState as JLatentState
from ltx2_tpu_torch.components import perturbations
from ltx2_tpu_torch.components.guiders import CFGGuider
from ltx2_tpu_torch.loader import fp8
from ltx2_tpu_torch.loader.from_numpy import dit_from_numpy
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.loader.int8 import set_int8_weight_
from ltx2_tpu_torch.ops import attention
from ltx2_tpu_torch.ops.common import Linear
from ltx2_tpu_torch.pipelines import common
from ltx2_tpu_torch.pipelines.denoise import DenoiseLoopConfig, make_video_denoise_loop
from ltx2_tpu_torch.types import LatentState
from tests.torch_port_util import (
    CFG, JCFG, assert_bitwise, assert_close, force_flash_route, run_loops, stacked_dit_tree, t,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

CFG3 = ("CFGGuider", {"scale": 3.0})
STAR = ("CFGStarRescalingGuider", {"scale": 3.0})
APG_CLAMP = ("LtxAPGGuider", {"scale": 3.0, "eta": 0.7, "norm_threshold": 1.0})
REQUEST_A = {"stg_scale": 1.0, "stg_blocks": (1,), "sampler": "heun", "ge_gamma": 0.5, "cross_attn_scale": 0.5,
             "cross_attn_start_block": 1, "cache_text_kv": True}

# case -> (guider, loop options, run_loops keywords)
CASES = {
    "bucket_cfg_star": (STAR, {}, {"bucket": 16}),
    "bucket_apg_clamp_stg": (APG_CLAMP, {"stg_scale": 1.0}, {"bucket": 16}),
    "bucket_request_a": (STAR, REQUEST_A, {"bucket": 16, "per_token": True}),
    "cross_attn_scale": (CFG3, {"cross_attn_scale": 0.5, "cross_attn_start_block": 1}, {}),
    "text_kv": (CFG3, {"cache_text_kv": True}, {}),
}


@pytest.fixture(scope="module")
def tree():
    return stacked_dit_tree(seed=6)


@pytest.fixture(scope="module")
def weights(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), dit_from_numpy(tree, CFG)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_option_matches_jax(weights, case):
    guider, opts, kwargs = CASES[case]
    out, ref = run_loops(*weights, guider, opts, **kwargs)
    assert np.isfinite(out).all()
    assert_close(out, ref, msg=case)


def test_text_kv_cache_fp8_matches_jax(tree):
    """Cached K/V from fp8 weights: dequantized as `linear` dequantizes them."""
    jq = jfp8.quantize_params_fp8(jax.tree_util.tree_map(jnp.asarray, tree))
    port = fp8.quantize_params_fp8(dit_from_numpy(tree, CFG))
    assert port.transformer_blocks[1].attn2.to_k.weight.dtype == torch.float8_e4m3fn
    out, ref = run_loops(jq, port, CFG3, {"cache_text_kv": True})
    assert_close(out, ref, msg="text KV cache, fp8 DiT")
    uncached, _ = run_loops(jq, port, CFG3, port_only=True)
    assert_close(out, uncached, rtol=1e-6, msg="cached vs uncached K/V")


@pytest.mark.parametrize("guider,opts", [(STAR, {}), (APG_CLAMP, {"stg_scale": 1.0})], ids=["cfg_star", "apg_stg"])
def test_bucketed_matches_unpadded(weights, guider, opts):
    bucketed, _ = run_loops(*weights, guider, opts, bucket=16, port_only=True)
    exact, _ = run_loops(*weights, guider, opts, port_only=True)
    assert_close(bucketed, exact, rtol=2e-5, msg="bucketed vs unpadded")
    on_grid, _ = run_loops(*weights, guider, opts, bucket=12, port_only=True)
    np.testing.assert_array_equal(on_grid, exact)


def test_bucket_helpers_match_jax():
    rng = np.random.default_rng(0)
    latent, clean = (rng.standard_normal((2, 12, 16)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, 12, 1)).astype(np.float32)
    positions = rng.standard_normal((2, 3, 12, 2)).astype(np.float32)
    state = LatentState(latent=t(latent), denoise_mask=t(mask), positions=t(positions), clean_latent=t(clean))
    jstate = JLatentState(latent=jnp.asarray(latent), denoise_mask=jnp.asarray(mask),
                          positions=jnp.asarray(positions), clean_latent=jnp.asarray(clean))
    assert [common.bucketed_tokens(n, 512) for n in (1, 512, 4290)] == [512, 512, 4608]
    assert common.bucketed_tokens(4290, 512) == jcommon.bucketed_tokens(4290, 512)
    padded, token_mask = common.pad_state_tokens(state, 16)
    jpadded, jtoken_mask = jcommon.pad_state_tokens(jstate, 16)
    assert_bitwise(token_mask, jtoken_mask, "token mask")
    for name in ("latent", "denoise_mask", "positions", "clean_latent"):
        assert_bitwise(getattr(padded, name), getattr(jpadded, name), name)
        assert_bitwise(getattr(common.slice_state_tokens(padded, 12), name), getattr(jstate, name), name)
    assert common.pad_state_tokens(state, 12) == (state, None)
    with pytest.raises(ValueError, match="exceeds bucket"):
        common.pad_state_tokens(state, 8)


def test_perturbation_masks_match_jax():
    stg = perturbations.create_stg_perturbation(blocks=[1])
    jstg = jperturbations.create_stg_perturbation(blocks=[1])
    cfg = perturbations.BatchedPerturbationConfig((perturbations.PerturbationConfig.empty(),) * 2 + (stg,))
    jcfg = jperturbations.BatchedPerturbationConfig((jperturbations.PerturbationConfig.empty(),) * 2 + (jstg,))
    masks = model._perturbation_mask_array(cfg, 3, 3)
    jmasks = jmodel._perturbation_mask_array(jcfg, 3, 3)
    assert set(masks) == set(jmasks)
    for name in masks:
        assert_bitwise(masks[name], jmasks[name], name)
    assert masks["video_self"].tolist() == [[1, 1, 1], [1, 1, 0], [1, 1, 1]]
    x = torch.zeros(3, 5, 7, dtype=torch.bfloat16)
    like = cfg.mask_like(perturbations.PerturbationType.SKIP_VIDEO_SELF_ATTN, 1, x)
    assert like.shape == (3, 1, 1) and like.dtype == torch.bfloat16 and like.flatten().tolist() == [1, 1, 0]
    assert cfg.any_in_batch(perturbations.PerturbationType.SKIP_VIDEO_SELF_ATTN, 1)
    assert not cfg.all_in_batch(perturbations.PerturbationType.SKIP_VIDEO_SELF_ATTN, 1)
    batched = perturbations.create_batched_stg_config(2, blocks=[0])
    jbatched = jperturbations.create_batched_stg_config(2, blocks=[0])
    assert_bitwise(batched.mask(perturbations.PerturbationType.SKIP_VIDEO_SELF_ATTN, 0),
                   jbatched.mask(jperturbations.PerturbationType.SKIP_VIDEO_SELF_ATTN, 0))
    ones = model._perturbation_mask_array(None, 2, 3)
    assert all(m.shape == (2, 3) and bool((m == 1).all()) for m in ones.values())


def test_precompute_text_kv_matches_jax(weights):
    jp, port = weights
    ctx = np.random.default_rng(1).standard_normal((3, 16, 256)).astype(np.float32)
    kv = model.precompute_text_kv(port, t(ctx))["video"]
    jkv = jmodel.precompute_text_kv(jp, JCFG, video_context=jnp.asarray(ctx))["video"]
    assert kv[0].shape == (2, 3, 16, 256)
    for got, want, name in zip(kv, jkv, ("k", "v")):
        assert_close(got, want, rtol=1e-5, msg=name)


def test_cached_kv_refuses_runtime_lora_and_int8(tree):
    port = dit_from_numpy(tree, CFG)
    to_k = port.transformer_blocks[0].attn2.to_k
    to_k.lora_A = torch.nn.Parameter(torch.zeros(2, 256))
    to_k.lora_B = torch.nn.Parameter(torch.zeros(256, 2))
    to_k.register_buffer("lora_scale", torch.tensor(1.0))
    loop = make_video_denoise_loop(CFG, DenoiseLoopConfig(guider=CFGGuider(3.0), cache_text_kv=True,
                                                          uniform_timesteps=True))
    state = LatentState(latent=torch.zeros(1, 12, 16), denoise_mask=torch.ones(1, 12, 1),
                        positions=torch.zeros(1, 3, 12, 2), clean_latent=torch.zeros(1, 12, 16))
    ctx = torch.zeros(1, 16, 256)
    with pytest.raises(ValueError, match="fuse the LoRA first"):
        loop(port, state, t([1.0, 0.0]), ctx, ctx)
    # int8 weights are served since the int8 W8A8 port: the cached K/V
    # dequantize them per out-channel for a plain product, as the JAX
    # package's _stacked_linear does (not the step's W8A8 route).
    rng = np.random.default_rng(3)
    codes = rng.integers(-127, 128, (4, 4)).astype(np.int8)
    cscale, x = rng.uniform(0.01, 0.02, 4).astype(np.float32), rng.standard_normal((1, 2, 4)).astype(np.float32)
    linear = Linear(4, 4, bias=False)
    set_int8_weight_(linear, torch.from_numpy(codes), torch.from_numpy(cscale))
    ref = jmodel._stacked_linear({"weight": jnp.asarray(codes)[None], "weight_cscale": jnp.asarray(cscale)[None]},
                                 jnp.asarray(x))
    assert_close(model._stacked_linear([linear], t(x)), ref, rtol=1e-6, msg="int8 cached K/V")


def test_bucketed_loop_bf16_flash_route_matches_jax(tree, monkeypatch):
    """bf16 in both packages, the port's attention on the flash kernels'
    route: self-attention takes the token mask as `kv_valid` (the key-valid
    route chip_smoke.py launches on the card), cross-attention none."""
    seen = force_flash_route(monkeypatch)
    key_valid = {"calls": 0}
    flash = attention.flash_attention

    def counting(q, k, v, scale=None, kv_valid=None):
        key_valid["calls"] += kv_valid is not None
        return flash(q, k, v, scale, kv_valid)

    monkeypatch.setattr(attention, "flash_attention", counting)
    jcfg16 = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    cfg16 = dataclasses.replace(CFG, compute_dtype="bfloat16")
    port16 = dit_from_numpy(tree, cfg16)
    out, ref = run_loops(jax.tree_util.tree_map(jnp.asarray, tree), port16, STAR, {"stg_scale": 1.0}, bucket=16,
                         jcfg=jcfg16, port_cfg=cfg16)
    assert np.isfinite(out).all()
    # 3 steps x 2 blocks x (self with kv_valid + cross without), one forward a step.
    assert seen["forward"] == 12 and key_valid["calls"] == 6, (seen, key_valid)
    assert_close(out, ref, rtol=2e-2, msg="bf16, flash route with kv_valid, vs JAX bf16")
