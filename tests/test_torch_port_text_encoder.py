"""The port's V1 text encoding against the JAX package, in float32 on the
CPU, to 1e-4 of max|ref| unless a test says otherwise: INTERLEAVED RoPE
(the connector's tables at its 1024 real positions and 3840 width, both
frequency grids), Gemma-3's pieces and `gemma3_apply` at
`Gemma3Config.tiny()` (every hidden state), `sdpa`'s plain route on
Gemma's masks at head dim 256, the V1 feature extractor, the 1D connector,
`video_text_encoder_apply`, the DiT's caption projection, and the whole
chain from token ids to x0 and to frames through
`generate_videos_distilled(..., text_encoder=...)`.

Weights come from the JAX package's inits (Gemma's zero norms randomised:
zeros would hide the (1 + w) offset) and reach the port through
loader/from_numpy.py; token ids from `generate.prompt_tokens`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.text_encoder import connector as jconnector
from ltx2_tpu.models.text_encoder import encoder as jencoder
from ltx2_tpu.models.text_encoder import feature_extractor as jfe
from ltx2_tpu.models.text_encoder import gemma3 as jgemma
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.ops import attention as jattn
from ltx2_tpu.ops import rope as jrope
from ltx2_tpu.pipelines.distilled import DistilledConfig as JDistilledConfig
from ltx2_tpu.pipelines.distilled import DistilledPipeline as JDistilledPipeline
from ltx2_tpu.pipelines.one_stage import OneStageCFGConfig
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, gemma3_from_numpy, spatial_upscaler_from_numpy, text_encoder_from_numpy,
    video_decoder_from_numpy,
)
from ltx2_tpu_torch.models.text_encoder import connector, encoder, feature_extractor, gemma3
from ltx2_tpu_torch.models.transformer import model
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
from ltx2_tpu_torch.ops import attention, rope
from tests.torch_port_util import CFG, JCFG, assert_close, numpy_tree, t

RNG = np.random.default_rng(11)
JGCFG, GCFG = jgemma.Gemma3Config.tiny(), gemma3.Gemma3Config.tiny()
HIDDEN = JGCFG.hidden_size  # 32
# The tiny stack above Gemma: 7 states of 32, a 2-block 4 x 8 connector with
# 8 registers up to 16 tokens.
JCONN = jconnector.ConnectorConfig(attention_head_dim=8, num_attention_heads=4, num_learnable_registers=8,
                                   min_sequence_length=16)
CONN = connector.ConnectorConfig(attention_head_dim=8, num_attention_heads=4, num_learnable_registers=8,
                                 min_sequence_length=16)
JTECFG = jencoder.TextEncoderConfig(hidden_dim=HIDDEN, num_gemma_layers=7, connector=JCONN)
TECFG = encoder.TextEncoderConfig(hidden_dim=HIDDEN, num_gemma_layers=7, connector=CONN)
# The parity DiT with a caption projection from the tiny encoder's 32 channels.
JCFG_CAP = dataclasses.replace(JCFG, caption_channels=HIDDEN)
CFG_CAP = dataclasses.replace(CFG, caption_channels=HIDDEN)
MASKED = -0.7 * np.finfo(np.float32).max


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def randn(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _left_mask(lengths, s):
    return (np.arange(s)[None, :] >= s - np.asarray(lengths)[:, None]).astype(np.int32)


def _gemma_tree(cfg, seed):
    return numpy_tree(jgemma.init_gemma3(jax.random.PRNGKey(seed), cfg), seed=seed + 1, randomize=("norm",))


@pytest.fixture(scope="module")
def gemma_tree():
    return _gemma_tree(JGCFG, 0)


@pytest.fixture(scope="module")
def te_tree():
    return numpy_tree(jencoder.init_text_encoder(jax.random.PRNGKey(2), JTECFG), seed=3, randomize=("norm",))


@pytest.mark.parametrize("f64", [False, True])
def test_interleaved_tables_at_connector_positions(f64):
    # The connector's real case: raw token indices 0..1023 over max_pos (1,),
    # 3840 wide, theta 1e4: angles up to 3.2e7 rad.
    grid = np.arange(1024, dtype=np.float32)[None, None]
    kw = dict(theta=1e4, max_pos=[1], num_attention_heads=30, use_double_precision=f64)
    jcos, jsin = jrope.precompute_freqs_cis(jnp.asarray(grid), 3840, rope_type=jrope.LTXRopeType.INTERLEAVED, **kw)
    cos, sin = rope.precompute_freqs_cis(t(grid), 3840, rope_type=rope.LTXRopeType.INTERLEAVED, **kw)
    assert cos.shape == (1, 1024, 3840) and cos.dtype == torch.float32
    assert_close(cos, jcos, msg=f"cos f64={f64}")
    assert_close(sin, jsin, msg=f"sin f64={f64}")
    np.testing.assert_array_equal(rope._freq_grid(1e4, 1, 3840, f64), jrope._freq_grid_host(1e4, 1, 3840, f64))


def test_apply_interleaved_rotary_emb():
    # 3 position dims into 64 channels: 4 identity channels padded at the front.
    grid = RNG.integers(0, 40, (2, 3, 5)).astype(np.float32)
    jpe = jrope.precompute_freqs_cis(jnp.asarray(grid), 64, rope_type=jrope.LTXRopeType.INTERLEAVED)
    pe = rope.precompute_freqs_cis(t(grid), 64, rope_type=rope.LTXRopeType.INTERLEAVED)
    assert_close(pe[0], jpe[0], msg="cos")
    x = randn(2, 5, 64)
    ref = jrope.apply_interleaved_rotary_emb(jnp.asarray(x), *jpe)
    assert_close(rope.apply_interleaved_rotary_emb(t(x), *pe), ref, msg="rotation")
    assert_close(rope.apply_rotary_emb(t(x), pe, rope.LTXRopeType.INTERLEAVED), ref, msg="dispatch")


def test_gemma_rms_norm_offset():
    x, w = randn(2, 5, 32, scale=3.0), randn(32)
    ref = jgemma.gemma_rms_norm(jnp.asarray(x), jnp.asarray(w))
    assert_close(gemma3.gemma_rms_norm(t(x), t(w)), ref, msg="gemma rms norm")


@pytest.mark.parametrize("theta,scaling", [(1e4, 1.0), (1e6, 8.0)])
def test_rope_tables_and_rotation(theta, scaling):
    positions = np.arange(12, dtype=np.int32)
    jcos, jsin = jgemma.rope_tables(jnp.asarray(positions), 256, theta, scaling)
    cos, sin = gemma3.rope_tables(torch.from_numpy(positions), 256, theta, scaling)
    assert_close(cos, jcos, msg="cos")
    assert_close(sin, jsin, msg="sin")
    q, k = randn(2, 4, 12, 256), randn(2, 4, 12, 256)
    jq, jk = jgemma.apply_rotary_pos_emb(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    pq, pk = gemma3.apply_rotary_pos_emb(t(q), t(k), cos, sin)
    assert_close(pq, jq, msg="q")
    assert_close(pk, jk, msg="k")


@pytest.mark.parametrize("padded", [False, True])
def test_build_masks(padded):
    mask = _left_mask([12, 5], 12) if padded else None
    jfull, jsliding = jgemma._build_masks(JGCFG, None if mask is None else jnp.asarray(mask), 12, jnp.float32)
    full, sliding = gemma3._build_masks(GCFG, None if mask is None else torch.from_numpy(mask), 12, torch.float32)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    np.testing.assert_array_equal(sliding.numpy(), np.asarray(jsliding))
    assert np.isfinite(full.numpy()).all()


BF16, F32 = torch.bfloat16, torch.float32
ROUTES = [
    # bf16, no mask or a key-only mask: the kernel, at any length.
    ((BF16, 6144, 6144, 128, None), "kernel"),
    ((BF16, 6144, 1024, 128, None), "kernel"),
    ((BF16, 1536, 1536, 128, None), "kernel"),
    ((BF16, 1000, 333, 64, "key"), "kernel"),
    # ... at any head dim too: the kernel raises on a card for D not in {64, 128}
    # (test_kernel_route_raises_for_other_head_dims), it never gives way to plain ops.
    ((BF16, 1024, 1024, 256, None), "kernel"),
    ((BF16, 64, 64, 32, "key"), "kernel"),  # train.py's placeholder heads
    ((BF16, 2048, 2048, 256, None), "kernel"),
    # A query-dependent mask: plain, in any dtype (Gemma in bf16 or fp32).
    ((BF16, 1024, 1024, 256, "query"), "plain"),
    ((F32, 1024, 1024, 256, "query"), "plain"),
    ((F32, 4096, 4096, 128, "query"), "plain"),
    # fp32 operands where the JAX package takes its einsum route.
    ((F32, 1024, 1024, 128, "key"), "plain"),  # the connector
    ((F32, 1024, 1024, 128, None), "plain"),
    ((F32, 4096, 1024, 128, None), "plain"),  # T_q != T_k without a mask
    ((F32, 2000, 2000, 128, None), "plain"),  # not a multiple of 128
    ((F32, 2048, 2048, 64, None), "plain"),  # D not a multiple of 128
    # Everything else raises: the JAX package's flash route on fp32 operands.
    ((F32, 2048, 2048, 128, None), ValueError),
    ((F32, 6144, 1024, 128, "key"), ValueError),
    ((F32, 2048, 2048, 256, None), ValueError),
    ((F32, 64, 64, 64, "causal"), ValueError),  # not a mask kind
]


@pytest.mark.parametrize("args,want", ROUTES)
def test_attention_route(args, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            attention.attention_route(*args)
    else:
        assert attention.attention_route(*args) == want


def test_route_is_the_contract_not_a_fallback(monkeypatch):
    assert attention.mask_kind(None) is None
    assert attention.mask_kind(torch.zeros(2, 1, 1, 8)) == "key"
    assert attention.mask_kind(torch.zeros(1, 1, 8, 8)) == "query"
    assert attention.mask_kind(torch.zeros(1, 4, 1, 8)) == "query"

    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed to launch")

    # A kernel-route call whose kernel fails raises; it never takes the plain route.
    monkeypatch.setattr(attention, "flash_attention", broken)
    q = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="failed to launch"):
        attention.sdpa(q, q, q, mask=torch.zeros(1, 1, 1, 8))
    assert attention.sdpa(q, q, q, mask=torch.zeros(1, 1, 8, 8)).shape == q.shape  # plain: no kernel called


@pytest.mark.parametrize("d", [32, 256])
def test_kernel_route_raises_for_other_head_dims(d):
    """bf16 attention at a head dim the kernels do not take goes to them all
    the same: on the CPU their plain version computes it, and the launch's
    checks (which run before any kernel is built) refuse it, as on a card."""
    q = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16)
    assert attention.attention_route(q.dtype, 8, 8, d, attention.mask_kind(None)) == "kernel"
    assert attention.sdpa(q, q, q).shape == q.shape
    with pytest.raises(ValueError, match="head dim"):
        attention._launch_fwd(q, q, q, d ** -0.5, None, residuals=False)


@pytest.mark.parametrize("case", ["causal", "sliding", "padded_rows"])
def test_sdpa_plain_route_matches_jax(case):
    s, d = 12, 256
    q, k, v = randn(2, 2, s, d), randn(2, 2, s, d), randn(2, 2, s, d)
    pad = _left_mask([12, 5], s) if case == "padded_rows" else None
    full, sliding = jgemma._build_masks(JGCFG, None if pad is None else jnp.asarray(pad), s, jnp.float32)
    mask = np.asarray(sliding if case == "sliding" else full)
    ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask), scale=d ** -0.5)
    out = attention.sdpa(t(q), t(k), t(v), mask=t(mask), scale=d ** -0.5)
    assert torch.isfinite(out).all()
    assert_close(out, ref, msg=case)
    if case == "padded_rows":
        # Row 1's first 7 queries see no valid key: uniform attention over V.
        assert_close(out[1, :, 0], v[1].mean(axis=1), msg="fully padded row")


@pytest.mark.parametrize("case", ["padded", "unpadded", "d256"])
def test_gemma3_apply_matches_jax(gemma_tree, case):
    jcfg, cfg, tree = JGCFG, GCFG, gemma_tree
    if case == "d256":
        kw = dict(num_hidden_layers=2, head_dim=256, layer_types=("sliding_attention", "full_attention"))
        jcfg, cfg = jgemma.Gemma3Config.tiny(**kw), gemma3.Gemma3Config.tiny(**kw)
        tree = _gemma_tree(jcfg, 5)
    ids = RNG.integers(0, jcfg.vocab_size, (2, 12))
    mask = None if case == "unpadded" else _left_mask([12, 5], 12)
    jfinal, jhidden = jgemma.gemma3_apply(_jtree(tree), jcfg, jnp.asarray(ids),
                                          None if mask is None else jnp.asarray(mask))
    final, hidden = gemma3.gemma3_apply(gemma3_from_numpy(tree, cfg), torch.from_numpy(ids),
                                        None if mask is None else torch.from_numpy(mask))
    assert hidden.shape == (cfg.num_hidden_layers + 1, 2, 12, cfg.hidden_size)
    for i in range(hidden.shape[0]):
        assert_close(hidden[i], jhidden[i], msg=f"{case} state {i}")
    assert_close(final, jfinal, msg=f"{case} final")


@pytest.mark.parametrize("side", ["left", "right"])
def test_extract_features_v1(side):
    states = randn(7, 2, 12, HIDDEN, scale=2.0)
    mask = _left_mask([12, 5], 12)
    if side == "right":
        mask = mask[:, ::-1].copy()
    jtree = numpy_tree(jfe.init_feature_extractor_v1(jax.random.PRNGKey(4), HIDDEN, 7), seed=5)
    ref = jfe.extract_features_v1(_jtree(jtree), jnp.asarray(states), jnp.asarray(mask), side)
    fe = feature_extractor.FeatureExtractorV1(HIDDEN, 7)
    fe.aggregate_embed.weight.data.copy_(t(jtree["aggregate_embed"]["weight"]))
    out = feature_extractor.extract_features_v1(fe, t(states), torch.from_numpy(mask), side)
    assert_close(out, ref, msg=side)
    normed = feature_extractor.norm_and_concat_padded_batch(t(states).permute(1, 2, 3, 0), torch.tensor([12, 5]), side)
    jnormed = jfe.norm_and_concat_padded_batch(jnp.asarray(states).transpose(1, 2, 3, 0), jnp.asarray([12, 5]), side)
    assert_close(normed, jnormed, msg=f"{side} normed")


@pytest.mark.parametrize("case", ["registers", "long", "no_registers"])
def test_connector_apply(case):
    jcfg, cfg = JCONN, CONN
    if case == "no_registers":
        jcfg = dataclasses.replace(JCONN, num_learnable_registers=None)
        cfg = dataclasses.replace(CONN, num_learnable_registers=None)
    s = 20 if case == "long" else 10  # 10 < 16: 6 registers appended; 20: 4 (up to whole register tiles)
    tree = numpy_tree(jconnector.init_connector(jax.random.PRNGKey(6), jcfg), seed=7)
    x = randn(2, s, HIDDEN)
    mask = np.where(_left_mask([s, 4], s) > 0, 0.0, -np.finfo(np.float32).max).astype(np.float32)[:, None, None]
    jx, jmask = jconnector.connector_apply(_jtree(tree), jcfg, jnp.asarray(x), jnp.asarray(mask))
    conn = connector.Connector(cfg)
    from ltx2_tpu_torch.loader.from_numpy import _load, flatten_tree

    _load(conn, flatten_tree(tree))
    out, out_mask = connector.connector_apply(conn, t(x), t(mask))
    assert out.shape[1] == {"registers": 16, "long": 24, "no_registers": 10}[case]
    assert_close(out, jx, msg=f"{case} states")
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(jmask))


def test_video_text_encoder_apply(te_tree):
    states = randn(7, 2, 12, HIDDEN, scale=2.0)
    mask = _left_mask([12, 5], 12)
    ref = jencoder.video_text_encoder_apply(_jtree(te_tree), JTECFG, jnp.asarray(states), jnp.asarray(mask))
    out = encoder.video_text_encoder_apply(text_encoder_from_numpy(te_tree, TECFG), t(states), torch.from_numpy(mask))
    assert out.video_encoding.shape == (2, 16, HIDDEN)
    assert_close(out.video_encoding, ref.video_encoding, msg="video encoding")
    np.testing.assert_array_equal(out.attention_mask.numpy(), np.asarray(ref.attention_mask))
    gated = connector.Connector(dataclasses.replace(CONN, apply_gated_attention=True), device="meta")
    assert all(b.attn1.to_gate_logits.weight.shape == (CONN.num_attention_heads, CONN.inner_dim)
               for b in gated.transformer_1d_blocks)


def _x0(jtree, context, jcontext, seed):
    """One x0 of the caption-projection DiT in both packages, the port's on
    `context`, JAX's on `jcontext` (each (1, S, 32)): (port, JAX)."""
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((1, 12, 16)).astype(np.float32)
    positions = rng.integers(0, 4, (1, 3, 12, 1)).astype(np.float32) + np.array([0.0, 1.0], np.float32)
    sigma = np.array([0.6], np.float32)
    jm = jmodel.Modality(latent=jnp.asarray(latent), context=jnp.asarray(jcontext), context_mask=None,
                         timesteps=jnp.asarray(sigma), positions=jnp.asarray(positions))
    ref = jmodel.x0_model_apply(_jtree(jtree), JCFG_CAP, video=jm)
    pm = model.Modality(latent=t(latent), context=torch.as_tensor(context), context_mask=None, timesteps=t(sigma),
                        positions=t(positions))
    return model.x0_model_apply(dit_from_numpy(jtree, CFG_CAP), pm), ref


@pytest.fixture(scope="module")
def dit_cap_tree():
    return numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(8), JCFG_CAP), seed=9)


def test_caption_projection_x0(dit_cap_tree):
    assert "caption_projection" in dit_cap_tree
    context = randn(1, 16, HIDDEN)
    out, ref = _x0(dit_cap_tree, t(context), context, 10)
    assert_close(out, ref, msg="x0 with caption projection")
    with pytest.raises(RuntimeError):
        dit_from_numpy(dit_cap_tree, CFG)  # strict: no place for the projection without caption_channels


def test_tokens_to_x0_chain(gemma_tree, te_tree, dit_cap_tree):
    ids, mask, lengths = generate.prompt_tokens(3, JGCFG.vocab_size)
    assert ids.shape == mask.shape == (2, generate.CONTEXT_TOKENS)
    assert [int(m.sum()) for m in mask] == lengths and all(int(ids[i, -n]) == generate.BOS_ID
                                                           for i, n in enumerate(lengths))
    _, jhidden = jgemma.gemma3_apply(_jtree(gemma_tree), JGCFG, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()))
    jctx = jencoder.video_text_encoder_apply(_jtree(te_tree), JTECFG, jhidden, jnp.asarray(mask.numpy()))
    _, hidden = gemma3.gemma3_apply(gemma3_from_numpy(gemma_tree, GCFG), ids, mask)
    ctx = encoder.video_text_encoder_apply(text_encoder_from_numpy(te_tree, TECFG), hidden, mask)
    assert_close(ctx.video_encoding, jctx.video_encoding, msg="context")
    out, ref = _x0(dit_cap_tree, ctx.video_encoding[0:1], jctx.video_encoding[0:1], 12)
    assert_close(out, ref, msg="x0 from tokens")


def test_generate_distilled_with_text_encoder_matches_jax(gemma_tree, te_tree, dit_cap_tree):
    height = width = 64
    frames, seed = 9, 13
    jdcfg = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                        decode_noise_scale=0.0)
    jupcfg = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
    dec_tree = numpy_tree(jax.jit(lambda k: jdecoder.init_video_decoder(k, jdcfg))(jax.random.PRNGKey(1)), seed=2)
    up_tree = numpy_tree(jspatial.init_spatial_upscaler(jax.random.PRNGKey(3), jupcfg), seed=4)

    # The JAX chain on the request's tokens: Gemma -> encoder -> the prompt row -> the two-stage pipeline.
    ids, mask, _ = generate.prompt_tokens(seed, JGCFG.vocab_size)
    _, jhidden = jgemma.gemma3_apply(_jtree(gemma_tree), JGCFG, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()))
    jctx = jencoder.video_text_encoder_apply(_jtree(te_tree), JTECFG, jhidden, jnp.asarray(mask.numpy()))
    pipe = JDistilledPipeline(transformer_params=_jtree(dit_cap_tree), transformer_cfg=JCFG_CAP,
                              video_decoder_params=_jtree(dec_tree), video_decoder_cfg=jdcfg,
                              spatial_upscaler_params=_jtree(up_tree), spatial_upscaler_cfg=jupcfg)
    config = JDistilledConfig(height=height, width=width, num_frames=frames, seed=seed, dtype="float32",
                              latent_channels=16)
    latent = pipe(jctx.video_encoding[0:1], None, config, skip_decode=True)
    k1, k2, decode_key = jax.random.split(jax.random.PRNGKey(seed), 3)
    ref = pipe._decode_video(jnp.asarray(latent), OneStageCFGConfig(
        height=height, width=width, num_frames=frames, latent_channels=16), decode_key)
    noises = tuple(t(np.asarray(jax.random.normal(jax.random.split(k)[0], (1, n, 16), jnp.float32)))
                   for k, n in ((k1, 2), (k2, 8)))

    videos, stats = generate.generate_videos_distilled(
        [seed], height=height, width=width, frames=frames, device="cpu",
        dit=dit_from_numpy(dit_cap_tree, CFG_CAP),
        upscaler=spatial_upscaler_from_numpy(up_tree, SpatialUpscalerConfig(16, 16, 1, 4)),
        decoder=video_decoder_from_numpy(dec_tree, VideoDecoderConfig(base_channels=16, latent_channels=16,
                                                                      compute_dtype="float32",
                                                                      decode_noise_scale=0.0)),
        gemma=gemma3_from_numpy(gemma_tree, GCFG), text_encoder=text_encoder_from_numpy(te_tree, TECFG),
        noises=[noises],
    )
    assert videos[0].shape == ref.shape == (frames, height, width, 3) and videos[0].dtype == np.uint8
    assert np.abs(videos[0].astype(int) - ref.astype(int)).max() <= 1
    st = stats[0]
    assert st["context_finite"] and st["text_encode_s"] > 0 and st["stage2_latent_finite"]
    assert generate.PROMPT_TOKENS[0] <= st["prompt_tokens"] < generate.PROMPT_TOKENS[1]
    assert generate.NEGATIVE_TOKENS[0] <= st["negative_tokens"] < generate.NEGATIVE_TOKENS[1]
    assert st["attention_launches"] == st["upscale_conv_launches"] == st["decode_conv_launches"] == 0
    assert st["text_encode_peak_gb"] is None  # no device memory on the CPU
    with pytest.raises(ValueError, match="caption_channels"):
        generate.generate_videos_distilled([seed], height=height, width=width, frames=frames, device="cpu",
                                           dit=dit_from_numpy(numpy_tree(jmodel.init_ltx_model(
                                               jax.random.PRNGKey(0), JCFG), seed=1), CFG),
                                           gemma=gemma3_from_numpy(gemma_tree, GCFG),
                                           text_encoder=text_encoder_from_numpy(te_tree, TECFG))


def test_text_encoder_entry_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--pipeline", "distilled", "--text-encoder", "--requests", "1", "--output", "unwritten.y4m"])
    with pytest.raises(SystemExit):
        generate.main(["--text-encoder", "--device", "cpu"])  # bench-e2e has no text encoder
    with pytest.raises(ValueError, match="gemma"):
        generate.generate_videos_distilled([0], device="cpu", gemma=object())


def test_phase_peaks_reset_only_when_asked(monkeypatch):
    """The serving entry leaves the process's peak memory statistics to its
    caller unless asked for each phase's peak (phase_peaks=True)."""
    resets = []
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 2.5e9)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda device=None: resets.append(device))
    cuda = torch.device("cuda")
    assert generate._phase_peak(cuda, False) is None and resets == []
    assert generate._phase_peak(torch.device("cpu"), True) is None and resets == []
    assert generate._phase_peak(cuda, True) == 2.5 and resets == [cuda]
