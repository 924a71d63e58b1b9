"""LTX-2.3 (V2) in the port against the JAX package, on the CPU, on the
same numpy-drawn weights (`random_tree`: the 9-row AdaLN tables, the prompt
tables and the gates drawn non-zero, the gate logits' weights scaled up so
the gates spread over (0, 2)):

- gated attention, the V2 block and the V2 `ltx_model_apply` /
  `x0_model_apply` (cross-attention AdaLN, prompt-table K/V modulation from
  `prompt_adaln_single` on the modality's sigma, gated attention, no caption
  projection) with uniform and per-token timesteps, in fp32 to 1e-4 of
  max|ref| (`assert_close`) and in bf16 to 1e-2 of max|x0| (the bound of
  `test_x0_model_bf16`);
- `extract_features_v2`, the gated connector and V2 `av_text_encoder_apply`
  (the video and the audio encodings), fp32 to 1e-4;
- the V2 distilled and one-stage pipelines at a small size on the JAX
  package's noise, the one-stage one at fps 12 (the position grid's rate),
  fp32 to 1e-4;
- `cache_text_kv` on V2: the loop skips the cache as the JAX loop does, and
  `precompute_text_kv` raises;
- a V2 checkpoint the port writes (f32 and the `-fp8` layout), read by
  `ltx2_tpu.loader.weight_loader.load_transformer_params` and
  `ltx2_tpu.models.text_encoder.encoder.load_text_encoder_params` bit for
  bit, and a DiT the JAX package exports (`ltx2_tpu/loader/export.py`) read
  by the port; the model ledger's V2 components.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.components.patchifiers import VideoLatentPatchifier as JPatchifier
from ltx2_tpu.conditioning.tools import VideoLatentTools as JTools
from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.loader import weight_loader as jwl
from ltx2_tpu.models.text_encoder import connector as jconnector
from ltx2_tpu.models.text_encoder import encoder as jencoder
from ltx2_tpu.models.text_encoder import feature_extractor as jfe
from ltx2_tpu.models.transformer import attention as jattention
from ltx2_tpu.models.transformer import blocks as jblocks
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.pipelines.distilled import DistilledConfig as JDistilledConfig
from ltx2_tpu.pipelines.distilled import DistilledPipeline as JDistilledPipeline
from ltx2_tpu.pipelines.one_stage import OneStageCFGConfig as JOneStageCFGConfig
from ltx2_tpu.pipelines.one_stage import OneStagePipeline as JOneStagePipeline
from ltx2_tpu.types import VideoLatentShape as JShape
from ltx2_tpu_torch.loader import weight_loader
from ltx2_tpu_torch.loader.export import iter_checkpoint_specs, iter_fp8_checkpoint_specs
from ltx2_tpu_torch.loader.fp8 import quantize_params_fp8
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, spatial_upscaler_from_numpy, text_encoder_from_numpy, video_decoder_from_numpy,
)
from ltx2_tpu_torch.loader.safetensors_io import write_safetensors_streaming
from ltx2_tpu_torch.models.text_encoder import connector, encoder, feature_extractor
from ltx2_tpu_torch.models.transformer import attention, blocks, model
from ltx2_tpu_torch.models.upscaler.spatial import SpatialUpscaler, SpatialUpscalerConfig
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, VideoDecoderConfig
from ltx2_tpu_torch.pipelines.distilled import DistilledConfig, DistilledPipeline
from ltx2_tpu_torch.pipelines.one_stage import OneStageCFGConfig, OneStagePipeline
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import (
    CFG, JCFG, assert_close, assert_module_matches_tree, random_tree, run_loops, stacked_dit_tree, t,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

JV2 = dataclasses.replace(JCFG, cross_attention_adaln=True, apply_gated_attention=True)
V2 = dataclasses.replace(CFG, cross_attention_adaln=True, apply_gated_attention=True, remat=False)
GATE_SCALE = 8.0  # spreads 2 * sigmoid(gate logits) over most of (0, 2)
RNG = np.random.default_rng(11)


def v2_tree(seed: int = 4):
    tree = stacked_dit_tree(V2, seed)
    for attn in ("attn1", "attn2"):
        tree["transformer_blocks"][attn]["to_gate_logits"]["weight"] *= GATE_SCALE
    return tree


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    tree = v2_tree()
    return tree, _jtree(tree), dit_from_numpy(tree, V2)


@pytest.fixture(scope="module")
def inputs():
    tools = JTools(JPatchifier(1), JShape(2, 16, 2, 2, 3), fps=24.0)
    positions = np.asarray(tools.create_initial_state().positions)
    latent = RNG.standard_normal((2, 12, 16)).astype(np.float32)
    context = (RNG.standard_normal((2, 16, 256)) * 0.5).astype(np.float32)
    context_mask = np.ones((2, 16), bool)
    context_mask[1, 11:] = False
    return positions, latent, context, context_mask


def _modalities(inputs, per_token: bool, masked: bool = False, sigma: bool = True):
    positions, latent, context, context_mask = inputs
    timesteps = RNG.uniform(0.05, 1.0, (2, 12) if per_token else (2,)).astype(np.float32)
    sig = RNG.uniform(0.05, 1.0, (2,)).astype(np.float32) if sigma else None
    cm = context_mask if masked else None
    jm = jmodel.Modality(latent=jnp.asarray(latent), context=jnp.asarray(context),
                         context_mask=None if cm is None else jnp.asarray(cm), timesteps=jnp.asarray(timesteps),
                         positions=jnp.asarray(positions), sigma=None if sig is None else jnp.asarray(sig))
    pm = model.Modality(latent=t(latent), context=t(context), context_mask=None if cm is None else t(cm),
                        timesteps=t(timesteps), positions=t(positions), sigma=None if sig is None else t(sig))
    return jm, pm


# ---- the DiT ---------------------------------------------------------------------

def test_gated_attention(weights, inputs):
    """`to_gate_logits` (heads outputs) gates each head before `to_out`,
    self- and cross-attention; the gates move the output."""
    _, jp, port = weights
    _, latent, context, _ = inputs
    x = t(latent @ RNG.standard_normal((16, 256)).astype(np.float32))
    block0 = jax.tree_util.tree_map(lambda a: a[0], jp["transformer_blocks"])
    jcfg = jattention.AttentionConfig(query_dim=256, heads=2, dim_head=128, apply_gated_attention=True)
    pcfg = attention.AttentionConfig(query_dim=256, heads=2, dim_head=128, apply_gated_attention=True)
    assert port.transformer_blocks[0].attn1.to_gate_logits.weight.shape == (2, 256)
    for name, ctx in (("attn1", None), ("attn2", context)):
        ref = jattention.attention_apply(block0[name], jcfg, jnp.asarray(x.numpy()),
                                         context=None if ctx is None else jnp.asarray(ctx))
        out = attention.attention_apply(getattr(port.transformer_blocks[0], name), pcfg, x,
                                        context=None if ctx is None else t(ctx))
        assert_close(out, ref, msg=name)
        ungated = attention.attention_apply(getattr(port.transformer_blocks[0], name),
                                            dataclasses.replace(pcfg, apply_gated_attention=False), x,
                                            context=None if ctx is None else t(ctx))
        assert (out - ungated).abs().max() > 0.1 * out.abs().max(), name


@pytest.mark.parametrize("per_token", [False, True])
def test_v2_block(weights, inputs, per_token):
    _, jp, port = weights
    jm, pm = _modalities(inputs, per_token=per_token, masked=True)
    jargs, _, _, _ = jmodel.prepare_stream_args(jp, JV2, video=jm)
    pargs = model.prepare_stream_args(port, pm)
    assert pargs.timesteps.shape[2] == 9 and pargs.prompt_timestep.shape == (2, 1, 2, 256)
    assert_close(pargs.timesteps, jargs.timesteps, msg="adaln embeddings")
    assert_close(pargs.prompt_timestep, jargs.prompt_timestep, msg="prompt adaln embeddings")
    block1 = jax.tree_util.tree_map(lambda a: a[1], jp["transformer_blocks"])
    jout, _ = jblocks.av_block_apply(block1, jargs, None, JV2.video_stream_config(), None)
    pout = blocks.av_block_apply(port.transformer_blocks[1], pargs, V2.video_stream_config())
    assert_close(pout.x, jout.x, msg="V2 block")
    with pytest.raises(AssertionError, match="V2 KV modulation"):
        blocks.av_block_apply(port.transformer_blocks[1], pargs, V2.video_stream_config(),
                              video_text_kv=(pargs.context, pargs.context))


@pytest.mark.parametrize("per_token,masked,sigma", [(False, False, True), (True, True, True), (True, False, False)])
def test_v2_x0_model(weights, inputs, per_token, masked, sigma):
    """fp32 x0 and velocity; without a sigma the prompt AdaLN takes the
    timesteps (per token: the first token's), as the JAX package does."""
    _, jp, port = weights
    jm, pm = _modalities(inputs, per_token=per_token, masked=masked, sigma=sigma)
    assert_close(model.x0_model_apply(port, pm), jmodel.x0_model_apply(jp, JV2, video=jm), msg="x0")
    assert_close(model.ltx_model_apply(port, pm), jmodel.ltx_model_apply(jp, JV2, video=jm), msg="velocity")


def test_v2_x0_model_bf16(weights, inputs):
    """bf16 compute in both packages on the same fp32 tree; the port's bf16
    x0 against JAX's fp32 and bf16 to 1e-2 of max|x0|."""
    tree, jp, _ = weights
    port16 = dit_from_numpy(tree, dataclasses.replace(V2, compute_dtype="bfloat16"))
    assert port16.transformer_blocks[0].attn2.to_gate_logits.weight.dtype == torch.bfloat16
    assert port16.transformer_blocks[0].prompt_scale_shift_table.dtype == torch.float32
    jm, pm = _modalities(inputs, per_token=True, masked=True)
    out = model.x0_model_apply(port16, pm).float()
    assert torch.isfinite(out).all()
    assert_close(out, jmodel.x0_model_apply(jp, JV2, video=jm), rtol=1e-2, msg="port bf16 vs JAX fp32")
    jv2_16 = dataclasses.replace(JV2, compute_dtype="bfloat16")
    assert_close(out, jnp.asarray(jmodel.x0_model_apply(jp, jv2_16, video=jm), jnp.float32), rtol=1e-2,
                 msg="port bf16 vs JAX bf16")


def test_v2_model_layout(weights):
    _, _, port = weights
    names = dict(port.named_parameters())
    assert "caption_projection.linear_1.weight" not in names
    assert names["adaln_single.linear.weight"].shape == (9 * 256, 256)
    assert names["prompt_adaln_single.linear.weight"].shape == (2 * 256, 256)
    assert names["transformer_blocks.0.scale_shift_table"].shape == (9, 256)
    assert names["transformer_blocks.0.prompt_scale_shift_table"].shape == (2, 256)
    v1 = model.LTXModel(CFG, device="meta")
    assert v1.transformer_blocks[0].scale_shift_table.shape == (6, 256)
    assert not hasattr(v1, "prompt_adaln_single") and not hasattr(v1.transformer_blocks[0].attn1, "to_gate_logits")


@pytest.mark.parametrize("per_token", [False, True])
def test_v2_cache_text_kv_is_skipped(weights, per_token):
    """`cache_text_kv` on a V2 model: the loop runs uncached, as the JAX
    loop does (denoise.py:503), and equals the JAX loop; the direct
    `precompute_text_kv` raises (model.py:430)."""
    tree, jp, port = weights
    got, ref = run_loops(jp, port, ("CFGGuider", {"scale": 3.0}), {"cache_text_kv": True}, per_token=per_token,
                         jcfg=JV2, port_cfg=V2)
    plain, _ = run_loops(jp, port, ("CFGGuider", {"scale": 3.0}), {}, per_token=per_token, jcfg=JV2, port_cfg=V2,
                         port_only=True)
    assert_close(got, ref, msg="V2 loop with cache_text_kv")
    np.testing.assert_array_equal(got, plain)
    with pytest.raises(ValueError, match="V1-only"):
        model.precompute_text_kv(port, torch.zeros(1, 4, 256))
    with pytest.raises(ValueError, match="V1-only"):
        jmodel.precompute_text_kv(jp, JV2, video_context=jnp.zeros((1, 4, 256)))


# ---- the V2 text encoder ----------------------------------------------------------

HIDDEN, STATES = 32, 7
JTE2 = jencoder.TextEncoderConfig(
    v2=True, hidden_dim=HIDDEN, num_gemma_layers=STATES, video_inner_dim=32, audio_inner_dim=16,
    connector=jconnector.ConnectorConfig(attention_head_dim=8, num_attention_heads=4, num_layers=2,
                                         num_learnable_registers=8, apply_gated_attention=True),
    audio_connector=jconnector.ConnectorConfig(attention_head_dim=4, num_attention_heads=4, num_layers=2,
                                               num_learnable_registers=8, apply_gated_attention=True))
TE2 = encoder.text_encoder_config_v2(hidden_dim=HIDDEN, num_gemma_layers=STATES, video_heads=4, video_head_dim=8,
                                     audio_heads=4, audio_head_dim=4, layers=2, registers=8)


def te2_tree(cfg=TE2, seed: int = 8):
    tree = random_tree(encoder.VideoTextEncoder(cfg, device="meta"), seed)
    for conn in ("embeddings_connector", "audio_embeddings_connector"):
        for block in tree[conn]["transformer_1d_blocks"]:
            block["attn1"]["to_gate_logits"]["weight"] *= GATE_SCALE
    return tree


@pytest.fixture(scope="module")
def te_tree():
    return te2_tree()


def _left_mask(lengths, s):
    return np.stack([np.arange(s) >= s - n for n in lengths]).astype(np.int64)


def test_extract_features_v2(te_tree):
    states = (RNG.standard_normal((STATES, 2, 12, HIDDEN)) * 2.0).astype(np.float32)
    mask = _left_mask([12, 5], 12)
    jv, ja = jfe.extract_features_v2(_jtree(te_tree)["feature_extractor"], jnp.asarray(states), jnp.asarray(mask),
                                     HIDDEN)
    port = text_encoder_from_numpy(te_tree, TE2)
    v, a = feature_extractor.extract_features_v2(port.feature_extractor, t(states), torch.from_numpy(mask), HIDDEN)
    assert v.shape == (2, 12, 32) and a.shape == (2, 12, 16)
    assert_close(v, jv, msg="video features")
    assert_close(a, ja, msg="audio features")
    normed = feature_extractor.norm_and_concat_per_token_rms(t(states).permute(1, 2, 3, 0), torch.from_numpy(mask))
    assert_close(normed, jfe.norm_and_concat_per_token_rms(jnp.asarray(states).transpose(1, 2, 3, 0),
                                                           jnp.asarray(mask)), msg="per-token rms")


@pytest.mark.parametrize("which", ["embeddings_connector", "audio_embeddings_connector"])
def test_gated_connector(te_tree, which):
    jcfg = JTE2.connector if which == "embeddings_connector" else JTE2.audio_connector
    pcfg = TE2.connector if which == "embeddings_connector" else TE2.audio_connector
    x = (RNG.standard_normal((2, 12, pcfg.inner_dim))).astype(np.float32)
    mask = encoder.convert_to_additive_mask(torch.from_numpy(_left_mask([12, 5], 12)), torch.float32)
    ref, ref_mask = jconnector.connector_apply(_jtree(te_tree)[which], jcfg, jnp.asarray(x), jnp.asarray(mask.numpy()))
    conn = getattr(text_encoder_from_numpy(te_tree, TE2), which)
    assert conn.transformer_1d_blocks[0].attn1.to_gate_logits.weight.shape == (4, pcfg.inner_dim)
    out, out_mask = connector.connector_apply(conn, t(x), mask)
    assert_close(out, ref, msg=which)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))


def test_av_text_encoder_apply_v2(te_tree):
    states = (RNG.standard_normal((STATES, 2, 12, HIDDEN)) * 2.0).astype(np.float32)
    mask = _left_mask([12, 5], 12)
    ref = jencoder.av_text_encoder_apply(_jtree(te_tree), JTE2, jnp.asarray(states), jnp.asarray(mask))
    port = text_encoder_from_numpy(te_tree, TE2)
    out = encoder.av_text_encoder_apply(port, t(states), torch.from_numpy(mask))
    assert out.video_encoding.shape == (2, 1024, 32) and out.audio_encoding.shape == (2, 1024, 16)  # registers
    assert_close(out.video_encoding, ref.video_encoding, msg="video encoding")
    assert_close(out.audio_encoding, ref.audio_encoding, msg="audio encoding")
    np.testing.assert_array_equal(out.attention_mask.numpy(), np.asarray(ref.attention_mask))
    with pytest.raises(ValueError, match="av_text_encoder_apply"):
        encoder.video_text_encoder_apply(port, t(states), torch.from_numpy(mask))


# ---- the V2 pipelines -------------------------------------------------------------

JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32",
                                    decode_noise_scale=0.0)
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32", decode_noise_scale=0.0)
JUPCFG = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
UPCFG = SpatialUpscalerConfig(in_channels=16, mid_channels=16, num_blocks_per_stage=1, num_groups=4)
HEIGHT, WIDTH, FRAMES, SEED = 64, 64, 9, 13


@pytest.fixture(scope="module")
def vae_trees():
    return random_tree(VideoDecoder(DCFG), 3), random_tree(SpatialUpscaler(UPCFG, device="meta"), 4)


def test_v2_distilled_pipeline_matches_jax(weights, vae_trees):
    tree, jp, port = weights
    dec_tree, up_tree = vae_trees
    context = (np.random.default_rng(5).standard_normal((1, 16, 256)) * 0.5).astype(np.float32)
    jpipe = JDistilledPipeline(transformer_params=jp, transformer_cfg=JV2, video_decoder_params=_jtree(dec_tree),
                               video_decoder_cfg=JDCFG, spatial_upscaler_params=_jtree(up_tree),
                               spatial_upscaler_cfg=JUPCFG)
    jconfig = JDistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, dtype="float32",
                               latent_channels=16)
    ref = jpipe(jnp.asarray(context), None, jconfig, skip_decode=True)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(SEED), 3)
    noises = tuple(t(np.asarray(jax.random.normal(jax.random.split(k)[0], (1, n, 16), jnp.float32)))
                   for k, n in ((k1, 2), (k2, 8)))
    pipe = DistilledPipeline(port, spatial_upscaler_from_numpy(up_tree, UPCFG),
                             video_decoder=video_decoder_from_numpy(dec_tree, DCFG))
    config = DistilledConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, latent_channels=16)
    latent = pipe(t(context), config, skip_decode=True, noises=noises)
    assert_close(latent, np.asarray(ref), msg="V2 two-stage latent")


def test_v2_one_stage_pipeline_at_fps_12_matches_jax(weights, vae_trees):
    """CFG* at 3.0 with the cached-K/V option on (skipped on V2), at fps 12:
    the position grid's temporal axis is in seconds at the clip's rate."""
    tree, jp, port = weights
    dec_tree, _ = vae_trees
    rng = np.random.default_rng(6)
    pos, neg = ((rng.standard_normal((1, 16, 256)) * 0.5).astype(np.float32) for _ in range(2))
    jpipe = JOneStagePipeline(transformer_params=jp, transformer_cfg=JV2, video_decoder_params=_jtree(dec_tree),
                              video_decoder_cfg=JDCFG)
    jconfig = JOneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                                 latent_channels=16, fps=12.0)
    ref, _ = jpipe(jnp.asarray(pos), jnp.asarray(neg), jconfig, skip_decode=True, cache_text_kv=True)
    tokens = 2 * 2 * 2
    noise = t(np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(SEED), 4)[1], (1, tokens, 16),
                                           jnp.float32)))
    config = OneStageCFGConfig(height=HEIGHT, width=WIDTH, num_frames=FRAMES, seed=SEED, num_inference_steps=3,
                               latent_channels=16, fps=12.0)
    latent, _ = OneStagePipeline(port)(t(pos), t(neg), config, skip_decode=True, noise=noise, cache_text_kv=True)
    assert_close(latent, np.asarray(ref), msg="V2 one-stage latent at fps 12")
    at_24, _ = OneStagePipeline(port)(t(pos), t(neg), dataclasses.replace(config, fps=24.0), skip_decode=True,
                                      noise=noise)
    assert (at_24 - latent).abs().max() > 1e-3  # the rate moves the result


# ---- V2 checkpoints ---------------------------------------------------------------

V2_META = {"model_version": "2.3.0", "config": json.dumps({"transformer": {
    "num_attention_heads": 2, "connector_num_attention_heads": 4, "connector_attention_head_dim": 8,
    "audio_connector_num_attention_heads": 4, "audio_connector_attention_head_dim": 4,
    "connector_num_layers": 2}})}


def _encoder_tensors(te_tree):
    return encoder.text_encoder_to_checkpoint(text_encoder_from_numpy(te_tree, TE2))


def test_v2_checkpoint_round_trip(weights, te_tree, tmp_path):
    """The port's writers -> a V2 file both packages read, bit for bit
    (f32 and the `-fp8` layout); the JAX package's export -> the port."""
    tree, jp, port = weights
    te = _encoder_tensors(te_tree)
    assert {k for k in te if k.startswith("text_embedding_projection.")} == {
        f"text_embedding_projection.{h}_aggregate_embed.{p}" for h in ("video", "audio") for p in ("weight", "bias")}
    assert any(k.startswith("model.diffusion_model.audio_embeddings_connector.") and "to_gate_logits" in k for k in te)
    te_specs = [(k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in te.items()]
    f32 = str(tmp_path / "v2.safetensors")
    write_safetensors_streaming(f32, [*iter_checkpoint_specs(port), *te_specs], metadata=V2_META)

    assert jwl.is_v2_model(f32) and weight_loader.is_v2_model(f32)
    assert_module_matches_tree(port, jwl.load_transformer_params(f32, target_dtype="float32"))
    loaded = weight_loader.load_transformer_params(f32, target_dtype="float32", device="cpu")
    assert loaded.cfg == dataclasses.replace(V2, remat=False)
    assert_module_matches_tree(loaded, tree)
    jte = jencoder.load_text_encoder_params(f32, jencoder.av_text_encoder_config_v2_from_checkpoint(f32))
    te_port = encoder.load_text_encoder_params(f32, encoder.text_encoder_config_from_checkpoint(f32, HIDDEN),
                                               device="cpu")
    assert te_port.cfg == TE2
    for name, leaf in dict(te_port.named_parameters()).items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(_get(jte, name)), err_msg=name)

    fp8 = str(tmp_path / "v2-fp8.safetensors")
    dit8 = quantize_params_fp8(dit_from_numpy(tree, dataclasses.replace(V2, compute_dtype="bfloat16")))
    assert dit8.transformer_blocks[0].attn2.to_gate_logits.weight.dtype == torch.float8_e4m3fn
    write_safetensors_streaming(fp8, [*iter_fp8_checkpoint_specs(dit8), *te_specs], metadata=V2_META)
    assert_module_matches_tree(weight_loader.load_transformer_params(fp8, device="cpu"),
                               jwl.load_transformer_params(fp8, target_dtype="bfloat16"))
    kept = weight_loader.load_transformer_params(fp8, device="cpu", keep_fp8=True)
    assert kept.transformer_blocks[1].attn1.to_gate_logits.weight.dtype == torch.float8_e4m3fn

    exported = str(tmp_path / "v2-jax.safetensors")
    jst.write_safetensors(exported, jexport.params_to_checkpoint(tree), metadata=V2_META)
    assert_module_matches_tree(weight_loader.load_transformer_params(exported, target_dtype="float32", device="cpu"),
                               tree)

    ledger = ModelLedger(f32, target_dtype="float32", device="cpu")
    assert ledger.is_v2 and ledger.transformer().cfg.cross_attention_adaln
    with pytest.raises(ValueError, match="Gemma's 3840"):  # V2's extractor needs Gemma's width: gemma_path
        ledger.text_encoder()


def _get(tree, dotted):
    node = tree
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node
