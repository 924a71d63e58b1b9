"""The port's loaders of the other components, the model ledger and the
entry points from files, on the CPU, against the JAX package.

- The VAE decoder, the spatial upscaler (v1.0 and v1.1 names), Gemma-3 (both
  key prefixes, two shards, fp32 and `quantize_fp8`) and the V1 text encoder
  (both connector prefixes): files written by the JAX package's
  `write_safetensors`, loaded by both packages, leaf by leaf and bit for bit;
  Gemma's every hidden state at the fp32 parity tests' 1e-4.
- `ModelLedger`: components, caching, `with_loras`, fp8 with LoRAs, and the
  unported components' refusals.
- `generate.py --pipeline distilled --checkpoint ... --spatial-upscaler ...
  --gemma-dir ... --gemma-fp8 --text-encoder --fp8-serving --lora ...` at a
  tiny size against `generate_videos_distilled` on the same weights built
  through from_numpy and the JAX package's loader and LoRA fusion.
- `train.py --checkpoint ... --save` (an adapter, then a whole checkpoint),
  read back by `generate.py --lora`, the ledger and the JAX loader.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.loader import export as jexport
from ltx2_tpu.loader import lora as jlora
from ltx2_tpu.loader import safetensors_io as jst
from ltx2_tpu.loader import weight_loader as jwl
from ltx2_tpu.models.text_encoder import connector as jconnector
from ltx2_tpu.models.text_encoder import encoder as jencoder
from ltx2_tpu.models.text_encoder import gemma3 as jgemma
from ltx2_tpu.models.transformer import model as jmodel
from ltx2_tpu.models.upscaler import spatial as jspatial
from ltx2_tpu.models.video_vae import decoder as jdecoder
from ltx2_tpu.models.video_vae import weights as jvae_weights
from ltx2_tpu_torch import generate, train
from ltx2_tpu_torch.loader import lora
from ltx2_tpu_torch.loader.export import iter_fp8_checkpoint_specs
from ltx2_tpu_torch.loader.fp8 import quantize_params_fp8
from ltx2_tpu_torch.loader.from_numpy import (
    dit_from_numpy, gemma3_from_numpy, spatial_upscaler_from_numpy, text_encoder_from_numpy, video_decoder_from_numpy,
)
from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile, write_safetensors_streaming
from ltx2_tpu_torch.models.text_encoder import encoder, gemma3
from ltx2_tpu_torch.models.text_encoder.connector import ConnectorConfig
from ltx2_tpu_torch.models.upscaler import spatial
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoderConfig
from ltx2_tpu_torch.utils.model_ledger import ModelLedger
from tests.torch_port_util import (
    CFG, JCFG, RTOL, assert_close, assert_module_matches_tree, jax_leaves, numpy_tree, port_leaves, write_tokenizer,
)
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

JDCFG = jdecoder.VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32")
DCFG = VideoDecoderConfig(base_channels=16, latent_channels=16, compute_dtype="float32")
# 32 groups, as the published upscaler and the loader (the file does not say) have them.
JUPCFG = jspatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
UPCFG = spatial.SpatialUpscalerConfig(in_channels=16, mid_channels=32, num_blocks_per_stage=1, num_groups=32)
JGCFG, GCFG = jgemma.Gemma3Config.tiny(), gemma3.Gemma3Config.tiny()
HIDDEN = JGCFG.hidden_size  # 32
JCONN = jconnector.ConnectorConfig(attention_head_dim=8, num_attention_heads=4, num_learnable_registers=8)
JTECFG = jencoder.TextEncoderConfig(hidden_dim=HIDDEN, num_gemma_layers=JGCFG.num_hidden_layers + 1, connector=JCONN)
TECFG = encoder.TextEncoderConfig(hidden_dim=HIDDEN, num_gemma_layers=GCFG.num_hidden_layers + 1,
                                  connector=ConnectorConfig(attention_head_dim=8, num_attention_heads=4,
                                                            num_learnable_registers=8))
JCFG_CAP = dataclasses.replace(JCFG, caption_channels=HIDDEN)
CFG_CAP = dataclasses.replace(CFG, caption_channels=HIDDEN, remat=False)
BLOCKS = [["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2, "residual": True}],
          ["res_x", {"num_layers": 1}]]
METADATA = {"model_version": "2.0.0", "config": json.dumps(
    {"transformer": {"num_attention_heads": 2, "connector_attention_head_dim": 8},
     "vae": {"decoder_blocks": BLOCKS}})}
JDCFG_B = dataclasses.replace(JDCFG, decoder_blocks=jdecoder.normalize_decoder_blocks(BLOCKS))
DCFG_B = dataclasses.replace(DCFG, decoder_blocks=vae_weights.normalize_decoder_blocks(BLOCKS))


def _numpy(d):
    return {k: v.float().numpy() if v.is_floating_point() else v.numpy() for k, v in d.items()}


@pytest.fixture(scope="module")
def trees():
    return {
        "dit": numpy_tree(jmodel.init_ltx_model(jax.random.PRNGKey(0), JCFG_CAP), seed=1),
        "decoder": numpy_tree(jax.jit(lambda k: jdecoder.init_video_decoder(k, JDCFG_B))(jax.random.PRNGKey(1)),
                              seed=2),
        "upscaler": numpy_tree(jspatial.init_spatial_upscaler(jax.random.PRNGKey(3), JUPCFG), seed=4),
        "gemma": numpy_tree(jgemma.init_gemma3(jax.random.PRNGKey(5), JGCFG), seed=6),
        "text_encoder": numpy_tree(jencoder.init_text_encoder(jax.random.PRNGKey(7), JTECFG), seed=8),
    }


def _write_gemma(tree, directory, prefix="language_model.model."):
    """Two shards, the layers split between them."""
    tensors = _numpy(gemma3.gemma_to_checkpoint(gemma3_from_numpy(tree, GCFG), prefix))
    first = {k: v for k, v in tensors.items() if ".layers." not in k or int(k.split(".layers.")[1].split(".")[0]) < 3}
    directory.mkdir(parents=True, exist_ok=True)
    jst.write_safetensors(str(directory / "model-00001-of-00002.safetensors"), first)
    jst.write_safetensors(str(directory / "model-00002-of-00002.safetensors"),
                          {k: v for k, v in tensors.items() if k not in first})
    return str(directory)


@pytest.fixture(scope="module")
def files(trees, tmp_path_factory):
    """A unified V1 checkpoint (DiT with caption projection, VAE decoder,
    text projection and video connector) in f32 and in the `-fp8` layout,
    the upscaler's file and a Gemma shard directory with a tokenizer.json,
    by the JAX writers."""
    d = tmp_path_factory.mktemp("files")
    others = {**_numpy(vae_weights.decoder_to_checkpoint(video_decoder_from_numpy(trees["decoder"], DCFG_B))),
              **_numpy(encoder.text_encoder_to_checkpoint(text_encoder_from_numpy(trees["text_encoder"], TECFG)))}
    paths = {"f32": str(d / "ltx.safetensors"), "fp8": str(d / "ltx-fp8.safetensors"),
             "upscaler": str(d / "upscaler.safetensors"), "gemma": write_tokenizer(_write_gemma(trees["gemma"], d / "gemma"))}
    jst.write_safetensors(paths["f32"], {**jexport.params_to_checkpoint(trees["dit"]), **others}, metadata=METADATA)
    dit8 = quantize_params_fp8(dit_from_numpy(trees["dit"], dataclasses.replace(CFG_CAP, compute_dtype="bfloat16")))
    write_safetensors_streaming(paths["fp8"], [
        *iter_fp8_checkpoint_specs(dit8),
        *((k, torch.from_numpy(v).dtype, v.shape, (lambda v=v: torch.from_numpy(v))) for k, v in others.items()),
    ], metadata=METADATA)
    up = spatial_upscaler_from_numpy(trees["upscaler"], UPCFG)
    jst.write_safetensors(paths["upscaler"], _numpy(spatial.upscaler_to_checkpoint(up)))
    return paths


# ---- component loaders against the JAX package --------------------------------

def test_decoder_loader_matches_jax(files, tmp_path):
    cfg = vae_weights.decoder_config_from_checkpoint(files["f32"])
    assert cfg == DCFG_B
    assert jvae_weights.decoder_config_from_checkpoint(files["f32"]).decoder_blocks == cfg.decoder_blocks
    port = vae_weights.load_video_decoder_params(files["f32"], cfg, device="cpu")
    assert_module_matches_tree(port, jvae_weights.load_video_decoder_params(files["f32"], JDCFG_B), stacked="")
    bf16 = vae_weights.load_video_decoder_params(files["f32"], dataclasses.replace(cfg, compute_dtype="bfloat16"),
                                                 device="cpu")
    assert bf16.conv_in.weight.dtype == torch.bfloat16 and bf16.last_scale_shift_table.dtype == torch.float32
    stats = vae_weights.load_per_channel_statistics(files["f32"], 16, device="cpu")
    assert torch.equal(stats.std_of_means, port.per_channel_statistics.std_of_means)
    # No statistics in the file: 0 and 1, as the JAX package defaults them.
    f = SafetensorsFile(files["f32"])
    bare = {k: f.get(k).float().numpy() for k in f.keys() if k.startswith("vae.decoder.")}
    path = str(tmp_path / "bare.safetensors")
    jst.write_safetensors(path, bare, metadata=METADATA)
    bare_port = vae_weights.load_video_decoder_params(path, cfg, device="cpu")
    jbare = jvae_weights.load_video_decoder_params(path, JDCFG_B)
    del jbare["per_channel_statistics"]  # the JAX package's defaults are 128 wide, whatever the latent
    stats = bare_port.per_channel_statistics
    assert torch.equal(stats.mean_of_means, torch.zeros(16)) and torch.equal(stats.std_of_means, torch.ones(16))
    del bare_port.per_channel_statistics
    assert_module_matches_tree(bare_port, jbare, stacked="")
    del bare["vae.decoder.conv_out.conv.weight"]
    jst.write_safetensors(path, bare, metadata=METADATA)
    with pytest.raises(ValueError, match=r"missing .*conv_out"):
        vae_weights.load_video_decoder_params(path, cfg, device="cpu")


@pytest.mark.parametrize("v11", [True, False])
def test_upscaler_loader_matches_jax(trees, tmp_path, v11):
    up = spatial_upscaler_from_numpy(trees["upscaler"], UPCFG)
    path = str(tmp_path / "up.safetensors")
    jst.write_safetensors(path, _numpy(spatial.upscaler_to_checkpoint(up, v11=v11)))
    assert ("upsampler.0.weight" in SafetensorsFile(path)) == v11
    port = spatial.load_spatial_upscaler_params(path, device="cpu")
    assert port.cfg == UPCFG
    assert_module_matches_tree(port, jspatial.load_spatial_upscaler_params(path), stacked="")


@pytest.mark.parametrize("prefix,fp8", [("language_model.model.", False), ("model.", False),
                                        ("language_model.model.", True)])
def test_gemma_loader_matches_jax(trees, tmp_path, prefix, fp8):
    directory = _write_gemma(trees["gemma"], tmp_path / "g", prefix)
    jparams = jgemma.load_gemma3_params(directory, JGCFG, quantize_fp8=fp8)
    port = gemma3.load_gemma3_params(directory, GCFG, quantize_fp8=fp8, device="cpu")
    assert_module_matches_tree(port, jparams, stacked="layers")
    if fp8:
        assert port.layers[0].mlp.up_proj.weight.dtype == torch.float8_e4m3fn
        assert port.embed_tokens.weight.dtype == torch.bfloat16
        # The in-memory quantization is the loader's, bit for bit.
        mem = gemma3.quantize_gemma_fp8_(gemma3_from_numpy(trees["gemma"], GCFG))
        assert_module_matches_tree(mem, jparams, stacked="layers")
    ids = np.random.default_rng(9).integers(3, JGCFG.vocab_size, (2, 12))
    mask = np.ones((2, 12), np.int64)
    mask[1, :5] = 0
    _, jhidden = jgemma.gemma3_apply(jparams, JGCFG, jnp.asarray(ids), jnp.asarray(mask))
    _, hidden = gemma3.gemma3_apply(port, torch.from_numpy(ids), torch.from_numpy(mask))
    for i in range(hidden.shape[0]):
        assert_close(hidden[i], jhidden[i], rtol=RTOL, msg=f"hidden state {i}")
    derived = gemma3.gemma_config_from_checkpoint(directory)
    assert derived == dataclasses.replace(GCFG, sliding_window=derived.sliding_window)


@pytest.mark.parametrize("generic", [False, True])
def test_text_encoder_loader_matches_jax(files, tmp_path, generic):
    path = files["f32"]
    if generic:  # the `embeddings_connector.` prefix
        f = SafetensorsFile(path)
        path = str(tmp_path / "generic.safetensors")
        jst.write_safetensors(path, {k.replace("video_embeddings_connector", "embeddings_connector"): f.get(k).numpy()
                                     for k in f.keys()}, metadata=METADATA)
    cfg = encoder.text_encoder_config_from_checkpoint(path)
    assert cfg == dataclasses.replace(TECFG, connector=cfg.connector) and cfg.connector.num_learnable_registers == 8
    port = encoder.load_text_encoder_params(path, cfg, device="cpu")
    assert_module_matches_tree(port, jencoder.load_text_encoder_params(path, JTECFG), stacked="")
    assert not hasattr(port, "audio_embeddings_connector")
    # An audio-video V1 file: the audio connector beside the video one, of its shape.
    f = SafetensorsFile(path)
    av = str(tmp_path / "av.safetensors")
    audio = {k.replace("video_embeddings_connector", "audio_embeddings_connector")
             .replace(".embeddings_connector", ".audio_embeddings_connector"): f.get(k).numpy() * 0.5
             for k in f.keys() if "embeddings_connector" in k}
    jst.write_safetensors(av, {**{k: f.get(k).numpy() for k in f.keys()}, **audio}, metadata=METADATA)
    av_cfg = encoder.text_encoder_config_from_checkpoint(av)
    assert av_cfg.audio_connector == av_cfg.connector
    assert_module_matches_tree(encoder.load_text_encoder_params(av, av_cfg, device="cpu"),
                               jencoder.load_text_encoder_params(av, JTECFG), stacked="")


# ---- the ledger ----------------------------------------------------------------

def _lora(path, rng):
    w = {}
    for base, (o, i) in {"transformer_blocks.0.attn1.to_q": (256, 256), "transformer_blocks.1.ff.net.2": (256, 1024),
                         "caption_projection.linear_1": (256, HIDDEN)}.items():
        w[f"diffusion_model.{base}.lora_A.weight"] = (rng.standard_normal((4, i)) * 0.2).astype(np.float32)
        w[f"diffusion_model.{base}.lora_B.weight"] = (rng.standard_normal((o, 4)) * 0.2).astype(np.float32)
    jst.write_safetensors(path, w)
    return path


def test_ledger(files, tmp_path):
    ledger = ModelLedger(files["fp8"], gemma_path=files["gemma"], spatial_upscaler_path=files["upscaler"],
                         keep_fp8=True, gemma_fp8=True, device="cpu")
    assert not ledger.is_v2 and ledger.checkpoint_config["vae"]["decoder_blocks"] == BLOCKS
    dit = ledger.transformer()
    assert dit is ledger.transformer() and dit.cfg == dataclasses.replace(CFG_CAP, compute_dtype="bfloat16")
    assert dit.transformer_blocks[0].attn1.to_q.weight.dtype == torch.float8_e4m3fn
    assert_module_matches_tree(dit, jwl.load_transformer_params(files["fp8"], keep_fp8=True))
    assert ledger.gemma().layers[0].self_attn.q_proj.weight.dtype == torch.float8_e4m3fn
    assert ledger.text_encoder().cfg.num_gemma_layers == GCFG.num_hidden_layers + 1
    assert ledger.spatial_upscaler().cfg == UPCFG and ledger.video_decoder().cfg == DCFG_B
    decoder = ledger.video_decoder()
    ledger.clear_model("transformer")
    assert ledger.transformer() is not dit
    # LoRAs: dequantized at load (fp8 cannot take an additive delta), fused
    # as the JAX package fuses them, the other components shared.
    path = _lora(str(tmp_path / "l.safetensors"), np.random.default_rng(1))
    view = ledger.with_loras([lora.LoRAConfig(path, 0.5)])
    assert view.video_decoder() is decoder and view.keep_fp8
    fused = view.transformer()
    assert fused.transformer_blocks[0].attn1.to_q.weight.dtype == torch.bfloat16
    jfused = jlora.fuse_lora_into_params(jwl.load_transformer_params(files["fp8"]), [jlora.LoRAConfig(path, 0.5)])
    got = port_leaves(fused)
    for name, ref in jax_leaves(jfused).items():
        diff = (got[name].float() - torch.from_numpy(np.array(ref, np.float32))).abs()
        assert diff.max() <= 2.0 ** -7 * np.abs(np.asarray(ref, np.float32)).max(), name
        assert (diff > 0).float().mean() < 0.01, name
    ledger.clear_all_models()
    assert ledger.temporal_upscaler() is None  # no temporal_upscaler_path, as in JAX
    assert ledger.audio_decoder() is None and ledger.vocoder() is None  # a file without audio, as in JAX
    assert ledger.audio_encoder() is None
    int8_dit = ModelLedger(files["f32"], device="cpu", int8=True).transformer()
    assert int8_dit.transformer_blocks[0].attn1.to_q.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="no audio stream"):
        ModelLedger(files["f32"], device="cpu", include_audio=True).transformer()
    with pytest.raises(ValueError, match="gemma_path"):
        ModelLedger(files["f32"], device="cpu").gemma()
    assert ModelLedger(files["f32"], device="cpu").spatial_upscaler() is None
    v2 = str(tmp_path / "v2.safetensors")
    jst.write_safetensors(v2, {"text_embedding_projection.video_aggregate_embed.weight": np.zeros((2, 4), np.float32)},
                          metadata={"model_version": "2.3.0"})
    for component in ("transformer", "text_encoder"):  # V2 is read now: this file lacks its tensors
        with pytest.raises(KeyError):
            getattr(ModelLedger(v2, device="cpu"), component)()


# ---- the entry points from files ------------------------------------------------

H = W = 64
FRAMES, SEED = 9, 5


def test_generate_distilled_from_files(trees, files, tmp_path):
    """Every flag of the file path at once, against the same weights handed
    in as modules: the DiT dequantized and LoRA-fused by the JAX package,
    Gemma quantized in memory by the loader's policy, the rest through
    from_numpy (their loaders are held to the JAX package above)."""
    path = _lora(str(tmp_path / "l.safetensors"), np.random.default_rng(2))
    videos, stats = generate.main([
        "--pipeline", "distilled", "--device", "cpu", "--height", str(H), "--width", str(W), "--frames", str(FRAMES),
        "--seed", str(SEED), "--checkpoint", files["fp8"], "--spatial-upscaler", files["upscaler"],
        "--gemma-dir", files["gemma"], "--gemma-fp8", "--text-encoder", "--fp8-serving", "--lora", f"{path}:0.7",
        "--output", str(tmp_path / "out.y4m"),
    ])
    jfused = jlora.fuse_lora_into_params(jwl.load_transformer_params(files["fp8"], target_dtype="bfloat16"),
                                         [jlora.LoRAConfig(path, 0.7)])
    gcfg = gemma3.gemma_config_from_checkpoint(files["gemma"])
    ref_videos, ref_stats = generate.generate_videos_distilled(
        [SEED], height=H, width=W, frames=FRAMES, device="cpu", text_encoder=text_encoder_from_numpy(
            trees["text_encoder"], encoder.text_encoder_config_from_checkpoint(files["fp8"])),
        gemma=gemma3.quantize_gemma_fp8_(gemma3_from_numpy(trees["gemma"], gcfg)),
        dit=dit_from_numpy(jax.tree_util.tree_map(np.asarray, jfused),
                           dataclasses.replace(CFG_CAP, compute_dtype="bfloat16")),
        upscaler=spatial_upscaler_from_numpy(trees["upscaler"], UPCFG),
        decoder=video_decoder_from_numpy(trees["decoder"], dataclasses.replace(DCFG_B, compute_dtype="bfloat16")),
        tokens=generate.tokenize_prompts(files["gemma"], generate.DEFAULT_PROMPT, generate.DEFAULT_NEGATIVE_PROMPT),
    )
    st = stats[0]
    assert st["prompt_source"] == ref_stats[0]["prompt_source"] == "tokenizer"
    assert videos[0].shape == (FRAMES, H, W, 3) and videos[0].dtype == np.uint8
    assert st["context_finite"] and st["stage1_latent_finite"] and st["stage2_latent_finite"]
    assert st["context_std"] == pytest.approx(ref_stats[0]["context_std"], rel=1e-6)
    diff = np.abs(videos[0].astype(int) - ref_videos[0].astype(int))
    assert diff.mean() < 0.1 and diff.max() <= 2, (diff.mean(), diff.max())


def test_train_save_then_generate_lora(files, tmp_path):
    """A LoRA trained from the checkpoint and saved loads back through
    `--lora`; a full fine-tune saves a complete checkpoint the JAX package
    reads."""
    adapter = str(tmp_path / "adapter.safetensors")
    common = ["--checkpoint", files["f32"], "--device", "cpu", "--synthetic", "2", "2", "3", "--synthetic-samples",
              "2", "--steps", "2", "--lr", "1e-2", "--log-every", "1"]
    out = train.main(common + ["--lora-rank", "4", "--save", adapter])
    trained = out["model"]
    assert trained.cfg.remat and out["adapters"] == 2 * 10
    assert any(k.endswith("lora_B.weight") for k in SafetensorsFile(adapter).keys())
    assert set(jlora.load_lora_weights(adapter)) == set(SafetensorsFile(adapter).keys())
    fused = ModelLedger(files["f32"], loras=[lora.LoRAConfig(adapter)], device="cpu").transformer()
    videos, _ = generate.main(["--pipeline", "distilled", "--device", "cpu", "--height", str(H), "--width", str(W),
                               "--frames", str(FRAMES), "--checkpoint", files["f32"], "--spatial-upscaler",
                               files["upscaler"], "--lora", adapter, "--output", str(tmp_path / "out.y4m")])
    assert videos[0].shape == (FRAMES, H, W, 3)
    rng = np.random.default_rng(3)
    from ltx2_tpu_torch.models.transformer import model

    positions = torch.from_numpy(train.synthetic_dataset(2, 2, 3, 1, trained.cfg, 0)["positions"])
    video = model.Modality(latent=torch.from_numpy(rng.standard_normal((1, 12, 16)).astype(np.float32)),
                           context=torch.from_numpy(rng.standard_normal((1, 8, HIDDEN)).astype(np.float32)),
                           context_mask=None, timesteps=torch.tensor([0.7]), positions=positions)
    with torch.no_grad():
        want = model.x0_model_apply(trained, video)
        got = model.x0_model_apply(fused, video)
    assert_close(got, want, rtol=1e-2, msg="fused adapter vs the trained adapters")

    full = str(tmp_path / "full.safetensors")
    tuned = train.main(common + ["--trainable", "attn1.to_q", "--save", full])["model"]
    jtree = jwl.load_transformer_params(full, target_dtype="bfloat16")
    assert_module_matches_tree(tuned, jtree)
    carried = SafetensorsFile(full)
    assert "vae.decoder.conv_in.conv.weight" in carried and carried.metadata == SafetensorsFile(files["f32"]).metadata
