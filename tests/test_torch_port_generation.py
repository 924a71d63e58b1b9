"""The prompt enhancement's decode and helpers against the JAX package, on
the CPU:

- `models/text_encoder/generation.py` against
  `ltx2_tpu/models/text_encoder/generation.py` on `Gemma3Config.tiny()`
  weights carried across by `loader/from_numpy.py`: greedy decodes give the
  same ids (one row, a prompt longer than the sliding window so the decode
  crosses it, left-padded batches of 2), EOS latching on a token the greedy
  run emits mid-way, `sample_top_p` and sampled decodes on JAX's own
  uniforms, the cached decode's logits against the uncached forward (1e-5
  of max|logits|, fp32), `generate_text` on a written tokenizer against the
  JAX function with `AutoTokenizer` (greedy and sampled);
- `utils/prompt_enhancement.py`: the same strings, and
  `resize_aspect_ratio_preserving` PIL's bytes;
- `--early-layers-only`: the contexts are JAX's `gemma3_apply` hidden[0] *
  mask (1e-6 of max), from `encode_prompts` and through `generate.main` on
  a tiny V1 checkpoint; a V2 checkpoint is refused with the JAX message;
- `--enhance-prompt` through `generate.main` on tiny V2 files: the enhanced
  prompt in the stats is what the tokenizer encodes for Gemma.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltx2_tpu.models.text_encoder import gemma3 as jgemma
from ltx2_tpu.models.text_encoder import generation as jgen
from ltx2_tpu.utils import prompt_enhancement as jpe
from ltx2_tpu_torch import generate
from ltx2_tpu_torch.loader.export import iter_checkpoint_specs
from ltx2_tpu_torch.loader.from_numpy import gemma3_from_numpy
from ltx2_tpu_torch.loader.safetensors_io import write_safetensors_streaming
from ltx2_tpu_torch.models.text_encoder import gemma3, generation
from ltx2_tpu_torch.models.transformer.model import LTXModel, init_ltx_model_
from ltx2_tpu_torch.models.video_vae import weights as vae_weights
from ltx2_tpu_torch.models.video_vae.decoder import VideoDecoder, init_video_decoder_
from ltx2_tpu_torch.utils import prompt_enhancement as pe
from ltx2_tpu_torch.utils.tokenizer import load_tokenizer, tokenize
from tests.test_torch_port_prompts import BLOCKS, DCFG, files  # noqa: F401 (the fixture)
from tests.torch_port_util import CFG, numpy_tree, write_tokenizer
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

transformers = pytest.importorskip("transformers")

JGCFG, GCFG = jgemma.Gemma3Config.tiny(), gemma3.Gemma3Config.tiny()  # sliding window 4, vocab 128
NEVER = JGCFG.vocab_size  # an eos id no decode emits
TOL_LOGITS = 1e-5  # cached vs uncached logits, of max|logits|, fp32
TOL_EARLY = 1e-6  # --early-layers-only contexts vs JAX, of max|context|
CHAT = ("<start_of_turn>", "<end_of_turn>")


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(jgemma.init_gemma3(jax.random.PRNGKey(0), JGCFG), seed=1, randomize=("norm",))


@pytest.fixture(scope="module")
def models(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), gemma3_from_numpy(tree, GCFG)


def _prompt(lengths, s, seed=0):
    """Left-padded ids (pad 0) and mask of rows with `lengths` real tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, JGCFG.vocab_size, (len(lengths), s)).astype(np.int32)
    mask = (np.arange(s)[None, :] >= s - np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


def _jax_uniforms(seed, steps, shape):
    """The uniforms JAX's sampled decode draws from PRNGKey(seed): the first
    pick's, then each decode step's, in pick order."""
    key, first = jax.random.split(jax.random.PRNGKey(seed))
    draws = [jax.random.uniform(first, shape)]
    for _ in range(steps - 1):
        key, step = jax.random.split(key)
        draws.append(jax.random.uniform(step, shape))
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


CASES = {"one_row": ([6], 8, 10), "past_the_window": ([11], 12, 12), "left_padded_batch": ([9, 4], 10, 12)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_decode_matches_jax(models, case):
    jparams, port = models
    lengths, s, new = CASES[case]
    ids, mask = _prompt(lengths, s)
    want = np.asarray(jgen.gemma3_generate(jparams, JGCFG, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=new,
                                           eos_id=NEVER))
    got = generation.gemma3_greedy_generate(port, torch.from_numpy(ids), torch.from_numpy(mask), new, eos_id=NEVER)
    assert got.dtype == torch.int64 and got.shape == (len(lengths), new)
    np.testing.assert_array_equal(got.numpy(), want)
    assert s + new > GCFG.sliding_window


def test_eos_latches_to_pad(models):
    """EOS: a token the greedy run emits mid-way; both decodes emit it, then
    pad ids only (the port stops decoding once every row is done)."""
    jparams, port = models
    ids, mask = _prompt([9, 4], 10, seed=3)
    free = np.asarray(jgen.gemma3_generate(jparams, JGCFG, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=20,
                                           eos_id=NEVER))
    eos = int(free[0, 3])
    want = np.asarray(jgen.gemma3_generate(jparams, JGCFG, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=20,
                                           eos_id=eos, pad_id=1))
    got = generation.gemma3_generate(port, torch.from_numpy(ids), torch.from_numpy(mask), 20, eos_id=eos, pad_id=1)
    np.testing.assert_array_equal(got.numpy(), want)
    first = list(want[0]).index(eos)
    assert first <= 3 and (want[0, first + 1:] == 1).all()


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.9), (1.3, 0.5), (0.2, 1.0)])
def test_sample_top_p_matches_jax(temperature, top_p):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((5, 128)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jgen.sample_top_p(key, jnp.asarray(logits), top_p, temperature))
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, logits.shape)))
    got = generation.sample_top_p(torch.from_numpy(logits), top_p, temperature, u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_decode_on_jax_uniforms_matches_jax(models):
    jparams, port = models
    ids, mask = _prompt([9, 4], 10, seed=5)
    new, seed = 12, 11
    want = np.asarray(jgen.gemma3_generate(jparams, JGCFG, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=new,
                                           eos_id=NEVER, temperature=0.7, top_p=0.9, key=jax.random.PRNGKey(seed)))
    got = generation.gemma3_generate(port, torch.from_numpy(ids), torch.from_numpy(mask), new, eos_id=NEVER,
                                     temperature=0.7, top_p=0.9,
                                     uniforms=_jax_uniforms(seed, new, (2, JGCFG.vocab_size)))
    np.testing.assert_array_equal(got.numpy(), want)
    # A generator's stream is the port's own: seeded, it repeats.
    a, b = (generation.gemma3_generate(port, torch.from_numpy(ids), torch.from_numpy(mask), new, eos_id=NEVER,
                                       temperature=0.7, top_p=0.9, generator=torch.Generator().manual_seed(seed))
            for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["one_row", "left_padded_batch"])
def test_cached_decode_logits_match_the_uncached_forward(models, case):
    """Each pick's logits against gemma3_apply over the prompt and the
    tokens before it, then the LM head: the same positions, no cache."""
    _, port = models
    lengths, s, new = CASES[case]
    ids, mask = _prompt(lengths, s, seed=6)
    tokens, logits = generation.gemma3_generate(port, torch.from_numpy(ids), torch.from_numpy(mask), new,
                                                eos_id=NEVER, return_logits=True)
    assert logits.shape == (len(lengths), new, GCFG.vocab_size)
    full_ids = torch.cat([torch.from_numpy(ids).long(), tokens[:, :-1]], dim=1)
    full_mask = torch.cat([torch.from_numpy(mask).long(), torch.ones_like(tokens[:, :-1])], dim=1)
    final, _ = gemma3.gemma3_apply(port, full_ids, full_mask)
    want = torch.nn.functional.linear(final[:, s - 1:], port.embed_tokens.weight)
    err = (logits - want).abs().max()
    assert err <= TOL_LOGITS * want.abs().max(), f"max abs err {float(err):.3e}"


def _chat_tokenizer(directory):
    """`write_tokenizer`'s BPE with Gemma's chat turns as special added
    tokens and Gemma's decoder chain (▁ -> space, byte fallback, fuse,
    strip one leading space)."""
    write_tokenizer(directory)
    path = os.path.join(directory, "tokenizer.json")
    spec = json.load(open(path, encoding="utf-8"))
    vocab = spec["model"]["vocab"]
    for content in CHAT:
        vocab[content] = len(vocab)
        spec["added_tokens"].append({"id": vocab[content], "content": content, "single_word": False,
                                     "lstrip": False, "rstrip": False, "normalized": False, "special": True})
    assert len(vocab) <= GCFG.vocab_size
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    json.dump(spec, open(path, "w", encoding="utf-8"))
    return str(directory)


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_text_matches_jax(models, tmp_path, sampled):
    jparams, port = models
    directory = _chat_tokenizer(tmp_path / "tok")
    ref = transformers.AutoTokenizer.from_pretrained(directory)
    tok = load_tokenizer(directory)
    assert generation.resolve_end_of_turn_id(tok) == jgen.resolve_end_of_turn_id(ref) == tok.token_to_id(CHAT[1])
    prompt = pe.build_chat_prompt("the ocean at sunset", "a red fox")
    assert tok.encode(prompt) == ref(prompt)["input_ids"]
    kw = dict(temperature=0.7, top_p=0.9) if sampled else {}
    want = jgen.generate_text(jparams, JGCFG, ref, prompt, max_new_tokens=24, seed=3, **kw)
    s = len(tok.encode(prompt))
    uniforms = _jax_uniforms(3, 24, (1, GCFG.vocab_size)) if sampled else None
    got = generation.generate_text(port, tok, prompt, max_new_tokens=24, seed=3, uniforms=uniforms, **kw)
    assert got == want and s % 64 != 0  # the prompt was padded
    assert isinstance(got, str) and got


def test_resolve_end_of_turn_falls_back_to_107(tmp_path):
    tok = load_tokenizer(write_tokenizer(tmp_path / "plain"))
    assert generation.resolve_end_of_turn_id(tok) == 107


def test_prompt_enhancement_helpers_match_jax():
    assert pe.T2V_SYSTEM_PROMPT == jpe.T2V_SYSTEM_PROMPT and pe.I2V_SYSTEM_PROMPT == jpe.I2V_SYSTEM_PROMPT
    replies = ["“A fox” runs ‘fast’", "-* > : the ocean ", "", "   ", "- ", "<start_of_turn>model\nA",
               "plain text"]
    for reply in replies:
        assert pe.clean_response(reply) == jpe.clean_response(reply)
        for call in ("enhance_prompt", "enhance_prompt_i2v"):
            seen = {}

            def gen(text, n, **kw):
                seen.setdefault("calls", []).append((text, n, kw))
                return reply

            args = ("a fox", gen) if call == "enhance_prompt" else ("a fox", "cat.png", gen)
            assert getattr(pe, call)(*args) == getattr(jpe, call)(*args)
            assert seen["calls"][0] == seen["calls"][1]
    assert pe.build_chat_prompt("s", "u") == jpe.build_chat_prompt("s", "u")
    assert pe.create_i2v_chat_prompt("u") == jpe.create_i2v_chat_prompt("u")
    assert pe.create_i2v_chat_prompt("u", "sys") == jpe.create_i2v_chat_prompt("u", "sys")


@pytest.mark.parametrize("shape,long_side", [((37, 53, 3), 40), ((53, 37, 3), 96), ((57, 33), 20), ((8, 300, 3), 64),
                                             ((1, 1, 3), 5)])
def test_resize_aspect_ratio_preserving_is_pils(shape, long_side):
    image = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = pe.resize_aspect_ratio_preserving(image, long_side)
    want = jpe.resize_aspect_ratio_preserving(image, long_side)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_early_layers_contexts_match_jax(tree, models):
    """encode_prompts with no text encoder: Gemma's layer-0 state with the
    padding zeroed, as the JAX CLI's --early-layers-only makes it."""
    jparams, port = models
    ids, mask = _prompt([12, 5], 16, seed=8)
    _, jhidden = jgemma.gemma3_apply(jparams, JGCFG, jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(jhidden[0] * jnp.asarray(mask)[:, :, None].astype(jhidden.dtype))
    stats = [{}]
    contexts = generate.encode_prompts([0], port, None, torch.device("cpu"), stats, negatives=True,
                                       tokens=(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()))
    got = contexts[0].numpy()
    assert got.shape == want.shape == (2, 16, GCFG.hidden_size)
    assert np.abs(got - want).max() <= TOL_EARLY * np.abs(want).max()
    assert (got[1, :11] == 0).all()


@pytest.fixture(scope="module")
def v1_checkpoint(tmp_path_factory):
    """A tiny V1 checkpoint whose DiT's caption projection takes the tiny
    Gemma's 32 channels (and a VAE decoder), by the port's writers."""
    d = tmp_path_factory.mktemp("v1_early")
    gen = torch.Generator().manual_seed(2)
    dit = init_ltx_model_(LTXModel(dataclasses.replace(CFG, caption_channels=GCFG.hidden_size)), gen)
    decoder = vae_weights.decoder_to_checkpoint(init_video_decoder_(VideoDecoder(DCFG), gen))
    path = str(d / "v1.safetensors")
    meta = {"config": json.dumps({"transformer": {"num_attention_heads": 2}, "vae": {"decoder_blocks": BLOCKS}})}
    write_safetensors_streaming(path, [*iter_checkpoint_specs(dit),
                                       *((k, v.dtype, tuple(v.shape), (lambda v=v: v)) for k, v in decoder.items())],
                                metadata=meta)
    return path


def test_early_layers_only_through_the_cli(files, v1_checkpoint, tmp_path, monkeypatch, capsys):  # noqa: F811
    """--early-layers-only on a V1 checkpoint: the contexts the DiT gets are
    JAX's hidden[0] * mask of the tokenized prompts on the file's Gemma; a V2
    checkpoint is refused with the JAX CLI's message, before any model."""
    seen = []
    encode = generate.encode_prompts

    def record(*args, **kwargs):
        contexts = encode(*args, **kwargs)
        seen.append(contexts[0])
        return contexts

    monkeypatch.setattr(generate, "encode_prompts", record)
    out = tmp_path / "early.y4m"
    videos, stats = generate.main(["--pipeline", "one-stage", "--device", "cpu", "--height", "64", "--width", "64",
                                   "--num-frames", "9", "--num-inference-steps", "2", "--checkpoint", v1_checkpoint,
                                   "--gemma-dir", files["gemma"], "--early-layers-only", "--prompt", "a fox",
                                   "--output", str(out)])
    assert videos[0].shape == (9, 64, 64, 3) and out.exists() and stats[0]["prompt_source"] == "tokenizer"
    jtree = jgemma.load_gemma3_params(files["gemma"], JGCFG)
    ids, mask = tokenize(files["gemma"], ["a fox", generate.DEFAULT_NEGATIVE_PROMPT])
    _, jhidden = jgemma.gemma3_apply(jtree, JGCFG, jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(jhidden[0] * jnp.asarray(mask)[:, :, None].astype(jhidden.dtype))
    got = seen[0].numpy()
    assert got.shape == want.shape == (2, 1024, GCFG.hidden_size)
    assert np.abs(got - want).max() <= TOL_EARLY * np.abs(want).max()

    for argv, word in ((["--checkpoint", files["checkpoint"], "--gemma-dir", files["gemma"]],
                        "--early-layers-only needs a V1 checkpoint whose caption projection takes 32-d input "
                        "(this model consumes 256-d context)"),
                       (["--checkpoint", v1_checkpoint, "--gemma-dir", files["gemma"], "--embedding", "e.npz"],
                        "needs Gemma's weights")):
        monkeypatch.setattr(generate, "ModelLedger", lambda *a, **k: pytest.fail("a model was built"))
        with pytest.raises(SystemExit):
            generate.main(["--pipeline", "one-stage", "--device", "cpu", "--early-layers-only", "--output",
                           str(tmp_path / "x.y4m"), *argv])
        assert word in capsys.readouterr().err


def test_enhance_prompt_reaches_the_tokenizer(files, tmp_path, monkeypatch):  # noqa: F811
    """--enhance-prompt: the file's Gemma decodes the T2V conversation (512
    new tokens, temperature 0.7, top_p 0.9, seeded by --seed; the same seed
    repeats it), the stats hold the enhanced prompt, and the ids Gemma
    encodes are the tokenizer's of it. The tiny Gemma's reply is prefixed
    here, so the enhanced prompt differs from the user's."""
    seen, calls = [], []
    apply, generate_text = generate.gemma3_apply, generation.generate_text

    def record(model, ids, mask, *args, **kwargs):
        seen.append(ids.cpu().numpy())
        return apply(model, ids, mask, *args, **kwargs)

    def text(model, tokenizer, prompt, **kwargs):
        reply = generate_text(model, tokenizer, prompt, **kwargs)
        calls.append((prompt, kwargs, reply))
        return "A red fox, " + reply

    monkeypatch.setattr(generate, "gemma3_apply", record)
    monkeypatch.setattr(generation, "generate_text", text)
    argv = ["--pipeline", "one-stage", "--device", "cpu", "--height", "64", "--width", "64", "--num-frames", "9",
            "--num-inference-steps", "1", "--checkpoint", files["checkpoint"], "--gemma-dir", files["gemma"],
            "--prompt", "a fox", "--enhance-prompt", "--seed", "4", "--skip-vae", "--output", str(tmp_path / "e.y4m")]
    _, stats = generate.main(argv)
    prompt, kwargs, reply = calls[0]
    assert prompt == pe.build_chat_prompt(pe.T2V_SYSTEM_PROMPT, "a fox")
    assert kwargs == dict(max_new_tokens=512, temperature=0.7, top_p=0.9, seed=4)
    enhanced = stats[0]["enhanced_prompt"]
    assert enhanced == pe.clean_response("A red fox, " + reply) and stats[0]["enhance_s"] > 0
    want, _ = tokenize(files["gemma"], [enhanced, generate.DEFAULT_NEGATIVE_PROMPT])
    np.testing.assert_array_equal(seen[-1], want)
    _, again = generate.main(argv)
    assert calls[1][2] == reply and again[0]["enhanced_prompt"] == enhanced
