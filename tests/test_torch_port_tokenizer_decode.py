"""The port tokenizer's decode and unpadded encode (utils/tokenizer.py)
against `tokenizers` and `transformers.AutoTokenizer`, exactly.

Every written variant of tests/test_torch_port_tokenizer.py, with Gemma's
decoder chain (Replace ▁ -> space, ByteFallback, Fuse, Strip one leading
space), another order with a two-space Strip, or none (tokens joined by
spaces): hypothesis-drawn id lists over
the vocabulary, the byte tokens, the special and non-special added tokens
and ids past the vocabulary, decoded with and without
`skip_special_tokens`; `Tokenizer.encode` against `tokenizer(prompt)`;
transformers' `clean_up_tokenization_spaces`; unsupported decoders raise by
name.
"""

import copy
import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ltx2_tpu_torch.utils import tokenizer as port_tokenizer
from tests.test_torch_port_tokenizer import BYTES, PROMPTS, VARIANTS, variant
from tests.torch_port_util import one_intra_op_thread  # noqa: F401 (the fixture)

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")
tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

GEMMA_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "}, {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
DECODERS = {"gemma": GEMMA_DECODER, "none": None,
            "strip_two": {"type": "Sequence", "decoders": [
                {"type": "ByteFallback"}, {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "Strip", "content": " ", "start": 2, "stop": 0}, {"type": "Fuse"}]}}
LOADED = {}


def load(name, decoder, tmp_path_factory):
    """(port Tokenizer, tokenizers.Tokenizer, AutoTokenizer, vocabulary size
    with the added tokens) of a variant with `decoder`."""
    if (name, decoder) not in LOADED:
        spec, config = variant(name)
        spec = copy.deepcopy(spec)
        spec["decoder"] = DECODERS[decoder]
        d = tmp_path_factory.mktemp(f"{name}_{decoder}")
        (d / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
        (d / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")
        size = max([*spec["model"]["vocab"].values(), *(t["id"] for t in spec["added_tokens"])]) + 1
        LOADED[(name, decoder)] = (port_tokenizer.load_tokenizer(str(d)),
                                   tokenizers.Tokenizer.from_file(str(d / "tokenizer.json")),
                                   transformers.AutoTokenizer.from_pretrained(str(d)), size)
    return LOADED[(name, decoder)]


def _ids(draw_size):
    return st.lists(st.one_of(st.integers(0, draw_size + 2), st.sampled_from(range(4)),
                              st.integers(draw_size - 270, draw_size - 1)), max_size=24)


@pytest.mark.parametrize("decoder", sorted(DECODERS))
@pytest.mark.parametrize("name", VARIANTS)
@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_decode_matches_tokenizers(name, decoder, tmp_path_factory, data):
    port, ref, auto, size = load(name, decoder, tmp_path_factory)
    ids = data.draw(_ids(size))
    for skip in (True, False):
        want = ref.decode(ids, skip_special_tokens=skip)
        assert port.decode(ids, skip_special_tokens=skip) == want, repr(ids)
        if all(i < size for i in ids):
            assert auto.decode(ids, skip_special_tokens=skip) == want


@pytest.mark.parametrize("name", ["replace", "metaspace", "gemma_class", "no_template_no_added"])
@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(prompt=PROMPTS)
def test_encode_and_round_trip(name, tmp_path_factory, prompt):
    """`encode` is `tokenizer(prompt)` (the template, no padding); decoding
    it back agrees with `tokenizers` too."""
    port, ref, auto, _ = load(name, "gemma", tmp_path_factory)
    ids = port.encode(prompt)
    assert ids == auto(prompt)["input_ids"]
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)


def test_byte_fallback_runs_and_invalid_utf8(tmp_path_factory):
    port, ref, _, _ = load("replace", "gemma", tmp_path_factory)
    vocab = variant("replace")[0]["model"]["vocab"]
    emoji = [vocab[f"<0x{b:02X}>"] for b in "😀".encode()]
    cases = [emoji, emoji[:2], emoji[:2] + [vocab["▁"]] + emoji, [vocab["<0xFF>"]] * 3, emoji + emoji[1:],
             [vocab[b] for b in BYTES[0x41:0x44]]]
    for ids in cases:
        assert port.decode(ids) == ref.decode(ids, skip_special_tokens=False), ids


def test_clean_up_tokenization_spaces(tmp_path):
    spec, config = variant("replace")
    spec["decoder"] = GEMMA_DECODER
    config["clean_up_tokenization_spaces"] = True
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")
    auto = transformers.AutoTokenizer.from_pretrained(str(tmp_path))
    port = port_tokenizer.load_tokenizer(str(tmp_path))
    for text in ["the fox , jumps . over ? it 's", "don 't ! we 're here , they 've 'm"]:
        ids = auto(text)["input_ids"]
        assert port.decode(ids, skip_special_tokens=True) == auto.decode(ids, skip_special_tokens=True)


@pytest.mark.parametrize("decoder,kind", [({"type": "Metaspace", "replacement": "▁"}, "Metaspace"),
                                          ({"type": "ByteLevel"}, "ByteLevel"),
                                          ({"type": "Replace", "pattern": {"Regex": "▁+"}, "content": " "}, "Regex")])
def test_unsupported_decoders_raise_by_name(decoder, kind):
    spec, config = variant("replace")
    spec["decoder"] = decoder
    with pytest.raises(NotImplementedError, match=kind):
        port_tokenizer.Tokenizer(spec, config)
