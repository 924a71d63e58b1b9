"""The port's tokenizer.json reader (ltx2_tpu_torch/utils/tokenizer.py)
against `transformers.AutoTokenizer`, exactly.

Tokenizers are trained here with `tokenizers` (a small BPE over a few
prompts) and varied by component: the normalizers Replace, Prepend and
Sequence; no pre-tokenizer, Split on a string (each behavior) and
Metaspace; byte fallback, fuse_unk and ignore_merges; special and
non-special added tokens with their flags; a TemplateProcessing <bos>, or
a Gemma tokenizer class whose template transformers rebuilds. Each is
written to a directory with its tokenizer_config.json, loaded by both, and
the two encode hypothesis-drawn unicode prompts (emoji, runs of spaces,
empty strings, the added tokens' texts, prompts longer than 1024 tokens) as
the JAX CLI's call does: max_length 1024, truncation, left padding; ids and
masks must be equal.
"""

import copy
import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ltx2_tpu_torch.utils import tokenizer as port_tokenizer

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

CORPUS = ["A cinematic shot of the ocean at sunset", "worst quality, inconsistent motion, blurry, jittery, distorted",
          "the quick brown fox jumps over the lazy dog", "café naïve résumé 東京 ", "  spaces   and\ttabs\nnewlines  ",
          "▁under_score 123 456"] * 20
BYTES = [f"<0x{b:02X}>" for b in range(256)]
ADDED = [
    {"content": "<extra>", "special": False, "normalized": False},
    {"content": "<start_of_image>", "special": True, "normalized": False},
    {"content": "fox", "special": False, "normalized": True, "single_word": True},
    {"content": "[ws]", "special": False, "normalized": False, "lstrip": True, "rstrip": True},
]
BOS_TEMPLATE = {"type": "TemplateProcessing", "single": [{"SpecialToken": {"id": "<bos>", "type_id": 0}},
                                                         {"Sequence": {"id": "A", "type_id": 0}}],
                "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
                "special_tokens": {"<bos>": {"id": "<bos>", "ids": [2], "tokens": ["<bos>"]}}}
REPLACE = {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}


def _base(pre_split: bool):
    """A BPE trained on CORPUS (spaces as ▁; merges across them unless
    `pre_split`), with the byte tokens appended to its vocabulary."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.normalizer = normalizers.Replace(" ", "▁")
    if pre_split:
        tok.pre_tokenizer = pre_tokenizers.Split("▁", "merged_with_next")
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=300, special_tokens=["<pad>", "<eos>", "<bos>",
                                                                                        "<unk>"],
                                                        show_progress=False))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    for name in BYTES + [a["content"] for a in ADDED]:
        vocab.setdefault(name, len(vocab))
    return spec


BASES = {}


def variant(name):
    """tokenizer.json and tokenizer_config.json of the named variant."""
    pre_split = name in ("split_merged_next", "metaspace", "metaspace_first")
    if pre_split not in BASES:
        BASES[pre_split] = _base(pre_split)
    spec = copy.deepcopy(BASES[pre_split])
    model = spec["model"]
    spec["normalizer"], spec["pre_tokenizer"], spec["post_processor"] = REPLACE, None, BOS_TEMPLATE
    model.update(byte_fallback=True, fuse_unk=False, ignore_merges=False)
    config = {"tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<bos>", "eos_token": "<eos>",
              "pad_token": "<pad>", "unk_token": "<unk>", "model_max_length": 1_000_000}
    added = [{"id": model["vocab"][a["content"]], "single_word": False, "lstrip": False, "rstrip": False, **a}
             for a in ADDED]
    spec["added_tokens"] = spec["added_tokens"] + added
    if name == "no_byte_fallback_fuse_unk":
        model.update(byte_fallback=False, fuse_unk=True)
    elif name == "no_byte_fallback":
        model.update(byte_fallback=False)
    elif name == "ignore_merges":
        model.update(ignore_merges=True)
    elif name == "prepend_sequence":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [{"type": "Prepend", "prepend": "▁"}, REPLACE]}
    elif name == "split_inverted":
        spec["pre_tokenizer"] = {"type": "Split", "pattern": {"String": "e"}, "behavior": "Isolated",
                                 "invert": True}
    elif name.startswith("split_"):
        behavior = {"split_removed": "Removed", "split_isolated": "Isolated", "split_contiguous": "Contiguous",
                    "split_merged_prev": "MergedWithPrevious", "split_merged_next": "MergedWithNext"}[name]
        spec["pre_tokenizer"] = {"type": "Split", "pattern": {"String": "▁"}, "behavior": behavior,
                                 "invert": False}
    elif name.startswith("metaspace"):
        spec["normalizer"] = None
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "split": True,
                                 "prepend_scheme": "first" if name == "metaspace_first" else "always"}
    elif name == "gemma_class":
        spec["post_processor"] = None
        config.update(tokenizer_class="GemmaTokenizerFast", add_bos_token=True, add_eos_token=False)
    elif name == "truncate_left":
        config["truncation_side"] = "left"
    elif name == "no_template_no_added":
        spec["post_processor"] = None
        spec["added_tokens"] = spec["added_tokens"][:4]  # <bos> and the like come back from the config
    return spec, config


VARIANTS = ["replace", "no_byte_fallback_fuse_unk", "no_byte_fallback", "ignore_merges", "prepend_sequence",
            "split_removed", "split_isolated", "split_contiguous", "split_merged_prev", "split_merged_next",
            "split_inverted", "metaspace", "metaspace_first", "gemma_class", "truncate_left", "no_template_no_added"]
LOADED = {}


def load(name, tmp_path_factory):
    if name not in LOADED:
        spec, config = variant(name)
        d = tmp_path_factory.mktemp(name)
        (d / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
        (d / "tokenizer_config.json").write_text(json.dumps(config), encoding="utf-8")
        ref = transformers.AutoTokenizer.from_pretrained(str(d), padding_side="left")
        LOADED[name] = (str(d), ref)
    return LOADED[name]


def reference(ref, prompts, max_length=1024):
    enc = ref(list(prompts), return_tensors="np", padding="max_length", truncation=True, max_length=max_length)
    return np.asarray(enc["input_ids"], np.int64), np.asarray(enc["attention_mask"], np.int64)


PIECES = st.one_of(
    st.text(alphabet=st.characters(codec="utf-8", exclude_categories=("Cs",)), max_size=12),
    st.sampled_from([" ", "  ", "   ", "\t", "\n", "fox", " fox ", "foxes", "_fox", "<extra>", "<start_of_image>",
                     "<bos>", "<eos>", "<pad>", " [ws] ", "[ws]", "😀", "🎬🌅", "東京", "café", "▁", "the ocean",
                     "cinematic", "zzz", "　", "\xa0", "²", "¼", "Ⓐ", "é"]),
)
PROMPTS = st.lists(PIECES, max_size=10).map("".join)


@pytest.mark.parametrize("name", VARIANTS)
@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(a=PROMPTS, b=PROMPTS)
def test_tokenizer_matches_autotokenizer(name, tmp_path_factory, a, b):
    directory, ref = load(name, tmp_path_factory)
    ids, mask = port_tokenizer.tokenize(directory, [a, b])
    want_ids, want_mask = reference(ref, [a, b])
    assert ids.dtype == np.int64 and mask.dtype == np.int64
    np.testing.assert_array_equal(ids, want_ids, err_msg=repr((a, b)))
    np.testing.assert_array_equal(mask, want_mask, err_msg=repr((a, b)))


@pytest.mark.parametrize("name", ["replace", "metaspace", "gemma_class", "truncate_left"])
def test_long_empty_and_fixed_prompts(name, tmp_path_factory):
    """Right-side truncation of prompts far over 1024 tokens, the empty
    prompt (the template's <bos> alone) and the JAX CLI's default prompts."""
    directory, ref = load(name, tmp_path_factory)
    long = " ".join(["A cinematic shot of 😀 the ocean at sunset <extra> café"] * 150)
    prompts = [long, "", "A cinematic shot of the ocean at sunset",
               "worst quality, inconsistent motion, blurry, jittery, distorted"]
    ids, mask = port_tokenizer.tokenize(directory, prompts)
    want_ids, want_mask = reference(ref, prompts)
    assert mask[0].all() and mask[1].sum() == 1  # truncated to the full length; <bos> alone
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    short_ids, short_mask = port_tokenizer.tokenize(directory, prompts, max_length=16)
    np.testing.assert_array_equal(short_ids, reference(ref, prompts, 16)[0])
    np.testing.assert_array_equal(short_mask, reference(ref, prompts, 16)[1])


def test_merges_follow_rank_then_position():
    """Merges apply lowest rank first, leftmost on ties, and a stale heap
    entry is skipped: 'aaa' with the single merge (a, a) gives [aa, a]."""
    vocab = {"a": 0, "b": 1, "aa": 2, "ab": 3, "aab": 4, "<pad>": 5}
    spec = {"model": {"type": "BPE", "vocab": vocab, "merges": [["a", "b"], ["a", "a"], ["aa", "b"]]},
            "added_tokens": []}
    tok = port_tokenizer.Tokenizer(spec, {"pad_token": "<pad>"})
    assert tok.encode_ids("aaa") == [2, 0]
    assert tok.encode_ids("aab") == [0, 3]  # (a, b) ranks first
    assert tok.encode_ids("aaab") == [2, 3]


@pytest.mark.parametrize("field,value,kind", [
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("normalizer", {"type": "Replace", "pattern": {"Regex": " +"}, "content": "▁"}, "Regex"),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False}, "ByteLevel"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": "\\s"}, "behavior": "Isolated", "invert": False},
     "Regex"),
    ("post_processor", {"type": "ByteLevel"}, "ByteLevel"),
    ("model", {"type": "WordPiece", "vocab": {}}, "WordPiece"),
    ("pre_tokenizer", {"type": "Sequence", "pretokenizers": []}, "Sequence"),
])
def test_unsupported_components_raise_by_name(field, value, kind):
    spec, config = variant("replace")
    spec[field] = value
    with pytest.raises(NotImplementedError, match=kind):
        port_tokenizer.Tokenizer(spec, config)


def test_parsed_once_per_path(tmp_path_factory):
    directory, _ = load("replace", tmp_path_factory)
    assert port_tokenizer.load_tokenizer(directory) is port_tokenizer.load_tokenizer(directory)
    assert port_tokenizer.has_tokenizer(directory) and not port_tokenizer.has_tokenizer(None)
