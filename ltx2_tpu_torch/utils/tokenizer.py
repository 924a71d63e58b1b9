"""A reader of Hugging Face `tokenizer.json` files, for Gemma's prompts.

The JAX CLI tokenizes through `transformers.AutoTokenizer.from_pretrained(
gemma_dir, padding_side="left")(prompts, padding="max_length",
truncation=True, max_length=1024)` (scripts/generate.py:532,565-568). The
port reads the same two files itself, in plain Python and numpy, and
encodes as that call does, step by step as the `tokenizers` library runs it:

1. added tokens are split off the raw text (leftmost-longest matching of
   the tokens that are not `normalized`), with their `single_word`,
   `lstrip` and `rstrip` flags;
2. each remaining piece is normalized (`Replace` of a string, `Prepend`,
   `Sequence`), and the `normalized` added tokens, themselves normalized,
   are split off it;
3. the pre-tokenizer (none, `Split` on a string, `Metaspace`) cuts the
   pieces into words;
4. the `BPE` model encodes each word: its characters (or, with
   `byte_fallback`, the `<0xNN>` tokens of a character's bytes; else the
   `unk_token`, consecutive ones fused with `fuse_unk`), then merges by
   rank, lowest first, leftmost on ties, the `tokenizers` heap's order; with
   `ignore_merges` a word that is itself in the vocabulary is one token;
5. truncation on the right (or the left, as `tokenizer_config.json`'s
   `truncation_side` says) to `max_length` less the template's special
   tokens, then the post-processor's template (`TemplateProcessing`), then
   padding to `max_length` on the left with the pad token.

`encode` gives one prompt's ids with the template and no padding or
truncation (`tokenizer(prompt)`, the prompt enhancement's call); `decode`
is `decode(ids, skip_special_tokens=...)`: the ids' tokens (special ones
skipped when asked) through the file's `decoder` (`Replace` of a string,
`ByteFallback`, `Fuse`, `Strip`, in a `Sequence`; without one the tokens
joined by spaces), then transformers' `clean_up_tokenization_spaces` when
the config asks for it.

`tokenizer_config.json` gives the pad, bos, eos and unk tokens; special
tokens it names that the added tokens lack are added as transformers adds
them (special, not normalized). With a Gemma or Llama `tokenizer_class` the
template is rebuilt from `add_bos_token` (default on) and `add_eos_token`
(default off), as `GemmaTokenizerFast.update_post_processor` does. Any
other component type raises NotImplementedError naming it. A parsed file
is cached per path (Gemma's holds 262k tokens and about 500k merges).
"""

from __future__ import annotations

import heapq
import json
import os
import unicodedata
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Rust's char::is_whitespace (the Unicode White_Space property), which
# lstrip/rstrip of added tokens use; Python's isspace() differs from it.
WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
                       + "\u2028\u2029\u202f\u205f\u3000")
GEMMA_LIKE = ("GemmaTokenizer", "GemmaTokenizerFast", "LlamaTokenizer", "LlamaTokenizerFast")


def _refuse(kind: str, spec) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(f"tokenizer.json: the {kind} {name!r} is not supported by the port's reader")


# Symbols (category So) with the Alphabetic property: circled, parenthesized
# and squared Latin letters.
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))


def _is_word_char(c: str) -> bool:
    """The Rust regex crate's Unicode \\w, which `tokenizers` uses for
    `single_word`: Alphabetic, marks, decimal digits, connector punctuation
    and the joiners (not Python's isalnum: '²' and '¼' are not \\w)."""
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d":
        return True
    return any(lo <= ord(c) <= hi for lo, hi in _ALPHABETIC_SYMBOLS)


# ---- normalized strings: text with each character's original offset --------

@dataclass
class _Piece:
    text: str
    orig: List[int]  # per character: the original offset it came from

    def slice(self, start: int, end: int) -> "_Piece":
        return _Piece(self.text[start:end], self.orig[start:end])


def _replace(p: _Piece, pattern: str, content: str) -> _Piece:
    """Every non-overlapping occurrence of `pattern`, left to right, by
    `content`, whose characters take the occurrence's original offset."""
    if not pattern or pattern not in p.text:
        return p
    text, orig, i = [], [], 0
    while True:
        j = p.text.find(pattern, i)
        if j < 0:
            break
        text.append(p.text[i:j])
        orig.extend(p.orig[i:j])
        text.append(content)
        orig.extend([p.orig[j]] * len(content))
        i = j + len(pattern)
    text.append(p.text[i:])
    orig.extend(p.orig[i:])
    return _Piece("".join(text), orig)


def _prepend(p: _Piece, prefix: str) -> _Piece:
    if not p.text:
        return p
    return _Piece(prefix + p.text, [p.orig[0]] * len(prefix) + p.orig)


def _string_pattern(spec: dict, kind: str) -> str:
    pattern = spec.get("pattern", {})
    if "String" not in pattern:
        raise NotImplementedError(f"tokenizer.json: the {kind}'s pattern {pattern!r} is not a String (Regex "
                                  "patterns are not supported by the port's reader)")
    return pattern["String"]


def _make_normalizer(spec):
    """tokenizer.json's normalizer -> fn(_Piece) -> _Piece."""
    if spec is None:
        return lambda p: p
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_make_normalizer(s) for s in spec["normalizers"]]

        def seq(p):
            for step in steps:
                p = step(p)
            return p
        return seq
    if kind == "Replace":
        pattern, content = _string_pattern(spec, "Replace normalizer"), spec["content"]
        return lambda p: _replace(p, pattern, content)
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda p: _prepend(p, prefix)
    raise _refuse("normalizer", spec)


# ---- pre-tokenizers -----------------------------------------------------------

def _find_matches(text: str, pattern: str) -> List[Tuple[int, int, bool]]:
    """`tokenizers`' Pattern::find_matches for a string: the text cut into
    (start, end, is_match) ranges covering it."""
    if not text:
        return [(0, 0, False)]
    if not pattern:
        return [(0, len(text), False)]
    out, prev, i = [], 0, text.find(pattern)
    while i >= 0:
        if prev != i:
            out.append((prev, i, False))
        out.append((i, i + len(pattern), True))
        prev = i + len(pattern)
        i = text.find(pattern, prev)
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _split(p: _Piece, pattern: str, behavior: str, invert: bool = False) -> List[_Piece]:
    """NormalizedString::split: the pieces `behavior` leaves, empty ones
    dropped (as PreTokenizedString::split drops them)."""
    matches = [(s, e, m != invert) for s, e, m in _find_matches(p.text, pattern)]
    if behavior == "Removed":
        spans = [(s, e) for s, e, m in matches if not m]
    elif behavior == "Isolated":
        spans = [(s, e) for s, e, _ in matches]
    elif behavior in ("Contiguous", "MergedWithPrevious", "MergedWithNext"):
        order = matches[::-1] if behavior == "MergedWithNext" else matches
        spans, previous = [], False
        for s, e, m in order:
            merge = (m == previous) if behavior == "Contiguous" else (m and not previous)
            if merge and spans:
                spans[-1] = (s, spans[-1][1]) if behavior == "MergedWithNext" else (spans[-1][0], e)
            else:
                spans.append((s, e))
            previous = m
        if behavior == "MergedWithNext":
            spans.reverse()
    else:
        raise _refuse("Split behavior", behavior)
    return [p.slice(s, e) for s, e in spans if e > s]


def _make_pre_tokenizer(spec):
    """tokenizer.json's pre-tokenizer -> fn(_Piece) -> [_Piece]."""
    if spec is None:
        return lambda p: [p] if p.text else []
    kind = spec.get("type")
    if kind == "Split":
        pattern = _string_pattern(spec, "Split pre-tokenizer")
        behavior, invert = spec["behavior"], bool(spec.get("invert", False))
        return lambda p: _split(p, pattern, behavior, invert)
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        do_split = spec.get("split", True)

        def metaspace(p):
            p = _replace(p, " ", rep)
            if p.text and not p.text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and p.orig[0] == 0)):
                p = _prepend(p, rep)
            return _split(p, rep, "MergedWithNext") if do_split else ([p] if p.text else [])
        return metaspace
    raise _refuse("pre-tokenizer", spec)


# ---- the BPE model ------------------------------------------------------------

class _BPE:
    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise _refuse("model", spec)
        for field in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(field):
                raise NotImplementedError(f"tokenizer.json: the BPE model's {field} is not supported by the port's "
                                          "reader")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}  # pair -> (rank, merged id); the last wins
        for rank, merge in enumerate(spec.get("merges", [])):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])

    def _symbols(self, word: str) -> List[int]:
        ids: List[int] = []
        unk: Optional[int] = None  # a pending unk's id (its length is not needed)
        for s in word:
            if s in self.vocab:
                if unk is not None:
                    ids.append(unk)
                    unk = None
                ids.append(self.vocab[s])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in s.encode("utf-8")]
                if all(c in self.vocab for c in codes):
                    ids.extend(self.vocab[c] for c in codes)  # a pending unk stays pending, as in `tokenizers`
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    ids.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            ids.append(unk)
        return ids

    def encode_word(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids = self._symbols(word)
        n = len(ids)
        nxt, prv, alive = list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        heap = []  # (rank, position, merged id): the lowest rank first, then the leftmost
        for i in range(n - 1):
            if (ids[i], ids[i + 1]) in self.merges:
                rank, new = self.merges[(ids[i], ids[i + 1])]
                heap.append((rank, i, new))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            target = self.merges.get((ids[pos], ids[right]))
            if target is None or target[1] != new:
                continue  # a stale entry
            ids[pos], alive[right] = new, False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0 and (ids[prv[pos]], ids[pos]) in self.merges:
                r, nid = self.merges[(ids[prv[pos]], ids[pos])]
                heapq.heappush(heap, (r, prv[pos], nid))
            if nxt[pos] < n and (ids[pos], ids[nxt[pos]]) in self.merges:
                r, nid = self.merges[(ids[pos], ids[nxt[pos]])]
                heapq.heappush(heap, (r, pos, nid))
        return [t for t, a in zip(ids, alive) if a]


# ---- decoders -------------------------------------------------------------------

def _byte_of(token: str) -> Optional[int]:
    """The byte of a `<0xNN>` token, as `tokenizers`' ByteFallback parses it
    (6 bytes long; Rust's u8::from_str_radix, which takes a leading '+')."""
    if len(token.encode("utf-8")) != 6 or not (token.startswith("<0x") and token.endswith(">")):
        return None
    digits = token[3:5]
    body = digits[1:] if digits.startswith("+") else digits
    if not body or any(c not in "0123456789abcdefABCDEF" for c in body):
        return None
    return int(body, 16)


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Runs of `<0xNN>` tokens -> their bytes as one string, or one U+FFFD a
    byte when they are not valid UTF-8."""
    out: List[str] = []
    pending: List[int] = []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend(["\ufffd"] * len(pending))
            pending.clear()

    for token in tokens:
        byte = _byte_of(token)
        if byte is None:
            flush()
            out.append(token)
        else:
            pending.append(byte)
    flush()
    return out


def _strip(token: str, content: str, start: int, stop: int) -> str:
    chars = list(token)
    first = 0
    for i, c in enumerate(chars[:start]):
        if c != content:
            break
        first = i + 1
    last = len(chars)
    for i in range(stop):
        index = len(chars) - i - 1
        if index < 0 or chars[index] != content:
            break
        last = index
    return "".join(chars[first:last])


def _make_decoder(spec):
    """tokenizer.json's decoder -> fn([token]) -> [token] (its decode_chain)."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_make_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for step in steps:
                tokens = step(tokens)
            return tokens
        return seq
    if kind == "Replace":
        pattern, content = _string_pattern(spec, "Replace decoder"), spec["content"]
        return lambda tokens: [t.replace(pattern, content) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]
        return lambda tokens: [_strip(t, content, start, stop) for t in tokens]
    raise _refuse("decoder", spec)


def _clean_up_tokenization(text: str) -> str:
    """transformers' `clean_up_tokenization`."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
                 (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


# ---- added tokens ---------------------------------------------------------------

@dataclass(frozen=True)
class _Added:
    content: str
    id: int
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False


class _Matcher:
    """Leftmost-longest matching of a set of patterns, as the aho-corasick
    automaton `tokenizers` builds with MatchKind::LeftmostLongest."""

    def __init__(self, tokens: Sequence[Tuple[str, _Added]]):
        self.by_pattern: Dict[str, _Added] = {}
        for pattern, tok in tokens:
            if pattern:
                self.by_pattern.setdefault(pattern, tok)
        self.lengths = sorted({len(p) for p in self.by_pattern}, reverse=True)
        self.first = {p[0] for p in self.by_pattern}

    def find_iter(self, text: str):
        i = 0
        while i < len(text):
            if text[i] in self.first:
                for n in self.lengths:
                    tok = self.by_pattern.get(text[i:i + n])
                    if tok is not None:
                        yield i, i + n, tok
                        i += n
                        break
                else:
                    i += 1
            else:
                i += 1


def _split_added(text: str, matcher: _Matcher) -> List[Tuple[int, int, Optional[_Added]]]:
    """AddedVocabulary::find_matches: the text cut into (start, end, token
    or None) ranges."""
    if not text:
        return [(0, 0, None)]
    out, offset = [], 0
    for start, stop, tok in matcher.find_iter(text):
        if tok.single_word:
            start_space = start == 0 or not _is_word_char(text[start - 1])
            stop_space = stop == len(text) or not _is_word_char(text[stop])
            if not (start_space and stop_space):
                continue
        if tok.lstrip:
            while start > 0 and text[start - 1] in WHITESPACE:
                start -= 1
        if tok.rstrip:
            while stop < len(text) and text[stop] in WHITESPACE:
                stop += 1
        if offset < start:
            out.append((offset, start, None))
        out.append((start, stop, tok))
        offset = stop
    if offset != len(text):
        out.append((offset, len(text), None))
    return out


# ---- the tokenizer ----------------------------------------------------------------

def _token_content(value) -> Optional[str]:
    return value.get("content") if isinstance(value, dict) else value


class Tokenizer:
    """A `tokenizer.json` (and `tokenizer_config.json`) read by the port."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        self.model = _BPE(spec["model"])
        self.normalizer = _make_normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _make_pre_tokenizer(spec.get("pre_tokenizer"))
        added = [_Added(t["content"], t["id"], t.get("single_word", False), t.get("lstrip", False),
                        t.get("rstrip", False), t.get("normalized", not t.get("special", False)))
                 for t in spec.get("added_tokens", [])]
        self.added_ids = {t.content: t.id for t in added}
        special_names = ("bos_token", "eos_token", "unk_token", "pad_token", "sep_token", "cls_token", "mask_token")
        named = {k: _token_content(config.get(k)) for k in special_names if config.get(k) is not None}
        extra = [_token_content(t) for t in config.get("additional_special_tokens", [])]
        for content in [*named.values(), *extra]:
            if content and content not in self.added_ids:
                # transformers adds the special tokens it is told of: special, not normalized.
                added.append(_Added(content, self.token_to_id(content)))
                self.added_ids[content] = added[-1].id
        self.special_ids = {t["id"] for t in spec.get("added_tokens", []) if t.get("special", False)}
        self.special_ids.update(self.token_to_id(c) for c in [*named.values(), *extra] if c)
        self.decoder = _make_decoder(spec.get("decoder"))
        self.clean_up_spaces = bool(config.get("clean_up_tokenization_spaces", False))
        self.id_to_token = {i: t for t, i in self.model.vocab.items()}
        self.id_to_token.update((t.id, t.content) for t in added)
        self.unk_id = self.token_to_id(self.model.unk) if self.model.unk is not None else None
        self.raw_matcher = _Matcher([(t.content, t) for t in added if not t.normalized])
        self.normalized_matcher = _Matcher([(self.normalizer(_Piece(t.content, [0] * len(t.content))).text, t)
                                            for t in added if t.normalized])
        self.pad_id = self.token_to_id(named["pad_token"]) if "pad_token" in named else None
        self.truncation_side = config.get("truncation_side", "right")
        self.template = self._template(spec.get("post_processor"), config, named)

    def token_to_id(self, content: str) -> int:
        if content in self.added_ids:
            return self.added_ids[content]
        if content in self.model.vocab:
            return self.model.vocab[content]
        raise KeyError(f"tokenizer: {content!r} is not a token")

    def _template(self, spec, config, named) -> List[object]:
        """The single-sequence template: ints (special ids) and None (the
        sequence)."""
        if config.get("tokenizer_class") in GEMMA_LIKE:
            items = []
            if config.get("add_bos_token", True):
                items.append(self.token_to_id(named["bos_token"]))
            items.append(None)
            if config.get("add_eos_token", False):
                items.append(self.token_to_id(named["eos_token"]))
            return items
        if spec is None:
            return [None]
        if spec.get("type") != "TemplateProcessing":
            raise _refuse("post-processor", spec)
        items = []
        for item in spec["single"]:
            if "Sequence" in item:
                items.append(None)
            else:
                items.extend(spec["special_tokens"][item["SpecialToken"]["id"]]["ids"])
        return items

    def _words(self, text: str) -> List[Tuple[Optional[int], str]]:
        """(added token id, None) or (None, word) in order."""
        out: List[Tuple[Optional[int], str]] = []
        for start, end, tok in _split_added(text, self.raw_matcher):
            if tok is not None:
                out.append((tok.id, ""))
                continue
            piece = self.normalizer(_Piece(text[start:end], list(range(start, end))))
            for s, e, ntok in _split_added(piece.text, self.normalized_matcher):
                if ntok is not None:
                    out.append((ntok.id, ""))
                    continue
                out.extend((None, w.text) for w in self.pre_tokenizer(piece.slice(s, e)))
        return out

    def encode_ids(self, text: str) -> List[int]:
        """The text's ids before truncation and the template."""
        ids: List[int] = []
        for tid, word in self._words(text):
            ids.extend([tid] if tid is not None else self.model.encode_word(word))
        return ids

    def encode(self, text: str) -> List[int]:
        """`tokenizer(text)["input_ids"]`: the template around the text's
        ids, no truncation, no padding."""
        seq = self.encode_ids(text)
        return [t for item in self.template for t in (seq if item is None else [item])]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        """`decode(ids, skip_special_tokens=...)`: unknown ids are dropped, as
        `tokenizers` drops them."""
        tokens = [self.id_to_token[i] for i in map(int, ids) if i in self.id_to_token
                  and not (skip_special_tokens and i in self.special_ids)]
        text = "".join(self.decoder(tokens)) if self.decoder is not None else " ".join(tokens)
        return _clean_up_tokenization(text) if self.clean_up_spaces else text

    def __call__(self, prompts: Sequence[str], max_length: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        """`AutoTokenizer(padding_side="left")(prompts, padding="max_length",
        truncation=True, max_length=max_length)`: (input_ids, attention_mask),
        int64 (len(prompts), max_length)."""
        if self.pad_id is None:
            raise ValueError("tokenizer_config.json names no pad_token: cannot pad to max_length")
        n_special = sum(1 for item in self.template if item is not None)
        keep = max_length - n_special
        ids = np.full((len(prompts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for row, prompt in enumerate(prompts):
            seq = self.encode_ids(prompt)
            if len(seq) > keep:
                seq = seq[:keep] if self.truncation_side == "right" else seq[len(seq) - keep:]
            full = [t for item in self.template for t in (seq if item is None else [item])][:max_length]
            ids[row, max_length - len(full):] = full
            mask[row, max_length - len(full):] = 1
        return ids, mask


@lru_cache(maxsize=4)
def _load(path: str, mtime: float) -> Tokenizer:
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as fh:
        spec = json.load(fh)
    config_path = os.path.join(path, "tokenizer_config.json")
    config = {}
    if os.path.exists(config_path):
        with open(config_path, encoding="utf-8") as fh:
            config = json.load(fh)
    return Tokenizer(spec, config)


def has_tokenizer(directory: Optional[str]) -> bool:
    return directory is not None and os.path.isfile(os.path.join(directory, "tokenizer.json"))


def load_tokenizer(directory: str) -> Tokenizer:
    """The tokenizer of `directory` (its tokenizer.json and
    tokenizer_config.json), parsed once per path and file version."""
    path = os.path.abspath(directory)
    return _load(path, os.path.getmtime(os.path.join(path, "tokenizer.json")))


def tokenize(directory: str, prompts: Sequence[str], max_length: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX CLI's tokenizer call on `directory`: left-padded int64 ids
    and mask, (len(prompts), max_length)."""
    return load_tokenizer(directory)(prompts, max_length)
