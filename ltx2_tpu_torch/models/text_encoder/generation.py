"""Text generation with Gemma-3, the prompt enhancement's decode
(counterpart of ltx2_tpu/models/text_encoder/generation.py).

The same Gemma that encodes the prompts generates the enhanced prompt:

- prefill: Gemma's layers (`gemma_layer`) over the left-padded prompt,
  each layer's RoPE'd keys and values written into a KV cache of
  (layers, batch, S + new, kv_heads, head_dim), allocated once and written
  in place;
- decode, one token a step: each layer attends one query row over its
  cache, position j visible iff j <= pos, it is valid (the prompt's mask,
  then each generated position as it is written) and, on a sliding layer,
  pos - j < sliding_window; masked scores are -1e30 and the softmax runs in
  fp32, as the JAX decode's `einsum`s do;
- the LM head is the tied embedding, read in place (fp32 Gemma: one
  product; a bf16 embedding under --gemma-fp8: converted in chunks, never
  copied whole); the matmul weights of an fp8 Gemma are dequantized at use
  by `linear`, as in the encode;
- greedy argmax, or nucleus sampling (`sample_top_p`) at a temperature,
  with EOS latching: once a row emits `eos_id` it emits `pad_id`.

The attention is one query row over the cache: plain torch ops, as the
JAX decode is plain `einsum` (no kernel). The random draws of the sampler
come from a torch.Generator, or are handed in (`uniforms`: the tests hand
in JAX's), so a sampled decode differs from JAX's at the same seed; greedy
decodes agree. Decoding stops early once every row has emitted EOS (the
rest is `pad_id`, as the JAX decode's fixed-length scan writes it).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ltx2_tpu_torch.models.text_encoder.gemma3 import Gemma3, gemma_layer, gemma_rms_norm, rope_tables

NEG = -1e30  # the JAX decode's masked score
LM_HEAD_CHUNK = 32768  # vocabulary rows converted at a time when the embedding is not in the compute dtype
EARLY_STOP_EVERY = 8  # decode steps between checks that every row has emitted EOS (a host sync)
END_OF_TURN_ID = 107  # Gemma's <end_of_turn>, the reference's constant


def lm_logits(model: Gemma3, x: torch.Tensor) -> torch.Tensor:
    """The last hidden state (B, D) -> logits (B, vocab): the final norm,
    then the tied embedding as the LM head, read in place."""
    cfg = model.cfg
    h = gemma_rms_norm(x, model.norm.weight, cfg.rms_norm_eps)
    w = model.embed_tokens.weight
    if w.dtype == h.dtype:
        return F.linear(h, w)
    out = torch.empty(h.shape[0], w.shape[0], dtype=h.dtype, device=h.device)
    for i in range(0, w.shape[0], LM_HEAD_CHUNK):
        out[:, i:i + LM_HEAD_CHUNK] = F.linear(h, w[i:i + LM_HEAD_CHUNK].to(h.dtype))
    return out


def sample_top_p(logits: torch.Tensor, p: float, temperature: float, uniforms: torch.Tensor) -> torch.Tensor:
    """Nucleus sampling, as the JAX package samples: the smallest prefix of
    the probability-sorted tokens whose mass crosses `p` (the crossing token
    kept), renormalized, then the Gumbel-max trick on `uniforms` (B, vocab)
    in [0, 1). logits (B, vocab) -> (B,) int64."""
    logits = logits.float() / max(temperature, 1e-6)
    probs = torch.softmax(logits, dim=-1)
    sorted_idx = torch.sort(-probs, dim=-1, stable=True).indices
    sorted_probs = probs.gather(-1, sorted_idx)
    cum = torch.cumsum(sorted_probs, dim=-1)
    keep = (cum - sorted_probs) <= p  # the first token is always kept
    sorted_probs = torch.where(keep, sorted_probs, torch.zeros((), device=probs.device))
    sorted_probs = sorted_probs / sorted_probs.sum(dim=-1, keepdim=True)
    gumbel = -torch.log(-torch.log(uniforms.float() + 1e-10) + 1e-10)
    choice = torch.argmax(torch.log(sorted_probs + 1e-10) + gumbel, dim=-1)
    return sorted_idx.gather(-1, choice[:, None])[:, 0]


@torch.no_grad()
def gemma3_generate(
    model: Gemma3,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    max_new_tokens: int,
    eos_id: int,
    pad_id: int = 0,
    temperature: float = 0.0,
    top_p: float = 0.0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    return_logits: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Decode -> (B, max_new_tokens) int64 token ids, `pad_id` after EOS.

    `input_ids` and `attention_mask` (B, S) are LEFT-padded: the first new
    token comes from the last position, which must be a real token.
    `temperature` and `top_p` both above 0 sample (`sample_top_p`), the i-th
    picked token from `uniforms[i]` ((max_new_tokens, B, vocab)) when given,
    else from draws of `generator`; otherwise greedy argmax. With
    `return_logits` also the fp32 logits each pick was made from, (B, picks,
    vocab)."""
    cfg = model.cfg
    device, dtype = model.embed_tokens.weight.device, cfg.dtype
    input_ids, attention_mask = input_ids.to(device), attention_mask.to(device).bool()
    b, s = input_ids.shape
    heads, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    groups = heads // kv
    cache_len = s + max_new_tokens
    do_sample = temperature > 0.0 and top_p > 0.0
    scale = torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype, device=device)
    positions = torch.arange(cache_len, device=device)
    tables = {"sliding_attention": rope_tables(positions, d, cfg.sliding_rope_theta, cfg.sliding_rope_scaling_factor),
              "full_attention": rope_tables(positions, d, cfg.full_rope_theta, cfg.full_rope_scaling_factor)}
    cache_k = torch.zeros((cfg.num_hidden_layers, b, cache_len, kv, d), dtype=dtype, device=device)
    cache_v = torch.zeros_like(cache_k)
    logits_seen: List[torch.Tensor] = []

    def pick(i: int, logits: torch.Tensor) -> torch.Tensor:
        if return_logits:
            logits_seen.append(logits.float())
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        u = uniforms[i].to(device) if uniforms is not None else torch.rand(
            logits.shape, generator=generator, device=device)
        return sample_top_p(logits, top_p, temperature, u)

    # ---- prefill: causal AND padding [AND window], -1e30 where masked.
    idx = torch.arange(s, device=device)
    full = (idx[None, :] <= idx[:, None])[None, None] & attention_mask[:, None, None, :]
    masks = {"full_attention": full, "sliding_attention": full & ((idx[:, None] - idx[None, :]) < cfg.sliding_window)}
    zero, neg = torch.zeros((), dtype=dtype, device=device), torch.tensor(NEG, dtype=dtype, device=device)
    masks = {kind: torch.where(m, zero, neg) for kind, m in masks.items()}
    x = F.embedding(input_ids, model.embed_tokens.weight).to(dtype) * scale
    for i, (layer, kind) in enumerate(zip(model.layers, cfg.layer_types)):
        def prefill(q, k, v, i=i, mask=masks[kind]):
            cache_k[i, :, :s] = k.transpose(1, 2)
            cache_v[i, :, :s] = v.transpose(1, 2)
            if groups > 1:
                k, v = k.repeat_interleave(groups, dim=1), v.repeat_interleave(groups, dim=1)
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * d ** -0.5
            weights = torch.softmax((scores + mask).float(), dim=-1).to(q.dtype)
            return torch.einsum("bhqk,bhkd->bhqd", weights, v)

        cos, sin = tables[kind]
        x = gemma_layer(layer, cfg, x, cos[:s], sin[:s], prefill)
    tok = pick(0, lm_logits(model, x[:, -1]))
    del x

    # ---- decode: one token a step over the cache.
    valid = torch.zeros((b, cache_len), dtype=torch.bool, device=device)
    valid[:, :s] = attention_mask
    j = torch.arange(cache_len, device=device)
    pad = torch.full((), pad_id, dtype=torch.long, device=device)
    tokens = torch.full((b, max_new_tokens), pad_id, dtype=torch.long, device=device)
    done = torch.zeros(b, dtype=torch.bool, device=device)
    for t in range(max_new_tokens):
        tokens[:, t] = torch.where(done, pad, tok)
        done = done | (tok == eos_id)
        if t == max_new_tokens - 1 or ((t + 1) % EARLY_STOP_EVERY == 0 and bool(done.all())):
            break
        pos = s + t
        valid[:, pos] = True
        h = F.embedding(tok[:, None], model.embed_tokens.weight).to(dtype) * scale
        allow = (j <= pos) & valid
        allows = {"full_attention": allow, "sliding_attention": allow & ((pos - j) < cfg.sliding_window)}
        for i, (layer, kind) in enumerate(zip(model.layers, cfg.layer_types)):
            def step(q, k, v, i=i, allow=allows[kind]):
                cache_k[i, :, pos] = k[:, :, 0]
                cache_v[i, :, pos] = v[:, :, 0]
                qg = q[:, :, 0].reshape(b, kv, groups, d)
                scores = torch.einsum("bkgd,btkd->bkgt", qg, cache_k[i]) * d ** -0.5
                scores = torch.where(allow[:, None, None, :], scores, neg)
                weights = torch.softmax(scores.float(), dim=-1).to(dtype)
                return torch.einsum("bkgt,btkd->bkgd", weights, cache_v[i]).reshape(b, heads, 1, d)

            cos, sin = tables[kind]
            h = gemma_layer(layer, cfg, h, cos[pos:pos + 1], sin[pos:pos + 1], step)
        tok = torch.where(done, pad, pick(t + 1, lm_logits(model, h[:, 0])))
    if return_logits:
        return tokens, torch.stack(logits_seen, dim=1)
    return tokens


def gemma3_greedy_generate(model: Gemma3, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                           max_new_tokens: int, eos_id: int, pad_id: int = 0) -> torch.Tensor:
    """Greedy `gemma3_generate`."""
    return gemma3_generate(model, input_ids, attention_mask, max_new_tokens=max_new_tokens, eos_id=eos_id,
                           pad_id=pad_id)


def resolve_end_of_turn_id(tokenizer) -> int:
    """The chat decode's stop token: <end_of_turn> (Gemma-3 closes its reply
    with it and seldom emits <eos>), by its id in `tokenizer`, else the
    reference's 107."""
    try:
        cand = tokenizer.token_to_id("<end_of_turn>")
    except KeyError:
        return END_OF_TURN_ID
    return END_OF_TURN_ID if cand == tokenizer.unk_id else cand


def generate_text(
    model: Gemma3,
    tokenizer,
    prompt: str,
    max_new_tokens: int = 256,
    pad_multiple: int = 64,
    temperature: float = 0.0,
    top_p: float = 0.0,
    seed: int = 42,
    uniforms: Optional[torch.Tensor] = None,
) -> str:
    """Tokenize (the template's BOS, no padding) -> decode -> detokenize,
    as the JAX function does: the prompt is left-padded with id 0 to a
    multiple of `pad_multiple`, the decode stops at <end_of_turn>, and the
    ids before it (pad ids dropped) are decoded with the special tokens
    skipped. Sampling (temperature and top_p above 0) draws from a
    generator seeded with `seed`, or takes `uniforms`."""
    ids = tokenizer.encode(prompt)
    pad = -len(ids) % pad_multiple
    input_ids = torch.tensor([[0] * pad + ids], dtype=torch.long)
    mask = torch.tensor([[0] * pad + [1] * len(ids)], dtype=torch.long)
    eos_id = resolve_end_of_turn_id(tokenizer)
    device = model.embed_tokens.weight.device
    tokens = gemma3_generate(model, input_ids, mask, max_new_tokens=max_new_tokens, eos_id=eos_id, pad_id=0,
                             temperature=temperature, top_p=top_p, uniforms=uniforms,
                             generator=torch.Generator(device=device).manual_seed(seed))
    out: Sequence[int] = tokens[0].tolist()
    if eos_id in out:
        out = out[: out.index(eos_id)]
    return tokenizer.decode([t for t in out if t != 0], skip_special_tokens=True)
