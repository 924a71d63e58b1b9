"""Analytic FLOP count of the DiT (the port's copy of the part of
ltx2_tpu/utils/flops.py the layout advisor reads; the JAX module imports no
JAX, but the port imports nothing of that package).

Counts the dense matmuls a forward executes, 1 MAC = 2 FLOPs; elementwise
and norm work is left out (under 1 % of the matmuls at these shapes). The
card's peak is the H100 SXM's dense bf16 rate, the figure PERF.md's bounds
use.
"""

from __future__ import annotations

H100_BF16_PEAK_TFLOPS = 989.0  # H100 SXM, dense bf16 (NVIDIA's data sheet)


def _attn_flops(n_q: int, n_kv: int, inner_dim: int) -> int:
    """QK^T + PV of one attention call at full density."""
    return 2 * 2 * n_q * n_kv * inner_dim


def dit_step_flops(
    cfg,
    n_video_tokens: int,
    n_text_tokens: int,
    n_audio_tokens: int = 0,
    rows: int = 1,
    text_kv_cached: bool = False,
) -> int:
    """FLOPs of one x0 forward of the DiT `cfg` (an LTXModelConfig): each
    block's self-attention, text cross-attention, audio<->video
    cross-attention and FFNs, and the input projection; `rows` multiplies
    everything (the guidance rows)."""
    d_v = cfg.num_attention_heads * cfg.attention_head_dim
    n = n_video_tokens
    s = n_text_tokens
    ctx = cfg.cross_attention_dim

    per_block = 4 * 2 * n * d_v * d_v + _attn_flops(n, n, d_v)
    per_block += 2 * 2 * n * d_v * d_v + _attn_flops(n, s, d_v)
    if not text_kv_cached:
        per_block += 2 * 2 * s * ctx * d_v
    per_block += 2 * 2 * n * d_v * (4 * d_v)

    if n_audio_tokens:
        d_a = cfg.audio_inner_dim
        na = n_audio_tokens
        per_block += 4 * 2 * na * d_a * d_a + _attn_flops(na, na, d_a)
        per_block += 2 * 2 * na * d_a * d_a + _attn_flops(na, s, d_a)
        if not text_kv_cached:
            per_block += 2 * 2 * s * ctx * d_a
        per_block += 2 * 2 * na * d_a * (4 * d_a)
        per_block += 2 * 2 * na * d_a * d_a + 2 * 2 * n * d_v * d_a + _attn_flops(na, n, d_a)
        per_block += 2 * 2 * n * d_v * d_v + 2 * 2 * na * d_a * d_v + _attn_flops(n, na, d_v)

    total = cfg.num_layers * per_block
    total += 2 * 2 * n * cfg.in_channels * d_v
    if n_audio_tokens:
        total += 2 * 2 * n_audio_tokens * cfg.audio_in_channels * cfg.audio_inner_dim
    return total * rows
