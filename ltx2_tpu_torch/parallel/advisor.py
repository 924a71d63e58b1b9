"""The layout advisor: the best (tp, sp, pp) layout of the DiT for N ranks
(counterpart of ltx2_tpu/parallel/advisor.py, behind `--auto-shard N`).

The model is the JAX package's per denoise step, with the port's schedule:
- compute_s = the step's FLOPs (utils/flops.py) / ranks / the card's peak,
  times the GPipe bubble (m + P - 1) / m when the blocks are staged (m the
  guidance rows, the microbatches);
- comm_s = each rank's wire bytes / the route's bandwidth, the bytes of
  (a) the Megatron all-reduce of every row-parallel product, walked from
  the port's sharding rules over a DiT built on the meta device (no
  memory), (b) the ring's K/V exchanges under SP, (c) the pipeline's
  activation hops, each carrying a rank's n_tokens / sp tokens, m a
  stage (each real microbatch once);
- step_s = max(compute_s, comm_s) when every collective of the layout
  overlaps the blocks' compute, else compute_s + comm_s.

The constants are the card's, not a v5e's: the H100 SXM's dense bf16 peak
(989 TFLOP/s), and by the world's route NVLink 4's published 450 GB/s a
direction for nccl across cards (not measured: the machines that ran the
port have had one card), or for ranks that share one card over gloo the
rate `chip_smoke.py` measured through pinned host memory. What overlaps is
what the port's code does: the ring starts the next K/V exchange before it
attends the current block; the TP all-reduce and the pipeline's hop wait.

The advisor knows no pipeline: the caller hands in the request's token
count, its guidance rows and the other token counts SP must divide, which
each pipeline class states (`CFG_ROW`, `stage_token_counts`) and
`generate.apply_auto_shard` gathers. Where the port departs from the JAX
package's model (ROADMAP.md section 3): under PP x SP a hop carries the
rank's token shard, where the JAX advisor (:221) charges the whole
sequence; a stage sends m hops, where the JAX schedule's bubble ticks make
m + P - 2; the TP all-reduce does not overlap. The header peek also reads
the heads from the reference metadata's "transformer" entry, where the JAX
peek reads the top level alone.
"""

from __future__ import annotations

import dataclasses
import re
from functools import lru_cache
from typing import List, Optional, Tuple

from ltx2_tpu_torch.utils.flops import H100_BF16_PEAK_TFLOPS, dit_step_flops

# The routes' bandwidths, bytes a second each way.
NVLINK4_BYTES_PER_S = 450e9  # published; not measured (one card so far)
# Two ranks on one card over gloo, each send staged through pinned host
# memory: chip_smoke.py's phase_scale_out timed a 50 MB activation hop
# both ways at 51.6-51.7 ms a hop in one run and 25.4-25.9 ms in another,
# on "NVIDIA H100 80GB HBM3, 700.00 W"; the slower run's rate is taken.
GLOO_STAGED_BYTES_PER_S = 1.015e9
ROUTE_BYTES_PER_S = {"nccl": NVLINK4_BYTES_PER_S, "gloo_staged": GLOO_STAGED_BYTES_PER_S,
                     "gloo": GLOO_STAGED_BYTES_PER_S}

# Which collectives overlap the blocks' compute in the port's code.
OVERLAPPABLE_COLLECTIVES = {
    "tp_allreduce": False,  # ops.common.linear_row_parallel waits for the sum
    "sp_ppermute": True,  # ring_attention_local starts the next exchange first
    "pp_ppermute": False,  # a stage waits for its microbatch's activations
}


def route_of_backend(backend: Optional[str], device=None) -> str:
    """The route the DiT's collectives take: "nccl" unless the world runs
    gloo (then "gloo_staged" on the card, "gloo" on the CPU)."""
    if backend == "gloo":
        return "gloo" if device is not None and str(device).startswith("cpu") else "gloo_staged"
    return "nccl"


# ---------------------------------------------------------------- volumes
def tp_allreduce_bytes(named_shapes, rows: int, n_tokens: int, dtype_bytes: int):
    """Every row-parallel linear weight (in-features split over 'model')
    makes one all-reduce of its output (rows, n_tokens, out_features) each
    time it is used. `named_shapes`: (dotted name, shape) of each tensor.
    Returns (the step's payload bytes, [(name, out, bytes), ...])."""
    from ltx2_tpu_torch.parallel.mesh import MODEL_AXIS
    from ltx2_tpu_torch.parallel.sharding import spec_for_path

    total, entries = 0, []
    for name, shape in named_shapes:
        if not name.endswith(".weight") or len(shape) != 2:
            continue
        if spec_for_path(name) != (None, MODEL_AXIS):
            continue
        payload = rows * n_tokens * shape[0] * dtype_bytes
        total += payload
        entries.append((name, shape[0], payload))
    return total, entries


def sp_ring_bytes(cfg, rows: int, n_tokens: int, sp: int, dtype_bytes: int) -> int:
    """Ring self-attention: each rank holds the K and V of n_tokens / sp
    tokens and passes them on sp - 1 times a self-attention, a block."""
    inner = cfg.num_attention_heads * cfg.attention_head_dim
    kv_chunk = 2 * rows * inner * (n_tokens // sp) * dtype_bytes
    return cfg.num_layers * (sp - 1) * kv_chunk


def pp_permute_bytes(cfg, rows: int, n_tokens: int, microbatches: int, dtype_bytes: int) -> int:
    """The pipeline's activation bytes a rank sends: each stage but the last
    sends each of the m microbatches once, a (rows / m, n_tokens, D)
    activation a hop (n_tokens the rank's own under SP)."""
    inner = cfg.num_attention_heads * cfg.attention_head_dim
    act = (rows // microbatches or 1) * n_tokens * inner * dtype_bytes
    return microbatches * act


def ring_allreduce_wire_bytes(payload, n: int) -> float:
    """A rank's wire bytes of a ring all-reduce of `payload`: 2 X (n - 1) / n."""
    return 2 * payload * (n - 1) / n


@lru_cache(maxsize=8)
def _allreduce_payload_units(cfg) -> int:
    """Sum of out_features over the row-parallel weights of `cfg`'s DiT (the
    request-independent factor of the TP payload), walked from the port's
    sharding rules over the DiT built on the meta device."""
    from ltx2_tpu_torch.models.transformer.model import LTXModel

    model = LTXModel(dataclasses.replace(cfg, tp_axis=None, sequence_axis=None), device="meta")
    total, _ = tp_allreduce_bytes(((n, tuple(p.shape)) for n, p in model.named_parameters()), 1, 1, 1)
    return total


# ---------------------------------------------------------------- estimates
@dataclasses.dataclass(frozen=True)
class LayoutEstimate:
    tp: int
    sp: int
    pp: int
    devices: int
    compute_s: float
    comm_s: float
    step_s: float
    wire_bytes: float
    overlapped: bool
    detail: str

    @property
    def name(self) -> str:
        parts = [f"{k}{v}" for k, v in (("SP", self.sp), ("TP", self.tp), ("PP", self.pp)) if v > 1]
        return " x ".join(parts) or "single-chip"

    def justification(self, n_tokens: int) -> str:
        return (f"--auto-shard: {self.name} over {self.devices} chips at {n_tokens} tokens — modeled step "
                f"{self.step_s * 1e3:.0f} ms (compute {self.compute_s * 1e3:.0f} ms, comm {self.comm_s * 1e3:.0f} ms"
                f"{', overlapped' if self.overlapped else ''}; {self.detail})")


def estimate_layout(cfg, n_tokens: int, rows: int, tp: int, sp: int, pp: int, dtype_bytes: int = 2,
                    step_flops: Optional[float] = None, peak_tflops: float = H100_BF16_PEAK_TFLOPS,
                    bytes_per_s: float = NVLINK4_BYTES_PER_S) -> LayoutEstimate:
    """The modelled step of one (tp, sp, pp) layout at this request."""
    if step_flops is None:
        step_flops = dit_step_flops(cfg, n_tokens, 1024, rows=rows)
    devices = tp * sp * pp
    wire, detail = 0.0, []
    overlapped = devices > 1
    if tp > 1:
        payload = _allreduce_payload_units(cfg) * rows * n_tokens * dtype_bytes / sp
        wire_tp = ring_allreduce_wire_bytes(payload, tp)
        wire += wire_tp
        detail.append(f"TP all-reduce {wire_tp / 1e9:.1f} GB wire")
        overlapped &= OVERLAPPABLE_COLLECTIVES["tp_allreduce"]
    if sp > 1:
        wire_sp = sp_ring_bytes(cfg, rows, n_tokens, sp, dtype_bytes)
        wire += wire_sp
        detail.append(f"ring ppermute {wire_sp / 1e9:.1f} GB wire")
        overlapped &= OVERLAPPABLE_COLLECTIVES["sp_ppermute"]
    microbatches = max(rows, 1)
    bubble = 1.0
    if pp > 1:
        wire_pp = pp_permute_bytes(cfg, rows, n_tokens // sp, microbatches, dtype_bytes)
        wire += wire_pp
        bubble = (microbatches + pp - 1) / microbatches
        detail.append(f"GPipe {wire_pp / 1e9:.2f} GB wire, bubble {bubble:.2f}x")
        overlapped &= OVERLAPPABLE_COLLECTIVES["pp_ppermute"]
    compute_s = step_flops / devices / (peak_tflops * 1e12) * bubble
    comm_s = wire / bytes_per_s
    if devices == 1:
        overlapped = False
    step_s = max(compute_s, comm_s) if overlapped else compute_s + comm_s
    return LayoutEstimate(tp=tp, sp=sp, pp=pp, devices=devices, compute_s=compute_s, comm_s=comm_s, step_s=step_s,
                          wire_bytes=wire, overlapped=overlapped, detail="; ".join(detail) or "no collectives")


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_layouts(cfg, n_devices: int, n_tokens: int, extra_sp_constraints: Tuple[int, ...] = ()
                      ) -> List[Tuple[int, int, int]]:
    """Every (tp, sp, pp) of n_devices ranks the parallel layer takes: TP
    splits the heads, SP the tokens (n_tokens and every count of
    `extra_sp_constraints`), PP whole blocks."""
    out = []
    for tp in _divisors(n_devices):
        if cfg.num_attention_heads % tp:
            continue
        rest = n_devices // tp
        for sp in _divisors(rest):
            if n_tokens % sp or any(c % sp for c in extra_sp_constraints):
                continue
            pp = rest // sp
            if cfg.num_layers % pp:
                continue
            out.append((tp, sp, pp))
    return out


def choose(cfg, n_devices: int, n_tokens: int, rows: int = 2, dtype_bytes: int = 2,
           extra_sp_constraints: Tuple[int, ...] = (), peak_tflops: float = H100_BF16_PEAK_TFLOPS,
           bytes_per_s: float = NVLINK4_BYTES_PER_S) -> Tuple[LayoutEstimate, List[LayoutEstimate]]:
    """The best modelled layout and the ranked table."""
    candidates = enumerate_layouts(cfg, n_devices, n_tokens, extra_sp_constraints=extra_sp_constraints)
    if not candidates:
        raise ValueError(f"no (tp, sp, pp) layout of {n_devices} devices satisfies the divisibility constraints at "
                         f"{n_tokens} tokens / {cfg.num_attention_heads} heads / {cfg.num_layers} layers")
    step_flops = dit_step_flops(cfg, n_tokens, 1024, rows=rows)
    estimates = [estimate_layout(cfg, n_tokens, rows, tp, sp, pp, dtype_bytes=dtype_bytes, step_flops=step_flops,
                                 peak_tflops=peak_tflops, bytes_per_s=bytes_per_s) for tp, sp, pp in candidates]
    # Ties: fewer mesh axes first, then more SP.
    estimates.sort(key=lambda e: (e.step_s, (e.tp > 1) + (e.sp > 1) + (e.pp > 1), -e.sp))
    return estimates[0], estimates


def flagship_serving_config():
    """The 48-block video DiT the advisor models when the checkpoint's
    architecture is not read (the published widths)."""
    from ltx2_tpu_torch.models.transformer.model import LTXModelConfig, LTXModelType

    return LTXModelConfig(model_type=LTXModelType.VideoOnly, num_attention_heads=32, attention_head_dim=128,
                          in_channels=128, out_channels=128, num_layers=48, cross_attention_dim=4096,
                          caption_channels=None, compute_dtype="bfloat16", remat=False)


def video_token_count(frames: int, height: int, width: int) -> int:
    """A pixel shape's DiT token count (8x temporal causal, 32x spatial)."""
    return ((frames - 1) // 8 + 1) * (height // 32) * (width // 32)


def peek_checkpoint_arch(path: str) -> Tuple[Optional[int], Optional[int]]:
    """(blocks, heads) of a checkpoint's DiT from its header alone: the
    blocks from the largest transformer_blocks index of its tensor names,
    the heads from the metadata's config; (None, None) where it cannot
    tell, and the caller keeps its default."""
    layers = heads = None
    try:
        from ltx2_tpu_torch.loader.safetensors_io import SafetensorsFile
        from ltx2_tpu_torch.loader.weight_loader import read_checkpoint_config

        f = SafetensorsFile(path)
        try:
            idx = [int(m.group(1)) for k in f.keys() for m in (re.search(r"transformer_blocks\.(\d+)\.", k),) if m]
        finally:
            f.close()
        if idx:
            layers = max(idx) + 1
        blob = read_checkpoint_config(path)
        h = blob.get("num_attention_heads") or blob.get("transformer", {}).get("num_attention_heads")
        heads = int(h) if h else None
    except Exception:  # noqa: BLE001 - an unreadable header leaves the defaults
        pass
    return layers, heads
