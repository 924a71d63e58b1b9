"""Fine-tune the video DiT with rectified flow on one GPU.

The single-device path of the JAX package's `scripts/train.py`: random
weights from `--seed` (no checkpoints here), LoRA adapters (`--lora-rank`)
or a trainable regex (`--trainable`), AdamW with global-norm clipping, an
optional LR warmup/decay, EMA and a held-out validation loss, per-block
remat. Every attention call of the forward, the remat recompute and the
backward runs on the hand-written flash-attention kernels.

Data: an .npz with video arrays
    x0         (N, tokens, C)    clean patchified video latents
    positions  (N, 3, tokens, 2) RoPE position bounds
    context    (N, S, D_ctx)     text embeddings
or `--synthetic F H W`, a random dataset at that latent shape with 32
context tokens (as scripts/train.py builds it).

    python -m ltx2_tpu_torch.train --synthetic 16 16 24 --lora-rank 16 --steps 3

The model is the full-width LTX-2.0 video DiT (`--layers` blocks, 48 by
default); `--placeholder` takes scripts/train.py's tiny config instead (4
heads x 32, 128-d context); `--checkpoint` loads the base DiT from a
reference-format checkpoint through `ModelLedger` (bf16, remat on).
`--save` writes, with `--lora-rank`, the adapters as a reference-format LoRA
file (`generate.py --lora` fuses it back), otherwise the trained DiT as a
reference-format checkpoint carrying the source checkpoint's other tensors
and metadata. Not ported yet, so absent: `--save-state` / `--resume`, the
fp8 frozen base, audio, and the TP/DP/ZeRO/FSDP mesh flags.

    python -m ltx2_tpu_torch.train --checkpoint ltx-2.safetensors --data lat.npz --lora-rank 16 \
        --save adapter.safetensors
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.generate import make_dit
from ltx2_tpu_torch.loader.export import export_transformer_checkpoint
from ltx2_tpu_torch.loader.safetensors_io import read_metadata
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig
from ltx2_tpu_torch.ops.rope import create_position_grid
from ltx2_tpu_torch.training import (
    TrainBatch,
    TrainConfig,
    ema_params,
    init_ema,
    make_ema_update,
    make_eval_step,
    make_optimizer,
    make_train_step,
    trainable_mask,
)
from ltx2_tpu_torch.training.lora import add_lora_params_, export_lora_checkpoint, lora_trainable_mask
from ltx2_tpu_torch.utils.model_ledger import ModelLedger

# scripts/train.py's --placeholder DiT.
PLACEHOLDER_CONFIG = LTXModelConfig(num_attention_heads=4, attention_head_dim=32, num_layers=4,
                                    cross_attention_dim=128)
SYNTHETIC_CONTEXT_TOKENS = 32
# scripts/bench_train.py's flagship shape: 16x16x24 latents = 6144 tokens
# against 1024 text tokens.
BENCH_SHAPE, BENCH_CONTEXT_TOKENS = (16, 16, 24), 1024


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--placeholder", action="store_true", help="tiny random DiT (CPU tests)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference-format checkpoint of the base DiT (loaded in bf16 through ModelLedger)")
    p.add_argument("--save", type=str, default=None,
                   help="write the LoRA adapter (with --lora-rank) or the fine-tuned checkpoint here")
    p.add_argument("--layers", type=int, default=None, help="DiT blocks (default: 48, placeholder 4)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--data", type=str, default=None, help=".npz with x0/positions/context arrays")
    p.add_argument("--synthetic", type=int, nargs=3, metavar=("F", "H", "W"), default=None,
                   help="random dataset at latent shape FxHxW")
    p.add_argument("--synthetic-samples", type=int, default=8)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip", type=float, default=1.0, help="global-norm gradient clip; 0 disables clipping")
    p.add_argument("--lora-rank", type=int, default=0, help="train LoRA adapters of this rank")
    p.add_argument("--lora-alpha", type=float, default=None, help="LoRA scale numerator (default: rank)")
    p.add_argument("--trainable", type=str, default=None,
                   help="regex over dotted parameter names; the rest freezes (e.g. 'attn')")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="microbatches per update, gradients accumulated in fp32")
    p.add_argument("--warmup-steps", type=int, default=0, help="linear LR warmup from 0 over this many steps")
    p.add_argument("--lr-schedule", choices=("constant", "cosine", "linear"), default="constant")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an fp32 EMA of the trained weights and end on it; 0 disables")
    p.add_argument("--val-fraction", type=float, default=0.0, help="hold out this tail fraction for validation")
    p.add_argument("--eval-every", type=int, default=50)
    return p


def make_model(layers: Optional[int], device: torch.device, seed: int, placeholder: bool = False,
               checkpoint: Optional[str] = None) -> LTXModel:
    """The DiT to train, remat on: from `checkpoint` (bf16), else full width
    (or the placeholder) with random weights from `seed`."""
    if checkpoint:
        model = ModelLedger(checkpoint_path=checkpoint, device=device).transformer()
        model.cfg = dataclasses.replace(model.cfg, remat=True)
        return model
    base = PLACEHOLDER_CONFIG if placeholder else LTXModelConfig()
    return make_dit(base.num_layers if layers is None else layers, device, seed=seed, base=base)


def save(args, model: LTXModel) -> None:
    """--save: the adapters as a LoRA file with --lora-rank, else the whole
    DiT as a reference-format checkpoint carrying the source checkpoint's
    other tensors and metadata."""
    if args.lora_rank:
        export_lora_checkpoint(args.save, model)
    else:
        metadata = read_metadata(args.checkpoint) if args.checkpoint else None
        export_transformer_checkpoint(args.save, model, metadata=metadata or None, carry_from=args.checkpoint)
    _log({"saved": args.save, "kind": "lora" if args.lora_rank else "checkpoint"})


def synthetic_dataset(frames: int, height: int, width: int, samples: int, cfg: LTXModelConfig, seed: int,
                      context_tokens: int = SYNTHETIC_CONTEXT_TOKENS) -> Tuple[np.ndarray, ...]:
    """(x0, positions, context) numpy arrays of a random dataset, drawn as
    scripts/train.py draws them."""
    rng = np.random.RandomState(seed)
    grid = create_position_grid(1, frames, height, width).numpy().astype(np.float32)
    pos = np.stack([grid, grid + 1], axis=-1)
    x0s = rng.randn(samples, frames * height * width, cfg.in_channels).astype(np.float32)
    poss = np.repeat(pos, samples, axis=0)
    ctx_width = cfg.caption_channels or cfg.cross_attention_dim  # the DiT's text input
    ctxs = rng.randn(samples, context_tokens, ctx_width).astype(np.float32) * 0.1
    return x0s, poss, ctxs


def dit_forward_flops(cfg: LTXModelConfig, video_tokens: int, text_tokens: int) -> int:
    """FLOP of one forward of the video DiT for one sample: per block the
    self-attention projections and attention, text cross-attention (q/out
    projections, k/v from the context, attention) and the 4x FFN, plus the
    patchify projection; elementwise work omitted (the count of the JAX
    package's utils/flops.py::dit_step_flops, video only)."""
    d, n, s = cfg.video_inner_dim, video_tokens, text_tokens
    per_block = 4 * 2 * n * d * d + 4 * n * n * d
    per_block += 2 * 2 * n * d * d + 4 * n * s * d + 2 * 2 * s * cfg.cross_attention_dim * d
    per_block += 2 * 2 * n * d * 4 * d
    return cfg.num_layers * per_block + 2 * 2 * n * cfg.in_channels * d


def make_batch(arrays: Tuple[np.ndarray, ...], idx, device: torch.device) -> TrainBatch:
    x0, pos, ctx = (torch.from_numpy(np.ascontiguousarray(a[idx])).to(device) for a in arrays)
    return TrainBatch(x0=x0, positions=pos, context=ctx)


def bench_step(model: LTXModel, device: torch.device):
    """scripts/bench_train.py's step on `model`'s trainable parameters:
    uniform sigmas, AdamW, one synthetic sample at BENCH_SHAPE with
    BENCH_CONTEXT_TOKENS text tokens. Returns (step, batch, FLOP per step at
    bench_train's LoRA rule: 3 x the forward, i.e. forward, remat
    recompute and the input-gradient half of the backward)."""
    tc = TrainConfig(logit_normal_loc=None)
    step = make_train_step(model, make_optimizer(tc, [p for p in model.parameters() if p.requires_grad]), tc)
    arrays = synthetic_dataset(*BENCH_SHAPE, 1, model.cfg, seed=0, context_tokens=BENCH_CONTEXT_TOKENS)
    tokens = BENCH_SHAPE[0] * BENCH_SHAPE[1] * BENCH_SHAPE[2]
    return step, make_batch(arrays, [0], device), 3 * dit_forward_flops(model.cfg, tokens, BENCH_CONTEXT_TOKENS)


def _dataset(args, cfg: LTXModelConfig):
    if args.data:
        data = np.load(args.data)
        if any(k.startswith("audio_") for k in data.files):
            raise NotImplementedError("audio-video training is not ported yet: the dataset carries audio arrays")
        return data["x0"], data["positions"], data["context"]
    if args.synthetic:
        return synthetic_dataset(*args.synthetic, args.synthetic_samples, cfg, args.seed)
    raise SystemExit("pass --data latents.npz or --synthetic F H W")


def select_trainable(model: LTXModel, args, device: torch.device) -> Tuple[list, int]:
    """Adapters and requires_grad per the flags; returns (trainable
    names, adapters added)."""
    if args.trainable and args.lora_rank:
        raise SystemExit("--trainable and --lora-rank are mutually exclusive")
    if args.lora_rank:
        alpha = args.lora_alpha if args.lora_alpha is not None else float(args.lora_rank)
        n = add_lora_params_(model, torch.Generator(device=device).manual_seed(args.seed + 100),
                             rank=args.lora_rank, alpha=alpha)
        return lora_trainable_mask(model), n
    pat = re.compile(args.trainable or "")
    return trainable_mask(model, lambda name: bool(pat.search(name))), 0


def _log(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None, on_step: Optional[Callable[[int, LTXModel, float], None]] = None) -> dict:
    """Train per the flags; returns {"model", "trainable", "adapters",
    "losses", "step_s", "val_losses"}. `on_step(i, model, loss)` runs after
    every optimizer step."""
    args = build_parser().parse_args(argv)
    if args.grad_clip < 0:
        raise SystemExit("--grad-clip must be >= 0 (0 disables clipping)")
    if args.ema_decay and not 0.0 < args.ema_decay < 1.0:
        raise SystemExit("--ema-decay must be in (0, 1)")
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.checkpoint and (args.placeholder or args.layers is not None):
        raise SystemExit("--checkpoint sets the model: drop --placeholder and --layers")
    model = make_model(args.layers, device, args.seed, args.placeholder, args.checkpoint)
    names, n_adapters = select_trainable(model, args, device)
    params = [p for p in model.parameters() if p.requires_grad]
    _log({"model_layers": model.cfg.num_layers, "width": model.cfg.video_inner_dim, "adapters": n_adapters,
          "trainable_tensors": len(names), "trainable_params": sum(p.numel() for p in params)})

    arrays = _dataset(args, model.cfg)
    val = None
    if args.val_fraction > 0:
        n_val = max(1, int(round(arrays[0].shape[0] * args.val_fraction)))
        if n_val >= arrays[0].shape[0]:
            raise SystemExit(f"--val-fraction {args.val_fraction} leaves no training data")
        val = tuple(a[-n_val:] for a in arrays)
        arrays = tuple(a[:-n_val] for a in arrays)
    n_samples = arrays[0].shape[0]

    tc = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        grad_clip_norm=args.grad_clip if args.grad_clip > 0 else None,
        warmup_steps=args.warmup_steps, lr_schedule=args.lr_schedule, total_steps=args.steps,
    )
    optimizer = make_optimizer(tc, params)
    step = make_train_step(model, optimizer, tc, accum_steps=args.accum_steps)
    ema = ema_update = None
    if args.ema_decay:
        ema, ema_update = init_ema(params), make_ema_update(args.ema_decay)

    eval_step, val_losses = make_eval_step(model, tc), []

    def eval_loss() -> float:
        vbs = args.batch_size
        reps = -(-vbs // val[0].shape[0])  # repeat-pad a tiny validation set to one batch
        vals = tuple(np.tile(a, (reps,) + (1,) * (a.ndim - 1)) for a in val)
        n_batches = vals[0].shape[0] // vbs
        total = 0.0
        for j in range(n_batches):
            gen = torch.Generator(device=device).manual_seed(args.seed + 7000 + j)
            total += float(eval_step(make_batch(vals, slice(j * vbs, (j + 1) * vbs), device), gen))
        return total / n_batches

    rng = np.random.RandomState(args.seed + 1)
    losses, step_s = [], []
    for i in range(args.steps):
        batch = make_batch(arrays, rng.randint(0, n_samples, size=args.batch_size), device)
        t0 = time.perf_counter()
        loss = float(step(batch, torch.Generator(device=device).manual_seed(args.seed + 2 + i)))
        step_s.append(time.perf_counter() - t0)  # float() waited for the device
        losses.append(loss)
        if ema is not None:
            ema_update(ema, params)
        if on_step is not None:
            on_step(i, model, loss)
        if i % args.log_every == 0 or i == args.steps - 1:
            _log({"step": i, "loss": loss, "step_s": step_s[-1]})
        if val is not None and ((i + 1) % args.eval_every == 0 or i == args.steps - 1):
            val_losses.append(eval_loss())
            _log({"step": i, "val_loss": val_losses[-1]})

    if ema is not None:  # end on the EMA weights, the ones a fine-tune samples from
        with torch.no_grad():
            for p, e in zip(params, ema_params(ema, params)):
                p.copy_(e)
    if args.save:
        save(args, model)
    return {"model": model, "trainable": names, "adapters": n_adapters, "losses": losses,
            "step_s": step_s, "val_losses": val_losses}


if __name__ == "__main__":
    main()
