"""Fine-tune the DiT with rectified flow on one GPU.

The single-device surface of the JAX package's `scripts/train.py`: random
weights from `--seed` or a reference-format `--checkpoint`, LoRA adapters
(`--lora-rank`) or a trainable regex (`--trainable`), AdamW with global-norm
clipping, an optional LR warmup/decay, EMA, a held-out validation loss
(`--val-fraction` or `--val-data`), per-block remat, joint audio-video
training (`--audio`), the fp8 frozen base (`--fp8-serving`) and exact
mid-run resume (`--save-state`, `--save-every`, `--resume`). Every attention
call of the forward, the remat recompute and the backward runs on the
hand-written flash-attention kernels.

Data: an .npz with video arrays
    x0         (N, tokens, C)    clean patchified video latents
    positions  (N, 3, tokens, 2) RoPE position bounds
    context    (N, S, D_ctx)     text embeddings
and, for joint audio-video training of an `--audio` model,
    audio_x0, audio_positions [, audio_context [, audio_context_mask]]
(`python -m ltx2_tpu_torch.prepare_data` writes the video arrays), or
`--synthetic F H W`, a random dataset at that latent shape with 32 context
tokens (with `--audio` also one audio token per latent frame, positions in
seconds and an 8-token audio context), drawn as scripts/train.py draws it.

    python -m ltx2_tpu_torch.train --synthetic 16 16 24 --lora-rank 16 --steps 3
    python -m ltx2_tpu_torch.train --audio --fp8-serving --data av.npz --lora-rank 16 --steps 100 \\
        --save-state state.safetensors --save-every 50
    python -m ltx2_tpu_torch.train ... --resume state.safetensors

The model is the full-width LTX-2.0 DiT (`--layers` blocks, 48 by default;
with `--audio` the audio-video one); `--placeholder` takes scripts/train.py's
tiny config instead (4 heads x 32, 128-d context; with `--audio` 4 audio
heads x 16), whose head dims the kernels do not take: on the card it is
refused by name. `--checkpoint` loads the base DiT from a reference-format
checkpoint through `ModelLedger` (bf16, or its fp8 weights kept with
`--fp8-serving`; remat on). An audio-video model trained on a video-only
dataset has its audio branch frozen. `--save` writes, with `--lora-rank`,
the adapters as a reference-format LoRA file (`generate.py --lora` fuses it
back), otherwise the trained DiT as a reference-format checkpoint carrying
the source checkpoint's other tensors and metadata. Not ported: the
TP/DP/ZeRO/FSDP mesh flags (they raise).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ltx2_tpu_torch.core import resolve_device
from ltx2_tpu_torch.generate import av_config, make_dit
from ltx2_tpu_torch.loader.export import export_transformer_checkpoint
from ltx2_tpu_torch.loader.safetensors_io import read_metadata
from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelConfig
from ltx2_tpu_torch.ops.attention import KERNEL_HEAD_DIMS
from ltx2_tpu_torch.ops.rope import create_position_grid
from ltx2_tpu_torch.training import (
    TrainBatch,
    TrainConfig,
    ema_params,
    freeze_audio_branch_mask,
    init_ema,
    make_ema_update,
    make_eval_step,
    make_optimizer,
    make_train_step,
    trainable_mask,
)
from ltx2_tpu_torch.training.checkpoint import load_train_state, save_train_state
from ltx2_tpu_torch.training.lora import add_lora_params_, export_lora_checkpoint, lora_trainable_mask
from ltx2_tpu_torch.utils.model_ledger import ModelLedger

# scripts/train.py's --placeholder DiT (with --audio its audio stream).
PLACEHOLDER_CONFIG = LTXModelConfig(num_attention_heads=4, attention_head_dim=32, num_layers=4,
                                    cross_attention_dim=128)
PLACEHOLDER_AUDIO = dict(audio_heads=4, audio_head_dim=16, audio_in_channels=32, audio_out_channels=32)
SYNTHETIC_CONTEXT_TOKENS = 32
SYNTHETIC_AUDIO_CONTEXT_TOKENS = 8
# scripts/bench_train.py's flagship shape: 16x16x24 latents = 6144 tokens
# against 1024 text tokens; the audio-video DiT also takes the audio of the
# 121-frame clip those latents come from (126 tokens at 24 fps) with its own
# 1024-token context, a padded caption's key mask keeping the first 700.
BENCH_SHAPE, BENCH_CONTEXT_TOKENS = (16, 16, 24), 1024
BENCH_FRAMES, BENCH_AUDIO_TEXT_VALID = 121, 700
VIDEO_KEYS = ("x0", "positions", "context")
AUDIO_KEYS = ("audio_x0", "audio_positions", "audio_context", "audio_context_mask")
# The JAX CLI's multi-device flags, refused: the port trains on one device.
MESH_FLAGS = ("tp_devices", "dp_devices", "zero1", "zero2", "fsdp")

Arrays = Dict[str, np.ndarray]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--placeholder", action="store_true", help="tiny random DiT (CPU tests)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference-format checkpoint of the base DiT (loaded through ModelLedger)")
    p.add_argument("--audio", action="store_true",
                   help="the audio-video DiT (a checkpoint's audio branch included): joint training on a dataset "
                        "with audio arrays, the audio branch frozen on a video-only one")
    p.add_argument("--fp8-serving", action="store_true",
                   help="keep the base's linears in fp8 as a FROZEN base (QLoRA-style); needs --lora-rank or "
                        "--trainable")
    p.add_argument("--save", type=str, default=None,
                   help="write the LoRA adapter (with --lora-rank) or the fine-tuned checkpoint here")
    p.add_argument("--layers", type=int, default=None, help="DiT blocks (default: 48, placeholder 4)")
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--data", type=str, default=None,
                   help=".npz with x0/positions/context arrays (plus audio_x0/audio_positions"
                        "[/audio_context[_mask]] for joint audio-video training with --audio)")
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
    p.add_argument("--save-state", type=str, default=None,
                   help="persist (step, trainable tensors, AdamW state, EMA) here for exact resume (atomic)")
    p.add_argument("--save-every", type=int, default=100, help="write --save-state every N steps and at the end")
    p.add_argument("--resume", type=str, default=None,
                   help="continue from a --save-state file at its step (the configuration must match)")
    p.add_argument("--warmup-steps", type=int, default=0, help="linear LR warmup from 0 over this many steps")
    p.add_argument("--lr-schedule", choices=("constant", "cosine", "linear"), default="constant")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an fp32 EMA of the trained weights and end on it; 0 disables")
    p.add_argument("--val-fraction", type=float, default=0.0, help="hold out this tail fraction for validation")
    p.add_argument("--val-data", type=str, default=None,
                   help="a separate .npz (the same arrays as --data) used only for the validation loss")
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--tp-devices", type=int, default=0, help="not ported (one device)")
    p.add_argument("--dp-devices", type=int, default=0, help="not ported (one device)")
    for flag in ("--zero1", "--zero2", "--fsdp"):
        p.add_argument(flag, action="store_true", help="not ported (one device)")
    return p


def check_head_dims(cfg: LTXModelConfig, device: torch.device) -> None:
    """On the card every attention runs on the flash kernels, which take
    head dims 64 and 128: refuse another by the config field's name."""
    if device.type != "cuda":
        return
    dims = []
    if cfg.has_video:
        dims.append(("attention_head_dim", cfg.attention_head_dim))
    if cfg.has_audio:
        dims.append(("audio_head_dim", cfg.audio_head_dim))
    for field, d in dims:
        if d not in KERNEL_HEAD_DIMS:
            raise ValueError(f"{field} {d}: the flash kernels take head dims {KERNEL_HEAD_DIMS} on the card "
                             f"(the placeholder DiT is for the CPU: pass --device cpu)")


def make_model(layers: Optional[int], device: torch.device, seed: int, placeholder: bool = False,
               checkpoint: Optional[str] = None, audio: bool = False, fp8: bool = False) -> LTXModel:
    """The DiT to train, remat on: from `checkpoint` (bf16, or its fp8
    weights kept with `fp8`), else full width (or the placeholder) with
    random weights from `seed`, quantized to fp8 with `fp8`; audio-video
    with `audio`."""
    if checkpoint:
        model = ModelLedger(checkpoint_path=checkpoint, device=device, include_audio=audio,
                            keep_fp8=fp8).transformer()
        model.cfg = dataclasses.replace(model.cfg, remat=True)
        check_head_dims(model.cfg, device)
        return model
    base = PLACEHOLDER_CONFIG if placeholder else LTXModelConfig()
    if audio:
        base = av_config(dataclasses.replace(base, **PLACEHOLDER_AUDIO) if placeholder else base)
    check_head_dims(base, device)
    return make_dit(base.num_layers if layers is None else layers, device, seed=seed, base=base, fp8=fp8)


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
                      context_tokens: int = SYNTHETIC_CONTEXT_TOKENS) -> Arrays:
    """The arrays of a random dataset, drawn as scripts/train.py draws them:
    x0, positions and context, and on an audio-video model audio_x0 (one
    token per latent frame), audio_positions (seconds) and audio_context."""
    rng = np.random.RandomState(seed)
    grid = create_position_grid(1, frames, height, width).numpy().astype(np.float32)
    pos = np.stack([grid, grid + 1], axis=-1)
    x0s = rng.randn(samples, frames * height * width, cfg.in_channels).astype(np.float32)
    poss = np.repeat(pos, samples, axis=0)
    ctx_width = cfg.caption_channels or cfg.cross_attention_dim  # the DiT's text input
    ctxs = rng.randn(samples, context_tokens, ctx_width).astype(np.float32) * 0.1
    arrays = {"x0": x0s, "positions": poss, "context": ctxs}
    if cfg.is_av:
        t = np.arange(frames, dtype=np.float32)[None, None, :]
        apos = np.stack([t, t + 0.1], axis=-1)
        arrays["audio_x0"] = rng.randn(samples, frames, cfg.audio_in_channels).astype(np.float32)
        arrays["audio_positions"] = np.repeat(apos, samples, axis=0)
        arrays["audio_context"] = rng.randn(samples, SYNTHETIC_AUDIO_CONTEXT_TOKENS,
                                            cfg.caption_channels or cfg.audio_inner_dim).astype(np.float32) * 0.1
    return arrays


def dit_forward_flops(cfg: LTXModelConfig, video_tokens: int, text_tokens: int, audio_tokens: int = 0,
                      audio_text_tokens: int = 0) -> int:
    """FLOP of one forward of the DiT for one sample: per block the
    self-attention projections and attention, text cross-attention (q/out
    projections, k/v from the context, attention) and the 4x FFN, plus the
    patchify projection; elementwise work omitted (the count of the JAX
    package's utils/flops.py::dit_step_flops for the video stream). With
    audio tokens the audio stream's same terms (its text context is as wide
    as the stream), audio->video attention (video queries projected to the
    audio width, audio keys) and video->audio, each at the audio heads'
    width, as the port's blocks compute them."""
    d, n, s = cfg.video_inner_dim, video_tokens, text_tokens
    per_block = 4 * 2 * n * d * d + 4 * n * n * d
    per_block += 2 * 2 * n * d * d + 4 * n * s * d + 2 * 2 * s * cfg.cross_attention_dim * d
    per_block += 2 * 2 * n * d * 4 * d
    total = 2 * 2 * n * cfg.in_channels * d
    if audio_tokens:
        da, na, sa = cfg.audio_inner_dim, audio_tokens, audio_text_tokens
        per_block += 4 * 2 * na * da * da + 4 * na * na * da
        per_block += 2 * 2 * na * da * da + 4 * na * sa * da + 2 * 2 * sa * da * da
        per_block += 2 * 2 * na * da * 4 * da
        per_block += 2 * 2 * n * d * da + 2 * 2 * na * da * da + 4 * n * na * da  # a2v
        per_block += 2 * 2 * na * da * da + 2 * 2 * n * d * da + 4 * na * n * da  # v2a
        total += 2 * 2 * na * cfg.audio_in_channels * da
    return cfg.num_layers * per_block + total


def bench_arrays(cfg: LTXModelConfig, audio: bool = True) -> Arrays:
    """One sample at the bench shape: `synthetic_dataset` at BENCH_SHAPE with
    BENCH_CONTEXT_TOKENS text tokens; on an audio-video model (and `audio`)
    its audio replaced by the BENCH_FRAMES clip's 126 tokens, positions in
    seconds as the audio patchifier gives them, and their own
    BENCH_CONTEXT_TOKENS-token context, the first BENCH_AUDIO_TEXT_VALID keys
    valid; without `audio` no audio arrays (a video-only dataset)."""
    from ltx2_tpu_torch.components.patchifiers import AudioPatchifier
    from ltx2_tpu_torch.types import AudioLatentShape, VideoPixelShape

    arrays = synthetic_dataset(*BENCH_SHAPE, 1, cfg, 0, context_tokens=BENCH_CONTEXT_TOKENS)
    for k in AUDIO_KEYS:
        arrays.pop(k, None)
    if not (audio and cfg.is_av):
        return arrays
    h, w = BENCH_SHAPE[1] * 32, BENCH_SHAPE[2] * 32
    shape = AudioLatentShape.from_video_pixel_shape(VideoPixelShape(1, BENCH_FRAMES, h, w, 24.0))
    rng = np.random.RandomState(1)
    arrays["audio_x0"] = rng.randn(1, shape.frames, cfg.audio_in_channels).astype(np.float32)
    arrays["audio_positions"] = AudioPatchifier(1).get_patch_grid_bounds(shape).numpy().astype(np.float32)
    width = cfg.caption_channels or cfg.audio_inner_dim
    arrays["audio_context"] = (rng.randn(1, BENCH_CONTEXT_TOKENS, width) * 0.1).astype(np.float32)
    mask = np.zeros((1, BENCH_CONTEXT_TOKENS), bool)
    mask[:, :BENCH_AUDIO_TEXT_VALID] = True
    arrays["audio_context_mask"] = mask
    return arrays


def make_batch(arrays: Arrays, idx, device: torch.device) -> TrainBatch:
    return TrainBatch(**{k: torch.from_numpy(np.ascontiguousarray(a[idx])).to(device) for k, a in arrays.items()})


def bench_step(model: LTXModel, device: torch.device, arrays: Optional[Arrays] = None):
    """scripts/bench_train.py's step on `model`'s trainable parameters
    (`--fp8-base`: an fp8 model): uniform sigmas, AdamW, the first sample
    of `arrays`, by default `bench_arrays`. Returns (step, batch, FLOP per
    step at bench_train's LoRA rule: 3 x the forward, i.e. forward, remat
    recompute and the input-gradient half of the backward)."""
    tc = TrainConfig(logit_normal_loc=None)
    step = make_train_step(model, make_optimizer(tc, [p for p in model.parameters() if p.requires_grad]), tc)
    if arrays is None:
        arrays = bench_arrays(model.cfg)
    batch = make_batch(arrays, [0], device)
    audio = {}
    if batch.audio_x0 is not None:
        a_ctx = batch.audio_context if batch.audio_context is not None else batch.context
        audio = {"audio_tokens": batch.audio_x0.shape[1], "audio_text_tokens": a_ctx.shape[1]}
    return step, batch, 3 * dit_forward_flops(model.cfg, batch.x0.shape[1], batch.context.shape[1], **audio)


def _load_npz(path: str) -> Arrays:
    data = np.load(path)
    return {k: data[k] for k in VIDEO_KEYS + AUDIO_KEYS if k in data.files}


def _dataset(args, cfg: LTXModelConfig) -> Arrays:
    if args.data:
        arrays = _load_npz(args.data)
        if any(k in arrays for k in AUDIO_KEYS) and "audio_positions" not in arrays:
            raise SystemExit("dataset has audio_x0 but no audio_positions")
        return arrays
    if args.synthetic:
        return synthetic_dataset(*args.synthetic, args.synthetic_samples, cfg, args.seed)
    raise SystemExit("pass --data latents.npz or --synthetic F H W")


def _split(args, arrays: Arrays) -> Tuple[Arrays, Optional[Arrays]]:
    """(training arrays, validation arrays or None): a separate --val-data
    file with the same audio arrays, or the held-out tail."""
    if args.val_data:
        val = _load_npz(args.val_data)
        train_audio = sorted(k for k in arrays if k in AUDIO_KEYS)
        val_audio = sorted(k for k in val if k in train_audio)
        if val_audio != train_audio:
            raise SystemExit(f"--val-data must carry the same audio arrays as --data (train has {train_audio}, "
                             f"val has {val_audio})")
        return arrays, {k: val[k] for k in arrays}
    if args.val_fraction > 0:
        n = arrays["x0"].shape[0]
        n_val = max(1, int(round(n * args.val_fraction)))
        if n_val >= n:
            raise SystemExit(f"--val-fraction {args.val_fraction} leaves no training data")
        return {k: a[:-n_val] for k, a in arrays.items()}, {k: a[-n_val:] for k, a in arrays.items()}
    return arrays, None


def _reject_fp8_trainable(model: LTXModel, pattern: "re.Pattern") -> None:
    """--fp8-serving with --trainable: refuse a regex that marks an fp8
    weight (one with a `weight_scale` beside it) trainable. AdamW cannot
    update E4M3 codes; --lora-rank trains adapters around the frozen base."""
    bad = [name for name, mod in model.named_modules() if getattr(mod, "weight_scale", None) is not None
           and (pattern.search(f"{name}.weight") or pattern.search(f"{name}.weight_scale"))]
    if bad:
        raise SystemExit(
            f"--trainable selects fp8-quantized leaves under --fp8-serving (e.g. {bad[0]}.weight): quantized "
            "weights are a FROZEN base. Use --lora-rank to train adapters, or drop --fp8-serving to dequantize "
            "the base for full fine-tuning.")


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
    if args.fp8_serving:
        _reject_fp8_trainable(model, pat)
    return trainable_mask(model, lambda name: bool(pat.search(name))), 0


def _log(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _check_args(args) -> None:
    for flag in MESH_FLAGS:
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported: the port trains on one device "
                                      "(ROADMAP.md §1, \"Scale-out\")")
    if args.grad_clip < 0:
        raise SystemExit("--grad-clip must be >= 0 (0 disables clipping)")
    if args.ema_decay and not 0.0 < args.ema_decay < 1.0:
        raise SystemExit("--ema-decay must be in (0, 1)")
    if args.fp8_serving and not (args.lora_rank or args.trainable):
        raise SystemExit("--fp8-serving requires --lora-rank or --trainable: fp8 weights are a FROZEN base "
                         "(AdamW cannot update them)")
    if args.checkpoint and (args.placeholder or args.layers is not None):
        raise SystemExit("--checkpoint sets the model: drop --placeholder and --layers")
    if args.save_every < 1:
        raise SystemExit("--save-every must be >= 1")


def main(argv=None, on_step: Optional[Callable[[int, LTXModel, float], None]] = None) -> dict:
    """Train per the flags; returns {"model", "optimizer", "ema",
    "trainable", "adapters", "losses", "step_s", "val_losses", "start",
    "state_save_s", "state_load_s"}. `on_step(i, model, loss)` runs after
    every optimizer step."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model = make_model(args.layers, device, args.seed, args.placeholder, args.checkpoint, args.audio,
                       args.fp8_serving)
    arrays = _dataset(args, model.cfg)
    has_audio = any(k in arrays for k in AUDIO_KEYS)
    if has_audio and not model.cfg.is_av:
        raise SystemExit("dataset carries audio arrays but the model is video-only: pass --audio (with an "
                         "audio-video checkpoint)")
    names, n_adapters = select_trainable(model, args, device)
    if model.cfg.is_av and not has_audio:
        # The loss never reaches the audio branch, but weight decay would
        # shrink it every step: freeze it (no moments, no decay).
        names = freeze_audio_branch_mask(model, names)
        _log({"audio_branch": "frozen (video-only dataset on an audio-video model)"})
    params = [p for p in model.parameters() if p.requires_grad]
    _log({"model_layers": model.cfg.num_layers, "width": model.cfg.video_inner_dim,
          "model_type": model.cfg.model_type.name, "fp8_base": args.fp8_serving, "adapters": n_adapters,
          "trainable_tensors": len(names), "trainable_params": sum(p.numel() for p in params)})

    arrays, val = _split(args, arrays)
    n_samples = arrays["x0"].shape[0]

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
        reps = -(-vbs // val["x0"].shape[0])  # repeat-pad a tiny validation set to one batch
        vals = {k: np.tile(a, (reps,) + (1,) * (a.ndim - 1)) for k, a in val.items()}
        n_batches = vals["x0"].shape[0] // vbs
        total = 0.0
        for j in range(n_batches):
            gen = torch.Generator(device=device).manual_seed(args.seed + 7000 + j)
            total += float(eval_step(make_batch(vals, slice(j * vbs, (j + 1) * vbs), device), gen))
        return total / n_batches

    start, state_save_s, state_load_s = 0, [], None
    if args.resume:
        t0 = time.perf_counter()
        start = load_train_state(args.resume, model, optimizer, ema)
        state_load_s = time.perf_counter() - t0
        _log({"resumed": args.resume, "step": start, "load_s": state_load_s})
    state_meta = {"seed": str(args.seed), "batch_size": str(args.batch_size), "accum_steps": str(args.accum_steps),
                  "trainable": str(args.trainable), "lora_rank": str(args.lora_rank),
                  "ema_decay": str(args.ema_decay), "lr_schedule": args.lr_schedule,
                  "warmup_steps": str(args.warmup_steps)}

    rng = np.random.RandomState(args.seed + 1)
    for _ in range(start):  # a resumed run sees the batches the uninterrupted run would
        rng.randint(0, n_samples, size=args.batch_size)
    losses, step_s = [], []
    for i in range(start, args.steps):
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
        if args.save_state and ((i + 1) % args.save_every == 0 or i == args.steps - 1):
            t0 = time.perf_counter()
            save_train_state(args.save_state, i + 1, model, optimizer, ema, metadata=state_meta)
            state_save_s.append(time.perf_counter() - t0)
            _log({"saved_state": args.save_state, "step": i + 1, "save_s": state_save_s[-1]})

    if ema is not None:  # end on the EMA weights, the ones a fine-tune samples from
        with torch.no_grad():
            for p, e in zip(params, ema_params(ema, params)):
                p.copy_(e)
    if args.save:
        save(args, model)
    return {"model": model, "optimizer": optimizer, "ema": ema, "trainable": names, "adapters": n_adapters, "losses": losses, "step_s": step_s,
            "val_losses": val_losses, "start": start, "state_save_s": state_save_s, "state_load_s": state_load_s}


if __name__ == "__main__":
    main()
