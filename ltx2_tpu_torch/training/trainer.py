"""Rectified-flow fine-tuning of the DiT on one device, data-parallel over
the ranks of a 'data' mesh axis, tensor-parallel over a 'model' axis, or
both (counterpart of ltx2_tpu/training/trainer.py).

Objective (rectified flow / flow matching): x_sigma = (1 - sigma) * x0 +
sigma * noise, and the DiT predicts the velocity v = noise - x0; the loss is
a uniform-weight fp32 MSE, with logit-normal (or uniform) sigma sampling.
A batch with audio fields trains the audio-video DiT jointly: both streams
share each sample's sigma and the loss is the sum of the two MSEs.
`freeze_audio_branch_mask` freezes the audio branch of an audio-video model
trained on video alone.

What replaces the JAX machinery:
- `jax.value_and_grad` -> autograd on the module; only parameters with
  `requires_grad` (set by `trainable_mask` / `lora_trainable_mask`) get
  gradients. The frozen base is simply never handed to the optimizer, which
  replaces `partition_params` / `optax.multi_transform`.
- `optax.chain(clip_by_global_norm, adamw)` -> `AdamW`, written to give
  optax's numbers (global-norm clip without eps, bias-corrected moments,
  decoupled weight decay, the learning rate of the step before the update).
- `jax.random` keys -> explicit `torch.Generator`s.
- Remat is `LTXModelConfig.remat` (per-block `torch.utils.checkpoint`).
- GSPMD's data parallelism -> one process per rank (parallel/runtime.py):
  `make_train_step(..., data_axis=)` gives each rank its rows of every
  microbatch, averages the gradients over 'data' after the backward
  (`collectives.all_reduce`, fp32) and the loss over the ranks.
- GSPMD's differentiation through the TP-sharded forward -> a model made
  a TP shard (`parallel.sharding.shard_model_`: its `cfg.tp_axis` set,
  each rank holding its heads and features), whose forward carries
  Megatron's differentiable collectives (`copy_to_model` at each
  column-parallel input, `reduce_from_model` at each row-parallel output,
  `all_reduce_sum` in the Q/K norms): every gradient comes out of the
  backward as this rank's slice of the whole one, or whole where the leaf
  replicates, except the replicated LoRA factors beside a split base
  (`sharding.tp_partial_grad`), whose shares the gradient store sums over
  'model'. Nothing else is reduced over 'model'; the gradients are
  averaged over 'data' and the loss is the mean over 'data' (it is the
  same on every rank of a 'model' line).
- The ZeRO shardings -> the shard dim of each trainable parameter, or None
  (`zero1_opt_state_shardings`, `zero2_grad_shardings`: the rule of
  `_data_extended_sharding` on each block's own dims, skipping the dim the
  TP spec holds when given the parameters' names). ZeRO-1: AdamW keeps its
  moments for this rank's slice, updates the slice and all-gathers the
  updated bf16 bits, so every rank holds the same parameters. ZeRO-2: each
  gradient is reduce-scattered into this rank's slice as the backward
  produces it, the full-size `.grad` freed. Under TP the slices are of the
  rank's TP slice.
- GSPMD's ZeRO-3/FSDP (`fsdp_param_shardings`, which GSPMD turns into
  per-block all-gathers inside the remat'd scan body and reduce-scatters
  of the gradients) -> the same rule on EVERY parameter (frozen, trainable,
  LoRA factors, fp8 codes), always skipping the TP dim;
  `parallel.fsdp.shard_model_fsdp_` slices the model in place, so between
  steps a rank holds only slices, and the DiT's forward gathers the
  non-block leaves once and each block's weights inside its remat unit
  (`collectives.gather_from_data`: all-gather forward, fp32 reduce-scatter
  of the gradient backward), the recompute gathering again. The step
  (`make_train_step(param_shardings=...)`) updates the slices in place from
  gradients the gathers' backward has already reduced: no second reduce, no
  gather after the update; the ZeRO layouts pass the FSDP dims through.
Training under sequence parallelism is refused (NotImplementedError), as
the JAX CLI's training mesh is (data, model) only.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelType, Modality, ltx_model_apply
from ltx2_tpu_torch.parallel import collectives
from ltx2_tpu_torch.parallel.fsdp import fsdp_dim, is_fsdp, model_fsdp_axis
from ltx2_tpu_torch.parallel.mesh import Axis
from ltx2_tpu_torch.parallel.sharding import model_tp_axis, tp_partial_grad, tp_split_dim


@dataclasses.dataclass
class TrainBatch:
    """One training batch of patchified latents.

    x0:           (B, N, C) clean latent tokens
    positions:    (B, 3, N, 2) RoPE position bounds
    context:      (B, S, D_ctx) text conditioning
    context_mask: optional (B, S) mask for padded captions (bool, or
                  additive float); needed when batching variable-length
                  prompts
    audio_*:      joint audio-video training: the audio latent tokens
                  (B, Na, Ca), their (B, 1, Na, 2) positions in seconds, and
                  optionally the audio stream's own text context and its
                  mask (without them the audio shares the video's)
    """

    x0: torch.Tensor
    positions: torch.Tensor
    context: torch.Tensor
    context_mask: Optional[torch.Tensor] = None
    audio_x0: Optional[torch.Tensor] = None
    audio_positions: Optional[torch.Tensor] = None
    audio_context: Optional[torch.Tensor] = None
    audio_context_mask: Optional[torch.Tensor] = None

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "TrainBatch":
        """A batch with `fn` applied to every tensor field."""
        return TrainBatch(**{f.name: None if getattr(self, f.name) is None else fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    grad_clip_norm: Optional[float] = 1.0
    # Logit-normal sigma sampling (mid-schedule emphasis); uniform when None.
    logit_normal_loc: Optional[float] = 0.0
    logit_normal_scale: float = 1.0
    # Linear warmup over warmup_steps, then "constant", "cosine" or "linear"
    # decay to 0 over total_steps - warmup_steps.
    warmup_steps: int = 0
    lr_schedule: str = "constant"
    total_steps: Optional[int] = None


def _sample_sigmas(generator: Optional[torch.Generator], batch: int, tc: TrainConfig,
                   device: torch.device) -> torch.Tensor:
    if tc.logit_normal_loc is None:
        u = torch.rand(batch, generator=generator, device=device)
        return 1e-4 + (1.0 - 2e-4) * u
    z = tc.logit_normal_loc + tc.logit_normal_scale * torch.randn(batch, generator=generator, device=device)
    return torch.sigmoid(z)


def draw_noise(batch: TrainBatch, generator: Optional[torch.Generator], tc: TrainConfig,
               sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
               audio_noise: Optional[torch.Tensor] = None):
    """(sigmas (B,), noise (B, N, C), audio_noise (B, Na, Ca) or None) in
    fp32 for every row of `batch`: each one given, or drawn from `generator`
    in that order. A data-parallel step draws them whole on every rank and
    takes its own rows, so the ranks and world 1 draw the same numbers."""
    x0 = batch.x0
    b, device = x0.shape[0], x0.device
    if sigmas is None:
        sigmas = _sample_sigmas(generator, b, tc, device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=device)
    if batch.audio_x0 is not None and audio_noise is None:
        audio_noise = torch.randn(batch.audio_x0.shape, generator=generator, device=device)
    return sigmas.float(), noise.float(), None if audio_noise is None else audio_noise.float()


def rectified_flow_loss(
    model: LTXModel,
    batch: TrainBatch,
    generator: Optional[torch.Generator] = None,
    tc: TrainConfig = TrainConfig(),
    sigmas: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    audio_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flow-matching MSE for one batch: model(x_sigma, sigma) vs noise - x0.

    sigmas (B,), noise (B, N, C) and, with audio fields, audio_noise (B, Na,
    Ca) are drawn from `generator` in that order unless given; the tests
    hand in the JAX package's draws. With audio fields both streams share
    the per-sample sigma and the loss is the sum of their MSEs."""
    cfg = model.cfg
    x0 = batch.x0.float()
    sigmas, noise, audio_noise = draw_noise(batch, generator, tc, sigmas, noise, audio_noise)
    s = sigmas[:, None, None]

    def noised(x0: torch.Tensor, eps: torch.Tensor):
        return eps, ((1.0 - s) * x0 + s * eps).to(cfg.dtype)

    noise, x_sigma = noised(x0, noise)
    video = Modality(
        latent=x_sigma, context=batch.context, context_mask=batch.context_mask,
        timesteps=sigmas, positions=batch.positions, sigma=sigmas,
    )
    if batch.audio_x0 is None:
        v_pred = ltx_model_apply(model, video)
        return torch.mean((v_pred.float() - (noise - x0)) ** 2)

    if cfg.model_type != LTXModelType.AudioVideo:
        raise ValueError("batch carries audio fields but cfg.model_type is video-only: a bare-array return would "
                         "mis-unpack into (v_pred, a_pred)")
    a0 = batch.audio_x0.float()
    audio_noise, a_sigma = noised(a0, audio_noise)
    own = batch.audio_context is not None
    # The video's mask applies only when the audio shares the video context.
    audio = Modality(
        latent=a_sigma, context=batch.audio_context if own else batch.context,
        context_mask=batch.audio_context_mask if own else batch.context_mask,
        timesteps=sigmas, positions=batch.audio_positions, sigma=sigmas,
    )
    v_pred, a_pred = ltx_model_apply(model, video, audio=audio)
    v_loss = torch.mean((v_pred.float() - (noise - x0)) ** 2)
    a_loss = torch.mean((a_pred.float() - (audio_noise - a0)) ** 2)
    return v_loss + a_loss


# Every audio-branch parameter of the DiT, by dotted name: the top-level
# audio_* / av_ca_* leaves and the blocks' audio_attn*, audio_ff,
# audio_*_table, audio_to_video_attn and video_to_audio_attn sublayers, with
# any LoRA adapters attached inside them.
AUDIO_BRANCH_PATTERN = r"(^|\.)(audio_|av_ca_|video_to_audio_attn)"


def freeze_audio_branch_mask(model: nn.Module, mask: Optional[Sequence[str]] = None) -> List[str]:
    """Freeze every audio-branch parameter (`requires_grad` False) and
    return the trainable names: those of `mask` (a trainable mask's names)
    outside the audio branch, or every parameter outside it when `mask` is
    None. For an audio-video model trained on video alone: the loss gives
    the audio branch exactly-zero gradients, but AdamW's weight decay would
    still shrink its weights every step; frozen, it gets no moments and no
    decay."""
    audio_re = re.compile(AUDIO_BRANCH_PATTERN)
    keep = None if mask is None else set(mask)
    return trainable_mask(model, lambda name: not audio_re.search(name) and (keep is None or name in keep))


def trainable_mask(model: nn.Module, predicate: Callable[[str], bool]) -> List[str]:
    """Set `requires_grad` on every parameter from `predicate` over its
    dotted name (e.g. `lambda n: "attn" in n` trains only the attention
    layers); returns the trainable names."""
    names = []
    for name, p in model.named_parameters():
        train = bool(predicate(name))
        p.requires_grad_(train)
        if train:
            names.append(name)
    return names


def parameter_names(model: nn.Module, params: Sequence[torch.Tensor]) -> List[str]:
    """The dotted names of `params` (an optimizer's) in `model`; raises
    ValueError where one is not a parameter of the model."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    names = [by_id.get(id(p)) for p in params]
    if None in names:
        raise ValueError("the optimizer holds a tensor that is not a parameter of the model")
    return names


def _linear_schedule(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine_decay(init: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        return init * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    return f


def learning_rate_schedule(tc: TrainConfig) -> Union[float, Callable[[int], float]]:
    """A constant LR, or step -> LR as optax's schedules give it: linear
    0 -> lr over warmup_steps, then constant, or cosine / linear decay to 0
    across the remaining total_steps - warmup_steps."""
    if tc.lr_schedule not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")
    lr = tc.learning_rate
    if tc.lr_schedule == "constant" and not tc.warmup_steps:
        return lr
    if tc.lr_schedule == "constant":
        decay = lambda count: lr  # noqa: E731
    else:
        if not tc.total_steps:
            raise ValueError(f"lr_schedule={tc.lr_schedule!r} needs total_steps (the decay horizon)")
        decay_steps = max(1, tc.total_steps - tc.warmup_steps)
        decay = _cosine_decay(lr, decay_steps) if tc.lr_schedule == "cosine" else _linear_schedule(lr, 0.0, decay_steps)
    if not tc.warmup_steps:
        return decay
    warmup, boundary = _linear_schedule(0.0, lr, tc.warmup_steps), tc.warmup_steps
    return lambda count: warmup(count) if count < boundary else decay(count - boundary)


ADAM_EPS = 1e-8  # optax.adamw's default, which the JAX trainer uses


def data_shard_dim(shape: Sequence[int], size: int, skip: Optional[int] = None) -> Optional[int]:
    """The dim a tensor of `shape` shards over a 'data' axis of `size`
    ranks: the first at least `size` long that divides by it, other than
    `skip` (the dim a TP spec holds), where `_data_extended_sharding`
    (ltx2_tpu/training/trainer.py) puts 'data'; None (kept whole) where no
    dim does, or at size 1. A TP shard's own shape gives the same answer as
    the whole one: only the skipped dim differs."""
    if size > 1:
        for i, n in enumerate(shape):
            if i != skip and n >= size and n % size == 0:
                return i
    return None


def fsdp_param_shardings(model: nn.Module, axis: Optional[Axis],
                         names: Optional[Sequence[str]] = None) -> List[Optional[int]]:
    """ZeRO-3/FSDP: for each parameter of `model` named in `names` (default:
    every one, in `named_parameters` order; frozen, trainable, LoRA
    factors, fp8 codes alike), the dim it shards over the 'data' `axis`, or
    None to keep it whole: the first dim other than its TP dim that divides
    (`data_shard_dim`), JAX's `fsdp_param_shardings` on each block's own
    leaf (the JAX package's stacked leaves start at dim 1, so 'data' never
    lands on the scan axis L). On a model sliced already
    (`parallel.fsdp.shard_model_fsdp_`) each parameter's recorded dim. Hand
    the layout of the whole model to `shard_model_fsdp_`, that of the
    trainable parameters to `make_train_step(param_shardings=...)`."""
    size = 1 if axis is None else axis.size
    params = dict(model.named_parameters())
    names = list(params) if names is None else list(names)
    return [fsdp_dim(params[n]) if is_fsdp(params[n]) else data_shard_dim(tuple(params[n].shape), size, tp_split_dim(n))
            for n in names]


def zero1_opt_state_shardings(params: Sequence[torch.Tensor], axis: Optional[Axis],
                              names: Optional[Sequence[str]] = None) -> List[Optional[int]]:
    """ZeRO-1: for each trainable parameter, the dim its Adam moments shard
    over the 'data' `axis` (None: kept whole). Hand it with the axis to
    `make_train_step(opt_state_shardings=..., data_axis=axis)`: AdamW then
    keeps `mu` and `nu` for this rank's slice (1/D of their bytes), updates
    the slice from the all-reduced gradient and all-gathers the updated
    slices. With the parameters' dotted `names` (under TP) the rule skips
    the dim each one's TP spec holds, as JAX's does; without them it runs
    on every dim. The JAX package stacks the blocks into (L, ...) leaves and
    may put 'data' on L; the port's blocks are separate modules, so the rule
    runs on each block's own dims. A parameter that is an FSDP slice
    already keeps its FSDP dim (JAX's helpers pass a spec that holds 'data'
    through): the moments take the parameters' layout."""
    size = 1 if axis is None else axis.size
    skips = [None] * len(params) if names is None else [tp_split_dim(n) for n in names]
    if len(skips) != len(params):
        raise ValueError(f"ZeRO layout: {len(skips)} names for {len(params)} parameters")
    return [fsdp_dim(p) if is_fsdp(p) else data_shard_dim(tuple(p.shape), size, skip)
            for p, skip in zip(params, skips)]


def zero2_grad_shardings(params: Sequence[torch.Tensor], axis: Optional[Axis],
                         names: Optional[Sequence[str]] = None) -> List[Optional[int]]:
    """ZeRO-2: the same layout for the gradients. Hand it to
    `make_train_step(grad_shardings=..., data_axis=axis)` (the moments take
    it too): each gradient is reduce-scattered into this rank's slice as the
    backward produces it, and under accumulation the fp32 accumulator holds
    the slice only."""
    return zero1_opt_state_shardings(params, axis, names)


class AdamW:
    """optax.chain(clip_by_global_norm(tc.grad_clip_norm), adamw(schedule,
    b1, b2, eps=1e-8, weight_decay)) over `params`, updated in place from
    the gradients handed to `step` or their `.grad` (which `step` then
    clears). Moments are kept in the parameters' dtype, as optax keeps
    them; after `shard_` (ZeRO-1), for this rank's slice of each sharded
    parameter only; under ZeRO-3/FSDP the parameters are those slices."""

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        self.params = list(params)
        if not self.params:
            raise ValueError("AdamW: no trainable parameters")
        self.tc = tc
        self.schedule = learning_rate_schedule(tc)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.axis: Optional[Axis] = None
        self.shard_dims: List[Optional[int]] = [None] * len(self.params)
        self.params_sliced = False
        # Under TP: the 'model' axis and which parameters are this rank's
        # slice of a split leaf (the clip sums their squares over it).
        self.model_axis: Optional[Axis] = None
        self.model_split: List[bool] = [False] * len(self.params)

    def learning_rate(self, count: int) -> float:
        return self.schedule(count) if callable(self.schedule) else self.schedule

    def shard_(self, dims: Sequence[Optional[int]], axis: Axis, params_sliced: bool = False) -> None:
        """ZeRO-1: keep the moments of this rank's slice of each parameter
        along its dim in `dims` (None: whole) over the 'data' `axis`. With
        `params_sliced` (ZeRO-3/FSDP) each parameter with a dim is that
        slice already, and so are its moments: the update reads sliced
        gradients and leaves the slices as they are (no gather)."""
        if self.axis is not None:
            raise ValueError("AdamW: the moments are sharded already")
        if len(dims) != len(self.params):
            raise ValueError(f"AdamW: {len(dims)} shard dims for {len(self.params)} parameters")
        if any(d is not None for d in dims) and (axis is None or axis.size < 2):
            raise ValueError("AdamW: sharded moments need a 'data' axis of more than one rank")
        self.axis, self.shard_dims, self.params_sliced = axis, list(dims), params_sliced
        if not params_sliced:
            self.mu = [self.local(i, m).clone() for i, m in enumerate(self.mu)]
            self.nu = [self.local(i, v).clone() for i, v in enumerate(self.nu)]

    def split_over_model_(self, split: Sequence[bool], axis: Axis) -> None:
        """Under TP: `split[i]` says parameter i is this rank's slice of a
        leaf split over the 'model' `axis` (its moments are that slice's)."""
        if len(split) != len(self.params):
            raise ValueError(f"AdamW: {len(split)} split flags for {len(self.params)} parameters")
        self.model_axis, self.model_split = axis, list(split)

    def local(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of x, a tensor shaped as parameter i
        before any 'data' slice (`unsliced_shape`), along the parameter's
        shard dim; x itself where it is not sharded."""
        d = self.shard_dims[i]
        if d is None:
            return x
        k = x.shape[d] // self.axis.size
        return x.narrow(d, self.axis.index * k, k)

    def unsliced_shape(self, i: int) -> tuple:
        """Parameter i's shape before the FSDP 'data' slice (its own shape
        unless the parameters are slices)."""
        shape, d = tuple(self.params[i].shape), self.shard_dims[i]
        if not self.params_sliced or d is None:
            return shape
        return shape[:d] + (shape[d] * self.axis.size,) + shape[d + 1:]

    def moment_bytes(self) -> int:
        """This rank's bytes of mu and nu."""
        return sum(t.numel() * t.element_size() for t in (*self.mu, *self.nu))

    def _global_norm(self, grads: List[torch.Tensor], sharded_grads: bool) -> torch.Tensor:
        sliced = [sharded_grads and d is not None for d in self.shard_dims]
        split = self.model_split
        if not (any(sliced) or any(split)):
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # The squares of ZeRO-2's slices summed over 'data', those of TP's
        # slices over 'model' (both where both split the leaf), each leaf
        # whole on every rank counted once.
        def squares(data_sliced: bool, model_split: bool) -> torch.Tensor:
            gs = [g for g, a, b in zip(grads, sliced, split) if a == data_sliced and b == model_split]
            if not gs:
                return torch.zeros((), device=grads[0].device)
            return torch.stack(torch._foreach_norm(gs, 2, dtype=torch.float32)).square().sum()

        over_data = collectives.all_reduce(torch.stack([squares(True, True), squares(True, False)]), self.axis)
        over_model = collectives.all_reduce(over_data[0] + squares(False, True), self.model_axis)
        return (over_model + over_data[1] + squares(False, False)).sqrt()

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None, sharded_grads: bool = False) -> None:
        """One update from `grads` (each parameter's gradient; default its
        `.grad`, zeros where None). With `sharded_grads` (ZeRO-2; always
        under FSDP) the gradient of each sharded parameter is this rank's
        slice."""
        tc = self.tc
        if grads is None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        grads = list(grads)
        if tc.grad_clip_norm is not None:
            g_norm = self._global_norm(grads, sharded_grads or self.params_sliced)
            clipped = torch._foreach_mul(torch._foreach_div(grads, g_norm), tc.grad_clip_norm)
            keep = g_norm < tc.grad_clip_norm
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        # Sharded moments: the update of this rank's slice (a view where the
        # slice is contiguous, else a copy), gathered below; under FSDP the
        # parameters are the slices, updated in place.
        sharded = [] if self.params_sliced else [i for i, d in enumerate(self.shard_dims) if d is not None]
        targets = list(self.params)
        for i in sharded:
            targets[i] = self.local(i, self.params[i]).contiguous()
            if not sharded_grads:
                grads[i] = self.local(i, grads[i]).contiguous()
        lr = self.learning_rate(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, tc.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - tc.b1)
        torch._foreach_mul_(self.nu, tc.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - tc.b2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - tc.b1 ** self.count)
        den = torch._foreach_div(self.nu, 1.0 - tc.b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        updates = torch._foreach_div(mu_hat, den)
        if tc.weight_decay:
            torch._foreach_add_(updates, targets, alpha=tc.weight_decay)
        torch._foreach_add_(targets, updates, alpha=-lr)
        for i in sharded:  # the updated bits of every slice, so every rank holds the same parameters
            self.params[i].copy_(collectives.all_gather(targets[i], self.axis, self.shard_dims[i]))
        for p in self.params:
            p.grad = None


def make_optimizer(tc: TrainConfig, params: Sequence[torch.Tensor]) -> AdamW:
    """The optimizer over the trainable parameters only (frozen ones are not
    passed: they get no gradient and no moments)."""
    return AdamW(params, tc)


def _rows_loss(model: LTXModel, batch: TrainBatch, generator: Optional[torch.Generator], tc: TrainConfig,
               rows: slice, given=(None, None, None)) -> torch.Tensor:
    """The loss over `rows` of `batch`, the sigmas and noise drawn (or
    `given`) for every row of it first."""
    draws = draw_noise(batch, generator, tc, *given)
    return rectified_flow_loss(model, batch.map(lambda x: x[rows]), None, tc,
                               *(None if x is None else x[rows] for x in draws))


class _Gradients:
    """Where a step's gradients gather. One microbatch without ZeRO-2: each
    parameter's `.grad`, averaged over 'data' after the backward. Otherwise
    post-accumulate hooks take each `.grad` as the backward produces it and
    free it: under accumulation into an fp32 accumulator (JAX's
    `_accumulated_value_and_grad`), under ZeRO-2 reduce-scattered first, so
    that the store holds this rank's slice of each sharded parameter (in
    the parameter's dtype for one microbatch). Under TP the gradients of
    the parameters flagged in `partial` (each rank's share of a replicated
    LoRA factor's gradient) are summed over the 'model' axis in fp32 first,
    before the 'data' average; no other gradient is reduced over 'model'.
    Under FSDP (the optimizer's parameters are slices) the gradient of
    each sliced parameter arrives as its slice, summed over 'data' by the
    gathers' backward: only the average is left to take (under
    accumulation in the fp32 store); the leaves kept whole are all-reduced
    as under plain DP."""

    def __init__(self, optimizer: AdamW, axis: Optional[Axis], accum_steps: int, zero2: bool,
                 model_axis: Optional[Axis] = None, partial: Optional[Sequence[bool]] = None):
        self.opt, self.axis, self.accum, self.zero2 = optimizer, axis, accum_steps, zero2
        self.size = 1 if axis is None else axis.size
        self.model_axis = model_axis
        self.partial = [False] * len(optimizer.params) if partial is None else list(partial)
        self.hooked = zero2 or accum_steps > 1
        self.store: List[Optional[torch.Tensor]] = [None] * len(optimizer.params)
        self.active = False
        if self.hooked:
            for i, p in enumerate(optimizer.params):
                p.register_post_accumulate_grad_hook(lambda p, i=i: self._take(i, p))

    def _whole(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """g, or for a partial leaf its sum over 'model' (fp32)."""
        return collectives.all_reduce(g, self.model_axis) if self.partial[i] else g

    def _over_data(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """g summed over 'data' in fp32: all-reduced, or as it is where the
        FSDP gathers' backward has reduce-scattered it into the slice."""
        if self.opt.params_sliced and self.opt.shard_dims[i] is not None:
            return g.float()
        return collectives.all_reduce(g, self.axis)

    def _take(self, i: int, p: torch.Tensor) -> None:
        if not self.active:
            return
        g, p.grad = p.grad, None
        g = self._whole(i, g)
        prev = self.store[i]
        if self.zero2:
            d = self.opt.shard_dims[i]
            g = collectives.all_reduce(g, self.axis) if d is None else collectives.reduce_scatter(g, self.axis, d)
            if self.accum == 1:  # this rank's slice of the mean gradient, in the parameter's dtype
                g = g / self.size
                self.store[i] = (g if prev is None else prev.float() + g).to(p.dtype)
                return
        else:
            g = g.float()
        if prev is None:
            self.store[i] = g
        else:
            prev.add_(g)

    def nbytes(self) -> int:
        """The bytes of gradient the update will read, before any reduce."""
        held = self.store if self.hooked else [p.grad for p in self.opt.params]
        return sum(g.numel() * g.element_size() for g in held if g is not None)

    def finish(self) -> List[torch.Tensor]:
        """The update's gradients: the mean over the microbatches and the
        ranks, in each parameter's dtype (ZeRO-2: this rank's slices)."""
        opt, n = self.opt, self.size * self.accum
        if not self.hooked:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params]
            grads = [self._whole(i, g).to(g.dtype) if self.size == 1 else
                     (self._over_data(i, self._whole(i, g)) / self.size).to(g.dtype)
                     for i, g in enumerate(grads)]
            return grads
        grads = []
        for i, p in enumerate(opt.params):
            g, self.store[i] = self.store[i], None
            if g is None:
                g = torch.zeros_like(opt.local(i, p) if self.zero2 else p)
            elif self.accum > 1:
                if not self.zero2 and self.size > 1:
                    g = self._over_data(i, g)
                g = (g * (1.0 / n)).to(p.dtype)
            grads.append(g)
        return grads


def _check_fsdp_layout(model: LTXModel, optimizer: AdamW, param_shardings, opt_state_shardings,
                       data_axis: Optional[Axis]) -> bool:
    """Whether the step trains FSDP slices: refuses a sliced model without
    its layout, a layout without a sliced model, another axis than the
    slices', and a layout (or ZeRO layout) that is not the one each
    parameter was sliced with."""
    axis = model_fsdp_axis(model)
    if param_shardings is None:
        if axis is not None:
            raise ValueError("the model's parameters are FSDP slices over 'data': pass param_shardings "
                             "(fsdp_param_shardings of the trainable parameters)")
        return False
    if axis is None:
        raise ValueError("param_shardings: the model is not sliced over a 'data' axis "
                         "(parallel.fsdp.shard_model_fsdp_)")
    if data_axis is not axis:
        raise ValueError("param_shardings: data_axis must be the 'data' axis the model is sliced over")
    names = parameter_names(model, optimizer.params)
    layout = list(param_shardings)
    if len(layout) != len(names):
        raise ValueError(f"param_shardings: {len(layout)} dims for {len(names)} parameters")
    for name, p, d in zip(names, optimizer.params, layout):
        if not is_fsdp(p) or fsdp_dim(p) != d:
            raise ValueError(f"param_shardings: {name} is given dim {d}, but the model slices it along "
                             f"{fsdp_dim(p)}")
    if opt_state_shardings is not None and list(opt_state_shardings) != layout:
        raise ValueError("ZeRO-3: the moments and gradients take the parameters' layout (the ZeRO helpers give "
                         "it for sliced parameters)")
    return True


def make_train_step(
    model: LTXModel,
    optimizer: AdamW,
    tc: TrainConfig = TrainConfig(),
    accum_steps: int = 1,
    opt_state_shardings: Optional[Sequence[Optional[int]]] = None,
    grad_shardings: Optional[Sequence[Optional[int]]] = None,
    param_shardings: Optional[Sequence[Optional[int]]] = None,
    data_axis: Optional[Axis] = None,
):
    """One step `(batch, generator, sigmas=None, noise=None, audio_noise=None)
    -> loss`: loss, backward, optimizer update.

    accum_steps > 1: the batch's leading dim splits into `accum_steps`
    microbatches whose mean gradient, accumulated in fp32 as the JAX step
    accumulates it, feeds ONE update.

    data_axis, a 'data' mesh `Axis` of D ranks (every rank calls the step
    with the same whole batch and generator): each rank takes its D-th of
    the rows of every microbatch, the sigmas and noise drawn for the whole
    microbatch (world 1's numbers); the gradients are averaged over 'data'
    in fp32 after the backward, and the loss returned is the mean over the
    ranks. opt_state_shardings (ZeRO-1, `zero1_opt_state_shardings`) shards
    the optimizer's moments; grad_shardings (ZeRO-2, `zero2_grad_shardings`;
    the moments take the same layout) reduce-scatters each gradient as the
    backward produces it.

    A model made a TP shard over a 'model' axis (`sharding.shard_model_`,
    its `cfg.tp_axis` set; every rank of a 'model' line calls the step with
    the same batch): each rank trains its slices of the split leaves and
    its copy of the replicated ones, the gradients coming whole out of the
    differentiable forward except the replicated LoRA factors', which are
    summed over 'model' here; AdamW's moments are the rank's slices, and
    its clip sums the split leaves' squares over 'model'. With a
    `data_axis` this is TP x DP; the ZeRO layouts then take the parameters'
    names (`zero1_opt_state_shardings(..., names)`).

    param_shardings (ZeRO-3/FSDP): a model sliced over `data_axis`
    (`parallel.fsdp.shard_model_fsdp_`) with, for each of the optimizer's
    parameters, its 'data' dim (`fsdp_param_shardings(model, data_axis,
    names)`; it must be the layout the model was sliced with, as JAX's
    must be the placement's). The forward gathers the weights and the
    gathers' backward reduce-scatters each gradient into its slice (the
    leaves kept whole are all-reduced); AdamW keeps moments of the slices
    and updates the slices in place, gathering nothing after; its clip sums
    the sliced leaves' squares over 'data' (and 'model'). The ZeRO layouts,
    if given, must be this one. A model under sequence parallelism raises
    NotImplementedError.

    `step.stats["grad_bytes"]`: the bytes of gradient the last update read
    (full-size `.grad`s, the fp32 accumulator, or ZeRO-2's and FSDP's
    slices); `step.stats["bytes"]`: the collective bytes the last step
    moved, by "axis route" (`collectives.STATS["axes"]`: 'model' and 'data'
    apart), `step.stats["op_bytes"]` by "operation axis route"."""
    seq = getattr(model.cfg, "sequence_axis", None)
    if seq is not None and seq.size > 1:
        raise NotImplementedError("sequence_axis: training under sequence parallelism is not supported (the "
                                  "training mesh is (data, model), as the JAX CLI's)")
    tp = model_tp_axis(model)
    partial = None
    if tp is not None:
        names = parameter_names(model, optimizer.params)
        optimizer.split_over_model_([tp_split_dim(n) is not None for n in names], tp)
        partial = [tp_partial_grad(n) for n in names]
    if grad_shardings is not None:
        if opt_state_shardings is not None and list(opt_state_shardings) != list(grad_shardings):
            raise ValueError("ZeRO-2: the moments take the gradients' layout; pass one layout")
        opt_state_shardings = grad_shardings
    fsdp = _check_fsdp_layout(model, optimizer, param_shardings, opt_state_shardings, data_axis)
    size, index = (1, 0) if data_axis is None else (data_axis.size, data_axis.index)
    if fsdp:
        optimizer.shard_(param_shardings, data_axis, params_sliced=True)
    elif opt_state_shardings is not None:
        optimizer.shard_(opt_state_shardings, data_axis)
    grads = _Gradients(optimizer, data_axis, accum_steps, zero2=not fsdp and grad_shardings is not None and size > 1,
                       model_axis=tp, partial=partial)
    stats = {"grad_bytes": 0, "bytes": {}, "op_bytes": {}}

    def step(batch: TrainBatch, generator: Optional[torch.Generator] = None,
             sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             audio_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = batch.x0.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} must divide --accum-steps {accum_steps}")
        mb = b // accum_steps
        if mb % size:
            raise ValueError(f"a microbatch of {mb} rows (batch {b} / --accum-steps {accum_steps}) does not divide "
                             f"over the {size} ranks of 'data'")
        own = slice(index * (mb // size), (index + 1) * (mb // size))
        before = {t: {k: dict(v) for k, v in collectives.STATS[t].items()} for t in ("axes", "op_axes")}
        total = torch.zeros((), device=batch.x0.device)
        grads.active = True
        try:
            for i in range(accum_steps):
                part = slice(i * mb, (i + 1) * mb)
                loss = _rows_loss(model, batch.map(lambda x: x[part]), generator, tc, own,
                                  [None if x is None else x[part] for x in (sigmas, noise, audio_noise)])
                loss.backward()
                total += loss.detach()
        finally:
            grads.active = False
        stats["grad_bytes"] = grads.nbytes()
        optimizer.step(grads.finish(), sharded_grads=grads.zero2)
        loss = total / accum_steps
        loss = loss if size == 1 else collectives.all_reduce(loss, data_axis) / size
        for key, table in (("bytes", "axes"), ("op_bytes", "op_axes")):
            stats[key] = {k: {d: n - before[table].get(k, {}).get(d, 0) for d, n in v.items()}
                          for k, v in collectives.STATS[table].items()}
        return loss

    step.stats = stats
    return step


# EMA (exponential moving average) of the trained parameters, in fp32 so
# small per-step updates do not vanish in bf16.


def init_ema(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """fp32 copies of the optimizer's parameters (never aliases)."""
    return [p.detach().float().clone() for p in params]


def make_ema_update(decay: float) -> Callable[[List[torch.Tensor], Sequence[torch.Tensor]], List[torch.Tensor]]:
    """`(ema, params) -> ema`, updated in place:
    ema = decay * ema + (1 - decay) * params."""

    @torch.no_grad()
    def update(ema: List[torch.Tensor], params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        for e, p in zip(ema, params):
            e.mul_(decay).add_(p.float(), alpha=1.0 - decay)
        return ema

    return update


def ema_params(ema: Sequence[torch.Tensor], like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The EMA cast back to the dtypes of `like` (the live parameters)."""
    return [e.to(p.dtype) for e, p in zip(ema, like)]


def make_eval_step(model: LTXModel, tc: TrainConfig = TrainConfig(), data_axis: Optional[Axis] = None):
    """Validation loss `(batch, generator) -> loss` without gradients, audio
    fields included. Pass a generator seeded per validation batch so
    successive evaluations draw the same sigmas and noise. With a 'data'
    `data_axis` each rank evaluates its share of the rows (the draws made
    for the whole batch, as the train step makes them) and every rank gets
    the mean."""
    size, index = (1, 0) if data_axis is None else (data_axis.size, data_axis.index)

    @torch.no_grad()
    def eval_step(batch: TrainBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b = batch.x0.shape[0]
        if b % size:
            raise ValueError(f"a validation batch of {b} rows does not divide over the {size} ranks of 'data'")
        loss = _rows_loss(model, batch, generator, tc, slice(index * (b // size), (index + 1) * (b // size)))
        return loss if size == 1 else collectives.all_reduce(loss, data_axis) / size

    return eval_step
