"""Rectified-flow fine-tuning of the DiT on one device (counterpart of
ltx2_tpu/training/trainer.py).

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
Not ported yet: the ZeRO-1/2/3 and FSDP sharding arguments of
`make_train_step` (they raise NotImplementedError).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from ltx2_tpu_torch.models.transformer.model import LTXModel, LTXModelType, Modality, ltx_model_apply


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
    b, device = x0.shape[0], x0.device
    if sigmas is None:
        sigmas = _sample_sigmas(generator, b, tc, device)
    sigmas = sigmas.float()
    s = sigmas[:, None, None]

    def noised(x0: torch.Tensor, eps: Optional[torch.Tensor]):
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=device)
        eps = eps.float()
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


class AdamW:
    """optax.chain(clip_by_global_norm(tc.grad_clip_norm), adamw(schedule,
    b1, b2, eps=1e-8, weight_decay)) over `params`, updated in place from
    their `.grad` (which `step` then clears). Moments are kept in the
    parameters' dtype, as optax keeps them."""

    def __init__(self, params: Sequence[torch.Tensor], tc: TrainConfig):
        self.params = list(params)
        if not self.params:
            raise ValueError("AdamW: no trainable parameters")
        self.tc = tc
        self.schedule = learning_rate_schedule(tc)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self, count: int) -> float:
        return self.schedule(count) if callable(self.schedule) else self.schedule

    @torch.no_grad()
    def step(self) -> None:
        tc = self.tc
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if tc.grad_clip_norm is not None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clipped = torch._foreach_mul(torch._foreach_div(grads, g_norm), tc.grad_clip_norm)
            keep = g_norm < tc.grad_clip_norm
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
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
            torch._foreach_add_(updates, self.params, alpha=tc.weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-lr)
        for p in self.params:
            p.grad = None


def make_optimizer(tc: TrainConfig, params: Sequence[torch.Tensor]) -> AdamW:
    """The optimizer over the trainable parameters only (frozen ones are not
    passed: they get no gradient and no moments)."""
    return AdamW(params, tc)


def make_train_step(
    model: LTXModel,
    optimizer: AdamW,
    tc: TrainConfig = TrainConfig(),
    accum_steps: int = 1,
    opt_state_shardings=None,
    grad_shardings=None,
    param_shardings=None,
):
    """One step `(batch, generator, sigmas=None, noise=None, audio_noise=None)
    -> loss`: loss, backward, optimizer update, on one device.

    accum_steps > 1: the batch's leading dim splits into `accum_steps`
    microbatches whose mean gradient feeds ONE update (each microbatch's
    backward adds into the fp32 `.grad` of the trainable parameters).
    The ZeRO / FSDP sharding arguments of the JAX step are not ported."""
    for name, value in (("opt_state_shardings", opt_state_shardings), ("grad_shardings", grad_shardings),
                        ("param_shardings", param_shardings)):
        if value is not None:
            raise NotImplementedError(f"{name}: ZeRO/FSDP sharding is not ported; the port trains on one device")

    def step(batch: TrainBatch, generator: Optional[torch.Generator] = None,
             sigmas: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             audio_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = batch.x0.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} must divide --accum-steps {accum_steps}")
        mb = b // accum_steps
        total = torch.zeros((), device=batch.x0.device)
        for i in range(accum_steps):
            part = slice(i * mb, (i + 1) * mb)
            loss = rectified_flow_loss(
                model, batch.map(lambda x: x[part]), generator, tc,
                *(None if x is None else x[part] for x in (sigmas, noise, audio_noise)),
            )
            (loss / accum_steps).backward()
            total += loss.detach()
        optimizer.step()
        return total / accum_steps

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


def make_eval_step(model: LTXModel, tc: TrainConfig = TrainConfig()):
    """Validation loss `(batch, generator) -> loss` without gradients, audio
    fields included. Pass a generator seeded per validation batch so
    successive evaluations draw the same sigmas and noise."""

    @torch.no_grad()
    def eval_step(batch: TrainBatch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return rectified_flow_loss(model, batch, generator, tc)

    return eval_step
