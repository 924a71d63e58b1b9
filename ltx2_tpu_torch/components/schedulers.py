"""Sigma schedules (counterpart of ltx2_tpu/components/schedulers.py).

A schedule is steps + 1 values made once per generation on the host, in
float64 numpy with float32 out, as the JAX package makes them."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

BASE_SHIFT_ANCHOR = 1024
MAX_SHIFT_ANCHOR = 4096

DISTILLED_SIGMA_VALUES = [
    1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0,
]

# The distilled recipe's stage 2: the last three steps of the schedule,
# entered at 0.909375 on the upscaled stage-1 latent.
STAGE_2_DISTILLED_SIGMA_VALUES = [0.909375, 0.725, 0.421875, 0.0]


class LTX2Scheduler:
    """The default LTX-2 schedule: linspace(1, 0, steps + 1), shifted by a
    sigmoid whose shift is linear in the token count (base_shift at 1024
    tokens, max_shift at 4096; 4096 when no count is given), then
    stretched so that the last non-zero sigma lands on `terminal`."""

    def execute(
        self,
        steps: int,
        tokens: Optional[int] = None,
        latent_shape: Optional[Sequence[int]] = None,
        max_shift: float = 2.05,
        base_shift: float = 0.95,
        stretch: bool = True,
        terminal: float = 0.1,
        **_kwargs,
    ) -> np.ndarray:
        if tokens is None:
            tokens = int(np.prod(latent_shape[2:])) if latent_shape is not None else MAX_SHIFT_ANCHOR
        sigmas = np.linspace(1.0, 0.0, steps + 1)
        mm = (max_shift - base_shift) / (MAX_SHIFT_ANCHOR - BASE_SHIFT_ANCHOR)
        b = base_shift - mm * BASE_SHIFT_ANCHOR
        exp_shift = math.exp(tokens * mm + b)
        with np.errstate(divide="ignore"):
            sigmas = np.where(sigmas != 0,
                              exp_shift / (exp_shift + (1.0 / np.where(sigmas != 0, sigmas, 1.0) - 1.0)), 0.0)
        if stretch and steps > 0:
            one_minus = 1.0 - sigmas
            scale_factor = one_minus[steps - 1] / (1.0 - terminal)
            # steps = 1 leaves [1, 0]: the last non-zero sigma is already 1,
            # the stretch is undefined, and [1, 0] is the schedule.
            if scale_factor != 0.0:
                sigmas = np.where(sigmas != 0, 1.0 - one_minus / scale_factor, sigmas)
        return sigmas.astype(np.float32)


def get_sigma_schedule(num_steps: int, distilled: bool = False, tokens: Optional[int] = None,
                       latent_shape: Optional[Sequence[int]] = None) -> np.ndarray:
    if distilled:
        return np.array(DISTILLED_SIGMA_VALUES, dtype=np.float32)
    return LTX2Scheduler().execute(steps=num_steps, tokens=tokens, latent_shape=latent_shape)
