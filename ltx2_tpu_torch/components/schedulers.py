"""Sigma schedules (counterpart of ltx2_tpu/components/schedulers.py)."""

DISTILLED_SIGMA_VALUES = [
    1.0, 0.99375, 0.9875, 0.98125, 0.975, 0.909375, 0.725, 0.421875, 0.0,
]

# The distilled recipe's stage 2: the last three steps of the schedule,
# entered at 0.909375 on the upscaled stage-1 latent.
STAGE_2_DISTILLED_SIGMA_VALUES = [0.909375, 0.725, 0.421875, 0.0]
