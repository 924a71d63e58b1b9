"""Fine-tuning of the DiT (counterpart of ltx2_tpu/training)."""

from ltx2_tpu_torch.training.trainer import (
    AUDIO_BRANCH_PATTERN,
    AdamW,
    TrainBatch,
    TrainConfig,
    ema_params,
    freeze_audio_branch_mask,
    init_ema,
    learning_rate_schedule,
    make_ema_update,
    make_eval_step,
    make_optimizer,
    make_train_step,
    rectified_flow_loss,
    trainable_mask,
)

__all__ = [
    "AUDIO_BRANCH_PATTERN",
    "AdamW",
    "TrainBatch",
    "TrainConfig",
    "ema_params",
    "freeze_audio_branch_mask",
    "init_ema",
    "learning_rate_schedule",
    "make_ema_update",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "rectified_flow_loss",
    "trainable_mask",
]
