"""Fine-tuning of the video DiT (counterpart of ltx2_tpu/training)."""

from ltx2_tpu_torch.training.trainer import (
    AdamW,
    TrainBatch,
    TrainConfig,
    ema_params,
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
    "AdamW",
    "TrainBatch",
    "TrainConfig",
    "ema_params",
    "init_ema",
    "learning_rate_schedule",
    "make_ema_update",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "rectified_flow_loss",
    "trainable_mask",
]
