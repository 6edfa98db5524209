"""Training (port of ``repro.training``): AdamW with a cosine schedule and
global-norm clipping, the train step (gradient accumulation, int8 gradient
compression), and checkpoints in the reference's on-disk layout."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optimizer import (
    OptConfig,
    adamw_init,
    adamw_update,
    global_norm,
    lr_at,
    opt_state_from_numpy,
    opt_state_to_numpy,
)
from .train_loop import (
    dequantize_grads,
    init_train_state,
    make_loss,
    make_train_step,
    quantize_grads_int8,
    train_state_from_numpy,
    train_state_shardings,
    train_state_to_numpy,
    value_and_grad,
)

__all__ = [
    "OptConfig", "adamw_init", "adamw_update", "dequantize_grads", "global_norm",
    "init_train_state", "latest_step", "lr_at", "make_loss", "make_train_step",
    "opt_state_from_numpy", "opt_state_to_numpy", "quantize_grads_int8", "restore_checkpoint",
    "save_checkpoint", "train_state_from_numpy", "train_state_shardings", "train_state_to_numpy",
    "value_and_grad",
]
