"""Training: the train step and Trainer, optimizers, checkpoints,
perplexity and generative eval."""

from .checkpoint import CheckpointManager, load_pytree, save_pytree
from .evaluate import generative_eval, perplexity_eval
from .optim import dequantize_blockwise, make_optimizer, make_schedule, quantize_blockwise
from .trainer import TrainConfig, Trainer, make_train_step, params_tree

__all__ = [
    "CheckpointManager",
    "TrainConfig",
    "Trainer",
    "dequantize_blockwise",
    "generative_eval",
    "load_pytree",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "params_tree",
    "perplexity_eval",
    "quantize_blockwise",
    "save_pytree",
]
