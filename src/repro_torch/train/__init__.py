"""Training: the LM train step (AdamW with optional 8-bit states,
gradient compression, checkpoints) and the GNN train step with the
``gnn_train`` smoke."""

from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import (TrainStepConfig, init_train_state, make_train_step,
                         train_state_from_jax)

__all__ = [
    "AdamWConfig",
    "CheckpointManager",
    "TrainStepConfig",
    "adamw_init",
    "adamw_update",
    "init_train_state",
    "make_train_step",
    "train_state_from_jax",
]
