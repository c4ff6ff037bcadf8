"""Training (port of `repro.train`): the microbatched AdamW step and the
Trainer loop with checkpoints, heartbeats and straggler events."""
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer

__all__ = ["Trainer", "init_train_state", "make_train_step"]
