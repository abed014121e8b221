"""Training of the port (``repro.train``): loop and checkpoints."""
from . import checkpoint
from .loop import (TrainConfig, TrainState, Watchdog, batch_to_device,
                   init_state, make_optimizer, make_train_step,
                   resolve_model_config, tokens_per_s, train)

__all__ = ["checkpoint", "TrainConfig", "TrainState", "Watchdog",
           "batch_to_device", "init_state", "make_optimizer",
           "make_train_step", "resolve_model_config", "tokens_per_s",
           "train"]
