"""Optimizers and gradient compression of the port (``repro.optim``)."""
from .adamw import (Optimizer, AdamWState, AdafactorState, adamw, adafactor,
                    apply_updates, global_norm, clip_by_global_norm,
                    clip_by_global_norm_, cosine_schedule, linear_schedule)
from .compression import (EFState, init_error_feedback, int8_compress,
                          topk_compress)

__all__ = ["Optimizer", "AdamWState", "AdafactorState", "adamw", "adafactor",
           "apply_updates", "global_norm", "clip_by_global_norm",
           "clip_by_global_norm_", "cosine_schedule", "linear_schedule",
           "EFState", "init_error_feedback", "int8_compress",
           "topk_compress"]
