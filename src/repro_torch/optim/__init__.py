"""Optimizer substrate of the port: AdamW, schedules, clipping and gradient
accumulation (counterpart of ``repro.optim``)."""
from .accumulate import microbatch_grads
from .adamw import (AdamWConfig, adamw_update, clip_by_global_norm,
                    cosine_schedule, global_norm, init_opt_state)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "microbatch_grads"]
