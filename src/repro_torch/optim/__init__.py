"""The optimizer (copy of ``repro/optim``): AdamW with float32 moments and
global-norm clipping, functional and in place (and on ZeRO-1 moments
across a grid mesh), and the warm-up cosine schedule."""

from .adamw import (AdamWState, adamw_init, adamw_init_zero1, adamw_update, adamw_update_,
                    adamw_update_zero1_, global_norm_clip)
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_", "global_norm_clip",
           "adamw_init_zero1", "adamw_update_zero1_", "warmup_cosine"]
