"""The optimizer (copy of ``repro/optim``): AdamW with float32 moments and
global-norm clipping, functional and in place, and the warm-up cosine
schedule."""

from .adamw import AdamWState, adamw_init, adamw_update, adamw_update_, global_norm_clip
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_", "global_norm_clip",
           "warmup_cosine"]
