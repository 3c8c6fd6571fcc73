"""The optimizer (copy of ``repro/optim/adamw.py``): AdamW with float32
moments and global-norm clipping."""

from .adamw import AdamWState, adamw_init, adamw_update, global_norm_clip

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm_clip"]
