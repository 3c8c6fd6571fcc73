"""Checkpoints (copy of ``repro/checkpoint``): atomic ``.npz`` saves that
interchange with the JAX package's, keep-last-k and torn-file fallback."""

from .checkpoint import CheckpointManager, restore_pytree, save_pytree

__all__ = ["save_pytree", "restore_pytree", "CheckpointManager"]
