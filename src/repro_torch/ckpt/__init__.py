"""Atomic, async, retained checkpoints in the JAX package's layout."""
from .checkpoint import CheckpointManager, latest_step, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "latest_step", "restore_pytree", "save_pytree"]
