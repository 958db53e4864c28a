"""Checkpointing: atomic, async, keep-N, elastic restore."""
from .manager import CheckpointManager, save_pytree, restore_pytree

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]
