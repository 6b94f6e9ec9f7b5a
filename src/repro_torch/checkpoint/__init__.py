"""Checkpointing of the port: atomic save / restore of dicts of tensors
(counterpart of ``repro.checkpoint``)."""
from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint, tree_paths)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "tree_paths"]
