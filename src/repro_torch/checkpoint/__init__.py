"""Checkpoints in the reference's ``arrays.npz`` + ``tree.json`` layout,
and the background-writing manager (counterpart of ``repro.checkpoint``)."""
from .io import (save_checkpoint, load_checkpoint, latest_step,
                 complete_steps, snapshot_tree, commit_snapshot,
                 step_dirname, read_run_meta)
from .manager import CheckpointManager

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "complete_steps", "snapshot_tree", "commit_snapshot",
           "step_dirname", "read_run_meta", "CheckpointManager"]
