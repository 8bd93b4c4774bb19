"""Atomic, async, retained checkpoints in the reference's on-disk layout."""

from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
