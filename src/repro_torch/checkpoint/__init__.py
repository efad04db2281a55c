"""Fault-tolerant checkpoints in the JAX package's format (see store.py)."""

from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
