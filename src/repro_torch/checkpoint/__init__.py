"""Checkpoints: atomic, crc-checked snapshots of a tree of arrays, in the
JAX package's on-disk layout (`checkpoint.manager`)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruption,
    latest_step,
    list_checkpoints,
    load_manifest,
    restore_checkpoint,
    restore_checkpoint_tree,
    save_checkpoint,
)
