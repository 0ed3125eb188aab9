"""Checkpoint save/restore in the reference's npz + json format
(``checkpoint.io``)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    latest_checkpoint,
    latest_fsdp_checkpoint,
    leaves_with_paths,
    restore_checkpoint,
    restore_checkpoint_fsdp,
    save_checkpoint,
    save_checkpoint_fsdp,
)
