"""Checkpoint save/restore in the reference's npz + json format
(``checkpoint.io``)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    latest_checkpoint,
    leaves_with_paths,
    restore_checkpoint,
    save_checkpoint,
)
