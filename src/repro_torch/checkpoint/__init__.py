"""Checkpoints of parameter dicts, flat banks and round states — the port
of ``repro.checkpoint``."""
from repro_torch.checkpoint.io import (
    latest_checkpoint,
    restore,
    restore_bank,
    restore_state,
    save,
    save_bank,
    save_state,
)

__all__ = [
    "save",
    "restore",
    "latest_checkpoint",
    "save_bank",
    "restore_bank",
    "save_state",
    "restore_state",
]
