"""Fault-tolerant checkpointing: atomic directories, per-leaf CRC32,
keep-N GC, async writes and solver-session state
(``repro_torch.api.session``).  Counterpart of ``repro.checkpoint``, with
the same on-disk format."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint,
                                          load_session_state,
                                          save_checkpoint,
                                          save_session_state, valid_steps)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint", "save_session_state", "load_session_state",
           "valid_steps"]
