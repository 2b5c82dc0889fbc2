"""Optimizers of the port (counterpart of ``repro.optim``): AdamW /
SGD(+momentum) with warmup-cosine schedules and global gradient clipping,
as plain functions over name -> tensor dicts."""
from repro_torch.optim.optimizers import (OptState, adamw_init,
                                          apply_updates, global_norm,
                                          make_optimizer, sgd_init)
from repro_torch.optim.schedules import make_schedule

__all__ = ["OptState", "adamw_init", "sgd_init", "apply_updates",
           "global_norm", "make_optimizer", "make_schedule"]
