"""Learning-rate schedules (pure functions of the step).  Counterpart of
``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimConfig


def make_schedule(cfg: OptimConfig):
    """step (an int or a tensor) -> lr (an f32 tensor on the step's
    device): linear warmup, then cosine, linear or constant."""
    base, warm, total = cfg.lr, cfg.warmup_steps, cfg.total_steps

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm_lr = base * (step + 1.0) / max(warm, 1)
        frac = ((step - warm) / max(total - warm, 1)).clamp(0.0, 1.0)
        if cfg.schedule == "cosine":
            rest = base * 0.5 * (1.0 + torch.cos(math.pi * frac))
        elif cfg.schedule == "linear":
            rest = base * (1.0 - frac)
        else:                       # constant
            rest = torch.full_like(frac, base)
        return torch.where(step < warm, warm_lr, rest)

    return sched
