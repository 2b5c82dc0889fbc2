"""One random-generator policy for every solver.

Counterpart of ``repro.core._keys``: a solver takes an explicit
``torch.Generator`` where the reference takes a PRNG key.  When none is
given, :func:`resolve_generator` keeps a deterministic default (seed 0)
but warns, so implicit seeding is always visible.  The two packages draw
different numbers from the same seed; tests hand both the same start
vector instead.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

IMPLICIT_KEY_MSG = (
    "{caller}: no torch.Generator was supplied; falling back to a "
    "generator seeded with 0. Pass generator= explicitly (or a warm-start "
    "q1) to silence this warning and control reproducibility."
)


class ImplicitKeyWarning(UserWarning):
    """Raised (as a warning) when a solver self-seeds with seed 0."""


def resolve_generator(generator: Optional[torch.Generator], *,
                      caller: str = "solver", device=None,
                      warn: bool = True) -> torch.Generator:
    """Return ``generator`` or a seed-0 generator on ``device``, warning on
    the latter."""
    if generator is None:
        if warn:
            warnings.warn(IMPLICIT_KEY_MSG.format(caller=caller),
                          ImplicitKeyWarning, stacklevel=3)
        return torch.Generator(device=device or "cpu").manual_seed(0)
    return generator


def fold_in(seed: int, *tags: int, device=None) -> torch.Generator:
    """A fresh generator on ``device`` (default: the CPU) seeded from
    (``seed``, ``tags``): the port's ``jax.random.fold_in``.  The same
    numbers give the same stream on every run; different tags give
    unrelated streams."""
    state = np.random.SeedSequence([seed, *tags]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device or "cpu").manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def normal(generator: torch.Generator, shape, *, device=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws of ``shape``, made in f32 on the generator's
    own device and moved to ``device`` (default: that device) and
    ``dtype``."""
    z = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return z.to(device=device or generator.device, dtype=dtype)


def integers(generator: torch.Generator, high: int, shape, *,
             device=None) -> torch.Tensor:
    """Uniform int32 draws from [0, high), made on the generator's device
    and moved to ``device``."""
    z = torch.randint(0, high, shape, generator=generator, dtype=torch.int32,
                      device=generator.device)
    return z.to(device or generator.device)
