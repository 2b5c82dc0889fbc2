"""Solver registry: methods plug into the facade by name.

A solver is ``fn(A: Operator, spec: SVDSpec, *, generator, q1, callback)
-> Factorization``.  Counterpart of ``repro.api.registry``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

_SOLVERS: Dict[str, Callable] = {}


def register_solver(name: str, fn: Optional[Callable] = None):
    """Register ``fn`` under ``name`` (usable as a decorator); the last
    registration wins."""
    def _register(f):
        _SOLVERS[name] = f
        return f

    if fn is not None:
        return _register(fn)
    return _register


def get_solver(name: str) -> Callable:
    try:
        return _SOLVERS[name]
    except KeyError:
        raise KeyError(
            f"no solver registered under {name!r}; available: "
            f"{sorted(_SOLVERS)}") from None


def available_solvers() -> tuple[str, ...]:
    return tuple(sorted(_SOLVERS))
