"""`factorize` / `estimate_rank` — the port's entry points.

Counterpart of ``repro.api.facade``.  The reference runs every call
through its plan cache (``repro.api.plan``); the port calls the
registered solver directly (the plan layer is a later slice,
``ROADMAP.md`` Queue 1 item 7).  ``A`` may be a tensor (kept on its
device), an operator, or a numpy array (moved to ``device``, by default
the CUDA card; without a card that raises).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.api import solvers as _solvers
from repro_torch.api.registry import get_solver
from repro_torch.api.results import Factorization, RankEstimate
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import resolve_generator
from repro_torch.core.operators import (GramOp, KroneckerOp, Operator,
                                        ScaledOp, SparseOp, SumOp,
                                        TransposedOp, as_operator)
from repro_torch.core.rank import numerical_rank

__all__ = ["factorize", "estimate_rank", "resolve_method"]

# tolerance at or above which "auto" picks the sketch (repro.api.plan)
_AUTO_SKETCH_TOL = 1e-4


def _is_matrix_free(op) -> bool:
    """True when materializing ``op`` densely would defeat its structure
    (sparse, Kronecker and Gram operands, through transposes, scalings
    and sums): "auto" then picks the streaming blocked solver."""
    if isinstance(op, (SparseOp, KroneckerOp, GramOp)):
        return True
    if isinstance(op, TransposedOp):
        return _is_matrix_free(op.inner)
    if isinstance(op, ScaledOp):
        return _is_matrix_free(op.op)
    if isinstance(op, SumOp):
        return any(_is_matrix_free(t) for t in op.terms)
    return False


def resolve_method(spec: SVDSpec, like: Any = None) -> str:
    """Resolve ``method="auto"`` under the reference's rule
    (``repro.api.plan.resolve_method``, less its sharded branch): an
    operand flagged ``single_pass_only`` → gnystrom, matrix-free operands
    → fsvd_blocked, and other operands → rsvd when
    ``power_iters > 0`` or ``tol >= 1e-4``, else fsvd."""
    if spec.method != "auto":
        return spec.method
    if like is not None:
        op = like if isinstance(like, Operator) else as_operator(
            like, backend=spec.backend)
        if getattr(op, "single_pass_only", False):
            return "gnystrom"
        if _is_matrix_free(op):
            return "fsvd_blocked"
    if spec.power_iters > 0 or spec.tol >= _AUTO_SKETCH_TOL:
        return "rsvd"
    return "fsvd"


def _spec_of(spec: Optional[SVDSpec], overrides: dict) -> SVDSpec:
    spec = spec or SVDSpec()
    if overrides:
        spec = spec.replace(**overrides)
    return spec


def factorize(A, spec: Optional[SVDSpec] = None, *,
              generator: Optional[torch.Generator] = None, q1=None,
              callback=None, device=None, **overrides) -> Factorization:
    """Rank-``spec.rank`` partial SVD of ``A`` under ``spec``.

    ``generator`` draws the GK start vector (warns and seeds 0 when
    omitted); ``q1`` is an optional start vector (e.g.
    ``prev.warm_start()``, or the reference's own draw in a parity test;
    ``fsvd`` and ``fsvd_blocked`` read it);
    ``callback`` a ``ConvergenceCallback``.  Keyword overrides merge into
    the spec: ``factorize(A, rank=20)`` == ``factorize(A, SVDSpec(rank=20))``.
    """
    spec = _spec_of(spec, overrides)
    op = as_operator(A, backend=spec.backend, device=device)
    method = resolve_method(spec, op)
    if method in _solvers.NOT_PORTED:
        raise _solvers.not_ported(method)
    return get_solver(method)(op, spec, generator=generator, q1=q1,
                              callback=callback)


def estimate_rank(A, spec: Optional[SVDSpec] = None, *,
                  generator: Optional[torch.Generator] = None,
                  sigma_tol: Optional[float] = None, device=None,
                  **overrides) -> RankEstimate:
    """Numerical rank of ``A`` (paper Alg 3) under ``spec``.

    ``spec.max_iters`` caps the GK sweep and sizes its basis buffers
    (default ``min(m, n)``: pass it for a large operand); ``spec.tol`` is
    the breakdown epsilon; ``sigma_tol`` overrides the Alg-3 counting
    threshold.  ``spec.host_loop=None`` means the early-exit host loop.
    """
    spec = _spec_of(spec, overrides)
    if spec.precision is not None:
        raise ValueError(
            "estimate_rank requires full-precision bases; got "
            f"spec.precision={spec.precision!r} (rank detection counts "
            "directions the stored basis can certify — use precision=None)")
    op = as_operator(A, backend=spec.backend, device=device)
    generator = resolve_generator(generator, caller="estimate_rank",
                                  device=op.device)
    host_loop = True if spec.host_loop is None else spec.host_loop
    res = numerical_rank(op, max_iters=spec.max_iters, eps=spec.tol,
                         relative_eps=spec.relative_tol, sigma_tol=sigma_tol,
                         generator=generator, host_loop=host_loop,
                         reorth_passes=spec.reorth_passes, dtype=spec.dtype)
    return RankEstimate(res.rank, res.gk_iterations, res.eigenvalues,
                        method="gk")
