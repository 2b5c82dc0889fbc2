"""`factorize` / `estimate_rank` — the port's entry points.

Counterpart of ``repro.api.facade``: thin wrappers over the plan layer
(``repro_torch.api.plan``), as in the reference.  Each call builds a
:class:`~repro_torch.api.plan.SolverPlan` (method resolution is
operator-aware) and solves through the process-wide runner cache, so
repeated one-shot calls with the same (spec, operand kind, shape, dtype,
device) share one runner.  ``A`` may be a tensor (kept on its device),
an operator, or a numpy array (moved to ``device``, by default the CUDA
card; without a card that raises).
"""
from __future__ import annotations

from typing import Optional

import torch

# NOTE: the package re-exports the *function* ``plan`` under the same name
# as the module, so bind the names straight off the submodule.
from repro_torch.api.plan import HOST_SIDE_METHODS
from repro_torch.api.plan import plan as _make_plan
from repro_torch.api.plan import resolve_method  # re-export
from repro_torch.api.results import Factorization, RankEstimate
from repro_torch.api.spec import SVDSpec
from repro_torch.core.operators import as_operator

__all__ = ["factorize", "factorize_jit", "estimate_rank", "resolve_method"]


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

    Equivalent to ``plan(spec, like=A).solve(generator=..., q1=...)``.
    """
    spec = _spec_of(spec, overrides)
    op = as_operator(A, backend=spec.backend, device=device)
    return _make_plan(spec, like=op, donate_q1=False).solve(
        generator=generator, q1=q1, callback=callback)


def factorize_jit(spec: SVDSpec, *, donate_q1: bool = True):
    """A solve-many ``fn(A, generator, q1) -> Factorization`` specialized
    to ``spec``: every call runs through the shared plan cache, so two
    handles for the same spec share one runner per operand signature.
    ``q1=None`` uses the generator's start vector.  ``donate_q1`` is kept
    for the reference's signature and has no effect (the port never
    writes into ``q1``).

    Host-loop specs (``host_loop=True`` or a host-side method such as
    ``fsvd_blocked``) have no cached runner and are rejected.
    """
    method = resolve_method(spec)
    if spec.host_loop or method in HOST_SIDE_METHODS:
        raise ValueError(
            f"factorize_jit requires an in-graph solver; method={method!r} "
            f"host_loop={spec.host_loop!r} runs a host-side loop")
    p = _make_plan(spec, donate_q1=donate_q1)

    def run(A, generator=None, q1=None):
        return p.solve(A, generator=generator, q1=q1)

    return run


def estimate_rank(A, spec: Optional[SVDSpec] = None, *,
                  generator: Optional[torch.Generator] = None,
                  sigma_tol: Optional[float] = None, device=None,
                  **overrides) -> RankEstimate:
    """Numerical rank of ``A`` (paper Alg 3) under ``spec``.

    ``spec.max_iters`` caps the GK sweep and sizes its basis buffers
    (default ``min(m, n)``: pass it for a large operand); ``spec.tol`` is
    the breakdown epsilon; ``sigma_tol`` overrides the Alg-3 counting
    threshold.  ``spec.host_loop=None`` means the early-exit host loop.

    Equivalent to ``plan(spec, like=A).estimate(generator=..., ...)``; an
    in-graph estimate shares the plan cache.
    """
    spec = _spec_of(spec, overrides)
    op = as_operator(A, backend=spec.backend, device=device)
    return _make_plan(spec, like=op).estimate(generator=generator,
                                              sigma_tol=sigma_tol)
