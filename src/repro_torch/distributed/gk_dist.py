"""Distributed Algorithms 1-3: GK / F-SVD / rank on a sharded operator.

Counterpart of ``repro.distributed.gk_dist``.  ``ShardedOp`` supplies the
one-collective-per-half-step Lanczos seam; the same ``repro_torch.core``
solvers run on top of it, every rank running the same solve (the
algorithm touches A only through products, so distribution is a property
of the operator).

Every registered solver accepts a sharded operand (``factorize(
sharded_operator(A, mesh), spec)`` with ``method`` "fsvd", "rsvd",
"fsvd_blocked", ...), so the ``"fsvd_sharded"`` method registered here
is a shim: it checks the operand, rejects host-loop specs and runs the
plain F-SVD solver.  :func:`sharded_fsvd` / :func:`sharded_rank` compose
:func:`~repro_torch.distributed.matvec.sharded_operator` with the facade.
``repro_torch.api`` imports this module, so the method is always
registered.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch.api.facade import estimate_rank, factorize
from repro_torch.api.registry import register_solver
from repro_torch.api.results import Factorization, RankEstimate
from repro_torch.api.solvers import solve_fsvd
from repro_torch.api.spec import SVDSpec
from repro_torch.core.gk import GKResult, gk_bidiag
from repro_torch.core.linop import ReproDeprecationWarning
from repro_torch.distributed.matvec import ShardedOp, sharded_operator


@register_solver("fsvd_sharded")
def solve_fsvd_sharded(A, spec: SVDSpec, *,
                       generator: Optional[torch.Generator] = None, q1=None,
                       callback=None) -> Factorization:
    """Registration shim: F-SVD on a sharded operator.

    ``A`` must already be a :class:`ShardedOp` (:func:`sharded_fsvd` lays
    a matrix out first; ``method="auto"`` on a sharded operand resolves
    here).  ``host_loop=True`` is rejected: the host loop brings the
    recurrence scalars to the host every iteration, which stalls every
    rank behind that round trip; the fixed-k loop (``host_loop=None`` or
    False) runs instead.

    The method stages through ``repro_torch.api.plan``: the operand key
    covers the ``DeviceMesh`` (shape, axis names, world), the block's
    shape and the logical shape, so plans on different meshes never share
    a runner while repeat solves on one placement reuse it.
    """
    if not isinstance(A, ShardedOp):
        raise TypeError(
            "method='fsvd_sharded' needs a ShardedOp operand; lay the "
            "matrix out with repro_torch.distributed.sharded_fsvd(A, mesh, "
            "...) or sharded_operator(A, mesh).")
    if spec.host_loop:
        raise ValueError(
            "method='fsvd_sharded' does not support host_loop=True: the "
            "early-exit host loop brings device scalars to the host every "
            "iteration, stalling every rank on one round trip per step.  "
            "Use host_loop=None/False (the fixed-k loop), or the plain "
            "'fsvd' method if you accept the per-step sync.")
    out = solve_fsvd(A, spec.replace(host_loop=False), generator=generator,
                     q1=q1, callback=callback)
    return Factorization(out.U, out.s, out.V, out.iterations,
                         out.breakdown, method="fsvd_sharded")


def sharded_fsvd(A, mesh, spec: SVDSpec, *,
                 generator: Optional[torch.Generator] = None,
                 q1=None) -> Factorization:
    """Lay A (dense, ``SparseOp``, ``GramOp`` / ``TransposedOp`` wrapped)
    out on ``mesh`` and run the facade on it (every rank calls this with
    the same A and draws)."""
    return factorize(sharded_operator(A, mesh),
                     spec.replace(method="fsvd_sharded"),
                     generator=generator, q1=q1)


def sharded_rank(A, mesh, spec: Optional[SVDSpec] = None, *,
                 generator: Optional[torch.Generator] = None,
                 **overrides) -> RankEstimate:
    """Numerical rank of a sharded operand through the facade: its
    ``GramOp`` / ``TransposedOp`` unwrapping composes with the sharding
    wrappers, and its host-loop default flips to the fixed-k loop for
    sharded operands."""
    return estimate_rank(sharded_operator(A, mesh), spec,
                         generator=generator, **overrides)


# --------------------------------------------------------------------------
# legacy signatures (deprecated shims over the facade)
# --------------------------------------------------------------------------

def fsvd_sharded(A, mesh, r: int, k: Optional[int] = None,
                 **kw) -> Factorization:
    """Deprecated: use :func:`sharded_fsvd` with an :class:`SVDSpec`."""
    warnings.warn("fsvd_sharded(A, mesh, r, k) is deprecated; use "
                  "sharded_fsvd(A, mesh, SVDSpec(rank=r, max_iters=k)).",
                  ReproDeprecationWarning, stacklevel=2)
    generator = kw.pop("generator", None)
    q1 = kw.pop("q1", None)
    spec = SVDSpec(method="fsvd_sharded", rank=r, max_iters=k, **{
        {"eps": "tol", "relative_eps": "relative_tol"}.get(a, a): v
        for a, v in kw.items()})
    return sharded_fsvd(A, mesh, spec, generator=generator, q1=q1)


def gk_sharded(A, mesh, k: int, **kw) -> GKResult:
    """Deprecated: GK bidiagonalization of A laid out on ``mesh``, with
    the bases gathered to their global rows on every rank."""
    warnings.warn("gk_sharded(A, mesh, k) is deprecated; use "
                  "core.gk.gk_bidiag(sharded_operator(A, mesh), k).",
                  ReproDeprecationWarning, stacklevel=2)
    op = sharded_operator(A, mesh)
    res = gk_bidiag(op, k, **kw)
    return GKResult(res.alphas, res.betas, res.beta1,
                    op.gather_basis(res.P, "right"),
                    op.gather_basis(res.Q, "left"), res.kprime,
                    res.breakdown)


def rank_sharded(A, mesh, **kw) -> RankEstimate:
    """Deprecated alias of :func:`sharded_rank` (keyword arguments in the
    legacy ``core.rank.numerical_rank`` spellings)."""
    warnings.warn("rank_sharded(A, mesh, **kw) is deprecated; use "
                  "sharded_rank(A, mesh, SVDSpec(...)).",
                  ReproDeprecationWarning, stacklevel=2)
    generator = kw.pop("generator", None)
    spec = SVDSpec(
        max_iters=kw.pop("max_iters", None),
        tol=kw.pop("eps", 1e-8),
        relative_tol=kw.pop("relative_eps", True),
        reorth_passes=kw.pop("reorth_passes", 2),
        dtype=kw.pop("dtype", None),
    )
    sigma_tol = kw.pop("sigma_tol", None)
    if kw:
        raise TypeError(f"rank_sharded() got unsupported kwargs: "
                        f"{sorted(kw)}")
    return sharded_rank(A, mesh, spec, generator=generator,
                        sigma_tol=sigma_tol)
