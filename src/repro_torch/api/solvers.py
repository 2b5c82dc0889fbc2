"""Built-in solver registrations for the facade.

Counterpart of ``repro.api.solvers``: every solver takes the same
(operator, spec, generator, q1) inputs and returns the same
:class:`~repro_torch.api.results.Factorization`, with the reference's
mapping from ``SVDSpec`` fields to solver arguments.  ``fsvd_sharded``
registers from ``repro_torch.distributed.gk_dist``, which
``repro_torch.api`` imports.  ``NOT_PORTED`` is empty: every method of
the reference is ported, and :func:`not_ported` stays for a method that
a later reference change adds.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.registry import register_solver
from repro_torch.api.results import Factorization
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import resolve_generator
from repro_torch.core.fsvd import fsvd as _fsvd
from repro_torch.core.fsvd import fsvd_batched as _fsvd_batched
from repro_torch.core.gk_block import fsvd_blocked as _fsvd_blocked
from repro_torch.core.rsvd import rsvd as _rsvd
from repro_torch.core.sketch import gnystrom as _gnystrom
from repro_torch.core.sketch import rbk as _rbk

NOT_PORTED: dict = {}


def not_ported(method: str) -> NotImplementedError:
    return NotImplementedError(
        f"method={method!r} is not ported to repro_torch yet: "
        f"{NOT_PORTED[method]}")


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, device=like.device)


def _count(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int32, device=like.device)


@register_solver("fsvd")
def solve_fsvd(A, spec: SVDSpec, *,
               generator: Optional[torch.Generator] = None, q1=None,
               callback=None) -> Factorization:
    """Paper Alg 2: k-step GK bidiagonalization + Ritz extraction."""
    if q1 is None:
        generator = resolve_generator(
            generator, caller="factorize(method='fsvd')", device=A.device)
    res = _fsvd(A, spec.rank, spec.max_iters, generator=generator, q1=q1,
                eps=spec.tol, relative_eps=spec.relative_tol,
                reorth_passes=spec.reorth_passes,
                host_loop=bool(spec.host_loop), dtype=spec.dtype,
                precision=spec.precision, callback=callback)
    return Factorization(res.U, res.s, res.V, res.kprime, res.breakdown,
                         method="fsvd")


def solve_fsvd_batched(A, spec: SVDSpec, *, generators=None, q1s=None,
                       callback=None) -> Factorization:
    """Alg 2 on every example of a stacked ``DenseOp`` (A (B, m, n)) in
    one masked GK loop, each half-step one kernel call a stage for the
    batch (``core.fsvd.fsvd_batched``); ``generators`` (one per example)
    or ``q1s`` (B, m) give the start vectors.  The fields of the result
    carry the batch dimension."""
    res = _fsvd_batched(A, spec.rank, spec.max_iters, generators=generators,
                        q1s=q1s, eps=spec.tol,
                        relative_eps=spec.relative_tol,
                        reorth_passes=spec.reorth_passes, dtype=spec.dtype,
                        precision=spec.precision, callback=callback)
    return Factorization(res.U, res.s, res.V, res.kprime, res.breakdown,
                         method="fsvd")


@register_solver("rsvd")
def solve_rsvd(A, spec: SVDSpec, *,
               generator: Optional[torch.Generator] = None, q1=None,
               callback=None) -> Factorization:
    """HMT 2011 randomized range sketch (+ optional power iterations).
    ``q1`` is accepted for signature parity but unused."""
    generator = resolve_generator(
        generator, caller="factorize(method='rsvd')", device=A.device)
    res = _rsvd(A, spec.rank, p=spec.oversample,
                power_iters=spec.power_iters, generator=generator,
                dtype=spec.dtype, precision=spec.precision,
                callback=callback)
    return Factorization(res.U, res.s, res.V,
                         iterations=_count(spec.power_iters, res.s),
                         breakdown=_flag(False, res.s), method="rsvd")


@register_solver("rbk")
def solve_rbk(A, spec: SVDSpec, *,
              generator: Optional[torch.Generator] = None, q1=None,
              callback=None) -> Factorization:
    """Musco–Musco randomized block Krylov: sketch start, ``spec.passes``
    expansions of ``Aᵀ(A·)``, Rayleigh–Ritz extraction.  ``q1`` is
    accepted for signature parity but unused."""
    generator = resolve_generator(
        generator, caller="factorize(method='rbk')", device=A.device)
    res = _rbk(A, spec.rank, passes=spec.passes,
               sketch_dim=spec.sketch_dim, kind=spec.sketch_kind,
               oversample=spec.oversample, generator=generator,
               dtype=spec.dtype, precision=spec.precision,
               backend=spec.backend, callback=callback)
    return Factorization(res.U, res.s, res.V, iterations=res.passes,
                         breakdown=_flag(False, res.s), method="rbk")


@register_solver("gnystrom")
def solve_gnystrom(A, spec: SVDSpec, *,
                   generator: Optional[torch.Generator] = None, q1=None,
                   callback=None) -> Factorization:
    """Generalized Nyström: both sketches captured in ONE sweep over the
    operator, core solve by a stabilized pseudo-inverse — the solver for
    operands that may be touched once (``Operator.single_pass_only``).
    ``q1`` is accepted for signature parity but unused."""
    generator = resolve_generator(
        generator, caller="factorize(method='gnystrom')", device=A.device)
    res = _gnystrom(A, spec.rank, sketch_dim=spec.sketch_dim,
                    kind=spec.sketch_kind, oversample=spec.oversample,
                    generator=generator, dtype=spec.dtype,
                    precision=spec.precision, backend=spec.backend,
                    callback=callback)
    return Factorization(res.U, res.s, res.V, iterations=res.passes,
                         breakdown=_flag(False, res.s), method="gnystrom")


@register_solver("fsvd_blocked")
def solve_fsvd_blocked(A, spec: SVDSpec, *,
                       generator: Optional[torch.Generator] = None, q1=None,
                       callback=None) -> Factorization:
    """Streaming block GK with Ritz locking and thick restart, for
    operators whose dense form would not fit memory.  ``spec.block_size``
    is the block width, ``spec.max_basis`` the basis budget,
    ``spec.max_iters`` the restart-cycle cap (default 40); ``q1``
    warm-starts the first block via ``Aᵀq1``."""
    if q1 is None:
        generator = resolve_generator(
            generator, caller="factorize(method='fsvd_blocked')",
            device=A.device)
    res = _fsvd_blocked(A, spec.rank, block=spec.block_size,
                        max_basis=spec.max_basis, tol=spec.tol,
                        relative_tol=spec.relative_tol,
                        max_restarts=spec.max_iters or 40,
                        generator=generator, q1=q1,
                        reorth_passes=spec.reorth_passes, dtype=spec.dtype,
                        precision=spec.precision, callback=callback)
    return Factorization(res.U, res.s, res.V,
                         iterations=_count(res.block_passes, res.s),
                         breakdown=_flag(not res.converged, res.s),
                         method="fsvd_blocked")
