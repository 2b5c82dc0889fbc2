"""Fixed-rank manifold geometry (paper §5.2-5.3).

Counterpart of ``repro.core.manifold``.  A point on the rank-r manifold
M_r = {W : rank(W) = r} is carried in factored form ``(U, s, V)`` with
``W = U diag(s) V^T``, U (m,r) and V (n,r) with orthonormal columns.
Tangent vectors at W (eq. 26) are

    T_W M = { U M V^T + U_p V^T + U V_p^T :  U_p^T U = 0, V_p^T V = 0 }

and are carried as the triple ``(M, U_p, V_p)`` — never dense.  The
Riemannian gradient (eq. 27) is the tangent projection of the Euclidean
gradient; the retraction (eq. 25) is the rank-r truncated SVD of W + xi,
computed by F-SVD on an *implicit* operator (paper Alg 4 line 9): the sum
``U diag(s) V^T + U M V^T + U_p V^T + U V_p^T`` is rank <= 3r, so every
matvec costs O((m+n) r) — the 1e8-entry W of the RSL driver is never
materialized.

The operand is a ``LowRankOp``: its GK half-steps take the operator
protocol's default ``cgs`` composition, as the reference's do, and no
hand-written kernel.  Where the reference takes a PRNG ``key``, the port
takes a ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core._keys import normal
from repro_torch.core.operators import LowRankOp, Operator

Tensor = torch.Tensor


class FixedRankPoint(NamedTuple):
    """W = U diag(s) V^T with orthonormal U (m,r), V (n,r)."""

    U: Tensor
    s: Tensor
    V: Tensor

    @property
    def rank(self) -> int:
        return self.s.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return self.U.shape[0], self.V.shape[0]


class TangentVector(NamedTuple):
    """xi = U M V^T + U_p V^T + U V_p^T at a FixedRankPoint."""

    M: Tensor    # (r, r)
    Up: Tensor   # (m, r), columns orthogonal to U
    Vp: Tensor   # (n, r), columns orthogonal to V


def random_point(generator: torch.Generator, m: int, n: int, r: int,
                 dtype: torch.dtype = torch.float32,
                 device=None) -> FixedRankPoint:
    """Random rank-r point (paper Alg 4 line 1, then projected to M_r),
    drawn from ``generator`` on its device and placed on ``device``
    (default: the generator's device)."""
    U, _ = torch.linalg.qr(normal(generator, (m, r), device=device,
                                  dtype=dtype))
    V, _ = torch.linalg.qr(normal(generator, (n, r), device=device,
                                  dtype=dtype))
    s = torch.sort(torch.abs(normal(generator, (r,), device=device,
                                    dtype=dtype)), descending=True)[0] + 0.1
    return FixedRankPoint(U, s, V)


def to_dense(W: FixedRankPoint) -> Tensor:
    return (W.U * W.s[None, :]) @ W.V.T


def as_linop(W: FixedRankPoint, tangent: Optional[TangentVector] = None,
             tangent_scale: Union[float, Tensor] = 1.0) -> LowRankOp:
    """Operator of W (+ tangent_scale * xi) without densifying.

    ``W + c xi = U (diag(s) + c M) V^T + c U_p V^T + c U V_p^T`` — each term
    is an explicit low-rank factor pair, carried as a ``LowRankOp`` with
    two ``extra`` pairs.  (Name kept from the closure era; ``as_operator``
    is an alias.)
    """
    if tangent is None:
        return LowRankOp(W.U, W.s, W.V.T)
    c = tangent_scale
    mid = torch.diag(W.s) + c * tangent.M
    ones = torch.ones_like(W.s)
    return LowRankOp(W.U @ mid, ones, W.V.T,
                     extra=((c * tangent.Up, W.V.T),
                            (W.U, c * tangent.Vp.T)))


as_operator = as_linop


def project_tangent(W: FixedRankPoint,
                    G: Union[Operator, Tensor]) -> TangentVector:
    """Riemannian gradient / tangent projection (eq. 27).

    ``P_W(G) = UU^T G VV^T + (I-UU^T) G VV^T + UU^T G (I-VV^T)`` carried as
    (M, U_p, V_p):  M = U^T G V;  U_p = G V - U M;  V_p = G^T U - V M^T.
    Only needs G through matmats with r columns — G may be any operator
    (e.g. the sparse-sampled Euclidean gradient of the RSL loss, carried as
    a ``LowRankOp`` / ``SumOp``) or a dense tensor.
    """
    if hasattr(G, "matmat"):          # Operator / legacy LinOp
        GV = G.matmat(W.V)            # (m, r)
        GtU = G.rmatmat(W.U)          # (n, r)
    else:
        GV = G @ W.V
        GtU = G.T @ W.U
    M = W.U.T @ GV                    # (r, r)
    Up = GV - W.U @ M
    Vp = GtU - W.V @ M.T
    return TangentVector(M, Up, Vp)


def tangent_to_dense(W: FixedRankPoint, xi: TangentVector) -> Tensor:
    return W.U @ xi.M @ W.V.T + xi.Up @ W.V.T + W.U @ xi.Vp.T


def inner(xi: TangentVector, zeta: TangentVector) -> Tensor:
    """Riemannian metric <xi, zeta> = tr(xi^T zeta) in the factored carry.

    Cross terms vanish by the orthogonality constraints, so the metric is the
    sum of Frobenius inners of the three components.
    """
    return (torch.sum(xi.M * zeta.M) + torch.sum(xi.Up * zeta.Up)
            + torch.sum(xi.Vp * zeta.Vp))


def norm(xi: TangentVector) -> Tensor:
    return torch.sqrt(inner(xi, xi))


def scale(xi: TangentVector, c: Union[float, Tensor]) -> TangentVector:
    return TangentVector(c * xi.M, c * xi.Up, c * xi.Vp)


def add(xi: TangentVector, zeta: TangentVector) -> TangentVector:
    return TangentVector(xi.M + zeta.M, xi.Up + zeta.Up, xi.Vp + zeta.Vp)


def retract_fsvd(W: FixedRankPoint, xi: TangentVector,
                 step: Union[float, Tensor], *, fsvd_iters: int = 20,
                 generator: Optional[torch.Generator] = None,
                 reorth_passes: int = 2,
                 warm_start: bool = True) -> FixedRankPoint:
    """Metric-projection retraction (eq. 24/25): rank-r SVD of W + step*xi
    via F-SVD on the implicit rank-<=3r operator — the paper's Alg 4 line 9.

    ``fsvd_iters`` is the paper's inner-iteration knob ("lower iter" 20 vs
    "higher iter" 35, Fig 2).

    ``warm_start=True`` (default) is the *tracking* retraction: the GK
    solve starts from W's own sigma-weighted blend ``U diag(s)·1``, so the
    Krylov space opens inside the already-converged subspace, the solve is
    deterministic and ``generator`` is not used (no self-seeding warning
    either).  ``warm_start=False`` restores the cold start drawn from
    ``generator`` (the paper's literal Alg 4).  Solves run through the
    plan layer, so a run of same-shaped steps builds one runner.
    """
    from repro_torch.api import SVDSpec, factorize
    r = W.rank
    op = as_linop(W, xi, step)
    k = min(max(fsvd_iters, r + 2), min(op.shape))
    q1 = (W.U @ W.s) if warm_start else None
    out = factorize(op, SVDSpec(method="fsvd", rank=r, max_iters=k,
                                reorth_passes=reorth_passes),
                    generator=None if warm_start else generator, q1=q1)
    return FixedRankPoint(out.U, out.s, out.V)


def retract_qr(W: FixedRankPoint, xi: TangentVector,
               step: Union[float, Tensor]) -> FixedRankPoint:
    """Closed-form rank-2r retraction (Vandereycken 2013 §A) — the exact
    baseline for tests.  Builds the 2r x 2r core and does a small dense SVD:

        W + t xi = [U  Q_u] K [V  Q_v]^T,
        K = [[diag(s) + t M,  t R_v^T], [t R_u, 0]]
    """
    t = step
    r = W.rank
    Qu, Ru = torch.linalg.qr(xi.Up)
    Qv, Rv = torch.linalg.qr(xi.Vp)
    K = torch.cat([
        torch.cat([torch.diag(W.s) + t * xi.M, t * Rv.T], dim=1),
        torch.cat([t * Ru, torch.zeros((r, r), dtype=W.s.dtype,
                                       device=W.s.device)], dim=1),
    ], dim=0)
    Uk, sk, Vkt = torch.linalg.svd(K)
    U = torch.cat([W.U, Qu], dim=1) @ Uk[:, :r]
    V = torch.cat([W.V, Qv], dim=1) @ Vkt.T[:, :r]
    return FixedRankPoint(U, sk[:r], V)
