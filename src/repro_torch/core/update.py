"""Rank-k update / downdate of an existing factorization — zero Krylov
iterations.  Counterpart of ``repro.core.update``.

When the drift of an operator is itself low-rank,

    A' = beta · U diag(s) Vᵀ + C Dᵀ          (C: (m, k), D: (n, k)),

the factorization of A' follows from the previous one with no matvec
against A' (Brand's SVD update):

  0. thin-QR the bases, ``U = Qu Ru`` and ``V = Qv Rv``, and carry
     ``S = Ru diag(s) Rvᵀ`` in place of ``diag(s)``: the same operator on
     orthonormal bases.  Brand's update assumes them, and an f32 F-SVD's
     V is orthonormal only to ~1e-5 at scale, which alone moves the
     updated σ past ``tests/test_update.py``'s gate.  The reference skips
     this step (``repro.core.update``), so on bases off orthogonality the
     port is the closer of the two to the exact σ;
  1. split each delta factor into its part in the current basis and an
     orthonormal complement: ``UᵀC`` and ``Qc Rc = qr((I − U Uᵀ) C)``
     (CGS-reorthogonalized), and the same for D against V;
  2. assemble the small (r+k, r+k) core
     ``K = beta · (S ⊕ 0) + [UᵀC; Rc] [VᵀD; Rd]ᵀ``;
  3. SVD the core, rotate the augmented bases ``[U | Qc] Uk`` and
     ``[V | Qd] Vk``, and truncate back to the rank.

On ``backend="pallas"`` the core's outer product runs through the
low-rank materialization kernel (``kernels.lowrank_update``), as in the
reference; ``materialize_lowrank`` densifies a drift through the same
kernel.  Downdates zero rows or columns of the factored operator, itself a
rank-|S| delta derived from the factorization alone.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.core.operators import LowRankOp, cgs, promote_mm

if TYPE_CHECKING:          # repro_torch.api imports this module
    from repro_torch.api.results import Factorization

Tensor = torch.Tensor


def delta_rank(delta: LowRankOp) -> int:
    """Total factored rank of a ``LowRankOp`` (main triplet + extras)."""
    k = delta.s.shape[0]
    for L, _ in delta.extra:
        k += L.shape[1]
    return k


def delta_factors(delta: LowRankOp, compute=torch.float32
                  ) -> tuple[Tensor, Tensor]:
    """``(C, D)`` with ``Delta = C @ D.T``: the op's ``scale`` and ``s``
    fold into C."""
    Cs = [delta.U.to(compute) * delta.s.to(compute)[None, :]]
    Ds = [delta.Vt.T.to(compute)]
    for L, R in delta.extra:
        Cs.append(L.to(compute))
        Ds.append(R.T.to(compute))
    return delta.scale * torch.cat(Cs, 1), torch.cat(Ds, 1)


def _core_outer(Chat: Tensor, Dhat: Tensor, backend: str) -> Tensor:
    """``Chat @ Dhat.T`` for the (r+k, r+k) core.  On the pallas backend
    through the low-rank materialization kernel (one launch, s = 1)."""
    if backend == "pallas":
        from repro_torch.kernels import ops as kops
        ones = torch.ones(Chat.shape[1], dtype=Chat.dtype,
                          device=Chat.device)
        return kops.lowrank_matmul(Chat, ones, Dhat.T)
    return Chat @ Dhat.T


def update_factorization(fact: Factorization, delta: LowRankOp, *,
                         beta=1.0, rank: Optional[int] = None,
                         passes: int = 2,
                         backend: str = "xla") -> Factorization:
    """Factorization of ``beta · (U diag(s) Vᵀ) + delta`` — no GK.

    ``rank=None`` keeps the previous rank; any ``rank <= fact.rank +
    delta_rank(delta)`` is valid.  The result has ``iterations == 0`` and
    ``method == "update"``.
    """
    from repro_torch.api.results import Factorization
    compute = torch.promote_types(fact.U.dtype, torch.float32)
    U, Ru = torch.linalg.qr(fact.U.to(compute))
    V, Rv = torch.linalg.qr(fact.V.to(compute))
    S = (Ru * fact.s.to(compute)[None, :]) @ Rv.T   # the same operator: U S Vᵀ
    C, D = delta_factors(delta, compute)
    r = S.shape[0]
    k = C.shape[1]
    rank = r if rank is None else min(int(rank), r + k)

    UtC = U.T @ C
    Qc, Rc = torch.linalg.qr(cgs(C, U, passes))
    VtD = V.T @ D
    Qd, Rd = torch.linalg.qr(cgs(D, V, passes))

    Chat = torch.cat([UtC, Rc], 0)                      # (r+k, k)
    Dhat = torch.cat([VtD, Rd], 0)                      # (r+k, k)
    K = beta * torch.block_diag(S, torch.zeros((k, k), dtype=compute,
                                               device=S.device)) \
        + _core_outer(Chat, Dhat, backend)
    Uk, sk, Vkt = torch.linalg.svd(K.to(compute), full_matrices=False)

    U2 = torch.cat([U, Qc], 1) @ Uk[:, :rank]
    V2 = torch.cat([V, Qd], 1) @ Vkt[:rank, :].T
    dev = U.device
    return Factorization(U2.to(fact.U.dtype), sk[:rank].to(fact.s.dtype),
                         V2.to(fact.V.dtype),
                         iterations=torch.zeros((), dtype=torch.int32,
                                                device=dev),
                         breakdown=torch.zeros((), dtype=torch.bool,
                                               device=dev),
                         method="update")


# --- downdates: row / column removal as self-derived low-rank deltas ------

def _index(idx, like: Tensor) -> Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=like.device)


def row_removal_delta(fact: Factorization, rows) -> LowRankOp:
    """The rank-|rows| delta that zeroes ``rows`` of the factored
    operator: ``Delta = −1_rows (U[rows] diag(s) Vᵀ)``."""
    compute = torch.promote_types(fact.U.dtype, torch.float32)
    rows = _index(rows, fact.U)
    C = -torch.nn.functional.one_hot(rows, fact.U.shape[0]).T.to(compute)
    Vt = (fact.U[rows].to(compute) * fact.s.to(compute)[None, :]) \
        @ fact.V.T.to(compute)
    return LowRankOp(C, torch.ones(rows.shape[0], dtype=compute,
                                   device=C.device), Vt)


def col_removal_delta(fact: Factorization, cols) -> LowRankOp:
    """The rank-|cols| delta that zeroes ``cols`` of the factored
    operator: ``Delta = −(U diag(s) Vᵀ e_cols) e_colsᵀ``."""
    compute = torch.promote_types(fact.U.dtype, torch.float32)
    cols = _index(cols, fact.V)
    U = -(fact.U.to(compute) * fact.s.to(compute)[None, :]) \
        @ fact.V[cols].T.to(compute)                            # (m, j)
    Vt = torch.nn.functional.one_hot(cols, fact.V.shape[0]).to(compute)
    return LowRankOp(U, torch.ones(cols.shape[0], dtype=compute,
                                   device=U.device), Vt)


def downdate_rows(fact: Factorization, rows, *, passes: int = 2,
                  backend: str = "xla") -> Factorization:
    """Factorization of the operator with ``rows`` removed (zeroed).
    Exact when ``fact`` is: removing rows cannot raise the rank."""
    return update_factorization(fact, row_removal_delta(fact, rows),
                                passes=passes, backend=backend)


def downdate_cols(fact: Factorization, cols, *, passes: int = 2,
                  backend: str = "xla") -> Factorization:
    """Factorization of the operator with ``cols`` removed (zeroed)."""
    return update_factorization(fact, col_removal_delta(fact, cols),
                                passes=passes, backend=backend)


def materialize_lowrank(delta: LowRankOp, *, backend: str = "xla",
                        dtype=None) -> Tensor:
    """Densify a ``LowRankOp`` (to fold a drift into a dense operand).

    The pallas backend runs the main triplet through the materialization
    kernel (every shape: the kernel masks its edges); the extras and the
    scale are applied to that fresh buffer in place (``addmm_``,
    ``mul_``), so an (m, n) result costs one (m, n) buffer, not three.
    """
    if backend == "pallas":
        from repro_torch.kernels import ops as kops
        W = kops.lowrank_matmul(delta.U, delta.s, delta.Vt)
    else:
        W = promote_mm(delta.U * delta.s[None, :], delta.Vt)
    for L, R in delta.extra:
        dt = torch.promote_types(W.dtype, torch.promote_types(L.dtype,
                                                              R.dtype))
        W = W.to(dt).addmm_(L.to(dt), R.to(dt))
    if not (isinstance(delta.scale, (int, float)) and delta.scale == 1):
        W.mul_(delta.scale)
    return W if dtype is None else W.to(dtype)


__all__ = ["col_removal_delta", "delta_factors", "delta_rank",
           "downdate_cols", "downdate_rows", "materialize_lowrank",
           "row_removal_delta", "update_factorization"]
