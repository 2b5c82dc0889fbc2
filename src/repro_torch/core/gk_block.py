"""Block Golub-Kahan bidiagonalization and the streaming blocked F-SVD.

Counterpart of ``repro.core.gk_block``.  The block variant advances ``b``
Lanczos vectors per pass over A (``A P_j`` and ``Aᵀ Q_j`` are GEMMs of
width b instead of GEMVs), so each pass does b× the arithmetic for the
same bytes of A.  Its projected matrix is block-bidiagonal, and a small
dense SVD of it gives Ritz triplets as in Alg 2.

  * :func:`gk_block_host` / :func:`fsvd_block` — fixed-step block GK.
  * :func:`fsvd_blocked` — the memory-budgeted streaming solver: block
    Krylov chains under a basis budget, Ritz locking and thick restart.

Host syncs (the breakdown norms, the MGS column norms, the locking
residuals) are ``.item()`` / ``.tolist()`` transfers, as the reference's
``float(...)`` calls are.  The reference's sharded-operand branch (blocked
Gram orthonormalization ``_mgs_block_gram``, replicated Rayleigh–Ritz
``_gram_rayleigh_ritz``) has no counterpart: a sharded operand's
``matmat`` / ``rmatmat`` (``repro_torch.distributed.matvec.ShardedOp``)
return the whole product, with the same bits, on every rank, so the MGS
and ``svd(AV)`` below take the same decisions on every rank with no
further collective.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import to_tensor
from repro_torch.core._keys import normal, resolve_generator
from repro_torch.core.gk import _store_dtype
from repro_torch.core.operators import (as_operator, mixed_mm, mixed_tmm,
                                        promote_mm)

Tensor = torch.Tensor
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class BlockGKResult:
    Q: Tensor          # (m, (s+1) b) left basis
    P: Tensor          # (n, s b) right basis
    K: Tensor          # ((s+1) b, s b) projected block-bidiagonal Qᵀ A P
    steps: int         # completed block steps s
    breakdown: bool


def _project(B: Tensor, W: Tensor) -> Tensor:
    """``B (Bᵀ W)`` under JAX's type promotion."""
    return promote_mm(B, promote_mm(B.T, W))


def _reorth(W: Tensor, basis: Tensor, passes: int) -> Tensor:
    for _ in range(passes):
        W = W - _project(basis, W)
    return W


def gk_block_host(op, block: int, steps: int, *,
                  generator: Optional[torch.Generator] = None, start=None,
                  eps: float = 1e-6, reorth_passes: int = 2,
                  device=None) -> BlockGKResult:
    """Host-loop block bidiagonalization with full block reorthogonalization.

    Recurrences (block analogue of paper eq. 7-8):
        P_1 A_1ᵀ            = QR(Aᵀ Q_1)
        Q_{j+1} B_{j+1}     = QR(A P_j − Q_j A_j)
        P_{j+1} A_{j+1}ᵀ    = QR(Aᵀ Q_{j+1} − P_j B_{j+1}ᵀ)
    K = Qᵀ A P is block-bidiagonal with diagonal blocks A_j and subdiagonal
    blocks B_{j+1}.  ``start`` is an (m, b) block to orthonormalize into
    Q_1 instead of a Gaussian draw from ``generator``.
    """
    op = as_operator(op, device=device)
    m, n = op.shape
    b = min(block, m, n)
    steps = min(steps, max(min(m, n) // b, 1))
    if start is None:
        generator = resolve_generator(generator, caller="gk_block_host",
                                      device=op.device)
        start = normal(generator, (m, b), device=op.device)
    Q1 = torch.linalg.qr(to_tensor(start, device=op.device, dtype=F32))[0]
    Z = op.rmatmat(Q1).to(F32)                            # (n, b)
    P1, A1t = torch.linalg.qr(Z)
    Qs, Ps = [Q1], [P1]
    Adiag = [A1t.T]                                       # A_1 (b, b)
    Bsub: list[Tensor] = []
    Qmat, Pmat = Q1, P1
    scale = torch.linalg.norm(A1t).item() + 1e-30
    breakdown = False

    for _ in range(1, steps):
        W = op.matmat(Ps[-1]).to(F32) - Qs[-1] @ Adiag[-1]
        W = _reorth(W, Qmat, reorth_passes)
        Qj, Bj = torch.linalg.qr(W)
        if torch.linalg.norm(Bj).item() < eps * scale:
            breakdown = True
            break
        Z = op.rmatmat(Qj).to(F32) - Ps[-1] @ Bj.T
        Z = _reorth(Z, Pmat, reorth_passes)
        Pj, Ajt = torch.linalg.qr(Z)
        if torch.linalg.norm(Ajt).item() < eps * scale:
            Qs.append(Qj)
            Bsub.append(Bj)
            Qmat = torch.cat([Qmat, Qj], dim=1)
            breakdown = True
            break
        Qs.append(Qj)
        Ps.append(Pj)
        Adiag.append(Ajt.T)
        Bsub.append(Bj)
        Qmat = torch.cat([Qmat, Qj], dim=1)
        Pmat = torch.cat([Pmat, Pj], dim=1)

    s = len(Ps)
    K = torch.zeros((Qmat.shape[1], Pmat.shape[1]), dtype=F32,
                    device=Qmat.device)
    for j in range(s):
        K[j * b:(j + 1) * b, j * b:(j + 1) * b] = Adiag[j]
    for j, Bj in enumerate(Bsub[:Qmat.shape[1] // b - 1]):
        K[(j + 1) * b:(j + 2) * b, j * b:(j + 1) * b] = Bj
    return BlockGKResult(Qmat, Pmat, K, s, breakdown)


@dataclasses.dataclass(frozen=True)
class FSVDBlockResult:
    U: Tensor
    s: Tensor
    V: Tensor
    steps: int
    breakdown: bool


def fsvd_block(A, r: int, *, block: Optional[int] = None,
               steps: Optional[int] = None,
               generator: Optional[torch.Generator] = None, start=None,
               reorth_passes: int = 2, device=None) -> FSVDBlockResult:
    """Top-r singular triplets via block GK (Alg 2 with a block backend).

    ``block`` defaults to a width ≥ r (at least 32); ``steps`` to enough
    slab captures for the top-r Ritz values to converge.
    """
    A = as_operator(A, device=device)
    m, n = A.shape
    if block is None:
        block = min(max(r, 32), min(m, n))
    if steps is None:
        steps = max(min(min(m, n) // block, max(2, 3 * r // block + 2)), 1)
    res = gk_block_host(A, block, steps, generator=generator, start=start,
                        reorth_passes=reorth_passes)
    Uk, sk, Vkt = torch.linalg.svd(res.K, full_matrices=False)
    r = min(r, sk.shape[0])
    U = res.Q @ Uk[:, :r]
    V = res.P @ Vkt[:r].T
    return FSVDBlockResult(U, sk[:r], V, res.steps, res.breakdown)


# ---------------------------------------------------------------------------
# Streaming blocked GK with locking + thick restart (memory-budgeted)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockedFSVDResult:
    U: Tensor          # (m, r)
    s: Tensor          # (r,)    descending
    V: Tensor          # (n, r)
    restarts: int      # restart cycles consumed
    block_passes: int  # streaming passes over A (block matvec round trips)
    converged: bool    # did r Ritz pairs lock before the restart budget?


def _orth_against(W: Tensor, bases, passes: int) -> Tensor:
    for _ in range(passes):
        for B in bases:
            if B.shape[1]:
                W = W - _project(B, W)
    return W


# a column whose norm drops by this factor under orthogonalization carries
# no new direction (f32 CGS2 noise floor), only roundoff — keeping it (or
# letting Householder QR substitute an arbitrary completion, which is NOT
# orthogonal to the deflation spaces) destroys basis orthonormality and
# with it the Ritz-value bound sigma_ritz <= sigma_max.
_MGS_DROP = 1e-5


def _mgs_block(W: Tensor, bases, passes: int = 2,
               drop: float = _MGS_DROP) -> Tensor:
    """Rank-revealing block orthonormalization (host-side MGS).

    Orthonormalizes W's columns against every basis in ``bases`` and each
    other, *dropping* columns that lose all their mass instead of
    completing them arbitrarily.  Returns (n, k ≤ W.cols) in the compute
    dtype; k == 0 means W carried no direction outside the spans.
    ``drop`` is the survival threshold (callers with bf16 bases raise it
    to that storage's orthogonalization noise floor).
    """
    live = [B for B in bases if B.shape[1]]
    compute = torch.promote_types(W.dtype, F32)
    cols: list[Tensor] = []
    for j in range(W.shape[1]):
        v = W[:, j].to(compute)
        nv0 = torch.linalg.vector_norm(v).item()
        if nv0 == 0.0:
            continue
        for _ in range(passes):
            for B in live:
                v = v - _project(B, v)
            for c in cols:
                v = v - c * torch.dot(c, v)
        nv = torch.linalg.vector_norm(v).item()
        if nv > drop * nv0:
            cols.append(v / nv)
    if not cols:
        return torch.zeros((W.shape[0], 0), dtype=compute, device=W.device)
    return torch.stack(cols, dim=1)


def _block_project(W: Tensor, bases, passes: int) -> Tensor:
    """``W − Σ B (Bᵀ W)``, ``passes`` times — blocked CGS against every
    basis with f32 accumulation (narrow-storage bases stay narrow)."""
    for _ in range(passes):
        for B in bases:
            if B.shape[1]:
                if B.dtype != W.dtype:
                    W = W - mixed_mm(B, mixed_tmm(B, W))
                else:
                    W = W - B @ (B.T @ W)
    return W


def blocked_dims(r: int, block: Optional[int], max_basis: Optional[int],
                 m: int, n: int) -> tuple[int, int, int]:
    """(r, b, max_basis) of :func:`fsvd_blocked`: r clamped to min(m, n);
    the block width b defaults to min(max(8, min(r, 32)), min(m, n)); the
    basis budget to min(min(m, n), max(3r, r + 2b)), never below
    max(r + b, 2b)."""
    r = min(r, min(m, n))
    b = block if block is not None else min(max(8, min(r, 32)), min(m, n))
    b = max(min(b, min(m, n)), 1)
    if max_basis is None:
        max_basis = min(min(m, n), max(3 * r, r + 2 * b))
    max_basis = min(max(max_basis, r + b, 2 * b), min(m, n))
    return r, b, max_basis


def fsvd_blocked(A, r: int, *, block: Optional[int] = None,
                 max_basis: Optional[int] = None, tol: float = 1e-8,
                 relative_tol: bool = True, max_restarts: int = 40,
                 generator: Optional[torch.Generator] = None, q1=None,
                 start=None, reorth_passes: int = 2,
                 dtype: Optional[torch.dtype] = None,
                 precision: Optional[str] = None, callback=None,
                 device=None) -> BlockedFSVDResult:
    """Top-r singular triplets by streaming block GK under a memory budget.

    The basis never exceeds ``max_basis`` right vectors: each cycle expands
    a block-Krylov chain ``P_{j+1} = orth(Aᵀ(A P_j))``, Rayleigh–Ritz
    extracts candidate triplets from the span, pairs whose residual
    ``‖Aᵀu − σv‖ ≤ tol·σ_max`` are *locked* (deflated from later cycles),
    and the basis restarts *thick* from the best unconverged Ritz vectors.
    A is touched only through block matvecs.

    ``relative_tol=True`` scales the threshold by the running σ_max with
    ``tol`` clamped to the dtype's Lanczos noise floor; ``False`` uses it
    as an absolute bound.  ``q1`` (an m-vector) warm-starts the first
    block via ``Aᵀq1``; ``start`` is an (n, b) first block to use instead
    of a draw from ``generator`` (which still feeds the rare random
    refreshes).  ``precision="bf16"`` stores the retained bases half-width.
    ``callback`` gets ``on_step(cycle, residual=, locked=)`` per cycle and
    a final ``on_info`` whose residual trace is the per-cycle minimum Ritz
    residual.
    """
    A = as_operator(A, device=device)
    m, n = A.shape
    r, b, max_basis = blocked_dims(r, block, max_basis, m, n)
    if dtype is None:
        dtype = torch.promote_types(A.dtype, F32)
    store = _store_dtype(precision, dtype)
    store_eps = float(torch.finfo(store).eps)
    mgs_drop = max(_MGS_DROP, 8.0 * store_eps)
    eff_tol = max(tol, 200.0 * float(torch.finfo(dtype).eps),
                  8.0 * store_eps)
    dev = A.device
    generator = resolve_generator(generator, caller="fsvd_blocked",
                                  device=dev, warn=q1 is None)

    def randn(cols: int) -> Tensor:
        return normal(generator, (n, cols), device=dev, dtype=dtype)

    locked_V = torch.zeros((n, 0), dtype=store, device=dev)
    locked_U = torch.zeros((m, 0), dtype=store, device=dev)
    locked_s: list[float] = []

    V = randn(b) if start is None else to_tensor(start, device=dev,
                                                 dtype=dtype).clone()
    if tuple(V.shape) != (n, b):
        raise ValueError(f"start must be ({n}, {b}), got {tuple(V.shape)}")
    if q1 is not None:
        V[:, 0] = A.rmv(to_tensor(q1, device=dev, dtype=dtype)).to(dtype)
    V = torch.linalg.qr(V)[0]

    block_passes = 0
    restarts = 0
    converged = False
    sigma_max = 0.0
    cycle_res: list[float] = []             # per-cycle min Ritz residual
    Us = S = Vr = None                      # last Rayleigh-Ritz extraction

    for restart in range(max_restarts):
        restarts = restart + 1
        # --- expand the Krylov chain under the basis budget --------------
        # the seed block is capped one short of the budget so at least one
        # A(ᵀ)A application always fits: with none the span never grows.
        budget = max_basis - locked_V.shape[1]
        if budget >= 2:
            V = V[:, :min(V.shape[1], budget - 1)]
        else:
            V = V[:, :max(budget, 1)]
        basis = _mgs_block(V, (locked_V,), reorth_passes,
                           drop=mgs_drop).to(store)
        if basis.shape[1] == 0:
            basis = _mgs_block(randn(min(b, budget)), (locked_V,),
                               reorth_passes, drop=mgs_drop).to(store)
        last = basis
        while basis.shape[1] < budget and last.shape[1]:
            W = A.rmatmat(A.matmat(last)).to(dtype)       # GK round trip
            block_passes += 1
            Qb = _mgs_block(W, (locked_V, basis), reorth_passes,
                            drop=mgs_drop)
            if Qb.shape[1] == 0:
                # chain exhausted the reachable subspace — refresh randomly
                Qb = _mgs_block(randn(last.shape[1]), (locked_V, basis),
                                reorth_passes, drop=mgs_drop)
                if Qb.shape[1] == 0:
                    break                     # whole space is spanned
            Qb = Qb[:, :budget - basis.shape[1]].to(store)
            basis = torch.cat([basis, Qb], dim=1)
            last = Qb
        # --- Rayleigh-Ritz on span(basis), deflated against locked -------
        AV = A.matmat(basis).to(dtype)                    # (m, d)
        block_passes += 1
        Us, S, Wt = torch.linalg.svd(AV, full_matrices=False)
        Vr = promote_mm(basis, Wt.T)
        S_host = S.tolist()
        sigma_max = max(sigma_max, S_host[0] if S_host else 0.0,
                        locked_s[0] if locked_s else 0.0)
        # residuals ‖Aᵀu_i − σ_i v_i‖ decide locking
        Rres = A.rmatmat(Us).to(dtype) - Vr * S[None, :]
        resn = torch.linalg.vector_norm(Rres, dim=0).tolist()
        thresh = eff_tol * max(sigma_max, 1.0) if relative_tol else tol
        need = r - len(locked_s)
        lock_idx = []
        for i in range(len(S_host)):
            if len(lock_idx) >= need:
                break
            if resn[i] <= thresh:
                lock_idx.append(i)
            else:
                break          # lock a contiguous head: keeps order strict
        if lock_idx:
            sel = torch.tensor(lock_idx, device=dev)
            newV = _orth_against(Vr[:, sel], (locked_V,), 1)
            newV = newV / torch.linalg.vector_norm(newV, dim=0,
                                                   keepdim=True)
            locked_V = torch.cat([locked_V, newV.to(store)], dim=1)
            locked_U = torch.cat([locked_U, Us[:, sel].to(store)], dim=1)
            locked_s.extend(S_host[i] for i in lock_idx)
        cycle_res.append(min(resn) if resn else 0.0)
        if callback is not None:
            callback.on_step(restart, residual=cycle_res[-1],
                             locked=len(locked_s))
        if len(locked_s) >= r:
            converged = True
            break
        # --- thick restart: the best unconverged Ritz vectors seed the
        # next cycle (orthonormalized against the locked pairs at loop top)
        rest = [i for i in range(len(S_host)) if i not in set(lock_idx)]
        keep = rest[:max(b, min(r - len(locked_s), len(rest)))]
        V = Vr[:, torch.tensor(keep, device=dev)] if keep else randn(b)

    # --- assemble: locked pairs first, fill from the last extraction -----
    if len(locked_s) < r and S is not None:
        fill = r - len(locked_s)
        cols_u, cols_v, vals = [], [], []
        for i in range(S.shape[0]):
            if len(vals) >= fill:
                break
            v_i = Vr[:, i]
            if locked_V.shape[1] and promote_mm(
                    locked_V.T, v_i).abs().max().item() > 0.5:
                continue       # this Ritz pair is (a copy of) a locked one
            cols_u.append(Us[:, i])
            cols_v.append(v_i)
            vals.append(S[i].item())
        if cols_u:
            locked_U = torch.cat(
                [locked_U, torch.stack(cols_u, dim=1).to(store)], dim=1)
            locked_V = torch.cat(
                [locked_V, torch.stack(cols_v, dim=1).to(store)], dim=1)
            locked_s.extend(vals)

    s_arr = torch.tensor(locked_s, dtype=dtype, device=dev)
    order = torch.argsort(-s_arr, stable=True)
    U = locked_U[:, order]
    V_out = locked_V[:, order]
    s_arr = s_arr[order]
    if s_arr.shape[0] < r:                      # exhausted rank-deficient A
        pad = r - s_arr.shape[0]
        U = torch.cat([U, torch.zeros((m, pad), dtype=store, device=dev)], 1)
        V_out = torch.cat([V_out, torch.zeros((n, pad), dtype=store,
                                              device=dev)], 1)
        s_arr = torch.cat([s_arr, torch.zeros(pad, dtype=dtype, device=dev)])
    if callback is not None:
        from repro_torch.api.callbacks import ConvergenceInfo
        callback.on_info(ConvergenceInfo(
            torch.tensor(cycle_res, dtype=F32, device=dev),
            torch.tensor(block_passes, dtype=torch.int32, device=dev),
            torch.tensor(not converged, device=dev),
            method="fsvd_blocked"))
    return BlockedFSVDResult(U[:, :r], s_arr[:r], V_out[:, :r], restarts,
                             block_passes, converged)
