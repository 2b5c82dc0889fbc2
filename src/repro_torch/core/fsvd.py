"""Algorithm 2 — Accurate and fast partial SVD (F-SVD).

Counterpart of ``repro.core.fsvd``.  Pipeline (paper Alg 2):
  1. GK-bidiagonalize A for (at most) k iterations -> B_{k'+1,k'}, P, Q.
  2. eigh of the small tridiagonal BᵀB -> Ritz pairs (theta_i, g_i).
  3. Right singular vectors V = P g.
  4. sigma = sqrt(theta);  U = A V Sigma^{-1}   (line 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import repro_torch.core.gk as gk_mod
from repro_torch.core.operators import (DenseOp, as_operator, mixed_mm,
                                        promote_mm)
from repro_torch.core.tridiag import btb_eigh

Tensor = torch.Tensor

# rows of A whose residual is formed at a time by truncated_svd_errors
_RESIDUAL_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class FSVDResult:
    U: Tensor        # (m, r)
    s: Tensor        # (r,)    descending
    V: Tensor        # (n, r)
    kprime: Tensor   # () int32 — GK iterations actually used
    breakdown: Tensor


def _mixed_matmul(B: Tensor, X: Tensor) -> Tensor:
    """``B @ X`` with f32 accumulation when B is a narrow-storage basis
    (bf16 B stays bf16 in memory; X is rounded to B's dtype)."""
    if B.dtype == X.dtype:
        return B @ X
    return mixed_mm(B, X)


def _assemble(op, res: gk_mod.GKResult, r: int) -> FSVDResult:
    theta, G = btb_eigh(res.alphas, res.betas, res.kprime)
    r = min(r, res.alphas.shape[0])
    theta_r = theta[:r]
    G_r = G[:, :r]
    # padding Ritz values were masked to -inf: zero their singular values
    pad = ~torch.isfinite(theta_r)
    s = torch.sqrt(torch.clamp(torch.where(pad, torch.zeros_like(theta_r),
                                           theta_r), min=0.0))
    V = _mixed_matmul(res.P, G_r)                       # line 3: V2 = P V1
    gather = getattr(op, "gather_basis", None)
    if gather is not None:             # a sharded operand's P is local
        V = gather(V, "right")
    AV = op.matmat(V)                                   # lines 6-8
    U = AV / torch.where(s > 0, s, torch.ones_like(s))[None, :]
    U = torch.where(pad[None, :], torch.zeros_like(U), U)
    V = torch.where(pad[None, :], torch.zeros_like(V), V)
    return FSVDResult(U, s, V, res.kprime, res.breakdown)


def default_k(r: int, shape) -> int:
    """The Krylov budget when ``k`` is omitted: ``min(4 r, min(m, n))``."""
    return min(4 * r, min(shape))


def fsvd(A, r: int, k: Optional[int] = None, *,
         generator: Optional[torch.Generator] = None, q1=None,
         eps: float = 1e-8, relative_eps: bool = True,
         reorth_passes: int = 2, host_loop: bool = False,
         dtype: Optional[torch.dtype] = None, precision=None,
         callback=None, device=None) -> FSVDResult:
    """Top-r singular triplets of A via k-step GK bidiagonalization.

    ``k`` defaults to :func:`default_k`; ``host_loop=True`` uses the
    early-exit host loop; ``precision="bf16"`` stores the Lanczos bases
    half-width while the Ritz extraction stays f32.
    """
    A = as_operator(A, device=device)
    if k is None:
        k = default_k(r, A.shape)
    k = max(k, r)
    runner = gk_mod.gk_bidiag_host if host_loop else gk_mod.gk_bidiag
    res = runner(A, k, generator=generator, q1=q1, eps=eps,
                 relative_eps=relative_eps, reorth_passes=reorth_passes,
                 dtype=dtype, precision=precision, callback=callback)
    return _assemble(A, res, r)


def _assemble_batched(op, res: gk_mod.GKResult, r: int) -> FSVDResult:
    """:func:`_assemble` for every example of a stacked operand at once: a
    batched ``eigh`` of the B tridiagonal problems, V = P G and
    U = A V Σ⁻¹ as batched products."""
    theta, G = btb_eigh(res.alphas, res.betas, res.kprime)
    r = min(r, res.alphas.shape[-1])
    theta_r = theta[..., :r]
    G_r = G[..., :r]
    pad = ~torch.isfinite(theta_r)
    s = torch.sqrt(torch.clamp(torch.where(pad, torch.zeros_like(theta_r),
                                           theta_r), min=0.0))
    if res.P.dtype == G_r.dtype:
        V = res.P @ G_r
    else:                            # narrow bases: widened by row blocks
        V = torch.stack([mixed_mm(P, Gb) for P, Gb in zip(res.P, G_r)])
    AV = promote_mm(op.A, V)
    U = AV / torch.where(s > 0, s, torch.ones_like(s))[:, None, :]
    U = torch.where(pad[:, None, :], torch.zeros_like(U), U)
    V = torch.where(pad[:, None, :], torch.zeros_like(V), V)
    return FSVDResult(U, s, V, res.kprime, res.breakdown)


def fsvd_batched(A, r: int, k: Optional[int] = None, *, generators=None,
                 q1s=None, eps: float = 1e-8, relative_eps: bool = True,
                 reorth_passes: int = 2, dtype: Optional[torch.dtype] = None,
                 precision=None, callback=None) -> FSVDResult:
    """:func:`fsvd` of each example of a stacked ``DenseOp`` (A (B, m, n))
    in one masked GK loop (``gk.gk_bidiag_batched``): each half-step is
    one kernel call a stage for the batch.  Every field of the result
    carries a leading batch dimension.  ``q1s`` (B, m), or one generator
    per example, gives the start vectors."""
    if k is None:
        k = default_k(r, A.shape)
    k = max(k, r)
    res = gk_mod.gk_bidiag_batched(
        A, k, generators=generators, q1s=q1s, eps=eps,
        relative_eps=relative_eps, reorth_passes=reorth_passes, dtype=dtype,
        precision=precision, callback=callback)
    return _assemble_batched(A, res, r)


def fsvd_dense_reconstruct(out) -> Tensor:
    """U diag(s) Vᵀ (tests / small operands)."""
    return (out.U * out.s[None, :]) @ out.V.T


def truncated_svd_errors(A, out) -> dict:
    """The paper's Table-2 metrics for a computed partial SVD ``out`` (any
    object with U, s, V): relative ``‖AᵀU − VΣ‖_F / ‖Σ‖_F`` and, for a
    dense operand, the residual ``‖A − UΣVᵀ‖_F``.  The residual is formed
    one block of rows at a time, so it never holds a second (m, n) matrix.
    """
    Aop = as_operator(A)
    ATU = Aop.rmatmat(out.U)
    rel = torch.linalg.vector_norm(ATU - out.V * out.s[None, :]) \
        / torch.linalg.vector_norm(out.s)
    res = None
    if isinstance(Aop, DenseOp):
        dense = Aop.A
        US = out.U * out.s[None, :]
        sq = torch.zeros((), dtype=torch.float64, device=dense.device)
        for r0 in range(0, dense.shape[0], _RESIDUAL_ROWS):
            blk = dense[r0:r0 + _RESIDUAL_ROWS] \
                - US[r0:r0 + _RESIDUAL_ROWS] @ out.V.T
            sq += torch.sum(blk.double() ** 2)
        res = torch.sqrt(sq).to(rel.dtype)
    return {"relative": rel, "residual": res}
