"""Algorithm 3 — fast numerical rank determination.

Counterpart of ``repro.core.rank``: run GK bidiagonalization with the
breakdown criterion (Alg 1); the iteration count at breakdown is the
first rank estimate, and the accurate rank is the number of eigenvalues
of BᵀB above a tolerance (Alg 3 line 4).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import repro_torch.core.gk as gk_mod
from repro_torch.core.operators import GramOp, TransposedOp, as_operator
from repro_torch.core.tridiag import btb_eigh

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RankResult:
    rank: Tensor           # () int32 — accurate numerical rank (Alg 3)
    gk_iterations: Tensor  # () int32 — Alg 1 iteration count at termination
    eigenvalues: Tensor    # (k,) Ritz values of BᵀB, descending (−inf pad)


def numerical_rank(A, *, max_iters: Optional[int] = None, eps: float = 1e-8,
                   relative_eps: bool = True,
                   sigma_tol: Optional[float] = None,
                   generator: Optional[torch.Generator] = None, q1=None,
                   host_loop: bool = True, reorth_passes: int = 2,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> RankResult:
    """Estimate rank(A).

    ``eps`` is the breakdown threshold of Alg 1.  ``sigma_tol`` is the
    Alg-3 counting threshold on the Ritz values of BᵀB; it defaults to
    ``max(theta) · eps_dtype · k' · 10``, the float32-safe reading of the
    paper's absolute 1e-8.  ``max_iters`` defaults to ``min(m, n)``, which
    sizes the basis buffers: pass it for a large operand.
    """
    A = as_operator(A, device=device)
    # rank(Aᵀ) == rank(AᵀA) == rank(A): run GK on the innermost operand
    # (Gram matvecs square the condition number and under-count rank).
    while isinstance(A, (TransposedOp, GramOp)):
        A = as_operator(A.inner)
    if max_iters is None:
        max_iters = min(A.shape)
    max_iters = min(max_iters, min(A.shape))
    runner = gk_mod.gk_bidiag_host if host_loop else gk_mod.gk_bidiag
    res = runner(A, max_iters, generator=generator, q1=q1, eps=eps,
                 relative_eps=relative_eps, reorth_passes=reorth_passes,
                 dtype=dtype)
    theta, _ = btb_eigh(res.alphas, res.betas, res.kprime)
    finite = torch.where(torch.isfinite(theta), theta,
                         torch.zeros_like(theta))
    if sigma_tol is None:
        big = torch.max(finite)
        eps_dt = torch.finfo(finite.dtype).eps
        # theta ~ sigma^2: tolerance on the squared scale, with headroom
        # over the roundoff accumulated across k' Lanczos steps.
        tol = big * eps_dt * res.kprime.to(finite.dtype) * 10.0
    else:
        tol = torch.as_tensor(sigma_tol, dtype=finite.dtype,
                              device=finite.device)
    rank = torch.sum(finite > tol).to(torch.int32)
    return RankResult(rank, res.kprime, theta)
