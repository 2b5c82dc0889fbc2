"""Unified result types of the facade (counterpart of ``repro.api.results``)."""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Factorization:
    """Partial SVD  A ≈ U diag(s) Vᵀ.

    iterations — GK iterations actually used (doubles as the Alg-1 rank
                 estimate).
    breakdown  — did the GK breakdown criterion fire.
    method     — solver that produced this.
    """

    U: Tensor
    s: Tensor
    V: Tensor
    iterations: Tensor
    breakdown: Tensor
    method: str = "fsvd"

    @property
    def rank(self) -> int:
        return self.s.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.U.shape[0], self.V.shape[0])

    def reconstruct(self) -> Tensor:
        """Materialize U diag(s) Vᵀ (tests / small operands only)."""
        return (self.U * self.s[None, :]) @ self.V.T

    def errors(self, A) -> dict:
        """The paper's Table-2 metrics: relative ‖AᵀU − VΣ‖_F/‖Σ‖_F and,
        for dense operands, the residual ‖A − UΣVᵀ‖_F (formed by row
        blocks, never as a second full matrix)."""
        from repro_torch.core.fsvd import truncated_svd_errors
        return truncated_svd_errors(A, self)

    def warm_start(self) -> Tensor:
        """Left start vector q1 for warm-starting the next GK solve: the
        sigma-weighted blend ``U @ s``, in the compute dtype (never the
        narrow storage dtype of a bf16 run)."""
        compute = torch.promote_types(self.U.dtype, torch.float32)
        return self.U.to(compute) @ self.s.to(compute)


@dataclasses.dataclass(frozen=True, eq=False)
class RankEstimate:
    """Numerical-rank determination result (paper Alg 3).

    rank        — accurate numerical rank (eigenvalue count above tol).
    iterations  — Alg-1 GK iteration count at termination.
    eigenvalues — Ritz values of BᵀB, descending (−inf padded).
    """

    rank: Tensor
    iterations: Tensor
    eigenvalues: Tensor
    method: str = "gk"

    def __int__(self) -> int:
        return int(self.rank)
