"""Assembly and eigendecomposition of T = B_{k+1,k}ᵀ B_{k+1,k}.

Counterpart of ``repro.core.tridiag``.  B is lower-bidiagonal (eq. 9), so
T is symmetric tridiagonal:

    T[i, i]   = alpha_{i+1}^2 + beta_{i+2}^2
    T[i, i+1] = alpha_{i+2} * beta_{i+2}

with ``alphas[i] = alpha_{i+1}`` and ``betas[i] = beta_{i+2}`` as
``gk.GKResult`` stores them.  k' is at most a few hundred, so a dense
``torch.linalg.eigh`` of the k' × k' matrix is negligible next to the
O(m n k') Lanczos work.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor


def btb_tridiagonal(alphas: Tensor, betas: Tensor) -> Tensor:
    """Dense (k, k) assembly of the tridiagonal BᵀB from the GK scalars
    ((B, k, k) for a stack of B examples' (B, k) scalars)."""
    diag = alphas ** 2 + betas ** 2
    off = alphas[..., 1:] * betas[..., :-1]
    return (torch.diag_embed(diag) + torch.diag_embed(off, 1)
            + torch.diag_embed(off, -1))


def btb_eigh(alphas: Tensor, betas: Tensor,
             kprime: Optional[Union[Tensor, int]] = None
             ) -> tuple[Tensor, Tensor]:
    """Eigendecomposition of BᵀB, eigenvalues DESCENDING.

    Eigenvalues of columns at or beyond ``kprime`` (the zero-masked part
    of the buffers) are set to -inf, so a top-r selection skips them.
    Stacked scalars (B, k) with a (B,) ``kprime`` give a batched ``eigh``
    of the B tridiagonal problems: θ (B, k), G (B, k, k).
    """
    T = btb_tridiagonal(alphas, betas)
    theta, G = torch.linalg.eigh(T)              # ascending
    theta = torch.flip(theta, (-1,))
    G = torch.flip(G, (-1,))
    if kprime is not None:
        k = alphas.shape[-1]
        valid = torch.arange(k, device=theta.device) < torch.as_tensor(
            kprime, device=theta.device)[..., None]
        theta = torch.where(valid, theta,
                            torch.full_like(theta, float("-inf")))
    return theta, G
