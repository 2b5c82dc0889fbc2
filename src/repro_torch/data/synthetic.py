"""Matrix-free problem generators: sparse and Kronecker operands with a
dense oracle.  Counterpart of the matrix-free part of
``repro.data.synthetic`` (``MatrixFreeProblem``, ``make_sparse_problem``,
``make_kron_problem``).

Each maker takes an explicit ``torch.Generator`` and draws on its device.
The two packages draw different numbers from one seed: parity tests build
the problem on the reference side and hand it over (``bridge.problem``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core._keys import normal

Tensor = torch.Tensor


class MatrixFreeProblem(NamedTuple):
    op: object            # a core.operators Operator: the solver input
    dense: Tensor         # materialized reference (small dims / oracles)


def _bernoulli(gen: torch.Generator, p: float, shape) -> Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


def make_sparse_problem(generator: torch.Generator, m: int, n: int, *,
                        density: float = 0.02, rank: Optional[int] = None,
                        backend: str = "xla") -> MatrixFreeProblem:
    """Random sparse operand with a dense oracle.

    ``rank=None``: iid Gaussian values on a Bernoulli(density) mask
    (full-rank with probability 1).  ``rank=r``: the product of two
    sparse factors ``S₁ (m, r) @ S₂ (r, n)`` of density √density each —
    rank at most r and still sparse for a small density.
    """
    from repro_torch.core.operators import SparseOp
    g = generator
    if rank is None:
        mask = _bernoulli(g, density, (m, n))
        dense = torch.where(mask, normal(g, (m, n)), 0.0)
    else:
        d = density ** 0.5
        S1 = torch.where(_bernoulli(g, d, (m, rank)),
                         normal(g, (m, rank)), 0.0)
        S2 = torch.where(_bernoulli(g, d, (rank, n)),
                         normal(g, (rank, n)), 0.0)
        dense = S1 @ S2
    return MatrixFreeProblem(SparseOp.fromdense(dense, backend=backend),
                             dense)


def make_kron_problem(generator: torch.Generator, ma: int, na: int, mb: int,
                      nb: int) -> MatrixFreeProblem:
    """Kronecker operand ``A ⊗ B`` with its dense oracle.  The product's
    singular values are the outer product of the factors' spectra."""
    from repro_torch.core.operators import DenseOp, KroneckerOp
    A = normal(generator, (ma, na)) / (ma * na) ** 0.25
    B = normal(generator, (mb, nb)) / (mb * nb) ** 0.25
    return MatrixFreeProblem(KroneckerOp(DenseOp(A), DenseOp(B)),
                             torch.kron(A, B))
