"""Closure-based linear operators and the deprecated constructors.
Counterpart of ``repro.core.linop``.

``LinOp`` gives a matrix as a pair of matvec closures (``mv``: ``A @ p``,
``rmv``: ``Aᵀ @ q``), which the GK / F-SVD / rank cores accept beside the
operators of ``core.operators``.  ``from_dense`` and ``from_factors`` are
the reference's deprecated shims: they warn and return a ``DenseOp`` or a
``LowRankOp``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import torch

Tensor = torch.Tensor


class ReproDeprecationWarning(DeprecationWarning):
    """Deprecation of an entry point kept for compatibility (the port's
    copy of ``repro.compat.ReproDeprecationWarning``), so the shims can
    be escalated to errors without erroring on others' warnings."""


@dataclasses.dataclass(frozen=True)
class LinOp:
    """An (m × n) linear operator given by matvec closures.

    ``mv(p)``: (n,) → (m,), ``A @ p``; ``rmv(q)``: (m,) → (n,), ``Aᵀ @ q``.
    ``mv_fused(p, y, a)`` / ``rmv_fused(q, y, b)`` are the Lanczos
    three-term forms ``A p − a y`` / ``Aᵀ q − b y``; the defaults compose
    the plain matvecs.  ``device`` is where the closures expect their
    vectors (the solvers allocate their bases there).
    """

    shape: tuple[int, int]
    mv: Callable[[Tensor], Tensor]
    rmv: Callable[[Tensor], Tensor]
    dtype: torch.dtype = torch.float32
    device: Any = "cuda"
    _mv_fused: Optional[Callable] = None
    _rmv_fused: Optional[Callable] = None

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def mv_fused(self, p: Tensor, y: Tensor, alpha) -> Tensor:
        if self._mv_fused is not None:
            return self._mv_fused(p, y, alpha)
        return self.mv(p) - alpha * y

    def rmv_fused(self, q: Tensor, y: Tensor, beta) -> Tensor:
        if self._rmv_fused is not None:
            return self._rmv_fused(q, y, beta)
        return self.rmv(q) - beta * y

    def matmat(self, V: Tensor) -> Tensor:
        """A @ V for a block of columns, one matvec per column."""
        return torch.stack([self.mv(V[:, j]) for j in range(V.shape[1])], 1)

    def rmatmat(self, Q: Tensor) -> Tensor:
        return torch.stack([self.rmv(Q[:, j]) for j in range(Q.shape[1])],
                           1)


def from_dense(A, use_kernels: bool = False):
    """Deprecated: use ``core.operators.DenseOp`` (or pass the tensor to
    the solvers / ``api.factorize``).  ``use_kernels=True`` maps to
    ``DenseOp(..., backend="pallas")``."""
    from repro_torch._device import to_tensor
    from repro_torch.core.operators import DenseOp
    warnings.warn(
        "from_dense() is deprecated; construct repro_torch.core.operators."
        "DenseOp(A, backend='pallas'|'xla') instead.",
        ReproDeprecationWarning, stacklevel=2)
    return DenseOp(to_tensor(A), backend="pallas" if use_kernels else "xla")


def from_factors(U, s, Vt, extra=None, scale=1.0):
    """Deprecated: use ``core.operators.LowRankOp``.  The operator
    ``scale · (U diag(s) Vt + Σ_i L_i R_i)`` with ``extra`` a list of
    (L_i (m, k_i), R_i (k_i, n)) addends."""
    from repro_torch.core.operators import LowRankOp
    warnings.warn(
        "from_factors() is deprecated; construct repro_torch.core.operators."
        "LowRankOp(U, s, Vt, extra=..., scale=...) instead.",
        ReproDeprecationWarning, stacklevel=2)
    return LowRankOp(U, s, Vt, extra=tuple(extra or ()), scale=scale)


def to_dense(op) -> Tensor:
    """Materialize (tests only).  Works for LinOp and Operator alike."""
    return op.matmat(torch.eye(op.n, dtype=op.dtype, device=op.device))
