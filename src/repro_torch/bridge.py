"""State carried across from the reference package, as numpy arrays.

The parity tests run ``repro`` (JAX) and ``repro_torch`` on the same
inputs.  These functions turn what the reference holds — an operand, a
start vector, a sketch test matrix, a ``Factorization`` and an
``SVDSpec`` — into the port's objects, given as numpy arrays
(``np.asarray`` of a JAX array) or as objects with the reference's field
names.  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import to_tensor, torch_dtype
from repro_torch.api.results import Factorization
from repro_torch.api.spec import SVDSpec
from repro_torch.core.operators import DenseOp
from repro_torch.core.sketch import GaussianSketch, SparseSignSketch


def operand(A, *, backend: str = "xla", device=None) -> DenseOp:
    """The reference's dense operand ``A`` (m, n) as a :class:`DenseOp`."""
    return DenseOp(to_tensor(np.asarray(A), device=device), backend=backend)


def start_vector(q1, *, device=None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A GK start vector ``q1`` (m,) drawn on the reference side."""
    return to_tensor(np.asarray(q1), device=device, dtype=dtype)


def sketch(ref: Any, *, backend=None, device=None, dtype=None):
    """A reference test matrix (``repro.core.sketch``) as the port's: a
    ``SparseSignSketch`` (``idx``, ``signs``, ``n`` and optionally
    ``backend``) or a ``GaussianSketch`` (``T``), the arrays as numpy
    arrays.  ``backend`` overrides the sketch's own; ``dtype`` casts the
    weights."""
    if hasattr(ref, "idx"):
        idx_np = np.asarray(ref.idx, np.int32)
        n = int(ref.n)
        if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= n):
            raise ValueError(f"sketch indices must lie in [0, {n}), got "
                             f"[{idx_np.min()}, {idx_np.max()}]")
        idx = to_tensor(idx_np, device=device)
        signs = to_tensor(np.asarray(ref.signs), device=device, dtype=dtype)
        return SparseSignSketch(idx, signs, n,
                                backend=backend or getattr(ref, "backend",
                                                           "xla"))
    return GaussianSketch(to_tensor(np.asarray(ref.T), device=device,
                                    dtype=dtype))


def factorization(ref: Any, *, device=None) -> Factorization:
    """A reference ``Factorization`` (or any object with ``U``, ``s``,
    ``V``, ``iterations``, ``breakdown`` and optionally ``method``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return Factorization(arr(ref.U), arr(ref.s), arr(ref.V),
                         arr(ref.iterations), arr(ref.breakdown),
                         method=getattr(ref, "method", "fsvd"))


def spec(ref: Any) -> SVDSpec:
    """A reference ``SVDSpec`` (a dataclass instance) or a mapping of its
    fields; a numpy/JAX ``dtype`` maps to the torch dtype of that name."""
    fields = dict(ref) if isinstance(ref, Mapping) else \
        dataclasses.asdict(ref)
    fields["dtype"] = torch_dtype(fields.get("dtype"))
    return SVDSpec(**fields)
