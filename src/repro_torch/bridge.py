"""State carried across from the reference package, as numpy arrays.

The parity tests run ``repro`` (JAX) and ``repro_torch`` on the same
inputs.  These functions turn what the reference holds — an operand (dense,
sparse COO triplets, low-rank factors, or any reference operator), a
matrix-free problem, a start vector, a sketch test matrix, a hashed-sign
table and a sketch-resident state, a ``Factorization``, an ``SVDSpec``,
a manifold point, a tangent vector and an RSL dataset — into the port's
objects, given as numpy arrays
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
from repro_torch.core import manifold as mf
from repro_torch.core import operators as ops
from repro_torch.core.operators import DenseOp
from repro_torch.core.sketch import GaussianSketch, SparseSignSketch
from repro_torch.data.synthetic import MatrixFreeProblem, RSLDataset
from repro_torch.sketchres.state import SketchState, _HashedSketch


def operand(A, *, backend: str = "xla", device=None) -> DenseOp:
    """The reference's dense operand ``A`` (m, n) as a :class:`DenseOp`."""
    return DenseOp(to_tensor(np.asarray(A), device=device), backend=backend)


def sparse_operand(data, indices, spshape, *, backend: str = "xla",
                   device=None) -> ops.SparseOp:
    """A reference ``SparseOp``'s COO triplets (``data`` (nnz,),
    ``indices`` (nnz, 2), ``spshape``) as the port's, in the same entry
    order, so both packages build the same ELL pack."""
    return ops.SparseOp.from_coo(
        to_tensor(np.asarray(data), device=device),
        to_tensor(np.asarray(indices, np.int32), device=device),
        tuple(int(d) for d in spshape), backend=backend)


def lowrank(U, s, Vt, extra=(), scale=1.0, *, device=None) -> ops.LowRankOp:
    """A reference ``LowRankOp``'s fields as the port's."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    sc = scale if isinstance(scale, (int, float)) else arr(scale)
    return ops.LowRankOp(arr(U), arr(s), arr(Vt),
                         extra=tuple((arr(L), arr(R)) for L, R in extra),
                         scale=sc)


def operator(ref: Any, *, backend=None, device=None) -> ops.Operator:
    """Any reference operator (``DenseOp``, ``SparseOp``, ``LowRankOp``,
    ``KroneckerOp``, ``SumOp``, ``ScaledOp``, ``TransposedOp``, ``GramOp``,
    ``SinglePassOp``), read by its class name and fields, as the port's.
    ``backend`` overrides the dense and sparse operators' own."""
    kind = type(ref).__name__

    def sub(x):
        return operator(x, backend=backend, device=device)

    if kind == "DenseOp":
        return operand(ref.A, backend=backend or ref.backend, device=device)
    if kind == "SparseOp":
        return sparse_operand(ref.data, ref.indices, ref.spshape,
                              backend=backend or ref.backend, device=device)
    if kind == "LowRankOp":
        return lowrank(ref.U, ref.s, ref.Vt, ref.extra, ref.scale,
                       device=device)
    if kind == "KroneckerOp":
        return ops.KroneckerOp(sub(ref.a), sub(ref.b))
    if kind == "SumOp":
        return ops.SumOp(tuple(sub(t) for t in ref.terms))
    if kind == "ScaledOp":
        alpha = ref.alpha if isinstance(ref.alpha, (int, float)) else \
            float(np.asarray(ref.alpha))
        return ops.ScaledOp(alpha, sub(ref.op))
    if kind == "TransposedOp":
        return ops.TransposedOp(sub(ref.inner))
    if kind == "GramOp":
        return ops.GramOp(sub(ref.inner), ref.side)
    if kind == "SinglePassOp":
        return ops.SinglePassOp(sub(ref.inner))
    raise TypeError(f"no port of a reference {kind}")


def problem(ref: Any, *, backend=None, device=None) -> MatrixFreeProblem:
    """A reference ``MatrixFreeProblem`` (``op``, ``dense``) as the
    port's."""
    return MatrixFreeProblem(
        operator(ref.op, backend=backend, device=device),
        to_tensor(np.asarray(ref.dense), device=device))


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


def hashed_sketch(slots, signs, d: int, *, device=None) -> _HashedSketch:
    """A hashed-sign table (``slots`` (n, ζ) in [0, d), ``signs`` (n, ζ))
    drawn on the reference side — ``repro.sketchres.state._hashed`` — as
    the port's, to hand to ``sketch_operand(omega=, psi=)``."""
    slots_np = np.asarray(slots, np.int32)
    if slots_np.size and (slots_np.min() < 0 or slots_np.max() >= d):
        raise ValueError(f"slots must lie in [0, {d}), got "
                         f"[{slots_np.min()}, {slots_np.max()}]")
    return _HashedSketch(to_tensor(slots_np, device=device),
                         to_tensor(np.asarray(signs, np.float32),
                                   device=device), int(d))


def sketch_state(ref: Any, omega: _HashedSketch, psi: _HashedSketch, *,
                 device=None) -> SketchState:
    """A reference ``SketchState`` (panels ``Y`` / ``Z``, ``folded_mass``,
    ``base_norm``, ``zeta``, ``budget``, ``backend``) as the port's,
    carrying the tables ``omega`` / ``psi`` (from :func:`hashed_sketch`)
    in place of the reference's PRNG keys."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return SketchState(Y=arr(ref.Y), Z=arr(ref.Z),
                       folded_mass=arr(ref.folded_mass).to(torch.float32),
                       base_norm=arr(ref.base_norm).to(torch.float32),
                       tables=(omega, psi), zeta=int(ref.zeta),
                       budget=float(ref.budget), backend=ref.backend)


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


def fixed_rank_point(ref: Any, *, device=None) -> mf.FixedRankPoint:
    """A reference ``FixedRankPoint`` (``U``, ``s``, ``V``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return mf.FixedRankPoint(arr(ref.U), arr(ref.s), arr(ref.V))


def tangent_vector(ref: Any, *, device=None) -> mf.TangentVector:
    """A reference ``TangentVector`` (``M``, ``Up``, ``Vp``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return mf.TangentVector(arr(ref.M), arr(ref.Up), arr(ref.Vp))


def rsl_dataset(ref: Any, *, device=None) -> RSLDataset:
    """A reference ``RSLDataset`` (``X``, ``V``, ``y``, ``Wu``, ``Wv``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return RSLDataset(arr(ref.X), arr(ref.V), arr(ref.y), arr(ref.Wu),
                      arr(ref.Wv))
