"""Sketch-to-SVD solvers: randomized block Krylov and generalized Nyström.

Counterpart of ``repro.core.sketch``:

  * :func:`rbk` — Musco & Musco's randomized **block Krylov**: start from a
    sketched block, expand ``q`` passes of ``Aᵀ(A ·)``, Rayleigh–Ritz
    extract.  Exactly ``2·q_eff + 1`` operator sweeps.
  * :func:`gnystrom` — Tropp–Webber's **generalized Nyström**: the sketches
    ``AΩ`` / ``AᵀΨ`` captured in ONE :meth:`Operator.sketch_pass`, the core
    ``ΨᵀY`` from the captured panel, a stabilized pseudo-inverse.

Test matrices come from :func:`make_sketch` — the sparse-sign ensemble
(ζ nonzeros per column, ±1/√ζ) in the (d, ζ) ELL pack that
``kernels.sketch_matvec`` applies, or a dense Gaussian — drawn from an
explicit ``torch.Generator``, or passed in (``sketch=`` / ``omega=``,
``psi=``: the reference's own draws in a parity test, see
``bridge.sketch``).  Sketch panels and Krylov bases are stored in
``_store_dtype(precision, dtype)`` and every contraction accumulates in
f32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.core._keys import integers, normal, resolve_generator
from repro_torch.core.gk import _store_dtype
from repro_torch.core.gk_block import _block_project
from repro_torch.core.operators import as_operator, mixed_tmm
from repro_torch.kernels.sketch_matvec import ZETA

Tensor = torch.Tensor
F32 = torch.float32

SKETCH_KINDS = ("sparse_sign", "gaussian")

# pseudo-inverse cutoff for the (l, k) Nyström core ΨᵀAΩ, relative to its
# top singular value: below it a core direction is sketch noise, and
# inverting it would amplify that noise into the reconstruction.
_PINV_RCOND = 1e-5


# ---------------------------------------------------------------------------
# test matrices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparseSignSketch:
    """Sparse-sign test matrix T (N, d), ζ nonzeros per column at ±1/√ζ, in
    the ELL pack of ``kernels.sketch_matvec``: row i of ``idx`` / ``signs``
    lists sketch coordinate i's ζ source rows and signed weights.  Rows are
    drawn with replacement; colliding slots sum, in :meth:`dense` as in
    :meth:`tapply`.  :attr:`order`, the sketch kernel's walk of the slots
    in source order, is made on first use and kept."""

    idx: Tensor         # (d, ζ) int32 — source rows of the operand block
    signs: Tensor       # (d, ζ) — ±1/√ζ in the storage dtype
    n: int              # N, the sketched dimension
    backend: str = "xla"

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.idx.shape[0])

    def dense(self) -> Tensor:
        """Materialize T (N, d), panel-sized.  Slots are added one slot
        index at a time: within one, every (row, column) target is
        distinct (one per column), so no scatter meets a duplicate and the
        bits are the same on every run and every device."""
        d, zeta = self.idx.shape
        T = torch.zeros((self.n, d), dtype=self.signs.dtype,
                        device=self.signs.device)
        cols = torch.arange(d, device=self.signs.device)
        rows = self.idx.long()
        for s in range(zeta):
            T[rows[:, s], cols] += self.signs[:, s]
        return T

    @functools.cached_property
    def order(self) -> Tensor:
        """``kernels.sketch_matvec.gather_order(idx)``: (2, d·ζ) int32,
        made once per sketch."""
        from repro_torch.kernels.sketch_matvec import gather_order
        return gather_order(self.idx)

    def tapply(self, X: Tensor) -> Tensor:
        """``Tᵀ X`` (d, b) f32 — the matrix-free apply; ``backend="pallas"``
        routes through the sketch kernel."""
        if self.backend == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.sketch_matmat(self.signs, self.idx, X, self.order)
        from repro_torch.kernels import ref
        return ref.sketch_matmat(self.signs, self.idx, X)


@dataclasses.dataclass(frozen=True)
class GaussianSketch:
    """Dense N(0, 1) test matrix, the HMT classic; ``tapply`` is a GEMM."""

    T: Tensor           # (N, d)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.T.shape)

    def dense(self) -> Tensor:
        return self.T

    def tapply(self, X: Tensor) -> Tensor:
        if X.dtype == self.T.dtype:
            return (self.T.T @ X).to(F32)
        return mixed_tmm(self.T, X)


def make_sketch(generator: torch.Generator, n: int, d: int, *,
                kind: str = "sparse_sign", zeta: int = ZETA,
                dtype: torch.dtype = F32, backend: str = "xla",
                device=None):
    """Draw an (n, d) test matrix of the given ensemble from
    ``generator``, on ``device`` (default: the generator's)."""
    if kind not in SKETCH_KINDS:
        raise ValueError(
            f"sketch kind must be one of {SKETCH_KINDS}, got {kind!r}")
    if kind == "gaussian":
        return GaussianSketch(normal(generator, (n, d), device=device,
                                     dtype=dtype))
    z = max(1, min(zeta, n))
    idx = integers(generator, n, (d, z), device=device)
    signs = (2.0 * integers(generator, 2, (d, z), device=device) - 1.0) \
        / math.sqrt(float(z))
    return SparseSignSketch(idx, signs.to(dtype), n, backend=backend)


def nystrom_reconstruct(Y: Tensor, Zt: Tensor,
                        C: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Stabilized generalized-Nyström core solve: the SVD of
    ``Y C⁺ Zt ≈ A`` from the range panel ``Y = AΩ`` (m, k), the co-range
    panel ``Zt = ΨᵀA`` (l, n) and the core ``C = ΨᵀY`` (l, k).

    Core directions below ``_PINV_RCOND·σmax`` are dropped, not inverted;
    Y is Householder-QR orthonormalized and the small projected matrix
    SVD'd.  Returns ``(U (m, k), s (k,), Vt (k, n))`` in f32.
    """
    C = C.to(F32)
    Zt = Zt.to(F32)
    Uc, sc, Vtc = torch.linalg.svd(C, full_matrices=False)
    keep = sc > _PINV_RCOND * sc[0]
    sci = torch.where(keep, 1.0 / torch.where(keep, sc, torch.ones_like(sc)),
                      torch.zeros_like(sc))
    M = (Vtc.T * sci[None, :]) @ (Uc.T @ Zt)        # (k, n) = C⁺ Zt
    Qy, Ry = torch.linalg.qr(Y.to(F32))
    B = Ry @ M                                      # (k, n) projected core
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    return Qy @ Ub, s, Vt


def _panel_dims(r: int, oversample: int, sketch_dim: Optional[int],
                m: int, n: int) -> tuple[int, int]:
    """(k, l): right/left sketch widths for gnystrom — k defaults to the
    R-SVD rule ``r + oversample`` clamped to the small dimension, and the
    co-range panel is twice as wide, clamped to m, never narrower than k."""
    k = min(sketch_dim or (r + oversample), min(m, n))
    l = max(k, min(2 * k, m))
    return k, l


def _info(callback, sweeps: int, method: str, device) -> None:
    if callback is None:
        return
    from repro_torch.api.callbacks import ConvergenceInfo
    callback.on_info(ConvergenceInfo(
        torch.zeros(0, device=device),
        torch.tensor(sweeps, dtype=torch.int32, device=device),
        torch.tensor(False, device=device), method=method))


def _check_shape(name: str, sk, shape: tuple[int, int]) -> None:
    if tuple(sk.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(sk.shape)}")


# ---------------------------------------------------------------------------
# randomized block Krylov (Musco & Musco 2015)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SketchSVDResult:
    U: Tensor
    s: Tensor
    V: Tensor
    passes: Tensor      # operator sweeps actually spent (0-d int32)


def rbk(A, r: int, *, passes: int = 2, sketch_dim: Optional[int] = None,
        kind: str = "sparse_sign", oversample: int = 10, zeta: int = ZETA,
        generator: Optional[torch.Generator] = None, sketch=None,
        dtype: Optional[torch.dtype] = None, precision=None,
        backend: str = "xla", callback=None, device=None) -> SketchSVDResult:
    """Top-r triplets via randomized block Krylov iteration.

    Builds ``[V₀, (AᵀA)V₀, …, (AᵀA)^q V₀]`` from an orthonormalized
    b-column sketch V₀ (no operator touch); each expansion is projected
    against the accumulated basis, Householder-QR'd, projected and QR'd
    again (a nearly converged block leaves a noise-level residual whose
    normalization amplifies any surviving overlap), then Rayleigh–Ritz
    extracts from ``A·basis``.  ``q_eff`` is ``passes`` capped so the basis
    never exceeds min(m, n) columns; the cost is exactly ``2·q_eff + 1``
    sweeps.  ``sketch`` is an (n, b) test matrix to use instead of a draw
    from ``generator``.
    """
    A = as_operator(A, device=device)
    m, n = A.shape
    if dtype is None:
        dtype = torch.promote_types(A.dtype, F32)
    store = _store_dtype(precision, dtype)
    b = min(sketch_dim or (r + oversample), min(m, n))
    q_eff = min(max(passes, 0), max((min(m, n) - b) // b, 0))
    if sketch is None:
        generator = resolve_generator(generator, caller="rbk",
                                      device=A.device)
        sketch = make_sketch(generator, n, b, kind=kind, zeta=zeta,
                             dtype=store, backend=backend, device=A.device)
    _check_shape("sketch", sketch, (n, b))

    block = torch.linalg.qr(sketch.dense().to(F32))[0]
    basis = block.to(store)                              # (n, b)
    for _ in range(q_eff):
        W = A.rmatmat(A.matmat(block.to(store)))         # 2 sweeps
        W = _block_project(W.to(F32), [basis], 2)
        W = torch.linalg.qr(W)[0]
        W = _block_project(W, [basis], 2)
        block = torch.linalg.qr(W)[0]
        basis = torch.cat([basis, block.to(store)], dim=1)

    AV = A.matmat(basis).to(F32)                         # 1 sweep
    # (the reference's sharded operands take a Gram Rayleigh-Ritz here; a
    # ShardedOp's AV is whole and alike on every rank, so svd(AV) serves)
    U, s, Wt = torch.linalg.svd(AV, full_matrices=False)
    V = basis.to(F32) @ Wt.T
    sweeps = 2 * q_eff + 1
    _info(callback, sweeps, "rbk", U.device)
    return SketchSVDResult(U[:, :r], s[:r], V[:, :r],
                           torch.tensor(sweeps, dtype=torch.int32,
                                        device=U.device))


# ---------------------------------------------------------------------------
# generalized Nyström (HMT 2011 §5.5 / Tropp–Webber)
# ---------------------------------------------------------------------------

def gnystrom(A, r: int, *, sketch_dim: Optional[int] = None,
             kind: str = "sparse_sign", oversample: int = 10,
             zeta: int = ZETA, generator: Optional[torch.Generator] = None,
             omega=None, psi=None, dtype: Optional[torch.dtype] = None,
             precision=None, backend: str = "xla", callback=None,
             device=None) -> SketchSVDResult:
    """Top-r triplets from ONE sweep over the operator.

    Draws independent test matrices Ω (n, k) and Ψ (m, l) (or takes
    ``omega`` / ``psi``), captures ``Y = AΩ`` and ``Z = AᵀΨ`` in a single
    :meth:`Operator.sketch_pass`, and reconstructs ``A ≈ Y (ΨᵀY)⁺ (ΨᵀA)``
    with :func:`nystrom_reconstruct`; the core ``ΨᵀY`` comes from
    ``Ψ.tapply(Y)`` without touching the operator again.
    """
    A = as_operator(A, device=device)
    m, n = A.shape
    if dtype is None:
        dtype = torch.promote_types(A.dtype, F32)
    store = _store_dtype(precision, dtype)
    k, l = _panel_dims(r, oversample, sketch_dim, m, n)
    if omega is None or psi is None:
        generator = resolve_generator(generator, caller="gnystrom",
                                      device=A.device)
        draw = dict(kind=kind, zeta=zeta, dtype=store, backend=backend,
                    device=A.device)
        if omega is None:
            omega = make_sketch(generator, n, k, **draw)
        if psi is None:
            psi = make_sketch(generator, m, l, **draw)
    _check_shape("omega", omega, (n, k))
    _check_shape("psi", psi, (m, l))

    Y, Z = A.sketch_pass(omega, psi)              # THE one operator sweep
    Y = Y.to(store)                               # (m, k) range panel
    Zt = Z.to(F32).T                              # (l, n) = ΨᵀA
    C = psi.tapply(Y).to(F32)                     # (l, k) = ΨᵀAΩ, no touch
    U, s, Vt = nystrom_reconstruct(Y, Zt, C)
    _info(callback, 1, "gnystrom", U.device)
    return SketchSVDResult(U[:, :r], s[:r], Vt[:r, :].T,
                           torch.tensor(1, dtype=torch.int32,
                                        device=U.device))
