"""Operator protocol and algebra: counterpart of ``repro.core.operators``.

The paper's algorithms touch A only through ``A @ p`` / ``Aᵀ @ q``.  Each
operator is a frozen dataclass exposing ``shape``, ``dtype``, ``device``,
``mv``, ``rmv``, the fused three-term forms, the fused Lanczos half-steps,
the block forms and the one-sweep ``sketch_pass``:

  * ``DenseOp(A, backend=...)`` — in-memory matrix.  ``backend="pallas"``
    (the reference's name, kept so one ``SVDSpec`` means the same thing to
    both packages) routes the Lanczos half-steps through the hand-written
    CUDA kernels of ``kernels.gk_step`` (its fused matvecs for a float64
    operand) and ``sketch_pass`` through ``kernels.sketch_matvec``;
    ``"xla"`` composes plain torch ops.
  * ``LowRankOp(U, s, Vt, extra=..., scale=...)`` — ``scale · (U diag(s)
    Vt + Σ L_i R_i)``, never materialized.
  * ``SumOp``, ``ScaledOp``, ``TransposedOp`` — closure of the algebra
    under ``A + B``, ``alpha * A`` and ``A.T``.
  * ``SparseOp`` — COO triplets; ``backend="pallas"`` packs them into ELL
    rows for both directions once and runs every matvec and block through
    the CUDA kernel of ``kernels.sparse_matvec`` (a block is one launch);
    ``"xla"`` multiplies a torch sparse COO tensor.
  * ``KroneckerOp(a, b)`` — ``a ⊗ b`` through ``(A ⊗ B) vec(X) =
    vec(A X Bᵀ)`` (row-major vec); the product is never materialized.
  * ``GramOp(inner, side)`` — ``AᵀA`` / ``AAᵀ`` applied as two matvecs.
  * ``SinglePassOp(inner)`` — marks an operand that may be swept once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Tuple

import torch

from repro_torch._device import to_tensor

Tensor = torch.Tensor

_BACKENDS = ("xla", "pallas")
_GRAM_SIDES = ("ata", "aat")
_OTHER_SIDE = {"left": "right", "right": "left"}

# rows of a narrow-storage basis widened to f32 at a time by the mixed
# products below: the basis itself is never upcast in memory.
_MIXED_ROWS = 1 << 16
# elements of a wide right-hand side that mixed_tmm rounds and widens at a
# time (256 MiB of f32): X may be the whole operand, or a view of it.
_MIXED_ELEMS = 1 << 26

def mixed_mm(B: Tensor, X: Tensor) -> Tensor:
    """``B @ X`` with X rounded to B's dtype and f32 accumulation, for a
    narrow-storage B (the reference's ``preferred_element_type=f32`` dot).
    B is widened one row block at a time, never whole."""
    Xr = X.to(B.dtype).to(torch.float32)
    out = torch.empty((B.shape[0],) + tuple(X.shape[1:]),
                      dtype=torch.float32, device=B.device)
    for r in range(0, B.shape[0], _MIXED_ROWS):
        out[r:r + _MIXED_ROWS] = B[r:r + _MIXED_ROWS].to(torch.float32) @ Xr
    return out


def mixed_tmm(B: Tensor, X: Tensor) -> Tensor:
    """``Bᵀ @ X`` under the same contract as :func:`mixed_mm`; B and X are
    rounded and widened together one row block at a time, never whole (X
    may be the operand, as in a Gaussian sketch's ``Tᵀ A``), and the
    row-block contributions are summed in a fixed order."""
    width = max(1, X[:1].numel())
    rows = max(1, min(_MIXED_ROWS, _MIXED_ELEMS // width))
    out = torch.zeros((B.shape[1],) + tuple(X.shape[1:]),
                      dtype=torch.float32, device=B.device)
    for r in range(0, B.shape[0], rows):
        out += (B[r:r + rows].to(torch.float32).T
                @ X[r:r + rows].to(B.dtype).to(torch.float32))
    return out


def promote_mm(A: Tensor, X: Tensor) -> Tensor:
    """``A @ X`` under JAX's type promotion (torch refuses mixed dtypes)."""
    if A.dtype == X.dtype:
        return A @ X
    dt = torch.promote_types(A.dtype, X.dtype)
    return A.to(dt) @ X.to(dt)


def cgs(v: Tensor, basis: Tensor, passes: int) -> Tensor:
    """Classical Gram-Schmidt of ``v`` against the (zero-padded) basis
    columns, ``passes`` times.

    When the basis is stored narrower than ``v`` (the bf16 policy), both
    products take operands in the basis dtype and accumulate in f32
    (:func:`mixed_mm`) — the basis is never upcast in memory.  For
    matching dtypes this is exactly ``v − B (Bᵀ v)``.
    """
    if basis.dtype == v.dtype:
        for _ in range(passes):
            v = v - basis @ (basis.T @ v)
        return v
    for _ in range(passes):
        c = mixed_tmm(basis, v)
        v = v - mixed_mm(basis, c)
    return v


class Operator:
    """Base class: the linear-map protocol.

    Subclasses define ``shape``, ``dtype``, ``device``, ``mv`` and ``rmv``
    and may override the fused three-term forms, the half-steps, the block
    forms, ``sketch_pass`` and ``T`` with cheaper specializations.
    """

    # Streaming hint: True means the operand can afford only ONE sweep;
    # ``resolve_method`` routes such operands to ``gnystrom``.
    single_pass_only: bool = False

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def mv(self, p: Tensor) -> Tensor:
        raise NotImplementedError

    def rmv(self, q: Tensor) -> Tensor:
        raise NotImplementedError

    def mv_fused(self, p: Tensor, y: Tensor, alpha) -> Tensor:
        """Lanczos three-term form ``A p − alpha y``."""
        return self.mv(p) - alpha * y

    def rmv_fused(self, q: Tensor, y: Tensor, beta) -> Tensor:
        return self.rmv(q) - beta * y

    def lanczos_step(self, p: Tensor, y: Tensor, alpha, basis: Tensor, *,
                     passes: int = 2) -> tuple[Tensor, Tensor]:
        """One left GK half-step: ``u = A p − α y`` reorthogonalized
        CGS^passes against ``basis``, plus its norm → ``(u, ‖u‖)``.

        The default composes the fused matvec with :func:`cgs`;
        ``DenseOp(backend="pallas")`` overrides it with the kernels.
        """
        u = cgs(self.mv_fused(p, y, alpha), basis, passes)
        return u, torch.linalg.vector_norm(u)

    def lanczos_rstep(self, q: Tensor, y: Tensor, beta, basis: Tensor, *,
                      passes: int = 2) -> tuple[Tensor, Tensor]:
        """Right GK half-step: ``v = Aᵀ q − β y`` vs ``basis`` → (v, ‖v‖)."""
        v = cgs(self.rmv_fused(q, y, beta), basis, passes)
        return v, torch.linalg.vector_norm(v)

    def matmat(self, V: Tensor) -> Tensor:
        return torch.stack([self.mv(V[:, j]) for j in range(V.shape[1])], 1)

    def rmatmat(self, Q: Tensor) -> Tensor:
        return torch.stack([self.rmv(Q[:, j]) for j in range(Q.shape[1])], 1)

    def sketch_pass(self, omega, psi) -> tuple[Tensor, Tensor]:
        """ONE sweep over the operator capturing both sketch directions,
        ``(A Ω, Aᵀ Ψ)``, for test matrices Ω (n, k) and Ψ (m, l) from
        ``core.sketch``: the seam ``gnystrom`` builds on.  The default
        composes the block forms on the densified (panel-sized) tests."""
        return self.matmat(omega.dense()), self.rmatmat(psi.dense())

    def to_dense(self) -> Tensor:
        """Materialize (tests and small operands only)."""
        return self.matmat(torch.eye(self.n, dtype=self.dtype,
                                     device=self.device))

    # --- algebra ------------------------------------------------------
    @property
    def T(self) -> "Operator":
        return TransposedOp(self)

    def __matmul__(self, x):
        if isinstance(x, Operator):
            return NotImplemented
        x = to_tensor(x, device=self.device)
        return self.mv(x) if x.dim() == 1 else self.matmat(x)

    def _check_same_shape(self, other: "Operator") -> "Operator":
        if tuple(self.shape) != tuple(other.shape):
            raise ValueError(
                f"operator shapes disagree: {tuple(self.shape)} + "
                f"{tuple(other.shape)}")
        return other

    def _term(self, other) -> "Operator":
        return self._check_same_shape(as_operator(other, device=self.device))

    def __add__(self, other):
        return SumOp((self, self._term(other)))

    def __radd__(self, other):
        return SumOp((self._term(other), self))

    def __sub__(self, other):
        return SumOp((self, ScaledOp(-1.0, self._term(other))))

    def __mul__(self, alpha):
        return ScaledOp(alpha, self)

    __rmul__ = __mul__

    def __neg__(self):
        return ScaledOp(-1.0, self)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseOp(Operator):
    """In-memory (m, n) matrix.  ``backend="pallas"`` runs the Lanczos
    half-steps and the fused matvecs through the CUDA kernels (A streamed
    once per half-step) and both sketch products through the sketch
    kernel; ``"xla"`` composes plain torch ops.  A numpy ``A`` goes to the
    CUDA card (and raises without one); pass a tensor to choose its
    device.

    A (B, m, n) ``A`` is a stack of B operands of one shape, the input of
    ``SolverPlan.solve_batched``: ``batch`` is B (None for one matrix)
    and ``shape`` each example's (m, n).  Only the batched solve takes a
    stacked operand; every other path refuses it."""

    A: Tensor
    backend: str = "xla"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if not isinstance(self.A, Tensor):
            object.__setattr__(self, "A", to_tensor(self.A))
        if self.A.dim() not in (2, 3):
            raise ValueError(f"DenseOp needs a 2-D matrix or a (B, m, n) "
                             f"stack of them, got {tuple(self.A.shape)}")

    @property
    def batch(self):
        """B for a stacked (B, m, n) operand, None for one matrix."""
        return self.A.shape[0] if self.A.dim() == 3 else None

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.A.shape[-2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _kernels(self) -> bool:
        return self.backend == "pallas" and self.A.dtype != torch.float64

    def mv(self, p):
        return promote_mm(self.A, p)

    def rmv(self, q):
        return promote_mm(self.A.T, q)

    def mv_fused(self, p, y, alpha):
        if self.backend == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.matvec_fused(self.A, p, y, alpha)
        return self.mv(p) - alpha * y

    def rmv_fused(self, q, y, beta):
        if self.backend == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.rmatvec_fused(self.A, q, y, beta)
        return self.rmv(q) - beta * y

    def lanczos_step(self, p, y, alpha, basis, *, passes=2):
        if self._kernels():
            from repro_torch.kernels import ops as kops
            return kops.gk_step_fused(self.A, p, y, alpha, basis, passes)
        return Operator.lanczos_step(self, p, y, alpha, basis,
                                     passes=passes)

    def lanczos_rstep(self, q, y, beta, basis, *, passes=2):
        if self._kernels():
            from repro_torch.kernels import ops as kops
            return kops.gk_rstep_fused(self.A, q, y, beta, basis, passes)
        return Operator.lanczos_rstep(self, q, y, beta, basis,
                                      passes=passes)

    def matmat(self, V):
        return promote_mm(self.A, V)

    def rmatmat(self, Q):
        return promote_mm(self.A.T, Q)

    def to_dense(self):
        return self.A

    def sketch_pass(self, omega, psi):
        if self.backend == "pallas":
            # both directions through the sketch kernel: (A Ω)ᵀ = Ωᵀ Aᵀ and
            # (Aᵀ Ψ)ᵀ = Ψᵀ A are each one Tᵀ X apply; Aᵀ is a view, read in
            # place by the kernel (never copied).
            return omega.tapply(self.A.T).T, psi.tapply(self.A).T
        return Operator.sketch_pass(self, omega, psi)


@dataclasses.dataclass(frozen=True, eq=False)
class LowRankOp(Operator):
    """``scale · (U diag(s) Vt + Σ_i L_i R_i)`` — never materialized.

    ``extra`` is a tuple of (L_i (m, k_i), R_i (k_i, n)) addend factor
    pairs: e.g. ``W − eta Z`` (a manifold point minus a tangent step), or
    a rank-k drift for ``core.update``.  Every factor goes to U's device
    (U itself, if not a tensor, to the CUDA card).
    """

    U: Tensor                     # (m, r)
    s: Tensor                     # (r,)
    Vt: Tensor                    # (r, n)
    extra: Tuple[Tuple[Tensor, Tensor], ...] = ()
    scale: Any = 1.0              # python scalar or 0-d tensor

    def __post_init__(self):
        U = to_tensor(self.U)
        dev = U.device
        object.__setattr__(self, "U", U)
        object.__setattr__(self, "s", to_tensor(self.s, device=dev))
        object.__setattr__(self, "Vt", to_tensor(self.Vt, device=dev))
        object.__setattr__(self, "extra", tuple(
            (to_tensor(L, device=dev), to_tensor(R, device=dev))
            for L, R in self.extra))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.U.shape[0], self.Vt.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.U.dtype

    @property
    def device(self) -> torch.device:
        return self.U.device

    def matmat(self, V):
        y = promote_mm(self.U, self.s[:, None] * promote_mm(self.Vt, V))
        for L, R in self.extra:
            y = y + promote_mm(L, promote_mm(R, V))
        return self.scale * y

    def rmatmat(self, Q):
        y = promote_mm(self.Vt.T, self.s[:, None] * promote_mm(self.U.T, Q))
        for L, R in self.extra:
            y = y + promote_mm(R.T, promote_mm(L.T, Q))
        return self.scale * y

    def mv(self, p):
        return self.matmat(p[:, None])[:, 0]

    def rmv(self, q):
        return self.rmatmat(q[:, None])[:, 0]

    @property
    def T(self):
        return LowRankOp(self.Vt.T, self.s, self.U.T,
                         extra=tuple((R.T, L.T) for L, R in self.extra),
                         scale=self.scale)


@dataclasses.dataclass(frozen=True, eq=False)
class SumOp(Operator):
    """A + B (+ ...): every product distributes over the terms, summed in
    term order."""

    terms: Tuple[Operator, ...]

    @property
    def shape(self) -> tuple[int, int]:
        return self.terms[0].shape

    @property
    def dtype(self) -> torch.dtype:
        return functools.reduce(torch.promote_types,
                                (t.dtype for t in self.terms))

    @property
    def device(self) -> torch.device:
        return self.terms[0].device

    def _sum(self, kind: str, x: Tensor) -> Tensor:
        y = getattr(self.terms[0], kind)(x)
        for t in self.terms[1:]:
            y = y + getattr(t, kind)(x)
        return y

    def mv(self, p):
        return self._sum("mv", p)

    def rmv(self, q):
        return self._sum("rmv", q)

    def matmat(self, V):
        return self._sum("matmat", V)

    def rmatmat(self, Q):
        return self._sum("rmatmat", Q)

    @property
    def T(self):
        return SumOp(tuple(t.T for t in self.terms))

    def __add__(self, other):     # flatten nested sums
        other = self._term(other)
        more = other.terms if isinstance(other, SumOp) else (other,)
        return SumOp(self.terms + more)


@dataclasses.dataclass(frozen=True, eq=False)
class ScaledOp(Operator):
    """alpha · A (alpha a python scalar or a 0-d tensor)."""

    alpha: Any
    op: Operator

    @property
    def shape(self) -> tuple[int, int]:
        return self.op.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.op.dtype

    @property
    def device(self) -> torch.device:
        return self.op.device

    def mv(self, p):
        return self.alpha * self.op.mv(p)

    def rmv(self, q):
        return self.alpha * self.op.rmv(q)

    def matmat(self, V):
        return self.alpha * self.op.matmat(V)

    def rmatmat(self, Q):
        return self.alpha * self.op.rmatmat(Q)

    @property
    def T(self):
        return ScaledOp(self.alpha, self.op.T)

    def __mul__(self, a):
        return ScaledOp(a * self.alpha, self.op)

    __rmul__ = __mul__


@dataclasses.dataclass(frozen=True, eq=False)
class TransposedOp(Operator):
    """Aᵀ of ``inner`` without a stored transpose: its left half-step is
    the inner operator's right half-step, so a dense inner operand keeps
    its fused kernels."""

    inner: Operator

    @property
    def shape(self) -> tuple[int, int]:
        m, n = self.inner.shape
        return (n, m)

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def mv(self, p):
        return self.inner.rmv(p)

    def rmv(self, q):
        return self.inner.mv(q)

    def mv_fused(self, p, y, alpha):
        return self.inner.rmv_fused(p, y, alpha)

    def rmv_fused(self, q, y, beta):
        return self.inner.mv_fused(q, y, beta)

    def lanczos_step(self, p, y, alpha, basis, *, passes=2):
        return self.inner.lanczos_rstep(p, y, alpha, basis, passes=passes)

    def lanczos_rstep(self, q, y, beta, basis, *, passes=2):
        return self.inner.lanczos_step(q, y, beta, basis, passes=passes)

    def matmat(self, V):
        return self.inner.rmatmat(V)

    def rmatmat(self, Q):
        return self.inner.matmat(Q)

    # a sharded inner operand's Lanczos seam keeps its vectors on its own
    # ranks' rows / columns: the transpose swaps the two sides
    def place_basis(self, X, side):
        fn = getattr(self.inner, "place_basis", None)
        return X if fn is None else fn(X, _OTHER_SIDE[side])

    def gather_basis(self, X, side):
        fn = getattr(self.inner, "gather_basis", None)
        return X if fn is None else fn(X, _OTHER_SIDE[side])

    @property
    def T(self):
        return self.inner


def _spmm(S: Tensor, X: Tensor) -> Tensor:
    """``S @ X`` for a sparse COO ``S`` and a vector or block ``X``, under
    JAX's type promotion."""
    dt = torch.promote_types(S.dtype, X.dtype)
    S = S if S.dtype == dt else S.to(dt)
    Y = torch.sparse.mm(S, (X[:, None] if X.dim() == 1 else X).to(dt))
    return Y[:, 0] if X.dim() == 1 else Y


@dataclasses.dataclass(frozen=True, eq=False)
class SparseOp(Operator):
    """Sparse (m, n) matrix in COO triplet form — never densified on the
    solver path (the GK / F-SVD / rank cores only ask for products).

    ``data`` (nnz,) and ``indices`` (nnz, 2) of [row, col] follow the BCOO
    convention of the reference: duplicate coordinates sum.

    ``backend="pallas"`` packs the triplets into ELL rows for A and for Aᵀ
    once, at construction, on the data's device (unless ``ell`` already
    holds the packs), and runs mv, rmv and the block products through the
    CUDA kernel of ``kernels.sparse_matvec``: a block of b columns is one
    launch.  On a CUDA device it also builds, once, the window layout of
    each pack that a windowed path serves (``windows``: one layout or None
    per pack, in the order of ``ell``; ``sparse_matvec.pack_layout``),
    through which mv / rmv on long rows gather x, and block products of 2
    to ``MAX_BLOCK_COLS`` columns gather X, from shared memory.  Such a
    pack is then held in its layout's order (the same slots of each row,
    in another order), in place of the reference's order, so ``ell`` keeps
    one copy.
    ``backend="xla"`` multiplies a torch sparse COO tensor, built on first
    use.
    """

    data: Tensor                  # (nnz,)
    indices: Tensor               # (nnz, 2) int — [row, col]
    spshape: Tuple[int, int] = (0, 0)
    ell: Any = None               # ((m,L) vals, (m,L) cols, (n,L') vals,
                                  #  (n,L') rows) — the pallas pack (in
                                  #  its layout's order where it has one),
                                  #  or None
    backend: str = "xla"
    windows: Any = None           # (layout of A's pack or None, of Aᵀ's),
                                  # or None where none was built

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        object.__setattr__(self, "spshape",
                           tuple(int(d) for d in self.spshape))
        if self.backend == "pallas" and self.ell is None:
            from repro_torch.kernels.sparse_matvec import ell_pack
            m, n = self.spshape
            object.__setattr__(self, "ell", (
                ell_pack(self.data, self.indices, (m, n))
                + ell_pack(self.data, self.indices.flip(1), (n, m))))
        if self.backend == "pallas" and self.windows is None \
                and self.data.device.type == "cuda":
            from repro_torch.kernels import sparse_matvec as spm
            m, n = self.spshape
            ell, windows = list(self.ell), []
            for side, (nr, nx) in enumerate(((m, n), (n, m))):
                # row populations mark each pack's padding
                counts = torch.bincount(self.indices[:, side].long(),
                                        minlength=nr)
                lay = spm.pack_layout(ell[2 * side], ell[2 * side + 1], nx,
                                      counts)
                if lay is not None:
                    ell[2 * side:2 * side + 2] = lay[:2]
                    # the old pack goes before the next layout is built
                    object.__setattr__(self, "ell", tuple(ell))
                windows.append(lay)
                del lay, counts
            object.__setattr__(self, "windows", tuple(windows))

    # --- constructors -------------------------------------------------
    @classmethod
    def from_coo(cls, data, indices, spshape, *, backend: str = "xla",
                 device=None) -> "SparseOp":
        """From COO triplets (tensors keep their device; numpy arrays go
        to ``device``, by default the CUDA card)."""
        data = to_tensor(data, device=device)
        indices = to_tensor(indices, device=data.device)
        return cls(data, indices, tuple(spshape), backend=backend)

    @classmethod
    def from_coo_tensor(cls, S: Tensor, *,
                        backend: str = "xla") -> "SparseOp":
        """From a torch sparse COO tensor (the counterpart of the
        reference's ``from_bcoo``); an uncoalesced tensor keeps its
        duplicate entries, which sum."""
        return cls.from_coo(S._values(), S._indices().T.to(torch.int32),
                            tuple(S.shape), backend=backend)

    @classmethod
    def fromdense(cls, A, *, backend: str = "xla",
                  device=None) -> "SparseOp":
        """The nonzeros of a dense matrix in row-major order (BCOO's
        ``fromdense``)."""
        A = to_tensor(A, device=device)
        idx = torch.nonzero(A).to(torch.int32)
        data = A[idx[:, 0].long(), idx[:, 1].long()]
        return cls.from_coo(data, idx, tuple(A.shape), backend=backend)

    # --- protocol -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return self.spshape

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def density(self) -> float:
        m, n = self.spshape
        return self.nnz / max(m * n, 1)

    @functools.cached_property
    def _coo(self) -> Tensor:
        return torch.sparse_coo_tensor(self.indices.T.long(), self.data,
                                       self.spshape,
                                       check_invariants=True).coalesce()

    @functools.cached_property
    def _coo_t(self) -> Tensor:
        return torch.sparse_coo_tensor(self.indices.flip(1).T.long(),
                                       self.data, self.spshape[::-1],
                                       check_invariants=True).coalesce()

    def _forward(self, X):
        if self.backend == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.sparse_matvec(self.ell[0], self.ell[1], X,
                                      self._window(0))
        return _spmm(self._coo, X)

    def _backward(self, X):
        if self.backend == "pallas":
            from repro_torch.kernels import ops as kops
            return kops.sparse_matvec(self.ell[2], self.ell[3], X,
                                      self._window(1))
        return _spmm(self._coo_t, X)

    def _window(self, side: int):
        return None if self.windows is None else self.windows[side]

    mv = matmat = _forward
    rmv = rmatmat = _backward

    def to_dense(self):
        return self._coo.to_dense()

    @property
    def T(self):
        ell = None if self.ell is None else \
            (self.ell[2], self.ell[3], self.ell[0], self.ell[1])
        windows = None if self.windows is None else self.windows[::-1]
        return SparseOp(self.data, self.indices.flip(1), self.spshape[::-1],
                        ell=ell, backend=self.backend, windows=windows)


@dataclasses.dataclass(frozen=True, eq=False)
class KroneckerOp(Operator):
    """``a ⊗ b`` — shape (m_a m_b, n_a n_b), never materialized.

    Products use ``(A ⊗ B) vec(X) = vec(A X Bᵀ)`` with a row-major vec
    (``torch.kron``'s index order ``[i·m_b + k, j·n_b + l]``), so a block
    of b columns costs one block product with each factor.  Factors are
    operators themselves: ``KroneckerOp(SparseOp(...), DenseOp(...))``
    composes.
    """

    a: Operator
    b: Operator

    @property
    def shape(self) -> tuple[int, int]:
        (ma, na), (mb, nb) = self.a.shape, self.b.shape
        return (ma * mb, na * nb)

    @property
    def dtype(self) -> torch.dtype:
        return torch.promote_types(self.a.dtype, self.b.dtype)

    @property
    def device(self) -> torch.device:
        return self.a.device

    @staticmethod
    def _apply(fa, fb, X, n_a, n_b, m_a):
        """vec(A X_c Bᵀ) for every column c of the (n_a n_b, w) block X:
        ``fa`` / ``fb`` are the factors' block products."""
        w = X.shape[1]
        AX = fa(X.reshape(n_a, n_b * w))                  # (m_a, n_b w)
        T = AX.reshape(m_a, n_b, w).permute(1, 0, 2).reshape(n_b, m_a * w)
        BT = fb(T)                                        # (m_b, m_a w)
        m_b = BT.shape[0]
        return BT.reshape(m_b, m_a, w).permute(1, 0, 2).reshape(
            m_a * m_b, w)

    def matmat(self, V):
        (ma, na), (_, nb) = self.a.shape, self.b.shape
        return self._apply(self.a.matmat, self.b.matmat, V, na, nb, ma)

    def rmatmat(self, Q):
        (ma, na), (mb, _) = self.a.shape, self.b.shape
        return self._apply(self.a.rmatmat, self.b.rmatmat, Q, ma, mb, na)

    def mv(self, x):
        return self.matmat(x[:, None])[:, 0]

    def rmv(self, y):
        return self.rmatmat(y[:, None])[:, 0]

    def to_dense(self):
        return torch.kron(self.a.to_dense(), self.b.to_dense())

    @property
    def T(self):
        return KroneckerOp(self.a.T, self.b.T)


@dataclasses.dataclass(frozen=True, eq=False)
class GramOp(Operator):
    """``AᵀA`` (side="ata", n×n) or ``AAᵀ`` (side="aat", m×m) of ``inner``,
    applied as two matvecs — the Gram matrix itself is never formed."""

    inner: Operator
    side: str = "ata"

    def __post_init__(self):
        if self.side not in _GRAM_SIDES:
            raise ValueError(
                f"side must be one of {_GRAM_SIDES}, got {self.side!r}")

    @property
    def shape(self) -> tuple[int, int]:
        d = self.inner.shape[1] if self.side == "ata" else self.inner.shape[0]
        return (d, d)

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def mv(self, p):
        if self.side == "ata":
            return self.inner.rmv(self.inner.mv(p))
        return self.inner.mv(self.inner.rmv(p))

    rmv = mv

    def matmat(self, V):
        if self.side == "ata":
            return self.inner.rmatmat(self.inner.matmat(V))
        return self.inner.matmat(self.inner.rmatmat(V))

    rmatmat = matmat

    @property
    def T(self):
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class SinglePassOp(Operator):
    """Marks an operand as affordable to sweep only ONCE (streamed, or too
    large to touch twice); pure forwarding otherwise.  ``resolve_method``
    sees ``single_pass_only`` and routes to ``gnystrom``, whose whole
    contract is one ``sketch_pass``."""

    inner: Operator

    single_pass_only = True

    @property
    def shape(self) -> tuple[int, int]:
        return self.inner.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def mv(self, p):
        return self.inner.mv(p)

    def rmv(self, q):
        return self.inner.rmv(q)

    def matmat(self, V):
        return self.inner.matmat(V)

    def rmatmat(self, Q):
        return self.inner.rmatmat(Q)

    def sketch_pass(self, omega, psi):
        return self.inner.sketch_pass(omega, psi)

    def to_dense(self):
        return self.inner.to_dense()

    @property
    def T(self):
        return SinglePassOp(self.inner.T)


def as_operator(A, *, backend: str = "xla", device=None) -> Operator:
    """Coerce to the operator protocol.

    Operators (and look-alikes with ``mv`` and ``rmv``, such as
    ``core.linop.LinOp``) pass through; a torch sparse COO tensor wraps
    into a :class:`SparseOp`; dense tensors wrap into a :class:`DenseOp`
    on their own device (or on ``device``); anything else (numpy arrays)
    goes to ``device``, by default the CUDA card.
    """
    if isinstance(A, Operator):
        return A
    if hasattr(A, "mv") and hasattr(A, "rmv"):
        return A
    if backend not in _BACKENDS:
        raise ValueError(
            f"backend must be one of {_BACKENDS}, got {backend!r}")
    if isinstance(A, Tensor) and A.layout == torch.sparse_coo:
        if device is not None:
            A = A.to(device)
        return SparseOp.from_coo_tensor(A, backend=backend)
    return DenseOp(to_tensor(A, device=device), backend=backend)


def sharding_mesh(op):
    """The device mesh a (possibly wrapped) operator is sharded over, or
    None.  Counterpart of ``repro.core.operators.sharding_mesh``: a
    ``repro_torch.distributed.ShardedOp`` exposes a ``sharding_mesh``
    property, and wrapper operators are walked through their operator
    fields (``inner``, ``op``, ``terms``, ...), so any wrapper takes part
    without registering here."""
    mesh = getattr(op, "sharding_mesh", None)
    if mesh is not None:
        return mesh
    if not (isinstance(op, Operator) and dataclasses.is_dataclass(op)):
        return None
    stack = [getattr(op, f.name) for f in dataclasses.fields(op)]
    while stack:
        x = stack.pop()
        if isinstance(x, Operator):
            mesh = sharding_mesh(x)
            if mesh is not None:
                return mesh
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return None


def to_dense(op) -> Tensor:
    """Materialize any protocol object (tests and small operands only)."""
    if isinstance(op, Operator):
        return op.to_dense()
    return op.matmat(torch.eye(op.n, dtype=op.dtype, device=op.device))
