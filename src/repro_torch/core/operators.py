"""Operator protocol: the slice of ``repro.core.operators`` the main path uses.

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
  * ``TransposedOp(inner)`` — ``Aᵀ`` without a stored transpose.
  * ``GramOp(inner, side)`` — ``AᵀA`` / ``AAᵀ`` applied as two matvecs.
  * ``SinglePassOp(inner)`` — marks an operand that may be swept once.

The sparse, Kronecker, low-rank, sum and scaled operators are a later
slice (``ROADMAP.md`` Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._device import to_tensor

Tensor = torch.Tensor

_BACKENDS = ("xla", "pallas")
_GRAM_SIDES = ("ata", "aat")

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

    @property
    def T(self) -> "Operator":
        return TransposedOp(self)


@dataclasses.dataclass(frozen=True, eq=False)
class DenseOp(Operator):
    """In-memory (m, n) matrix.  ``backend="pallas"`` runs the Lanczos
    half-steps and the fused matvecs through the CUDA kernels (A streamed
    once per half-step) and both sketch products through the sketch
    kernel; ``"xla"`` composes plain torch ops.  A numpy ``A`` goes to the
    CUDA card (and raises without one); pass a tensor to choose its
    device."""

    A: Tensor
    backend: str = "xla"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if not isinstance(self.A, Tensor):
            object.__setattr__(self, "A", to_tensor(self.A))
        if self.A.dim() != 2:
            raise ValueError(f"DenseOp needs a 2-D matrix, got "
                             f"{tuple(self.A.shape)}")

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.A.shape)

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

    def sketch_pass(self, omega, psi):
        if self.backend == "pallas":
            # both directions through the sketch kernel: (A Ω)ᵀ = Ωᵀ Aᵀ and
            # (Aᵀ Ψ)ᵀ = Ψᵀ A are each one Tᵀ X apply; Aᵀ is a view, read in
            # place by the kernel (never copied).
            return omega.tapply(self.A.T).T, psi.tapply(self.A).T
        return Operator.sketch_pass(self, omega, psi)


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

    @property
    def T(self):
        return self.inner


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

    @property
    def T(self):
        return SinglePassOp(self.inner.T)


def as_operator(A, *, backend: str = "xla", device=None) -> Operator:
    """Coerce to the operator protocol.

    Operators (and look-alikes with ``mv`` and ``rmv``) pass through;
    tensors wrap into a :class:`DenseOp` on their own device (or on
    ``device``); anything else (numpy arrays) goes to ``device``, by
    default the CUDA card.
    """
    if isinstance(A, Operator):
        return A
    if hasattr(A, "mv") and hasattr(A, "rmv"):
        return A
    if backend not in _BACKENDS:
        raise ValueError(
            f"backend must be one of {_BACKENDS}, got {backend!r}")
    return DenseOp(to_tensor(A, device=device), backend=backend)
