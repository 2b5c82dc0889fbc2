"""SketchState — a resident generalized-Nyström sketch pair, maintained
incrementally under drift.  Counterpart of ``repro.sketchres.state``.

Both panels are *linear* in the operand: ``Y = AΩ`` and ``Z = ΨᵀA``, so
for any drift ``A → A + Δ`` the panels of the new operand are exactly
``Y + ΔΩ`` and ``Z + ΨᵀΔ``.  For a COO entry stream that is a hashed
scatter-add: entry ``(i, j, v)`` lands ``v·Ω[j, :]`` on row i of Y and
``v·Ψ[i, :]`` on column j of Z, and with the hashed-sign ensemble each of
those is ζ signed slot updates, landed by ``kernels.ops.scatter_add``.

Test matrices are the **hashed-sign** (count-sketch) ensemble: each source
coordinate ``j`` owns ζ slots ``slots[j, s] ∈ [0, d)`` with signs
±1/√ζ, the per-source layout a fold needs ("which slots does source j
touch?" in O(ζ)).  The reference re-derives slots and signs from two
stored PRNG keys on every fold; the port stores two integer seeds, drawn
at :func:`sketch_operand` from the caller's ``torch.Generator``, and every
fold re-derives the tables from fresh generators of those seeds on the
state's device, so a fold sees the same bits as the sweep did.  (The CPU
and the card draw different bits from one seed.)  A parity test hands
both packages the reference's own tables instead (``omega=`` / ``psi=``,
see ``bridge.hashed_sketch``); the state then carries those tables in
place of seeds.

The staleness odometer tracks the cumulative folded Frobenius mass against
``budget·base_norm``; once it trips, the owner must re-sketch from the
operand (one sweep) instead of trusting the panels.  Panels are stored in
``_store_dtype(spec.precision, …)`` and every fold accumulates in f32.
Nothing in a fold waits for the device: ``folded_mass`` and ``base_norm``
are 0-d device tensors and :func:`is_stale` returns a 0-d bool tensor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch._device import to_tensor
from repro_torch.api.results import Factorization
from repro_torch.core._keys import integers, resolve_generator
from repro_torch.core.gk import _store_dtype
from repro_torch.core.operators import _BACKENDS, as_operator, mixed_tmm
from repro_torch.core.sketch import _check_shape, _panel_dims, \
    nystrom_reconstruct
from repro_torch.kernels.sketch_matvec import ZETA

Tensor = torch.Tensor
F32, I32 = torch.float32, torch.int32

# default staleness budget: re-sketch once the cumulative folded Frobenius
# mass reaches half the operand's mass at sketch time.
BUDGET = 0.5

# fold batches are padded up to a multiple of this (and then to the next
# power of two), as in the reference, whose plan cache then sees O(log E)
# distinct entry shapes.
_ENTRY_QUANTUM = 64


# ---------------------------------------------------------------------------
# hashed-sign ensemble (per-source-coordinate layout)
# ---------------------------------------------------------------------------

def _hashed(generator: torch.Generator, n: int, d: int,
            zeta: int) -> tuple[Tensor, Tensor]:
    """slots (n, ζ) int32 in [0, d) and signs (n, ζ) f32 = ±1/√ζ, drawn on
    the generator's device."""
    z = max(1, min(zeta, d))
    slots = integers(generator, d, (n, z))
    signs = (2.0 * integers(generator, 2, (n, z)) - 1.0) / math.sqrt(z)
    return slots, signs.to(F32)


def _dense(slots: Tensor, signs: Tensor, d: int) -> Tensor:
    """Materialize T (n, d) f32; colliding slots sum, as in the fold.
    Slots are added one slot index at a time: within one, every row has
    one target, so no write meets a duplicate and the bits are the same on
    every run and every device."""
    n, z = slots.shape
    T = torch.zeros((n, d), dtype=F32, device=slots.device)
    rows = torch.arange(n, device=slots.device)
    cols = slots.long()
    for s in range(z):
        T[rows, cols[:, s]] += signs[:, s].to(F32)
    return T


@dataclasses.dataclass(frozen=True, eq=False)
class _HashedSketch:
    """Duck-types ``core.sketch``'s test matrices (``shape`` / ``dense`` /
    ``tapply``), so ``Operator.sketch_pass`` takes the streaming ensemble
    for the initial one-sweep capture."""

    slots: Tensor       # (n, ζ) int32
    signs: Tensor       # (n, ζ) f32
    d: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.slots.shape[0], self.d)

    def dense(self) -> Tensor:
        return _dense(self.slots, self.signs, self.d)

    def tapply(self, X: Tensor) -> Tensor:
        """``Tᵀ X`` (d, b) f32, a dense product as in the reference.  A
        narrower X (a bf16 operand) is widened one row block at a time,
        never whole."""
        if X.dtype == F32:
            return self.dense().T @ X
        return mixed_tmm(self.dense(), X)


def _tables(seeds: tuple[int, int], m: int, n: int, k: int, l: int,
            zeta: int, device) -> tuple[_HashedSketch, _HashedSketch]:
    """(Ω (n, k), Ψ (m, l)) from fresh generators of the two seeds."""
    def gen(seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seed)
    return (_HashedSketch(*_hashed(gen(seeds[0]), n, k, zeta), k),
            _HashedSketch(*_hashed(gen(seeds[1]), m, l, zeta), l))


# ---------------------------------------------------------------------------
# the state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SketchState:
    """Resident sketch pair + seeds (or tables) + staleness odometer.

    Y           (m, k) range panel ``AΩ``, storage dtype (bf16 under
                ``precision="bf16"``; every fold accumulates f32).
    Z           (l, n) co-range panel ``ΨᵀA``, storage dtype.
    folded_mass () f32 — cumulative ‖Δ‖_F folded since the sweep (exact ℓ2
                of the values for entry and dense folds, the ‖ΨᵀΔ‖_F
                sketch estimate for factored folds).
    base_norm   () f32 — ‖A‖_F estimate at sweep time (``‖Z‖_F``).
    seeds       (Ω seed, Ψ seed): the tables are re-derived per fold; or
    tables      (Ω, Ψ) handed to :func:`sketch_operand` (exactly one of
                the two is set).
    """

    Y: Tensor
    Z: Tensor
    folded_mass: Tensor
    base_norm: Tensor
    seeds: Optional[tuple[int, int]] = None
    tables: Optional[tuple[_HashedSketch, _HashedSketch]] = None
    zeta: int = ZETA
    budget: float = BUDGET
    backend: str = "xla"

    def __post_init__(self):
        if (self.seeds is None) == (self.tables is None):
            raise ValueError("a SketchState carries seeds or tables, "
                             "exactly one of them")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.Y.shape[0], self.Z.shape[1])

    @property
    def panel_dims(self) -> tuple[int, int]:
        """(k, l) — range / co-range sketch widths."""
        return (self.Y.shape[1], self.Z.shape[0])

    @property
    def device(self) -> torch.device:
        return self.Y.device

    def sketches(self) -> tuple[_HashedSketch, _HashedSketch]:
        """(Ω, Ψ): the carried tables, or the tables re-derived from the
        stored seeds on the state's device."""
        if self.tables is not None:
            return self.tables
        m, n = self.shape
        k, l = self.panel_dims
        return _tables(self.seeds, m, n, k, l, self.zeta, self.device)


def sketch_operand(A, spec, *, generator: Optional[torch.Generator] = None,
                   omega: Optional[_HashedSketch] = None,
                   psi: Optional[_HashedSketch] = None,
                   budget: float = BUDGET, backend: Optional[str] = None,
                   device=None) -> SketchState:
    """ONE sweep over the operand → a resident :class:`SketchState` sized
    by the spec's gnystrom panel rule (``k = rank + oversample`` or
    ``sketch_dim``, ``l ≈ 2k``).

    The two seeds are drawn from ``generator`` (a seed-0 generator, with a
    warning, when it is missing); ``omega`` (n, k) and ``psi`` (m, l),
    given together, are used instead of seeded tables.
    """
    A = as_operator(A, device=device)
    m, n = A.shape
    k, l = _panel_dims(spec.rank, spec.oversample, spec.sketch_dim, m, n)
    store = _store_dtype(spec.precision,
                         torch.promote_types(A.dtype, F32))
    if (omega is None) != (psi is None):
        raise ValueError("pass omega and psi together, or neither")
    seeds = tables = None
    if omega is None:
        generator = resolve_generator(generator, caller="sketch_operand",
                                      device=A.device)
        seeds = tuple(torch.randint(0, 2 ** 62, (2,), generator=generator,
                                    device=generator.device).tolist())
        omega, psi = _tables(seeds, m, n, k, l, ZETA, A.device)
    else:
        _check_shape("omega", omega, (n, k))
        _check_shape("psi", psi, (m, l))
        tables = (omega, psi)
    Y, Z = A.sketch_pass(omega, psi)              # the one operator sweep
    Zt = Z.to(F32).T                              # (l, n) = ΨᵀA
    base = torch.linalg.vector_norm(Zt)           # E‖ΨᵀA‖_F² = ‖A‖_F²
    return SketchState(Y=Y.to(store), Z=Zt.to(store),
                       folded_mass=torch.zeros((), dtype=F32,
                                               device=Y.device),
                       base_norm=base, seeds=seeds, tables=tables,
                       zeta=ZETA, budget=budget,
                       backend=backend or spec.backend)


# ---------------------------------------------------------------------------
# incremental folds
# ---------------------------------------------------------------------------

def _scatter(rows: Tensor, cols: Tensor, vals: Tensor,
             shape: tuple[int, int], backend: str) -> Tensor:
    if backend == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.scatter_add(rows, cols, vals, shape)
    from repro_torch.kernels import ref
    return ref.scatter_add(rows, cols, vals, shape)


def _lookup(idx: Tensor, n: int) -> Tensor:
    """Table rows of entry indices, read as the reference's JAX indexing
    reads them: a negative index counts from the end, and an index still
    outside [0, n) clamps to the nearest row."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)


def _stream(rows, cols, vals, device) -> tuple[Tensor, Tensor, Tensor]:
    return (to_tensor(rows, device=device).reshape(-1).to(I32),
            to_tensor(cols, device=device).reshape(-1).to(I32),
            to_tensor(vals, device=device).reshape(-1).to(F32))


def pad_entries(rows, cols, vals, *, quantum: int = _ENTRY_QUANTUM,
                device=None) -> tuple[Tensor, Tensor, Tensor]:
    """Pad a COO batch to the next power-of-two multiple of ``quantum``
    with (0, 0, 0.0) entries — exact no-ops for both the fold and the mass
    odometer.  Tensors keep their device; arrays go to ``device`` (by
    default the CUDA card)."""
    rows, cols, vals = _stream(rows, cols, vals, device)
    E = rows.shape[0]
    target = quantum
    while target < E:
        target *= 2
    pad = target - E
    if pad:
        rows, cols, vals = (torch.cat([x, x.new_zeros(pad)])
                            for x in (rows, cols, vals))
    return rows, cols, vals


def apply_entries(state: SketchState, rows, cols, vals) -> SketchState:
    """Fold a COO entry stream of the drift into both panels, O(nnz·ζ).

    Entry ``(i, j, v)`` contributes ``v·Ω[j, :]`` to ``Y[i, :]`` and
    ``v·Ψ[i, :]`` to ``Z[:, j]``: each is ζ signed slot updates, expanded
    slot-major (all entries' first slots, then all second slots, …) and
    landed by one scatter-add per panel, so duplicate destinations sum in
    the reference's entry order.  Zero-value entries are exact no-ops,
    which makes :func:`pad_entries` padding safe.  An index outside the
    operand is read as the reference's pallas backend reads it: its table
    lookup wraps a negative index and clamps (:func:`_lookup`), and the
    scatter drops the destination outside the panel.
    """
    m, n = state.shape
    k, l = state.panel_dims
    om, ps = state.sketches()
    rows, cols, vals = _stream(rows, cols, vals, state.device)
    oc, pr = _lookup(cols, n), _lookup(rows, m)
    zo, zp = om.slots.shape[1], ps.slots.shape[1]
    # ΔY: destination rows are the entries' rows, columns their Ω slots.
    dY = _scatter(rows.repeat(zo), om.slots[oc].T.reshape(-1),
                  (vals[None, :] * om.signs[oc].T).reshape(-1),
                  (m, k), state.backend)
    # ΔZ: destination rows are the entries' Ψ slots, columns their columns.
    dZ = _scatter(ps.slots[pr].T.reshape(-1), cols.repeat(zp),
                  (vals[None, :] * ps.signs[pr].T).reshape(-1),
                  (l, n), state.backend)
    Y = (state.Y.to(F32) + dY).to(state.Y.dtype)
    Z = (state.Z.to(F32) + dZ).to(state.Z.dtype)
    mass = state.folded_mass + torch.linalg.vector_norm(vals)
    return dataclasses.replace(state, Y=Y, Z=Z, folded_mass=mass)


def _apply_block(state: SketchState, dop,
                 mass: Optional[Tensor] = None) -> SketchState:
    """Fold an operator drift by two panel products; ``mass`` defaults to
    the ``‖ΨᵀΔ‖_F`` sketch estimate."""
    om, ps = state.sketches()
    dY = dop.matmat(om.dense()).to(F32)               # (m, k) = ΔΩ
    dZ = dop.rmatmat(ps.dense()).to(F32).T            # (l, n) = ΨᵀΔ
    if mass is None:
        mass = torch.linalg.vector_norm(dZ)
    Y = (state.Y.to(F32) + dY).to(state.Y.dtype)
    Z = (state.Z.to(F32) + dZ).to(state.Z.dtype)
    return dataclasses.replace(state, Y=Y, Z=Z,
                               folded_mass=state.folded_mass + mass)


def apply_dense_delta(state: SketchState, D) -> SketchState:
    """Fold a dense (m, n) drift block: one panel product per sketch,
    exact Frobenius mass on the odometer."""
    D = to_tensor(D, device=state.device)
    return _apply_block(state, as_operator(D),
                        torch.linalg.vector_norm(D.to(F32)))


def apply_lowrank_delta(state: SketchState, dop) -> SketchState:
    """Fold a factored drift (``LowRankOp`` or any operator) without
    materializing it: two factored panel products.  The odometer takes the
    ``‖ΨᵀΔ‖_F`` sketch estimate (the estimator of ``base_norm``)."""
    return _apply_block(state, as_operator(dop, device=state.device))


# ---------------------------------------------------------------------------
# staleness + reconstruction
# ---------------------------------------------------------------------------

def staleness_ratio(state: SketchState) -> Tensor:
    """Folded mass over the coverage budget — ≥ 1.0 means stale."""
    return state.folded_mass / torch.clamp(state.budget * state.base_norm,
                                           min=1e-30)


def is_stale(state: SketchState) -> Tensor:
    """True (a 0-d bool tensor) once the cumulative folded mass reaches the
    coverage budget; owners must re-sketch instead of reconstructing."""
    return staleness_ratio(state) >= 1.0


def reconstruct(state: SketchState, spec) -> Factorization:
    """Zero-sweep factorization from the maintained panels: the stabilized
    generalized-Nyström core solve on ``(Y, Z, ΨᵀY)``.  Returns
    ``iterations=0, method="sketch"``; nothing here touches the operator,
    so callers must gate the answer (a residual probe and
    :func:`is_stale`) before serving it."""
    _, ps = state.sketches()
    Yf = state.Y.to(F32)
    C = ps.tapply(Yf)                             # (l, k) = ΨᵀY, no touch
    U, s, Vt = nystrom_reconstruct(Yf, state.Z, C)
    r = min(spec.rank, s.shape[0])
    return Factorization(U[:, :r], s[:r], Vt[:r, :].T,
                         iterations=torch.tensor(0, dtype=torch.int32,
                                                 device=Yf.device),
                         breakdown=torch.tensor(False, device=Yf.device),
                         method="sketch")


__all__ = [
    "BUDGET", "SketchState", "apply_dense_delta", "apply_entries",
    "apply_lowrank_delta", "is_stale", "pad_entries", "reconstruct",
    "sketch_operand", "staleness_ratio",
]
