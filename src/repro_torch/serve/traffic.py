"""Synthetic serve traffic: Zipf shape mix + slowly drifting tenant streams.

Counterpart of ``repro.serve.traffic``, and a copy of it: plain numpy, so
one seed gives the reference's request stream array for array, and the
parity tests serve the *same* operands through both servers.  One
generator feeds the CLI (``repro_torch.launch.solve_serve``) and
``chip_smoke.py`` phase 11: a head-heavy (Zipf) distribution over operand
shapes — the regime where shape bucketing and continuous batching pay —
with an optional fraction of requests pinned to repeat *tenants* whose
operands drift slowly between requests (the Session-tracking regime).

Operands are low-rank-plus-noise like the solver zoo, so every request is
a realistic partial-SVD target rather than white noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

# a head-heavy but bounded shape menu: several logical shapes per 32-grid
# bucket, so bucketing actually coalesces.
DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = (
    (96, 64), (90, 60), (80, 56), (64, 64), (120, 48), (48, 96),
)


@dataclasses.dataclass
class Request:
    """One synthetic serve request.

    ``kind="delta"`` carries the low-rank drift factors in ``delta``
    (``(U, s, Vt)`` with ``U (m, k)``, ``s (k,)``, ``Vt (k, n)``); ``A``
    is then the *post-drift* operand — kept for accuracy checking on the
    consumer side, never shipped to the server.  ``kind="entries"``
    carries an unstructured COO drift in ``entries`` (``(rows, cols,
    vals)``) with the same ``A`` convention.
    """

    A: np.ndarray
    shape: Tuple[int, int]
    tenant: Optional[str] = None
    kind: str = "factorize"
    delta: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    entries: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def zipf_choice(rng: np.random.Generator, k: int, size: int,
                a: float = 1.1) -> np.ndarray:
    """``size`` indices in [0, k) with a truncated-Zipf(a) rank law
    (index 0 = hottest)."""
    ranks = np.arange(1, k + 1, dtype=np.float64)
    p = ranks ** -a
    p /= p.sum()
    return rng.choice(k, size=size, p=p)


def lowrank_operand(rng: np.random.Generator, shape: Tuple[int, int],
                    rank: int, noise: float = 1e-3,
                    dtype=np.float32) -> np.ndarray:
    """Low-rank-plus-noise operand with a geometric spectrum (the zoo's
    default texture)."""
    m, n = shape
    r = min(rank, m, n)
    U = rng.standard_normal((m, r))
    V = rng.standard_normal((n, r))
    s = np.logspace(0.0, -2.0, r)
    A = (U * s) @ V.T + noise * rng.standard_normal((m, n))
    return np.asarray(A, dtype=dtype)


def entry_drift(rng: np.random.Generator, A: np.ndarray, *,
                drift: float, nnz: int, dtype=np.float32
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unstructured COO drift: ``nnz`` uniformly placed entry updates
    ``(rows, cols, vals)`` with ``||vals||_2 = drift * ||A||_F`` — the
    sparse/entrywise regime no low-rank factor pair can express."""
    m, n = A.shape
    rows = rng.integers(0, m, size=nnz).astype(np.int32)
    cols = rng.integers(0, n, size=nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    scale = drift * np.linalg.norm(A) / max(np.linalg.norm(vals), 1e-30)
    return rows, cols, (scale * vals).astype(dtype)


def lowrank_drift(rng: np.random.Generator, A: np.ndarray, *,
                  drift: float, drift_rank: int, dtype=np.float32
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-``drift_rank`` drift factors ``(U, s, Vt)`` with
    ``||U diag(s) Vt||_F = drift * ||A||_F``."""
    m, n = A.shape
    k = max(1, min(drift_rank, m, n))
    U = rng.standard_normal((m, k)).astype(dtype)
    Vt = rng.standard_normal((k, n)).astype(dtype)
    W = U @ Vt
    scale = drift * np.linalg.norm(A) / max(np.linalg.norm(W), 1e-30)
    s = np.full((k,), scale, dtype)
    return U, s, Vt


def synthetic_stream(n_requests: int, *,
                     shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES,
                     zipf_a: float = 1.1,
                     rank: int = 8,
                     tenants: int = 0,
                     tenant_fraction: float = 0.25,
                     drift: float = 1e-3,
                     estimate_fraction: float = 0.0,
                     structured_drift: bool = False,
                     drift_rank: int = 2,
                     entry_drift_nnz: int = 0,
                     seed: int = 0) -> Iterator[Request]:
    """Yield ``n_requests`` synthetic :class:`Request`\\ s.

    ``tenants > 0`` routes ~``tenant_fraction`` of the stream to that many
    repeat clients, each pinned to one shape with an operand that drifts
    by ``drift`` (relative Frobenius) per request — small enough that the
    Session refine path stays engaged.  ``estimate_fraction`` converts
    that share of the anonymous stream into rank-estimate requests.

    ``structured_drift=True`` makes every tenant drift a rank-
    ``drift_rank`` *structured* perturbation shipped as a ``kind="delta"``
    request (the factors, not the operand) — the regime where the serving
    stack's zero-iteration update path engages.  Tenant first-contact
    operands are then exactly rank-``rank`` (no additive noise), matching
    how a real incremental stream starts from a factorized state.

    ``entry_drift_nnz > 0`` instead ships every tenant drift as a
    ``kind="entries"`` request of that many COO triplets (unstructured —
    no factor pair exists), engaging the sketch-resident path.  Mutually
    exclusive with ``structured_drift``.
    """
    if structured_drift and entry_drift_nnz > 0:
        raise ValueError("structured_drift and entry_drift_nnz are "
                         "mutually exclusive drift regimes")
    rng = np.random.default_rng(seed)
    shapes = [tuple(s) for s in shapes]
    picks = zipf_choice(rng, len(shapes), n_requests, a=zipf_a)
    tenant_state: Dict[str, np.ndarray] = {}
    for i in range(n_requests):
        if tenants > 0 and rng.random() < tenant_fraction:
            tid = f"tenant-{int(rng.integers(tenants))}"
            A = tenant_state.get(tid)
            if A is None:
                shape = shapes[picks[i]]
                incremental = structured_drift or entry_drift_nnz > 0
                noise = 0.0 if incremental else 1e-3
                A = lowrank_operand(rng, shape, rank, noise=noise)
                tenant_state[tid] = A
                yield Request(A=A, shape=tuple(A.shape), tenant=tid)
                continue
            if entry_drift_nnz > 0:
                rows, cols, vals = entry_drift(rng, A, drift=drift,
                                               nnz=entry_drift_nnz,
                                               dtype=A.dtype)
                A = A.copy()
                np.add.at(A, (rows, cols), vals)
                tenant_state[tid] = A
                yield Request(A=A, shape=tuple(A.shape), tenant=tid,
                              kind="entries",
                              entries=(rows, cols, vals))
                continue
            if structured_drift:
                U, s, Vt = lowrank_drift(rng, A, drift=drift,
                                         drift_rank=drift_rank,
                                         dtype=A.dtype)
                A = (A + (U * s) @ Vt).astype(A.dtype)
                tenant_state[tid] = A
                yield Request(A=A, shape=tuple(A.shape), tenant=tid,
                              kind="delta", delta=(U, s, Vt))
                continue
            step = rng.standard_normal(A.shape).astype(A.dtype)
            scale = drift * np.linalg.norm(A) / max(
                np.linalg.norm(step), 1e-30)
            A = A + scale * step
            tenant_state[tid] = A
            yield Request(A=A, shape=tuple(A.shape), tenant=tid)
            continue
        shape = shapes[picks[i]]
        kind = "estimate" if rng.random() < estimate_fraction \
            else "factorize"
        yield Request(A=lowrank_operand(rng, shape, rank), shape=shape,
                      kind=kind)


__all__ = ["DEFAULT_SHAPES", "Request", "entry_drift", "lowrank_drift",
           "lowrank_operand", "synthetic_stream", "zipf_choice"]
