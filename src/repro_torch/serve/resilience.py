"""Serving resilience primitives: typed failure taxonomy, per-group
circuit breaker, bounded retry backoff, the HMT residual probe that gates
degraded and sketch-reconstructed answers, and the NaN quarantine gate.

Counterpart of ``repro.serve.resilience`` (plain host code: the standard
library, numpy and torch).  The failure taxonomy:

  :class:`DeadlineExceeded`   the request aged past its deadline before a
                              worker could touch it.
  :class:`WorkerCrashed`      the dispatch worker died or hung while this
                              request was in flight.  Retryable.
  :class:`CircuitOpen`        the request's group breaker is shedding
                              load and no degraded answer was possible.
  :class:`PoisonedOperand`    the operand carries NaN/Inf and was
                              quarantined at submit.
  :class:`DegradedRejected`   a degraded answer failed the residual probe.

The residual probe is Halko–Martinsson–Tropp posterior error estimation:
for factors ``U diag(s) Vᵀ ≈ A`` and a few Gaussian probe vectors ``ω``,
``‖Aω − U diag(s) Vᵀ ω‖ / ‖Aω‖`` estimates the relative defect of the
approximation at the cost of ``probes`` extra matvecs.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict

import numpy as np
import torch


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before dispatch admission."""


class WorkerCrashed(RuntimeError):
    """The dispatch worker died/hung with this request in flight; the
    supervisor restarted the worker.  Safe to retry."""


class CircuitOpen(RuntimeError):
    """The group's circuit breaker is open (shedding load) and degraded
    mode could not answer."""


class PoisonedOperand(ValueError):
    """The operand contains NaN/Inf; quarantined at submit."""


class DegradedRejected(RuntimeError):
    """The degraded-mode answer failed the residual-probe accuracy gate."""


class CircuitBreaker:
    """Per-group consecutive-failure circuit breaker.

    closed     normal operation; ``threshold`` consecutive failures open
               it.
    open       shed load (callers take the degraded path or fail fast)
               until ``reset_s`` elapses.
    half-open  after the reset timer one trial batch is admitted; success
               closes the breaker, failure re-opens it (and restarts the
               timer).

    All transitions are timestamp-driven inside :meth:`allow` — no
    background thread.  Thread-safe.
    """

    def __init__(self, threshold: int = 5, reset_s: float = 5.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._opens = 0

    def allow(self) -> bool:
        """May a (non-degraded) dispatch proceed right now?  Flips open →
        half-open when the reset timer has elapsed."""
        with self._lock:
            if self._state == "open":
                if time.perf_counter() - self._opened_at >= self.reset_s:
                    self._state = "half-open"
                    return True
                return False
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == "half-open" or self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = time.perf_counter()
                self._opens += 1

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == "open" and \
                    time.perf_counter() - self._opened_at >= self.reset_s:
                return "half-open"
            return self._state

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "opens": self._opens}


def retry_with_backoff(fn, *, retries: int, backoff_s: float,
                       retry_on=(Exception,), on_retry=None):
    """Run ``fn()`` with up to ``retries`` retries on ``retry_on``
    exceptions, sleeping ``backoff_s * 2**attempt`` between attempts
    (bounded exponential backoff).  The final failure re-raises."""
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt)
            time.sleep(backoff_s * (2 ** attempt))
            attempt += 1


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.to(torch.float32)   # exact; numpy has no bf16 of its own
        return x.cpu().numpy()
    return np.asarray(x)


def residual_probe(A, fact, *, probes: int = 4, seed: int = 0) -> float:
    """HMT-style randomized posterior residual of ``fact`` against ``A``:
    ``‖AΩ − U diag(s) (VᵀΩ)‖_F / ‖AΩ‖_F`` over ``probes`` Gaussian
    columns Ω drawn by ``numpy.random.default_rng(seed)``.  ~0 for a
    faithful factorization, O(1) for garbage.

    A numpy array or a CPU tensor takes the reference's numpy path and
    gives its value bit for bit.  A CUDA tensor stays where it is: the
    same Ω is copied to the card and ``A Ω``, ``Vᵀ Ω`` are plain
    ``torch.matmul`` products there (TF32 off), in the dtype numpy would
    use; at 1e5 × 8e4 a host copy would move 32 GB per probe.  Either way
    the probe shares no kernel with the solver it checks.
    """
    if isinstance(A, torch.Tensor) and A.device.type != "cpu":
        return _probe_on_device(A, fact, int(probes), seed)
    A = _host(A)
    U, s, V = _host(fact.U), _host(fact.s), _host(fact.V)
    rng = np.random.default_rng(seed)
    omega = rng.standard_normal((A.shape[1], int(probes)))
    omega = omega.astype(np.result_type(A.dtype, np.float32), copy=False)
    ao = A @ omega
    approx = U @ (s[:, None] * (V.T @ omega))
    denom = float(np.linalg.norm(ao))
    if denom <= 0.0:
        # zero operand: any zero-ish factorization is exact
        return float(np.linalg.norm(approx))
    return float(np.linalg.norm(ao - approx) / denom)


_ROWS = 1 << 14         # row block of a narrow operand widened on the card
# Ω's columns are padded with zeros to a multiple of this: cuBLAS forms
# A Ω about twice as fast with 8 columns as with 4 at 1e5 × 8e4 f32
# (chip_smoke.py phase 9 times both)
_COLUMNS = 8


def _probe_on_device(A: torch.Tensor, fact, probes: int, seed: int) -> float:
    dev = A.device
    wide = torch.float64 if A.dtype == torch.float64 else torch.float32
    rng = np.random.default_rng(seed)
    drawn = rng.standard_normal((A.shape[1], probes))
    omega = torch.zeros(A.shape[1], -(-probes // _COLUMNS) * _COLUMNS,
                        dtype=wide)
    omega[:, :probes] = torch.from_numpy(drawn.astype(
        np.float64 if wide == torch.float64 else np.float32))
    omega = omega.to(dev)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if A.dtype == wide:
            ao = (A @ omega)[:, :probes]
        else:           # bf16 / f16 storage: widen a row block at a time
            ao = torch.cat([A[r:r + _ROWS].to(wide) @ omega
                            for r in range(0, A.shape[0], _ROWS)])[:, :probes]
        omega = omega[:, :probes]
        U, s, V = (x.to(device=dev, dtype=wide)
                   for x in (fact.U, fact.s, fact.V))
        approx = U @ (s[:, None] * (V.T @ omega))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    denom = float(torch.linalg.vector_norm(ao))
    if denom <= 0.0:
        return float(torch.linalg.vector_norm(approx))
    return float(torch.linalg.vector_norm(ao - approx)) / denom


def _leaves(tree):
    """Tensors and arrays of a nested structure: dicts, lists, tuples and
    dataclasses (operators, factorizations) are walked."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, float)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def finite_or_raise(tree, *, what: str = "operand") -> None:
    """Quarantine gate: raise :class:`PoisonedOperand` when any float
    leaf of ``tree`` (a tensor, an array, an operator or a nest of dicts,
    lists and dataclasses) carries NaN/Inf.  One poisoned example in a
    stacked batch contaminates every co-batched result, so this must run
    per request at submit time, before batching.  A tensor is checked on
    its own device (one reduction, no host copy)."""
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and \
                not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = np.issubdtype(arr.dtype, np.floating) and \
                not np.isfinite(arr).all()
        if bad:
            raise PoisonedOperand(
                f"{what} contains NaN/Inf and was quarantined; a "
                "non-finite operand would poison every request in its "
                "batch")


__all__ = [
    "CircuitBreaker", "CircuitOpen", "DeadlineExceeded", "DegradedRejected",
    "PoisonedOperand", "WorkerCrashed", "finite_or_raise", "residual_probe",
    "retry_with_backoff",
]
