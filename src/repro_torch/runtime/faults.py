"""Fault injection: named failpoints for chaos-testing the serving stack.

Counterpart of ``repro.runtime.faults`` (numpy and the standard library
only, copied rather than imported).  :func:`corrupt` also takes a float
tensor, and poisons a copy of it on the tensor's own device.

A *failpoint* is a named hook compiled into production code paths
(``serve.dispatch``, ``plan.solve``, ``checkpoint.write``,
``session.restore``) that does nothing until a test, the chaos benchmark
or the ``--chaos`` CLI flag *arms* it with a :class:`FaultSpec`:

    with inject("plan.solve", mode="raise", p=0.2, transient=True):
        ...  # ~20% of plan solves raise TransientFault

Armed behaviours:

* ``mode="raise"``    raise :class:`FaultInjected` (or
                      :class:`TransientFault` when ``transient=True`` —
                      the retry layer's signal that backing off is worth
                      it, or any exception type passed via ``exc``).
* ``mode="delay"``    sleep ``delay_s`` seconds (simulates a hung worker
                      / slow device; the serve watchdog's prey).
* ``mode="corrupt"``  :func:`corrupt` mangles the value passed through
                      the failpoint (NaN for float arrays and tensors,
                      flipped bytes for raw buffers) — simulates bit-rot
                      and poisoned operands.

Design constraints, in order:

1. **No-op when disarmed.**  The registry holds a single module-level
   ``_ARMED`` flag checked before any dict lookup, so production traffic
   pays one attribute read per failpoint crossing.
2. **Seeded.**  Each armed failpoint owns a ``numpy`` Generator seeded
   from (``seed``, name), so a chaos run replays the same fault schedule
   for the same seed regardless of which other failpoints are armed.
3. **Thread-safe.**  Arming/disarming and probability draws take a lock;
   failpoints fire concurrently from client threads, the dispatch worker
   and the watchdog.
4. **Scoped.**  ``inject(...)`` / ``chaos(...)`` are context managers
   that disarm on exit even when the body raises — a failed test never
   leaves a failpoint armed for the rest of the suite.

``fire_count(name)`` / ``fault_stats()`` expose how often each armed
failpoint actually triggered — the chaos bench reports the injected-fault
mix next to the availability it measured.
"""
from __future__ import annotations

import contextlib
import threading
import time
import zlib
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class FaultInjected(RuntimeError):
    """An armed failpoint fired (mode="raise")."""


class TransientFault(FaultInjected):
    """A retryable injected failure — the bounded-retry layer's cue."""


class FaultSpec:
    """One armed failpoint's behaviour.

    mode        "raise" | "delay" | "corrupt".
    p           per-crossing trigger probability in [0, 1].
    delay_s     sleep length for mode="delay".
    transient   mode="raise" raises TransientFault instead of
                FaultInjected (ignored when ``exc`` is given).
    exc         exception *type* to raise for mode="raise".
    max_fires   stop triggering after this many fires (None = unbounded)
                — "crash exactly once" tests want determinism, not a
                probability.
    seed        RNG seed; the stream is additionally folded with the
                failpoint name so two armed points never share a draw
                sequence.
    """

    __slots__ = ("name", "mode", "p", "delay_s", "transient", "exc",
                 "max_fires", "fires", "_rng")

    def __init__(self, name: str, mode: str = "raise", *, p: float = 1.0,
                 delay_s: float = 0.05, transient: bool = False,
                 exc: Optional[type] = None,
                 max_fires: Optional[int] = None, seed: int = 0):
        if mode not in ("raise", "delay", "corrupt"):
            raise ValueError(
                f"mode must be 'raise', 'delay' or 'corrupt', got {mode!r}")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.name = name
        self.mode = mode
        self.p = float(p)
        self.delay_s = float(delay_s)
        self.transient = bool(transient)
        self.exc = exc
        self.max_fires = max_fires
        self.fires = 0
        # fold the name into the seed so arming the same chaos seed on N
        # failpoints yields N independent, reproducible schedules
        self._rng = np.random.default_rng(
            (int(seed) << 32) ^ zlib.crc32(name.encode()))

    def _should_fire(self) -> bool:
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.p >= 1.0 or self._rng.random() < self.p:
            self.fires += 1
            return True
        return False


_LOCK = threading.Lock()
_POINTS: Dict[str, FaultSpec] = {}
_ARMED = False          # fast-path gate: production pays one bool read
_TOTALS: Dict[str, int] = {}


def arm(name: str, mode: str = "raise", **kw) -> FaultSpec:
    """Arm ``name`` with a :class:`FaultSpec` (replacing any previous)."""
    global _ARMED
    spec = FaultSpec(name, mode, **kw)
    with _LOCK:
        _POINTS[name] = spec
        _ARMED = True
    return spec


def disarm(name: str) -> None:
    global _ARMED
    with _LOCK:
        _POINTS.pop(name, None)
        _ARMED = bool(_POINTS)


def disarm_all() -> None:
    global _ARMED
    with _LOCK:
        _POINTS.clear()
        _ARMED = False


def armed(name: str) -> bool:
    with _LOCK:
        return name in _POINTS


def fire_count(name: str) -> int:
    """How many times the failpoint actually triggered (lifetime, across
    re-arms)."""
    with _LOCK:
        live = _POINTS.get(name)
        return _TOTALS.get(name, 0) + (live.fires if live else 0)


def fault_stats() -> Dict[str, Any]:
    """{name: {mode, p, fires}} for every armed point plus lifetime fire
    totals of disarmed ones (the chaos bench's injected-fault report)."""
    with _LOCK:
        out: Dict[str, Any] = {
            name: {"mode": s.mode, "p": s.p, "fires": s.fires}
            for name, s in _POINTS.items()}
        for name, n in _TOTALS.items():
            if name not in out:
                out[name] = {"mode": None, "p": 0.0, "fires": n}
        return out


def reset_stats() -> None:
    with _LOCK:
        _TOTALS.clear()
        for s in _POINTS.values():
            s.fires = 0


def fire(name: str) -> None:
    """The failpoint crossing: no-op unless ``name`` is armed and its
    probability draw triggers; then raise or delay per the armed spec.

    Call this at the top of the protected operation — the fault lands
    *before* the real work, like a crash on entry."""
    if not _ARMED:
        return
    with _LOCK:
        spec = _POINTS.get(name)
        if spec is None or not spec._should_fire():
            return
        mode, delay_s = spec.mode, spec.delay_s
        exc = spec.exc
        transient = spec.transient
    if mode == "delay":
        time.sleep(delay_s)
        return
    if mode == "raise":
        if exc is not None:
            raise exc(f"failpoint {name!r} fired")
        if transient:
            raise TransientFault(f"failpoint {name!r} fired (transient)")
        raise FaultInjected(f"failpoint {name!r} fired")
    # mode == "corrupt" without a value crossing: nothing to mangle here;
    # sites that carry data route through corrupt() instead.


def corrupt(name: str, value):
    """Value-carrying failpoint: return ``value`` unchanged when disarmed,
    a mangled copy when an armed mode="corrupt" spec fires.

    Float arrays get a NaN planted at a seeded position (poisoned
    operand); byte buffers get one byte flipped (bit-rot).  A tensor gets
    the same seeded flat position in a copy on its own device (a NaN for a
    float tensor, every bit of the element flipped otherwise).  Raise/delay
    specs behave as in :func:`fire` — one site serves all three modes.
    """
    if not _ARMED:
        return value
    with _LOCK:
        spec = _POINTS.get(name)
        if spec is None or spec.mode != "corrupt":
            pass
        elif spec._should_fire():
            rng = spec._rng
            if isinstance(value, (bytes, bytearray)):
                buf = bytearray(value)
                i = int(rng.integers(len(buf))) if buf else 0
                if buf:
                    buf[i] ^= 0xFF
                return bytes(buf)
            if isinstance(value, torch.Tensor):
                return _corrupt_tensor(rng, value)
            arr = np.array(value, copy=True)
            if arr.size:
                i = int(rng.integers(arr.size))
                flat = arr.reshape(-1)
                flat[i] = np.nan if np.issubdtype(arr.dtype, np.floating) \
                    else flat[i] ^ np.asarray(-1, arr.dtype)
            return arr
    fire(name)        # raise/delay specs still apply at value crossings
    return value


def _corrupt_tensor(rng, value: torch.Tensor) -> torch.Tensor:
    """A copy of ``value`` on its device with the element at a seeded flat
    position poisoned: the same draw as a numpy array of that size."""
    out = value.clone(memory_format=torch.contiguous_format)
    if out.numel():
        i = int(rng.integers(out.numel()))
        flat = out.view(-1)
        flat[i] = float("nan") if out.is_floating_point() or out.is_complex() \
            else ~flat[i]
    return out


@contextlib.contextmanager
def inject(name: str, mode: str = "raise", **kw) -> Iterator[FaultSpec]:
    """Scoped arming: arm on enter, disarm (and roll the spec's fire
    count into the lifetime totals) on exit — exception-safe."""
    spec = arm(name, mode, **kw)
    try:
        yield spec
    finally:
        global _ARMED
        with _LOCK:
            if _POINTS.get(name) is spec:
                del _POINTS[name]
            _TOTALS[name] = _TOTALS.get(name, 0) + spec.fires
            _ARMED = bool(_POINTS)


# the serving stack's compiled-in failpoint names (importable constants so
# call sites and tests cannot drift apart on a typo)
SERVE_DISPATCH = "serve.dispatch"
PLAN_SOLVE = "plan.solve"
CHECKPOINT_WRITE = "checkpoint.write"
SESSION_RESTORE = "session.restore"


@contextlib.contextmanager
def chaos(seed: int = 0, *,
          dispatch_crash_p: float = 0.0,
          dispatch_hang_p: float = 0.0,
          hang_s: float = 0.2,
          solve_transient_p: float = 0.0) -> Iterator[None]:
    """Arm the serving fault mix in one scope (the ``--chaos`` flag and
    the chaos bench).  Crash and hang cannot share the one
    ``serve.dispatch`` slot — crash wins when both are requested; the
    bench arms them in separate phases instead.
    """
    stack = contextlib.ExitStack()
    with stack:
        if dispatch_crash_p > 0:
            stack.enter_context(inject(
                SERVE_DISPATCH, "raise", p=dispatch_crash_p, seed=seed))
        elif dispatch_hang_p > 0:
            stack.enter_context(inject(
                SERVE_DISPATCH, "delay", p=dispatch_hang_p,
                delay_s=hang_s, seed=seed))
        if solve_transient_p > 0:
            stack.enter_context(inject(
                PLAN_SOLVE, "raise", p=solve_transient_p, transient=True,
                seed=seed))
        yield


__all__ = [
    "CHECKPOINT_WRITE", "FaultInjected", "FaultSpec", "PLAN_SOLVE",
    "SERVE_DISPATCH", "SESSION_RESTORE", "TransientFault", "arm", "armed",
    "chaos", "corrupt", "disarm", "disarm_all", "fault_stats", "fire",
    "fire_count", "inject", "reset_stats",
]
