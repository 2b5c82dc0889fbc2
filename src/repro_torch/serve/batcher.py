"""Continuous batching: coalesce same-group requests within a deadline
window, dispatch them as one batch — under a supervisor that keeps the
dispatch worker alive.

Counterpart of ``repro.serve.batcher``, and the same code: it touches no
array, so only its imports differ.

Plain threads + ``queue.Queue`` — no asyncio runtime dependency, so the
batcher embeds in any host (a test, the CLI, a larger service) without an
event loop.  One worker thread owns all dispatch; per-group pending lists
flush when they reach ``max_batch`` or when their oldest request has aged
past the ``window_ms`` deadline, whichever comes first.  The intake queue
is *bounded*: past ``max_queue`` undispatched requests, ``submit`` raises
:class:`QueueFull` — the server rejects rather than OOMs under overload
(the caller retries with backoff; silently buffering unbounded operands is
how a solve server dies).

Per-request lifecycle is a :class:`Ticket`: the client blocks on
``result(timeout=...)``, may ``cancel()`` at any point (a cancelled ticket
is dropped at flush time, before any solver work), may carry a deadline
(enforced by the dispatch function at admission time, so an expired
request never burns a batch slot), and reads its measured ``latency_ms``
afterwards.  ``result(timeout, cancel_on_timeout=True)`` cancels on the
way out, so an abandoned request releases its ``max_queue`` slot instead
of pinning backpressure capacity until dispatch.

Supervision: the worker is restartable.  Its loop state (pending groups,
in-flight batch, a heartbeat timestamp set when a dispatch starts) lives
on the batcher instance, and every worker carries a *generation* number.
A watchdog thread restarts the worker when it dies (crash anywhere in the
dispatch path) or when a dispatch overruns ``hang_timeout_s``; only the
in-flight batch is failed
(:class:`~repro_torch.serve.resilience.WorkerCrashed` — retryable),
queued tickets survive to be served by the next generation.
A superseded worker that wakes from a hang discovers its generation is
stale and exits without touching successor state.  The ``serve.dispatch``
failpoint (``repro_torch.runtime.faults``) fires *outside* the dispatch
try/except precisely so raise-mode faults kill the worker (exercising
supervisor restart) and delay-mode faults hang it (exercising the
watchdog) instead of being absorbed as batch errors.

Shutdown is race-free: ``stop()`` drains everything already queued, then
any ``submit`` that raced the drain finds ``_stopping`` set after its
enqueue and claims its own straggler back — every ticket terminates, none
can land in the intake queue after the drain and hang its client forever.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional

from repro_torch.runtime import faults
from repro_torch.serve.resilience import WorkerCrashed

_SENTINEL = object()


class QueueFull(RuntimeError):
    """Backpressure: the intake queue is at capacity; retry later."""


class Cancelled(RuntimeError):
    """The request was cancelled (by the client or at shutdown)."""


class Ticket:
    """One in-flight request: a result slot + completion event.

    Created by :meth:`ContinuousBatcher.submit`; resolved (or failed) by
    the dispatch function on the worker thread.

    State transitions (resolve / fail / cancel) are serialized by a
    per-ticket lock: exactly ONE transition wins, so ``cancel()`` returns
    True only when the cancel actually preempted a result — it can no
    longer race the worker's ``_resolve`` and claim a delivered result was
    cancelled.  The backpressure slot a ticket occupies in its batcher is
    released exactly once (at cancel time, flush time, or shutdown —
    whichever comes first).
    """

    __slots__ = ("group", "payload", "submitted_at", "dispatched_at",
                 "deadline_at", "latency_ms", "_done", "_result", "_error",
                 "_cancelled", "_lock", "_released", "_batcher")

    def __init__(self, group: Hashable, payload: Any,
                 batcher: Optional["ContinuousBatcher"] = None,
                 deadline_s: Optional[float] = None):
        self.group = group
        self.payload = payload
        self.submitted_at = time.perf_counter()
        self.deadline_at: Optional[float] = (
            None if deadline_s is None else self.submitted_at
            + float(deadline_s))
        self.dispatched_at: Optional[float] = None
        self.latency_ms: Optional[float] = None
        self._done = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._lock = threading.Lock()
        self._released = False
        self._batcher = batcher

    # --- client side ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def expired(self) -> bool:
        """Past its deadline (always False for deadline-less tickets)."""
        return (self.deadline_at is not None
                and time.perf_counter() > self.deadline_at)

    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline (negative if past); None if no
        deadline."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.perf_counter()

    def cancel(self) -> bool:
        """Cancel if not already completed; True when the cancel won.

        A cancelled ticket never reaches the solver (the worker drops it
        at flush time) and immediately stops occupying the batcher's
        backpressure budget; any thread blocked in :meth:`result` gets
        :class:`Cancelled`.
        """
        with self._lock:
            if self._done.is_set():
                return False
            self._cancelled = True
            self.latency_ms = (time.perf_counter()
                               - self.submitted_at) * 1e3
            self._error = Cancelled("request cancelled")
            self._done.set()
        self._release_slot()
        return True

    def result(self, timeout: Optional[float] = None, *,
               cancel_on_timeout: bool = False) -> Any:
        """Block until resolved; raises the dispatch error, ``Cancelled``,
        or ``TimeoutError`` after ``timeout`` seconds.

        With ``cancel_on_timeout=True`` an expiring wait also cancels the
        ticket, releasing its ``max_queue`` slot — the contract for
        callers that abandon the request on timeout (otherwise the
        abandoned ticket pins backpressure capacity until the worker gets
        around to flushing its group).  If the cancel loses the race to a
        concurrent resolve, the result is returned normally.
        """
        if not self._done.wait(timeout):
            if not cancel_on_timeout or self.cancel():
                raise TimeoutError(
                    f"request not served within {timeout}s (group="
                    f"{self.group!r})"
                    + ("; cancelled, slot released"
                       if cancel_on_timeout else "; cancel() to drop it"))
            # cancel lost the race: a result (or error) landed while we
            # were timing out — deliver it.
        if self._error is not None:
            raise self._error
        return self._result

    # --- worker side ---------------------------------------------------
    def _resolve(self, result: Any) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self.latency_ms = (time.perf_counter()
                               - self.submitted_at) * 1e3
            self._result = result
            self._done.set()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self.latency_ms = (time.perf_counter()
                               - self.submitted_at) * 1e3
            self._error = exc
            self._done.set()

    def _release_slot(self) -> None:
        """Give the batcher's backpressure slot back, exactly once.

        Callable from the client (cancel), the worker (flush) and the
        shutdown drain; the per-ticket lock arbitrates, so concurrent
        callers can never double-decrement ``_pending_n``.  Lock order is
        always ticket → batcher (never the reverse), so no deadlock.
        """
        with self._lock:
            if self._released:
                return
            self._released = True
        b = self._batcher
        if b is not None:
            with b._lock:
                b._pending_n -= 1


DispatchFn = Callable[[Hashable, List[Ticket]], None]


class ContinuousBatcher:
    """Deadline-window request coalescer with a supervised dispatch
    worker thread.

    ``dispatch(group, tickets)`` receives only live (non-cancelled)
    tickets and must resolve every one (``Ticket._resolve``/``_fail``);
    an exception escaping dispatch fails the whole batch, and any ticket
    a dispatch forgets is failed defensively — a client can never hang on
    a flushed batch.  A crash *outside* that try (the ``serve.dispatch``
    failpoint, or a bug in the flush machinery itself) kills the worker;
    the watchdog restarts it, failing only the in-flight batch.

    Parameters
    ----------
    dispatch       the batch executor (runs on the worker thread).
    max_batch      flush a group at this many pending requests.
    window_ms      flush a group when its oldest request is this old.
    max_queue      bound on undispatched requests across all groups;
                   beyond it ``submit`` raises :class:`QueueFull`.
    hang_timeout_s declare a single dispatch hung after this long and
                   restart the worker (None disables hang detection;
                   crash detection still runs).
    supervise      run the watchdog thread (disable only in tests that
                   need a deliberately dead batcher).
    watchdog_interval_s  how often the watchdog polls liveness.
    """

    def __init__(self, dispatch: DispatchFn, *, max_batch: int = 8,
                 window_ms: float = 4.0, max_queue: int = 256,
                 name: str = "solve-batcher",
                 hang_timeout_s: Optional[float] = 30.0,
                 supervise: bool = True,
                 watchdog_interval_s: float = 0.05):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._dispatch = dispatch
        self.max_batch = int(max_batch)
        self.window = float(window_ms) / 1e3
        self.max_queue = int(max_queue)
        self.hang_timeout = (None if hang_timeout_s is None
                             else float(hang_timeout_s))
        self._name = name
        self._intake: "queue.Queue" = queue.Queue()
        self._pending_n = 0
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._stopped = threading.Event()
        # worker-generation state (all guarded by _lock) -----------------
        self._gen = 0
        self._restarts = 0
        self._crashes = 0
        self._inflight: Optional[List[Ticket]] = None
        self._dispatch_started: Optional[float] = None
        # loop state lives on the instance so a restarted worker resumes
        # exactly where its predecessor died — queued groups survive.
        self._pending_map: "collections.OrderedDict[Hashable, List[Ticket]]" \
            = collections.OrderedDict()
        self._oldest: Dict[Hashable, float] = {}
        self._thread = threading.Thread(target=self._run, args=(0,),
                                        name=name, daemon=True)
        self._thread.start()
        self._watchdog: Optional[threading.Thread] = None
        if supervise:
            self._watch_interval = float(watchdog_interval_s)
            self._watchdog = threading.Thread(
                target=self._watch, name=f"{name}-watchdog", daemon=True)
            self._watchdog.start()

    # --- client side ---------------------------------------------------
    def submit(self, group: Hashable, payload: Any, *,
               deadline_s: Optional[float] = None) -> Ticket:
        with self._lock:
            if self._stopping.is_set():
                raise RuntimeError("batcher is stopped")
            if self._pending_n >= self.max_queue:
                raise QueueFull(
                    f"{self._pending_n} requests already queued "
                    f"(max_queue={self.max_queue}); retry with backoff")
            self._pending_n += 1
        ticket = Ticket(group, payload, batcher=self, deadline_s=deadline_s)
        self._intake.put(ticket)
        if self._stopping.is_set():
            # stop() raced our enqueue and the worker's final drain may
            # already have passed without seeing this ticket.  Wait for
            # the drain to finish, then claim any stragglers ourselves:
            # the ticket terminates either way — served if the worker got
            # to it, failed with RuntimeError here if not — and can never
            # sit in the intake queue forever.
            self._stopped.wait(30.0)
            self._fail_stragglers()
        return ticket

    @property
    def pending(self) -> int:
        with self._lock:
            return self._pending_n

    @property
    def restarts(self) -> int:
        """Worker restarts performed by the watchdog (crash or hang)."""
        with self._lock:
            return self._restarts

    @property
    def crashes(self) -> int:
        """Worker deaths observed (crashes noted by the dying worker)."""
        with self._lock:
            return self._crashes

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Drain: flush everything already queued, then stop the worker."""
        self._stopping.set()
        self._intake.put(_SENTINEL)
        self._stopped.wait(timeout)

    # --- worker side ---------------------------------------------------
    def _current(self, gen: int) -> bool:
        with self._lock:
            return self._gen == gen

    def _run(self, gen: int) -> None:
        try:
            self._loop(gen)
        except BaseException as exc:   # noqa: BLE001 — the supervisor owns recovery
            self._note_crash(gen, exc)
            return
        if self._current(gen):
            self._drain_and_stop()

    def _loop(self, gen: int) -> None:
        while True:
            if not self._current(gen):
                return
            timeout: Optional[float] = None
            if self._pending_map:
                now = time.perf_counter()
                nearest = min(self._oldest.values())
                timeout = max(0.0, nearest + self.window - now)
            if self._stopping.is_set():
                # stay responsive during the drain even if our wake-up
                # sentinel was consumed by a dead predecessor
                timeout = 0.05 if timeout is None else min(timeout, 0.05)
            try:
                item = self._intake.get(timeout=timeout)
            except queue.Empty:
                item = None
            if item is not None and not self._current(gen):
                # superseded mid-get: hand the item to our successor
                self._intake.put(item)
                return
            if item is not None and item is not _SENTINEL:
                grp = self._pending_map.setdefault(item.group, [])
                grp.append(item)
                # window measured from when the group started pending,
                # NOT from submit time: requests that queued up behind
                # a long dispatch still get a chance to coalesce.
                self._oldest.setdefault(item.group, time.perf_counter())
                if len(grp) >= self.max_batch:
                    self._flush(item.group, gen)
            # deadline-expired groups (and everything, at shutdown)
            now = time.perf_counter()
            for g in [g for g, t0 in list(self._oldest.items())
                      if self._stopping.is_set()
                      or now - t0 >= self.window]:
                self._flush(g, gen)
            if not self._current(gen):
                return
            if (self._stopping.is_set() and not self._pending_map
                    and self._intake.empty()):
                return

    def _flush(self, group: Hashable, gen: int) -> None:
        batch = self._pending_map.pop(group, [])
        self._oldest.pop(group, None)
        if not batch:
            return
        # cancelled tickets released their slot at cancel time; the rest
        # release here — _release_slot is exactly-once per ticket.
        for t in batch:
            t._release_slot()
        live = [t for t in batch if not t.cancelled]
        if not live:
            return
        now = time.perf_counter()
        for t in live:
            t.dispatched_at = now
        with self._lock:
            self._inflight = list(live)
            self._dispatch_started = now
        # OUTSIDE the try: a raise-mode fault here kills the worker (the
        # watchdog restarts it and fails only this in-flight batch); a
        # delay-mode fault hangs it (the watchdog detects the stale
        # heartbeat).  Inside the try it would be just another dispatch
        # error — and prove nothing about recovery.
        faults.fire(faults.SERVE_DISPATCH)
        if not self._current(gen):
            # the watchdog declared us hung during the fault delay and
            # already failed this batch + started our successor: don't
            # burn solver time on tickets that have been answered.
            return
        try:
            self._dispatch(group, live)
        except BaseException as exc:   # noqa: BLE001 — fail the batch, keep serving
            for t in live:
                t._fail(exc)
        finally:
            with self._lock:
                if self._gen == gen:
                    self._inflight = None
                    self._dispatch_started = None
        for t in live:                 # dispatch forgot one: fail defensively
            if not t.done:
                t._fail(RuntimeError(
                    f"dispatch left ticket unresolved (group={group!r})"))

    def _note_crash(self, gen: int, exc: BaseException) -> None:
        """Dying worker's own crash bookkeeping: fail the in-flight batch
        so clients unblock immediately instead of at the next watchdog
        poll.  The watchdog still performs the restart."""
        with self._lock:
            if self._gen != gen:
                return
            self._crashes += 1
            inflight, self._inflight = self._inflight, None
            self._dispatch_started = None
        err = WorkerCrashed(
            f"dispatch worker crashed with {exc!r}; in-flight batch "
            "failed, worker restarting — safe to retry")
        for t in inflight or []:
            t._fail(err)

    def _drain_and_stop(self) -> None:
        """Clean shutdown (current generation only): fail anything still
        live so no client hangs forever, then mark stopped."""
        for batch in self._pending_map.values():
            for t in batch:
                t._fail(Cancelled("batcher stopped"))
                t._release_slot()
        self._pending_map.clear()
        self._oldest.clear()
        self._fail_stragglers()
        self._stopped.set()

    def _fail_stragglers(self) -> None:
        """Fail every ticket still sitting in intake.  Called by the
        stopping worker after its drain AND by any submitter whose enqueue
        raced stop() — ``Queue.get_nowait`` is atomic, so concurrent
        drainers each claim a disjoint set and every ticket is failed
        exactly once."""
        while True:
            try:
                item = self._intake.get_nowait()
            except queue.Empty:
                return
            if item is _SENTINEL:
                continue
            item._fail(RuntimeError(
                "ticket submitted while the batcher was stopping; the "
                "drain had already passed — resubmit to a live batcher"))
            item._release_slot()

    # --- supervisor -----------------------------------------------------
    def _watch(self) -> None:
        while not self._stopped.wait(self._watch_interval):
            with self._lock:
                thread = self._thread
                started = self._dispatch_started
            hung = (self.hang_timeout is not None and started is not None
                    and time.perf_counter() - started > self.hang_timeout)
            if self._stopped.is_set():
                return
            if not thread.is_alive():
                self._restart("dispatch worker died")
            elif hung:
                self._restart(
                    f"dispatch exceeded hang_timeout_s="
                    f"{self.hang_timeout:g}s")

    def _restart(self, reason: str) -> None:
        """Fail only the in-flight batch, bump the generation (stranding
        any zombie worker), and start a successor that resumes the queued
        work."""
        with self._lock:
            if self._stopped.is_set():
                return
            self._gen += 1
            gen = self._gen
            self._restarts += 1
            inflight, self._inflight = self._inflight, None
            self._dispatch_started = None
            successor = threading.Thread(
                target=self._run, args=(gen,),
                name=f"{self._name}-gen{gen}", daemon=True)
            self._thread = successor
        if inflight:
            err = WorkerCrashed(
                f"{reason}; in-flight batch failed, worker restarted — "
                "safe to retry")
            for t in inflight:
                t._fail(err)
        successor.start()
        if self._stopping.is_set():
            # the shutdown sentinel may have died with the predecessor;
            # re-arm it so the successor finishes the drain.
            self._intake.put(_SENTINEL)


__all__ = ["Cancelled", "ContinuousBatcher", "QueueFull", "Ticket"]
