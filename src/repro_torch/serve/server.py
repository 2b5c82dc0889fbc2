"""The solve server: intake -> bucket -> continuous batch -> plan cache.

Counterpart of ``repro.serve.server``.  One :class:`SolveServer` owns a
solve configuration (an ``SVDSpec``) and a device, and serves these
request kinds through a single dispatch worker:

* anonymous ``factorize`` — bucketed, coalesced by the continuous batcher
  and dispatched through ``SolverPlan.solve_batched`` (one runner per
  (group, padded-batch-size) signature, shared process-wide via the plan
  LRU; with ``backend="pallas"`` an fsvd batch is one stacked kernel call
  a stage).  Batch sizes are padded up to powers of two by repeating the
  last request, so the signatures per group are ``O(log max_batch)``.
* ``estimate`` — Algorithm-3 rank estimates with the in-graph loop
  (``host_loop=False``).
* tenant ``factorize`` — routed to the tenant's
  :class:`~repro_torch.api.session.Session`; repeat requests run the
  tracked refine path (strictly fewer GK iterations than cold).
* tenant ``delta`` — a *structured drift* against the tenant's tracked
  state (a ``LowRankOp`` or raw ``(U, s, Vt)`` factors), routed through
  ``Session.delta``: the zero-iteration rank-k update when it passes the
  parity gate, refine/restart otherwise.
* tenant ``entries`` — an unstructured drift as COO triplets, folded into
  the tenant session's resident sketch (``Session.entries``).

Accuracy contract: in ``mode="exact"`` (default) every solver input is
the caller's logical operand, bit-for-bit — padding is transport-only.
``mode="shared"`` solves at bucket shape, with a roundoff-level σ
perturbation (see ``serve.bucket``).  Rank estimates always run exact.

Resilience (see ``serve.resilience`` for the failure taxonomy) is the
reference's: NaN/Inf quarantine at submit, deadline admission at
dispatch, bounded retry of transient faults, a per-group circuit breaker,
probe-gated degraded answers (default ``gnystrom``) and a supervised,
restartable dispatch worker (``serve.batcher``).  The stats endpoint
(:meth:`SolveServer.stats`) and :meth:`SolveServer.health` carry the
reference's keys.

What differs from the reference, and why:

* **Device.**  ``device=None`` means the CUDA card
  (``_device.resolve_device``); ``"cpu"`` when asked.  Tenant sessions and
  stacked batches live there.  Transport stays numpy on the host, and a
  batch crosses to the device once: one ``np.stack`` and one copy in, one
  device → host copy of each result field for the whole batch out, then
  each ticket gets a view of it.  Every answer holds CPU tensors.
* **Draws.**  Where the reference folds a request's sequence number into
  its key, each request here gets its own generator, ``fold_in(seed,
  seq)`` on the server's device, made on the dispatch thread; the seed is
  the ``generator=`` argument's ``initial_seed()`` (0 without one).  The
  two packages draw different numbers.
* **Backend of a batch.**  The reference wraps a stacked batch in a
  default (``"xla"``) ``DenseOp`` whatever the spec says; here the stack
  takes the spec's backend, so ``SVDSpec(backend="pallas")`` runs the
  stacked GK-step kernels on anonymous batches.
* **The degraded answer's probe** runs on the host copy of the logical
  operand: the reference's numpy path and bits
  (``serve.resilience.residual_probe``).
* **Warmup** also loads the CUDA library of every kernel the dispatch
  path can reach (``backend="pallas"`` on the card), so no dispatch waits
  on a first-use ``nvcc`` build under the hang watchdog.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device, to_tensor, torch_dtype
from repro_torch.api.plan import (SolverPlan, plan as _make_plan,
                                  plan_cache_stats)
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import fold_in
from repro_torch.core.operators import LowRankOp
from repro_torch.runtime.faults import TransientFault
from repro_torch.runtime.telemetry import LatencyStats
from repro_torch.serve.batcher import ContinuousBatcher, QueueFull, Ticket
from repro_torch.serve.bucket import (DEFAULT_QUANTUM, Bucketed, embed,
                                      stack, unpad_factors)
from repro_torch.serve.resilience import (CircuitBreaker, CircuitOpen,
                                          DeadlineExceeded, DegradedRejected,
                                          finite_or_raise, residual_probe,
                                          retry_with_backoff)
from repro_torch.serve.tenant import TenantRegistry

_KINDS = ("factorize", "estimate", "delta", "entries")
_MODES = ("exact", "shared")


@dataclasses.dataclass
class ServeResult:
    """What a resolved ticket carries.

    ``value`` is a ``Factorization`` (factorize/tenant) or a
    ``RankEstimate`` (estimate), on the host; ``info`` the per-request
    ``ConvergenceInfo`` when the path captures one; ``batch`` the size of
    the coalesced batch this request rode in; ``meta`` path-specific
    extras (tenant solves report the Session's kind + iteration count).
    """

    kind: str
    value: Any
    batch: int = 1
    info: Any = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _pow2_pad(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _tensor_fields(obj) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def _to_host(obj):
    """A result dataclass with every tensor field copied to the host (one
    device → host copy a field; none for CPU tensors)."""
    return dataclasses.replace(obj, **{k: v.cpu() for k, v in
                                       _tensor_fields(obj).items()})


def _example(obj, i: int):
    """Example ``i`` of a batched result dataclass (views)."""
    return dataclasses.replace(obj, **{k: v[i] for k, v in
                                       _tensor_fields(obj).items()})


class SolveServer:
    """Multi-tenant factorization service over one ``SVDSpec``.

    Parameters as in ``repro.serve.server.SolveServer``, with ``generator``
    (its ``initial_seed()`` seeds every per-request and per-tenant
    generator) in place of ``key``, and ``device`` (default: the CUDA
    card) for the tenant sessions and the stacked batches.
    """

    def __init__(self, spec: Optional[SVDSpec] = None, *,
                 quantum: int = DEFAULT_QUANTUM,
                 mode: str = "exact",
                 max_batch: int = 8,
                 window_ms: float = 4.0,
                 max_queue: int = 256,
                 max_tenants: int = 32,
                 checkpoint_dir: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 deadline_ms: Optional[float] = None,
                 hang_timeout_s: Optional[float] = 30.0,
                 max_retries: int = 2,
                 retry_backoff_ms: float = 10.0,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 degraded: bool = True,
                 degraded_method: str = "gnystrom",
                 degraded_tol: float = 0.35,
                 degrade_under_ms: Optional[float] = None,
                 **overrides):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        spec = spec or SVDSpec()
        if overrides:
            spec = spec.replace(**overrides)
        self.spec = spec
        self.device = resolve_device(device)
        self.quantum = int(quantum)
        self.mode = mode
        self.plan: SolverPlan = _make_plan(spec)
        # estimates run the in-graph loop: a server must not stall its
        # dispatch thread on per-iteration host round-trips.
        self._est_plan: SolverPlan = _make_plan(spec.replace(host_loop=False))
        self.deadline_ms = deadline_ms
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_ms) / 1e3
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.degraded_tol = float(degraded_tol)
        self.degrade_under_s = (None if degrade_under_ms is None
                                else float(degrade_under_ms) / 1e3)
        self._breakers: Dict[Hashable, CircuitBreaker] = {}
        # the degraded plan: same rank contract, a cheap in-graph solver
        # (default single-pass generalized Nyström — one operator sweep).
        self.degraded_method = str(degraded_method)
        self._deg_plan: Optional[SolverPlan] = None
        if degraded:
            self._deg_plan = _make_plan(spec.replace(
                method=self.degraded_method, host_loop=False,
                oversample=min(spec.oversample, 4), power_iters=0))
        self.tenants = TenantRegistry(
            spec, max_tenants=max_tenants, checkpoint_dir=checkpoint_dir,
            generator=generator, device=self.device)
        self._seed = 0 if generator is None else generator.initial_seed()
        self._seq = 0
        self._lock = threading.Lock()
        self._counters = {"submitted": 0, "completed": 0, "rejected": 0,
                          "cancelled": 0, "timeouts": 0, "errors": 0,
                          "batches": 0, "tenant_requests": 0,
                          "bucket_hits": 0, "bucket_misses": 0,
                          "quarantined": 0, "deadline_drops": 0,
                          "retries": 0, "degraded": 0,
                          "degraded_rejected": 0, "breaker_open_shed": 0}
        self._batch_hist: Dict[int, int] = {}
        self._seen_signatures: set = set()
        self.latency = LatencyStats()
        self._t0 = time.perf_counter()
        self._closed = False
        self.batcher = ContinuousBatcher(
            self._dispatch, max_batch=max_batch, window_ms=window_ms,
            max_queue=max_queue, hang_timeout_s=hang_timeout_s)

    # --- intake ---------------------------------------------------------
    def _next_seq(self) -> int:
        """Per-request *sequence number* — the generator itself is made
        at dispatch, on the worker thread that uses it."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        return seq

    def request_generator(self, seq: int) -> torch.Generator:
        """The generator of the request with sequence number ``seq``
        (``ticket.payload["seq"]``): a fresh one on every call, so that a
        retry, or a direct call that checks a served answer, draws the
        same numbers."""
        return fold_in(self._seed, seq, device=self.device)

    def _group(self, kind: str, tenant: Optional[str],
               b: Bucketed) -> Hashable:
        if tenant is not None:
            return ("tenant", str(tenant))
        dtype = str(b.data.dtype)
        if kind == "estimate":
            return ("estimate", b.logical_shape, dtype)
        if self.mode == "shared":
            return ("solve", b.bucket, dtype)
        return ("solve", b.logical_shape, dtype)

    def submit(self, A, *, kind: str = "factorize",
               tenant: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> Ticket:
        """Enqueue one request; returns its :class:`Ticket` immediately.

        Raises :class:`QueueFull` under backpressure — the request was
        NOT accepted; retry with backoff.  Raises
        :class:`~repro_torch.serve.resilience.PoisonedOperand` for NaN/Inf
        operands (quarantined before they can contaminate a batch).
        ``deadline_ms`` overrides the server default; expired requests
        are dropped at dispatch admission with
        :class:`~repro_torch.serve.resilience.DeadlineExceeded`.
        """
        if self._closed:
            raise RuntimeError("server is closed")
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        if kind == "estimate" and tenant is not None:
            raise ValueError("estimate requests are stateless; "
                             "tenant routing applies to factorize only")
        try:
            finite_or_raise(A, what=f"{kind} operand")
        except Exception:
            with self._lock:
                self._counters["quarantined"] += 1
            raise
        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        deadline_s = None if deadline_ms is None else float(deadline_ms) / 1e3
        if kind == "delta":
            # structured drift against a tenant's tracked state: ``A`` is
            # the drift itself, not an operand, so it bypasses bucketing.
            # The group stays ("tenant", id): deltas serialize FIFO with
            # the tenant's factorize requests on the dispatch worker.
            if tenant is None:
                raise ValueError("delta requests require tenant= routing; "
                                 "there is no anonymous tracked state to "
                                 "update")
            payload = {"delta": A, "kind": kind, "tenant": tenant,
                       "seq": self._next_seq()}
            group: Hashable = ("tenant", str(tenant))
        elif kind == "entries":
            # unstructured drift as raw COO triplets (rows, cols, vals):
            # no operand transport, no bucketing — the triplets fold into
            # the tenant session's resident sketch.  Same FIFO group.
            if tenant is None:
                raise ValueError("entries requests require tenant= "
                                 "routing; there is no anonymous tracked "
                                 "state to fold into")
            try:
                rows, cols, vals = A
            except (TypeError, ValueError):
                raise ValueError("entries requests ship a (rows, cols, "
                                 "vals) COO triplet") from None
            payload = {"entries": (rows, cols, vals), "kind": kind,
                       "tenant": tenant, "seq": self._next_seq()}
            group = ("tenant", str(tenant))
        else:
            b = embed(A, self.quantum)
            payload = {"bucketed": b, "kind": kind, "tenant": tenant,
                       "seq": self._next_seq()}
            group = self._group(kind, tenant, b)
        try:
            ticket = self.batcher.submit(group, payload,
                                         deadline_s=deadline_s)
        except QueueFull:
            with self._lock:
                self._counters["rejected"] += 1
            raise
        with self._lock:
            self._counters["submitted"] += 1
            if tenant is not None:
                self._counters["tenant_requests"] += 1
        return ticket

    def solve(self, A, *, kind: str = "factorize",
              tenant: Optional[str] = None,
              timeout: Optional[float] = 30.0,
              deadline_ms: Optional[float] = None) -> ServeResult:
        """Synchronous submit + wait.  On timeout the request is cancelled
        (it will never reach the solver) and ``TimeoutError`` re-raises."""
        ticket = self.submit(A, kind=kind, tenant=tenant,
                             deadline_ms=deadline_ms)
        try:
            return ticket.result(timeout)
        except TimeoutError:
            self.cancel(ticket)
            with self._lock:
                self._counters["timeouts"] += 1
            raise

    def cancel(self, ticket: Ticket) -> bool:
        """Cancel a submitted ticket (counted in the stats)."""
        won = ticket.cancel()
        if won:
            with self._lock:
                self._counters["cancelled"] += 1
        return won

    # --- warmup ---------------------------------------------------------
    def warmup(self, shapes, *, dtype=np.float32,
               estimates: bool = False) -> int:
        """Stage every runner the dispatch path can reach for a menu of
        logical operand ``shapes`` — call at deploy time.

        Batch composition is timing-dependent: without warmup, which
        (group, batch-size) signatures are first seen is decided by how
        requests happen to coalesce.  Warming every power-of-two batch
        size up to ``max_batch`` per shape makes every later anonymous
        batch a bucket hit.  On the card with ``backend="pallas"`` this
        also loads every kernel library a dispatch can reach — the
        degraded plan's ``sketch_matmat`` and the tenants' update and
        entry-fold kernels included — in the caller's thread.  Returns
        the number of staged (group, batch) signatures.
        """
        if self.device.type == "cuda" and self.spec.backend == "pallas":
            from repro_torch.kernels import ops
            ops.load_dense_libraries()
        shapes = [tuple(s) for s in shapes]
        zeros = functools.partial(torch.zeros, dtype=torch_dtype(dtype),
                                  device=self.device)
        staged = 0
        for shape in dict.fromkeys(shapes):
            b = embed(np.zeros(shape, dtype), self.quantum)
            group = self._group("factorize", None, b)
            solve_shape = b.bucket if self.mode == "shared" else shape
            if not self.plan.staged:
                fact = self.plan.solve(zeros(solve_shape),
                                       generator=self.request_generator(0))
                fact.s.cpu()
                with self._lock:
                    self._seen_signatures.add((group, 1))
                staged += 1
            else:
                batch = 1
                while batch <= self.batcher.max_batch:
                    fact = self.plan.solve_batched(
                        zeros((batch,) + solve_shape),
                        generators=[self.request_generator(0)
                                    for _ in range(batch)])
                    fact.s.cpu()
                    with self._lock:
                        self._seen_signatures.add((group, batch))
                    staged += 1
                    batch *= 2
            if estimates:
                res = self._est_plan.estimate(
                    zeros(shape), generator=self.request_generator(0))
                res.rank.cpu()
                with self._lock:
                    self._seen_signatures.add(
                        (("estimate", shape, str(np.dtype(dtype))), 1))
                staged += 1
        # warmup is deploy time, not serving time: restart the stats clock
        # so requests_per_sec reflects traffic actually served.
        self._t0 = time.perf_counter()
        return staged

    # --- dispatch (runs on the batcher worker thread) -------------------
    def _admit(self, tickets: List[Ticket]) -> List[Ticket]:
        """Deadline admission: fail already-expired tickets NOW, before
        they burn a batch slot or solver time, and return the survivors."""
        live, dropped = [], 0
        for t in tickets:
            if t.expired:
                t._fail(DeadlineExceeded(
                    f"deadline passed before dispatch (queued "
                    f"{(time.perf_counter() - t.submitted_at) * 1e3:.1f}"
                    "ms); dropped at admission"))
                dropped += 1
            else:
                live.append(t)
        if dropped:
            with self._lock:
                self._counters["deadline_drops"] += dropped
        return live

    def _breaker(self, group: Hashable) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(group)
            if br is None:
                br = CircuitBreaker(self.breaker_threshold,
                                    self.breaker_reset_s)
                self._breakers[group] = br
            return br

    def _retrying(self, fn):
        """Run ``fn`` with bounded exponential backoff on
        :class:`~repro_torch.runtime.faults.TransientFault` only —
        permanent errors propagate immediately."""
        def _count(_attempt):
            with self._lock:
                self._counters["retries"] += 1
        return retry_with_backoff(
            fn, retries=self.max_retries, backoff_s=self.retry_backoff_s,
            retry_on=(TransientFault,), on_retry=_count)

    def _dispatch(self, group: Hashable, tickets: List[Ticket]) -> None:
        try:
            tickets = self._admit(tickets)
            if not tickets:
                return
            if group[0] == "tenant":
                self._dispatch_tenant(tickets)
            elif group[0] == "estimate":
                self._dispatch_estimate(group, tickets)
            else:
                self._dispatch_solve(group, tickets)
        except BaseException:
            with self._lock:
                self._counters["errors"] += 1
            raise
        finally:
            with self._lock:
                self._counters["batches"] += 1
                n = len(tickets)
                self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
                for t in tickets:
                    if t.done and t.latency_ms is not None \
                            and t._error is None:
                        self._counters["completed"] += 1
                        self.latency.record(t.latency_ms)

    def _note_signature(self, signature: Hashable, n: int) -> None:
        """Bucket-hit accounting: a request 'hits' when its runner
        signature (group x padded batch size) is already staged."""
        with self._lock:
            if signature in self._seen_signatures:
                self._counters["bucket_hits"] += n
            else:
                self._seen_signatures.add(signature)
                self._counters["bucket_misses"] += n

    def _dispatch_solve(self, group: Hashable, tickets: List[Ticket]
                        ) -> None:
        breaker = self._breaker(group)
        if not breaker.allow():
            # open breaker: shed to the degraded path (or fail fast) —
            # don't feed a failing runner more batches until the
            # half-open trial says it recovered.
            with self._lock:
                self._counters["breaker_open_shed"] += len(tickets)
            self._degraded_dispatch(
                group, tickets, reason="breaker_open",
                fallback_error=CircuitOpen(
                    f"circuit breaker open for group {group!r}; "
                    "load shed — retry after the reset window"))
            return
        pressured: List[Ticket] = []
        normal: List[Ticket] = []
        if self.degrade_under_s is not None and self._deg_plan is not None:
            for t in tickets:
                rem = t.remaining_s()
                (pressured if rem is not None
                 and rem < self.degrade_under_s else normal).append(t)
        else:
            normal = list(tickets)
        if pressured:
            # not enough deadline left for the full solve: a certified
            # cheap answer in time beats an accurate one too late.
            self._degraded_dispatch(group, pressured,
                                    reason="deadline_pressure")
        if not normal:
            return
        try:
            self._primary_solve(group, normal)
        except BaseException as exc:   # noqa: BLE001 — degrade, don't die
            breaker.record_failure()
            self._degraded_dispatch(group, normal, reason="primary_failed",
                                    fallback_error=exc)
            return
        breaker.record_success()

    def _operand(self, t: Ticket) -> torch.Tensor:
        """A ticket's logical operand on the server's device."""
        return to_tensor(t.payload["bucketed"].extract(), device=self.device)

    def _primary_solve(self, group: Hashable, tickets: List[Ticket]
                       ) -> None:
        n = len(tickets)
        if not self.plan.staged:
            # host-loop methods cannot batch: serve them one by one
            # through the same plan.
            self._note_signature((group, 1), n)
            for t in tickets:
                A, seq = self._operand(t), t.payload["seq"]
                fact, info = self._retrying(
                    lambda A=A, seq=seq: self.plan.solve(
                        A, generator=self.request_generator(seq),
                        with_info=True))
                t._resolve(ServeResult(kind="factorize",
                                       value=_to_host(fact), batch=1,
                                       info=_to_host(info)))
            return
        self._note_signature((group, _pow2_pad(n)), n)
        facts, infos = self._solve_batch(self.plan, tickets)
        for t, fi, ii in zip(tickets, facts, infos):
            t._resolve(ServeResult(kind="factorize", value=fi, batch=n,
                                   info=ii))

    def _solve_batch(self, plan: SolverPlan, tickets: List[Ticket]):
        """Pad, stack, solve once, unstack: per-ticket host-side
        ``(facts, infos)`` lists.  Transient dispatch faults retry with
        backoff inside this call, each attempt with fresh generators."""
        n = len(tickets)
        shared = self.mode == "shared"
        if shared:
            ops = [t.payload["bucketed"].data for t in tickets]
        else:
            ops = [t.payload["bucketed"].extract() for t in tickets]
        seqs = [t.payload["seq"] for t in tickets]
        pad_to_n = _pow2_pad(n)
        ops = ops + [ops[-1]] * (pad_to_n - n)
        seqs = seqs + [seqs[-1]] * (pad_to_n - n)
        # one host-side stack and one copy in for the whole batch
        stacked = stack(ops, self.device)
        fact, info = self._retrying(
            lambda: plan.solve_batched(
                stacked, generators=[self.request_generator(s)
                                     for s in seqs],
                with_info=True))
        # one device -> host copy a field for the whole batch, then
        # per-ticket views: per-request device slicing would launch a few
        # small copies per ticket and dominate the dispatch loop.
        fact, info = _to_host(fact), _to_host(info)
        facts, infos = [], []
        for i, t in enumerate(tickets):
            fi, ii = _example(fact, i), _example(info, i)
            if shared:
                fi = unpad_factors(fi, t.payload["bucketed"].logical_shape)
            facts.append(fi)
            infos.append(ii)
        return facts, infos

    def _degraded_dispatch(self, group: Hashable, tickets: List[Ticket],
                           *, reason: str,
                           fallback_error: Optional[BaseException] = None
                           ) -> None:
        """Answer with the cheap plan — but ONLY if the answer certifies.

        Every degraded factorization is gated by the HMT residual probe
        against the caller's logical operand (its host copy); an answer
        that fails the gate becomes :class:`DegradedRejected`, never a
        silent wrong result.  Passing answers carry
        ``meta["degraded"]=True`` + the probe value.
        """
        if self._deg_plan is None:
            err = fallback_error or CircuitOpen(
                f"group {group!r} unavailable and degraded mode disabled")
            for t in tickets:
                t._fail(err)
            return
        try:
            facts, infos = self._solve_batch(self._deg_plan, tickets)
        except BaseException as exc:   # noqa: BLE001 — terminate every ticket
            for t in tickets:
                t._fail(exc)
            return
        for t, fi, ii in zip(tickets, facts, infos):
            A = np.asarray(t.payload["bucketed"].extract())
            probe = residual_probe(A, fi, seed=t.payload["seq"])
            if probe <= self.degraded_tol:
                with self._lock:
                    self._counters["degraded"] += 1
                t._resolve(ServeResult(
                    kind="factorize", value=fi, batch=len(tickets), info=ii,
                    meta={"degraded": True, "reason": reason,
                          "method": self.degraded_method, "probe": probe}))
            else:
                with self._lock:
                    self._counters["degraded_rejected"] += 1
                t._fail(DegradedRejected(
                    f"degraded answer failed the residual probe "
                    f"({probe:.3g} > degraded_tol={self.degraded_tol:g}, "
                    f"reason={reason}); refusing to return an "
                    "uncertified result"))

    def _dispatch_estimate(self, group: Hashable, tickets: List[Ticket]
                           ) -> None:
        self._note_signature((group, 1), len(tickets))
        for t in tickets:
            res = self._est_plan.estimate(
                self._operand(t),
                generator=self.request_generator(t.payload["seq"]))
            t._resolve(ServeResult(kind="estimate", value=_to_host(res),
                                   batch=len(tickets)))

    def _as_lowrank(self, delta) -> LowRankOp:
        if isinstance(delta, LowRankOp):
            return delta
        U, s, Vt = delta
        return LowRankOp(to_tensor(U, device=self.device), s, Vt)

    def _dispatch_tenant(self, tickets: List[Ticket]) -> None:
        for t in tickets:
            tid, seq = t.payload["tenant"], t.payload["seq"]
            try:
                if t.payload["kind"] == "delta":
                    sess = self.tenants.touch(tid)
                    if sess is None or sess.fact is None:
                        t._fail(RuntimeError(
                            f"tenant {tid!r}: delta before any factorize "
                            "— there is no tracked state to update"))
                        continue
                    dop = self._as_lowrank(t.payload["delta"])
                    fact = self._retrying(
                        lambda s=sess, d=dop: s.delta(
                            d, generator=self.request_generator(seq)))
                elif t.payload["kind"] == "entries":
                    sess = self.tenants.touch(tid)
                    if sess is None or sess.fact is None:
                        t._fail(RuntimeError(
                            f"tenant {tid!r}: entries before any "
                            "factorize — there is no tracked state to "
                            "fold into"))
                        continue
                    rows, cols, vals = t.payload["entries"]
                    fact = self._retrying(
                        lambda s=sess, r=rows, c=cols, v=vals: s.entries(
                            r, c, v, generator=self.request_generator(seq)))
                else:
                    A = self._operand(t)
                    sess = self.tenants.get(tid, A)
                    fact = self._retrying(
                        lambda s=sess, A=A: s.update(
                            A, generator=self.request_generator(seq)))
            except Exception as exc:   # noqa: BLE001 — isolate per ticket:
                # one tenant request failing (retries exhausted, rotten
                # state, ...) must not fail the whole coalesced batch.
                t._fail(exc)
                continue
            rec = sess.history[-1]
            meta = {"kind": rec["kind"],
                    "iterations": rec["iterations"],
                    "step": rec["step"]}
            for k in ("probe", "gate", "staleness", "sketch_stale",
                      "sketch_rejected"):
                if k in rec:
                    meta[k] = rec[k]
            t._resolve(ServeResult(
                kind="tenant", value=_to_host(fact), batch=len(tickets),
                meta=meta))

    # --- stats / lifecycle ----------------------------------------------
    def health(self) -> dict:
        """Reliability counters: breaker states, worker restarts/crashes,
        quarantines, deadline drops, retries and the degraded-answer
        fraction.  A monitoring endpoint would scrape exactly this."""
        with self._lock:
            counters = dict(self._counters)
            breakers = {"|".join(map(str, g)): br.snapshot()
                        for g, br in self._breakers.items()}
        completed = counters["completed"]
        return {
            "worker_restarts": self.batcher.restarts,
            "worker_crashes": self.batcher.crashes,
            "quarantined": counters["quarantined"],
            "deadline_drops": counters["deadline_drops"],
            "retries": counters["retries"],
            "degraded": counters["degraded"],
            "degraded_rejected": counters["degraded_rejected"],
            "breaker_open_shed": counters["breaker_open_shed"],
            "degraded_fraction":
                counters["degraded"] / completed if completed else 0.0,
            "breakers": breakers,
        }

    def stats(self) -> dict:
        """JSON-able snapshot of the serving counters (the CLI's stats
        endpoint payload).  Health counters are merged at top level AND
        nested under ``"health"``."""
        now = time.perf_counter()
        health = self.health()
        with self._lock:
            counters = dict(self._counters)
            hist = {str(k): v for k, v in sorted(self._batch_hist.items())}
        elapsed = max(now - self._t0, 1e-9)
        lookups = counters["bucket_hits"] + counters["bucket_misses"]
        return {
            "uptime_s": elapsed,
            **counters,
            **{k: v for k, v in health.items() if k != "breakers"},
            "requests_per_sec": counters["completed"] / elapsed,
            "latency_ms": self.latency.summary(),
            "batch_histogram": hist,
            "bucket_hit_rate":
                counters["bucket_hits"] / lookups if lookups else 0.0,
            "mode": self.mode,
            "quantum": self.quantum,
            "tenants": self.tenants.stats(),
            "plan_cache": plan_cache_stats(),
            "health": health,
        }

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain the queue, stop the worker, checkpoint tenant sessions."""
        if self._closed:
            return
        self._closed = True
        self.batcher.stop(timeout)
        self.tenants.save_all()

    def __enter__(self) -> "SolveServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["ServeResult", "SolveServer"]
