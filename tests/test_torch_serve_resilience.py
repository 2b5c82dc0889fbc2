"""Fault-tolerant serving in the port: the server cases of
tests/test_resilience.py and the tenant registry's restore failpoint of
tests/test_checkpoint.py (``test_restore_failpoint_raises_and_tenant_
registry_survives``), on the port's server and failpoints, on the CPU.

Supervisor restart of crashed and hung dispatch workers, the stop() /
submit() shutdown race, cancel-on-timeout slot release, deadline
admission, NaN quarantine (and why it must happen before batching),
transient retry, circuit breaking and probe-gated degraded answers; plus
the chaos replay of benchmarks/chaos_bench.py at a small size against its
own gates (every request terminated, availability >= 0.99, quarantined ==
poisoned, every degraded answer within 0.05·σ_max), and tenant eviction
to a checkpoint and back.  The operands are the reference tests' own
(``make_lowrank`` through numpy).
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import make_lowrank
from repro.api import SVDSpec as RefSpec
from repro.api import session as ref_session
from repro_torch.api import SVDSpec, session
from repro_torch.launch.solve_serve import run_traffic
from repro_torch.runtime import faults
from repro_torch.serve import (ContinuousBatcher, DeadlineExceeded,
                               DegradedRejected, PoisonedOperand,
                               SolveServer, TenantRegistry, WorkerCrashed)
from repro_torch.serve.traffic import synthetic_stream

SERVE_SPEC = SVDSpec(method="fsvd", rank=4, max_iters=24)
SHAPE = (24, 16)
SIGMA_GATE = 0.05                 # benchmarks/chaos_bench.py:57


@pytest.fixture(autouse=True)
def _clean_failpoints():
    """Disarm every failpoint around each test, and clear the lifetime
    fire totals that ``faults.chaos`` leaves behind (process-wide: a later
    test file in the same worker counts fires from zero)."""
    faults.disarm_all()
    yield
    faults.disarm_all()
    faults.reset_stats()


def _operand(seed=0, m=SHAPE[0], n=SHAPE[1]):
    return np.array(make_lowrank(jax.random.PRNGKey(seed), m, n, 4),
                    copy=True)


def _server(**kw):
    return SolveServer(SERVE_SPEC, generator=torch.Generator().manual_seed(3),
                       device="cpu", **kw)


def _sigma_err(s, A):
    s_true = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    s = np.asarray(s, np.float64)
    return float(np.max(np.abs(s - s_true[:s.shape[-1]])) / s_true[0])


@pytest.fixture(scope="module")
def server():
    """One warmed module-scoped server: resilience counters are asserted
    as before/after deltas so tests stay order-independent."""
    srv = _server(window_ms=2.0, hang_timeout_s=30.0, max_retries=2,
                  retry_backoff_ms=1.0, breaker_threshold=2,
                  breaker_reset_s=0.3)
    srv.warmup([SHAPE])
    yield srv
    faults.disarm_all()
    srv.close()


# ---------------------------------------------------------------------------
# batcher supervisor (no solver involved)
# ---------------------------------------------------------------------------

def _echo_batcher(**kw):
    def dispatch(group, tickets):
        for t in tickets:
            t._resolve(t.payload)
    return ContinuousBatcher(dispatch, **kw)


def test_worker_crash_fails_inflight_only_and_restarts():
    release = threading.Event()

    def dispatch(group, tickets):
        release.wait(5.0)
        for t in tickets:
            t._resolve(t.payload)

    b = ContinuousBatcher(dispatch, max_batch=1, window_ms=1.0,
                          watchdog_interval_s=0.01)
    try:
        faults.arm(faults.SERVE_DISPATCH, mode="raise", p=1.0, max_fires=1)
        doomed = b.submit("g", "doomed")
        with pytest.raises(WorkerCrashed):
            doomed.result(timeout=5.0)
        release.set()
        survivor = b.submit("g", "survivor")
        assert survivor.result(timeout=5.0) == "survivor"
        deadline = time.perf_counter() + 5.0
        while b.restarts < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert b.restarts == 1 and b.crashes == 1
        assert b.pending == 0
    finally:
        faults.disarm_all()
        b.stop()


def test_hung_dispatch_is_detected_and_worker_restarted():
    b = _echo_batcher(max_batch=1, window_ms=1.0, hang_timeout_s=0.1,
                      watchdog_interval_s=0.01)
    try:
        faults.arm(faults.SERVE_DISPATCH, mode="delay", p=1.0,
                   delay_s=1.0, max_fires=1)
        hung = b.submit("g", "hung")
        with pytest.raises(WorkerCrashed, match="hang_timeout"):
            hung.result(timeout=5.0)
        assert b.submit("g", "after").result(timeout=5.0) == "after"
        assert b.restarts >= 1
    finally:
        faults.disarm_all()
        b.stop()


def test_stop_submit_race_every_ticket_terminates():
    """A ticket whose enqueue lands after the stopping worker's final
    drain terminates with a typed RuntimeError, and its slot is
    released."""
    b = _echo_batcher(max_batch=4, window_ms=1.0)
    in_put = threading.Event()
    real_put = b._intake.put

    def parked_put(item, *a, **kw):
        if getattr(item, "payload", None) == "straggler":
            in_put.set()
            b._stopped.wait(5.0)
        real_put(item, *a, **kw)

    b._intake.put = parked_put
    out = {}

    def racer():
        try:
            t = b.submit("g", "straggler")
            try:
                t.result(timeout=5.0)
                out["outcome"] = "resolved"
            except RuntimeError as e:
                out["outcome"] = ("failed", str(e))
        except RuntimeError as e:
            out["outcome"] = ("refused", str(e))

    thread = threading.Thread(target=racer)
    thread.start()
    assert in_put.wait(5.0)
    b.stop(timeout=5.0)
    thread.join(timeout=10.0)
    assert not thread.is_alive(), "straggler submit never terminated"
    assert out["outcome"][0] == "failed"
    assert "stopping" in out["outcome"][1]
    assert b.pending == 0


def test_cancel_on_timeout_releases_backpressure_slot():
    started, release = threading.Event(), threading.Event()

    def dispatch(group, tickets):
        started.set()
        release.wait(10.0)
        for t in tickets:
            t._resolve("ok")

    b = ContinuousBatcher(dispatch, max_batch=1, window_ms=1.0, max_queue=2)
    try:
        b.submit("g", "blocker")
        assert started.wait(5.0)
        abandoned = b.submit("g", "abandoned")
        with pytest.raises(TimeoutError, match="slot released"):
            abandoned.result(timeout=0.05, cancel_on_timeout=True)
        assert abandoned.cancelled
        replacement = b.submit("g", "replacement")
        release.set()
        assert replacement.result(timeout=5.0) == "ok"
    finally:
        release.set()
        b.stop()


def test_expired_property_and_deadline_storage():
    b = _echo_batcher(max_batch=8, window_ms=1.0)
    try:
        t = b.submit("g", 1, deadline_s=30.0)
        assert not t.expired and t.remaining_s() > 29.0
        t2 = b.submit("g", 2)
        assert t2.deadline_at is None and t2.remaining_s() is None
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# server: quarantine, deadlines, retry, breaker, degraded mode
# ---------------------------------------------------------------------------

def test_nan_operand_quarantined_at_submit(server):
    before = server.stats()["quarantined"]
    bad = _operand(1)
    bad[2, 3] = np.nan
    with pytest.raises(PoisonedOperand):
        server.submit(bad)
    assert server.stats()["quarantined"] == before + 1


def test_nan_would_poison_a_stacked_batch_clean_requests_stay_clean(server):
    """ONE NaN operand in a stacked solve ruins its batch: here the
    batched Ritz step's ``eigh`` fails for the whole stack (the reference
    returns garbage for the poisoned row instead).  The server keeps
    co-submitted clean requests finite because the poisoned one never
    enters a batch."""
    clean = [_operand(s) for s in (2, 3, 4)]
    bad = _operand(5)
    bad[0, 0] = np.nan
    stacked = torch.from_numpy(np.stack(clean + [bad]))
    try:
        fact = server.plan.solve_batched(
            stacked,
            generators=[server.request_generator(i) for i in range(4)])
    except torch.linalg.LinAlgError:
        pass                      # every co-batched answer is lost
    else:
        s3 = fact.s[3]
        assert (not bool(torch.isfinite(s3).all())) or not bool(s3.any())

    tickets = [server.submit(a) for a in clean]
    with pytest.raises(PoisonedOperand):
        server.submit(bad)
    for t in tickets:
        res = t.result(timeout=60.0)
        assert bool(torch.isfinite(res.value.s).all())


def test_deadline_enforced_at_dispatch_admission(server):
    before = server.stats()["deadline_drops"]
    t = server.submit(_operand(6), deadline_ms=0.001)
    with pytest.raises(DeadlineExceeded):
        t.result(timeout=30.0)
    assert server.stats()["deadline_drops"] == before + 1
    res = server.solve(_operand(7), deadline_ms=60000.0, timeout=60.0)
    assert bool(torch.isfinite(res.value.s).all())


def test_transient_fault_retried_with_backoff(server):
    before = server.stats()["retries"]
    faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, transient=True,
               max_fires=1)
    res = server.solve(_operand(8), timeout=60.0)
    faults.disarm_all()
    assert not res.meta.get("degraded")
    assert server.stats()["retries"] == before + 1


def test_primary_failure_degrades_with_probe_label(server):
    """A non-transient primary failure falls back to the cheap plan; the
    answer is labeled degraded, carries its probe value, and the probe
    certifies it against the operand."""
    before = server.stats()["degraded"]
    faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, max_fires=1)
    res = server.solve(_operand(9), timeout=120.0)
    faults.disarm_all()
    assert res.meta["degraded"] is True
    assert res.meta["reason"] == "primary_failed"
    assert res.meta["method"] == "gnystrom"
    assert res.meta["probe"] <= server.degraded_tol
    assert _sigma_err(res.value.s, _operand(9)) < SIGMA_GATE
    assert server.stats()["degraded"] == before + 1
    assert server.stats()["degraded_fraction"] > 0.0


def test_degraded_method_is_configurable_and_reported():
    srv = _server(window_ms=2.0, retry_backoff_ms=1.0,
                  degraded_method="rsvd")
    try:
        faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, max_fires=1)
        res = srv.solve(_operand(9), timeout=120.0)
        faults.disarm_all()
        assert res.meta["degraded"] is True
        assert res.meta["method"] == "rsvd"
        assert srv.degraded_method == "rsvd"
    finally:
        faults.disarm_all()
        srv.close()


def test_probe_gate_rejects_uncertifiable_degraded_answer(server):
    before = server.stats()["degraded_rejected"]
    old_tol = server.degraded_tol
    server.degraded_tol = -1.0
    try:
        faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, max_fires=1)
        with pytest.raises(DegradedRejected):
            server.solve(_operand(10), timeout=120.0)
    finally:
        faults.disarm_all()
        server.degraded_tol = old_tol
    assert server.stats()["degraded_rejected"] == before + 1


def test_breaker_opens_sheds_to_degraded_then_half_opens(server):
    shed_before = server.stats()["breaker_open_shed"]
    faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, max_fires=4)
    for _ in range(2):
        with pytest.raises(Exception):
            server.solve(_operand(11), timeout=60.0)
    faults.disarm_all()
    states = {k: v["state"]
              for k, v in server.stats()["health"]["breakers"].items()}
    assert "open" in states.values()
    res = server.solve(_operand(12), timeout=60.0)
    assert res.meta["degraded"] is True
    assert res.meta["reason"] == "breaker_open"
    assert server.stats()["breaker_open_shed"] > shed_before
    time.sleep(server.breaker_reset_s + 0.1)
    res2 = server.solve(_operand(13), timeout=60.0)
    assert not res2.meta.get("degraded")
    states = {k: v["state"]
              for k, v in server.stats()["health"]["breakers"].items()}
    assert "open" not in states.values()


def test_server_worker_death_recovery_end_to_end():
    srv = _server(window_ms=2.0, hang_timeout_s=30.0)
    try:
        srv.warmup([SHAPE])
        faults.arm(faults.SERVE_DISPATCH, mode="raise", p=1.0, max_fires=1)
        doomed = srv.submit(_operand(20))
        with pytest.raises(WorkerCrashed):
            doomed.result(timeout=30.0)
        queued = [srv.submit(_operand(21 + i)) for i in range(3)]
        for t in queued:
            res = t.result(timeout=60.0)
            assert bool(torch.isfinite(res.value.s).all())
        deadline = time.perf_counter() + 5.0
        while srv.stats()["worker_restarts"] < 1 \
                and time.perf_counter() < deadline:
            time.sleep(0.02)
        st = srv.stats()
        assert st["worker_restarts"] == 1
        assert st["worker_crashes"] == 1
    finally:
        faults.disarm_all()
        srv.close()


def test_health_block_shape(server):
    h = server.health()
    for k in ("worker_restarts", "worker_crashes", "quarantined",
              "deadline_drops", "retries", "degraded", "degraded_rejected",
              "breaker_open_shed", "degraded_fraction", "breakers"):
        assert k in h
    st = server.stats()
    assert st["health"]["quarantined"] == st["quarantined"]


@pytest.mark.parametrize("mix", [
    ("faulty", {"crash": 0.03, "hang": 0.01, "transient": 0.05}),
    ("storm", {"crash": 0.10, "hang": 0.03, "transient": 0.15}),
], ids=["faulty", "storm"])
def test_chaos_replay_meets_the_chaos_gates(mix):
    """benchmarks/chaos_bench.py's replay (its mixes, deadline, poison,
    hang timeout and hang_s) at a small size: every request terminates,
    availability >= 0.99, quarantined == poisoned and every degraded
    answer is within SIGMA_GATE of the exact σ."""
    label, p = mix
    reqs = list(synthetic_stream(40, shapes=((48, 32), (40, 24)), rank=4,
                                 tenants=2, tenant_fraction=0.25, seed=7))
    poisoned = 0
    for r in reqs:
        if poisoned < 2 and r.tenant is None and r.kind == "factorize":
            r.A = np.array(r.A, copy=True)
            r.A[0, 0] = np.nan
            poisoned += 1
    srv = SolveServer(SVDSpec(method="fsvd", rank=4), device="cpu",
                      generator=torch.Generator().manual_seed(4321),
                      max_batch=8, window_ms=2.0,
                      max_queue=4 * len(reqs) + 16, hang_timeout_s=1.0,
                      breaker_threshold=5, breaker_reset_s=1.0,
                      max_retries=2, retry_backoff_ms=5.0)
    degraded = []

    def collect(req, outcome, detail):
        if outcome == "ok" and req.tenant is None \
                and detail.meta.get("degraded"):
            degraded.append(_sigma_err(detail.value.s, req.A))

    try:
        srv.warmup(((48, 32), (40, 24)))
        with faults.chaos(0, dispatch_crash_p=p["crash"],
                          dispatch_hang_p=p["hang"], hang_s=2.5,
                          solve_transient_p=p["transient"]):
            counts = run_traffic(srv, reqs, clients=4, timeout=15.0,
                                 deadline_ms=15000.0, on_result=collect)
    finally:
        faults.disarm_all()
        srv.close()
    quarantined = counts["errors"].get("PoisonedOperand", 0)
    outcomes = (counts["ok"] + counts["rejected"] + counts["failed"]
                + counts["timeouts"])
    eligible = max(len(reqs) - quarantined - counts["rejected"], 1)
    assert outcomes == len(reqs), label
    assert counts["ok"] / eligible >= 0.99, (label, counts)
    assert quarantined == poisoned == 2
    assert all(e <= SIGMA_GATE for e in degraded), degraded


# ---------------------------------------------------------------------------
# tenant registry: restore failpoint, eviction to a checkpoint and back
# ---------------------------------------------------------------------------

def test_restore_failpoint_raises_and_tenant_registry_survives(tmp_path):
    """The session.restore failpoint makes restore blow up; the registry
    absorbs that into a fresh (cold) session and counts it.  The
    checkpoint is the reference's own."""
    key = jax.random.PRNGKey(13)
    k1, k2 = jax.random.split(key)
    A = np.array(jax.random.normal(k1, (20, 4))
                 @ jax.random.normal(k2, (4, 16)))
    ref_spec = RefSpec(method="fsvd", rank=3, max_iters=12)
    sess = ref_session(A, ref_spec, key=key)
    sess.solve()
    sess.save(str(tmp_path / "t0"), step=1)
    spec = SVDSpec(method="fsvd", rank=3, max_iters=12)
    reg = TenantRegistry(spec, checkpoint_dir=str(tmp_path),
                         generator=torch.Generator().manual_seed(13),
                         device="cpu")
    faults.arm(faults.SESSION_RESTORE, mode="raise", p=1.0)
    got = reg.get("t0", torch.from_numpy(A))
    faults.disarm_all()
    assert got.fact is None
    assert reg.stats()["restore_failures"] == 1
    assert reg.stats()["creates"] == 1
    # without the failpoint the reference's checkpoint restores
    reg2 = TenantRegistry(spec, checkpoint_dir=str(tmp_path), device="cpu")
    got2 = reg2.get("t0", torch.from_numpy(A))
    assert got2.fact is not None and reg2.stats()["restores"] == 1


def test_evicted_tenant_restores_and_keeps_refining(tmp_path):
    """Past max_tenants the coldest session is checkpointed and evicted;
    when it returns it restores its factorization and refines instead of
    paying a cold solve again."""
    rng = np.random.default_rng(1)
    ops = {t: _operand(30 + i, 48, 32) for i, t in enumerate("abc")}
    with _server(max_tenants=2, checkpoint_dir=str(tmp_path),
                 window_ms=1.0) as srv:
        kinds = [srv.solve(ops[t], tenant=t, timeout=60.0).meta["kind"]
                 for t in "abc"]
        assert srv.stats()["tenants"]["evictions"] == 1
        assert (tmp_path / "a").exists()
        A = ops["a"] + 1e-4 * rng.standard_normal(
            ops["a"].shape).astype(np.float32)
        back = srv.solve(A, tenant="a", timeout=60.0)
        stats = srv.stats()["tenants"]
    assert kinds == ["cold"] * 3
    assert back.meta["kind"] == "refine"
    assert stats["restores"] == 1 and stats["creates"] == 3


def test_tenant_generators_are_stable_across_registries():
    """The same seed and tenant id give the same generator in a fresh
    registry (a restarted server), and other ids other streams."""
    def draw(tid):
        reg = TenantRegistry(SERVE_SPEC, device="cpu",
                             generator=torch.Generator().manual_seed(5))
        s = reg.get(tid, torch.from_numpy(_operand(40)))
        return torch.randn(4, generator=s._generator)
    assert torch.equal(draw("acme"), draw("acme"))
    assert not torch.equal(draw("acme"), draw("other"))


def test_session_of_a_tenant_is_a_plain_session():
    """A registry session solves like a Session built by hand on the same
    operand and generator."""
    A = torch.from_numpy(_operand(41))
    reg = TenantRegistry(SERVE_SPEC, device="cpu",
                         generator=torch.Generator().manual_seed(6))
    mine = reg.get("x", A)
    g = torch.Generator().manual_seed(9)
    f1 = mine.update(A, generator=g)
    other = session(A, SERVE_SPEC, track_residuals=False, device="cpu")
    f2 = other.update(A, generator=torch.Generator().manual_seed(9))
    assert torch.equal(f1.s, f2.s)


def test_single_flight_build_holds_across_a_restarted_worker(monkeypatch):
    """The first dispatch of a fresh key builds its runner slowly and is
    declared hung; the restarted worker's first calls on the same key wait
    for that build (or, declared hung in turn, are retried as the client
    contract says) instead of starting their own: one build, one trace,
    and the request is served."""
    import importlib
    pm = importlib.import_module("repro_torch.api.plan")
    real = pm.SolverPlan._build_batched
    build_threads = []

    def slow_build(self):
        build_threads.append(threading.current_thread())
        if len(build_threads) == 1:
            time.sleep(0.8)
        return real(self)

    monkeypatch.setattr(pm.SolverPlan, "_build_batched", slow_build)
    spec = SVDSpec(method="fsvd", rank=3, max_iters=19)
    shape = (37, 23)
    traces = pm.trace_count()
    srv = SolveServer(spec, device="cpu", max_batch=1, window_ms=1.0,
                      hang_timeout_s=0.5,
                      generator=torch.Generator().manual_seed(8))
    try:
        doomed = srv.submit(_operand(50, *shape))
        with pytest.raises(WorkerCrashed, match="hang_timeout"):
            doomed.result(timeout=10.0)
        for _ in range(5):
            try:
                res = srv.solve(_operand(51, *shape), timeout=10.0)
                break
            except WorkerCrashed:
                continue
        assert _sigma_err(res.value.s, _operand(51, *shape)) < 1e-2
        assert srv.stats()["worker_restarts"] >= 1
    finally:
        srv.close()
        build_threads[0].join(timeout=10.0)     # the superseded worker
    assert not build_threads[0].is_alive()
    assert len(build_threads) == 1
    assert pm.trace_count() == traces + 1
