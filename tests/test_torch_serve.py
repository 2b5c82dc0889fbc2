"""The port's solve server (``repro_torch.serve``) against the reference's.

Ports tests/test_serve.py case for case, on the CPU: the exact-mode bit
identity of ``embed`` / ``extract`` on the parity zoo, shared mode within
roundoff, every batcher contract, warm anonymous traffic that builds no
runner, tenant repeats with strictly fewer iterations, ``delta`` to the
update path and ``entries`` to the sketch path, stateless estimates,
rejections, timeouts and the closed server.  Beside them, parity with the
reference: the same ``synthetic_stream`` array for array, the same
requests through both servers (σ against a dense SVD at the reference's
1e-2·σ_max bound, and the two packages within it of each other; tenant
step kinds; the ``stats()`` / ``health()`` key sets), a served batch bit
for bit ``solve_batched`` on its stack, the tenants' submission order
under concurrent clients, and the CLI at a small size.  The two packages
draw different numbers (the port's per-request generators), so nothing
is compared bit for bit across them.
"""
import threading

import jax
import numpy as np
import pytest
import torch

import repro.serve as rserve
from repro.api import SVDSpec as RefSpec
from repro.serve.traffic import synthetic_stream as ref_stream
from repro_torch.api import (SVDSpec, plan, plan_cache_stats, trace_count)
from repro_torch.core._keys import fold_in
from repro_torch.launch import solve_serve
from repro_torch.serve import (Cancelled, ContinuousBatcher, QueueFull,
                               SolveServer, bucket_shape, embed,
                               unpad_factors)
from repro_torch.serve.bucket import stack
from repro_torch.serve.traffic import (entry_drift, lowrank_drift,
                                       lowrank_operand, synthetic_stream)
from test_solver_parity import ZOO

SPEC = SVDSpec(method="fsvd", rank=8, max_iters=48)
SERVE_SPEC = SVDSpec(method="fsvd", rank=4, max_iters=24)
SERVED_BOUND = 1e-2      # tests/test_serve.py:289-293


def gen(seed):
    return torch.Generator().manual_seed(seed)


def server(spec=SERVE_SPEC, seed=0, **kw):
    return SolveServer(spec, generator=gen(seed), device="cpu", **kw)


def sigma_err(s, A, r):
    s_true = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)[:r]
    return float(np.max(np.abs(np.asarray(s, np.float64) - s_true))
                 / s_true[0])


# ---------------------------------------------------------------------------
# bucketing: padding is transport, never arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ZOO))
def test_padded_solve_bit_identical_on_zoo(name):
    """The exact-mode contract: embedding into a bucket and extracting
    back feeds the solver the caller's bytes — σ is bit-identical."""
    A = np.array(ZOO[name][0])
    b = embed(A, 32)
    assert b.bucket == bucket_shape(A.shape, 32)
    assert tuple(b.data.shape) == b.bucket
    back = b.extract()
    np.testing.assert_array_equal(back, A)
    m, n = b.logical_shape
    assert not np.any(b.data[m:, :]) and not np.any(b.data[:, n:])
    p = plan(SPEC)
    s_direct = p.solve(torch.from_numpy(A), generator=gen(3)).s
    s_roundtrip = p.solve(torch.from_numpy(np.ascontiguousarray(back)),
                          generator=gen(3)).s
    assert torch.equal(s_direct, s_roundtrip)


def test_shared_mode_solves_bucket_at_roundoff():
    """Zero rows/cols leave σ mathematically unchanged: the bucket solve
    agrees with the logical one to f32 roundoff, and unpad_factors
    restores the logical factor shapes."""
    A = np.array(ZOO["lowrank_noise"][0])
    b = embed(A, 32)
    fact = plan(SPEC).solve(torch.from_numpy(b.data), generator=gen(3))
    fact = unpad_factors(fact, b.logical_shape)
    m, n = b.logical_shape
    assert fact.U.shape[-2] == m and fact.V.shape[-2] == n
    s_direct = plan(SPEC).solve(torch.from_numpy(A), generator=gen(3)).s
    assert float((fact.s - s_direct).abs().max() / s_direct[0]) < 5e-5


def test_stack_is_one_copy_of_the_host_stack():
    arrays = [np.full((3, 2), i, np.float32) for i in range(3)]
    got = stack(arrays, "cpu")
    assert got.shape == (3, 3, 2) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.stack(arrays))


# ---------------------------------------------------------------------------
# the continuous batcher (no solver involved)
# ---------------------------------------------------------------------------

def _recording_batcher(**kw):
    batches = []

    def dispatch(group, tickets):
        batches.append((group, [t.payload for t in tickets]))
        for t in tickets:
            t._resolve(len(tickets))

    return ContinuousBatcher(dispatch, **kw), batches


def test_batcher_flushes_at_max_batch():
    b, batches = _recording_batcher(max_batch=4, window_ms=500.0,
                                    max_queue=64)
    try:
        tickets = [b.submit("g", i) for i in range(4)]
        assert [t.result(timeout=5.0) for t in tickets] == [4, 4, 4, 4]
        assert batches == [("g", [0, 1, 2, 3])]
    finally:
        b.stop()


def test_batcher_window_flush_keeps_groups_separate():
    b, batches = _recording_batcher(max_batch=8, window_ms=10.0,
                                    max_queue=64)
    try:
        ta = [b.submit("a", i) for i in range(2)]
        tb = b.submit("b", 9)
        assert [t.result(timeout=5.0) for t in ta] == [2, 2]
        assert tb.result(timeout=5.0) == 1
        assert dict(batches) == {"a": [0, 1], "b": [9]}
    finally:
        b.stop()


@pytest.fixture
def blocked_batcher():
    """A batcher whose worker is parked inside a dispatch until released;
    yields (batcher, started_event, release_event, seen_payloads)."""
    started, release = threading.Event(), threading.Event()
    seen = []

    def dispatch(group, tickets):
        seen.extend(t.payload for t in tickets)
        started.set()
        release.wait(timeout=30)
        for t in tickets:
            t._resolve("ok")

    b = ContinuousBatcher(dispatch, max_batch=1, window_ms=1.0, max_queue=3)
    yield b, started, release, seen
    release.set()
    b.stop()


def test_batcher_backpressure_rejects_not_buffers(blocked_batcher):
    b, started, release, _ = blocked_batcher
    blocker = b.submit("g", "blocker")
    assert started.wait(timeout=5.0)
    queued = [b.submit("g", i) for i in range(3)]
    with pytest.raises(QueueFull):
        b.submit("g", "overflow")
    release.set()
    assert blocker.result(timeout=5.0) == "ok"
    assert [t.result(timeout=5.0) for t in queued] == ["ok"] * 3


def test_batcher_cancel_never_reaches_dispatch(blocked_batcher):
    b, started, release, seen = blocked_batcher
    b.submit("g", "blocker")
    assert started.wait(timeout=5.0)
    victim = b.submit("g", "victim")
    assert victim.cancel() is True
    assert victim.cancel() is False
    with pytest.raises(Cancelled):
        victim.result(timeout=5.0)
    release.set()
    b.stop()
    assert "victim" not in seen


def test_batcher_result_timeout(blocked_batcher):
    b, started, _, _ = blocked_batcher
    b.submit("g", "blocker")
    assert started.wait(timeout=5.0)
    waiting = b.submit("g", "later")
    with pytest.raises(TimeoutError):
        waiting.result(timeout=0.05)
    assert not waiting.done


def test_batcher_stop_drains_queued_work():
    b, batches = _recording_batcher(max_batch=8, window_ms=200.0,
                                    max_queue=64)
    tickets = [b.submit("g", i) for i in range(5)]
    b.stop(timeout=10.0)
    for t in tickets:
        assert isinstance(t.result(timeout=0.1), int)
    assert sorted(p for _, ps in batches for p in ps) == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError):
        b.submit("g", 99)


def test_batcher_resolve_cancel_race_exactly_one_wins(blocked_batcher):
    """A client cancel racing the worker's resolve picks exactly one
    winner, and every slot comes back exactly once."""
    b, started, release, _ = blocked_batcher
    b.submit("g", "blocker")
    assert started.wait(timeout=5.0)
    for trial in range(50):
        t = b.submit("g", trial)
        outcome = {}
        barrier = threading.Barrier(2)

        def do_cancel():
            barrier.wait()
            outcome["cancel"] = t.cancel()

        def do_resolve():
            barrier.wait()
            t._resolve("solved")

        th = [threading.Thread(target=do_cancel),
              threading.Thread(target=do_resolve)]
        for x in th:
            x.start()
        for x in th:
            x.join(timeout=5.0)
        assert not any(x.is_alive() for x in th)
        assert t.done
        if outcome["cancel"]:
            with pytest.raises(Cancelled):
                t.result(timeout=0.0)
            assert t.cancelled
        else:
            assert t.result(timeout=0.0) == "solved"
            assert not t.cancelled
        t._release_slot()
    assert b.pending == 0
    release.set()


def test_batcher_cancel_frees_backpressure_slot(blocked_batcher):
    b, started, release, _ = blocked_batcher
    b.submit("g", "blocker")
    assert started.wait(timeout=5.0)
    victims = [b.submit("g", i) for i in range(3)]
    with pytest.raises(QueueFull):
        b.submit("g", "overflow")
    for v in victims:
        assert v.cancel() is True
        assert v.cancel() is False
    assert b.pending == 0
    replacements = [b.submit("g", f"r{i}") for i in range(3)]
    release.set()
    for t in replacements:
        assert t.result(timeout=5.0) == "ok"
    b.stop()
    assert b.pending == 0


def test_batcher_dispatch_error_fails_whole_batch():
    def dispatch(group, tickets):
        raise ValueError("solver exploded")

    b = ContinuousBatcher(dispatch, max_batch=2, window_ms=1.0,
                          max_queue=8)
    try:
        t1, t2 = b.submit("g", 1), b.submit("g", 2)
        for t in (t1, t2):
            with pytest.raises(ValueError, match="solver exploded"):
                t.result(timeout=5.0)
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_end_to_end_warm_traffic_builds_nothing():
    """After warmup, anonymous traffic builds ZERO runners (the port's
    trace) and the stats endpoint's bucket hit rate / counters agree with
    the plan-cache ground truth; every answer is on the host."""
    shapes = ((48, 32), (40, 24))
    reqs = list(synthetic_stream(24, shapes=shapes, rank=4, tenants=0,
                                 seed=3))
    with server(max_batch=2, window_ms=2.0, seed=1) as srv:
        srv.warmup(shapes)
        before, t_before = plan_cache_stats(), trace_count()
        tickets = [srv.submit(r.A) for r in reqs]
        results = [t.result(timeout=120.0) for t in tickets]
        srv.batcher.stop()
        after, stats = plan_cache_stats(), srv.stats()
    assert trace_count() == t_before
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]
    assert stats["bucket_hit_rate"] == 1.0
    assert stats["submitted"] == stats["completed"] == len(reqs)
    assert stats["errors"] == 0
    assert sum(int(k) * v for k, v in stats["batch_histogram"].items()) \
        == len(reqs)
    for r, res in zip(reqs, results):
        assert sigma_err(res.value.s, r.A, 4) < SERVED_BOUND
        assert res.value.U.shape == (r.shape[0], 4)
        assert res.value.V.shape == (r.shape[1], 4)
        assert res.value.s.device.type == "cpu"
        assert res.info.residuals.device.type == "cpu"


@pytest.mark.parametrize("n", [3, 4])
def test_served_batch_is_solve_batched_bit_for_bit(n):
    """A batch the server coalesces is ``solve_batched`` of its padded
    stack with each request's generator, bit for bit (n = 3 pads to 4 by
    repeating the last request)."""
    rng = np.random.default_rng(5)
    ops = [lowrank_operand(rng, (40, 24), 4) for _ in range(n)]
    with server(max_batch=n, window_ms=10_000.0, seed=7) as srv:
        tickets = [srv.submit(A) for A in ops]
        results = [t.result(timeout=120.0) for t in tickets]
        seqs = [t.payload["seq"] for t in tickets]
        padded = 1 << (n - 1).bit_length()
        stacked = stack(ops + [ops[-1]] * (padded - n), "cpu")
        direct = srv.plan.solve_batched(
            stacked, generators=[fold_in(7, s) for s in
                                 seqs + [seqs[-1]] * (padded - n)])
    for i, res in enumerate(results):
        assert res.batch == n
        for f in ("U", "s", "V", "iterations", "breakdown"):
            assert torch.equal(getattr(res.value, f),
                               getattr(direct, f)[i]), f


def test_tenant_repeat_requests_strictly_fewer_iterations():
    rng = np.random.default_rng(0)
    base = lowrank_operand(rng, (48, 32), 4)
    with server(max_batch=2, window_ms=2.0, seed=2) as srv:
        metas = []
        for _ in range(3):
            A = base + 1e-4 * rng.standard_normal(
                base.shape).astype(np.float32)
            res = srv.solve(A, tenant="acme", timeout=120.0)
            assert res.kind == "tenant"
            metas.append(res.meta)
        stats = srv.stats()
    assert [m["kind"] for m in metas] == ["cold", "refine", "refine"]
    cold = metas[0]["iterations"]
    assert all(m["iterations"] < cold for m in metas[1:])
    assert stats["tenant_requests"] == 3
    assert stats["tenants"]["creates"] == 1
    assert stats["tenants"]["reuses"] == 2


def test_server_delta_requests_hit_update_path():
    rng = np.random.default_rng(7)
    A = lowrank_operand(rng, (48, 32), 4, noise=0.0)
    with server(max_batch=2, window_ms=2.0, seed=8) as srv:
        res0 = srv.solve(A, tenant="acme", timeout=120.0)
        assert res0.meta["kind"] == "cold"
        for _ in range(3):
            U, s, Vt = lowrank_drift(rng, A, drift=1e-3, drift_rank=2)
            res = srv.solve((U, s, Vt), kind="delta", tenant="acme",
                            timeout=120.0)
            A = A + (U * s) @ Vt
            assert res.kind == "tenant"
            assert res.meta["kind"] == "update"
            assert res.meta["iterations"] == 0
        stats = srv.stats()
    assert sigma_err(res.value.s, A, 4) < 1e-4
    assert stats["tenant_requests"] == 4
    assert stats["tenants"]["creates"] == 1


def test_server_delta_requires_tracked_state():
    rng = np.random.default_rng(8)
    A = lowrank_operand(rng, (48, 32), 4)
    U, s, Vt = lowrank_drift(rng, A, drift=1e-3, drift_rank=2)
    with server(seed=9) as srv:
        with pytest.raises(ValueError):
            srv.submit((U, s, Vt), kind="delta")
        with pytest.raises(RuntimeError, match="delta before any"):
            srv.solve((U, s, Vt), kind="delta", tenant="ghost",
                      timeout=120.0)


def test_server_entries_requests_hit_sketch_path():
    rng = np.random.default_rng(11)
    A = lowrank_operand(rng, (48, 32), 4, noise=0.0)
    with server(max_batch=2, window_ms=2.0, seed=12) as srv:
        res0 = srv.solve(A, tenant="acme", timeout=120.0)
        assert res0.meta["kind"] == "cold"
        metas = []
        for _ in range(4):
            rows, cols, vals = entry_drift(rng, A, drift=5e-4, nnz=64)
            A = A.copy()
            np.add.at(A, (rows, cols), vals)
            res = srv.solve((rows, cols, vals), kind="entries",
                            tenant="acme", timeout=120.0)
            assert res.kind == "tenant"
            metas.append(res.meta)
        stats = srv.stats()
    sketched = [m for m in metas if m["kind"] == "sketch"]
    assert len(sketched) >= 2
    for m in sketched:
        assert m["iterations"] == 0
        assert m["probe"] <= m["gate"]
        assert 0.0 < m["staleness"] < 1.0
    assert sigma_err(res.value.s, A, 4) < 5e-3
    assert stats["tenant_requests"] == 5
    assert stats["tenants"]["creates"] == 1


def test_server_entries_requires_tenant_and_tracked_state():
    rng = np.random.default_rng(12)
    A = lowrank_operand(rng, (48, 32), 4)
    rows, cols, vals = entry_drift(rng, A, drift=1e-3, nnz=16)
    with server(seed=13) as srv:
        with pytest.raises(ValueError, match="tenant"):
            srv.submit((rows, cols, vals), kind="entries")
        with pytest.raises(ValueError, match="COO triplet"):
            srv.submit(A, kind="entries", tenant="acme")
        with pytest.raises(RuntimeError, match="entries before any"):
            srv.solve((rows, cols, vals), kind="entries", tenant="ghost",
                      timeout=120.0)
        bad = vals.copy()
        bad[0] = np.nan
        with pytest.raises(Exception, match="quarantined"):
            srv.submit((rows, cols, bad), kind="entries", tenant="acme")


def test_estimate_requests_are_stateless():
    rng = np.random.default_rng(5)
    A = lowrank_operand(rng, (48, 32), 4, noise=0.0)
    spec = SVDSpec(method="fsvd", rank=4, max_iters=32)
    with server(spec, seed=3) as srv:
        res = srv.solve(A, kind="estimate", timeout=120.0)
        assert res.kind == "estimate"
        assert int(res.value.rank) == 4
        assert res.value.rank.device.type == "cpu"
        with pytest.raises(ValueError):
            srv.submit(A, kind="estimate", tenant="acme")


def test_server_counts_rejections(monkeypatch):
    srv = server(seed=4)
    try:
        def full(group, payload, **kw):
            raise QueueFull("full")
        monkeypatch.setattr(srv.batcher, "submit", full)
        with pytest.raises(QueueFull):
            srv.submit(np.zeros((8, 8), np.float32))
        assert srv.stats()["rejected"] == 1
        assert srv.stats()["submitted"] == 0
    finally:
        srv.close()


def test_server_timeout_cancels_and_counts(monkeypatch):
    started, release = threading.Event(), threading.Event()
    srv = server(max_batch=1, window_ms=1.0, seed=5)
    try:
        def slow(group, tickets):
            started.set()
            release.wait(timeout=30)
            for t in tickets:
                t._resolve("late")
        monkeypatch.setattr(srv.batcher, "_dispatch", slow)
        A = np.zeros((8, 8), np.float32)
        srv.submit(A)
        assert started.wait(timeout=5.0)
        with pytest.raises(TimeoutError):
            srv.solve(A, timeout=0.05)
        stats = srv.stats()
        assert stats["timeouts"] == 1 and stats["cancelled"] == 1
    finally:
        release.set()
        srv.close()


def test_closed_server_refuses_submissions():
    srv = server(seed=6)
    srv.close()
    srv.close()
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros((8, 8), np.float32))


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """No device means the card: without one the server and the CLI
    raise instead of quietly serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SolveServer(SERVE_SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_serve.main(["--requests", "2", "--no-warmup"])


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

STREAMS = [dict(tenants=0), dict(tenants=3, estimate_fraction=0.2),
           dict(tenants=2, tenant_fraction=0.5, structured_drift=True),
           dict(tenants=2, tenant_fraction=0.5, entry_drift_nnz=32)]


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("kw", STREAMS,
                         ids=["anon", "tenants", "delta", "entries"])
def test_synthetic_stream_is_the_references(seed, kw):
    shapes = ((48, 32), (40, 24), (33, 17))
    mine = list(synthetic_stream(30, shapes=shapes, rank=4, seed=seed, **kw))
    ref = list(ref_stream(30, shapes=shapes, rank=4, seed=seed, **kw))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a.shape, a.tenant, a.kind) == (b.shape, b.tenant, b.kind)
        assert a.A.dtype == b.A.dtype
        np.testing.assert_array_equal(a.A, b.A)
        for x, y in ((a.delta, b.delta), (a.entries, b.entries)):
            assert (x is None) == (y is None)
            for u, v in zip(x or (), y or ()):
                np.testing.assert_array_equal(u, v)


def test_same_requests_through_both_servers():
    """One client submits the same stream, in order, to both servers:
    every anonymous σ is within the reference's served bound of a dense
    SVD and of the other package's; tenant kinds agree where the policy
    decides them by itself (first cold, a delta an update of 0
    iterations); stats() and health() carry the reference's keys."""
    shapes = ((48, 32), (40, 24))
    reqs = list(synthetic_stream(16, shapes=shapes, rank=4, tenants=2,
                                 tenant_fraction=0.4, structured_drift=True,
                                 seed=4))
    assert {r.kind for r in reqs} == {"factorize", "delta"}
    ref_spec = RefSpec(method="fsvd", rank=4, max_iters=24)
    mine = server(seed=1, window_ms=1.0)
    ref = rserve.SolveServer(ref_spec, window_ms=1.0,
                             key=jax.random.key(1))
    try:
        seen = set()
        for r in reqs:
            if r.kind == "delta":
                operand, kind = r.delta, "delta"
            else:
                operand, kind = r.A, "factorize"
            a = mine.solve(operand, kind=kind, tenant=r.tenant,
                           timeout=120.0)
            b = ref.solve(operand, kind=kind, tenant=r.tenant,
                          timeout=120.0)
            s_a = a.value.s.numpy()
            s_b = np.asarray(b.value.s)
            assert sigma_err(s_a, r.A, 4) < SERVED_BOUND
            assert sigma_err(s_b, r.A, 4) < SERVED_BOUND
            assert np.max(np.abs(s_a - s_b)) / s_b[0] < SERVED_BOUND
            if r.tenant is None:
                assert a.kind == b.kind == "factorize"
                continue
            first = r.tenant not in seen
            seen.add(r.tenant)
            if first:
                assert a.meta["kind"] == b.meta["kind"] == "cold"
            if r.kind == "delta" and b.meta["kind"] == "update":
                assert a.meta["kind"] == "update"
                assert a.meta["iterations"] == b.meta["iterations"] == 0
        mine.batcher.stop()         # settle worker-side accounting
        ref.batcher.stop()
        sa, sb = mine.stats(), ref.stats()
        assert set(sa) == set(sb)
        assert set(sa["health"]) == set(sb["health"])
        assert set(mine.health()) == set(ref.health())
        assert set(sa["tenants"]) == set(sb["tenants"])
        assert set(sa["latency_ms"]) == set(sb["latency_ms"])
        assert set(sa["plan_cache"]) == set(sb["plan_cache"])
        for k in ("submitted", "completed", "tenant_requests", "errors"):
            assert sa[k] == sb[k], k
    finally:
        mine.close()
        ref.close()


def test_tenant_drifts_reach_the_server_in_stream_order():
    """Four clients replay a structured-drift stream: each tenant's
    requests are submitted in stream order, so every request is served,
    each tenant starts cold and each delta is an update of 0 iterations
    whose σ tracks the drifted operand."""
    shapes = ((48, 32), (40, 24))
    reqs = list(synthetic_stream(24, shapes=shapes, rank=4, tenants=2,
                                 tenant_fraction=0.6, structured_drift=True,
                                 seed=2))
    served = {}
    with server(seed=3, window_ms=2.0) as srv:
        counts = solve_serve.run_traffic(
            srv, reqs, clients=4,
            on_result=lambda req, o, d: served.__setitem__(id(req), d))
    assert counts["ok"] == len(reqs) and not counts["errors"]
    kinds = {}
    for req in reqs:
        res = served[id(req)]
        assert sigma_err(res.value.s, req.A, 4) < SERVED_BOUND
        if req.tenant is not None:
            kinds.setdefault(req.tenant, []).append(
                (res.meta["kind"], res.meta["iterations"]))
    for steps in kinds.values():
        assert steps[0][0] == "cold"
        assert all(k in ("update", "refine", "restart") for k, _ in
                   steps[1:])
        assert all(i == 0 for k, i in steps if k == "update")


def test_cli_runs_on_the_cpu(tmp_path):
    path = tmp_path / "stats.json"
    out = solve_serve.main(["--device", "cpu", "--requests", "24",
                            "--tenants", "2", "--estimate-fraction", "0.2",
                            "--stats-json", str(path), "--seed", "3"])
    drv, st = out["traffic"], out["server"]
    assert drv["ok"] == 24 and drv["failed"] == 0
    assert st["completed"] == 24 and st["worker_restarts"] == 0
    assert st["bucket_hit_rate"] == 1.0
    assert path.exists()
