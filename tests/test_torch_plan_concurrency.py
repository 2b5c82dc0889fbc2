"""The port's plan cache under concurrency: N threads hammering one key
build exactly one runner (single-flight), counters stay coherent, and the
bounded LRU's evictions are accounted.  Mirrors three of the four cases
of tests/test_plan_concurrency.py; its Session case waits for the port's
Session (ROADMAP Queue 1 item 2)."""
import importlib
import threading

import jax
import numpy as np
import pytest
import torch

from conftest import make_lowrank
from repro_torch.api import (SVDSpec, clear_plan_cache, plan,
                             plan_cache_stats, trace_count)

# ``repro_torch.api`` re-exports a ``plan`` *function*, which shadows the
# submodule under ``import repro_torch.api.plan as ...``: resolve the
# module itself for monkeypatching its cache bound.
plan_mod = importlib.import_module("repro_torch.api.plan")

SPEC = SVDSpec(method="fsvd", rank=4, max_iters=24)

N_THREADS = 8
PER_THREAD = 4


def _lowrank(seed, m, n, r):
    return torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(seed),
                                                  m, n, r)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def fresh_cache():
    clear_plan_cache(reset_stats=True)
    yield
    clear_plan_cache(reset_stats=True)


def _hammer(fn, n_threads=N_THREADS):
    """Run ``fn(thread_idx)`` on every thread behind a start barrier; a
    thread still alive after the join timeout is a deadlock, not slowness."""
    errors = []
    barrier = threading.Barrier(n_threads)

    def worker(i):
        try:
            barrier.wait(timeout=30)
            fn(i)
        except Exception as exc:       # noqa: BLE001 — surface in-test
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads), \
        "deadlock: worker threads never finished"
    assert not errors, errors


def test_one_key_many_threads_traces_once(fresh_cache):
    A = _lowrank(0, 64, 48, 4)
    s_true = np.linalg.svd(A.numpy().astype(np.float64),
                           compute_uv=False)[:4]
    results = [None] * N_THREADS

    def solve_loop(i):
        for j in range(PER_THREAD):
            f = plan(SPEC, like=A).solve(
                A, generator=_gen(i * PER_THREAD + j))
            results[i] = f.s.numpy()

    _hammer(solve_loop)
    assert trace_count() == 1          # single-flight: one trace, period
    stats = plan_cache_stats()
    assert stats["entries"] == 1
    assert stats["misses"] == 1        # only the builder missed
    assert stats["hits"] == N_THREADS * PER_THREAD - 1
    for s in results:
        assert np.max(np.abs(s - s_true)) / s_true[0] < 1e-2


def test_distinct_keys_race_without_cross_talk(fresh_cache):
    """Threads racing DIFFERENT cache keys (per-thread operand shape)
    build exactly one runner each — no lost entries, no duplicate traces,
    no deadlock between concurrent builders."""
    mats = [_lowrank(i, 40 + 8 * i, 32, 4) for i in range(4)]

    def solve_loop(i):
        A = mats[i % len(mats)]
        for j in range(PER_THREAD):
            plan(SPEC, like=A).solve(A, generator=_gen(j))

    _hammer(solve_loop)
    assert trace_count() == len(mats)
    stats = plan_cache_stats()
    assert stats["entries"] == len(mats)
    assert stats["misses"] == len(mats)
    assert stats["hits"] == N_THREADS * PER_THREAD - len(mats)


def test_eviction_accounting_under_tiny_cache(fresh_cache, monkeypatch):
    monkeypatch.setattr(plan_mod, "_CACHE_SIZE", 2)
    mats = [_lowrank(i, 40 + 8 * i, 24, 4) for i in range(4)]
    for A in mats:
        plan(SPEC, like=A).solve(A, generator=_gen(0))
    stats = plan_cache_stats()
    assert stats["entries"] <= 2
    assert stats["evictions"] == 2
    assert stats["misses"] == 4
    # an evicted key rebuilds (miss), a resident one hits
    plan(SPEC, like=mats[0]).solve(mats[0], generator=_gen(0))
    assert plan_cache_stats()["misses"] == 5
    plan(SPEC, like=mats[0]).solve(mats[0], generator=_gen(0))
    assert plan_cache_stats()["hits"] == 1
