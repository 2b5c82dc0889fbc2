"""The port's serving resilience primitives (``repro_torch.serve.
resilience``) against the reference's.

The cases of tests/test_resilience.py that need no server, on the
primitives the server is built from: the circuit breaker of
``test_breaker_opens_sheds_to_degraded_then_half_opens`` (threshold 2,
reset 0.3 s: open, shed, half-open trial, closed again), the transient
retry of ``test_transient_fault_retried_with_backoff`` (a ``plan.solve``
failpoint that fires once, retried with backoff) and the NaN quarantine
of ``test_nan_operand_quarantined_at_submit``.  Each is driven through
both packages' primitives with the same inputs; the server-level cases
are in tests/test_torch_serve_resilience.py.
"""
import time

import numpy as np
import pytest
import torch

import repro.serve.resilience as rres
from repro.runtime import faults as ref_faults
from repro_torch.api import SVDSpec, factorize, plan
from repro_torch.api.results import Factorization
from repro_torch.core.operators import DenseOp, LowRankOp
from repro_torch.runtime import faults
from repro_torch.serve import resilience as res

RESET_S = 0.3


@pytest.fixture(autouse=True)
def _clean_failpoints():
    # the lifetime fire counts too: an earlier file in the same process
    # (tests/test_torch_plan.py fires plan.solve) must not leak into a
    # test that counts fires
    faults.disarm_all()
    ref_faults.disarm_all()
    faults.reset_stats()
    ref_faults.reset_stats()
    yield
    faults.disarm_all()
    ref_faults.disarm_all()
    faults.reset_stats()
    ref_faults.reset_stats()


@pytest.mark.parametrize("mod", [res, rres], ids=["port", "reference"])
def test_breaker_opens_sheds_then_half_opens_and_closes(mod):
    br = mod.CircuitBreaker(threshold=2, reset_s=RESET_S)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed" and br.allow()     # one failure: still shut
    br.record_failure()
    assert br.state == "open" and not br.allow()   # shedding
    assert br.snapshot() == {"state": "open", "failures": 2, "opens": 1}
    time.sleep(RESET_S + 0.05)
    assert br.state == "half-open"
    assert br.allow()                              # the one trial
    br.record_success()
    assert br.state == "closed"
    assert br.snapshot() == {"state": "closed", "failures": 0, "opens": 1}


@pytest.mark.parametrize("mod", [res, rres], ids=["port", "reference"])
def test_breaker_half_open_failure_reopens(mod):
    br = mod.CircuitBreaker(threshold=1, reset_s=RESET_S)
    br.record_failure()
    assert not br.allow()
    time.sleep(RESET_S + 0.05)
    assert br.allow()                              # half-open trial
    br.record_failure()                            # trial failed
    assert br.state == "open" and not br.allow()
    assert br.snapshot()["opens"] == 2


def test_breaker_transitions_match_the_reference():
    """One schedule of successes, failures and waits through both
    breakers: the same states and snapshots at every step."""
    ours = res.CircuitBreaker(threshold=3, reset_s=0.1)
    ref = rres.CircuitBreaker(threshold=3, reset_s=0.1)
    rng = np.random.default_rng(0)
    for op in rng.choice(["fail", "ok", "wait", "allow"], size=40):
        for br in (ours, ref):
            if op == "fail":
                br.record_failure()
            elif op == "ok":
                br.record_success()
            elif op == "allow":
                br.allow()
        if op == "wait":
            time.sleep(0.12)
        assert ours.snapshot() == ref.snapshot()
        assert ours.state == ref.state


@pytest.mark.parametrize("mod", [res, rres], ids=["port", "reference"])
def test_breaker_refuses_a_zero_threshold(mod):
    with pytest.raises(ValueError, match="threshold"):
        mod.CircuitBreaker(threshold=0)


def test_transient_fault_retried_with_backoff():
    """A plan.solve failpoint that raises TransientFault once: the retry
    loop backs off once and the second attempt answers."""
    A = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (24, 16)).astype(np.float32))
    p = plan(SVDSpec(method="fsvd", rank=4, max_iters=16), like=A)
    retries = []
    faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, transient=True,
               max_fires=1)
    fact = res.retry_with_backoff(
        lambda: p.solve(A, generator=torch.Generator().manual_seed(0)),
        retries=2, backoff_s=1e-3, retry_on=(faults.TransientFault,),
        on_retry=retries.append)
    assert retries == [0]
    assert faults.fire_count(faults.PLAN_SOLVE) == 1
    want = factorize(A, SVDSpec(method="fsvd", rank=4, max_iters=16),
                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(fact.s, want.s)


@pytest.mark.parametrize("mod", [res, rres], ids=["port", "reference"])
def test_retry_gives_up_after_its_budget_and_sleeps_exponentially(
        mod, monkeypatch):
    slept, calls = [], []
    monkeypatch.setattr(mod.time, "sleep", slept.append)

    def boom():
        calls.append(1)
        raise KeyError("always")

    with pytest.raises(KeyError):
        mod.retry_with_backoff(boom, retries=3, backoff_s=0.5,
                               retry_on=(KeyError,))
    assert len(calls) == 4
    assert slept == [0.5, 1.0, 2.0]


@pytest.mark.parametrize("mod", [res, rres], ids=["port", "reference"])
def test_retry_passes_other_exceptions_through(mod):
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("not retryable")

    with pytest.raises(ValueError):
        mod.retry_with_backoff(boom, retries=5, backoff_s=0.0,
                               retry_on=(KeyError,))
    assert calls == [1]


def _operand(seed=1, m=24, n=16):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_nan_operand_quarantined(bad):
    """Every form the port takes an operand in is quarantined when one
    entry is not finite, as the reference's gate does for arrays."""
    A = _operand()
    A[2, 3] = bad
    for tree in (A, torch.from_numpy(A), DenseOp(torch.from_numpy(A)),
                 {"op": [torch.zeros(3), torch.from_numpy(A)]}):
        with pytest.raises(res.PoisonedOperand, match="NaN/Inf"):
            res.finite_or_raise(tree)
    with pytest.raises(rres.PoisonedOperand):
        rres.finite_or_raise(A)


def test_clean_operands_and_integer_leaves_pass():
    A = torch.from_numpy(_operand())
    f = Factorization(A[:, :2], torch.ones(2), torch.ones(16, 2),
                      torch.tensor(3, dtype=torch.int32),
                      torch.tensor(False))
    res.finite_or_raise(A)
    res.finite_or_raise(f, what="answer")
    res.finite_or_raise(LowRankOp(torch.ones(4, 1), torch.ones(1),
                                  torch.ones(1, 3)))
    res.finite_or_raise({"idx": np.arange(5), "n": 7, "tag": "x"})
    poisoned = LowRankOp(torch.ones(4, 1), torch.tensor([float("nan")]),
                         torch.ones(1, 3))
    with pytest.raises(res.PoisonedOperand, match="factor"):
        res.finite_or_raise(poisoned, what="factor")


def test_failure_taxonomy_matches_the_reference():
    for name in ("DeadlineExceeded", "WorkerCrashed", "CircuitOpen",
                 "PoisonedOperand", "DegradedRejected"):
        ours, ref = getattr(res, name), getattr(rres, name)
        assert ours.__mro__[1] is ref.__mro__[1]   # the same builtin base
