"""The port's fault-injection registry (``repro_torch.runtime.faults``):
the ten cases of tests/test_faults.py on the port — armed/disarmed fast
paths, probability and max_fires semantics, seeded determinism,
corrupt-mode value crossings, context-manager scoping, thread safety and
the chaos preset — plus the port's own tensor crossing of ``corrupt``,
held to the reference's schedule on the same seed."""
import threading

import numpy as np
import pytest
import torch

from repro.runtime import faults as ref_faults
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultInjected, TransientFault


@pytest.fixture(autouse=True)
def _clean_registry():
    for f in (faults, ref_faults):
        f.disarm_all()
        f.reset_stats()
    yield
    for f in (faults, ref_faults):
        f.disarm_all()


def test_disarmed_is_noop():
    # never armed: fire/corrupt must be free and inert
    faults.fire("some.point")
    assert faults.corrupt("some.point", b"abc") == b"abc"
    assert not faults.armed("some.point")


def test_raise_mode_fires_with_p1():
    faults.arm("t.raise", mode="raise", p=1.0)
    assert faults.armed("t.raise")
    with pytest.raises(FaultInjected):
        faults.fire("t.raise")
    assert faults.fire_count("t.raise") == 1


def test_transient_raises_retryable_subtype():
    faults.arm("t.transient", mode="raise", p=1.0, transient=True)
    with pytest.raises(TransientFault):
        faults.fire("t.transient")
    # TransientFault IS a FaultInjected: generic handlers still catch it
    assert issubclass(TransientFault, FaultInjected)


def test_max_fires_bounds_the_blast_radius():
    faults.arm("t.bounded", mode="raise", p=1.0, max_fires=2)
    for _ in range(2):
        with pytest.raises(FaultInjected):
            faults.fire("t.bounded")
    faults.fire("t.bounded")            # exhausted: no-op
    assert faults.fire_count("t.bounded") == 2


def test_probability_is_seeded_and_deterministic():
    def sequence():
        faults.arm("t.seeded", mode="raise", p=0.5, seed=123)
        hits = []
        for _ in range(64):
            try:
                faults.fire("t.seeded")
                hits.append(0)
            except FaultInjected:
                hits.append(1)
        faults.disarm("t.seeded")
        return hits

    a, b = sequence(), sequence()
    assert a == b                        # same seed -> same draw sequence
    assert 0 < sum(a) < 64               # actually probabilistic


def test_corrupt_mode_flips_bytes_and_nans_floats():
    faults.arm("t.corrupt", mode="corrupt", p=1.0)
    raw = b"\x00" * 16
    assert faults.corrupt("t.corrupt", raw) != raw
    arr = np.ones(8, np.float32)
    out = faults.corrupt("t.corrupt", arr.copy())
    assert not np.isfinite(np.asarray(out)).all()


def test_inject_context_manager_scopes_the_fault():
    with faults.inject("t.scoped", mode="raise", p=1.0):
        with pytest.raises(FaultInjected):
            faults.fire("t.scoped")
    faults.fire("t.scoped")              # disarmed on exit


def test_delay_mode_sleeps():
    import time
    faults.arm("t.delay", mode="delay", p=1.0, delay_s=0.05)
    t0 = time.perf_counter()
    faults.fire("t.delay")
    assert time.perf_counter() - t0 >= 0.045


def test_thread_safety_under_concurrent_fire():
    faults.arm("t.mt", mode="raise", p=1.0, max_fires=50)
    fired = []

    def worker():
        for _ in range(25):
            try:
                faults.fire("t.mt")
            except FaultInjected:
                fired.append(1)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # max_fires is exact even under contention
    assert len(fired) == 50
    assert faults.fire_count("t.mt") == 50


def test_chaos_preset_arms_and_restores():
    with faults.chaos(0, dispatch_crash_p=0.5, solve_transient_p=0.5):
        assert faults.armed(faults.SERVE_DISPATCH)
        assert faults.armed(faults.PLAN_SOLVE)
    assert not faults.armed(faults.SERVE_DISPATCH)
    assert not faults.armed(faults.PLAN_SOLVE)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_corrupt_mode_poisons_a_copy_of_a_tensor(dtype):
    """A tensor crossing gets the reference's seeded flat position (the
    same draw as a numpy array of that size), in a copy on its own device:
    a NaN for a float tensor, every bit flipped otherwise; the input is
    left as it was."""
    shape, seed = (7, 5), 11
    ref_faults.arm("t.tensor", mode="corrupt", p=1.0, seed=seed)
    want = np.asarray(ref_faults.corrupt("t.tensor",
                                         np.ones(shape, np.float32)))
    faults.arm("t.tensor", mode="corrupt", p=1.0, seed=seed)
    x = torch.ones(shape, dtype=dtype)
    got = faults.corrupt("t.tensor", x)
    assert got is not x and got.device == x.device and got.dtype == dtype
    assert torch.equal(x, torch.ones(shape, dtype=dtype))
    hit = np.argwhere(np.isnan(want))
    changed = (got != x).nonzero().numpy()
    np.testing.assert_array_equal(changed, hit)
    if dtype.is_floating_point:
        assert torch.isnan(got.float()).sum() == 1
    else:
        assert int(got[tuple(hit[0])]) == ~1
    assert faults.fire_count("t.tensor") == 1
    faults.disarm("t.tensor")
    assert faults.corrupt("t.tensor", x) is x          # disarmed: untouched
