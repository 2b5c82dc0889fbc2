"""The port's Session (``repro_torch.api.session``) against the
reference's.

Mirrors the 12 cases of tests/test_session.py, the Session cases of
tests/test_update.py:176-320 and of tests/test_sketchres.py:242-388, each
held to the reference test's own assertions and bounds: the kinds taken,
zero iterations on the update and sketch branches, the gates, probe ≤
gate, the σ bounds (``STOL`` 5e-4 of σ_max after a GK solve, 1e-4 along a
delta stream, 5e-3 after a sketch) and the trace counts (a trace is one
build of a plan key's runner).  The reference's draws cannot be made in
torch, so the port's sessions take a ``torch.Generator`` and these cases
compare outcomes, not draws.

Then what ties the two packages together: ``residual_probe`` gives the
reference's value bit for bit on the same numpy inputs; two sessions, one
of each package, started from the same factorization (``bridge.
factorization``) take the same branch on the same delta, drift or entry
batch, with drift sines, update residuals and probes within the stated
tolerances; both learn the same refine budget from the same residual
trace; and the operand folds give the reference's bits on the CPU.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.serve.resilience as rres
from conftest import make_lowrank
from repro.api.callbacks import ConvergenceInfo as RefInfo
from repro.core.operators import LowRankOp as RefLowRankOp
from repro.core.update import materialize_lowrank as ref_materialize
from repro.kernels.sketch_matvec import ZETA
from repro.sketchres.state import _hashed as ref_hashed
from repro_torch import bridge
from repro_torch.api import (ImplicitKeyWarning, LowRankOp, SVDSpec,
                             clear_plan_cache, factorize, session,
                             trace_count)
from repro_torch.api.callbacks import ConvergenceInfo
from repro_torch.api.session import (Session, fold_entries, fold_lowrank,
                                     zero_lines)
from repro_torch.core.update import materialize_lowrank
from repro_torch.serve import resilience as res
from test_solver_parity import R, ZOO

SPEC = SVDSpec(method="fsvd", rank=R, max_iters=48)
REF_SPEC = rapi.SVDSpec(method="fsvd", rank=R, max_iters=48)
STOL = 5e-4          # tests/test_session.py: the parity battery's GK gate
KEY = jax.random.PRNGKey(11)


def _gen(seed=11):
    return torch.Generator().manual_seed(seed)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _zoo(name):
    return _t(ZOO[name][0])


def _drifted(A, seed, rel=1e-3):
    G = torch.randn(A.shape, generator=_gen(seed))
    return A + rel * torch.linalg.vector_norm(A) * G / \
        torch.linalg.vector_norm(G)


def _accuracy(fact, A) -> float:
    s_true = np.linalg.svd(np.asarray(A, np.float64),
                           compute_uv=False)[:fact.rank]
    return float(np.max(np.abs(fact.s.double().numpy() - s_true))
                 / s_true[0])


def _lowrank(seed, m, n, r):
    return _t(make_lowrank(jax.random.PRNGKey(seed), m, n, r))


# --- tests/test_session.py --------------------------------------------------

@pytest.mark.parametrize("name", sorted(ZOO))
def test_update_beats_cold_on_zoo(name):
    A = _zoo(name)
    spec = SPEC.replace(max_iters=min(48, min(A.shape)))
    A2 = _drifted(A, 1)
    cold = factorize(A2, spec, generator=_gen(2))
    sess = session(A, spec, generator=_gen())
    sess.solve()
    tracked = sess.update(A2)
    assert sess.history[-1]["kind"] == "refine"
    assert int(tracked.iterations) < int(cold.iterations)
    acc_cold = _accuracy(cold, A2)
    acc_tracked = _accuracy(tracked, A2)
    assert acc_tracked <= max(STOL, 2.0 * acc_cold), (
        f"{name}: tracked {acc_tracked:.2e} vs cold {acc_cold:.2e}")


def test_refine_vs_restart_decision():
    A = _zoo("lowrank_noise")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    sess.update(_drifted(A, 3, rel=1e-4))
    assert sess.history[-1]["kind"] == "refine"
    assert sess.history[-1]["drift"] < sess.restart_angle
    B = _lowrank(99, *A.shape, R)
    sess.update(B)
    assert sess.history[-1]["kind"] == "restart"
    assert sess.history[-1]["drift"] > sess.restart_angle
    assert sess.counts() == {"cold": 1, "refine": 1, "restart": 1}


def test_drift_is_zero_for_unchanged_operator():
    A = _zoo("graded")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    assert sess.drift() < 1e-4
    again = sess.solve()
    assert sess.history[-1]["kind"] == "refine"
    assert _accuracy(again, A) <= STOL


def _rank1(A, scale_rel=1e-3, seeds=(5, 6)):
    m, n = A.shape
    u = torch.randn(m, 1, generator=_gen(seeds[0]))
    v = torch.randn(1, n, generator=_gen(seeds[1]))
    scale = scale_rel * float(torch.linalg.vector_norm(A)) / float(
        torch.linalg.vector_norm(u) * torch.linalg.vector_norm(v))
    return u, v, scale


def test_delta_lowrank_update():
    A = _zoo("lowrank_noise")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    u, v, scale = _rank1(A)
    fact = sess.delta(LowRankOp(u, torch.tensor([scale]), v))
    assert sess.history[-1]["kind"] == "update"
    assert sess.history[-1]["iterations"] == 0
    assert sess.counts()["update"] == 1
    assert _accuracy(fact, A + scale * (u @ v)) <= STOL


def test_delta_update_disabled_falls_back_to_refine():
    A = _zoo("lowrank_noise")
    sess = session(A, SPEC, generator=_gen(), update_tol=0.0)
    sess.solve()
    u, v, scale = _rank1(A)
    fact = sess.delta(LowRankOp(u, torch.tensor([scale]), v))
    assert sess.history[-1]["kind"] == "refine"
    assert "update" not in sess.counts()
    assert _accuracy(fact, A + scale * (u @ v)) <= STOL


def test_session_residual_history():
    A = _zoo("tall")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    sess.update(_drifted(A, 7))
    assert all("residual" in rec for rec in sess.history)
    assert all(rec["residual"] < 1e-4 for rec in sess.history)
    quiet = session(A, SPEC, generator=_gen(), track_residuals=False)
    quiet.solve()
    assert "residual" not in quiet.history[-1]


def test_session_compiles_twice_for_many_solves():
    A = _zoo("wide")
    clear_plan_cache()
    base = trace_count()
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    for t in range(4):
        sess.update(_drifted(A, 20 + t))
    assert trace_count() - base == 2
    assert sess.counts()["refine"] == 4


def test_session_save_restore_roundtrip(tmp_path):
    A = _zoo("lowrank_noise")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    A2 = _drifted(A, 8)
    sess.update(A2)
    sess.save(str(tmp_path))
    back = Session.restore(str(tmp_path), A2, generator=_gen())
    assert back.solves == sess.solves
    assert back.history == sess.history
    assert back.spec == sess.spec
    for f in ("U", "s", "V", "iterations", "breakdown"):
        assert torch.equal(getattr(back.fact, f), getattr(sess.fact, f))
    assert back.fact.method == sess.fact.method
    back.update(_drifted(A2, 9))
    assert back.history[-1]["kind"] == "refine"


def test_load_latest_into_live_session(tmp_path):
    A = _zoo("graded")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    sess.save(str(tmp_path))
    fresh = session(A, SPEC, generator=_gen())
    assert fresh.fact is None
    assert fresh.load_latest(str(tmp_path))
    assert fresh.solves == 1 and fresh.fact is not None
    assert not session(A, SPEC, generator=_gen()).load_latest(
        str(tmp_path / "no"))


def test_update_with_new_shape_restarts_not_crashes():
    A = _zoo("lowrank_noise")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    B = _lowrank(5, 40, 24, R)
    fact = sess.update(B)
    assert sess.history[-1]["kind"] == "restart"
    assert fact.shape == (40, 24)
    assert _accuracy(fact, B) <= STOL


def test_refine_uses_session_generator_stream_for_sketch():
    """rsvd has no warm-start seam: refines draw from the session's
    stream, never the implicit seed-0 generator."""
    A = _zoo("lowrank_noise")
    sess = session(A, SVDSpec(method="rsvd", rank=4, power_iters=2),
                   generator=_gen())
    with warnings.catch_warnings():
        warnings.simplefilter("error", ImplicitKeyWarning)
        sess.solve()
        sess.update(_drifted(A, 30))


def test_session_save_keep_n(tmp_path):
    A = _zoo("graded")
    sess = session(A, SPEC, generator=_gen())
    sess.solve()
    for s in (1, 2, 3, 4):
        sess.save(str(tmp_path), s, keep=2)
    names = sorted(os.listdir(tmp_path))
    assert "step_3" in names and "step_4" in names
    assert "step_1" not in names and "step_2" not in names


# --- tests/test_update.py:176-320 ------------------------------------------

M, N = 96, 64
USPEC = SVDSpec(method="fsvd", rank=R, max_iters=48)


def _exact(seed=77):
    return _lowrank(seed, M, N, R)


def _delta(seed, m=M, n=N, k=2, rel=1e-2, ref=None):
    U = torch.randn(m, k, generator=_gen(seed))
    Vt = torch.randn(k, n, generator=_gen(seed + 1000))
    scale = 1.0 if ref is None else rel * float(
        torch.linalg.vector_norm(ref)) / float(torch.linalg.vector_norm(
            U @ Vt))
    return LowRankOp(U, torch.full((k,), scale), Vt)


def test_session_delta_stream_zero_iterations():
    A = _exact()
    sess = session(A, USPEC, generator=_gen())
    sess.solve()
    cur = A
    for t in range(4):
        d = _delta(50 + t, rel=1e-3, ref=cur)
        fact = sess.delta(d)
        cur = cur + materialize_lowrank(d)
        assert sess.history[-1]["kind"] == "update"
        assert sess.history[-1]["iterations"] == 0
        assert _accuracy(fact, cur) <= 1e-4
    assert sess.counts()["update"] == 4
    assert sess.meta()["updates"] == 4


def test_session_gate_rejects_and_annotates():
    A = _zoo("lowrank_noise")
    sess = session(A, USPEC, generator=_gen(), update_tol=1e-12)
    sess.solve()
    sess.delta(_delta(60, m=A.shape[0], n=A.shape[1], rel=1e-3, ref=A))
    rec = sess.history[-1]
    assert rec["kind"] in ("refine", "restart")
    assert rec["update_rejected"] is True
    assert rec["residual_update"] > rec["gate"] == 1e-12
    assert "update" not in sess.counts()


def test_session_downdate():
    A = _exact()
    sess = session(A, USPEC, generator=_gen())
    with pytest.raises(RuntimeError):
        sess.downdate(rows=[0])
    sess.solve()
    with pytest.raises(ValueError):
        sess.downdate(rows=[0], cols=[1])
    fact = sess.downdate(rows=[2, 9])
    A2 = A.clone()
    A2[[2, 9], :] = 0
    assert sess.history[-1]["kind"] == "downdate"
    assert sess.counts()["downdate"] == 1
    assert _accuracy(fact, A2) <= 1e-4
    assert float(sess.op.A[[2, 9], :].abs().max()) == 0.0
    assert torch.equal(A[[2, 9]], _exact()[[2, 9]])   # the caller's A kept


def test_session_oversized_delta_falls_back():
    m, n, r = 24, 10, 8
    A = _lowrank(70, m, n, r)
    sess = session(A, SVDSpec(method="fsvd", rank=r, max_iters=10),
                   generator=_gen())
    sess.solve()
    sess.delta(_delta(71, m=m, n=n, k=4, rel=1e-3, ref=A))
    assert sess.history[-1]["kind"] in ("refine", "restart")


def test_restore_preserves_policy_knobs_and_updates(tmp_path):
    A = _exact()
    sess = session(A, USPEC, generator=_gen(), track_residuals=False,
                   restart_angle=0.3, update_tol=1e-3)
    sess.solve()
    d = _delta(80, rel=1e-4, ref=A)
    sess.delta(d)
    assert sess.counts()["update"] == 1
    meta = sess.meta()
    assert meta["track_residuals"] is False
    assert meta["restart_angle"] == 0.3
    assert meta["update_tol"] == 1e-3
    assert meta["updates"] == 1
    sess.save(str(tmp_path))
    A2 = A + materialize_lowrank(d)
    back = Session.restore(str(tmp_path), A2, generator=_gen())
    assert back.track_residuals is False
    assert back.restart_angle == 0.3
    assert back.update_tol == 1e-3
    assert back.history == sess.history
    assert back.counts() == sess.counts()
    fresh = session(A2, USPEC, generator=_gen())
    assert fresh.load_latest(str(tmp_path))
    assert fresh.track_residuals is False
    assert fresh.restart_angle == 0.3
    assert fresh.update_tol == 1e-3
    assert fresh.history == sess.history


def test_untracked_solve_issues_no_extra_host_sync(monkeypatch):
    """With ``track_residuals=False`` and a pinned refine budget, a warm
    tracked solve reads at most ONE device scalar (the drift policy's) —
    recording history adds no read; reading history is the sync point."""
    A = _zoo("lowrank_noise")
    drifts = [A + 1e-4 * torch.linalg.vector_norm(A) * _lowrank(
        90 + t, *A.shape, 2) for t in (0, 1)]
    sess = session(A, USPEC, generator=_gen(), track_residuals=False,
                   refine_iters=16)
    sess.solve()
    sess.update(drifts[0])
    calls = []

    def _wrap(name, orig):
        def wrapper(self, *a, **kw):
            if self.dim() == 0:
                calls.append(name)
            return orig(self, *a, **kw)
        return wrapper

    for name in ("item", "tolist", "numpy", "__int__", "__float__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name,
                            _wrap(name, getattr(torch.Tensor, name)))
    sess.update(drifts[1])
    assert len(calls) <= 1, calls
    monkeypatch.undo()
    assert isinstance(sess.history[-1]["iterations"], int)


# --- tests/test_sketchres.py:242-388 ---------------------------------------

def _sk_lowrank(seed, m, n, r):
    U = torch.randn(m, r, generator=_gen(seed))
    V = torch.randn(n, r, generator=_gen(seed + 500))
    s = torch.logspace(0.0, -2.0, r)
    return (U * s) @ V.T


def _entries(rng, m, n, e, scale=1e-3):
    rows = rng.integers(0, m, e).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    vals = (scale * rng.standard_normal(e)).astype(np.float32)
    return rows, cols, vals


def _drift_step(rng, sess, m, n, e=48, scale=5e-4):
    rows, cols, vals = _entries(rng, m, n, e, scale=scale)
    fact = sess.entries(rows, cols, vals)
    return fact, sess.history[-1]


def test_session_entries_sketch_branch_zero_iterations():
    rng = np.random.default_rng(7)
    m, n = 48, 36
    A = _sk_lowrank(13, m, n, 6)
    sess = Session(A, SVDSpec(method="fsvd", rank=6), generator=_gen(),
                   sketch_tol=5e-3)
    sess.solve()
    kinds = []
    for _ in range(4):
        fact, rec = _drift_step(rng, sess, m, n)
        kinds.append(rec["kind"])
        if rec["kind"] == "sketch":
            assert rec["iterations"] == 0
            assert rec["probe"] <= rec["gate"] == 5e-3
            assert 0.0 < rec["staleness"] < 1.0
    assert kinds.count("sketch") >= 3
    s_true = np.linalg.svd(sess.op.A.double().numpy(), compute_uv=False)[:6]
    err = float(np.max(np.abs(sess.fact.s.double().numpy() - s_true))
                / s_true[0])
    assert err < 5e-3
    assert sess.counts()["sketch"] == kinds.count("sketch")
    assert sess.meta()["sketches"] == kinds.count("sketch")


def test_session_entries_staleness_falls_back_to_real_solve():
    rng = np.random.default_rng(8)
    m, n = 40, 30
    A = _sk_lowrank(14, m, n, 5)
    sess = Session(A, SVDSpec(method="fsvd", rank=5), generator=_gen(),
                   sketch_tol=1e-2)
    sess.solve()
    _drift_step(rng, sess, m, n)
    fact, rec = _drift_step(rng, sess, m, n, e=600, scale=1.0)
    assert rec["kind"] in ("refine", "restart")
    assert rec["sketch_stale"] is True
    assert rec["staleness"] >= 1.0
    assert "probe" not in rec
    assert sess.sketch is not None
    assert float(sess.sketch.folded_mass) == 0.0
    om, _ = sess.sketch.sketches()
    np.testing.assert_allclose(sess.sketch.Y.numpy(),
                               (sess.op.A @ om.dense()).numpy(),
                               rtol=1e-3, atol=1e-3)


def test_session_entries_rejection_annotates_fallback():
    rng = np.random.default_rng(9)
    m, n = 40, 30
    A = _sk_lowrank(15, m, n, 5)
    sess = Session(A, SVDSpec(method="fsvd", rank=5), generator=_gen(),
                   sketch_tol=1e-12)
    sess.solve()
    fact, rec = _drift_step(rng, sess, m, n)
    assert rec["kind"] in ("refine", "restart")
    assert rec["sketch_rejected"] is True
    assert rec["probe"] > rec["gate"] == 1e-12


def test_session_entries_sketch_tol_zero_disables_path():
    rng = np.random.default_rng(10)
    m, n = 32, 24
    A = _sk_lowrank(16, m, n, 4)
    sess = Session(A, SVDSpec(method="fsvd", rank=4), generator=_gen(),
                   sketch_tol=0.0)
    sess.solve()
    for _ in range(2):
        fact, rec = _drift_step(rng, sess, m, n)
        assert rec["kind"] in ("refine", "restart")
    assert sess.sketch is None
    assert "sketch" not in sess.counts()


def test_session_entries_requires_dense_operand():
    U = torch.randn(20, 3, generator=_gen(17))
    Vt = torch.randn(3, 16, generator=_gen(18))
    sess = Session(LowRankOp(U, torch.ones(3), Vt),
                   SVDSpec(method="fsvd", rank=3), generator=_gen())
    with pytest.raises(TypeError, match="dense operand"):
        sess.entries([0], [0], [1.0])
    with pytest.raises(ValueError, match="equal lengths"):
        Session(torch.ones((8, 8)), SVDSpec(method="fsvd", rank=2),
                generator=_gen()).entries([0, 1], [0], [1.0])


def test_session_delta_keeps_resident_sketch_live():
    rng = np.random.default_rng(11)
    m, n = 40, 30
    A = _sk_lowrank(19, m, n, 5)
    sess = Session(A, SVDSpec(method="fsvd", rank=5), generator=_gen(),
                   sketch_tol=1e-2)
    sess.solve()
    _drift_step(rng, sess, m, n)
    U = torch.randn(m, 1, generator=_gen(20))
    Vt = torch.randn(1, n, generator=_gen(21))
    sess.delta(LowRankOp(U, torch.tensor([1e-4]), Vt))
    assert sess.sketch is not None
    om, _ = sess.sketch.sketches()
    np.testing.assert_allclose(sess.sketch.Y.numpy(),
                               (sess.op.A @ om.dense()).numpy(),
                               rtol=1e-3, atol=1e-3)
    sess.update(sess.op.A + 0.0)
    assert sess.sketch is None


def test_accepted_update_and_sketch_records_carry_gate():
    rng = np.random.default_rng(12)
    m, n = 48, 36
    A = _sk_lowrank(22, m, n, 5)
    sess = Session(A, SVDSpec(method="fsvd", rank=5), generator=_gen(),
                   update_tol=1e-3, sketch_tol=5e-3)
    sess.solve()
    U = torch.randn(m, 1, generator=_gen(23))
    Vt = torch.randn(1, n, generator=_gen(24))
    sess.delta(LowRankOp(U, torch.tensor([1e-6]), Vt))
    upd = sess.history[-1]
    assert upd["kind"] == "update"
    assert upd["gate"] == 1e-3 and upd["residual_update"] <= 1e-3
    for _ in range(3):
        fact, rec = _drift_step(rng, sess, m, n, e=32, scale=2e-4)
        if rec["kind"] == "sketch":
            break
    assert rec["kind"] == "sketch"
    assert rec["gate"] == 5e-3 and rec["probe"] <= 5e-3
    hist = sess.meta()["history"]
    json.dumps(hist)
    assert any("gate" in r for r in hist)


def test_spec_rejects_rbk_zero_passes():
    with pytest.raises(ValueError, match="at least one pass"):
        SVDSpec(method="rbk", passes=0)
    SVDSpec(method="rbk", passes=1)
    SVDSpec(method="gnystrom", passes=0)


# --- the residual probe: the reference's value bit for bit -----------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("probes,seed", [(4, 0), (4, 3), (7, 11)])
def test_residual_probe_matches_the_reference_bit_for_bit(dtype, probes,
                                                          seed):
    A = np.array(ZOO["lowrank_noise"][0], dtype=dtype)
    ref_fact = rapi.factorize(jnp.asarray(A), REF_SPEC.replace(rank=4),
                              key=KEY)
    fact = bridge.factorization(ref_fact, device="cpu")
    want = rres.residual_probe(A, ref_fact, probes=probes, seed=seed)
    assert res.residual_probe(A, fact, probes=probes, seed=seed) == want
    assert res.residual_probe(torch.from_numpy(A), fact, probes=probes,
                              seed=seed) == want
    assert 0.0 < want < 1.0


def test_residual_probe_of_a_zero_operand():
    A = np.zeros((12, 9), np.float32)
    fact = factorize(_lowrank(3, 12, 9, 2), SVDSpec(method="fsvd", rank=2),
                     generator=_gen())
    ref = bridge.factorization(fact, device="cpu")
    assert res.residual_probe(A, fact) == rres.residual_probe(
        A, type("F", (), {"U": fact.U.numpy(), "s": fact.s.numpy(),
                          "V": fact.V.numpy()})()) > 0.0
    assert res.residual_probe(A, ref) == res.residual_probe(A, fact)


# --- policy parity: one factorization, both packages' sessions -------------

def _pair(A, spec=REF_SPEC, **knobs):
    """A reference session after its cold solve, and a port session on
    the same operand holding the reference's factorization."""
    ref = rapi.session(jnp.asarray(A), spec, key=KEY, **knobs)
    ref.solve()
    port = session(_t(A), bridge.spec(spec), generator=_gen(), **knobs)
    port.fact = bridge.factorization(ref.fact, device="cpu")
    port._step = ref._step
    return ref, port


def _rank2(A, seed, rel=1e-3):
    m, n = A.shape
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((m, 2)).astype(np.float32)
    Vt = rng.standard_normal((2, n)).astype(np.float32)
    scale = rel * float(np.linalg.norm(A)) / float(np.linalg.norm(U @ Vt))
    s = np.full(2, scale, np.float32)
    return RefLowRankOp(jnp.asarray(U), jnp.asarray(s), jnp.asarray(Vt)), \
        LowRankOp(_t(U), _t(s), _t(Vt))


RESIDUAL_ATOL = 2e-6      # |residual_update(port) − (reference)|, of ‖Σ‖
DRIFT_ATOL = 1e-6         # |sin θ(port) − sin θ(reference)|
PROBE_RTOL = 1e-2         # probes of the same panels, same Ω: at a probe
                          # of ~2.5e-5 the two reconstructions' f32
                          # rounding moves it by ~1e-3 relative


def test_policy_parity_on_a_low_rank_delta():
    A = np.array(make_lowrank(jax.random.PRNGKey(77), M, N, R))
    ref, port = _pair(A)
    rd, pd = _rank2(A, 1)
    ref.delta(rd)
    port.delta(pd)
    r, p = ref.history[-1], port.history[-1]
    assert r["kind"] == p["kind"] == "update"
    assert p["iterations"] == 0
    assert abs(p["residual_update"] - r["residual_update"]) <= RESIDUAL_ATOL
    assert p["gate"] == pytest.approx(r["gate"], rel=1e-3)
    np.testing.assert_allclose(port.fact.s.numpy(), np.asarray(ref.fact.s),
                               rtol=0, atol=1e-5 * float(ref.fact.s[0]))


def test_policy_parity_on_a_rejected_delta():
    A = np.array(ZOO["lowrank_noise"][0])
    ref, port = _pair(A, update_tol=1e-12)
    rd, pd = _rank2(A, 2)
    ref.delta(rd)
    port.delta(pd)
    r, p = ref.history[-1], port.history[-1]
    assert r["kind"] == p["kind"] == "refine"
    assert r["update_rejected"] is p["update_rejected"] is True
    assert abs(p["residual_update"] - r["residual_update"]) <= RESIDUAL_ATOL
    assert abs(p["drift"] - r["drift"]) <= DRIFT_ATOL


@pytest.mark.parametrize("rel,kind", [(1e-3, "refine"), (None, "restart")])
def test_policy_parity_on_a_drifted_operand(rel, kind):
    A = np.array(ZOO["lowrank_noise"][0])
    ref, port = _pair(A)
    if rel is None:
        A2 = np.array(make_lowrank(jax.random.PRNGKey(99), *A.shape, R))
    else:
        G = np.random.default_rng(4).standard_normal(A.shape)
        A2 = (A + rel * np.linalg.norm(A) * G / np.linalg.norm(G)).astype(
            np.float32)
    ref.update(jnp.asarray(A2))
    port.update(_t(A2))
    r, p = ref.history[-1], port.history[-1]
    assert r["kind"] == p["kind"] == kind
    assert abs(p["drift"] - r["drift"]) <= DRIFT_ATOL + 1e-3 * r["drift"]


def test_policy_parity_on_a_downdate():
    A = np.array(make_lowrank(jax.random.PRNGKey(78), M, N, R))
    ref, port = _pair(A)
    ref.downdate(rows=[2, 9, 40])
    port.downdate(rows=[2, 9, 40])
    r, p = ref.history[-1], port.history[-1]
    assert r["kind"] == p["kind"] == "downdate"
    assert abs(p["residual_update"] - r["residual_update"]) <= RESIDUAL_ATOL
    assert torch.equal(port.op.A, _t(ref.op.A))


def test_policy_parity_on_an_entry_batch():
    """The port's session carries the reference's resident sketch (its
    hashed tables through ``bridge``): both reconstruct from the same
    panels, probe with the same Ω and take the sketch branch."""
    m, n = 48, 36
    A = np.array(jax.random.normal(jax.random.PRNGKey(13), (m, 6))
                 @ jax.random.normal(jax.random.PRNGKey(14), (6, n)))
    spec = rapi.SVDSpec(method="fsvd", rank=6)
    ref, port = _pair(A, spec, sketch_tol=5e-3)
    ref.sketch = ref.plan.sketch(ref.op, key=jax.random.PRNGKey(5))
    k, l = ref.sketch.panel_dims
    om = bridge.hashed_sketch(*ref_hashed(ref.sketch.okey, n, k, ZETA), k,
                              device="cpu")
    ps = bridge.hashed_sketch(*ref_hashed(ref.sketch.pkey, m, l, ZETA), l,
                              device="cpu")
    port.sketch = bridge.sketch_state(ref.sketch, om, ps, device="cpu")
    rows, cols, vals = _entries(np.random.default_rng(3), m, n, 48, 5e-4)
    ref.entries(rows, cols, vals)
    port.entries(rows, cols, vals)
    r, p = ref.history[-1], port.history[-1]
    assert r["kind"] == p["kind"] == "sketch"
    assert p["iterations"] == 0
    assert p["probe"] == pytest.approx(r["probe"], rel=PROBE_RTOL)
    assert p["probe"] <= p["gate"] == r["gate"] == 5e-3
    assert p["staleness"] == pytest.approx(r["staleness"], rel=1e-5)
    assert torch.equal(port.op.A, _t(ref.op.A))   # the fold's bits


@pytest.mark.parametrize("name", ["lowrank_noise", "graded"])
def test_learned_sketch_gate_is_the_references(name):
    """The learned gate probes the same factorization against the same
    operand with the same Ω: the reference's value, bit for bit."""
    A = np.array(ZOO[name][0])
    ref, port = _pair(A)
    assert port._sketch_gate() == ref._sketch_gate()
    assert port._ref_probe == ref._ref_probe > 0.0


# --- the refine budget learner ----------------------------------------------

def _traces():
    k = 48
    decay = np.geomspace(1.0, 1e-6, k)
    out = {"gapped": decay, "flat": np.ones(k),
           "collapse_at_0": np.r_[1.0, np.full(k - 1, 1e-4)],
           "late": np.r_[np.ones(40), np.full(k - 40, 1e-3)],
           "zero": np.zeros(k), "empty": np.zeros(0)}
    return {name: t.astype(np.float32) for name, t in out.items()}


@pytest.mark.parametrize("name", sorted(_traces()))
@pytest.mark.parametrize("method", ["gk", "rbk"])
def test_refine_budget_learned_as_the_reference_learns_it(name, method):
    trace = _traces()[name]
    A = np.array(ZOO["lowrank_noise"][0])
    ref = rapi.session(jnp.asarray(A), REF_SPEC, key=KEY)
    port = session(_t(A), SPEC, generator=_gen())
    assert port.refine_iters == ref.refine_iters
    it = np.int32(trace.size)
    ref._learn_refine_iters(RefInfo(jnp.asarray(trace), jnp.asarray(it),
                                    jnp.asarray(False), method=method))
    port._learn_refine_iters(ConvergenceInfo(
        torch.from_numpy(trace), torch.tensor(trace.size),
        torch.tensor(False), method=method))
    assert port.refine_iters == ref.refine_iters
    assert port.refine_plan.spec.max_iters == ref.refine_iters


# --- operand folds and the generator stream --------------------------------

def test_entry_fold_gives_the_reference_bits_with_duplicates():
    """Each coordinate three times, values across ten decades, shuffled:
    the fold sums in entry order, as the reference's scatter-add does on
    the CPU; the caller's operand is untouched."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((30, 20)).astype(np.float32)
    r0 = rng.integers(0, 30, 200).astype(np.int32)
    c0 = rng.integers(0, 20, 200).astype(np.int32)
    order = rng.permutation(600)
    rows, cols = np.tile(r0, 3)[order], np.tile(c0, 3)[order]
    vals = (rng.standard_normal(600)
            * 10.0 ** rng.integers(-8, 3, 600)).astype(np.float32)
    want = np.asarray(jnp.asarray(A).at[rows, cols].add(vals))
    At = _t(A)
    got = fold_entries(At, torch.from_numpy(rows), torch.from_numpy(cols),
                       torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(At, _t(A))


def test_entry_fold_wraps_negative_and_drops_outside_indices():
    A = torch.zeros(4, 3)
    got = fold_entries(A, torch.tensor([-1, 0, 4, 1]),
                       torch.tensor([0, -1, 0, 3]),
                       torch.tensor([1.0, 2.0, 3.0, 4.0]))
    want = torch.zeros(4, 3)
    want[3, 0], want[0, 2] = 1.0, 2.0
    assert torch.equal(got, want)


@pytest.mark.parametrize("beta", [1.0, 0.5])
@pytest.mark.parametrize("fold_bytes", [1 << 30, 4 * 64 * 7])
def test_lowrank_fold_matches_the_whole_drift_fold(beta, fold_bytes,
                                                   monkeypatch):
    """By row blocks (one block, and blocks of 7 rows) against the
    reference's whole-drift fold ``beta · A + materialize_lowrank``.  One
    block gives the port's whole-drift bits; on the CPU a row block's
    product may round otherwise, so blocks are held to f32 rounding (on
    the card: bit for bit, ``tests/test_torch_gpu.py``)."""
    import importlib
    ses = importlib.import_module("repro_torch.api.session")
    monkeypatch.setattr(ses, "_FOLD_BYTES", fold_bytes)
    rng = np.random.default_rng(6)
    A = rng.standard_normal((50, 64)).astype(np.float32)
    U = rng.standard_normal((50, 3)).astype(np.float32)
    s = rng.random(3).astype(np.float32)
    Vt = rng.standard_normal((3, 64)).astype(np.float32)
    L = rng.standard_normal((50, 1)).astype(np.float32)
    Rt = rng.standard_normal((1, 64)).astype(np.float32)
    delta = LowRankOp(_t(U), _t(s), _t(Vt), extra=((_t(L), _t(Rt)),),
                      scale=0.25)
    got = fold_lowrank(_t(A), delta, beta, backend="pallas")
    whole = beta * _t(A) + materialize_lowrank(delta, backend="pallas")
    rd = RefLowRankOp(jnp.asarray(U), jnp.asarray(s), jnp.asarray(Vt),
                      extra=((jnp.asarray(L), jnp.asarray(Rt)),),
                      scale=0.25)
    ref = np.asarray(beta * jnp.asarray(A) + ref_materialize(rd))
    if fold_bytes >= 4 * 50 * 64:
        assert torch.equal(got, whole)
    else:
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_zero_lines_matches_the_reference_and_keeps_the_input():
    A = np.random.default_rng(7).standard_normal((9, 6)).astype(np.float32)
    At = _t(A)
    for dim, idx in ((0, [1, 4, 4]), (1, [0, 5])):
        got = zero_lines(At, idx, dim)
        ref = jnp.asarray(A)
        ref = ref.at[jnp.asarray(idx), :].set(0) if dim == 0 else \
            ref.at[:, jnp.asarray(idx)].set(0)
        assert torch.equal(got, _t(ref))
    assert torch.equal(At, _t(A))


def _stream(seed):
    """One session through every branch; the σ of each step."""
    A = _sk_lowrank(31, 48, 36, 6)
    sess = session(A, SVDSpec(method="fsvd", rank=6, max_iters=24),
                   generator=torch.Generator().manual_seed(seed),
                   sketch_tol=5e-3)
    out = [sess.solve().s]
    out.append(sess.update(_drifted(A, 32, rel=1e-4)).s)
    out.append(sess.delta(_delta(33, m=48, n=36, rel=1e-4,
                                 ref=sess.op.A)).s)
    out.append(sess.downdate(rows=[3, 7]).s)
    rows, cols, vals = _entries(np.random.default_rng(34), 48, 36, 40, 2e-4)
    out.append(sess.entries(rows, cols, vals).s)
    return out, [rec["kind"] for rec in sess.history]


def test_a_rerun_of_the_stream_gives_the_same_bits():
    first, kinds = _stream(5)
    again, kinds2 = _stream(5)
    assert kinds == kinds2 == ["cold", "refine", "update", "downdate",
                               "sketch"]
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_step_generators_follow_the_seed_step_and_tag():
    sess = session(torch.eye(6), SVDSpec(rank=2), generator=_gen(3))
    draws = {}
    for step in (0, 1):
        sess._step = step
        for tag in (0, 1, 2):
            g = sess._next_generator(None, tag)
            draws[step, tag] = torch.randn(4, generator=g)
            assert torch.equal(draws[step, tag], torch.randn(
                4, generator=sess._next_generator(None, tag)))
    values = list(draws.values())
    assert all(not torch.equal(a, b) for i, a in enumerate(values)
               for b in values[i + 1:])
    explicit = _gen(9)
    assert sess._next_generator(explicit) is explicit
