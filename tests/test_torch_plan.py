"""The port's plan layer (``repro_torch.api.plan``) against the reference's.

Mirrors tests/test_plan.py — compile-once (the port counts a trace when a
cache key builds its runner), operator-aware auto resolution, keys by
shape / dtype / kind / device, eager fallbacks, the ConvergenceInfo
channel — less its two ``mesh8`` cases, which wait for the sharded
operator (ROADMAP Queue 1 item 6).  Then the plan-staging cases of
tests/test_update.py:145-175 and tests/test_sketchres.py:202-241, the
rank-k update on bases off orthogonality, σ parity with the reference
for ``solve``, ``estimate`` and ``solve_batched`` (the reference's draws
handed over as ``q1`` / ``q1s``, its pallas backend run as its own tests
run it, bounds ``SOLVERS["fsvd"]["stol"]``), and a cache entry that does
not keep its template operand alive.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
from conftest import make_lowrank
from repro.core.update import update_factorization as ref_update
from repro_torch.api import (Factorization, RecordingCallback, SVDSpec,
                             SinglePassOp, clear_plan_cache, estimate_rank,
                             factorize, factorize_jit, plan,
                             plan_cache_stats, resolve_method, trace_count)
from repro_torch.core.linop import LinOp
from repro_torch.core.operators import (DenseOp, GramOp, KroneckerOp,
                                        LowRankOp, SparseOp)
from repro_torch.core.update import materialize_lowrank
from test_solver_parity import SOLVERS

STOL = SOLVERS["fsvd"]["stol"]


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


def _lowrank(seed, m, n, r):
    return torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(seed),
                                                  m, n, r)))


def _svals(A, r):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)[:r]


@pytest.fixture
def compile_counter():
    """Fresh plan cache + a callable returning traces since fixture setup
    (a trace is one runner build: it cannot tick without a cache miss)."""
    clear_plan_cache()
    base = trace_count()
    return lambda: trace_count() - base


@pytest.fixture(scope="module")
def A():
    return _lowrank(0, 96, 72, 10)


SPEC = SVDSpec(method="fsvd", rank=6, max_iters=24)


def test_compile_once_two_plans(A, compile_counter):
    f1 = plan(SPEC, like=A).solve(A, generator=_gen(1))
    f2 = plan(SPEC, like=A).solve(A, generator=_gen(2))
    assert compile_counter() == 1          # one trace for two plan().solve()
    stats = plan_cache_stats()
    assert stats["hits"] >= 1 and stats["entries"] == 1
    np.testing.assert_allclose(f1.s.numpy(), _svals(A, 6), rtol=1e-3)
    assert f1.s.shape == f2.s.shape


def test_facade_shares_plan_cache(A, compile_counter):
    factorize(A, SPEC, generator=_gen(1))
    factorize(A, SPEC, generator=_gen(2))
    plan(SPEC, like=A).solve(A, generator=_gen(3))
    assert compile_counter() == 1


def test_new_shape_or_spec_stages_new_executable(A, compile_counter):
    plan(SPEC, like=A).solve(A, generator=_gen())
    assert compile_counter() == 1
    B = _lowrank(1, 64, 48, 10)
    plan(SPEC, like=B).solve(B, generator=_gen())        # new shape
    assert compile_counter() == 2
    plan(SPEC.replace(rank=4), like=A).solve(A, generator=_gen())  # new spec
    assert compile_counter() == 3
    # repeats of all three stay cached
    plan(SPEC, like=A).solve(A, generator=_gen())
    plan(SPEC, like=B).solve(B, generator=_gen())
    plan(SPEC.replace(rank=4), like=A).solve(A, generator=_gen())
    assert compile_counter() == 3


def test_operand_kind_keys_cache(A, compile_counter):
    """Same shapes, different operator kind, backend or device -> a
    different entry; values never key."""
    p = plan(SPEC, like=A)
    dense_key = p.operand_key(DenseOp(A))
    pallas_key = p.operand_key(DenseOp(A, backend="pallas"))
    lr = LowRankOp(torch.ones(96, 2), torch.ones(2), torch.ones(2, 72))
    assert dense_key != pallas_key            # backend is static
    assert dense_key != p.operand_key(lr)
    assert dense_key == p.operand_key(DenseOp(A + 1.0))   # values don't key
    assert dense_key != p.operand_key(DenseOp(A.to("meta")))  # devices do
    assert dense_key != p.operand_key(DenseOp(A.double()))


def test_sparse_shape_keys_cache(compile_counter):
    """``spshape`` is static, as in the reference: two sparse operands
    with the same nnz and dtype but different shapes take two traces."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(np.stack([rng.integers(0, 40, 300),
                                     rng.integers(0, 30, 300)], 1))
    vals = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    spec = SVDSpec(method="fsvd", rank=4, max_iters=12)
    p = plan(spec)
    a, b = SparseOp(vals, idx, (40, 30)), SparseOp(vals, idx, (48, 30))
    assert p.operand_key(a) != p.operand_key(b)
    assert p.operand_key(a) == p.operand_key(SparseOp(vals + 1, idx,
                                                      (40, 30)))
    p.solve(a, generator=_gen(1))
    p.solve(b, generator=_gen(1))
    assert compile_counter() == 2
    p.solve(a, generator=_gen(2))
    assert compile_counter() == 2


def test_warm_start_q1_structure_keys_cache(A, compile_counter):
    p = plan(SPEC, like=A)
    f = p.solve(A, generator=_gen())
    assert compile_counter() == 1
    p.solve(A, q1=f.warm_start())              # q1 present: new structure
    assert compile_counter() == 2
    p.solve(A, q1=f.warm_start())
    assert compile_counter() == 2


def test_host_loop_spec_falls_back_eager(A, compile_counter):
    spec = SPEC.replace(host_loop=True)
    f = plan(spec, like=A).solve(A, generator=_gen())
    assert compile_counter() == 0              # never staged
    assert not plan(spec, like=A).staged
    np.testing.assert_allclose(f.s.numpy(), _svals(A, 6), rtol=1e-3)


def test_legacy_linop_falls_back_eager(A, compile_counter):
    op = LinOp(shape=tuple(A.shape), mv=lambda p: A @ p,
               rmv=lambda q: A.T @ q, device="cpu")
    f = plan(SPEC, like=op).solve(op, generator=_gen())
    assert compile_counter() == 0
    np.testing.assert_allclose(f.s.numpy(), _svals(A, 6), rtol=1e-3)


def test_factorize_jit_handles_share_one_executable(A, compile_counter):
    fn1 = factorize_jit(SPEC)
    fn2 = factorize_jit(SPEC)
    q1 = torch.ones(A.shape[0])
    o1 = fn1(A, _gen(), q1)
    o2 = fn2(A, _gen(), q1)
    assert compile_counter() == 1
    np.testing.assert_allclose(o1.s.numpy(), o2.s.numpy())
    with pytest.raises(ValueError, match="host-side loop"):
        factorize_jit(SPEC.replace(host_loop=True))


def test_estimate_rank_ingraph_shares_cache(A, compile_counter):
    spec = SVDSpec(host_loop=False, max_iters=40)
    e1 = estimate_rank(A, spec, generator=_gen(1))
    e2 = estimate_rank(A, spec, generator=_gen(2))
    assert compile_counter() == 1
    assert int(e1.rank) == int(e2.rank) == 10


def test_with_info_and_callback(A, compile_counter):
    p = plan(SPEC, like=A)
    cb = RecordingCallback()
    fact, info = p.solve(A, generator=_gen(), with_info=True, callback=cb)
    assert info.residuals.shape == (24,)       # per-iteration betas
    assert int(info.iterations) == int(fact.iterations)
    assert bool(info.breakdown) == bool(fact.breakdown)
    assert cb.info is not None
    # host-loop path delivers per-step scalars through the same protocol
    cb2 = RecordingCallback()
    factorize(A, SPEC.replace(host_loop=True), generator=_gen(),
              callback=cb2)
    assert len(cb2.steps) > 0
    assert all("beta" in m for _, m in cb2.steps)
    assert cb2.info is not None and cb2.info.method == "gk"


def test_auto_resolution_operator_aware(A):
    loose = SVDSpec(method="auto", tol=1e-2)
    # dense heuristic unchanged (spec-only view stays backward compatible)
    assert resolve_method(loose) == "rsvd"
    assert resolve_method(SVDSpec(method="auto")) == "fsvd"
    assert resolve_method(SVDSpec(method="auto", power_iters=2)) == "rsvd"
    # sparse / Gram / Kronecker operands never take the dense-only branch
    sp = SparseOp.fromdense(torch.eye(8))
    assert resolve_method(loose, sp) == "fsvd_blocked"
    assert resolve_method(loose, GramOp(DenseOp(A))) == "fsvd_blocked"
    assert resolve_method(loose, sp.T) == "fsvd_blocked"
    kron = KroneckerOp(DenseOp(torch.eye(4)), DenseOp(torch.eye(5)))
    assert resolve_method(SVDSpec(method="auto", power_iters=3),
                          kron) == "fsvd_blocked"
    # plain dense operands keep the tol/power-iters trade-off heuristic
    assert resolve_method(loose, DenseOp(A)) == "rsvd"
    assert resolve_method(SVDSpec(method="auto"), DenseOp(A)) == "fsvd"
    # auto factorize on a sparse operand runs the blocked solver
    out = factorize(sp, SVDSpec(method="auto", rank=3, tol=1e-2),
                    generator=_gen())
    assert out.method == "fsvd_blocked"


def test_auto_resolution_normalizes_non_operators(A):
    """A non-operator with a ``mv`` of its own is normalized through
    ``as_operator`` first, so operand-aware routing sees the real operator
    kind.  A torch tensor is such an operand: ``Tensor.mv`` is the
    matrix-vector product, unrelated to the operator protocol (no
    ``rmv``), so a dense tensor takes the dense heuristic and a sparse
    COO tensor the blocked solver, as the reference routes the same
    arrays."""
    assert hasattr(A, "mv") and not hasattr(A, "rmv")
    loose = SVDSpec(method="auto", tol=1e-2)
    assert resolve_method(loose, A) == "rsvd"
    assert resolve_method(SVDSpec(method="auto"), A) == "fsvd"
    assert rapi.resolve_method(rapi.SVDSpec(method="auto", tol=1e-2),
                               A.numpy()) == "rsvd"
    sp = torch.eye(8).to_sparse()
    assert hasattr(sp, "mv")
    assert resolve_method(loose, sp) == "fsvd_blocked"


def test_auto_resolution_single_pass_hint(A):
    """Operators flagged single_pass_only route to the one-sweep solver
    before any other operand-aware branch."""
    op = SinglePassOp(DenseOp(A))
    assert resolve_method(SVDSpec(method="auto"), op) == "gnystrom"
    # the hint outranks the loose-tol dense heuristic too
    assert resolve_method(SVDSpec(method="auto", tol=1e-2),
                          op) == "gnystrom"
    out = factorize(op, SVDSpec(method="auto", rank=4), generator=_gen())
    assert out.method == "gnystrom"
    np.testing.assert_allclose(out.s.numpy(), _svals(A, 4), rtol=1e-2)


def test_compile_once_sketch_solvers(A, compile_counter):
    """rbk and gnystrom go through the plan cache with the same
    compile-once contract as fsvd/rsvd: two solves, one trace each."""
    rbk_spec = SVDSpec(method="rbk", rank=6, passes=3)
    gny_spec = SVDSpec(method="gnystrom", rank=6)
    f1 = plan(rbk_spec, like=A).solve(A, generator=_gen(1))
    f2 = plan(rbk_spec, like=A).solve(A, generator=_gen(2))
    assert compile_counter() == 1
    g1 = plan(gny_spec, like=A).solve(A, generator=_gen(1))
    g2 = plan(gny_spec, like=A).solve(A, generator=_gen(2))
    assert compile_counter() == 2
    for f in (f1, f2, g1, g2):
        np.testing.assert_allclose(f.s.numpy(), _svals(A, 6), rtol=1e-2)


def test_warm_start_stays_compute_dtype_under_bf16(A):
    """bf16 storage must not leak into the warm-start seam: the blocked
    solver keeps its locked U half-width, and a q1 inheriting that dtype
    would seed the next solve's CGS2 at the bf16 noise floor."""
    out = factorize(A, SVDSpec(method="fsvd_blocked", rank=4,
                               precision="bf16"), generator=_gen())
    assert out.U.dtype == torch.bfloat16      # storage stays narrow
    q1 = out.warm_start()
    assert q1.dtype == torch.float32          # the blend must not
    # and the warm-started follow-up accepts it
    nxt = factorize(A, SVDSpec(method="fsvd", rank=4, max_iters=16), q1=q1)
    assert nxt.s.shape == (4,)


# --------------------------------------------------------------------------
# what the port's cache holds
# --------------------------------------------------------------------------

def test_cache_entry_does_not_keep_its_template_operand():
    """A runner closes over (solver, spec, method) only: the plan's
    ``like`` tensor dies with its last outside reference while the cache
    entry stays."""
    clear_plan_cache()
    T = _lowrank(5, 80, 60, 6)
    ref = weakref.ref(T)
    p = plan(SPEC, like=T)
    p.solve(generator=_gen())
    p.update(factorize(T, SPEC, generator=_gen()),
             LowRankOp(torch.ones(80, 1), torch.ones(1), torch.ones(1, 60)))
    assert plan_cache_stats()["entries"] == 2
    del T, p
    gc.collect()
    assert ref() is None
    assert plan_cache_stats()["entries"] == 2


def test_stacked_operands_take_solve_batched_only(A):
    stacked = torch.stack([A, A])
    p = plan(SPEC)
    with pytest.raises(ValueError, match="solve_batched"):
        p.solve(stacked, generator=_gen())
    with pytest.raises(ValueError, match="generators"):
        p.solve_batched(stacked)                  # no generators, no q1s
    with pytest.raises(ValueError, match="stacked DenseOp"):
        p.solve_batched(A, generators=[_gen()])
    with pytest.raises(ValueError, match="host-side loop"):
        plan(SPEC.replace(host_loop=True)).solve_batched(
            stacked, generators=[_gen(), _gen()])
    op = DenseOp(stacked)
    assert op.batch == 2 and op.shape == tuple(A.shape)
    assert DenseOp(A).batch is None


def test_failpoint_fires_before_any_work(A, compile_counter):
    from repro_torch.runtime import faults
    with faults.inject(faults.PLAN_SOLVE, mode="raise"):
        with pytest.raises(faults.FaultInjected):
            plan(SPEC, like=A).solve(A, generator=_gen())
        with pytest.raises(faults.FaultInjected):
            plan(SPEC).solve_batched(torch.stack([A]), generators=[_gen()])
    assert compile_counter() == 0
    assert not faults.armed(faults.PLAN_SOLVE)


# --------------------------------------------------------------------------
# plan staging: the rank-k update (tests/test_update.py:145-175)
# --------------------------------------------------------------------------

GATE = 1e-5


def _sigma_err(fact, dense):
    s = _svals(dense, fact.rank)
    return np.max(np.abs(fact.s.numpy().astype(np.float64) - s)) / s[0]


def _exact(m=60, n=48, r=8, seed=0):
    """An exact rank-r operand and the spec that recovers it."""
    return _lowrank(seed, m, n, r)


def _delta(seed, m=60, n=48, k=2, scale=1e-2, ref=None):
    g = _gen(seed)
    C = torch.randn(m, k, generator=g)
    Dt = torch.randn(k, n, generator=g)
    s = scale * float(torch.linalg.matrix_norm(ref, 2)) \
        * torch.linspace(1.0, 0.5, k)
    return LowRankOp(C / m ** 0.5, s, Dt / n ** 0.5)


UPDATE_SPEC = SVDSpec(method="fsvd", rank=12, max_iters=40)


def test_plan_update_compiles_once_across_deltas_and_betas():
    """One runner covers every same-signature delta and every beta."""
    A = _exact()
    p = plan(UPDATE_SPEC, like=A)
    fact = factorize(A, UPDATE_SPEC, generator=_gen())
    clear_plan_cache()
    base = trace_count()
    for t, beta in enumerate((1.0, 0.9, 1.0, 0.5)):
        d = _delta(30 + t, ref=A)
        upd = p.update(fact, d, beta=beta)
        A2 = beta * A + materialize_lowrank(d)
        assert _sigma_err(upd, A2) <= GATE
        assert int(upd.iterations) == 0
    assert trace_count() - base == 1
    clear_plan_cache()


def test_plan_update_rejects_non_lowrank_delta():
    A = _exact()
    p = plan(UPDATE_SPEC, like=A)
    fact = factorize(A, UPDATE_SPEC, generator=_gen())
    with pytest.raises(TypeError):
        p.update(fact, torch.ones_like(A))


def _skewed_bases(rng, m, n, r, off):
    """Orthonormal bases moved ``off`` (in ‖·‖ per column) off
    orthogonality, as an f32 F-SVD's V drifts at scale."""
    U = np.linalg.qr(rng.standard_normal((m, r)))[0]
    V = np.linalg.qr(rng.standard_normal((n, r)))[0]
    U = U + off * rng.standard_normal((m, r)) / np.sqrt(m)
    V = V + off * rng.standard_normal((n, r)) / np.sqrt(n)
    return U, V


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("off", [1e-4, 0.0])
def test_update_on_bases_off_orthogonality(backend, off):
    """The port thin-QRs the bases before Brand's update: on bases 1e-4
    off orthogonality its σ is within 1e-6·σ_max of the exact σ of the
    factored operator, where the reference's (which assumes orthonormal
    bases) is not; on orthonormal bases both hold the reference's GATE."""
    rng = np.random.default_rng(3)
    m, n, r, k, beta = 120, 90, 8, 3, 0.9
    U, V = _skewed_bases(rng, m, n, r, off)
    s = np.linspace(10.0, 1.0, r)
    C, Dt = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    sd = np.array([0.5, 0.3, 0.2])
    s_exact = _svals(beta * (U * s) @ V.T + (C * sd) @ Dt, r)
    f32 = [np.asarray(x, np.float32) for x in (U, s, V, C, sd, Dt)]
    t = [torch.from_numpy(x) for x in f32]
    fact = Factorization(t[0], t[1], t[2], torch.tensor(0),
                         torch.tensor(False))
    got = plan(SVDSpec(method="fsvd", rank=r, backend=backend)).update(
        fact, LowRankOp(t[3], t[4], t[5]), beta=beta)
    j = [jnp.asarray(x) for x in f32]
    want = ref_update(rapi.Factorization(j[0], j[1], j[2], jnp.asarray(0),
                                         jnp.asarray(False)),
                      rapi.LowRankOp(j[3], j[4], j[5]), beta=beta,
                      backend=backend)
    err = np.max(np.abs(got.s.numpy() - s_exact)) / s_exact[0]
    ref_err = np.max(np.abs(np.asarray(want.s) - s_exact)) / s_exact[0]
    if off:
        assert err < 1e-6 < ref_err
    else:
        assert err < GATE and ref_err < GATE
        assert np.max(np.abs(got.s.numpy() - np.asarray(want.s))) \
            / s_exact[0] < GATE


# --------------------------------------------------------------------------
# plan staging: the sketch-resident state (tests/test_sketchres.py:202-241)
# --------------------------------------------------------------------------

SK_SPEC = SVDSpec(method="gnystrom", rank=6, oversample=8)


def _entries(rng, m, n, e, scale=1e-3):
    rows = rng.integers(0, m, e).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    vals = (scale * rng.standard_normal(e)).astype(np.float32)
    return (torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(vals))


def test_plan_sketch_fold_stages_per_padded_length():
    clear_plan_cache()
    rng = np.random.default_rng(6)
    A = _lowrank(11, 40, 32, 5)
    p = plan(SK_SPEC, like=DenseOp(A))
    st = p.sketch(A, generator=_gen(3))
    t0 = trace_count()
    for e in (10, 20, 33, 60):                      # all pad to 64
        st = p.sketch_fold(st, *_entries(rng, 40, 32, e))
    assert trace_count() - t0 == 1                  # one padded length
    st = p.sketch_fold(st, *_entries(rng, 40, 32, 100))   # pads to 128
    assert trace_count() - t0 == 2
    f1 = p.sketch_reconstruct(st)
    t1 = trace_count()
    f2 = p.sketch_reconstruct(st)
    assert trace_count() == t1                      # cached runner
    assert int(f1.iterations) == int(f2.iterations) == 0
    d = p.sketch_fold_delta(st, LowRankOp(torch.ones(40, 1), torch.ones(1),
                                          torch.ones(1, 32)))
    t2 = trace_count()
    p.sketch_fold_delta(d, LowRankOp(torch.ones(40, 1), torch.ones(1),
                                     torch.ones(1, 32)))
    assert trace_count() == t2


def test_plan_sketch_memoizes_per_operand_signature():
    clear_plan_cache()
    A = _lowrank(12, 40, 32, 5)
    p = plan(SK_SPEC, like=DenseOp(A))
    p.sketch(A, generator=_gen(3))
    t0 = trace_count()
    p.sketch(A + 1.0, generator=_gen(99))           # same signature
    assert trace_count() == t0


# --------------------------------------------------------------------------
# parity with the reference's plan
# --------------------------------------------------------------------------

def _q1s(B, m, seed=0):
    return (2.0 + np.random.default_rng(seed).standard_normal((B, m))
            ).astype(np.float32)


PARITY_SPEC = dict(method="fsvd", rank=5, max_iters=30)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_plan_solve_and_estimate_match_reference(backend):
    A = np.array(make_lowrank(jax.random.PRNGKey(21), 90, 70, 8))
    s_true = _svals(A, 8)
    q1 = _q1s(1, 90)[0]
    rspec = rapi.SVDSpec(backend=backend, **PARITY_SPEC)
    want = rapi.plan(rspec, like=jnp.asarray(A)).solve(
        jnp.asarray(A), q1=jnp.asarray(q1))
    got = plan(SVDSpec(backend=backend, **PARITY_SPEC),
               like=torch.from_numpy(A)).solve(q1=torch.from_numpy(q1))
    assert np.max(np.abs(got.s.numpy() - np.asarray(want.s))) \
        / s_true[0] < STOL
    assert np.max(np.abs(got.s.numpy() - s_true[:5])) / s_true[0] < STOL
    espec = dict(max_iters=40, host_loop=False, backend=backend)
    r_est = rapi.plan(rapi.SVDSpec(**espec), like=jnp.asarray(A)).estimate(
        key=jax.random.PRNGKey(0))
    t_est = plan(SVDSpec(**espec), like=torch.from_numpy(A)).estimate(
        generator=_gen())
    assert int(t_est.rank) == int(r_est.rank) == 8


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_solve_batched_matches_reference(backend):
    """B = 3 stacked operands through ``solve_batched`` on both packages
    (the reference's jit(vmap(run)), its pallas kernels in interpret
    mode): σ per example within stol of the reference's, of the exact σ
    and of the port's own single solve with the same q1; the fields carry
    the batch dimension."""
    B, m, n = 3, 80, 60
    As = np.stack([np.array(make_lowrank(jax.random.PRNGKey(40 + b), m, n,
                                         6 + b)) for b in range(B)])
    q1s = _q1s(B, m, 1)
    rspec = rapi.SVDSpec(backend=backend, **PARITY_SPEC)
    want, winfo = rapi.plan(rspec).solve_batched(
        rapi.DenseOp(jnp.asarray(As), backend=backend),
        q1s=jnp.asarray(q1s), with_info=True)
    spec = SVDSpec(backend=backend, **PARITY_SPEC)
    clear_plan_cache()
    t0 = trace_count()
    got, info = plan(spec).solve_batched(
        DenseOp(torch.from_numpy(As), backend=backend),
        q1s=torch.from_numpy(q1s), with_info=True)
    plan(spec).solve_batched(torch.from_numpy(As) + 1.0,
                             q1s=torch.from_numpy(q1s))
    assert trace_count() - t0 == 1
    assert got.U.shape == (B, m, 5) and got.V.shape == (B, n, 5)
    assert got.s.shape == (B, 5) and got.iterations.shape == (B,)
    assert info.residuals.shape == np.asarray(winfo.residuals).shape
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    for b in range(B):
        s_true = _svals(As[b], 5)
        one = plan(spec).solve(torch.from_numpy(As[b]),
                               q1=torch.from_numpy(q1s[b]))
        for other in (np.asarray(want.s[b]), s_true, one.s.numpy()):
            assert np.max(np.abs(got.s[b].numpy() - other)) \
                / s_true[0] < STOL


def test_solve_batched_sketch_methods_run_example_by_example():
    """rsvd runs its examples one after another inside the runner, each
    from its own generator: example b is the single solve from that
    generator, bit for bit."""
    As = torch.stack([_lowrank(50 + b, 60, 40, 4) for b in range(2)])
    spec = SVDSpec(method="rsvd", rank=4)
    got = plan(spec).solve_batched(As, generators=[_gen(1), _gen(2)])
    assert got.method == "rsvd" and got.s.shape == (2, 4)
    for b, seed in enumerate((1, 2)):
        one = plan(spec).solve(As[b], generator=_gen(seed))
        assert torch.equal(got.s[b], one.s)
