"""The port's sketch and blocked solvers (rsvd, rbk, gnystrom, fsvd_blocked)
against the reference package on the CPU.

Operands are the differential zoo of tests/test_solver_parity.py.  Torch
cannot reproduce JAX's draws, so the random test matrices are drawn on the
JAX side with the same key split the reference solver makes for
``factorize(..., key=PRNGKey(7))`` — rsvd ``normal(key, (n, l))``, rbk
``make_sketch(key, n, b)``, gnystrom ``split(key)`` into two
``make_sketch`` calls, fsvd_blocked the first block ``normal(k0, (n, b))``
after ``split(key)`` — carried over with ``repro_torch.bridge`` and handed
to the port's solvers.  The registered solvers are also run through
``factorize`` with a seeded ``torch.Generator`` (the port's own draws).

Bounds are the reference's own: ``SOLVERS[method]["stol"]``·σ_max against
dense SVD and against the reference's σ, ``BF16_STOL`` with bf16 storage,
and the principal-cosine floors of ``test_subspace_parity``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
from conftest import make_lowrank
from repro.core.gk import _store_dtype as ref_store_dtype
from repro.core.sketch import make_sketch as ref_make_sketch
from repro_torch import bridge
from repro_torch.api import (CaptureCallback, SinglePassOp, SVDSpec,
                             factorize, resolve_method)
from repro_torch.core import gk_block, rsvd as trsvd, sketch as tsketch
from repro_torch.core.operators import DenseOp, Operator, as_operator
from repro_torch.kernels import sketch_matvec as skm
from test_solver_parity import BF16_STOL, R, SOLVERS, ZOO

METHODS = ["rsvd", "rbk", "gnystrom", "fsvd_blocked"]
# the backend reaches the kernels only through the sketch apply
BACKENDS = {"rsvd": ["xla"], "fsvd_blocked": ["xla"],
            "rbk": ["xla", "pallas"], "gnystrom": ["xla", "pallas"]}
CASES = [(m, b) for m in METHODS for b in BACKENDS[m]]
KEY = 7


def _spec(method, precision=None, backend="xla"):
    return SVDSpec(method=method, rank=R, precision=precision,
                   backend=backend, **SOLVERS[method]["spec"])


def _reference(method, A, precision=None, key=KEY):
    spec = rapi.SVDSpec(method=method, rank=R, precision=precision,
                        **SOLVERS[method]["spec"])
    return rapi.factorize(jnp.asarray(A), spec, key=jax.random.PRNGKey(key))


def _port(method, A, precision=None, backend="xla", key=KEY):
    """The port's solver on the reference's own test matrices, with the
    arguments the registered solver maps from the spec."""
    spec = _spec(method, precision, backend)
    m, n = A.shape
    At = torch.from_numpy(np.asarray(A))
    k = jax.random.PRNGKey(key)
    jstore = ref_store_dtype(precision, jnp.float32)
    if method == "rsvd":
        l = min(R + spec.oversample, min(m, n))
        omega = np.asarray(jax.random.normal(k, (n, l), jnp.float32))
        return trsvd.rsvd(At, R, p=spec.oversample,
                          power_iters=spec.power_iters, omega=omega,
                          precision=precision)
    if method == "rbk":
        b = min(spec.sketch_dim or (R + spec.oversample), min(m, n))
        sk = ref_make_sketch(k, n, b, dtype=jstore)
        return tsketch.rbk(At, R, passes=spec.passes,
                           sketch_dim=spec.sketch_dim,
                           sketch=bridge.sketch(sk, backend=backend,
                                                device="cpu"),
                           precision=precision, backend=backend)
    if method == "gnystrom":
        kk, ll = tsketch._panel_dims(R, spec.oversample, spec.sketch_dim,
                                     m, n)
        ko, kp = jax.random.split(k)
        om = ref_make_sketch(ko, n, kk, dtype=jstore)
        ps = ref_make_sketch(kp, m, ll, dtype=jstore)
        return tsketch.gnystrom(
            At, R, sketch_dim=spec.sketch_dim,
            omega=bridge.sketch(om, backend=backend, device="cpu"),
            psi=bridge.sketch(ps, backend=backend, device="cpu"),
            precision=precision, backend=backend)
    _, b, _ = gk_block.blocked_dims(R, spec.block_size, spec.max_basis,
                                    m, n)
    _, k0 = jax.random.split(k)
    start = np.asarray(jax.random.normal(k0, (n, b), jnp.float32))
    return gk_block.fsvd_blocked(At, R, block=spec.block_size,
                                 max_basis=spec.max_basis, tol=spec.tol,
                                 start=start, precision=precision,
                                 generator=torch.Generator().manual_seed(0))


def _s_true(A):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)


def _err(s, s_ref, smax):
    s = s.float().numpy() if isinstance(s, torch.Tensor) else \
        np.asarray(s, np.float32)
    return np.max(np.abs(s.astype(np.float64)
                         - np.asarray(s_ref, np.float64)[:len(s)])) / smax


@pytest.mark.parametrize("name", sorted(ZOO))
@pytest.mark.parametrize("method,backend", CASES)
def test_singular_values_match_reference(method, backend, name):
    A = np.array(ZOO[name][0])
    s_true = _s_true(A)
    stol = SOLVERS[method]["stol"]
    got = _port(method, A, backend=backend)
    ref = _reference(method, A)
    assert got.s.shape == (R,) and got.U.shape == (A.shape[0], R)
    assert got.V.shape == (A.shape[1], R)
    assert _err(got.s, s_true, s_true[0]) < stol
    assert _err(got.s, ref.s, s_true[0]) < stol
    # the registered solver on the port's own draws
    out = factorize(torch.from_numpy(A), _spec(method, backend=backend),
                    generator=torch.Generator().manual_seed(1))
    assert out.method == method
    assert _err(out.s, s_true, s_true[0]) < stol


@pytest.mark.parametrize("name", sorted(ZOO))
@pytest.mark.parametrize("method", METHODS)
def test_singular_values_match_reference_bf16(method, name):
    """bf16-stored bases, f32 accumulation, against dense SVD and the
    reference.  bf16 rbk is held against the reference run eagerly (it
    cannot run jitted on this jax), not against dense SVD: on
    lowrank_noise its Ritz values overshoot σ_max by a rounding-driven
    amount that straddles BF16_STOL["rbk"] in both packages (ROADMAP.md
    Queue 3)."""
    A = np.array(ZOO[name][0])
    s_true = _s_true(A)
    bound = BF16_STOL[method]
    got = _port(method, A, precision="bf16")
    if method == "rbk":
        with jax.disable_jit():
            ref = _reference(method, A, precision="bf16")
    else:
        assert _err(got.s, s_true, s_true[0]) < bound
        ref = _reference(method, A, precision="bf16")
    assert _err(got.s, ref.s, s_true[0]) < bound


@pytest.mark.parametrize("name", [n for n in sorted(ZOO) if ZOO[n][1]])
@pytest.mark.parametrize("method", METHODS)
def test_subspace_parity(method, name):
    """Where the spectrum has a gap at R, the right subspace aligns with
    the dense-SVD one and with the reference's (test_subspace_parity)."""
    A = np.array(ZOO[name][0])
    Vt = np.linalg.svd(np.asarray(A, np.float64))[2]
    got = _port(method, A, key=11).V.double().numpy()
    ref = np.asarray(_reference(method, A, key=11).V, np.float64)
    floor = 0.99 if method == "rsvd" else 0.9999
    for basis in (Vt[:R].T, ref):
        cos = np.linalg.svd(basis.T @ got, compute_uv=False)
        assert cos.min() > floor, (method, name, cos.min())


# --------------------------------------------------------------------------
# pass budgets (tests/test_solver_parity.py:460-500)
# --------------------------------------------------------------------------

class _PassCountGuard(Operator):
    """Counts operator touches: each mv / rmv / matmat / rmatmat is one
    sweep, and a fused ``sketch_pass`` is ONE sweep.  Overrunning the
    budget raises inside the solver."""

    def __init__(self, inner, budget):
        self._inner = inner
        self.budget = budget
        self.counts = {"mv": 0, "rmv": 0, "matmat": 0, "rmatmat": 0,
                       "sketch_pass": 0}

    shape = property(lambda self: self._inner.shape)
    dtype = property(lambda self: self._inner.dtype)
    device = property(lambda self: self._inner.device)

    def _tick(self, kind):
        self.counts[kind] += 1
        assert sum(self.counts.values()) <= self.budget, self.counts

    def mv(self, p):
        self._tick("mv")
        return self._inner.mv(p)

    def rmv(self, q):
        self._tick("rmv")
        return self._inner.rmv(q)

    def matmat(self, V):
        self._tick("matmat")
        return self._inner.matmat(V)

    def rmatmat(self, Q):
        self._tick("rmatmat")
        return self._inner.rmatmat(Q)

    def sketch_pass(self, omega, psi):
        self._tick("sketch_pass")
        return self._inner.sketch_pass(omega, psi)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gnystrom_touches_operator_exactly_once(backend):
    A = np.array(make_lowrank(jax.random.PRNGKey(21), 120, 96, R))
    guard = _PassCountGuard(
        as_operator(torch.from_numpy(A), backend=backend), budget=1)
    out = factorize(guard, SVDSpec(method="gnystrom", rank=R,
                                   backend=backend),
                    generator=torch.Generator().manual_seed(7))
    assert guard.counts["sketch_pass"] == 1
    assert sum(guard.counts.values()) == 1, guard.counts
    s_true = _s_true(A)
    assert _err(out.s, s_true, s_true[0]) < 1e-3


def test_rbk_respects_pass_budget():
    passes = 3
    A = np.array(make_lowrank(jax.random.PRNGKey(22), 120, 96, R))
    guard = _PassCountGuard(as_operator(torch.from_numpy(A)),
                            budget=2 * passes + 1)
    cb = CaptureCallback()
    out = factorize(guard, SVDSpec(method="rbk", rank=R, passes=passes,
                                   sketch_dim=16),
                    generator=torch.Generator().manual_seed(7), callback=cb)
    assert guard.counts["matmat"] == passes + 1
    assert guard.counts["rmatmat"] == passes
    assert guard.counts["sketch_pass"] == 0
    assert int(out.iterations) == 2 * passes + 1
    assert cb.info.method == "rbk" and int(cb.info.iterations) == 7
    s_true = _s_true(A)
    assert _err(out.s, s_true, s_true[0]) < 1e-4


@pytest.mark.parametrize("sketch_dim", [8, 10])
def test_rbk_range_comes_from_the_krylov_blocks(sketch_dim):
    """The sketch block's own columns add no dimension of the operand's
    range (their null-space parts cannot cancel), so rbk captures a
    rank-20 range only when passes·sketch_dim ≥ 20: at 2·8 its Ritz values
    miss on a clustered spectrum, at 2·10 they are exact — in both
    packages, which agree on the same sketch."""
    rng = np.random.default_rng(0)
    U = np.linalg.qr(rng.standard_normal((200, 20)))[0]
    V = np.linalg.qr(rng.standard_normal((150, 20)))[0]
    s = 1.0 + 0.1 * np.linspace(1.0, 0.0, 20)
    A = ((U * s) @ V.T).astype(np.float32)
    sk = ref_make_sketch(jax.random.PRNGKey(1), 150, sketch_dim)
    got = tsketch.rbk(torch.from_numpy(A), R, passes=2,
                      sketch_dim=sketch_dim,
                      sketch=bridge.sketch(sk, device="cpu"))
    ref = rapi.factorize(jnp.asarray(A), rapi.SVDSpec(
        method="rbk", rank=R, passes=2, sketch_dim=sketch_dim),
        key=jax.random.PRNGKey(1))
    assert _err(got.s, ref.s, s[0]) < 1e-4
    err = _err(got.s, s, s[0])
    if sketch_dim * 2 >= 20:
        assert err < 1e-4
    else:
        assert err > SOLVERS["rbk"]["stol"]


def test_rbk_clamps_passes_to_the_space():
    """q_eff caps the basis at min(m, n) columns: 2·q_eff + 1 sweeps."""
    A = torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(2),
                                               60, 40, 5)))
    out = tsketch.rbk(A, 5, passes=9, sketch_dim=16,
                      generator=torch.Generator().manual_seed(0))
    assert int(out.passes) == 2 * ((40 - 16) // 16) + 1


# --------------------------------------------------------------------------
# facade, sketches, callbacks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(tol=1e-3), dict(power_iters=2),
                                dict(method="rbk"), dict(tol=1e-5)])
def test_resolve_method_matches_reference(kw):
    """Dense and SinglePassOp operands resolve as in repro.api.plan."""
    from repro.core.operators import DenseOp as RefDenseOp
    from repro.core.operators import SinglePassOp as RefSinglePassOp
    A = np.zeros((20, 10), np.float32)
    dense = DenseOp(torch.from_numpy(A))
    for port_op, ref_op in ((dense, RefDenseOp(jnp.asarray(A))),
                            (SinglePassOp(dense),
                             RefSinglePassOp(RefDenseOp(jnp.asarray(A))))):
        want = rapi.resolve_method(rapi.SVDSpec(**kw), ref_op)
        assert resolve_method(SVDSpec(**kw), port_op) == want
    assert resolve_method(SVDSpec(), SinglePassOp(dense)) == "gnystrom"


def test_single_pass_operand_runs_gnystrom_through_one_sweep():
    A = np.array(make_lowrank(jax.random.PRNGKey(4), 80, 60, 6))
    op = SinglePassOp(DenseOp(torch.from_numpy(A), backend="pallas"))
    assert op.shape == (80, 60) and op.T.shape == (60, 80)
    assert op.T.single_pass_only
    guard = _PassCountGuard(op, budget=1)
    guard.single_pass_only = True
    out = factorize(guard, SVDSpec(rank=4, sketch_dim=24),
                    generator=torch.Generator().manual_seed(0))
    assert out.method == "gnystrom" and guard.counts["sketch_pass"] == 1
    s_true = _s_true(A)
    assert _err(out.s, s_true, s_true[0]) < 1e-3


@pytest.mark.parametrize("method", METHODS)
def test_convergence_info_names_the_method(method):
    A = torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(5),
                                               50, 40, 4)))
    cb = CaptureCallback()
    out = factorize(A, SVDSpec(method=method, rank=3),
                    generator=torch.Generator().manual_seed(0), callback=cb)
    assert out.method == cb.info.method == method
    assert int(cb.info.iterations) == int(out.iterations)
    ref_cb = rapi.CaptureCallback()
    rapi.factorize(jnp.asarray(A.numpy()), rapi.SVDSpec(method=method,
                                                        rank=3),
                   key=jax.random.PRNGKey(0), callback=ref_cb)
    assert ref_cb.info.method == method
    assert cb.info.residuals.dtype == torch.float32


@pytest.mark.parametrize("kind", ["sparse_sign", "gaussian"])
def test_bridge_carries_the_reference_sketch(kind):
    ref = ref_make_sketch(jax.random.PRNGKey(3), 70, 16, kind=kind)
    sk = bridge.sketch(ref, device="cpu")
    np.testing.assert_array_equal(sk.dense().numpy(), np.asarray(ref.dense()))
    X = np.random.default_rng(0).standard_normal((70, 5)).astype(np.float32)
    np.testing.assert_allclose(sk.tapply(torch.from_numpy(X)).numpy(),
                               np.asarray(ref.tapply(jnp.asarray(X))),
                               rtol=2e-5, atol=2e-5)
    assert sk.shape == tuple(ref.shape)
    if kind == "sparse_sign":
        assert sk.idx.dtype == torch.int32 and sk.backend == "xla"
        assert bridge.sketch(ref, backend="pallas",
                             device="cpu").backend == "pallas"


@pytest.mark.parametrize("bad", [-1, 70])
def test_bridge_rejects_sketch_indices_outside_the_rows(bad):
    """The sketch kernel reads every slot unchecked, so the bridge checks
    a carried-over pack's indices once, on the host."""
    ref = ref_make_sketch(jax.random.PRNGKey(3), 70, 16, kind="sparse_sign")
    idx = np.array(ref.idx)
    idx[4, 2] = bad
    with pytest.raises(ValueError, match=r"\[0, 70\)"):
        bridge.sketch(types.SimpleNamespace(idx=idx, signs=ref.signs,
                                            n=ref.n), device="cpu")


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("method", ["rbk", "gnystrom"])
def test_gaussian_sketch_kind(method, precision):
    """sketch_kind="gaussian" (a dense N(0, 1) test matrix, its apply a
    GEMM with f32 accumulation) through the registered solvers."""
    A = np.array(ZOO["graded"][0])
    s_true = _s_true(A)
    spec = _spec(method, precision).replace(sketch_kind="gaussian",
                                            backend="pallas")
    out = factorize(torch.from_numpy(A), spec,
                    generator=torch.Generator().manual_seed(4))
    ref = rapi.factorize(jnp.asarray(A), rapi.SVDSpec(
        method=method, rank=R, precision=precision, sketch_kind="gaussian",
        **SOLVERS[method]["spec"]), key=jax.random.PRNGKey(4))
    bound = SOLVERS[method]["stol"] if precision is None \
        else BF16_STOL[method]
    assert _err(out.s, s_true, s_true[0]) < bound
    if not (method == "rbk" and precision == "bf16"):    # jit: Queue 3
        assert _err(ref.s, s_true, s_true[0]) < bound


def test_make_sketch_draws_the_sparse_sign_ensemble():
    g = torch.Generator().manual_seed(0)
    sk = tsketch.make_sketch(g, 500, 64, backend="pallas")
    assert sk.shape == (500, 64) and sk.idx.shape == (64, skm.ZETA)
    assert sk.idx.dtype == torch.int32
    assert 0 <= int(sk.idx.min()) and int(sk.idx.max()) < 500
    mag = 1.0 / np.sqrt(skm.ZETA)
    np.testing.assert_allclose(sk.signs.abs().numpy(), mag, rtol=1e-6)
    assert abs(float((sk.signs > 0).float().mean()) - 0.5) < 0.1
    T = sk.dense()
    assert torch.equal(T, sk.dense())                 # deterministic
    # every column carries ζ slots: its squared norm is ζ/ζ = 1 unless
    # two slots collide on one row (then they add)
    X = torch.randn(500, 7, generator=g)
    torch.testing.assert_close(sk.tapply(X), T.T @ X, rtol=1e-5, atol=1e-5)
    small = tsketch.make_sketch(g, 3, 4, dtype=torch.bfloat16)
    assert small.idx.shape == (4, 3) and small.signs.dtype == torch.bfloat16
    gauss = tsketch.make_sketch(g, 50, 6, kind="gaussian")
    assert gauss.dense().shape == (50, 6)
    with pytest.raises(ValueError, match="sketch kind"):
        tsketch.make_sketch(g, 5, 2, kind="dense")


def test_dense_sums_colliding_slots():
    """Two slots of one column on the same row add, in dense() as in the
    gather apply."""
    idx = torch.tensor([[2, 2, 0], [1, 3, 3]], dtype=torch.int32)
    signs = torch.tensor([[0.5, 0.25, -1.0], [1.0, -0.5, -0.5]])
    sk = tsketch.SparseSignSketch(idx, signs, 4, backend="pallas")
    want = torch.tensor([[-1.0, 0.0], [0.0, 1.0], [0.75, 0.0], [0.0, -1.0]])
    assert torch.equal(sk.dense(), want)
    X = torch.arange(8.0).reshape(4, 2)
    torch.testing.assert_close(sk.tapply(X), want.T @ X)


def test_nystrom_reconstruct_matches_reference():
    from repro.core.sketch import nystrom_reconstruct as ref_nystrom
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((60, 6)) @ rng.standard_normal((6, 40))
         ).astype(np.float32)
    Om = rng.standard_normal((40, 10)).astype(np.float32)
    Ps = rng.standard_normal((60, 20)).astype(np.float32)
    Y, Zt = A @ Om, Ps.T @ A
    C = Ps.T @ Y
    U, s, Vt = tsketch.nystrom_reconstruct(*(torch.from_numpy(x)
                                            for x in (Y, Zt, C)))
    rU, rs, rVt = ref_nystrom(Y, Zt, C)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-4,
                               atol=1e-4 * float(rs[0]))
    np.testing.assert_allclose(((U[:, :6] * s[:6]) @ Vt[:6]).numpy(), A,
                               atol=1e-3 * float(rs[0]))


def test_rsvd_oversampling_and_power_iterations():
    A = torch.from_numpy(np.array(ZOO["graded"][0]))
    s_true = _s_true(A.numpy())
    g = torch.Generator().manual_seed(3)
    plain = factorize(A, SVDSpec(method="rsvd", rank=R), generator=g)
    power = factorize(A, SVDSpec(method="rsvd", rank=R, power_iters=3),
                      generator=g)
    assert int(power.iterations) == 3 and int(plain.iterations) == 0
    assert _err(power.s, s_true, s_true[0]) \
        < _err(plain.s, s_true, s_true[0])
    with pytest.raises(ValueError, match="omega"):
        trsvd.rsvd(A, R, omega=torch.zeros(3, 3))
