"""The port's F-SVD (Alg 2), numerical rank (Alg 3) and API facade against
the reference package on the CPU.

Operands come from the reference's own batteries — the differential zoo
of tests/test_solver_parity.py and the cases of tests/test_rank.py — and
go to both packages as numpy arrays; the GK start vector is drawn once
with numpy and injected into both.  Bounds are the reference's own:
``SOLVERS["fsvd"]["stol"]``·σ_max in f32, ``BF16_STOL["fsvd"]``·σ_max with
bf16 bases, equal iteration counts and breakdown flags on exact-rank
inputs, and singular vectors equal up to sign at 1e-3 where a triplet is
separated from its neighbours by more than 1e-2·σ_max.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
from conftest import make_lowrank
from repro.core.rank import numerical_rank as ref_rank
from repro_torch import bridge
from repro_torch.api import (ImplicitKeyWarning, RecordingCallback, SVDSpec,
                             available_solvers, estimate_rank, factorize,
                             resolve_method)
from repro_torch.core import fsvd as tfsvd
from repro_torch.core.operators import DenseOp, GramOp
from repro_torch.core.rank import numerical_rank
from test_solver_parity import BF16_STOL, R, SOLVERS, ZOO

STOL = SOLVERS["fsvd"]["stol"]
MAX_ITERS = SOLVERS["fsvd"]["spec"]["max_iters"]
BACKENDS = ["xla", "pallas"]


def _q1(m, seed=0):
    return (2.0 + np.random.default_rng(seed).standard_normal(m)
            ).astype(np.float32)


def _both(A, spec_kw, q1, backend="xla", **port_kw):
    """(reference, port) factorizations of numpy ``A`` under one spec."""
    rspec = rapi.SVDSpec(method="fsvd", **spec_kw)
    ref = rapi.factorize(jnp.asarray(A), rspec, q1=jnp.asarray(q1))
    got = factorize(torch.from_numpy(A),
                    bridge.spec(rspec).replace(backend=backend),
                    q1=torch.from_numpy(q1), **port_kw)
    return ref, got


def _sv_err(s, s_true):
    s = np.asarray(s.float() if isinstance(s, torch.Tensor) else s,
                   np.float64)
    return np.max(np.abs(s - s_true[:len(s)])) / s_true[0]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_singular_values_match_reference(name, backend):
    A = np.array(ZOO[name][0])
    s_true = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    ref, got = _both(A, dict(rank=R, max_iters=MAX_ITERS), _q1(A.shape[0]),
                     backend)
    assert got.s.shape == (R,) and got.U.shape == (A.shape[0], R)
    assert _sv_err(got.s, s_true) < STOL
    assert _sv_err(ref.s, s_true) < STOL
    assert np.max(np.abs(got.s.numpy() - np.asarray(ref.s))) \
        / s_true[0] < STOL


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(ZOO))
def test_singular_values_match_reference_bf16(name, backend):
    A = np.array(ZOO[name][0])
    s_true = np.linalg.svd(A.astype(np.float64), compute_uv=False)
    ref, got = _both(A, dict(rank=R, max_iters=MAX_ITERS, precision="bf16"),
                     _q1(A.shape[0], 1), backend)
    assert _sv_err(got.s, s_true) < BF16_STOL["fsvd"]
    assert np.max(np.abs(got.s.numpy() - np.asarray(ref.s, np.float32))) \
        / s_true[0] < BF16_STOL["fsvd"]


@pytest.mark.parametrize("host_loop", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m,n,rank", [(90, 60, 8), (60, 120, 25),
                                      (150, 40, 12)])
def test_exact_rank_iterations_and_vectors_match(m, n, rank, backend,
                                                 host_loop):
    A = np.array(make_lowrank(jax.random.PRNGKey(m), m, n, rank))
    ref, got = _both(A, dict(rank=min(R, rank), max_iters=3 * rank,
                             host_loop=host_loop), _q1(m, rank), backend)
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.breakdown) == bool(ref.breakdown)
    s = np.asarray(ref.s, np.float64)
    smax = s[0]
    np.testing.assert_allclose(got.s.numpy(), s, rtol=0, atol=STOL * smax)
    gaps = np.abs(np.diff(np.concatenate([[np.inf], s, [0.0]])))
    separated = np.minimum(gaps[:-1], gaps[1:]) > 1e-2 * smax
    assert separated.any()
    for X, Xr in ((got.U, ref.U), (got.V, ref.V)):
        X, Xr = X.numpy(), np.asarray(Xr)
        for i in np.flatnonzero(separated):
            sign = np.sign(X[:, i] @ Xr[:, i])
            np.testing.assert_allclose(sign * X[:, i], Xr[:, i], rtol=0,
                                       atol=1e-3)


def test_reconstruction_and_errors_match_reference(monkeypatch):
    A = np.array(make_lowrank(jax.random.PRNGKey(0), 120, 80, 15))
    ref, got = _both(A, dict(rank=15, max_iters=60), _q1(120))
    want = ref.errors(jnp.asarray(A))
    errs = got.errors(torch.from_numpy(A))
    assert float(errs["relative"]) < 5e-5          # test_api.py:102
    np.testing.assert_allclose(float(errs["residual"]),
                               float(want["residual"]), rtol=0.05,
                               atol=1e-3 * np.linalg.norm(A))
    np.testing.assert_allclose(got.reconstruct().numpy(),
                               np.asarray(ref.reconstruct()), atol=1e-3)
    # the residual is formed by row blocks; the blocking does not matter
    # (rank 6 < 15, so the residual is well above rounding)
    ref6, got6 = _both(A, dict(rank=6), _q1(120))
    whole = float(got6.errors(torch.from_numpy(A))["residual"])
    np.testing.assert_allclose(
        whole, float(ref6.errors(jnp.asarray(A))["residual"]), rtol=1e-4)
    monkeypatch.setattr(tfsvd, "_RESIDUAL_ROWS", 7)
    blocked = got6.errors(torch.from_numpy(A))["residual"]
    np.testing.assert_allclose(float(blocked), whole, rtol=1e-5)


def test_warm_start_matches_reference_and_converges():
    A = np.array(make_lowrank(jax.random.PRNGKey(0), 120, 80, 15))
    ref, got = _both(A, dict(rank=6), _q1(120))
    np.testing.assert_allclose(got.warm_start().numpy(),
                               np.asarray(ref.warm_start()), rtol=1e-3,
                               atol=1e-3 * float(np.abs(ref.warm_start()).max()))
    warm = factorize(torch.from_numpy(A), SVDSpec(method="fsvd", rank=6),
                     q1=got.warm_start())
    np.testing.assert_allclose(warm.s.numpy(), got.s.numpy(), rtol=1e-3)
    half = factorize(torch.from_numpy(A),
                     SVDSpec(method="fsvd", rank=6, precision="bf16"),
                     q1=got.warm_start())
    assert half.warm_start().dtype == torch.float32


def test_callback_sees_the_solve():
    A = torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(1),
                                                 80, 60, 7)))
    cb = RecordingCallback()
    out = factorize(A, SVDSpec(method="fsvd", rank=4, host_loop=True),
                    q1=torch.from_numpy(_q1(80)), callback=cb)
    assert int(cb.info.iterations) == int(out.iterations)
    assert len(cb.steps) >= int(out.iterations) - 1


# --------------------------------------------------------------------------
# numerical rank (Alg 3)
# --------------------------------------------------------------------------

RANK_CASES = [(100, 80, 10), (60, 120, 25), (200, 200, 1)]


@pytest.mark.parametrize("host_loop", [True, False])
@pytest.mark.parametrize("m,n,rank", RANK_CASES)
def test_numerical_rank_matches_reference(m, n, rank, host_loop):
    """tests/test_rank.py's cases, in both loop styles."""
    A = np.array(make_lowrank(jax.random.PRNGKey(0), m, n, rank))
    want = ref_rank(jnp.asarray(A), host_loop=host_loop,
                    key=jax.random.PRNGKey(0))
    got = numerical_rank(torch.from_numpy(A), host_loop=host_loop,
                         generator=torch.Generator().manual_seed(0))
    assert int(got.rank) == int(want.rank) == rank
    assert rank <= int(got.gk_iterations) <= rank + 3
    assert got.eigenvalues.shape == (min(m, n),)


@pytest.mark.parametrize("backend", BACKENDS)
def test_estimate_rank_matches_reference(backend):
    A = np.array(make_lowrank(jax.random.PRNGKey(0), 120, 80, 15))
    g = torch.Generator().manual_seed(1)
    for host_loop in (None, False):
        spec = SVDSpec(max_iters=40, backend=backend, host_loop=host_loop)
        got = estimate_rank(torch.from_numpy(A), spec, generator=g)
        want = rapi.estimate_rank(
            jnp.asarray(A), rapi.SVDSpec(max_iters=40, host_loop=host_loop),
            key=jax.random.PRNGKey(1))
        assert int(got) == int(want) == 15
        assert got.method == "gk"


def test_rank_of_full_rank_noisy_and_wrapped_operands():
    key = jax.random.PRNGKey(0)
    full = np.array(jax.random.normal(key, (50, 30)))
    g = torch.Generator().manual_seed(2)
    assert int(numerical_rank(torch.from_numpy(full), generator=g).rank) \
        == 30
    A = np.array(make_lowrank(key, 100, 80, 10))
    A = A + 1e-6 * np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                A.shape))
    tol = 1e-4 * float(np.linalg.norm(A)) ** 2
    got = numerical_rank(torch.from_numpy(A), sigma_tol=tol, generator=g)
    assert int(got.rank) == 10 == int(ref_rank(
        jnp.asarray(A), sigma_tol=tol, key=jax.random.PRNGKey(2)).rank)
    op = DenseOp(torch.from_numpy(A))
    for wrapped in (op.T, GramOp(op, "ata"), GramOp(op.T, "aat")):
        assert int(numerical_rank(wrapped, sigma_tol=tol,
                                  generator=g).rank) == 10


# --------------------------------------------------------------------------
# facade behaviour
# --------------------------------------------------------------------------

BAD_SPECS = [dict(rank=0), dict(block_size=0), dict(max_basis=0),
             dict(sketch_dim=0), dict(passes=-1),
             dict(method="rbk", passes=0),
             dict(method="gnystrom", rank=10, sketch_dim=5),
             dict(sketch_kind="dense"), dict(backend="cuda"),
             dict(precision="fp8")]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: ",".join(kw))
def test_spec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        rapi.SVDSpec(**kw)
    with pytest.raises(ValueError):
        SVDSpec(**kw)


def test_spec_dtype_is_a_torch_dtype():
    assert SVDSpec(dtype=torch.float64).dtype is torch.float64
    with pytest.raises(TypeError, match="torch.dtype"):
        SVDSpec(dtype="float32")
    assert SVDSpec(rank=3).replace(rank=5).rank == 5


def test_methods_not_ported_name_their_roadmap_row():
    """All six of the reference's methods are ported, so none is left to
    name a ROADMAP.md row; fsvd_sharded, like the reference's, refuses an
    operand that is not sharded."""
    from repro_torch.api.solvers import NOT_PORTED
    A = torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(0),
                                                 40, 30, 4)))
    assert NOT_PORTED == {}
    assert available_solvers() == ("fsvd", "fsvd_blocked", "fsvd_sharded",
                                   "gnystrom", "rbk", "rsvd")
    with pytest.raises(TypeError, match="ShardedOp"):
        factorize(A, SVDSpec(method="fsvd_sharded", rank=3))
    g = torch.Generator().manual_seed(0)
    for method in ("rsvd", "fsvd_blocked", "rbk", "gnystrom"):
        out = factorize(A, SVDSpec(method=method, rank=3), generator=g)
        assert out.method == method and out.s.shape == (3,)
    with pytest.raises(KeyError):
        factorize(A, SVDSpec(method="nope", rank=3))


def test_auto_resolution_follows_the_reference_rule():
    """auto → rsvd for tol ≥ 1e-4 or power iterations (and that solve now
    runs), fsvd otherwise, fsvd_blocked on matrix-free operands."""
    A = torch.zeros(20, 10)
    for kw in (dict(), dict(tol=1e-3), dict(power_iters=2),
               dict(method="fsvd", tol=1e-3)):
        assert resolve_method(SVDSpec(**kw), A) == rapi.resolve_method(
            rapi.SVDSpec(**kw), jnp.zeros((20, 10)))
    assert resolve_method(SVDSpec(), GramOp(DenseOp(A))) == "fsvd_blocked"
    B = torch.from_numpy(np.array(make_lowrank(jax.random.PRNGKey(3),
                                                 40, 30, 4)))
    out = factorize(B, SVDSpec(tol=1e-3, rank=2),
                    generator=torch.Generator().manual_seed(0))
    assert out.method == "rsvd"
    s = np.linalg.svd(B.numpy().astype(np.float64), compute_uv=False)
    assert np.max(np.abs(out.s.numpy() - s[:2])) / s[0] \
        < SOLVERS["rsvd"]["stol"]


def test_generators_and_devices():
    A = np.array(make_lowrank(jax.random.PRNGKey(2), 50, 40, 5))
    with pytest.warns(ImplicitKeyWarning):
        a = factorize(torch.from_numpy(A), rank=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = factorize(A, rank=3, device="cpu",
                      generator=torch.Generator().manual_seed(0))
        factorize(A, rank=3, device="cpu", q1=_q1(50))
    assert torch.equal(a.s, b.s)
    assert b.U.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factorize(A, rank=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            estimate_rank(A)
    with pytest.raises(ValueError, match="full-precision"):
        estimate_rank(torch.from_numpy(A), precision="bf16")
