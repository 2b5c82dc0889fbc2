"""The port's rank-k update / downdate (repro_torch.core.update) against the
reference package on the CPU.

The cases of tests/test_update.py:58-143, each run on both backends: the
reference factorizes and draws the delta; both packages then update the
same factorization with the same delta (carried over with
``repro_torch.bridge``).  The port's σ is held at the reference's own
``GATE`` (1e-5·σ_max) against the dense SVD of the drifted matrix and
against the reference's updated σ, with zero GK iterations.  On the CPU
the pallas backend's core product is the plain version of the
``lowrank_matmul`` kernel (the kernel itself is held on the card by
tests/test_torch_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LowRankOp as RefLowRankOp
from repro.api import SVDSpec as RefSpec
from repro.api import factorize as ref_factorize
from repro.core import update as jupd
from repro_torch import bridge
from repro_torch.api import (LowRankOp, downdate_cols, downdate_rows,
                             update_factorization)
from repro_torch.core import update as tupd
from repro_torch.kernels import lowrank_update as klu
from test_solver_parity import ZOO
from test_update import GATE, KEY, M, N, R, SPEC, _delta, _exact

BACKENDS = ["xla", "pallas"]


def _np(x):
    return np.asarray(x.detach().double() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float64))


def _sigma_err(s, A) -> float:
    s_true = np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)
    s = _np(s)
    return float(np.max(np.abs(s - s_true[:len(s)])) / s_true[0])


def _subspace_cos(V, A) -> float:
    _, _, Vt = np.linalg.svd(np.asarray(A, np.float64), full_matrices=False)
    V = _np(V)
    return float(np.min(np.linalg.svd(Vt[:V.shape[1]] @ V,
                                      compute_uv=False)))


def _delta_port(d):
    return bridge.lowrank(d.U, d.s, d.Vt, d.extra, d.scale, device="cpu")


def _fact(A, spec=SPEC, key=KEY):
    ref = ref_factorize(A, spec, key=key)
    return ref, bridge.factorization(ref, device="cpu")


def _check(got, ref, A2, gate=GATE):
    assert int(got.iterations) == 0 and got.method == "update"
    assert _sigma_err(got.s, A2) <= gate
    assert float(np.max(np.abs(_np(got.s) - _np(ref.s)))) \
        / float(_np(ref.s)[0]) <= gate


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_matches_cold_factorize_exact(backend):
    A = _exact()
    ref_f, f = _fact(A)
    d = _delta(jax.random.fold_in(KEY, 1), ref=A)
    ref = jupd.update_factorization(ref_f, d)
    got = update_factorization(f, _delta_port(d), backend=backend)
    A2 = np.asarray(A + jupd.materialize_lowrank(d))
    _check(got, ref, A2)
    assert _subspace_cos(got.V, A2) >= 1.0 - 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_on_zoo_lowrank_matches_gk_parity(backend):
    A, _ = ZOO["lowrank_noise"]
    spec = RefSpec(method="fsvd", rank=R, max_iters=48)
    ref_f, f = _fact(A, spec)
    d = _delta(jax.random.fold_in(KEY, 2), m=A.shape[0], n=A.shape[1],
               rel=1e-3, ref=A)
    ref = jupd.update_factorization(ref_f, d)
    got = update_factorization(f, _delta_port(d), backend=backend)
    A2 = np.asarray(A + jupd.materialize_lowrank(d))
    cold = ref_factorize(A2, spec, key=jax.random.fold_in(KEY, 3))
    assert int(got.iterations) == 0
    assert _sigma_err(got.s, A2) <= max(5e-4, 2.0 * _sigma_err(cold.s, A2))
    assert float(np.max(np.abs(_np(got.s) - _np(ref.s)))) \
        / float(_np(ref.s)[0]) <= GATE


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_beta_decay(backend):
    A = _exact()
    ref_f, f = _fact(A)
    d = _delta(jax.random.fold_in(KEY, 4), ref=A)
    ref = jupd.update_factorization(ref_f, d, beta=0.5)
    got = update_factorization(f, _delta_port(d), beta=0.5, backend=backend)
    _check(got, ref, np.asarray(0.5 * A + jupd.materialize_lowrank(d)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_update_with_scale_and_extras(backend):
    A = _exact()
    ref_f, f = _fact(A)
    d0 = _delta(jax.random.fold_in(KEY, 5), k=1, ref=A)
    L = 1e-3 * jax.random.normal(jax.random.fold_in(KEY, 6), (M, 1))
    Rf = jax.random.normal(jax.random.fold_in(KEY, 7), (1, N))
    d = RefLowRankOp(d0.U, d0.s, d0.Vt, scale=2.0, extra=((L, Rf),))
    dp = _delta_port(d)
    assert tupd.delta_rank(dp) == jupd.delta_rank(d) == 2
    C, D = tupd.delta_factors(dp)
    rC, rD = jupd.delta_factors(d)
    np.testing.assert_allclose(_np(C), _np(rC), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(D), _np(rD), rtol=1e-6, atol=1e-7)
    W = tupd.materialize_lowrank(dp, backend=backend)
    np.testing.assert_allclose(_np(C @ D.T), _np(W), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(W), _np(jupd.materialize_lowrank(d)),
                               rtol=1e-5, atol=1e-5)
    ref = jupd.update_factorization(ref_f, d)
    got = update_factorization(f, dp, backend=backend)
    _check(got, ref, np.asarray(A + jupd.materialize_lowrank(d)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_downdate_rows_and_cols(backend):
    A = _exact()
    ref_f, f = _fact(A)
    rows = [3, 17, 40]
    down = downdate_rows(f, rows, backend=backend)
    A2 = np.asarray(A).copy()
    A2[rows, :] = 0
    _check(down, jupd.downdate_rows(ref_f, rows), A2)
    approx = _np((down.U * down.s[None, :]) @ down.V.T)
    assert float(np.max(np.abs(approx[rows, :]))) <= \
        1e-4 * float(np.linalg.norm(np.asarray(A)))

    cols = [0, 5]
    down_c = downdate_cols(f, cols, backend=backend)
    A3 = np.asarray(A).copy()
    A3[:, cols] = 0
    _check(down_c, jupd.downdate_cols(ref_f, cols), A3)
    d_r = tupd.row_removal_delta(f, rows)
    d_c = tupd.col_removal_delta(f, cols)
    assert tupd.delta_rank(d_r) == 3 and tupd.delta_rank(d_c) == 2
    for got, want in ((d_r, jupd.row_removal_delta(ref_f, rows)),
                      (d_c, jupd.col_removal_delta(ref_f, cols))):
        np.testing.assert_allclose(
            _np(tupd.materialize_lowrank(got, backend=backend)),
            _np(jupd.materialize_lowrank(want)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rank", [None, 4, R + 2, R + 10])
def test_update_rank_argument(rank):
    """``rank=None`` keeps the previous rank; any rank up to r + k is
    valid and larger ones clamp, as in the reference."""
    A = _exact()
    ref_f, f = _fact(A)
    d = _delta(jax.random.fold_in(KEY, 8), ref=A)
    ref = jupd.update_factorization(ref_f, d, rank=rank)
    got = update_factorization(f, _delta_port(d), rank=rank,
                               backend="pallas")
    assert got.s.shape == ref.s.shape and got.U.shape == ref.U.shape
    np.testing.assert_allclose(_np(got.s), _np(ref.s), rtol=0,
                               atol=GATE * float(_np(ref.s)[0]))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_materialize_lowrank_matches_reference(dtype):
    """materialize_lowrank on both backends (the pallas one through the
    kernel's plain version on the CPU) against the reference's, with a
    ragged shape the reference's tile ladder cannot cut (its jnp
    fallback) and an f32 output whatever the factors' dtype."""
    rng = np.random.default_rng(3)
    U = rng.standard_normal((127, 5)).astype(np.float32)
    s = np.abs(rng.standard_normal(5)).astype(np.float32)
    Vt = rng.standard_normal((5, 383)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "f64": (jnp.float32, torch.float64)}[dtype]   # no JAX x64
    if dtype == "f64":
        U, Vt = U.astype(np.float64), Vt.astype(np.float64)
    ref = jupd.materialize_lowrank(
        RefLowRankOp(jnp.asarray(U).astype(jdt), jnp.asarray(s),
                     jnp.asarray(Vt).astype(jdt)), backend="pallas")
    op = LowRankOp(torch.from_numpy(U).to(tdt), torch.from_numpy(s),
                   torch.from_numpy(Vt).to(tdt))
    for backend in BACKENDS:
        got = tupd.materialize_lowrank(op, backend=backend,
                                       dtype=torch.float32)
        assert got.dtype == torch.float32 and got.shape == (127, 383)
        tol = 3e-2 if dtype == "bf16" else 2e-4
        np.testing.assert_allclose(_np(got), _np(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    klu.reset_launches()
    tupd.materialize_lowrank(op, backend="pallas")
    assert klu.LAUNCHES["lowrank_matmul"] == 0          # CPU: plain version


def test_core_outer_backends_agree():
    rng = np.random.default_rng(4)
    Chat = torch.from_numpy(rng.standard_normal((30, 10)))
    Dhat = torch.from_numpy(rng.standard_normal((30, 10)))
    want = jupd._core_outer(jnp.asarray(Chat.numpy(), jnp.float32),
                            jnp.asarray(Dhat.numpy(), jnp.float32), "pallas")
    for backend in BACKENDS:
        got = tupd._core_outer(Chat.float(), Dhat.float(), backend)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
