"""The port's fixed-rank manifold (``repro_torch.core.manifold``) against
the reference's (``repro.core.manifold``).

Every case of tests/test_manifold.py runs on the port, on the reference's
own point and matrices (handed over through ``bridge``), held to that
test's assertions and bounds.  Then parity: the port's outputs against the
reference's on the same inputs, at stated tolerances:

* ``project_tangent`` (dense G and an operator G), ``inner``, ``norm``:
  f32 rounding apart, atol 1e-5 (test_manifold.py's own bound for the
  tangent components);
* ``as_linop`` mv / rmv: rtol 2e-4, atol 1e-4 (test_linop_matches_dense);
* ``retract_qr`` and ``retract_fsvd`` (warm, and cold from the reference's
  own start vector): the dense point within 1e-4 and σ within 1e-4
  relative, ten times under test_retractions_agree's 1e-3.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import gk as ref_gk
from repro.core import manifold as rmf
from repro_torch import bridge
from repro_torch.api import ImplicitKeyWarning, clear_plan_cache, trace_count
from repro_torch.core import gk as tgk
from repro_torch.core import manifold as tmf
from repro_torch.core.linop import to_dense as linop_dense
from repro_torch.core.operators import LowRankOp

TANGENT_ATOL = 1e-5       # test_manifold.py: tangent constraints / idempotence
RETRACT_TOL = 1e-4        # port vs reference retraction (reference: 1e-3)


@pytest.fixture
def ref_point(rng):
    return rmf.random_point(rng, 60, 45, 5)


@pytest.fixture
def point(ref_point):
    return bridge.fixed_rank_point(ref_point, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _G(seed, shape=(60, 45)):
    return jax.random.normal(jax.random.PRNGKey(seed), shape)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# --- tests/test_manifold.py on the port --------------------------------------

def test_point_orthonormal(point):
    np.testing.assert_allclose(_np(point.U.T @ point.U), np.eye(5),
                               atol=1e-5)
    np.testing.assert_allclose(_np(point.V.T @ point.V), np.eye(5),
                               atol=1e-5)


def test_random_point_of_the_port_is_a_point():
    W = tmf.random_point(torch.Generator().manual_seed(0), 60, 45, 5)
    assert W.rank == 5 and W.shape == (60, 45)
    np.testing.assert_allclose(_np(W.U.T @ W.U), np.eye(5), atol=1e-5)
    np.testing.assert_allclose(_np(W.V.T @ W.V), np.eye(5), atol=1e-5)
    s = _np(W.s)
    assert np.all(np.diff(s) <= 0) and s.min() >= 0.1
    W2 = tmf.random_point(torch.Generator().manual_seed(0), 60, 45, 5)
    assert all(torch.equal(a, b) for a, b in zip(W, W2))


def test_tangent_constraints(point):
    xi = tmf.project_tangent(point, _t(_G(3)))
    assert float(torch.max(torch.abs(point.U.T @ xi.Up))) < 1e-5
    assert float(torch.max(torch.abs(point.V.T @ xi.Vp))) < 1e-5


def test_projection_idempotent(point):
    xi = tmf.project_tangent(point, _t(_G(3)))
    xi2 = tmf.project_tangent(point, tmf.tangent_to_dense(point, xi))
    np.testing.assert_allclose(_np(xi.M), _np(xi2.M), atol=1e-5)
    np.testing.assert_allclose(_np(xi.Up), _np(xi2.Up), atol=1e-5)


def test_projection_is_metric_projection(point):
    """<G - P(G), Z> = 0 for any tangent Z (orthogonal projection)."""
    kg, kz = jax.random.split(jax.random.PRNGKey(4))
    G = _t(jax.random.normal(kg, (60, 45)))
    xi = tmf.project_tangent(point, G)
    Z = tmf.project_tangent(point, _t(jax.random.normal(kz, (60, 45))))
    resid = G - tmf.tangent_to_dense(point, xi)
    ip = float(torch.sum(resid * tmf.tangent_to_dense(point, Z)))
    assert abs(ip) < 1e-3


def test_inner_matches_dense(point):
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    xi = tmf.project_tangent(point, _t(jax.random.normal(k1, (60, 45))))
    zt = tmf.project_tangent(point, _t(jax.random.normal(k2, (60, 45))))
    dense = float(torch.sum(tmf.tangent_to_dense(point, xi)
                            * tmf.tangent_to_dense(point, zt)))
    assert abs(float(tmf.inner(xi, zt)) - dense) < 1e-3 * (1 + abs(dense))


@pytest.mark.parametrize("step", [0.05, 0.5])
def test_retractions_agree(point, step):
    """QR closed form == F-SVD implicit retraction (both = rank-r SVD of
    W + t xi)."""
    xi = tmf.project_tangent(point, _t(_G(6)))
    Wq = tmf.retract_qr(point, xi, -step)
    Wf = tmf.retract_fsvd(point, xi, -step, fsvd_iters=25)
    np.testing.assert_allclose(_np(tmf.to_dense(Wq)), _np(tmf.to_dense(Wf)),
                               atol=1e-3)


def test_retraction_first_order(point):
    """R_W(t xi) = W + t xi + O(t^2)."""
    xi = tmf.project_tangent(point, _t(_G(7)))
    W0 = tmf.to_dense(point)
    Xi = tmf.tangent_to_dense(point, xi)
    errs = []
    for t in (1e-2, 5e-3):
        Rt = tmf.to_dense(tmf.retract_qr(point, xi, t))
        errs.append(float(torch.linalg.norm(Rt - (W0 + t * Xi))))
    # halving t should shrink the error ~4x (second order)
    assert errs[1] < errs[0] / 2.5


def test_linop_matches_dense(point):
    xi = tmf.project_tangent(point, _t(_G(8)))
    op = tmf.as_linop(point, xi, 0.3)
    assert isinstance(op, LowRankOp) and len(op.extra) == 2
    dense = tmf.to_dense(point) + 0.3 * tmf.tangent_to_dense(point, xi)
    p = _t(jax.random.normal(jax.random.PRNGKey(9), (45,)))
    q = _t(jax.random.normal(jax.random.PRNGKey(10), (60,)))
    np.testing.assert_allclose(_np(op.mv(p)), _np(dense @ p),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(_np(op.rmv(q)), _np(dense.T @ q),
                               rtol=2e-4, atol=1e-4)


# --- parity with the reference ------------------------------------------------

def test_project_tangent_matches_reference(ref_point, point):
    G = _G(3)
    ref = rmf.project_tangent(ref_point, G)
    got = tmf.project_tangent(point, _t(G))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=TANGENT_ATOL)
    # through the operator protocol: a low-rank G as the reference's and
    # the port's LowRankOp
    L = jax.random.normal(jax.random.PRNGKey(12), (60, 7))
    R = jax.random.normal(jax.random.PRNGKey(13), (7, 45))
    c = jax.random.normal(jax.random.PRNGKey(14), (7,))
    from repro.core.operators import LowRankOp as RefLowRankOp
    ref_op = rmf.project_tangent(ref_point, RefLowRankOp(L, c, R))
    got_op = tmf.project_tangent(point,
                                 bridge.lowrank(L, c, R, device="cpu"))
    for a, b in zip(got_op, ref_op):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=TANGENT_ATOL)
    zeta_ref = rmf.project_tangent(ref_point, _G(15))
    zeta = bridge.tangent_vector(zeta_ref, device="cpu")
    np.testing.assert_allclose(float(tmf.inner(got, zeta)),
                               float(rmf.inner(ref, zeta_ref)),
                               rtol=1e-5, atol=TANGENT_ATOL)
    np.testing.assert_allclose(float(tmf.norm(got)), float(rmf.norm(ref)),
                               rtol=1e-5)
    two = tmf.add(tmf.scale(got, 2.0), zeta)
    two_ref = rmf.add(rmf.scale(ref, 2.0), zeta_ref)
    for a, b in zip(two, two_ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=2e-5)
    np.testing.assert_allclose(_np(tmf.tangent_to_dense(point, got)),
                               np.asarray(rmf.tangent_to_dense(ref_point,
                                                               ref)),
                               atol=TANGENT_ATOL)


@pytest.mark.parametrize("scale", [1.0, 0.3, -2.0])
def test_as_linop_matches_reference(ref_point, point, scale):
    xi_ref = rmf.project_tangent(ref_point, _G(8))
    xi = bridge.tangent_vector(xi_ref, device="cpu")
    ref_op = rmf.as_linop(ref_point, xi_ref, scale)
    op = tmf.as_operator(point, xi, scale)
    p = jax.random.normal(jax.random.PRNGKey(9), (45,))
    q = jax.random.normal(jax.random.PRNGKey(10), (60,))
    np.testing.assert_allclose(_np(op.mv(_t(p))), np.asarray(ref_op.mv(p)),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(_np(op.rmv(_t(q))),
                               np.asarray(ref_op.rmv(q)),
                               rtol=2e-4, atol=1e-4)
    # the point alone is the rank-r operator of its factors
    np.testing.assert_allclose(_np(linop_dense(tmf.as_linop(point))),
                               np.asarray(rmf.to_dense(ref_point)),
                               atol=1e-5)


def _close_points(got, ref, tol=RETRACT_TOL):
    dense_ref = np.asarray(rmf.to_dense(ref))
    np.testing.assert_allclose(_np(tmf.to_dense(got)), dense_ref,
                               atol=tol * np.abs(dense_ref).max())
    np.testing.assert_allclose(_np(got.s), np.asarray(ref.s), rtol=tol)


@pytest.mark.parametrize("step", [0.05, 0.5])
def test_retract_qr_matches_reference(ref_point, point, step):
    xi_ref = rmf.project_tangent(ref_point, _G(6))
    xi = bridge.tangent_vector(xi_ref, device="cpu")
    _close_points(tmf.retract_qr(point, xi, -step),
                  rmf.retract_qr(ref_point, xi_ref, -step))


@pytest.mark.parametrize("step", [0.05, 0.5])
def test_retract_fsvd_warm_matches_reference(ref_point, point, step):
    """The tracking retraction starts from U diag(s) 1 in both packages,
    and with a given q1 draws nothing: no self-seeding warning."""
    xi_ref = rmf.project_tangent(ref_point, _G(6))
    xi = bridge.tangent_vector(xi_ref, device="cpu")
    ref = rmf.retract_fsvd(ref_point, xi_ref, -step, fsvd_iters=25)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ImplicitKeyWarning)
        got = tmf.retract_fsvd(point, xi, -step, fsvd_iters=25)
    _close_points(got, ref)


@pytest.mark.parametrize("step", [0.05, 0.5])
def test_retract_fsvd_cold_matches_reference(monkeypatch, ref_point, point,
                                             step):
    """The cold retraction draws its start vector from the generator: hand
    the port the reference's draw for its key, then compare."""
    key = jax.random.PRNGKey(21)
    xi_ref = rmf.project_tangent(ref_point, _G(6))
    xi = bridge.tangent_vector(xi_ref, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = rmf.retract_fsvd(ref_point, xi_ref, -step, fsvd_iters=25,
                               key=key, warm_start=False)
    q1 = bridge.start_vector(ref_gk.start_vector(key, 60), device="cpu")
    gen = torch.Generator().manual_seed(0)
    drawn = []

    def start_vector(generator, m, dtype, device):
        drawn.append(generator)
        return q1.to(device=device, dtype=dtype)

    monkeypatch.setattr(tgk, "start_vector", start_vector)
    got = tmf.retract_fsvd(point, xi, -step, fsvd_iters=25, generator=gen,
                           warm_start=False)
    assert drawn == [gen]
    _close_points(got, ref)


def test_retract_fsvd_builds_one_runner_per_shape(point):
    """A run of same-shaped tracking retractions is one trace."""
    clear_plan_cache()
    before = trace_count()
    W = point
    for _ in range(4):
        W = tmf.retract_fsvd(W, tmf.project_tangent(W, _t(_G(6))), -0.05)
    assert trace_count() - before == 1
    assert W.rank == 5 and bool(torch.all(W.s > 0))
