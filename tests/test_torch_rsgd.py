"""The port's Algorithm 4 (``repro_torch.core.rsgd``) and RSL makers
(``repro_torch.data.synthetic``) against the reference's.

Every case of tests/test_rsgd.py runs on the port, on the reference's own
dataset, start point and batches (handed over through ``bridge``), held to
that test's assertions; ``batch_euclidean_grad`` is checked against
``torch.autograd`` of the dense loss (the reference checks against
``jax.grad``), at its atol 1e-5.

Then 20 steps of the port and of the reference side by side, at
test_rsgd_qr_and_fsvd_match's lr 0.05, across the options (fsvd tracking
and cold, qr, ``project_at="grad"``, logistic, weight decay).  Where the
reference draws a start vector from its step key, the port is handed that
draw.  Per-step losses within rtol 1e-4 and the final dense W within
atol 1e-4 of the reference's (test_rsgd_qr_and_fsvd_match holds the two
retractions to rtol 0.05 / atol 0.02 and atol 0.05).

Last, ``rsl_batch`` is a pure function of (seed, step), the dataset maker
gives the reference's dataset from the reference's draws, and a run of
same-shaped ``make_step`` calls builds one plan runner.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gk as ref_gk
from repro.core import manifold as rmf
from repro.core import rsgd as rrs
from repro.core.linop import to_dense as ref_linop_dense
from repro.data import synthetic as rsyn
from repro_torch import bridge
from repro_torch.api import clear_plan_cache, trace_count
from repro_torch.core import gk as tgk
from repro_torch.core import manifold as tmf
from repro_torch.core import rsgd as trs
from repro_torch.core.linop import to_dense as linop_dense
from repro_torch.data import synthetic as tsyn

GRAD_ATOL = 1e-5          # test_batch_grad_matches_dense
LOSS_RTOL = 1e-4          # per-step losses, port vs reference
W_ATOL = 1e-4             # final dense W, port vs reference


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@functools.lru_cache(maxsize=None)
def _ref_problem(seed, d1=24, d2=30, rank=3, n=512):
    """test_rsgd.py's _train setup: the reference's dataset and point."""
    key = jax.random.PRNGKey(seed)
    ds = rsyn.make_rsl_dataset(key, n, d1, d2, rank, noise=0.0)
    W = rmf.random_point(jax.random.fold_in(key, 1), d1, d2, rank)
    return key, ds, W


@functools.lru_cache(maxsize=None)
def _ref_batches(seed, steps, batch=64):
    """The reference's ``rsl_batch(ds, seed, t, batch)`` for t < steps,
    its index draws made in one vmapped call (the same keys, so the same
    indices; step 0 is checked against a direct call)."""
    _, ds, _ = _ref_problem(seed)
    n = ds.X.shape[0]
    idx = np.asarray(jax.vmap(lambda t: jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(seed), t), (batch,), 0, n))(
            jnp.arange(steps)))
    X, V, y = (np.asarray(a) for a in (ds.X, ds.V, ds.y))
    first = rsyn.rsl_batch(ds, seed, 0, batch)
    assert np.array_equal(np.asarray(first["x"]), X[idx[0]])
    return [{"x": X[i], "v": V[i], "y": y[i]} for i in idx]


def _tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _train(opts, steps=60, seed=0, generators=None):
    """test_rsgd.py's _train on the port: the reference's dataset, point
    and batches; ``generators(t)`` gives the step's generator."""
    _, ds_ref, W_ref = _ref_problem(seed)
    ds = bridge.rsl_dataset(ds_ref, device="cpu")
    W = bridge.fixed_rank_point(W_ref, device="cpu")
    losses = []
    for t, b in enumerate(_ref_batches(seed, steps)):
        b = _tb(b)
        gen = generators(t) if generators else None
        W, loss = trs.rsgd_step(W, b["x"], b["v"], b["y"], opts,
                                generator=gen)
        losses.append(float(loss))
    acc = float(trs.accuracy(W, ds.X, ds.V, ds.y))
    return losses, acc, W


def _gens(seed=0):
    return lambda t: torch.Generator().manual_seed(1000 * seed + t)


# --- tests/test_rsgd.py on the port --------------------------------------------

def test_rsgd_converges_fsvd_retraction():
    losses, acc, _ = _train(trs.RSGDOptions(lr=3.0, fsvd_iters=15),
                            steps=120)
    assert np.mean(losses[-10:]) < 0.5 * np.mean(losses[:5])
    assert acc > 0.9


def test_rsgd_qr_and_fsvd_match():
    """Same trajectory under both retractions (they compute the same map)."""
    o1 = trs.RSGDOptions(lr=0.05, retraction="qr")
    o2 = trs.RSGDOptions(lr=0.05, retraction="fsvd", fsvd_iters=25)
    l1, a1, W1 = _train(o1, steps=20)
    l2, a2, W2 = _train(o2, steps=20)
    np.testing.assert_allclose(l1, l2, rtol=0.05, atol=0.02)
    np.testing.assert_allclose(_np(tmf.to_dense(W1)), _np(tmf.to_dense(W2)),
                               atol=0.05)


def test_rsgd_paper_literal_projection_variant():
    losses, acc, _ = _train(
        trs.RSGDOptions(lr=1.0, fsvd_iters=15, project_at="grad"), steps=80,
        generators=_gens())
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:5])


def test_rsgd_logistic_loss():
    losses, acc, _ = _train(
        trs.RSGDOptions(lr=1.0, loss="logistic", fsvd_iters=15))
    assert np.mean(losses[-10:]) < np.mean(losses[:5])


def test_rank_preserved():
    _, _, W = _train(trs.RSGDOptions(lr=0.1, fsvd_iters=15), steps=10)
    assert W.rank == 3
    assert float(torch.min(W.s)) > 0


def test_weight_decay_shrinks_spectrum():
    o_plain = trs.RSGDOptions(lr=0.05)
    o_decay = trs.RSGDOptions(lr=0.05, weight_decay=0.5)
    _, _, W1 = _train(o_plain, steps=30, seed=3)
    _, _, W2 = _train(o_decay, steps=30, seed=3)
    assert float(W2.s.sum()) < float(W1.s.sum())


@pytest.mark.parametrize("loss,wd", [("hinge", 0.0), ("hinge", 0.3),
                                     ("logistic", 0.0)])
def test_batch_grad_matches_dense(loss, wd):
    """Implicit batch-gradient operator == torch.autograd of the dense
    loss, and == the reference's operator on the same inputs."""
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 4)
    Xb = jax.random.normal(ks[0], (16, 10))
    Vb = jax.random.normal(ks[1], (16, 12))
    W_ref = rmf.random_point(ks[2], 10, 12, 3)
    y = jnp.sign(jax.random.normal(ks[3], (16,)))
    W = bridge.fixed_rank_point(W_ref, device="cpu")
    tX, tV, ty = (torch.from_numpy(np.array(a)) for a in (Xb, Vb, y))
    bg = trs.batch_euclidean_grad(W, tX, tV, ty, loss, wd)

    Wd = tmf.to_dense(W).detach().requires_grad_()
    yhat = torch.einsum("bi,ij,bj->b", tX, Wd, tV)
    if loss == "hinge":
        per = torch.clamp(1.0 - ty * yhat, min=0.0)
    else:
        per = torch.logaddexp(torch.zeros_like(yhat), -ty * yhat)
    (per.mean() + 0.5 * wd * torch.sum(Wd * Wd)).backward()
    np.testing.assert_allclose(_np(linop_dense(bg.op)), _np(Wd.grad),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(float(bg.loss), float(per.mean().detach()),
                               rtol=1e-6)

    ref = rrs.batch_euclidean_grad(W_ref, Xb, Vb, y, loss, wd)
    np.testing.assert_allclose(_np(linop_dense(bg.op)),
                               np.asarray(ref_linop_dense(ref.op)),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(float(bg.loss), float(ref.loss), rtol=1e-6)


@pytest.mark.parametrize("fn", ["hinge", "logistic"])
def test_losses_match_reference(fn):
    z = np.linspace(-40.0, 40.0, 161, dtype=np.float32)
    y = np.where(np.arange(z.size) % 2 == 0, 1.0, -1.0).astype(np.float32)
    ref_l, ref_g = rrs.LOSSES[fn](jnp.asarray(z), jnp.asarray(y))
    got_l, got_g = trs.LOSSES[fn](torch.from_numpy(z), torch.from_numpy(y))
    np.testing.assert_allclose(_np(got_l), np.asarray(ref_l), rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(_np(got_g), np.asarray(ref_g), rtol=1e-6,
                               atol=1e-30)


# --- 20 steps side by side ----------------------------------------------------

PARITY = {
    "fsvd-track": dict(fsvd_iters=25),
    "fsvd-cold": dict(fsvd_iters=25, track=False),
    "qr": dict(retraction="qr"),
    "project-grad": dict(fsvd_iters=15, project_at="grad"),
    "logistic": dict(fsvd_iters=25, loss="logistic"),
    "weight-decay": dict(fsvd_iters=25, weight_decay=0.5),
}


@pytest.mark.parametrize("name", list(PARITY))
def test_trajectory_matches_reference(monkeypatch, name):
    steps, seed = 20, 0
    key, ds_ref, W_ref = _ref_problem(seed)
    ref_opts = rrs.RSGDOptions(lr=0.05, **PARITY[name])
    opts = trs.RSGDOptions(lr=0.05, **PARITY[name])
    assert {f: getattr(opts, f) for f in opts.__dataclass_fields__} == \
        {f: getattr(ref_opts, f) for f in ref_opts.__dataclass_fields__}

    batches = _ref_batches(seed, steps)
    ref_losses = []
    W = W_ref
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for t, b in enumerate(batches):
            W, loss = rrs.rsgd_step(W, jnp.asarray(b["x"]),
                                    jnp.asarray(b["v"]), jnp.asarray(b["y"]),
                                    ref_opts, key=jax.random.fold_in(key, t))
            ref_losses.append(float(loss))
    ref_dense = np.asarray(rmf.to_dense(W))

    # the reference's draw of step t: start_vector(fold_in(key, t), d1)
    draws = {}

    def generators(t):
        g = torch.Generator().manual_seed(t)
        draws[id(g)] = (g, np.array(ref_gk.start_vector(
            jax.random.fold_in(key, t), W_ref.U.shape[0])))
        return g

    def start_vector(generator, m, dtype, device):
        q1 = draws[id(generator)][1]
        assert q1.shape == (m,)
        return torch.from_numpy(q1).to(device=device, dtype=dtype)

    monkeypatch.setattr(tgk, "start_vector", start_vector)
    losses, _, Wp = _train(opts, steps=steps, seed=seed,
                           generators=generators)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(tmf.to_dense(Wp)), ref_dense,
                               atol=W_ATOL)


# --- the makers, and the compile-once meaning ----------------------------------

def test_rsl_batch_is_a_pure_function_of_seed_and_step():
    ds = tsyn.make_rsl_dataset(torch.Generator().manual_seed(5), 300, 20,
                               16, 3)
    a = tsyn.rsl_batch(ds, 7, 3, 32)
    b = tsyn.rsl_batch(ds, 7, 3, 32)
    for k in ("x", "v", "y"):
        assert torch.equal(a[k], b[k])
        assert a[k].shape[0] == 32 and a[k].device == ds.X.device
    other_step = tsyn.rsl_batch(ds, 7, 4, 32)
    other_seed = tsyn.rsl_batch(ds, 8, 3, 32)
    assert not torch.equal(a["x"], other_step["x"])
    assert not torch.equal(a["x"], other_seed["x"])
    # the rows are rows of the dataset, with their labels
    rows = [int(torch.nonzero((ds.X == x).all(1))[0]) for x in a["x"]]
    assert torch.equal(ds.V[rows], a["v"]) and torch.equal(ds.y[rows],
                                                           a["y"])


def test_make_rsl_dataset_gives_the_reference_dataset(monkeypatch):
    """Handed the reference's five draws, the maker gives the reference's
    dataset: labels from the population std (``jnp.std``), as there."""
    key = jax.random.PRNGKey(4)
    n, d1, d2, rank, noise = 400, 30, 20, 3, 0.5
    ref = rsyn.make_rsl_dataset(key, n, d1, d2, rank, noise=noise)
    kx, kv, kw1, kw2, kn = jax.random.split(key, 5)
    seq = iter([jax.random.normal(kx, (n, d1)), jax.random.normal(kv, (n, d2)),
                jax.random.normal(kw1, (d1, rank)),
                jax.random.normal(kw2, (rank, d2)),
                jax.random.normal(kn, (n,))])

    def normal(generator, shape, **_):
        z = next(seq)
        assert tuple(z.shape) == tuple(shape)
        return torch.from_numpy(np.array(z))

    monkeypatch.setattr(tsyn, "normal", normal)
    got = tsyn.make_rsl_dataset(torch.Generator(), n, d1, d2, rank,
                                noise=noise)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(_np(got.true_spectrum()),
                               np.asarray(ref.true_spectrum()), rtol=1e-5)
    np.testing.assert_allclose(_np(got.W_true), np.asarray(ref.W_true),
                               rtol=1e-5, atol=1e-6)
    # the planted spectrum is the dense metric's
    np.testing.assert_allclose(
        _np(got.true_spectrum()),
        _np(torch.linalg.svdvals(got.W_true))[:rank], rtol=1e-4)


def test_make_step_builds_one_runner():
    """``jit`` keeps the call site; the plan cache gives the reference's
    compile-once meaning: N same-shaped steps are one trace."""
    _, ds_ref, W_ref = _ref_problem(0)
    W = bridge.fixed_rank_point(W_ref, device="cpu")
    step = trs.make_step(trs.RSGDOptions(lr=0.05, fsvd_iters=15), jit=True)
    clear_plan_cache()
    before = trace_count()
    for b in _ref_batches(0, 6):
        b = _tb(b)
        W, loss = step(W, b["x"], b["v"], b["y"])
    assert trace_count() - before == 1
    assert torch.isfinite(loss) and W.rank == 3
    acc = trs.accuracy(W, *(torch.from_numpy(np.array(a)) for a in
                            (ds_ref.X, ds_ref.V, ds_ref.y)))
    np.testing.assert_allclose(
        float(acc), float(rrs.accuracy(
            rmf.FixedRankPoint(*(jnp.asarray(_np(a)) for a in W)),
            ds_ref.X, ds_ref.V, ds_ref.y)), atol=1 / 512)
