"""The port's sketch-resident state (repro_torch.sketchres) against the
reference package (repro.sketchres) on the CPU.

Each case of tests/test_sketchres.py:56-200 — panels against the dense
test matrices, fold = fresh sketch, dense against entry fold, low-rank
against materialized, xla against pallas backend, the ``pad_entries``
no-op, the odometer, ``reconstruct`` accuracy and drift tracking — runs
on both packages, on the reference's inputs, with the reference's own
hashed-sign tables (``repro.sketchres.state._hashed`` of its keys) handed
to the port (``bridge.hashed_sketch``).  Every invariant is asserted for
both packages, and the port's panels are held against the reference's.

Tolerances.  With f32 panels, the reference's own bounds: 1e-5 absolute
on the panels (2e-5 for dense against entry folds, 1e-6 for the two
backends), 1e-5 relative Frobenius for fold against fresh sketch, 1e-4 and
1e-3 relative reconstruction error.  With ``precision="bf16"`` the panels
are rounded to bf16 after the sweep and after each fold: a panel is then
held elementwise to one bf16 ulp, 2^-7 relative (two values within f32
roundoff of each other round at most one ulp apart); fold against fresh
sketch, which rounds twice against once, to 2^-7 relative Frobenius; the
reconstructions, which start from panels accurate to 2^-9 relative, to
1e-2 (exact-rank operand) and 2e-2 (drift tracking; the drifted rank-6
operand is still inside the k = 14 range).  On the CPU the pallas backend
folds through the plain version of the scatter-add kernel (the kernel is
held on the card by tests/test_torch_gpu.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sketchres as rsk
from repro.api import SVDSpec as RefSpec
from repro.core.operators import LowRankOp as RefLowRankOp
from repro.kernels.sketch_matvec import ZETA
from repro.sketchres.state import _hashed as ref_hashed
from repro_torch import bridge
from repro_torch import sketchres as tsk
from test_sketchres import KEY, _coo_apply, _entries, _lowrank

PRECISIONS = [None, "bf16"]
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
RECON = {None: 1e-4, "bf16": 1e-2}        # exact-rank reconstruction
TRACK = {None: 1e-3, "bf16": 2e-2}        # drift tracking


def _spec(precision):
    return RefSpec(method="gnystrom", rank=6, oversample=8,
                   precision=precision)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=None):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype or
                                                       torch.float32)


def _pair(A, precision, backend=None):
    """(reference state, port state) of one sweep over A, the port given
    the reference's tables."""
    rspec = _spec(precision)
    rst = rsk.sketch_operand(A, rspec, key=KEY, backend=backend)
    m, n = A.shape
    k, l = rst.panel_dims
    om = bridge.hashed_sketch(*ref_hashed(rst.okey, n, k, ZETA), k,
                              device="cpu")
    ps = bridge.hashed_sketch(*ref_hashed(rst.pkey, m, l, ZETA), l,
                              device="cpu")
    tst = tsk.sketch_operand(_t(np.asarray(A)), bridge.spec(rspec),
                             omega=om, psi=ps, backend=backend)
    return rst, tst


def _panel_close(got, want, precision, atol):
    rtol = BF16_RTOL if precision == "bf16" else 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _same_panels(rst, tst, precision, atol=1e-5):
    _panel_close(tst.Y, rst.Y, precision, atol)
    _panel_close(tst.Z, rst.Z, precision, atol)


# --------------------------------------------------------------------------
# state + folds (tests/test_sketchres.py:56-161)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
def test_sketch_operand_panels_match_dense_test_matrices(precision):
    A = _lowrank(jax.random.PRNGKey(0), 40, 30, 6)
    rst, tst = _pair(A, precision)
    om, ps = tst.sketches()
    At = _t(np.asarray(A))
    _panel_close(tst.Y, At @ om.dense(), precision, 1e-5)
    _panel_close(tst.Z, ps.dense().T @ At, precision, 1e-5)
    rom, rps = rst.sketches()
    _panel_close(rst.Y, A @ rom.dense(), precision, 1e-5)
    _same_panels(rst, tst, precision)
    np.testing.assert_allclose(_np(om.dense()), _np(rom.dense()), rtol=0,
                               atol=0)
    assert tst.panel_dims == rst.panel_dims == (14, 28)
    assert tst.Y.dtype == (torch.bfloat16 if precision else torch.float32)
    assert float(tst.folded_mass) == 0.0
    assert float(tst.base_norm) > 0.0
    np.testing.assert_allclose(float(tst.base_norm), float(rst.base_norm),
                               rtol=1e-5)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_apply_entries_matches_fresh_sketch_same_seeds(precision):
    """A fold IS the sketch of the drifted operand (same tables), to f32
    scatter roundoff (or bf16 storage rounding)."""
    rng = np.random.default_rng(1)
    A = _lowrank(jax.random.PRNGKey(1), 48, 36, 6)
    rst, tst = _pair(A, precision)
    rows, cols, vals = _entries(rng, 48, 36, 300, scale=1e-2)
    A2 = _coo_apply(A, rows, cols, vals)
    rfresh, tfresh = _pair(A2, precision)
    rfold = rsk.apply_entries(rst, rows, cols, vals)
    tfold = tsk.apply_entries(tst, _t(rows, torch.int32),
                              _t(cols, torch.int32), _t(vals))
    bound = BF16_RTOL if precision == "bf16" else 1e-5
    for fold, fresh in ((rfold, rfresh), (tfold, tfresh)):
        assert _rel(fold.Y, fresh.Y) < bound
        assert _rel(fold.Z, fresh.Z) < bound
    assert _rel(tfold.Y, rfold.Y) < bound
    assert _rel(tfold.Z, rfold.Z) < bound
    np.testing.assert_allclose(float(tfold.folded_mass),
                               float(np.linalg.norm(vals)), rtol=1e-6)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_apply_dense_delta_equals_entry_fold(precision):
    rng = np.random.default_rng(2)
    A = _lowrank(jax.random.PRNGKey(2), 32, 24, 5)
    rst, tst = _pair(A, precision)
    D = (1e-3 * rng.standard_normal((32, 24))).astype(np.float32)
    rr, cc = np.meshgrid(np.arange(32), np.arange(24), indexing="ij")
    for pkg, st, Dx in ((rsk, rst, jnp.asarray(D)), (tsk, tst, _t(D))):
        via_entries = pkg.apply_entries(st, rr.ravel(), cc.ravel(),
                                        D.ravel())
        via_block = pkg.apply_dense_delta(st, Dx)
        _panel_close(via_entries.Y, via_block.Y, precision, 2e-5)
        _panel_close(via_entries.Z, via_block.Z, precision, 2e-5)
        # dense-block mass is the exact ‖D‖_F = ℓ2 of the entry values
        np.testing.assert_allclose(float(via_entries.folded_mass),
                                   float(via_block.folded_mass), rtol=1e-5)
        if pkg is rsk:
            ref_block = via_block
    _same_panels(ref_block, via_block, precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_apply_lowrank_delta_matches_materialized(precision):
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    A = _lowrank(k1, 40, 28, 5)
    rst, tst = _pair(A, precision)
    U = jax.random.normal(k2, (40, 2))
    Vt = jax.random.normal(jax.random.PRNGKey(5), (2, 28))
    s = jnp.asarray([1e-3, 5e-4])
    r_op = rsk.apply_lowrank_delta(rst, RefLowRankOp(U, s, Vt))
    r_dense = rsk.apply_dense_delta(rst, (U * s) @ Vt)
    t_op = tsk.apply_lowrank_delta(tst, bridge.lowrank(U, s, Vt,
                                                       device="cpu"))
    t_dense = tsk.apply_dense_delta(tst, _t(np.asarray((U * s) @ Vt)))
    for via_op, via_dense in ((r_op, r_dense), (t_op, t_dense)):
        _panel_close(via_op.Y, via_dense.Y, precision, 1e-5)
        _panel_close(via_op.Z, via_dense.Z, precision, 1e-5)
    _same_panels(r_op, t_op, precision)
    # the factored fold's mass is the ‖ΨᵀΔ‖_F sketch estimate
    np.testing.assert_allclose(float(t_op.folded_mass),
                               float(r_op.folded_mass), rtol=1e-5)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pallas_and_xla_backends_agree(precision):
    rng = np.random.default_rng(3)
    A = _lowrank(jax.random.PRNGKey(6), 36, 30, 5)
    rx, tx = _pair(A, precision, backend="xla")
    rp = dataclasses.replace(rx, backend="pallas")
    tp = dataclasses.replace(tx, backend="pallas")
    rows, cols, vals = _entries(rng, 36, 30, 200)
    folds = [pkg.apply_entries(st, rows, cols, vals)
             for pkg, st in ((rsk, rx), (rsk, rp), (tsk, tx), (tsk, tp))]
    for fx, fp in (folds[:2], folds[2:]):
        _panel_close(fx.Y, fp.Y, precision, 1e-6)
        _panel_close(fx.Z, fp.Z, precision, 1e-6)
    _same_panels(folds[1], folds[3], precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pad_entries_is_exact_noop(precision):
    rng = np.random.default_rng(4)
    A = _lowrank(jax.random.PRNGKey(7), 24, 20, 4)
    _, tst = _pair(A, precision)
    rows, cols, vals = _entries(rng, 24, 20, 37)
    pr, pc, pv = tsk.pad_entries(rows, cols, vals, device="cpu")
    assert pr.shape[0] == 64                       # quantum, pow2
    assert (pr.dtype, pc.dtype, pv.dtype) == (torch.int32, torch.int32,
                                              torch.float32)
    more = tsk.pad_entries(*_entries(rng, 24, 20, 65), device="cpu")
    assert more[0].shape[0] == 128
    assert [x.shape[0] for x in rsk.pad_entries(rows, cols, vals)] == \
        [x.shape[0] for x in (pr, pc, pv)]
    raw = tsk.apply_entries(tst, rows, cols, vals)
    padded = tsk.apply_entries(tst, pr, pc, pv)
    assert torch.equal(raw.Y, padded.Y)
    assert torch.equal(raw.Z, padded.Z)
    np.testing.assert_allclose(float(raw.folded_mass),
                               float(padded.folded_mass), rtol=1e-6)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_staleness_odometer_trips_and_only_then(precision):
    A = _lowrank(jax.random.PRNGKey(8), 32, 24, 4)
    rst, tst = _pair(A, precision)
    for pkg, st in ((rsk, rst), (tsk, tst)):
        assert not bool(pkg.is_stale(st))
        # a fold of exactly budget*base_norm mass lands the ratio on 1.0
        target = float(st.budget * st.base_norm)
        small = pkg.apply_entries(st, [0], [0], [0.1 * target])
        assert not bool(pkg.is_stale(small))
        assert 0.0 < float(pkg.staleness_ratio(small)) < 1.0
        big = pkg.apply_entries(small, [1], [1], [target])
        assert bool(pkg.is_stale(big))
        assert float(pkg.staleness_ratio(big)) >= 1.0
    stale = tsk.is_stale(big)
    assert isinstance(stale, torch.Tensor) and stale.shape == () \
        and stale.dtype == torch.bool


# --------------------------------------------------------------------------
# reconstruction (tests/test_sketchres.py:164-200)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("precision", PRECISIONS)
def test_reconstruct_zero_iterations_and_accuracy(precision):
    A = _lowrank(jax.random.PRNGKey(9), 60, 44, 6)
    rst, tst = _pair(A, precision)
    An = np.asarray(A, np.float64)
    for pkg, st in ((rsk, rst), (tsk, tst)):
        f = pkg.reconstruct(st, _spec(precision))
        assert int(f.iterations) == 0
        assert f.method == "sketch"
        assert not bool(f.breakdown)
        Ahat = (_np(f.U) * _np(f.s)) @ _np(f.V).T
        rel = np.linalg.norm(Ahat - An) / np.linalg.norm(An)
        assert rel < RECON[precision]                # exact-rank operand
        if pkg is rsk:
            rs = _np(f.s)
    np.testing.assert_allclose(_np(f.s), rs, rtol=0,
                               atol=RECON[precision] * rs[0])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_reconstruct_tracks_folded_drift(precision):
    """A rank-1 block shipped entry by entry: after the fold, reconstruct
    matches the drifted operand and is far from the pre-drift one."""
    m, n = 60, 44
    A = _lowrank(jax.random.PRNGKey(10), m, n, 5)
    u = jax.random.normal(jax.random.PRNGKey(30), (m,))
    v = jax.random.normal(jax.random.PRNGKey(31), (n,))
    D = np.asarray(0.05 * jnp.outer(u, v))           # rank-1, ~5% mass
    rst, tst = _pair(A, precision)
    rr, cc = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    An = np.asarray(A, np.float64)
    A2 = An + D
    for pkg, st in ((rsk, rst), (tsk, tst)):
        st = pkg.apply_entries(st, rr.ravel(), cc.ravel(), D.ravel())
        f = pkg.reconstruct(st, _spec(precision))
        Ahat = (_np(f.U) * _np(f.s)) @ _np(f.V).T
        rel = np.linalg.norm(Ahat - A2) / np.linalg.norm(A2)
        stale_rel = np.linalg.norm(Ahat - An) / np.linalg.norm(An)
        assert rel < TRACK[precision]
        assert stale_rel > 10 * rel


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("row,col", [(-1, 3), (3, -2), (40, 3), (3, 30)])
def test_entries_outside_the_operand(backend, row, col):
    """An entry whose row or column lies outside the 40 x 30 operand: the
    table lookup wraps a negative index and clamps, and the scatter drops
    the destination outside the panel — the reference's pallas fold, bit
    for bit; its xla fold too, except that it wraps a negative scatter
    destination the port drops."""
    A = _lowrank(jax.random.PRNGKey(0), 40, 30, 6)
    rst, tst = _pair(A, None, backend=backend)
    rows, cols = np.asarray([row], np.int32), np.asarray([col], np.int32)
    vals = np.asarray([16.0], np.float32)
    rfold = rsk.apply_entries(dataclasses.replace(rst, backend="pallas"),
                              rows, cols, vals)
    tfold = tsk.apply_entries(tst, rows, cols, vals)
    for got, want, base in ((tfold.Y, rfold.Y, rst.Y),
                            (tfold.Z, rfold.Z, rst.Z)):
        _panel_close(got - _t(np.asarray(base)),
                     np.asarray(want - base), None, 1e-5)
    if backend == "xla" and min(row, col) >= 0:
        xfold = rsk.apply_entries(rst, rows, cols, vals)
        _same_panels(xfold, tfold, None)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bridge_sketch_state_carries_the_reference_state(precision):
    """A reference state carried over whole (panels, odometer, budget,
    backend) folds the next entries as the reference does."""
    rng = np.random.default_rng(5)
    A = _lowrank(jax.random.PRNGKey(11), 36, 28, 5)
    rst, tst = _pair(A, precision, backend="pallas")
    rst = rsk.apply_entries(rst, *_entries(rng, 36, 28, 50))
    carried = bridge.sketch_state(rst, *tst.sketches(), device="cpu")
    assert carried.seeds is None and carried.backend == "pallas"
    assert carried.Y.dtype == tst.Y.dtype
    assert float(carried.folded_mass) == float(rst.folded_mass)
    rows, cols, vals = _entries(rng, 36, 28, 80)
    _same_panels(rsk.apply_entries(rst, rows, cols, vals),
                 tsk.apply_entries(carried, rows, cols, vals), precision)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_entry_fold_with_a_range_sketch_narrower_than_zeta(backend):
    """k = 4 < ZETA = 8 <= l = 8: each table is expanded by its own slot
    count, so the fold of a stream with duplicate entries equals a fresh
    sketch of the edited operand with the same seeds.  Port only: the
    reference tiles both expansions by the range table's slot count and
    raises here (src/repro/sketchres/state.py:230,236,241)."""
    from repro_torch.api import SVDSpec
    rng = np.random.default_rng(16)
    A = _t(np.asarray(_lowrank(jax.random.PRNGKey(16), 40, 30, 2)))
    spec = SVDSpec(method="gnystrom", rank=2, sketch_dim=4, backend=backend)

    def sketch(op):
        return tsk.sketch_operand(op, spec,
                                  generator=torch.Generator().manual_seed(9))

    st = sketch(A)
    k, l = st.panel_dims
    assert k < ZETA <= l
    rows, cols, vals = _entries(rng, 40, 30, 60, scale=1e-2)
    rows, cols, vals = (np.concatenate([x, x[:20]])
                        for x in (rows, cols, vals))     # 20 duplicates
    folded = tsk.apply_entries(st, _t(rows, torch.int32),
                               _t(cols, torch.int32), _t(vals))
    fresh = sketch(_t(np.asarray(_coo_apply(np.asarray(A), rows, cols,
                                            vals))))
    assert fresh.seeds == st.seeds
    assert _rel(folded.Y, fresh.Y) < 1e-5
    assert _rel(folded.Z, fresh.Z) < 1e-5


def test_seeded_state_rederives_its_tables():
    """Without injected tables the state carries two seeds drawn from the
    caller's generator (a missing one warns) and re-derives the same
    tables on every fold."""
    from repro_torch.api import ImplicitKeyWarning
    A = _t(np.asarray(_lowrank(jax.random.PRNGKey(12), 30, 24, 4)))
    spec = bridge.spec(_spec(None))
    st = tsk.sketch_operand(A, spec,
                            generator=torch.Generator().manual_seed(5))
    assert st.tables is None and len(st.seeds) == 2
    (o1, p1), (o2, p2) = st.sketches(), st.sketches()
    assert torch.equal(o1.slots, o2.slots) and torch.equal(p1.signs, p2.signs)
    assert torch.equal(st.Y, A @ o1.dense())
    again = tsk.sketch_operand(A, spec,
                               generator=torch.Generator().manual_seed(5))
    assert again.seeds == st.seeds and torch.equal(again.Z, st.Z)
    with pytest.warns(ImplicitKeyWarning):
        tsk.sketch_operand(A, spec)
    with pytest.raises(ValueError, match="together"):
        tsk.sketch_operand(A, spec, omega=o1)
