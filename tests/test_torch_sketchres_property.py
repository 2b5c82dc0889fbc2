"""Hypothesis properties of the port's count-sketch fold path, on its own
seeded ensemble (the counterpart of tests/test_sketchres_property.py).

* **Unbiasedness** — the port's hashed-sign tables, drawn from seeded
  ``torch.Generator``s, satisfy ``E[T Tᵀ] = I``: the seed-averaged
  ``T Tᵀ x`` converges on ``x`` at the Monte-Carlo rate (the reference's
  0.2 bound, a ~6σ margin over the ~0.03 expected error).
* **Duplicate-slot exactness** — ``ops.scatter_add`` (on the CPU, its
  plain version) agrees with ``np.add.at`` in f32 and with the integer
  ground truth bit for bit under forced collisions on dyadic values.
* **Fold/sketch commutation** — folding a COO batch into a state sketched
  with a seeded generator equals sketching the updated operand with the
  same generator seed, to the reference's 1e-5 relative Frobenius bound.

Skips cleanly when hypothesis is absent (dev/CI requirement).
"""
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis", reason="property sweep needs hypothesis (dev requirement)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.api import SVDSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sketchres import apply_entries, sketch_operand  # noqa: E402
from repro_torch.sketchres.state import _dense, _hashed  # noqa: E402

SPEC = SVDSpec(method="gnystrom", rank=4, oversample=4)


@settings(max_examples=15, deadline=None)
@given(st.integers(3, 10), st.integers(0, 2**31 - 1))
def test_hashed_ensemble_unbiased(n, seed):
    """E[T Tᵀ x] = x over independently seeded tables."""
    d, K = 64, 160
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    x /= np.linalg.norm(x)
    acc = np.zeros(n, np.float64)
    for i in range(K):
        g = torch.Generator().manual_seed(seed * K + i)
        slots, signs = _hashed(g, n, d, 4)
        assert slots.dtype == torch.int32
        assert int(slots.min()) >= 0 and int(slots.max()) < d
        T = _dense(slots, signs, d).double().numpy()
        acc += T @ (T.T @ x)
    assert np.linalg.norm(acc / K - x) < 0.2


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 64), st.integers(1, 4), st.integers(1, 4),
       st.integers(0, 2**31 - 1))
def test_scatter_add_duplicates_bitexact(e, m, d, seed):
    """Forced collisions (tiny destination grid) with dyadic values:
    duplicates SUM, bit for bit."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, e).astype(np.int32)
    cols = rng.integers(0, d, e).astype(np.int32)
    # dyadic grid: every value and every partial sum is exact in f32
    vals = (rng.integers(-8, 9, e) * 0.25).astype(np.float32)
    got = ops.scatter_add(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals), (m, d)).numpy()
    want = np.zeros((m, d), np.float32)
    np.add.at(want, (rows, cols), vals)
    np.testing.assert_array_equal(got, want)
    dense = np.zeros((m, d), np.float64)
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    np.testing.assert_array_equal(got, dense.astype(np.float32))


@settings(max_examples=15, deadline=None)
@given(st.integers(8, 40), st.integers(8, 40), st.integers(1, 120),
       st.integers(0, 2**31 - 1))
def test_fold_commutes_with_sketch(m, n, e, seed):
    """apply_entries(sketch(A), Δ) == sketch(A + Δ) with the same seeds."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    rows = rng.integers(0, m, e).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    vals = rng.standard_normal(e).astype(np.float32)

    def sketch(M):
        return sketch_operand(torch.from_numpy(M), SPEC,
                              generator=torch.Generator().manual_seed(seed))

    folded = apply_entries(sketch(A), rows, cols, vals)
    A2 = A.copy()
    np.add.at(A2, (rows, cols), vals)
    fresh = sketch(A2)
    assert folded.seeds == fresh.seeds
    for got, want in ((folded.Y, fresh.Y), (folded.Z, fresh.Z)):
        scale = max(float(torch.linalg.vector_norm(want)), 1e-12)
        assert float(torch.linalg.vector_norm(got - want)) < 1e-5 * scale
