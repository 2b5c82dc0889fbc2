"""The port's operator algebra and matrix-free operands
(repro_torch.core.operators, padding, linop, data.synthetic) against the
reference package on the CPU.

Every operator kind is built on the reference side (its own constructors,
seeded JAX draws) and carried over with ``repro_torch.bridge.operator``,
so both packages multiply the same operand.  The laws of
tests/test_operators.py and tests/test_operators_property.py (adjoint,
involution, linearity, Kronecker with mixed factors, Gram sides) are held
on every kind at fixed seeds.  The solvers on sparse and Kronecker
operands run with the reference's own start vector or block, and are held
at ``SOLVERS[method]["stol"]``; the densify guard is that of
tests/test_solver_parity.py:273-340.

Tolerances: products rtol 1e-5 with atol 1e-5·max|ref| (f32, only the
summation order differs; the reference's own law tests use 1e-5 to 1e-4);
laws at the reference's 1e-4 / 1e-3.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import repro.api as rapi
import repro.core.operators as jops
from repro.api.plan import resolve_method as ref_resolve_method
from repro.core import padding as jpad
from repro.data.synthetic import make_kron_problem as ref_kron_problem
from repro.data.synthetic import make_sparse_problem as ref_sparse_problem
from repro_torch import bridge
from repro_torch.api import SVDSpec, estimate_rank, factorize, resolve_method
from repro_torch.core import gk_block, linop, padding
from repro_torch.core import operators as tops
from repro_torch.core.operators import (DenseOp, GramOp, KroneckerOp,
                                        LowRankOp, Operator, ScaledOp,
                                        SinglePassOp, SparseOp, SumOp,
                                        TransposedOp, as_operator, to_dense)
from repro_torch.data import synthetic
from repro_torch.kernels import sparse_matvec as spm
from test_solver_parity import R, SOLVERS

KINDS = ("dense", "lowrank", "lowrank_extra", "sparse", "sparse_pallas",
         "kron", "kron_mixed", "gram", "sum", "scaled", "transposed",
         "single_pass")
SEEDS = (3, 11)


def _ref_op(kind: str, m: int, n: int, seed: int):
    """A reference operator of ``kind`` (shape (m, n) unless the kind fixes
    its own) and its dense oracle."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    A = jax.random.normal(ks[0], (m, n))
    if kind == "dense":
        return jops.DenseOp(A), A
    if kind in ("lowrank", "lowrank_extra"):
        r = max(min(m, n) // 2, 1)
        U = jnp.linalg.qr(jax.random.normal(ks[1], (m, r)))[0]
        s = jnp.abs(jax.random.normal(ks[2], (r,))) + 0.1
        Vt = jnp.linalg.qr(jax.random.normal(ks[3], (n, r)))[0].T
        dense = (U * s[None, :]) @ Vt
        if kind == "lowrank":
            return jops.LowRankOp(U, s, Vt), dense
        L = jax.random.normal(ks[4], (m, 2))
        Rf = jax.random.normal(ks[1], (2, n))
        return (jops.LowRankOp(U, s, Vt, extra=((L, Rf),), scale=-0.7),
                -0.7 * (dense + L @ Rf))
    if kind in ("sparse", "sparse_pallas"):
        S = jnp.where(jax.random.bernoulli(ks[1], 0.3, (m, n)), A, 0.0)
        backend = "pallas" if kind == "sparse_pallas" else "xla"
        return jops.SparseOp.fromdense(S, backend=backend), S
    if kind in ("kron", "kron_mixed"):
        B = jax.random.normal(ks[1], (max(m // 2, 1), max(n // 2, 1)))
        C = jax.random.normal(ks[2], (2, 3))
        if kind == "kron":
            return (jops.KroneckerOp(jops.DenseOp(B), jops.DenseOp(C)),
                    jnp.kron(B, C))
        Bs = jnp.where(jax.random.bernoulli(ks[3], 0.5, B.shape), B, 0.0)
        return (jops.KroneckerOp(jops.SparseOp.fromdense(Bs),
                                 jops.DenseOp(C)), jnp.kron(Bs, C))
    if kind == "gram":
        return jops.GramOp(jops.DenseOp(A)), A.T @ A
    if kind == "sum":
        B = jax.random.normal(ks[1], (m, n))
        return jops.SumOp((jops.DenseOp(A), jops.DenseOp(B))), A + B
    if kind == "scaled":
        return jops.ScaledOp(-1.7, jops.DenseOp(A)), -1.7 * A
    if kind == "transposed":
        return jops.TransposedOp(jops.DenseOp(A)), A.T
    if kind == "single_pass":
        return jops.SinglePassOp(jops.DenseOp(A)), A
    raise AssertionError(kind)


def _pair(kind, m=9, n=7, seed=0):
    ref, dense = _ref_op(kind, m, n, seed)
    return ref, bridge.operator(ref, device="cpu"), np.asarray(dense)


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


def _close(got, want, tol=1e-5):
    want = _np(want)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _vec(k, seed):
    return np.random.default_rng(seed).standard_normal(k).astype(np.float32)


def _block(k, w, seed):
    return np.random.default_rng(seed).standard_normal(
        (k, w)).astype(np.float32)


# --------------------------------------------------------------------------
# every kind against the reference operator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_products_match_reference(kind):
    ref, op, _ = _pair(kind, seed=1)
    m, n = ref.shape
    assert tuple(op.shape) == (m, n)
    p, q = _vec(n, 1), _vec(m, 2)
    V, Q = _block(n, 3, 3), _block(m, 4, 4)
    _close(op.mv(torch.from_numpy(p)), ref.mv(jnp.asarray(p)))
    _close(op.rmv(torch.from_numpy(q)), ref.rmv(jnp.asarray(q)))
    _close(op.matmat(torch.from_numpy(V)), ref.matmat(jnp.asarray(V)))
    _close(op.rmatmat(torch.from_numpy(Q)), ref.rmatmat(jnp.asarray(Q)))
    y = _vec(m, 5)
    _close(op.mv_fused(torch.from_numpy(p), torch.from_numpy(y), 0.7),
           ref.mv_fused(jnp.asarray(p), jnp.asarray(y), 0.7))
    _close(op.rmv_fused(torch.from_numpy(q), torch.from_numpy(p), 0.3),
           ref.rmv_fused(jnp.asarray(q), jnp.asarray(p), 0.3))


@pytest.mark.parametrize("kind", KINDS)
def test_to_dense_and_transpose_involution(kind):
    ref, op, dense = _pair(kind, seed=2)
    _close(to_dense(op), jops.to_dense(ref))
    _close(to_dense(op), dense, 1e-4)
    _close(to_dense(op.T), dense.T, 1e-4)
    _close(to_dense(op.T.T), dense, 1e-4)
    assert tuple(op.T.shape) == tuple(ref.T.shape)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_adjoint_consistency(kind, seed):
    """⟨Aᵀy, x⟩ == ⟨y, Ax⟩ (tests/test_operators_property.py)."""
    _, op, _ = _pair(kind, 8, 6, seed)
    om, on = op.shape
    x = torch.from_numpy(_vec(on, seed))
    y = torch.from_numpy(_vec(om, seed + 1))
    lhs = float(torch.dot(op.T @ y, x))
    rhs = float(torch.dot(y, op @ x))
    scale = abs(rhs) + float(x.norm() * y.norm()) + 1e-6
    assert abs(lhs - rhs) / scale < 1e-4


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", KINDS)
def test_linearity(kind, seed):
    """(A + αB) x == A x + α (B x): SumOp / ScaledOp distribute."""
    _, op_a, da = _pair(kind, 8, 6, seed)
    am, an = op_a.shape
    _, op_b, db = _pair("dense", am, an, seed + 1)
    alpha = -1.3
    x = torch.from_numpy(_vec(an, seed))
    combo = op_a + alpha * op_b
    assert isinstance(combo, SumOp)
    _close(combo @ x, op_a @ x + alpha * (op_b @ x), 1e-3)
    _close(to_dense(combo), da + alpha * db, 1e-3)
    _close(to_dense(op_a - op_b), da - db, 1e-3)
    _close(to_dense(-op_a), -da, 1e-3)


def test_algebra_builds_the_reference_tree():
    """The port's operator sugar builds the same trees as the reference's
    (tests/test_operators.py): sums flatten, scalings compose, shapes are
    checked, ``@`` dispatches on the operand's rank."""
    ra, a, da = _pair("dense", 6, 4, 0)
    rb, b, db = _pair("lowrank", 6, 4, 1)
    rc, c, dc = _pair("sparse", 6, 4, 2)
    s = a + b + c
    rs = ra + rb + rc
    assert isinstance(s, SumOp) and len(s.terms) == len(rs.terms) == 3
    _close(to_dense(s), jops.to_dense(rs))
    t = 2.0 * (3.0 * a)
    assert isinstance(t, ScaledOp) and t.alpha == 6.0 and t.op is a
    _close(to_dense(t), 6.0 * da)
    _close(to_dense(a + torch.from_numpy(db.copy())), da + db)
    _close(to_dense(torch.from_numpy(db.copy()) + a), da + db)
    with pytest.raises(ValueError, match="shapes disagree"):
        a + DenseOp(torch.zeros(4, 6))
    P = torch.from_numpy(_block(4, 3, 9))
    _close(a @ P, da @ P.numpy())
    _close(b.T @ torch.ones(6), db.T @ np.ones(6))
    assert a.m == 6 and a.n == 4
    assert TransposedOp(s).T is s
    _close(to_dense(s.T.T), to_dense(s))


@pytest.mark.parametrize("ma,na,mb,nb", [(3, 4, 2, 5), (5, 2, 4, 3),
                                         (1, 6, 7, 1), (4, 4, 3, 3)])
def test_kron_mixed_factors(ma, na, mb, nb):
    """KroneckerOp(sparse ⊗ dense) matches kron exactly, block products
    included (one block product per factor)."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(ma * 7 + nb), 3)
    A = jnp.where(jax.random.bernoulli(k1, 0.5, (ma, na)),
                  jax.random.normal(k2, (ma, na)), 0.0)
    B = jax.random.normal(k3, (mb, nb))
    ref = jops.KroneckerOp(jops.SparseOp.fromdense(A), jops.DenseOp(B))
    for backend in ("xla", "pallas"):
        op = bridge.operator(ref, backend=backend, device="cpu")
        K = np.kron(np.asarray(A), np.asarray(B))
        _close(to_dense(op), K, 1e-3)
        X = torch.from_numpy(_block(na * nb, 3, 1))
        _close(op.matmat(X), K @ X.numpy(), 1e-3)
        Y = torch.from_numpy(_block(ma * mb, 2, 2))
        _close(op.rmatmat(Y), K.T @ Y.numpy(), 1e-3)
        _close(op.mv(X[:, 0]), ref.mv(jnp.asarray(X[:, 0].numpy())))


@pytest.mark.parametrize("seed", SEEDS)
def test_gram_sides_consistent(seed):
    _, op, _ = _pair("dense", 8, 5, seed)
    g1 = to_dense(GramOp(op, side="ata"))
    g2 = to_dense(GramOp(op.T, side="aat"))
    _close(g1, g2, 1e-3)
    w = torch.linalg.eigvalsh(g1)
    assert float(w.min()) > -1e-3 * max(float(w.max()), 1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_resolve_method_on_every_kind(kind):
    """"auto" picks what the reference picks for every operator kind, at
    a tight and at a loose tolerance."""
    ref, op, _ = _pair(kind, seed=4)
    for tol in (1e-6, 1e-3):
        want = ref_resolve_method(rapi.SVDSpec(method="auto", tol=tol), ref)
        got = resolve_method(SVDSpec(method="auto", tol=tol), op)
        assert got == want, (kind, tol)
    assert resolve_method(SVDSpec(method="auto"),
                          ScaledOp(2.0, TransposedOp(op))) == \
        ref_resolve_method(rapi.SVDSpec(method="auto"),
                           jops.ScaledOp(2.0, jops.TransposedOp(ref)))


# --------------------------------------------------------------------------
# SparseOp constructors and the ELL pack it carries
# --------------------------------------------------------------------------

def test_fromdense_matches_bcoo():
    A = np.asarray(_ref_op("sparse", 8, 6, 7)[1])
    nnz = int(np.count_nonzero(A))
    ref = jsparse.BCOO.fromdense(jnp.asarray(A))
    op = SparseOp.fromdense(torch.from_numpy(A))
    np.testing.assert_array_equal(op.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(op.data.numpy(), np.asarray(ref.data))
    assert op.nnz == nnz and op.density == pytest.approx(nnz / 48)
    _close(op.to_dense(), np.asarray(ref.todense()))


def test_sparse_pack_and_transpose_match_reference():
    """A pallas SparseOp carries the reference's ELL packs of A and Aᵀ,
    bit for bit, and ``T`` swaps them."""
    ref, op, _ = _pair("sparse_pallas", 12, 9, 5)
    for got, want in zip(op.ell, ref.ell):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    t = op.T
    assert t.shape == (9, 12) and t.ell[0] is op.ell[2]
    np.testing.assert_array_equal(t.indices.numpy(),
                                  np.asarray(ref.T.indices))
    _close(to_dense(t), jops.to_dense(ref.T))


def test_directly_built_pallas_sparse_op_carries_the_pack(monkeypatch):
    """SparseOp(data, indices, shape, backend="pallas"), built without
    from_coo, packs both directions at construction, as from_coo does and
    bit for bit as the reference does, and its products reach the kernel
    wrapper rather than the torch sparse product."""
    ref, packed, dense = _pair("sparse_pallas", 12, 9, 5)
    op = SparseOp(packed.data, packed.indices, (12, 9), backend="pallas")
    for got, want in zip(op.ell, ref.ell):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    calls = []
    real = spm.sparse_matvec

    def spy(vals, cols, X, layout=None):
        calls.append(tuple(X.shape))
        return real(vals, cols, X, layout)

    monkeypatch.setattr(spm, "sparse_matvec", spy)
    monkeypatch.setattr(tops, "_spmm", None)     # no library fallback
    _close(op.mv(torch.from_numpy(_vec(9, 1))), dense @ _vec(9, 1))
    _close(op.T.matmat(torch.from_numpy(_block(12, 4, 2))),
           dense.T @ _block(12, 4, 2))
    assert calls == [(9,), (12, 4)]
    assert SparseOp(packed.data, packed.indices, (12, 9)).ell is None


def test_coo_tensor_operands():
    """as_operator wraps a torch sparse COO tensor; an uncoalesced one
    keeps its duplicate entries, which sum (BCOO semantics)."""
    idx = torch.tensor([[0, 0, 3, 3, 1], [1, 1, 0, 2, 2]])
    val = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    S = torch.sparse_coo_tensor(idx, val, (5, 3), check_invariants=True)
    want = np.zeros((5, 3), np.float32)
    np.add.at(want, (idx[0].numpy(), idx[1].numpy()), val.numpy())
    for backend in ("xla", "pallas"):
        op = as_operator(S, backend=backend)
        assert isinstance(op, SparseOp) and op.nnz == 5
        _close(to_dense(op), want)
        _close(op.mv(torch.tensor([1.0, 10.0, 100.0])),
               [30.0, 500.0, 0.0, 403.0, 0.0])
    assert as_operator(S.coalesce()).nnz == 4
    with pytest.raises(ValueError):
        as_operator(S, backend="mosaic")
    with pytest.raises(ValueError):
        SparseOp.from_coo(val, idx.T, (5, 3), backend="mosaic")


def test_sparse_block_is_one_kernel_call(monkeypatch):
    """SparseOp(backend="pallas").matmat of a b-column block reaches the
    kernel wrapper once, with the whole block (the reference vmaps one
    batched launch); rmatmat goes to the transposed pack."""
    _, op, dense = _pair("sparse_pallas", 40, 30, 6)
    calls = []
    real = spm.sparse_matvec

    def spy(vals, cols, X, layout=None):
        calls.append((vals.shape, tuple(X.shape)))
        return real(vals, cols, X, layout)

    monkeypatch.setattr(spm, "sparse_matvec", spy)
    V = torch.from_numpy(_block(30, 20, 1))
    _close(op.matmat(V), dense @ V.numpy())
    Q = torch.from_numpy(_block(40, 7, 2))
    _close(op.rmatmat(Q), dense.T @ Q.numpy())
    assert calls == [(op.ell[0].shape, (30, 20)), (op.ell[2].shape, (40, 7))]


# --------------------------------------------------------------------------
# solvers on matrix-free operands, against the reference
# --------------------------------------------------------------------------

def _svals(A):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)


def _err(s, s_true):
    return float(np.max(np.abs(_np(s) - s_true[:len(s)])) / s_true[0])


def _problem(kind, backend="xla"):
    if kind == "sparse":
        return ref_sparse_problem(jax.random.PRNGKey(23), 150, 120,
                                  density=0.08, backend=backend)
    if kind == "sparse_lowrank":
        return ref_sparse_problem(jax.random.PRNGKey(24), 140, 110,
                                  density=0.1, rank=12, backend=backend)
    return ref_kron_problem(jax.random.PRNGKey(31), 18, 14, 15, 12)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["sparse", "sparse_lowrank", "kron"])
def test_fsvd_blocked_matches_reference(kind, backend):
    """fsvd_blocked from the reference's own first block: σ against the
    reference's and the dense spectrum at SOLVERS["fsvd_blocked"]."""
    stol = SOLVERS["fsvd_blocked"]["stol"]
    ref_prob = _problem(kind, backend)
    prob = bridge.problem(ref_prob, device="cpu")
    s_true = _svals(ref_prob.dense)
    spec = rapi.SVDSpec(method="fsvd_blocked", rank=R)
    key = jax.random.PRNGKey(7)
    ref = rapi.factorize(ref_prob.op, spec, key=key)
    m, n = prob.op.shape
    _, b, _ = gk_block.blocked_dims(R, spec.block_size, spec.max_basis, m, n)
    start = np.asarray(jax.random.normal(jax.random.split(key)[1], (n, b)))
    got = gk_block.fsvd_blocked(prob.op, R, block=spec.block_size,
                                max_basis=spec.max_basis, tol=spec.tol,
                                start=start,
                                generator=torch.Generator().manual_seed(0))
    assert _err(got.s, s_true) < stol
    assert _err(got.s, _np(ref.s)) < stol
    auto = factorize(prob.op, SVDSpec(method="auto", rank=R),
                     generator=torch.Generator().manual_seed(1))
    assert auto.method == "fsvd_blocked"
    assert _err(auto.s, s_true) < stol


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["sparse", "sparse_lowrank", "kron"])
def test_fsvd_matches_reference(kind, backend):
    """fsvd with the reference's start vector q1: σ at SOLVERS["fsvd"]."""
    cfg = SOLVERS["fsvd"]
    ref_prob = _problem(kind, backend)
    prob = bridge.problem(ref_prob, device="cpu")
    s_true = _svals(ref_prob.dense)
    q1 = 2.0 + _vec(prob.op.shape[0], 5)
    rspec = rapi.SVDSpec(method="fsvd", rank=R, backend=backend,
                         **cfg["spec"])
    ref = rapi.factorize(ref_prob.op, rspec, q1=jnp.asarray(q1))
    got = factorize(prob.op, bridge.spec(rspec), q1=torch.from_numpy(q1))
    assert _err(got.s, s_true) < cfg["stol"]
    assert _err(got.s, _np(ref.s)) < cfg["stol"]
    assert int(got.iterations) == int(ref.iterations)


@pytest.mark.parametrize("kind,rank", [("sparse_lowrank", 12),
                                       ("kron_lowrank", 8)])
def test_estimate_rank_matches_reference(kind, rank):
    if kind == "kron_lowrank":
        k1, k2 = jax.random.split(jax.random.PRNGKey(3))
        A = jax.random.normal(k1, (10, 2)) @ jax.random.normal(k2, (2, 9))
        B = jax.random.normal(k2, (12, 4)) @ jax.random.normal(k1, (4, 8))
        ref_op = jops.KroneckerOp(jops.DenseOp(A), jops.SparseOp.fromdense(B))
    else:
        ref_op = _problem(kind).op
    op = bridge.operator(ref_op, device="cpu")
    ref = rapi.estimate_rank(ref_op, key=jax.random.PRNGKey(0))
    got = estimate_rank(op, generator=torch.Generator().manual_seed(0))
    assert int(got) == int(ref) == rank


class _DensifyGuard(Operator):
    """Forwards the matvec protocol; trips on any densification attempt —
    ``to_dense`` or a block wide enough to be the identity trick."""

    def __init__(self, inner):
        self._inner = inner
        self.width_cap = max(min(inner.shape) - 1, 1)

    shape = property(lambda self: self._inner.shape)
    dtype = property(lambda self: self._inner.dtype)
    device = property(lambda self: self._inner.device)

    def mv(self, p):
        return self._inner.mv(p)

    def rmv(self, q):
        return self._inner.rmv(q)

    def matmat(self, V):
        assert V.shape[1] <= self.width_cap, \
            f"matmat width {V.shape[1]} is a densification in disguise"
        return self._inner.matmat(V)

    def rmatmat(self, Q):
        assert Q.shape[1] <= self.width_cap, \
            f"rmatmat width {Q.shape[1]} is a densification in disguise"
        return self._inner.rmatmat(Q)

    def to_dense(self):
        raise AssertionError("solver densified a matrix-free operand")

    @property
    def T(self):
        return _DensifyGuard(self._inner.T)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_fsvd_blocked_sparse_never_densifies(backend):
    """factorize(SparseOp, fsvd_blocked, k=20) matches dense SVD to ≤ 1e-4
    per-value relative error without materializing the matrix."""
    ref_prob = ref_sparse_problem(jax.random.PRNGKey(21), 250, 180,
                                  density=0.05)
    prob = bridge.problem(ref_prob, backend=backend, device="cpu")
    s_true = _svals(ref_prob.dense)[:20]
    out = factorize(_DensifyGuard(prob.op),
                    SVDSpec(method="fsvd_blocked", rank=20),
                    generator=torch.Generator().manual_seed(2))
    assert (np.abs(_np(out.s) - s_true) / s_true).max() < 1e-4


def test_fsvd_blocked_kronecker_never_densifies():
    prob = bridge.problem(ref_kron_problem(jax.random.PRNGKey(31), 18, 14,
                                           15, 12), device="cpu")
    s_true = _svals(prob.dense)[:R]
    out = factorize(_DensifyGuard(prob.op),
                    SVDSpec(method="fsvd_blocked", rank=R),
                    generator=torch.Generator().manual_seed(6))
    assert _err(out.s, s_true) < 1e-4


# --------------------------------------------------------------------------
# padding, the LinOp shims and the problem makers
# --------------------------------------------------------------------------

def test_padding_matches_reference():
    for size, mult in [(0, 4), (5, 1), (7, 4), (8, 4), (129, 128)]:
        assert padding.pad_dim(size, mult) == jpad.pad_dim(size, mult)
    assert padding.padded_shape((7, 9), (4, 8)) == \
        jpad.padded_shape((7, 9), (4, 8))
    A = _block(5, 3, 0)
    for x in (A, torch.from_numpy(A)):
        P = padding.pad_to(x, (8, 4))
        assert type(P) is type(x)
        np.testing.assert_array_equal(_np(P), np.asarray(jpad.pad_to(A,
                                                                     (8, 4))))
        np.testing.assert_array_equal(_np(padding.unpad(P, (5, 3))), A)
        assert padding.pad_to(x, (5, 3)) is x
        assert padding.unpad(x, (5, 3)) is x
    with pytest.raises(ValueError):
        padding.pad_dim(3, 0)
    with pytest.raises(ValueError):
        padding.padded_shape((3,), (1, 2))
    with pytest.raises(ValueError):
        padding.pad_to(A, (4, 3))


def test_linop_closures_and_shims():
    A = torch.from_numpy(_block(30, 20, 3))
    op = linop.LinOp((30, 20), lambda p: A @ p, lambda q: A.T @ q,
                     device="cpu")
    assert op.m == 30 and op.n == 20 and op.device.type == "cpu"
    _close(linop.to_dense(op), A.numpy())
    _close(to_dense(op), A.numpy())
    p, y = torch.from_numpy(_vec(20, 1)), torch.from_numpy(_vec(30, 2))
    _close(op.mv_fused(p, y, 0.5), (A @ p - 0.5 * y).numpy())
    fused = linop.LinOp((30, 20), op.mv, op.rmv, device="cpu",
                        _mv_fused=lambda p, y, a: torch.zeros(30))
    assert float(fused.mv_fused(p, y, 0.5).abs().max()) == 0.0
    got = factorize(op, SVDSpec(method="fsvd", rank=4, max_iters=20),
                    generator=torch.Generator().manual_seed(0))
    s_true = _svals(A.numpy())
    assert _err(got.s, s_true) < 5e-4
    with pytest.warns(linop.ReproDeprecationWarning):
        d = linop.from_dense(A, use_kernels=True)
    assert isinstance(d, DenseOp) and d.backend == "pallas"
    with pytest.warns(linop.ReproDeprecationWarning):
        lr = linop.from_factors(A[:, :2], torch.ones(2), A[:2, :].T,
                                extra=[(A[:, :1], A[:1, :].T)], scale=2.0)
    assert isinstance(lr, LowRankOp) and lr.scale == 2.0
    assert issubclass(linop.ReproDeprecationWarning, DeprecationWarning)


def test_problem_makers():
    g = torch.Generator().manual_seed(0)
    prob = synthetic.make_sparse_problem(g, 80, 60, density=0.1, rank=6,
                                         backend="pallas")
    assert isinstance(prob.op, SparseOp) and prob.op.ell is not None
    assert int(torch.linalg.matrix_rank(prob.dense)) == 6
    _close(to_dense(prob.op), prob.dense)
    full = synthetic.make_sparse_problem(g, 200, 150, density=0.05)
    assert 0.03 < full.op.density < 0.07
    kron = synthetic.make_kron_problem(g, 6, 5, 4, 3)
    assert isinstance(kron.op, KroneckerOp)
    sa = torch.linalg.svdvals(kron.op.a.A)
    sb = torch.linalg.svdvals(kron.op.b.A)
    want = torch.sort((sa[:, None] * sb[None, :]).flatten(),
                      descending=True).values
    _close(torch.linalg.svdvals(kron.dense), want, 1e-4)


def test_single_pass_and_numpy_factors_keep_their_device():
    op = LowRankOp(torch.ones(4, 2), np.ones(2, np.float32),
                   np.ones((2, 3), np.float32))
    assert op.s.device.type == "cpu" and op.Vt.device.type == "cpu"
    _close(to_dense(op), 2 * np.ones((4, 3)))
    sp = SinglePassOp(op)
    assert sp.single_pass_only and sp.T.single_pass_only
    _close(to_dense(sp), to_dense(op))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert as_operator(op) is op and tops.as_operator(sp) is sp
