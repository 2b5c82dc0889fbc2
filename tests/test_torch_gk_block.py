"""The port's block GK and streaming blocked F-SVD (repro_torch.core.gk_block)
against the reference package on the CPU.

Counterparts of the cases of tests/test_gk_block.py (none needs a sparse
operand) and of the dense fsvd_blocked cases of tests/test_solver_parity.py.
Operands come from the reference's own makers; where the reference draws
a start block from a key, the same draw is handed to the port as
``start``.  QR column signs differ between the two packages, so parity is
held on singular values, subspaces and reconstructions, never on raw
bases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_lowrank
from repro.core import gk_block as jgb
from repro_torch.api import RecordingCallback, SVDSpec, factorize
from repro_torch.core import gk_block as gb
from repro_torch.core.fsvd import fsvd
from repro_torch.core.operators import DenseOp, Operator


def _t(x):
    return torch.from_numpy(np.array(x))


def _start(m, b, seed=0):
    """The reference's default draw: normal(PRNGKey(seed), (m, b))."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (m, b)))


def _svals(A):
    return np.linalg.svd(np.asarray(A, np.float64), compute_uv=False)


# --------------------------------------------------------------------------
# fixed-step block GK
# --------------------------------------------------------------------------

def test_block_bases_orthonormal(rng):
    A = np.asarray(jax.random.normal(rng, (200, 150)))
    res = gb.gk_block_host(_t(A), block=16, steps=4, start=_start(200, 16))
    Q, P = res.Q.numpy(), res.P.numpy()
    np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[1]), atol=1e-4)
    np.testing.assert_allclose(P.T @ P, np.eye(P.shape[1]), atol=1e-4)
    ref = jgb.gk_block_host(A, block=16, steps=4, key=jax.random.PRNGKey(0))
    assert res.steps == ref.steps and res.breakdown == ref.breakdown


def test_projection_identity(rng):
    """K == Qᵀ A P, and K has the reference's singular values."""
    A = np.asarray(jax.random.normal(rng, (120, 90)))
    res = gb.gk_block_host(_t(A), block=8, steps=5, start=_start(120, 8))
    K_direct = res.Q.numpy().T @ A @ res.P.numpy()
    np.testing.assert_allclose(res.K.numpy(), K_direct, atol=2e-3)
    ref = jgb.gk_block_host(A, block=8, steps=5, key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(_svals(res.K), _svals(ref.K), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("m,n,rank,r", [(300, 200, 40, 10),
                                        (150, 220, 25, 25)])
def test_fsvd_block_matches_dense(rng, m, n, rank, r):
    A = np.asarray(make_lowrank(rng, m, n, rank))
    b = max(16, r)
    out = gb.fsvd_block(_t(A), r, block=b, steps=6, start=_start(m, b))
    U, s, Vt = np.linalg.svd(A.astype(np.float64), full_matrices=False)
    np.testing.assert_allclose(out.s.numpy(), s[:r], rtol=2e-3)
    qual = np.abs(np.sum(out.U.numpy() * U[:, :r], 0)) \
        * np.abs(np.sum(out.V.numpy() * Vt[:r].T, 0))
    assert qual.min() > 0.99
    ref = jgb.fsvd_block(A, r, block=b, steps=6, key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(out.s.numpy(), np.asarray(ref.s), rtol=1e-4)


def test_block_and_vector_paths_agree(rng):
    A = _t(make_lowrank(rng, 256, 180, 30))
    out_b = gb.fsvd_block(A, 8, block=32, steps=4,
                          generator=torch.Generator().manual_seed(0))
    out_v = fsvd(A, 8, 120, host_loop=True,
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(out_b.s.numpy(), out_v.s.numpy(), rtol=1e-3)


def test_block_breakdown_on_lowrank(rng):
    """Rank < block: the second slab is rank-deficient, breakdown fires
    and the captured spectrum is still exact."""
    A = np.asarray(make_lowrank(rng, 150, 100, 12))
    out = gb.fsvd_block(_t(A), 12, block=16, steps=6, start=_start(150, 16))
    np.testing.assert_allclose(out.s.numpy(), _svals(A)[:12], rtol=1e-3)
    ref = jgb.fsvd_block(A, 12, block=16, steps=6, key=jax.random.PRNGKey(0))
    assert out.breakdown and ref.breakdown and out.steps == ref.steps


def test_fewer_passes_than_vector_lanczos(rng):
    """Three block steps (3 passes over A) reach top-16 convergence."""
    A = np.asarray(make_lowrank(rng, 400, 300, 60))
    out = gb.fsvd_block(_t(A), 16, block=64, steps=3,
                        start=_start(400, 64))
    np.testing.assert_allclose(out.s.numpy(), _svals(A)[:16], rtol=1e-3)


# --------------------------------------------------------------------------
# streaming blocked solver (fsvd_blocked)
# --------------------------------------------------------------------------

def test_fsvd_blocked_rank_deficient_stays_orthonormal(rng):
    """More triplets than the rank: the rank-revealing MGS expansion does
    not fabricate directions, so the zero triplets come back as zeros and
    the returned bases stay orthonormal."""
    A = np.asarray(make_lowrank(rng, 40, 30, 4))
    s_true = _svals(A)
    res = gb.fsvd_blocked(_t(A), 8, generator=torch.Generator().manual_seed(3))
    assert res.converged
    np.testing.assert_allclose(res.s.numpy(), s_true[:8],
                               atol=1e-4 * s_true[0])
    for M in (res.U[:, :4], res.V[:, :4]):
        np.testing.assert_allclose(M.numpy().T @ M.numpy(), np.eye(4),
                                   atol=1e-3)


def test_fsvd_blocked_locks_across_restarts(rng):
    """A budget far below one cycle's need forces many restarts; locking
    still assembles every requested triplet, as in the reference."""
    A = np.asarray(make_lowrank(rng, 120, 100, 20)
                   + 1e-4 * jax.random.normal(jax.random.PRNGKey(1),
                                              (120, 100)))
    s_true = _svals(A)
    res = gb.fsvd_blocked(_t(A), 12, block=4, max_basis=14,
                          generator=torch.Generator().manual_seed(5))
    assert res.converged and res.restarts > 1
    np.testing.assert_allclose(res.s.numpy(), s_true[:12],
                               atol=5e-4 * s_true[0])
    ref = jgb.fsvd_blocked(A, 12, block=4, max_basis=14,
                           key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(res.s.numpy(), np.asarray(ref.s),
                               atol=5e-4 * s_true[0])


def test_fsvd_blocked_respects_memory_budget():
    """max_basis caps the retained basis; accuracy survives the restarts
    (tests/test_solver_parity.py test_fsvd_blocked_respects_memory_budget)."""
    A = np.asarray(make_lowrank(jax.random.PRNGKey(41), 200, 150, 12)
                   + 1e-4 * jax.random.normal(jax.random.PRNGKey(42),
                                              (200, 150)))

    class _BudgetGuard(Operator):
        max_seen = 0

        def __init__(self, inner):
            self.inner = inner

        shape = property(lambda self: self.inner.shape)
        dtype = property(lambda self: self.inner.dtype)
        device = property(lambda self: self.inner.device)

        def mv(self, p):
            return self.inner.mv(p)

        def rmv(self, q):
            return self.inner.rmv(q)

        def matmat(self, V):
            _BudgetGuard.max_seen = max(_BudgetGuard.max_seen, V.shape[1])
            return self.inner.matmat(V)

        def rmatmat(self, Q):
            return self.inner.rmatmat(Q)

    out = factorize(_BudgetGuard(DenseOp(_t(A))),
                    SVDSpec(method="fsvd_blocked", rank=10, block_size=4,
                            max_basis=22),
                    generator=torch.Generator().manual_seed(8))
    assert _BudgetGuard.max_seen <= 22
    s_true = _svals(A)
    assert np.max(np.abs(out.s.numpy() - s_true[:10])) / s_true[0] < 5e-4


def test_fsvd_blocked_reconstructs_exact_rank():
    A = np.asarray(make_lowrank(jax.random.PRNGKey(3), 90, 60, 8))
    out = factorize(_t(A), SVDSpec(method="fsvd_blocked", rank=8),
                    generator=torch.Generator().manual_seed(5))
    rel = np.linalg.norm(A - out.reconstruct().numpy()) / np.linalg.norm(A)
    assert rel < 1e-4


def test_fsvd_blocked_bf16_subspace_still_aligned():
    from test_solver_parity import R, ZOO
    A = np.asarray(ZOO["lowrank_noise"][0])
    Vt = np.linalg.svd(A.astype(np.float64))[2]
    out = factorize(_t(A), SVDSpec(method="fsvd_blocked", rank=R,
                                   precision="bf16"),
                    generator=torch.Generator().manual_seed(11))
    assert out.V.dtype == torch.bfloat16
    cos = np.linalg.svd(Vt[:R] @ out.V.float().numpy(), compute_uv=False)
    assert cos.min() > 0.995


def test_fsvd_blocked_warm_start_and_callback():
    """q1 seeds the first block via Aᵀq1 (no generator needed, no
    warning); the callback sees each cycle and the final info."""
    A = _t(make_lowrank(jax.random.PRNGKey(6), 80, 60, 6))
    cold = factorize(A, SVDSpec(method="fsvd_blocked", rank=4),
                     generator=torch.Generator().manual_seed(0))
    cb = RecordingCallback()
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warm = factorize(A, SVDSpec(method="fsvd_blocked", rank=4),
                         q1=cold.warm_start(), callback=cb)
    np.testing.assert_allclose(warm.s.numpy(), cold.s.numpy(), rtol=1e-4)
    assert cb.info.method == "fsvd_blocked"
    assert int(cb.info.iterations) == int(warm.iterations)
    assert len(cb.steps) == cb.info.residuals.shape[0] >= 1
    assert not bool(warm.breakdown)


# --------------------------------------------------------------------------
# block orthonormalizers
# --------------------------------------------------------------------------

def test_mgs_block_keeps_large_scale_blocks():
    """The drop threshold is relative to the block's own column scale, so
    a large raw block keeps every column, spanning what the reference
    keeps."""
    W = _t(1e4 * jax.random.normal(jax.random.PRNGKey(0), (64, 8)))
    empty = torch.zeros(64, 0)
    Q = gb._mgs_block(W, (empty,))
    assert Q.shape == (64, 8)
    assert float((Q.T @ Q - torch.eye(8)).abs().max()) < 1e-5
    want = jgb._mgs_block(jnp.asarray(W.numpy()), (jnp.zeros((64, 0)),))
    cos = np.linalg.svd(np.asarray(want).T @ Q.numpy(), compute_uv=False)
    assert cos.min() > 1 - 1e-5


def test_mgs_block_drops_spanned_columns():
    B = np.asarray(jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(1),
                                                   (48, 4)))[0])
    fresh = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (48, 3)))
    W = np.concatenate([B @ (B.T @ fresh[:, :1]) * 50.0,   # spanned by B
                        fresh, fresh[:, :1] * 2.0], axis=1)  # duplicate
    Q = gb._mgs_block(_t(W), (_t(B),))
    assert Q.shape[1] == 3
    assert float((_t(B).T @ Q).abs().max()) < 1e-5
    assert jgb._mgs_block(W, (B,)).shape[1] == 3


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_block_project_matches_reference(store):
    rng = np.random.default_rng(4)
    B = np.linalg.qr(rng.standard_normal((50, 6)))[0].astype(np.float32)
    W = rng.standard_normal((50, 3)).astype(np.float32)
    jstore = jnp.bfloat16 if store == torch.bfloat16 else jnp.float32
    want = jgb._block_project(jnp.asarray(W), [jnp.asarray(B, jstore)], 2)
    got = gb._block_project(_t(W), [_t(B).to(store)], 2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
