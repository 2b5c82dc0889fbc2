"""The port's operators, GK bidiagonalization (Alg 1) and Ritz extraction
against the reference package on the CPU.

Inputs are made with numpy from a seed; torch cannot reproduce JAX's PRNG
draws, so the GK start vector q1 is drawn once and handed to both.
Bounds: the leading f32 recurrence scalars agree to 1e-4 relative (the
two packages sum in different orders), Ritz singular values to
1e-5·σ_max, and breakdown iteration counts exactly on exact-rank inputs.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SVDSpec as RefSpec
from repro.core import gk as jgk
from repro.core import operators as jop
from repro.core import tridiag as jtri
from repro_torch import bridge
from repro_torch.api import (Factorization, ImplicitKeyWarning,
                             RecordingCallback, SVDSpec)
from repro_torch.core import gk, operators, tridiag
from repro_torch.core._keys import resolve_generator
from repro_torch.core.operators import (DenseOp, GramOp, TransposedOp,
                                        as_operator, cgs)


def _lowrank(m, n, rank, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, rank))
            @ rng.standard_normal((rank, n))).astype(np.float32)


def _q1(m, seed):
    return (2.0 + np.random.default_rng(seed).standard_normal(m)
            ).astype(np.float32)


def _np(x):
    return np.asarray(x, dtype=np.float64) if not isinstance(
        x, torch.Tensor) else x.detach().double().cpu().numpy()


# --------------------------------------------------------------------------
# bridge and key policy
# --------------------------------------------------------------------------

def test_bridge_carries_operand_vector_factorization_and_spec():
    A = _lowrank(30, 20, 4, 0)
    op = bridge.operand(A, backend="pallas", device="cpu")
    assert isinstance(op, DenseOp) and op.backend == "pallas"
    np.testing.assert_array_equal(op.A.numpy(), A)
    q1 = bridge.start_vector(jnp.asarray(_q1(30, 1)), device="cpu")
    assert q1.dtype == torch.float32 and q1.shape == (30,)
    np.testing.assert_array_equal(q1.numpy(), _q1(30, 1))
    bf = bridge.start_vector(jnp.asarray(_q1(30, 1), jnp.bfloat16),
                             device="cpu", dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        bf.float().numpy(),
        np.asarray(jnp.asarray(_q1(30, 1), jnp.bfloat16), np.float32))

    import repro.api as rapi
    ref = rapi.factorize(A, RefSpec(method="fsvd", rank=3),
                         q1=jnp.asarray(_q1(30, 1)))
    f = bridge.factorization(ref, device="cpu")
    assert isinstance(f, Factorization) and f.method == "fsvd"
    np.testing.assert_array_equal(f.s.numpy(), np.asarray(ref.s))
    assert int(f.iterations) == int(ref.iterations)
    assert bool(f.breakdown) == bool(ref.breakdown)

    rspec = RefSpec(method="fsvd", rank=7, max_iters=33, precision="bf16",
                    backend="pallas", dtype=jnp.float32, host_loop=True)
    tspec = bridge.spec(rspec)
    for field in dataclasses.fields(RefSpec):
        if field.name != "dtype":
            assert getattr(tspec, field.name) == getattr(rspec, field.name)
    assert tspec.dtype is torch.float32
    assert bridge.spec({"rank": 4}).rank == 4


def test_resolve_generator_warns_and_seeds_zero():
    with pytest.warns(ImplicitKeyWarning, match="my_solver"):
        g = resolve_generator(None, caller="my_solver")
    ref = torch.Generator().manual_seed(0)
    assert torch.equal(torch.randn(5, generator=g),
                       torch.randn(5, generator=ref))
    mine = torch.Generator().manual_seed(3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_generator(mine) is mine


def test_start_vector_is_n21_and_seeded():
    v = gk.start_vector(torch.Generator().manual_seed(1), 40_000)
    assert v.dtype == torch.float32 and v.shape == (40_000,)
    assert abs(float(v.mean()) - 2.0) < 0.03
    assert abs(float(v.std()) - 1.0) < 0.03
    w = gk.start_vector(torch.Generator().manual_seed(1), 40_000,
                        torch.float64)
    np.testing.assert_array_equal(w.float().numpy(), v.numpy())


# --------------------------------------------------------------------------
# operators
# --------------------------------------------------------------------------

def test_numpy_operand_needs_a_card_or_an_explicit_device():
    A = _lowrank(10, 8, 2, 0)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: numpy operands go to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseOp(A)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        as_operator(A)
    op = as_operator(A, device="cpu", backend="pallas")
    assert op.device.type == "cpu" and op.backend == "pallas"
    with pytest.raises(ValueError, match="backend"):
        DenseOp(torch.zeros(2, 2), backend="cuda")


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("passes", [1, 2])
def test_cgs_matches_reference(store, passes):
    rng = np.random.default_rng(5)
    v = rng.standard_normal(70).astype(np.float32)
    B = np.linalg.qr(rng.standard_normal((70, 9)))[0].astype(np.float32)
    jstore = jnp.bfloat16 if store == torch.bfloat16 else jnp.float32
    want = jop.cgs(jnp.asarray(v), jnp.asarray(B, jstore), passes)
    got = cgs(torch.from_numpy(v), torch.from_numpy(B).to(store), passes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mixed_products_widen_by_row_blocks(monkeypatch):
    """The bf16 basis is widened a row block at a time: the blocked sums
    equal the one-shot product."""
    rng = np.random.default_rng(6)
    B = torch.from_numpy(rng.standard_normal((50, 6)).astype(
        np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    whole_t = operators.mixed_tmm(B, x)
    whole = operators.mixed_mm(B, X)
    monkeypatch.setattr(operators, "_MIXED_ROWS", 7)
    torch.testing.assert_close(operators.mixed_tmm(B, x), whole_t)
    torch.testing.assert_close(operators.mixed_mm(B, X), whole)
    torch.testing.assert_close(
        whole, B.float() @ X.bfloat16().float(), rtol=0, atol=0)


def test_mixed_tmm_rounds_a_wide_operand_by_row_blocks(monkeypatch):
    """A wide right-hand side (the operand, or its transposed view, under
    a bf16 Gaussian sketch) is rounded and widened a row block at a time,
    the block sized by its width: the blocked product equals the
    one-shot one."""
    rng = np.random.default_rng(7)
    T = torch.from_numpy(rng.standard_normal((40, 5)).astype(
        np.float32)).bfloat16()
    A = torch.from_numpy(rng.standard_normal((30, 40)).astype(np.float32))
    want = T.float().T @ A.T.bfloat16().float()
    monkeypatch.setattr(operators, "_MIXED_ELEMS", 90)   # 3 rows a block
    torch.testing.assert_close(operators.mixed_tmm(T, A.T), want)
    torch.testing.assert_close(operators.mixed_tmm(T, A.T.contiguous()),
                               want)


def test_transposed_and_gram_operators():
    A = torch.from_numpy(_lowrank(12, 9, 3, 2))
    op = DenseOp(A, backend="pallas")
    x9, x12 = torch.randn(9), torch.randn(12)
    T = op.T
    assert isinstance(T, TransposedOp) and T.shape == (9, 12)
    torch.testing.assert_close(T.mv(x12), A.T @ x12)
    torch.testing.assert_close(T.matmat(torch.eye(12)), A.T)
    assert T.T is op
    # Aᵀ's left half-step is A's right half-step (fused path kept)
    basis = torch.zeros(9, 2)
    u, nrm = T.lanczos_step(x12, x9, 0.5, basis, passes=2)
    v, nrm2 = op.lanczos_rstep(x12, x9, 0.5, basis, passes=2)
    torch.testing.assert_close(u, v)
    G = GramOp(op, "ata")
    assert G.shape == (9, 9) and G.T is G
    torch.testing.assert_close(G.mv(x9), A.T @ (A @ x9))
    torch.testing.assert_close(GramOp(op, "aat").matmat(torch.eye(12)),
                               A @ A.T)
    with pytest.raises(ValueError, match="side"):
        GramOp(op, "both")


def test_f64_pallas_operand_uses_the_f32_matvec_on_cpu():
    """As in the reference, a float64 operand's pallas half-step is the
    fused f32 matvec (gk_matvec) plus CGS; on the CPU that is its plain
    version."""
    A = torch.from_numpy(_lowrank(20, 15, 3, 4)).double()
    op = DenseOp(A, backend="pallas")
    p, y = torch.randn(15, dtype=torch.float64), torch.randn(20,
                                                             dtype=torch.float64)
    u = op.mv_fused(p, y, 0.5)
    assert u.dtype == torch.float32
    torch.testing.assert_close(u, (A @ p - 0.5 * y).float())


# --------------------------------------------------------------------------
# tridiagonal Ritz problem
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kprime", [None, 4, 7])
def test_btb_eigh_matches_reference_and_masks(kprime):
    rng = np.random.default_rng(8)
    a = np.abs(rng.standard_normal(7)).astype(np.float32) + 0.1
    b = np.abs(rng.standard_normal(7)).astype(np.float32)
    if kprime is not None:
        a[kprime:] = 0.0
        b[kprime:] = 0.0
    T_ref = jtri.btb_tridiagonal(jnp.asarray(a), jnp.asarray(b))
    T = tridiag.btb_tridiagonal(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=1e-6)
    th_ref, _ = jtri.btb_eigh(jnp.asarray(a), jnp.asarray(b), kprime)
    th, G = tridiag.btb_eigh(torch.from_numpy(a), torch.from_numpy(b),
                             kprime)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_ref), rtol=1e-5,
                               atol=1e-5)
    assert torch.all(th[:-1] >= th[1:])                 # descending
    if kprime is not None:
        assert torch.all(torch.isneginf(th[kprime:]))
        assert torch.all(torch.isfinite(th[:kprime]))
        kt = tridiag.btb_eigh(torch.from_numpy(a), torch.from_numpy(b),
                              torch.tensor(kprime))[0]
        assert torch.equal(kt, th)
    torch.testing.assert_close(G @ G.T, torch.eye(7), rtol=1e-5, atol=1e-5)
    if kprime is None:
        torch.testing.assert_close(G @ torch.diag(th) @ G.T, T, rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------------------
# GK bidiagonalization
# --------------------------------------------------------------------------

LOOPS = {"in_graph": (gk.gk_bidiag, jgk.gk_bidiag),
         "host": (gk.gk_bidiag_host, jgk.gk_bidiag_host)}


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("m,n,rank", [(90, 60, 8), (50, 110, 12)])
def test_gk_matches_reference_on_exact_rank(loop, backend, m, n, rank):
    port, refr = LOOPS[loop]
    A = _lowrank(m, n, rank, m + n)
    q1 = _q1(m, rank)
    k = 3 * rank
    want = refr(jop.DenseOp(jnp.asarray(A), backend=backend), k,
                q1=jnp.asarray(q1))
    got = port(DenseOp(torch.from_numpy(A), backend=backend), k,
               q1=torch.from_numpy(q1))
    assert int(got.kprime) == int(want.kprime)
    assert bool(got.breakdown) == bool(want.breakdown)
    kp = int(want.kprime)
    assert rank <= kp <= rank + 3
    # The leading scalars agree to rounding; the last few before breakdown
    # are conditioned by the shrinking residual, so the check there is the
    # quantity the solvers use: the Ritz values of BᵀB.
    scale = float(want.alphas[0])
    np.testing.assert_allclose(_np(got.alphas)[:rank // 2],
                               _np(want.alphas)[:rank // 2], rtol=1e-4)
    np.testing.assert_allclose(_np(got.betas)[:rank // 2],
                               _np(want.betas)[:rank // 2], rtol=1e-4)
    th = tridiag.btb_eigh(got.alphas, got.betas, got.kprime)[0][:rank]
    th_ref = jtri.btb_eigh(want.alphas, want.betas, want.kprime)[0][:rank]
    smax = float(np.sqrt(th_ref[0]))
    np.testing.assert_allclose(np.sqrt(_np(th)), np.sqrt(_np(th_ref)),
                               rtol=0, atol=1e-5 * smax)
    np.testing.assert_allclose(float(got.beta1), float(want.beta1),
                               rtol=1e-6)
    assert np.all(_np(got.alphas)[kp:] == 0)
    # the Lanczos identity A P_k' = Q_{k'+1} B_{k'+1,k'}
    P = got.P.double()[:, :kp]
    Q = got.Q.double()[:, :kp + 1]
    B = torch.zeros(kp + 1, kp, dtype=torch.float64)
    B[torch.arange(kp), torch.arange(kp)] = got.alphas.double()[:kp]
    B[torch.arange(1, kp + 1), torch.arange(kp)] = got.betas.double()[:kp]
    resid = torch.linalg.matrix_norm(torch.from_numpy(A).double() @ P
                                     - Q @ B)
    assert float(resid) < 1e-4 * float(got.alphas[0])


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_gk_fixed_k_matches_reference(loop, precision):
    """A full-rank operand runs all k iterations in both packages; the
    recurrence scalars agree (bf16 bases: to the storage's rounding)."""
    port, refr = LOOPS[loop]
    rng = np.random.default_rng(9)
    A = rng.standard_normal((80, 50)).astype(np.float32)
    q1 = _q1(80, 9)
    want = refr(jnp.asarray(A), 20, q1=jnp.asarray(q1), precision=precision)
    got = port(torch.from_numpy(A), 20, q1=torch.from_numpy(q1),
               precision=precision)
    assert int(got.kprime) == int(want.kprime) == 20
    assert not bool(got.breakdown)
    store = torch.bfloat16 if precision == "bf16" else torch.float32
    assert got.P.dtype == got.Q.dtype == store
    rtol = 1e-4 if precision is None else 2e-2
    np.testing.assert_allclose(_np(got.alphas), _np(want.alphas), rtol=rtol)
    np.testing.assert_allclose(_np(got.betas), _np(want.betas), rtol=rtol)


def test_gk_clamps_k_and_validates_precision():
    A = torch.from_numpy(_lowrank(10, 6, 6, 1))
    res = gk.gk_bidiag(A, 50, q1=torch.ones(10))
    assert res.alphas.shape == (6,) and res.Q.shape == (10, 7)
    with pytest.raises(ValueError, match="precision"):
        gk.gk_bidiag(A, 3, q1=torch.ones(10), precision="fp8")
    assert gk._eff_eps(1e-8, torch.float32, torch.bfloat16) == pytest.approx(
        jgk._eff_eps(1e-8, jnp.float32, jnp.bfloat16))
    assert gk._eff_eps(1e-8, torch.float32, torch.float32) == pytest.approx(
        jgk._eff_eps(1e-8, jnp.float32, jnp.float32))


def test_host_loop_reports_each_step_and_the_final_info():
    A = torch.from_numpy(_lowrank(60, 40, 5, 3))
    cb = RecordingCallback()
    res = gk.gk_bidiag_host(A, 20, q1=torch.from_numpy(_q1(60, 3)),
                            callback=cb)
    kp = int(res.kprime)
    assert bool(res.breakdown) and 5 <= kp <= 8
    assert [i for i, _ in cb.steps] == list(range(1, len(cb.steps) + 1))
    assert set(cb.steps[0][1]) == {"alpha", "beta"}
    assert cb.info.method == "gk" and int(cb.info.iterations) == kp
    torch.testing.assert_close(cb.info.residuals, res.betas)
    cb2 = RecordingCallback()
    gk.gk_bidiag(A, 20, q1=torch.from_numpy(_q1(60, 3)), callback=cb2)
    assert cb2.steps == [] and int(cb2.info.iterations) == kp
    assert float(cb2.info.last_residual) == float(
        cb2.info.residuals[kp - 1])


def test_gk_without_start_vector_warns_and_is_reproducible():
    A = torch.from_numpy(_lowrank(40, 30, 4, 7))
    with pytest.warns(ImplicitKeyWarning):
        a = gk.gk_bidiag(A, 10)
    with pytest.warns(ImplicitKeyWarning):
        b = gk.gk_bidiag(A, 10)
    assert torch.equal(a.alphas, b.alphas)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    c = gk.gk_bidiag_host(A, 10, generator=g1)
    d = gk.gk_bidiag_host(A, 10, generator=g2)
    assert torch.equal(c.alphas, d.alphas)


def test_spec_fields_match_the_reference():
    assert [f.name for f in dataclasses.fields(SVDSpec)] == \
        [f.name for f in dataclasses.fields(RefSpec)]
    for f in dataclasses.fields(SVDSpec):
        if f.name != "dtype":
            assert f.default == next(
                g.default for g in dataclasses.fields(RefSpec)
                if g.name == f.name)
