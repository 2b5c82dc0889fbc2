"""The port's CUDA kernels on the card, against their plain-torch versions.

Every test here is marked ``gpu`` and skips without a CUDA card.  This
file imports torch, numpy and repro_torch only (the card's machine has no
JAX), so on the card it runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: rtol 1e-5 with atol 1e-5·max|plain| when A and the basis are
f32 (the kernel and the plain version differ only in summation order),
3e-2 where either is stored bf16 (tests/test_kernels.py:151-187).  The
fused matvecs multiply in f32 whatever A's storage (f64 included), and
the sketch apply widens bf16 exactly, so both are held at f32 bounds.
The sparse matvec and the low-rank materialization widen their bf16 and
f64 inputs to f32 before they multiply, so they too are held at f32
bounds against their plain versions (which widen the same way).  The
reorthogonalization pair is held at the same bounds (1e-5 f32, 3e-2 for a
bf16 basis).  The scatter-add sums each destination in entry order, so it
is held bit for bit against its plain version on the CPU, its binning
(count, scan, stable scatter into bins and into parts of bins) exactly
against the plain model ``ref.bin_entries``, and a fold of the
sketch-resident state on the card equals the same fold on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import (LowRankOp, SVDSpec, estimate_rank, factorize,
                             update_factorization)
from repro_torch.core import sketch as tsketch
from repro_torch.core.operators import DenseOp, Operator
from repro_torch.core.update import materialize_lowrank
from repro_torch.data.synthetic import make_sparse_problem
from repro_torch import sketchres as tsk
from repro_torch.kernels import count_sketch as cs
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import lowrank_update as klu
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import reorth as rk
from repro_torch.kernels import sketch_matvec as skm
from repro_torch.kernels import sparse_matvec as spm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, n, k, adt, qdt, seed):
    rng = np.random.default_rng(seed)

    def t(x, dt=torch.float32):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dt).cuda()

    A = t(rng.standard_normal((m, n)), adt)
    p, yn = t(rng.standard_normal(n)), t(rng.standard_normal(n))
    q, ym = t(rng.standard_normal(m)), t(rng.standard_normal(m))
    Q = t(np.linalg.qr(rng.standard_normal((m, k)))[0], qdt)
    P = t(np.linalg.qr(rng.standard_normal((n, k)))[0], qdt)
    return A, p, q, ym, yn, Q, P


def _assert_close(got, want, rtol):
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("m,n,k", [(64, 48, 4), (300, 517, 17),
                                   (127, 383, 9), (1024, 512, 64),
                                   (4099, 2050, 201)])
@pytest.mark.parametrize("adt,qdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16)])
def test_kernels_match_plain_versions(cuda, m, n, k, adt, qdt):
    A, p, q, ym, yn, Q, P = _inputs(m, n, k, adt, qdt, m + n + k)
    rtol = 1e-5 if adt == qdt == torch.float32 else 3e-2
    c = torch.linspace(-1, 1, k, device=cuda)
    alpha = torch.tensor([0.37], device=cuda)
    before = dict(gs.LAUNCHES)
    cases = [(lambda: gs.mv_qtv(A, p, ym, alpha, Q),
              ref.mv_qtv(A, p, ym, alpha, Q)),
             (lambda: gs.rmv_qtv(A, q, yn, 1.7, P),
              ref.rmv_qtv(A, q, yn, 1.7, P)),
             (lambda: gs.proj_qtv(ym, Q, c), ref.proj_qtv(ym, Q, c)),
             (lambda: gs.proj_norm(ym, Q, c), ref.proj_norm(ym, Q, c))]
    for kern, want in cases:
        got = kern()
        _assert_close(got, want, rtol)
        for a, b in zip(got, kern()):      # deterministic cross-block sums
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    stages = ("mv_qtv", "rmv_qtv", "proj_qtv", "proj_norm")
    assert gs.LAUNCHES == dict(before, **{name: before[name] + 2
                                          for name in stages})


@pytest.mark.parametrize("passes", [0, 1, 2, 3])
def test_fused_steps_match_plain_versions(cuda, passes):
    A, p, q, ym, yn, Q, P = _inputs(300, 517, 17, torch.float32,
                                    torch.float32, passes)
    _assert_close(ops.gk_step_fused(A, p, ym, 0.37, Q, passes),
                  ref.gk_step(A, p, ym, 0.37, Q, passes), 1e-5)
    _assert_close(ops.gk_rstep_fused(A, q, yn, 1.7, P, passes),
                  ref.gk_rstep(A, q, yn, 1.7, P, passes), 1e-5)


def test_f64_pallas_operand_raises(cuda):
    """No longer raises: a float64 DenseOp(backend="pallas") takes its
    half-steps through matvec_fused / rmatvec_fused (the reference's f64
    leg), which match their plain versions."""
    op = DenseOp(torch.randn(400, 300, dtype=torch.float64, device=cuda),
                 backend="pallas")
    q = torch.randn(400, dtype=torch.float64, device=cuda)
    p = torch.randn(300, dtype=torch.float64, device=cuda)
    Q = torch.zeros(400, 3, dtype=torch.float64, device=cuda)
    P = torch.zeros(300, 3, dtype=torch.float64, device=cuda)
    gs.reset_launches()
    u, _ = op.lanczos_step(p, q, torch.tensor(0.5, dtype=torch.float64,
                                              device=cuda), Q)
    v, _ = op.lanczos_rstep(q, p, 0.5, P)
    assert gs.LAUNCHES == dict(dict.fromkeys(gs.LAUNCHES, 0),
                               matvec_fused=1, rmatvec_fused=1)
    _assert_close([u, v], [ref.matvec_fused(op.A, p, q, 0.5),
                           ref.rmatvec_fused(op.A, q, p, 0.5)], 1e-5)


@pytest.mark.parametrize("m,n", [(64, 48), (300, 517), (257, 129),
                                 (127, 383), (1024, 512), (4099, 2050)])
@pytest.mark.parametrize("adt", [torch.float64, torch.float32,
                                 torch.bfloat16])
def test_fused_matvecs_match_plain_versions(cuda, m, n, adt):
    A, p, q, ym, yn, _, _ = _inputs(m, n, 1, adt, torch.float32, m ^ n)
    alpha = torch.tensor([0.37], device=cuda)
    before = dict(gs.LAUNCHES)
    cases = [(lambda: gs.matvec_fused(A, p, ym, alpha),
              ref.matvec_fused(A, p, ym, alpha)),
             (lambda: gs.rmatvec_fused(A, q, yn, 1.7),
              ref.rmatvec_fused(A, q, yn, 1.7))]
    for kern, want in cases:
        got = kern()
        _assert_close([got], [want], 1e-5)
        assert torch.equal(got, kern())       # fixed-order chunk sums
    torch.cuda.synchronize()
    assert gs.LAUNCHES == dict(before,
                               matvec_fused=before["matvec_fused"] + 2,
                               rmatvec_fused=before["rmatvec_fused"] + 2)


@pytest.mark.parametrize("n,d,b", [(300, 64, 24), (128, 130, 16),
                                   (70, 16, 48), (48, 48, 48),
                                   (200, 96, 32), (5000, 300, 4000)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["row_major", "transposed_view"])
def test_sketch_matmat_matches_plain_version(cuda, n, d, b, xdt, layout):
    g = torch.Generator(device=cuda).manual_seed(n * d + b)
    sk = tsketch.make_sketch(g, n, d, backend="pallas")
    if layout == "row_major":
        X = torch.randn(n, b, generator=g, device=cuda).to(xdt)
    else:
        X = torch.randn(b, n, generator=g, device=cuda).to(xdt).T
    before = skm.LAUNCHES["sketch_matmat"]
    got = skm.sketch_matmat(sk.signs, sk.idx, X)
    _assert_close([got], [ref.sketch_matmat(sk.signs, sk.idx, X)], 2e-5)
    _assert_close([got], [sk.dense().T @ X.float()], 2e-5)
    assert torch.equal(got, skm.sketch_matmat(sk.signs, sk.idx, X))
    torch.cuda.synchronize()
    assert skm.LAUNCHES["sketch_matmat"] == before + 2


def test_sketch_pass_reads_the_operand_in_place(cuda):
    """DenseOp(backend="pallas").sketch_pass launches the kernel on A and
    on the view Aᵀ, allocating only the panels (no copy of A)."""
    m, n = 4096, 3000
    A = torch.randn(m, n, device=cuda)
    op = DenseOp(A, backend="pallas")
    g = torch.Generator(device=cuda).manual_seed(0)
    om = tsketch.make_sketch(g, n, 64, backend="pallas")
    ps = tsketch.make_sketch(g, m, 128, backend="pallas")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    skm.reset_launches()
    Y, Z = op.sketch_pass(om, ps)
    torch.cuda.synchronize()
    assert skm.LAUNCHES["sketch_matmat"] == 2
    assert torch.cuda.max_memory_allocated() - base < A.numel() * 4 // 4
    _assert_close([Y, Z], [A @ om.dense(), A.T @ ps.dense()], 1e-5)


def test_gaussian_bf16_gnystrom_widens_the_operand_by_row_blocks(
        cuda, monkeypatch):
    """A bf16 Gaussian sketch applies Tᵀ to A and to the view Aᵀ a row
    block at a time: the solve's peak holds no bf16 or f32 copy of A.
    The block budget is cut so that A spans many blocks here."""
    from repro_torch.core import operators
    monkeypatch.setattr(operators, "_MIXED_ELEMS", 1 << 20)
    m, n = 4096, 3000
    g = torch.Generator(device=cuda).manual_seed(5)
    A = torch.randn(m, 20, generator=g, device=cuda) @ torch.randn(
        20, n, generator=g, device=cuda)
    s_true = torch.linalg.svdvals(A.double())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = factorize(A, SVDSpec(method="gnystrom", rank=8, sketch_dim=48,
                               sketch_kind="gaussian", precision="bf16",
                               backend="pallas"),
                    generator=torch.Generator(cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < A.numel() * 4 // 4
    err = float((got.s.double() - s_true[:8]).abs().max() / s_true[0])
    assert err < 5e-2                         # BF16_STOL["gnystrom"]


def test_wrappers_reject_strided_input(cuda):
    A, p, q, ym, yn, Q, P = _inputs(64, 48, 4, torch.float32,
                                    torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        gs.mv_qtv(A.T.contiguous().T, p, ym, 0.1, Q)


def test_solvers_run_through_the_kernels(cuda):
    """factorize / estimate_rank with backend="pallas" on a card tensor
    launch the kernels and agree with the plain-torch backend."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy((rng.standard_normal((600, 12))
                          @ rng.standard_normal((12, 400))
                          ).astype(np.float32)).to(cuda)
    q1 = torch.from_numpy(2 + rng.standard_normal(600).astype(
        np.float32)).to(cuda)
    gs.reset_launches()
    got = factorize(A, SVDSpec(method="fsvd", rank=5, max_iters=30,
                               backend="pallas"), q1=q1)
    assert gs.LAUNCHES["mv_qtv"] == 30 and gs.LAUNCHES["rmv_qtv"] == 29
    want = factorize(A, SVDSpec(method="fsvd", rank=5, max_iters=30,
                                backend="xla"), q1=q1)
    torch.testing.assert_close(got.s, want.s, rtol=1e-4, atol=0.0)
    assert int(got.iterations) == int(want.iterations)
    est = estimate_rank(A, SVDSpec(max_iters=40, backend="pallas"),
                        generator=torch.Generator(device=cuda).manual_seed(0))
    assert int(est) == 12


@pytest.mark.parametrize("method,kw", [
    ("gnystrom", dict(sketch_dim=48)), ("rbk", dict(passes=2, sketch_dim=16)),
    ("rsvd", dict(oversample=30, power_iters=1)), ("fsvd_blocked", dict())])
def test_sketch_and_blocked_solvers_on_the_card(cuda, method, kw):
    """The four solvers on a card tensor: σ within the reference's stol
    of the exact spectrum, the same bits on a rerun, and gnystrom's one
    sweep through three sketch_matmat launches."""
    g = torch.Generator(device=cuda).manual_seed(1)
    M = torch.randn(3000, 30, generator=g, device=cuda)
    N = torch.randn(30, 2000, generator=g, device=cuda)
    A = M @ N
    s_true = torch.linalg.svdvals(A.double())
    spec = SVDSpec(method=method, rank=8, backend="pallas", **kw)
    skm.reset_launches()
    got = factorize(A, spec, generator=torch.Generator(cuda).manual_seed(2))
    if method == "gnystrom":
        assert skm.LAUNCHES["sketch_matmat"] == 3
    again = factorize(A, spec, generator=torch.Generator(cuda).manual_seed(2))
    assert torch.equal(got.s, again.s)
    stol = {"gnystrom": 1e-3, "rbk": 5e-4, "rsvd": 5e-2,
            "fsvd_blocked": 5e-4}[method]        # SOLVERS[method]["stol"]
    err = float((got.s.double() - s_true[:8]).abs().max() / s_true[0])
    assert err < stol, (method, err)


def test_f64_fsvd_runs_through_the_fused_matvecs(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    A = (torch.randn(2000, 20, generator=g, device=cuda, dtype=torch.float64)
         @ torch.randn(20, 1500, generator=g, device=cuda,
                       dtype=torch.float64))
    s_true = torch.linalg.svdvals(A)
    gs.reset_launches()
    got = factorize(A, SVDSpec(method="fsvd", rank=8, max_iters=40,
                               backend="pallas"),
                    generator=torch.Generator(cuda).manual_seed(0))
    assert gs.LAUNCHES == dict(dict.fromkeys(gs.LAUNCHES, 0),
                               matvec_fused=40, rmatvec_fused=39)
    assert float((got.s - s_true[:8]).abs().max() / s_true[0]) < 5e-4


def _sparse(m, n, density, vdt, seed, device):
    """COO triplets on ``device`` (shuffled, with empty rows and one
    duplicate) and the dense matrix they sum to, from a numpy seed."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < density, rng.standard_normal((m, n)),
                 0.0)
    A[:2] = 0
    rows, cols = np.nonzero(A)
    idx = np.stack([rows, cols], 1)
    idx = np.concatenate([idx, idx[:1]])[rng.permutation(len(rows) + 1)]
    data = A[idx[:, 0], idx[:, 1]]
    dense = np.zeros((m, n))
    np.add.at(dense, (idx[:, 0], idx[:, 1]), data)
    return (torch.from_numpy(data).to(vdt).to(device),
            torch.from_numpy(idx.astype(np.int32)).to(device), dense)


@pytest.mark.parametrize("m,n,density", [(300, 517, 0.02), (257, 129, 0.1),
                                         (64, 48, 0.3), (128, 1000, 0.005),
                                         (40, 5000, 0.5), (3000, 60, 0.4)])
@pytest.mark.parametrize("b", [1, 5, 20, 40])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16,
                                 torch.float64])
def test_sparse_matvec_matches_plain_version(cuda, m, n, density, b, vdt):
    """Both packs of a ragged matrix (rows of 2500 slots take the block-
    per-row path), one vector and blocks of 5, 20 and 40 columns: against
    the plain version, twice bitwise, one launch per call."""
    data, idx, _ = _sparse(m, n, density, vdt, m + n + b, cuda)
    for shape, ix in (((m, n), idx), ((n, m), idx.flip(1))):
        vals, cols = spm.ell_pack(data, ix, shape)
        X = torch.randn(shape[1], b, device=cuda)
        if b == 1:
            X = X[:, 0].contiguous()
        before = spm.LAUNCHES["sparse_matvec"]
        got = spm.sparse_matvec(vals, cols, X)
        assert got.shape == ((shape[0],) if b == 1 else (shape[0], b))
        _assert_close([got], [ref.sparse_matvec(vals, cols, X)], 1e-5)
        assert torch.equal(got, spm.sparse_matvec(vals, cols, X))
        torch.cuda.synchronize()
        assert spm.LAUNCHES["sparse_matvec"] == before + 2


def test_ell_pack_on_the_card_is_the_cpu_pack(cuda):
    data, idx, _ = _sparse(500, 300, 0.05, torch.float32, 1, cuda)
    for got, want in zip(spm.ell_pack(data, idx, (500, 300)),
                         spm.ell_pack(data.cpu(), idx.cpu(), (500, 300))):
        assert torch.equal(got.cpu(), want)


def test_directly_built_pallas_sparse_op_launches_the_kernel(cuda):
    """SparseOp(data, indices, shape, backend="pallas") without from_coo
    packs itself and runs mv, rmv and a block through sparse_matvec, one
    launch each."""
    from repro_torch.core.operators import SparseOp
    data, idx, dense = _sparse(300, 200, 0.05, torch.float32, 3, cuda)
    op = SparseOp(data, idx, (300, 200), backend="pallas")
    D = torch.from_numpy(dense).float().to(cuda)
    x, q = torch.randn(200, device=cuda), torch.randn(300, device=cuda)
    V = torch.randn(200, 20, device=cuda)
    spm.reset_launches()
    got = [op.mv(x), op.rmv(q), op.matmat(V)]
    torch.cuda.synchronize()
    assert spm.LAUNCHES["sparse_matvec"] == 3
    _assert_close(got, [D @ x, D.T @ q, D @ V], 1e-5)


@pytest.mark.parametrize("m,n,r", [(64, 48, 4), (300, 200, 17),
                                   (1024, 512, 64), (100, 700, 5),
                                   (512, 128, 128), (300, 517, 7),
                                   (257, 129, 7), (127, 383, 7),
                                   (300, 200, 7), (30, 30, 10), (5, 3, 0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float64])
def test_lowrank_matmul_matches_plain_version(cuda, m, n, r, dt):
    g = torch.Generator(device=cuda).manual_seed(m * n + r)
    U = torch.randn(m, r, generator=g, device=cuda).to(dt)
    s = torch.rand(r, generator=g, device=cuda) + 0.5
    Vt = torch.randn(r, n, generator=g, device=cuda).to(dt)
    Vview = Vt.T.contiguous().T                    # strided, not copied
    before = klu.LAUNCHES["lowrank_matmul"]
    for V in (Vt, Vview):
        got = klu.lowrank_matmul(U, s, V)
        _assert_close([got], [ref.lowrank_matmul(U, s, V)], 1e-5)
        assert torch.equal(got, klu.lowrank_matmul(U, s, V))
    torch.cuda.synchronize()
    assert klu.LAUNCHES["lowrank_matmul"] == before + 4


class _Touches(Operator):
    """Counts the block and vector products a solver asks of ``inner``."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    shape = property(lambda self: self.inner.shape)
    dtype = property(lambda self: self.inner.dtype)
    device = property(lambda self: self.inner.device)

    def _touch(self, kind, x):
        self.calls += 1
        return getattr(self.inner, kind)(x)

    def mv(self, p):
        return self._touch("mv", p)

    def rmv(self, q):
        return self._touch("rmv", q)

    def matmat(self, V):
        return self._touch("matmat", V)

    def rmatmat(self, Q):
        return self._touch("rmatmat", Q)


@pytest.mark.parametrize("method", ["fsvd", "fsvd_blocked"])
def test_sparse_solvers_on_the_card(cuda, method):
    """A sparse operand with backend="pallas": every product the solver
    asks for is one sparse_matvec launch (a block included), σ within
    SOLVERS stol of the dense spectrum, and the same bits on a rerun."""
    prob = make_sparse_problem(torch.Generator(device=cuda).manual_seed(4),
                               2000, 1500, density=0.05, rank=12,
                               backend="pallas")
    s_true = torch.linalg.svdvals(prob.dense.double())
    op = prob.op
    spec = SVDSpec(method=method, rank=8, max_iters=60, backend="pallas")
    touches = _Touches(op)
    spm.reset_launches()
    got = factorize(touches, spec,
                    generator=torch.Generator(cuda).manual_seed(2))
    assert spm.LAUNCHES["sparse_matvec"] == touches.calls > 0
    if method == "fsvd":
        assert touches.calls == 2 * 60 + 1
    again = factorize(op, spec, generator=torch.Generator(cuda).manual_seed(2))
    assert torch.equal(got.s, again.s)
    err = float((got.s.double() - s_true[:8]).abs().max() / s_true[0])
    assert err < 5e-4                             # SOLVERS[method]["stol"]


def test_update_and_materialize_through_the_kernel(cuda):
    """update_factorization(backend="pallas") launches lowrank_matmul once
    (the core product) and matches the exact σ of the drifted operator;
    materialize_lowrank launches it once and matches its plain version."""
    g = torch.Generator(device=cuda).manual_seed(6)
    A = torch.randn(900, 10, generator=g, device=cuda) @ torch.randn(
        10, 700, generator=g, device=cuda)
    fact = factorize(A, SVDSpec(method="fsvd", rank=10, max_iters=40),
                     generator=torch.Generator(cuda).manual_seed(0))
    C = torch.randn(900, 3, generator=g, device=cuda)
    Dt = torch.randn(3, 700, generator=g, device=cuda)
    delta = LowRankOp(C, torch.full((3,), 0.05, device=cuda), Dt)
    klu.reset_launches()
    upd = update_factorization(fact, delta, beta=0.9, backend="pallas")
    assert klu.LAUNCHES["lowrank_matmul"] == 1
    assert int(upd.iterations) == 0
    A2 = (0.9 * (fact.U * fact.s[None, :]) @ fact.V.T
          + materialize_lowrank(delta)).double()
    s_true = torch.linalg.svdvals(A2)
    assert float((upd.s.double() - s_true[:10]).abs().max()
                 / s_true[0]) < 1e-5                # tests/test_update.py GATE
    klu.reset_launches()
    W = materialize_lowrank(delta, backend="pallas")
    assert klu.LAUNCHES["lowrank_matmul"] == 1
    _assert_close([W], [ref.lowrank_matmul(C, delta.s, Dt)], 1e-5)


# --------------------------------------------------------------------------
# slice 4: the reorthogonalization pair and the scatter-add
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k", [(64, 4), (300, 17), (1024, 64), (100, 5),
                                 (512, 128), (517, 5), (129, 31),
                                 (4099, 201)])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_reorth_pair_matches_plain_version(cuda, m, k, qdt):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    Q = torch.linalg.qr(torch.randn(m, k, generator=g, device=cuda))[0]
    Q = Q.to(qdt).contiguous()
    v = torch.randn(m, generator=g, device=cuda)
    c = torch.randn(k, generator=g, device=cuda)
    rtol = 1e-5 if qdt == torch.float32 else 3e-2
    rk.reset_launches()
    for kern, plain in ((lambda: rk.qtv(Q, v), ref.qtv(Q, v)),
                        (lambda: rk.subtract_qc(v, Q, c),
                         ref.subtract_qc(v, Q, c))):
        got, again = kern(), kern()
        assert torch.equal(got, again)
        _assert_close([got], [plain], rtol)
    assert rk.LAUNCHES == {"qtv": 2, "subtract_qc": 2}
    for passes in (1, 2):
        w = ops.reorth(v, Q, passes)
        assert torch.equal(w, ops.reorth(v, Q, passes))
        _assert_close([w], [ref.reorth(v, Q, passes)], rtol)
    if qdt == torch.float32:
        assert float((Q.T @ w).abs().max()) < 1e-4 * float(v.norm())


def _cpu_plain(rows, cols, vals, shape):
    return ref.scatter_add(rows.cpu(), cols.cpu(), vals.cpu(), shape)


@pytest.mark.parametrize("E,m,d,hot", [(300, 37, 20, 0), (128, 128, 128, 0),
                                       (1, 5, 3, 0), (513, 260, 130, 0),
                                       (200_000, 1000, 128, 0),
                                       (100_000, 40, 30, 3)])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
def test_scatter_add_matches_cpu_plain_version_bitwise(cuda, E, m, d, hot,
                                                       vdt):
    """Gaussian values, heavy collisions (``hot`` > 0 sends every entry to
    a 3 x 3 corner) and coordinates past the panel: the kernel sums in
    entry order, so it equals the CPU plain version bit for bit, twice."""
    g = torch.Generator(device=cuda).manual_seed(E + m)
    hi_r, hi_c = (hot, hot) if hot else (m + 2, d + 2)
    rows = torch.randint(0, hi_r, (E,), generator=g, device=cuda,
                         dtype=torch.int32)
    cols = torch.randint(0, hi_c, (E,), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(E, generator=g, device=cuda).to(vdt)
    cs.reset_launches()
    got = cs.scatter_add(rows, cols, vals, (m, d))
    again = cs.scatter_add(rows, cols, vals, (m, d))
    assert cs.LAUNCHES["scatter_add"] == 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), _cpu_plain(rows, cols, vals, (m, d)))


def _stream(cuda, E, hi_r, hi_c, vdt, seed, lo=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    rows = torch.randint(lo, hi_r, (E,), generator=g, device=cuda,
                         dtype=torch.int32)
    cols = torch.randint(lo, hi_c, (E,), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(E, generator=g, device=cuda, dtype=torch.float64)
    return rows, cols, vals.to(vdt)


# (E, m, d, tile_bits, lo, hi_r, hi_c, sub): coordinates outside the panel
# on every side; a ragged last tile; d = 1; empty tiles (a stream on a few
# rows of a tall panel); one tile that takes everything; bins of 2**sub
# tiles (4, read whole; 8, 64 and 128, each cut into parts of one tile),
# so that a panel of 411 to 62,500 tiles has at most 512 bins
BIN_CASES = [(50_000, 300, 37, 7, -3, 303, 40, 0),
             (50_000, 400, 100, 5, -1, 401, 101, 2),
             (20_000, 1000, 1, 6, 0, 1000, 1, 0),
             (30_000, 5000, 64, 10, 0, 40, 64, 0),
             (40_000, 100, 100, 14, 0, 100, 100, 0),
             (60_000, 700, 150, 5, -1, 701, 151, 3),
             (100_000, 1000, 1000, 5, -1, 1001, 1001, 6),
             (100_000, 2000, 1000, 5, 0, 2000, 1000, 7)]


@pytest.mark.parametrize("E,m,d,bits,lo,hi_r,hi_c,sub", BIN_CASES)
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16,
                                 torch.float64])
def test_bin_scatter_matches_the_binning_model(cuda, E, m, d, bits, lo,
                                               hi_r, hi_c, sub, vdt):
    """The card's steps 1–4 (count, scan, stable scatter into bins, and
    into parts of one tile where bins are wider) give the plain model's
    offsets and (cell, value) stream exactly, with bins of one tile and of
    many."""
    plan = cs.bin_plan(E, (m, d), bits)
    assert plan.bin_bits - plan.tile_bits == sub
    split = sub > cs.DIRECT_SUB_BITS
    assert plan.part_bits == (plan.tile_bits if split else plan.bin_bits)
    rows, cols, vals = _stream(cuda, E, hi_r, hi_c, vdt, E + m, lo)
    offsets, cells, values = cs.bin_entries(rows, cols, vals, plan)
    want = ref.bin_entries(rows.cpu(), cols.cpu(), vals.cpu(), (m, d),
                           plan.part_bits)
    for got, w in zip((offsets, cells, values), want):
        assert got.dtype == w.dtype
        assert torch.equal(got.cpu(), w)


@pytest.mark.parametrize("E,m,d,bits,lo,hi_r,hi_c", [
    (300_000, 1000, 128, 14, 0, 1000, 128),     # across 8 tiles
    (300_000, 1000, 128, 7, 0, 1000, 128),      # bins of 2 tiles
    (300_000, 1000, 128, 14, 0, 3, 128),        # all into one tile
    (300_000, 1000, 128, 14, 0, 1, 1),          # all into one cell
    (200_000, 1000, 1000, 5, -1, 1001, 1001),   # bins of 64 tiles
    (200_000, 2000, 1000, 5, 0, 2000, 1000)])   # bins of 128 tiles
@pytest.mark.parametrize("vdt", [torch.float32, torch.float64])
def test_scatter_add_streams_bitwise(cuda, E, m, d, bits, lo, hi_r, hi_c,
                                     vdt):
    """Streams across tile boundaries, all into one tile or one cell, and
    into bins of many tiles (the stages of a plan with small tiles), f32
    and f64 values: bit for bit the CPU plain version, twice; scatter_add
    itself launches once a call."""
    rows, cols, vals = _stream(cuda, E, hi_r, hi_c, vdt, E + bits, lo)
    plan = cs.bin_plan(E, (m, d), bits)
    got = cs.fold(rows, cols, vals, plan)
    again = cs.fold(rows, cols, vals, plan)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), _cpu_plain(rows, cols, vals, (m, d)))
    cs.reset_launches()
    assert torch.equal(cs.scatter_add(rows, cols, vals, (m, d)), got)
    assert cs.LAUNCHES["scatter_add"] == 1


@pytest.mark.parametrize("bins,slices", [(cs.BATCH_BINS + 1, 8),
                                         (0, 8), (4, 12)])
def test_bin_stages_refuse_tables_they_cannot_hold(cuda, bins, slices):
    """The binning kernels check the limits their shared-memory tables
    rely on (at most BATCH_BINS bins, whole blocks of WARPS slices) and
    raise, rather than write past a table."""
    rows, cols, vals = _stream(cuda, 1000, 100, 100, torch.float32, 5)
    plan = cs.bin_plan(1000, (100, 100))._replace(bins=bins, slices=slices)
    counts = torch.zeros(max(bins, 1) * slices, dtype=torch.int32,
                         device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cs.count_bins(rows, cols, plan)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cs.scatter_bins(rows, cols, vals, plan, counts, counts)


def test_scatter_add_empty_stream_launches_nothing(cuda):
    e = torch.zeros(0, dtype=torch.int32, device=cuda)
    cs.reset_launches()
    z = ops.scatter_add(e, e, torch.zeros(0, device=cuda), (4, 6))
    assert cs.LAUNCHES["scatter_add"] == 0
    assert z.device.type == "cuda" and torch.equal(z.cpu(), torch.zeros(4, 6))


def test_fold_on_the_card_equals_the_fold_on_the_cpu(cuda):
    """The same state (panels and tables) on both devices, the same entry
    stream: the pallas fold on the card launches the scatter-add twice and
    gives the CPU fold's panels bit for bit."""
    gen = torch.Generator().manual_seed(4)
    A = torch.randn(300, 20, generator=gen) @ torch.randn(20, 200,
                                                          generator=gen)
    spec = SVDSpec(method="gnystrom", rank=10, backend="pallas")
    host = tsk.sketch_operand(A, spec,
                              generator=torch.Generator().manual_seed(7))
    om, ps = host.sketches()
    dev = tsk.SketchState(
        Y=host.Y.to(cuda), Z=host.Z.to(cuda),
        folded_mass=host.folded_mass.to(cuda),
        base_norm=host.base_norm.to(cuda),
        tables=tuple(type(t)(t.slots.to(cuda), t.signs.to(cuda), t.d)
                     for t in (om, ps)), backend="pallas")
    host = dataclasses.replace(host, seeds=None, tables=(om, ps))
    E = 50_000
    rows = torch.randint(0, 300, (E,), generator=gen, dtype=torch.int32)
    cols = torch.randint(0, 200, (E,), generator=gen, dtype=torch.int32)
    vals = torch.randn(E, generator=gen)
    cs.reset_launches()
    folded = tsk.apply_entries(dev, rows.to(cuda), cols.to(cuda),
                               vals.to(cuda))
    assert cs.LAUNCHES["scatter_add"] == 2
    want = tsk.apply_entries(host, rows, cols, vals)
    assert torch.equal(folded.Y.cpu(), want.Y)
    assert torch.equal(folded.Z.cpu(), want.Z)
    assert isinstance(tsk.is_stale(folded), torch.Tensor)
    f = tsk.reconstruct(folded, spec)
    assert int(f.iterations) == 0 and f.method == "sketch"
