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
The projection pair is held at f32 bounds with a bf16 basis too: its
plain version widens the same rounded basis, so only the order of the
sums differs.  The sparse matvec and the low-rank materialization widen
their bf16 and f64 inputs to f32 before they multiply, so they too are
held at f32 bounds against their plain versions (which widen the same
way).  The
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


def _stacked_inputs(m, n, k, adt, qdt, B, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def t(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    return (t(B, m, n, dt=adt), t(B, n), t(B, m), t(B, m), t(B, n), t(B),
            t(B, m, k, dt=qdt), t(B, n, k, dt=qdt), t(B, k))


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("adt,qdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("m,n,k", [(64, 48, 4), (300, 517, 17),
                                   (127, 383, 9), (192, 128, 25),
                                   (1025, 333, 201), (4096, 2048, 101)])
def test_stacked_launches_are_single_launches(cuda, m, n, k, adt, qdt, B):
    """One launch of each stage covers a stack of B examples: example b
    is bit for bit a single launch on it (the same plan, partials and
    finishing order), the stack is within tolerance of its stacked plain
    version and bitwise stable, and each call counts one launch."""
    A, p, q, ym, yn, al, Q, P, c = _stacked_inputs(m, n, k, adt, qdt, B,
                                                   m + n + k + B)
    rtol = 1e-5 if adt == qdt == torch.float32 else 3e-2
    cases = {"mv_qtv": (lambda: gs.mv_qtv(A, p, ym, al, Q),
                        lambda b: gs.mv_qtv(A[b], p[b], ym[b], al[b], Q[b]),
                        ref.mv_qtv(A, p, ym, al, Q)),
             "rmv_qtv": (lambda: gs.rmv_qtv(A, q, yn, al, P),
                         lambda b: gs.rmv_qtv(A[b], q[b], yn[b], al[b],
                                              P[b]),
                         ref.rmv_qtv(A, q, yn, al, P)),
             "proj_qtv": (lambda: gs.proj_qtv(ym, Q, c),
                          lambda b: gs.proj_qtv(ym[b], Q[b], c[b]),
                          ref.proj_qtv(ym, Q, c)),
             "proj_norm": (lambda: gs.proj_norm(ym, Q, c),
                           lambda b: gs.proj_norm(ym[b], Q[b], c[b]),
                           ref.proj_norm(ym, Q, c))}
    for name, (stacked, single, want) in cases.items():
        before = gs.LAUNCHES[name]
        got = stacked()
        assert gs.LAUNCHES[name] == before + 1
        _assert_close(got, want, rtol if name[0] in "mr" else
                      (3e-2 if qdt == torch.bfloat16 else 1e-5))
        for a, b in zip(got, stacked()):
            assert torch.equal(a, b)
        for b in range(B):
            for a, w in zip(got, single(b)):
                assert torch.equal(a[b], w), (name, b)
    torch.cuda.synchronize()


def test_stacked_rmv_qtv_at_the_batched_shape(cuda):
    """The batched solve's shape, 2 × 8192 × 4096 f32 with a 100-column
    P: a stacked walk of many row chunks and tiles an example.  Example b
    is bit for bit a single launch on it, and the stack is within f32
    bounds of ``ref.rmv_qtv``."""
    m, n, k, B = 8192, 4096, 100, 2
    A, _, q, _, yn, al, _, P, _ = _stacked_inputs(m, n, k, torch.float32,
                                                   torch.float32, B, 26)
    got = gs.rmv_qtv(A, q, yn, al, P)
    _assert_close(got, ref.rmv_qtv(A, q, yn, al, P), 1e-5)
    for b in range(B):
        for a, w in zip(got, gs.rmv_qtv(A[b], q[b], yn[b], al[b], P[b])):
            assert torch.equal(a[b], w), b
    torch.cuda.synchronize()


def test_stacked_mv_qtv_at_the_batched_shape(cuda):
    """The batched solve's shape, 2 × 8192 × 4096 f32 with a 101-column
    Q: stage 1's row grid has 1,024 blocks, so its finish sums 1,024
    partials a column, more than the 512 a warp of the projection pair's
    stacked finish could take.  Example b is bit for bit a single launch
    on it, and the stack is within f32 bounds of ``ref.mv_qtv``."""
    m, n, k, B = 8192, 4096, 101, 2
    A, p, _, ym, _, al, Q, _, _ = _stacked_inputs(m, n, k, torch.float32,
                                                   torch.float32, B, 27)
    assert gs.rows_plan(m)[1] > 2 * gs.THREADS
    got = gs.mv_qtv(A, p, ym, al, Q)
    _assert_close(got, ref.mv_qtv(A, p, ym, al, Q), 1e-5)
    for b in range(B):
        for a, w in zip(got, gs.mv_qtv(A[b], p[b], ym[b], al[b], Q[b])):
            assert torch.equal(a[b], w), b
    torch.cuda.synchronize()


def _pair_stack(cuda, B, L, k, qdt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(B, L, generator=g, device=cuda)
    X = (torch.randn(B, L, k, generator=g, device=cuda) / L ** 0.5).to(qdt)
    return u, X, torch.randn(B, k, generator=g, device=cuda)


def _assert_pair_is_single_launches(name, got, u, X, c):
    kern = getattr(gs, name)
    for b in range(u.shape[0]):
        for a, w in zip(got, kern(u[b], X[b], c[b])):
            assert torch.equal(a[b], w), (name, b)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,k", [(8192, 101), (4096, 100)])
def test_stacked_projection_pair_at_the_batched_shapes(cuda, L, k, qdt):
    """The batched solve's Q (2 × 8192 × 101) and P (2 × 4096 × 100)
    bases: the stacked proj_qtv and proj_norm are bit for bit a single
    launch on each example, bitwise the same run to run, and within f32
    bounds of the plain versions."""
    u, X, c = _pair_stack(cuda, 2, L, k, qdt, L + k)
    for name in ("proj_qtv", "proj_norm"):
        got = getattr(gs, name)(u, X, c)
        _assert_close(got, getattr(ref, name)(u, X, c), 1e-5)
        for a, b in zip(got, getattr(gs, name)(u, X, c)):
            assert torch.equal(a, b)
        _assert_pair_is_single_launches(name, got, u, X, c)
    torch.cuda.synchronize()


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 96, 127, 128, 129, 200, 256,
                               300])
def test_stacked_projection_pair_across_register_widths(cuda, k, qdt):
    """The register path takes 4 slots a lane up to 128 columns, else 8:
    on either side of that width, past the register path (k > 256) and
    with zeros of both signs in u, c and the basis, every example of the
    stacked proj_qtv, proj_norm and rmv_qtv's Pᵀv is bit for bit a single
    launch on it."""
    B, L = 3, 777
    u, X, c = _pair_stack(cuda, B, L, k, qdt, k)
    u[:, ::5] = -0.0
    c[:, ::3] = -0.0
    X[:, ::7] = -0.0
    X[1] = 0.0                             # example 1: every product 0
    for name in ("proj_qtv", "proj_norm"):
        _assert_pair_is_single_launches(name, getattr(gs, name)(u, X, c),
                                        u, X, c)
    g = torch.Generator(device="cuda").manual_seed(k)
    A = torch.randn(B, 64, L, generator=g, device=cuda)
    q = torch.randn(B, 64, generator=g, device=cuda)
    got = gs.rmv_qtv(A, q, u, 0.5, X)
    for b in range(B):
        for a, w in zip(got, gs.rmv_qtv(A[b], q[b], u[b], 0.5, X[b])):
            assert torch.equal(a[b], w), b
    torch.cuda.synchronize()


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_stacked_projection_pair_past_one_finishing_pass(cuda, qdt):
    """A stack of 2 × 49152 × 101 (Q) and 2 × 49152 × 100 (rmv_qtv's P):
    each plan's grid is past 256 for an f32 and a bf16 basis, so the warp
    finish takes its second pass over the partials.  Every example of the
    stacked proj_qtv, proj_norm and rmv_qtv's Pᵀv is bit for bit a single
    launch on it, and the stack is within f32 bounds of the plain
    versions."""
    B, L = 2, 49152
    for k in (101, 100):
        assert gs.proj_plan(L, k, qdt).grid > gs.THREADS
    u, X, c = _pair_stack(cuda, B, L, 101, qdt, 16)
    for name in ("proj_qtv", "proj_norm"):
        got = getattr(gs, name)(u, X, c)
        _assert_close(got, getattr(ref, name)(u, X, c), 1e-5)
        _assert_pair_is_single_launches(name, got, u, X, c)
    g = torch.Generator(device="cuda").manual_seed(17)
    A = torch.randn(B, 64, L, generator=g, device=cuda)
    q = torch.randn(B, 64, generator=g, device=cuda)
    P = X[..., :100].contiguous()
    got = gs.rmv_qtv(A, q, u, 0.5, P)
    _assert_close(got, ref.rmv_qtv(A, q, u, 0.5, P), 1e-5)
    for b in range(B):
        for a, w in zip(got, gs.rmv_qtv(A[b], q[b], u[b], 0.5, P[b])):
            assert torch.equal(a[b], w), b
    torch.cuda.synchronize()


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [64, 128, 200])
def test_projection_keeps_the_sign_of_underflowed_dots(cuda, k, qdt, B):
    """Rows whose every product Q[r, j]·c[j] lies below the least
    subnormal, with u = −0: each product rounds to −0.  A lane's chain
    ends as the 8-slot chain of the register path, whose slots past k add
    +0 and turn its −0 into +0 (at k = 128 only the +0 add after 4 slots
    does), so every w_r = −0 − (+0) = −0, bit for bit, in proj_qtv,
    proj_norm and subtract_qc."""
    g = torch.Generator(device="cuda").manual_seed(k)
    L = 1000
    X = (torch.rand(B, L, k, generator=g, device=cuda) + 0.5) * 1e-30
    X = X.to(qdt)
    c = -(torch.rand(B, k, generator=g, device=cuda) + 0.5) * 1e-20
    u = torch.full((B, L), -0.0, device=cuda)
    ws = [gs.proj_qtv(u, X, c)[0], gs.proj_norm(u, X, c)[0]]
    ws += [rk.subtract_qc(u[b], X[b], c[b]) for b in range(B)]
    for w in ws:
        assert bool((w == 0).all()) and bool(torch.signbit(w).all())
    torch.cuda.synchronize()


def test_stacked_projection_pair_on_streams_and_in_graphs(cuda):
    """The stacked proj_qtv at the batched solve's Q stack (8 × 8192 ×
    101: the kernel, then the warp finish): two streams calling it at
    once, and a call captured in a CUDA graph and replayed twice, give
    the bits of serial calls."""
    B, L, k = 8, 8192, 101
    calls = [_pair_stack(cuda, B, L, k, torch.float32, s) for s in (1, 2)]
    want = [gs.proj_qtv(*args) for args in calls]
    streams = [torch.cuda.Stream() for _ in calls]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [None] * len(calls)
    for rep in range(4):
        for i, (st, args) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(st):
                got[i] = gs.proj_qtv(*args)
        for st in streams:
            torch.cuda.current_stream().wait_stream(st)
        for outs, w in zip(got, want):
            for a, b in zip(outs, w):
                assert torch.equal(a, b), rep
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gs.proj_qtv(*calls[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gs.proj_qtv(*calls[0])
    for _ in range(2):
        for x in captured:
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, want[0]):
            assert torch.equal(a, b)


def test_solve_batched_on_the_card(cuda):
    """fsvd over B = 3 stacked operands: one call a stage for the batch
    (a single solve's launch counts), each example's σ within 1e-5·σ_max
    of its own plan.solve from the same q1."""
    from repro_torch.api import plan
    rng = np.random.default_rng(4)
    As = torch.from_numpy(np.stack([
        rng.standard_normal((192, 10)) @ rng.standard_normal((10, 128))
        for _ in range(3)]).astype(np.float32)).to(cuda)
    q1s = torch.from_numpy(2 + rng.standard_normal((3, 192)).astype(
        np.float32)).to(cuda)
    spec = SVDSpec(method="fsvd", rank=8, max_iters=24, backend="pallas")
    gs.reset_launches()
    got = plan(spec).solve_batched(As, q1s=q1s)
    assert gs.LAUNCHES["mv_qtv"] == 24 and gs.LAUNCHES["rmv_qtv"] == 23
    assert got.s.shape == (3, 8)
    for b in range(3):
        one = plan(spec).solve(As[b], q1=q1s[b])
        assert float((got.s[b] - one.s).abs().max()) <= 1e-5 * float(one.s[0])


@pytest.mark.parametrize("passes", [0, 1, 2, 3])
def test_fused_steps_match_plain_versions(cuda, passes):
    A, p, q, ym, yn, Q, P = _inputs(300, 517, 17, torch.float32,
                                    torch.float32, passes)
    _assert_close(ops.gk_step_fused(A, p, ym, 0.37, Q, passes),
                  ref.gk_step(A, p, ym, 0.37, Q, passes), 1e-5)
    _assert_close(ops.gk_rstep_fused(A, q, yn, 1.7, P, passes),
                  ref.gk_rstep(A, q, yn, 1.7, P, passes), 1e-5)


# (L, k) of the projection pair's cases: with 24-row f32 / 80-row bf16
# tiles at k = 201, 7 rows are less than one tile and 2050 end on a ragged
# tile; "several" is 3 x grid x tile rows + 5 of the dtype's own plan, so
# each block walks several tiles and the last is ragged.  Past REG_K
# columns: at k = 1000 and 3000 c sits in shared memory beside two
# stages, at 20,000 it does so in bf16 only, and at MAX_K it is read from
# device memory (f32: a tile is one row in one stage).
PROJ_CASES = [(1, 1), (7, 201), (2050, 201), ("several", 201),
              (100_000, 201), (80_000, 200), (5000, 1), (5000, 4),
              (5000, 1000), (300, 3000), (300, 20_000), (40, gs.MAX_K)]


def _proj_inputs(cuda, L, k, qdt, seed, extra_rows=0):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(cuda)

    B = t(rng.standard_normal((L + extra_rows, k)) / np.sqrt(L)).to(qdt)
    return t(rng.standard_normal(L)), B, t(rng.standard_normal(k))


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,k", PROJ_CASES)
def test_projection_pair_matches_plain_versions(cuda, L, k, qdt):
    """proj_qtv / proj_norm against their plain versions (which widen the
    same bf16 basis to f32: f32 bounds), bitwise on a rerun, one launch
    counted a call."""
    if L == "several":
        plan = gs.proj_plan(1, k, qdt)
        L = 3 * gs.PROJ_BLOCKS * plan.tile_rows + 5
        assert gs.proj_plan(L, k, qdt).tiles == 3 * gs.PROJ_BLOCKS + 1
    u, Q, c = _proj_inputs(cuda, L, k, qdt, L + k)
    before = dict(gs.LAUNCHES)
    for kern, plain in ((gs.proj_qtv, ref.proj_qtv),
                        (gs.proj_norm, ref.proj_norm)):
        got = kern(u, Q, c)
        _assert_close(got, plain(u, Q, c), 1e-5)
        for a, b in zip(got, kern(u, Q, c)):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert gs.LAUNCHES == dict(before, proj_qtv=before["proj_qtv"] + 2,
                               proj_norm=before["proj_norm"] + 2)


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [7, 5000])
def test_projection_pair_reads_an_unaligned_basis(cuda, L, qdt):
    """A basis whose data_ptr is off a 16-byte boundary (the contiguous view
    B[1:] of an (L+1, 201) tensor): the tiles' copies peel the array's
    ends, and the result is the aligned copy's, bit for bit."""
    u, B, c = _proj_inputs(cuda, L, 201, qdt, L, extra_rows=1)
    Q = B[1:]
    assert Q.is_contiguous() and Q.data_ptr() % 16 != 0
    aligned = Q.clone()
    assert aligned.data_ptr() % 16 == 0
    for kern, plain in ((gs.proj_qtv, ref.proj_qtv),
                        (gs.proj_norm, ref.proj_norm)):
        got = kern(u, Q, c)
        _assert_close(got, plain(u, Q, c), 1e-5)
        for a, b in zip(got, kern(u, aligned, c)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["tile_rows", "grid", "stages", "smem",
                                 "flags"])
def test_projection_pair_refuses_plans_past_its_limits(cuda, monkeypatch,
                                                        bad):
    """gk_step.cu checks the plan it is handed against its own limits (tile
    rows, grid cap, ring depth, 227 KB of shared memory, flags it does not
    know) and refuses it before a launch: the wrapper raises."""
    L, k = 300, gs.MAX_K if bad == "smem" else 201
    u, Q, c = _proj_inputs(cuda, L, k, torch.float32, 3)
    plan = gs.proj_plan(L, k, torch.float32)
    plan = {"tile_rows": plan._replace(tile_rows=gs.MAX_TILE_ROWS + 1),
            "grid": plan._replace(grid=gs.PROJ_BLOCKS + 1),
            "stages": plan._replace(stages=5),
            "smem": plan._replace(stages=2),
            "flags": plan._replace(flags=2)}[bad]
    monkeypatch.setattr(gs, "proj_plan", lambda *args: plan)
    for kern in (gs.proj_qtv, gs.proj_norm):
        with pytest.raises(RuntimeError, match="invalid argument"):
            kern(u, Q, c)


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


@pytest.mark.parametrize("m", [1, 7, 20_000])
@pytest.mark.parametrize("n", [1024, 1003])          # 1003: a ragged tail
@pytest.mark.parametrize("adt", [torch.float64, torch.float32,
                                 torch.bfloat16])
def test_matvec_fused_persistent_kernel(cuda, m, n, adt):
    """matvec_fused's own kernel against its plain version, twice bitwise,
    one launch a call; for f32 and bf16 A its u has the bits of mv_qtv's
    u (the same row loop)."""
    A, p, _, ym, _, Q, _ = _inputs(m, n, 1, adt, torch.float32, m + n)
    alpha = torch.tensor([0.37], device=cuda)
    before = gs.LAUNCHES["matvec_fused"]
    got = gs.matvec_fused(A, p, ym, alpha)
    _assert_close([got], [ref.matvec_fused(A, p, ym, alpha)], 1e-5)
    assert torch.equal(got, gs.matvec_fused(A, p, ym, alpha))
    torch.cuda.synchronize()
    assert gs.LAUNCHES["matvec_fused"] == before + 2
    if adt != torch.float64:
        u, _ = gs.mv_qtv(A, p, ym, alpha, Q)
        assert torch.equal(got, u)


@pytest.mark.parametrize("grid", ["past_the_cap", "idle_block", "zero"])
def test_matvec_fused_refuses_plans_past_its_limits(cuda, monkeypatch,
                                                    grid):
    """gk_step.cu refuses a grid past SMS x MV_BLOCKS_PER_SM blocks, one
    with a block that owns no row, and an empty one: the wrapper
    raises."""
    A, p, _, ym, _, _, _ = _inputs(100, 64, 1, torch.float32,
                                   torch.float32, 5)
    bad = {"past_the_cap": gs.SMS * gs.MV_BLOCKS_PER_SM + 1,
           "idle_block": gs.matvec_plan(100) + 1, "zero": 0}[grid]
    monkeypatch.setattr(gs, "matvec_plan", lambda *args: bad)
    with pytest.raises(RuntimeError, match="invalid argument"):
        gs.matvec_fused(A, p, ym, 0.5)


# (m, n) of the Aᵀq kernel's own cases: n not a multiple of 4 (4-byte
# loads), one row, a tall narrow operand, several column tiles with a
# ragged last one (1,024 f32 / 2,048 bf16 / 512 f64 columns a tile of 256
# threads), spans that cross tiles, and row groups of 1 to 128 threads.
RMV_CASES = [(300, 1003), (1, 5000), (10**6, 3), (4099, 2050), (257, 4100),
             (3000, 2048), (5000, 201), (20_000, 100), (7, 4), (999, 40)]
A_TYPES = [torch.float64, torch.float32, torch.bfloat16]


@pytest.mark.parametrize("adt", A_TYPES)
@pytest.mark.parametrize("m,n", RMV_CASES)
def test_rmv_kernel_matches_plain_versions(cuda, m, n, adt):
    """rmatvec_fused, and for f32 / bf16 A rmv_qtv, against the plain
    versions, bitwise on a rerun; rmv_qtv's v has rmatvec_fused's bits
    and its c those of reorth.qtv(P, v)."""
    A, _, q, _, yn, _, P = _inputs(m, n, 17, adt, torch.float32, m + n)
    got = gs.rmatvec_fused(A, q, yn, 1.7)
    _assert_close([got], [ref.rmatvec_fused(A, q, yn, 1.7)], 1e-5)
    assert torch.equal(got, gs.rmatvec_fused(A, q, yn, 1.7))
    if adt == torch.float64:
        return
    v, c = gs.rmv_qtv(A, q, yn, 1.7, P)
    _assert_close([v, c], ref.rmv_qtv(A, q, yn, 1.7, P), 1e-5)
    again = gs.rmv_qtv(A, q, yn, 1.7, P)
    assert torch.equal(v, again[0]) and torch.equal(c, again[1])
    assert torch.equal(v, got)
    assert torch.equal(c, rk.qtv(P, v))


@pytest.mark.parametrize("adt", A_TYPES)
@pytest.mark.parametrize("m,n", [(300, 2048), (50, 1024), (1, 512)])
def test_rmv_kernel_reads_an_unaligned_operand(cuda, m, n, adt):
    """A contiguous A that starts one element into its buffer (4 bytes
    off a 16-byte boundary in f32) takes 4-byte loads; the sums run in
    the same order as over the aligned copy, so the bits are the same."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    buf = torch.randn(m * n + 1, generator=g, device=cuda).to(adt)
    A = buf[1:].view(m, n)
    assert A.is_contiguous() and A.data_ptr() % 16 != 0
    aligned = A.clone()
    assert aligned.data_ptr() % 16 == 0
    q = torch.randn(m, generator=g, device=cuda)
    y = torch.randn(n, generator=g, device=cuda)
    got = gs.rmatvec_fused(A, q, y, 0.5)
    _assert_close([got], [ref.rmatvec_fused(A, q, y, 0.5)], 1e-5)
    assert torch.equal(got, gs.rmatvec_fused(aligned, q, y, 0.5))
    if adt != torch.float64:
        P = torch.randn(n, 5, generator=g, device=cuda)
        for a, b in zip(gs.rmv_qtv(A, q, y, 0.5, P),
                        gs.rmv_qtv(aligned, q, y, 0.5, P)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["past_the_cap", "idle_chunk", "short",
                                 "zero", "cols"])
def test_rmv_kernel_refuses_plans_past_its_limits(cuda, monkeypatch, bad):
    """gk_step.cu refuses more than SMS x RMV_BLOCKS_PER_SM blocks of
    several chunks, a chunk that owns no row, chunks that do not cover
    the rows, no chunk and row groups of a width it does not take: both
    wrappers raise."""
    A, _, q, _, yn, _, P = _inputs(3000, 2048, 4, torch.float32,
                                   torch.float32, 9)
    plan = gs.rmv_plan(3000, 2048, torch.float32)
    cap = gs.SMS * gs.RMV_BLOCKS_PER_SM
    assert plan.tiles * plan.chunks <= cap < plan.tiles * 600
    plan = {"past_the_cap": plan._replace(rows=5, chunks=600),
            "idle_chunk": plan._replace(chunks=plan.chunks + 1),
            "short": plan._replace(rows=plan.rows - 1),
            "zero": plan._replace(chunks=0),
            "cols": plan._replace(cols=96)}[bad]
    monkeypatch.setattr(gs, "rmv_plan", lambda *args: plan)
    with pytest.raises(RuntimeError, match="invalid argument"):
        gs.rmatvec_fused(A, q, yn, 0.5)
    with pytest.raises(RuntimeError, match="invalid argument"):
        gs.rmv_qtv(A, q, yn, 0.5, P)


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


LONG_N = 98_305          # three windows of x, the last of one element


@pytest.mark.parametrize("L", [1023, 1024, 4802, 20_000])
@pytest.mark.parametrize("b", [1, 20])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16,
                                 torch.float64])
@pytest.mark.parametrize("windows", [False, True])
def test_sparse_matvec_long_rows(cuda, L, b, vdt, windows):
    """Rows of L slots (1,023 and 4,802: every other row starts off a
    16-byte boundary) over an x of three windows, with and without the
    window layout (through which a block takes the block kernel): against
    the plain version, twice bitwise, one launch a call."""
    rng = np.random.default_rng(L + b)
    m = 37
    cols = torch.from_numpy(rng.integers(0, LONG_N, (m, L), dtype=np.int32))
    vals = torch.from_numpy(rng.standard_normal((m, L)).astype(np.float32))
    vals, cols = vals.to(vdt).to(cuda), cols.to(cuda)
    X = torch.randn(LONG_N, b, device=cuda)
    if b == 1:
        X = X[:, 0].contiguous()
    layout = spm.window_layout(vals, cols, LONG_N, torch.full(
        (m,), L, device=cuda)) if windows else None
    v, c = (vals, cols) if layout is None else layout[:2]
    before = spm.LAUNCHES["sparse_matvec"]
    got = spm.sparse_matvec(v, c, X, layout)
    _assert_close([got], [ref.sparse_matvec(vals, cols, X)], 1e-5)
    if layout is not None:
        ratio = spm.WINDOW_SUBS if b == 1 else spm.block_ratio(b)
        _assert_close([got], [ref.sparse_matvec_windows(
            *layout[:3], X, ratio)], 1e-5)
    assert torch.equal(got, spm.sparse_matvec(v, c, X, layout))
    torch.cuda.synchronize()
    assert spm.LAUNCHES["sparse_matvec"] == before + 2


@pytest.mark.parametrize("windows", [False, True])
def test_sparse_matvec_reads_unaligned_runs(cuda, windows):
    """A pack that starts off a 16-byte boundary (rows [1:] of a pack of
    1,023 slots, or of its window layout) takes the slot-by-slot loads,
    against the plain version; an x off a 16-byte boundary gives the bits
    of its aligned copy."""
    rng = np.random.default_rng(11)
    cols = torch.from_numpy(rng.integers(0, LONG_N, (9, 1023),
                                         dtype=np.int32)).to(cuda)
    vals = torch.randn(9, 1023, device=cuda)
    full = spm.window_layout(vals, cols, LONG_N, torch.full(
        (9,), 1023, device=cuda)) if windows else None
    if windows:
        vals, cols = full.vals, full.cols
    xs = torch.randn(LONG_N + 1, device=cuda)
    x = xs[1:]                                   # 4 bytes off the boundary
    for r in (1, 0):
        v, c = vals[r:], cols[r:]
        layout = spm.WindowLayout(v, c, full.offsets[r:],
                                  full.window_offsets[r:]) if windows \
            else None
        got = spm.sparse_matvec(v, c, x, layout)
        _assert_close([got], [ref.sparse_matvec(v, c, x)], 1e-5)
        assert torch.equal(got, spm.sparse_matvec(v, c, x.clone(), layout))


def test_sparse_op_transpose_carries_the_window_layout(cuda):
    """A SparseOp on the card builds the layout of each pack once (its
    padding marked by the row populations); .T carries them across (no
    second build), and mv / rmv through them match the plain products."""
    from repro_torch.core.operators import SparseOp
    data, idx, dense = _sparse(2600, 300, 0.5, torch.float32, 7, cuda)
    op = SparseOp(data, idx, (2600, 300), backend="pallas")
    # each pack is held once, in its layout's order
    for k in (0, 1):
        assert op.ell[2 * k] is op.windows[k].vals
        assert op.ell[2 * k + 1] is op.windows[k].cols
    for k, (shape, ix) in enumerate((((2600, 300), idx),
                                     ((300, 2600), idx.flip(1)))):
        want = spm.pack_layout(
            *spm.ell_pack(data, ix, shape), shape[1],
            torch.bincount(ix[:, 0].long(), minlength=shape[0]))
        assert want.offsets is not None
        assert all(torch.equal(a, b) for a, b in zip(op.windows[k], want))
    t = op.T
    assert t.windows[0] is op.windows[1] and t.windows[1] is op.windows[0]
    D = torch.from_numpy(dense).float().to(cuda)
    q = torch.randn(2600, device=cuda)
    spm.reset_launches()
    got = [op.rmv(q), t.mv(q)]
    torch.cuda.synchronize()
    assert spm.LAUNCHES["sparse_matvec"] == 2
    assert torch.equal(got[0], got[1])
    _assert_close(got[:1], [D.T @ q], 1e-5)
    Q = torch.randn(2600, 20, device=cuda)       # a block, through that pack
    _assert_close([op.rmatmat(Q)], [D.T @ Q], 1e-5)


def test_sparse_matvec_windows_refuse_plans_past_their_limits(cuda,
                                                             monkeypatch):
    """sparse_matvec.cu checks the window plan it is handed (windows that
    do not cover x, row groups that do not cover the rows) and refuses it
    before a launch: the wrapper raises."""
    vals = torch.randn(5, 1100, device=cuda)
    cols = torch.randint(0, LONG_N, (5, 1100), device=cuda,
                         dtype=torch.int32)
    x = torch.randn(LONG_N, device=cuda)
    layout = spm.window_layout(vals, cols, LONG_N, torch.full(
        (5,), 1100, device=cuda))
    plan = spm.window_plan(5, LONG_N)
    for bad in (plan._replace(groups=plan.groups + 1),
                plan._replace(rows_per_group=1, groups=1),
                plan._replace(windows=plan.windows - 1)):
        monkeypatch.setattr(spm, "window_plan", lambda *args: bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            spm.sparse_matvec(layout.vals, layout.cols, x, layout)


@pytest.mark.parametrize("b", [2, 3, 5, 8, 13, 20, 31, 32])
@pytest.mark.parametrize("m,n,density", [(300, 517, 0.02), (257, 129, 0.1),
                                         (40, 5000, 0.5), (3000, 60, 0.4),
                                         (5, 30_000, 0.3)])
@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16,
                                 torch.float64])
def test_block_kernel_matches_plain_version(cuda, m, n, density, b, vdt):
    """Blocks of 2 to 32 columns through the layout of both packs of a
    ragged matrix (empty rows, a duplicate; short rows, rows of 2,500 and
    9,000 slots, one block window and several): against the plain
    version on the same pack and against the layout's own plain model,
    twice bitwise, one launch a call."""
    data, idx, _ = _sparse(m, n, density, vdt, m + n + b, cuda)
    for shape, ix in (((m, n), idx), ((n, m), idx.flip(1))):
        vals, cols = spm.ell_pack(data, ix, shape)
        lay = spm.window_layout(vals, cols, shape[1], torch.bincount(
            ix[:, 0].long(), minlength=shape[0]))
        X = torch.randn(shape[1], b, device=cuda)
        before = spm.LAUNCHES["sparse_matvec"]
        got = spm.sparse_matvec(lay.vals, lay.cols, X, lay)
        assert got.shape == (shape[0], b)
        _assert_close([got], [ref.sparse_matvec(vals, cols, X)], 1e-5)
        _assert_close([got], [ref.sparse_matvec_windows(
            *lay[:3], X, spm.block_ratio(b))], 1e-5)
        assert torch.equal(got, spm.sparse_matvec(lay.vals, lay.cols, X,
                                                  lay))
        torch.cuda.synchronize()
        assert spm.LAUNCHES["sparse_matvec"] == before + 2


@pytest.mark.parametrize("b", [2, 7, 20, 32])
def test_block_kernel_on_skewed_rows(cuda, b):
    """Rows from empty to 30,000 slots (segments longer than a staged
    chunk, a window's worth of padding) and a pack whose entries all fall
    in one column, every draw from a generator seeded by the case: the
    kernel and the plain version each within an f32 sum's bound of an
    f64 sum of the same terms, row by row, and the kernel twice bitwise.

    The bound of a sum of L products in f32 (u = 2^-24), in any order:
    7 sqrt(L + 1) u sum |a x|.  With the rounding errors independent and
    of mean zero, the error exceeds lambda sqrt(L + 1) u sum |a x| with
    probability at most 2 exp(-lambda^2 / 2) (Higham & Mary, SIAM J.
    Sci. Comput. 41 (2019)): 5e-11 an output at lambda = 7.  The two
    sums' orders differ, and so do their errors: over 128 seeded cases
    on the card each reached 0.58 of the lambda = 1 bound where they
    differed by 1.1e-5 of max |y|, so they are not held to each other."""
    seed = 1000 * b
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = 60_000
    counts = np.array([0, 30_000, 1, 7, 0, 4_000, 41, 40, 39, 2] * 3)
    rows = np.repeat(np.arange(len(counts)), counts)
    length = torch.from_numpy(counts).to(cuda).double()[:, None]
    for cols in (rng.integers(0, n, rows.shape[0]),
                 np.full(rows.shape[0], n - 1)):
        idx = torch.from_numpy(np.stack([rows, cols], 1).astype(
            np.int32)).to(cuda)
        data = torch.randn(rows.shape[0], device=cuda, generator=g)
        vals, pc = spm.ell_pack(data, idx, (len(counts), n))
        lay = spm.window_layout(vals, pc, n, torch.from_numpy(
            counts).to(cuda))
        X = torch.randn(n, b, device=cuda, generator=g)
        got = spm.sparse_matvec(lay.vals, lay.cols, X, lay)
        plain = ref.sparse_matvec(vals, pc, X)
        terms = vals.double()[..., None] * X.double()[pc.long()]
        exact = terms.sum(1)
        bound = 7 * torch.sqrt(length + 1) * 2.0 ** -24 * terms.abs().sum(1)
        for y in (got, plain):
            assert bool(((y.double() - exact).abs() <= bound).all())
        assert torch.equal(got, spm.sparse_matvec(lay.vals, lay.cols, X,
                                                  lay))


def test_sparse_op_block_products_take_the_block_kernel(cuda, monkeypatch):
    """SparseOp's matmat / rmatmat with 20 columns run the block kernel
    (one launch each, no warp-per-row launch), and a block of 40 columns
    the warp-per-row kernel; both match the dense products."""
    from repro_torch.core.operators import SparseOp
    data, idx, dense = _sparse(3000, 400, 0.05, torch.float32, 11, cuda)
    op = SparseOp(data, idx, (3000, 400), backend="pallas")
    D = torch.from_numpy(dense).float().to(cuda)
    calls = []
    lib = spm._lib()

    class Spy:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(spm, "_lib", lambda: Spy())
    V, Q = torch.randn(400, 20, device=cuda), torch.randn(3000, 20,
                                                          device=cuda)
    _assert_close([op.matmat(V), op.rmatmat(Q)], [D @ V, D.T @ Q], 1e-5)
    assert calls == ["sparse_matvec_block"] * 2
    calls.clear()
    W = torch.randn(400, 40, device=cuda)
    _assert_close([op.matmat(W)], [D @ W], 1e-5)
    assert calls == ["sparse_matvec"]


def test_sparse_op_on_a_wide_sparse_matrix_holds_no_layout(cuda,
                                                          monkeypatch):
    """A wide, sparse operand (rows of a few slots over an x of 200,000):
    neither pack keeps a layout (its sub-window table would outweigh the
    pack) and its block products take the warp-per-row kernel, with no
    partials scratch; mv, rmv and both block products match the dense
    products."""
    from repro_torch.core.operators import SparseOp
    data, idx, dense = _sparse(200, 200_000, 2e-5, torch.float32, 13, cuda)
    op = SparseOp(data, idx, (200, 200_000), backend="pallas")
    assert op.windows == (None, None)
    D = torch.from_numpy(dense).float().to(cuda)
    calls = []
    lib = spm._lib()

    class Spy:
        def __getattr__(self, name):
            calls.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(spm, "_lib", lambda: Spy())
    V, Q = torch.randn(200_000, 20, device=cuda), torch.randn(200, 20,
                                                              device=cuda)
    _assert_close([op.matmat(V), op.rmatmat(Q), op.mv(V[:, 0].contiguous()),
                   op.rmv(Q[:, 0].contiguous())],
                  [D @ V, D.T @ Q, D @ V[:, 0], D.T @ Q[:, 0]], 1e-5)
    assert calls == ["sparse_matvec"] * 4


def test_sparse_matvec_block_refuses_plans_past_its_limits(cuda,
                                                           monkeypatch):
    """sparse_matvec.cu checks the block plan it is handed (windows that
    do not cover X, a window past the shared memory, row groups that do
    not cover the rows) and refuses it before a launch."""
    data, idx, _ = _sparse(300, 5000, 0.1, torch.float32, 3, cuda)
    vals, cols = spm.ell_pack(data, idx, (300, 5000))
    lay = spm.window_layout(vals, cols, 5000, torch.bincount(
        idx[:, 0].long(), minlength=300))
    X = torch.randn(5000, 20, device=cuda)
    plan = spm.block_plan(300, 5000, 20)
    for bad in (plan._replace(windows=plan.windows + 1),
                plan._replace(ratio=plan.ratio + 1),
                plan._replace(groups=plan.groups + 1),
                plan._replace(rows_per_group=1, groups=1)):
        monkeypatch.setattr(spm, "block_plan", lambda *args: bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            spm.sparse_matvec(lay.vals, lay.cols, X, lay)


SKETCH_RAGGED = [(1025, 37, 24, 5), (70_001, 130, 8, 1000),
                 (3000, 200, 7, 3), (2000, 3, 1100, 37), (48, 48, 1, 17),
                 (5, 300, 5, 4099)]


@pytest.mark.parametrize("N,d,zeta,b", SKETCH_RAGGED)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float64])
@pytest.mark.parametrize("layout", ["row_major", "row_pitch",
                                    "transposed_view"])
def test_sketch_kernels_on_ragged_shapes(cuda, N, d, zeta, b, dt, layout):
    """Both sketch kernels on ragged d, ζ, N and b, with f32, bf16 and
    f64 X and signs: a row-major X (16-byte loads), a row pitch one past b
    (element loads), a transposed view (the range kernel, with the
    sketch's kept order; past a chunk's ζ the element path): against the
    plain version, twice bitwise, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(N + d + zeta + b)
    sk = tsketch.make_sketch(g, N, d, zeta=zeta, dtype=dt, backend="pallas")
    if layout == "transposed_view":
        X = torch.randn(b, N, generator=g, device=cuda).to(dt).T
    else:
        X = torch.randn(N, b + 1, generator=g, device=cuda).to(dt)[:, :b]
        X = X.contiguous() if layout == "row_major" else X
    before = skm.LAUNCHES["sketch_matmat"]
    got = skm.sketch_matmat(sk.signs, sk.idx, X, sk.order)
    _assert_close([got], [ref.sketch_matmat(sk.signs, sk.idx, X)], 2e-5)
    assert torch.equal(got, skm.sketch_matmat(sk.signs, sk.idx, X,
                                              sk.order))
    torch.cuda.synchronize()
    assert skm.LAUNCHES["sketch_matmat"] == before + 2


def test_sketch_range_and_rows_kernels_agree_bit_for_bit(cuda):
    """Y[i, c] is the same fmaf chain in slot order on both paths: a
    transposed view through the range kernel and its row-major copy
    through the row kernel give the same bits, and so does the range
    kernel without the kept order (made for the call)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    sk = tsketch.make_sketch(g, 9000, 128, backend="pallas")
    A = torch.randn(3000, 9000, generator=g, device=cuda)
    via_range = skm.sketch_matmat(sk.signs, sk.idx, A.T, sk.order)
    assert torch.equal(via_range, skm.sketch_matmat(
        sk.signs, sk.idx, A.T.contiguous(), sk.order))
    assert torch.equal(via_range, skm.sketch_matmat(sk.signs, sk.idx, A.T))


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


# (m, k) of the reorthogonalization pair's own cases: odd widths, k = 1,
# the projection pair's widest basis, and several tiles a block
REORTH_CASES = [(7, 1), (5000, 1), (4099, 201), (2050, 17), (40, gs.MAX_K),
                (300, 3000), (100_000, 201)]


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", REORTH_CASES)
def test_reorth_pair_takes_the_staged_tiles(cuda, m, k, qdt):
    """qtv and subtract_qc against their plain versions (which widen the
    same basis: f32 bounds), bitwise on a rerun; a basis that starts one
    row into its buffer (never 16-byte aligned at odd k) gives the aligned
    copy's bits; subtract_qc(v, Q, c) is proj_norm's w and qtv(Q, v)
    proj_qtv(v, Q, 0)'s c', bit for bit (the same staged tiles)."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    B = (torch.randn(m + 1, k, generator=g, device=cuda)
         / float(np.sqrt(m))).to(qdt)
    v = torch.randn(m, generator=g, device=cuda)
    c = torch.randn(k, generator=g, device=cuda)
    aligned = B[1:].clone()
    rk.reset_launches()
    for Q in (aligned, B[1:]):
        got_c, got_w = rk.qtv(Q, v), rk.subtract_qc(v, Q, c)
        _assert_close([got_c, got_w], [ref.qtv(Q, v),
                                       ref.subtract_qc(v, Q, c)], 1e-5)
        assert torch.equal(got_c, rk.qtv(aligned, v))
        assert torch.equal(got_w, rk.subtract_qc(v, aligned, c))
    assert rk.LAUNCHES == {"qtv": 4, "subtract_qc": 4}
    assert torch.equal(got_w, gs.proj_norm(v, aligned, c)[0])
    assert torch.equal(got_c, gs.proj_qtv(v, aligned, torch.zeros_like(c))[1])


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


# --- the Session's folds, probe and checkpoints on the card -----------------

@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_blocked_lowrank_fold_is_the_whole_drift_fold(cuda, beta,
                                                      monkeypatch):
    """``fold_lowrank`` by ragged row blocks (at most 37 rows) gives the
    bits of ``beta · A + materialize_lowrank`` over the whole drift: the
    materialization kernel sums each element's r terms in one order
    whatever the block."""
    import importlib
    ses = importlib.import_module("repro_torch.api.session")
    rng = np.random.default_rng(21)
    m, n, r = 1025, 777, 3

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()

    A = t(m, n)
    delta = LowRankOp(t(m, r), t(r).abs() + 0.5, t(r, n), scale=0.3)
    whole = beta * A + materialize_lowrank(delta, backend="pallas")
    monkeypatch.setattr(ses, "_FOLD_BYTES", 4 * n * 37)
    klu.reset_launches()
    got = ses.fold_lowrank(A, delta, beta, backend="pallas")
    assert klu.LAUNCHES["lowrank_matmul"] == -(-m // 37)
    assert torch.equal(got, whole)
    assert torch.equal(ses.fold_lowrank(A, delta, beta, backend="pallas"),
                       got)


def test_entry_fold_on_the_card_is_bitwise_and_the_cpu_fold(cuda):
    """Every coordinate four times, shuffled, values across ten decades:
    the fold on the card gives the same bits on a rerun, and the CPU
    fold's bits (both add in entry order, one level at a time)."""
    from repro_torch.api.session import fold_entries
    rng = np.random.default_rng(22)
    m, n, e = 3000, 2000, 100_000
    A = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    r0 = rng.integers(0, m, e).astype(np.int32)
    c0 = rng.integers(0, n, e).astype(np.int32)
    order = rng.permutation(4 * e)
    rows = torch.from_numpy(np.tile(r0, 4)[order])
    cols = torch.from_numpy(np.tile(c0, 4)[order])
    vals = torch.from_numpy((rng.standard_normal(4 * e) * 10.0 **
                             rng.integers(-8, 3, 4 * e)).astype(np.float32))
    Ad = A.cuda()
    got = fold_entries(Ad, rows.cuda(), cols.cuda(), vals.cuda())
    again = fold_entries(Ad, rows.cuda(), cols.cuda(), vals.cuda())
    assert torch.equal(got, again)
    want = fold_entries(A, rows, cols, vals)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(Ad.cpu(), A)                   # out of place


def test_residual_probe_on_the_card_matches_numpy(cuda):
    """A rank-4 truncation of a full-rank operand (probe ~1): the card's
    products land within 1e-6 relative of the numpy path on the same
    inputs and the same Ω."""
    from repro_torch.api.results import Factorization
    from repro_torch.serve.resilience import residual_probe
    rng = np.random.default_rng(23)
    A = torch.from_numpy(rng.standard_normal((2000, 1500)).astype(
        np.float32))
    U, s, Vt = torch.linalg.svd(A.double(), full_matrices=False)
    f = Factorization(U[:, :4].float(), s[:4].float(), Vt[:4].T.float(),
                      torch.tensor(4), torch.tensor(False))
    want = residual_probe(A.numpy(), f, probes=4, seed=5)
    fd = Factorization(*(x.cuda() for x in (f.U, f.s, f.V, f.iterations,
                                            f.breakdown)))
    got = residual_probe(A.cuda(), fd, probes=4, seed=5)
    assert 0.5 < want < 1.0
    assert abs(got - want) <= 1e-6 * want


def test_session_state_round_trip_of_card_tensors(cuda, tmp_path):
    """A session solved on the card saves through the store and restores
    onto the card (the store's default device) bit for bit."""
    from repro_torch.api.session import Session, session
    from repro_torch.checkpoint import load_session_state
    gen = torch.Generator(device="cuda").manual_seed(3)
    A = torch.randn(600, 8, generator=gen, device="cuda") @ torch.randn(
        8, 400, generator=gen, device="cuda")
    sess = session(A, SVDSpec(method="fsvd", rank=8, max_iters=32,
                              backend="pallas"), generator=gen)
    sess.solve()
    sess.save(str(tmp_path))
    fact, meta = load_session_state(str(tmp_path), 1)
    assert meta == sess.meta()
    for name in ("U", "s", "V", "iterations", "breakdown"):
        got, want = getattr(fact, name), getattr(sess.fact, name)
        assert got.device.type == "cuda" and torch.equal(got, want)
    back = Session.restore(str(tmp_path), A, generator=gen)
    assert back.fact.U.device.type == "cuda"
    assert torch.equal(back.fact.s, sess.fact.s)


def test_session_stream_on_the_card(cuda):
    """Every branch of the policy on the card, as chip_smoke.py's phase 9
    drives it at full width: the kinds, zero iterations off the solver
    branches, the launches of each ported kernel."""
    from repro_torch.api.session import session
    gen = torch.Generator(device="cuda").manual_seed(4)
    m, n, r = 3000, 2000, 8
    A = torch.randn(m, r, generator=gen, device="cuda") @ torch.randn(
        r, n, generator=gen, device="cuda")
    sess = session(A, SVDSpec(method="fsvd", rank=r, max_iters=64,
                              backend="pallas"), generator=gen)
    gs.reset_launches()
    sess.solve()
    assert gs.LAUNCHES["mv_qtv"] == 64
    drift = A + 1e-4 * torch.randn(m, n, generator=gen, device="cuda")
    gs.reset_launches()
    sess.update(drift)
    assert sess.history[-1]["kind"] == "refine"
    assert gs.LAUNCHES["mv_qtv"] == sess.history[-1]["budget"] < 64
    U = torch.randn(m, 2, generator=gen, device="cuda")
    Vt = torch.randn(2, n, generator=gen, device="cuda")
    klu.reset_launches()
    sess.delta(LowRankOp(U, torch.full((2,), 1e-3, device="cuda"), Vt))
    assert sess.history[-1]["kind"] == "update"
    assert klu.LAUNCHES["lowrank_matmul"] >= 2     # the core and the fold
    sess.downdate(rows=[1, 7, 99])
    assert sess.history[-1]["kind"] == "downdate"
    rows = torch.randint(0, m, (5000,), generator=gen, device="cuda")
    cols = torch.randint(0, n, (5000,), generator=gen, device="cuda")
    vals = 1e-4 * torch.randn(5000, generator=gen, device="cuda")
    cs.reset_launches()
    gs.reset_launches()
    sess.entries(rows, cols, vals)
    rec = sess.history[-1]
    assert rec["kind"] == "sketch" and rec["iterations"] == 0
    assert rec["probe"] <= rec["gate"]
    assert cs.LAUNCHES["scatter_add"] == 2 and gs.LAUNCHES["mv_qtv"] == 0


# --- slice 12: the RSL application on the card ---------------------------------

def _rsl_point_distance(Wa, Wb):
    """||Wa - Wb||_F / ||Wb||_F through the factors, in f64."""
    def fro(left, right):
        return torch.linalg.vector_norm(
            torch.linalg.qr(left).R @ torch.linalg.qr(right).R.T)
    Ua, sa, Va = (t.double() for t in Wa)
    Ub, sb, Vb = (t.double() for t in Wb)
    return float(fro(torch.cat([Ua * sa, -(Ub * sb)], 1),
                     torch.cat([Va, Vb], 1)) / fro(Ub * sb, Vb))


def test_rsl_steps_rerun_bit_for_bit_on_the_card(cuda):
    """Ten tracking steps twice from the seed: the same U, s, V and loss
    bits; no hand-written kernel runs on this path."""
    from repro_torch.launch import train_rsl
    args = ["--device", "cuda", "--d1", "2000", "--d2", "1500", "--n-train",
            "2048", "--steps", "10", "--seed", "5"]
    gs.reset_launches()
    klu.reset_launches()
    a = train_rsl.main(args)
    b = train_rsl.main(args)
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for x, y in zip(a["W"], b["W"]))
    assert a["W"].U.is_cuda and a["memory"] is not None
    assert sum(gs.LAUNCHES.values()) == 0
    assert klu.LAUNCHES["lowrank_matmul"] == 0


@pytest.mark.parametrize("warm", [True, False])
def test_rsl_retractions_agree_on_the_card(cuda, warm):
    """retract_fsvd (tracking and cold) within 1e-4 of retract_qr on the
    card, as phase 10 gates it at full width."""
    from repro_torch.core import manifold as mf
    from repro_torch.core import rsgd
    from repro_torch.data.synthetic import make_rsl_dataset, rsl_batch
    gen = torch.Generator(device="cuda").manual_seed(6)
    ds = make_rsl_dataset(gen, 1024, 3000, 2500, 5, noise=0.05)
    W = mf.random_point(gen, 3000, 2500, 5)
    b = rsl_batch(ds, 0, 0, 64)
    g = rsgd.batch_euclidean_grad(W, b["x"], b["v"], b["y"])
    xi = mf.project_tangent(W, g.op)
    Wf = mf.retract_fsvd(W, xi, -3.0, warm_start=warm,
                         generator=None if warm else gen)
    Wq = mf.retract_qr(W, xi, -3.0)
    assert Wf.U.is_cuda
    assert _rsl_point_distance(Wf, Wq) <= 1e-4


def test_grad_spectrum_on_the_card_matches_the_cpu(cuda):
    from repro_torch.runtime.telemetry import grad_spectrum
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(400, 6, generator=gen) @ torch.randn(6, 300,
                                                         generator=gen)
    cpu = grad_spectrum(g, k=8)
    card = grad_spectrum(g.cuda(), k=8)
    assert card["sigma"].is_cuda
    assert int(card["rank"]) == int(cpu["rank"]) == 6
    torch.testing.assert_close(card["sigma"][:6].cpu(), cpu["sigma"][:6],
                               rtol=1e-4, atol=0)
    assert abs(float(card["energy_r"]) - float(cpu["energy_r"])) < 1e-4


# --- slice 13: the solve server on the card ------------------------------------

def _serve_operands(n, shape, seed):
    from repro_torch.serve.traffic import lowrank_operand
    rng = np.random.default_rng(seed)
    return [lowrank_operand(rng, shape, 8) for _ in range(n)]


@pytest.mark.parametrize("n", [3, 8])
def test_served_batch_is_the_direct_call_on_the_card(cuda, n):
    """A batch the server coalesces (``backend="pallas"``: the stacked
    GK-step launches) is ``solve_batched`` of its padded stack with each
    request's generator, U, s and V bit for bit; the answers are on the
    host."""
    from repro_torch.serve import SolveServer
    from repro_torch.serve.bucket import stack
    ops = _serve_operands(n, (400, 300), 8)
    spec = SVDSpec(method="fsvd", rank=8, backend="pallas")
    gs.reset_launches()
    with SolveServer(spec, max_batch=n, window_ms=10_000.0,
                     generator=torch.Generator().manual_seed(2)) as srv:
        assert srv.device.type == "cuda"
        tickets = [srv.submit(A) for A in ops]
        served = [t.result(timeout=120.0).value for t in tickets]
        assert gs.LAUNCHES["mv_qtv"] > 0
        seqs = [t.payload["seq"] for t in tickets]
        pad = (1 << (n - 1).bit_length()) - n
        direct = srv.plan.solve_batched(
            stack(ops + [ops[-1]] * pad, "cuda"),
            generators=[srv.request_generator(s)
                        for s in seqs + [seqs[-1]] * pad])
    for i, f in enumerate(served):
        assert f.s.device.type == "cpu"
        for name in ("U", "s", "V"):
            assert torch.equal(getattr(f, name),
                               getattr(direct, name)[i].cpu()), name


def test_warmup_loads_every_reachable_library(cuda, monkeypatch):
    """warmup (on the card, ``backend="pallas"``) loads the library of
    every kernel a dispatch can reach in the caller's thread; anonymous
    batches, a degraded answer, tenant deltas and entry folds after it
    start no build on the dispatch worker."""
    import threading
    from repro_torch.kernels import _build
    from repro_torch.runtime import faults
    from repro_torch.serve import SolveServer
    from repro_torch.serve.traffic import entry_drift, lowrank_drift
    builds = []
    real_build = _build.build

    def recording_build(names=None):
        builds.append((threading.current_thread().name, list(names or [])))
        return real_build(names)

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", recording_build)
    spec = SVDSpec(method="fsvd", rank=8, backend="pallas")
    shape = (400, 300)
    with SolveServer(spec, generator=torch.Generator().manual_seed(3),
                     hang_timeout_s=30.0) as srv:
        srv.warmup([shape])
        assert {"gk_step", "lowrank_update", "sketch_matvec",
                "count_sketch"} <= set(_build._LIBS)
        main = threading.current_thread().name
        assert all(name == main for name, _ in builds)
        warm = len(builds)
        A, B = _serve_operands(2, shape, 9)
        assert srv.solve(A, timeout=120.0).value.s.shape == (8,)
        faults.arm(faults.PLAN_SOLVE, mode="raise", p=1.0, max_fires=1)
        try:
            res = srv.solve(B, timeout=120.0)
        finally:
            faults.disarm_all()
        assert res.meta["degraded"] and res.meta["method"] == "gnystrom"
        rng = np.random.default_rng(4)
        T = _serve_operands(1, shape, 10)[0]
        srv.solve(T, tenant="t", timeout=120.0)
        srv.solve(lowrank_drift(rng, T, drift=1e-3, drift_rank=2),
                  kind="delta", tenant="t", timeout=120.0)
        srv.solve(entry_drift(rng, T, drift=1e-3, nnz=256),
                  kind="entries", tenant="t", timeout=120.0)
        assert srv.stats()["worker_restarts"] == 0
    assert len(builds) == warm


# --- slice 14: the distributed layer's stage-1 launches ----------------------

@pytest.mark.parametrize("m,n,k", [(5003, 777, 201), (1001, 4099, 33)])
def test_local_stage1_kernels_match_plain_versions(cuda, m, n, k):
    """local_mv_qtv / local_rmv_qtv on a shard whose rows are not a
    multiple of the row kernel's tile (8 rows a block group): one stage-1
    launch each, counted, against the plain versions at f32 bounds."""
    A, p, q, ym, yn, Q, P = _inputs(m, n, k, torch.float32, torch.float32,
                                    m + n + k)
    alpha = torch.tensor([0.37], device=cuda)
    before = dict(gs.LAUNCHES)
    u, c = ops.local_mv_qtv(A, p, ym, alpha, Q)
    v, d = ops.local_rmv_qtv(A, q, yn, 1.7, P)
    assert gs.LAUNCHES["mv_qtv"] == before["mv_qtv"] + 1
    assert gs.LAUNCHES["rmv_qtv"] == before["rmv_qtv"] + 1
    for got, want in [((u, c), ref.mv_qtv(A, p, ym, alpha, Q)),
                      ((v, d), ref.rmv_qtv(A, q, yn, 1.7, P))]:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))


def test_two_ranks_fsvd_sharded_on_one_card(cuda, tmp_path):
    """Two gloo ranks share cuda:0: fsvd_sharded through the stage-1
    kernels within 1e-5·σ_max of the single-device port's fsvd from the
    same q1, the same σ on both ranks."""
    import torch_world as tw
    rng = np.random.default_rng(14)
    A = (rng.standard_normal((3001, 40)) @ rng.standard_normal((40, 1200))
         + 1e-3 * rng.standard_normal((3001, 1200))).astype(np.float32)
    q1 = (2.0 + rng.standard_normal(3001)).astype(np.float32)
    np.savez(tmp_path / "in.npz", A=A, q1=q1)
    ranks = tw.run_port(tw.gpu_fsvd_case, str(tmp_path),
                        str(tmp_path / "in.npz"), world=2)
    smax = float(np.linalg.svd(A.astype(np.float64), compute_uv=False)[0])
    for got in ranks:
        np.testing.assert_array_equal(got["sharded"], ranks[0]["sharded"])
        assert np.max(np.abs(got["sharded"] - got["single"])) / smax < 1e-5
        assert list(got["launches"]) == [48, 47]


# --- the LM stack (phase 13 of chip_smoke.py) ---------------------------------

LM_ARCHS = ["deepseek-v2-236b", "gemma-7b", "gemma2-9b", "llava-next-34b",
            "mamba2-780m", "olmoe-1b-7b", "stablelm-1.6b", "starcoder2-15b",
            "whisper-base", "zamba2-1.2b"]


def _lm_setup(arch, device, seed=0):
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import LMBatchSpec, lm_batch
    from repro_torch.models import model as TM
    cfg = get_arch(arch).reduced()
    model, _ = TM.init_model(cfg, torch.Generator(device=device).manual_seed(
        seed))
    img = cfg.vlm.num_image_tokens if cfg.vlm is not None else 0
    frames = 32 if cfg.encdec is not None else 0
    batch = lm_batch(LMBatchSpec(2, 32, cfg.vocab_size, img, frames,
                                 cfg.d_model), seed, 0, device=device)
    return cfg, model, batch


def _lm_state(model, opt):
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.steps import TrainState
    return TrainState(model, make_optimizer(opt)[0](
        dict(model.named_parameters())))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_the_card(cuda, arch):
    """Each family's reduced train step on the card: finite, not skipped,
    the parameters moved, and its loss within 1e-5 relative of the port's
    CPU loss on the same parameters and batch."""
    import copy
    from repro_torch.configs import OptimConfig
    from repro_torch.models import model as TM
    from repro_torch.runtime.steps import build_train_step
    cfg, model, batch = _lm_setup(arch, cuda)
    cpu = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        cpu_loss = float(TM.loss_fn(cpu, {k: v.cpu() for k, v in
                                          batch.items()}, cfg)[0])
    before = [p.detach().clone() for p in model.parameters()]
    opt = OptimConfig(lr=1e-3, warmup_steps=0)
    _, metrics = build_train_step(cfg, opt)(_lm_state(model, opt), batch)
    loss = float(metrics["loss"])
    assert int(metrics["skipped"]) == 0
    assert np.isfinite(loss) and np.isfinite(float(metrics["grad_norm"]))
    assert abs(loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    assert any(not torch.equal(p.detach(), b)
               for p, b in zip(model.parameters(), before))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_lm_train_step_never_syncs(cuda, arch):
    """A train step (forward, backward, clip, AdamW, the NaN guard's
    select) under torch.cuda.set_sync_debug_mode("error"): nothing reads a
    value back to the host."""
    from repro_torch.configs import OptimConfig
    from repro_torch.runtime.steps import build_train_step
    cfg, model, batch = _lm_setup(arch, cuda)
    opt = OptimConfig(lr=1e-3, warmup_steps=0)
    step = build_train_step(cfg, opt)
    state, _ = step(_lm_state(model, opt), batch)     # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(metrics["skipped"]) == 0


# --- the Trainer and the sharded step (phase 14 of chip_smoke.py) -----------

def test_trainer_resumes_on_the_card(cuda, tmp_path):
    """A reduced stablelm trained 4 steps on the card with checkpoints
    every 2 resumes a Trainer built from another seed: the step, and every
    parameter and moment leaf bit for bit, on the card."""
    from repro_torch.checkpoint.store import _named_leaves
    from repro_torch.configs import (CheckpointConfig, OptimConfig,
                                     RunConfig, RuntimeConfig, ShapeConfig,
                                     get_arch)
    from repro_torch.data.synthetic import LMBatchSpec, lm_batch
    from repro_torch.runtime import Trainer
    from repro_torch.runtime.steps import build_train_step, init_state
    from repro_torch.runtime.trainer import saved_state
    cfg = get_arch("stablelm-1.6b").reduced()
    opt = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                    optim=opt,
                    checkpoint=CheckpointConfig(directory=str(tmp_path),
                                                every_steps=2),
                    runtime=RuntimeConfig(log_every=0))
    spec = LMBatchSpec(4, 32, cfg.vocab_size)
    step = build_train_step(cfg, opt)

    def trainer(seed):
        return Trainer(run, step, lambda s: lm_batch(spec, 0, s,
                                                     device=cuda),
                       init_state(cfg, opt, torch.Generator(
                           device=cuda).manual_seed(seed)),
                       install_sigterm=False, log_fn=lambda s: None)
    tr = trainer(0)
    tr.run(4)
    tr2 = trainer(1)
    assert tr2.maybe_resume() and tr2.step == 4
    a = dict(_named_leaves(saved_state(tr.state)))
    b = dict(_named_leaves(saved_state(tr2.state)))
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].device.type == "cuda", k
        assert torch.equal(a[k], b[k]), k


def test_two_ranks_sharded_train_step_on_one_card(cuda, tmp_path):
    """Two gloo ranks share cuda:0: one expert-parallel step of reduced
    olmoe on (1, 2) ("data", "model"), its loss within 1e-5 relative of
    the single-card step's, the same on both ranks, on the card."""
    import torch_world as tw
    import torch_train_world as ttw
    np.savez(tmp_path / "in.npz", none=np.zeros(1))
    ranks = tw.run_port(ttw.gpu_sharded_case, str(tmp_path),
                        str(tmp_path / "in.npz"), world=2)
    for got in ranks:
        assert float(got["loss"]) == float(ranks[0]["loss"])
        assert abs(float(got["loss"]) - float(got["single"])) \
            <= 1e-5 * abs(float(got["single"]))
        assert int(got["skipped"]) == 0
        assert str(got["device"]).startswith("cuda")
