"""The port's kernels (repro_torch.kernels) against the reference's
Pallas kernels (repro.kernels, interpret mode on the CPU).

On CPU tensors the port's wrappers take their plain-torch versions, so
these tests hold the port's arithmetic — the GK-step stages and their
half-step composition (stage 1, passes−1 × proj_qtv, proj_norm), the
fused matvecs and the sparse-sign sketch apply — against the
reference's.  Inputs are made with numpy from a seed (the sketch packs
with the reference's own ``make_sketch``) and handed to both.  The CUDA
kernels themselves are checked on the card by ``tests/test_torch_gpu.py``.

Tolerances are those of tests/test_kernels.py:151-187: rtol 1e-5 with
atol 1e-5·max|ref| in f32 (only the summation order differs), 3e-2 where
A or the basis is stored bf16; the sketch apply is held at the 2e-5 of
tests/test_kernels.py:271-300, the sparse matvec and the low-rank
materialization at the 2e-4 / 3e-2 of tests/test_kernels.py:60-245.  The
ELL pack is held bit for bit.  The reorthogonalization pair is held at
rtol 1e-5 (summation order only; a bf16 basis is rounded once and handed
to both) and ``ops.reorth`` also at the 1e-4 of tests/test_kernels.py:48-60;
the scatter-add at the 2e-6 of tests/test_kernels.py:304-321 against the
reference's kernel and oracle, and bit for bit against ``np.add.at`` (the
port adds in entry order), on dyadic duplicates, empty and padding streams
and dropped coordinates.  The plain model of the card's binning
(``ref.bin_entries``) is held bit for bit against numpy's stable argsort
by bin, and binning by bin and then by part inside each bin against
binning by part at once.
"""
import ctypes
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketch import make_sketch as ref_make_sketch
from repro.kernels import gk_step as jgs
from repro.kernels import reorth as jro
from repro.kernels import sparse_matvec as jspm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core.operators import SparseOp
from repro_torch.kernels import _build
from repro_torch.kernels import count_sketch as cs
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import lowrank_update as klu
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import reorth as rk
from repro_torch.kernels import sketch_matvec as skm
from repro_torch.kernels import sparse_matvec as spm

KERNEL_MODULES = {"gk_step": gs, "sketch_matvec": skm, "sparse_matvec": spm,
                  "lowrank_update": klu, "reorth": rk, "count_sketch": cs}

# GK_STEP_SHAPES of tests/test_kernels.py:136, those within 300 × 520
# (Pallas interpret mode is slow on the CPU).
SHAPES = [(64, 48, 4), (300, 517, 17), (257, 129, 31), (127, 383, 9),
          (300, 200, 5)]
PASSES = [0, 1, 2, 3]


def _inputs(m, n, k, seed, left=True):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    x = rng.standard_normal(n if left else m).astype(np.float32)
    y = rng.standard_normal(m if left else n).astype(np.float32)
    Q = np.linalg.qr(rng.standard_normal((m if left else n, k)))[0]
    return A, x, y, Q.astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("passes", PASSES)
def test_gk_step_fused_matches_reference(m, n, k, passes):
    A, p, y, Q = _inputs(m, n, k, m * n + k)
    want_u, want_b = jops.gk_step_fused(A, p, y, 0.37, Q, passes)
    got_u, got_b = ops.gk_step_fused(_t(A), _t(p), _t(y), 0.37, _t(Q),
                                     passes)
    _close(got_u, want_u)
    _close(got_b, want_b)


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("passes", PASSES)
def test_gk_rstep_fused_matches_reference(m, n, k, passes):
    A, q, y, P = _inputs(m, n, k, m + 3 * n + k, left=False)
    want_v, want_a = jops.gk_rstep_fused(A, q, y, 1.7, P, passes)
    got_v, got_a = ops.gk_rstep_fused(_t(A), _t(q), _t(y), 1.7, _t(P),
                                      passes)
    _close(got_v, want_v)
    _close(got_a, want_a)


@pytest.mark.parametrize("direction", ["left", "right"])
def test_fused_step_bf16_storage(direction):
    """bf16 A and basis, f32 accumulation: the port's bf16 step tracks the
    reference's bf16 step and the f32 oracle to bf16 input rounding."""
    m, n, k = 300, 517, 17
    left = direction == "left"
    A, x, y, Q = _inputs(m, n, k, m ^ n, left=left)
    jfn = jops.gk_step_fused if left else jops.gk_rstep_fused
    tfn = ops.gk_step_fused if left else ops.gk_rstep_fused
    want_u, want_b = jfn(jnp.asarray(A, jnp.bfloat16), x, y, 0.37,
                         jnp.asarray(Q, jnp.bfloat16), 2)
    got_u, got_b = tfn(_t(A, torch.bfloat16), _t(x), _t(y), 0.37,
                       _t(Q, torch.bfloat16), 2)
    _close(got_u, want_u, rtol=3e-2)
    _close(got_b, want_b, rtol=3e-2)
    oracle = jref.gk_step if left else jref.gk_rstep
    f32_u, f32_b = oracle(A, x, y, 0.37, Q, 2)
    _close(got_u, f32_u, rtol=3e-2)
    _close(got_b, f32_b, rtol=3e-2)


@pytest.mark.parametrize("m,n,k", [(64, 48, 4), (257, 129, 31)])
def test_stage_one_matches_reference(m, n, k):
    """mv_qtv / rmv_qtv against the reference's stage-1 kernels."""
    A, p, y, Q = _inputs(m, n, k, 7 * m + n)
    want_u, want_c = jops.local_mv_qtv(A, p[:, None], y[:, None], 0.37, Q)
    got_u, got_c = gs.mv_qtv(_t(A), _t(p), _t(y), 0.37, _t(Q))
    _close(got_u, want_u[:, 0])
    _close(got_c, want_c[:, 0])
    _, q, yn, P = _inputs(m, n, k, 11 * m + n, left=False)
    want_v, want_c = jops.local_rmv_qtv(A, q[:, None], yn[:, None], 1.7, P)
    got_v, got_c = gs.rmv_qtv(_t(A), _t(q), _t(yn), 1.7, _t(P))
    _close(got_v, want_v[:, 0])
    _close(got_c, want_c[:, 0])


@pytest.mark.parametrize("L,k,qdt", [
    pytest.param(48, 4, "f32", id="48-4"),
    pytest.param(300, 17, "f32", id="300-17"),
    pytest.param(129, 31, "f32", id="129-31"),
    pytest.param(257, 201, "f32", id="257-201"),      # odd k: rows unaligned
    pytest.param(257, 201, "bf16", id="257-201-bf16"),
    pytest.param(300, 17, "bf16", id="300-17-bf16")])
def test_projection_stages_match_reference(L, k, qdt):
    """proj_qtv / proj_norm against the reference's stage-2/3 kernels.  A
    bf16 basis is rounded once and handed to both (both widen it to f32),
    so it is held at the f32 bound."""
    rng = np.random.default_rng(L * k)
    u = rng.standard_normal(L).astype(np.float32)
    Q = np.linalg.qr(rng.standard_normal((L, k)))[0].astype(np.float32)
    c = rng.standard_normal(k).astype(np.float32)
    tQ = _t(Q, torch.bfloat16 if qdt == "bf16" else torch.float32)
    jQ = tQ.float().numpy()
    jQ = jnp.asarray(jQ, jnp.bfloat16) if qdt == "bf16" else jQ
    want_w, want_c = jgs.proj_qtv(u[:, None], jQ, c[:, None], bm=L)
    got_w, got_c = gs.proj_qtv(_t(u), tQ, _t(c))
    _close(got_w, want_w[:, 0])
    _close(got_c, want_c[:, 0])
    want_v, want_n = jgs.proj_norm(u[:, None], jQ, c[:, None], bm=L)
    got_v, got_n = gs.proj_norm(_t(u), tQ, _t(c))
    _close(got_v, want_v[:, 0])
    _close(got_n, want_n[0, 0])
    assert got_n.shape == ()


def test_plain_versions_match_reference_oracles():
    A, p, y, Q = _inputs(40, 30, 6, 3)
    cases = [
        (ref.matvec_fused(_t(A), _t(p), _t(y), 0.5),
         jref.matvec_fused(A, p, y, 0.5)),
        (ref.rmatvec_fused(_t(A), _t(y), _t(p), 0.5),
         jref.rmatvec_fused(A, y, p, 0.5)),
        (ref.qtv(_t(Q), _t(y)), jref.qtv(Q, y)),
        (ref.reorth(_t(y), _t(Q), 2), jref.reorth(y, Q, 2)),
    ]
    for got, want in cases:
        _close(got, want)


def test_cpu_path_counts_no_launches():
    gs.reset_launches()
    A, p, y, Q = _inputs(64, 48, 4, 0)
    ops.gk_step_fused(_t(A), _t(p), _t(y), 0.37, _t(Q), 2)
    ops.gk_rstep_fused(_t(A), _t(y), _t(p), 0.37, _t(_inputs(
        64, 48, 4, 1, left=False)[3]), 2)
    assert gs.LAUNCHES == {"mv_qtv": 0, "rmv_qtv": 0, "proj_qtv": 0,
                           "proj_norm": 0, "matvec_fused": 0,
                           "rmatvec_fused": 0}


def test_wrappers_reject_what_the_kernel_does_not_take():
    A, p, y, Q = (_t(x) for x in _inputs(32, 24, 3, 5))
    with pytest.raises(TypeError):
        gs.mv_qtv(A.double(), p, y, 0.1, Q)
    with pytest.raises(TypeError):
        gs.mv_qtv(A, p.double(), y, 0.1, Q)
    with pytest.raises(ValueError):
        gs.mv_qtv(A, p[:-1], y, 0.1, Q)
    with pytest.raises(ValueError):
        gs.mv_qtv(A, p, y, 0.1, Q[:-1])
    with pytest.raises(ValueError):
        gs.rmv_qtv(A, y, p, 0.1, Q)          # P must have n rows
    with pytest.raises(ValueError):
        gs.proj_qtv(y, Q, torch.zeros(4))
    with pytest.raises(ValueError):
        gs.proj_norm(y[:, None], Q, torch.zeros(3))
    meta = torch.empty(32, 24, device="meta")
    with pytest.raises(ValueError):
        gs.mv_qtv(meta, p, y, 0.1, Q)        # mixed devices


def _stack(m, n, k, B, seed, qdt=torch.float32):
    """Stacked inputs of both half-steps: A (B, m, n), the vectors (B, ·),
    the scalars (B,), bases (B, m, k) / (B, n, k) of ``qdt``."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, m, n, generator=g)
    vecs = [torch.randn(B, L, generator=g) for L in (n, m, m, n)]
    al = torch.randn(B, generator=g)
    Q = torch.randn(B, m, k, generator=g).to(qdt)
    P = torch.randn(B, n, k, generator=g).to(qdt)
    c = torch.randn(B, k, generator=g)
    return A, vecs, al, Q, P, c


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("m,n,k", [(64, 48, 4), (257, 129, 31)])
def test_stacked_stages_are_each_examples_single_call(m, n, k, B, qdt):
    """Each of the four stages takes stacked inputs (the batched solve's
    half-steps): example b of the stacked call is bit for bit the
    unstacked call on example b (its plain version here; on the card a
    single launch, tests/test_torch_gpu.py); the last example, the one at
    the largest offsets, matches the reference's stage-1 and projection
    kernels."""
    A, (p, q, ym, yn), al, Q, P, c = _stack(m, n, k, B, m + n + k + B, qdt)
    gs.reset_launches()
    stacked = {"mv_qtv": gs.mv_qtv(A, p, ym, al, Q),
               "rmv_qtv": gs.rmv_qtv(A, q, yn, al, P),
               "proj_qtv": gs.proj_qtv(ym, Q, c),
               "proj_norm": gs.proj_norm(ym, Q, c)}
    assert stacked["proj_norm"][1].shape == (B,)
    assert stacked["mv_qtv"][0].shape == (B, m)
    assert stacked["rmv_qtv"][1].shape == (B, k)
    for b in range(B):
        single = {"mv_qtv": gs.mv_qtv(A[b], p[b], ym[b], al[b], Q[b]),
                  "rmv_qtv": gs.rmv_qtv(A[b], q[b], yn[b], al[b], P[b]),
                  "proj_qtv": gs.proj_qtv(ym[b], Q[b], c[b]),
                  "proj_norm": gs.proj_norm(ym[b], Q[b], c[b])}
        for name, outs in single.items():
            for got, want in zip(stacked[name], outs):
                assert torch.equal(got[b], want), name
    b = B - 1
    jQ = jnp.asarray(Q[b].float().numpy(), jnp.bfloat16) \
        if qdt == torch.bfloat16 else Q[b].numpy()
    rtol = 3e-2 if qdt == torch.bfloat16 else 1e-5
    u, cu = jops.local_mv_qtv(A[b].numpy(), p[b].numpy()[:, None],
                              ym[b].numpy()[:, None], float(al[b]), jQ)
    _close(stacked["mv_qtv"][0][b], u[:, 0], rtol)
    _close(stacked["mv_qtv"][1][b], cu[:, 0], rtol)
    w, nrm = jgs.proj_norm(ym[b].numpy()[:, None], jQ,
                           c[b].numpy()[:, None], bm=m)
    _close(stacked["proj_norm"][0][b], w[:, 0], rtol)
    _close(stacked["proj_norm"][1][b], nrm[0, 0], rtol)
    assert gs.LAUNCHES == dict.fromkeys(gs.LAUNCHES, 0)


def test_stacked_half_steps_are_each_examples_half_step():
    """ops.gk_step_fused / gk_rstep_fused on stacked inputs: (B, ·)
    vectors and (B,) norms, each example the unstacked half-step's."""
    A, (p, q, ym, yn), al, Q, P, c = _stack(60, 40, 5, 3, 9)
    for passes in PASSES:
        u, nu = ops.gk_step_fused(A, p, ym, al, Q, passes)
        v, nv = ops.gk_rstep_fused(A, q, yn, al, P, passes)
        assert u.shape == (3, 60) and nu.shape == nv.shape == (3,)
        for b in range(3):
            for got, want in zip((u[b], nu[b], v[b], nv[b]),
                                 ops.gk_step_fused(A[b], p[b], ym[b], al[b],
                                                   Q[b], passes)
                                 + ops.gk_rstep_fused(A[b], q[b], yn[b],
                                                      al[b], P[b], passes)):
                assert torch.equal(got, want)


def test_stacked_wrappers_reject_what_the_kernel_does_not_take():
    A, (p, q, ym, yn), al, Q, P, c = _stack(32, 24, 3, 2, 5)
    with pytest.raises(ValueError, match="stack of 2 vectors"):
        gs.mv_qtv(A, p[0], ym, al, Q)             # an unstacked vector
    with pytest.raises(ValueError, match="stack of 2 2-D"):
        gs.mv_qtv(A, p, ym, al, Q[0])             # an unstacked basis
    with pytest.raises(ValueError):
        gs.mv_qtv(A, p[:1], ym, al, Q)            # batch sizes disagree
    with pytest.raises(ValueError):
        gs.rmv_qtv(A, q, yn, al, Q)               # P must have n rows
    with pytest.raises(ValueError):
        gs.proj_norm(ym, Q, c[:, :2])
    with pytest.raises(ValueError, match="examples"):
        gs.mv_qtv(torch.empty(0, 32, 24), p[:0], ym[:0], al[:0], Q[:0])
    meta = torch.empty(2, 32, 24, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        gs.mv_qtv(meta, p, ym, al, Q)
    # the card's scalar check: one f32 scalar per example on the device
    with pytest.raises(ValueError, match="2-element float32"):
        gs._scalar(al[:1], al.device, 2)
    assert torch.equal(gs._scalar(0.5, al.device, 2), torch.full((2,), 0.5))


@pytest.mark.parametrize("L", [1, 7, 8, 9, 2047, 2048 * 8 + 1, 100_000,
                               80_000])
def test_rows_plan_covers_every_row_once(L):
    per, grid = gs.rows_plan(L)
    assert per % gs.GROUP == 0
    assert grid <= gs.MAX_BLOCKS
    assert (grid - 1) * per < L <= grid * per


@pytest.mark.parametrize("m", [1, 7, 8, 2047, 20_000, 100_000])
def test_matvec_plan_covers_every_row_once(m):
    """matvec_fused's persistent grid: warp w of W takes rows w, w + W, ...
    so every row is one warp's; no block is without a row, and the grid
    is the card's resident blocks when the rows fill them.  The plan is a
    function of m alone (n and A's dtype do not move it)."""
    grid = gs.matvec_plan(m)
    assert 1 <= grid <= gs.SMS * gs.MV_BLOCKS_PER_SM
    assert (grid - 1) * gs.GROUP < m
    warps = grid * gs.GROUP
    rows = np.concatenate([np.arange(w, m, warps) for w in range(warps)])
    np.testing.assert_array_equal(np.sort(rows), np.arange(m))
    if m >= gs.SMS * gs.MV_BLOCKS_PER_SM * gs.GROUP:
        assert grid == gs.SMS * gs.MV_BLOCKS_PER_SM
    assert list(inspect.signature(gs.matvec_plan).parameters) == ["m"]


PLAN_LS = [1, 7, 8, 2047, 80_000, 100_000, 480_189]
PLAN_KS = [1, 4, 200, 201, gs.MAX_K]
PLAN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dt", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("k", PLAN_KS)
@pytest.mark.parametrize("L", PLAN_LS)
def test_proj_plan_covers_every_row_once(L, k, dt):
    """The projection pair's tiles cover rows [0, L) once, and the blocks'
    strided walks (b, b + grid, ...) take every tile once."""
    plan = gs.proj_plan(L, k, PLAN_DTYPES[dt])
    T = plan.tile_rows
    assert 1 <= T <= gs.MAX_TILE_ROWS
    assert T < gs.GROUP or T % gs.GROUP == 0
    assert (plan.tiles - 1) * T < L <= plan.tiles * T
    assert 1 <= plan.grid <= min(plan.tiles, gs.PROJ_BLOCKS)
    walks = np.concatenate([np.arange(b, plan.tiles, plan.grid)
                            for b in range(plan.grid)])
    np.testing.assert_array_equal(np.sort(walks), np.arange(plan.tiles))
    if L >= gs.PROJ_BLOCKS * T:
        assert plan.grid == gs.PROJ_BLOCKS


def _round16(x):
    return -(-x // 16) * 16


@pytest.mark.parametrize("dt", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("k", PLAN_KS + [0, 1000, 12_000, 20_000])
def test_proj_plan_fits_shared_memory(k, dt):
    """The staged tiles, with c where the plan puts it, fit the 227 KB a
    block can have; up to STAGES buffers, then (past REG_K columns, below
    which c and c' sit in registers) c is taken whenever it fits.  The
    stages also hold the register path's 8 warps' column sums."""
    dtype = PLAN_DTYPES[dt]
    plan = gs.proj_plan(100_000, k, dtype)
    e = dtype.itemsize
    T = plan.tile_rows
    stage = _round16(4 * T) + _round16(T * k * e) + 32
    assert T * k * e <= max(gs.STAGE_BYTES[dtype], k * e)  # one row at least
    vec = _round16(4 * k)
    c_shared = bool(plan.flags & gs.C_SHARED)
    want = stage * plan.stages + vec * c_shared
    assert plan.smem == want <= gs.SMEM_LIMIT < 227 * 1024
    assert plan.stages == max(1, min(gs.STAGES, gs.SMEM_LIMIT // stage))
    assert c_shared == (k > gs.REG_K
                        and stage * plan.stages + vec <= gs.SMEM_LIMIT)
    if k <= gs.REG_K:                  # c and c' in registers
        assert plan.flags == 0
    if k <= 1000:
        assert plan.stages == gs.STAGES
    if gs.REG_K < k <= 1000:
        assert plan.flags == gs.C_SHARED
    if k <= gs.REG_K:
        assert stage * plan.stages >= 4 * gs.GROUP * k
    if k == gs.MAX_K and dtype == torch.float32:
        assert (plan.stages, plan.flags, T) == (1, 0, 1)  # a 196,608-byte row


def test_proj_plan_depends_only_on_its_arguments():
    """Same (L, k, dtype), same plan, whatever else the process does: the
    cross-block order of the sums, and σ's bits, follow from the plan."""
    cases = [(L, k, d) for L in PLAN_LS for k in PLAN_KS
             for d in PLAN_DTYPES.values()]
    first = [gs.proj_plan(*case) for case in cases]
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        again = [gs.proj_plan(*case) for case in reversed(cases)]
    finally:
        torch.set_num_threads(threads)
    assert first == again[::-1]
    params = list(inspect.signature(gs.proj_plan).parameters)
    assert params == ["L", "k", "dtype"]


def _finish_tree(part):
    """finish_kernel in float32: thread t of 256 adds slots t, t + 256,
    ... from 0, then the shared halving tree 128, 64, ..., 1."""
    G = part.shape[0]
    s = np.zeros((256,) + part.shape[1:], np.float32)
    for t in range(256):
        for b in range(t, G, 256):
            s[t] = s[t] + part[b]
    w = 128
    while w > 0:
        s[:w] = s[:w] + s[w:2 * w]
        w //= 2
    return s[0]


def _finish_warp(part):
    """``finish_warps_kernel`` in float32, pass for pass: lane l's register
    i starts as +0 + (slot l + 32 i, or +0 past G); where G > 256 a second
    pass adds slot l + 32 i + 256 (or +0); then the levels 128, 64 and 32
    add registers i and i + h, and 16 to 1 take lane l + o's value
    (``__shfl_down_sync``).  Like the kernel it takes no G past
    ``PROJ_BLOCKS``."""
    G = part.shape[0]
    assert 1 <= G <= gs.PROJ_BLOCKS <= 2 * gs.THREADS
    zero = np.zeros(part.shape[1:], np.float32)
    v = np.zeros((32, 8) + part.shape[1:], np.float32)
    for lane in range(32):
        for i in range(8):
            t = lane + 32 * i
            v[lane, i] = zero + (part[t] if t < G else zero)
            if G > gs.THREADS:
                t += gs.THREADS
                v[lane, i] = v[lane, i] + (part[t] if t < G else zero)
    h = 4
    while h > 0:
        for i in range(h):
            v[:, i] = v[:, i] + v[:, i + h]
        h //= 2
    x = v[:, 0]
    for o in (16, 8, 4, 2, 1):
        down = np.concatenate([x[o:], x[:o]])   # lanes past 31 unused
        x = x + down
    return x[0]


@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 200), (201, 256),
                                   (257, gs.PROJ_BLOCKS)])
def test_warp_finish_keeps_the_tree_bit_for_bit(lo, hi):
    """For every grid G a projection plan can take (1 to ``PROJ_BLOCKS``:
    one pass up to 256 partials, two past it), the warp finish adds each
    output's partials as finish_kernel's shared tree does: the float32
    results are equal bit for bit, on data spread over many binades with
    zeros of both signs mixed in."""
    rng = np.random.default_rng(lo)
    for G in range(lo, hi + 1):
        part = (rng.standard_normal((G, 24))
                * 10.0 ** rng.integers(-6, 7, (G, 24))).astype(np.float32)
        part[rng.random((G, 24)) < 0.05] = -0.0
        part[:, 0] = -0.0                       # an output of -0 partials
        got, want = _finish_warp(part), _finish_tree(part)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), G


def _fmaf(a, b, c):
    """float32 fmaf for the model: a·b is exact in float64, and a product
    below float32's least subnormal rounds to a zero of its sign, as the
    fused operation's one rounding gives it where c is ±0."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 96, 100, 101, 127, 128])
def test_narrow_register_slots_keep_the_lane_sums_bit_for_bit(k):
    """The register path takes 4 slots a lane up to 128 columns where it
    holds 8: the 8-slot chain's slots 4-7 hold +0 in the row and in c, so
    each adds fmaf(+0, +0, dot) = dot + (+0), and the 4-slot chain ends
    with one such add.  A float32 model of a lane's chain, on rows and c
    with zeros of both signs and on rows whose every product lies below
    the least subnormal (each rounds to -0, so the 4 slots leave a -0
    that the add turns into +0), gives the same bits either way.  Below
    97 columns every lane's 4 slots already hold one past k, which adds
    the same +0, so only a wider basis leaves a -0 for the add."""
    rng = np.random.default_rng(k)
    negative_zero_dots = 0
    for trial in range(200):
        q = (rng.standard_normal(256) * 10.0 ** rng.integers(-4, 5, 256)
             ).astype(np.float32)
        c = rng.standard_normal(256).astype(np.float32)
        if trial % 4 == 3:                 # every product underflows
            q = np.abs(q) * np.float32(1e-30)
            c = -np.abs(c) * np.float32(1e-20)
        q[rng.random(256) < 0.3] = -0.0
        q[rng.random(256) < 0.2] = 0.0
        c[rng.random(256) < 0.3] = -0.0
        q[k:], c[k:] = 0.0, 0.0            # what the kernel loads past k
        for lane in range(32):
            dots = []
            for slots in (4, 8):
                dot = np.float32(0.0)
                for t in range(slots):
                    dot = _fmaf(q[lane + 32 * t], c[lane + 32 * t], dot)
                if slots == 4:
                    negative_zero_dots += bool(dot == 0 and np.signbit(dot))
                    dot = dot + np.float32(0.0)     # __fadd_rn(dot, 0.f)
                dots.append(dot)
            assert dots[0].view(np.uint32) == dots[1].view(np.uint32), lane
    assert (negative_zero_dots > 0) == (k > 96)


# (m, n) of the Aᵀq plan: the shapes the previous chunk plan was held at,
# those of qtv's previous plan, the main and f64 operands, the sparse
# cell's Lanczos basis, a wide single row and a tall narrow operand
RMV_PLAN_SHAPES = [(1, 1), (64, 48), (2000, 100_000), (100_000, 2000),
                   (100_000, 80_000), (10**7, 3), (300, 17), (480_189, 201),
                   (100, 5000), (20_000, 16_000), (1, 10**7), (10**6, 3)]
RMV_DTYPES = {"f64": torch.float64, "f32": torch.float32,
              "bf16": torch.bfloat16}


def _rmv_blocks(m, plan):
    """(block, tile, first row, end row) of each block of
    rmv_partial_kernel: block b takes tile b % tiles over chunk
    b // tiles."""
    return [(b, b % plan.tiles, (b // plan.tiles) * plan.rows,
             min((b // plan.tiles + 1) * plan.rows, m))
            for b in range(plan.tiles * plan.chunks)]


@pytest.mark.parametrize("dt", sorted(RMV_DTYPES))
@pytest.mark.parametrize("m,n", RMV_PLAN_SHAPES)
def test_chunk_plan_covers_every_row_once(m, n, dt):
    """The Aᵀq plan (rmv_plan): row groups as narrow as n allows, the
    tiles cover the n columns once, the chunks cover the m rows once with
    no empty chunk, and the grid is one wave within the cap gk_step.cu
    refuses past (a block per tile where the tiles alone pass it), filled
    as far as the chunks allow."""
    plan = gs.rmv_plan(m, n, RMV_DTYPES[dt])
    V = 16 // RMV_DTYPES[dt].itemsize
    # row groups as narrow as n allows (a power of two): a tile holds n,
    # or the block is one group of THREADS threads
    assert plan.cols in [1 << i for i in range(9)] and gs.THREADS == 256
    assert plan.cols == gs.THREADS or plan.cols * V >= n
    assert plan.cols == 1 or plan.cols * V < 2 * n
    tc = plan.tile_cols
    assert tc == plan.cols * V
    assert (plan.tiles - 1) * tc < n <= plan.tiles * tc
    assert 1 <= plan.chunks <= m
    assert (plan.chunks - 1) * plan.rows < m <= plan.chunks * plan.rows
    cap = gs.SMS * gs.RMV_BLOCKS_PER_SM
    assert plan.tiles * plan.chunks <= cap or plan.chunks == 1
    assert 2 * plan.chunks >= min(m, max(1, cap // plan.tiles))
    blocks = _rmv_blocks(m, plan)
    assert all(i0 < i1 for _, _, i0, i1 in blocks)       # no idle block
    for t in range(plan.tiles):
        spans = sorted((i0, i1) for _, tt, i0, i1 in blocks if tt == t)
        assert [i0 for i0, _ in spans] == [0] + [i1 for _, i1 in spans[:-1]]
        assert spans[-1][1] == m


@pytest.mark.parametrize("m,n", [(50, 3000), (7, 5000), (3000, 3),
                                 (1, 2049), (700, 1025)])
def test_rmv_plan_partials_sum_to_the_product(m, n):
    """A numpy model of the card's Aᵀq: each block's partial into slot b,
    then each column's chunks added from vpart[k · width + j] (width =
    tiles × tile_cols), gives Aᵀq."""
    rng = np.random.default_rng(m * n)
    A, q = rng.standard_normal((m, n)), rng.standard_normal(m)
    plan = gs.rmv_plan(m, n, torch.float32)
    tc, width = plan.tile_cols, plan.tiles * plan.tile_cols
    vpart = np.full(plan.chunks * width, np.nan)
    for b, t, i0, i1 in _rmv_blocks(m, plan):
        cols = A[i0:i1, t * tc:(t + 1) * tc]
        vpart[b * tc:b * tc + cols.shape[1]] = cols.T @ q[i0:i1]
    v = np.array([sum(vpart[k * width + j] for k in range(plan.chunks))
                  for j in range(n)])
    np.testing.assert_allclose(v, A.T @ q, rtol=1e-12, atol=1e-12)


def test_rmv_plan_depends_only_on_its_arguments():
    """Same (m, n, dtype), same plan, whatever else the process does: the
    order of every sum of Aᵀq, and σ's bits, follow from the plan."""
    cases = [(m, n, d) for m, n in RMV_PLAN_SHAPES
             for d in RMV_DTYPES.values()]
    first = [gs.rmv_plan(*case) for case in cases]
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        again = [gs.rmv_plan(*case) for case in reversed(cases)]
    finally:
        torch.set_num_threads(threads)
    assert first == again[::-1]
    params = list(inspect.signature(gs.rmv_plan).parameters)
    assert params == ["m", "n", "dtype"]


@pytest.mark.parametrize("B", [1, 2, 3, 8])
def test_stacked_rmv_grid_covers_every_slot_once(B):
    """A numpy model of the stacked Aᵀq launches for every plan of
    RMV_PLAN_SHAPES: block (x, y) of the partial kernel's (slots, B) grid
    takes slot x of example y, the rows and tile block x of a single
    launch on that example takes; the B × slots blocks fill the wrapper's
    vpart (B · tiles · chunks · tile_cols floats) once, slot by slot in
    (example, chunk, tile) order; and the finish reads example y's
    chunks from the place the partial wrote them, so example y sums what
    a single launch on it sums."""
    for m, n in RMV_PLAN_SHAPES:
        for dt in RMV_DTYPES.values():
            plan = gs.rmv_plan(m, n, dt)
            slots, tc = plan.tiles * plan.chunks, plan.tile_cols
            width = plan.tiles * tc
            single = _rmv_blocks(m, plan)
            x, y = np.meshgrid(np.arange(slots), np.arange(B))
            start = (y * slots + x) * tc          # the partial's writes
            assert np.array_equal(np.sort(start.ravel()),
                                  np.arange(B * slots) * tc)
            assert B * slots * tc == B * plan.tiles * plan.chunks * tc
            # the finish's base for example y is the partial's
            assert plan.chunks * width == slots * tc
            c, t = np.divmod(np.arange(slots), plan.tiles)
            assert [(b, tt, i0) for b, tt, i0, _ in single] == \
                list(zip(range(slots), t, c * plan.rows))


def _finish_before(vpart, chunks):
    """The finish's order in float32, a thread a residue: ``ways``
    residues (the power of two at or past the chunks, at most 256),
    residue r adding chunks r, r + ways, ... from 0, then the halving tree
    over the residues."""
    ways = 1
    while ways < 256 and ways < chunks:
        ways *= 2
    s = np.zeros((ways,) + vpart.shape[1:], np.float32)
    for r in range(ways):
        for k in range(r, chunks, ways):
            s[r] = s[r] + vpart[k]
    h = ways // 2
    while h > 0:
        s[:h] = s[:h] + s[h:2 * h]
        h //= 2
    return s[0]


def _finish_lanes(vpart, chunks):
    """The coalesced finish in float32: a column's residues over sub =
    min(ways, 8) warps, warp rc holding residues rc + sub·i (i < L =
    ways / sub) in registers, its rounds k0 = 0, ways, ... adding chunk
    k0 + rc + sub·i to s[i]; the in-warp halving tree, then the one
    across warps in shared memory."""
    ways = 1
    while ways < 256 and ways < chunks:
        ways *= 2
    sub = min(ways, 8)
    L = ways // sub
    part = []
    for rc in range(sub):
        s = [np.zeros(vpart.shape[1:], np.float32) for _ in range(L)]
        for k0 in range(0, chunks, ways):
            for i in range(L):
                k = k0 + rc + sub * i
                if k < chunks:
                    s[i] = s[i] + vpart[k]
        e = L // 2
        while e > 0:
            for i in range(e):
                s[i] = s[i] + s[i + e]
            e //= 2
        part.append(s[0])
    h = sub // 2
    while h > 0:
        for rc in range(h):
            part[rc] = part[rc] + part[rc + h]
        h //= 2
    return part[0]


@pytest.mark.parametrize("ways", [1, 2, 4, 8, 16, 32, 64, 128, 256])
def test_rmv_finish_lanes_keep_the_tree_bit_for_bit(ways):
    """For every chunk count from 1 to 600 (grouped by the ``ways`` it
    gives), the coalesced finish's mapping adds each column's chunks in
    the old finish's order: the float32 results are equal bit for bit,
    on data spread over many binades with signed zeros mixed in."""
    lo = ways // 2 + 1 if ways > 1 else 1
    hi = ways if ways < 256 else 600
    rng = np.random.default_rng(ways)
    for chunks in range(lo, hi + 1):
        vpart = (rng.standard_normal((chunks, 48))
                 * 10.0 ** rng.integers(-6, 7, (chunks, 48))
                 ).astype(np.float32)
        vpart[rng.random((chunks, 48)) < 0.05] = -0.0
        got, want = _finish_lanes(vpart, chunks), _finish_before(vpart,
                                                                 chunks)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
            chunks


def test_build_targets_sm90a_with_a_plain_c_interface():
    assert _build.ARCH_FLAGS == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert {"-O3", "-shared", "-fPIC"} <= set(_build.NVCC_FLAGS)
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(KERNEL_MODULES)
    for name, module in KERNEL_MODULES.items():
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
        # the ctypes signatures agree with the C prototypes in the source
        src = _build.source(name).read_text()
        protos = dict(re.findall(r"^(?:int|const char\*) (\w+)\(([^)]*)\)",
                                 src, flags=re.M))
        assert set(protos) == set(module._SIGNATURES), name
        for fn, argtypes in module._SIGNATURES.items():
            params = [a.strip() for a in protos[fn].split(",")]
            assert len(params) == len(argtypes), fn
            for param, t in zip(params, argtypes):
                want = (ctypes.c_void_p if "*" in param else ctypes.c_longlong
                        if param.startswith("long long") else ctypes.c_int)
                assert t is want, (fn, param)


def test_library_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """Every source includes csrc/gk_rows.cuh: an edit of the header must
    change every library's name (no stale build)."""
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in KERNEL_MODULES}
    header = tmp_path / "gk_rows.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path


# --------------------------------------------------------------------------
# fused matvecs (gk_step.matvec_fused / rmatvec_fused): the float64 leg of DenseOp(backend="pallas")
# --------------------------------------------------------------------------

# tests/test_kernels.py:10 SHAPES (m, n) and :82 RAGGED
MATVEC_SHAPES = [(64, 48), (300, 200), (1024, 512), (100, 700), (512, 128),
                 (300, 517), (257, 129), (127, 383)]
A_DTYPES = {"f64": (np.float64, None), "f32": (np.float32, None),
            "bf16": (np.float32, torch.bfloat16)}


def _operand(m, n, dt, seed):
    """(numpy A for the reference, torch A for the port) of one storage
    dtype; bf16 is rounded once and handed to both."""
    np_dt, torch_dt = A_DTYPES[dt]
    A = np.random.default_rng(seed).standard_normal((m, n)).astype(np_dt)
    if torch_dt is None:
        return A, torch.from_numpy(A)
    At = torch.from_numpy(A).to(torch_dt)
    return jnp.asarray(A, jnp.bfloat16), At


@pytest.mark.parametrize("dt", sorted(A_DTYPES))
@pytest.mark.parametrize("m,n", MATVEC_SHAPES)
def test_fused_matvecs_match_reference(m, n, dt):
    """matvec_fused / rmatvec_fused (plain versions on the CPU) against
    the reference's Pallas kernels; f64 A is multiplied in f32 by both."""
    A, At = _operand(m, n, dt, m * n)
    rng = np.random.default_rng(m + n)
    p, q = (rng.standard_normal(k).astype(np.float32) for k in (n, m))
    ym, yn = (rng.standard_normal(k).astype(np.float32) for k in (m, n))
    gs.reset_launches()
    got = ops.matvec_fused(At, _t(p), _t(ym), 0.37)
    assert got.dtype == torch.float32 and got.shape == (m,)
    _close(got, jops.matvec_fused(A, p, ym, 0.37))
    got = ops.rmatvec_fused(At, _t(q), _t(yn), 1.7)
    assert got.dtype == torch.float32 and got.shape == (n,)
    _close(got, jops.rmatvec_fused(A, q, yn, 1.7))
    assert gs.LAUNCHES == dict.fromkeys(gs.LAUNCHES, 0)


def test_fused_matvec_entry_points_cast_vectors_and_scalars():
    """ops.matvec_fused takes vectors and the scalar in any float dtype
    (the f64 GK loop hands it f64 device scalars) and casts to f32, as
    the reference wrapper does."""
    A, At = _operand(40, 30, "f64", 1)
    rng = np.random.default_rng(2)
    p, y = rng.standard_normal(30), rng.standard_normal(40)
    got = ops.matvec_fused(At, torch.from_numpy(p), torch.from_numpy(y),
                           torch.tensor(0.25, dtype=torch.float64))
    _close(got, jref.matvec_fused(A.astype(np.float32), p.astype(np.float32),
                                  y.astype(np.float32), 0.25))
    got = ops.rmatvec_fused(At, torch.from_numpy(y), torch.from_numpy(p),
                            torch.tensor(0.25, dtype=torch.float64))
    _close(got, jref.rmatvec_fused(A.astype(np.float32),
                                   y.astype(np.float32),
                                   p.astype(np.float32), 0.25))


def test_fused_matvec_wrappers_reject_what_the_kernel_does_not_take():
    A = torch.zeros(8, 6)
    p, y = torch.zeros(6), torch.zeros(8)
    with pytest.raises(TypeError, match="float64, float32 or bfloat16"):
        gs.matvec_fused(A.half(), p, y, 0.1)
    with pytest.raises(TypeError):
        gs.matvec_fused(A, p.double(), y, 0.1)
    with pytest.raises(ValueError):
        gs.matvec_fused(A, p[:-1], y, 0.1)
    with pytest.raises(ValueError):
        gs.rmatvec_fused(A, p, y, 0.1)            # q must have m rows
    with pytest.raises(ValueError):
        gs.rmatvec_fused(A[0], y, p, 0.1)
    with pytest.raises(ValueError):
        gs.matvec_fused(torch.empty(8, 6, device="meta"), p, y, 0.1)


# --------------------------------------------------------------------------
# sparse-sign sketch apply (sketch_matvec)
# --------------------------------------------------------------------------

# tests/test_kernels.py:271-300
SKETCH_SHAPES = [(300, 64, 24), (128, 130, 16), (70, 16, 48), (48, 48, 48),
                 (200, 96, 32)]


def _sketch(n, d, seed=0):
    ref_sk = ref_make_sketch(jax.random.PRNGKey(n * d + seed), n, d,
                             kind="sparse_sign", dtype=jnp.float32)
    return ref_sk, bridge.sketch(ref_sk, backend="pallas", device="cpu")


@pytest.mark.parametrize("layout", ["row_major", "transposed_view"])
@pytest.mark.parametrize("n,d,b", SKETCH_SHAPES)
def test_sketch_matmat_matches_reference(n, d, b, layout):
    """The plain sketch_matmat (the wrapper's CPU path) against the
    reference's plain version, its Pallas kernel in interpret mode and
    the dense TᵀX, on a row-major X and on a transposed view of one."""
    ref_sk, sk = _sketch(n, d)
    X = np.random.default_rng(b).standard_normal((n, b)).astype(np.float32)
    Xt = torch.from_numpy(X) if layout == "row_major" else \
        torch.from_numpy(np.ascontiguousarray(X.T)).T
    assert Xt.is_contiguous() == (layout == "row_major")
    skm.reset_launches()
    got = ops.sketch_matmat(sk.signs, sk.idx, Xt)
    assert got.dtype == torch.float32 and got.shape == (d, b)
    assert skm.LAUNCHES["sketch_matmat"] == 0
    for want in (jref.sketch_matmat(ref_sk.signs, ref_sk.idx, X),
                 jops.sketch_matmat(ref_sk.signs, ref_sk.idx, X),
                 np.asarray(ref_sk.dense()).T @ X):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(sk.dense().numpy(), np.asarray(ref_sk.dense()),
                               rtol=1e-6, atol=1e-6)


def test_sketch_matmat_bf16_block():
    """A bf16 block is widened exactly: the same result as its f32 copy."""
    _, sk = _sketch(300, 64)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 24)).astype(np.float32)).to(torch.bfloat16)
    torch.testing.assert_close(ops.sketch_matmat(sk.signs, sk.idx, X),
                               ops.sketch_matmat(sk.signs, sk.idx, X.float()),
                               rtol=1e-6, atol=1e-6)


def test_sketch_matmat_wrapper_rejects_what_the_kernel_does_not_take():
    _, sk = _sketch(48, 16)
    X = torch.zeros(48, 5)
    with pytest.raises(TypeError, match="int32"):
        skm.sketch_matmat(sk.signs, sk.idx.long(), X)
    with pytest.raises(ValueError, match="shape of signs"):
        skm.sketch_matmat(sk.signs, sk.idx[:, :3], X)
    with pytest.raises(TypeError):
        skm.sketch_matmat(sk.signs, sk.idx, X.int())
    with pytest.raises(ValueError, match="different devices"):
        skm.sketch_matmat(sk.signs, sk.idx, torch.zeros(48, 5,
                                                        device="meta"))


def _order_model(idx, chunk_rows):
    """A numpy model of gather_order: each chunk of chunk_rows sketch rows'
    flat slots stably sorted by source row."""
    flat = idx.reshape(-1)
    per = chunk_rows * idx.shape[1]
    slots = np.concatenate([
        q + np.argsort(flat[q:q + per], kind="stable")
        for q in range(0, flat.shape[0], per)])
    return np.stack([flat[slots], slots])


@pytest.mark.parametrize("n,d,zeta", [(300, 64, 8), (128, 130, 8),
                                      (70, 16, 5), (80_000, 128, 8),
                                      (100_000, 256, 8), (7, 3, 7),
                                      (5000, 300, 1000), (40, 200, 1)])
def test_gather_order_is_a_permutation_in_chunks(n, d, zeta):
    """The range kernel's walk of a sketch pack: row 1 is a permutation of
    the flat slots that keeps each chunk of chunk_rows(ζ) sketch rows in
    place, row 0 the source rows of those slots, ascending in each chunk
    and stable; bit for bit a numpy model of it."""
    rng = np.random.default_rng(n + d + zeta)
    idx = rng.integers(0, n, (d, zeta)).astype(np.int32)
    order = skm.gather_order(torch.from_numpy(idx))
    assert order.dtype == torch.int32 and order.shape == (2, d * zeta)
    got = order.numpy()
    assert np.array_equal(np.sort(got[1]), np.arange(d * zeta))
    np.testing.assert_array_equal(got[0], idx.reshape(-1)[got[1]])
    rows = max(skm.chunk_rows(zeta), 1)
    per = rows * zeta
    for q in range(0, d * zeta, per):
        sl = got[:, q:q + per]
        assert np.all((sl[1] >= q) & (sl[1] < q + per))
        assert np.all(np.diff(sl[0]) >= 0)
    np.testing.assert_array_equal(got, _order_model(idx, rows))


def test_sparse_sign_sketch_keeps_its_order():
    """SparseSignSketch makes the range kernel's order once: the same
    tensor on every use, that of gather_order(idx)."""
    _, sk = _sketch(300, 64)
    first = sk.order
    assert sk.order is first
    assert torch.equal(first, skm.gather_order(sk.idx))


@pytest.mark.parametrize("d,zeta,b,want", [
    (128, 8, 100_000, 16),        # the range sketch: 16 rows a block
    (256, 8, 128, 1),             # gnystrom's core: 2 chunks x 128 rows
    (256, 8, 80_000, 16), (1000, 8, 300, 8), (5, 3, 7, 1)])
def test_range_rows_fill_the_card(d, zeta, b, want):
    """A range-kernel block owns RANGE_ROWS rows below X, fewer (a power
    of two) where the grid would not hold two blocks an SM."""
    rows = skm.range_rows(d, zeta, b)
    assert rows == want
    assert rows & (rows - 1) == 0 and 1 <= rows <= skm.RANGE_ROWS
    chunks = -(-d // skm.chunk_rows(zeta))
    if rows < skm.RANGE_ROWS:
        assert chunks * -(-b // (2 * rows)) < 2 * gs.SMS


def test_sketch_matmat_rejects_an_order_that_does_not_fit():
    _, sk = _sketch(48, 16)
    X = torch.zeros(5, 48).T
    for bad in (sk.order[:, 1:], sk.order.long(), sk.order.T.contiguous().T,
                sk.order[:1]):
        with pytest.raises(ValueError, match="gather_order"):
            skm.sketch_matmat(sk.signs, sk.idx, X, bad)
    got = skm.sketch_matmat(sk.signs, sk.idx, X, sk.order)
    assert got.shape == (16, 5)


# --------------------------------------------------------------------------
# ELL pack and sparse matvec (sparse_matvec): the SparseOp(backend="pallas")
# products
# --------------------------------------------------------------------------

# tests/test_kernels.py:214-216
SPARSE_SHAPES = [(300, 517, 0.02), (257, 129, 0.1), (64, 48, 0.3),
                 (128, 1000, 0.005)]


def _coo(m, n, density, seed, dtype=np.float32):
    """COO triplets in a shuffled order, with empty rows and a duplicate
    coordinate, made with numpy and handed to both packages."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < density,
                 rng.standard_normal((m, n)), 0.0).astype(dtype)
    A[:3] = 0                                     # empty rows
    rows, cols = np.nonzero(A)
    data = A[rows, cols]
    idx = np.stack([rows, cols], 1).astype(np.int32)
    if len(data):                                 # a duplicate of entry 0
        idx = np.concatenate([idx, idx[:1]])
        data = np.concatenate([data, data[:1]])
    order = rng.permutation(len(data))
    return data[order], idx[order]


@pytest.mark.parametrize("m,n,density", SPARSE_SHAPES + [(40, 30, 0.0)])
def test_ell_pack_matches_reference_bit_for_bit(m, n, density):
    """The port's torch ell_pack gives the reference's NumPy pack bit for
    bit, both directions: duplicates keep their slots, empty rows and
    padding hold (0, column 0)."""
    data, idx = _coo(m, n, density, m + n)
    for d, ix, shape in ((data, idx, (m, n)),
                         (data, idx[:, ::-1].copy(), (n, m))):
        want_v, want_c = jspm.ell_pack(d, ix, shape)
        got_v, got_c = spm.ell_pack(torch.from_numpy(d), torch.from_numpy(ix),
                                    shape)
        assert got_c.dtype == torch.int32 and got_v.dtype == torch.float32
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("bad", [(0, -1), (0, 40), (-1, 0), (50, 0)])
def test_ell_pack_rejects_indices_outside_the_shape(bad):
    """A COO index outside (m, n) raises before any pack is built: the
    kernel gathers X[cols] unchecked, so ell_pack is where it is caught
    (SparseOp(backend="pallas") and bridge.sparse_operand pack through
    it)."""
    data, idx = _coo(50, 40, 0.2, 2)
    idx[5] = bad
    with pytest.raises(ValueError, match="outside the shape"):
        spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx), (50, 40))
    with pytest.raises(ValueError, match="outside the shape"):
        SparseOp.from_coo(data, idx, (50, 40), backend="pallas",
                          device="cpu")
    with pytest.raises(ValueError, match=r"\(nnz, 2\)"):
        spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx[:, :1]),
                     (50, 40))


def test_ell_pack_keeps_the_value_dtype():
    data, idx = _coo(50, 40, 0.2, 1, np.float64)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (50, 40))
    want_v, want_c = jspm.ell_pack(data.astype(np.float32), idx, (50, 40))
    assert vals.dtype == torch.float64
    np.testing.assert_array_equal(vals.float().numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("m,n,density", SPARSE_SHAPES)
def test_sparse_matvec_matches_reference(m, n, density):
    """The plain sparse_matvec (the wrapper's CPU path) against the
    reference's plain version, its Pallas kernel in interpret mode and
    the dense product, on one vector and on a block."""
    data, idx = _coo(m, n, density, m * n)
    jv, jc = jspm.ell_pack(data, idx, (m, n))
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, n))
    A = np.zeros((m, n), np.float64)
    np.add.at(A, (idx[:, 0], idx[:, 1]), data)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    spm.reset_launches()
    got = ops.sparse_matvec(vals, cols, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m,)
    for want in (jref.sparse_matvec(jv, jc, x), jops.sparse_matvec(jv, jc, x),
                 A @ x):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    X = np.random.default_rng(2).standard_normal((n, 5)).astype(np.float32)
    got = ops.sparse_matvec(vals, cols, torch.from_numpy(X).double())
    assert got.dtype == torch.float32 and got.shape == (m, 5)
    want = np.stack([np.asarray(jops.sparse_matvec(jv, jc, X[:, j]))
                     for j in range(5)], 1)        # the reference's vmap
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert spm.LAUNCHES["sparse_matvec"] == 0


WINDOW_NS = [spm.WINDOW - 1, spm.WINDOW + 1]      # one window, and two


def _long_pack(L, n, seed):
    """An ELL pack with rows of up to L slots over columns [0, n): ragged
    rows, an empty row, duplicate coordinates, columns on both sides of
    each window edge."""
    rng = np.random.default_rng(seed)
    m = 5
    counts = [L, 0, max(L // 2, 1), L, max(L - 3, 1)]
    rows = np.repeat(np.arange(m), counts)
    cols = rng.integers(0, n, rows.shape[0])
    edge = np.array([0, n - 1, min(spm.WINDOW - 1, n - 1),
                     min(spm.WINDOW, n - 1)])
    cols[:min(4, cols.shape[0])] = edge[:min(4, cols.shape[0])]
    cols[-1] = cols[0]                                  # a duplicate
    data = rng.standard_normal(rows.shape[0]).astype(np.float32)
    idx = np.stack([rows, cols], 1).astype(np.int32)
    return data, idx, m


@pytest.mark.parametrize("n", WINDOW_NS)
@pytest.mark.parametrize("L", [1, 1023, 1024, 4802, 20_000])
def test_window_layout_is_a_stable_permutation(L, n):
    """Each row of the layout is its pack row's entries in a stable order
    by sub-window (column // SUB), its padding after them, and the offsets
    tile the row: sub-window s's segment holds exactly the slots of
    columns in sub-window s, so each WINDOW of one vector is one segment
    too, whose edges are the window table."""
    data, idx, m = _long_pack(L, n, L + n)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, n))
    counts = np.bincount(idx[:, 0], minlength=m)
    lay = spm.window_layout(vals, cols, n, torch.from_numpy(counts))
    windows = -(-n // spm.WINDOW)
    subs = -(-n // spm.SUB)
    Lp = cols.shape[1]
    assert lay.vals.shape == lay.cols.shape == (m, Lp)
    assert lay.offsets.shape == (m, subs + 1)
    assert lay.window_offsets.shape == (m, windows + 1)
    assert lay.offsets.dtype == lay.cols.dtype == torch.int32
    assert lay.window_offsets.dtype == torch.int32
    c, v = cols.numpy(), vals.numpy()
    off = lay.offsets.numpy()
    for i in range(m):
        key = np.where(np.arange(Lp) < counts[i], c[i] // spm.SUB, subs)
        order = np.argsort(key, kind="stable")
        np.testing.assert_array_equal(lay.cols[i].numpy(), c[i][order])
        np.testing.assert_array_equal(lay.vals[i].numpy(), v[i][order])
        assert off[i, 0] == 0 and off[i, -1] == counts[i]
        assert np.all(np.diff(off[i]) >= 0)
        for s_ in range(subs):
            seg = lay.cols[i, off[i, s_]:off[i, s_ + 1]].numpy()
            assert np.all(seg // spm.SUB == s_)
        for w in range(windows):
            lo, hi = lay.window_offsets[i, w:w + 2].tolist()
            assert lo == off[i, w * spm.WINDOW_SUBS]
            seg = lay.cols[i, lo:hi].numpy()
            assert np.all(seg // spm.WINDOW == w)
        assert lay.window_offsets[i, -1] == counts[i]


def _layout_model(vals, cols, counts, n):
    """A numpy model of window_layout with row populations: each row's
    entries (slots before its count) stably sorted by column // SUB, its
    padding after them; offsets[i, s] the first slot of sub-window s (of
    the padding at s = subs)."""
    m, L = cols.shape
    subs = -(-n // spm.SUB)
    key = np.where(np.arange(L)[None, :] < counts[:, None], cols // spm.SUB,
                   subs)
    order = np.argsort(key, axis=1, kind="stable")
    skey = np.take_along_axis(key, order, 1)
    off = np.stack([np.searchsorted(skey[i], np.arange(subs + 1))
                    for i in range(m)])
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(cols, order, 1), off)


LAYOUT_PACKS = {"short": (300, 517, 0.02), "dense": (64, 48, 0.3),
                "wide": (128, 1000, 0.005), "tall": (2000, 60, 0.4)}


@pytest.mark.parametrize("pack", ["short", "dense", "wide", "tall"])
@pytest.mark.parametrize("side", ["forward", "transposed"])
def test_window_layout_with_counts_matches_a_numpy_model(pack, side):
    """The layout the operator builds (row populations given) against a
    numpy model of it, on both packs of ragged matrices with empty rows
    and a duplicate: entries sorted by sub-window, the padding last and in
    no window, the offsets bit for bit; and every block window (of
    block_ratio(b) sub-windows, b from 2 to 32) and every WINDOW of one
    vector is one contiguous segment of each row holding exactly its
    columns."""
    m, n, density = LAYOUT_PACKS[pack]
    data, idx = _coo(m, n, density, m * 7 + n)
    if side == "transposed":
        idx, (m, n) = idx[:, ::-1].copy(), (n, m)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, n))
    counts = np.bincount(idx[:, 0], minlength=m)
    lay = spm.window_layout(vals, cols, n, torch.from_numpy(counts))
    want_v, want_c, want_off = _layout_model(vals.numpy(), cols.numpy(),
                                             counts, n)
    np.testing.assert_array_equal(lay.vals.numpy(), want_v)
    np.testing.assert_array_equal(lay.cols.numpy(), want_c)
    np.testing.assert_array_equal(lay.offsets.numpy(), want_off)
    off = lay.offsets.numpy()
    assert np.array_equal(off[:, -1], counts)          # padding after
    subs = off.shape[1] - 1
    for ratio in sorted({spm.block_ratio(b) for b in range(2, 33)}
                        | {spm.WINDOW_SUBS}):
        span = ratio * spm.SUB
        for w in range(-(-subs // ratio)):
            lo = off[:, w * ratio]
            hi = off[:, min((w + 1) * ratio, subs)]
            for i in range(m):
                seg = want_c[i, lo[i]:hi[i]]
                assert np.all(seg // span == w)
            assert np.array_equal(
                hi - lo, [np.sum((idx[:, 0] == i) & (idx[:, 1] // span == w))
                          for i in range(m)])


@pytest.mark.parametrize("n", WINDOW_NS)
@pytest.mark.parametrize("L", [1, 1023, 1024, 4802, 20_000])
def test_window_layout_evaluation_matches_reference(L, n):
    """The plain evaluation through the layout (per-window partials, then
    their sum in window order: the wrapper's CPU path) against the plain
    version, the reference's Pallas kernel in interpret mode and the dense
    product, at test_sparse_matvec_matches_reference's tolerance."""
    data, idx, m = _long_pack(L, n, 2 * L + n)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, n))
    lay = spm.window_layout(vals, cols, n, torch.bincount(
        torch.from_numpy(idx[:, 0]).long(), minlength=m))
    x = np.random.default_rng(L).standard_normal(n).astype(np.float32)
    spm.reset_launches()
    got = ops.sparse_matvec(lay.vals, lay.cols, torch.from_numpy(x), lay)
    assert got.dtype == torch.float32 and got.shape == (m,)
    jv, jc = jspm.ell_pack(data, idx, (m, n))
    A = np.zeros((m, n), np.float64)
    np.add.at(A, (idx[:, 0], idx[:, 1]), data)
    for want in (ref.sparse_matvec(vals, cols, torch.from_numpy(x)),
                 jops.sparse_matvec(jv, jc, x), A @ x):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)
    assert spm.LAUNCHES["sparse_matvec"] == 0


BLOCK_WIDTHS = [2, 3, 7, 20, 32]


@pytest.mark.parametrize("b", BLOCK_WIDTHS)
@pytest.mark.parametrize("pack", ["short", "dense", "wide", "tall"])
@pytest.mark.parametrize("side", ["forward", "transposed"])
def test_block_windows_match_reference(pack, side, b):
    """A block of b columns through the operator's layout (per-window
    partials of block_ratio(b) sub-windows, added in window order: the
    wrapper's CPU path, and the card's sums) against the reference's
    plain version on its own pack, its Pallas kernel in interpret mode
    (vmapped over the columns, as the reference does) and the dense
    product, on both packs of ragged matrices with empty rows and a
    duplicate, at test_sparse_matvec_matches_reference's tolerance."""
    m, n, density = LAYOUT_PACKS[pack]
    data, idx = _coo(m, n, density, m + n + b)
    if side == "transposed":
        idx, (m, n) = idx[:, ::-1].copy(), (n, m)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, n))
    lay = spm.window_layout(vals, cols, n, torch.bincount(
        torch.from_numpy(idx[:, 0]).long(), minlength=m))
    X = np.random.default_rng(b).standard_normal((n, b)).astype(np.float32)
    spm.reset_launches()
    got = ops.sparse_matvec(lay.vals, lay.cols, torch.from_numpy(X), lay)
    assert got.dtype == torch.float32 and got.shape == (m, b)
    assert spm.LAUNCHES["sparse_matvec"] == 0
    jv, jc = jspm.ell_pack(data, idx, (m, n))
    A = np.zeros((m, n), np.float64)
    np.add.at(A, (idx[:, 0], idx[:, 1]), data)
    plain = np.stack([np.asarray(jref.sparse_matvec(jv, jc, X[:, j]))
                      for j in range(b)], 1)
    kernel = jax.vmap(lambda x: jops.sparse_matvec(jv, jc, x), in_axes=1,
                      out_axes=1)(jnp.asarray(X))   # the reference's vmap
    for w in (plain, kernel, A @ X):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    # the windows' sum, by hand, in window order
    ratio = spm.block_ratio(b)
    off = lay.offsets.numpy()
    subs = off.shape[1] - 1
    g = lay.vals.numpy()[..., None] * X[lay.cols.numpy()]
    hand = np.zeros((m, b), np.float32)
    for w in range(-(-subs // ratio)):
        lo, hi = off[:, w * ratio], off[:, min((w + 1) * ratio, subs)]
        part = np.stack([g[i, lo[i]:hi[i]].sum(0) for i in range(m)])
        hand = hand + part.astype(np.float32)
    np.testing.assert_allclose(got.numpy(), hand, rtol=1e-5,
                               atol=1e-5 * np.abs(hand).max())


@pytest.mark.parametrize("b", list(range(2, 33)))
def test_block_plan_covers_rows_and_x(b):
    """The block kernel's plan at the Netflix shape's two packs and a small
    one: windows of block_ratio(b) sub-windows cover X once and fit
    BLOCK_FLOATS at b's pitch (b rounded up to 4), row groups cover the
    rows once, and the blocks keep BLOCK_WAVE_SHARE of the SMs of their
    last wave busy with the fewest groups that do, else the best share of
    any count of groups up to 8·SMS / windows."""
    for m, n in ((480_189, 17_770), (17_770, 480_189), (300, 517), (5, 1)):
        plan = spm.block_plan(m, n, b)
        span = plan.ratio * spm.SUB
        assert plan.ratio == spm.block_ratio(b) >= 1
        assert span * (-(-b // 4) * 4) <= spm.BLOCK_FLOATS
        assert (plan.windows - 1) * span < n <= plan.windows * span
        assert (plan.groups - 1) * plan.rows_per_group < m \
            <= plan.groups * plan.rows_per_group
        def share(g):
            blocks = plan.windows * g
            return blocks / (-(-blocks // gs.SMS) * gs.SMS)

        tried = range(1, min(m, max(8 * gs.SMS // plan.windows, 1)) + 1)
        first = [g for g in tried if share(g) >= spm.BLOCK_WAVE_SHARE]
        per = -(-m // (first[0] if first else
                       max(tried, key=lambda g: (share(g), -g))))
        assert plan.rows_per_group == per


def test_block_plan_refuses_a_window_of_no_sub_window():
    with pytest.raises(ValueError, match="block window"):
        spm.block_plan(10, 10, spm.BLOCK_FLOATS // spm.SUB + 1)


@pytest.mark.parametrize("m,n", [(1, 1), (5, spm.WINDOW + 1), (17_770,
                                                                 480_189),
                                 (480_189, 17_770), (3, 10 ** 7)])
def test_window_plan_covers_rows_and_x(m, n):
    """The window kernel's blocks: windows cover x once, row groups cover
    the rows once, about one block an SM (WINDOW_BLOCKS) where the rows
    allow."""
    plan = spm.window_plan(m, n)
    assert (plan.windows - 1) * spm.WINDOW < n <= plan.windows * spm.WINDOW
    assert (plan.groups - 1) * plan.rows_per_group < m \
        <= plan.groups * plan.rows_per_group
    assert plan.groups * plan.windows <= max(spm.WINDOW_BLOCKS, plan.windows)
    if m >= spm.WINDOW_BLOCKS:
        assert plan.groups == max(spm.WINDOW_BLOCKS // plan.windows, 1)


def test_sparse_op_builds_no_window_layout_on_the_cpu():
    """The layout serves the card's kernel; on the CPU a SparseOp holds
    none, and .T keeps it so."""
    data, idx, m = _long_pack(1500, 2000, 3)
    op = SparseOp.from_coo(torch.from_numpy(data), torch.from_numpy(idx),
                           (m, 2000), backend="pallas")
    assert op.windows is None and op.T.windows is None


def test_sparse_matvec_rejects_a_layout_that_does_not_fit():
    data, idx, m = _long_pack(1500, 2000, 4)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, 2000))
    lay = spm.window_layout(vals, cols, 2000, torch.bincount(
        torch.from_numpy(idx[:, 0]).long(), minlength=m))
    x = torch.zeros(spm.WINDOW + 5)             # two windows, not one
    with pytest.raises(ValueError, match="window layout"):
        spm.sparse_matvec(lay.vals, lay.cols, x, lay)
    with pytest.raises(ValueError, match="window layout"):    # int64
        spm.sparse_matvec(lay.vals, lay.cols, torch.zeros(2000),
                          lay._replace(offsets=lay.offsets.long()))


def test_sparse_matvec_refuses_the_layout_of_another_pack():
    """The layout serves its own vals / cols alone: the pack it was built
    from, a copy of its own pack, a pack of other values and a block of
    columns through another pack are all refused, so the two can never
    disagree."""
    data, idx, m = _long_pack(1500, 2000, 5)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, 2000))
    lay = spm.window_layout(vals, cols, 2000, torch.bincount(
        torch.from_numpy(idx[:, 0]).long(), minlength=m))
    x = torch.zeros(2000)
    for v, c, X in ((vals, cols, x), (lay.vals.clone(), lay.cols, x),
                    (2 * lay.vals, lay.cols, x),
                    (lay.vals, lay.cols.clone(), x),
                    (vals, cols, torch.zeros(2000, 5))):
        with pytest.raises(ValueError, match="not of this pack"):
            spm.sparse_matvec(v, c, X, lay)
    got = spm.sparse_matvec(lay.vals, lay.cols, torch.ones(2000, 5), lay)
    np.testing.assert_allclose(
        got.numpy(),
        ref.sparse_matvec(vals, cols, torch.ones(2000, 5)).numpy(),
        rtol=2e-4, atol=2e-4)


# (m, n, L): the Netflix shape's two packs, a wide sparse shape (1e6 x
# 1e6 with 1e8 entries: rows of ~100 slots, the longest ~150), ragged
# small ones, long rows over a wide x, and ten times the Netflix rows
MEMORY_SHAPES = [(480_189, 17_770, 178), (17_770, 480_189, 4_802),
                 (10 ** 6, 10 ** 6, 150), (300, 517, 20), (5, 30_000, 9_000),
                 (30_000, 5, 5), (2, 10 ** 6, 1_100), (4_801_890, 17_770, 178)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("m,n,L", MEMORY_SHAPES)
def test_layout_and_block_scratch_stay_within_the_pack(m, n, L, dtype):
    """What a layout and a block product add to device memory, by shape
    alone (nothing is allocated): a layout keeps its sub-window table only
    where that is at most 1 / TABLE_SHARE of the pack's bytes, and the
    block kernel's partials take at most the pack's bytes, or one window's
    (the output's own size), for every b from 2 to 32.  At 1e6 x 1e6 with
    1e8 entries no table fits and the rows are short, so the operator
    holds no layout and allocates no scratch; at the Netflix shape both packs keep theirs and a 20-column block takes the
    block kernel."""
    pack = m * L * spm.slot_bytes(dtype)
    table = 4 * m * (spm.sub_count(n) + 1)
    assert spm.sub_table_fits(L, n, dtype) == \
        (table * spm.TABLE_SHARE <= pack)
    for b in range(2, 33):
        windows = spm.block_windows(n, b)
        part = windows * m * b * 4
        if spm.block_scratch_fits(L, n, b, dtype):
            assert part <= max(pack, m * b * 4)
        else:
            assert windows > 1 and part > pack
    if (m, n) == (10 ** 6, 10 ** 6):
        assert not spm.sub_table_fits(L, n, dtype) and L < spm.LONG_ROW
    if (m, n, L) in MEMORY_SHAPES[:2]:
        assert spm.sub_table_fits(L, n, dtype)
        assert spm.block_scratch_fits(L, n, 20, dtype)


def _rows_pack(m, n, L, seed):
    """An ELL pack of m rows of L entries over columns [0, n) (the last
    row one short: a padded slot), its populations and the COO indices."""
    rng = np.random.default_rng(seed)
    counts = np.full(m, L)
    counts[-1] = L - 1
    rows = np.repeat(np.arange(m), counts)
    idx = np.stack([rows, rng.integers(0, n, rows.shape[0])],
                   1).astype(np.int32)
    data = rng.standard_normal(rows.shape[0]).astype(np.float32)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (m, n))
    return vals, cols, torch.from_numpy(counts), idx


@pytest.mark.parametrize("m,n,L,tables", [
    (3, 10 ** 6, 5, None),            # short rows over a wide x: none
    (2, 10 ** 6, 1_100, "window"),    # long rows over a wide x
    (300, 517, 20, "both"),           # short rows over a narrow x
    (40, 5_000, 2_500, "both")])
def test_pack_layout_builds_what_its_paths_use(m, n, L, tables):
    """The operator's layout of a pack: none where no windowed path serves
    it, the window table alone for long rows whose sub-window table would
    not fit, both tables otherwise; the wrapper's CPU path then takes the
    path the card would (the window or block model, or the plain
    warp-per-row sum), bit for bit, and matches the plain product."""
    vals, cols, counts, _ = _rows_pack(m, n, L, m + L)
    lay = spm.pack_layout(vals, cols, n, counts)
    if tables is None:
        assert lay is None
        return
    assert (lay.offsets is not None) == (tables == "both")
    full = spm.window_layout(vals, cols, n, counts)
    assert torch.equal(lay.vals, full.vals)
    assert torch.equal(lay.window_offsets, full.window_offsets)
    rng = np.random.default_rng(n)
    for b in (1, 3, 20):
        X = torch.from_numpy(rng.standard_normal((n, b)).astype(np.float32))
        X = X[:, 0].contiguous() if b == 1 else X
        got = spm.sparse_matvec(lay.vals, lay.cols, X, lay)
        if b == 1 and L >= spm.LONG_ROW:
            want = ref.sparse_matvec_windows(lay.vals, lay.cols,
                                             lay.window_offsets, X, 1)
        elif b > 1 and tables == "both" and spm.block_scratch_fits(
                L, n, b, vals.dtype):
            want = ref.sparse_matvec_windows(lay.vals, lay.cols, lay.offsets,
                                             X, spm.block_ratio(b))
        else:
            want = ref.sparse_matvec(lay.vals, lay.cols, X)
        assert torch.equal(got, want)
        np.testing.assert_allclose(
            got.numpy(), ref.sparse_matvec(vals, cols, X).numpy(),
            rtol=2e-4, atol=2e-4)


def test_window_layout_takes_the_row_populations():
    """A layout is built only with each row's population, so the padding
    never lands in a window."""
    vals, cols, counts, _ = _rows_pack(4, 600, 7, 1)
    with pytest.raises(TypeError):
        spm.window_layout(vals, cols, 600)             # no populations
    with pytest.raises(ValueError, match="populations"):
        spm.window_layout(vals, cols, 600, counts[:3])
    lay = spm.window_layout(vals, cols, 600, counts)
    assert lay.offsets[:, -1].tolist() == counts.tolist()
    assert lay.cols[-1, -1] == 0 and lay.vals[-1, -1] == 0    # padding last


def test_sparse_matvec_empty_rows_and_duplicates():
    """tests/test_kernels.py:232-242: rows with no entry and duplicate
    coordinates (sum semantics) survive the pack."""
    data = torch.tensor([1.0, 2.0, 3.0, 4.0])
    idx = torch.tensor([[0, 1], [0, 1], [3, 0], [3, 2]], dtype=torch.int32)
    vals, cols = spm.ell_pack(data, idx, (5, 3))
    got = ops.sparse_matvec(vals, cols, torch.tensor([1.0, 10.0, 100.0]))
    np.testing.assert_allclose(got.numpy(), [30.0, 0.0, 0.0, 403.0, 0.0],
                               rtol=1e-6)


@pytest.mark.parametrize("vdt", [torch.bfloat16, torch.float64])
def test_sparse_matvec_widens_the_values(vdt):
    """bf16 and f64 values are multiplied in f32, as the reference kernel
    casts each tile."""
    data, idx = _coo(120, 90, 0.1, 3)
    vals, cols = spm.ell_pack(torch.from_numpy(data).to(vdt),
                              torch.from_numpy(idx), (120, 90))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        90).astype(np.float32))
    got = ops.sparse_matvec(vals, cols, x)
    want = ops.sparse_matvec(vals.float(), cols, x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_sparse_matvec_wrapper_rejects_what_the_kernel_does_not_take():
    data, idx = _coo(20, 10, 0.3, 5)
    vals, cols = spm.ell_pack(torch.from_numpy(data), torch.from_numpy(idx),
                              (20, 10))
    x = torch.zeros(10)
    with pytest.raises(TypeError, match="int32"):
        spm.sparse_matvec(vals, cols.long(), x)
    with pytest.raises(ValueError, match="shape of vals"):
        spm.sparse_matvec(vals, cols[:, :1], x)
    with pytest.raises(TypeError, match="float64, float32 or bfloat16"):
        spm.sparse_matvec(vals.half(), cols, x)
    with pytest.raises(TypeError, match="float32"):
        spm.sparse_matvec(vals, cols, x.double())
    with pytest.raises(ValueError, match="1-D or 2-D"):
        spm.sparse_matvec(vals, cols, torch.zeros(10, 2, 2))
    with pytest.raises(ValueError, match="different devices"):
        spm.sparse_matvec(vals, cols, torch.zeros(10, device="meta"))


# --------------------------------------------------------------------------
# low-rank materialization (lowrank_update): core.update's kernel
# --------------------------------------------------------------------------

# tests/test_kernels.py:10 SHAPES (m, n, r) and :84 RAGGED (m, n) at r = 7
LOWRANK_SHAPES = [(64, 48, 4), (300, 200, 17), (1024, 512, 64),
                  (100, 700, 5), (512, 128, 128), (300, 517, 7),
                  (257, 129, 7), (127, 383, 7), (300, 200, 7)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,n,r", LOWRANK_SHAPES)
def test_lowrank_matmul_matches_reference(m, n, r, dt):
    """The plain lowrank_matmul against the reference's Pallas kernel in
    interpret mode (its wrapper pads ragged shapes) and its plain
    version; bf16 factors rounded once and handed to both."""
    rng = np.random.default_rng(m * n + r)
    U = rng.standard_normal((m, r)).astype(np.float32)
    s = np.abs(rng.standard_normal(r)).astype(np.float32)
    Vt = rng.standard_normal((r, n)).astype(np.float32)
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    Ut, Vtt = torch.from_numpy(U).to(tdt), torch.from_numpy(Vt).to(tdt)
    jU, jVt = (jnp.asarray(Ut.float().numpy()).astype(jnp.bfloat16),
               jnp.asarray(Vtt.float().numpy()).astype(jnp.bfloat16)) \
        if dt == "bf16" else (U, Vt)
    klu.reset_launches()
    got = ops.lowrank_matmul(Ut, torch.from_numpy(s), Vtt)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert klu.LAUNCHES["lowrank_matmul"] == 0
    tol = 3e-2 if dt == "bf16" else 2e-4
    for want in (jops.lowrank_matmul(jU, s, jVt),
                 jref.lowrank_matmul(jU, s, jVt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


def test_lowrank_matmul_reads_strided_factors():
    """A transposed view for Vt (the update's Dhat.T) and an f64 s give
    the contiguous f32 result."""
    rng = np.random.default_rng(9)
    U = torch.from_numpy(rng.standard_normal((30, 10)).astype(np.float32))
    D = torch.from_numpy(rng.standard_normal((30, 10)).astype(np.float32))
    s = torch.ones(10, dtype=torch.float64)
    torch.testing.assert_close(ops.lowrank_matmul(U, s, D.T),
                               ops.lowrank_matmul(U, s.float(),
                                                  D.T.contiguous()))


def test_lowrank_matmul_wrapper_rejects_what_the_kernel_does_not_take():
    U, s, Vt = torch.zeros(8, 3), torch.ones(3), torch.zeros(3, 5)
    with pytest.raises(ValueError, match="length 3"):
        klu.lowrank_matmul(U, s[:2], Vt)
    with pytest.raises(ValueError, match="rows, expected 3"):
        klu.lowrank_matmul(U, s, Vt[:2])
    with pytest.raises(TypeError, match="float64, float32 or bfloat16"):
        klu.lowrank_matmul(U.half(), s, Vt)
    with pytest.raises(TypeError, match="float tensor"):
        klu.lowrank_matmul(U, s.int(), Vt)
    with pytest.raises(ValueError, match="2-D"):
        klu.lowrank_matmul(U[0], s, Vt)
    with pytest.raises(ValueError, match="different devices"):
        klu.lowrank_matmul(U, s, torch.zeros(3, 5, device="meta"))


# --------------------------------------------------------------------------
# reorthogonalization (reorth.qtv / subtract_qc, ops.reorth)
# --------------------------------------------------------------------------

# tests/test_kernels.py:10 SHAPES as (m, k) and :110 RAGGED reorth shapes
REORTH_SHAPES = [(64, 4), (300, 17), (1024, 64), (100, 5), (512, 128),
                 (517, 5), (129, 31)]


def _basis(m, k, seed, dt="f32"):
    """(numpy Q for the reference, torch Q for the port, v); a bf16 basis
    is rounded once and handed to both."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((m, k)))[0].astype(np.float32)
    v = rng.standard_normal(m).astype(np.float32)
    if dt == "bf16":
        Qt = torch.from_numpy(Q).to(torch.bfloat16)
        return jnp.asarray(Qt.float().numpy()).astype(jnp.bfloat16), Qt, v
    return Q, torch.from_numpy(Q), v


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("m,k", REORTH_SHAPES)
def test_reorth_matches_reference(m, k, passes):
    """ops.reorth against the reference's Pallas pair in interpret mode
    and its oracle; the result is orthogonal to the basis."""
    Q, Qt, v = _basis(m, k, m * k + passes)
    rk.reset_launches()
    got = ops.reorth(_t(v, torch.float64), Qt, passes)
    assert got.dtype == torch.float32 and got.shape == (m,)
    assert rk.LAUNCHES == {"qtv": 0, "subtract_qc": 0}
    for want in (jops.reorth(v, Q, passes), jref.reorth(v, Q, passes)):
        _close(got, want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    assert float((Qt.T @ got).abs().max()) < 1e-4 * float(np.linalg.norm(v))
    assert torch.equal(ops.reorth(_t(v), Qt, 0), _t(v))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k", REORTH_SHAPES)
def test_qtv_and_subtract_qc_match_reference(m, k, dt):
    """Each kernel's plain version against the reference's Pallas kernel
    in interpret mode (one row block: the reference needs m % bm == 0)."""
    Q, Qt, v = _basis(m, k, 3 * m + k, dt)
    c = np.random.default_rng(k).standard_normal(k).astype(np.float32)
    got_c = rk.qtv(Qt, _t(v))
    assert got_c.shape == (k,) and got_c.dtype == torch.float32
    _close(got_c, jro.qtv(Q, v[:, None], bm=m)[:, 0])
    got_w = rk.subtract_qc(_t(v), Qt, _t(c))
    assert got_w.shape == (m,) and got_w.dtype == torch.float32
    _close(got_w, jro.subtract_qc(v[:, None], Q, c[:, None], bm=m)[:, 0])


def test_reorth_wrappers_reject_what_the_kernel_does_not_take():
    Q, v, c = torch.zeros(8, 3), torch.zeros(8), torch.zeros(3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rk.qtv(Q.double(), v)
    with pytest.raises(TypeError, match="float32"):
        rk.qtv(Q, v.double())
    with pytest.raises(ValueError, match="length 8"):
        rk.qtv(Q, v[:-1])
    with pytest.raises(ValueError, match="length 3"):
        rk.subtract_qc(v, Q, c[:-1])
    with pytest.raises(ValueError, match="2-D"):
        rk.subtract_qc(v, Q[0], c)
    with pytest.raises(ValueError, match="different devices"):
        rk.qtv(Q, torch.zeros(8, device="meta"))


@pytest.mark.parametrize("dt", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("m,k", [(1, 1), (300, 17), (480_189, 201),
                                 (10**7, 3), (100, 5000)])
def test_qtv_plan_covers_every_row_once(m, k, dt):
    """qtv and subtract_qc take the projection pair's staged tiles: its
    plan's tiles cover the basis's rows once, every block walks a tile,
    and the blocks' strided walks take every tile once."""
    plan = gs.proj_plan(m, k, PLAN_DTYPES[dt])
    T = plan.tile_rows
    assert (plan.tiles - 1) * T < m <= plan.tiles * T
    assert 1 <= plan.grid <= min(plan.tiles, gs.PROJ_BLOCKS)
    walks = np.concatenate([np.arange(b, plan.tiles, plan.grid)
                            for b in range(plan.grid)])
    np.testing.assert_array_equal(np.sort(walks), np.arange(plan.tiles))


# --------------------------------------------------------------------------
# COO scatter-add (count_sketch): the sketch-resident state's fold
# --------------------------------------------------------------------------

def _stream(E, m, d, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, E).astype(np.int32)
    cols = rng.integers(0, d, E).astype(np.int32)
    vals = (rng.integers(-8, 9, E) * 0.25 if dyadic
            else rng.standard_normal(E)).astype(np.float32)
    return rows, cols, vals


def _add_at(rows, cols, vals, shape):
    """np.add.at in f32: one entry after another, in entry order."""
    out = np.zeros(shape, np.float32)
    np.add.at(out, (rows, cols), vals)
    return out


def _scatter(rows, cols, vals, shape):
    return ops.scatter_add(torch.from_numpy(rows), torch.from_numpy(cols),
                           torch.from_numpy(vals), shape).numpy()


@pytest.mark.parametrize("E,m,d", [(300, 37, 20), (128, 128, 128),
                                   (1, 5, 3), (513, 260, 130)])
def test_scatter_add_matches_reference(E, m, d):
    """tests/test_kernels.py:304-321's shapes: against the reference's
    kernel (interpret mode) and oracle at 2e-6, and bit for bit against
    np.add.at in f32."""
    rows, cols, vals = _stream(E, m, d, E * m + d)
    cs.reset_launches()
    got = _scatter(rows, cols, vals, (m, d))
    assert cs.LAUNCHES["scatter_add"] == 0
    for want in (jops.scatter_add(rows, cols, vals, (m, d)),
                 jref.scatter_add(rows, cols, vals, (m, d))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-6,
                                   atol=2e-6)
    np.testing.assert_array_equal(got, _add_at(rows, cols, vals, (m, d)))


def test_scatter_add_duplicate_slots_bitexact():
    """Forced collisions on dyadic values: duplicates SUM, bit for bit
    equal to the reference's kernel, its one-hot oracle and np.add.at."""
    rows = np.asarray([3, 3, 3, 0, 3, 1, 1], np.int32)
    cols = np.asarray([1, 1, 1, 0, 1, 2, 2], np.int32)
    vals = np.asarray([0.25, 0.5, 1.25, -2.0, -0.75, 8.0, -8.0], np.float32)
    got = _scatter(rows, cols, vals, (5, 4))
    for want in (jops.scatter_add(rows, cols, vals, (5, 4)),
                 jref.scatter_add(rows, cols, vals, (5, 4)),
                 _add_at(rows, cols, vals, (5, 4))):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert got[3, 1] == np.float32(1.25)       # 0.25+0.5+1.25-0.75
    assert got[1, 2] == np.float32(0.0)        # +8 and -8 annihilate
    assert got[0, 0] == np.float32(-2.0)


@pytest.mark.parametrize("E,m,d", [(64, 3, 2), (500, 4, 4), (2000, 1, 1)])
def test_scatter_add_dyadic_collisions_bitexact(E, m, d):
    rows, cols, vals = _stream(E, m, d, E + m, dyadic=True)
    got = _scatter(rows, cols, vals, (m, d))
    np.testing.assert_array_equal(
        got, np.asarray(jref.scatter_add(rows, cols, vals, (m, d))))
    np.testing.assert_array_equal(got, _add_at(rows, cols, vals, (m, d)))


def test_scatter_add_empty_and_padding():
    """E = 0 gives zeros; (0, 0, 0) padding entries are exact, and an
    all-duplicates stream at (0, 0) counts each entry once."""
    empty = np.zeros(0, np.int32)
    z = _scatter(empty, empty, np.zeros(0, np.float32), (4, 6))
    np.testing.assert_array_equal(z, np.zeros((4, 6), np.float32))
    np.testing.assert_array_equal(
        z, np.asarray(jops.scatter_add(empty, empty,
                                       np.zeros(0, np.float32), (4, 6))))
    E = 200
    zeros, ones = np.zeros(E, np.int32), np.ones(E, np.float32)
    got = _scatter(zeros, zeros, ones, (3, 3))
    assert got[0, 0] == np.float32(E)
    assert np.abs(got).sum() == np.float32(E)
    np.testing.assert_array_equal(
        got, np.asarray(jops.scatter_add(zeros, zeros, ones, (3, 3))))
    rows, cols, vals = _stream(37, 9, 7, 5)
    padded = [np.concatenate([x, np.zeros(27, x.dtype)])
              for x in (rows, cols, vals)]
    np.testing.assert_array_equal(_scatter(*padded, (9, 7)),
                                  _scatter(rows, cols, vals, (9, 7)))


def test_scatter_add_drops_coordinates_outside_the_panel():
    """A row or column outside (m, d) — past the end, or negative — lands
    nowhere, as in the reference's one-hot oracle; in particular a column
    past d does not spill into the next row of the flattened panel."""
    rows = np.asarray([0, 2, 5, 1, -1, 3, 1], np.int32)
    cols = np.asarray([0, 3, 0, 4, 1, -2, 1], np.int32)
    vals = np.asarray([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 0.5], np.float32)
    got = _scatter(rows, cols, vals, (4, 4))
    want = np.zeros((4, 4), np.float32)
    want[0, 0], want[2, 3], want[1, 1] = 1.0, 2.0, 0.5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jref.scatter_add(rows, cols, vals, (4, 4))))
    np.testing.assert_array_equal(
        got, np.asarray(jops.scatter_add(rows, cols, vals, (4, 4))))


def _np_bins(rows, cols, vals, shape, bits):
    """numpy's stable argsort of each inside entry's tile: the bins of the
    card's scatter-add, built independently of the model."""
    m, d = shape
    r, c = rows.astype(np.int64), cols.astype(np.int64)
    inside = (r >= 0) & (r < m) & (c >= 0) & (c < d)
    key = (r * d + c)[inside]
    order = np.argsort(key >> bits, kind="stable")
    bins = -(-(m * d) // (1 << bits))
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(key >> bits, minlength=bins))])
    return (offsets, (key[order] & ((1 << bits) - 1)).astype(np.int32),
            vals[inside][order])


# (E, m, d, tile_bits, lo, hi_r, hi_c): coordinates outside the panel;
# empty tiles (a few rows of a tall panel); a ragged last tile; d = 1;
# one tile that takes everything
BIN_CASES = {"outside": (400, 30, 20, 5, -2, 33, 23),
             "empty tiles": (300, 400, 16, 6, 0, 12, 16),
             "ragged last tile": (500, 37, 13, 7, 0, 37, 13),
             "d = 1": (300, 257, 1, 5, 0, 257, 1),
             "one tile": (600, 50, 40, 14, 0, 50, 40)}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_entries_is_a_stable_sort_by_tile(case):
    """The plain model of the card's binning against numpy's stable
    argsort by bin: the same offsets, cells and values, bit for bit; and
    the same through the wrapper on CPU tensors, whose plan bins by single
    tiles at these sizes."""
    E, m, d, bits, lo, hi_r, hi_c = BIN_CASES[case]
    rng = np.random.default_rng(E + m)
    rows = rng.integers(lo, hi_r, E).astype(np.int32)
    cols = rng.integers(lo, hi_c, E).astype(np.int32)
    vals = rng.standard_normal(E).astype(np.float32)
    want = _np_bins(rows, cols, vals, (m, d), bits)
    t = (torch.from_numpy(rows), torch.from_numpy(cols),
         torch.from_numpy(vals))
    plan = cs.bin_plan(E, (m, d), bits)
    assert plan.bin_bits == plan.part_bits == bits
    for got in (ref.bin_entries(*t, (m, d), bits),
                cs.bin_entries(*t, plan)):
        assert [x.dtype for x in got] == [torch.int64, torch.int32,
                                          torch.float32]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    offsets = want[0]
    assert offsets.shape == (-(-(m * d) >> bits) + 1,)
    if case == "empty tiles":
        assert (np.diff(offsets) == 0).any()
    if case == "one tile":
        assert offsets.tolist() == [0, E]


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binning_by_part_inside_bins_is_binning_by_part(case):
    """The card's step 4 bins each bin's pairs again by part, stably:
    binning into bins of 4 tiles and then each bin by tile gives the bins
    of single tiles that binning the stream by tile at once gives."""
    E, m, d, bits, lo, hi_r, hi_c = BIN_CASES[case]
    rng = np.random.default_rng(E + d)
    rows = rng.integers(lo, hi_r, E).astype(np.int32)
    cols = rng.integers(lo, hi_c, E).astype(np.int32)
    vals = rng.standard_normal(E).astype(np.float32)
    offsets, cells, values = _np_bins(rows, cols, vals, (m, d), bits + 2)
    parts = []
    for b in range(offsets.shape[0] - 1):
        seg = slice(offsets[b], offsets[b + 1])
        order = np.argsort(cells[seg] >> bits, kind="stable")
        key = (b << (bits + 2)) + cells[seg][order].astype(np.int64)
        parts.append((key, values[seg][order]))
    key = np.concatenate([k for k, _ in parts])
    want = _np_bins(rows, cols, vals, (m, d), bits)
    np.testing.assert_array_equal(key >> bits,
                                  np.repeat(np.arange(want[0].shape[0] - 1),
                                            np.diff(want[0])))
    np.testing.assert_array_equal(key & ((1 << bits) - 1), want[1])
    np.testing.assert_array_equal(np.concatenate([v for _, v in parts]),
                                  want[2])


def test_bin_plan_sizes_slices_and_counters():
    """Phase-7 fold shapes take bins of 2 and 4 tiles and 4,096 slices;
    every plan has at most BATCH_BINS bins of the fewest tiles (a power of
    two) that allow it, covers its stream with whole chunks in a multiple
    of WARPS slices, keeps slices within int32 counts, and each count
    matrix within MAX_COUNTERS."""
    for shape, bin_bits, bins in (((100_000, 128), 15, 391),
                                  ((256, 80_000), 16, 313)):
        p = cs.bin_plan(16_777_216, shape)
        assert (p.tile_bits, p.bin_bits, p.bins, p.slices, p.slice_len) == \
            (14, bin_bits, bins, 4096, 4096)
    for E, shape, bits in ((1, (1, 1), 5), (200, (3, 3), 14),
                           (10 ** 6, (1000, 1000), 5),
                           (1000, (512 << 14, 1), 14),
                           (1000, ((512 << 14) + 1, 1), 14),
                           (2 ** 31 - 1, (10 ** 5, 10 ** 5), 14),
                           (5 * 10 ** 7, (10 ** 7, 256), 15)):
        p = cs.bin_plan(E, shape, bits)
        total = shape[0] * shape[1]
        assert p.bins == -(-total // (1 << p.bin_bits)) <= cs.BATCH_BINS
        assert p.bin_bits == bits or \
            -(-total // (1 << (p.bin_bits - 1))) > cs.BATCH_BINS
        assert p.slices % cs.WARPS == 0 and p.slice_len % cs.CHUNK == 0
        assert p.slices * p.slice_len >= E
        assert p.slice_len < 2 ** 31
        assert p.bins * p.slices <= cs.MAX_COUNTERS
        assert p.bins * p.parts * p.part_slices <= cs.MAX_COUNTERS
    assert cs.bin_plan(1000, (512 << 14, 1)).bin_bits == 14
    assert cs.bin_plan(1000, ((512 << 14) + 1, 1)).bin_bits == 15
    with pytest.raises(ValueError, match="tile_bits"):
        cs.bin_plan(10, (4, 4), 16)
    with pytest.raises(ValueError, match="non-empty"):
        cs.bin_plan(10, (0, 4))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        cs.bin_plan(2 ** 31, (4, 4))


# (shape, tile_bits) -> tiles a bin in steps 1-3, tiles a bin in step 5:
# the phase-7 folds, a Netflix-width Y fold, bins of 64 tiles, and a panel
# of more than BATCH_BINS**2 tiles, whose parts hold 2 tiles each
PART_CASES = [((100_000, 128), 14, 2), ((256, 80_000), 14, 4),
              ((480_189, 128), 14, 8), ((4_194_304, 128), 14, 64),
              ((1 << 20, 1 << 13), 14, 1024), ((2000, 1000), 5, 128)]


@pytest.mark.parametrize("shape,bits,width", PART_CASES)
def test_bin_plan_cuts_wide_bins_into_parts(shape, bits, width):
    """Bins of more than 2**DIRECT_SUB_BITS tiles are cut into parts of
    one tile each, at most BATCH_BINS a bin (parts of 2**k tiles past
    BATCH_BINS**2 tiles), in a multiple of WARPS slices a bin, the count
    matrix within MAX_COUNTERS; narrower bins are read whole."""
    p = cs.bin_plan(16_777_216, shape, bits)
    assert 1 << (p.bin_bits - p.tile_bits) == width
    tiles = -(-(shape[0] * shape[1]) >> bits)
    if width <= 1 << cs.DIRECT_SUB_BITS:
        assert (p.part_bits, p.part_slices, p.parts) == (p.bin_bits, 0, 1)
        return
    assert p.parts <= cs.BATCH_BINS
    assert p.part_bits == max(bits, p.bin_bits - 9)
    assert (p.part_bits == bits) == (tiles <= cs.BATCH_BINS ** 2)
    assert p.part_slices % cs.WARPS == 0 and p.part_slices >= cs.WARPS
    assert p.bins * p.parts * p.part_slices <= cs.MAX_COUNTERS


def test_ops_scatter_add_casts_indices_and_values():
    rows, cols, vals = _stream(50, 6, 5, 11)
    want = _scatter(rows, cols, vals, (6, 5))
    got = ops.scatter_add(torch.from_numpy(rows).long(),
                          torch.from_numpy(cols).long()[:, None],
                          torch.from_numpy(vals).half(), (6, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)
    assert got.dtype == torch.float32


def test_scatter_add_wrapper_rejects_what_the_kernel_does_not_take():
    r, c, v = torch.zeros(4, dtype=torch.int32), \
        torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    with pytest.raises(TypeError, match="int32"):
        cs.scatter_add(r.long(), c, v, (2, 2))
    with pytest.raises(TypeError, match="float64, float32 or bfloat16"):
        cs.scatter_add(r, c, v.half(), (2, 2))
    with pytest.raises(ValueError, match="one length"):
        cs.scatter_add(r, c[:3], v, (2, 2))
    with pytest.raises(ValueError, match="1-D"):
        cs.scatter_add(r[:, None], c, v, (2, 2))
    with pytest.raises(ValueError, match="non-negative"):
        cs.scatter_add(r, c, v, (-1, 2))
    with pytest.raises(ValueError, match="different devices"):
        cs.scatter_add(r, c, torch.zeros(4, device="meta"), (2, 2))


def test_scatter_add_plain_version_adds_in_entry_order():
    """200,000 Gaussian entries of spread magnitudes on 37 cells: the
    plain version (the CPU path, and the kernel's bitwise reference on
    the card) adds each cell's entries one after another in entry order,
    bit for bit np.add.at in f32."""
    rng = np.random.default_rng(12)
    E = 200_000
    rows = rng.integers(0, 37, E).astype(np.int32)
    cols = np.zeros(E, np.int32)
    vals = (rng.standard_normal(E)
            * 10.0 ** rng.integers(-4, 5, E)).astype(np.float32)
    np.testing.assert_array_equal(_scatter(rows, cols, vals, (37, 1)),
                                  _add_at(rows, cols, vals, (37, 1)))
