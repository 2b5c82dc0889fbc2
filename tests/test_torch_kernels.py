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
ELL pack is held bit for bit.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketch import make_sketch as ref_make_sketch
from repro.kernels import gk_step as jgs
from repro.kernels import sparse_matvec as jspm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core.operators import SparseOp
from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import lowrank_update as klu
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import sketch_matvec as skm
from repro_torch.kernels import sparse_matvec as spm

KERNEL_MODULES = {"gk_step": gs, "sketch_matvec": skm, "sparse_matvec": spm,
                  "lowrank_update": klu}

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


@pytest.mark.parametrize("L,k", [(48, 4), (300, 17), (129, 31)])
def test_projection_stages_match_reference(L, k):
    """proj_qtv / proj_norm against the reference's stage-2/3 kernels."""
    rng = np.random.default_rng(L * k)
    u = rng.standard_normal(L).astype(np.float32)
    Q = np.linalg.qr(rng.standard_normal((L, k)))[0].astype(np.float32)
    c = rng.standard_normal(k).astype(np.float32)
    want_w, want_c = jgs.proj_qtv(u[:, None], Q, c[:, None], bm=L)
    got_w, got_c = gs.proj_qtv(_t(u), _t(Q), _t(c))
    _close(got_w, want_w[:, 0])
    _close(got_c, want_c[:, 0])
    want_v, want_n = jgs.proj_norm(u[:, None], Q, c[:, None], bm=L)
    got_v, got_n = gs.proj_norm(_t(u), _t(Q), _t(c))
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


@pytest.mark.parametrize("L", [1, 7, 8, 9, 2047, 2048 * 8 + 1, 100_000,
                               80_000])
def test_rows_plan_covers_every_row_once(L):
    per, grid = gs.rows_plan(L)
    assert per % gs.GROUP == 0
    assert grid <= gs.MAX_BLOCKS
    assert (grid - 1) * per < L <= grid * per


@pytest.mark.parametrize("m,n", [(1, 1), (64, 48), (2000, 100_000),
                                 (100_000, 2000), (100_000, 80_000),
                                 (10**7, 3)])
def test_chunk_plan_covers_every_row_once(m, n):
    per, chunks = gs.chunk_plan(m, n)
    assert 1 <= chunks <= gs.MAX_CHUNKS
    assert (chunks - 1) * per < m <= chunks * per
    tiles = -(-n // gs.THREADS)
    if m >= 64 * gs.RMV_TARGET_BLOCKS:
        assert tiles * chunks >= gs.RMV_TARGET_BLOCKS


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
