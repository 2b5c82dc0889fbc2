#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0] [--m 100000] [--n 80000]
                          [--m64 20000] [--n64 16000]
                          [--sm 480189] [--sn 17770]

Phases (any failure exits non-zero; there is no CPU fallback):

  1. device and build — the card's name and power limit from nvidia-smi,
     and an nvcc build of every kernel in src/repro_torch/csrc for sm_90a
     (one nvcc per source, all started together);
  2. kernel vs plain version — each of the four fused GK-step kernels, and
     gk_step_fused / gk_rstep_fused at passes 0..3, against the plain-torch
     versions of repro_torch.kernels.ref on ragged small shapes and at the
     main shape, f32 and bf16 storage; matvec_fused / rmatvec_fused with
     f64, f32 and bf16 A on the shapes of tests/test_kernels.py:22-110 and
     at the main shape; sketch_matmat on the shapes of
     tests/test_kernels.py:271-300 and at gnystrom's three main-path
     shapes, on row-major X and on a transposed view of X; sparse_matvec
     on the shapes of tests/test_kernels.py:210-245 (empty rows,
     duplicates, both packs, one vector and 20-column blocks, f32 and
     bf16 values); lowrank_matmul on tests/test_kernels.py's SHAPES and
     RAGGED and at the update's 30 x 30 core (r = 10, a transposed view);
     qtv, subtract_qc and ops.reorth (passes 1 and 2) on the shapes of
     tests/test_kernels.py:48-60 and :110-116 with an f32 and a bf16
     basis; scatter_add bit for bit against its plain version on the CPU
     (it sums in entry order): the shapes of tests/test_kernels.py:304-363,
     the forced-duplicates dyadic case, the empty stream (no launch), an
     all-at-(0, 0) stream, coordinates outside the panel and a 1e6-entry
     Gaussian stream, spread, in one tile and in one cell (each timed,
     beside the previous design's sorted path);
     its binning against the plain model, bins of 1 to 128 tiles;
     every kernel twice, bitwise equal;
  3. main path — A = M N with Gaussian M (m x 100) and N (100 x n) made on
     the card from --seed (the paper's numerical-rank-100 input, §6.1);
     factorize(A, SVDSpec(method="fsvd", rank=20, max_iters=200,
     backend="pallas")) against sigma(A) = sigma(R_M R_N^T) from thin QRs,
     with exact launch counts, a bitwise rerun, a bf16-basis run, and
     estimate_rank(A) == 100 through the host loop; then the rank-k
     update: update_factorization of that r = 20 factorization by a
     seeded rank-10 LowRankOp (s ~ 1e-2 sigma_max, beta 0.9,
     backend="pallas"): zero iterations, one lowrank_matmul launch, held
     against its plain version on the update's own core, and sigma within
     1e-5 sigma_max of the same update in f64 on the same bases; with the
     bases orthonormalized in f64, within 1e-5 sigma_max of the exact
     sigma of the factored operator;
  4. the sketch and blocked solvers on the same operand, backend="pallas":
     gnystrom (one sketch_pass, three sketch_matmat launches, bitwise
     rerun), rbk (5 sweeps, bitwise rerun), rsvd and fsvd_blocked, each
     against sigma_true at the reference's stol, with its wall time and a
     peak device memory that shows no copy of A or A^T;
     then every kernel is timed at its main shape beside its bound, its
     plain version and a PyTorch yardstick;
     after A is freed, materialize_lowrank of a rank-20 LowRankOp at the
     main shape through lowrank_matmul (32 GB written once), held against
     its plain version by row blocks and timed;
  5. the float64 leg — an f64 operand of numerical rank 100 (--m64 x
     --n64): matvec_fused / rmatvec_fused held against their plain
     versions on it (twice, bitwise), then factorize(method="fsvd",
     rank=20, max_iters=200, backend="pallas"), whose half-steps run
     through them: exact launch counts, sigma within 5e-4, and both
     kernels timed at that shape;
  6. the sparse operand — a matrix of the Netflix Prize's shape (--sm
     users x --sn movies), built on the card from --seed as COO: a row-
     and column-permuted block diagonal of 100 rank-1 blocks, so its
     rank is 100 and its exact sigma is known.  SparseOp(backend=
     "pallas") packs both directions; sparse_matvec is held against its
     plain version on both packs; fsvd (exact launch counts, bitwise
     rerun), "auto" (must pick fsvd_blocked) and estimate_rank (must give
     100) run on it, with a peak device memory far below one dense
     copy; sparse_matvec is timed both ways at b = 1 and b = 20.  Then
     the Lanczos basis of gk_bidiag at k = 200 (480,189 x 201 f32):
     ops.reorth(A p, Q, 2) against its plain version and orthogonal to Q
     (max|Q^T w| < 1e-4 ||v||, tests/test_kernels.py:59-60), and qtv /
     subtract_qc timed on it in f32 and on a bf16 copy;
  7. the sketch-resident state on phase 3's operand (it edits A in place,
     so it runs after every other use of A): sketch_operand with
     SVDSpec(method="gnystrom", rank=20, sketch_dim=128,
     backend="pallas") in one operator sweep; a seeded rank-1 drift on
     1,024 x 1,024 entries (||D||_F = 0.05 ||A||_F), each coordinate sent
     twice (a Gaussian part and the rest), shuffled: apply_entries with
     exactly 2 scatter_add launches, bitwise on a rerun; A += D in place
     and a fresh sketch with the same seeds within 1e-5 (relative
     Frobenius) of the folded panels; reconstruct with 0 iterations and
     the top-20 sigma within 1e-3 sigma_max of the exact sigma of A + D;
     the same after apply_lowrank_delta of phase 3b's rank-10 drift; the
     odometer trips on a fold of budget * base_norm and not before; peak
     memory below phase 3's + 2 GiB; scatter_add timed at both fold
     shapes, stage by stage, beside the previous design's sorted path, and
     so on two wider panels (480,189 x 128 and 4,194,304 x 128: bins of 8
     and of 64 tiles) with as many spread entries as the Y fold.

The line before the last is the card as nvidia-smi reports it; the last is
{"ok": true, "device": {...}}.  A kernels JSON line precedes them.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEV = "cuda"                  # every tensor of the run lives on the card
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
RANK, R_WANT, MAX_ITERS, RANK_ITERS = 100, 20, 200, 256
FSVD_STOL = 5e-4              # SOLVERS["fsvd"]["stol"], test_solver_parity
BF16_STOL = 5e-2              # BF16_STOL["fsvd"], test_solver_parity
REL_ERR_BOUND = 5e-5          # test_api.py test_factorization_reconstruct
SMALL_SHAPES = [(64, 48, 4), (300, 517, 17), (257, 129, 31), (127, 383, 9),
                (1024, 512, 64), (300, 200, 5)]   # tests/test_kernels.py:136
BF16_A_SHAPE = (8192, 8192, 201)                   # bf16 A kept this small
MATVEC_SHAPES = [(64, 48), (300, 200), (1024, 512), (100, 700), (512, 128),
                 (300, 517), (257, 129), (127, 383)]  # tests/test_kernels.py
SKETCH_SHAPES = [(300, 64, 24), (128, 130, 16), (70, 16, 48), (48, 48, 48),
                 (200, 96, 32)]                 # tests/test_kernels.py:271
SPARSE_SHAPES = [(300, 517, 0.02), (257, 129, 0.1), (64, 48, 0.3),
                 (128, 1000, 0.005)]               # tests/test_kernels.py:214
LOWRANK_SHAPES = [(64, 48, 4), (300, 200, 17), (1024, 512, 64),
                  (100, 700, 5), (512, 128, 128),  # tests/test_kernels.py:10
                  (300, 517, 7), (257, 129, 7), (127, 383, 7),
                  (300, 200, 7),                   # RAGGED, :84 (r = 7)
                  (30, 30, 10)]       # phase 3b's core: (r+k, r+k), r = k
REORTH_SHAPES = [(64, 4), (300, 17), (1024, 64), (100, 5), (512, 128),
                 (517, 5), (129, 31)]   # tests/test_kernels.py:48-60, :110
SCATTER_SHAPES = [(300, 37, 20), (128, 128, 128), (1, 5, 3),
                  (513, 260, 130)]         # tests/test_kernels.py:304-321
SCATTER_GAUSSIAN = (10 ** 6, 1000, 128)    # E, m, d of the long stream
BIN_SHAPES = [(50_000, 300, 37, 7),        # E, m, d, tile_bits: bins of
              (60_000, 700, 150, 5),       # 1, 8 and 128 tiles
              (100_000, 2000, 1000, 5)]
WIDE_FOLDS = [("Netflix-width Y fold", (480_189, 128)),  # bins of 8 tiles
              ("fold into bins of 64 tiles", (4_194_304, 128))]
LANCZOS_K = 200               # phase 6's basis: gk_bidiag(S, 200) -> Q (m, 201)
REORTH_BOUND = 1e-4           # max|Q^T w| / ||v||, tests/test_kernels.py:59
SKETCHRES_FIELDS = dict(method="gnystrom", rank=20, sketch_dim=128,
                        backend="pallas")  # phase 7: k = 128, l = 256
DRIFT_BLOCK = 1024            # phase 7's drift: rows x columns it touches
DRIFT_MASS = 0.05             # ||D||_F / ||A||_F
PANEL_BOUND = 1e-5            # fold vs fresh sketch, tests/test_sketchres.py:70-84
SKETCHRES_STOL = 1e-3         # SOLVERS["gnystrom"]["stol"]
DELTA_RANK = 10               # the update phase's drift
UPDATE_GATE = 1e-5            # GATE, tests/test_update.py:26
SPARSE_STOL = 5e-4            # SOLVERS["fsvd"] / ["fsvd_blocked"] stol
SPARSE_PEAK = 8               # GiB; one dense f32 copy of the cell is 34 GB
GIB = 2 ** 30
# phase 4: (method, spec fields, sigma bound as a fraction of sigma_max)
SKETCH_SOLVES = [
    # sketch_dim >= the rank, so the range is captured; 1e-3 is
    # SOLVERS["gnystrom"]["stol"] of tests/test_solver_parity.py
    ("gnystrom", dict(sketch_dim=128), 1e-3),
    # passes * sketch_dim = 100 Krylov columns reach the rank-100 range
    # (the sketch block's own columns add none of it); SOLVERS stol
    ("rbk", dict(passes=2, sketch_dim=50), 5e-4),
    ("rsvd", dict(oversample=100, power_iters=1), 5e-2),
    ("fsvd_blocked", dict(), 5e-4),
]
REPLACES = {"mv_qtv": "src/repro/kernels/gk_step.py:147",
            "rmv_qtv": "src/repro/kernels/gk_step.py:178",
            "proj_qtv": "src/repro/kernels/gk_step.py:206",
            "proj_norm": "src/repro/kernels/gk_step.py:232",
            "matvec_fused": "src/repro/kernels/gk_matvec.py:71",
            "rmatvec_fused": "src/repro/kernels/gk_matvec.py:92",
            "qtv": "src/repro/kernels/reorth.py:50",
            "subtract_qc": "src/repro/kernels/reorth.py:68",
            "lowrank_matmul": "src/repro/kernels/lowrank_update.py:34",
            "sparse_matvec": "src/repro/kernels/sparse_matvec.py:75",
            "sketch_matmat": "src/repro/kernels/sketch_matvec.py:65",
            "scatter_add": "src/repro/kernels/count_sketch.py:75"}
SOURCES = {"mv_qtv": "gk_step.cu", "rmv_qtv": "gk_step.cu",
           "proj_qtv": "gk_step.cu", "proj_norm": "gk_step.cu",
           "matvec_fused": "gk_step.cu", "rmatvec_fused": "gk_step.cu",
           "qtv": "reorth.cu", "subtract_qc": "reorth.cu",
           "sketch_matmat": "sketch_matvec.cu",
           "lowrank_matmul": "lowrank_update.cu",
           "sparse_matvec": "sparse_matvec.cu",
           "scatter_add": "count_sketch.cu"}
GK_STEP = ("mv_qtv", "rmv_qtv", "proj_qtv", "proj_norm")
MATVECS = ("matvec_fused", "rmatvec_fused")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --- phase 2: kernels against their plain versions ------------------------

def compare(name, got, want, dtypes):
    """Max |got − want| over the outputs; raises past the tolerance: rtol
    and atol/max|want| of 1e-5 in f32, 3e-2 with bf16 storage (the bounds
    of tests/test_kernels.py:151-187)."""
    import torch
    rtol = 3e-2 if torch.bfloat16 in dtypes else 1e-5
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = float((g - w).abs().max()) if w.numel() else 0.0
        ok = torch.allclose(g, w, rtol=rtol, atol=rtol * scale)
        check(ok, f"{name}: kernel differs from plain version by {err:.3e} "
                  f"(scale {scale:.3e}, rtol {rtol})")
        worst = max(worst, err)
    return worst


def bitwise_twice(name, fn):
    import torch
    a, b = fn(), fn()
    for x, y in zip(a, b):
        check(torch.equal(x, y), f"{name}: two launches differ bitwise")
    return a


def stage_inputs(gen, m, n, k, adt, qdt, A=None):
    import torch
    dev = DEV
    if A is None:
        A = torch.randn(m, n, generator=gen, device=dev).to(adt)
    p = torch.randn(n, generator=gen, device=dev)
    q = torch.randn(m, generator=gen, device=dev)
    ym = torch.randn(m, generator=gen, device=dev)
    yn = torch.randn(n, generator=gen, device=dev)
    Q = torch.linalg.qr(torch.randn(m, k, generator=gen, device=dev))[0]
    P = torch.linalg.qr(torch.randn(n, k, generator=gen, device=dev))[0]
    c = torch.randn(k, generator=gen, device=dev)
    return A, p, q, ym, yn, Q.to(qdt).contiguous(), P.to(qdt).contiguous(), c


def check_stages(gen, m, n, k, adt, qdt, A=None, steps=True):
    """All four kernels (and the composed half-steps) on one shape;
    returns {kernel: max abs error}."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    A, p, q, ym, yn, Q, P, c = stage_inputs(gen, m, n, k, adt, qdt, A)
    alpha = torch.tensor([0.37], device=DEV)
    tag = f"({m}x{n}, k={k}, A {adt}, basis {qdt})"
    errs = {}
    cases = {
        "mv_qtv": (lambda: gs.mv_qtv(A, p, ym, alpha, Q),
                   lambda: ref.mv_qtv(A, p, ym, alpha, Q), (adt, qdt)),
        "rmv_qtv": (lambda: gs.rmv_qtv(A, q, yn, 1.7, P),
                    lambda: ref.rmv_qtv(A, q, yn, 1.7, P), (adt, qdt)),
        "proj_qtv": (lambda: gs.proj_qtv(ym, Q, c),
                     lambda: ref.proj_qtv(ym, Q, c), (qdt,)),
        "proj_norm": (lambda: gs.proj_norm(ym, Q, c),
                      lambda: ref.proj_norm(ym, Q, c), (qdt,)),
    }
    for name, (kern, plain, dts) in cases.items():
        got = bitwise_twice(f"{name} {tag}", kern)
        errs[name] = compare(f"{name} {tag}", got, plain(), dts)
    if steps:
        for passes in range(4):
            got = bitwise_twice(
                f"gk_step_fused p={passes} {tag}",
                lambda: kops.gk_step_fused(A, p, ym, alpha, Q, passes))
            compare(f"gk_step_fused p={passes} {tag}", got,
                    ref.gk_step(A, p, ym, alpha, Q, passes), (adt, qdt))
            got = bitwise_twice(
                f"gk_rstep_fused p={passes} {tag}",
                lambda: kops.gk_rstep_fused(A, q, yn, 1.7, P, passes))
            compare(f"gk_rstep_fused p={passes} {tag}", got,
                    ref.gk_rstep(A, q, yn, 1.7, P, passes), (adt, qdt))
    torch.cuda.synchronize()
    return errs


def check_matvecs(gen, m, n, adt, A=None):
    """matvec_fused / rmatvec_fused on one shape against the plain
    versions (both multiply in f32 whatever A's storage: f32 bounds);
    returns {kernel: max abs error}."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    A, p, q, ym, yn, _, _, _ = stage_inputs(gen, m, n, 1, adt,
                                            torch.float32, A)
    alpha = torch.tensor([0.37], device=DEV)
    tag = f"({m}x{n}, A {adt})"
    cases = {
        "matvec_fused": (lambda: (gs.matvec_fused(A, p, ym, alpha),),
                         lambda: (ref.matvec_fused(A, p, ym, alpha),)),
        "rmatvec_fused": (lambda: (gs.rmatvec_fused(A, q, yn, 1.7),),
                          lambda: (ref.rmatvec_fused(A, q, yn, 1.7),)),
    }
    errs = {}
    for name, (kern, plain) in cases.items():
        got = bitwise_twice(f"{name} {tag}", kern)
        errs[name] = compare(f"{name} {tag}", got, plain(), (torch.float32,))
    torch.cuda.synchronize()
    return errs


def sketch_pack(gen, N, d):
    from repro_torch.core.sketch import make_sketch
    return make_sketch(gen, N, d, backend="pallas", device=DEV)


def check_sketch(tag, sk, X):
    """sketch_matmat(X) against the plain version (bf16 X is widened
    exactly, so f32 bounds hold); returns (max abs error, Y)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch_matvec as skm
    name = f"sketch_matmat {tag}"
    got = bitwise_twice(name, lambda: (skm.sketch_matmat(sk.signs, sk.idx,
                                                         X),))
    err = compare(name, got, (ref.sketch_matmat(sk.signs, sk.idx, X),),
                  (torch.float32,))
    torch.cuda.synchronize()
    return err, got[0]


def phase_new_kernels(gen, A_main):
    """Phase 2 rows of the gk_matvec pair and sketch_matmat; returns the
    max abs errors at the main path's shapes."""
    import torch
    n_cases = 0
    for m, n in MATVEC_SHAPES:
        for adt in (torch.float64, torch.float32, torch.bfloat16):
            check_matvecs(gen, m, n, adt)
            n_cases += 1
    m, n = A_main.shape
    errs = check_matvecs(gen, m, n, torch.float32, A=A_main)
    for N, d, b in SKETCH_SHAPES:
        for xdt in (torch.float32, torch.bfloat16):
            sk = sketch_pack(gen, N, d)
            X = torch.randn(N, b, generator=gen, device=DEV).to(xdt)
            Xt = torch.randn(b, N, generator=gen, device=DEV).to(xdt).T
            check_sketch(f"({N}x{b} row-major, d={d}, {xdt})", sk, X)
            check_sketch(f"({N}x{b} transposed view, d={d}, {xdt})", sk, Xt)
            n_cases += 2
    # gnystrom's three calls: Omega^T A^T (A^T a view), Psi^T A, Psi^T Y
    k = SKETCH_SOLVES[0][1]["sketch_dim"]
    l = 2 * k                                   # gnystrom's co-range width
    e1, Yt = check_sketch(f"range ({n}x{m} view of A, d={k})",
                          sketch_pack(gen, n, k), A_main.T)
    psi = sketch_pack(gen, m, l)
    e2, _ = check_sketch(f"co-range ({m}x{n} A, d={l})", psi, A_main)
    e3, _ = check_sketch(f"core ({m}x{k} view of Y, d={l})", psi, Yt.T)
    errs["sketch_matmat"] = max(e1, e2, e3)
    print(f"phase 2: {n_cases} more shape/type cases of matvec_fused/"
          f"rmatvec_fused (f64/f32/bf16 A) and sketch_matmat (row-major "
          f"and transposed-view X, f32/bf16) match the plain versions, "
          f"bitwise stable; max abs err at the main shapes: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


def phase_kernels(gen, A_main):
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    n_cases = 0
    for m, n, k in SMALL_SHAPES:
        for adt in (f32, bf16):
            for qdt in (f32, bf16):
                check_stages(gen, m, n, k, adt, qdt)
                n_cases += 1
    m, n, k = BF16_A_SHAPE
    for qdt in (f32, bf16):
        check_stages(gen, m, n, k, bf16, qdt)
        n_cases += 1
    m, n = A_main.shape
    check_stages(gen, m, n, MAX_ITERS + 1, f32, bf16, A=A_main)
    errs = check_stages(gen, m, n, MAX_ITERS + 1, f32, f32, A=A_main)
    print(f"phase 2: {n_cases + 2} shape/type cases x 4 kernels and "
          f"gk_step_fused/gk_rstep_fused x passes 0..3 match the plain "
          f"versions, bitwise stable; max abs err at the main shape (f32): "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    return errs


# --- phase 3: the main path ------------------------------------------------

def operand_factors(seed, m, n, dtype=None):
    """The seeded Gaussian factors M (m x RANK) and N (RANK x n) of A."""
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    M = torch.randn(m, RANK, generator=gen, device=DEV, dtype=dtype)
    N = torch.randn(RANK, n, generator=gen, device=DEV, dtype=dtype)
    return M, N


def factored_sigma(left, right):
    """sigma(left right^T) = sigma(R_l R_r^T) from the thin QRs left =
    Q_l R_l and right = Q_r R_r, in f64 — no dense SVD of the (m, n)
    matrix."""
    import torch
    R_l = torch.linalg.qr(left.double())[1]
    R_r = torch.linalg.qr(right.double())[1]
    return torch.linalg.svdvals(R_l @ R_r.T)


def make_operand(seed, m, n, dtype=None):
    import torch
    M, N = operand_factors(seed, m, n, dtype)
    A = M @ N
    s_true = factored_sigma(M, N.T)
    torch.cuda.synchronize()
    return A, s_true


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_main(A, s_true, seed):
    import torch
    from repro_torch.api import SVDSpec, estimate_rank, factorize
    from repro_torch.kernels import gk_step as gs
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    smax = float(s_true[0])

    def gen():
        return torch.Generator(device=DEV).manual_seed(seed)

    gs.reset_launches()
    fact, wall = timed(lambda: factorize(A, spec, generator=gen()))
    launches = dict(gs.LAUNCHES)
    k, passes = MAX_ITERS, spec.reorth_passes
    want = {"mv_qtv": k, "rmv_qtv": k - 1,
            "proj_qtv": (2 * k - 1) * (passes - 1), "proj_norm": 2 * k - 1,
            "matvec_fused": 0, "rmatvec_fused": 0}
    check(launches == want, f"launch counts {launches} != {want}")
    launches = {name: launches[name] for name in GK_STEP}
    err = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
    print(f"phase 3: fsvd f32 {A.shape[0]}x{A.shape[1]} wall {wall:.3f} s, "
          f"iterations {int(fact.iterations)}, breakdown "
          f"{bool(fact.breakdown)}, max|sigma - sigma_true|/sigma_max "
          f"{err:.3e} (bound {FSVD_STOL}), launches {launches}", flush=True)
    check(err < FSVD_STOL, f"fsvd sigma error {err:.3e} >= {FSVD_STOL}")
    errs, t_err = timed(lambda: fact.errors(A))
    rel = float(errs["relative"])
    print(f"phase 3: errors(A) relative {rel:.3e} (bound {REL_ERR_BOUND}), "
          f"residual {float(errs['residual']):.3e} "
          f"(||A||_F {float(torch.linalg.vector_norm(s_true)):.3e}), "
          f"{t_err:.3f} s", flush=True)
    check(rel < REL_ERR_BOUND, f"relative error {rel:.3e}")

    gs.reset_launches()
    again, wall2 = timed(lambda: factorize(A, spec, generator=gen()))
    check(dict(gs.LAUNCHES) == want, "rerun launch counts differ")
    check(torch.equal(fact.s, again.s), "sigma differs bitwise on a rerun")
    print(f"phase 3: rerun wall {wall2:.3f} s, sigma bitwise equal",
          flush=True)

    gs.reset_launches()
    half, wall3 = timed(lambda: factorize(
        A, spec.replace(precision="bf16"), generator=gen()))
    check(gs.LAUNCHES["mv_qtv"] == k, f"bf16 launches {gs.LAUNCHES}")
    err16 = float((half.s.double() - s_true[:R_WANT]).abs().max()) / smax
    print(f"phase 3: fsvd bf16 bases wall {wall3:.3f} s, iterations "
          f"{int(half.iterations)}, sigma error {err16:.3e} "
          f"(bound {BF16_STOL})", flush=True)
    check(err16 < BF16_STOL, f"bf16 sigma error {err16:.3e}")

    gs.reset_launches()
    est, wall4 = timed(lambda: estimate_rank(
        A, SVDSpec(max_iters=RANK_ITERS, backend="pallas"),
        generator=gen()))
    rank_launches = {name: gs.LAUNCHES[name] for name in GK_STEP}
    print(f"phase 3: estimate_rank wall {wall4:.3f} s, rank {int(est)}, "
          f"GK iterations {int(est.iterations)}, launches {rank_launches}",
          flush=True)
    check(int(est) == RANK, f"estimate_rank returned {int(est)}")
    check(all(v > 0 for v in rank_launches.values()),
          f"estimate_rank skipped a kernel: {rank_launches}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3: peak device memory {peak / GIB:.2f} GiB", flush=True)
    return launches, peak, fact


def counting_op(inner):
    """``inner`` behind a wrapper that counts each operator touch (a
    fused sketch_pass is one), so a run shows its sweep budget."""
    from repro_torch.core.operators import Operator

    class CountingOp(Operator):
        def __init__(self):
            self.counts = dict.fromkeys(
                ("mv", "rmv", "matmat", "rmatmat", "sketch_pass"), 0)

        shape = property(lambda self: inner.shape)
        dtype = property(lambda self: inner.dtype)
        device = property(lambda self: inner.device)

        def _touch(self, kind, *args):
            self.counts[kind] += 1
            return getattr(inner, kind)(*args)

        def mv(self, p):
            return self._touch("mv", p)

        def rmv(self, q):
            return self._touch("rmv", q)

        def matmat(self, V):
            return self._touch("matmat", V)

        def rmatmat(self, Q):
            return self._touch("rmatmat", Q)

        def sketch_pass(self, omega, psi):
            return self._touch("sketch_pass", omega, psi)

    return CountingOp()


def phase_sketch(A, s_true, seed, peak3):
    """gnystrom, rbk, rsvd and fsvd_blocked on the main operand; returns
    gnystrom's sketch_matmat launch count."""
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.core.operators import DenseOp
    from repro_torch.kernels import sketch_matvec as skm
    smax = float(s_true[0])
    dense = DenseOp(A, backend="pallas")
    launches = None
    for method, fields, bound in SKETCH_SOLVES:
        spec = SVDSpec(method=method, rank=R_WANT, backend="pallas",
                       **fields)

        def solve(op):
            gen = torch.Generator(device=DEV).manual_seed(seed + 3)
            return factorize(op, spec, generator=gen)

        guard = counting_op(dense)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        skm.reset_launches()
        fact, wall = timed(lambda: solve(guard))
        sk_launches = skm.LAUNCHES["sketch_matmat"]
        peak = torch.cuda.max_memory_allocated()
        err = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
        touches = {k: v for k, v in guard.counts.items() if v}
        print(f"phase 4: {method} {fields} wall {wall:.3f} s, iterations "
              f"{int(fact.iterations)}, max|sigma - sigma_true|/sigma_max "
              f"{err:.3e} (bound {bound}), operator touches {touches}, "
              f"sketch_matmat launches {sk_launches}, peak device memory "
              f"{peak / GIB:.2f} GiB (phase 3 {peak3 / GIB:.2f} GiB)",
              flush=True)
        check(err < bound, f"{method} sigma error {err:.3e} >= {bound}")
        check(peak < peak3 + 2 * GIB,
              f"{method} peak {peak / GIB:.2f} GiB: a copy of the operand?")
        if method == "gnystrom":
            launches = sk_launches
            check(touches == {"sketch_pass": 1},
                  f"gnystrom touched the operand {touches}")
            check(sk_launches == 3, f"gnystrom launched sketch_matmat "
                                    f"{sk_launches} times, not 3")
        if method == "rbk":
            sweeps = 2 * fields["passes"] + 1
            check(int(fact.iterations) == sweeps,
                  f"rbk reports {int(fact.iterations)} sweeps")
            check(sum(touches.values()) == sweeps,
                  f"rbk touched the operand {touches}")
        if method in ("gnystrom", "rbk"):
            skm.reset_launches()
            again, wall2 = timed(lambda: solve(dense))
            check(torch.equal(fact.s, again.s),
                  f"{method} sigma differs bitwise on a rerun")
            print(f"phase 4: {method} rerun wall {wall2:.3f} s, sigma "
                  f"bitwise equal", flush=True)
    return launches


def event_ms(fn, reps=10):
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(A, seed):
    """Each kernel at the main shape (f32 A, f32 bases of the main path's
    widths), its bound, its plain version and a PyTorch yardstick that
    computes the same function with library calls."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    m, n = A.shape
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    kq, kp = MAX_ITERS + 1, MAX_ITERS
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    Q = torch.linalg.qr(torch.randn(m, kq, generator=g, device=DEV))[0]
    P = torch.linalg.qr(torch.randn(n, kp, generator=g, device=DEV))[0]
    Q, P = Q.contiguous(), P.contiguous()
    c = torch.randn(kq, generator=g, device=DEV)
    alpha = torch.tensor([0.37], device=DEV)
    f = 4  # bytes of an f32

    def lib_mv():
        u = torch.addmv(ym, A, p, beta=-0.37)
        return u, torch.mv(Q.T, u)

    def lib_rmv():
        v = torch.addmv(yn, A.T, q, beta=-1.7)
        return v, torch.mv(P.T, v)

    def lib_proj():
        w = torch.addmv(ym, Q, c, alpha=-1.0)
        return w, torch.mv(Q.T, w)

    def lib_norm():
        v = torch.addmv(ym, Q, c, alpha=-1.0)
        return v, torch.dot(v, v)

    rows = {
        "mv_qtv": (lambda: gs.mv_qtv(A, p, ym, alpha, Q),
                   lambda: ref.mv_qtv(A, p, ym, alpha, Q), lib_mv,
                   f * (m * n + n + m + m * kq + 1 + m + kq),
                   2 * m * n + 2 * m + 2 * m * kq),
        "rmv_qtv": (lambda: gs.rmv_qtv(A, q, yn, 1.7, P),
                    lambda: ref.rmv_qtv(A, q, yn, 1.7, P), lib_rmv,
                    f * (m * n + m + n + n * kp + n + kp),
                    2 * m * n + 2 * n + 2 * n * kp),
        "proj_qtv": (lambda: gs.proj_qtv(ym, Q, c),
                     lambda: ref.proj_qtv(ym, Q, c), lib_proj,
                     f * (m + m * kq + kq + m + kq), 4 * m * kq + m),
        "proj_norm": (lambda: gs.proj_norm(ym, Q, c),
                      lambda: ref.proj_norm(ym, Q, c), lib_norm,
                      f * (m + m * kq + kq + m + 1), 2 * m * kq + 3 * m),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, flops) in rows.items():
        k = kp if name == "rmv_qtv" else kq
        out[name] = time_row(name, kern, plain, lib, nbytes, flops,
                             f"({m}x{n}, k={k}, f32)")
    return out


def csr_transpose(sk):
    """Tᵀ (d, N) of a sparse-sign pack as a CSR tensor (columns sorted
    within each row; colliding slots stay as separate entries, which
    SpMM sums) for the torch.sparse.mm yardstick."""
    import torch
    cols, order = torch.sort(sk.idx.long(), dim=1)
    vals = torch.gather(sk.signs.float(), 1, order)
    d, zeta = sk.idx.shape
    crow = torch.arange(0, d * zeta + 1, zeta, device=DEV)
    with warnings.catch_warnings():       # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols.reshape(-1),
                                       vals.reshape(-1), size=(d, sk.n),
                                       check_invariants=False)


def time_row(name, kern, plain, lib, nbytes, flops, shape, phase=3):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    ms, plain_ms, lib_ms = event_ms(kern), event_ms(plain), event_ms(lib)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               nbytes=nbytes)
    print(f"phase {phase}: {name} at {shape}: kernel {ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
          f"{nbytes / ms / 1e6:.1f} GB/s, plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms", flush=True)
    return row


def phase_times_new(A, seed):
    """matvec_fused / rmatvec_fused at the main shape (f32, library
    torch.addmv) and sketch_matmat at gnystrom's three main-path calls
    (library: a CSR torch.sparse.mm); the sketch_matmat row is the mean
    over the three calls of one solve."""
    import torch
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch_matvec as skm
    m, n = A.shape
    g = torch.Generator(device=DEV).manual_seed(seed + 4)
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    alpha = torch.tensor([0.37], device=DEV)
    f = 4
    out = {
        "matvec_fused": time_row(
            "matvec_fused", lambda: gs.matvec_fused(A, p, ym, alpha),
            lambda: ref.matvec_fused(A, p, ym, alpha),
            lambda: torch.addmv(ym, A, p, beta=-0.37),
            f * (m * n + n + m + 1 + m), 2 * m * n + 2 * m,
            f"({m}x{n}, f32)"),
        "rmatvec_fused": time_row(
            "rmatvec_fused", lambda: gs.rmatvec_fused(A, q, yn, 1.7),
            lambda: ref.rmatvec_fused(A, q, yn, 1.7),
            lambda: torch.addmv(yn, A.T, q, beta=-1.7),
            f * (m * n + m + n + 1 + n), 2 * m * n + 2 * n,
            f"({m}x{n}, f32)"),
    }
    k = SKETCH_SOLVES[0][1]["sketch_dim"]
    omega, psi = sketch_pack(g, n, k), sketch_pack(g, m, 2 * k)
    Y = skm.sketch_matmat(omega.signs, omega.idx, A.T).T     # (m, k) view
    calls = [("range: Omega^T A^T, A^T a view", omega, A.T),
             ("co-range: Psi^T A, row-major", psi, A),
             ("core: Psi^T Y, Y a view", psi, Y)]
    rows = []
    for label, sk, X in calls:
        d, zeta = sk.idx.shape
        N, b = X.shape
        rows_read = int(torch.unique(sk.idx).numel())  # this draw's rows
        nbytes = d * zeta * 8 + rows_read * b * f + d * b * f
        Tt = csr_transpose(sk)
        rows.append(time_row(
            f"sketch_matmat {label}",
            lambda sk=sk, X=X: skm.sketch_matmat(sk.signs, sk.idx, X),
            lambda sk=sk, X=X: ref.sketch_matmat(sk.signs, sk.idx, X),
            lambda Tt=Tt, X=X: torch.sparse.mm(Tt, X),
            nbytes, 2 * d * zeta * b, f"(X {N}x{b}, d={d}, f32)"))
    mean = {key: sum(r[key] for r in rows) / len(rows)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    mean["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                      for r in rows) else "operations"
    out["sketch_matmat"] = mean
    print(f"phase 3: sketch_matmat per launch over one gnystrom solve "
          f"(mean of the three calls): kernel {mean['ms']:.4f} ms, bound "
          f"{mean['bound_ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms, "
          f"library {mean['library_ms']:.4f} ms", flush=True)
    return out


def phase_f64(seed, m, n):
    """The float64 leg: matvec_fused / rmatvec_fused against their plain
    versions on an f64 operand of numerical rank 100, then its F-SVD with
    backend="pallas", every half-step through them, and both kernels
    timed there.  Returns (launches, max abs errors, times)."""
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref
    A, s_true = make_operand(seed + 5, m, n, dtype=torch.float64)
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    errs = check_matvecs(gen, m, n, torch.float64, A=A)
    print(f"phase 5: matvec_fused / rmatvec_fused on the f64 {m}x{n} "
          f"operand match the plain versions, bitwise stable; max abs err "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")
    gs.reset_launches()
    fact, wall = timed(lambda: factorize(
        A, spec, generator=torch.Generator(device=DEV).manual_seed(seed)))
    k = MAX_ITERS
    want = dict(dict.fromkeys(gs.LAUNCHES, 0), matvec_fused=k,
                rmatvec_fused=k - 1)
    check(gs.LAUNCHES == want, f"f64 launch counts {gs.LAUNCHES} != {want}")
    launches = {name: gs.LAUNCHES[name] for name in MATVECS}
    err = float((fact.s - s_true[:R_WANT]).abs().max()) / float(s_true[0])
    print(f"phase 5: fsvd f64 {m}x{n} ({A.numel() * 8 / 1e9:.2f} GB) wall "
          f"{wall:.3f} s, iterations {int(fact.iterations)}, breakdown "
          f"{bool(fact.breakdown)}, max|sigma - sigma_true|/sigma_max "
          f"{err:.3e} (bound {FSVD_STOL}), launches {launches}", flush=True)
    check(err < FSVD_STOL, f"f64 fsvd sigma error {err:.3e}")
    g = torch.Generator(device=DEV).manual_seed(seed + 7)
    p = torch.randn(n, generator=g, device=DEV)
    q = torch.randn(m, generator=g, device=DEV)
    ym = torch.randn(m, generator=g, device=DEV)
    yn = torch.randn(n, generator=g, device=DEV)
    pd, qd, ymd, ynd = p.double(), q.double(), ym.double(), yn.double()
    shape = f"({m}x{n}, f64 A; library in f64)"
    times = {
        "matvec_fused": time_row(
            "matvec_fused", lambda: gs.matvec_fused(A, p, ym, 0.37),
            lambda: ref.matvec_fused(A, p, ym, 0.37),
            lambda: torch.addmv(ymd, A, pd, beta=-0.37),
            8 * m * n + 4 * (n + 2 * m + 1), 2 * m * n + 2 * m, shape,
            phase=5),
        "rmatvec_fused": time_row(
            "rmatvec_fused", lambda: gs.rmatvec_fused(A, q, yn, 1.7),
            lambda: ref.rmatvec_fused(A, q, yn, 1.7),
            lambda: torch.addmv(ynd, A.T, qd, beta=-1.7),
            8 * m * n + 4 * (m + 2 * n + 1), 2 * m * n + 2 * n, shape,
            phase=5),
    }
    return launches, errs, times


# --- slice 3: sparse_matvec and lowrank_matmul ----------------------------

def sparse_coo(gen, m, n, density):
    """COO triplets of a random (m, n) matrix on the card: Bernoulli
    entries, the first two rows empty, entry 0 duplicated, and a shuffled
    entry order; int32 indices."""
    import torch
    A = torch.randn(m, n, generator=gen, device=DEV)
    A = A * (torch.rand(m, n, generator=gen, device=DEV) < density)
    A[:2] = 0
    idx = torch.nonzero(A)
    idx = torch.cat([idx, idx[:1]])
    idx = idx[torch.randperm(idx.shape[0], generator=gen, device=DEV)]
    return A[idx[:, 0], idx[:, 1]], idx.to(torch.int32)


def check_spmv(tag, vals, cols, X):
    """sparse_matvec against its plain version (bf16 values are widened
    exactly, so f32 bounds hold); returns the max abs error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_matvec as spm
    name = f"sparse_matvec {tag}"
    got = bitwise_twice(name, lambda: (spm.sparse_matvec(vals, cols, X),))
    err = compare(name, got, (ref.sparse_matvec(vals, cols, X),),
                  (torch.float32,))
    torch.cuda.synchronize()
    return err


def check_lowrank(tag, U, s, Vt):
    import torch
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import ref
    name = f"lowrank_matmul {tag}"
    got = bitwise_twice(name, lambda: (klu.lowrank_matmul(U, s, Vt),))
    err = compare(name, got, (ref.lowrank_matmul(U, s, Vt),),
                  (torch.float32,))
    torch.cuda.synchronize()
    return err


def phase_slice3_kernels(gen):
    """Phase 2 rows of sparse_matvec and lowrank_matmul on the shapes of
    tests/test_kernels.py (their main-path shapes come in phases 3b/6)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sparse_matvec as spm
    n_cases = 0
    for m, n, density in SPARSE_SHAPES:
        data, idx = sparse_coo(gen, m, n, density)
        for vdt in (torch.float32, torch.bfloat16):
            for shape, ix in (((m, n), idx), ((n, m), idx.flip(1))):
                vals, cols = spm.ell_pack(data.to(vdt), ix, shape)
                for b in (1, 20):
                    X = torch.randn(shape[1], b, generator=gen, device=DEV)
                    X = X[:, 0].contiguous() if b == 1 else X
                    check_spmv(f"({shape[0]}x{shape[1]}, b={b}, {vdt})",
                               vals, cols, X)
                    n_cases += 1
    # tests/test_kernels.py:232-242: empty rows and duplicates, exactly
    data = torch.tensor([1.0, 2.0, 3.0, 4.0], device=DEV)
    idx = torch.tensor([[0, 1], [0, 1], [3, 0], [3, 2]], dtype=torch.int32,
                       device=DEV)
    vals, cols = spm.ell_pack(data, idx, (5, 3))
    y = kops.sparse_matvec(vals, cols, torch.tensor([1.0, 10.0, 100.0],
                                                    device=DEV))
    check(y.tolist() == [30.0, 0.0, 0.0, 403.0, 0.0],
          f"sparse_matvec empty rows / duplicates gave {y.tolist()}")
    for m, n, r in LOWRANK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            U = torch.randn(m, r, generator=gen, device=DEV).to(dt)
            sv = torch.rand(r, generator=gen, device=DEV) + 0.5
            Vt = torch.randn(r, n, generator=gen, device=DEV).to(dt)
            check_lowrank(f"({m}x{n}, r={r}, {dt})", U, sv, Vt)
            check_lowrank(f"({m}x{n}, r={r}, {dt}, Vt a view)", U, sv,
                          Vt.T.contiguous().T)
            n_cases += 2
    print(f"phase 2: {n_cases + 1} shape/type cases of sparse_matvec (both "
          f"packs, b = 1 and 20, f32/bf16 values, empty rows and "
          f"duplicates) and lowrank_matmul (f32/bf16, row-major and "
          f"transposed-view Vt) match the plain versions, bitwise stable",
          flush=True)


# --- slice 4: the reorth pair and scatter_add ------------------------------

def check_reorth(tag, Q, v, c):
    """qtv, subtract_qc and ops.reorth (passes 1, 2) on one basis against
    their plain versions (rtol 1e-5 in f32, 3e-2 with a bf16 basis),
    each twice bitwise; returns {kernel: max abs error}."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import reorth as kro
    dts = (Q.dtype,)
    errs = {}
    for name, kern, plain in (
            ("qtv", lambda: (kro.qtv(Q, v),), lambda: (ref.qtv(Q, v),)),
            ("subtract_qc", lambda: (kro.subtract_qc(v, Q, c),),
             lambda: (ref.subtract_qc(v, Q, c),))):
        got = bitwise_twice(f"{name} {tag}", kern)
        errs[name] = compare(f"{name} {tag}", got, plain(), dts)
    for passes in (1, 2):
        got = bitwise_twice(f"reorth p={passes} {tag}",
                            lambda: (kops.reorth(v, Q, passes),))
        compare(f"reorth p={passes} {tag}", got,
                (ref.reorth(v, Q, passes),), dts)
    torch.cuda.synchronize()
    return errs


def check_scatter(tag, rows, cols, vals, shape):
    """scatter_add twice (bitwise) against its plain version on the CPU,
    bit for bit: the kernel sums every cell in entry order, as index_add_
    does there.  Returns the panel."""
    import torch
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ref
    name = f"scatter_add {tag}"
    got = bitwise_twice(name, lambda: (kcs.scatter_add(rows, cols, vals,
                                                       shape),))[0]
    want = ref.scatter_add(rows.cpu(), cols.cpu(), vals.cpu(), shape)
    err = float((got.cpu() - want).abs().max()) if want.numel() else 0.0
    check(torch.equal(got.cpu(), want),
          f"{name}: differs from the CPU plain version (max abs {err:.3e})")
    return got


def phase_slice4_kernels(gen):
    """Phase 2 rows of qtv / subtract_qc / ops.reorth and scatter_add on
    the shapes of tests/test_kernels.py (their main-path shapes come in
    phases 6 and 7)."""
    import torch
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    n_cases = 0
    for m, k in REORTH_SHAPES:
        for qdt in (torch.float32, torch.bfloat16):
            Q = torch.linalg.qr(torch.randn(m, k, generator=gen,
                                            device=DEV))[0]
            Q = Q.to(qdt).contiguous()
            v = torch.randn(m, generator=gen, device=DEV)
            c = torch.randn(k, generator=gen, device=DEV)
            check_reorth(f"({m}x{k}, {qdt})", Q, v, c)
            n_cases += 1

    def stream(E, m, d):
        rows = torch.randint(0, m, (E,), generator=gen, device=DEV,
                             dtype=torch.int32)
        cols = torch.randint(0, d, (E,), generator=gen, device=DEV,
                             dtype=torch.int32)
        return rows, cols, torch.randn(E, generator=gen, device=DEV)

    for E, m, d in SCATTER_SHAPES:
        check_scatter(f"({E} entries, {m}x{d})", *stream(E, m, d), (m, d))
        n_cases += 1
    # tests/test_kernels.py:324-340: forced duplicates, dyadic values
    t = lambda x, dt: torch.tensor(x, dtype=dt, device=DEV)  # noqa: E731
    i32, f32 = torch.int32, torch.float32
    got = check_scatter(
        "dyadic duplicates", t([3, 3, 3, 0, 3, 1, 1], i32),
        t([1, 1, 1, 0, 1, 2, 2], i32),
        t([0.25, 0.5, 1.25, -2.0, -0.75, 8.0, -8.0], f32), (5, 4))
    check((got[3, 1].item(), got[1, 2].item(), got[0, 0].item())
          == (1.25, 0.0, -2.0), "scatter_add dyadic duplicates gave "
          f"{got.tolist()}")
    # :343-357: the empty stream (no launch) and an all-at-(0, 0) stream
    empty = torch.zeros(0, dtype=i32, device=DEV)
    kcs.reset_launches()
    z = kops.scatter_add(empty, empty, torch.zeros(0, device=DEV), (4, 6))
    check(kcs.LAUNCHES["scatter_add"] == 0 and not z.any()
          and z.shape == (4, 6), "scatter_add of an empty stream")
    zeros = torch.zeros(200, dtype=i32, device=DEV)
    got = check_scatter("all at (0, 0)", zeros, zeros,
                        torch.ones(200, device=DEV), (3, 3))
    check(got[0, 0].item() == 200.0 and got.abs().sum().item() == 200.0,
          f"scatter_add all at (0, 0) gave {got.tolist()}")
    # coordinates outside the panel (past the end, negative) are dropped
    got = check_scatter(
        "outside the panel", t([0, 2, 5, 1, -1, 3, 1], i32),
        t([0, 3, 0, 4, 1, -2, 1], i32),
        t([1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 0.5], f32), (4, 4))
    want = torch.zeros(4, 4)
    want[0, 0], want[2, 3], want[1, 1] = 1.0, 2.0, 0.5
    check(torch.equal(got.cpu(), want),
          f"scatter_add kept a coordinate outside the panel: {got.tolist()}")
    E, m, d = SCATTER_GAUSSIAN
    rows, cols, vals = stream(E, m, d)
    check_scatter(f"Gaussian ({E} entries, {m}x{d})", rows, cols, vals,
                  (m, d))
    n_cases += 5
    # the binning (steps 1-4) against its plain model, bins of many tiles
    widths = set()
    for E2, m2, d2, bits in BIN_SHAPES:
        r2, c2, v2 = (x.to(dt) for x, dt in zip(
            stream(E2, m2 + 2, d2 + 2), (i32, i32, torch.float64)))
        plan = kcs.bin_plan(E2, (m2, d2), bits)
        got = kcs.bin_entries(r2, c2, v2, plan)
        want = ref.bin_entries(r2.cpu(), c2.cpu(), v2.cpu(), (m2, d2),
                               plan.part_bits)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"bin_entries ({E2} entries, {m2}x{d2}, bins of 2^"
              f"{plan.bin_bits} cells in parts of 2^{plan.part_bits}) "
              f"differs from its plain model")
        widths.add(1 << (plan.bin_bits - plan.tile_bits))
        n_cases += 1
    check(widths == {1, 8, 128}, f"the binning cases took bins of {widths} "
                                 f"tiles")
    # skew: the Gaussian stream's values all into one tile, then one cell;
    # each timed beside the sorted path of the previous design
    def times(r, c):
        return (event_ms(lambda: kcs.scatter_add(r, c, vals, (m, d)), reps=3),
                event_ms(lambda: kcs.segment_sum(
                    *kcs.sort_keys(r, c, (m, d)), vals, (m, d)), reps=3))

    t_spread = times(rows, cols)
    corner = torch.randint(0, 3, (E,), generator=gen, device=DEV, dtype=i32)
    check_scatter(f"{E} entries in a 3x3 corner", corner, corner.flip(0),
                  vals, (m, d))
    t_corner = times(corner, corner.flip(0))
    zeros = torch.zeros(E, dtype=i32, device=DEV)
    check_scatter(f"{E} entries at (0, 0)", zeros, zeros, vals, (m, d))
    t_cell = times(zeros, zeros)
    n_cases += 2
    print(f"phase 2: {n_cases} shape/type cases of qtv / subtract_qc / "
          f"ops.reorth (f32 and bf16 bases, passes 1 and 2), scatter_add "
          f"(dyadic duplicates, empty, all at (0, 0), outside the panel, a "
          f"{E}-entry Gaussian stream, the same into a 3x3 corner and into "
          f"one cell) and the binning into bins of {sorted(widths)} tiles "
          f"match the "
          f"plain versions, scatter_add bit for bit against the CPU, "
          f"bitwise stable; scatter_add of the {E}-entry stream spread over "
          f"{m}x{d} {t_spread[0]:.4f} ms, in a 3x3 corner (one tile) "
          f"{t_corner[0]:.4f} ms, in one cell {t_cell[0]:.4f} ms; the "
          f"sorted path of the previous design {t_spread[1]:.4f}, "
          f"{t_corner[1]:.4f} and {t_cell[1]:.4f} ms", flush=True)


def exact_update_sigma(fact, C, sd, Dt, beta):
    """sigma of beta U S V^T + C diag(sd) Dt, independently in f64: the
    Householder QRs of [U | C] and [V | Dt^T], then svdvals of the small
    core."""
    import torch
    Ra = torch.linalg.qr(torch.cat([fact.U, C], 1).double())[1]
    Rb = torch.linalg.qr(torch.cat([fact.V, Dt.T], 1).double())[1]
    core = torch.cat([beta * fact.s.double(), sd.double()])
    return torch.linalg.svdvals(Ra @ torch.diag(core) @ Rb.T)


def orthonormal_bases(fact):
    """The same operator U S V^T with bases orthonormal to f32 rounding:
    U = Q_U R_U and V = Q_V R_V in f64, then the SVD of R_U S R_V^T (the
    update's precondition; the reference's update assumes it)."""
    import torch
    from repro_torch.api import Factorization
    Qu, Ru = torch.linalg.qr(fact.U.double())
    Qv, Rv = torch.linalg.qr(fact.V.double())
    X, sx, Yt = torch.linalg.svd(Ru @ torch.diag(fact.s.double()) @ Rv.T)
    return Factorization((Qu @ X).float(), sx.float(), (Qv @ Yt.T).float(),
                         fact.iterations, fact.breakdown, method=fact.method)


def defect(Q):
    """||Q^T Q - I||_2 in f64."""
    import torch
    G = Q.double().T @ Q.double()
    return float(torch.linalg.matrix_norm(
        G - torch.eye(G.shape[0], dtype=G.dtype, device=G.device), ord=2))


def update_with_inputs(f, delta, beta):
    """update_factorization(backend="pallas") of f by delta, timed, with
    the launch count and the arguments its one lowrank_matmul launch was
    given (the core's Chat, ones and the transposed view Dhat.T)."""
    from repro_torch.api import update_factorization
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import ops as kops
    seen = []
    real = kops.lowrank_matmul

    def spy(U, s, Vt):
        seen.append((U, s, Vt))
        return real(U, s, Vt)

    kops.lowrank_matmul = spy
    try:
        klu.reset_launches()
        upd, wall = timed(lambda: update_factorization(
            f, delta, beta=beta, backend="pallas"))
        launches = klu.LAUNCHES["lowrank_matmul"]
    finally:
        kops.lowrank_matmul = real
    return upd, wall, launches, seen


def update_in_f64(f, C, sd, Dt, beta):
    """The same update on the same bases, every step in float64 (the
    plain core product): what the f32 pallas run would give without its
    own rounding."""
    import torch
    from repro_torch.api import Factorization, LowRankOp, update_factorization
    f64 = Factorization(f.U.double(), f.s.double(), f.V.double(),
                        f.iterations, f.breakdown, method=f.method)
    return update_factorization(
        f64, LowRankOp(C.double(), sd.double(), Dt.double()), beta=beta,
        backend="xla").s.to(torch.float64)


def phase_update(fact, seed):
    """update_factorization of phase 3's r = 20 factorization by a seeded
    rank-10 drift.  The core product's kernel is held against its plain
    version on the arguments the update gave it.  The update assumes
    orthonormal bases, and the f32 fsvd's bases are not orthonormal to
    f32 rounding, so two runs are gated: on the raw bases against the same
    update in f64 on those bases (the port's own error), and on the bases
    orthonormalized in f64 against the exact sigma of beta U S V^T +
    C diag(s) Dt.  The raw run's distance from its exact sigma is printed
    beside the f64 run's (the precondition's share).  Returns (launches,
    wall seconds, sigma error of the raw run against f64, the drift)."""
    import torch
    from repro_torch.api import LowRankOp
    m, n = fact.shape
    smax = float(fact.s[0])
    g = torch.Generator(device=DEV).manual_seed(seed + 8)
    C = torch.randn(m, DELTA_RANK, generator=g, device=DEV) / m ** 0.5
    Dt = torch.randn(DELTA_RANK, n, generator=g, device=DEV) / n ** 0.5
    sd = 1e-2 * smax * torch.linspace(1.0, 0.5, DELTA_RANK, device=DEV)
    delta, beta = LowRankOp(C, sd, Dt), 0.9
    r = fact.rank
    errs = {}
    for name, f in (("raw", fact), ("orthonormal", orthonormal_bases(fact))):
        upd, wall, launches, seen = update_with_inputs(f, delta, beta)
        check(int(upd.iterations) == 0, "the update ran GK iterations")
        check(launches == 1, f"update launched lowrank_matmul {launches} "
                             f"times")
        (Uc, ones, Vc), = seen
        core_err = check_lowrank(
            f"update core ({Uc.shape[0]}x{Vc.shape[1]}, r={Uc.shape[1]}, "
            f"Vt a view {tuple(Vc.stride())})", Uc, ones, Vc)
        s_exact = exact_update_sigma(f, C, sd, Dt, beta)
        s64 = update_in_f64(f, C, sd, Dt, beta)
        errs[name] = {
            "exact": float((upd.s.double() - s_exact[:r]).abs().max()
                           / s_exact[0]),
            "f64": float((upd.s.double() - s64).abs().max() / s_exact[0]),
            "f64_exact": float((s64 - s_exact[:r]).abs().max()
                               / s_exact[0])}
        e = errs[name]
        print(f"phase 3b: update_factorization ({name} bases: "
              f"||U^T U - I|| {defect(f.U):.3e}, ||V^T V - I|| "
              f"{defect(f.V):.3e}; r = {r}, rank-{DELTA_RANK} drift, beta "
              f"{beta}) wall {wall * 1e3:.3f} ms, iterations "
              f"{int(upd.iterations)}, lowrank_matmul launches {launches} "
              f"(core {tuple(Uc.shape)} x {tuple(Vc.shape)} matches its "
              f"plain version, max abs err {core_err:.3e}, bitwise "
              f"stable); max|sigma - .|/sigma_max: vs the f64 update on "
              f"the same bases {e['f64']:.3e}, vs exact {e['exact']:.3e} "
              f"(f64 update vs exact {e['f64_exact']:.3e})", flush=True)
    raw, orth = errs["raw"]["f64"], errs["orthonormal"]["exact"]
    print(f"phase 3b: gate {UPDATE_GATE}: raw bases vs the f64 update "
          f"{raw:.3e}, orthonormal bases vs exact {orth:.3e}", flush=True)
    check(raw < UPDATE_GATE, f"update sigma error vs f64 {raw:.3e}")
    check(orth < UPDATE_GATE, f"update sigma error vs exact {orth:.3e}")
    return launches, wall, raw, delta


def phase_materialize(seed, m, n):
    """materialize_lowrank of a rank-20 LowRankOp at (m, n) through the
    kernel, held against the plain version by row blocks (no second
    (m, n) buffer), then timed beside its bound, the plain version and
    torch.matmul(U*s, Vt).  Returns (launches, max abs error, times)."""
    import torch
    from repro_torch.api import LowRankOp
    from repro_torch.core.update import materialize_lowrank
    from repro_torch.kernels import lowrank_update as klu
    from repro_torch.kernels import ref
    g = torch.Generator(device=DEV).manual_seed(seed + 10)
    r = R_WANT
    U = torch.randn(m, r, generator=g, device=DEV)
    sv = torch.rand(r, generator=g, device=DEV) + 0.5
    Vt = torch.randn(r, n, generator=g, device=DEV)
    delta = LowRankOp(U, sv, Vt)
    klu.reset_launches()
    W, wall = timed(lambda: materialize_lowrank(delta, backend="pallas"))
    launches = klu.LAUNCHES["lowrank_matmul"]
    check(launches == 1, f"materialize launched lowrank_matmul {launches}")
    rows = 1 << 13
    err = 0.0
    for r0 in range(0, m, rows):
        err = max(err, compare(f"materialize_lowrank rows {r0}+",
                               (W[r0:r0 + rows],),
                               (ref.lowrank_matmul(U[r0:r0 + rows], sv, Vt),),
                               (torch.float32,)))
    again = klu.lowrank_matmul(U, sv, Vt)
    check(torch.equal(W, again), "lowrank_matmul differs bitwise on a rerun")
    del W, again
    torch.cuda.empty_cache()
    print(f"phase 3c: materialize_lowrank {m}x{n} r = {r} "
          f"({m * n * 4 / 1e9:.1f} GB) wall {wall * 1e3:.3f} ms, launches "
          f"{launches}, matches the plain version by row blocks (max abs "
          f"err {err:.3e}), bitwise stable", flush=True)
    row = time_row("lowrank_matmul", lambda: klu.lowrank_matmul(U, sv, Vt),
                   lambda: ref.lowrank_matmul(U, sv, Vt),
                   lambda: torch.matmul(U * sv, Vt),
                   4 * (m * r + r + r * n + m * n), 2 * m * n * r,
                   f"({m}x{n}, r={r}, f32)", phase="3c")
    torch.cuda.empty_cache()
    return launches, err, row


# --- phase 7: the sketch-resident state ------------------------------------

def drift_stream(seed, m, n, norm_a):
    """The seeded rank-1 drift D = c u v^T on DRIFT_BLOCK rows x
    DRIFT_BLOCK columns (drawn without replacement), ||D||_F = DRIFT_MASS
    ||A||_F, as a COO stream: each coordinate twice, a Gaussian part a and
    D_ij - a, shuffled.  Returns (rows, cols, vals, u_full, v_full) with
    D = u_full v_full^T (c folded into u_full)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed + 15)
    b = DRIFT_BLOCK
    R = torch.randperm(m, generator=g, device=DEV)[:b]
    C = torch.randperm(n, generator=g, device=DEV)[:b]
    u = torch.randn(b, generator=g, device=DEV)
    v = torch.randn(b, generator=g, device=DEV)
    c = DRIFT_MASS * norm_a / (torch.linalg.vector_norm(u)
                               * torch.linalg.vector_norm(v))
    D = (c * u)[:, None] * v[None, :]
    a = torch.randn(b, b, generator=g, device=DEV) * (
        torch.linalg.vector_norm(D) / b)          # the drift's rms entry
    rows = R[:, None].expand(b, b).reshape(-1)
    cols = C[None, :].expand(b, b).reshape(-1)
    order = torch.randperm(2 * b * b, generator=g, device=DEV)
    rows = torch.cat([rows, rows])[order].to(torch.int32)
    cols = torch.cat([cols, cols])[order].to(torch.int32)
    vals = torch.cat([a.reshape(-1), (D - a).reshape(-1)])[order]
    u_full = torch.zeros(m, device=DEV).index_copy_(0, R, c * u)
    v_full = torch.zeros(n, device=DEV).index_copy_(0, C, v)
    return rows, cols, vals, u_full, v_full


def rel_fro(got, want):
    import torch
    d = torch.linalg.vector_norm(got.float() - want.float())
    return float(d / torch.linalg.vector_norm(want.float()))


def time_scatter(label, r, c, v, shape):
    """scatter_add on one stream: bit for bit against the CPU plain
    version, then timed against the sorted path of the previous design (in
    turns: sorted, binned, binned, sorted), the plain version on the card
    and index_add_, with each stage of its plan timed alone.  Returns the
    timing row, with the largest difference from the CPU under "err"."""
    import torch
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ref
    got = kcs.scatter_add(r, c, v, shape)
    want = ref.scatter_add(r.cpu(), c.cpu(), v.cpu(), shape)
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu(), want), f"scatter_add at the {label} "
                                        f"differs from the CPU plain "
                                        f"version by {err:.3e}")
    del got, want
    flat = r.long() * shape[1] + c.long()
    panel = torch.zeros(shape[0] * shape[1], device=DEV)
    nbytes = 12 * r.shape[0] + 4 * shape[0] * shape[1]

    def binned():
        return kcs.scatter_add(r, c, v, shape)

    def sorted_path():
        return kcs.segment_sum(*kcs.sort_keys(r, c, shape), v, shape)

    before = event_ms(sorted_path)
    row = time_row(
        f"scatter_add {label}", binned,
        lambda: ref.scatter_add(r, c, v, shape),
        lambda: panel.zero_().index_add_(0, flat, v),
        nbytes, r.shape[0], f"({r.shape[0]} entries -> {shape[0]}x"
        f"{shape[1]}, f32)", phase=7)
    row["ms"] = (row["ms"] + event_ms(binned)) / 2
    row["sorted_ms"] = (before + event_ms(sorted_path)) / 2
    del flat, panel
    plan = kcs.bin_plan(r.shape[0], shape)
    counts = kcs.count_bins(r, c, plan)
    incl = kcs.scan_counts(counts)
    pairs = kcs.scatter_bins(r, c, v, plan, counts, incl)
    stages = {
        "count_ms": event_ms(lambda: kcs.count_bins(r, c, plan)),
        "scan_ms": event_ms(lambda: kcs.scan_counts(counts)),
        "bin_ms": event_ms(
            lambda: kcs.scatter_bins(r, c, v, plan, counts, incl))}
    if plan.part_slices:
        # what step 4 buys: the tile sum over step 3's bins read whole
        whole = plan._replace(part_bits=plan.bin_bits, part_slices=0)
        stages["unsplit_sum_ms"] = event_ms(
            lambda: kcs.sum_tiles(pairs, incl, whole))

        def parts():
            pc = kcs.count_parts(pairs, incl, plan)
            pi = kcs.scan_counts(pc)
            return kcs.scatter_parts(pairs, incl, plan, pc, pi), pi

        stages["part_ms"] = event_ms(parts)
        pairs, incl = parts()
    stages["sum_ms"] = event_ms(lambda: kcs.sum_tiles(pairs, incl, plan))
    row["stages"] = stages
    print(f"phase 7: scatter_add {label}: binned {row['ms']:.4f} ms (mean "
          f"of two) against the sorted path's {row['sorted_ms']:.4f} ms "
          f"(torch.sort + segment sum, mean of two); stages "
          + ", ".join(f"{k} {t:.4f}" for k, t in stages.items())
          + f"; plan {plan.bins} bins of 2^{plan.bin_bits} cells, "
          f"{plan.slices} slices of {plan.slice_len}, "
          f"{plan.parts} parts a bin in {plan.part_slices} slices",
          flush=True)
    row["call"], row["err"] = label, err
    del counts, incl, pairs
    return row


def phase_sketchres(A, seed, peak3, drift):
    """Phase 7: the sketch-resident state on the main operand (edited in
    place).  Returns (scatter_add launches, max abs error, timing row)."""
    import torch
    from repro_torch import sketchres as sk
    from repro_torch.api import LowRankOp, SVDSpec
    from repro_torch.core.operators import DenseOp
    from repro_torch.kernels import count_sketch as kcs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    m, n = A.shape
    spec = SVDSpec(**SKETCHRES_FIELDS)
    M, N = operand_factors(seed, m, n)
    left, right = [M], [N.T]                # A = left right^T, in pieces

    def sketch(op):
        return sk.sketch_operand(op, spec, generator=torch.Generator(
            device=DEV).manual_seed(seed + 16))

    def exact():
        return factored_sigma(torch.cat(left, 1), torch.cat(right, 1))

    def check_state(label, st, wall):
        """Fresh sketch of the edited A (same seeds) against the folded
        panels, then reconstruct against the exact sigma."""
        fresh = sketch(DenseOp(A, backend="pallas"))
        check(fresh.seeds == st.seeds, "a re-sketch drew other seeds")
        eY, eZ = rel_fro(st.Y, fresh.Y), rel_fro(st.Z, fresh.Z)
        f, t_rec = timed(lambda: sk.reconstruct(st, spec))
        s_exact = exact()
        err = float((f.s.double() - s_exact[:R_WANT]).abs().max()
                    / s_exact[0])
        ratio = float(sk.staleness_ratio(st))
        print(f"phase 7: {label} wall {wall * 1e3:.3f} ms; folded vs fresh "
              f"sketch (same seeds) |dY|/|Y| {eY:.3e}, |dZ|/|Z| {eZ:.3e} "
              f"(bound {PANEL_BOUND}); reconstruct {t_rec * 1e3:.3f} ms, "
              f"iterations {int(f.iterations)}, method {f.method}, "
              f"max|sigma - sigma_exact|/sigma_max {err:.3e} (bound "
              f"{SKETCHRES_STOL}; the exact sigma of a rank <= "
              f"{s_exact.shape[0]} operand); "
              f"staleness {ratio:.4f}", flush=True)
        check(eY <= PANEL_BOUND and eZ <= PANEL_BOUND,
              f"{label}: folded panels {eY:.3e} / {eZ:.3e} from a fresh "
              f"sketch")
        check(int(f.iterations) == 0 and f.method == "sketch",
              f"{label}: reconstruct gave {int(f.iterations)} iterations, "
              f"method {f.method}")
        check(err < SKETCHRES_STOL, f"{label}: sigma error {err:.3e}")
        check(not bool(sk.is_stale(st)), f"{label}: stale at {ratio:.4f}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    guard = counting_op(DenseOp(A, backend="pallas"))
    st, t_sketch = timed(lambda: sketch(guard))
    touches = {k: v for k, v in guard.counts.items() if v}
    k, l = st.panel_dims
    print(f"phase 7: sketch_operand {m}x{n} (k = {k}, l = {l}; Y "
          f"{st.Y.numel() * 4 / 1e6:.1f} MB, Z {st.Z.numel() * 4 / 1e6:.1f} "
          f"MB) wall {t_sketch:.3f} s, operator touches {touches}, "
          f"base_norm {float(st.base_norm):.4e}", flush=True)
    check(touches == {"sketch_pass": 1}, f"sketch_operand touched {touches}")

    rows, cols, vals, u_full, v_full = drift_stream(
        seed, m, n, float(torch.linalg.vector_norm(exact())))
    E = rows.shape[0]
    seen = []
    real = kops.scatter_add

    def spy(r, c, v, shape):
        seen.append((r, c, v, shape))
        return real(r, c, v, shape)

    kops.scatter_add = spy
    try:
        kcs.reset_launches()
        folded, t_fold = timed(lambda: sk.apply_entries(st, rows, cols,
                                                        vals))
        launches = kcs.LAUNCHES["scatter_add"]
    finally:
        kops.scatter_add = real
    check(launches == 2, f"apply_entries launched scatter_add {launches} "
                         f"times, not 2")
    again = sk.apply_entries(st, rows, cols, vals)
    check(torch.equal(folded.Y, again.Y) and torch.equal(folded.Z, again.Z),
          "apply_entries differs bitwise on a rerun")
    del again
    print(f"phase 7: apply_entries of {E} entries (a rank-1 drift on "
          f"{DRIFT_BLOCK}x{DRIFT_BLOCK} coordinates, each sent twice) -> "
          f"{[x[0].shape[0] for x in seen]} expanded entries into panels "
          f"{[x[3] for x in seen]}: scatter_add launches {launches}, panels "
          f"bitwise equal on a rerun", flush=True)
    A.index_put_((rows.long(), cols.long()), vals, accumulate=True)
    left.append(u_full[:, None])
    right.append(v_full[:, None])
    check_state("entry fold", folded, t_fold)

    Cd, sd, Dt = drift.U, drift.s, drift.Vt
    st2, t_lr = timed(lambda: sk.apply_lowrank_delta(
        folded, LowRankOp(Cd, sd, Dt)))
    W = Cd * sd
    for r0 in range(0, m, 1 << 13):
        A[r0:r0 + (1 << 13)].addmm_(W[r0:r0 + (1 << 13)], Dt)
    left.append(W)
    right.append(Dt.T)
    check_state(f"low-rank fold (rank {Dt.shape[0]})", st2, t_lr)

    target = (st2.budget * st2.base_norm).reshape(1)
    zero = torch.zeros(1, dtype=torch.int32, device=DEV)
    st3 = sk.apply_entries(st2, zero, zero, target)
    ratio = float(sk.staleness_ratio(st3))
    print(f"phase 7: odometer: a one-entry fold of budget * base_norm "
          f"({float(target):.4e}) takes staleness to {ratio:.4f}, stale "
          f"{bool(sk.is_stale(st3))}", flush=True)
    check(bool(sk.is_stale(st3)), "the budget fold did not trip is_stale")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 7: peak device memory {peak / GIB:.2f} GiB (phase 3 "
          f"{peak3 / GIB:.2f} GiB + 2 GiB)", flush=True)
    check(peak < peak3 + 2 * GIB,
          f"phase 7 peak {peak / GIB:.2f} GiB: a copy of the operand?")
    del st, folded, st2, st3, M, N, left, right

    errs, rows_t = [], []
    for (r, c, v, shape), label in zip(seen, ("Y fold", "Z fold")):
        row = time_scatter(label, r, c, v, shape)
        errs.append(row.pop("err"))
        rows_t.append(row)
    # wider panels than the phase-7 folds: bins of 8 and of 64 tiles
    g = torch.Generator(device=DEV).manual_seed(seed + 17)
    wide = []
    E = seen[0][0].shape[0]             # as many entries as the Y fold
    for label, shape in WIDE_FOLDS:
        r = torch.randint(0, shape[0], (E,), generator=g, device=DEV,
                          dtype=torch.int32)
        c = torch.randint(0, shape[1], (E,), generator=g, device=DEV,
                          dtype=torch.int32)
        v = torch.randn(E, generator=g, device=DEV)
        row = time_scatter(label, r, c, v, shape)
        errs.append(row.pop("err"))
        wide.append(row)
        del r, c, v
        torch.cuda.empty_cache()
    out = {key: sum(r[key] for r in rows_t) / len(rows_t)
           for key in ("ms", "sorted_ms", "plain_ms", "library_ms",
                       "bound_ms")}
    out["bound_by"] = "bytes"
    keys = ("call", "ms", "sorted_ms", "stages", "plain_ms", "library_ms",
            "bound_ms")
    out["calls"] = [{k: r[k] for k in keys} for r in rows_t]
    out["wide"] = [{k: r[k] for k in keys} for r in wide]
    del seen
    torch.cuda.empty_cache()
    return launches, max(errs), out


def netflix_operand(seed, m, n):
    """COO triplets (on the card, int32 indices) of a row- and column-
    permuted block diagonal: block k of RANK joins ~m/RANK users and
    ~n/RANK movies as the rank-1 c_k m_k n_k^T (Gaussian m, n; c_k in
    [0.5, 1]).
    Returns (data, indices, exact sigma descending in f64)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed + 9)
    rp = torch.randperm(m, generator=g, device=DEV)
    cp = torch.randperm(n, generator=g, device=DEV)
    rb = torch.arange(m, device=DEV) * RANK // m     # block of row position
    cb = torch.arange(n, device=DEV) * RANK // n
    col_cnt = torch.bincount(cb, minlength=RANK)
    col_start = torch.cumsum(col_cnt, 0) - col_cnt
    per_row = col_cnt[rb]
    j = torch.repeat_interleave(torch.arange(m, device=DEV), per_row)
    first = torch.cumsum(per_row, 0) - per_row
    cpos = col_start[rb[j]] + (torch.arange(j.shape[0], device=DEV)
                               - first[j])
    mv = torch.randn(m, generator=g, device=DEV)
    nv = torch.randn(n, generator=g, device=DEV)
    c = 0.5 + 0.5 * torch.rand(RANK, generator=g, device=DEV)
    data = c[rb[j]] * mv[j] * nv[cpos]
    idx = torch.stack([rp[j], cp[cpos]], 1).to(torch.int32)
    del j, cpos, first
    nm = torch.zeros(RANK, dtype=torch.float64, device=DEV).index_add_(
        0, rb, mv.double() ** 2)
    nn = torch.zeros(RANK, dtype=torch.float64, device=DEV).index_add_(
        0, cb, nv.double() ** 2)
    s_true = torch.sort(c.double() * nm.sqrt() * nn.sqrt(),
                        descending=True).values
    return data, idx, s_true


def csr_of_pack(vals, cols):
    """The (rows, L) ELL pack as a CSR tensor (columns sorted in each row;
    the padding slots stay as explicit zeros) for the library yardstick."""
    import torch
    rows, L = cols.shape
    c, order = torch.sort(cols.long(), dim=1)
    v = torch.gather(vals.float(), 1, order)
    crow = torch.arange(0, rows * L + 1, L, device=DEV)
    with warnings.catch_warnings():       # "CSR support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, c.reshape(-1), v.reshape(-1),
                                       size=(rows, int(cols.max()) + 1),
                                       check_invariants=False)


def phase_reorth(S, seed):
    """Phase 6, the reorthogonalization pair on the sparse operand's
    Lanczos basis Q (gk_bidiag at k = LANCZOS_K).  Returns ({kernel:
    launches}, {kernel: max abs error}, {kernel: timing row})."""
    import torch
    from repro_torch.core.gk import gk_bidiag
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import reorth as kro
    m, n = S.shape
    res, wall = timed(lambda: gk_bidiag(
        S, LANCZOS_K, generator=torch.Generator(device=DEV).manual_seed(
            seed + 13)))
    Q = res.Q
    g = torch.Generator(device=DEV).manual_seed(seed + 14)
    v = S.mv(torch.randn(n, generator=g, device=DEV))          # A p
    kro.reset_launches()
    w = kops.reorth(v, Q, 2)
    launches = dict(kro.LAUNCHES)
    check(launches == {"qtv": 2, "subtract_qc": 2},
          f"ops.reorth(passes=2) launched {launches}")
    check(torch.equal(w, kops.reorth(v, Q, 2)),
          "ops.reorth differs bitwise on a rerun")
    # A p lies in the range that the basis spans (rank 100, breakdown near
    # 105), so w is the roundoff remainder of v: the kernel and the plain
    # version are held to 1e-5 max|v| there, not to 1e-5 max|w|
    vmax, vn = float(v.abs().max()), float(torch.linalg.vector_norm(v))
    err_ap = float((w - ref.reorth(v, Q, 2)).abs().max())
    check(err_ap <= 1e-5 * vmax, f"ops.reorth(A p) differs from its plain "
                                 f"version by {err_ap:.3e} (max|v| {vmax:.3e})")
    ortho = float(torch.mv(Q.T, w).abs().max())
    check(ortho < REORTH_BOUND * vn, f"max|Q^T w| {ortho:.3e} >= "
                                     f"{REORTH_BOUND} ||v|| ({vn:.3e})")
    # a Gaussian vector has a remainder of its own size: the usual bounds
    x = torch.randn(m, generator=g, device=DEV)
    Qh = Q.to(torch.bfloat16)
    k = Q.shape[1]
    errs = check_reorth(f"Lanczos basis ({m}x{k}, f32)", Q, x,
                        kro.qtv(Q, x))
    check_reorth(f"Lanczos basis ({m}x{k}, bf16)", Qh, x, kro.qtv(Qh, x))
    errs = {name: max(e, err_ap) for name, e in errs.items()}
    print(f"phase 6: Lanczos basis {m}x{k} f32 ({Q.numel() * 4 / 1e6:.1f} "
          f"MB) from gk_bidiag in {wall:.3f} s (iterations "
          f"{int(res.kprime)}); ops.reorth(A p, Q, 2) launches {launches}, "
          f"vs plain {err_ap:.3e} (max|v| {vmax:.3e}), max|Q^T w| "
          f"{ortho:.3e} < {REORTH_BOUND} ||v|| = {REORTH_BOUND * vn:.3e}; "
          f"qtv / subtract_qc / reorth on a Gaussian vector match the "
          f"plain versions (f32 and bf16 basis), bitwise stable", flush=True)
    rows = {"qtv": [], "subtract_qc": []}
    for label, B in (("f32", Q), ("bf16", Qh)):
        eb, mk = B.element_size(), B.numel()
        c = ref.qtv(B, v)
        # the library calls take one dtype: in bf16 they multiply in bf16
        vb, cb = v.to(B.dtype), c.to(B.dtype)
        shape = f"(Q {m}x{k} {label}, f32 vectors)"
        row = time_row(f"qtv {label}", lambda B=B: kro.qtv(B, v),
                       lambda B=B: ref.qtv(B, v),
                       lambda B=B, vb=vb: torch.mv(B.T, vb),
                       eb * mk + 4 * (m + k), 2 * mk, shape, phase=6)
        rows["qtv"].append(dict(row, call=label))
        row = time_row(f"subtract_qc {label}",
                       lambda B=B, c=c: kro.subtract_qc(v, B, c),
                       lambda B=B, c=c: ref.subtract_qc(v, B, c),
                       lambda B=B, vb=vb, cb=cb: torch.addmv(vb, B, cb,
                                                             alpha=-1),
                       eb * mk + 4 * (2 * m + k), 2 * mk, shape, phase=6)
        rows["subtract_qc"].append(dict(row, call=label))
    times = {}
    for name, calls in rows.items():
        times[name] = {key: calls[0][key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")}
        times[name]["calls"] = [{key: r[key] for key in
                                 ("call", "ms", "plain_ms", "library_ms",
                                  "bound_ms")} for r in calls]
    return launches, errs, times


def phase_sparse(seed, m, n):
    """Phase 6: the sparse operand.  Returns (launches, max abs error,
    timing row) of sparse_matvec and phase_reorth's results."""
    import torch
    from repro_torch.api import SVDSpec, estimate_rank, factorize
    from repro_torch.core.operators import SparseOp
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_matvec as spm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (data, idx, s_true), t_coo = timed(
        lambda: netflix_operand(seed, m, n))
    nnz = data.shape[0]
    S, t_pack = timed(lambda: SparseOp.from_coo(data, idx, (m, n),
                                                backend="pallas"))
    peak_build = torch.cuda.max_memory_allocated()
    packs = {"forward": (S.ell[0], S.ell[1], n),
             "transposed": (S.ell[2], S.ell[3], m)}
    desc = ", ".join(f"{k} {v.shape[0]} rows x L {v.shape[1]} (fill "
                     f"{nnz / v.numel():.4f})" for k, (v, _, _)
                     in packs.items())
    print(f"phase 6: sparse operand {m}x{n}, {RANK} rank-1 blocks, nnz "
          f"{nnz} (density {nnz / (m * n):.3e}), COO on the card in "
          f"{t_coo:.3f} s, both ELL packs in {t_pack:.3f} s: {desc}; peak "
          f"{peak_build / GIB:.2f} GiB while building (one dense f32 copy: "
          f"{m * n * 4 / GIB:.1f} GiB)", flush=True)
    err = 0.0
    gen = torch.Generator(device=DEV).manual_seed(seed + 11)
    for name, (vals, cols, nx) in packs.items():
        for vdt in (torch.float32, torch.bfloat16):
            v = vals if vdt == torch.float32 else vals.to(vdt)
            for b in (1, 20):
                X = torch.randn(nx, b, generator=gen, device=DEV)
                X = X[:, 0].contiguous() if b == 1 else X
                e = check_spmv(f"cell {name} b={b} {vdt}", v, cols, X)
                if vdt == torch.float32:
                    err = max(err, e)
    print(f"phase 6: sparse_matvec matches its plain version on both packs "
          f"(b = 1 and 20, f32 and bf16 values), bitwise stable; max abs "
          f"err (f32) {err:.3e}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    smax = float(s_true[0])
    spec = SVDSpec(method="fsvd", rank=R_WANT, max_iters=MAX_ITERS,
                   backend="pallas")

    def gen_f():
        return torch.Generator(device=DEV).manual_seed(seed + 12)

    guard = counting_op(S)
    spm.reset_launches()
    fact, wall = timed(lambda: factorize(guard, spec, generator=gen_f()))
    launches = spm.LAUNCHES["sparse_matvec"]
    k = MAX_ITERS
    touches = {kk: v for kk, v in guard.counts.items() if v}
    ferr = float((fact.s.double() - s_true[:R_WANT]).abs().max()) / smax
    print(f"phase 6: fsvd wall {wall:.3f} s, iterations "
          f"{int(fact.iterations)}, breakdown {bool(fact.breakdown)}, "
          f"max|sigma - sigma_true|/sigma_max {ferr:.3e} (bound "
          f"{SPARSE_STOL}), sparse_matvec launches {launches} (touches "
          f"{touches})", flush=True)
    check(touches == {"mv": k, "rmv": k, "matmat": 1},
          f"fsvd touched the sparse operand {touches}")
    check(launches == 2 * k + 1, f"fsvd launched sparse_matvec {launches} "
                                 f"times, not {2 * k + 1}")
    check(ferr < SPARSE_STOL, f"sparse fsvd sigma error {ferr:.3e}")
    again, wall2 = timed(lambda: factorize(S, spec, generator=gen_f()))
    check(torch.equal(fact.s, again.s), "sparse fsvd sigma differs bitwise "
                                        "on a rerun")
    print(f"phase 6: fsvd rerun wall {wall2:.3f} s, sigma bitwise equal",
          flush=True)

    auto_spec = SVDSpec(method="auto", rank=R_WANT, backend="pallas")
    spm.reset_launches()
    auto, wall3 = timed(lambda: factorize(S, auto_spec, generator=gen_f()))
    auto_launches = spm.LAUNCHES["sparse_matvec"]
    aerr = float((auto.s.double() - s_true[:R_WANT]).abs().max()) / smax
    # the same solve behind a counting wrapper (which "auto" would not
    # see as sparse): each block product must be one launch
    guard = counting_op(S)
    spm.reset_launches()
    counted = factorize(guard, auto_spec.replace(method=auto.method),
                        generator=gen_f())
    touches = sum(guard.counts.values())
    print(f"phase 6: auto -> {auto.method} wall {wall3:.3f} s, block passes "
          f"{int(auto.iterations)}, sigma error {aerr:.3e} (bound "
          f"{SPARSE_STOL}), sparse_matvec launches {auto_launches} for "
          f"{touches} operator products", flush=True)
    check(auto.method == "fsvd_blocked", f"auto picked {auto.method}")
    check(auto_launches == spm.LAUNCHES["sparse_matvec"] == touches,
          "a block product was not one sparse_matvec launch")
    check(torch.equal(auto.s, counted.s), "fsvd_blocked sigma differs "
                                          "bitwise on a rerun")
    check(aerr < SPARSE_STOL, f"sparse fsvd_blocked sigma error {aerr:.3e}")

    est, wall4 = timed(lambda: estimate_rank(
        S, SVDSpec(max_iters=RANK_ITERS, backend="pallas"),
        generator=gen_f()))
    print(f"phase 6: estimate_rank wall {wall4:.3f} s, rank {int(est)}, GK "
          f"iterations {int(est.iterations)}", flush=True)
    check(int(est) == RANK, f"estimate_rank returned {int(est)}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 6: peak device memory over the solves {peak / GIB:.2f} "
          f"GiB (bound {SPARSE_PEAK} GiB)", flush=True)
    check(peak < SPARSE_PEAK * GIB, f"sparse peak {peak / GIB:.2f} GiB")

    rows = []
    vb = S.ell[0].element_size()
    for name, (vals, cols, nx) in packs.items():
        csr = csr_of_pack(vals, cols)
        ny = vals.shape[0]
        for b in (1, 20):
            X = torch.randn(nx, b, generator=gen, device=DEV)
            if b == 1:
                x = X[:, 0].contiguous()
                lib = (lambda csr=csr, x=x: csr @ x)
            else:
                x = X
                lib = (lambda csr=csr, x=x: torch.sparse.mm(csr, x))
            nbytes = nnz * (vb + 4) + 4 * b * (nx + ny)
            row = time_row(
                f"sparse_matvec {name} b={b}",
                lambda v=vals, c=cols, x=x: spm.sparse_matvec(v, c, x),
                lambda v=vals, c=cols, x=x: ref.sparse_matvec(v, c, x), lib,
                nbytes, 2 * nnz * b, f"({ny} rows x L {vals.shape[1]}, "
                f"x {nx}x{b}, f32)", phase=6)
            row["call"] = f"{name} b={b}"
            rows.append(row)
        del csr
    # the row of the kernels line: the GK half-steps (b = 1, both packs),
    # 400 of the fsvd solve's 401 launches, as the mean per launch
    half = [r for r in rows if r["call"].endswith("b=1")]
    out = {key: sum(r[key] for r in half) / len(half)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    out["bound_by"] = "bytes"
    out["calls"] = [{k: r[k] for k in ("call", "ms", "plain_ms",
                                       "library_ms", "bound_ms")}
                    for r in rows]
    return launches, err, out, phase_reorth(S, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=80_000)
    ap.add_argument("--m64", type=int, default=20_000)
    ap.add_argument("--n64", type=int, default=16_000)
    # the Netflix Prize rating matrix: 480,189 users x 17,770 movies
    ap.add_argument("--sm", type=int, default=480_189)
    ap.add_argument("--sn", type=int, default=17_770)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    try:
        from repro_torch.kernels import _build
        card = smi_line()
        print(f"phase 1: card {card}", flush=True)
        t0 = time.perf_counter()
        logs = _build.build()
        print(f"phase 1: built {sorted(logs)} for sm_90a in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

        A, s_true = make_operand(args.seed, args.m, args.n)
        gen = torch.Generator(device=DEV).manual_seed(args.seed + 2)
        errs = phase_kernels(gen, A)
        errs.update(phase_new_kernels(gen, A))
        phase_slice3_kernels(gen)
        phase_slice4_kernels(gen)
        launches, peak3, fact = phase_main(A, s_true, args.seed)
        update_launches, _, _, drift = phase_update(fact, args.seed)
        del fact
        launches["sketch_matmat"] = phase_sketch(A, s_true, args.seed, peak3)
        times = phase_times(A, args.seed)
        times.update(phase_times_new(A, args.seed))
        # phase 7 edits A in place: it comes after every other use of A
        (launches["scatter_add"], errs["scatter_add"],
         times["scatter_add"]) = phase_sketchres(A, args.seed, peak3, drift)
        del drift
        # the counting wrappers of phase 4 are classes made in a function,
        # so reference cycles keep their operand (A) until a collection
        del A, s_true
        gc.collect()
        torch.cuda.empty_cache()
        (launches["lowrank_matmul"], errs["lowrank_matmul"],
         times["lowrank_matmul"]) = phase_materialize(args.seed, args.m,
                                                      args.n)
        # the matvecs' main path is the f64 leg: its run gives their
        # launches, errors and times; the f32 1e5 x 8e4 figures stay
        # beside them for the comparison with mv_qtv / rmv_qtv
        f32_main = {name: dict(shape=f"{args.m}x{args.n} f32",
                               max_abs_err=errs[name],
                               **{k: v for k, v in times[name].items()
                                  if k != "nbytes"})
                    for name in MATVECS}
        f64_launches, f64_errs, f64_times = phase_f64(args.seed, args.m64,
                                                      args.n64)
        launches.update(f64_launches)
        errs.update(f64_errs)
        times.update(f64_times)
        torch.cuda.empty_cache()
        (launches["sparse_matvec"], errs["sparse_matvec"],
         times["sparse_matvec"], (reorth_launches, reorth_errs,
                                  reorth_times)) = phase_sparse(
            args.seed, args.sm, args.sn)
        launches.update(reorth_launches)
        errs.update(reorth_errs)
        times.update(reorth_times)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name in REPLACES:
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/csrc/{SOURCES[name]}",
                   replaces=REPLACES[name], launches=launches[name],
                   max_abs_err=errs[name], ms=times[name]["ms"],
                   plain_ms=times[name]["plain_ms"],
                   bound_ms=times[name]["bound_ms"],
                   bound_by=times[name]["bound_by"],
                   library_ms=times[name]["library_ms"])
        if name in MATVECS:
            row["shape"] = f"{args.m64}x{args.n64} f64"
            row["f32_main"] = f32_main[name]
        if name == "lowrank_matmul":
            row["shape"] = f"{args.m}x{args.n} r={R_WANT}"
            row["launches_update"] = update_launches
        if name == "sparse_matvec":
            row["shape"] = f"{args.sm}x{args.sn}, {RANK} blocks"
            row["calls"] = times[name]["calls"]
        if name in ("qtv", "subtract_qc"):
            row["shape"] = f"Lanczos basis {args.sm}x{LANCZOS_K + 1} f32"
            row["calls"] = times[name]["calls"]
        if name == "scatter_add":
            row["shape"] = "phase 7 folds, mean of Y and Z"
            row["sorted_ms"] = times[name]["sorted_ms"]
            row["calls"] = times[name]["calls"]
            row["wide"] = times[name]["wide"]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
