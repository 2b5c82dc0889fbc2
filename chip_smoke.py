#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0] [--m 100000] [--n 80000]
                          [--m64 20000] [--n64 16000]

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
     shapes, on row-major X and on a transposed view of X; every kernel
     twice, bitwise equal;
  3. main path — A = M N with Gaussian M (m x 100) and N (100 x n) made on
     the card from --seed (the paper's numerical-rank-100 input, §6.1);
     factorize(A, SVDSpec(method="fsvd", rank=20, max_iters=200,
     backend="pallas")) against sigma(A) = sigma(R_M R_N^T) from thin QRs,
     with exact launch counts, a bitwise rerun, a bf16-basis run, and
     estimate_rank(A) == 100 through the host loop;
  4. the sketch and blocked solvers on the same operand, backend="pallas":
     gnystrom (one sketch_pass, three sketch_matmat launches, bitwise
     rerun), rbk (5 sweeps, bitwise rerun), rsvd and fsvd_blocked, each
     against sigma_true at the reference's stol, with its wall time and a
     peak device memory that shows no copy of A or A^T;
     then every kernel is timed at its main shape beside its bound, its
     plain version and a PyTorch yardstick;
  5. the float64 leg — the f32 operand freed, an f64 operand of numerical
     rank 100 (--m64 x --n64): matvec_fused / rmatvec_fused held against
     their plain versions on it (twice, bitwise), then factorize(
     method="fsvd", rank=20, max_iters=200, backend="pallas"), whose
     half-steps run through them: exact launch counts, sigma within 5e-4,
     and both kernels timed at that shape.

The line before the last is the card as nvidia-smi reports it; the last is
{"ok": true, "device": {...}}.  A kernels JSON line precedes them.
"""
from __future__ import annotations

import argparse
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
            "sketch_matmat": "src/repro/kernels/sketch_matvec.py:65"}
SOURCES = {"mv_qtv": "gk_step.cu", "rmv_qtv": "gk_step.cu",
           "proj_qtv": "gk_step.cu", "proj_norm": "gk_step.cu",
           "matvec_fused": "gk_step.cu", "rmatvec_fused": "gk_step.cu",
           "sketch_matmat": "sketch_matvec.cu"}
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

def make_operand(seed, m, n, dtype=None):
    import torch
    gen = torch.Generator(device=DEV).manual_seed(seed)
    M = torch.randn(m, RANK, generator=gen, device=DEV, dtype=dtype)
    N = torch.randn(RANK, n, generator=gen, device=DEV, dtype=dtype)
    A = M @ N
    # sigma(M N) = sigma(R_M R_N^T) from the thin QRs M = Q_M R_M and
    # N^T = Q_N R_N, in f64 — no dense SVD of the (m, n) matrix.
    R_M = torch.linalg.qr(M.double())[1]
    R_N = torch.linalg.qr(N.T.double())[1]
    s_true = torch.linalg.svdvals(R_M @ R_N.T)
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
    return launches, peak


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=80_000)
    ap.add_argument("--m64", type=int, default=20_000)
    ap.add_argument("--n64", type=int, default=16_000)
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
        launches, peak3 = phase_main(A, s_true, args.seed)
        launches["sketch_matmat"] = phase_sketch(A, s_true, args.seed, peak3)
        times = phase_times(A, args.seed)
        times.update(phase_times_new(A, args.seed))
        del A, s_true
        torch.cuda.empty_cache()
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
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
