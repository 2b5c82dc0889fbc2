#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--m 100000] [--n 80000]

Phases (any failure exits non-zero; there is no CPU fallback):

  1. device and build — the card's name and power limit from nvidia-smi,
     and an nvcc build of every kernel in src/repro_torch/csrc for sm_90a;
  2. kernel vs plain version — each of the four fused GK-step kernels, and
     gk_step_fused / gk_rstep_fused at passes 0..3, against the plain-torch
     versions of repro_torch.kernels.ref on ragged small shapes and at the
     main shape, f32 and bf16 storage, and two launches bitwise equal;
  3. main path — A = M N with Gaussian M (m x 100) and N (100 x n) made on
     the card from --seed (the paper's numerical-rank-100 input, §6.1);
     factorize(A, SVDSpec(method="fsvd", rank=20, max_iters=200,
     backend="pallas")) against sigma(A) = sigma(R_M R_N^T) from thin QRs,
     with exact launch counts, a bitwise rerun, a bf16-basis run, and
     estimate_rank(A) == 100 through the host loop; then each kernel is
     timed at the main shape beside its bound, its plain version and a
     PyTorch yardstick.

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

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
RANK, R_WANT, MAX_ITERS, RANK_ITERS = 100, 20, 200, 256
FSVD_STOL = 5e-4              # SOLVERS["fsvd"]["stol"], test_solver_parity
BF16_STOL = 5e-2              # BF16_STOL["fsvd"], test_solver_parity
REL_ERR_BOUND = 5e-5          # test_api.py test_factorization_reconstruct
SMALL_SHAPES = [(64, 48, 4), (300, 517, 17), (257, 129, 31), (127, 383, 9),
                (1024, 512, 64), (300, 200, 5)]   # tests/test_kernels.py:136
BF16_A_SHAPE = (8192, 8192, 201)                   # bf16 A kept this small
REPLACES = {"mv_qtv": "src/repro/kernels/gk_step.py:147",
            "rmv_qtv": "src/repro/kernels/gk_step.py:178",
            "proj_qtv": "src/repro/kernels/gk_step.py:206",
            "proj_norm": "src/repro/kernels/gk_step.py:232"}


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
    dev = "cuda"
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
    alpha = torch.tensor([0.37], device="cuda")
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

def make_operand(seed, m, n):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    M = torch.randn(m, RANK, generator=gen, device="cuda")
    N = torch.randn(RANK, n, generator=gen, device="cuda")
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
        return torch.Generator(device="cuda").manual_seed(seed)

    gs.reset_launches()
    fact, wall = timed(lambda: factorize(A, spec, generator=gen()))
    launches = dict(gs.LAUNCHES)
    k, passes = MAX_ITERS, spec.reorth_passes
    want = {"mv_qtv": k, "rmv_qtv": k - 1,
            "proj_qtv": (2 * k - 1) * (passes - 1), "proj_norm": 2 * k - 1}
    check(launches == want, f"launch counts {launches} != {want}")
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
    rank_launches = dict(gs.LAUNCHES)
    print(f"phase 3: estimate_rank wall {wall4:.3f} s, rank {int(est)}, "
          f"GK iterations {int(est.iterations)}, launches {rank_launches}",
          flush=True)
    check(int(est) == RANK, f"estimate_rank returned {int(est)}")
    check(all(v > 0 for v in rank_launches.values()),
          f"estimate_rank skipped a kernel: {rank_launches}")
    print(f"phase 3: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
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
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    kq, kp = MAX_ITERS + 1, MAX_ITERS
    p = torch.randn(n, generator=g, device="cuda")
    q = torch.randn(m, generator=g, device="cuda")
    ym = torch.randn(m, generator=g, device="cuda")
    yn = torch.randn(n, generator=g, device="cuda")
    Q = torch.linalg.qr(torch.randn(m, kq, generator=g, device="cuda"))[0]
    P = torch.linalg.qr(torch.randn(n, kp, generator=g, device="cuda"))[0]
    Q, P = Q.contiguous(), P.contiguous()
    c = torch.randn(kq, generator=g, device="cuda")
    alpha = torch.tensor([0.37], device="cuda")
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
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        ms = event_ms(kern)
        plain_ms = event_ms(plain)
        lib_ms = event_ms(lib)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", nbytes=nbytes)
        print(f"phase 3: {name} at ({m}x{n}, k={kq if name != 'rmv_qtv' else kp}"
              f", f32): kernel {ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({out[name]['bound_by']}), {nbytes / ms / 1e6:.1f} GB/s, "
              f"plain {plain_ms:.4f} ms, torch addmv+gemv {lib_ms:.4f} ms",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=100_000)
    ap.add_argument("--n", type=int, default=80_000)
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
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 2)
        errs = phase_kernels(gen, A)
        launches = phase_main(A, s_true, args.seed)
        times = phase_times(A, args.seed)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    kernels = [dict(name=name, route="cuda",
                    source="src/repro_torch/csrc/gk_step.cu",
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], ms=times[name]["ms"],
                    plain_ms=times[name]["plain_ms"],
                    bound_ms=times[name]["bound_ms"],
                    bound_by=times[name]["bound_by"],
                    library_ms=times[name]["library_ms"])
               for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
