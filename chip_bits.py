#!/usr/bin/env python3
"""Hold the GK-step kernels of two trees to each other's bits and times.

    python3 chip_bits.py save TREE OUT.pt     # on the card, once per tree
    python3 chip_bits.py compare A.pt B.pt
    python3 chip_bits.py times TREE OUT.json [--main]

``save`` imports ``TREE/src/repro_torch`` (a checkout of any commit of
this repo, e.g. a ``git archive`` of the parent), runs ``mv_qtv``,
``rmv_qtv``, ``proj_qtv`` and ``proj_norm`` with seeded inputs on ragged
shapes, f32 and bf16 A and basis, the same four over stacks (B = 3 at
ragged shapes, B = 2 at 8192 x 4096) with a single launch on each
example, and an fsvd of a seeded 2e4 x 1.6e4 operand of rank 100 through
``factorize(backend="pallas")``, and saves every output.  ``compare``
prints how many of them differ bitwise, and how many stacked examples
differ from their single launch in either file, and exits non-zero if
any does.  ``times`` imports a tree the same way and takes, with this
checkout's ``chip_smoke.py``, its stacked ``rmv_qtv`` / ``mv_qtv``
trace and phase 8's stage times at 8 x 8192 x 4096 (B = 2, 4, 8); with
``--main`` also rows 1-2 and 5-6 at 1e5 x 8e4 f32, 1d-2d on a 5e4 x 8e4
shard and 5-6 on the 2e4 x 1.6e4 f64 operand, all by device time.  Run
it for two trees in one call, in turns (parent, change, change, parent),
to compare their times on one card.  It needs one CUDA card and no
network.
"""
from __future__ import annotations

import sys


def save(tree: str, out: str) -> None:
    sys.path.insert(0, f"{tree}/src")
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.kernels import gk_step as gs

    g = torch.Generator(device="cuda").manual_seed(0)

    def t(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    res = {}
    for m, n, k in [(300, 517, 17), (1025, 333, 201), (8192, 4096, 101)]:
        for adt in (torch.float32, torch.bfloat16):
            for qdt in (torch.float32, torch.bfloat16):
                A, p, q, ym, yn = t(m, n, dt=adt), t(n), t(m), t(m), t(n)
                Q, P, c = t(m, k, dt=qdt), t(n, k, dt=qdt), t(k)
                al = torch.tensor([0.37], device="cuda")
                tag = f"{m}x{n}x{k} A {adt} basis {qdt}"
                res[f"mv_qtv {tag}"] = gs.mv_qtv(A, p, ym, al, Q)
                res[f"rmv_qtv {tag}"] = gs.rmv_qtv(A, q, yn, 1.7, P)
                res[f"proj_qtv {tag}"] = gs.proj_qtv(ym, Q, c)
                res[f"proj_norm {tag}"] = gs.proj_norm(ym, Q, c)
    # the stacked calls: phase 2's shapes at B = 3, the batched solve's
    # shape at B = 2; each example's single launch beside them
    for m, n, k, B in [(64, 48, 4, 3), (300, 517, 17, 3), (127, 383, 9, 3),
                       (192, 128, 25, 3), (1025, 333, 201, 3),
                       (8192, 4096, 101, 2)]:
        for adt in (torch.float32, torch.bfloat16):
            for qdt in (torch.float32, torch.bfloat16):
                A, p, q, ym, yn = (t(B, m, n, dt=adt), t(B, n), t(B, m),
                                   t(B, m), t(B, n))
                Q, P, c, al = (t(B, m, k, dt=qdt), t(B, n, k, dt=qdt),
                               t(B, k), t(B))
                calls = {
                    "mv_qtv": lambda *e: gs.mv_qtv(A[e], p[e], ym[e], al[e],
                                                   Q[e]),
                    "rmv_qtv": lambda *e: gs.rmv_qtv(A[e], q[e], yn[e],
                                                     al[e], P[e]),
                    "proj_qtv": lambda *e: gs.proj_qtv(ym[e], Q[e], c[e]),
                    "proj_norm": lambda *e: gs.proj_norm(ym[e], Q[e], c[e])}
                tag = f"B={B} {m}x{n}x{k} A {adt} basis {qdt}"
                for name, fn in calls.items():
                    res[f"stacked {name} {tag}"] = fn(slice(None))
                    for b in range(B):
                        res[f"single {name} {tag} b={b}"] = fn(b)
    A = t(20000, 100) @ t(100, 16000)
    res["fsvd sigma"] = (factorize(
        A, SVDSpec(method="fsvd", rank=20, max_iters=200, backend="pallas"),
        generator=torch.Generator(device="cuda").manual_seed(0)).s,)
    torch.save({key: [x.cpu() for x in outs] for key, outs in res.items()},
               out)
    print(f"saved {len(res)} outputs of {tree} to {out}")


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    differ = [key for key in x
              if key not in y or not all(torch.equal(u, v)
                                         for u, v in zip(x[key], y[key]))]
    print(f"{len(x)} outputs compared, {len(differ)} differ bitwise: "
          f"{differ}")
    apart = []   # stacked examples that are not their single launch
    for path, res in ((a, x), (b, y)):
        for key, outs in res.items():
            if not key.startswith("stacked "):
                continue
            for e in range(outs[0].shape[0]):
                one = res[f"single {key[len('stacked '):]} b={e}"]
                if not all(torch.equal(u[e], w) for u, w in zip(outs, one)):
                    apart.append(f"{path}: {key} b={e}")
    print(f"{len(apart)} stacked examples differ from their single launch: "
          f"{apart}")
    return 1 if differ or apart else 0


def times(tree: str, out: str, main: bool) -> None:
    import json
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import chip_smoke as cs   # puts this checkout's src/ on the path
    sys.path.insert(0, os.path.abspath(f"{tree}/src"))   # the tree's first
    from repro_torch.kernels import _build
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import ref

    if not gs.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"{tree}: imported {gs.__file__} instead")
    torch.backends.cuda.matmul.allow_tf32 = False
    logs = _build.build(["gk_step"])
    res = dict(tree=tree, module=gs.__file__, card=cs.smi_line(),
               ptxas=[line for line in cs.ptxas_report(logs["gk_step"])
                      if "rmv_" in line or "rows_kernel" in line])
    print("\n".join([f"{tree}: {gs.__file__}, {res['card']}"]
                    + res["ptxas"]), flush=True)
    g = torch.Generator(device="cuda").manual_seed(23)
    As = torch.randn(8, 8192, 4096, generator=g, device="cuda")
    res["trace"] = cs.stacked_trace(As, 0, 100)
    res["stages"] = cs.batched_stage_times(As, 0, 100)
    del As
    torch.cuda.empty_cache()
    if main:
        f, m, n = 4, 100_000, 80_000
        A = torch.randn(m, n, generator=g, device="cuda")
        rows = {k: v for k, v in cs.phase_times(A, 0).items()
                if k in ("mv_qtv", "rmv_qtv")}
        rows.update({k: v for k, v in cs.phase_times_new(A, 0).items()
                     if k in ("matvec_fused", "rmatvec_fused")})
        blk, mm = A[: m // 2], m // 2          # one rank's shard (1d-2d)

        def r(*shape, dt=torch.float32):
            return torch.randn(*shape, generator=g, device="cuda").to(dt)

        p, q, ym, yn = r(n), r(mm), r(mm), r(n)
        Q = torch.linalg.qr(r(mm, 201))[0].contiguous()
        P = torch.linalg.qr(r(n, 200))[0].contiguous()
        al = torch.tensor([0.37], device="cuda")
        rows["local_mv_qtv"] = cs.time_row(
            "local_mv_qtv", lambda: gs.mv_qtv(blk, p, ym, al, Q),
            lambda: ref.mv_qtv(blk, p, ym, al, Q),
            lambda: torch.mv(Q.T, torch.addmv(ym, blk, p, beta=-0.37)),
            f * (mm * n + n + mm + mm * 201 + 1 + mm + 201),
            2 * mm * n + 2 * mm + 2 * mm * 201, f"({mm}x{n} shard, k=201)",
            graph=cs.MAIN_GRAPH)
        rows["local_rmv_qtv"] = cs.time_row(
            "local_rmv_qtv", lambda: gs.rmv_qtv(blk, q, yn, 1.7, P),
            lambda: ref.rmv_qtv(blk, q, yn, 1.7, P),
            lambda: torch.mv(P.T, torch.addmv(yn, blk.T, q, beta=-1.7)),
            f * (mm * n + mm + n + n * 200 + n + 200),
            2 * mm * n + 2 * n + 2 * n * 200, f"({mm}x{n} shard, k=200)",
            graph=cs.MAIN_GRAPH)
        del A, blk, Q, P
        torch.cuda.empty_cache()
        m, n = 20_000, 16_000                  # the f64 leg (rows 5-6)
        A = r(m, n, dt=torch.float64)
        p, q, ym, yn = r(n), r(m), r(m), r(n)
        for name, fn, plain, lib, nbytes, flops in [
                ("matvec_fused", lambda: gs.matvec_fused(A, p, ym, 0.37),
                 lambda: ref.matvec_fused(A, p, ym, 0.37),
                 lambda: torch.addmv(ym.double(), A, p.double(), beta=-0.37),
                 8 * m * n + 4 * (n + 2 * m + 1), 2 * m * n + 2 * m),
                ("rmatvec_fused", lambda: gs.rmatvec_fused(A, q, yn, 1.7),
                 lambda: ref.rmatvec_fused(A, q, yn, 1.7),
                 lambda: torch.addmv(yn.double(), A.T, q.double(),
                                     beta=-1.7),
                 8 * m * n + 4 * (m + 2 * n + 1), 2 * m * n + 2 * n)]:
            rows[f"{name} f64"] = cs.time_row(
                name, fn, plain, lib, nbytes, flops, f"({m}x{n}, f64)",
                phase=5, graph=(60, 5))
        res["main"] = {k: {kk: vv for kk, vv in v.items() if kk != "device"}
                       for k, v in rows.items()}
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1, default=str)
    print(f"wrote the times of {tree} to {out}", flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "save":
        save(argv[1], argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    if len(argv) in (3, 4) and argv[0] == "times" and argv[3:] in ([],
                                                                  ["--main"]):
        times(argv[1], argv[2], argv[3:] == ["--main"])
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
