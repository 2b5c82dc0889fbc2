#!/usr/bin/env python3
"""Hold the GK-step kernels of two trees to each other's bits and times.

    python3 chip_bits.py save TREE OUT.pt     # on the card, once per tree
    python3 chip_bits.py compare A.pt B.pt
    python3 chip_bits.py times TREE OUT.json [--main]
    python3 chip_bits.py ab PARENT CHANGE OUT.json [ROUNDS]
    python3 chip_bits.py skew SEEDS
    python3 chip_bits.py tp OUT.json [sweep]
    python3 chip_bits.py q3 OUT.json [sweep]
    python3 chip_bits.py scratch

``save`` imports ``TREE/src/repro_torch`` (a checkout of any commit of
this repo, e.g. a ``git archive`` of the parent), runs ``mv_qtv``,
``rmv_qtv``, ``proj_qtv`` and ``proj_norm`` with seeded inputs on ragged
shapes, f32 and bf16 A and basis, the same four over stacks (B = 3 at
ragged shapes, B = 2 at 8192 x 4096; the projection pair on both bases,
at B = 8 on the 8192 x 101 and 4096 x 100 bases and at B = 2 on 16384
rows, a grid of 264 for f32, with rmv_qtv's P^T v there) with a single
launch on each example, both pairs on 20000 rows at k = 128, 201 and
300, the projection pair on rows whose every product underflows, and an
fsvd of a seeded 2e4 x 1.6e4 operand of rank 100 through
``factorize(backend="pallas")``, and saves every output.  ``compare``
prints how many of them differ bitwise (zeros of opposite signs
differ), and how many stacked examples differ from their single launch
in either file, and exits non-zero if any does.  ``times`` imports a tree the same way and takes, with this
checkout's ``chip_smoke.py``, its stacked ``rmv_qtv`` / ``mv_qtv`` /
projection pair trace, phase 8's stage times at 8 x 8192 x 4096 (B =
2, 4, 8; the pair on the Q and the P side's basis, warm and cold L2) and
the device time of the batched solve's GK loop at that stack; with
``--main`` also rows 1-4 and 5-6 at 1e5 x 8e4 f32, 1d-2d on a 5e4 x 8e4
shard, 7-8 on a 480,189 x 201 basis and 5-6 on the 2e4 x 1.6e4 f64
operand, all by device time.  Run
it for two trees in one call, in turns (parent, change, change, parent),
to compare their times on one card.  ``ab`` imports both trees into one
process and takes rows 1-4 and 7-8 at their main shapes, the stacked
projection pair and ``rmv_qtv`` and the batched GK loop in turns within
each round, so the card's drift between processes stays out of the
comparison.  ``skew`` runs ``tests/test_torch_gpu.py``'s skewed rows
(empty to 30,000 slots; entries spread, and all in one column) through
``sparse_matvec``'s block kernel for SEEDS seeds at b = 2, 7, 20 and 32,
and prints, as JSON, each case's error against the plain version over
max |y| and the kernel's and the plain version's errors against an f64
sum of the same terms over sqrt(L + 1) u sum |a x|.  ``tp`` runs
``chip_smoke.py``'s phase 14 (b) tensor-parallel stablelm-1.6b run (two
gloo ranks on the card beside one card's steps, prefill and decode) and
phase 15 (b)'s two-rank trace of it, and with ``sweep`` phase 15 (a)'s
dry-run sweep, alone, and writes their records to OUT.json.  ``q3`` does
the same for phase 14 (b)'s Mamba2, batch-of-one and sequence splits
(zamba2-1.2b's Mamba2 heads over "model" on (1, 2), its batch of one
over "data" on (2, 1), deepseek-v2-236b's MLA latents by sequence over
"model" on (1, 2), beside one card's) and phase 15 (b)'s two-rank trace
of the batch of one's decode step.  ``scratch``
prints, as JSON, the device bytes the CUDA softmax backward holds beyond
its output (max_memory_allocated over its inputs and output) at shapes
from (2, 16, 512, 512) to (8, 1024, 50176), f32 and bf16, beside the
forward softmax's.  It needs one CUDA card and no network.
"""
from __future__ import annotations

import sys


def save(tree: str, out: str) -> None:
    sys.path.insert(0, f"{tree}/src")
    import torch
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.kernels import gk_step as gs
    from repro_torch.kernels import reorth as rk

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
    # shape at B = 2 (the projection pair on both bases); each example's
    # single launch beside them
    for m, n, k, B in [(64, 48, 4, 3), (300, 517, 17, 3), (127, 383, 9, 3),
                       (192, 128, 25, 3), (1025, 333, 201, 3),
                       (8192, 4096, 101, 2)]:
        for adt in (torch.float32, torch.bfloat16):
            for qdt in (torch.float32, torch.bfloat16):
                A, p, q, ym, yn = (t(B, m, n, dt=adt), t(B, n), t(B, m),
                                   t(B, m), t(B, n))
                Q, P, c, al = (t(B, m, k, dt=qdt), t(B, n, k, dt=qdt),
                               t(B, k), t(B))
                cp = t(B, k)
                calls = {
                    "mv_qtv": lambda *e: gs.mv_qtv(A[e], p[e], ym[e], al[e],
                                                   Q[e]),
                    "rmv_qtv": lambda *e: gs.rmv_qtv(A[e], q[e], yn[e],
                                                     al[e], P[e]),
                    "proj_qtv": lambda *e: gs.proj_qtv(ym[e], Q[e], c[e]),
                    "proj_norm": lambda *e: gs.proj_norm(ym[e], Q[e], c[e]),
                    "proj_qtv P": lambda *e: gs.proj_qtv(yn[e], P[e],
                                                         cp[e]),
                    "proj_norm P": lambda *e: gs.proj_norm(yn[e], P[e],
                                                           cp[e])}
                tag = f"B={B} {m}x{n}x{k} A {adt} basis {qdt}"
                for name, fn in calls.items():
                    res[f"stacked {name} {tag}"] = fn(slice(None))
                    for b in range(B):
                        res[f"single {name} {tag} b={b}"] = fn(b)
    # the projection pair at the batched solve's stack, B = 8, on both
    # sides (more blocks than the card holds at once), and at B = 2 on a
    # basis of 16384 rows, whose f32 grid (264; bf16's is 103) takes the
    # warp finish's second pass, with rmv_qtv's Pᵀv there too
    for B, L, k in [(8, 8192, 101), (8, 4096, 100), (2, 16384, 101)]:
        for qdt in (torch.float32, torch.bfloat16):
            u, X, c = t(B, L), t(B, L, k, dt=qdt), t(B, k)
            tag = f"B={B} {L}x{k} basis {qdt}"
            for name in ("proj_qtv", "proj_norm"):
                fn = getattr(gs, name)
                res[f"stacked {name} {tag}"] = fn(u, X, c)
                for b in range(B):
                    res[f"single {name} {tag} b={b}"] = fn(u[b], X[b], c[b])
            if L == 16384:
                A, q, al = t(B, 64, L), t(B, 64), t(B)
                res[f"stacked rmv_qtv {tag}"] = gs.rmv_qtv(A, q, u, al, X)
                for b in range(B):
                    res[f"single rmv_qtv {tag} b={b}"] = gs.rmv_qtv(
                        A[b], q[b], u[b], al[b], X[b])
    # the reorthogonalization pair and the projection pair on both slot
    # counts (k = 128: 4 a lane) and past the register path (k = 300),
    # past one finishing pass (20000 rows: a grid of 264 but for bf16 at
    # k = 128 and 201)
    for k in (128, 201, 300):
        for qdt in (torch.float32, torch.bfloat16):
            v, X, c = t(20000), t(20000, k, dt=qdt), t(k)
            tag = f"20000x{k} basis {qdt}"
            res[f"qtv {tag}"] = (rk.qtv(X, v),)
            res[f"subtract_qc {tag}"] = (rk.subtract_qc(v, X, c),)
            res[f"proj_qtv {tag}"] = gs.proj_qtv(v, X, c)
            res[f"proj_norm {tag}"] = gs.proj_norm(v, X, c)
    # rows whose every product underflows to -0, with u = -0: w keeps the
    # 8-slot chain's bits (compare holds the signs of zeros too)
    for k in (64, 128, 200):
        for qdt in (torch.float32, torch.bfloat16):
            B, L = 2, 1000
            X = ((torch.rand(B, L, k, generator=g, device="cuda") + 0.5)
                 * 1e-30).to(qdt)
            c = -(torch.rand(B, k, generator=g, device="cuda") + 0.5) * 1e-20
            u = torch.full((B, L), -0.0, device="cuda")
            tag = f"underflow B={B} {L}x{k} basis {qdt}"
            for name in ("proj_qtv", "proj_norm"):
                fn = getattr(gs, name)
                res[f"stacked {name} {tag}"] = fn(u, X, c)
                for b in range(B):
                    res[f"single {name} {tag} b={b}"] = fn(u[b], X[b], c[b])
            res[f"subtract_qc {tag}"] = (rk.subtract_qc(u[0], X[0], c[0]),)
    A = t(20000, 100) @ t(100, 16000)
    res["fsvd sigma"] = (factorize(
        A, SVDSpec(method="fsvd", rank=20, max_iters=200, backend="pallas"),
        generator=torch.Generator(device="cuda").manual_seed(0)).s,)
    torch.save({key: [x.cpu() for x in outs] for key, outs in res.items()},
               out)
    print(f"saved {len(res)} outputs of {tree} to {out}")


def _same_bits(u, v) -> bool:
    """Equal bit for bit: zeros of opposite signs (and NaNs) differ."""
    import torch
    flat = lambda x: x.contiguous().reshape(-1).view(torch.uint8)  # noqa: E731
    return u.dtype == v.dtype and u.shape == v.shape and torch.equal(
        flat(u), flat(v))


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    differ = [key for key in x
              if key not in y or not all(_same_bits(u, v)
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
                if not all(_same_bits(u[e], w) for u, w in zip(outs, one)):
                    apart.append(f"{path}: {key} b={e}")
    print(f"{len(apart)} stacked examples differ from their single launch: "
          f"{apart}")
    return 1 if differ or apart else 0


def times(tree: str, out: str, main: bool) -> None:
    import json
    import os
    import re
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
                      if re.search(r"rmv_|rows_kernel|proj_|finish_",
                                   line)])
    print("\n".join([f"{tree}: {gs.__file__}, {res['card']}"]
                    + res["ptxas"]), flush=True)
    g = torch.Generator(device="cuda").manual_seed(23)
    As = torch.randn(8, 8192, 4096, generator=g, device="cuda")
    res["trace"] = cs.stacked_trace(As, 0, 100)
    res["stages"] = cs.batched_stage_times(As, 0, 100)
    del As
    torch.cuda.empty_cache()
    # the batched solve's GK loop (100 steps at 8 x 8192 x 4096), in one
    # CUDA graph as phase 8 times it
    res["gk_loop_ms"] = cs.gk_device_ms(8, (8192, 4096), 100)
    print(f"{tree}: GK loop of the batched solve, B=8 x 8192x4096, 100 "
          f"steps: {res['gk_loop_ms']:.3f} ms of device time", flush=True)
    if main:
        f, m, n = 4, 100_000, 80_000
        A = torch.randn(m, n, generator=g, device="cuda")
        rows = {k: v for k, v in cs.phase_times(A, 0).items()
                if k in ("mv_qtv", "rmv_qtv", "proj_qtv", "proj_norm")}
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
        # rows 7-8: qtv / subtract_qc on a basis of the sparse cell's
        # Lanczos shape (480,189 x 201), f32 and bf16, two copies a graph
        from repro_torch.kernels import reorth as rk
        L, k = 480_189, 201
        v, c = r(L), r(k)
        Qs = torch.linalg.qr(r(L, k))[0].contiguous()
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            copies = [Qs.to(dt, copy=True) for _ in range(2)]
            for name, fn in (("qtv", lambda B: rk.qtv(B, v)),
                             ("subtract_qc",
                              lambda B: rk.subtract_qc(v, B, c))):
                ms = cs.graph_ms([lambda B=B: fn(B) for B in copies])
                rows[f"{name} {tag}"] = dict(ms=ms, shape=f"{L}x{k} {tag}")
                print(f"{tree}: {name} at {L}x{k} {tag}, device time over "
                      f"2 copies: {ms:.4f} ms", flush=True)
            del copies
        del Qs
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


class _Trees:
    """Two trees' ``repro_torch`` in one process.  ``use(tag)`` puts that
    tree's modules in ``sys.modules`` and its ``src`` first on the path,
    so a later import, in this file or inside a function of either tree
    (or of chip_smoke), resolves to that tree."""

    def __init__(self, trees: dict):
        import os
        self.src = {tag: os.path.abspath(f"{tree}/src")
                    for tag, tree in trees.items()}
        self.mods = {tag: {} for tag in trees}
        self.tag = None
        for tag in trees:
            self.use(tag)
            from repro_torch.kernels import _build
            assert _build.__file__.startswith(self.src[tag]), _build.__file__
            self.log = _build.build(["gk_step", "reorth"])

    def use(self, tag: str) -> None:
        own = lambda n: n.split(".")[0] == "repro_torch"  # noqa: E731
        if self.tag is not None:
            self.mods[self.tag] = {n: m for n, m in sys.modules.items()
                                   if own(n)}
        for n in [n for n in sys.modules if own(n)]:
            del sys.modules[n]
        sys.modules.update(self.mods[tag])
        sys.path[:] = [p for p in sys.path if p not in self.src.values()]
        sys.path.insert(0, self.src[tag])
        self.tag = tag


def ab(parent: str, change: str, out: str, rounds: int) -> None:
    """Rows 1-4 and 7-8 at their main shapes, the stacked projection pair
    (Q and P side, B = 8, 4, 2), the stacked ``rmv_qtv`` and the batched
    solve's GK loop, for two trees in one process: each round times
    parent, change, change, parent on the same inputs by device time
    (``graph_ms``), so the card's drift falls on both alike.  Prints each
    row's times and the change's time over the parent's, a round each."""
    import importlib
    import json
    import os
    import statistics
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import chip_smoke as cs
    trees = _Trees({"parent": parent, "change": change})
    print("\n".join(line for line in cs.ptxas_report(trees.log["gk_step"])
                    + cs.ptxas_report(trees.log["reorth"])
                    if "proj_" in line or "finish" in line), flush=True)
    mod = importlib.import_module
    gs = lambda: mod("repro_torch.kernels.gk_step")  # noqa: E731
    rk = lambda: mod("repro_torch.kernels.reorth")   # noqa: E731
    res = dict(card=cs.smi_line(), parent=parent, change=change,
               rounds=rounds, rows={})
    print(f"card: {res['card']}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(29)

    def r(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    def turns(name, ms, n=rounds):
        t = {"parent": [], "change": []}
        for _ in range(n):
            for tag in ("parent", "change", "change", "parent"):
                trees.use(tag)
                t[tag].append(ms())
        ratio = [sum(t["change"][2 * i: 2 * i + 2])
                 / sum(t["parent"][2 * i: 2 * i + 2]) for i in range(n)]
        res["rows"][name] = dict(t, ratio=ratio,
                                 median_ratio=statistics.median(ratio))
        print(f"{name}: parent {min(t['parent']):.5f}-"
              f"{max(t['parent']):.5f} ms, change {min(t['change']):.5f}-"
              f"{max(t['change']):.5f} ms; change / parent a round "
              + " ".join(f"{x:.4f}" for x in ratio)
              + f" (median {statistics.median(ratio):.4f})", flush=True)

    m, n = 100_000, 80_000                     # rows 1-2: the main A
    A, p, q, ym, yn = r(m, n), r(n), r(m), r(m), r(n)
    Q = torch.linalg.qr(r(m, 201))[0].contiguous()
    P = torch.linalg.qr(r(n, 200))[0].contiguous()
    al = torch.tensor([0.37], device="cuda")
    turns("mv_qtv 1e5x8e4 k=201 (row 1)", lambda: cs.graph_ms(
        [lambda: gs().mv_qtv(A, p, ym, al, Q)], *cs.MAIN_GRAPH))
    turns("rmv_qtv 1e5x8e4 k=200 (row 2)", lambda: cs.graph_ms(
        [lambda: gs().rmv_qtv(A, q, yn, 1.7, P)], *cs.MAIN_GRAPH))
    del A, P
    torch.cuda.empty_cache()
    u, c = r(m), r(201)                        # rows 3-4: phase 3's Q side
    copies = [Q.clone() for _ in range(cs.PROJ_COPIES["f32"])]
    for name in ("proj_qtv", "proj_norm"):
        turns(f"{name} 1e5x201 f32 (row {3 if name == 'proj_qtv' else 4})",
              lambda: cs.graph_ms([lambda B=B: getattr(gs(), name)(u, B, c)
                                   for B in copies]))
    del Q, copies
    L, k = 480_189, 201                        # rows 7-8: the Lanczos basis
    v, c = r(L), r(k)
    Qs = torch.linalg.qr(r(L, k))[0].contiguous()
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        copies = [Qs.to(dt, copy=True) for _ in range(2)]
        turns(f"qtv {L}x{k} {tag} (row 7)", lambda: cs.graph_ms(
            [lambda B=B: rk().qtv(B, v) for B in copies]))
        turns(f"subtract_qc {L}x{k} {tag} (row 8)", lambda: cs.graph_ms(
            [lambda B=B: rk().subtract_qc(v, B, c) for B in copies]))
        del copies
    del Qs
    torch.cuda.empty_cache()
    for side, L, k in (("Q", 8192, 101), ("P", 4096, 100)):   # 3s-4s-P
        u, X, c = r(8, L), r(8, L, k), r(8, k)
        for B in (8, 4, 2):
            for name in ("proj_qtv", "proj_norm"):
                turns(f"stacked {name} {side} B={B} x {L}x{k} f32, warm",
                      lambda: cs.graph_ms([lambda: getattr(gs(), name)(
                          u[:B], X[:B], c[:B])]))
    As, q, yn, P = r(8, 8192, 4096), r(8, 8192), r(8, 4096), r(8, 4096, 100)
    al = r(8)
    turns("stacked rmv_qtv B=8 x 8192x4096 k=100 (row 2s)", lambda:
          cs.graph_ms([lambda: gs().rmv_qtv(As, q, yn, al, P)], 20, 5))
    del As
    torch.cuda.empty_cache()
    turns("GK loop, B=8 x 8192x4096, 100 steps", lambda: cs.gk_device_ms(
        8, (8192, 4096), 100))
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"wrote both trees' times to {out}", flush=True)


def skew(seeds: int) -> None:
    import json

    import numpy as np
    import torch
    sys.path.insert(0, "src")
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_matvec as spm
    cuda, n, out = torch.device("cuda"), 60_000, []
    counts = np.array([0, 30_000, 1, 7, 0, 4_000, 41, 40, 39, 2] * 3)
    rows = np.repeat(np.arange(len(counts)), counts)
    length = torch.from_numpy(counts).to(cuda).double()[:, None]
    for seed in range(seeds):
        for b in (2, 7, 20, 32):
            g = torch.Generator(device=cuda).manual_seed(1000 * b + seed)
            rng = np.random.default_rng(1000 * b + seed)
            for kind, cols in (("spread", rng.integers(0, n, rows.shape[0])),
                               ("one column", np.full(rows.shape[0], n - 1))):
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
                bound = (torch.sqrt(length + 1) * 2.0 ** -24
                         * terms.abs().sum(1)).clamp(min=1e-300)
                out.append(dict(
                    seed=seed, b=b, kind=kind,
                    vs_plain=float((got - plain).abs().max()
                                   / plain.abs().max()),
                    kernel_f64=float(((got.double() - exact).abs()
                                      / bound).max()),
                    plain_f64=float(((plain.double() - exact).abs()
                                     / bound).max())))
    print(json.dumps(dict(
        cases=len(out), over_1e5=[r for r in out if r["vs_plain"] > 1e-5],
        max_vs_plain=max(r["vs_plain"] for r in out),
        max_kernel_f64=max(r["kernel_f64"] for r in out),
        max_plain_f64=max(r["plain_f64"] for r in out))))


def _tp_rank(rank, world, out_dir, seed):
    """One rank of ``tp``'s two-rank world: ``chip_smoke.tp_rank``."""
    import json
    import time

    import torch

    import chip_smoke as cs
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def timed(fn):
        torch.cuda.synchronize()
        reset_collectives()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, collective_stats()
    rec = cs.tp_rank(rank, "cuda", seed, out_dir, timed)
    with open(f"{out_dir}/rank{rank}.json", "w") as fh:
        json.dump({"tp": rec}, fh)


def _q3_rank(rank, world, out_dir, seed):
    """One rank of ``q3``'s two-rank world: ``chip_smoke.q3_rank``."""
    import json
    import time

    import torch

    import chip_smoke as cs
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def timed(fn):
        torch.cuda.synchronize()
        reset_collectives()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, collective_stats()
    rec = cs.q3_rank(rank, "cuda", seed, out_dir, timed)
    with open(f"{out_dir}/rank{rank}.json", "w") as fh:
        json.dump({"q3": rec}, fh)


def q3(out: str, sweep: bool) -> None:
    import json
    import os
    import shutil

    import torch
    sys.path.insert(0, "src")
    import chip_smoke as cs
    from repro_torch.launch.mesh import run_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    work = os.path.join(cs.ROOT, "build", "chip_bits_q3")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        single = cs.q3_reference(0, work)
        run_world(_q3_rank, cs.DIST_WORLD, os.path.join(work, "rendezvous"),
                  (work, 0), timeout_s=cs.DIST_TIMEOUT_S)
        recs = []
        for r in range(cs.DIST_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                recs.append(json.load(fh))
        res = dict(q3=cs.q3_check(single, recs, work))
        res["q3_trace"] = cs.dryrun_vs_real_q3(res["q3"]["zb"]["ranks"][0])
        if sweep:
            os.makedirs(os.path.join(work, "sweep"))
            res["sweep"] = cs.dryrun_sweep(os.path.join(work, "sweep"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with open(out, "w") as fh:
        json.dump(res, fh, default=str)


def tp(out: str, sweep: bool) -> None:
    import json
    import os
    import shutil

    import torch
    sys.path.insert(0, "src")
    import chip_smoke as cs
    from repro_torch.launch.mesh import run_world
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    work = os.path.join(cs.ROOT, "build", "chip_bits_tp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        single = cs.tp_reference(0, work)
        run_world(_tp_rank, cs.DIST_WORLD, os.path.join(work, "rendezvous"),
                  (work, 0), timeout_s=cs.DIST_TIMEOUT_S)
        recs = []
        for r in range(cs.DIST_WORLD):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                recs.append(json.load(fh))
        res = dict(tp=cs.tp_check(single, recs, work))
        res["tp_trace"] = cs.dryrun_vs_real_tp(res["tp"]["ranks"][0])
        if sweep:
            os.makedirs(os.path.join(work, "sweep"))
            res["sweep"] = cs.dryrun_sweep(os.path.join(work, "sweep"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with open(out, "w") as fh:
        json.dump(res, fh, default=str)


def scratch() -> None:
    import json

    import torch
    cuda, out = torch.device("cuda"), []
    for shape in ((2, 16, 512, 512), (2, 16, 2048, 2048), (2, 16, 4096, 4096),
                  (2, 32, 4096, 4096), (1, 4, 1024, 8192), (8, 1024, 50176),
                  (2, 16, 4096, 4097)):
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn(shape, device=cuda, dtype=dt)
            o = torch.softmax(torch.randn(shape, device=cuda, dtype=dt), -1)
            rows = {}
            for name, fn in (("backward", lambda: torch.ops.aten
                              ._softmax_backward_data(g, o, -1, dt)),
                             ("forward", lambda: torch.softmax(g, -1))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                r = fn()
                torch.cuda.synchronize()
                rows[name] = (torch.cuda.max_memory_allocated() - base
                              - r.numel() * r.element_size())
                del r
            out.append(dict(shape=list(shape), dtype=str(dt),
                            out_bytes=g.numel() * g.element_size(),
                            backward_scratch=rows["backward"],
                            forward_scratch=rows["forward"]))
            del g, o
            torch.cuda.empty_cache()
    print(json.dumps(dict(torch=torch.__version__, cases=out)))


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "save":
        save(argv[1], argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    if len(argv) in (4, 5) and argv[0] == "ab":
        ab(argv[1], argv[2], argv[3], int(argv[4]) if argv[4:] else 4)
        return 0
    if len(argv) in (3, 4) and argv[0] == "times" and argv[3:] in ([],
                                                                  ["--main"]):
        times(argv[1], argv[2], argv[3:] == ["--main"])
        return 0
    if len(argv) == 2 and argv[0] == "skew":
        skew(int(argv[1]))
        return 0
    if len(argv) in (2, 3) and argv[0] == "tp" and argv[2:] in ([],
                                                              ["sweep"]):
        tp(argv[1], argv[2:] == ["sweep"])
        return 0
    if len(argv) in (2, 3) and argv[0] == "q3" and argv[2:] in ([],
                                                              ["sweep"]):
        q3(argv[1], argv[2:] == ["sweep"])
        return 0
    if argv == ["scratch"]:
        scratch()
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
