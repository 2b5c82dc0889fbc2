#!/usr/bin/env python3
"""Hold the unstacked GK-step kernels of two trees to each other's bits.

    python3 chip_bits.py save TREE OUT.pt     # on the card, once per tree
    python3 chip_bits.py compare A.pt B.pt

``save`` imports ``TREE/src/repro_torch`` (a checkout of any commit of
this repo, e.g. a ``git archive`` of the parent), runs ``mv_qtv``,
``rmv_qtv``, ``proj_qtv`` and ``proj_norm`` with seeded inputs on ragged
shapes, f32 and bf16 A and basis, and an fsvd of a seeded 2e4 x 1.6e4
operand of rank 100 through ``factorize(backend="pallas")``, and saves
every output.  ``compare`` prints how many of them differ bitwise and
exits non-zero if any does.  It needs one CUDA card and no network.
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
    return 1 if differ else 0


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "save":
        save(argv[1], argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "compare":
        return compare(argv[1], argv[2])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
