"""Quickstart: the paper's three algorithms through the
``repro_torch.api`` facade.  Counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart

On the card (``--device cpu`` for the CPU).  ``DenseOp(backend="pallas")``
runs F-SVD through the hand-written GK-step kernels on the card (their
plain versions on the CPU); the batched solve runs ``solve_batched`` on a
stacked ``DenseOp`` where the reference maps the facade with ``vmap``.
``main(argv)`` returns the figures it prints.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.api import (DenseOp, SVDSpec, estimate_rank, factorize,
                             plan)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # a "huge" low-rank matrix (the paper's synthetic setup): A = M @ N
    # with Gaussian factors -> numerical rank exactly 50
    g = gen(0)
    A = (torch.randn((4000, 50), generator=g, device=dev)
         @ torch.randn((50, 2000), generator=g, device=dev))
    out_rec = {}

    # --- Algorithm 3: numerical rank, no user parameters ---
    est = estimate_rank(A, generator=gen(1))
    print(f"numerical rank: {int(est.rank)} "
          f"(GK terminated after {int(est.iterations)} iterations)")
    out_rec["rank"] = int(est.rank)

    # --- Algorithm 2: accurate partial SVD (top 10 triplets) ---
    spec = SVDSpec(method="fsvd", rank=10, max_iters=120, host_loop=True)
    out = factorize(A, spec, generator=gen(2))
    s_true = torch.linalg.svdvals(A.double())[:10]
    err = float((out.s.double() - s_true).abs().max())
    print("F-SVD sigma:", [f"{x:.1f}" for x in out.s.tolist()])
    print("max |sigma - svd|:", err)
    out_rec["fsvd_err"] = err

    # --- the R-SVD baseline: same call, different spec ---
    rs = factorize(A, SVDSpec(method="rsvd", rank=10, oversample=10),
                   generator=gen(3))
    rs_err = float((rs.s.double() - s_true).abs().max())
    print("R-SVD(default) max err:", rs_err)
    out_rec["rsvd_err"] = rs_err

    # --- F-SVD through the hand-written kernels ---
    out_k = factorize(DenseOp(A, backend="pallas"),
                      spec.replace(rank=4, max_iters=60, host_loop=False),
                      generator=gen(4))
    print("kernel-path sigma:", [f"{x:.1f}" for x in out_k.s.tolist()])
    out_rec["kernel_err"] = float((out_k.s.double() - s_true[:4]).abs().max())

    # --- batched partial SVD: one solve over a stacked DenseOp ---
    As = torch.stack([A[:500, :400], A[500:1000, 400:800]])
    batched = plan(SVDSpec(method="fsvd", rank=4, max_iters=40),
                   like=DenseOp(As[0])).solve_batched(
        DenseOp(As), generators=[gen(5), gen(6)])
    print("batched sigma shape:", tuple(batched.s.shape))       # (2, 4)
    out_rec["batched_shape"] = tuple(batched.s.shape)

    # --- Table-2 error metrics + warm-start seam ---
    errors = {k: (float(v) if v is not None else None)
              for k, v in out.errors(A).items()}
    print("errors:", errors)
    out2 = factorize(A, spec, q1=out.warm_start())           # warm-started
    print("warm-start sigma[0]:", float(out2.s[0]))
    out_rec["errors"] = errors
    return out_rec


if __name__ == "__main__":
    main()
