"""End-to-end driver: the paper's RSL application at 1e8-parameter scale.

Counterpart of ``examples/train_rsl.py``.  Learns a rank-5 similarity
metric W in R^{10000 x 10000} (1e8 entries — the paper's "huge matrix"
regime) with Riemannian mini-batch SGD (Alg 4), using the F-SVD retraction
(Alg 2) on an IMPLICIT operator: the dense W is never materialized anywhere
in the training loop — the point, tangent vectors and retraction all live
in factored form, so memory is O((d1+d2) r) ~ 100k floats instead of 1e8.

Two tracking layers exploit the slow drift between steps:

  * the retraction runs in *tracking* mode (``RSGDOptions.track``,
    default): each step's F-SVD warm-starts from the current point's own
    factors — no cold random-start solve per step (``--no-track``
    restores the paper's literal cold retraction);
  * the gradient-spectrum monitor is a ``repro_torch.api.Session`` on the
    drifting batch-gradient operator: warm-started refine solves with a
    restart-vs-refine decision from the subspace angle, and checkpointable
    state (``--session-dir``, in the reference's format).

Run it on the card, or on the CPU at a small width:

    PYTHONPATH=src python -m repro_torch.launch.train_rsl --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train_rsl --device cpu \\
        --d1 600 --d2 500 --n-train 2048 --steps 100

``main(argv)`` prints the reference's lines and returns a summary dict
(ms a step, losses, accuracy, spectra, the session's solves and counts).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.api import SVDSpec, session
from repro_torch.core import manifold as mf
from repro_torch.core import rsgd
from repro_torch.core._keys import fold_in
from repro_torch.data.synthetic import (RSLDataset, make_rsl_dataset,
                                        rsl_batch)

# fold_in tags of the run's streams (batches use (seed, step) directly)
_DATA, _POINT, _SESSION, _COLD = 0, 1, 2, 3


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d1", type=int, default=10000)
    ap.add_argument("--d2", type=int, default=10000)
    ap.add_argument("--rank", type=int, default=5)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3.0)
    ap.add_argument("--fsvd-iters", type=int, default=20,
                    help="paper Fig 2: 20 = 'lower iter', 35 = 'higher'")
    ap.add_argument("--n-train", type=int, default=8192)
    ap.add_argument("--no-track", action="store_true",
                    help="cold retraction solves from a drawn start vector "
                         "(paper-literal Alg 4) instead of warm-started "
                         "tracking")
    ap.add_argument("--grad-spectrum", action="store_true",
                    help="track the batch-gradient operator's top spectrum "
                         "with a repro_torch.api.Session (logged every 50 "
                         "steps)")
    ap.add_argument("--session-dir", default=None,
                    help="checkpoint/resume the gradient-spectrum session "
                         "state under this directory")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data, the start point, the session "
                         "and the batches")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain-torch path)")
    return ap.parse_args(argv)


def build(seed: int, n_train: int, d1: int, d2: int, rank: int,
          device) -> tuple[RSLDataset, mf.FixedRankPoint]:
    """The run's dataset and start point, drawn on ``device`` from
    ``seed``."""
    ds = make_rsl_dataset(fold_in(seed, _DATA, device=device), n_train, d1,
                          d2, rank, noise=0.05)
    W = mf.random_point(fold_in(seed, _POINT, device=device), d1, d2, rank)
    return ds, W


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, observe: Optional[Callable[[dict], None]] = None
         ) -> dict:
    """Run the trainer.  ``observe``, when given, is called after every
    step with {"step", "W_prev", "batch", "W", "loss"} and, on the logged
    steps of a gradient-spectrum run, "grad" (the batch gradient's
    operator) and "grad_fact" (the session's factorization of it)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    print(f"[rsl] W: {args.d1} x {args.d2} rank {args.rank} "
          f"({args.d1 * args.d2 / 1e6:.0f}M entries, never materialized) "
          f"on {dev}")
    ds, W = build(args.seed, args.n_train, args.d1, args.d2, args.rank, dev)
    if dev.type == "cuda":
        # drawing X makes a temporary of X's size: the loop's peak is read
        # against what is allocated from here on
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start_bytes = torch.cuda.memory_allocated(dev)
    opts = rsgd.RSGDOptions(lr=args.lr, fsvd_iters=args.fsvd_iters,
                            track=not args.no_track)
    mode = ("tracking (warm-started F-SVD)" if opts.track
            else "cold F-SVD from a drawn start (paper-literal)")
    print(f"[rsl] retraction: {mode}")
    step = rsgd.make_step(opts)

    def generator(t):
        # only a cold retraction draws; tracking needs no generator
        return None if opts.track else fold_in(args.seed, _COLD, t,
                                               device=dev)

    grad_sess = None
    resumed_at = None
    if args.grad_spectrum:
        b0 = rsl_batch(ds, args.seed, 0, args.batch)
        g0 = rsgd.batch_euclidean_grad(W, b0["x"], b0["v"], b0["y"],
                                       opts.loss, opts.weight_decay)
        # the gradient drifts slowly along the trajectory: a Session
        # re-solves it warm from the previous step's Ritz basis.
        grad_sess = session(g0.op, SVDSpec(method="fsvd", rank=args.rank),
                            generator=fold_in(args.seed, _SESSION,
                                              device=dev))
        if args.session_dir and grad_sess.load_latest(args.session_dir):
            resumed_at = grad_sess.solves
            print(f"[rsl] gradient-spectrum session resumed at solve "
                  f"{grad_sess.solves}")

    b = rsl_batch(ds, args.seed, 0, args.batch)
    step(W, b["x"], b["v"], b["y"], generator(0))     # warm-up
    _sync(dev)
    losses = []
    t0 = time.perf_counter()
    for t in range(args.steps):
        b = rsl_batch(ds, args.seed, t, args.batch)
        W_prev = W
        W, loss = step(W, b["x"], b["v"], b["y"], generator(t))
        losses.append(loss)
        event = None if observe is None else dict(
            step=t, W_prev=W_prev, batch=b, W=W, loss=loss)
        if t % 50 == 0:
            acc = float(rsgd.accuracy(W, b["x"], b["v"], b["y"]))
            msg = (f"[rsl] step {t:4d}: loss {float(loss):.4f} "
                   f"batch-acc {acc * 100:.1f}%")
            if grad_sess is not None:
                g = rsgd.batch_euclidean_grad(W, b["x"], b["v"], b["y"],
                                              opts.loss, opts.weight_decay)
                gf = grad_sess.update(g.op)
                rec = grad_sess.history[-1]
                msg += (f" | grad sigma1 {float(gf.s[0]):.3e} "
                        f"({rec['kind']}, {rec['iterations']} GK iters)")
                if event is not None:
                    event.update(grad=g.op, grad_fact=gf)
            print(msg)
        if event is not None:
            observe(event)
    _sync(dev)
    dt = time.perf_counter() - t0
    peak = None
    if dev.type == "cuda":
        peak = dict(start_bytes=start_bytes,
                    peak_bytes=torch.cuda.max_memory_allocated(dev))
    acc = float(rsgd.accuracy(W, ds.X, ds.V, ds.y))
    print(f"[rsl] {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1e3:.1f} ms/step); "
          f"train acc {acc*100:.1f}%")
    print(f"[rsl] learned spectrum: {[f'{x:.2f}' for x in W.s.tolist()]}")
    s_true = ds.true_spectrum()
    print(f"[rsl] planted spectrum (top-5): "
          f"{[f'{x:.2f}' for x in s_true[:5].tolist()]}")
    summary = dict(device=str(dev), steps=args.steps,
                   ms_per_step=dt / max(args.steps, 1) * 1e3,
                   losses=torch.stack(losses).tolist() if losses else [],
                   train_acc=acc, spectrum=W.s.tolist(),
                   planted=s_true[:args.rank].tolist(), W=W, memory=peak,
                   session=None)
    if grad_sess is not None:
        counts = grad_sess.counts()
        print(f"[rsl] gradient-spectrum session: {grad_sess.solves} solves "
              f"({counts['refine']} refined, {counts['restart']} restarts)")
        summary["session"] = dict(
            solves=grad_sess.solves, counts=counts, resumed_at=resumed_at,
            kinds=[rec["kind"] for rec in grad_sess.history])
        if args.session_dir:
            grad_sess.save(args.session_dir)
            print(f"[rsl] session state saved to {args.session_dir}")
    return summary


if __name__ == "__main__":
    main()
