"""LM training with Krylov low-rank gradient compression (reduced config).
Counterpart of ``examples/train_lm.py``.

Data-parallel training where the per-layer gradient all-reduce is replaced
by the paper's GK factorization of the implicit mean-gradient operator
(``distributed.compression``, with error feedback): each Lanczos
iteration moves one m-vector and one n-vector instead of the m x n
gradient.  ``--world`` gloo ranks (8 by default, the example's 8
devices) form one ("data",) mesh; they all run on the card (each on
cuda:0), or on the CPU with ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 30 \\
        --compress

``main(argv)`` returns rank 0's {"losses", "ratio", "seconds"}.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.configs.base import FsvdConfig, OptimConfig
from repro_torch.data.synthetic import LMBatchSpec, lm_batch


def _rank(rank, world, args, device, out):
    from repro_torch import bridge
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.matvec import psum
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as model_mod
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime.steps import shard_batch
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh((world,), ("data",), device_type=device)
    cfg = get_arch(args.arch).reduced()
    fcfg = FsvdConfig(compression_rank=args.rank, compression_min_dim=64,
                      max_iters=2 * args.rank)
    ocfg = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=args.steps)
    opt_init, opt_update = make_optimizer(ocfg)
    # every rank draws the same parameters
    model, _ = model_mod.init_model(
        cfg, torch.Generator(device=device).manual_seed(0))
    named = dict(model.named_parameters())
    opt_state = opt_init(named)
    ef = C.init_error_feedback(bridge.reference_tree(model), fcfg)
    spec = LMBatchSpec(args.batch, args.seq, cfg.vocab_size)
    losses, ratios = [], []
    t0 = time.perf_counter()
    for t in range(args.steps):
        local = shard_batch(lm_batch(spec, 0, t, device=device), mesh)
        loss, _ = model_mod.loss_fn(model, local, cfg)
        grads = torch.autograd.grad(loss, list(named.values()))
        with torch.no_grad():
            tree = bridge.reference_tree(dict(zip(named, grads)))
            if args.compress:
                mean, ef, stats = C.compressed_mean_grads(
                    tree, ef, "data", fcfg, mesh=mesh)
                ratio = float(stats.compressed_bytes
                              / stats.dense_bytes.clamp(min=1.0))
            else:
                mean = model_mod._map(
                    lambda g: psum(g, mesh, "data") / world, tree)
                ratio = 1.0
            loss = float(psum(loss.detach(), mesh, "data") / world)
            new, opt_state, _ = opt_update(
                {k: p.detach() for k, p in named.items()}, opt_state,
                bridge.named_tensors(mean))
            for k, p in named.items():
                p.copy_(new[k])
        losses.append(loss)
        ratios.append(ratio)
        if rank == 0 and t % 5 == 0:
            print(f"[lm] step {t:3d}: loss {loss:.4f} "
                  f"comm-bytes ratio {ratio:.4f}", flush=True)
    if rank == 0:
        with open(out, "w") as fh:
            json.dump({"losses": losses, "ratio": ratios[-1],
                       "seconds": time.perf_counter() - t0}, fh)


def main(argv=None) -> dict:
    from repro_torch.launch.mesh import run_world
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--world", type=int, default=8,
                    help="gloo ranks, one ('data',) mesh")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        run_world(_rank, args.world, os.path.join(d, "rendezvous"),
                  (args, device, out), threads=1 if device == "cpu" else 0)
        with open(out) as fh:
            rec = json.load(fh)
    mode = "compressed" if args.compress else "dense"
    print(f"[lm] {args.steps} {mode} DP steps on {args.world} ranks in "
          f"{rec['seconds']:.1f}s; final loss {rec['losses'][-1]:.4f}")
    return rec


if __name__ == "__main__":
    main()
