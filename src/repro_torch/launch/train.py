"""Training CLI.  Counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --reduced --steps 100 --batch 8 --seq 128

Runs on the card (``--device cpu`` for the CPU).  ``--reduced`` is the
tiny same-family config; ``--mesh single|multi`` lays the state out on
the production mesh (``launch.mesh.make_production_mesh``: a process
group of 256 or 512 ranks that the caller has initialised), each rank
holding its blocks (``runtime.steps.shard_state``).  Supports checkpoint
auto-resume, the on-device NaN guard and straggler telemetry through the
``runtime.Trainer``.  ``--compress`` sets
``FsvdConfig.compress_gradients`` in the run's config, which no step
reads, as in the reference (``runtime.steps.build_compressed_train_step``
is the compressed step).

``main(argv)`` returns {"losses", "ms_per_step", "steps"}.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, RunConfig, get_arch
from repro_torch.configs.base import (CheckpointConfig, FsvdConfig,
                                      MeshConfig, OptimConfig, RuntimeConfig,
                                      ShapeConfig)
from repro_torch.data.synthetic import lm_batch, spec_for
from repro_torch.launch.mesh import mesh_from_config
from repro_torch.runtime import Trainer
from repro_torch.runtime.steps import (build_train_step,
                                       init_sharded_state, init_state,
                                       shard_state)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "krylovlr_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true",
                    help="sets FsvdConfig.compress_gradients (read by no "
                         "step, as in the reference)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    optim = OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps)
    run = RunConfig(
        model=cfg, shape=shape, optim=optim,
        mesh=MeshConfig(multi_pod=args.mesh == "multi"),
        fsvd=FsvdConfig(compress_gradients=args.compress),
        checkpoint=CheckpointConfig(directory=args.ckpt_dir,
                                    every_steps=args.ckpt_every),
        runtime=RuntimeConfig(), seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    sharding_fn = None
    if args.mesh != "none":
        mesh = mesh_from_config(run.mesh, device_type=device.type)
        sharding_fn = functools.partial(shard_state, mesh=mesh, cfg=cfg)
        step_fn = build_train_step(cfg, optim, mesh)     # refuses first
        state = init_sharded_state(cfg, optim, gen, mesh)
    else:
        state = init_state(cfg, optim, gen)
        step_fn = build_train_step(cfg, optim)

    spec = spec_for(cfg, shape)
    trainer = Trainer(run, step_fn,
                      lambda s: lm_batch(spec, args.seed, s, device=device),
                      state, state_sharding_fn=sharding_fn)
    trainer.maybe_resume()
    hist = trainer.run(args.steps)
    losses = [h["loss"] for h in hist]
    ms = float(np.mean([h["time"] for h in hist]) * 1e3)
    print(f"[train] {args.arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({len(hist)} steps, {ms:.0f} ms/step)")
    return {"losses": losses, "ms_per_step": ms, "steps": trainer.step}


if __name__ == "__main__":
    main()
