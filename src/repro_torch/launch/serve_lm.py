"""Batched LM serving with a KV cache (reduced config).  Counterpart of
``examples/serve_lm.py``.

Prefill once, then greedy-decode with the per-family cache (GQA KV, MLA
latents, SSD states).  Runs on the card (``--device cpu`` for the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch zamba2-1.2b \\
        --gen 24
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.serve import generate, prompts_for
from repro_torch.models import model as model_mod


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    model, _ = model_mod.init_model(
        cfg, torch.Generator(device=device).manual_seed(0))
    prompts, frames = prompts_for(cfg, args.batch, args.prompt_len, 1,
                                  device)
    generate(model, cfg, prompts, args.gen, frames)          # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = generate(model, cfg, prompts, args.gen, frames)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"[serve] {args.arch} ({cfg.family}): {toks} tokens in {dt:.2f}s "
          f"-> {toks / dt:.1f} tok/s (batch {args.batch})")
    print("[serve] continuations:")
    for row in out[:, args.prompt_len:].tolist():
        print("  ", row)
    return out


if __name__ == "__main__":
    main()
