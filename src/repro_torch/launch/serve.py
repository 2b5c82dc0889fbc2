"""Serving CLI: batched prefill + greedy decode with a KV cache.
Counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --reduced --batch 4 --prompt-len 32 --gen 16

Runs on the card (``--device cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import model as model_mod
from repro_torch.runtime.steps import build_decode_step, build_prefill_step


def generate(model, cfg, prompts: torch.Tensor, gen: int,
             frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy generation.  prompts: (B, S) -> (B, S + gen)."""
    B, S = prompts.shape
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frames"] = frames
    logits, cache = build_prefill_step(cfg)(model, batch)
    cache = model_mod.pad_cache_to(cache, cfg, S + gen)
    decode = build_decode_step(cfg)

    tokens = prompts
    next_tok = logits.argmax(-1).to(torch.int32)[:, None]
    for i in range(gen):
        tokens = torch.cat([tokens, next_tok], dim=1)
        if i == gen - 1:
            break
        pos = torch.full((B, 1), S + i, dtype=torch.int32,
                         device=prompts.device)
        logits, cache = decode(model, cache,
                               {"tokens": next_tok, "positions": pos})
        next_tok = logits.argmax(-1).to(torch.int32)[:, None]
    return tokens


def prompts_for(cfg, batch: int, prompt_len: int, seed: int, device):
    """Random prompts (and, for the audio family, frames) from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=device, dtype=torch.int32)
    frames = None
    if cfg.family == "audio":
        frames = torch.randn((batch, prompt_len, cfg.d_model), generator=g,
                             device=device) * 0.02
    return prompts, frames


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model, _ = model_mod.init_model(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    prompts, frames = prompts_for(cfg, args.batch, args.prompt_len,
                                  args.seed + 1, device)
    t0 = time.perf_counter()
    out = generate(model, cfg, prompts, args.gen, frames)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"[serve] {args.arch}: generated {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. prefill)")
    print(out[:, args.prompt_len:].cpu())
    return out


if __name__ == "__main__":
    main()
