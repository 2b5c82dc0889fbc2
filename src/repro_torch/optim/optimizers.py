"""AdamW / SGD with decoupled weight decay and global-norm clipping.
Counterpart of ``repro.optim.optimizers``.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name (``dict(model.named_parameters())``).  Moments are kept in f32
whatever the parameter dtype, and every update is computed in f32 and
cast back to the parameter's dtype.  The bias correction and the
decoupled weight decay follow the reference's formula (not
``torch.optim``'s).  Nothing reads a value back to the host: the step, the
learning rate and the norm stay tensors on the parameters' device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import OptimConfig
from repro_torch.optim.schedules import make_schedule

Tensor = torch.Tensor


class OptState(NamedTuple):
    step: Tensor                 # () int32
    mu: dict                     # first moment (f32); the momentum for sgd
    nu: Optional[dict]           # second moment (f32); None for sgd


def _f32_zeros_like(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _step0(params: dict) -> Tensor:
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params: dict) -> OptState:
    return OptState(_step0(params), _f32_zeros_like(params),
                    _f32_zeros_like(params))


def sgd_init(params: dict) -> OptState:
    return OptState(_step0(params), _f32_zeros_like(params), None)


def global_norm(tree: dict) -> Tensor:
    """The f32 2-norm of every tensor of ``tree`` together."""
    sq = [x.float().square().sum() for x in tree.values()]
    return torch.stack(sq).sum().sqrt()


def clip_by_global_norm(grads: dict, max_norm: float,
                        gnorm: Optional[Tensor] = None
                        ) -> tuple[dict, Tensor]:
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / gnorm.clamp(min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gnorm


def make_optimizer(cfg: OptimConfig) -> tuple[
        Callable[[dict], OptState],
        Callable[[dict, OptState, dict], tuple[dict, OptState, dict]]]:
    """Returns (init_fn, update_fn).

    ``update_fn(params, state, grads, gnorm=None) -> (new_params,
    new_state, stats)`` with new tensors (the inputs are not changed);
    ``stats`` holds the pre-clip ``grad_norm`` and the step's ``lr``.
    ``gnorm`` clips by a norm computed elsewhere (the global norm of a
    sharded step, whose ``grads`` are one rank's blocks).
    """
    sched = make_schedule(cfg)

    if cfg.name == "adamw":
        def update(params, state, grads, gnorm=None):
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
            step = state.step + 1
            t = step.to(torch.float32)
            lr = sched(state.step)
            b1, b2 = cfg.b1, cfg.b2
            c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
            new_p, mu, nu = {}, {}, {}
            for k, p in params.items():
                g32 = grads[k].float()
                m = b1 * state.mu[k] + (1 - b1) * g32
                v = b2 * state.nu[k] + (1 - b2) * g32.square()
                delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
                p32 = p.float()
                delta = delta + cfg.weight_decay * p32
                new_p[k] = (p32 - lr * delta).to(p.dtype)
                mu[k], nu[k] = m, v
            return new_p, OptState(step, mu, nu), \
                {"grad_norm": gnorm, "lr": lr}

        return adamw_init, update

    if cfg.name == "sgd":
        def update(params, state, grads, gnorm=None):
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, gnorm)
            step = state.step + 1
            lr = sched(state.step)
            new_p, mu = {}, {}
            for k, p in params.items():
                p32 = p.float()
                g32 = grads[k].float() + cfg.weight_decay * p32
                m = cfg.b1 * state.mu[k] + g32
                new_p[k] = (p32 - lr * m).to(p.dtype)
                mu[k] = m
            return new_p, OptState(step, mu, None), \
                {"grad_norm": gnorm, "lr": lr}

        return sgd_init, update

    raise ValueError(f"unknown optimizer {cfg.name!r}")


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}
