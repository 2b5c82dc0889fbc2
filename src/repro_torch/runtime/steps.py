"""Step functions of one device, shared by the trainer and the serving
loop.  Counterpart of the single-device ``build_*`` functions of
``repro.runtime.steps``.

A :class:`TrainState` holds the model module (its parameters) and the
optimizer state.  A train step updates the module's parameters in place
and returns the new optimizer state; every other step leaves the
module alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, OptimConfig
from repro_torch.models import model as model_mod
from repro_torch.optim import OptState, make_optimizer


class TrainState(NamedTuple):
    model: model_mod.ParamTree     # the parameters; a step updates them
    opt: OptState


def init_state(cfg: ModelConfig, optim_cfg: OptimConfig,
               generator: torch.Generator) -> TrainState:
    model, _ = model_mod.init_model(cfg, generator)
    opt_init, _ = make_optimizer(optim_cfg)
    return TrainState(model, opt_init(dict(model.named_parameters())))


def _select(ok: torch.Tensor, new, old):
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: torch.where(ok, v, old[k]) for k, v in new.items()}
    return torch.where(ok, new, old)


def build_train_step(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                     nan_guard: bool = True, keep_grads: bool = False):
    """(state, batch) -> (new_state, metrics dict).

    The NaN guard runs on the device: a non-finite loss or gradient norm
    turns the update into a ``torch.where`` select of the old values (no
    value is read back to the host), reported as ``metrics["skipped"]``.
    ``keep_grads`` adds the gradients, by parameter name, as
    ``metrics["grads"]``.
    """
    _, opt_update = make_optimizer(optim_cfg)

    def train_step(state: TrainState, batch: dict):
        named = dict(state.model.named_parameters())
        loss, met = model_mod.loss_fn(state.model, batch, model_cfg)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(named.items(), grads)}
        with torch.no_grad():
            params = {k: p.detach() for k, p in named.items()}
            new_params, new_opt, stats = opt_update(params, state.opt, grads)
            metrics = {"loss": loss.detach(), "ce": met.ce.detach(),
                       "aux": met.aux.detach(), "n_tokens": met.n_tokens,
                       **stats}
            if nan_guard:
                ok = torch.isfinite(loss) & torch.isfinite(stats["grad_norm"])
                new_params = _select(ok, new_params, params)
                new_opt = OptState(*(_select(ok, n, o) for n, o in
                                     zip(new_opt, state.opt)))
                metrics["skipped"] = (~ok).to(torch.int32)
            for k, p in named.items():
                p.copy_(new_params[k])
        if keep_grads:
            metrics["grads"] = grads
        return TrainState(state.model, new_opt), metrics

    return train_step


def build_eval_step(model_cfg: ModelConfig):
    def eval_step(model, batch):
        with torch.no_grad():
            loss, met = model_mod.loss_fn(model, batch, model_cfg)
        return {"loss": loss, "ce": met.ce, "n_tokens": met.n_tokens}
    return eval_step


def build_prefill_step(model_cfg: ModelConfig):
    def prefill(model, batch):
        with torch.no_grad():
            return model_mod.prefill_step(model, batch, model_cfg)
    return prefill


def build_decode_step(model_cfg: ModelConfig):
    def decode(model, cache, batch):
        with torch.no_grad():
            return model_mod.decode_step(model, cache, batch, model_cfg)
    return decode
