"""The port's single-device step factories (``repro_torch.runtime.steps``)
against the reference's (``repro.runtime.steps``).

``build_train_step`` on the reference's params and batch (carried over):
the loss and the pre-clip gradient norm within 1e-5 relative; with SGD
(momentum, so the update is linear in the gradient) the new params within
1e-5 of each leaf's max |p|; with AdamW the new moments within 1e-4 of
each leaf's max (the reference's gradient bound).  The NaN guard
(tests/test_trainer.py::test_in_graph_nan_guard_preserves_state): a NaN
batch leaves params and optimizer state bit for bit unchanged and
reports ``skipped == 1``.  The eval, prefill and decode steps give the
model functions' values; the runtime resolves its step members lazily.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_ref as L
from repro.configs import get_arch as ref_get_arch
from repro.configs.base import OptimConfig as RefOptimConfig
from repro.optim import make_optimizer as ref_make_optimizer
from repro.runtime import steps as RS
from repro_torch import bridge
from repro_torch.configs import OptimConfig, get_arch
from repro_torch.data.synthetic import LMBatchSpec, lm_batch
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer
from repro_torch.runtime import steps as TS


def _ref_step(arch, opt):
    """One reference train step from its init params on its batch."""
    ref = L.reference(arch)
    params = jax.tree.map(jnp.asarray, ref["params"])
    opt = RefOptimConfig(**opt)
    state = RS.TrainState(params, ref_make_optimizer(opt)[0](params))
    return RS.build_train_step(ref_get_arch(arch).reduced(), opt)(
        state, jax.tree.map(jnp.asarray, ref["batch"]))


def _port_step(arch, opt):
    """The port's step from the same params (carried over) and batch."""
    ref = L.reference(arch)
    cfg, opt = get_arch(arch).reduced(), OptimConfig(**opt)
    model = bridge.model_params(cfg, ref["params"], device="cpu")
    state = TS.TrainState(model, make_optimizer(opt)[0](
        dict(model.named_parameters())))
    return TS.build_train_step(cfg, opt)(state, L.to_torch(ref["batch"]))


def _tree_np(named):
    return jax.tree.map(lambda t: t.numpy(), bridge.reference_tree(named))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_sgd_train_step_matches_reference(arch):
    opt = dict(name="sgd", lr=0.1, warmup_steps=0, weight_decay=0.01)
    new, met = _ref_step(arch, opt)
    state, metrics = _port_step(arch, opt)
    assert int(metrics["skipped"]) == int(met["skipped"]) == 0
    for key in ("loss", "grad_norm"):
        assert abs(float(metrics[key]) - float(met[key])) <= \
            1e-5 * abs(float(met[key])), key
    got = _tree_np(state.model)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(
            jax.tree.map(np.asarray, new.params))):
        assert float(np.max(np.abs(g - r))) <= \
            1e-5 * float(np.max(np.abs(r)))


def test_adamw_train_step_moments_match_reference():
    opt = dict(name="adamw", lr=1e-3, warmup_steps=0)
    new, met = _ref_step("gemma2-9b", opt)
    state, metrics = _port_step("gemma2-9b", opt)
    assert abs(float(metrics["loss"]) - float(met["loss"])) <= \
        1e-5 * abs(float(met["loss"]))
    assert int(state.opt.step) == int(new.opt.step) == 1
    for mine, ref in ((state.opt.mu, new.opt.mu), (state.opt.nu, new.opt.nu)):
        got = _tree_np(mine)
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(
                jax.tree.map(np.asarray, ref))):
            assert float(np.max(np.abs(g - r))) <= \
                1e-4 * max(float(np.max(np.abs(r))), 1e-30)


def test_in_graph_nan_guard_preserves_state():
    cfg = get_arch("stablelm-1.6b").reduced(num_layers=1)
    opt = OptimConfig(lr=1e-3)
    state = TS.init_state(cfg, opt, torch.Generator().manual_seed(0))
    step = TS.build_train_step(cfg, opt, nan_guard=True)
    batch = lm_batch(LMBatchSpec(2, 16, cfg.vocab_size), 0, 0, device="cpu")
    # one good step, so the optimizer state is not all zeros
    state, metrics = step(state, batch)
    assert int(metrics["skipped"]) == 0
    # poison the embedding row of a token that occurs in the batch
    tok0 = int(batch["tokens"][0, 0])
    with torch.no_grad():
        state.model.embed[tok0] = float("nan")
    params = {k: p.detach().clone() for k, p in
              state.model.named_parameters()}
    opt_before = jax.tree.map(lambda t: t.clone(), tuple(state.opt),
                              is_leaf=lambda x: isinstance(x, torch.Tensor))
    new_state, metrics = step(state, batch)
    assert int(metrics["skipped"]) == 1
    assert not bool(torch.isfinite(metrics["loss"]))
    for k, p in new_state.model.named_parameters():     # bits, NaNs too
        assert torch.equal(p.detach().view(torch.int32),
                           params[k].view(torch.int32)), k
    after = jax.tree.leaves(tuple(new_state.opt),
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b in zip(after, jax.tree.leaves(
            opt_before, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_train_step_keeps_grads_on_request():
    cfg = get_arch("stablelm-1.6b").reduced(num_layers=1)
    opt = OptimConfig(lr=1e-3, warmup_steps=0)
    state = TS.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batch = lm_batch(LMBatchSpec(2, 16, cfg.vocab_size), 0, 0, device="cpu")
    before = {k: p.detach().clone() for k, p in
              state.model.named_parameters()}
    state, metrics = TS.build_train_step(cfg, opt, keep_grads=True)(
        state, batch)
    assert sorted(metrics["grads"]) == sorted(before)
    assert any(not torch.equal(p, before[k])
               for k, p in state.model.named_parameters())
    assert int(metrics["n_tokens"]) == 2 * 16


def test_eval_prefill_decode_steps():
    cfg, model, _ = L.port_model("gemma2-9b")
    batch = L.port_batch(cfg)
    out = TS.build_eval_step(cfg)(model, batch)
    with torch.no_grad():
        loss, met = TM.loss_fn(model, batch, cfg)
    assert float(out["loss"]) == float(loss)
    assert int(out["n_tokens"]) == int(met.n_tokens)
    prompt = {"tokens": batch["tokens"]}
    logits, cache = TS.build_prefill_step(cfg)(model, prompt)
    assert not logits.requires_grad
    cache = TM.pad_cache_to(cache, cfg, L.S + 1)
    step = {"tokens": batch["tokens"][:, :1],
            "positions": torch.full((L.B, 1), L.S, dtype=torch.int32)}
    got, _ = TS.build_decode_step(cfg)(model, cache, step)
    with torch.no_grad():
        want, _ = TM.decode_step(model, cache, step, cfg)
    assert torch.equal(got, want)


def test_runtime_resolves_step_members_lazily():
    import repro_torch.runtime as R
    assert R.TrainState is TS.TrainState
    assert R.build_train_step is TS.build_train_step
    assert R.build_eval_step is TS.build_eval_step
    from repro_torch.runtime import trainer
    assert R.Trainer is trainer.Trainer
    with pytest.raises(AttributeError):
        R.NoSuchMember
