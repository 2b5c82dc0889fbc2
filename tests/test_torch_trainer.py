"""The port's fault-tolerant Trainer (``repro_torch.runtime.trainer``): the
cases of tests/test_trainer.py, and checkpoints carried across packages.

A reduced stablelm (2 layers, f32) trains on the CPU.  A checkpoint the
reference's ``Trainer`` writes resumes the port's with every leaf equal
bit for bit, and one the port's writes restores through the reference's
``CheckpointManager.restore_latest`` with every leaf equal bit for bit
(the same leaf names: ``params/...`` with each layer stack one leaf,
``opt/step``, ``opt/mu/...``, ``opt/nu/...``).  A bf16 model's state
comes back bf16, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.checkpoint.store import _named_leaves
from repro_torch.configs import RunConfig, get_arch
from repro_torch.configs.base import (CheckpointConfig, OptimConfig,
                                      RuntimeConfig, ShapeConfig)
from repro_torch.data.synthetic import LMBatchSpec, lm_batch
from repro_torch.runtime import Trainer, build_train_step
from repro_torch.runtime.steps import init_state
from repro_torch.runtime.trainer import StragglerWatchdog, saved_state


def _run_cfg(cfg, opt, tmp_path, every, async_write=False):
    return RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                     optim=opt,
                     checkpoint=CheckpointConfig(directory=str(tmp_path),
                                                 every_steps=every,
                                                 async_write=async_write),
                     runtime=RuntimeConfig(max_nan_skips=3, log_every=0))


def _setup(tmp_path, every=10, async_write=False, cfg=None):
    cfg = cfg or get_arch("stablelm-1.6b").reduced(num_layers=2)
    opt = OptimConfig(lr=1e-3, warmup_steps=2, total_steps=100)
    run = _run_cfg(cfg, opt, tmp_path, every, async_write)
    state = init_state(cfg, opt, torch.Generator().manual_seed(0))
    step = build_train_step(cfg, opt)
    spec = LMBatchSpec(4, 32, cfg.vocab_size)
    return cfg, run, state, step, spec


def _batches(spec):
    return lambda s: lm_batch(spec, 0, s, device="cpu")


def _trainer(run, step, spec, state, **kw):
    return Trainer(run, step, _batches(spec), state, install_sigterm=False,
                   log_fn=lambda s: None, **kw)


def _leaves(state) -> dict:
    return {k: v.detach() for k, v in _named_leaves(saved_state(state))}


def _assert_bits(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y), k


def test_loss_decreases(tmp_path):
    cfg, run, state, step, spec = _setup(tmp_path)
    hist = _trainer(run, step, spec, state).run(40)
    assert np.mean([h["loss"] for h in hist[-5:]]) \
        < np.mean([h["loss"] for h in hist[:5]])


def test_resume_continues_from_checkpoint(tmp_path):
    cfg, run, state, step, spec = _setup(tmp_path, every=10)
    tr = _trainer(run, step, spec, state)
    tr.run(15)   # checkpoints at 10 and a final one at 15

    state2 = init_state(cfg, run.optim, torch.Generator().manual_seed(42))
    tr2 = _trainer(run, step, spec, state2)
    assert tr2.maybe_resume()
    assert tr2.step == 15
    # every resumed leaf (params, step, moments) is the saved one
    _assert_bits(_leaves(tr.state), _leaves(tr2.state))
    # and training goes on from there
    assert len(tr2.run(2)) == 2 and tr2.step == 17


def test_nan_guard_skips_and_aborts(tmp_path):
    cfg, run, state, step, spec = _setup(tmp_path)

    def bad_step(state, batch):
        new_state, metrics = step(state, batch)
        metrics = dict(metrics)
        metrics["loss"] = torch.tensor(float("nan"))
        metrics["skipped"] = torch.tensor(1, dtype=torch.int32)
        return state, metrics   # state unchanged = skip semantics

    tr = _trainer(run, bad_step, spec, state)
    with pytest.raises(RuntimeError, match="consecutive"):
        tr.run(10)
    assert tr.consecutive_nans >= 4


def test_in_graph_nan_guard_preserves_state():
    cfg = get_arch("stablelm-1.6b").reduced(num_layers=1)
    opt = OptimConfig(lr=1e-3)
    state = init_state(cfg, opt, torch.Generator().manual_seed(0))
    step = build_train_step(cfg, opt, nan_guard=True)
    batch = lm_batch(LMBatchSpec(2, 16, cfg.vocab_size), 0, 0, device="cpu")
    # poison the embedding row of a token that actually occurs in the batch
    tok0 = int(batch["tokens"][0, 0])
    with torch.no_grad():
        state.model.embed[tok0] = float("nan")
    before = _leaves(state)
    new_state, metrics = step(state, batch)
    assert int(metrics["skipped"]) == 1
    _assert_bits(before, _leaves(new_state))


def test_straggler_watchdog_flags_outlier():
    wd = StragglerWatchdog(zscore=3.0, window=50)
    for i in range(30):
        assert not wd.observe(i, 0.1 + 0.001 * (i % 3))
    assert wd.observe(31, 1.5)          # 10x step time -> alarm
    assert len(wd.alarms) == 1


def test_sigterm_drain(tmp_path):
    cfg, run, state, step, spec = _setup(tmp_path, every=1000)
    tr = _trainer(run, step, spec, state)

    orig_step = tr.train_step

    def step_then_term(st, b):
        out = orig_step(st, b)
        if tr.step == 5:
            tr._on_sigterm(None, None)    # SIGTERM mid-run
        return out
    tr.train_step = step_then_term
    tr.run(50)
    assert tr.step == 6                    # drained right after step 5
    assert latest_step(str(tmp_path)) == 6   # final checkpoint written


def test_trainer_checkpoints_and_resumes_solver_session(tmp_path):
    """A tracking Session handed to the trainer checkpoints beside the
    model state and resumes warm: the restarted trainer's session starts
    from the saved factorization, and its next update refines."""
    from repro_torch.api import SVDSpec, session
    g = torch.Generator().manual_seed(3)
    A = torch.randn(24, 4, generator=g) @ torch.randn(4, 18, generator=g)
    spec_s = SVDSpec(method="fsvd", rank=3, max_iters=12)
    sess = session(A, spec_s, generator=torch.Generator().manual_seed(3))
    sess.solve()

    cfg, run, state, step, spec = _setup(tmp_path, every=10)
    tr = _trainer(run, step, spec, state, session=sess)
    tr.run(5)       # final checkpoint (+ session state) at step 5

    sess2 = session(A, spec_s, generator=torch.Generator().manual_seed(3))
    state2 = init_state(cfg, run.optim, torch.Generator().manual_seed(9))
    tr2 = _trainer(run, step, spec, state2, session=sess2)
    assert tr2.maybe_resume()
    assert sess2.fact is not None and sess2.solves == sess.solves
    assert torch.equal(sess2.fact.s, sess.fact.s)
    # the resumed session refines (warm) rather than re-solving cold
    sess2.update(A + 1e-3 * torch.randn(A.shape, generator=g))
    assert sess2.history[-1]["kind"] == "refine"


def test_bf16_state_resumes_as_bf16_bit_for_bit(tmp_path):
    cfg = dataclasses.replace(get_arch("stablelm-1.6b").reduced(num_layers=2),
                              dtype="bfloat16", param_dtype="bfloat16")
    cfg, run, state, step, spec = _setup(tmp_path, every=2, cfg=cfg)
    tr = _trainer(run, step, spec, state)
    tr.run(2)
    tr2 = _trainer(run, step, spec, init_state(
        cfg, run.optim, torch.Generator().manual_seed(4)))
    assert tr2.maybe_resume() and tr2.step == 2
    assert tr2.state.model.embed.dtype == torch.bfloat16
    _assert_bits(_leaves(tr.state), _leaves(tr2.state))


# --- across packages --------------------------------------------------------

def _ref_setup(tmp_path, every):
    from repro.configs import RunConfig as RRun
    from repro.configs import get_arch as ref_get_arch
    from repro.configs.base import (CheckpointConfig as RCk,
                                    OptimConfig as ROpt,
                                    RuntimeConfig as RRt,
                                    ShapeConfig as RShape)
    from repro.runtime import build_train_step as ref_step
    from repro.runtime.steps import init_state as ref_init
    cfg = ref_get_arch("stablelm-1.6b").reduced(num_layers=2)
    opt = ROpt(lr=1e-3, warmup_steps=2, total_steps=100)
    run = RRun(model=cfg, shape=RShape("t", "train", 32, 4), optim=opt,
               checkpoint=RCk(directory=str(tmp_path), every_steps=every,
                              async_write=False),
               runtime=RRt(max_nan_skips=3, log_every=0))
    return run, ref_init(cfg, opt, jax.random.PRNGKey(0)), \
        jax.jit(ref_step(cfg, opt))


def _ref_leaves(tree) -> dict:
    from repro.checkpoint.store import _key_name
    return {"/".join(_key_name(p) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_checkpoint_resumes_the_port(tmp_path):
    from repro.data.synthetic import LMBatchSpec as RSpec
    from repro.data.synthetic import lm_batch as ref_batch
    from repro.runtime import Trainer as RefTrainer
    run, state, step = _ref_setup(tmp_path, every=10)
    spec = RSpec(4, 32, 512)
    ref = RefTrainer(run, step, lambda s: ref_batch(spec, 0, s), state,
                     install_sigterm=False, log_fn=lambda s: None)
    ref.run(3)                        # the final checkpoint at step 3

    cfg, prun, pstate, pstep, pspec = _setup(tmp_path, every=10)
    tr = _trainer(prun, pstep, pspec, init_state(
        cfg, prun.optim, torch.Generator().manual_seed(5)))
    assert tr.maybe_resume() and tr.step == 3
    want = _ref_leaves(ref.state)
    got = {k: v.numpy() for k, v in _leaves(tr.state).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port trains on from the reference's state
    assert np.isfinite(tr.run(1)[0]["loss"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    from repro.checkpoint import CheckpointManager as RefManager
    cfg, run, state, step, spec = _setup(tmp_path, every=10)
    tr = _trainer(run, step, spec, state)
    tr.run(3)                         # the final checkpoint at step 3

    _, template, _ = _ref_setup(tmp_path, every=10)
    restored = RefManager(str(tmp_path)).restore_latest(template)
    assert restored is not None
    step_no, tree, _ = restored
    assert step_no == 3
    want = {k: v.numpy() for k, v in _leaves(tr.state).items()}
    got = _ref_leaves(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(tree.opt.step) == 3
