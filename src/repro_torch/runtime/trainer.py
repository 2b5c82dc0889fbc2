"""Fault-tolerant training loop.  Counterpart of ``repro.runtime.trainer``.

Failure modes handled (and tested):
  * process death        -> atomic checkpoints + auto-resume from the
                            newest valid one
  * loss/grad NaN or Inf -> the step's on-device no-op select + a host
                            counter; abort after ``max_nan_skips``
                            consecutive skips
  * stragglers           -> per-step EWMA timing; z-score alarms
  * SIGTERM / preemption -> drain: finish the step in flight, write a
                            final checkpoint, return
  * elastic restarts     -> reshard-on-restore: the checkpoint holds whole
                            host arrays; ``state_sharding_fn`` re-places
                            the restored state under the current mesh,
                            which may differ from the writer's

The state is saved in the reference's tree, ``TrainState(params, opt)``
with ``opt = OptState(step, mu, nu)``: the reference's leaf names, each
layer stack one leaf with the layer axis in front
(``bridge.reference_tree``).  A checkpoint written by either package's
trainer resumes the other's.  bfloat16 leaves are written as float32 and
read back as bfloat16 bit for bit (``repro_torch.checkpoint``).

On a mesh the state is a ``runtime.steps.ShardedState``: saving gathers
it on every rank (one collective) and rank 0 writes; every rank restores
the whole state and ``state_sharding_fn`` (``functools.partial(
steps.shard_state, mesh=mesh, cfg=cfg)``) keeps its blocks.

A loop that owns a solver ``repro_torch.api.Session`` hands it to the
trainer: its tracking state checkpoints beside the model state under
``<ckpt_dir>/session`` with the same keep-N, and resumes with
``maybe_resume``.
"""
from __future__ import annotations

import collections
import math
import os
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.models import model as model_mod
from repro_torch.optim import OptState
from repro_torch.runtime import steps as S


class StragglerWatchdog:
    """EWMA step-time monitor: flags steps whose duration z-score exceeds
    the threshold (the single-host stand-in for per-host heartbeats)."""

    def __init__(self, zscore: float = 3.0, window: int = 50):
        self.z = zscore
        self.times: collections.deque = collections.deque(maxlen=window)
        self.alarms: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        flagged = False
        if len(self.times) >= 10:
            mu = float(np.mean(self.times))
            sd = float(np.std(self.times)) + 1e-9
            if (dt - mu) / sd > self.z:
                self.alarms.append((step, dt, mu))
                flagged = True
        self.times.append(dt)
        return flagged


def saved_state(state) -> S.SavedState:
    """A :class:`~repro_torch.runtime.steps.TrainState` (or a sharded one,
    gathered: a collective) in the reference's tree."""
    if isinstance(state, S.ShardedState):
        state = S.gather_state(state)
    opt = state.opt
    return S.SavedState(bridge.reference_tree(state.model),
                        OptState(opt.step, bridge.reference_tree(opt.mu),
                                 None if opt.nu is None else
                                 bridge.reference_tree(opt.nu)))


def _template(state) -> tuple[S.SavedState, torch.device]:
    """The tree a restore fills (shapes and dtypes) and its device."""
    if not isinstance(state, S.ShardedState):
        return saved_state(state), state.opt.step.device

    def meta(f32):
        return {k: torch.empty(lf.shape, device="meta",
                               dtype=torch.float32 if f32 else lf.dtype)
                for k, lf in state.layout.items()}
    opt = state.opt
    return (S.SavedState(bridge.reference_tree(meta(False)),
                         OptState(opt.step, bridge.reference_tree(meta(True)),
                                  None if opt.nu is None else
                                  bridge.reference_tree(meta(True)))),
            opt.step.device)


def _cast(tree, like):
    """``tree`` with every tensor cast to the dtype of ``like``'s."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cast(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_cast(a, b) for a, b in zip(tree, like)))
    return tree.to(like.dtype)


def loaded_state(tree: S.SavedState) -> S.TrainState:
    """A restored ``steps.SavedState`` as a whole ``TrainState``."""
    named = bridge.named_tensors(tree.params)
    opt = tree.opt
    return S.TrainState(
        model_mod.ParamTree(S._nest(named)),
        OptState(opt.step, bridge.named_tensors(opt.mu),
                 None if opt.nu is None else bridge.named_tensors(opt.nu)))


class Trainer:
    """Drives ``train_step`` with checkpointing, NaN accounting, straggler
    telemetry and SIGTERM draining."""

    def __init__(self, run_cfg: RunConfig, train_step: Callable,
                 batch_fn: Callable[[int], dict], state: Any,
                 state_sharding_fn: Optional[Callable] = None,
                 log_fn: Callable[[str], None] = print,
                 install_sigterm: bool = True, session=None):
        self.cfg = run_cfg
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.state = state
        self.log = log_fn
        self.ckpt = CheckpointManager(run_cfg.checkpoint.directory,
                                      keep=run_cfg.checkpoint.keep,
                                      async_write=run_cfg.checkpoint.async_write)
        self.watchdog = StragglerWatchdog(run_cfg.runtime.straggler_zscore,
                                          run_cfg.runtime.straggler_window)
        self.state_sharding_fn = state_sharding_fn
        self.session = session       # optional repro_torch.api.Session
        self.step = 0
        self.consecutive_nans = 0
        self.history: list[dict] = []
        self._drain = False
        # on a process group, rank 0 writes the checkpoints
        self._writer = not dist.is_initialized() or dist.get_rank() == 0
        if install_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._on_sigterm)
            except ValueError:
                pass           # not on the main thread (tests)

    def _on_sigterm(self, signum, frame):
        self.log("[trainer] SIGTERM received - draining")
        self._drain = True

    @property
    def _session_dir(self) -> str:
        return os.path.join(self.cfg.checkpoint.directory, "session")

    def _save(self) -> None:
        tree = saved_state(self.state)
        if not self._writer:
            return
        self.ckpt.save(self.step, tree, extra={"run": self.cfg.to_dict()})
        if self.session is not None:
            # the model checkpoints' keep-N, so a rolled-back restore
            # still finds a matching session state
            self.session.save(self._session_dir, self.step,
                              keep=self.ckpt.keep)

    def maybe_resume(self) -> bool:
        template, device = _template(self.state)
        restored = self.ckpt.restore_latest(template, device=device)
        if restored is None:
            return False
        step, tree, _ = restored
        state = loaded_state(_cast(tree, template))
        if self.state_sharding_fn is not None:
            state = self.state_sharding_fn(state)
        self.state = state
        self.step = step
        if self.session is not None and self.session.load_latest(
                self._session_dir):
            self.log(f"[trainer] solver session resumed "
                     f"({self.session.solves} tracked solves)")
        self.log(f"[trainer] resumed from step {step}")
        return True

    def run(self, num_steps: int) -> list[dict]:
        cfg = self.cfg
        end = self.step + num_steps
        while self.step < end and not self._drain:
            t0 = time.perf_counter()
            batch = self.batch_fn(self.step)
            self.state, metrics = self.train_step(self.state, batch)
            # the step's scalars, read back once
            names = [k for k, v in metrics.items()
                     if isinstance(v, torch.Tensor) and v.dim() == 0]
            vals = dict(zip(names, torch.stack(
                [metrics[k].double() for k in names]).tolist()))
            loss = vals["loss"]
            dt = time.perf_counter() - t0

            skipped = int(vals.get("skipped", 0))
            if skipped or not math.isfinite(loss):
                self.consecutive_nans += 1
                self.log(f"[trainer] step {self.step}: non-finite loss - "
                         f"update skipped ({self.consecutive_nans} in a row)")
                if self.consecutive_nans > cfg.runtime.max_nan_skips:
                    raise RuntimeError(
                        f"aborting: {self.consecutive_nans} consecutive "
                        f"non-finite steps")
            else:
                self.consecutive_nans = 0

            if self.watchdog.observe(self.step, dt):
                self.log(f"[trainer] step {self.step}: straggler alarm "
                         f"({dt:.3f}s vs EWMA "
                         f"{np.mean(self.watchdog.times):.3f}s)")

            rec = {"step": self.step, "loss": loss, "time": dt,
                   **{k: v for k, v in vals.items() if k != "loss"}}
            self.history.append(rec)
            if cfg.runtime.log_every and self.step % cfg.runtime.log_every == 0:
                self.log(f"[trainer] step {self.step}: loss {loss:.4f} "
                         f"({dt * 1e3:.0f} ms)")

            self.step += 1
            if (cfg.checkpoint.every_steps
                    and self.step % cfg.checkpoint.every_steps == 0):
                self._save()

        if self._drain:
            self.log(f"[trainer] drained at step {self.step}; final "
                     f"checkpoint")
        self._save()
        self.ckpt.wait()
        if dist.is_initialized():
            # every rank returns once the final checkpoint is on disk
            dist.barrier()
        return self.history
