"""Session — track a drifting operator across many solves.

Counterpart of ``repro.api.session``.  The paper's §V workload and the
serving target are not one SVD but a *stream* of partial SVDs of an
operator that drifts slowly between solves.  A :class:`Session` owns that
stream:

    sess = session(A, SVDSpec(method="fsvd", rank=8), generator=g)
    f0 = sess.solve()                 # cold: full Krylov budget
    f1 = sess.update(A_next)          # warm: refine from f0, reduced budget
    f2 = sess.delta(LowRankOp(...))   # structured drift: rank-k update,
                                      # ZERO Krylov iterations when it
                                      # passes the parity gate
    f3 = sess.entries(rows, cols, v)  # unstructured drift: fold the COO
                                      # stream into a resident sketch,
                                      # reconstruct — zero iterations when
                                      # it passes the residual probe

The decision is **four-way** per step, as in the reference:

  ``update``   a ``LowRankOp`` delta whose measured residual-after-update
               passes the parity gate (``update_tol``, learned when not
               pinned) — 0 GK iterations;
  ``sketch``   a COO entry batch (:meth:`entries`) whose reconstruction
               from the resident sketch passes the residual probe
               (``sketch_tol``) while the staleness odometer is under
               budget — 0 GK iterations;
  ``refine``   measured subspace drift ≤ ``restart_angle`` — a warm solve
               at the learned refine budget;
  ``restart``  larger drift (or no previous factorization), and the
               staleness fallback — a full solve.

Solves, updates, sketches, folds and reconstructions run through the
plan layer (``api/plan.py``), so a stream builds one runner per cache key.

What differs from the reference, and why:

* **Generators.**  The reference folds the step into one PRNG key.  A
  session here takes ``generator=`` and derives each step's generator
  from that generator's seed, the step and a tag (0 for the solve, 1 and
  2 for the sketches), on the operand's device: a rerun of the same stream
  draws the same numbers.  They are not the reference's numbers.
* **Operand folds at full width** (a 1e5 × 8e4 f32 operand is 32 GB on an
  80 GB card).  Folds are out of place, so the caller's tensor is never
  changed, and none holds more than two operands at once:
  :func:`fold_lowrank` adds a ``LowRankOp`` delta a row block at a time
  through the materialization kernel, never forming the whole (m, n)
  drift; :func:`fold_entries` sums duplicate coordinates in entry order,
  one level of duplicates at a time, so the operand's bits do not depend
  on atomics.  The session's plans hold no template operand, so a folded-
  away operand is freed as soon as the caller drops it.
* **The residual probe** runs on the operand's device
  (``serve.resilience.residual_probe``): no 32 GB host copy.
* **History** records device scalars as 0-d tensors and reads them (one
  sync) only when ``history`` / ``meta()`` is read; the budget learner
  reads the previous solve's residual trace at the start of the next
  solve, so no solve blocks on its own trace.

Sessions checkpoint through ``repro_torch.checkpoint`` in the reference's
format: ``sess.save(dir, step)``; ``Session.restore(dir, A)`` /
``sess.load_latest(dir)`` resume where the stream left off, from a
checkpoint written by either package.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device, to_tensor, torch_dtype
from repro_torch.api.plan import SolverPlan, method_needs_key, resolve_method
from repro_torch.api.results import Factorization
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import fold_in, resolve_generator
from repro_torch.core.operators import (DenseOp, LowRankOp, Operator,
                                        as_operator)

Tensor = torch.Tensor

# bytes of f32 drift a LowRankOp fold materializes at a time
_FOLD_BYTES = 1 << 30


def spec_to_dict(spec: SVDSpec) -> dict:
    """JSON-able spec (dtype by its numpy name, as the reference writes
    it) for manifests."""
    d = dataclasses.asdict(spec)
    d["dtype"] = None if spec.dtype is None else \
        str(spec.dtype).replace("torch.", "")
    return d


def spec_from_dict(d: dict) -> SVDSpec:
    d = dict(d)
    if d.get("dtype") is not None:
        d["dtype"] = torch_dtype(d["dtype"])
    return SVDSpec(**d)


def _load_newest_verified(directory: str, device):
    """(step, fact, meta) from the newest session checkpoint that both
    passes the CRC directory scan *and* actually loads; None when no step
    survives (a step that fails at read time falls back to the next older
    verified one)."""
    from repro_torch.checkpoint.store import load_session_state, valid_steps
    for step in valid_steps(directory):
        try:
            fact, meta = load_session_state(directory, step, device=device)
            return step, fact, meta
        except Exception:        # noqa: BLE001 — corrupt step: try older
            continue
    return None


def _cold_iters(spec: SVDSpec, shape) -> int:
    """The Krylov budget a cold solve actually runs (facade defaults —
    the ``k=None`` rule lives in ``repro_torch.core.fsvd.default_k``)."""
    from repro_torch.core.fsvd import default_k
    cold = spec.max_iters if spec.max_iters is not None \
        else default_k(spec.rank, shape)
    return max(min(cold, min(shape)), spec.rank)


def _default_refine_iters(spec: SVDSpec, shape) -> int:
    """Initial Krylov budget for a warm-started refine solve: ``r`` plus
    a modest slack, never above the cold budget.  Only the *seed*: the
    session re-learns it from each solve's convergence trace."""
    return max(1, min(max(spec.rank + 8, (3 * spec.rank) // 2),
                      _cold_iters(spec, shape), min(shape)))


# budget learning: the per-iteration GK residual proxy (beta) collapses
# once the Krylov space has captured the reachable spectrum; the collapse
# index is what the refine budget should track.
_DECAY_TOL = 3e-2      # "collapsed" = beta below this fraction of max beta
_DECAY_SLACK = 8       # iterations granted beyond the collapse index
_REFINE_CAP = 0.75     # hard-spectrum cap as a fraction of the cold budget
_BUDGET_QUANTUM = 4    # round budgets up to multiples (bounds rebuilds)

# update gate learning: accepted when the update's residual stays within a
# margin of the residual the solver itself achieves on this stream,
# floored so exact-rank operands with ~eps residuals are not held to the
# impossible.  Only solver factorizations set the reference.
_UPDATE_MARGIN = 4.0   # accepted when r_update <= margin * r_solver
_UPDATE_FLOOR = 1e-5   # parity gate floor (matches the acceptance gate)


def _plan(spec: SVDSpec, op) -> SolverPlan:
    """A plan resolved against ``op`` that keeps no reference to it."""
    return SolverPlan(spec=spec, method=resolve_method(spec, op))


def _derived(generator: torch.Generator, step: int, tag: int,
             device) -> torch.Generator:
    """A fresh generator on ``device`` seeded from (``generator``'s seed,
    ``step``, ``tag``): the same stream on every run."""
    return fold_in(generator.initial_seed(), step, tag, device=device)


def _operand_device(A, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(A, (Tensor, Operator)):
        return A.device
    return resolve_device(None)


# --- out-of-place operand folds --------------------------------------------

def fold_lowrank(A: Tensor, delta: LowRankOp, beta=1.0, *,
                 backend: str = "xla") -> Tensor:
    """``beta · A + delta`` as a new tensor, one row block of at most
    ~1 GiB of drift at a time: each block's drift comes from
    ``materialize_lowrank`` of the delta's rows (the materialization
    kernel on ``backend="pallas"``), so the whole (m, n) drift is never
    held.  The materialization kernel sums each element's r terms in a
    fixed order whatever the row block, so on the card the result is the
    whole-drift fold's bits; peak memory is two operands plus a block."""
    from repro_torch.core.update import materialize_lowrank
    m, n = A.shape
    rows = max(1, _FOLD_BYTES // (4 * max(1, n)))
    out = torch.empty_like(A)
    for r0 in range(0, m, rows):
        blk = slice(r0, r0 + rows)
        part = LowRankOp(delta.U[blk], delta.s, delta.Vt,
                         extra=tuple((L[blk], R) for L, R in delta.extra),
                         scale=delta.scale)
        W = materialize_lowrank(part, backend=backend, dtype=A.dtype)
        base = A[blk] if beta == 1.0 else beta * A[blk]
        torch.add(base, W, out=out[blk])
        del W, base
    return out


def fold_entries(A: Tensor, rows: Tensor, cols: Tensor,
                 vals: Tensor) -> Tensor:
    """A copy of ``A`` with ``vals`` added at (``rows``, ``cols``), in
    A's dtype.  Duplicate coordinates are summed one at a time in entry
    order, ``((A_ij + v_1) + v_2) + …`` — the reference's order on the
    CPU — and the same on every run and device: the entries are sorted
    stably by coordinate, and level j adds the j-th entry of every
    coordinate that has one (no two writes of a level meet).  Negative
    indices wrap; coordinates outside A are dropped."""
    m, n = A.shape
    out = A.clone(memory_format=torch.contiguous_format)
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    rows = torch.where(rows < 0, rows + m, rows)
    cols = torch.where(cols < 0, cols + n, cols)
    keep = (rows >= 0) & (rows < m) & (cols >= 0) & (cols < n)
    key = (rows * n + cols)[keep]
    if key.numel() == 0:
        return out
    key, order = torch.sort(key, stable=True)
    vals = vals.to(A.dtype)[keep][order]
    idx = torch.arange(key.numel(), device=key.device)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    level = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    flat = out.view(-1)
    for j in range(int(level.max()) + 1):
        sel = level == j
        k = key[sel]
        flat[k] = flat[k] + vals[sel]
    return out


def zero_lines(A: Tensor, idx, dim: int) -> Tensor:
    """A copy of ``A`` with rows (``dim=0``) or columns (``dim=1``)
    ``idx`` zeroed: the downdate's exact fold."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=A.device)
    return A.clone().index_fill_(dim, idx.reshape(-1), 0)


class Session:
    """Stateful solve-many tracker for one operand stream.

    Parameters as in ``repro.api.session.Session``, with ``generator``
    (a ``torch.Generator``: each step's generator is derived from its
    seed) in place of ``key``, and ``device`` for an operand that is not a
    tensor (default: the CUDA card).
    """

    def __init__(self, A, spec: Optional[SVDSpec] = None, *,
                 generator: Optional[torch.Generator] = None,
                 refine_iters: Optional[int] = None,
                 restart_angle: float = 0.5,
                 track_residuals: bool = True,
                 update_tol: Optional[float] = None,
                 sketch_tol: Optional[float] = None,
                 device=None,
                 **overrides):
        spec = (spec or SVDSpec())
        if overrides:
            spec = spec.replace(**overrides)
        self.op = as_operator(A, backend=spec.backend, device=device)
        self.plan = _plan(spec, self.op)
        self.spec = self.plan.spec
        # an explicit refine_iters pins the budget; otherwise the session
        # seeds it and re-learns it from every solve's convergence trace.
        self._auto_refine = refine_iters is None
        if refine_iters is None:
            refine_iters = _default_refine_iters(self.spec, self.op.shape)
        self.refine_iters = int(refine_iters)
        self.refine_plan = _plan(
            self.spec.replace(max_iters=self.refine_iters), self.op)
        self.restart_angle = float(restart_angle)
        self.track_residuals = track_residuals
        self.update_tol = None if update_tol is None else float(update_tol)
        self.sketch_tol = None if sketch_tol is None else float(sketch_tol)
        self._generator = generator
        self._step = 0
        self.fact: Optional[Factorization] = None
        self._history: list[dict] = []
        # deferred state: the previous solve's ConvergenceInfo (budget
        # learning reads it at the START of the next solve) and the
        # solver-residual gate reference.
        self._pending_info = None
        self._ref_residual: Optional[float] = None
        # sketch residency (the entries path): built lazily from the
        # pre-drift operand on the first entries() call, folded after
        # that, dropped whenever the operand changes by a route the sketch
        # cannot fold (update(), beta != 1 deltas, downdates).
        self.sketch = None
        self._ref_probe: Optional[float] = None

    # --- generator stream ---------------------------------------------
    def _next_generator(self, generator: Optional[torch.Generator],
                        tag: int = 0) -> torch.Generator:
        dev = self.op.device
        if generator is not None:
            return generator if tag == 0 else \
                _derived(generator, self._step, tag, dev)
        if self._generator is None:
            self._generator = resolve_generator(None, caller="session",
                                                device=dev)
        return _derived(self._generator, self._step, tag, dev)

    def _wrap(self, A):
        return as_operator(A, backend=self.spec.backend,
                           device=self.op.device)

    # --- drift measurement --------------------------------------------
    def drift(self, op=None) -> Optional[float]:
        """sin of the aggregate angle between span(U_prev) and the image
        of the previous right Ritz basis under the (new) operator; None
        before the first solve.  ~0 for an unchanged operator."""
        if self.fact is None:
            return None
        op = self.op if op is None else self._wrap(op)
        f = self.fact
        if (f.U.shape[0], f.V.shape[0]) != tuple(op.shape):
            # geometry changed under the session: maximal drift, forcing
            # the restart branch instead of a shape-mismatched matmat.
            return float("inf")
        compute = torch.promote_types(f.U.dtype, torch.float32)
        U = f.U.to(compute)
        B = op.matmat(f.V.to(compute))            # (m, r): A' V_prev
        R = B - U @ (U.T @ B)                      # component off span(U)
        num = torch.linalg.vector_norm(R)
        den = torch.clamp(torch.linalg.vector_norm(B),
                          min=torch.finfo(compute).tiny)
        return float(num / den)

    # --- solves -------------------------------------------------------
    def solve(self, *, generator: Optional[torch.Generator] = None
              ) -> Factorization:
        """Solve the current operand: cold on first use, tracked after."""
        return self._tracked_solve(generator)

    def update(self, A, *, generator: Optional[torch.Generator] = None
               ) -> Factorization:
        """Replace the operand with ``A`` (a drifted version) and solve.
        The resident sketch describes the old operand: it is dropped."""
        self.op = self._wrap(A)
        self.sketch = None
        return self._tracked_solve(generator)

    def delta(self, delta_op, *, beta: float = 1.0,
              generator: Optional[torch.Generator] = None) -> Factorization:
        """Apply an additive drift ``A ← beta * A + delta_op`` and solve.

        A ``LowRankOp`` delta first attempts the zero-iteration rank-k
        update (``SolverPlan.update``), accepted on the measured
        residual-after-update (``update_tol``); rejected or ineligible
        deltas fall back to the refine/restart policy.  A dense operand
        absorbs the delta (:func:`fold_lowrank`)."""
        dop = as_operator(delta_op, backend=self.spec.backend,
                          device=self.op.device)
        return self._apply_delta(dop, beta, generator, kind="update")

    def downdate(self, *, rows=None, cols=None,
                 generator: Optional[torch.Generator] = None
                 ) -> Factorization:
        """Remove (zero) ``rows`` or ``cols`` of the tracked operand, as
        the rank-|idx| delta derived from the current factorization
        (``core.update.row_removal_delta``) through the gated update
        path; a dense operand is zeroed exactly (:func:`zero_lines`)."""
        if (rows is None) == (cols is None):
            raise ValueError("pass exactly one of rows= / cols=")
        if self.fact is None:
            raise RuntimeError("downdate requires a previous solve; call "
                               "solve() first")
        from repro_torch.core.update import (col_removal_delta,
                                             row_removal_delta)
        dop = (row_removal_delta(self.fact, rows) if rows is not None
               else col_removal_delta(self.fact, cols))
        fold: Optional[Callable[[], Any]] = None
        if isinstance(self.op, DenseOp):
            base = self.op
            idx, dim = (rows, 0) if rows is not None else (cols, 1)
            fold = lambda: DenseOp(zero_lines(base.A, idx, dim),  # noqa: E731
                                   backend=base.backend)
        return self._apply_delta(dop, 1.0, generator, kind="downdate",
                                 fold=fold)

    def entries(self, rows, cols, vals, *,
                generator: Optional[torch.Generator] = None
                ) -> Factorization:
        """Apply an *unstructured* entrywise drift ``A[rows, cols] +=
        vals`` (COO triplets) and solve — the fourth policy branch.

        The resident sketch (built from the pre-drift operand on first
        use) and the operand both take the batch (``SolverPlan.
        sketch_fold``: two ``scatter_add`` launches; :func:`fold_entries`);
        the answer is reconstructed from the panels with ZERO Krylov
        iterations and accepted only when the staleness odometer has not
        tripped and the residual probe against the post-drift operand
        passes ``sketch_tol``.  A staleness trip re-sketches and answers
        with a real solve; a probe rejection falls back to refine/restart,
        annotated.  Dense operands only."""
        if not isinstance(self.op, DenseOp):
            raise TypeError(
                "entries() folds COO triplets into the operand and needs a "
                f"dense operand; got {type(self.op).__name__}. Materialize "
                "the operand or express the drift as a LowRankOp via "
                "delta().")
        dev = self.op.device
        rows = to_tensor(rows, device=dev).reshape(-1).to(torch.int32)
        cols = to_tensor(cols, device=dev).reshape(-1).to(torch.int32)
        vals = to_tensor(vals, device=dev).reshape(-1)
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError("rows/cols/vals must have equal lengths; got "
                             f"{rows.shape[0]}/{cols.shape[0]}/"
                             f"{vals.shape[0]}")
        enabled = self.sketch_tol is None or self.sketch_tol > 0.0
        if enabled and self.sketch is None:
            # sketch the PRE-drift operand: the fold below brings it up to
            # date with the post-drift operand.
            self.sketch = self.plan.sketch(
                self.op, generator=self._next_generator(generator, 1))
        new_op = DenseOp(fold_entries(self.op.A, rows, cols, vals),
                         backend=self.op.backend)
        if not enabled:
            self.op = new_op
            return self._tracked_solve(generator)
        from repro_torch.sketchres import is_stale, staleness_ratio
        # the learned gate's reference probes self.fact against the
        # operand it described — the PRE-drift one.
        gate = self._sketch_gate()
        self.sketch = self.plan.sketch_fold(self.sketch, rows, cols, vals)
        ratio = float(staleness_ratio(self.sketch))
        self.op = new_op
        if bool(is_stale(self.sketch)):
            # past the coverage budget: re-sketch from the operand
            # (odometer reset) and answer with a verified solve.
            self.sketch = self.plan.sketch(
                new_op, generator=self._next_generator(generator, 2))
            fact = self._tracked_solve(generator)
            self._history[-1]["sketch_stale"] = True
            self._history[-1]["staleness"] = ratio
            return fact
        if gate is not None:
            from repro_torch.serve import resilience
            fact = self.plan.sketch_reconstruct(self.sketch)
            probe = resilience.residual_probe(new_op.A, fact, probes=4,
                                              seed=self._step)
            if probe <= gate:
                rec = {"step": self._step, "kind": "sketch", "drift": None,
                       "iterations": 0, "breakdown": False,
                       "probe": probe, "gate": gate, "staleness": ratio}
                if self.track_residuals:
                    rec["residual"] = self._residual(fact)
                self._history.append(rec)
                self.fact = fact
                self._step += 1
                return fact
            rejected = (probe, gate)
        else:
            # no reference factorization to learn the gate from yet: solve
            # for real, which also anchors the probe reference.
            rejected = None
        fact = self._tracked_solve(generator)
        if rejected is not None:
            self._history[-1]["sketch_rejected"] = True
            self._history[-1]["probe"] = rejected[0]
            self._history[-1]["gate"] = rejected[1]
        return fact

    def _sketch_gate(self) -> Optional[float]:
        """Residual-probe acceptance gate for the sketch branch; None when
        it cannot be formed yet (learned gate with no prior solve)."""
        if self.sketch_tol is not None:
            return self.sketch_tol
        if self.fact is None:
            return None
        if self._ref_probe is None:
            # probe the current factorization once, lazily, against the
            # operand it described; sketch answers never ratchet it.
            if not isinstance(self.op, DenseOp):
                return None
            from repro_torch.serve import resilience
            self._ref_probe = resilience.residual_probe(
                self.op.A, self.fact, probes=4, seed=self._step)
        return max(_UPDATE_FLOOR, _UPDATE_MARGIN * self._ref_probe)

    # --- the four-way policy ------------------------------------------
    def _fold(self, dop, beta):
        """The post-delta operand.  A dense operand absorbs a low-rank
        delta (and any decay) by row blocks; other operator kinds compose
        ``beta * op + dop``."""
        if isinstance(self.op, DenseOp) and isinstance(dop, LowRankOp):
            return DenseOp(fold_lowrank(self.op.A, dop, beta,
                                        backend=self.op.backend),
                           backend=self.op.backend)
        base = self.op if beta == 1.0 else beta * self.op
        return base + dop

    def _update_eligible(self, dop) -> bool:
        if self.fact is None or not isinstance(dop, LowRankOp):
            return False
        if self.update_tol is not None and self.update_tol <= 0.0:
            return False        # update_tol=0.0: update path disabled
        if tuple(dop.shape) != tuple(self.op.shape):
            return False
        from repro_torch.core.update import delta_rank
        return self.fact.rank + delta_rank(dop) <= min(self.op.shape)

    def _update_gate(self) -> float:
        if self.update_tol is not None:
            return self.update_tol
        if self._ref_residual is None:
            # no solver residual on file: measure the current
            # factorization against the PRE-delta operand once, lazily.
            self._ref_residual = self._residual(self.fact)
        return max(_UPDATE_FLOOR, _UPDATE_MARGIN * self._ref_residual)

    def _apply_delta(self, dop, beta, generator, kind: str,
                     fold: Optional[Callable[[], Any]] = None
                     ) -> Factorization:
        eligible = self._update_eligible(dop)
        gate = self._update_gate() if eligible else None
        new_op = self._fold(dop, beta) if fold is None else fold()
        if self.sketch is not None:
            if fold is None and beta == 1.0:
                # sketches are linear in A: the delta folds into the
                # panels too (two panel products).
                self.sketch = self.plan.sketch_fold_delta(self.sketch, dop)
            else:
                # decayed or custom-folded operands (downdate's exact
                # zeroing) diverge from what the panels would track.
                self.sketch = None
        rejected = None
        if eligible:
            fact = self.plan.update(self.fact, dop, beta=beta)
            r_upd = self._residual(fact, op=new_op)
            if r_upd <= gate:
                self.op = new_op
                rec = {"step": self._step, "kind": kind, "drift": None,
                       "iterations": 0, "breakdown": False,
                       "residual_update": r_upd, "gate": gate}
                if self.track_residuals:
                    rec["residual"] = r_upd
                self._history.append(rec)
                self.fact = fact
                self._step += 1
                return fact
            rejected = (r_upd, gate)
        self.op = new_op
        fact = self._tracked_solve(generator)
        if rejected is not None:
            self._history[-1]["update_rejected"] = True
            self._history[-1]["residual_update"] = rejected[0]
            self._history[-1]["gate"] = rejected[1]
        return fact

    def _learn_refine_iters(self, info) -> None:
        """Re-fit the refine budget to the observed GK residual trace:
        the collapse index of the beta trace plus a slack, quantized,
        between the seed budget and a cap below the cold budget."""
        if not self._auto_refine or info is None or info.method != "gk":
            return
        res = info.residuals.detach().to("cpu", torch.float64).numpy()
        if res.size == 0 or res.max() <= 0.0:
            return
        cold = _cold_iters(self.spec, self.op.shape)
        floor = _default_refine_iters(self.spec, self.op.shape)
        cap = max(floor, int(np.ceil(_REFINE_CAP * cold)))
        idx = np.nonzero(res < _DECAY_TOL * res.max())[0]
        learned = int(idx[0]) + _DECAY_SLACK if idx.size else cap
        learned = -(-learned // _BUDGET_QUANTUM) * _BUDGET_QUANTUM
        learned = int(np.clip(learned, floor, cap))
        if learned != self.refine_iters:
            self.refine_iters = learned
            self.refine_plan = _plan(self.spec.replace(max_iters=learned),
                                     self.op)

    def _tracked_solve(self, generator: Optional[torch.Generator]
                       ) -> Factorization:
        # budget learning reads the PREVIOUS solve's residual trace here,
        # before this solve picks its plan.
        if self._pending_info is not None:
            info, self._pending_info = self._pending_info, None
            self._learn_refine_iters(info)
        drift = self.drift() if self.fact is not None else None
        refine = drift is not None and drift <= self.restart_angle
        if refine:
            q1 = self.fact.warm_start()
            # generator-consuming methods (the sketches) draw from the
            # session's stream even on refines: q1 is no seam there
            rgen = self._next_generator(generator) if method_needs_key(
                self.plan.method) else generator
            fact, info = self.refine_plan.solve(self.op, generator=rgen,
                                                q1=q1, with_info=True)
            kind = "refine"
        else:
            fact, info = self.plan.solve(
                self.op, generator=self._next_generator(generator),
                with_info=True)
            kind = "cold" if drift is None else "restart"
        budget = self.refine_iters if refine else None
        self._pending_info = info
        # iterations / breakdown stay 0-d device tensors here; `history`
        # and `meta()` read them.
        rec = {"step": self._step, "kind": kind, "drift": drift,
               "iterations": fact.iterations,
               "breakdown": fact.breakdown}
        if budget is not None:
            rec["budget"] = budget
        if self.track_residuals:
            rec["residual"] = self._residual(fact)
            self._ref_residual = rec["residual"]
        else:
            self._ref_residual = None
        # a fresh solver factorization re-anchors the sketch gate too
        self._ref_probe = None
        self._history.append(rec)
        self.fact = fact
        self._step += 1
        return fact

    def _residual(self, fact: Factorization, op=None) -> float:
        op = self.op if op is None else op
        compute = torch.promote_types(fact.U.dtype, torch.float32)
        ATU = op.rmatmat(fact.U.to(compute))
        num = torch.linalg.vector_norm(
            ATU - fact.V.to(compute) * fact.s[None, :].to(compute))
        return float(num / torch.clamp(torch.linalg.vector_norm(fact.s),
                                       min=1e-30))

    # --- bookkeeping ---------------------------------------------------
    @property
    def solves(self) -> int:
        return self._step

    @property
    def history(self) -> list[dict]:
        """Per-step records.  Device scalars recorded by solves are read
        (in place, once) on first access: reading history is the sync
        point, not the solve that appended the record."""
        for rec in self._history:
            for k, v in rec.items():
                if isinstance(v, (Tensor, np.generic)):
                    rec[k] = v.item()
        return self._history

    @history.setter
    def history(self, value) -> None:
        self._history = list(value)

    def counts(self) -> dict:
        """Per-kind step counts over the history (always with ``cold`` /
        ``refine`` / ``restart``)."""
        out = {"cold": 0, "refine": 0, "restart": 0}
        for rec in self._history:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return out

    def meta(self) -> dict:
        """JSON-able session metadata (manifest ``extra`` payload), with
        the reference's keys."""
        c = self.counts()
        return {"spec": spec_to_dict(self.spec), "method": self.plan.method,
                "refine_iters": self.refine_iters,
                "auto_refine": self._auto_refine,
                "restart_angle": self.restart_angle,
                "track_residuals": self.track_residuals,
                "update_tol": self.update_tol,
                "sketch_tol": self.sketch_tol,
                "updates": c.get("update", 0) + c.get("downdate", 0),
                "sketches": c.get("sketch", 0),
                "step": self._step, "history": self.history}

    # --- persistence ----------------------------------------------------
    def save(self, directory: str, step: Optional[int] = None, *,
             keep: int = 0) -> str:
        """Atomic checkpoint of the tracking state (previous factorization
        + spec + history) via ``repro_torch.checkpoint``.  ``keep > 0``
        prunes old session states to the newest ``keep``."""
        from repro_torch.checkpoint.store import save_session_state
        return save_session_state(directory,
                                  self._step if step is None else step,
                                  self, keep=keep)

    def load_latest(self, directory: str) -> bool:
        """Restore tracking state in place from the newest *verified*
        session checkpoint under ``directory`` (onto the operand's
        device); False when none exists.  A step that fails at read time
        is skipped for the next older verified one."""
        from repro_torch.runtime import faults
        faults.fire(faults.SESSION_RESTORE)
        loaded = _load_newest_verified(directory, self.op.device)
        if loaded is None:
            return False
        step, fact, meta = loaded
        if meta["spec"] != spec_to_dict(self.spec):
            warnings.warn(
                "session checkpoint was written under a different spec "
                f"({meta['spec']} != {spec_to_dict(self.spec)}); restoring "
                "its factorization anyway — the next solve re-tracks under "
                "the current spec.", stacklevel=2)
        self.fact = fact
        self._step = int(meta["step"])
        self.history = list(meta["history"])
        self._auto_refine = bool(meta.get("auto_refine",
                                          self._auto_refine))
        self.restart_angle = float(meta.get("restart_angle",
                                            self.restart_angle))
        self.track_residuals = bool(meta.get("track_residuals",
                                             self.track_residuals))
        if "update_tol" in meta:
            tol = meta["update_tol"]
            self.update_tol = None if tol is None else float(tol)
        if "sketch_tol" in meta:
            tol = meta["sketch_tol"]
            self.sketch_tol = None if tol is None else float(tol)
        self._ref_residual = None
        self._pending_info = None
        # sketches are cheap to rebuild: re-sketched on the next entries()
        self.sketch = None
        self._ref_probe = None
        learned = int(meta.get("refine_iters", self.refine_iters))
        if learned != self.refine_iters:
            self.refine_iters = learned
            self.refine_plan = _plan(self.spec.replace(max_iters=learned),
                                     self.op)
        return True

    @classmethod
    def restore(cls, directory: str, A, *,
                generator: Optional[torch.Generator] = None,
                step: Optional[int] = None, device=None) -> "Session":
        """Rebuild a session around operand ``A`` from a checkpoint (either
        package's): spec, factorization (on the operand's device), policy
        knobs and history all come from the manifest.  With ``step=None``
        the newest checkpoint that passes its CRC verification restores."""
        from repro_torch.checkpoint.store import load_session_state
        from repro_torch.runtime import faults
        faults.fire(faults.SESSION_RESTORE)
        dev = _operand_device(A, device)
        if step is None:
            loaded = _load_newest_verified(directory, dev)
            if loaded is None:
                raise FileNotFoundError(
                    f"no valid session checkpoint under {directory!r}")
            step, fact, meta = loaded
        else:
            fact, meta = load_session_state(directory, step, device=dev)
        sess = cls(A, spec_from_dict(meta["spec"]), generator=generator,
                   refine_iters=meta.get("refine_iters"),
                   restart_angle=meta.get("restart_angle", 0.5),
                   track_residuals=meta.get("track_residuals", True),
                   update_tol=meta.get("update_tol"),
                   sketch_tol=meta.get("sketch_tol"), device=dev)
        # carry the learned budget but keep learning if the original did
        sess._auto_refine = bool(meta.get("auto_refine", True))
        sess.fact = fact
        sess._step = int(meta["step"])
        sess.history = list(meta["history"])
        return sess


def session(A, spec: Optional[SVDSpec] = None, *,
            generator: Optional[torch.Generator] = None,
            **kwargs) -> Session:
    """Build a :class:`Session` (keyword conveniences as in ``plan``)."""
    return Session(A, spec, generator=generator, **kwargs)


__all__ = ["Session", "fold_entries", "fold_lowrank", "session",
           "spec_from_dict", "spec_to_dict", "zero_lines"]
