"""SolverPlan — resolve once, solve many.

Counterpart of ``repro.api.plan``.  ``factorize`` is the right call for
*one* SVD; the paper's real workloads (the §V Riemannian similarity
loop, rank tracking of a drifting operator, heavy-traffic serving) issue
thousands of structurally identical solves, so the plan layer splits
resolving from solving:

    p = plan(SVDSpec(method="fsvd", rank=8), like=A)   # resolve ONCE
    f1 = p.solve(A,  generator=g1)                      # build ONCE
    f2 = p.solve(A2, generator=g2)                      # reuse the runner

``plan()`` resolves ``method="auto"`` operator-aware (matrix-free sparse /
Kronecker / Gram operands → the streaming blocked solver, a
``single_pass_only`` operand → ``gnystrom``) and pins the solver.  Runners
are memoized in a process-wide LRU keyed by

    (task, spec, method, operand signature, argument structure)

where the operand signature walks the operator's dataclass fields: a
tensor gives its (shape, dtype, device), a static field (a bool, string,
dtype, None, or a number such as ``SparseOp.spshape``) its value, a
number the reference traces as a leaf (``ScaledOp.alpha``,
``LowRankOp.scale``) its type (values never key: ``DenseOp(A)`` and
``DenseOp(A + 1)`` share an entry, a CPU and a CUDA operand never do),
and nested operators, factorizations and sketch states are walked
recursively.  An operand the walk cannot describe (a legacy ``LinOp``
closure) runs eagerly: a plan always solves, it just cannot always cache.

**What a trace is here.**  Torch has no jit, so the port counts what the
reference's trace stands for: one call of a cache key's ``build()``,
which makes the key's runner.  The runner binds (solver, spec, method)
and nothing else — never the plan or its ``like`` operand, so a cache
entry does not keep a 32 GB template alive — and the launch plans of the
kernels are functions of the operand's shapes, made per call.
``trace_count()`` moves only there, so the reference's compile-once
tests keep their meaning: a key must cover everything its runner depends
on.  Kernel builds are shared under ``kernels._build``'s own lock, so a
runner does no lazy work on its first call and needs no first-call fence.
``torch.compile`` cannot see the ctypes launches, and a CUDA graph per key
is a later item (``ROADMAP.md``).

``solve_batched`` runs a stacked ``DenseOp`` (A (B, m, n)): fsvd through
one masked GK loop whose half-steps are one kernel call a stage for the
whole batch (``core.fsvd.fsvd_batched``); rsvd, rbk and gnystrom run
their B examples one after another inside the runner, through the same
kernels (their batched path is a later item).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Optional, Sequence

import torch

from repro_torch.api import solvers as _solvers
from repro_torch.api.callbacks import CaptureCallback, empty_info
from repro_torch.api.registry import get_solver
from repro_torch.api.results import Factorization, RankEstimate
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import resolve_generator
from repro_torch.core.operators import (DenseOp, GramOp, KroneckerOp,
                                        LowRankOp, Operator, ScaledOp,
                                        SparseOp, SumOp, TransposedOp,
                                        as_operator, sharding_mesh)
from repro_torch.runtime import faults as _faults

Tensor = torch.Tensor

# methods that run a host-side Python loop (real early exit / restarts):
# never cached, and refused by solve_batched.
HOST_SIDE_METHODS = frozenset({"fsvd_blocked"})

# built-in methods whose runners the plan caches.  Extensions that
# register a solver accepting the ``callback`` kwarg opt in here.
_INGRAPH_METHODS = {"fsvd", "rsvd", "fsvd_sharded", "rbk", "gnystrom"}

# sketch-based methods always consume a generator (no warm-start seam).
_NEEDS_KEY = frozenset({"rsvd", "rbk", "gnystrom"})

# "auto" heuristic for dense operands (repro.api.plan): a loose tolerance
# or power iterations put the caller on the sketch side of the trade-off.
_AUTO_SKETCH_TOL = 1e-4


def register_ingraph_method(name: str) -> None:
    """Declare a registered solver cacheable by plans (accepts
    ``callback=``)."""
    _INGRAPH_METHODS.add(name)


def method_needs_key(method: str) -> bool:
    """Does ``method`` consume a generator even when warm-started?"""
    return method in _NEEDS_KEY


# ---------------------------------------------------------------------------
# operator-aware method resolution
# ---------------------------------------------------------------------------

def _is_matrix_free(op) -> bool:
    """True when materializing ``op`` densely would defeat its structure
    (sparse, Kronecker and Gram operands, through transposes, scalings
    and sums): "auto" then picks the streaming blocked solver."""
    if isinstance(op, (SparseOp, KroneckerOp, GramOp)):
        return True
    if isinstance(op, TransposedOp):
        return _is_matrix_free(op.inner)
    if isinstance(op, ScaledOp):
        return _is_matrix_free(op.op)
    if isinstance(op, SumOp):
        return any(_is_matrix_free(t) for t in op.terms)
    return False


def resolve_method(spec: SVDSpec, like: Any = None) -> str:
    """Resolve ``method="auto"`` to a registered solver name, under the
    reference's rule: an operand flagged ``single_pass_only`` →
    gnystrom, a sharded operand → fsvd_sharded, matrix-free operands →
    fsvd_blocked, and other operands → rsvd when ``power_iters > 0`` or
    ``tol >= 1e-4``, else fsvd.  A ``like`` that is not an operator is
    normalized through ``as_operator`` first."""
    if spec.method != "auto":
        return spec.method
    if like is not None:
        op = like if isinstance(like, Operator) else as_operator(
            like, backend=spec.backend)
        if getattr(op, "single_pass_only", False):
            return "gnystrom"
        if sharding_mesh(op) is not None:
            return "fsvd_sharded"
        if _is_matrix_free(op):
            return "fsvd_blocked"
    if spec.power_iters > 0 or spec.tol >= _AUTO_SKETCH_TOL:
        return "rsvd"
    return "fsvd"


# ---------------------------------------------------------------------------
# the process-wide runner cache
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
_CACHE: "collections.OrderedDict[tuple, Any]" = collections.OrderedDict()
_CACHE_SIZE = 128
_STATS = {"traces": 0, "hits": 0, "misses": 0, "evictions": 0}
# single-flight: cache key -> Event, present while one thread builds that
# entry; concurrent requesters wait instead of duplicating the build.
_BUILDING: dict = {}


def clear_plan_cache(reset_stats: bool = False) -> None:
    """Drop every memoized runner (tests / memory pressure).

    ``reset_stats=True`` also zeroes the hit/miss/eviction/trace
    counters."""
    with _LOCK:
        _CACHE.clear()
        if reset_stats:
            for k in _STATS:
                _STATS[k] = 0


def plan_cache_stats() -> dict:
    """Snapshot of {traces, hits, misses, evictions, entries, hit_rate}:
    ``hits`` / ``misses`` count :func:`_memoized` lookups (one per cached
    ``solve`` / ``estimate`` / ``solve_batched`` / staging call),
    ``evictions`` LRU drops and ``traces`` runner builds."""
    with _LOCK:
        total = _STATS["hits"] + _STATS["misses"]
        return {**_STATS, "entries": len(_CACHE),
                "hit_rate": _STATS["hits"] / total if total else 0.0}


def trace_count() -> int:
    """Runner builds through plans in this process (a rebuild means a
    cache key failed to cover something: the compile-once tests assert
    on deltas of this counter)."""
    with _LOCK:
        return _STATS["traces"]


def _bump_traces() -> None:
    with _LOCK:
        _STATS["traces"] += 1


class _Unstageable(Exception):
    pass


# the numbers the reference traces as leaves (its ``_data_fields``): they
# key by type.  Every other number of an operand is static, as the
# reference's ``_meta_fields``, and keys by value (``SparseOp.spshape``,
# ``SketchState.zeta`` / ``budget``).
_SCALAR_LEAVES = {"LowRankOp": frozenset({"scale"}),
                  "ScaledOp": frozenset({"alpha"}),
                  "SketchState": frozenset({"seeds"})}


def _sig(x, leaf=False):
    if isinstance(x, Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if x is None or isinstance(x, (bool, str, torch.dtype, torch.device)):
        return ("static", x)
    if isinstance(x, (int, float, complex)):
        return ("scalar", type(x).__name__) if leaf else ("static", x)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_sig(v, leaf) for v in x))
    if hasattr(x, "mesh_dim_names") and hasattr(x, "get_coordinate"):
        # a sharded operand's DeviceMesh (the reference keys its Mesh as
        # static aux data): shape, axis names and world, so plans on
        # different meshes or factorizations never share a runner
        import torch.distributed as dist
        return ("mesh", tuple(x.mesh.shape), tuple(x.mesh_dim_names),
                str(x.device_type), dist.get_world_size())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        leaves = _SCALAR_LEAVES.get(type(x).__name__, frozenset())
        return (type(x).__qualname__,
                tuple((f.name, _sig(getattr(x, f.name), f.name in leaves))
                      for f in dataclasses.fields(x)))
    raise _Unstageable


def _operand_signature(obj) -> Optional[tuple]:
    """The structure of a dataclass operand (operator, factorization or
    sketch state) as a hashable tuple, or None when a field is neither a
    tensor, a static value nor a dataclass of such (a closure)."""
    try:
        return _sig(obj)
    except _Unstageable:
        return None


def _accepts_callback(fn) -> bool:
    import inspect
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):          # builtins / C callables
        return False
    return "callback" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _memoized(cache_key: tuple, build):
    """Single-flight LRU lookup; ``build()`` makes the runner on a miss.

    Concurrent misses on the same key coalesce: the first thread builds
    (off-lock) while the rest wait on a per-key event, so N threads
    hammering one key build exactly one runner.  Waiters count as hits —
    they share the built runner.
    """
    while True:
        with _LOCK:
            hit = _CACHE.get(cache_key)
            if hit is not None:
                _CACHE.move_to_end(cache_key)
                _STATS["hits"] += 1
                return hit
            event = _BUILDING.get(cache_key)
            if event is None:
                event = threading.Event()
                _BUILDING[cache_key] = event
                _STATS["misses"] += 1
                builder = True
            else:
                builder = False
        if not builder:
            event.wait()
            continue        # built (or failed — then we take over the build)
        try:
            fn = build()
        except BaseException:
            with _LOCK:
                _BUILDING.pop(cache_key, None)
            event.set()     # wake waiters; one of them retries the build
            raise
        with _LOCK:
            _CACHE[cache_key] = fn
            _CACHE.move_to_end(cache_key)
            while len(_CACHE) > _CACHE_SIZE:
                _CACHE.popitem(last=False)
                _STATS["evictions"] += 1
            _BUILDING.pop(cache_key, None)
        event.set()
        return fn


def _traced(run):
    """``run`` as a cached runner: building it is one trace."""
    _bump_traces()
    return run


def _solver(method: str):
    if method in _solvers.NOT_PORTED:
        raise _solvers.not_ported(method)
    return get_solver(method)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """A resolved (spec, method) pair with a cached runner per operand
    signature.

    Build with :func:`plan`.  ``solve`` runs the factorization; cacheable
    specs run a memoized runner, host-loop specs and operands with no
    signature run eagerly.  The plan itself is stateless — it may be
    shared freely across threads; all memoization lives in the
    process-wide cache.  ``donate_q1`` is kept so that every call site
    reads as the reference's; it has no effect here, since the port
    never writes into the caller's ``q1``.
    """

    spec: SVDSpec
    method: str
    like: Any = None                 # wrapped template operand (optional)
    donate_q1: bool = True

    # --- introspection ------------------------------------------------
    @property
    def staged(self) -> bool:
        """Is this plan's runner cached (method + loop style allow it)?"""
        return (self.method in _INGRAPH_METHODS
                and not self.spec.host_loop
                and self.method not in HOST_SIDE_METHODS)

    def operand_key(self, A: Any = None) -> Optional[tuple]:
        """The operand component of the cache key for ``A``; None when
        the operand cannot be cached."""
        op = self._wrap(A)
        if not isinstance(op, Operator):
            return None
        return _operand_signature(op)

    def _wrap(self, A: Any):
        if A is None:
            if self.like is None:
                raise ValueError(
                    "plan was built without a template operand; pass A to "
                    "solve()/estimate()")
            return self.like
        return as_operator(A, backend=self.spec.backend)

    # --- execution ----------------------------------------------------
    def solve(self, A: Any = None, *,
              generator: Optional[torch.Generator] = None, q1=None,
              with_info: bool = False, callback=None):
        """Run the planned factorization on ``A`` (default: the template
        operand).  Returns a ``Factorization``, or ``(Factorization,
        ConvergenceInfo)`` when ``with_info=True``.  ``callback`` receives
        ``on_info`` either way (and ``on_step`` from host-loop solvers).
        """
        _faults.fire(_faults.PLAN_SOLVE)
        op = self._wrap(A)
        if getattr(op, "batch", None) is not None:
            raise ValueError("a stacked (B, m, n) operand: use "
                             "solve_batched")
        okey = self.operand_key(op) if self.staged else None
        if okey is None:
            return self._solve_eager(op, generator, q1, with_info, callback)

        # resolved per call, so the implicit-generator warning fires once
        # per solve, and the runner only ever sees a generator or a q1.
        if q1 is None or self.method in _NEEDS_KEY:
            generator = resolve_generator(
                generator, caller=f"plan(method={self.method!r})",
                device=op.device)
        cache_key = ("solve", self.spec, self.method, okey,
                     generator is None, q1 is None)
        fn = _memoized(cache_key, self._build_solve)
        fact, info = fn(op, generator, q1)
        if callback is not None:
            callback.on_info(info)
        return (fact, info) if with_info else fact

    def _build_solve(self):
        solver = _solver(self.method)
        spec, method = self.spec, self.method
        takes_cb = _accepts_callback(solver)

        # `run` closes over these scalars only — never `self`: the runner
        # lives in the process-wide cache, and a closure over the plan
        # would keep its `like` operand (a full input tensor) alive.
        def run(op, generator, q1):
            cb = CaptureCallback()
            if takes_cb:
                fact = solver(op, spec, generator=generator, q1=q1,
                              callback=cb)
            else:
                fact = solver(op, spec, generator=generator, q1=q1)
            info = cb.info if cb.info is not None else empty_info(
                method, fact.s.device)
            return fact, info

        return _traced(run)

    def _solve_eager(self, op, generator, q1, with_info, callback):
        solver = _solver(self.method)
        rec = CaptureCallback()
        cb: Any = rec
        if callback is not None:
            class _Tee:
                def on_step(self, i, **m):
                    callback.on_step(i, **m)

                def on_info(self, info):
                    rec.on_info(info)
                    callback.on_info(info)
            cb = _Tee()
        if _accepts_callback(solver):
            fact = solver(op, self.spec, generator=generator, q1=q1,
                          callback=cb)
        else:
            # extension solvers predating the callback protocol
            fact = solver(op, self.spec, generator=generator, q1=q1)
        info = rec.info if rec.info is not None else empty_info(
            self.method, fact.s.device)
        return (fact, info) if with_info else fact

    def update(self, fact: Factorization, delta: Any, *, beta=1.0):
        """Rank-k update of an existing ``Factorization`` — zero GK
        iterations (see :mod:`repro_torch.core.update`).

        Cached like solves, keyed by the (spec, factorization signature,
        delta signature) triple, so a tracking stream builds ONE runner
        for every update of a given shape; ``beta`` is an argument of the
        runner, so one runner covers every decay factor.
        """
        from repro_torch.core.update import update_factorization
        dop = as_operator(delta, backend=self.spec.backend)
        if not isinstance(dop, LowRankOp):
            raise TypeError(
                f"plan.update requires a low-rank delta (LowRankOp), got "
                f"{type(dop).__name__}; use solve() for unstructured drift")
        backend = self.spec.backend
        fsig = _operand_signature(fact)
        dsig = _operand_signature(dop)
        if fsig is None or dsig is None:
            return update_factorization(fact, dop, beta=beta,
                                        backend=backend)
        cache_key = ("update", self.spec, fsig, dsig)

        def build():
            def run(fact, dop, beta):
                return update_factorization(fact, dop, beta=beta,
                                            backend=backend)
            return _traced(run)

        return _memoized(cache_key, build)(fact, dop, beta)

    # --- sketch-resident seam (repro_torch.sketchres) -----------------
    def sketch(self, A: Any = None, *,
               generator: Optional[torch.Generator] = None,
               budget: Optional[float] = None):
        """ONE sweep over the operand → a resident ``SketchState`` sized
        by this plan's spec (``sketchres.sketch_operand``), cached per
        operand signature."""
        from repro_torch.sketchres import BUDGET, sketch_operand
        op = self._wrap(A)
        generator = resolve_generator(generator, caller="plan.sketch",
                                      device=op.device)
        budget = BUDGET if budget is None else budget
        okey = _operand_signature(op)
        spec = self.spec
        if okey is None:
            return sketch_operand(op, spec, generator=generator,
                                  budget=budget)
        cache_key = ("sketch", spec, okey, budget)

        def build():
            def run(op, generator):
                return sketch_operand(op, spec, generator=generator,
                                      budget=budget)
            return _traced(run)

        return _memoized(cache_key, build)(op, generator)

    def sketch_fold(self, state, rows, cols, vals):
        """Fold a COO entry batch into a ``SketchState`` through the
        count-sketch scatter-add kernel — cached per (state signature,
        padded entry count).  Batches are padded to power-of-two lengths
        (``sketchres.pad_entries``; zero-value pads are exact no-ops), so
        an arbitrary delta stream builds O(log E) runners in all."""
        from repro_torch.sketchres import apply_entries, pad_entries
        rows, cols, vals = pad_entries(rows, cols, vals,
                                       device=state.device)
        ssig = _operand_signature(state)
        if ssig is None:
            return apply_entries(state, rows, cols, vals)
        cache_key = ("sketch_fold", ssig, rows.shape[0])

        def build():
            return _traced(apply_entries)

        return _memoized(cache_key, build)(state, rows, cols, vals)

    def sketch_fold_delta(self, state, delta):
        """Fold a factored (or dense) drift block into a ``SketchState``
        via two panel products — cached per (state, delta) signature."""
        from repro_torch.sketchres import apply_lowrank_delta
        dop = as_operator(delta, backend=self.spec.backend)
        ssig = _operand_signature(state)
        dsig = _operand_signature(dop)
        if ssig is None or dsig is None:
            return apply_lowrank_delta(state, dop)
        cache_key = ("sketch_fold_delta", ssig, dsig)

        def build():
            return _traced(apply_lowrank_delta)

        return _memoized(cache_key, build)(state, dop)

    def sketch_reconstruct(self, state):
        """Zero-sweep ``Factorization`` from maintained panels
        (``sketchres.reconstruct``), cached per (spec, state signature).
        The answer is unverified by construction; callers gate it."""
        from repro_torch.sketchres import reconstruct
        spec = self.spec
        ssig = _operand_signature(state)
        if ssig is None:
            return reconstruct(state, spec)
        cache_key = ("sketch_reconstruct", spec, ssig)

        def build():
            def run(state):
                return reconstruct(state, spec)
            return _traced(run)

        return _memoized(cache_key, build)(state)

    def solve_batched(self, ops: Any, *,
                      generators: Optional[Sequence[torch.Generator]] = None,
                      q1s=None, with_info: bool = False):
        """Run the planned factorization over a *stacked* operand — a
        ``DenseOp`` (or tensor) of shape (B, m, n).

        The serve layer's dispatch seam: the runner is built ONCE per
        (spec, stacked signature) and memoized in the same cache as
        single solves.  fsvd runs one masked GK loop whose half-steps are
        one kernel call a stage for the whole batch; rsvd, rbk and
        gnystrom run their examples one after another inside the runner.
        ``generators`` gives one generator per example (required unless
        every example is warm-started), ``q1s`` (B, m) optional start
        vectors.  Returns a ``Factorization`` whose fields carry the
        batch dimension, plus a batched ``ConvergenceInfo`` when
        ``with_info=True``.  A plan that cannot cache (host-loop method,
        non-dense operand) is a caller error.
        """
        _faults.fire(_faults.PLAN_SOLVE)
        if not self.staged:
            raise ValueError(
                f"solve_batched requires a stageable plan; method="
                f"{self.method!r} host_loop={self.spec.host_loop!r} runs "
                "a host-side loop")
        op = as_operator(ops, backend=self.spec.backend)
        okey = _operand_signature(op)
        if not isinstance(op, DenseOp) or op.batch is None or okey is None:
            raise ValueError(
                "solve_batched requires a stacked DenseOp (A of shape "
                f"(B, m, n)); got {type(ops).__name__}")
        if generators is not None and len(generators) != op.batch:
            raise ValueError(f"{len(generators)} generators for a batch of "
                             f"{op.batch}")
        if generators is None and (q1s is None
                                   or self.method in _NEEDS_KEY):
            raise ValueError(
                "solve_batched needs `generators` (one per example) "
                "unless every example is warm-started via `q1s`")
        cache_key = ("solve_batched", self.spec, self.method, okey,
                     generators is None, q1s is None)
        fn = _memoized(cache_key, self._build_batched)
        fact, info = fn(op, generators, q1s)
        return (fact, info) if with_info else fact

    def _build_batched(self):
        spec, method = self.spec, self.method
        if method == "fsvd":
            def run(op, generators, q1s):
                cb = CaptureCallback()
                fact = _solvers.solve_fsvd_batched(
                    op, spec, generators=generators, q1s=q1s, callback=cb)
                return fact, cb.info
            return _traced(run)
        solver = _solver(method)
        takes_cb = _accepts_callback(solver)

        # same rule as _build_solve: scalars only in the closure.
        def run(op, generators, q1s):
            facts, infos = [], []
            for b in range(op.batch):
                one = DenseOp(op.A[b], backend=op.backend)
                g = None if generators is None else generators[b]
                q1 = None if q1s is None else q1s[b]
                cb = CaptureCallback()
                if takes_cb:
                    f = solver(one, spec, generator=g, q1=q1, callback=cb)
                else:
                    f = solver(one, spec, generator=g, q1=q1)
                facts.append(f)
                infos.append(cb.info if cb.info is not None
                             else empty_info(method, f.s.device))
            return _stack(facts, infos)

        return _traced(run)

    def estimate(self, A: Any = None, *,
                 generator: Optional[torch.Generator] = None,
                 sigma_tol: Optional[float] = None) -> RankEstimate:
        """Numerical rank (paper Alg 3) under this plan's spec.

        ``spec.host_loop=None`` keeps the early-exit host loop (iteration
        count == rank estimate); an in-graph estimate (``host_loop=False``)
        is cached like a solve.
        """
        from repro_torch.core.rank import numerical_rank
        spec = self.spec
        if spec.precision is not None:
            # breakdown-based rank detection resolves directions down to
            # the basis storage's CGS2 noise floor: narrowing the storage
            # silently changes what "numerical rank" means, so refuse.
            raise ValueError(
                "estimate_rank requires full-precision bases; got "
                f"spec.precision={spec.precision!r} (rank detection counts "
                "directions the stored basis can certify — use "
                "precision=None)")
        op = self._wrap(A)
        generator = resolve_generator(generator, caller="estimate_rank",
                                      device=op.device)
        if spec.host_loop is None:
            host_loop = sharding_mesh(op) is None
        else:
            host_loop = spec.host_loop

        kwargs = dict(max_iters=spec.max_iters, eps=spec.tol,
                      relative_eps=spec.relative_tol, sigma_tol=sigma_tol,
                      reorth_passes=spec.reorth_passes, dtype=spec.dtype)
        okey = None if host_loop else self.operand_key(op)
        if okey is None:
            res = numerical_rank(op, generator=generator,
                                 host_loop=host_loop, **kwargs)
        else:
            cache_key = ("estimate", spec, okey, sigma_tol)

            def build():
                def run(op, generator):
                    return numerical_rank(op, generator=generator,
                                          host_loop=False, **kwargs)
                return _traced(run)

            res = _memoized(cache_key, build)(op, generator)
        return RankEstimate(res.rank, res.gk_iterations, res.eigenvalues,
                            method="gk")


def _stack(facts, infos):
    """One batched (Factorization, ConvergenceInfo) from per-example
    ones: every tensor field gains a leading batch dimension."""
    from repro_torch.api.callbacks import ConvergenceInfo
    f0, i0 = facts[0], infos[0]
    fact = Factorization(*(torch.stack([getattr(f, k) for f in facts])
                           for k in ("U", "s", "V", "iterations",
                                     "breakdown")), method=f0.method)
    info = ConvergenceInfo(*(torch.stack([getattr(i, k) for i in infos])
                             for k in ("residuals", "iterations",
                                       "breakdown")), method=i0.method)
    return fact, info


def plan(spec: Optional[SVDSpec] = None, *, like: Any = None,
         donate_q1: bool = True, **overrides) -> SolverPlan:
    """Resolve ``spec`` (method, backend) against an optional template
    operand ``like`` and return a reusable :class:`SolverPlan`.

    Keyword overrides merge into the spec exactly as in ``factorize``:
    ``plan(rank=20, like=A)`` == ``plan(SVDSpec(rank=20), like=A)``.
    ``donate_q1`` has no effect in the port (see :class:`SolverPlan`).
    """
    spec = spec or SVDSpec()
    if overrides:
        spec = spec.replace(**overrides)
    wrapped = None
    if like is not None:
        wrapped = as_operator(like, backend=spec.backend)
    return SolverPlan(spec=spec, method=resolve_method(spec, wrapped),
                      like=wrapped, donate_q1=donate_q1)


__all__ = ["HOST_SIDE_METHODS", "SolverPlan", "clear_plan_cache",
           "method_needs_key", "plan", "plan_cache_stats",
           "register_ingraph_method", "resolve_method", "trace_count"]
