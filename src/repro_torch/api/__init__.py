"""repro_torch.api — the spec-driven solver facade of the port.

    from repro_torch.api import SVDSpec, factorize, estimate_rank

    fact = factorize(A, SVDSpec(method="fsvd", rank=20, backend="pallas"),
                     generator=g)
    est = estimate_rank(A, SVDSpec(max_iters=256, backend="pallas"),
                        generator=g)

Methods: ``fsvd``, ``rsvd``, ``rbk``, ``gnystrom``, ``fsvd_blocked`` and
``fsvd_sharded`` (F-SVD on a ``repro_torch.distributed.ShardedOp``, an
operand sharded over the ranks of a ``torch.distributed`` mesh; this
package registers it on import).  Operands: dense tensors, every operator
of ``core.operators`` (sparse, Kronecker, low-rank, sums, scalings,
transposes, Gram) and sharded operators, on which every method runs.  The rank-k update (``update_factorization``,
``downdate_rows``, ``downdate_cols``) revises a factorization with zero
Krylov iterations.  ``factorize`` and ``estimate_rank`` run through the
plan layer (``plan``, ``SolverPlan``: a process-wide cache of runners,
``solve_batched`` over a stacked operand, the update and sketch stages).
A ``Session`` (``session(A, spec, generator=g)``) tracks a drifting
operand across solves: cold, refine and restart solves, the rank-k update
and the sketch-resident entry fold, checkpointed through
``repro_torch.checkpoint``.
"""
from repro_torch.api.callbacks import (CaptureCallback, ConvergenceCallback,
                                       ConvergenceInfo, RecordingCallback)
from repro_torch.api.facade import (estimate_rank, factorize, factorize_jit,
                                    resolve_method)
from repro_torch.api.plan import (SolverPlan, clear_plan_cache, plan,
                                  plan_cache_stats, trace_count)
from repro_torch.api.registry import (available_solvers, get_solver,
                                      register_solver)
from repro_torch.api.results import Factorization, RankEstimate
from repro_torch.api.session import Session, session
from repro_torch.api.spec import METHODS, SVDSpec
from repro_torch.core._keys import ImplicitKeyWarning, resolve_generator
from repro_torch.core.operators import (DenseOp, GramOp, KroneckerOp,
                                        LowRankOp, Operator, ScaledOp,
                                        SinglePassOp, SparseOp, SumOp,
                                        TransposedOp, as_operator)
from repro_torch.core.update import (downdate_cols, downdate_rows,
                                     update_factorization)

__all__ = [
    "SVDSpec", "METHODS", "factorize", "estimate_rank", "resolve_method",
    "factorize_jit", "plan", "SolverPlan", "clear_plan_cache",
    "plan_cache_stats", "trace_count", "Session", "session",
    "ConvergenceInfo", "ConvergenceCallback", "RecordingCallback",
    "CaptureCallback", "Factorization", "RankEstimate",
    "update_factorization", "downdate_rows", "downdate_cols",
    "register_solver", "get_solver", "available_solvers",
    "Operator", "DenseOp", "LowRankOp", "SumOp", "ScaledOp",
    "TransposedOp", "SparseOp", "KroneckerOp", "GramOp", "SinglePassOp",
    "as_operator",
    "resolve_generator", "ImplicitKeyWarning",
]

# registers the "fsvd_sharded" method (it imports this package's facade)
from repro_torch.distributed import gk_dist as _gk_dist  # noqa: E402,F401
