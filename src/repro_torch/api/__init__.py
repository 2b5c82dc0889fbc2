"""repro_torch.api — the spec-driven solver facade of the port.

    from repro_torch.api import SVDSpec, factorize, estimate_rank

    fact = factorize(A, SVDSpec(method="fsvd", rank=20, backend="pallas"),
                     generator=g)
    est = estimate_rank(A, SVDSpec(max_iters=256, backend="pallas"),
                        generator=g)

Ported methods: ``fsvd``, ``rsvd``, ``rbk``, ``gnystrom`` and
``fsvd_blocked``; ``fsvd_sharded`` raises ``NotImplementedError`` naming
its ``ROADMAP.md`` row.  The plan cache and sessions of ``repro.api`` are
later slices.
"""
from repro_torch.api.callbacks import (CaptureCallback, ConvergenceCallback,
                                       ConvergenceInfo, RecordingCallback)
from repro_torch.api.facade import estimate_rank, factorize, resolve_method
from repro_torch.api.registry import (available_solvers, get_solver,
                                      register_solver)
from repro_torch.api.results import Factorization, RankEstimate
from repro_torch.api.spec import METHODS, SVDSpec
from repro_torch.core._keys import ImplicitKeyWarning, resolve_generator
from repro_torch.core.operators import (DenseOp, GramOp, Operator,
                                        SinglePassOp, TransposedOp,
                                        as_operator)

__all__ = [
    "SVDSpec", "METHODS", "factorize", "estimate_rank", "resolve_method",
    "ConvergenceInfo", "ConvergenceCallback", "RecordingCallback",
    "CaptureCallback", "Factorization", "RankEstimate",
    "register_solver", "get_solver", "available_solvers",
    "Operator", "DenseOp", "TransposedOp", "GramOp", "SinglePassOp",
    "as_operator",
    "resolve_generator", "ImplicitKeyWarning",
]
