"""The serving layer of the port.  Counterpart of ``repro.serve``; so far
only its resilience primitives (``serve.resilience``: the failure
taxonomy, ``CircuitBreaker``, ``retry_with_backoff``, ``residual_probe``,
``finite_or_raise``), which the Session's sketch branch needs.  The
server's modules come with ``ROADMAP.md`` Queue 1 item 5."""
from repro_torch.serve.resilience import (CircuitBreaker, CircuitOpen,
                                          DeadlineExceeded,
                                          DegradedRejected, PoisonedOperand,
                                          WorkerCrashed, finite_or_raise,
                                          residual_probe, retry_with_backoff)

__all__ = [
    "CircuitBreaker", "CircuitOpen", "DeadlineExceeded", "DegradedRejected",
    "PoisonedOperand", "WorkerCrashed", "finite_or_raise", "residual_probe",
    "retry_with_backoff",
]
