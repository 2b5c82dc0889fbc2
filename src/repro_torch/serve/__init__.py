"""Factorization-as-a-service: the multi-tenant solve server of the port.

Counterpart of ``repro.serve``, with the same modules:

    bucket.py     shape-bucketing + zero-padded numpy transport
    batcher.py    continuous batching under a supervised, restartable
                  dispatch worker (thread + queue.Queue, no asyncio)
    resilience.py typed failure taxonomy, circuit breaker, retry backoff,
                  HMT residual probe gating degraded answers
    tenant.py     per-tenant Session state (LRU-evicted, checkpointable)
    traffic.py    synthetic Zipf traffic shared by the CLI and
                  ``chip_smoke.py``
    server.py     the front end wiring intake -> bucket -> batch -> plan,
                  plus deadlines / quarantine / breaker / degraded mode

Quickstart::

    from repro_torch.serve import SolveServer
    with SolveServer(SVDSpec(rank=8, backend="pallas"),
                     generator=torch.Generator().manual_seed(0)) as srv:
        fact = srv.solve(A).value            # sync, batched under the hood
        t = srv.submit(A2)                    # async: a Ticket
        print(t.result(timeout=5.0).value.s)
        print(srv.stats())

The server runs on the CUDA card unless ``device="cpu"`` is given; from a
shell: ``python -m repro_torch.launch.solve_serve --requests 200`` (add
``--device cpu`` for the plain path).
"""
from repro_torch.serve.batcher import (Cancelled, ContinuousBatcher,
                                       QueueFull, Ticket)
from repro_torch.serve.bucket import (Bucketed, bucket_shape, embed,
                                      stack_buckets, unpad_factors)
from repro_torch.serve.resilience import (CircuitBreaker, CircuitOpen,
                                          DeadlineExceeded,
                                          DegradedRejected, PoisonedOperand,
                                          WorkerCrashed, residual_probe)
from repro_torch.serve.server import ServeResult, SolveServer
from repro_torch.serve.tenant import TenantRegistry
from repro_torch.serve.traffic import (Request, lowrank_drift,
                                       synthetic_stream)

__all__ = [
    "Bucketed", "bucket_shape", "embed", "stack_buckets", "unpad_factors",
    "Cancelled", "ContinuousBatcher", "QueueFull", "Ticket",
    "CircuitBreaker", "CircuitOpen", "DeadlineExceeded", "DegradedRejected",
    "PoisonedOperand", "WorkerCrashed", "residual_probe",
    "TenantRegistry", "ServeResult", "SolveServer",
    "Request", "lowrank_drift", "synthetic_stream",
]
