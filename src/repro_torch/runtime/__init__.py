"""Runtime support of the port: the fault-injection (failpoint) registry
(``faults``) and the training- and serving-health telemetry
(``repro_torch.runtime.telemetry``: ``LatencyStats``, ``grad_spectrum``,
``gradient_rank_summary``).

Counterpart of ``repro.runtime``.  Only ``faults`` loads eagerly: it sits
on the solve and checkpoint paths, which must not pull in the rest.  The
train-loop members come with the training stack (``ROADMAP.md`` Queue 1
item 7).
"""
from repro_torch.runtime import faults

__all__ = ["faults"]
