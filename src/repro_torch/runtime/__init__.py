"""Runtime support of the port: the fault-injection (failpoint) registry.

Counterpart of ``repro.runtime``; its train-loop members come with the
training stack (``ROADMAP.md`` Queue 1 item 7).
"""
from repro_torch.runtime import faults

__all__ = ["faults"]
