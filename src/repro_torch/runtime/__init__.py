"""Runtime support of the port: the fault-injection (failpoint) registry
(``faults``), the training- and serving-health telemetry
(``repro_torch.runtime.telemetry``: ``LatencyStats``, ``grad_spectrum``,
``gradient_rank_summary``) and the single-device step factories
(``repro_torch.runtime.steps``).

Counterpart of ``repro.runtime``.  Only ``faults`` loads eagerly: it sits
on the solve and checkpoint paths, which must not pull in the model
stack.  ``TrainState``, ``build_train_step`` and ``build_eval_step``
resolve lazily (PEP 562); the fault-tolerant ``Trainer`` is not ported
yet (``ROADMAP.md`` Queue 1 item 7b).
"""
from repro_torch.runtime import faults

__all__ = ["TrainState", "build_train_step", "build_eval_step", "faults"]


def __getattr__(name):
    if name in ("TrainState", "build_train_step", "build_eval_step"):
        from repro_torch.runtime import steps
        return getattr(steps, name)
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")
