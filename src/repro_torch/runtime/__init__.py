"""Runtime support of the port: the fault-injection (failpoint) registry
(``faults``), the training- and serving-health telemetry
(``repro_torch.runtime.telemetry``: ``LatencyStats``, ``grad_spectrum``,
``gradient_rank_summary``), the step factories
(``repro_torch.runtime.steps``: one device, a mesh, the compressed
multi-pod step) and the fault-tolerant training loop
(``repro_torch.runtime.trainer``).

Counterpart of ``repro.runtime``.  Only ``faults`` loads eagerly: it sits
on the solve and checkpoint paths, which must not pull in the model
stack.  ``TrainState``, ``build_train_step``, ``build_eval_step`` and
``Trainer`` resolve lazily (PEP 562).
"""
from repro_torch.runtime import faults

__all__ = ["TrainState", "build_train_step", "build_eval_step", "Trainer",
           "faults"]


def __getattr__(name):
    if name in ("TrainState", "build_train_step", "build_eval_step"):
        from repro_torch.runtime import steps
        return getattr(steps, name)
    if name == "Trainer":
        from repro_torch.runtime.trainer import Trainer
        return Trainer
    raise AttributeError(
        f"module 'repro_torch.runtime' has no attribute {name!r}")
