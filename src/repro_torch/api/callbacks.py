"""Convergence diagnostics: ``ConvergenceInfo`` and the callback protocol.

Counterpart of ``repro.api.callbacks``.  Host-loop solvers call
``callback.on_step(i, **metrics)`` with the host scalars they synced
anyway; every solver hands the final :class:`ConvergenceInfo` (device
tensors) to ``callback.on_info``.  For GK the per-iteration residual
proxy is ``beta_{i+1}``, whose collapse is Alg 1's breakdown event.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ConvergenceInfo:
    """Per-solve convergence record.

    residuals  — (k,) per-iteration residual proxies, zero beyond
                 ``iterations``.
    iterations — () int32: iterations actually used.
    breakdown  — () bool: did the breakdown flag fire.
    method     — producing solver.
    """

    residuals: Tensor
    iterations: Tensor
    breakdown: Tensor
    method: str = "fsvd"

    @property
    def last_residual(self) -> Tensor:
        """The final residual proxy, 0.0 when empty."""
        if self.residuals.shape[0] == 0:
            return torch.zeros((), device=self.residuals.device)
        idx = torch.clamp(self.iterations.long() - 1, 0,
                          self.residuals.shape[0] - 1)
        return self.residuals[idx]


def empty_info(method: str, device=None) -> ConvergenceInfo:
    """A structurally valid info for solvers with no per-iteration signal
    (on ``device``)."""
    return ConvergenceInfo(torch.zeros((0,), dtype=torch.float32,
                                       device=device),
                           torch.zeros((), dtype=torch.int32, device=device),
                           torch.zeros((), dtype=torch.bool, device=device),
                           method=method)


class ConvergenceCallback:
    """Base/no-op callback: subclass and override what you observe."""

    def on_step(self, i: int, **metrics) -> None:   # pragma: no cover
        pass

    def on_info(self, info: ConvergenceInfo) -> None:  # pragma: no cover
        pass


class RecordingCallback(ConvergenceCallback):
    """Collects ``steps`` as (i, metrics) tuples and the final ``info``."""

    def __init__(self) -> None:
        self.steps: list[tuple[int, dict]] = []
        self.info: Optional[ConvergenceInfo] = None

    def on_step(self, i: int, **metrics) -> None:
        self.steps.append((i, metrics))

    def on_info(self, info: ConvergenceInfo) -> None:
        self.info = info


class CaptureCallback(ConvergenceCallback):
    """Holds the final info only."""

    def __init__(self) -> None:
        self.info: Optional[ConvergenceInfo] = None

    def on_info(self, info: ConvergenceInfo) -> None:
        self.info = info
