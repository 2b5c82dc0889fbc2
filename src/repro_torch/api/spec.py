"""SVDSpec — one declarative knob set for every low-rank solver.

Counterpart of ``repro.api.spec`` with the same fields, defaults and
validation, so that one spec means the same thing to both packages
(``bridge.spec`` carries a reference spec over).  Two fields read
differently here:

    backend  "xla" | "pallas" — the reference's names.  In the port
             "pallas" means the hand-written Hopper kernels of
             ``repro_torch.kernels`` (their plain-torch versions on CPU
             tensors) and "xla" means plain torch ops.
    dtype    compute dtype override: None or a ``torch.dtype``.

See ``repro.api.spec.SVDSpec`` for the meaning of every other field.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

METHODS = ("auto", "fsvd", "rsvd", "fsvd_blocked", "fsvd_sharded", "rbk",
           "gnystrom")

SKETCH_KINDS = ("sparse_sign", "gaussian")


@dataclasses.dataclass(frozen=True)
class SVDSpec:
    """Declarative description of a partial-SVD / rank-estimation solve
    (fields as in ``repro.api.spec.SVDSpec``)."""

    method: str = "auto"
    rank: int = 10
    max_iters: Optional[int] = None
    tol: float = 1e-8
    relative_tol: bool = True
    reorth_passes: int = 2
    oversample: int = 10
    power_iters: int = 0
    sketch_dim: Optional[int] = None
    passes: int = 2
    sketch_kind: str = "sparse_sign"
    backend: str = "xla"
    block_size: Optional[int] = None
    max_basis: Optional[int] = None
    precision: Optional[str] = None
    dtype: Any = None
    host_loop: Optional[bool] = None

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.block_size is not None and self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.max_basis is not None and self.max_basis < 1:
            raise ValueError(f"max_basis must be >= 1, got {self.max_basis}")
        if self.sketch_dim is not None and self.sketch_dim < 1:
            raise ValueError(
                f"sketch_dim must be >= 1, got {self.sketch_dim}")
        if self.passes < 0:
            raise ValueError(f"passes must be >= 0, got {self.passes}")
        if self.method == "rbk" and self.passes == 0:
            raise ValueError(
                "method='rbk' is the iterative randomized block-Krylov "
                "solver and needs at least one pass over the operand; "
                "passes=0 (sketch-only) is the gnystrom regime — use "
                "method='gnystrom' instead")
        if self.method in ("rbk", "gnystrom") and \
                self.sketch_dim is not None and self.sketch_dim < self.rank:
            raise ValueError(
                f"sketch_dim={self.sketch_dim} cannot resolve rank="
                f"{self.rank}: the sketch panel must span at least the "
                "requested rank (sketch_dim >= rank; leave sketch_dim=None "
                "for the oversampled default)")
        if self.sketch_kind not in SKETCH_KINDS:
            raise ValueError(
                f"sketch_kind must be one of {SKETCH_KINDS}, got "
                f"{self.sketch_kind!r}")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(
                f"backend must be 'xla' or 'pallas', got {self.backend!r}")
        if self.precision not in (None, "f32", "bf16"):
            raise ValueError(
                "precision must be None, 'f32' or 'bf16', got "
                f"{self.precision!r}")
        if self.dtype is not None and not isinstance(self.dtype, torch.dtype):
            raise TypeError(
                f"dtype must be None or a torch.dtype, got {self.dtype!r}")

    def replace(self, **changes) -> "SVDSpec":
        return dataclasses.replace(self, **changes)
