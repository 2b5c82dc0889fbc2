"""Shape bucketing — collapse a heavy-traffic shape mix onto canonical
shapes.

Counterpart of ``repro.serve.bucket``.  A serve front end sees an
open-ended mix of operand shapes; bucketing rounds every dim up to a
``quantum`` grid (through the shared :mod:`repro_torch.core.padding`
helper), so the traffic collapses onto a bounded set of canonical buckets
and same-bucket request buffers stack into one batched dispatch.

Correctness contract (the part that earns the "never perturb σ" claim):

* **exact mode** (the default): the padded buffer is *transport only*.
  Before the solve, :meth:`Bucketed.extract` slices the logical operand
  back out — slicing moves bytes, it never rounds — and the solver runs at
  the logical shape through the ordinary plan cache.  Same runner, same
  input bits ⇒ σ **bit-identical** to an unbucketed solve.  Requests then
  group per *logical* shape; the bucket bounds transport shapes and batch
  grouping, not the runner count.

* **shared mode**: the solver runs at the *bucket* shape, so every
  logical shape in a bucket shares one runner per batch size.  Zero
  rows/cols are mathematically inert for every matvec/CGS reduction, but
  the padded width changes the kernels' reduction order, so σ can move in
  the last ulps.  :func:`unpad_factors` slices U/V back to logical rows
  afterwards.

Transport stays **numpy** on the host: a request crosses to the device
once per dispatched batch, in :func:`stack_buckets` (or the server's own
stack in exact mode) — one host-side ``np.stack`` and one copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.padding import pad_to, padded_shape, unpad

# default bucket granularity: coarse enough to collapse a Zipf shape mix
# onto a handful of buckets, fine enough that padding waste stays < ~2x.
DEFAULT_QUANTUM = 32


def bucket_shape(shape: Sequence[int],
                 quantum: int = DEFAULT_QUANTUM) -> Tuple[int, ...]:
    """Canonical (bucket) shape for ``shape``: every dim rounded up to a
    multiple of ``quantum``."""
    return padded_shape(shape, (quantum,) * len(shape))


@dataclasses.dataclass(frozen=True)
class Bucketed:
    """One request operand in padded (canonical-shape) transport form.

    ``data`` is the zero-embedded bucket buffer (numpy, on the host);
    ``logical_shape`` is the caller's true geometry.  :meth:`extract`
    restores the logical operand exactly (a slice, no arithmetic).
    """

    data: Any                      # np.ndarray (host transport buffer)
    logical_shape: Tuple[int, ...]

    @property
    def bucket(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def padded(self) -> bool:
        return self.bucket != tuple(self.logical_shape)

    def extract(self):
        """The logical operand, bit-for-bit (exact slice, numpy view)."""
        return unpad(self.data, self.logical_shape)


def embed(A, quantum: int = DEFAULT_QUANTUM) -> Bucketed:
    """Zero-embed ``A`` (a numpy array or a CPU tensor) into its bucket's
    canonical shape, on the host."""
    A = np.asarray(A)
    return Bucketed(data=pad_to(A, bucket_shape(A.shape, quantum)),
                    logical_shape=tuple(A.shape))


def stack(arrays: Sequence[Any], device=None) -> torch.Tensor:
    """Equal-shape host arrays as one (B, m, n) tensor on ``device``
    (default: the card): one ``np.stack`` and one host → device copy."""
    return torch.from_numpy(np.stack([np.asarray(a) for a in arrays])).to(
        resolve_device(device))


def stack_buckets(items: Sequence[Bucketed], device=None) -> torch.Tensor:
    """Stack same-bucket transport buffers into a (B, M, N) batch on
    ``device`` (default: the card).

    All items must share one bucket (that is what the batcher's group key
    guarantees).  The stack happens host-side (numpy), then crosses to the
    device in one copy — the only transfer on the dispatch path.
    """
    if not items:
        raise ValueError("cannot stack an empty bucket batch")
    buckets = {it.bucket for it in items}
    if len(buckets) != 1:
        raise ValueError(f"mixed buckets in one batch: {sorted(buckets)}")
    return stack([it.data for it in items], device)


def unpad_factors(fact, logical_shape: Tuple[int, int]):
    """Slice a bucket-shape factorization's U/V back to logical rows.

    For a zero-padded operand the top-r left/right singular vectors have
    (mathematically) zero support on the padded rows/cols; shared-mode
    serving discards them after the solve.  σ is returned as computed —
    shared mode's documented roundoff-level perturbation lives there.
    """
    m, n = logical_shape
    return dataclasses.replace(fact, U=fact.U[..., :m, :],
                               V=fact.V[..., :n, :])


__all__ = ["DEFAULT_QUANTUM", "Bucketed", "bucket_shape", "embed",
           "stack", "stack_buckets", "unpad_factors"]
