"""Zero-padding to canonical shapes.  Counterpart of ``repro.core.padding``.

The reference's distributed partitioner pads an operand up to the mesh
tiling and its serving layer up to a shape bucket; both ports will share
these helpers.  Zero rows and columns are inert for every product the
solvers issue, but not bitwise inert (a padded width can change the
reduction order), so a layer that promises identical bits slices the
logical operand back out (:func:`unpad`, exact) before it solves.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def pad_dim(size: int, multiple: int) -> int:
    """Smallest ``s >= size`` with ``s % multiple == 0`` (multiple >= 1)."""
    if multiple < 1:
        raise ValueError(f"multiple must be >= 1, got {multiple}")
    return size + (-size) % multiple


def padded_shape(shape: Sequence[int],
                 multiples: Sequence[int]) -> Tuple[int, ...]:
    """Per-dim :func:`pad_dim`: the smallest shape >= ``shape`` whose dims
    are multiples of ``multiples``."""
    if len(shape) != len(multiples):
        raise ValueError(
            f"shape {tuple(shape)} and multiples {tuple(multiples)} must "
            "have equal length")
    return tuple(pad_dim(s, t) for s, t in zip(shape, multiples))


def pad_to(A, shape: Sequence[int]):
    """Zero-embed ``A`` in the top-left corner of ``shape``: the same
    object when the shape already matches; numpy stays numpy, a tensor
    stays a tensor on its device."""
    shape = tuple(shape)
    if tuple(A.shape) == shape:
        return A
    widths = []
    for have, want in zip(A.shape, shape):
        if want < have:
            raise ValueError(
                f"cannot pad {tuple(A.shape)} down to {shape}")
        widths.append((0, want - have))
    if isinstance(A, np.ndarray):
        return np.pad(A, widths)
    # F.pad takes (before, after) pairs from the last dim backwards
    flat = [w for pair in reversed(widths) for w in pair]
    return torch.nn.functional.pad(A, flat)


def unpad(A, shape: Sequence[int]):
    """Slice the logical top-left ``shape`` block back out of a padded
    buffer: exact, it only moves bytes."""
    shape = tuple(shape)
    if tuple(A.shape) == shape:
        return A
    return A[tuple(slice(0, s) for s in shape)]


__all__ = ["pad_dim", "padded_shape", "pad_to", "unpad"]
