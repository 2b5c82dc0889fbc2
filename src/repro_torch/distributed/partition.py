"""Operator placement on a device mesh: the solver side of the reference's
``repro.distributed.partition``.

A dense (m, n) operand shards its rows over the ``("pod", "data")`` axes
present and its columns over ``"model"`` when present, the layout every
``repro_torch.distributed.ShardedOp`` product assumes.  Row block i of
the operand lies on the ranks whose coordinates on the row axes, read in
``("pod", "data")`` order, make the row-major index i (as a JAX
``PartitionSpec(("pod", "data"), "model")`` places them); column block j
on the ranks with ``"model"`` coordinate j.  A shape that does not tile
the mesh is zero-padded first, which is exact for every product and
reduction the solvers issue.

The model-parameter rules of the reference (``logical_to_spec``,
``param_shardings``, ``spec_for_batch``) come with the models
(``ROADMAP.md`` Queue 1 item 7).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.padding import pad_to
from repro_torch.core.padding import padded_shape as _padded_shape

Tensor = torch.Tensor


def mesh_sizes(mesh) -> dict:
    """{dimension name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def operator_axes(mesh) -> Tuple[Tuple[str, ...], Optional[str]]:
    """``(row_axes, col_axis)`` of the operand layout on ``mesh``: rows
    over the ("pod", "data") axes present, columns over "model" when
    present.  Either side may be absent (that dimension is then whole on
    every rank)."""
    rows = batch_axes(mesh)
    col = "model" if "model" in mesh.mesh_dim_names else None
    return rows, col


def operator_counts(mesh) -> Tuple[int, int]:
    """(row shard count R, column shard count C) of the operand layout."""
    rows, col = operator_axes(mesh)
    sizes = mesh_sizes(mesh)
    r = math.prod(sizes[a] for a in rows) if rows else 1
    c = sizes[col] if col else 1
    return r, c


def operator_spec(mesh) -> Tuple[Optional[Tuple[str, ...]], Optional[str]]:
    """The reference's ``PartitionSpec`` of a dense operand as a pair:
    (row axes or None, column axis or None)."""
    rows, col = operator_axes(mesh)
    return (rows or None, col)


def axes_index(mesh, axes: Tuple[str, ...], coord=None) -> int:
    """Row-major index over ``axes`` (in the order given) of this rank's
    coordinate, or of ``coord`` ({name: position})."""
    sizes = mesh_sizes(mesh)
    if coord is None:
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def shard_index(mesh) -> Tuple[int, int]:
    """(row block i, column block j) this rank holds."""
    rows, col = operator_axes(mesh)
    return axes_index(mesh, rows), axes_index(mesh, (col,) if col else ())


def shard_shape(shape: Tuple[int, int], mesh) -> Tuple[int, int]:
    """Per-rank block shape of an operand laid out by
    :func:`place_operator` (requires a divisible ``shape``)."""
    m, n = shape
    r, c = operator_counts(mesh)
    if m % r or n % c:
        raise ValueError(
            f"operand shape {tuple(shape)} does not tile a ({r} x {c})-way "
            f"mesh layout; pad first (see padded_operand_shape)")
    return (m // r, n // c)


def padded_operand_shape(shape: Tuple[int, int], mesh) -> Tuple[int, int]:
    """Smallest shape >= ``shape`` whose rows / columns tile the mesh
    layout.  Zero-padding to it is exact for every matvec and CGS
    reduction the solvers issue (zero rows and columns add nothing to any
    dot); the arithmetic is the shared ``core.padding`` helper."""
    r, c = operator_counts(mesh)
    return _padded_shape(tuple(shape), (r, c))


def place_operator(A: Tensor, mesh) -> Tensor:
    """This rank's block of ``A`` under the operand layout, zero-padded to
    :func:`padded_operand_shape` first: a contiguous tensor of
    :func:`shard_shape` on ``A``'s device, holding no reference to A."""
    mp, np_ = padded_operand_shape(tuple(A.shape), mesh)
    bm, bn = shard_shape((mp, np_), mesh)
    i, j = shard_index(mesh)
    m, n = A.shape
    blk = A[i * bm:min((i + 1) * bm, m), j * bn:min((j + 1) * bn, n)]
    out = pad_to(blk, (bm, bn))
    if out is blk:                       # a view of A: copy it out
        return blk.clone(memory_format=torch.contiguous_format)
    return out.contiguous()
