"""Logical-axis -> mesh-axis partitioning, and the operator placement.
Counterpart of ``repro.distributed.partition``.

Model code names every parameter dimension with a *logical* axis
(``repro_torch.models.layers.ParamBag``); :data:`RULES` maps those names
onto the mesh:

    vocab / heads / kv_heads / mlp / experts / ssm_inner -> "model"
    embed                                                -> "data"  (FSDP)
    everything small or sequential                       -> replicated

with the reference's two guards: a dimension whose size does not divide
its mesh axis stays whole (divisibility), and a mesh axis claimed by an
earlier dimension is not claimed again (conflict: the expert weights'
"experts" dimension takes "model", so their "mlp" dimension stays
whole).  "pod" is never assigned to a parameter; batch axes shard over
("pod", "data").  A spec is a plain tuple with one entry a dimension: a
mesh-axis name, a tuple of names (taken row-major; one name alone, as
``PartitionSpec`` writes it) or None, trailing Nones dropped, as the
reference's ``logical_to_spec`` drops them.  A "mesh"
is a ``DeviceMesh`` of ``repro_torch.launch.mesh`` or, where no process
group is needed (the rules alone), a ``{name: size}`` mapping.

:func:`local_block` cuts a rank's block of a tensor under its spec;
:func:`gather_leaves` puts the blocks of every rank back together in
shard order with one ``all_gather`` (``distributed.matvec``'s counted
collective), the same bits on every rank.

A dense (m, n) operand shards its rows over the ``("pod", "data")`` axes
present and its columns over ``"model"`` when present, the layout every
``repro_torch.distributed.ShardedOp`` product assumes.  Row block i of
the operand lies on the ranks whose coordinates on the row axes, read in
``("pod", "data")`` order, make the row-major index i (as a JAX
``PartitionSpec(("pod", "data"), "model")`` places them); column block j
on the ranks with ``"model"`` coordinate j.  A shape that does not tile
the mesh is zero-padded first, which is exact for every product and
reduction the solvers issue.

"""
from __future__ import annotations

import itertools
import math
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.padding import pad_to
from repro_torch.core.padding import padded_shape as _padded_shape

Tensor = torch.Tensor


Spec = Tuple[Any, ...]

# logical axis -> preferred mesh axis (None = replicate)
RULES: dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "embed": "data",
    # replicated (small or sequential):
    "head_dim": None, "kv_lora": None, "q_lora": None, "experts_dim": None,
    "ssm_state": None, "ssm_heads": None, "conv_k": None, "img_in": None,
    "layers": None,
}


def mesh_sizes(mesh) -> dict:
    """{dimension name: size} of a ``DeviceMesh`` (or of a ``{name: size}``
    mapping), in the mesh's order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


# --------------------------------------------------------------------------
# model parameters and batches
# --------------------------------------------------------------------------

def _strip(spec: list) -> Spec:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def logical_to_spec(axes: Sequence[str], shape: Sequence[int], mesh) -> Spec:
    """The spec of one parameter from its logical axes and shape."""
    taken: set = set()
    spec = []
    sizes = mesh_sizes(mesh)
    for name, dim in zip(axes, shape):
        mesh_axis = RULES.get(name)
        if (mesh_axis is None or mesh_axis not in sizes
                or mesh_axis in taken or dim % sizes[mesh_axis] != 0):
            spec.append(None)
        else:
            spec.append(mesh_axis)
            taken.add(mesh_axis)
    return _strip(spec)


def param_shardings(logical, params_shape, mesh):
    """The spec tree of a parameter tree: ``logical`` mirrors the params
    with tuples of axis names, ``params_shape`` is the params tree itself
    (tensors, meta tensors, or anything with a ``shape``)."""
    if isinstance(logical, Mapping):
        return {k: param_shardings(v, params_shape[k], mesh)
                for k, v in logical.items()}
    return logical_to_spec(tuple(logical), tuple(params_shape.shape), mesh)


def spec_for_batch(mesh, batch: int, ndim: int,
                   seq_axis_shard: bool = False) -> Spec:
    """Spec of a (B, S, ...) batch tensor: B over ("pod", "data") when
    divisible; for B = 1 long-context cells ``seq_axis_shard=True`` shards
    the sequence axis over "data" instead."""
    baxes = batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    total = math.prod(sizes[a] for a in baxes)
    if batch % total == 0 and batch >= total:
        return _strip([axes_entry(baxes)] + [None] * (ndim - 1))
    if seq_axis_shard and ndim >= 2:
        return _strip([None, "data"] + [None] * (ndim - 2))
    return ()


def axes_entry(axes: Tuple[str, ...]):
    """A spec entry of ``axes``: the name alone for one axis, as
    ``PartitionSpec`` normalizes it."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def rank_coords(mesh) -> list:
    """The coordinate ({name: position}) of every rank of a
    ``DeviceMesh``, indexed by rank."""
    names = tuple(mesh.mesh_dim_names)
    flat = mesh.mesh.reshape(-1).tolist()
    coords = [None] * len(flat)
    for pos, r in zip(itertools.product(*(range(n) for n in
                                          mesh.mesh.shape)), flat):
        coords[r] = dict(zip(names, pos))
    return coords


def my_coord(mesh) -> dict:
    """This rank's coordinate on ``mesh`` ({name: position})."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def block_slices(spec: Spec, shape: Sequence[int], mesh, coord=None
                 ) -> Tuple[slice, ...]:
    """The slices of the block of a ``shape`` tensor that the rank at
    ``coord`` (default: this rank) holds under ``spec``."""
    sizes = mesh_sizes(mesh)
    if coord is None:
        coord = my_coord(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(f"dimension {d} ({n}) does not tile the "
                             f"{parts}-way spec entry {spec[d]!r}")
        i = axes_index(mesh, axes, coord)
        b = n // parts
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def local_block(x: Tensor, spec: Spec, mesh, coord=None) -> Tensor:
    """The block of ``x`` the rank at ``coord`` (default: this rank) holds
    under ``spec``: a contiguous copy, holding no reference to ``x``."""
    blk = x[block_slices(spec, x.shape, mesh, coord)]
    return blk.clone(memory_format=torch.contiguous_format)


def _words(t: Tensor) -> Tensor:
    """``t``'s bytes as a flat float32 tensor (padded to 8 bytes): the
    collective only copies them."""
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    pad = -raw.numel() % 8
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.float32)


def gather_packed(tensors: Sequence[Tensor]) -> list:
    """Every rank's ``tensors`` (the same shapes and dtypes on all ranks,
    on one device), indexed by rank, with ONE counted ``all_gather`` of
    their bytes, whatever their dtypes."""
    from repro_torch.distributed.matvec import _all_gather
    words = [_words(t) for t in tensors]
    parts = _all_gather(torch.cat(words) if len(words) > 1 else words[0])
    out = []
    for part in parts:
        raw = part.view(torch.uint8)
        got, off = [], 0
        for t, w in zip(tensors, words):
            nb = t.numel() * t.element_size()
            got.append(raw[off:off + nb].view(t.dtype).view(t.shape))
            off += w.numel() * 4
        out.append(got)
    return out


def restrict(spec: Spec, keep: Sequence[str]) -> Spec:
    """``spec`` with only the entries that name ``keep`` axes alone."""
    return _strip([e if e is not None and set(_entry_axes(e)) <= set(keep)
                   else None for e in spec])


def assemble(parts: Sequence[Tensor], spec: Spec, shape: Sequence[int],
             mesh, within: Spec = ()) -> Tensor:
    """This rank's block under ``within`` (default: the whole tensor) from
    every rank's block under ``spec`` (``parts`` indexed by rank;
    ``within`` a :func:`restrict` of ``spec``): each block is taken from
    the first rank, in rank order, that holds it."""
    coords = rank_coords(mesh)
    region = block_slices(within, shape, mesh,
                          my_coord(mesh) if within else coords[0])
    out = parts[0].new_empty(tuple(g.stop - g.start for g in region))
    seen = set()
    for r, part in enumerate(parts):
        sl = block_slices(spec, shape, mesh, coords[r])
        key = tuple((s.start, s.stop) for s in sl)
        if key in seen or any(s.start < g.start or s.stop > g.stop
                              for s, g in zip(sl, region)):
            continue
        seen.add(key)
        out[tuple(slice(s.start - g.start, s.stop - g.start)
                  for s, g in zip(sl, region))] = part
    return out


def gather_leaves(blocks: Sequence[Tensor], specs: Sequence[Spec],
                  shapes: Sequence[Sequence[int]], mesh,
                  within: Optional[Sequence[Spec]] = None) -> list:
    """The whole tensors (or, per leaf, this rank's block under
    ``within[i]``) of this rank's ``blocks``, each under its spec and of
    its whole ``shape``, with one :func:`gather_packed`: the same bits on
    every rank.  A leaf its spec leaves whole on every rank is returned
    as it is, without a collective."""
    sizes = mesh_sizes(mesh)
    within = list(within) if within is not None else [()] * len(blocks)
    # the leaves split over an axis of size > 1 that ``within`` keeps whole
    idx = [i for i, s in enumerate(specs)
           if math.prod(sizes[a] for a in spec_axes(s)
                        if a not in spec_axes(within[i])) > 1]
    out = list(blocks)
    if not idx:
        return out
    per_rank = gather_packed([blocks[i] for i in idx])
    for j, i in enumerate(idx):
        out[i] = assemble([p[j] for p in per_rank], specs[i], shapes[i],
                          mesh, within[i])
    return out


# --------------------------------------------------------------------------
# operator placement: rows over ("pod", "data"), columns over "model"
# --------------------------------------------------------------------------

def operator_axes(mesh) -> Tuple[Tuple[str, ...], Optional[str]]:
    """``(row_axes, col_axis)`` of the operand layout on ``mesh``: rows
    over the ("pod", "data") axes present, columns over "model" when
    present.  Either side may be absent (that dimension is then whole on
    every rank)."""
    rows = batch_axes(mesh)
    col = "model" if "model" in mesh_sizes(mesh) else None
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
        coord = my_coord(mesh)
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
