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
:func:`gather_leaves` puts the blocks back together in shard order with
one ``all_gather`` a group (``distributed.matvec``'s counted collective
over the ranks that hold the other blocks), the same bits on every rank;
:func:`block_grid` sees a tensor as every rank's block at once, so an
exchange costs a few ops a leaf, not a few a rank.
:func:`model_region` says which leaves the layers compute by their
"model" block (tensor and expert parallelism) and which whole.

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
import weakref
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


# the logical axes whose "model" split the layers compute block by block:
# tensor parallelism over heads, kv heads, the MLP's width, the
# vocabulary and the Mamba2 heads (ssm_inner), expert parallelism over the
# experts.
MODEL_COMPUTE = ("vocab", "heads", "kv_heads", "mlp", "experts", "ssm_inner")

# leaves (by name) that the rules split over "model" but whose block is not
# the region a layer computes with: the Mamba2 conv's weight and bias
# carry ssm_inner on conv_dim = d_in + 2·G·N, whose contiguous blocks line
# up neither with a rank's heads' x channels nor with the B and C channels
# every rank reads whole.  A layer takes them whole, reads its channels
# and has their gradients summed over "model" (``layers.enter``).
WHOLE_IN_BLOCK = ("conv_w", "conv_b")


def model_region(axes: Sequence[str], spec: Spec, name: str = "") -> Spec:
    """What a rank computes with of a leaf of logical ``axes`` under
    ``spec`` (``name``: the leaf's own name, its path's last part): its
    "model" block where the spec splits a :data:`MODEL_COMPUTE` dimension
    over "model", else (and for :data:`WHOLE_IN_BLOCK`) the whole leaf
    (``()``)."""
    if name in WHOLE_IN_BLOCK:
        return ()
    for entry_name, entry in zip(axes, spec):
        if entry == "model" and entry_name in MODEL_COMPUTE:
            return restrict(spec, ("model",))
    return ()


def mesh_sizes(mesh) -> dict:
    """{dimension name: size} of a ``DeviceMesh`` (or of a ``{name: size}``
    mapping), in the mesh's order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


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


# a DeviceMesh's ranks and coordinates, read once (its ``mesh`` tensor
# is rebuilt at every read in recent torch)
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _layout_of(mesh) -> tuple:
    got = _LAYOUTS.get(mesh)
    if got is None:
        from torch.utils._python_dispatch import _disable_current_modes
        # with every dispatch mode set aside: a step traced under
        # ``FakeTensorMode`` reads them too
        with _disable_current_modes():
            ranks = mesh.mesh.tolist()
        names = tuple(mesh.mesh_dim_names)
        flat = ranks
        for _ in range(len(names) - 1):
            flat = [r for row in flat for r in row]
        coords = [None] * len(flat)
        for pos, r in zip(itertools.product(*(range(n) for n in
                                              mesh_sizes(mesh).values())),
                          flat):
            coords[r] = dict(zip(names, pos))
        got = _LAYOUTS[mesh] = (ranks, coords,
                                flat == list(range(len(flat))))
    return got


def mesh_ranks(mesh) -> list:
    """A ``DeviceMesh``'s ranks as nested lists (read-only)."""
    return _layout_of(mesh)[0]


def rank_coords(mesh) -> list:
    """The coordinate ({name: position}) of every rank of a
    ``DeviceMesh``, indexed by rank (read-only)."""
    return _layout_of(mesh)[1]


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


ALIGN = 8              # bytes: every packed tensor starts on such a boundary


def _padded(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def _require_row_major(mesh) -> None:
    """The vectorized gathers read rank r at the r-th row-major position
    of the mesh, as ``launch.mesh.make_mesh`` lays ranks out."""
    if not _layout_of(mesh)[2]:
        raise NotImplementedError(
            "the packed gathers need rank r at the r-th row-major position "
            "of the mesh (as make_mesh lays ranks out)")


def _pack(tensors: Sequence[Tensor]) -> Tensor:
    """The bytes of ``tensors``, each from an :data:`ALIGN`-byte boundary,
    in one float32 buffer (each tensor copied once)."""
    total = sum(_padded(_nbytes(t)) for t in tensors)
    flat = torch.empty(total // 4, dtype=torch.float32,
                       device=tensors[0].device)
    raw = flat.view(torch.uint8)
    off = 0
    for t in tensors:
        n = _nbytes(t)
        raw[off:off + n].view(t.dtype).view(t.shape).copy_(t)
        off += _padded(n)
    return flat


def gather_packed(tensors: Sequence[Tensor], mesh=None, axes=()) -> list:
    """Every rank's ``tensors`` (the same shapes and dtypes on all ranks,
    on one device) with ONE counted ``all_gather`` of their bytes,
    whatever their dtypes: for each tensor, every rank's stacked by rank,
    (world, *shape), or, with a ``mesh``, the group of ``axes``'s stacked
    in shard order, (group, *shape); views of one buffer."""
    from repro_torch.distributed.matvec import _all_gather
    rows = _all_gather(_pack(tensors), mesh,
                       None if mesh is None else axes).view(torch.uint8)
    out, off = [], 0
    for t in tensors:
        n = _nbytes(t)
        col = rows[:, off:off + n].view(t.dtype)
        out.append(col.unflatten(1, t.shape) if t.dim() else col[:, 0])
        off += _padded(n)
    return out


def restrict(spec: Spec, keep: Sequence[str]) -> Spec:
    """``spec`` with only the entries that name ``keep`` axes alone."""
    return _strip([e if e is not None and set(_entry_axes(e)) <= set(keep)
                   else None for e in spec])


def block_grid(x: Tensor, spec: Spec, mesh, fixed: Sequence[str] = ()
               ) -> Tensor:
    """``x`` as every rank's block under ``spec``: a view of shape (the
    sizes of the mesh axes outside ``fixed``, in mesh order) + the block
    shape, whose entry at a coordinate is the block the rank there holds
    (the same block along the axes ``spec`` does not name).  ``x`` is the
    tensor whole, or its region at this rank's position on ``fixed``: the
    entries of ``spec`` that name only ``fixed`` axes are cut already."""
    sizes = mesh_sizes(mesh)
    split, where, blocks = [], {}, []
    for d, n in enumerate(x.shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        if set(axes) <= set(fixed):
            axes = ()
        for a in axes:
            where[a] = len(split)
            split.append(sizes[a])
        blocks.append(len(split))
        split.append(n // math.prod(sizes[a] for a in axes))
    out_axes = [a for a in sizes if a not in fixed]
    v = x.reshape(split).permute(
        [where[a] for a in out_axes if a in where] + blocks)
    for i, a in enumerate(out_axes):
        if a not in where:
            v = v.unsqueeze(i)
    return v.expand([sizes[a] for a in out_axes] + [-1] * len(blocks))


def assemble_group(rows: Tensor, spec: Spec, mesh,
                   axes: Tuple[str, ...]) -> Tensor:
    """This rank's region of a leaf from ``rows`` (group, *block): the
    blocks under ``spec`` of the group of ``axes`` (in the mesh's order),
    gathered in shard order.  The region is the block under ``spec``
    with the entries of ``axes`` whole.  A fresh tensor."""
    sizes = mesh_sizes(mesh)
    block = list(rows.shape[1:])
    g = rows.reshape([sizes[a] for a in axes] + block)
    pos = {a: i for i, a in enumerate(axes)}
    order, out_shape = [], []
    for d in range(len(block)):
        named = [a for a in (_entry_axes(spec[d]) if d < len(spec) else ())
                 if a in pos]
        order += [pos[a] for a in named] + [len(axes) + d]
        out_shape.append(block[d] * math.prod(sizes[a] for a in named))
    out = g.permute(order).reshape(out_shape)
    return out.clone() if out._is_view() else out


def gather_leaves(blocks: Sequence[Tensor], specs: Sequence[Spec],
                  shapes: Sequence[Sequence[int]], mesh,
                  within: Optional[Sequence[Spec]] = None) -> list:
    """The whole tensors (or, per leaf, this rank's block under
    ``within[i]``) of this rank's ``blocks``, each under its spec and of
    its whole ``shape``: the same bits on every rank.  A leaf is gathered
    over the group of the mesh axes its spec splits it over and
    ``within`` keeps whole; the leaves of one such group travel in one
    :func:`gather_packed` (one collective a group: the FSDP axis alone
    for leaves kept by their "model" block).  A leaf its spec leaves
    whole on every rank is returned as it is, without a collective."""
    sizes = mesh_sizes(mesh)
    names = list(sizes)
    within = list(within) if within is not None else [()] * len(blocks)
    groups: dict = {}
    for i, s in enumerate(specs):
        axes = tuple(a for a in names if a in spec_axes(s)
                     and a not in spec_axes(within[i]) and sizes[a] > 1)
        if axes:
            groups.setdefault(axes, []).append(i)
    out = list(blocks)
    for axes, idx in groups.items():
        rows = gather_packed([blocks[i] for i in idx], mesh, axes)
        for j, i in enumerate(idx):
            out[i] = assemble_group(rows[j], specs[i], mesh, axes)
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
