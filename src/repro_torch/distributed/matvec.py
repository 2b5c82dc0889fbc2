"""Sharded GK matvecs on a ``torch.distributed`` mesh: the paper's "huge
matrix" regime across ranks.

Counterpart of ``repro.distributed.matvec``.  The operator A (m, n) is
laid out by ``repro_torch.distributed.partition``: rows over the
("pod", "data") axes, columns over "model".  Each rank holds its own
block; the Lanczos vectors of the GK seam live on the matching axis, q
and the left basis Q by the rank's rows, p and the right basis P by its
columns (whole where the mesh has no "model" axis).  The communication
model is **one collective per GK half-step** in the row-sharded layout (a
"model" axis adds one matvec-reduce collective):

  * left half-step ``u = A p − α q``: the local GEMV needs no reduction
    (rows are local); the CGS products are stacked: each rank computes the
    partial first coefficient ``c₁ = Qᵀu``, the partial basis Gram
    ``G = QᵀQ`` and the partial ``‖u‖²``, and ONE collective carries all
    three.  Every further CGS pass is local algebra,
    ``c_{i+1} = c_i − G c_i`` (exact: ``Qᵀ(w − Q c) = Qᵀw − G c``), and the
    norm comes from ``‖u − Q d‖² = ‖u‖² − 2 dᵀc₁ + dᵀG d``;
  * right half-step ``v = Aᵀ q − β p``: the transposed GEMV is partial
    over the row shards; ONE collective sums it (with the partial
    ``c₁ = Pᵀv``), after which CGS against the whole P basis is local.

With ``backend="pallas"`` and a row-sharded dense f32 / bf16 block, each
half-step's local work is one stage-1 launch of ``csrc/gk_step.cu``
(``kernels.ops.local_mv_qtv`` / ``local_rmv_qtv``): the GEMV and the
first CGS product in one pass over the block.

Every cross-rank exchange of the solvers is one ``all_gather`` of this
rank's local partial or block over the group of ranks it concerns (the
ranks that share this rank's coordinates on every other mesh
dimension; :func:`_all_gather`, :func:`_group`), after which each rank
combines the gathered parts itself: blocks are concatenated, and
partials of the same block are added in shard order (:func:`psum` for a
plain sum).  No backend reduction order enters, so σ has the same bits
on gloo and NCCL, on every rank, and across the (8,), (2, 4) and (4, 2)
row meshes.  A rank sends its own payload and receives the group's size
× it; gloo takes ``all_gather`` for CUDA tensors.  A tensor too large to
gather whole is summed by :func:`psum_large` (an ``all_to_all_single``
of slices, the slices' sums, one ``all_gather``), with the same bits.
The sharded train step's gradient exchange is one ``all_to_all_single``
with split sizes (:func:`_all_to_all`): each rank receives only what it
asked for.  These helpers are where collectives are counted
(:func:`collective_stats`, by kind under the reference's names,
:data:`COLLECTIVE_KINDS`).

Global and local tensors: the public products (``mv``, ``rmv``, their
fused forms, ``matmat``, ``rmatmat``, ``sketch_pass``, ``to_dense``) take
and return the logical, global tensors on every rank, as a sharded JAX
array is logically global; only the Lanczos seam (``lanczos_step``,
``lanczos_rstep``) and its bases are local, placed by ``place_basis`` and
gathered by ``gather_basis``.  Every rank must run the same solve with
the same draws (a generator seeded alike on each rank, or the same q1).

The payload is a dense block or the row-partitioned ELL packs of a
``SparseOp`` (:class:`SparseShards`); :func:`sharded_operator` builds
either, and pushes the sharding through ``GramOp`` / ``TransposedOp``
wrappers.  Operands whose shape does not tile the mesh are zero-padded
(exact for every reduction the solvers issue) and report their logical
shape.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
import weakref
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import to_tensor
from repro_torch.core.operators import (GramOp, Operator, SparseOp,
                                        TransposedOp, cgs, mixed_mm,
                                        mixed_tmm)
from repro_torch.distributed.partition import (mesh_ranks, mesh_sizes,
                                               operator_axes,
                                               operator_counts,
                                               operator_spec,
                                               padded_operand_shape,
                                               place_operator, shard_index,
                                               shard_shape)

__all__ = ["ShardedOp", "SparseShards", "place_operator", "sharded_operator",
           "operator_axes", "operator_spec", "shard_shape", "psum",
           "psum_large",
           "collective_stats", "reset_collectives", "COLLECTIVE_KINDS"]

Tensor = torch.Tensor
F32 = torch.float32

# --- the collective ---------------------------------------------------------

# the reference's names of collective kinds (repro.launch.hlo_analysis)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")


def _zero_stats() -> dict:
    return {"calls": 0, "floats_sent": 0, "floats_received": 0,
            "seconds": 0.0,
            "by_kind": {k: {"calls": 0, "bytes": 0} for k in COLLECTIVE_KINDS}}


# collectives issued in this process: calls, floats (4-byte words) this
# rank sent and received, host seconds spent in them, and calls and bytes
# received by kind
_STATS = _zero_stats()
_STATS_LOCK = threading.Lock()


def reset_collectives() -> None:
    with _STATS_LOCK:
        _STATS.update(_zero_stats())


def collective_stats() -> dict:
    """{calls, floats_sent, floats_received, seconds, by_kind} of this
    process's collectives since the last :func:`reset_collectives`;
    ``by_kind[kind]`` holds the calls and the bytes received (the
    collective's result, as the reference counts it) of each of
    :data:`COLLECTIVE_KINDS`."""
    with _STATS_LOCK:
        out = dict(_STATS)
        out["by_kind"] = {k: dict(v) for k, v in _STATS["by_kind"].items()}
        return out


def _count(kind: str, sent: Tensor, received: int, t0: float) -> None:
    with _STATS_LOCK:
        _STATS["calls"] += 1
        _STATS["floats_sent"] += sent.numel()
        _STATS["floats_received"] += received
        _STATS["seconds"] += time.perf_counter() - t0
        by = _STATS["by_kind"][kind]
        by["calls"] += 1
        by["bytes"] += received * sent.element_size()


class _Group(NamedTuple):
    """The ranks that share this rank's coordinates on every mesh
    dimension outside ``axes`` (in the mesh's order): their process group,
    whose rank order is their shard order, row-major over ``axes``."""
    axes: Tuple[str, ...]
    pg: Any
    size: int


# a mesh's groups by their axes, made on first use: every rank makes
# every group of a partition, in the same order
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_GROUPS_LOCK = threading.Lock()


def _members(mesh, axes: Tuple[str, ...], fixed: dict) -> list:
    """The ranks at the coordinates ``fixed`` outside ``axes``, in
    row-major order over ``axes``."""
    sizes = mesh_sizes(mesh)
    ranks = mesh_ranks(mesh)
    out = []
    for idx in itertools.product(*(range(sizes[a]) for a in axes)):
        pos = dict(fixed, **dict(zip(axes, idx)))
        r = ranks
        for name in mesh.mesh_dim_names:
            r = r[pos[name]]
        out.append(r)
    return out


def _group(mesh, axes) -> _Group:
    """The group of ``axes`` (a name or a tuple of names) on ``mesh``:
    the mesh's own group of one dimension, the world for every dimension,
    else one ``dist.new_group`` for each group of the partition, made by
    every rank in the same order and cached on the mesh."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    with _GROUPS_LOCK:
        cache = _GROUPS.setdefault(mesh, {})
        got = cache.get(axes)
        if got is not None:
            return got
        names = tuple(mesh.mesh_dim_names)
        if len(set(axes)) != len(axes) or not set(axes) <= set(names):
            raise ValueError(f"axes {axes} are not distinct dimensions of "
                             f"a mesh of {names}")
        sizes = mesh_sizes(mesh)
        me = dict(zip(names, mesh.get_coordinate()))
        rest = tuple(a for a in names if a not in axes)
        mine = _members(mesh, axes, {a: me[a] for a in rest})
        if not rest:
            pg = dist.group.WORLD
        elif len(axes) == 1:
            pg = mesh.get_group(axes[0])
        else:
            pg = None
            for idx in itertools.product(*(range(sizes[a]) for a in rest)):
                ranks = _members(mesh, axes, dict(zip(rest, idx)))
                made = dist.new_group(sorted(ranks))
                if ranks == mine:
                    pg = made
        if mine != sorted(mine):
            raise NotImplementedError(
                "the group collectives need rank r at the r-th row-major "
                "position of the mesh (as make_mesh lays ranks out)")
        got = cache[axes] = _Group(axes, pg, len(mine))
        return got


def _all_gather(x: Tensor, mesh=None, axes=None) -> Tensor:
    """Every rank's ``x`` (one shape on all ranks) stacked, one
    ``all_gather``, counted: over the world by rank, (world, *x.shape),
    or over the group of ``axes`` on ``mesh`` in shard order, (group,
    *x.shape), a buffer of the group's size."""
    x = x.contiguous()
    if mesh is None:
        pg, size = None, dist.get_world_size()
    else:
        grp = _group(mesh, axes)
        pg, size = grp.pg, grp.size
    rows = x.new_empty((size,) + tuple(x.shape))
    t0 = time.perf_counter()
    dist.all_gather(list(rows.unbind(0)), x, group=pg)
    _count("all-gather", x, size * x.numel(), t0)
    return rows


def _all_to_all(x: Tensor, send: list, recv: list, group=None) -> Tensor:
    """One ``all_to_all_single`` of the flat ``x``: ``send[r]`` elements
    of it, in rank order, go to rank r (of ``group``, default the world),
    and the result holds ``recv[r]`` elements from each rank r, in rank
    order; counted."""
    out = x.new_empty(sum(recv))
    t0 = time.perf_counter()
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    _count("all-to-all", x, out.numel(), t0)
    return out


def _group_axes(mesh, axes) -> Tuple[str, ...]:
    """``axes`` in the mesh's order."""
    return tuple(a for a in mesh.mesh_dim_names if a in set(axes))


def _combine(parts: Tensor, mesh, cat_axes: Tuple[str, ...],
             sum_axes: Tuple[str, ...]) -> list:
    """One tensor per index over ``cat_axes`` (row-major, as given): the
    sum over ``sum_axes``, in shard order (row-major as given), of the
    ``parts`` gathered over the group of ``cat_axes`` + ``sum_axes``
    (:func:`_all_gather` with those axes in the mesh's order)."""
    sizes = mesh_sizes(mesh)
    gaxes = _group_axes(mesh, cat_axes + sum_axes)
    out = []
    for ci in itertools.product(*(range(sizes[a]) for a in cat_axes)):
        acc = None
        for si in itertools.product(*(range(sizes[a]) for a in sum_axes)):
            pos = dict(zip(cat_axes, ci)) | dict(zip(sum_axes, si))
            i = 0
            for a in gaxes:
                i = i * sizes[a] + pos[a]
            acc = parts[i] if acc is None else acc + parts[i]
        out.append(acc)
    return out


def psum(x: Tensor, mesh, axes) -> Tensor:
    """Sum of ``x`` over the ranks that share this rank's coordinates on
    every mesh dimension outside ``axes`` (a name or a tuple of names),
    added in shard order (row-major over ``axes`` as given): the
    counterpart of ``jax.lax.psum``.  Bitwise the same on every rank of
    the group and under any backend: one :func:`_all_gather` over the
    group, then a left-to-right sum of its parts."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    out = _combine(_all_gather(x, mesh, _group_axes(mesh, axes)), mesh, (),
                   axes)[0]
    # a group of one adds nothing: copy the part out of the gathered rows
    return out.clone() if out._is_view() else out


SLICE_ALIGN = 8    # bytes: every slice of the large reduction's rows


def psum_large(xs, mesh, axes) -> list:
    """Each of the tensors ``xs`` summed over the group of ``axes`` (as
    :func:`psum`: in shard order, row-major over ``axes`` as given), the
    same bits as :func:`psum` of each, for tensors too large to gather
    whole.  One ``all_to_all_single`` gives each member of the group its
    1/g slice of every member's ``xs``; it adds the slices in shard order,
    each in its tensor's dtype; one ``all_gather`` returns every slice's
    sum to every member.  A rank receives 2 x (its payload), not g x, and
    the gather-then-sum's element sums are unchanged.  A tensor is
    returned fresh; no collective for a group of one."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    grp = _group(mesh, _group_axes(mesh, axes))
    g = grp.size
    xs = [x.contiguous() for x in xs]
    if g == 1:
        return [x.clone() for x in xs]
    # each tensor's slice per member: a whole number of SLICE_ALIGN bytes,
    # so that every slice starts on a boundary its dtype can view
    slices = []
    for x in xs:
        per = max(SLICE_ALIGN // x.element_size(), 1)
        slices.append(-(-x.numel() // (g * per)) * per)
    row = sum(s * x.element_size() for s, x in zip(slices, xs)) // 4
    send = torch.empty((g, row), dtype=torch.float32, device=xs[0].device)
    raw = send.view(torch.uint8)
    off = 0
    for x, s in zip(xs, slices):
        nb = s * x.element_size()
        flat = x.reshape(-1)
        raw[:, off:off + nb].view(x.dtype).copy_(torch.nn.functional.pad(
            flat, (0, g * s - flat.numel())).view(g, s))
        off += nb
    # member j of the group (in shard order) takes slice j
    got = _all_to_all(send.reshape(-1), [row] * g, [row] * g,
                      group=grp.pg).view(g, row)
    del send, raw
    # the shard order of the sum over ``axes`` as given
    sizes = mesh_sizes(mesh)
    gaxes = _group_axes(mesh, axes)
    seq = []
    for idx in itertools.product(*(range(sizes[a]) for a in axes)):
        pos = dict(zip(axes, idx))
        i = 0
        for a in gaxes:
            i = i * sizes[a] + pos[a]
        seq.append(i)
    graw = got.view(torch.uint8)
    sums = torch.empty(row, dtype=torch.float32, device=xs[0].device)
    sraw = sums.view(torch.uint8)
    off = 0
    for x, s in zip(xs, slices):
        nb = s * x.element_size()
        seg = graw[:, off:off + nb].view(x.dtype)
        acc = seg[seq[0]]
        for i in seq[1:]:
            acc = acc + seg[i]
        sraw[off:off + nb].view(x.dtype).copy_(acc)
        off += nb
    del got, graw
    # member j holds slice j's sums
    rows = sums.new_empty((g, row))
    t0 = time.perf_counter()
    dist.all_gather(list(rows.unbind(0)), sums, group=grp.pg)
    _count("all-gather", sums, g * row, t0)
    del sums, sraw
    out = []
    off = 0
    rraw = rows.view(torch.uint8)
    for x, s in zip(xs, slices):
        nb = s * x.element_size()
        whole = rraw[:, off:off + nb].view(x.dtype).reshape(-1)
        out.append(whole[:x.numel()].reshape(x.shape).clone())
        off += nb
    return out


# --- the payload and the local algebra ---------------------------------------

class SparseShards(NamedTuple):
    """This rank's ELL packs of a row-partitioned sparse operand.

    ``mv_vals`` / ``mv_cols`` pack the rank's rows of A with global column
    ids (the right vector is whole); ``rmv_vals`` / ``rmv_rows`` pack the
    transpose of the rank's row block, indexed by its **own** local rows,
    so ``Aᵀq`` is a gather over the local q block and one collective
    finishes it.  Both are padded to the widths every rank shares (the
    reference's global pack and its widest transposed shard)."""

    mv_vals: Tensor     # (m_loc, L)
    mv_cols: Tensor     # (m_loc, L) int32, global column ids
    rmv_vals: Tensor    # (n, L')
    rmv_rows: Tensor    # (n, L') int32, shard-local row ids


def _f32(x: Tensor) -> Tensor:
    return x if x.dtype == F32 else x.to(F32)


def _acc_tdot(B: Tensor, x: Tensor) -> Tensor:
    """``Bᵀ x`` with f32 accumulation; a narrower-storage basis (bf16) is
    never upcast whole (the ``cgs`` policy: x is rounded to B's dtype)."""
    if B.dtype != F32:
        return mixed_tmm(B, x)
    return B.T @ _f32(x)


def _acc_apply(B: Tensor, d: Tensor) -> Tensor:
    """``B d`` with f32 accumulation under the same storage policy."""
    if B.dtype != F32:
        return mixed_mm(B, d)
    return B @ _f32(d)


def _gram_cgs_psum(w: Tensor, basis: Tensor, mesh, axes, passes: int,
                   c1_part: Optional[Tensor] = None
                   ) -> tuple[Tensor, Tensor]:
    """CGS^passes of the sharded column ``w`` against the equally sharded
    ``basis`` with ONE stacked collective over ``axes``: the partial
    ``c₁ = Qᵀw``, ``G = QᵀQ`` and ``‖w‖²`` reduce together; later passes
    use ``c_{i+1} = c_i − G c_i`` and the norm
    ``‖w − Q d‖² = ‖w‖² − 2 dᵀc₁ + dᵀG d``.  Returns the local projected
    column and the norm (the same on every rank)."""
    k = basis.shape[1]
    w = _f32(w)
    c1 = _acc_tdot(basis, w) if c1_part is None else c1_part     # (k,)
    G = _acc_tdot(basis, basis)                                   # (k, k)
    ww = torch.sum(w * w).reshape(1)
    flat = psum(torch.cat([c1.reshape(-1), G.reshape(-1), ww]), mesh, axes)
    c1 = flat[:k]
    G = flat[k:k + k * k].reshape(k, k)
    ww = flat[k + k * k]
    d = c1
    ci = c1
    for _ in range(passes - 1):
        ci = ci - G @ ci
        d = d + ci
    v = w - _acc_apply(basis, d)
    nrm2 = ww - 2.0 * torch.dot(d, c1) + torch.dot(d, G @ d)
    return v, torch.sqrt(torch.clamp(nrm2, min=0.0))


def _local_cgs(w: Tensor, basis: Tensor, passes: int) -> tuple[Tensor,
                                                                 Tensor]:
    """Plain CGS^passes and the direct norm of a column whole on every
    rank."""
    v = cgs(_f32(w), basis, passes)
    return v, torch.linalg.vector_norm(v)


def _ell(vals: Tensor, cols: Tensor, X: Tensor) -> Tensor:
    """``Y = A X`` over an ELL pack: the sparse_matvec kernel on the card,
    its plain version on the CPU."""
    from repro_torch.kernels import ops as kops
    return kops.sparse_matvec(vals, cols, X.contiguous())


def _local_mv(a, X: Tensor) -> Tensor:
    """This rank's part of ``A X`` (partial over column shards, if any);
    X (n_loc,) or (n_loc, b)."""
    if isinstance(a, SparseShards):
        return _ell(a.mv_vals, a.mv_cols, X)
    return _f32(a) @ _f32(X)


def _local_rmv(a, X: Tensor) -> Tensor:
    """This rank's part of ``Aᵀ X`` (partial over row shards)."""
    if isinstance(a, SparseShards):
        return _ell(a.rmv_vals, a.rmv_rows, X)
    return _f32(a).T @ _f32(X)


# --- the operator -------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedOp(Operator):
    """An operator sharded over a ``DeviceMesh``: products are local block
    work plus one collective.

    ``A`` is this rank's payload: its dense block of the operand laid out
    by :func:`place_operator` (zero-padded to the mesh tiling), or its
    :class:`SparseShards`.  ``lshape`` is the logical (m, n); without it a
    dense payload's block shape times the shard counts is the shape.
    Build with :func:`sharded_operator`, which handles padding, sparse
    packing and ``GramOp`` / ``TransposedOp`` wrappers.

    ``backend="pallas"`` runs the local work of each Lanczos half-step on
    the stage-1 kernels of ``csrc/gk_step.cu`` (row-sharded dense f32 /
    bf16 blocks only; a "model" axis takes the plain local products, as
    the reference's does).
    """

    A: Any
    mesh: Any
    lshape: Optional[Tuple[int, int]] = None
    backend: str = "xla"

    # --- shape bookkeeping -------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        if self.lshape is not None:
            return tuple(self.lshape)
        if self._is_sparse:
            raise ValueError("a sparse ShardedOp needs an explicit lshape "
                             "(build it with sharded_operator)")
        r, c = operator_counts(self.mesh)
        return (self.A.shape[0] * r, self.A.shape[1] * c)

    @property
    def dtype(self) -> torch.dtype:
        if self._is_sparse:
            return self.A.mv_vals.dtype
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        if self._is_sparse:
            return self.A.mv_vals.device
        return self.A.device

    @property
    def _is_sparse(self) -> bool:
        return isinstance(self.A, SparseShards)

    @functools.cached_property
    def _layout(self):
        """(row axes, col axis, R, C, i, j, padded (mp, np_), local
        (m_loc, n_loc))."""
        rows, col = operator_axes(self.mesh)
        R, C = operator_counts(self.mesh)
        i, j = shard_index(self.mesh)
        mp, np_ = padded_operand_shape(self.shape, self.mesh)
        return rows, col, R, C, i, j, (mp, np_), (mp // R, np_ // C)

    def _payload(self):
        """The dense block padded to the mesh tiling (a no-op for blocks
        from :func:`place_operator`)."""
        if self._is_sparse:
            return self.A
        ml, nl = self._layout[7]
        if tuple(self.A.shape) == (ml, nl):
            return self.A
        from repro_torch.core.padding import pad_to
        return pad_to(self.A, (ml, nl))

    # --- placement ----------------------------------------------------
    def place_basis(self, X: Tensor, side: str) -> Tensor:
        """This rank's rows of a global buffer laid out on the vector
        sharding of ``side``: "left" (m rows, by the operand's row
        blocks) or "right" (n rows, by its column blocks), zero-padded to
        the tiling.  The GK seam's vectors and bases live so."""
        rows, col, R, C, i, j, (mp, np_), (ml, nl) = self._layout
        if side == "left":
            full, loc, blk = mp, ml, i
        elif side == "right":
            full, loc, blk = np_, nl, j
        else:
            raise ValueError(f"side must be 'left' or 'right', got {side!r}")
        if X.shape[0] < full:
            from repro_torch.core.padding import pad_to
            X = pad_to(X, (full,) + tuple(X.shape[1:]))
        return X[blk * loc:(blk + 1) * loc].contiguous()

    def gather_basis(self, X: Tensor, side: str) -> Tensor:
        """The global (logical) rows of a buffer placed by
        :meth:`place_basis`, the same on every rank: one collective, the
        side's blocks stacked in shard order; no collective where the
        side is not sharded."""
        rows, col, R, C = self._layout[:4]
        m, n = self.shape
        if side == "left":
            axes, count, out = rows, R, m
        else:
            axes, count, out = (col,) if col else (), C, n
        if count == 1:
            return X[:out]
        return self._assemble(X, axes, ())[:out]

    def _assemble(self, x: Tensor, cat_axes, sum_axes,
                  parts: Optional[list] = None) -> Tensor:
        """The global tensor from every rank's local ``x`` (or from
        ``parts`` already gathered): its blocks over ``cat_axes`` stacked
        by rows, each the shard-order sum over ``sum_axes`` of the
        partials of that block."""
        if parts is None:
            parts = _all_gather(x, self.mesh,
                                _group_axes(self.mesh, cat_axes + sum_axes))
        return torch.cat(_combine(parts, self.mesh, tuple(cat_axes),
                                  tuple(sum_axes)), dim=0)

    def _sides(self):
        """(row-block axes, column-block axes) of the operand layout."""
        rows, col = self._layout[:2]
        return rows, ((col,) if col else ())

    # --- the public products: global in, global out --------------------
    def _forward(self, X: Tensor) -> Tensor:
        """A X for a global X (n,) or (n, b) → (m,) or (m, b) f32."""
        m, _ = self.shape
        rows, cols = self._sides()
        Y = _local_mv(self._payload(), self.place_basis(_f32(X), "right"))
        return self._assemble(Y, rows, cols)[:m]

    def _backward(self, X: Tensor) -> Tensor:
        """Aᵀ X for a global X (m,) or (m, b) → (n,) or (n, b) f32."""
        _, n = self.shape
        rows, cols = self._sides()
        Z = _local_rmv(self._payload(), self.place_basis(_f32(X), "left"))
        return self._assemble(Z, cols, rows)[:n]

    mv = matmat = _forward
    rmv = rmatmat = _backward

    def mv_fused(self, p, y, alpha):
        return self.mv(p) - alpha * _f32(y)

    def rmv_fused(self, q, y, beta):
        return self.rmv(q) - beta * _f32(y)

    def sketch_pass(self, omega, psi):
        """Both sketch directions from one sweep over the local block and
        ONE collective: the local range panel ``A Ω`` and co-range panel
        ``Aᵀ Ψ`` travel in one buffer (zero-padding the panels to the mesh
        tiling is exact)."""
        m, n = self.shape
        rows, cols = self._sides()
        a = self._payload()
        Y = _local_mv(a, self.place_basis(_f32(omega.dense()), "right"))
        Z = _local_rmv(a, self.place_basis(_f32(psi.dense()), "left"))
        cut = Y.numel()
        parts = _all_gather(torch.cat([Y.reshape(-1), Z.reshape(-1)]),
                            self.mesh, _group_axes(self.mesh, rows + cols))
        return (self._assemble(None, rows, cols, [p[:cut].reshape(Y.shape)
                                                  for p in parts])[:m],
                self._assemble(None, cols, rows, [p[cut:].reshape(Z.shape)
                                                  for p in parts])[:n])

    def to_dense(self) -> Tensor:
        if self._is_sparse:
            return Operator.to_dense(self)
        m, n = self.shape
        rows, cols = self._sides()
        R, C = self._layout[2:4]
        blocks = _combine(_all_gather(self._payload(), self.mesh,
                                      _group_axes(self.mesh, rows + cols)),
                          self.mesh, rows + cols, ())
        return torch.cat([torch.cat(blocks[i * C:(i + 1) * C], dim=1)
                          for i in range(R)], dim=0)[:m, :n]

    # --- the Lanczos seam: local vectors, one collective a half-step ---
    def _kernels(self) -> bool:
        rows, col = self._layout[:2]
        return (self.backend == "pallas" and not self._is_sparse
                and col is None and bool(rows)
                and self.A.dtype in (F32, torch.bfloat16))

    def lanczos_step(self, p, y, alpha, basis, *, passes: int = 2):
        """Left half-step on local vectors: p (n_loc,) by the rank's
        columns, y (m_loc,) and basis (m_loc, k) by its rows → (u (m_loc,)
        f32, ‖u‖ the same on every rank)."""
        rows, col = self._layout[:2]
        a = self._payload()
        if self._kernels():
            from repro_torch.kernels import ops as kops
            u, c1 = kops.local_mv_qtv(a, p, y, alpha, basis)
            return _gram_cgs_psum(u, basis, self.mesh, rows, passes,
                                  c1_part=c1)
        u = _local_mv(a, p)
        if col is not None:
            u = psum(u, self.mesh, col)
        u = u - alpha * _f32(y)
        if rows:
            return _gram_cgs_psum(u, basis, self.mesh, rows, passes)
        return _local_cgs(u, basis, passes)

    def lanczos_rstep(self, q, y, beta, basis, *, passes: int = 2):
        """Right half-step: q (m_loc,) by rows, y (n_loc,) and basis
        (n_loc, k) by columns → (v (n_loc,) f32, ‖v‖)."""
        rows, col, R = self._layout[:3]
        a = self._payload()
        if self._kernels():
            from repro_torch.kernels import ops as kops
            # each rank takes β y / R, so the sum over row shards is β y
            v, c1 = kops.local_rmv_qtv(a, q, _f32(y) / R, beta, basis)
            nloc = v.shape[0]
            flat = psum(torch.cat([v, c1]), self.mesh, rows)
            v, c1 = flat[:nloc], flat[nloc:]
            v = v - _acc_apply(basis, c1)
            for _ in range(passes - 1):
                v = v - _acc_apply(basis, _acc_tdot(basis, v))
            return v, torch.linalg.vector_norm(v)
        v = _local_rmv(a, q)
        if rows:
            v = psum(v, self.mesh, rows)
        v = v - beta * _f32(y)
        if col is not None:
            return _gram_cgs_psum(v, basis, self.mesh, (col,), passes)
        return _local_cgs(v, basis, passes)

    @property
    def sharding_mesh(self):
        return self.mesh


def _sparse_shards(sp: SparseOp, mesh) -> tuple[SparseShards, tuple]:
    """This rank's ELL packs of ``sp`` (every rank passes the same global
    triplets): its rows of the forward pack at the global width, and the
    transposed pack of its row block at the widest shard's width."""
    from repro_torch.core.padding import pad_dim
    from repro_torch.kernels.sparse_matvec import ell_pack

    R, C = operator_counts(mesh)
    if C > 1:
        raise NotImplementedError(
            "a sparse ShardedOp takes row-sharded meshes only (no 'model' "
            f"axis); got mesh axes {tuple(mesh.mesh_dim_names)}")
    m, n = sp.spshape
    m_loc = pad_dim(m, R) // R
    i, _ = shard_index(mesh)
    data, idx = sp.data, sp.indices
    rows = idx[:, 0].long()
    width = max(int(torch.bincount(rows, minlength=m).max())
                if rows.numel() else 0, 1)
    twidth = max(int(torch.bincount((rows // m_loc) * n + idx[:, 1].long(),
                                    minlength=R * n).max())
                 if rows.numel() else 0, 1)
    sel = (rows >= i * m_loc) & (rows < (i + 1) * m_loc)
    del rows
    loc = idx[sel].clone()
    loc[:, 0] -= i * m_loc
    vals = data[sel]
    del sel
    fv, fc = ell_pack(vals, loc, (m_loc, n))
    tv, tr = ell_pack(vals, loc.flip(1), (n, m_loc))
    del vals, loc

    def widen(x, w):
        return torch.nn.functional.pad(x, (0, w - x.shape[1])).contiguous()

    return SparseShards(widen(fv, width), widen(fc, width),
                        widen(tv, twidth), widen(tr, twidth)), (m, n)


def sharded_operator(x, mesh, backend: Optional[str] = None):
    """Lay any supported operand out on ``mesh`` as a sharded operator.

    Dense tensors (and ``DenseOp``) zero-pad to the mesh tiling and keep
    this rank's block (a numpy array goes to the mesh's device type
    first); a ``SparseOp`` (or a torch sparse COO tensor) builds this
    rank's row-partitioned ELL packs; ``GramOp`` / ``TransposedOp`` push
    the sharding onto their inner operand (so ``estimate_rank``'s
    unwrapping and the Lanczos seams keep composing); a
    :class:`ShardedOp` passes through.  Every rank passes the same global
    operand.
    """
    from repro_torch.core.linop import LinOp
    from repro_torch.core.operators import DenseOp
    if isinstance(x, ShardedOp):
        return x
    if isinstance(x, Tensor) and x.layout == torch.sparse_coo:
        return sharded_operator(SparseOp.from_coo_tensor(x), mesh, backend)
    if isinstance(x, GramOp):
        return GramOp(sharded_operator(x.inner, mesh, backend), side=x.side)
    if isinstance(x, TransposedOp):
        return TransposedOp(sharded_operator(x.inner, mesh, backend))
    if isinstance(x, SparseOp):
        shards, lshape = _sparse_shards(x, mesh)
        return ShardedOp(shards, mesh, lshape=lshape,
                         backend=backend or x.backend)
    if isinstance(x, DenseOp):
        return sharded_operator(x.A, mesh, backend or x.backend)
    if isinstance(x, (Operator, LinOp)):
        raise TypeError(
            f"sharded_operator cannot lay out {type(x).__name__}; supported "
            "operands: dense tensors / DenseOp, SparseOp (row-sharded), "
            "GramOp / TransposedOp wrappers, ShardedOp")
    A = to_tensor(x, device=None if isinstance(x, Tensor)
                  else mesh.device_type)
    return ShardedOp(place_operator(A, mesh), mesh, lshape=tuple(A.shape),
                     backend=backend or "xla")
