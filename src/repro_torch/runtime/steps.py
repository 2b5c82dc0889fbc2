"""Step functions shared by the trainer, the serving loop and the launchers.
Counterpart of ``repro.runtime.steps``.

A :class:`TrainState` holds the model module (its parameters) and the
optimizer state.  The single-device train step updates the module's
parameters in place and returns the new optimizer state; every other
single-device step leaves the module alone.

On a mesh (a ``DeviceMesh`` of ``repro_torch.launch.mesh``, one rank a
process) the state is a :class:`ShardedState`: each rank holds its block
of every parameter and of its AdamW moments under
``distributed.partition``'s rules (:func:`shard_state`;
:func:`gather_state` puts it back together).  A step
(``build_train_step(..., mesh=mesh)``)

  1. gathers the blocks over the FSDP axis ("data"), one collective a
     group: a leaf the layers compute by its "model" block
     (``partition.model_region``: the heads, the MLP's width, the
     vocabulary and the Mamba2 heads of tensor parallelism, the experts
     of the MoE) keeps its
     "model" block with every other dimension whole, every other leaf
     comes whole;
  2. runs the loss on the rank's shard of the global batch
     (``spec_for_batch``), tensor parallel over "model" and the MoE
     blocks expert-parallel (``models.model``);
  3. weights each shard's cross entropy by its share of the global batch's
     valid tokens, so the loss is the exact global token mean that the
     reference's global-batch loss is;
  4. exchanges the gradients: every rank of a "model" group holds the
     same gradient of a leaf the group computes alike (a leaf whole on
     "model"; one that a rank reads only part of inside a block, kv
     weights whose heads do not divide "model" or the Mamba2 leaves the
     rules keep whole, has its gradient summed over "model" by
     ``layers.enter`` in the backward pass), and its own of a leaf
     computed by "model" blocks.  One ``all_to_all_single``, whose rows
     pass only between the ranks of a batch group (one "model"
     position), brings each rank, from each rank of its group, a piece
     of each block it owns: the block where it owns it alone, else 1/r
     of it where r ranks own it alike (over "model" for a leaf whole on
     "model", over "pod" for every leaf on two pods, ...).  It adds them
     in shard order over the batch axes, and one ``all_gather`` over
     each such group of axes puts the blocks back together.  So a
     rank's summed block has the bits of the same block of the whole
     summed gradient;
  5. computes the global gradient norm from each rank's sum of squares of
     the blocks it owns, each element counted once (a block several ranks
     hold is counted by the one at position 0 on the axes its spec does
     not name), the partial sums and the loss terms exchanged in one small
     gather and the partial sums added by one reduction over the gathered
     vector: the same bits on every rank;
  6. updates AdamW on the rank's own blocks, with one NaN-guard decision
     that every rank takes alike.

Memory.  Step 1 leaves every rank the parameters it computes with: its
"model" blocks of the split leaves and the rest whole (the FSDP blocks
save memory between steps, not during one), with its gradient beside
them at the end of the backward pass.  Step 4 then holds the gradient
and the rows it sends, then what it sends and what it receives, then
what it receives and the blocks the gather rebuilds: a row a rank of its
batch group, about a gradient over the "model" size.  The step is built
only where the largest of those four moments fits the device
(:func:`_check_exchange_fits`).

:func:`build_compressed_train_step` is the multi-pod step with Krylov
gradient compression over "pod" (``distributed.compression``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.configs.base import FsvdConfig, ModelConfig, OptimConfig
from repro_torch.distributed import partition as P
from repro_torch.distributed.matvec import _all_gather, _all_to_all
from repro_torch.models import model as model_mod
from repro_torch.optim import OptState, make_optimizer

Tensor = torch.Tensor


class TrainState(NamedTuple):
    model: model_mod.ParamTree     # the parameters; a step updates them
    opt: OptState


class SavedState(NamedTuple):
    """The reference's ``TrainState`` layout (``params``, ``opt``): the tree
    a checkpoint holds and the dry-run's structs describe, each layer
    stack one leaf with the layer axis in front."""
    params: dict
    opt: OptState


class Leaf(NamedTuple):
    """One parameter on a mesh."""
    spec: tuple                    # its spec (``distributed.partition``)
    shape: tuple                   # its whole shape
    dtype: torch.dtype
    model_block: bool              # computed by its "model" block (TP or EP)
    expert: bool                   # an expert weight (EP)


class ShardedState(NamedTuple):
    """A train state on a mesh: this rank's block of every parameter and of
    its optimizer moments (by parameter name); the step count whole."""
    params: dict
    opt: OptState
    layout: dict                   # parameter name -> Leaf
    mesh: Any


def init_state(cfg: ModelConfig, optim_cfg: OptimConfig,
               generator: torch.Generator) -> TrainState:
    model, _ = model_mod.init_model(cfg, generator)
    opt_init, _ = make_optimizer(optim_cfg)
    return TrainState(model, opt_init(dict(model.named_parameters())))


def _select(ok: torch.Tensor, new, old):
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: torch.where(ok, v, old[k]) for k, v in new.items()}
    return torch.where(ok, new, old)


def _guard(ok, new_params, params, new_opt, opt):
    return (_select(ok, new_params, params),
            OptState(*(_select(ok, n, o) for n, o in zip(new_opt, opt))))


def _grads(loss: Tensor, named: dict) -> dict:
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), grads)}


# ---------------------------------------------------------------------------
# the state on a mesh
# ---------------------------------------------------------------------------

def param_layout(cfg: ModelConfig, mesh) -> dict:
    """{parameter name: :class:`Leaf`} of ``cfg``'s model on ``mesh``: each
    per-layer leaf takes the spec of its stacked leaf without the layer
    axis (which the rules never shard)."""
    model, logical = model_mod.init_abstract(cfg)
    out = {}
    for name, p in model.named_parameters():
        node, stacked = logical, False
        for part in name.split("."):
            if part.isdigit():
                stacked = True
                continue
            node = node[part]
        axes = tuple(node[1:] if stacked else node)
        spec = P.logical_to_spec(axes, p.shape, mesh)
        out[name] = Leaf(spec, tuple(p.shape), p.dtype,
                         bool(P.model_region(axes, spec,
                                             name.rsplit(".", 1)[-1])),
                         bool(axes) and axes[0] == "experts")
    return out


def _nest(named: dict) -> dict:
    """A name -> tensor dict as the model's nested tree (lists for the
    layer stacks), as ``ParamTree.tree()`` gives it."""
    root: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


class _Tree:
    """Parameters as the model functions read them (``.tree()``)."""

    def __init__(self, tree: dict):
        self._tree = tree

    def tree(self) -> dict:
        return self._tree


def _moments(opt: OptState, fn) -> OptState:
    return OptState(opt.step.clone(), {k: fn(k, v) for k, v in
                                       opt.mu.items()},
                    None if opt.nu is None else
                    {k: fn(k, v) for k, v in opt.nu.items()})


def shard_state(state: TrainState, mesh, cfg: ModelConfig) -> ShardedState:
    """This rank's blocks of a whole ``state`` (the same on every rank) on
    ``mesh``; every block is a copy."""
    layout = param_layout(cfg, mesh)
    named = dict(state.model.named_parameters())

    def block(name, t):
        return P.local_block(t.detach(), layout[name].spec, mesh)
    return ShardedState({k: block(k, p) for k, p in named.items()},
                        _moments(state.opt, block), layout, mesh)


def serving_specs(layout: dict, mesh) -> dict:
    """The spec of each leaf a rank serves with on ``mesh``: an expert
    weight's block (the expert-parallel MoE gathers its d_model over
    "data" a layer at a time), the "model" block of every other leaf the
    layers compute by block, every other leaf whole."""
    region = _regions(layout, mesh)
    return {k: lf.spec if lf.expert else region[k]
            for k, lf in layout.items()}


def serving_model(model, cfg: ModelConfig, mesh):
    """The model a rank serves with on ``mesh`` (prefill and decode): of
    a whole ``model`` (the same on every rank), its blocks under
    :func:`serving_specs`; copies."""
    specs = serving_specs(param_layout(cfg, mesh), mesh)
    return model_mod.ParamTree(_nest({
        k: P.local_block(p.detach(), specs[k], mesh)
        for k, p in model.named_parameters()}))


def init_sharded_state(cfg: ModelConfig, optim_cfg: OptimConfig,
                       generator: torch.Generator, mesh) -> ShardedState:
    """A fresh state on ``mesh``: the model drawn whole from ``generator``
    (seeded alike on every rank) and cut to this rank's blocks, the
    optimizer moments made for the blocks alone."""
    model, _ = model_mod.init_model(cfg, generator)
    layout = param_layout(cfg, mesh)
    params = {k: P.local_block(p.detach(), layout[k].spec, mesh)
              for k, p in model.named_parameters()}
    del model
    opt_init, _ = make_optimizer(optim_cfg)
    return ShardedState(params, opt_init(params), layout, mesh)


def gather_state(state: ShardedState) -> TrainState:
    """The whole state of a :class:`ShardedState`, on every rank (one
    collective)."""
    names = list(state.layout)
    trees = [state.params] + [t for t in (state.opt.mu, state.opt.nu)
                              if t is not None]
    blocks = [tree[k] for tree in trees for k in names]
    leaves = [state.layout[k] for _ in trees for k in names]
    whole = P.gather_leaves(blocks, [lf.spec for lf in leaves],
                            [lf.shape for lf in leaves], state.mesh)
    parts = [dict(zip(names, whole[i * len(names):(i + 1) * len(names)]))
             for i in range(len(trees))]
    model = model_mod.ParamTree(_nest(parts[0]))
    return TrainState(model, OptState(state.opt.step.clone(), parts[1],
                                      parts[2] if len(parts) > 2 else None))


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's shard of a global batch (the same on every rank): the
    batch dimension over ("pod", "data") where they divide it, else the
    whole batch on every rank (replicated, as the reference's
    ``batch_shardings`` places a batch of one)."""
    return {k: v[P.block_slices(P.spec_for_batch(mesh, v.shape[0], v.dim()),
                                v.shape, mesh)]
            for k, v in batch.items()}


def _check_batch_splits(batch: dict, mesh) -> None:
    """Refuse a batch that does not split over the batch axes: a train
    step on a replicated batch would add each sequence's gradient once a
    batch rank in the exchange."""
    axes = P.batch_axes(mesh)
    sizes = P.mesh_sizes(mesh)
    if math.prod(sizes[a] for a in axes) == 1:
        return
    for k, v in batch.items():
        if not P.spec_for_batch(mesh, v.shape[0], v.dim()):
            raise ValueError(
                f"batch {k!r} of {v.shape[0]} rows does not split over the "
                f"batch axes {axes} of a {sizes} mesh: a train step on it "
                f"replicated would add each sequence's gradient once a "
                f"batch rank")


def _contributors(mesh, model_pos: int) -> list:
    """The ranks at "model" position ``model_pos``, in shard order over the
    batch axes: the ranks whose gradients add up to a leaf's."""
    coords = P.rank_coords(mesh)
    baxes = P.batch_axes(mesh)
    ranks = [r for r, c in enumerate(coords) if c.get("model", 0) == model_pos]
    return sorted(ranks, key=lambda r: P.axes_index(mesh, baxes, coords[r]))


H100_BYTES = 80 * 10 ** 9      # an H100's device memory (data sheet)


def _device_bytes(mesh) -> int:
    """The memory of one of ``mesh``'s devices: the card's, or the host's
    for a CPU mesh."""
    if getattr(mesh, "device_type", "cpu") == "cuda":
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _regions(layout: dict, mesh) -> dict:
    """What a rank computes of each leaf: the whole of it (``()``), or its
    "model" block (its spec's "model" entry)."""
    return {k: P.restrict(lf.spec, ("model",)) if lf.model_block else ()
            for k, lf in layout.items()}


def _numel(slices) -> int:
    return math.prod(sl.stop - sl.start for sl in slices)


def _slice_len(n: int, r: int, itemsize: int) -> int:
    """Elements a slice of a block of ``n`` elements cut into ``r``:
    ``ceil(n / r)``, rounded up to a whole number of
    ``partition.ALIGN`` bytes (the last slices may be short or empty)."""
    per = max(P.ALIGN // itemsize, 1)
    return -(-n // (r * per)) * per


class _Exchange(NamedTuple):
    """One rank's side of step 4, fixed by the layout and the mesh.

    The ranks are (b, m): b the position over the batch axes, m over
    "model" (the mesh's last axis, or absent: m = 0).  Every rank of a
    "model" group holds the same gradient of each leaf the group computes
    alike and its own of each leaf computed by "model" blocks, so rank
    (b, m) sends only to the ranks (b', m): one row each, with a piece of
    every leaf's block that (b', m) owns.  The ranks that own the same
    block (over the mesh axes its spec does not name: "model" for a leaf
    whole on "model", "pod" for every leaf on two pods, "data" for a leaf
    with no "embed" dimension, the MLA up-projections' blocks) take one
    slice of it each (:func:`_slice_len` elements of it flat, the slice
    of the rank's position over those axes); a block one rank owns is
    its piece whole.  Each piece starts on a ``partition.ALIGN``-byte
    boundary, the sliced ones first, grouped by their axes.  A rank adds
    the rows it receives in shard order over b, then gathers each
    group's summed slices over its axes (one ``all_gather`` a group) and
    puts the blocks back together: every element is the same sum in the
    same order as the whole block's."""
    groups: list        # (axes, first byte, end byte, [(name, off, n)])
    plain: list         # (name, byte offset): a block owned by one rank
    row: int            # bytes of a row
    slices: dict        # name -> the slice each rank (b', m) takes, by b'
    send_counts: list   # words to each rank
    recv_counts: list   # words from each rank
    batch: tuple        # the sizes of the batch axes
    pos: int            # this rank's "model" position
    counted: tuple      # the names whose block this rank counts in the norm
    blocks: dict        # name -> this rank's block shape


def _exchange_plan(layout: dict, mesh) -> _Exchange:
    sizes = P.mesh_sizes(mesh)
    names = list(sizes)
    if "model" in sizes and names[-1] != "model":
        raise NotImplementedError(f"the sharded step takes meshes whose "
                                  f"last axis is 'model'; got {names}")
    if isinstance(mesh, Mapping):
        me = {a: 0 for a in sizes}
    else:
        P._require_row_major(mesh)
        me = P.my_coord(mesh)
    pos = me.get("model", 0)
    baxes = [a for a in names if a != "model"]
    batch = tuple(sizes[a] for a in baxes)
    dests = [dict(zip(baxes, c), model=pos)
             for c in itertools.product(*(range(n) for n in batch))]
    blocks, counted, by_axes, plain, slices = {}, [], {}, [], {}
    for k, lf in layout.items():
        blocks[k] = tuple(sl.stop - sl.start for sl in
                          P.block_slices(lf.spec, lf.shape, mesh, me))
        named = P.spec_axes(lf.spec)
        if all(me[a] == 0 for a in sizes if a not in named):
            counted.append(k)
        axes = tuple(a for a in names if a not in named and sizes[a] > 1)
        if axes:
            by_axes.setdefault(axes, []).append(k)
            slices[k] = [P.axes_index(mesh, axes, d) for d in dests]
        else:
            plain.append(k)
    off, groups = 0, []
    for axes, ks in by_axes.items():
        r = math.prod(sizes[a] for a in axes)
        first, items = off, []
        for k in ks:
            item = layout[k].dtype.itemsize
            n = _slice_len(math.prod(blocks[k]), r, item)
            items.append((k, off, n))
            off += P._padded(n * item)
        groups.append((axes, first, off, items))
    placed = []
    for k in plain:
        placed.append((k, off))
        off += P._padded(math.prod(blocks[k]) * layout[k].dtype.itemsize)
    words = [off // 4 if c.get("model", 0) == pos else 0
             for c in (P.rank_coords(mesh) if not isinstance(mesh, Mapping)
                       else [])]
    return _Exchange(groups, placed, off, slices, words, words, batch, pos,
                     tuple(counted), blocks)


def exchange_bytes(layout: dict, mesh) -> dict:
    """The bytes of a rank's side of the step: ``params`` (what it
    gathers: each leaf whole, or its "model" block), ``grad`` (what it
    computes, the same), ``sent`` and ``received`` (the all-to-all's: a
    row to and from each rank of its batch group) and ``gathered`` (the
    summed slices of every group that owns a block alike); every rank
    the same.  No process group is needed (``mesh`` may be a ``{name:
    size}`` mapping)."""
    sizes = P.mesh_sizes(mesh)
    region = _regions(layout, mesh)
    origin = {a: 0 for a in sizes}
    plan = _exchange_plan(layout, dict(sizes))
    group = math.prod(plan.batch)
    grad = sum(_numel(P.block_slices(region[k], lf.shape, mesh, origin))
               * lf.dtype.itemsize for k, lf in layout.items())
    gathered = sum(math.prod(sizes[a] for a in axes) * (end - first)
                   for axes, first, end, _ in plan.groups)
    return dict(params=grad, grad=grad, sent=group * plan.row,
                received=group * plan.row, gathered=gathered)


def _check_exchange_fits(layout: dict, mesh, device_bytes=None) -> None:
    """Refuse a mesh on which a step's peak cannot fit: the largest of
    the parameters whole with the gradient (the end of the backward
    pass), the gradient with the rows it sends, those with the rows it
    receives, and the summed slices with the blocks their gather
    rebuilds (:func:`exchange_bytes`).  That is a lower bound of the
    step's peak."""
    b = exchange_bytes(layout, mesh)
    moments = {"the parameters whole and the gradient":
               b["params"] + b["grad"],
               "the gradient and the rows it sends":
               b["grad"] + b["sent"],
               "the rows it sends and receives":
               b["sent"] + b["received"],
               "the rows it receives and the slices it gathers":
               b["received"] + b["gathered"]}
    what, need = max(moments.items(), key=lambda kv: kv[1])
    have = _device_bytes(mesh) if device_bytes is None else device_bytes
    if need > have:
        raise ValueError(
            f"the sharded train step needs {what}, {need / 1e9:.1f} GB a "
            f"rank (parameters {b['params'] / 1e9:.3f} GB, gradient "
            f"{b['grad'] / 1e9:.3f}, sent {b['sent'] / 1e9:.3f}, received "
            f"{b['received'] / 1e9:.3f}, gathered "
            f"{b['gathered'] / 1e9:.3f}), more than the device's "
            f"{have / 1e9:.1f} GB; use a smaller model or a mesh that "
            f"splits it further")


def _slot(buf: Tensor, off: int, shape: tuple, dtype) -> Tensor:
    """The (..., *shape) ``dtype`` view of ``buf`` (..., bytes) at byte
    ``off`` of its last dimension."""
    n = math.prod(shape) * dtype.itemsize
    return buf[..., off:off + n].view(dtype).unflatten(-1, shape)


def _exchange(grads: dict, plan: _Exchange, layout: dict, mesh,
              device) -> dict:
    """Step 4: this rank's block of every summed gradient (one
    ``all_to_all_single``, then one ``all_gather`` for each group of
    ranks that own blocks alike; :class:`_Exchange`).  ``grads`` is
    emptied once its pieces are packed, so the gradient is freed before
    the rows arrive."""
    B, pos = plan.batch, plan.pos
    nb = len(B)
    has_model = "model" in P.mesh_sizes(mesh)
    flat = torch.zeros(math.prod(B) * plan.row // 4, dtype=torch.float32,
                       device=device)
    out = flat.view(torch.uint8).view(B + (plan.row,))

    def grid(k):
        # every rank (b', m)'s block, by b'
        lf = layout[k]
        if lf.model_block:
            return P.block_grid(grads[k], lf.spec, mesh, ("model",))
        g = P.block_grid(grads[k], lf.spec, mesh)
        return g.select(nb, pos) if has_model else g

    for axes, _, _, items in plan.groups:
        for k, off, n in items:
            g = grid(k)
            g = g.reshape(*g.shape[:nb], -1)
            r = math.prod(P.mesh_sizes(mesh)[a] for a in axes)
            if g.shape[-1] < r * n:
                g = torch.nn.functional.pad(g, (0, r * n - g.shape[-1]))
            idx = torch.tensor(plan.slices[k], device=device).view(
                B + (1, 1)).expand(B + (1, n))
            piece = torch.take_along_dim(g.unflatten(-1, (r, n)), idx,
                                         dim=nb).squeeze(nb)
            _slot(out, off, (n,), layout[k].dtype).copy_(piece)
    for k, off in plan.plain:
        _slot(out, off, plan.blocks[k], layout[k].dtype).copy_(grid(k))
    grads.clear()
    del out
    got = _all_to_all(flat, plan.send_counts, plan.recv_counts)
    del flat
    rows = got.view(torch.uint8).view(-1, plan.row)
    mine = {}
    for k, off in plan.plain:
        mine[k] = _add(_slot(rows, off, plan.blocks[k],
                             layout[k].dtype).unbind(0))
    for axes, first, end, items in plan.groups:
        summed = torch.empty((end - first) // 4, dtype=torch.float32,
                             device=device)
        buf = summed.view(torch.uint8)
        for k, off, n in items:
            dt = layout[k].dtype
            _slot(buf, off - first, (n,), dt).copy_(
                _add(_slot(rows, off, (n,), dt).unbind(0)))
        parts = _all_gather(summed, mesh, axes).view(torch.uint8)
        for k, off, n in items:
            mine[k] = _slot(parts, off - first, (n,), layout[k].dtype
                            ).reshape(-1)[:math.prod(plan.blocks[k])].view(
                                plan.blocks[k]).clone()
        del summed, parts
    return {k: mine[k] for k in layout}


def _sharded_train_step(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                        mesh, nan_guard: bool, keep_grads: bool,
                        device_bytes=None):
    _, opt_update = make_optimizer(optim_cfg)
    layout = param_layout(model_cfg, mesh)
    names = list(layout)
    region = _regions(layout, mesh)
    _check_exchange_fits(layout, mesh, device_bytes)
    plan = _exchange_plan(layout, mesh)
    group0 = _contributors(mesh, 0)
    w_aux = model_cfg.moe.aux_loss_weight if model_cfg.moe is not None \
        else 0.0

    def train_step(state: ShardedState, batch: dict):
        _check_batch_splits(batch, mesh)
        # 1. the parameters a rank computes with (one collective)
        full = P.gather_leaves([state.params[k] for k in names],
                               [layout[k].spec for k in names],
                               [layout[k].shape for k in names], mesh,
                               [region[k] for k in names])
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in zip(names, full)}
        local = shard_batch(batch, mesh)
        n_all = (batch["labels"] != -1).sum()
        # 2-3. the loss on this rank's shard, weighted to the global mean
        _, met = model_mod.loss_fn(_Tree(_nest(leaves)), local, model_cfg,
                                   mesh)
        n_loc = met.n_tokens
        obj = met.ce * (n_loc.float() / n_all.float()) + w_aux * met.aux
        grads = _grads(obj, leaves)
        device = full[0].device
        del full, leaves, obj
        with torch.no_grad():
            # 4. this rank's blocks of the summed gradients (one collective)
            mine = _exchange(grads, plan, layout, mesh, device)
            del grads
            # 5. the norm's partial sums and the loss terms (one collective)
            sq = torch.zeros((), dtype=torch.float32, device=device)
            for k in plan.counted:
                sq = sq + mine[k].float().square().sum()
            scal = torch.stack([(met.ce * n_loc).float(), met.aux.float(),
                                sq])
            parts = P.gather_packed([scal])[0]
            nll = sum(parts[r, 0] for r in group0)
            ce = nll / n_all.clamp(min=1).float()
            loss = ce + w_aux * met.aux.detach().float()
            gnorm = parts[:, 2].sum().sqrt()
            del parts
            # 6. AdamW on the rank's blocks
            new_params, new_opt, stats = opt_update(state.params, state.opt,
                                                    mine, gnorm=gnorm)
            metrics = {"loss": loss, "ce": ce, "aux": met.aux.detach(),
                       "n_tokens": n_all, **stats}
            if nan_guard:
                ok = torch.isfinite(loss) & torch.isfinite(gnorm)
                new_params, new_opt = _guard(ok, new_params, state.params,
                                             new_opt, state.opt)
                metrics["skipped"] = (~ok).to(torch.int32)
        if keep_grads:
            metrics["grads"] = mine
        return ShardedState(new_params, new_opt, layout, mesh), metrics

    return train_step


def _add(parts: list) -> Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def build_train_step(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                     mesh=None, nan_guard: bool = True,
                     keep_grads: bool = False, device_bytes=None):
    """(state, batch) -> (new_state, metrics dict).

    The NaN guard runs on the device: a non-finite loss or gradient norm
    turns the update into a ``torch.where`` select of the old values (no
    value is read back to the host), reported as ``metrics["skipped"]``.
    ``keep_grads`` adds the gradients, by parameter name, as
    ``metrics["grads"]`` (on a mesh: this rank's blocks of the summed
    gradients).  With a ``mesh`` the state is a :class:`ShardedState` and
    ``batch`` the global batch, the same on every rank (see the module
    docstring); a mesh on which the step's exchange does not fit one
    device (``device_bytes``, default the mesh's device's memory) raises
    ``ValueError``.
    """
    if mesh is not None:
        return _sharded_train_step(model_cfg, optim_cfg, mesh, nan_guard,
                                   keep_grads, device_bytes)
    _, opt_update = make_optimizer(optim_cfg)

    def train_step(state: TrainState, batch: dict):
        named = dict(state.model.named_parameters())
        loss, met = model_mod.loss_fn(state.model, batch, model_cfg)
        grads = _grads(loss, named)
        with torch.no_grad():
            params = {k: p.detach() for k, p in named.items()}
            new_params, new_opt, stats = opt_update(params, state.opt, grads)
            metrics = {"loss": loss.detach(), "ce": met.ce.detach(),
                       "aux": met.aux.detach(), "n_tokens": met.n_tokens,
                       **stats}
            if nan_guard:
                ok = torch.isfinite(loss) & torch.isfinite(stats["grad_norm"])
                new_params, new_opt = _guard(ok, new_params, params,
                                             new_opt, state.opt)
                metrics["skipped"] = (~ok).to(torch.int32)
            for k, p in named.items():
                p.copy_(new_params[k])
        if keep_grads:
            metrics["grads"] = grads
        return TrainState(state.model, new_opt), metrics

    return train_step


def build_compressed_train_step(model_cfg: ModelConfig,
                                optim_cfg: OptimConfig, mesh,
                                fsvd_cfg: FsvdConfig,
                                nan_guard: bool = True):
    """Multi-pod train step with Krylov gradient compression over "pod".

    Each pod (here: each rank of the "pod" axis) computes gradients on its
    shard of the global batch; the cross-pod mean of every large 2-D (or
    stacked per-layer) gradient is exchanged as GK factors, ``k (m + n)``
    floats instead of ``m n`` (``distributed.compression``, error feedback
    off, as in the reference); small leaves take a plain mean.  The
    gradients are compressed in the reference's tree, each layer stack
    one leaf.  The loss is averaged over "pod"; ``metrics`` add
    ``comm_dense_bytes`` and ``comm_compressed_bytes``.  The state is a
    whole :class:`TrainState` on every rank (parameters replicated over
    pods), so the other mesh axes must have size 1.  MoE archs are not
    supported on this path, as the reference's docstring says: they raise.
    """
    from repro_torch import bridge
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.matvec import psum
    sizes = P.mesh_sizes(mesh)
    if "pod" not in sizes:
        raise ValueError("the compressed step needs a 'pod' axis")
    if model_cfg.moe is not None:
        raise ValueError(
            f"{model_cfg.name}: MoE archs are not supported on the "
            "compressed path (their expert-parallel blocks keep their own "
            "collectives); use build_train_step")
    if any(n > 1 for a, n in sizes.items() if a != "pod"):
        raise ValueError(f"the compressed step shards nothing inside a pod; "
                         f"got a {sizes} mesh")
    _, opt_update = make_optimizer(optim_cfg)
    fcfg = dataclasses.replace(fsvd_cfg, error_feedback=False)
    n_pods = sizes["pod"]

    def train_step(state: TrainState, batch: dict):
        _check_batch_splits(batch, mesh)
        named = dict(state.model.named_parameters())
        local = shard_batch(batch, mesh)
        loss, met = model_mod.loss_fn(state.model, local, model_cfg)
        grads = _grads(loss, named)
        with torch.no_grad():
            tree = bridge.reference_tree(grads)
            ef = model_mod._map(
                lambda g: g.new_zeros((), dtype=torch.float32), tree)
            mean, _, stats = C.compressed_mean_grads(tree, ef, "pod", fcfg,
                                                     mesh=mesh)
            mean = bridge.named_tensors(mean)
            terms = psum(torch.stack([loss.detach().float(), met.ce.float(),
                                      met.aux.float(),
                                      met.n_tokens.float()]), mesh, "pod")
            loss_m = terms[0] / n_pods
            params = {k: p.detach() for k, p in named.items()}
            new_params, new_opt, ostats = opt_update(params, state.opt, mean)
            metrics = {"loss": loss_m, "ce": terms[1] / n_pods,
                       "aux": terms[2] / n_pods,
                       "n_tokens": terms[3].to(torch.int64),
                       "comm_dense_bytes": stats.dense_bytes,
                       "comm_compressed_bytes": stats.compressed_bytes,
                       **ostats}
            if nan_guard:
                ok = torch.isfinite(loss_m) & \
                    torch.isfinite(ostats["grad_norm"])
                new_params, new_opt = _guard(ok, new_params, params,
                                             new_opt, state.opt)
                metrics["skipped"] = (~ok).to(torch.int32)
            for k, p in named.items():
                p.copy_(new_params[k])
        return TrainState(state.model, new_opt), metrics

    return train_step


def build_eval_step(model_cfg: ModelConfig, mesh=None):
    def eval_step(model, batch):
        with torch.no_grad():
            loss, met = model_mod.loss_fn(model, batch, model_cfg, mesh)
        return {"loss": loss, "ce": met.ce, "n_tokens": met.n_tokens}
    return eval_step


def build_prefill_step(model_cfg: ModelConfig, mesh=None):
    def prefill(model, batch):
        with torch.no_grad():
            return model_mod.prefill_step(model, batch, model_cfg, mesh)
    return prefill


def build_decode_step(model_cfg: ModelConfig, mesh=None, seq_axes=()):
    """(model, cache, batch) -> (logits, new cache).  On a mesh the cache
    is the rank's block, its self-attention caches' sequence split over
    ``seq_axes`` (``launch.input_specs.decode_seq_axes``; cut by
    ``launch.input_specs.sequence_block``)."""
    def decode(model, cache, batch):
        with torch.no_grad():
            return model_mod.decode_step(model, cache, batch, model_cfg,
                                         mesh, seq_axes)
    return decode
