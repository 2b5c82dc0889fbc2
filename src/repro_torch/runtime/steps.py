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

  1. gathers the blocks with one collective: every leaf whole, except the
     expert weights, of which each rank keeps its experts ("model") with
     their whole d_model;
  2. runs the loss on the rank's shard of the global batch
     (``spec_for_batch``), the MoE blocks expert-parallel;
  3. weights each shard's cross entropy by its share of the global batch's
     valid tokens, so the loss is the exact global token mean that the
     reference's global-batch loss is;
  4. gathers every rank's gradients with one collective and adds them
     over the batch axes in shard order: a leaf the EP group computes
     alike is taken from the ranks at "model" position 0 (no sum over
     "model"), an expert weight from the ranks that own those experts;
  5. computes the global gradient norm from the summed gradients, each
     element counted once, the same bits on every rank;
  6. updates AdamW on the rank's own blocks, with one NaN-guard decision
     that every rank takes alike.

Memory.  Step 1 leaves every rank the parameters whole (the FSDP blocks
save memory between steps, not during one), and step 4 leaves it every
rank's gradients: world + 1 times the gradient a rank computes.  So a
rank's peak grows with the world, and the step is built only where that
fits the device (:func:`_check_gather_fits`); on the production meshes
(256 or 512 ranks) it does not for any registry arch.  A reduce-scatter
of the gradients by block would lift this.

:func:`build_compressed_train_step` is the multi-pod step with Krylov
gradient compression over "pod" (``distributed.compression``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import FsvdConfig, ModelConfig, OptimConfig
from repro_torch.distributed import partition as P
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
    expert: bool                   # an expert weight (computed by its EP group)


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
        out[name] = Leaf(P.logical_to_spec(axes, p.shape, mesh),
                         tuple(p.shape), p.dtype,
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
    batch dimension over ("pod", "data"), which must divide it."""
    out = {}
    for k, v in batch.items():
        spec = P.spec_for_batch(mesh, v.shape[0], v.dim())
        axes = P.batch_axes(mesh)
        if math.prod(P.mesh_sizes(mesh)[a] for a in axes) > 1 and not spec:
            raise ValueError(
                f"batch {k!r} of {v.shape[0]} rows does not split over the "
                f"batch axes {axes} of a {P.mesh_sizes(mesh)} mesh")
        out[k] = v[P.block_slices(spec, v.shape, mesh)]
    return out


def _contributors(mesh, model_pos: int) -> list:
    """The ranks at "model" position ``model_pos``, in shard order over the
    batch axes: the ranks whose gradients add up to a leaf's."""
    coords = P.rank_coords(mesh)
    baxes = P.batch_axes(mesh)
    ranks = [r for r, c in enumerate(coords) if c.get("model", 0) == model_pos]
    return sorted(ranks, key=lambda r: P.axes_index(mesh, baxes, coords[r]))


def _device_bytes(mesh) -> int:
    """The memory of one of ``mesh``'s devices: the card's, or the host's
    for a CPU mesh."""
    if getattr(mesh, "device_type", "cpu") == "cuda":
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _regions(layout: dict, mesh) -> dict:
    """What a rank computes of each leaf: the whole of it (``()``), or its
    experts (its spec's "model" entry)."""
    keep = ("model",) if "model" in P.mesh_sizes(mesh) else ()
    return {k: P.restrict(lf.spec, keep) if lf.expert else ()
            for k, lf in layout.items()}


def _check_gather_fits(layout: dict, mesh) -> None:
    """Refuse a mesh on which a step's gradient gather cannot fit: a rank
    holds its own gradient and every rank's, world + 1 times the bytes of
    what it computes (each leaf whole, or its experts).  That is a lower
    bound of the step's peak."""
    region = _regions(layout, mesh)
    sizes = P.mesh_sizes(mesh)
    origin = {a: 0 for a in sizes}
    grad = sum(math.prod(sl.stop - sl.start for sl in P.block_slices(
        region[k], lf.shape, mesh, origin)) * lf.dtype.itemsize
        for k, lf in layout.items())
    world = math.prod(sizes.values())
    need, have = (world + 1) * grad, _device_bytes(mesh)
    if need > have:
        raise ValueError(
            f"the sharded train step gathers every rank's gradients whole: "
            f"({world} ranks + 1) x {grad / 1e9:.3f} GB = {need / 1e9:.1f} "
            f"GB a rank, more than the device's {have / 1e9:.1f} GB; use a "
            f"smaller mesh")


def _sharded_train_step(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                        mesh, nan_guard: bool, keep_grads: bool):
    _, opt_update = make_optimizer(optim_cfg)
    layout = param_layout(model_cfg, mesh)
    names = list(layout)
    sizes = P.mesh_sizes(mesh)
    region = _regions(layout, mesh)
    _check_gather_fits(layout, mesh)
    n_model = sizes.get("model", 1)
    groups = [_contributors(mesh, c) for c in range(n_model)]
    w_aux = model_cfg.moe.aux_loss_weight if model_cfg.moe is not None \
        else 0.0

    def train_step(state: ShardedState, batch: dict):
        me = P.my_coord(mesh)
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
        del full, leaves, obj
        with torch.no_grad():
            # 4. every rank's gradients and loss terms (one collective)
            scal = torch.stack([(met.ce * n_loc).float(), met.aux.float()])
            parts = P.gather_packed([grads[k] for k in names] + [scal])
            del grads
            nll = sum(parts[r][-1][0] for r in groups[0])
            ce = nll / n_all.clamp(min=1).float()
            loss = ce + w_aux * met.aux.detach().float()
            # 5. the summed gradients, each element once, and the norm
            sq, mine = [], {}
            for i, k in enumerate(names):
                lf = layout[k]
                if not lf.expert:
                    g = _add([parts[r][i] for r in groups[0]])
                    sq.append(g.float().square().sum())
                    mine[k] = P.local_block(g, lf.spec, mesh)
                    continue
                for c, grp in enumerate(groups):
                    g = _add([parts[r][i] for r in grp])
                    sq.append(g.float().square().sum())
                    if c == me.get("model", 0):
                        mine[k] = _block_of_region(g, lf, region[k], mesh)
            del parts
            gnorm = torch.stack(sq).sum().sqrt()
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


def _block_of_region(g: Tensor, lf: Leaf, region: tuple, mesh) -> Tensor:
    """This rank's block (under ``lf.spec``) of ``g``, its region (under
    ``region``) of the leaf."""
    me = P.my_coord(mesh)
    reg = P.block_slices(region, lf.shape, mesh, me)
    blk = P.block_slices(lf.spec, lf.shape, mesh, me)
    return g[tuple(slice(b.start - r.start, b.stop - r.start)
                   for b, r in zip(blk, reg))].contiguous()


def build_train_step(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                     mesh=None, nan_guard: bool = True,
                     keep_grads: bool = False):
    """(state, batch) -> (new_state, metrics dict).

    The NaN guard runs on the device: a non-finite loss or gradient norm
    turns the update into a ``torch.where`` select of the old values (no
    value is read back to the host), reported as ``metrics["skipped"]``.
    ``keep_grads`` adds the gradients, by parameter name, as
    ``metrics["grads"]`` (on a mesh: this rank's blocks of the summed
    gradients).  With a ``mesh`` the state is a :class:`ShardedState` and
    ``batch`` the global batch, the same on every rank (see the module
    docstring); a mesh on which every rank's gradients do not fit one
    device raises ``ValueError``.
    """
    if mesh is not None:
        return _sharded_train_step(model_cfg, optim_cfg, mesh, nan_guard,
                                   keep_grads)
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


def build_decode_step(model_cfg: ModelConfig, mesh=None):
    def decode(model, cache, batch):
        with torch.no_grad():
            return model_mod.decode_step(model, cache, batch, model_cfg,
                                         mesh)
    return decode
