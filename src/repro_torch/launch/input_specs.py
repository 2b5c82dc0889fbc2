"""Abstract input specs for the dry-run: the structs and specs of every
(arch x shape x mesh) cell, with no device allocation.  Counterpart of
``repro.launch.input_specs``.

A struct is a tensor on the ``meta`` device (shape and dtype, no
storage); a spec a plain tuple (``distributed.partition``).  Trees follow
the reference's layout: parameters and moments as the reference's pytree
(each layer stack one leaf, layer axis in front), the train state as
``runtime.steps.SavedState(params, opt)``.  ``mesh`` is a ``DeviceMesh``
or a ``{name: size}`` mapping: no process group is needed.

Sharding layout:
  * batch dimensions shard over ("pod", "data") when divisible, else the
    batch is whole on every rank (replicated, as a batch of one);
  * the ``long_500k`` B = 1 cells shard the *sequence* axis of KV caches
    over "data" instead (and SSM head axes over "model");
  * KV / latent caches shard kv-heads (or SSD heads) over "model" when
    divisible, else their sequence axis;
  * parameters and optimizer moments follow ``distributed.partition``.

:func:`serving_cache_spec` is that layout as the port's decode step
holds it: :func:`_cache_leaf_spec`'s, except that the cross attention's
K / V (whisper) keep their sequence whole (the port's cross attention
reads its K / V whole; the reference splits them like a self-attention
cache).  :func:`cache_block` is a rank's block of a cell's cache under
it, :func:`decode_seq_axes` the mesh axes a model's self-attention
caches split their sequence over (the decode step's ``seq_axes``), and
:func:`sequence_block` cuts a rank's sequence block from a prefill's
cache (padded to its decode length) on the rank.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig, OptimConfig, ShapeConfig
from repro_torch.distributed.partition import (_strip, axes_entry,
                                               batch_axes, mesh_sizes,
                                               param_shardings,
                                               spec_for_batch)
from repro_torch.models import model as model_mod
from repro_torch.optim import OptState
from repro_torch.runtime.steps import SavedState

Tree = Any
META = torch.device("meta")


def abstract_init(cfg: ModelConfig) -> tuple[Tree, Tree]:
    """(params structs in the reference's tree, logical axes), with no
    allocation."""
    model, logical = model_mod.init_abstract(cfg)
    return bridge.reference_tree(model), logical


def _batch_total(mesh) -> int:
    sizes = mesh_sizes(mesh)
    total = 1
    for a in batch_axes(mesh):
        total *= sizes[a]
    return total


def _div(n: int, mesh, axis: str) -> bool:
    sizes = mesh_sizes(mesh)
    return axis in sizes and n % sizes[axis] == 0


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def train_batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    s_text = S
    if cfg.family == "vlm":
        s_text = S - cfg.vlm.num_image_tokens
        batch["img_embeds"] = torch.empty(
            (B, cfg.vlm.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=META)
    if cfg.family == "audio":
        batch["frames"] = torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)
    batch["tokens"] = torch.empty((B, s_text), dtype=torch.int32, device=META)
    batch["labels"] = torch.empty((B, s_text), dtype=torch.int32, device=META)
    return batch


def decode_batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B = shape.global_batch
    return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
            "positions": torch.empty((B, 1), dtype=torch.int32,
                                     device=META)}


def batch_shardings(batch: dict, mesh) -> dict:
    return {k: spec_for_batch(mesh, v.shape[0], v.dim())
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

_SEQ_LEAF_AXES = {
    # leaf name -> (batch_axis, seq_axis, head_axis) counted from the END
    # of the per-layer shape; a stacked cache's leading layer axis is
    # skipped by the negative indexing
    "k": (-4, -3, -2), "v": (-4, -3, -2),               # gqa kv
    "cross_k": (-4, -3, -2), "cross_v": (-4, -3, -2),   # whisper cross
    "ckv": (-3, -2, None), "krope": (-3, -2, None),     # mla latents
}
_SSM_LEAF_AXES = {
    "h": (-4, -3), "conv": (-3, None),                  # (batch, head) axes
}


def _cache_leaf_spec(name: str, shape: tuple, mesh, B: int) -> tuple:
    nd = len(shape)
    spec: list = [None] * nd
    b_shardable = B % _batch_total(mesh) == 0 and B >= _batch_total(mesh)
    if name in _SEQ_LEAF_AXES:
        b_ax, s_ax, h_ax = _SEQ_LEAF_AXES[name]
        if b_shardable:
            spec[nd + b_ax] = axes_entry(batch_axes(mesh))
        elif _div(shape[nd + s_ax], mesh, "data"):
            spec[nd + s_ax] = "data"
        if h_ax is not None and _div(shape[nd + h_ax], mesh, "model"):
            spec[nd + h_ax] = "model"
        elif _div(shape[nd + s_ax], mesh, "model"):
            # kv heads (or MLA latents) that cannot split over "model"
            # split the cache's sequence axis there instead
            cur = spec[nd + s_ax]
            spec[nd + s_ax] = (cur, "model") if cur else "model"
    elif name in _SSM_LEAF_AXES:
        b_ax, h_ax = _SSM_LEAF_AXES[name]
        if b_shardable:
            spec[nd + b_ax] = axes_entry(batch_axes(mesh))
        if h_ax is not None and _div(shape[nd + h_ax], mesh, "model"):
            spec[nd + h_ax] = "model"
    return _strip(spec)


# the cross attention's K / V: read whole by the port's cross attention
_CROSS_LEAVES = ("cross_k", "cross_v")


def serving_cache_spec(name: str, shape: tuple, mesh, B: int) -> tuple:
    """The spec of a cache leaf as the port's decode step holds it: that
    of :func:`_cache_leaf_spec`, with the cross attention's K / V whole
    along their sequence."""
    spec = list(_cache_leaf_spec(name, shape, mesh, B))
    if name in _CROSS_LEAVES:
        s_ax = len(shape) + _SEQ_LEAF_AXES[name][1]
        if s_ax < len(spec):
            spec[s_ax] = None
    return _strip(spec)


def decode_seq_axes(cfg: ModelConfig, mesh, B: int, S: int) -> tuple:
    """The mesh axes (shard order) over which a decode cache of ``B``
    sequences (the global batch) of ``S`` positions splits the sequence of
    ``cfg``'s self-attention caches under :func:`serving_cache_spec`: ()
    where it stays whole or the model has none."""
    if cfg.family == "ssm":
        return ()
    if cfg.mla is not None:
        name, shape = "ckv", (B, S, cfg.mla.kv_lora_rank)
    else:
        name, shape = "k", (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    spec = serving_cache_spec(name, shape, mesh, B)
    s_ax = len(shape) + _SEQ_LEAF_AXES[name][1]
    entry = spec[s_ax] if s_ax < len(spec) else None
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sequence_block(cache: Tree, mesh, seq_axes: tuple) -> Tree:
    """This rank's block of ``seq_axes`` of the sequence of every
    self-attention leaf of ``cache`` (a rank's prefill cache, padded to
    the decode length, its sequence whole): copies; other leaves as they
    are."""
    from repro_torch.distributed.partition import axes_entry, block_slices

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if not seq_axes or name not in _SEQ_LEAF_AXES \
                or name in _CROSS_LEAVES:
            return tree
        spec = [None] * tree.dim()
        spec[tree.dim() + _SEQ_LEAF_AXES[name][1]] = axes_entry(
            tuple(seq_axes))
        return tree[block_slices(tuple(spec), tree.shape, mesh)].clone()
    return walk(cache)


def cache_block(struct: Tree, cfg: ModelConfig, shape: ShapeConfig,
                mesh) -> Tree:
    """This rank's block (meta tensors) of the cell's cache ``struct``
    (``model.init_cache`` of the global batch) under
    :func:`serving_cache_spec`."""
    from repro_torch.distributed.partition import block_slices
    B = shape.global_batch

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        spec = serving_cache_spec(name, tuple(tree.shape), mesh, B)
        return tree[block_slices(spec, tree.shape, mesh)]
    return walk(struct)


def cache_struct_and_shardings(cfg: ModelConfig, shape: ShapeConfig,
                               mesh) -> tuple[Tree, Tree]:
    B, S = shape.global_batch, shape.seq_len
    struct = model_mod.init_cache(cfg, B, S, device=META)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _cache_leaf_spec(name, tuple(tree.shape), mesh, B)
    return struct, walk(struct)


# ---------------------------------------------------------------------------
# state specs
# ---------------------------------------------------------------------------

def _opt_struct(name: str, params: Tree) -> OptState:
    step = torch.empty((), dtype=torch.int32, device=META)
    def moment():
        return model_mod._map(lambda p: torch.empty(
            p.shape, dtype=torch.float32, device=META), params)
    mu = moment()
    if name == "adamw":
        return OptState(step, mu, moment())
    if name == "sgd":
        return OptState(step, mu, None)
    raise ValueError(f"unknown optimizer {name!r}")


def state_struct_and_shardings(cfg: ModelConfig, optim_cfg: OptimConfig,
                               mesh) -> tuple[SavedState, SavedState]:
    params_struct, logical = abstract_init(cfg)
    p_shard = param_shardings(logical, params_struct, mesh)
    opt_struct = _opt_struct(optim_cfg.name, params_struct)
    # moments mirror the params shape for shape: the params' specs
    opt_shard = OptState((), p_shard,
                         p_shard if opt_struct.nu is not None else None)
    return (SavedState(params_struct, opt_struct),
            SavedState(p_shard, opt_shard))


def params_struct_and_shardings(cfg: ModelConfig, mesh
                                ) -> tuple[Tree, Tree]:
    params_struct, logical = abstract_init(cfg)
    return params_struct, param_shardings(logical, params_struct, mesh)


# ---------------------------------------------------------------------------
# full cell assembly
# ---------------------------------------------------------------------------

def cell_inputs(cfg: ModelConfig, shape: ShapeConfig, optim_cfg: OptimConfig,
                mesh) -> dict:
    """Everything the dry-run needs to lower one (arch x shape) cell."""
    if shape.kind == "train":
        state_struct, state_shard = state_struct_and_shardings(
            cfg, optim_cfg, mesh)
        batch = train_batch_struct(cfg, shape)
        return {"kind": "train",
                "args_struct": (state_struct, batch),
                "in_shardings": (state_shard, batch_shardings(batch, mesh))}
    if shape.kind == "prefill":
        p_struct, p_shard = params_struct_and_shardings(cfg, mesh)
        batch = train_batch_struct(cfg, shape)
        batch.pop("labels")
        return {"kind": "prefill",
                "args_struct": (p_struct, batch),
                "in_shardings": (p_shard, batch_shardings(batch, mesh))}
    if shape.kind == "decode":
        p_struct, p_shard = params_struct_and_shardings(cfg, mesh)
        cache_struct, cache_shard = cache_struct_and_shardings(
            cfg, shape, mesh)
        batch = decode_batch_struct(cfg, shape)
        return {"kind": "decode",
                "args_struct": (p_struct, cache_struct, batch),
                "in_shardings": (p_shard, cache_shard,
                                 batch_shardings(batch, mesh))}
    raise ValueError(shape.kind)
