"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on a
fake world.  Counterpart of ``repro.launch.dryrun``.

The reference proves its distribution config coherent without hardware
by lowering and compiling each cell's step on 512 placeholder devices.
Here a cell stands up a fake process group of 256 or 512 ranks
(``torch.distributed``'s ``fake`` backend: collectives return at once),
lays out the production mesh over it (``launch.mesh``), takes the
cell's structs from ``launch.input_specs.cell_inputs``, makes this
rank's (rank 0's) share of them as fake tensors on ``device``
(``FakeTensorMode``: shapes, dtypes and devices, no storage), and runs
the port's own step once under ``launch.op_analysis.CostMode``:

  * train:   ``runtime.steps.build_train_step`` on the mesh (or
             ``build_compressed_train_step``), on a ``ShardedState`` of
             the rank's blocks (as ``shard_state`` cuts them) and the
             global batch (the step takes the rank's shard itself);
  * prefill: ``build_prefill_step`` on the rank's batch shard (the whole
             batch on every rank where it does not split over the batch
             axes, as the reference replicates a batch of one);
  * decode:  ``build_decode_step`` on the rank's batch shard and its
             block of the cache.

For prefill and decode the model holds the expert weights as the rank's
blocks (what the expert-parallel MoE takes), of each other leaf the
layers compute by its "model" block (``partition.model_region``: heads,
the MLP's width, the vocabulary, the Mamba2 heads) that block with every
other dimension whole, and every other leaf whole
(``steps.serving_specs``); the decode cache is the rank's block of the
cell's cache under ``input_specs.serving_cache_spec``, the reference's
``_cache_leaf_spec``: kv heads (and the Mamba2 state's heads) over
"model" where they divide, else the sequence over "model"; a batch of one
splits the sequence over "data" (``models.attention`` combines the
blocks' softmax partials).  A port check that refuses a cell (a
``ValueError``: a train batch that does not split over the batch axes,
the train step's exchange cannot fit the device, the compressed step's
mesh) is a failed cell, as is a cell whose traced peak exceeds the
device's memory (the reference's OOM at compile); any other exception
fails the cell with its traceback.  No hand-written kernel lies on these
steps' paths (the LM steps launch none of them), so none needs a fake
implementation here.

Per traced cell the record holds (the reference's keys where they mean
the same):

  * ``memory`` — the step's arguments and the peak of live device bytes
    on the rank, counted from the fake storages as they are made and
    freed (``CostMode``);
  * ``flops_per_device`` / ``bytes_per_device`` — dot FLOPs and HBM
    bytes of the ops the rank dispatches;
  * ``collectives`` — bytes and calls by kind;
  * ``model_flops_global`` — 6·N·D (2·N·D forward only), N the active
    parameters.

Usage:
    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun
    (``--device cpu`` traces fake CPU tensors, where no card is present)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_arch,
                                 get_shape)
from repro_torch.configs.base import (FsvdConfig, ModelConfig, OptimConfig,
                                      ShapeConfig)
from repro_torch.distributed import partition as P
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_mod
from repro_torch.optim import OptState
from repro_torch.runtime import steps as steps_mod

# the device whose memory a cell must fit, unless the caller names another
H100_BYTES = steps_mod.H100_BYTES

# what makes a cell fail, besides an exception
MEMORY, CHECK = "memory", "check"


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D)
# ---------------------------------------------------------------------------

def _pairs(params, logical):
    if isinstance(params, dict):
        for k in params:
            yield from _pairs(params[k], logical[k])
    else:
        yield params, tuple(logical)


def active_param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total params, active-per-token params) from the abstract init."""
    params, logical = ispec.abstract_init(cfg)
    total = active = 0
    for p, axes in _pairs(params, logical):
        n = 1
        for d in p.shape:
            n *= d
        total += n
        if cfg.moe is not None and "experts" in axes:
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    _, n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# the fake world and the rank's inputs
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A process group of ``world`` ranks in which this process is
    ``rank`` and every collective returns at once (the ``fake``
    backend); destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already; the "
                           "dry run stands up its own fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _block_shape(lf: steps_mod.Leaf, mesh) -> tuple:
    return tuple(sl.stop - sl.start
                 for sl in P.block_slices(lf.spec, lf.shape, mesh))


def _named(tree: dict, layout: dict) -> dict:
    named = bridge.named_tensors(tree)
    if list(named) != list(layout):
        raise RuntimeError("the cell's structs and the step's layout name "
                           "different parameters")
    return named


def _train_args(cell, cfg, mesh, device, compressed: bool):
    saved, batch = cell["args_struct"]
    layout = steps_mod.param_layout(cfg, mesh)
    params = _named(saved.params, layout)
    moments = [None if m is None else _named(m, layout)
               for m in (saved.opt.mu, saved.opt.nu)]
    batch = {k: _fake(v, device) for k, v in batch.items()}
    step = torch.zeros((), dtype=saved.opt.step.dtype, device=device)
    if compressed:                       # the whole state on every rank
        model = model_mod.ParamTree(steps_mod._nest(
            {k: _fake(t, device) for k, t in params.items()}))
        opt = OptState(step, *[None if m is None else
                               {k: _fake(t, device) for k, t in m.items()}
                               for m in moments])
        return steps_mod.TrainState(model, opt), batch

    def blocks(tree):
        return None if tree is None else {
            k: torch.empty(_block_shape(layout[k], mesh), dtype=t.dtype,
                           device=device) for k, t in tree.items()}
    opt = OptState(step, *[blocks(m) for m in moments])
    return steps_mod.ShardedState(blocks(params), opt, layout, mesh), batch


def _serving_model(cfg, params_struct, mesh, device):
    """The model a rank serves with (``steps.serving_specs``): the expert
    weights as their blocks, the "model" block of each other leaf the
    layers compute by block, every other leaf whole."""
    layout = steps_mod.param_layout(cfg, mesh)
    named = _named(params_struct, layout)
    specs = steps_mod.serving_specs(layout, mesh)
    return model_mod.ParamTree(steps_mod._nest({
        k: torch.empty(_block_shape(layout[k]._replace(spec=specs[k]),
                                    mesh), dtype=t.dtype, device=device)
        for k, t in named.items()}))


def _inputs(cell, cfg, shape, mesh, device, compressed: bool) -> tuple:
    """This rank's arguments of the cell's step, as fake tensors."""
    kind = cell["kind"]
    if kind == "train":
        return _train_args(cell, cfg, mesh, device, compressed)
    params_struct, *_, batch = cell["args_struct"]
    local = steps_mod.shard_batch(batch, mesh)      # meta slices
    local = {k: _fake(v, device) for k, v in local.items()}
    model = _serving_model(cfg, params_struct, mesh, device)
    if kind == "prefill":
        return model, local
    struct = model_mod.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
    cache = model_mod._map(lambda t: _fake(t, device), ispec.cache_block(
        struct, cfg, shape, mesh))
    return model, cache, local


def _step(kind, cfg, shape, optim_cfg, mesh, compressed: bool, device_bytes):
    if kind == "train":
        if compressed:
            return steps_mod.build_compressed_train_step(
                cfg, optim_cfg, mesh,
                FsvdConfig(compression_rank=8, compression_min_dim=512,
                           max_iters=16))
        return steps_mod.build_train_step(cfg, optim_cfg, mesh,
                                          device_bytes=device_bytes)
    if kind == "prefill":
        return steps_mod.build_prefill_step(cfg, mesh)
    return steps_mod.build_decode_step(cfg, mesh, ispec.decode_seq_axes(
        cfg, mesh, shape.global_batch, shape.seq_len))


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def trace(fn, make_args) -> tuple:
    """Run ``fn(*make_args())`` once on fake tensors (``make_args`` makes
    them, under ``FakeTensorMode``) under a ``CostMode``; the arguments
    count as live from the start.  Returns (the mode, the arguments'
    bytes, the seconds the trace took)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = op_analysis.CostMode()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = make_args()
        arg_bytes = mode.track(args)
        with mode:
            out = fn(*args)
        del out, args
    return mode, arg_bytes, time.perf_counter() - t0


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, head: dict, *,
               optim_cfg: OptimConfig = OptimConfig(),
               compressed_grads: bool = False, device: str = "cuda",
               device_bytes: int = H100_BYTES) -> dict:
    """Trace one cell's step on ``mesh`` (a ``DeviceMesh`` over a world
    that is up, fake or real) as this rank sees it; ``head`` starts the
    record (arch, shape, mesh).  Returns the record; a port check that
    refuses the cell makes it ``failed`` (``failure: "check"``), a peak
    past ``device_bytes`` too (``failure: "memory"``)."""
    rec = dict(head)
    try:
        cell = ispec.cell_inputs(cfg, shape, optim_cfg, mesh)
        rec["kind"] = cell["kind"]
        fn = _step(cell["kind"], cfg, shape, optim_cfg, mesh,
                   compressed_grads, device_bytes)
        mode, arg_bytes, trace_s = trace(fn, lambda: _inputs(
            cell, cfg, shape, mesh, device, compressed_grads))
    except ValueError as e:
        rec.update(status="failed", failure=CHECK, error=str(e))
        return rec
    cost = mode.cost()
    n_total, n_active = active_param_count(cfg)
    rec.update({
        "status": "ok",
        "devices": dist.get_world_size(),
        "trace_s": round(trace_s, 2),
        "flops_per_device": cost.dot_flops,
        "bytes_per_device": cost.hbm_bytes,
        "memory": {"argument_bytes": arg_bytes,
                   "peak_bytes": mode.peak_bytes,
                   "device_bytes": device_bytes},
        "collectives": {
            **{k: {"bytes": cost.collective_bytes[k],
                   "count": cost.collective_counts[k]}
               for k in op_analysis.COLLECTIVE_KINDS},
            "total_bytes": cost.total_collective_bytes},
        "params_total": n_total, "params_active": n_active,
        "model_flops_global": model_flops(cfg, shape),
    })
    if mode.peak_bytes > device_bytes:
        rec.update(status="failed", failure=MEMORY, error=(
            f"the step's peak is {mode.peak_bytes / 1e9:.2f} GB a rank, "
            f"more than the device's {device_bytes / 1e9:.1f} GB"))
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             optim_cfg: OptimConfig = OptimConfig(),
             cfg_overrides: dict | None = None,
             compressed_grads: bool = False, device: str = "cuda",
             device_bytes: int = H100_BYTES) -> dict:
    """Trace one cell on a fake world of 256 ranks (one pod) or 512 (two),
    as rank 0.  ``cfg_overrides`` patches the ModelConfig;
    ``compressed_grads`` swaps in the Krylov-compressed train step;
    ``device`` is where the fake tensors claim to live (``"cuda"``, or
    ``"cpu"`` where no card is present); ``device_bytes`` the memory a
    rank must fit (an H100's by default)."""
    cfg = get_arch(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = get_shape(shape_name)
    ok, reason = cell_applicable(arch, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        return {**head, "status": "skipped", "reason": reason}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        return trace_cell(cfg, shape, mesh, head, optim_cfg=optim_cfg,
                          compressed_grads=compressed_grads, device=device,
                          device_bytes=device_bytes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The reference's --save-hlo has no counterpart: the port "
               "compiles no HLO; a cell's record holds what the trace "
               "counts.")
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--pin", action="store_true",
                    help="tuned profile: pin_activations=True")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim (cuda, or cpu "
                         "where no card is present)")
    args = ap.parse_args(argv)
    overrides = {"pin_activations": True} if args.pin else None

    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                tag = f"{arch}_{shape}_{mesh_name}"
                try:
                    rec = run_cell(arch, shape, mp, cfg_overrides=overrides,
                                   device=args.device)
                except Exception as e:                    # noqa: BLE001
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "failed", "failure": "exception",
                           "error": str(e),
                           "traceback": traceback.format_exc()}
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "failed"
                extra = ""
                if "memory" in rec:
                    extra = (f" peak {rec['memory']['peak_bytes'] / 2**30:.2f}"
                             f" GiB/dev, args "
                             f"{rec['memory']['argument_bytes'] / 2**30:.2f}"
                             f" GiB/dev, {rec['flops_per_device']:.3g} "
                             f"flops/dev, coll "
                             f"{rec['collectives']['total_bytes'] / 2**20:.1f}"
                             f" MiB, trace {rec['trace_s']:.1f}s")
                if st == "failed":
                    extra += f" [{rec['failure']}] " + rec["error"][:200]
                print(f"[dryrun] {tag}: {st}{extra}", flush=True)
    print(f"[dryrun] done: {n_ok} ok / {n_skip} skipped / {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
