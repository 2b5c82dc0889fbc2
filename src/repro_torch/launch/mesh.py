"""Device meshes over a ``torch.distributed`` world.

Counterpart of ``repro.launch.mesh``.  A JAX mesh names the devices of
one program; here each rank of an initialised process group is one
device of the mesh, and :func:`make_mesh` lays the world out as a
``DeviceMesh`` with named dimensions (``("data",)``, ``("pod", "data")``,
``("data", "model")``, ...), the names the operator layout of
``repro_torch.distributed.partition`` reads.

Nothing here tells a program about a cluster: the caller initialises the
process group, or :func:`run_world` starts ``world`` processes on this
host, each with its rank, a ``FileStore`` rendezvous and a short timeout
(a dead rank then fails the others instead of hanging them).
:func:`make_production_mesh` lays out the reference's production meshes
(one pod of 256 devices, or two pods of 256) over a world of that size;
:func:`mesh_from_config` reads a ``MeshConfig``.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a collective waits for a missing rank before it raises
WORLD_TIMEOUT_S = 120.0


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over
    the initialised world, rank r at the r-th position in row-major order
    (as ``jax.make_mesh`` orders its devices).  ``device_type`` is
    ``"cuda"`` unless the caller asks for ``"cpu"``; the product of
    ``shape`` must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "repro_torch.launch.mesh.run_world)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh has {math.prod(shape)} ranks; "
                         f"the world has {world}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass "
                           "device_type='cpu' to lay the mesh out over CPU "
                           "ranks")
    ranks = torch.arange(world, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """One pod: (16, 16) = 256 ranks, axes ("data", "model").  Two pods:
    (2, 16, 16) = 512 ranks, axes ("pod", "data", "model").  The world
    must have that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {shape} {axes} needs a world of "
            f"{math.prod(shape)} ranks; this world has {world} (pass "
            f"MeshConfig(shape=..., axes=...) for another layout)")
    return make_mesh(shape, axes, device_type=device_type)


def mesh_from_config(cfg, *, device_type: str = "cuda"):
    """``RunConfig.mesh`` -> a mesh: ``cfg.shape`` / ``cfg.axes`` when
    given, else the production mesh."""
    if cfg.shape is not None:
        return make_mesh(cfg.shape, cfg.axes, device_type=device_type)
    return make_production_mesh(multi_pod=cfg.multi_pod,
                                device_type=device_type)


def _rank_main(rank, fn, world, init_file, timeout_s, threads, args):
    if threads:
        torch.set_num_threads(threads)
    # gloo sums CPU and CUDA tensors alike and takes several ranks on one
    # card, which NCCL refuses
    dist.init_process_group(
        "gloo", store=dist.FileStore(init_file, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world: int, init_file: str,
              args: Sequence = (), *, timeout_s: float = WORLD_TIMEOUT_S,
              threads: int = 0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form one gloo process group, and wait for all of them.  ``fn`` must be a
    module-level function (spawn imports it by name).  Raises if any rank
    raises or dies; ``threads`` > 0 caps each rank's intra-op threads.
    ``init_file`` must not exist yet."""
    import torch.multiprocessing as mp
    if os.path.exists(init_file):
        raise FileExistsError(f"rendezvous file {init_file} exists; each "
                              f"world needs a fresh one")
    mp.spawn(_rank_main, nprocs=world, join=True,
             args=(fn, world, init_file, timeout_s, threads, tuple(args)))
