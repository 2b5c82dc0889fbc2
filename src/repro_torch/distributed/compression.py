"""Krylov low-rank gradient compression with error feedback.

Counterpart of ``repro.distributed.compression``: the paper's F-SVD as a
distributed-optimization trick (PowerSGD-shaped, Lanczos-accurate).  In
data-parallel training the gradient all-reduce moves ``m·n`` floats per
2-D parameter; instead GK bidiagonalization runs on the implicit
mean-gradient operator

    mv(p)  = psum(G_local @ p,  axis) / n_workers
    rmv(q) = psum(G_localᵀ @ q, axis) / n_workers

so each Lanczos iteration moves one m-vector and one n-vector, and k
iterations give the top-r triplets of the *exact mean* gradient (the sum
is inside the matvec).  Communication: ``k (m + n)`` against ``m n``
floats, e.g. 0.4 % of the dense bytes for a 4096 × 14336 block at k = 12.

Error feedback (Seide et al. / PowerSGD): each worker keeps what
compression dropped, ``e ← (G_local + e) − lowrank(mean)``.

Every sum goes through ``distributed.matvec.psum`` over the process group
of a mesh dimension (``axis``, a name of ``mesh``'s dimensions), so every
rank of the group computes the same bits.  Each rank calls these with its
own local gradients and a generator seeded alike on every rank (the
Lanczos start vectors must agree).  The gradient pytree is a dict, list
or tuple of tensors (nested freely).  The multi-pod train step that calls
this is ``runtime.steps.build_compressed_train_step``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import FsvdConfig
from repro_torch.core.fsvd import fsvd as _fsvd
from repro_torch.core.gk import start_vector
from repro_torch.core.linop import LinOp
from repro_torch.distributed.matvec import psum
from repro_torch.distributed.partition import mesh_sizes

Tensor = torch.Tensor
PyTree = Any
F32 = torch.float32


class CompressionStats(NamedTuple):
    dense_bytes: Tensor        # what a plain all-reduce would move
    compressed_bytes: Tensor   # what the factor exchange moved
    num_compressed: int
    num_plain: int


def _layout(g: Tensor, cfg: FsvdConfig):
    """How to compress a leaf: None (plain mean), ("2d", m, n), or
    ("batched", L, m, n) for stacked per-layer parameters (L independent
    2-D gradients, compressed one layer at a time)."""
    if g.dim() < 2:
        return None
    if g.dim() >= 3:
        L, m = g.shape[0], g.shape[1]
        n = math.prod(g.shape[2:])
        if min(m, n) >= cfg.compression_min_dim:
            return ("batched", L, m, n)
        return None
    m, n = g.shape[0], math.prod(g.shape[1:])
    if min(m, n) >= cfg.compression_min_dim:
        return ("2d", m, n)
    return None


def _compressible(g: Tensor, cfg: FsvdConfig) -> bool:
    return _layout(g, cfg) is not None


def _workers(mesh, axis) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


class _MeanGradOp(LinOp):
    """The mean-gradient ``LinOp`` with block products of one collective
    each (the F-SVD's final ``A V``)."""

    def matmat(self, V: Tensor) -> Tensor:
        return self.mv(V)

    def rmatmat(self, Q: Tensor) -> Tensor:
        return self.rmv(Q)


def mean_grad_operator(G_local: Tensor, axis, mesh) -> LinOp:
    """Implicit mean-over-workers operator of a 2-D local gradient: its
    products sum over the ranks of ``mesh``'s dimension(s) ``axis``."""
    m, n = G_local.shape
    nw = _workers(mesh, axis)

    def mv(p):
        return psum(G_local @ p, mesh, axis) / nw

    def rmv(q):
        return psum(G_local.T @ q, mesh, axis) / nw

    return _MeanGradOp((m, n), mv, rmv, dtype=G_local.dtype,
                       device=G_local.device)


def compress_mean(G_local: Tensor, axis, rank: int, k: int, *, mesh,
                  generator: Optional[torch.Generator] = None, q1=None,
                  reorth_passes: int = 2) -> tuple[Tensor, Tensor, Tensor]:
    """(U, s, V) of the mean gradient over ``axis`` by distributed GK
    (Alg 2), the same on every rank of the group."""
    op = mean_grad_operator(G_local.to(F32), axis, mesh)
    out = _fsvd(op, rank, k, generator=generator, q1=q1,
                reorth_passes=reorth_passes, relative_eps=True)
    return out.U, out.s, out.V


def _flatten(tree, leaves: list):
    if isinstance(tree, dict):
        return ("dict", [(key, _flatten(v, leaves)) for key, v in
                         tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, items = spec
    if kind == "dict":
        return {key: _unflatten(s, leaves) for key, s in items}
    return kind(_unflatten(s, leaves) for s in items)


def compressed_mean_grads(grads: PyTree, ef: PyTree, axis, cfg: FsvdConfig,
                          *, mesh,
                          generator: Optional[torch.Generator] = None
                          ) -> tuple[PyTree, PyTree, CompressionStats]:
    """Tree-wide compressed gradient mean with error feedback.

    ``grads`` are this rank's local gradients; ``ef`` the residual tree
    from :func:`init_error_feedback`.  Small leaves take the plain mean;
    each compressible leaf the rank-``cfg.compression_rank`` factors of
    its exact mean.  ``generator`` (default: seed 0 on the gradients'
    device) draws one start vector per compressed leaf, shared by its
    layers.  Returns (mean_grads, new_ef, stats)."""
    nw = _workers(mesh, axis)
    leaves, ef_leaves = [], []
    spec = _flatten(grads, leaves)
    _flatten(ef, ef_leaves)
    dev = leaves[0].device if leaves else torch.device("cpu")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    out, new_ef = [], []
    dense_b = torch.zeros((), dtype=F32, device=dev)
    comp_b = torch.zeros((), dtype=F32, device=dev)
    n_comp = n_plain = 0
    # a few Krylov iterations suffice for a rank-r factor (2r is the
    # PowerSGD-comparable budget); communication grows linearly in k
    r = cfg.compression_rank
    k = min(max(2 * r, r + 2), cfg.max_iters)

    for g, e in zip(leaves, ef_leaves):
        lay = _layout(g, cfg)
        if lay is None:
            out.append(psum(g, mesh, axis) / nw)
            new_ef.append(e)
            n_plain += 1
            continue
        if lay[0] == "2d":
            _, m, n = lay
            layers = 1
        else:
            _, layers, m, n = lay
        g3 = g.reshape(layers, m, n).to(F32)
        if cfg.error_feedback:
            g3 = g3 + e.reshape(layers, m, n)
        q1 = start_vector(generator, m, F32, dev)
        lows = []
        for g2 in g3:
            U, s, V = compress_mean(g2, axis, r, k, mesh=mesh, q1=q1)
            lows.append((U * s[None, :]) @ V.T)
        low = torch.stack(lows)
        if cfg.error_feedback:
            new_ef.append((g3 - low).reshape(g.shape).to(e.dtype))
        else:
            new_ef.append(e)
        out.append(low.reshape(g.shape).to(g.dtype))
        n_comp += 1
        dense_b = dense_b + 4.0 * layers * m * n
        # per GK iteration one m-vector and one n-vector are summed, plus
        # the final r-column A V for U
        comp_b = comp_b + 4.0 * layers * (k * (m + n) + r * m)

    stats = CompressionStats(dense_b, comp_b, n_comp, n_plain)
    return (_unflatten(spec, iter(out)), _unflatten(spec, iter(new_ef)),
            stats)


def init_error_feedback(params: PyTree, cfg: FsvdConfig) -> PyTree:
    """Zeros (f32) for compressible leaves, scalar zeros elsewhere."""
    leaves = []
    spec = _flatten(params, leaves)
    zeros = [torch.zeros(p.shape if _compressible(p, cfg) else (),
                         dtype=F32, device=p.device) for p in leaves]
    return _unflatten(spec, iter(zeros))
