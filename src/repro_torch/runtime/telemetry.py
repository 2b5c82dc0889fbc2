"""Training- and serving-health telemetry.

Counterpart of ``repro.runtime.telemetry``.  Two signals live here: the
paper's Algorithm 3 applied to gradients (spectral training health, below),
and :class:`LatencyStats` — the thread-safe latency reservoir behind the
solve server's stats endpoint.

The numerical rank (and top-Ritz spectrum) of per-layer gradients is a
cheap-to-compute training-health signal: a collapsing gradient rank flags
dead layers / LR pathologies, an exploding tail flags noise domination —
and it directly prescribes the ``compression_rank`` the Krylov gradient
compression can use losslessly.  Cost: k matvecs with the (m, n) gradient,
k ~ 16 — negligible next to the step itself; run every
``FsvdConfig.rank_telemetry_every`` steps.  The GK sweep runs on a
``DenseOp`` with the default ``"xla"`` backend, as the reference's does:
plain torch products, no hand-written kernel.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import FsvdConfig
from repro_torch.core.gk import gk_bidiag
from repro_torch.core.operators import DenseOp
from repro_torch.core.tridiag import btb_eigh

Tensor = torch.Tensor


class LatencyStats:
    """Thread-safe latency accumulator with bounded memory.

    Percentiles come from a sliding window of the most recent ``window``
    samples (a long-running server must not grow without bound); count,
    mean and max are exact over the full lifetime.  All methods take one
    short lock — safe to call from submit threads and the dispatch worker
    concurrently.
    """

    def __init__(self, window: int = 8192):
        self._buf: "collections.deque[float]" = collections.deque(
            maxlen=int(window))
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._max = 0.0

    def record(self, ms: float) -> None:
        ms = float(ms)
        with self._lock:
            self._buf.append(ms)
            self._count += 1
            self._total += ms
            self._max = max(self._max, ms)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    # Readers snapshot under the lock and crunch OUTSIDE it: record() on
    # the dispatch hot path takes the same lock, and an np.percentile over
    # the full 8192-sample window (tens of µs, unboundedly worse under a
    # descheduled reader) must never stall it.  The copy is O(window) but
    # lock-held time is a bounded memcpy, not a sort.

    def percentile(self, p: float) -> float:
        with self._lock:
            data = np.asarray(self._buf)
        if data.size == 0:
            return 0.0
        return float(np.percentile(data, p))

    def summary(self) -> dict:
        """{count, mean_ms, p50_ms, p99_ms, max_ms} snapshot."""
        with self._lock:
            count, total, mx = self._count, self._total, self._max
            data = np.asarray(self._buf)
        if count == 0:
            return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0,
                    "p99_ms": 0.0, "max_ms": 0.0}
        return {"count": count,
                "mean_ms": total / count,
                "p50_ms": float(np.percentile(data, 50)),
                "p99_ms": float(np.percentile(data, 99)),
                "max_ms": mx}


def grad_spectrum(g: Tensor, k: int = 16, eps: float = 1e-6) -> dict:
    """Top-k Ritz spectrum + effective numerical rank of one 2-D gradient.

    Returns {"sigma": (k,) descending, "rank": (), "energy_r": ()} where
    ``energy_r`` is the spectral energy fraction captured by the top
    ``rank`` values (how losslessly a rank-r compression would transmit
    this gradient).  The start vector comes from a generator seeded 0 on
    g's device: a deterministic diagnostic.
    """
    if g.dim() > 2:
        g = g.reshape(g.shape[0], -1)
    m, n = g.shape
    k = min(k, m, n)
    # run the recurrence past k (bounded slack) so near-degenerate spectra
    # still resolve k clean Ritz values; the REPORTED rank is clamped to
    # the k-vector actually returned — rank must never exceed len(sigma).
    kk = min(4 * k, m, n)
    g32 = g.to(torch.float32)
    res = gk_bidiag(DenseOp(g32), kk, reorth_passes=2,
                    generator=torch.Generator(device=g.device).manual_seed(0))
    theta, _ = btb_eigh(res.alphas, res.betas, res.kprime)
    finite = torch.where(torch.isfinite(theta), torch.clamp(theta, min=0.0),
                         torch.zeros_like(theta))
    sigma = torch.sqrt(finite[:k])
    tol = torch.max(finite) * eps
    rank = torch.clamp(torch.sum(finite > tol), max=k).to(torch.int32)
    # energy fraction against the FULL Frobenius energy, not just the
    # computed Ritz values (a white spectrum must not read as 100%)
    total = torch.sum(torch.square(g32)) + 1e-30
    csum = torch.cumsum(finite[:k], 0)
    idx = torch.clamp(rank - 1, 0, k - 1).long()
    # a zero / below-tolerance spectrum captures no energy at rank 0 — the
    # unguarded csum[0]/total would report the top-1 fraction instead
    energy_r = torch.where(rank > 0, csum[idx] / total,
                           torch.zeros_like(total))
    return {"sigma": sigma, "rank": rank, "energy_r": energy_r}


def _flatten_with_path(tree: Any, path: tuple = ()):
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and naming: a dict's keys sorted (an ``OrderedDict`` in its own
    order), a namedtuple's fields by name, a list or tuple's items by
    index, ``None`` an empty subtree.  A path entry is the key or field
    name, or None for an index (the reference names an index ``"?"``)."""
    if tree is None:
        return
    if isinstance(tree, Mapping):
        keys = list(tree) if isinstance(tree, collections.OrderedDict) \
            else sorted(tree)
        for key in keys:
            yield from _flatten_with_path(tree[key], path + (key,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _flatten_with_path(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from _flatten_with_path(item, path + (None,))
    else:
        yield path, tree


def gradient_rank_summary(grads: Any, cfg: Optional[FsvdConfig] = None,
                          k: int = 16, max_leaves: int = 8) -> dict:
    """Alg-3 telemetry over the largest 2-D gradient leaves.

    ``grads`` is a nested dict / list / namedtuple of tensors, or the
    name → grad mapping of ``dict(module.named_parameters())`` (with
    ``p.grad`` as values).  Returns {leaf-path: spectrum dict} for the
    ``max_leaves`` biggest compressible matrices, named and ordered as the
    reference names and orders the same leaves.
    """
    min_dim = cfg.compression_min_dim if cfg is not None else 256
    cands = []
    for path, leaf in _flatten_with_path(grads):
        if leaf.dim() < 2:
            continue
        m = leaf.shape[0] if leaf.dim() == 2 else leaf.shape[1]
        n = leaf.numel() // leaf.shape[0] if leaf.dim() == 2 else \
            leaf.numel() // (leaf.shape[0] * leaf.shape[1])
        if min(m, n) < min_dim:
            continue
        name = "/".join("?" if p is None else str(p) for p in path)
        cands.append((leaf.numel(), name, leaf))
    cands.sort(key=lambda t: -t[0])
    out = {}
    for _, name, leaf in cands[:max_leaves]:
        if leaf.dim() >= 3:
            # stacked layers: spectrum of the middle layer as representative
            leaf = leaf[leaf.shape[0] // 2]
        out[name] = grad_spectrum(leaf, k=k)
    return out
