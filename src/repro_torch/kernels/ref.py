"""Plain-torch versions of the kernels (the allclose reference).

Counterpart of ``repro.kernels.ref``: every function upcasts its inputs
to f32 and accumulates in f32, as the kernels do.  The kernel wrappers
(``kernels.gk_step``, ``kernels.reorth``, ``kernels.sketch_matvec``,
``kernels.sparse_matvec``, ``kernels.lowrank_update``,
``kernels.count_sketch``) call these for CPU tensors only.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor
F32 = torch.float32


def _scalar(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=F32, device=like.device).reshape(())


def matvec_fused(A: Tensor, p: Tensor, y: Tensor, alpha) -> Tensor:
    """u = A @ p − alpha * y   (GK line 5 / 12, f32 accumulate)."""
    return A.to(F32) @ p.to(F32) - _scalar(alpha, A) * y.to(F32)


def rmatvec_fused(A: Tensor, q: Tensor, y: Tensor, beta) -> Tensor:
    """v = Aᵀ @ q − beta * y."""
    return A.to(F32).T @ q.to(F32) - _scalar(beta, A) * y.to(F32)


def qtv(Q: Tensor, v: Tensor) -> Tensor:
    """c = Qᵀ v."""
    return Q.to(F32).T @ v.to(F32)


def subtract_qc(v: Tensor, Q: Tensor, c: Tensor) -> Tensor:
    """w = v − Q c."""
    return v.to(F32) - Q.to(F32) @ c.to(F32)


def reorth(v: Tensor, Q: Tensor, passes: int = 2) -> Tensor:
    for _ in range(passes):
        v = subtract_qc(v, Q, qtv(Q, v))
    return v


def gk_step(A: Tensor, p: Tensor, y: Tensor, alpha, Q: Tensor,
            passes: int = 2) -> tuple[Tensor, Tensor]:
    """Left GK half-step: u = A p − α y, CGS^passes vs Q, and ‖u‖."""
    u = reorth(matvec_fused(A, p, y, alpha), Q, passes)
    return u, torch.linalg.vector_norm(u)


def gk_rstep(A: Tensor, q: Tensor, y: Tensor, beta, P: Tensor,
             passes: int = 2) -> tuple[Tensor, Tensor]:
    """Right GK half-step: v = Aᵀ q − β y, CGS^passes vs P, and ‖v‖."""
    v = reorth(rmatvec_fused(A, q, y, beta), P, passes)
    return v, torch.linalg.vector_norm(v)


def sketch_matmat(signs: Tensor, idx: Tensor, X: Tensor) -> Tensor:
    """Y = Tᵀ X for T in the sparse-sign ELL pack (signs / idx (d, ζ),
    X (N, b)): sketch row i sums its ζ signed source rows of X."""
    return torch.einsum("ds,dsb->db", signs.to(F32), X.to(F32)[idx.long()])


def sparse_matvec(vals: Tensor, cols: Tensor, X: Tensor) -> Tensor:
    """Y = A X for A in padded-ELL rows (vals / cols (m, L)), X (n,) or
    (n, b): row i sums its slots' values times the gathered rows of X."""
    g = X.to(F32)[cols.long()]                 # (m, L) or (m, L, b)
    v = vals.to(F32)
    return (v * g if X.dim() == 1 else v[..., None] * g).sum(1)


def sparse_matvec_windows(vals: Tensor, cols: Tensor, offsets: Tensor,
                          X: Tensor, ratio: int) -> Tensor:
    """Y = A X through a window layout (``sparse_matvec.window_layout``)
    in windows of ``ratio`` columns of its table ``offsets`` (m, subs + 1)
    (the sub-window table; the window table with ratio 1): row i's
    partial over window w sums its slots offsets[i, w·ratio] to
    offsets[i, min((w + 1)·ratio, subs)], and Y adds each row's partials
    in window order.  X (n,) or (n, b); slots past offsets[i, subs] (the
    padding) lie in no window."""
    m, L = cols.shape
    subs = offsets.shape[1] - 1
    g = X.to(F32)[cols.long()]                          # (m, L) or (m, L, b)
    g = vals.to(F32) * g if X.dim() == 1 else vals.to(F32)[..., None] * g
    slot = torch.arange(L, device=cols.device)
    Y = torch.zeros((m,) + tuple(X.shape[1:]), dtype=F32, device=cols.device)
    for w in range(-(-subs // ratio)):
        lo = offsets[:, w * ratio:w * ratio + 1]
        hi = offsets[:, min((w + 1) * ratio, subs)][:, None]
        inside = (slot >= lo) & (slot < hi)
        if X.dim() == 2:
            inside = inside[..., None]
        Y = Y + torch.where(inside, g, 0.0).sum(1)
    return Y


def lowrank_matmul(U: Tensor, s: Tensor, Vt: Tensor) -> Tensor:
    """W = U diag(s) Vᵀ (the low-rank materialization), f32."""
    return (U.to(F32) * s.to(F32)[None, :]) @ Vt.to(F32)


def scatter_add(rows: Tensor, cols: Tensor, vals: Tensor,
                shape: tuple[int, int]) -> Tensor:
    """Dense (m, d) f32 panel of a COO stream (rows / cols / vals (E,)):
    duplicate coordinates sum, and a coordinate outside the panel is
    dropped, as the reference's one-hot oracle drops it.  The int64 key
    ``row·d + col`` of such a coordinate points one past the panel.  On the
    CPU ``index_add_`` adds the entries one after another in entry order,
    the order of ``np.add.at`` (``index_put_(accumulate=True)`` adds with
    threads there, in no fixed order)."""
    m, d = shape
    r, c = rows.long(), cols.long()
    outside = (r < 0) | (r >= m) | (c < 0) | (c >= d)
    key = torch.where(outside, m * d, r * d + c)
    out = torch.zeros(m * d + 1, dtype=F32, device=vals.device)
    out.index_add_(0, key, vals.to(F32))
    return out[:m * d].view(m, d)


def bin_entries(rows: Tensor, cols: Tensor, vals: Tensor,
                shape: tuple[int, int],
                bin_bits: int) -> tuple[Tensor, Tensor, Tensor]:
    """The binning of the card's scatter-add (its steps 1–4): the
    flattened (m, d) panel is cut into bins of ``2**bin_bits`` cells, and
    each entry inside the panel goes to its bin, in entry order; an entry
    outside the panel goes nowhere.  Returns (offsets (bins + 1,) int64,
    cells (N,) int32 inside the bin, values (N,) f32), bin b's entries at
    ``offsets[b]:offsets[b + 1]``."""
    m, d = shape
    r, c = rows.long(), cols.long()
    inside = (r >= 0) & (r < m) & (c >= 0) & (c < d)
    key = (r * d + c)[inside]
    bin_ = key >> bin_bits
    order = torch.sort(bin_, stable=True).indices
    bins = -(-(m * d) >> bin_bits)
    offsets = torch.zeros(bins + 1, dtype=torch.int64, device=vals.device)
    torch.cumsum(torch.bincount(bin_, minlength=bins), 0, out=offsets[1:])
    cells = (key[order] & ((1 << bin_bits) - 1)).to(torch.int32)
    return offsets, cells, vals.to(F32)[inside][order]


# --- the four stages of the fused pipeline (kernels/gk_step.py) ---------
#
# Each also takes stacked inputs (A or the basis with a leading batch
# dimension, vectors (B, len), the scalar a (B,) tensor or a number): the
# plain version of each example in turn, stacked, so every example has
# the bits of the unstacked call on it.

def _stacked(fn, *args):
    """``fn`` on each example of the stacked tensors in ``args`` (a
    number or a 0-d tensor goes to every example), stacked."""
    B = next(a.shape[0] for a in args if isinstance(a, Tensor)
             and a.dim() == 3)
    outs = [fn(*(a[b] if isinstance(a, Tensor) and a.dim() else a
                 for a in args)) for b in range(B)]
    return tuple(torch.stack(o) for o in zip(*outs))


def mv_qtv(A: Tensor, p: Tensor, y: Tensor, alpha,
           Q: Tensor) -> tuple[Tensor, Tensor]:
    """(u, c) = (A p − α y, Qᵀ u)."""
    if A.dim() == 3:
        return _stacked(mv_qtv, A, p, y, alpha, Q)
    u = matvec_fused(A, p, y, alpha)
    return u, qtv(Q, u)


def rmv_qtv(A: Tensor, q: Tensor, y: Tensor, beta,
            P: Tensor) -> tuple[Tensor, Tensor]:
    """(v, c) = (Aᵀ q − β y, Pᵀ v)."""
    if A.dim() == 3:
        return _stacked(rmv_qtv, A, q, y, beta, P)
    v = rmatvec_fused(A, q, y, beta)
    return v, qtv(P, v)


def proj_qtv(u: Tensor, Q: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """(w, c') = (u − Q c, Qᵀ w)."""
    if Q.dim() == 3:
        return _stacked(proj_qtv, u, Q, c)
    w = subtract_qc(u, Q, c)
    return w, qtv(Q, w)


def proj_norm(u: Tensor, Q: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """(v, ‖v‖²) = (u − Q c, Σ v²); the second output is 0-d ((B,)
    stacked)."""
    if Q.dim() == 3:
        return _stacked(proj_norm, u, Q, c)
    v = subtract_qc(u, Q, c)
    return v, torch.dot(v, v)
