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

def mv_qtv(A: Tensor, p: Tensor, y: Tensor, alpha,
           Q: Tensor) -> tuple[Tensor, Tensor]:
    """(u, c) = (A p − α y, Qᵀ u)."""
    u = matvec_fused(A, p, y, alpha)
    return u, qtv(Q, u)


def rmv_qtv(A: Tensor, q: Tensor, y: Tensor, beta,
            P: Tensor) -> tuple[Tensor, Tensor]:
    """(v, c) = (Aᵀ q − β y, Pᵀ v)."""
    v = rmatvec_fused(A, q, y, beta)
    return v, qtv(P, v)


def proj_qtv(u: Tensor, Q: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """(w, c') = (u − Q c, Qᵀ w)."""
    w = subtract_qc(u, Q, c)
    return w, qtv(Q, w)


def proj_norm(u: Tensor, Q: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """(v, ‖v‖²) = (u − Q c, Σ v²); the second output is 0-d."""
    v = subtract_qc(u, Q, c)
    return v, torch.dot(v, v)
