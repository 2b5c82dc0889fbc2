"""The kernel entry points the operators and sketches call.

Counterpart of ``repro.kernels.ops``:

  * ``gk_step_fused`` / ``gk_rstep_fused`` (``DenseOp(backend="pallas")``
    half-steps): stage 1 (``mv_qtv`` or ``rmv_qtv``), then ``passes − 1`` ×
    ``proj_qtv``, then ``proj_norm``, so the basis is read ``passes + 1``
    times and the candidate vector meets its first CGS product before it
    is stored;
  * ``matvec_fused`` / ``rmatvec_fused`` (``DenseOp.mv_fused`` /
    ``rmv_fused``): vectors and the scalar of any float dtype, cast to
    f32 as the reference wrapper does;
  * ``sketch_matmat`` (``SparseSignSketch.tapply``);
  * ``sparse_matvec`` (``SparseOp(backend="pallas")`` mv/rmv/matmat/
    rmatmat): x or a block X of any float dtype, cast to f32;
  * ``lowrank_matmul`` (``core.update``: the update's core outer product
    and ``materialize_lowrank``);
  * ``reorth`` (CGS^passes against a basis: ``passes`` × (``qtv``,
    ``subtract_qc``));
  * ``scatter_add`` (``sketchres.state`` folds of a COO entry stream).

The reference pads A, the basis, the sketch rows, the ELL pack, the
low-rank factors, the block and the entry stream to tile multiples first;
the CUDA kernels mask ragged edges themselves, so nothing here pads or
copies an operand.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_sketch as cs
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import reorth as ro
from repro_torch.kernels import sparse_matvec as spm
from repro_torch.kernels.lowrank_update import lowrank_matmul  # noqa: F401
from repro_torch.kernels.sketch_matvec import sketch_matmat  # noqa: F401

Tensor = torch.Tensor


def _f32(x: Tensor) -> Tensor:
    return x.to(torch.float32).contiguous()


def _f32_scalar(x):
    """A device scalar in f32 (a device op: never a host sync)."""
    return x.to(torch.float32) if isinstance(x, Tensor) else x


def matvec_fused(A: Tensor, p: Tensor, y: Tensor, alpha) -> Tensor:
    """u = A p − α y (f32).  A (m, n) f64/f32/bf16; p (n,); y (m,)."""
    return gs.matvec_fused(A, _f32(p), _f32(y), _f32_scalar(alpha))


def rmatvec_fused(A: Tensor, q: Tensor, y: Tensor, beta) -> Tensor:
    """v = Aᵀ q − β y (f32).  A (m, n) f64/f32/bf16; q (m,); y (n,)."""
    return gs.rmatvec_fused(A, _f32(q), _f32(y), _f32_scalar(beta))


def sparse_matvec(vals: Tensor, cols: Tensor, x: Tensor) -> Tensor:
    """y = A x for A in padded-ELL rows (``sparse_matvec.ell_pack``):
    x (n,) → (m,) f32, or a block X (n, b) → (m, b) f32 in one launch."""
    return spm.sparse_matvec(vals, cols, _f32(x))


def reorth(v: Tensor, Q: Tensor, passes: int = 2) -> Tensor:
    """CGS^passes: ``v − Q (Qᵀ v)``, repeated.  v (m,) of any float dtype;
    Q (m, k) f32/bf16 → (m,) f32."""
    w = _f32(v)
    for _ in range(passes):
        w = ro.subtract_qc(w, Q, ro.qtv(Q, w))
    return w


def scatter_add(rows: Tensor, cols: Tensor, vals: Tensor,
                shape: tuple[int, int]) -> Tensor:
    """Dense (m, d) f32 accumulation of a COO entry stream; duplicate
    coordinates sum (count-sketch collision semantics) and coordinates
    outside the panel are dropped.  Indices are taken as int32 and values
    of any float dtype are accumulated in f32; an empty stream gives zeros
    without a launch.  Returns a fresh panel."""
    vals = vals.reshape(-1)
    if vals.dtype not in cs.KINDS:
        vals = vals.to(torch.float32)
    return cs.scatter_add(rows.reshape(-1).to(torch.int32).contiguous(),
                          cols.reshape(-1).to(torch.int32).contiguous(),
                          vals.contiguous(), shape)


def gk_step_fused(A: Tensor, p: Tensor, y: Tensor, alpha, Q: Tensor,
                  passes: int = 2) -> tuple[Tensor, Tensor]:
    """Left GK half-step: ``u = A p − α y`` reorthogonalized CGS^passes
    against Q, plus its norm.  A (m, n); p (n,); y (m,); Q (m, k) →
    (u (m,) f32, ‖u‖ () f32)."""
    u, c = gs.mv_qtv(A, _f32(p), _f32(y), alpha, Q)
    return _project(u, Q, c, passes)


def gk_rstep_fused(A: Tensor, q: Tensor, y: Tensor, beta, P: Tensor,
                   passes: int = 2) -> tuple[Tensor, Tensor]:
    """Right GK half-step: ``v = Aᵀ q − β y`` against the P basis.
    A (m, n); q (m,); y (n,); P (n, k) → (v (n,) f32, ‖v‖ () f32)."""
    v, c = gs.rmv_qtv(A, _f32(q), _f32(y), beta, P)
    return _project(v, P, c, passes)


def _project(u: Tensor, Q: Tensor, c: Tensor,
             passes: int) -> tuple[Tensor, Tensor]:
    if passes == 0:
        return u, torch.linalg.vector_norm(u)
    for _ in range(passes - 1):
        u, c = gs.proj_qtv(u, Q, c)
    v, nrm2 = gs.proj_norm(u, Q, c)
    return v, torch.sqrt(nrm2)
