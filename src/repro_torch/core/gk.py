"""Algorithm 1 — Golub-Kahan bidiagonalization with reorthogonalization and
breakdown-based numerical-rank detection.

Counterpart of ``repro.core.gk``, in the same two execution styles:

  * ``gk_bidiag``      — fixed k iterations with breakdown *masking*: no
                         host synchronization inside the loop (every
                         recurrence scalar stays on the device, and the
                         kernels read α / β through device pointers), and
                         one masked column write per iteration.
  * ``gk_bidiag_host`` — real early exit: exactly one device→host transfer
                         of (β, α) per iteration.

``gk_bidiag_batched`` is ``gk_bidiag`` over a stack of B operands of one
shape (``DenseOp`` of a (B, m, n) tensor): every recurrence scalar, mask
and ``kprime`` is a (B,) tensor, and each half-step is one call of each
kernel stage for the whole batch.

All route every half-iteration through the operator's fused
``lanczos_step`` / ``lanczos_rstep`` (the CUDA kernels for
``DenseOp(backend="pallas")``; a ``repro_torch.distributed.ShardedOp``'s
seam takes its own ranks' rows of q and Q and columns of p and P, placed
by its ``place_basis``, so P and Q of the result are this rank's rows),
and both take ``precision="bf16"``: the
P/Q bases are stored half-width while every reduction stays f32.  The
basis buffers are updated in place (torch tensors are mutable; the
reference rebuilds them functionally).

Index conventions (paper eq. 9): ``alphas[i] = alpha_{i+1}`` (diagonal of
B_{k+1,k}), ``betas[i] = beta_{i+2}`` (subdiagonal), ``beta1`` is the
norm of the start vector (not part of B).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import to_tensor
from repro_torch.core._keys import normal, resolve_generator
from repro_torch.core.operators import as_operator, cgs

Tensor = torch.Tensor

PRECISIONS = (None, "f32", "bf16")


@dataclasses.dataclass(frozen=True)
class GKResult:
    alphas: Tensor      # (k,)   diag of B_{k+1,k}; zero-masked beyond kprime
    betas: Tensor       # (k,)   subdiag beta_{2..k+1}; zero beyond kprime
    beta1: Tensor       # ()     norm of the start vector
    P: Tensor           # (n, k)   right Lanczos basis
    Q: Tensor           # (m, k+1) left Lanczos basis
    kprime: Tensor      # () int32: number of valid columns
    breakdown: Tensor   # () bool: did the breakdown test fire?


def _store_dtype(precision, compute_dtype: torch.dtype) -> torch.dtype:
    """Basis storage dtype for a ``precision`` knob value (None keeps the
    compute dtype)."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision is None:
        return compute_dtype
    return torch.bfloat16 if precision == "bf16" else torch.float32


def _eff_eps(eps: float, dtype: torch.dtype, store: torch.dtype) -> float:
    """Breakdown epsilon clamped to the reorthogonalization noise floor:
    ~40 eps of the compute dtype, and ~40 eps² of a narrower storage dtype
    (CGS2 against a rounded basis bottoms out there).  See
    ``repro.core.gk._eff_eps`` for the derivation."""
    return max(eps, 40.0 * float(torch.finfo(dtype).eps),
               40.0 * float(torch.finfo(store).eps) ** 2)


def _notify(callback, alphas, betas, kprime, breakdown):
    """Hand a ``ConvergenceInfo`` (per-iteration residual proxy
    ``beta_{i+1}``) to ``callback.on_info``."""
    if callback is None:
        return
    from repro_torch.api.callbacks import ConvergenceInfo
    callback.on_info(ConvergenceInfo(betas, kprime, breakdown, method="gk"))


def _step(op, p, y, alpha, basis, passes):
    """One fused left half-step (look-alike operators lack the method)."""
    fn = getattr(op, "lanczos_step", None)
    if fn is not None:
        return fn(p, y, alpha, basis, passes=passes)
    u = cgs(op.mv_fused(p, y, alpha), basis, passes)
    return u, torch.linalg.vector_norm(u)


def _rstep(op, q, y, beta, basis, passes):
    fn = getattr(op, "lanczos_rstep", None)
    if fn is not None:
        return fn(q, y, beta, basis, passes=passes)
    v = cgs(op.rmv_fused(q, y, beta), basis, passes)
    return v, torch.linalg.vector_norm(v)


def _nonzero(x: Tensor) -> Tensor:
    return torch.where(x > 0, x, torch.ones_like(x))


def start_vector(generator: torch.Generator, m: int,
                 dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """Paper Alg 1 line 1: q1 ~ N(2, 1)^{m}, drawn from ``generator`` on
    its own device (``device`` defaults to it)."""
    return (2.0 + normal(generator, m)).to(
        device=device or generator.device, dtype=dtype)


def _place(op, x: Tensor, side: str) -> Tensor:
    """A sharded operator's Lanczos seam takes vectors on its own ranks'
    rows ("left") or columns ("right"): this rank's part of the global
    ``x``; ``x`` itself for any other operator."""
    place = getattr(op, "place_basis", None)
    return x if place is None else place(x, side)


def _setup(op, k, generator, q1, dtype, precision, caller, device):
    op = as_operator(op, device=device)
    m, n = op.shape
    k = min(k, min(m, n))
    if dtype is None:
        dtype = torch.promote_types(op.dtype, torch.float32)
    store = _store_dtype(precision, dtype)
    dev = op.device
    if q1 is None:
        generator = resolve_generator(generator, caller=caller, device=dev)
        q1 = start_vector(generator, m, dtype, dev)
    q1 = to_tensor(q1, device=dev, dtype=dtype)
    beta1 = torch.linalg.vector_norm(q1)
    q = q1 / beta1
    p = op.rmv(q).to(dtype)
    return op, m, n, k, dtype, store, dev, beta1, q, p


def gk_bidiag(op, k: int, *, generator: Optional[torch.Generator] = None,
              q1=None, eps: float = 1e-8, relative_eps: bool = True,
              reorth_passes: int = 2, dtype: Optional[torch.dtype] = None,
              precision: Optional[str] = None, callback=None,
              device=None) -> GKResult:
    """GK bidiagonalization with fixed k iterations and breakdown masking.

    Nothing in the loop waits for the device: the breakdown test, the
    masks and the column writes are device ops, so the host enqueues all
    k iterations ahead of the card.  ``precision="bf16"`` stores the P/Q
    bases in bfloat16 (see :func:`_eff_eps` for the widened threshold).
    """
    op, m, n, k, dtype, store, dev, beta1, q, p = _setup(
        op, k, generator, q1, dtype, precision, "gk_bidiag", device)
    alpha1 = torch.linalg.vector_norm(p)
    p = p / _nonzero(alpha1)
    # a sharded operand's bases hold this rank's rows only
    q, p = _place(op, q, "left"), _place(op, p, "right")

    Q = torch.zeros((q.shape[0], k + 1), dtype=store, device=dev)
    P = torch.zeros((p.shape[0], k), dtype=store, device=dev)
    Q[:, 0] = q.to(store)
    P[:, 0] = p.to(store)
    alphas = torch.zeros(k, dtype=dtype, device=dev)
    betas = torch.zeros(k, dtype=dtype, device=dev)
    alphas[0] = alpha1

    eff_eps = _eff_eps(eps, dtype, store)
    if relative_eps:
        thresh = eff_eps * torch.clamp(alpha1, min=1.0)
    else:
        thresh = torch.tensor(eps, dtype=dtype, device=dev)
    kprime = torch.ones((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    for i in range(1, k):
        # left vector: u = A p_i − alpha_i q_i, CGS, norm (lines 5-7)
        u, beta = _step(op, p, q, alphas[i - 1], Q, reorth_passes)
        u, beta = u.to(dtype), beta.to(dtype)
        done_l = done | (beta < thresh)                          # line 9
        qn = u / _nonzero(beta)                                  # line 8
        # right vector: v = Aᵀ q_{i+1} − beta_{i+1} p_i (lines 12-14)
        v, alpha = _rstep(op, qn, p, beta, P, reorth_passes)
        v, alpha = v.to(dtype), alpha.to(dtype)
        done_r = done_l | (alpha < thresh)
        pn = v / _nonzero(alpha)

        keep, keep2 = ~done_l, ~done_r
        Q[:, i] = torch.where(keep, qn.to(store), Q[:, i])
        P[:, i] = torch.where(keep2, pn.to(store), P[:, i])
        alphas[i] = torch.where(keep2, alpha, alphas[i])
        betas[i - 1] = torch.where(keep, beta, betas[i - 1])
        kprime = torch.where(done_r, kprime, kprime + 1)
        q = torch.where(keep, qn, q)
        p = torch.where(keep2, pn, p)
        done = done_r

    # final half-iteration (lines 5-8 at i = k): beta_{k+1} and q_{k+1}
    # complete B_{k+1,k}.  kprime stays on the device: index by tensor.
    last = kprime.reshape(1).long()
    u, beta = _step(op, p, q, alphas.index_select(0, last - 1), Q,
                    reorth_passes)
    u, beta = u.to(dtype), beta.to(dtype)
    valid = ~done & (beta >= thresh)
    qn = (u / _nonzero(beta)).to(store)
    Q.index_copy_(1, last, torch.where(valid, qn[:, None],
                                       Q.index_select(1, last)))
    betas.index_copy_(0, last - 1, torch.where(
        valid, beta.reshape(1), betas.index_select(0, last - 1)))
    _notify(callback, alphas, betas, kprime, done)
    return GKResult(alphas, betas, beta1, P, Q, kprime, done)


def gk_bidiag_host(op, k: int, *,
                   generator: Optional[torch.Generator] = None, q1=None,
                   eps: float = 1e-8, relative_eps: bool = True,
                   reorth_passes: int = 2,
                   dtype: Optional[torch.dtype] = None,
                   precision: Optional[str] = None, callback=None,
                   device=None) -> GKResult:
    """Host-loop GK with real early exit (paper wall-time behaviour).

    One device→host transfer per iteration: the right half-step is issued
    speculatively against the device-resident ``beta``, and both
    recurrence scalars come back together.
    """
    op, m, n, k, dtype, store, dev, beta1, q, p = _setup(
        op, k, generator, q1, dtype, precision, "gk_bidiag_host", device)
    alpha1 = float(torch.linalg.vector_norm(p))
    p = p / (alpha1 if alpha1 > 0 else 1.0)
    q, p = _place(op, q, "left"), _place(op, p, "right")
    eff_eps = _eff_eps(eps, dtype, store)
    thresh = eff_eps * max(alpha1, 1.0) if relative_eps else eps

    qs, ps, al, be = [q], [p], [alpha1], []
    breakdown = False
    # fixed-width zero-padded basis buffers: zero columns contribute
    # nothing to CGS, and every step sees the same shapes.
    Qm = torch.zeros((q.shape[0], k + 1), dtype=store, device=dev)
    Pm = torch.zeros((p.shape[0], k), dtype=store, device=dev)
    Qm[:, 0] = q.to(store)
    Pm[:, 0] = p.to(store)

    for _ in range(1, k):
        u, beta_d = _step(op, ps[-1], qs[-1], al[-1], Qm, reorth_passes)
        u = u.to(dtype)
        # speculative right half-step against the device scalar, so beta
        # and alpha arrive in ONE host round trip
        qn = u / _nonzero(beta_d).to(dtype)
        v, alpha_d = _rstep(op, qn, ps[-1], beta_d, Pm, reorth_passes)
        v = v.to(dtype)
        beta, alpha = torch.stack([beta_d.to(dtype),
                                   alpha_d.to(dtype)]).tolist()
        if callback is not None:
            callback.on_step(len(al), alpha=alpha, beta=beta)
        if beta < thresh:
            breakdown = True
            break
        if alpha < thresh:
            be.append(beta)
            Qm[:, len(qs)] = qn.to(store)
            qs.append(qn)
            breakdown = True
            break
        pn = v / alpha
        Qm[:, len(qs)] = qn.to(store)
        Pm[:, len(ps)] = pn.to(store)
        qs.append(qn)
        ps.append(pn)
        al.append(alpha)
        be.append(beta)

    if not breakdown and len(al) == k:
        # final half-iteration: beta_{k+1}, q_{k+1} complete B_{k+1,k}
        u, beta_d = _step(op, ps[-1], qs[-1], al[-1], Qm, reorth_passes)
        beta = float(beta_d)
        if beta >= thresh:
            be.append(beta)
            Qm[:, k] = (u.to(dtype) / beta).to(store)

    kp = len(al)
    alphas = torch.zeros(k, dtype=dtype, device=dev)
    betas = torch.zeros(k, dtype=dtype, device=dev)
    alphas[:kp] = torch.tensor(al, dtype=dtype)
    betas[:len(be)] = torch.tensor(be, dtype=dtype)
    kprime = torch.tensor(kp, dtype=torch.int32, device=dev)
    bd = torch.tensor(breakdown, device=dev)
    _notify(callback, alphas, betas, kprime, bd)
    return GKResult(alphas, betas, beta1.to(dtype), Pm, Qm, kprime, bd)


def _bstep(op, p, y, alpha, basis, passes, right: bool):
    """One left (``right=False``) or right half-step of every example of a
    stacked ``DenseOp``: one kernel call a stage for the batch where the
    operand takes the kernels, else each example's own half-step."""
    if op._kernels():
        from repro_torch.kernels import ops as kops
        fn = kops.gk_rstep_fused if right else kops.gk_step_fused
        return fn(op.A, p, y, alpha, basis, passes)
    outs = []
    for b in range(op.batch):
        one = type(op)(op.A[b], backend=op.backend)
        fn = one.lanczos_rstep if right else one.lanczos_step
        outs.append(fn(p[b], y[b], alpha[b], basis[b], passes=passes))
    return tuple(torch.stack(o) for o in zip(*outs))


def gk_bidiag_batched(op, k: int, *, generators=None, q1s=None,
                      eps: float = 1e-8, relative_eps: bool = True,
                      reorth_passes: int = 2,
                      dtype: Optional[torch.dtype] = None,
                      precision: Optional[str] = None,
                      callback=None) -> GKResult:
    """:func:`gk_bidiag` on each example of a stacked ``DenseOp``
    (A (B, m, n)), all at once.

    ``q1s`` (B, m) are the start vectors; without them example b draws
    its own from ``generators[b]``, as a single solve would.  The result's
    fields carry a leading batch dimension: alphas / betas (B, k), P
    (B, n, k), Q (B, m, k + 1), beta1 / kprime / breakdown (B,).  Each
    example follows its own breakdown masks, and the last half-step writes
    each example's column ``kprime[b]``.
    """
    B = op.batch
    m, n = op.shape
    k = min(k, min(m, n))
    if dtype is None:
        dtype = torch.promote_types(op.dtype, torch.float32)
    store = _store_dtype(precision, dtype)
    dev = op.device
    if q1s is None:
        if generators is None or len(generators) != B:
            raise ValueError(f"pass q1s (B, m) or {B} generators, one per "
                             f"example")
        q1s = torch.stack([start_vector(g, m, dtype, dev)
                           for g in generators])
    q1s = to_tensor(q1s, device=dev, dtype=dtype)
    if tuple(q1s.shape) != (B, m):
        raise ValueError(f"q1s must be ({B}, {m}), got {tuple(q1s.shape)}")
    beta1 = torch.linalg.vector_norm(q1s, dim=1)
    q = q1s / beta1[:, None]
    p = torch.matmul(op.A.transpose(1, 2).to(dtype), q[..., None])[..., 0]
    alpha1 = torch.linalg.vector_norm(p, dim=1)
    p = p / _nonzero(alpha1)[:, None]

    Q = torch.zeros((B, m, k + 1), dtype=store, device=dev)
    P = torch.zeros((B, n, k), dtype=store, device=dev)
    Q[:, :, 0] = q.to(store)
    P[:, :, 0] = p.to(store)
    alphas = torch.zeros((B, k), dtype=dtype, device=dev)
    betas = torch.zeros((B, k), dtype=dtype, device=dev)
    alphas[:, 0] = alpha1

    eff_eps = _eff_eps(eps, dtype, store)
    if relative_eps:
        thresh = eff_eps * torch.clamp(alpha1, min=1.0)
    else:
        thresh = torch.full((B,), eps, dtype=dtype, device=dev)
    kprime = torch.ones(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    for i in range(1, k):
        u, beta = _bstep(op, p, q, alphas[:, i - 1], Q,
                         reorth_passes, right=False)
        u, beta = u.to(dtype), beta.to(dtype)
        done_l = done | (beta < thresh)
        qn = u / _nonzero(beta)[:, None]
        v, alpha = _bstep(op, qn, p, beta, P, reorth_passes, right=True)
        v, alpha = v.to(dtype), alpha.to(dtype)
        done_r = done_l | (alpha < thresh)
        pn = v / _nonzero(alpha)[:, None]

        keep, keep2 = ~done_l, ~done_r
        Q[:, :, i] = torch.where(keep[:, None], qn.to(store), Q[:, :, i])
        P[:, :, i] = torch.where(keep2[:, None], pn.to(store), P[:, :, i])
        alphas[:, i] = torch.where(keep2, alpha, alphas[:, i])
        betas[:, i - 1] = torch.where(keep, beta, betas[:, i - 1])
        kprime = torch.where(done_r, kprime, kprime + 1)
        q = torch.where(keep[:, None], qn, q)
        p = torch.where(keep2[:, None], pn, p)
        done = done_r

    # final half-iteration at each example's own column kprime[b]
    last = kprime.long()[:, None]                                  # (B, 1)
    u, beta = _bstep(op, p, q, alphas.gather(1, last - 1)[:, 0], Q,
                     reorth_passes, right=False)
    u, beta = u.to(dtype), beta.to(dtype)
    valid = ~done & (beta >= thresh)
    qn = (u / _nonzero(beta)[:, None]).to(store)
    col = last[:, None, :].expand(B, m, 1)
    Q.scatter_(2, col, torch.where(valid[:, None, None], qn[..., None],
                                   Q.gather(2, col)))
    betas.scatter_(1, last - 1, torch.where(
        valid[:, None], beta[:, None], betas.gather(1, last - 1)))
    _notify(callback, alphas, betas, kprime, done)
    return GKResult(alphas, betas, beta1, P, Q, kprime, done)
