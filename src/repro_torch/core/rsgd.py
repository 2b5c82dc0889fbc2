"""Algorithm 4 — Riemannian mini-batch SGD for similarity learning (RSL).

Counterpart of ``repro.core.rsgd``.  Problem (paper eq. 21): learn W in M_r
minimizing the mean pair loss of ``f_W(x, v) = x^T W v`` over labelled
cross-domain pairs (x_i, v_i, y_i), y in {-1, +1}.

Scale design: the mini-batch Euclidean gradient is

    Gr = (1/b) X_b^T diag(c) V_b  + wd * W,     c_i = dl/dyhat_i * ...,

i.e. rank <= b + r — it is carried as an operator (``LowRankOp`` /
``SumOp``) and *never* materialized, so a 1e8-entry W (the paper's "huge
matrix" regime) trains with O((d1+d2) (b + r)) memory per step.  The
tangent projection (Alg 4 line 8) needs Gr only through r-column matmats,
and the retraction (line 9) runs F-SVD on the implicit rank-<=3r operator
W - eta*Z.

Note on Alg 4 line 6: the paper writes ``Gr = Gr - lambda W``; for a descent
step on f + (lambda/2)||W||_F^2 the regularization gradient is ``+ lambda W``
(the paper's minus sign would make the decay term *ascend*).  We implement
the mathematically consistent ``+``; set ``weight_decay=0`` to reproduce the
unregularized runs.

Note on Alg 4 line 7/8: the paper projects Gr using the singular vectors *of
Gr itself*; the Riemannian gradient of §5.3 (eq. 27) projects with the
factors *of W*.  ``project_at="w"`` (default) implements eq. 27;
``project_at="grad"`` implements the literal Alg 4 lines 7-8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

import repro_torch.core.manifold as mf
from repro_torch.api import SVDSpec, factorize
from repro_torch.core.operators import LowRankOp, Operator

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def hinge_loss(yhat: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """Returns (loss per pair, dl/dyhat per pair)."""
    margin = 1.0 - y * yhat
    loss = torch.clamp(margin, min=0.0)
    grad = torch.where(margin > 0, -y, torch.zeros_like(y))
    return loss, grad


def logistic_loss(yhat: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    z = y * yhat
    # logaddexp(0, -z), as the reference: softplus's linear threshold
    # would change the values
    loss = torch.logaddexp(torch.zeros_like(z), -z)
    grad = -y * torch.sigmoid(-z)
    return loss, grad


LOSSES: dict[str, Callable] = {"hinge": hinge_loss, "logistic": logistic_loss}


# ---------------------------------------------------------------------------
# batch gradient as an implicit operator
# ---------------------------------------------------------------------------

class BatchGrad(NamedTuple):
    loss: Tensor      # () mean batch loss (without the wd term)
    op: Operator      # implicit Euclidean gradient (d1, d2)


def batch_euclidean_grad(W: mf.FixedRankPoint, Xb: Tensor, Vb: Tensor,
                         y: Tensor, loss: str = "hinge",
                         weight_decay: float = 0.0) -> BatchGrad:
    """Gr = (1/b) X_b^T diag(c) V_b + wd * W through the operator algebra.

    Xb: (b, d1), Vb: (b, d2), y: (b,) in {-1, +1}.
    ``f_W(x_i, v_i) = x_i^T W v_i`` evaluated through W's factors.  The
    data term is ``LowRankOp(Xbᵀ, c, Vb)`` (rank ≤ b); weight decay adds
    ``wd * LowRankOp(U, s, Vᵀ)`` (rank r) as a ``SumOp``.
    """
    b = Xb.shape[0]
    loss_fn = LOSSES[loss]
    # yhat_i = x_i^T W v_i = (Xb U) diag(s) (V^T v_i) rowwise
    XU = Xb @ W.U                      # (b, r)
    VV = Vb @ W.V                      # (b, r)
    yhat = torch.einsum("br,r,br->b", XU, W.s, VV)
    per_pair, dl = loss_fn(yhat, y)
    c = dl / b                         # (b,)

    op: Operator = LowRankOp(Xb.T, c, Vb)          # (d1, d2), rank <= b
    if weight_decay:
        op = op + weight_decay * LowRankOp(W.U, W.s, W.V.T)
    return BatchGrad(per_pair.mean(), op)


# ---------------------------------------------------------------------------
# the RSGD step (Alg 4 body)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RSGDOptions:
    lr: float = 1e-2
    weight_decay: float = 0.0
    loss: str = "hinge"
    fsvd_iters: int = 20          # Alg 2 inner iterations (paper: 20 / 35)
    retraction: str = "fsvd"      # fsvd (paper) | qr (closed-form baseline)
    project_at: str = "w"         # w (eq 27) | grad (literal Alg 4 line 7-8)
    reorth_passes: int = 2
    # tracking retraction: warm-start each step's F-SVD from the current
    # point's factors (the retraction operand W - eta*Z is a *drift* of W)
    # instead of a cold start drawn from the step's generator.  False =
    # the paper's literal cold solve.
    track: bool = True


def rsgd_step(W: mf.FixedRankPoint, Xb: Tensor, Vb: Tensor, y: Tensor,
              opts: RSGDOptions,
              generator: Optional[torch.Generator] = None
              ) -> tuple[mf.FixedRankPoint, Tensor]:
    """One Alg-4 iteration. Returns (W_new, batch loss).  ``generator``
    draws the start vectors of the cold solves (the cold retraction and
    ``project_at="grad"``'s factorization of the gradient)."""
    bg = batch_euclidean_grad(W, Xb, Vb, y, opts.loss, opts.weight_decay)

    if opts.project_at == "grad":
        # literal Alg 4 lines 7-8: factor the gradient itself with F-SVD,
        # project Gr onto the tangent cone at its own top-r factors.
        r = W.rank
        g_out = factorize(
            bg.op, SVDSpec(method="fsvd", rank=r,
                           max_iters=max(opts.fsvd_iters, r + 2),
                           reorth_passes=opts.reorth_passes),
            generator=generator)
        Wg = mf.FixedRankPoint(g_out.U, g_out.s, g_out.V)
        xi = mf.project_tangent(Wg, bg.op)
        # re-express in the tangent space at W for the retraction step
        Zdense_op = mf.as_linop(Wg, xi, 1.0)     # still low-rank implicit
        xi = mf.project_tangent(W, Zdense_op)
    else:
        xi = mf.project_tangent(W, bg.op)        # eq. 27 at W

    if opts.retraction == "qr":
        W_new = mf.retract_qr(W, xi, -opts.lr)
    else:
        W_new = mf.retract_fsvd(W, xi, -opts.lr,
                                fsvd_iters=opts.fsvd_iters,
                                generator=generator,
                                reorth_passes=opts.reorth_passes,
                                warm_start=opts.track)
    return W_new, bg.loss


def make_step(opts: RSGDOptions, jit: bool = True):
    """The Alg-4 step: (W, Xb, Vb, y, generator) -> (W_new, loss).

    ``jit`` keeps the reference's call site and changes nothing: torch
    compiles nothing here.  The reference's compile-once meaning comes
    from the plan layer instead: the retraction's F-SVD runs through one
    cached runner, so ``trace_count()`` rises by one over a run of
    same-shaped steps.
    """
    def step(W, Xb, Vb, y, generator=None):
        return rsgd_step(W, Xb, Vb, y, opts, generator=generator)

    return step


def predict(W: mf.FixedRankPoint, Xb: Tensor, Vb: Tensor) -> Tensor:
    """yhat_i = x_i^T W v_i through the factors."""
    return torch.einsum("br,r,br->b", Xb @ W.U, W.s, Vb @ W.V)


def accuracy(W: mf.FixedRankPoint, Xb: Tensor, Vb: Tensor,
             y: Tensor) -> Tensor:
    return (torch.sign(predict(W, Xb, Vb)) == y).float().mean()
