"""Expert-parallel mixture-of-experts block.  Counterpart of
``repro.models.moe``.

On one device (``mesh=None``) each call:

  1. routes every token on f32 logits: softmax, top-k, gates renormalised
     over the top k;
  2. builds a fixed-capacity ``(E, C, D)`` buffer of the tokens routed to
     each expert (:func:`dispatch`: a stable sort on the expert id, every
     slot past ``C = max(int(cf·T·k/E), 8)`` dropped in that order);
  3. runs the gated expert MLP as one batched product over the experts;
  4. scatter-adds the gated results back to their tokens.

The buffer-side gather and scatter-add keep the ``(T, k, D)``
per-assignment tensor from ever being materialized.  Nothing here reads a
value back to the host.

On a mesh (a ``DeviceMesh`` of ``repro_torch.launch.mesh``) the experts
split over "model" (EP): the rank at "model" position i holds experts
``my_lo = i · E_loc`` to ``my_lo + E_loc - 1`` (``E_loc = E / ep``), and
their d_model dimension is further split over "data" (FSDP, where it
divides).  The tokens are this rank's batch shard, the same on every rank
of the EP group.  Each rank

  1. gathers its experts' d_model blocks over "data" (one collective);
  2. routes its tokens (the router weight is whole on every rank; the
     routing is the same on every rank of the EP group);
  3. fills its local experts' buffers, capacity from its own T;
  4. sums the partial outputs over the EP group in rank order (one
     collective), so y has the same bits on every rank of the group.

The collectives are autograd functions (gloo's ``all_gather`` has none),
each over its own group of the mesh ("model" for the EP sums, "data"
for the FSDP gather): the output sum passes its gradient through
unchanged, the tokens entering
the local experts sum their gradient over the EP group, and the FSDP
gather sums the expert weights' gradients over "data" and keeps this
rank's block.  So each expert's owner gets the gradient the single-device
block gives its expert on the same tokens.  The aux loss is the mean over
every batch and EP rank (the EP group's ranks agree); each rank's own
term carries ``1 / n_batch`` of the gradient, since the train step adds
gradients over the batch axes only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import ParamBag, activate

Tensor = torch.Tensor


def init_moe(bag: ParamBag, cfg: ModelConfig, dtype, name: str = "moe"):
    moe = cfg.moe
    d = cfg.d_model
    sub = bag.sub(name)
    sub.dense("w_router", (d, moe.num_experts), ("embed", "experts_dim"),
              torch.float32)
    sub.dense("w_gate", (moe.num_experts, d, moe.d_ff_expert),
              ("experts", "embed", "mlp"), dtype)
    sub.dense("w_up", (moe.num_experts, d, moe.d_ff_expert),
              ("experts", "embed", "mlp"), dtype)
    sub.dense("w_down", (moe.num_experts, moe.d_ff_expert, d),
              ("experts", "mlp", "embed"), dtype)


def capacity(moe: MoEConfig, T: int) -> int:
    """Slots per expert for ``T`` tokens."""
    return max(int(moe.capacity_factor * T * moe.top_k / moe.num_experts), 8)


def route(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top-``k`` gates and expert ids of router probabilities ``(T, E)``,
    the gates renormalised over the top k."""
    gates, eidx = torch.topk(probs, k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp(min=1e-9), eidx


def expert_counts(flat_e: Tensor, num_experts: int) -> Tensor:
    """Assignments per expert (``bincount`` without its host sync)."""
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat_e.device)
    return counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))


def dispatch(gates: Tensor, eidx: Tensor, num_experts: int, C: int, *,
             lo: int = 0, local: Optional[int] = None
             ) -> tuple[Tensor, Tensor]:
    """The buffer tables of a routing: ``tok_for_slot`` ``(E, C)`` holds the
    token of each expert slot (``T`` where the slot is empty) and
    ``gate_for_slot`` its gate (0 where empty).

    Assignments are ordered by a stable sort on the expert id (token-major
    within an expert), and every assignment past an expert's ``C``-th is
    dropped.  With ``local`` given, only experts ``lo`` to
    ``lo + local - 1`` (a rank's own) get slots, and the tables are
    ``(local, C)``.
    """
    T, k = eidx.shape
    dev = eidx.device
    flat_e = eidx.reshape(-1)                                 # (T*k,)
    if local is None:
        E, key = num_experts, flat_e
    else:
        # other ranks' experts sort last, under the spare id E
        E, key = local, flat_e - lo
        key = torch.where((key >= 0) & (key < E), key, E)
    flat_tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    flat_gate = gates.reshape(-1)
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    counts = expert_counts(key, E + 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = (sorted_e < E) & (slot < C)
    # dropped assignments write to the spare row/column, cut off below
    e_idx = torch.where(keep, sorted_e, E)
    s_idx = torch.where(keep, slot, C)
    tok_for_slot = torch.full((E + 1, C + 1), T, dtype=torch.int64,
                              device=dev)
    tok_for_slot = tok_for_slot.index_put((e_idx, s_idx), flat_tok[order])
    gate_for_slot = torch.zeros((E + 1, C + 1), dtype=torch.float32,
                                device=dev)
    gate_for_slot = gate_for_slot.index_put((e_idx, s_idx),
                                            flat_gate[order].float())
    return tok_for_slot[:E, :C], gate_for_slot[:E, :C]


def _experts(xt: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
             tok_for_slot: Tensor, gate_for_slot: Tensor, act: str
             ) -> Tensor:
    """Gather -> batched expert MLP -> scatter-add: the (T, D) sum of the
    gated outputs of the experts of the tables."""
    T, D = xt.shape
    E, C = tok_for_slot.shape
    # row T of the padded tokens is the zero token of the empty slots
    xt_pad = torch.cat([xt, xt.new_zeros(1, D)], dim=0)
    buf = xt_pad[tok_for_slot.reshape(-1)].reshape(E, C, D)
    h = activate(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)
    out_buf = out_buf * gate_for_slot[..., None].to(out_buf.dtype)
    y = out_buf.new_zeros(T + 1, D)
    y = y.index_add(0, tok_for_slot.reshape(-1), out_buf.reshape(-1, D))
    return y[:T]


def _aux(probs: Tensor, eidx: Tensor, E: int) -> Tensor:
    """The Switch-style load-balance loss of one routing."""
    T, k = eidx.shape
    frac_tokens = expert_counts(eidx.reshape(-1), E).float() / (T * k)
    frac_probs = probs.mean(0)
    return E * torch.sum(frac_tokens * frac_probs)


def _local_moe(x: Tensor, wr: Tensor, wg: Tensor, wu: Tensor, wd: Tensor,
               *, moe: MoEConfig, act: str) -> tuple[Tensor, Tensor]:
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E, k = moe.num_experts, moe.top_k

    # --- router (f32) ---
    logits = xt.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = route(probs, k)
    C = capacity(moe, T)
    tok_for_slot, gate_for_slot = dispatch(gates, eidx, E, C)
    y = _experts(xt, wg, wu, wd, tok_for_slot, gate_for_slot, act)
    return y.reshape(B, S, D).to(x.dtype), _aux(probs, eidx, E)


# --- the expert-parallel path ---------------------------------------------

class _SumOut(torch.autograd.Function):
    """Forward: the sum over ``axes`` in rank order (the large-tensor
    reduction over the group).  Backward: the gradient unchanged (every
    rank of the group holds the same sum and continues alike)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        from repro_torch.distributed.matvec import psum_large
        return psum_large([x], mesh, axes)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradients summed over
    ``axes`` in rank order (each rank's own experts add their part), one
    large-tensor reduction over the group for all of them."""

    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.distributed.matvec import psum_large
        return (None, None, *psum_large(gs, ctx.mesh, ctx.axes))


class _MeanAux(torch.autograd.Function):
    """Forward: the mean over ``axes``.  Backward: ``1 / n_grad`` of the
    gradient to this rank's own term."""

    @staticmethod
    def forward(ctx, aux, mesh, axes, n, n_grad):
        from repro_torch.distributed.matvec import psum
        ctx.n_grad = n_grad
        return psum(aux, mesh, axes) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_grad, None, None, None, None


class _FsdpGather(torch.autograd.Function):
    """Forward: the expert weights' d_model blocks gathered over "data"
    (one collective over the group for the three).  Backward: the
    gradients summed over "data" in rank order (one large-tensor
    reduction), this rank's block kept."""

    @staticmethod
    def forward(ctx, mesh, wg, wu, wd):
        from repro_torch.distributed.partition import gather_packed, my_coord
        ctx.mesh = mesh
        ctx.idx = my_coord(mesh)["data"]
        ctx.block = wg.shape[1]
        parts = gather_packed([wg, wu, wd], mesh, ("data",))
        return tuple(torch.cat(list(parts[j].unbind(0)), dim=dim)
                     for j, dim in enumerate((1, 1, 2)))

    @staticmethod
    def backward(ctx, gg, gu, gd):
        from repro_torch.distributed.matvec import psum_large
        totals = psum_large((gg, gu, gd), ctx.mesh, ("data",))
        lo, b = ctx.idx * ctx.block, ctx.block
        return (None, *(t.narrow(dim, lo, b).contiguous()
                        for t, dim in zip(totals, (1, 1, 2))))


def expert_layout(moe: MoEConfig, d_model: int, mesh) -> tuple[int, int]:
    """(E_loc, D_loc): the experts and the d_model rows of one rank's
    block of an expert weight on ``mesh``: experts over "model" (which
    must divide them), d_model over "data" where it divides."""
    from repro_torch.distributed.partition import mesh_sizes
    sizes = mesh_sizes(mesh)
    ep, data = sizes.get("model", 1), sizes.get("data", 1)
    if moe.num_experts % ep:
        raise ValueError(f"{moe.num_experts} experts do not split over a "
                         f"{ep}-way 'model' axis")
    return (moe.num_experts // ep,
            d_model // data if d_model % data == 0 else d_model)


def _ep_moe(p: dict, x: Tensor, cfg: ModelConfig, mesh
            ) -> tuple[Tensor, Tensor]:
    from repro_torch.distributed.partition import (batch_axes, mesh_sizes,
                                                   my_coord)
    moe = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    E, k = moe.num_experts, moe.top_k
    sizes = mesh_sizes(mesh)
    E_loc, D_loc = expert_layout(moe, D, mesh)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    rows = wg.shape[1]
    if wg.shape[0] != E_loc or rows not in (D_loc, D) \
            or wd.shape[0] != E_loc or wd.shape[2] != rows:
        raise ValueError(
            f"expert weights {tuple(wg.shape)} / {tuple(wd.shape)} are not "
            f"this rank's block ({E_loc} experts, {D_loc} or all {D} "
            f"d_model rows) on a {sizes} mesh")
    if rows < D:
        wg, wu, wd = _FsdpGather.apply(mesh, wg, wu, wd)
    ep = ("model",) if sizes.get("model", 1) > 1 else ()
    my_lo = my_coord(mesh).get("model", 0) * E_loc

    # --- router (f32), the same on every rank of the EP group ---
    logits = xt.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = route(probs, k)
    # the tokens and gates entering the local experts: every expert's
    # owner adds its part to their gradients
    xe = xt
    if ep:
        xe, gates = _SumGrad.apply(mesh, ep, xt, gates)
    C = capacity(moe, T)
    tok_for_slot, gate_for_slot = dispatch(gates, eidx, E, C, lo=my_lo,
                                           local=E_loc)
    y = _experts(xe, wg, wu, wd, tok_for_slot, gate_for_slot, cfg.mlp_act)
    if ep:
        y = _SumOut.apply(y, mesh, ep)

    # --- aux, the mean over every batch and EP rank ---
    axes = batch_axes(mesh) + ep
    n = math.prod(sizes[a] for a in axes)
    aux = _aux(probs, eidx, E)
    if n > 1:
        aux = _MeanAux.apply(aux, mesh, axes, n,
                             n // sizes.get("model", 1) if ep else n)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_block(p: dict, x: Tensor, cfg: ModelConfig, mesh=None
              ) -> tuple[Tensor, Tensor]:
    """Apply the MoE block.  Returns (y, aux_loss).

    ``mesh=None``: one device, ``p`` whole.  On a mesh: ``x`` is this
    rank's batch shard, ``p["w_router"]`` whole and the expert weights
    this rank's blocks (:func:`expert_layout`, the blocks
    ``distributed.partition.param_shardings`` gives them)."""
    if mesh is None:
        return _local_moe(x, p["w_router"], p["w_gate"], p["w_up"],
                          p["w_down"], moe=cfg.moe, act=cfg.mlp_act)
    return _ep_moe(p, x, cfg, mesh)
