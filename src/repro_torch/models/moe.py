"""Mixture-of-experts block on one device.  Counterpart of the single-device
path of ``repro.models.moe`` (``moe_block`` with ``mesh=None``).

Each call:

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
"""
from __future__ import annotations

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


def dispatch(gates: Tensor, eidx: Tensor, num_experts: int, C: int
             ) -> tuple[Tensor, Tensor]:
    """The buffer tables of a routing: ``tok_for_slot`` ``(E, C)`` holds the
    token of each expert slot (``T`` where the slot is empty) and
    ``gate_for_slot`` its gate (0 where empty).

    Assignments are ordered by a stable sort on the expert id (token-major
    within an expert), and every assignment past an expert's ``C``-th is
    dropped.
    """
    T, k = eidx.shape
    E = num_experts
    dev = eidx.device
    flat_e = eidx.reshape(-1)                                 # (T*k,)
    flat_tok = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    flat_gate = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep = slot < C
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

    # --- gather -> batched expert MLP -> scatter-add ---
    # row T of the padded tokens is the zero token of the empty slots
    xt_pad = torch.cat([xt, xt.new_zeros(1, D)], dim=0)
    buf = xt_pad[tok_for_slot.reshape(-1)].reshape(E, C, D)
    h = activate(torch.bmm(buf, wg), act) * torch.bmm(buf, wu)
    out_buf = torch.bmm(h, wd)
    out_buf = out_buf * gate_for_slot[..., None].to(out_buf.dtype)
    y = out_buf.new_zeros(T + 1, D)
    y = y.index_add(0, tok_for_slot.reshape(-1), out_buf.reshape(-1, D))
    y = y[:T]

    # --- aux load-balance loss (Switch style) ---
    frac_tokens = expert_counts(eidx.reshape(-1), E).float() / (T * k)
    frac_probs = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y.reshape(B, S, D).to(x.dtype), aux


def moe_block(p: dict, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """Apply the MoE block on one device.  Returns (y, aux_loss)."""
    return _local_moe(x, p["w_router"], p["w_gate"], p["w_up"], p["w_down"],
                      moe=cfg.moe, act=cfg.mlp_act)
