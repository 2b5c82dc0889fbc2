"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain 2-layer MLP.
Counterpart of ``repro.models.mlp``.

On a mesh whose "model" axis divides the hidden width, the rank holds
the columns of ``w_gate`` / ``w_up`` and the rows of ``w_down`` of its
block and computes its part of the output, summed over "model"
(``layers.enter`` / ``leave``)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import (ParamBag, activate, block_split,
                                       enter, leave, proj)

Tensor = torch.Tensor


def init_mlp(bag: ParamBag, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype, name: str = "mlp") -> None:
    sub = bag.sub(name)
    if act in ("silu", "gelu"):
        sub.dense("w_gate", (d_model, d_ff), ("embed", "mlp"), dtype)
    sub.dense("w_up", (d_model, d_ff), ("embed", "mlp"), dtype)
    sub.dense("w_down", (d_ff, d_model), ("mlp", "embed"), dtype)


def mlp(p: dict, x: Tensor, act: str, mesh=None, d_ff: int = 0) -> Tensor:
    """The block on ``x``; on a mesh, ``d_ff`` is the whole hidden width,
    which the weights hold whole or as this rank's "model" block (a
    block alone does not tell its whole width)."""
    split = None if mesh is None else block_split(
        mesh, p["w_up"].shape[1], d_ff, "the MLP's width")
    if split is not None:
        x, = enter(mesh, x)
    up = proj(x, p["w_up"])
    if "w_gate" in p:
        h = activate(proj(x, p["w_gate"]), act) * up
    else:
        h = activate(up, act)
    y = proj(h, p["w_down"])
    return y if split is None else leave(mesh, y)[0]
