"""Feed-forward blocks: gated (SwiGLU / GeGLU) and plain 2-layer MLP.
Counterpart of ``repro.models.mlp``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import ParamBag, activate, proj

Tensor = torch.Tensor


def init_mlp(bag: ParamBag, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype, name: str = "mlp") -> None:
    sub = bag.sub(name)
    if act in ("silu", "gelu"):
        sub.dense("w_gate", (d_model, d_ff), ("embed", "mlp"), dtype)
    sub.dense("w_up", (d_model, d_ff), ("embed", "mlp"), dtype)
    sub.dense("w_down", (d_ff, d_model), ("mlp", "embed"), dtype)


def mlp(p: dict, x: Tensor, act: str) -> Tensor:
    up = proj(x, p["w_up"])
    if "w_gate" in p:
        h = activate(proj(x, p["w_gate"]), act) * up
    else:
        h = activate(up, act)
    return proj(h, p["w_down"])
