"""Mamba2 (SSD — state-space duality) block, chunked matmul form.
Counterpart of ``repro.models.ssm``.

Follows the minimal SSD formulation of Dao & Gu (arXiv:2405.21060): a
within-chunk quadratic ("attention-like") term plus an inter-chunk state
recurrence, a loop over chunks carrying the state.  The recurrence state
``(B, H, P, N)`` is the decode cache — O(1) per generated token.

SSD internals run in float32 (cumulative-sum exponentials); projections
stay in the model dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamBag, proj, repeat_interleave

Tensor = torch.Tensor


def init_ssm(bag: ParamBag, cfg: ModelConfig, dtype, name: str = "ssm"):
    ssm = cfg.ssm
    d = cfg.d_model
    d_in = ssm.expand * d
    H = d_in // ssm.head_dim
    G, N = ssm.n_groups, ssm.d_state
    sub = bag.sub(name)
    sub.dense("wz", (d, d_in), ("embed", "ssm_inner"), dtype)
    sub.dense("wx", (d, d_in), ("embed", "ssm_inner"), dtype)
    sub.dense("wB", (d, G * N), ("embed", "ssm_state"), dtype)
    sub.dense("wC", (d, G * N), ("embed", "ssm_state"), dtype)
    sub.dense("wdt", (d, H), ("embed", "ssm_heads"), dtype)
    sub.zeros("dt_bias", (H,), ("ssm_heads",), torch.float32)
    # A_log init ~ log(uniform[1,16]) (mamba2 default)
    u = sub.uniform("A_log", (H,), ("ssm_heads",))
    sub.params["A_log"] = torch.log(1.0 + 15.0 * u)
    sub.ones("D_skip", (H,), ("ssm_heads",), torch.float32)
    conv_dim = d_in + 2 * G * N
    sub.dense("conv_w", (ssm.d_conv, conv_dim), ("conv_k", "ssm_inner"),
              dtype, scale=ssm.d_conv ** -0.5)
    sub.zeros("conv_b", (conv_dim,), ("ssm_inner",), dtype)
    sub.ones("out_norm", (d_in,), ("ssm_inner",), dtype)
    sub.dense("w_out", (d_in, d), ("ssm_inner", "embed"), dtype)


def _causal_depthwise_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x: (B,S,C); w: (K,C) depthwise causal conv + silu."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x, dtype=torch.promote_types(x.dtype, w.dtype))
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i]
    return F.silu(out + b)


def _gated_rmsnorm(y: Tensor, z: Tensor, w: Tensor, eps: float = 1e-6
                   ) -> Tensor:
    """Mamba2 output norm: RMSNorm(y * silu(z))."""
    y32 = (y * F.silu(z.float())).float()
    var = y32.square().mean(-1, keepdim=True)
    return y32 * torch.rsqrt(var + eps) * w.float()


def _ssd_chunked(xd: Tensor, a: Tensor, Bm: Tensor, Cm: Tensor, L: int,
                 h0: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Chunked SSD scan.

    xd: (B,S,H,P)  — dt-premultiplied inputs (f32)
    a:  (B,S,H)    — dt * A  (negative, f32)
    Bm/Cm: (B,S,G,N); heads map to groups by ``H // G`` blocks.
    Returns (y: (B,S,H,P), final_state: (B,H,P,N)).
    """
    Bsz, S, H, Pd = xd.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    NC = S // L
    xc = xd.reshape(Bsz, NC, L, H, Pd)
    ac = a.reshape(Bsz, NC, L, H)
    Bc = repeat_interleave(Bm.reshape(Bsz, NC, L, G, N), rep, 3)
    Cc = repeat_interleave(Cm.reshape(Bsz, NC, L, G, N), rep, 3)

    acs = torch.cumsum(ac, dim=2)                                # inclusive
    # --- intra-chunk quadratic term ---
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]          # (B,NC,l,s,H)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xd.device))
    # mask before exp: the masked (future) entries have seg > 0 and
    # exp(seg) overflows; an inf in the untaken branch turns the backward
    # pass into 0 * inf = NaN
    seg = torch.where(mask[None, None, :, :, None], seg, -math.inf)
    Lmat = torch.exp(seg)
    CB = torch.einsum("bclhn,bcshn->bclsh", Cc, Bc)
    y_diag = torch.einsum("bclsh,bcshp->bclhp", CB * Lmat, xc)

    # --- chunk states and inter-chunk recurrence ---
    decay_states = torch.exp(acs[:, :, -1:, :] - acs)            # (B,NC,L,H)
    states = torch.einsum("bcshn,bcshp->bchnp",
                          Bc * decay_states[..., None], xc)
    chunk_total = torch.exp(acs[:, :, -1, :])                    # (B,NC,H)

    h = h0 if h0 is not None else xd.new_zeros((Bsz, H, N, Pd))
    h_prevs = []
    for c in range(NC):
        h_prevs.append(h)
        h = h * chunk_total[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,NC,H,N,P)

    y_off = torch.einsum("bclhn,bchnp->bclhp",
                         Cc * torch.exp(acs)[..., None], h_prevs)
    y = (y_diag + y_off).reshape(Bsz, S, H, Pd)
    # state layout (B,H,P,N) for the decode cache
    return y, h.transpose(-1, -2)


def ssm_block(p: dict, x: Tensor, cfg: ModelConfig,
              cache: Optional[dict] = None, collect_state: bool = False
              ) -> tuple[Tensor, Optional[dict]]:
    """Mamba2 block.

    Train: ``cache=None`` -> full chunked SSD (no state returned).
    Prefill: ``cache=None, collect_state=True`` -> returns the final SSD
    state and the conv window as the decode cache.
    Decode: ``cache={"h": (B,H,P,N), "conv": (B,K-1,conv_dim)}``.
    """
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    H = d_in // ssm.head_dim
    G, N, Pd = ssm.n_groups, ssm.d_state, ssm.head_dim
    Bsz, S, _ = x.shape

    z = proj(x, p["wz"])
    xin = proj(x, p["wx"])
    Braw = proj(x, p["wB"])
    Craw = proj(x, p["wC"])
    dt_raw = proj(x, p["wdt"])

    xBC = torch.cat([xin, Braw, Craw], dim=-1)
    if cache is None:
        xBC_raw = xBC
        xBC = _causal_depthwise_conv(xBC, p["conv_w"],
                                     p["conv_b"]).to(x.dtype)
        K = ssm.d_conv
        new_conv = None
        if collect_state:
            padded = F.pad(xBC_raw, (0, 0, max(0, K - 1 - S), 0))
            new_conv = padded[:, -(K - 1):, :]
    else:
        window = torch.cat([cache["conv"], xBC], dim=1)          # (B,K,conv)
        out = (window * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
        xBC = F.silu(out)[:, None, :].to(x.dtype)
        new_conv = window[:, 1:, :]

    xin = xBC[..., :d_in]
    Bm = xBC[..., d_in:d_in + G * N].reshape(Bsz, S, G, N).float()
    Cm = xBC[..., d_in + G * N:].reshape(Bsz, S, G, N).float()

    dt = F.softplus(dt_raw.float() + p["dt_bias"])               # (B,S,H)
    A = -torch.exp(p["A_log"])                                   # (H,)
    xh = xin.reshape(Bsz, S, H, Pd).float()
    xd = xh * dt[..., None]
    a = dt * A

    if cache is None:
        L = min(ssm.chunk_size, S)
        pad = (-S) % L
        if pad:
            # zero-pad to a chunk multiple: xd/B/C = 0 adds nothing to the
            # state and a = 0 (decay exp(0) = 1) preserves it, so the final
            # state is exact despite the padding
            xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
            a = F.pad(a, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        y, hT = _ssd_chunked(xd, a, Bm, Cm, L)
        y = y[:, :S]
        new_cache = ({"h": hT.float(), "conv": new_conv}
                     if collect_state else None)
    else:
        h = cache["h"].float()                                   # (B,H,P,N)
        rep = H // G
        Bh = repeat_interleave(Bm[:, 0], rep, 1)                 # (B,H,N)
        Ch = repeat_interleave(Cm[:, 0], rep, 1)
        h = (h * torch.exp(a[:, 0])[:, :, None, None]
             + xd[:, 0][..., None] * Bh[:, :, None, :])          # (B,H,P,N)
        y = torch.einsum("bhpn,bhn->bhp", h, Ch)[:, None]        # (B,1,H,P)
        new_cache = {"h": h.to(cache["h"].dtype), "conv": new_conv}

    y = y + xh * p["D_skip"][None, None, :, None]
    y = y.reshape(Bsz, S, d_in)
    y = _gated_rmsnorm(y, z, p["out_norm"]).to(x.dtype)
    return proj(y, p["w_out"]), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    H = d_in // ssm.head_dim
    conv_dim = d_in + 2 * ssm.n_groups * ssm.d_state
    return {
        "h": torch.zeros((batch, H, ssm.head_dim, ssm.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, ssm.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
