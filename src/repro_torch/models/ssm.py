"""Mamba2 (SSD — state-space duality) block, chunked matmul form.
Counterpart of ``repro.models.ssm``.

Follows the minimal SSD formulation of Dao & Gu (arXiv:2405.21060): a
within-chunk quadratic ("attention-like") term plus an inter-chunk state
recurrence, a loop over chunks carrying the state.  The recurrence state
``(B, H, P, N)`` is the decode cache — O(1) per generated token.

SSD internals run in float32 (cumulative-sum exponentials); projections
stay in the model dtype.

On a mesh (``mesh``, a ``DeviceMesh``) whose "model" axis divides the SSD
heads H, a block computes this rank's heads (``ssm_inner`` -> "model",
``layers.enter`` / ``leave``): ``wz`` and ``wx`` by their column block,
``out_norm`` and ``w_out`` by their row block, all aligned to heads; the
gated norm's sum of squares over the whole ``d_in`` is summed over
"model" (one small shard-order sum, the same bits on every rank of the
group).  The leaves the rules keep whole (``wB``, ``wC``, ``wdt``,
``dt_bias``, ``A_log``, ``D_skip``) come whole to every rank.  A rank
computes B and C whole from the block's input before it enters the
rank's heads; the f32 B and C, which each rank's heads read in part,
have their gradient summed over "model" (``layers.enter``) before it
goes back through the bf16 conv and projections, so ``wB``'s and
``wC``'s gradients come whole and alike to every rank.  Of the rest a
rank takes its heads' slice: its gradient fills its heads' part and the
sum over "model" puts the parts together.  The conv's ``conv_w`` and
``conv_b`` carry ``ssm_inner`` on conv_dim = d_in + 2·G·N, whose
contiguous "model" blocks line up neither with a rank's x channels nor
with the B and C channels every rank needs whole, so they come whole to
the layer (``distributed.partition.WHOLE_IN_BLOCK``): a rank convolves
its x channels (their part of the leaves summed like ``wdt``'s) and B
and C (their part alike on every rank).  The decode state ``h`` is the
rank's heads; the conv window stays whole, as the reference's cache
keeps it: the rank's x channels of its new rows are gathered over
"model" (B × (K − 1) × d_in / M values a prefill, B × d_in / M a
decoded token, a layer).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamBag, block_split, enter,
                                       gather_model, leave, proj,
                                       repeat_interleave)

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


def _gated_rmsnorm(y: Tensor, z: Tensor, w: Tensor, eps: float = 1e-6,
                   mesh=None, width: int = 0) -> Tensor:
    """Mamba2 output norm: RMSNorm(y * silu(z)).  With a ``mesh``, ``y``
    and ``z`` are this rank's ``width / M`` channels of ``width``: the sum
    of squares is summed over "model" (its gradient too: every rank's
    channels read it)."""
    y32 = (y * F.silu(z.float())).float()
    if mesh is None:
        var = y32.square().mean(-1, keepdim=True)
    else:
        ss, = enter(mesh, *leave(mesh, y32.square().sum(-1, keepdim=True),
                                 small=True))
        var = ss / width
    return y32 * torch.rsqrt(var + eps) * w.float()


def _head_groups(m: Tensor, lo: int, n: int, rep: int) -> Tensor:
    """The groups (B, S, G', N) of ``m`` that heads ``lo .. lo + n`` read
    (head h reads group h // ``rep``): the groups' slice where the heads
    cover whole groups, else one group a head."""
    if n % rep == 0:
        return m[:, :, lo // rep:(lo + n) // rep]
    idx = torch.arange(lo, lo + n, device=m.device) // rep
    return m.index_select(2, idx)


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
              cache: Optional[dict] = None, collect_state: bool = False,
              mesh=None) -> tuple[Tensor, Optional[dict]]:
    """Mamba2 block.

    Train: ``cache=None`` -> full chunked SSD (no state returned).
    Prefill: ``cache=None, collect_state=True`` -> returns the final SSD
    state and the conv window as the decode cache.
    Decode: ``cache={"h": (B,H,P,N), "conv": (B,K-1,conv_dim)}``.
    On a mesh whose "model" axis splits the heads, ``p`` holds this
    rank's blocks of ``wz``, ``wx``, ``out_norm`` and ``w_out`` and the
    state ``h`` is its heads' (module docstring).
    """
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    H = d_in // ssm.head_dim
    G, N, Pd = ssm.n_groups, ssm.d_state, ssm.head_dim
    Bsz, S, _ = x.shape
    K = ssm.d_conv
    split = block_split(mesh, p["wx"].shape[1], d_in, "wx's channels")
    wdt, dt_bias, A_log, D_skip = p["wdt"], p["dt_bias"], p["A_log"], \
        p["D_skip"]
    wB, wC, conv_w, conv_b = p["wB"], p["wC"], p["conv_w"], p["conv_b"]
    lo, Hl, dl = 0, H, d_in
    if split is not None:
        M, i = split
        if H % M:
            raise ValueError(f"a 'model' axis of {M} splits the {d_in} inner "
                             f"channels but not the {H} heads")
        Hl, dl = H // M, d_in // M
        lo = i * Hl
        # the whole leaves whose heads' or x channels' part a rank reads:
        # each rank's gradient fills its own part, the sum over "model"
        # puts the parts together
        wdt, dt_bias, A_log, D_skip, cx, bx = enter(
            mesh, wdt, dt_bias, A_log, D_skip, conv_w[:, :d_in],
            conv_b[:d_in])
        heads = slice(lo, lo + Hl)
        wdt = wdt[:, heads]
        dt_bias, A_log, D_skip = dt_bias[heads], A_log[heads], D_skip[heads]
        # the rank's x channels, then B and C
        conv_w = torch.cat([cx[:, lo * Pd:lo * Pd + dl], conv_w[:, d_in:]],
                           dim=1)
        conv_b = torch.cat([bx[lo * Pd:lo * Pd + dl], conv_b[d_in:]])
        # B and C are computed whole from the un-entered x (their
        # gradient is summed over "model" in f32, below), the rank's
        # heads' projections from the entered one
        xb, (x,) = x, enter(mesh, x)
    else:
        xb = x

    def whole(rows):
        # the conv window's rows with every rank's x channels
        if split is None:
            return rows
        return torch.cat([gather_model(rows[..., :dl], mesh),
                          rows[..., dl:]], dim=-1)

    z = proj(x, p["wz"])
    xin = proj(x, p["wx"])
    Braw = proj(xb, wB)
    Craw = proj(xb, wC)
    dt_raw = proj(x, wdt)

    xBC = torch.cat([xin, Braw, Craw], dim=-1)
    if cache is None:
        xBC_raw = xBC
        xBC = _causal_depthwise_conv(xBC, conv_w, conv_b).to(x.dtype)
        new_conv = None
        if collect_state:
            padded = F.pad(xBC_raw, (0, 0, max(0, K - 1 - S), 0))
            new_conv = whole(padded[:, -(K - 1):, :])
    else:
        window = torch.cat([cache["conv"], whole(xBC)], dim=1)   # (B,K,conv)
        new_conv = window[:, 1:, :]
        if split is not None:
            window = torch.cat([window[..., lo * Pd:lo * Pd + dl],
                                window[..., d_in:]], dim=-1)
        out = (window * conv_w[None]).sum(dim=1) + conv_b
        xBC = F.silu(out)[:, None, :].to(x.dtype)

    xin = xBC[..., :dl]
    Bm = xBC[..., dl:dl + G * N].reshape(Bsz, S, G, N).float()
    Cm = xBC[..., dl + G * N:].reshape(Bsz, S, G, N).float()
    if split is not None:
        # alike on every rank; each rank's heads give part of their
        # gradient, summed over "model" before the bf16 path back
        Bm, Cm = enter(mesh, Bm, Cm)
        Bm = _head_groups(Bm, lo, Hl, H // G)
        Cm = _head_groups(Cm, lo, Hl, H // G)

    dt = F.softplus(dt_raw.float() + dt_bias)                   # (B,S,H)
    A = -torch.exp(A_log)                                        # (H,)
    xh = xin.reshape(Bsz, S, Hl, Pd).float()
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
        rep = Hl // Bm.shape[2]
        Bh = repeat_interleave(Bm[:, 0], rep, 1)                 # (B,H,N)
        Ch = repeat_interleave(Cm[:, 0], rep, 1)
        h = (h * torch.exp(a[:, 0])[:, :, None, None]
             + xd[:, 0][..., None] * Bh[:, :, None, :])          # (B,H,P,N)
        y = torch.einsum("bhpn,bhn->bhp", h, Ch)[:, None]        # (B,1,H,P)
        new_cache = {"h": h.to(cache["h"].dtype), "conv": new_conv}

    y = y + xh * D_skip[None, None, :, None]
    y = y.reshape(Bsz, S, dl)
    if split is None:
        y = _gated_rmsnorm(y, z, p["out_norm"]).to(x.dtype)
        return proj(y, p["w_out"]), new_cache
    y = _gated_rmsnorm(y, z, p["out_norm"], mesh=mesh,
                       width=d_in).to(x.dtype)
    return leave(mesh, proj(y, p["w_out"]))[0], new_cache


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
