"""Attention blocks: GQA (full / sliding-window local, logit softcap), MLA
(DeepSeek-V2 multi-head latent attention with absorbed decode), and
encoder-decoder cross attention.  Counterpart of
``repro.models.attention``, with the reference's arithmetic: logits in f32
before the softcap, the mask and the softmax.

Shapes: activations are ``(B, S, D)``; per-head tensors ``(B, S, H, hd)``.
The decode path updates KV caches with a one-hot blend (``blend``, the
default) or a one-slot write (``dus``), and returns new caches.

The sliding window is a per-layer Python int (``GLOBAL_WINDOW`` = global
attention), so alternating local/global stacks (gemma2) share one layer
body.  ``impl="chunked"`` computes attention in query chunks so the
(Sq, Sk) logits are never held at once; ``impl="online"`` runs the
flash-style online softmax over KV chunks, each step checkpointed so the
backward pass recomputes its probability tile.

On a mesh (``mesh``, a ``DeviceMesh``) whose "model" axis divides the
heads, a block computes this rank's heads (Megatron's layout,
``layers.enter`` / ``leave``): the q heads of its "model" block, the kv
heads they read, the f32 logits of its heads alone, and its part of the
output projection, summed over "model".  Where the kv heads divide too,
the rank holds its kv heads and its block of the KV cache; where they do
not (the weights whole), it takes the kv heads its q heads map to by
:func:`_repeat_kv`'s grouping.  MLA splits ``w_uq``, ``w_uk``, ``w_uv``
and ``wo`` by heads and keeps its latents whole; cross attention splits
as GQA.  Where "model" does not divide the heads, the block runs whole on
every rank.

A decode cache may split its sequence (``seq_axes``, the mesh axes of
``launch.input_specs.decode_seq_axes``): the rank at position j of the
group of ``seq_axes`` (n ranks) holds positions [j·S/n, (j+1)·S/n) of
every kv head it holds, the layout the reference's
``_cache_leaf_spec`` gives a cache whose kv heads do not divide "model"
(its sequence over "model"; the MLA latents, which have no head axis,
alike) and the batch of one of ``long_500k`` (its sequence over "data").
The new token's k and v (or latents) are written by the one rank whose
block holds its position (global positions; the causal and window masks
take the global ``kpos``).  A rank computes the online softmax's
partials (running max, denominator, f32 accumulator: :func:`_kv_step`)
of the q heads it needs over its own positions and combines them over
the group of ``seq_axes`` in shard order (:func:`_combine`): the same
bits on every rank of the group, and the cache is never gathered.  Where
"model" splits both the q heads and the sequence, each rank gathers the
q of every head over "model" and computes every head's partials, then
keeps its own heads' result.  So a rank sends, a token and a layer, B ×
(H / M) × hd floats of q (MLA: B × (H / M) × (kv_lora + dr)) where
"model" splits both, and B × H' × (hv + 2) floats of partials, H' the
heads it computes (MLA: hv = kv_lora), B its batch rows.  Cross
attention's K / V keep their sequence whole.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamBag, apply_rope, block_split,
                                       enter, gather_model, leave, proj,
                                       proj_heads, repeat_interleave)

Tensor = torch.Tensor

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
GLOBAL_WINDOW = torch.iinfo(torch.int32).max // 2   # sentinel: "no window"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_gqa(bag: ParamBag, cfg: ModelConfig, dtype, name: str = "attn"):
    sub = bag.sub(name)
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    sub.dense("wq", (d, h, hd), ("embed", "heads", "head_dim"), dtype)
    sub.dense("wk", (d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype)
    sub.dense("wv", (d, kv, hd), ("embed", "kv_heads", "head_dim"), dtype)
    sub.dense("wo", (h, hd, d), ("heads", "head_dim", "embed"), dtype)
    if cfg.qkv_bias:
        sub.zeros("bq", (h, hd), ("heads", "head_dim"), dtype)
        sub.zeros("bk", (kv, hd), ("kv_heads", "head_dim"), dtype)
        sub.zeros("bv", (kv, hd), ("kv_heads", "head_dim"), dtype)


def init_mla(bag: ParamBag, cfg: ModelConfig, dtype, name: str = "attn"):
    mla = cfg.mla
    sub = bag.sub(name)
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    sub.dense("w_dq", (d, mla.q_lora_rank), ("embed", "q_lora"), dtype)
    sub.ones("q_norm", (mla.q_lora_rank,), ("q_lora",), dtype)
    sub.dense("w_uq", (mla.q_lora_rank, h, dn + dr),
              ("q_lora", "heads", "head_dim"), dtype)
    sub.dense("w_dkv", (d, mla.kv_lora_rank + dr), ("embed", "kv_lora"),
              dtype)
    sub.ones("kv_norm", (mla.kv_lora_rank,), ("kv_lora",), dtype)
    sub.dense("w_uk", (mla.kv_lora_rank, h, dn),
              ("kv_lora", "heads", "head_dim"), dtype)
    sub.dense("w_uv", (mla.kv_lora_rank, h, dv),
              ("kv_lora", "heads", "head_dim"), dtype)
    sub.dense("wo", (h, dv, d), ("heads", "head_dim", "embed"), dtype)


def init_cross_attn(bag: ParamBag, cfg: ModelConfig, dtype,
                    name: str = "xattn"):
    sub = bag.sub(name)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    sub.dense("wq", (d, h, hd), ("embed", "heads", "head_dim"), dtype)
    sub.dense("wk", (d, h, hd), ("embed", "heads", "head_dim"), dtype)
    sub.dense("wv", (d, h, hd), ("embed", "heads", "head_dim"), dtype)
    sub.dense("wo", (h, hd, d), ("heads", "head_dim", "embed"), dtype)


# ---------------------------------------------------------------------------
# core attend
# ---------------------------------------------------------------------------

def _softcap32(logits: Tensor, cap: Optional[float]) -> Tensor:
    return logits if cap is None else cap * torch.tanh(logits / cap)


def _attend_full(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
                 scale: float, cap: Optional[float]) -> Tensor:
    """q: (B,Sq,H,hd)  k/v: (B,Sk,H,hd|hv)  mask: (B,Sq,Sk) bool or None.
    The logits are taken in f32 (the products of the inputs, summed in
    f32), as the reference's ``preferred_element_type``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = _softcap32(logits, cap)
    if mask is not None:
        logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhv->bqhv", probs, v)


def _causal_window_mask(qpos: Tensor, kpos: Tensor, window: int) -> Tensor:
    """(B,Sq,Sk) bool: causal, and within ``window`` of the query."""
    ok = kpos[:, None, :] <= qpos[:, :, None]
    ok &= (qpos[:, :, None] - kpos[:, None, :]) < window
    return ok


def _kv_step(m, l, acc, qi, kj, vj, qpi, kpj, window, scale, cap, causal):
    """One KV chunk of the online softmax: the running (max, denominator,
    accumulator) updated by the (Cq, Ck) tile."""
    s = torch.einsum("bqhd,bkhd->bqhk", qi.float(), kj.float()) * scale
    s = _softcap32(s, cap)
    if causal:
        ok = _causal_window_mask(qpi, kpj, window)            # (B,Cq,Ck)
        s = torch.where(ok[:, :, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))                      # (B,Cq,H)
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bqhk,bkhv->bqhv", p,
                                               vj.float())
    return m_new, l, acc


def _attend_online(q: Tensor, k: Tensor, v: Tensor, qpos: Tensor,
                   kpos: Tensor, window: int, scale: float,
                   cap: Optional[float], q_chunk: int, kv_chunk: int,
                   causal: bool) -> Tensor:
    """Flash-style online-softmax attention: query chunks outer, KV chunks
    inner with running (max, denominator, accumulator) statistics; the
    (Sq, Sk) score matrix never exists.  Each KV step is checkpointed, so
    the backward pass recomputes its (Cq, Ck) tile instead of keeping all
    of them (exact online rescaling, not an approximation)."""
    B, Sq, H, _ = q.shape
    Sk = k.shape[1]
    hv = v.shape[-1]
    assert Sq % q_chunk == 0 and Sk % kv_chunk == 0, (Sq, Sk, q_chunk,
                                                      kv_chunk)
    step = _kv_step
    if torch.is_grad_enabled():
        def step(*args):
            return checkpoint(_kv_step, *args, use_reentrant=False,
                              preserve_rng_state=False)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qi, qpi = q[:, q0:q0 + q_chunk], qpos[:, q0:q0 + q_chunk]
        m = torch.full((B, q_chunk, H), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, q_chunk, H), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, q_chunk, H, hv), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            m, l, acc = step(m, l, acc, qi, k[:, k0:k0 + kv_chunk],
                             v[:, k0:k0 + kv_chunk], qpi,
                             kpos[:, k0:k0 + kv_chunk], window, scale, cap,
                             causal)
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(v.dtype))
    return torch.cat(outs, dim=1)


def attend(q: Tensor, k: Tensor, v: Tensor, qpos: Tensor, kpos: Tensor, *,
           window: int, scale: float, cap: Optional[float],
           impl: str = "full", q_chunk: int = 1024,
           causal: bool = True) -> Tensor:
    """Masked attention with selectable implementation.

    ``full``    — materialize the (Sq, Sk) score matrix (baseline);
    ``chunked`` — query-chunked full softmax (peak-memory relief);
    ``online``  — flash-style online softmax (no S^2 buffer at all);
    ``auto``    — chunked when Sq > 8192 else full.
    ``window``: an int; GLOBAL_WINDOW for global attention.
    ``causal=False`` (encoder self-attention) attends everywhere.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    if impl == "auto":
        impl = "chunked" if (Sq > 8192 and Sq % q_chunk == 0) else "full"
    if impl == "online":
        qc, kvc = min(q_chunk, Sq), min(q_chunk, Sk)
        if Sq % qc == 0 and Sk % kvc == 0 and Sq > 1:
            return _attend_online(q, k, v, qpos, kpos, window, scale, cap,
                                  qc, kvc, causal)
        impl = "full"
    if impl != "chunked" or Sq <= q_chunk:
        mask = _causal_window_mask(qpos, kpos, window) if causal else None
        return _attend_full(q, k, v, mask, scale, cap)

    assert Sq % q_chunk == 0, (Sq, q_chunk)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qi, qpi = q[:, q0:q0 + q_chunk], qpos[:, q0:q0 + q_chunk]
        mask = _causal_window_mask(qpi, kpos, window) if causal else None
        outs.append(_attend_full(qi, k, v, mask, scale, cap))
    return torch.cat(outs, dim=1)


def _repeat_kv(x: Tensor, h: int) -> Tensor:
    kv = x.shape[2]
    return x if kv == h else repeat_interleave(x, h // kv, 2)


def _blend(cache: Tensor, new: Tensor, pos: Tensor,
           impl: str = "blend") -> Tensor:
    """Write ``new: (B,1,...)`` into ``cache: (B,S,...)`` at positions
    ``pos: (B,)``, returning a new cache.

    ``blend`` — one-hot convex blend: reads and rewrites the whole cache
    (scatter-free).  ``dus`` — writes one token slot per row.  A position
    outside ``[0, S)`` (a token of another rank's sequence block) writes
    nothing.
    """
    if impl == "dus":
        rows = torch.arange(cache.shape[0], device=cache.device)
        S = cache.shape[1]
        at = pos.long().clamp(0, S - 1)
        inside = ((pos >= 0) & (pos < S)).reshape(
            (-1,) + (1,) * (cache.dim() - 2))
        new = torch.where(inside, new[:, 0].to(cache.dtype), cache[rows, at])
        return cache.index_put((rows, at), new)
    S = cache.shape[1]
    slots = torch.arange(S, device=cache.device)
    oh = (slots[None, :] == pos[:, None]).to(cache.dtype)     # (B, S)
    oh = oh.reshape(oh.shape + (1,) * (cache.dim() - 2))
    return cache * (1 - oh) + oh * new.to(cache.dtype)


# ---------------------------------------------------------------------------
# decode over a cache split by sequence
# ---------------------------------------------------------------------------

def _seq_block(cache: Tensor, positions: Tensor, mesh, seq_axes) -> tuple:
    """(this rank's first position, its positions (B, S_loc)) of a cache
    block of ``cache.shape[1]`` positions, split over ``seq_axes``."""
    from repro_torch.distributed.partition import axes_index
    S = cache.shape[1]
    off = axes_index(mesh, tuple(seq_axes)) * S if seq_axes else 0
    kpos = off + torch.arange(S, dtype=positions.dtype,
                              device=cache.device)
    return off, kpos[None, :].expand(cache.shape[0], S)


def _combine(m: Tensor, l: Tensor, acc: Tensor, mesh, seq_axes) -> Tensor:
    """``acc / l`` over the whole sequence from each rank's online-softmax
    partials over its block (``m``, ``l``: (...), ``acc``: (..., hv), f32):
    one gather over the group of ``seq_axes``, the blocks rescaled to the
    group's max and added in shard order; the same bits on every rank of
    the group.  A block no key of which is visible (its ``m`` the mask
    value) weighs exp(NEG_INF − max) = 0."""
    from repro_torch.distributed.matvec import _all_gather
    rows = _all_gather(torch.cat([m[..., None], l[..., None], acc], -1),
                       mesh, tuple(seq_axes))
    top = rows[..., 0].amax(0)
    num = den = None
    for r in rows.unbind(0):
        w = torch.exp(r[..., 0] - top)
        den = w * r[..., 1] if den is None else den + w * r[..., 1]
        part = w[..., None] * r[..., 2:]
        num = part if num is None else num + part
    return num / den.clamp(min=1e-30)[..., None]


def _attend_seq_split(q: Tensor, k: Tensor, v: Tensor, qpos: Tensor,
                      kpos: Tensor, window: int, scale: float,
                      cap: Optional[float], mesh, seq_axes) -> Tensor:
    """Causal attention of ``q`` (B, Sq, H, hd) over the whole sequence
    of which ``k`` / ``v`` (B, S_loc, H, ·) are this rank's block at
    global positions ``kpos``: the block's partials (:func:`_kv_step`),
    combined over ``seq_axes``."""
    B, Sq, H, _ = q.shape
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    m, l, acc = _kv_step(m, l, acc, q, k, v, qpos, kpos, window, scale, cap,
                         True)
    return _combine(m, l, acc, mesh, seq_axes).to(v.dtype)


# ---------------------------------------------------------------------------
# GQA forward
# ---------------------------------------------------------------------------

def _head_split(p: dict, cfg: ModelConfig, mesh, key: str = "wq"):
    """(M, i) where this rank computes a block of the heads (its ``key``
    holds its "model" block of them), else None."""
    return block_split(mesh, p[key].shape[1], cfg.num_heads,
                       f"{key}'s heads")


def _kv_heads(p: dict, cfg: ModelConfig, mesh, split) -> tuple:
    """Where this rank's q heads read their kv heads on a "model" block
    ``split``: (kv weights whole?, first kv head, kv heads read, the kv
    head of each local q head relative to the first, or None where
    :func:`_repeat_kv` maps them)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    M, i = split
    h_loc = h // M
    if block_split(mesh, p["wk"].shape[1], kv, "wk's kv heads") is not None:
        return False, i * (kv // M), kv // M, None
    rep = h // kv
    lo = i * h_loc
    first, last = lo // rep, (lo + h_loc - 1) // rep
    idx = [q // rep - first for q in range(lo, lo + h_loc)]
    return True, first, last - first + 1, idx


def _take_kv(x: Tensor, h: int, idx) -> Tensor:
    """The kv heads (B, S, Kv, hd) of ``h`` q heads: by
    :func:`_repeat_kv`, or by the index of each q head's kv head."""
    if idx is None:
        return _repeat_kv(x, h)
    return x.index_select(2, torch.tensor(idx, device=x.device))


def gqa_attention(p: dict, x: Tensor, positions: Tensor, cfg: ModelConfig,
                  window: int = GLOBAL_WINDOW, cache: Optional[dict] = None,
                  collect_kv: bool = False, causal: bool = True,
                  mesh=None, seq_axes=()) -> tuple[Tensor, Optional[dict]]:
    """GQA self-attention.

    Train: ``x: (B,S,D)``, ``positions: (B,S)``, ``cache=None``.
    Prefill: additionally ``collect_kv=True`` -> returns {"k","v"} as the
    decode cache (kv-head layout, pre-repeat).
    Decode: ``x: (B,1,D)``, ``positions: (B,1)`` = current index,
    ``cache = {"k": (B,Smax,Kv,hd), "v": ...}``; returns the new cache.
    On a mesh that splits the heads the weights, the cache and the logits
    are this rank's; a decode cache may split its sequence over
    ``seq_axes`` (module docstring).
    """
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    scale = hd ** -0.5
    split = _head_split(p, cfg, mesh)
    wk, wv = p["wk"], p["wv"]
    bk, bv = (p["bk"], p["bv"]) if cfg.qkv_bias else (None, None)
    idx, whole = None, False
    if split is not None:
        h //= split[0]
        whole, first, n_kv, idx = _kv_heads(p, cfg, mesh, split)
        serving = cache is not None or collect_kv
        if whole:
            # each rank reads part of the whole kv weights: their
            # gradients are summed over "model"
            ws = enter(mesh, *(w for w in (wk, wv, bk, bv) if w is not None))
            wk, wv = ws[:2]
            if cfg.qkv_bias:
                bk, bv = ws[2:]
        if whole and not serving:
            wk, wv = wk[:, first:first + n_kv], wv[:, first:first + n_kv]
            if cfg.qkv_bias:
                bk, bv = bk[first:first + n_kv], bv[first:first + n_kv]
        x, = enter(mesh, x)
    q = proj(x, p["wq"])
    k = proj(x, wk)
    v = proj(x, wv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + bk, v + bv
    q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)

    def read(c):
        # the kv heads this rank's q heads read, from a whole cache
        if split is not None and whole and serving:
            c = c[:, :, first:first + n_kv]
        return _take_kv(c, h, idx)

    if cache is None:
        ctx = attend(q, read(k), read(v), positions,
                     positions, window=window, scale=scale,
                     cap=cfg.attn_logit_softcap, impl=cfg.attn_impl,
                     q_chunk=cfg.q_chunk, causal=causal)
        new_cache = {"k": k, "v": v} if collect_kv else None
    else:
        pos = positions[:, 0]                                 # (B,)
        off, kpos = _seq_block(cache["k"], positions, mesh, seq_axes)
        ck = _blend(cache["k"], k, pos - off, cfg.cache_update)
        cv = _blend(cache["v"], v, pos - off, cfg.cache_update)
        if not seq_axes:
            ctx = attend(q, read(ck), read(cv), positions,
                         kpos, window=window, scale=scale,
                         cap=cfg.attn_logit_softcap, impl="full")
        elif split is not None and "model" in seq_axes:
            # every head's partials over this rank's positions (the cache
            # holds every kv head), then this rank's heads
            H = cfg.num_heads
            qa = gather_model(q, mesh, dim=2)
            ctx = _attend_seq_split(qa, _repeat_kv(ck, H), _repeat_kv(cv, H),
                                    positions, kpos, window, scale,
                                    cfg.attn_logit_softcap, mesh, seq_axes)
            ctx = ctx[:, :, split[1] * h:(split[1] + 1) * h]
        else:
            ctx = _attend_seq_split(q, read(ck), read(cv), positions, kpos,
                                    window, scale, cfg.attn_logit_softcap,
                                    mesh, seq_axes)
        new_cache = {"k": ck, "v": cv}
    return _out(proj_heads(ctx, p["wo"]), mesh, split), new_cache


# ---------------------------------------------------------------------------
# MLA forward (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _rmsn(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def mla_attention(p: dict, x: Tensor, positions: Tensor, cfg: ModelConfig,
                  window: int = GLOBAL_WINDOW, cache: Optional[dict] = None,
                  collect_kv: bool = False, causal: bool = True,
                  mesh=None, seq_axes=()) -> tuple[Tensor, Optional[dict]]:
    """Multi-head latent attention.

    The cache stores only the latents: ``{"ckv": (B,Smax,kv_lora),
    "krope": (B,Smax,dr)}``.  Decode uses the absorbed form (q folded
    through W_uk, the context combined in latent space), so per-head K/V
    are never materialized over the cache length.
    """
    mla = cfg.mla
    dn, dr = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    scale = (dn + dr) ** -0.5
    split = _head_split(p, cfg, mesh, "w_uq")

    cq = _rmsn(proj(x, p["w_dq"]), p["q_norm"])
    ckv_full = proj(x, p["w_dkv"])
    ckv, krope = (ckv_full[..., :mla.kv_lora_rank],
                  ckv_full[..., mla.kv_lora_rank:])
    ckv = _rmsn(ckv, p["kv_norm"])
    krope = apply_rope(krope[:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    if split is not None:
        # the latents, whole on every rank, enter the rank's heads
        cq, ckv, krope = enter(mesh, cq, ckv, krope)
    qfull = proj(cq, p["w_uq"])
    q_nope, q_rope = qfull[..., :dn], qfull[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    if cache is None:
        # full sequence: materialize per-head K/V (train / prefill)
        k_nope = proj(ckv, p["w_uk"])
        v = proj(ckv, p["w_uv"])
        k = torch.cat([k_nope, krope[:, :, None, :].expand(
            *k_nope.shape[:3], dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        ctx = attend(q, k, v, positions, positions, window=window,
                     scale=scale, cap=cfg.attn_logit_softcap,
                     impl=cfg.attn_impl, q_chunk=cfg.q_chunk)
        new_cache = {"ckv": ckv, "krope": krope} if collect_kv else None
        return _out(proj_heads(ctx, p["wo"]), mesh, split), new_cache

    # --- absorbed decode ---
    pos = positions[:, 0]
    off, kpos = _seq_block(cache["ckv"], positions, mesh, seq_axes)
    c_ckv = _blend(cache["ckv"], ckv, pos - off, cfg.cache_update)  # (B,S,r)
    c_kr = _blend(cache["krope"], krope, pos - off,
                  cfg.cache_update)                              # (B,S,dr)
    # fold q through W_uk: (B,1,H,dn) x (r,H,dn) -> (B,1,H,r)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    every = bool(seq_axes) and split is not None and "model" in seq_axes
    if every:
        # every head's partials over this rank's positions
        q_lat = gather_model(q_lat, mesh, dim=2)
        q_rope = gather_model(q_rope, mesh, dim=2)
    logits = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_ckv.float())
              + torch.einsum("bshk,btk->bhst", q_rope.float(),
                             c_kr.float())) * scale
    mask = kpos[:, None, :] <= pos[:, None, None]
    logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
    if not seq_axes:
        probs = torch.softmax(logits, dim=-1).to(c_ckv.dtype)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_ckv)  # (B,1,H,r)
    else:
        m = logits.amax(-1)                                     # (B,H,1)
        pr = torch.exp(logits - m[..., None])
        acc = torch.einsum("bhst,btr->bshr", pr, c_ckv.float())
        ctx_lat = _combine(m.transpose(1, 2), pr.sum(-1).transpose(1, 2),
                           acc, mesh, seq_axes).to(c_ckv.dtype)
        if every:
            h = p["w_uv"].shape[1]
            ctx_lat = ctx_lat[:, :, split[1] * h:(split[1] + 1) * h]
    ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, p["w_uv"])  # (B,1,H,dv)
    return (_out(proj_heads(ctx, p["wo"]), mesh, split),
            {"ckv": c_ckv, "krope": c_kr})


def _out(y: Tensor, mesh, split) -> Tensor:
    """A block's output projection: summed over "model" where the rank
    computed a block of the heads."""
    return y if split is None else leave(mesh, y)[0]


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------

def cross_attention(p: dict, x: Tensor, enc_kv: tuple[Tensor, Tensor],
                    cfg: ModelConfig, mesh=None) -> Tensor:
    """x: (B,S,D); enc_kv: precomputed (K, V) each (B,T,H,hd), this
    rank's heads where the mesh splits them (:func:`encode_cross_kv`)."""
    hd = cfg.resolved_head_dim
    split = _head_split(p, cfg, mesh)
    if split is not None:
        x, = enter(mesh, x)
    q = proj(x, p["wq"])
    B, Sq = x.shape[:2]
    T = enc_kv[0].shape[1]
    qpos = torch.zeros((B, Sq), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    ctx = attend(q, enc_kv[0], enc_kv[1], qpos, kpos, window=GLOBAL_WINDOW,
                 scale=hd ** -0.5, cap=None, causal=False,
                 impl=cfg.attn_impl, q_chunk=cfg.q_chunk)
    return _out(proj_heads(ctx, p["wo"]), mesh, split)


def encode_cross_kv(p: dict, enc_out: Tensor, cfg: ModelConfig,
                    mesh=None) -> tuple[Tensor, Tensor]:
    """The cross attention's (K, V) of the encoder output: this rank's
    heads where the mesh splits them."""
    if _head_split(p, cfg, mesh) is not None:
        enc_out, = enter(mesh, enc_out)
    return proj(enc_out, p["wk"]), proj(enc_out, p["wv"])


def init_gqa_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_seq, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device=None) -> dict:
    mla = cfg.mla
    return {"ckv": torch.zeros((batch, max_seq, mla.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, mla.qk_rope_head_dim),
                                 dtype=dtype, device=device)}
