"""Model zoo assembly: every assigned architecture behind one API.
Counterpart of ``repro.models.model``.

    init_model(cfg, generator)                 -> (model, logical_axes)
    loss_fn(model, batch, cfg, mesh)           -> (loss, metrics)   [train]
    prefill_step(model, batch, cfg, mesh)      -> (last_logits, cache)
    decode_step(model, cache, batch, cfg, mesh) -> (logits, new_cache)
    init_cache(cfg, batch, max_seq)            -> cache dict

``mesh`` (default None: one device) is a ``DeviceMesh`` of
``repro_torch.launch.mesh``.  Each rank then runs its batch shard, and a
layer's compute follows its weights' spec
(``distributed.partition.model_region``): where the spec splits the
heads, the MLP's width or the vocabulary over "model", the rank computes
its block (tensor parallelism, ``layers.enter`` / ``leave``: attention by
heads, the MLP by columns and rows, the embedding lookup, the LM head and
its cross entropy by vocabulary rows), and the MoE blocks run
expert-parallel (``repro_torch.models.moe``); ``model`` then holds this
rank's "model" blocks of those leaves; the Mamba2 layers compute their
heads' block where "model" divides the heads (``ssm_inner``,
``repro_torch.models.ssm``).  A leaf the divisibility guard leaves whole
runs whole on every rank.

Families: dense / moe / vlm share the decoder-LM skeleton; audio is an
encoder-decoder (whisper); ssm is a Mamba2 stack; hybrid is Zamba2 (Mamba2
backbone + one SHARED attention+MLP block applied every ``attn_every``
layers).

The model is a :class:`ParamTree` module: the reference's parameter
pytree with each tensor an ``nn.Parameter`` under the reference's name,
and each stacked layer axis (``layers``, ``enc_layers``, ``dec_layers``)
an ``nn.ModuleList`` of one subtree per layer.  The functions below read
its nested dict (``model.tree()``).

  * the layer stacks are loops over the layer list; each layer is wrapped
    per ``cfg.remat_policy``: ``nothing`` checkpoints the whole layer,
    ``dots`` saves only the outputs of its matrix products (the
    reference's ``dots_with_no_batch_dims_saveable``), ``none`` keeps
    everything;
  * gemma2's local/global alternation is a per-layer window (an int);
  * deepseek's dense layer 0 is an unrolled prefix (``layer0``), zamba2's
    shared-attention sites a grouped loop;
  * the LM head and cross entropy are sequence-chunked (``cfg.ce_chunk``)
    with each chunk checkpointed, so the (B, S, vocab) logits are never
    held at once.
  * decode caches keep the reference's layout: one tensor per leaf with a
    leading layer axis.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamBag, apply_norm, block_split,
                                       ce_sums, enter, gather_model,
                                       init_norm, leave, proj,
                                       stacked_logical)
from repro_torch.models.mlp import init_mlp, mlp

Tensor = torch.Tensor

#: the parameter keys whose reference leaves carry a leading layer axis
STACKED = ("layers", "enc_layers", "dec_layers")


# ---------------------------------------------------------------------------
# the parameter tree as a module
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested parameter dict as a module: tensors become parameters,
    dicts submodules, lists of dicts ``nn.ModuleList``s."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=v.is_floating_point()))

    def tree(self) -> dict:
        """The parameters as a nested dict (lists for the layer stacks)."""
        out: dict = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = ([c.tree() for c in m] if isinstance(m, nn.ModuleList)
                      else m.tree())
        return out


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _index(tree, i):
    return _map(lambda a: a[i], tree)


def _stack(trees: list):
    """Stack a list of equal-structure cache trees along a new axis 0."""
    if not trees or trees[0] is None:
        return None
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees, 0)


def _cat(a, b):
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k]) for k in a}
    return torch.cat([a, b], 0)


# ---------------------------------------------------------------------------
# shared plumbing
# ---------------------------------------------------------------------------

def layer_windows(cfg: ModelConfig) -> tuple[int, ...]:
    """The sliding window of every layer; GLOBAL_WINDOW = global."""
    L = cfg.num_layers
    if not cfg.attn_pattern or cfg.sliding_window is None:
        return (attn_mod.GLOBAL_WINDOW,) * L
    pat = [cfg.sliding_window if k == "local" else attn_mod.GLOBAL_WINDOW
           for k in cfg.attn_pattern]
    return tuple(pat[i % len(pat)] for i in range(L))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Save the outputs of the matrix products that have no batch
    dimension (the projections), recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(f: Callable, policy: str) -> Callable:
    """``f`` wrapped per the remat policy (only where autograd records)."""
    if policy == "none":
        return f
    kw: dict = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, **kw)
    return wrapped


def _run_layers(body, x: Tensor, layers: list, windows, caches,
                policy: str):
    """Apply ``body(x, p, window, cache) -> (x, new_cache, aux)`` layer by
    layer.  ``caches`` (stacked, or None) gives layer i ``caches[i]``; the
    layers' new caches come back stacked (None if the body returns
    none)."""
    f = _remat(body, policy)
    aux = x.new_zeros((), dtype=torch.float32)
    new = []
    for i, p in enumerate(layers):
        cache = _index(caches, i) if caches is not None else None
        x, nc, a = f(x, p, windows[i], cache)
        aux = aux + a
        new.append(nc)
    return x, _stack(new), aux


def _pin_batch(x: Tensor, cfg: ModelConfig, mesh) -> Tensor:
    """The reference's batch-sharding constraint on (B, S, D) activations
    (``ModelConfig.pin_activations``), a layout hint to GSPMD.  Here each
    rank already holds only its batch shard, so this is the identity."""
    return x


def _vocab_split(params: dict, cfg: ModelConfig, mesh):
    """(M, i) where this rank holds a block of the vocabulary rows, else
    None."""
    return block_split(mesh, params["embed"].shape[0], cfg.vocab_size,
                       "the embedding's vocabulary")


def _embed(params: dict, tokens: Tensor, cfg: ModelConfig,
           mesh=None) -> Tensor:
    emb = params["embed"]
    split = _vocab_split(params, cfg, mesh)
    if split is None:
        x = torch.index_select(emb, 0, tokens.reshape(-1))
    else:
        # the rank's rows, zeros for the others' tokens, summed over
        # "model": each token's row from the one rank that holds it
        local = tokens.reshape(-1).long() - split[1] * emb.shape[0]
        own = (local >= 0) & (local < emb.shape[0])
        x = torch.index_select(emb, 0, torch.where(own, local, 0))
        x, = leave(mesh, x * own[:, None].to(x.dtype))
    x = x.reshape(*tokens.shape, emb.shape[-1]).to(_dtype(cfg.dtype))
    if cfg.embedding_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head_logits(params: dict, x: Tensor, cfg: ModelConfig,
                 mesh=None) -> Tensor:
    """(..., d) -> (..., V) in f32, with the final softcap.  The products
    of the stored values are summed in f32, as the reference's
    ``preferred_element_type``.  Where the rank holds a block of the
    vocabulary, its logits are gathered over "model"."""
    split = _vocab_split(params, cfg, mesh)
    logits = _local_logits(params, x, cfg)
    return logits if split is None else gather_model(logits, mesh)


def _local_logits(params: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The logits of the vocabulary rows the rank holds (all of them on
    one device)."""
    if cfg.tie_embeddings:
        logits = x.float() @ params["embed"].to(x.dtype).float().T
    else:
        logits = x.float() @ params["head"].float()
    if cfg.final_logit_softcap is not None:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _ce_chunk(params: dict, x: Tensor, labels: Tensor, cfg: ModelConfig,
              mesh=None):
    split = _vocab_split(params, cfg, mesh)
    if split is None:
        return ce_sums(_local_logits(params, x, cfg), labels)
    x, = enter(mesh, x)
    return vocab_ce_sums(_local_logits(params, x, cfg), labels, mesh,
                         split[1])


def vocab_ce_sums(logits: Tensor, labels: Tensor, mesh, pos: int,
                  ignore_id: int = -1) -> tuple[Tensor, Tensor]:
    """``layers.ce_sums`` of logits whose vocabulary is split over
    "model": ``logits`` (..., V / M) are this rank's, the block at
    ``pos``.  The max is taken over the group, the sum of exponentials
    and the label's logit (from the rank that holds it) are summed over
    it; every rank of the group returns the same sums."""
    from repro_torch.distributed.matvec import _all_gather
    logits = logits.float()
    n = logits.shape[-1]
    valid = labels != ignore_id
    local = torch.where(valid, labels, 0).long() - pos * n
    own = (local >= 0) & (local < n)
    with torch.no_grad():
        m = _all_gather(logits.amax(-1), mesh, ("model",)).amax(0)
    se = torch.exp(logits - m[..., None]).sum(-1)
    gold = torch.take_along_dim(logits, torch.where(own, local, 0)[..., None],
                                dim=-1)[..., 0]
    se, gold = leave(mesh, torch.stack([se, torch.where(own, gold, 0.0)]),
                     small=True)[0].unbind(0)
    nll = torch.where(valid, torch.log(se) + m - gold, 0.0)
    return nll.sum(), valid.sum()


def _chunked_ce(params: dict, x: Tensor, labels: Tensor, cfg: ModelConfig,
                mesh=None) -> tuple[Tensor, Tensor]:
    """Sequence-chunked LM-head cross entropy. x: (B,S,d) final-normed.

    Returns (mean nll over valid tokens, n_valid).  Each chunk is
    checkpointed, so the (B, chunk, V) logits block is the only
    vocab-sized live tensor, in the forward and the backward pass.
    """
    S = x.shape[1]
    chunk = cfg.ce_chunk
    if not chunk or S % chunk or S <= chunk:
        nll, n = _ce_chunk(params, x, labels, cfg, mesh)
        return nll / n.clamp(min=1), n
    f = _remat(_ce_chunk, "nothing")
    nll = x.new_zeros((), dtype=torch.float32)
    n = torch.zeros((), dtype=torch.int64, device=x.device)
    for c in range(0, S, chunk):
        nll_c, n_c = f(params, x[:, c:c + chunk], labels[:, c:c + chunk], cfg,
                       mesh)
        nll, n = nll + nll_c, n + n_c
    return nll / n.clamp(min=1), n


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


class Metrics(NamedTuple):
    loss: Tensor
    ce: Tensor
    aux: Tensor
    n_tokens: Tensor


# ---------------------------------------------------------------------------
# decoder LM (dense / moe / vlm)
# ---------------------------------------------------------------------------

def _init_decoder_layer(gen, cfg: ModelConfig, dtype, kind: str,
                        d_ff: Optional[int] = None) -> tuple[dict, dict]:
    bag = ParamBag(gen)
    if cfg.mla is not None:
        attn_mod.init_mla(bag, cfg, dtype)
    else:
        attn_mod.init_gqa(bag, cfg, dtype)
    init_norm(bag, "attn_norm", cfg.d_model, cfg.norm, dtype)
    init_norm(bag, "mlp_norm", cfg.d_model, cfg.norm, dtype)
    if cfg.post_norm:
        init_norm(bag, "post_attn_norm", cfg.d_model, cfg.norm, dtype)
        init_norm(bag, "post_mlp_norm", cfg.d_model, cfg.norm, dtype)
    if kind == "moe":
        moe_mod.init_moe(bag, cfg, dtype)
        if cfg.moe.num_shared_experts:
            init_mlp(bag, cfg.d_model,
                     cfg.moe.num_shared_experts * cfg.moe.d_ff_shared,
                     cfg.mlp_act, dtype, name="shared_mlp")
    else:
        init_mlp(bag, cfg.d_model, d_ff or cfg.d_ff, cfg.mlp_act, dtype)
    return bag.done()


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.moe is None:
        return ["dense"] * cfg.num_layers
    kinds = []
    for i in range(cfg.num_layers):
        is_moe = (i >= cfg.moe.moe_start_layer
                  and (i - cfg.moe.moe_start_layer) % cfg.moe.moe_every == 0)
        kinds.append("moe" if is_moe else "dense")
    return kinds


def _n_prefix(cfg: ModelConfig) -> int:
    """The leading dense run before the homogeneous tail (deepseek's layer
    0); only MoE configs have one."""
    kinds = _layer_kinds(cfg)
    n = 0
    while n < len(kinds) and cfg.moe is not None and kinds[n] == "dense":
        n += 1
    assert len(set(kinds[n:])) <= 1, f"non-homogeneous tail: {kinds}"
    return n


def _layer_stack(bag: ParamBag, name: str, make, n: int) -> None:
    layers = [make() for _ in range(n)]
    bag.params[name] = [p for p, _ in layers]
    bag.logical[name] = stacked_logical(layers[0][1])


def _init_decoder_lm(cfg: ModelConfig, gen) -> tuple[dict, dict]:
    dtype = _dtype(cfg.param_dtype)
    bag = ParamBag(gen)
    bag.dense("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
              dtype, scale=1.0)
    if not cfg.tie_embeddings:
        bag.dense("head", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                  dtype)
    if cfg.vlm is not None:
        bag.dense("img_proj", (cfg.d_model, cfg.d_model),
                  ("img_in", "embed"), dtype)
    kinds = _layer_kinds(cfg)
    n_prefix = _n_prefix(cfg)
    tail_kind = kinds[-1] if kinds else "dense"
    for i in range(n_prefix):
        p, lg = _init_decoder_layer(gen, cfg, dtype, "dense")
        bag.params[f"layer{i}"] = p
        bag.logical[f"layer{i}"] = lg
    _layer_stack(bag, "layers", lambda: _init_decoder_layer(
        gen, cfg, dtype, tail_kind), cfg.num_layers - n_prefix)
    init_norm(bag, "final_norm", cfg.d_model, cfg.norm, dtype)
    return bag.done()


def _decoder_block(p: dict, x: Tensor, positions: Tensor, cfg: ModelConfig,
                   mesh, window: int, cache, kind: str, collect_kv: bool,
                   seq_axes=()) -> tuple[Tensor, Optional[dict], Tensor]:
    attn_fn = (attn_mod.mla_attention if cfg.mla is not None
               else attn_mod.gqa_attention)
    x = _pin_batch(x, cfg, mesh)
    h = apply_norm(p["attn_norm"], x, cfg.norm)
    a, new_cache = attn_fn(p["attn"], h, positions, cfg, window=window,
                           cache=cache, collect_kv=collect_kv, mesh=mesh,
                           seq_axes=seq_axes)
    if cfg.post_norm:
        a = apply_norm(p["post_attn_norm"], a, cfg.norm)
    x = x + a
    h = apply_norm(p["mlp_norm"], x, cfg.norm)
    aux = x.new_zeros((), dtype=torch.float32)
    if kind == "moe":
        m, aux = moe_mod.moe_block(p["moe"], h, cfg, mesh)
        if "shared_mlp" in p:
            m = m + mlp(p["shared_mlp"], h, cfg.mlp_act, mesh,
                        cfg.moe.num_shared_experts * cfg.moe.d_ff_shared)
    else:
        m = mlp(p["mlp"], h, cfg.mlp_act, mesh, cfg.d_ff)
    if cfg.post_norm:
        m = apply_norm(p["post_mlp_norm"], m, cfg.norm)
    return _pin_batch(x + m, cfg, mesh), new_cache, aux


def _decoder_backbone(params: dict, x: Tensor, positions: Tensor,
                      cfg: ModelConfig, mesh, caches: Optional[dict],
                      collect_kv: bool, seq_axes=()
                      ) -> tuple[Tensor, Optional[dict], Tensor]:
    """Runs the prefix layers, then the homogeneous tail."""
    kinds = _layer_kinds(cfg)
    windows = layer_windows(cfg)
    n_prefix = len([k for k in params if k.startswith("layer")
                    and k[5:].isdigit()])
    aux_total = x.new_zeros((), dtype=torch.float32)
    new_prefix_caches = {}
    for i in range(n_prefix):
        cache_i = caches[f"layer{i}"] if caches is not None else None
        x, nc, aux = _decoder_block(params[f"layer{i}"], x, positions, cfg,
                                    mesh, windows[i], cache_i, "dense",
                                    collect_kv, seq_axes)
        aux_total = aux_total + aux
        if nc is not None:
            new_prefix_caches[f"layer{i}"] = nc

    tail_kind = kinds[-1]

    def body(x, p, w, cache):
        return _decoder_block(p, x, positions, cfg, mesh, w, cache,
                              tail_kind, collect_kv, seq_axes)

    tail_caches = caches["layers"] if caches is not None else None
    x, new_tail, aux = _run_layers(body, x, params["layers"],
                                   windows[n_prefix:], tail_caches,
                                   cfg.remat_policy)
    aux_total = aux_total + aux
    new_caches = None
    if caches is not None or (collect_kv and new_tail is not None):
        new_caches = dict(new_prefix_caches)
        new_caches["layers"] = new_tail
    return x, new_caches, aux_total


def _lm_inputs(params: dict, batch: dict, cfg: ModelConfig, mesh=None
               ) -> tuple[Tensor, Tensor, Optional[Tensor]]:
    """Embed tokens (+ VLM image prefix). Returns (x, positions, labels)."""
    x = _embed(params, batch["tokens"], cfg, mesh)
    labels = batch.get("labels")
    if cfg.vlm is not None and "img_embeds" in batch:
        img = proj(batch["img_embeds"].to(x.dtype), params["img_proj"])
        x = torch.cat([img, x], dim=1)
        if labels is not None:
            pad = torch.full(img.shape[:2], -1, dtype=labels.dtype,
                             device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
    B, S = x.shape[:2]
    return x, _positions(B, S, x.device), labels


# ---------------------------------------------------------------------------
# whisper (audio enc-dec)
# ---------------------------------------------------------------------------

def _init_encdec(cfg: ModelConfig, gen) -> tuple[dict, dict]:
    dtype = _dtype(cfg.param_dtype)
    bag = ParamBag(gen)
    bag.dense("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
              dtype, scale=1.0)
    bag.dense("frame_proj", (cfg.d_model, cfg.d_model), ("img_in", "embed"),
              dtype)

    def enc_layer():
        b = ParamBag(gen)
        attn_mod.init_gqa(b, cfg, dtype)
        init_norm(b, "attn_norm", cfg.d_model, cfg.norm, dtype)
        init_mlp(b, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
        init_norm(b, "mlp_norm", cfg.d_model, cfg.norm, dtype)
        return b.done()

    def dec_layer():
        b = ParamBag(gen)
        attn_mod.init_gqa(b, cfg, dtype)
        init_norm(b, "attn_norm", cfg.d_model, cfg.norm, dtype)
        attn_mod.init_cross_attn(b, cfg, dtype)
        init_norm(b, "xattn_norm", cfg.d_model, cfg.norm, dtype)
        init_mlp(b, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)
        init_norm(b, "mlp_norm", cfg.d_model, cfg.norm, dtype)
        return b.done()

    _layer_stack(bag, "enc_layers", enc_layer, cfg.encdec.encoder_layers)
    _layer_stack(bag, "dec_layers", dec_layer, cfg.num_layers)
    init_norm(bag, "enc_norm", cfg.d_model, cfg.norm, dtype)
    init_norm(bag, "final_norm", cfg.d_model, cfg.norm, dtype)
    return bag.done()


def _whisper_encode(params: dict, frames: Tensor, cfg: ModelConfig,
                    mesh=None) -> Tensor:
    """frames: (B, T, d) precomputed stub embeddings -> encoder output."""
    x = proj(frames.to(_dtype(cfg.dtype)), params["frame_proj"])
    B, T = x.shape[:2]
    pos = _positions(B, T, x.device)

    def body(x, p, w, _):
        h = apply_norm(p["attn_norm"], x, cfg.norm)
        a, _ = attn_mod.gqa_attention(p["attn"], h, pos, cfg, window=w,
                                      causal=False, mesh=mesh)
        x = x + a
        h = apply_norm(p["mlp_norm"], x, cfg.norm)
        return (x + mlp(p["mlp"], h, cfg.mlp_act, mesh, cfg.d_ff), None,
                x.new_zeros((), dtype=torch.float32))

    layers = params["enc_layers"]
    windows = (attn_mod.GLOBAL_WINDOW,) * len(layers)
    x, _, _ = _run_layers(body, x, layers, windows, None, cfg.remat_policy)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _whisper_decode_stack(params: dict, x: Tensor, positions: Tensor,
                          cfg: ModelConfig, enc_out: Optional[Tensor],
                          caches: Optional[dict], collect_kv: bool,
                          mesh=None, seq_axes=()
                          ) -> tuple[Tensor, Optional[dict]]:
    """Decoder layers.  Cross-attention K/V come from ``enc_out`` during
    train/prefill (computed per layer) and from the cache during decode.

    ``caches`` is the stacked dict {"self": {k,v}, "cross_k", "cross_v"}
    with a leading decoder-layer dim.  In decode only the self cache is
    re-emitted per layer; the static cross K/V are merged back after.
    """
    def body(x, p, w, cache):
        self_cache = cache["self"] if cache is not None else None
        h = apply_norm(p["attn_norm"], x, cfg.norm)
        a, new_self = attn_mod.gqa_attention(p["attn"], h, positions, cfg,
                                             window=w, cache=self_cache,
                                             collect_kv=collect_kv,
                                             mesh=mesh, seq_axes=seq_axes)
        x = x + a
        h = apply_norm(p["xattn_norm"], x, cfg.norm)
        if cache is not None:
            kv = (cache["cross_k"], cache["cross_v"])
        else:
            kv = attn_mod.encode_cross_kv(p["xattn"], enc_out, cfg, mesh)
        x = x + attn_mod.cross_attention(p["xattn"], h, kv, cfg, mesh)
        h = apply_norm(p["mlp_norm"], x, cfg.norm)
        x = x + mlp(p["mlp"], h, cfg.mlp_act, mesh, cfg.d_ff)
        new_cache = None
        if cache is not None:
            new_cache = {"self": new_self}
        elif collect_kv:
            new_cache = {"self": new_self, "cross_k": kv[0], "cross_v": kv[1]}
        return x, new_cache, x.new_zeros((), dtype=torch.float32)

    layers = params["dec_layers"]
    windows = (attn_mod.GLOBAL_WINDOW,) * len(layers)
    x, new_caches, _ = _run_layers(body, x, layers, windows, caches,
                                   cfg.remat_policy)
    if caches is not None:
        new_caches = {"self": new_caches["self"],
                      "cross_k": caches["cross_k"],
                      "cross_v": caches["cross_v"]}
    return x, new_caches


# ---------------------------------------------------------------------------
# mamba2 (ssm) and zamba2 (hybrid)
# ---------------------------------------------------------------------------

def _init_ssm_layer(gen, cfg: ModelConfig, dtype) -> tuple[dict, dict]:
    bag = ParamBag(gen)
    ssm_mod.init_ssm(bag, cfg, dtype)
    init_norm(bag, "norm", cfg.d_model, cfg.norm, dtype)
    return bag.done()


def _init_mamba(cfg: ModelConfig, gen) -> tuple[dict, dict]:
    dtype = _dtype(cfg.param_dtype)
    bag = ParamBag(gen)
    bag.dense("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
              dtype, scale=1.0)
    if not cfg.tie_embeddings:
        bag.dense("head", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                  dtype)
    _layer_stack(bag, "layers", lambda: _init_ssm_layer(gen, cfg, dtype),
                 cfg.num_layers)
    init_norm(bag, "final_norm", cfg.d_model, cfg.norm, dtype)
    return bag.done()


def _ssm_stack(layers: list, x: Tensor, cfg: ModelConfig, caches,
               collect_kv: bool, policy: str, mesh=None):
    def body(x, p, w, cache):
        h = apply_norm(p["norm"], x, cfg.norm)
        y, nc = ssm_mod.ssm_block(p["ssm"], h, cfg, cache,
                                  collect_state=collect_kv, mesh=mesh)
        return x + y, nc, x.new_zeros((), dtype=torch.float32)

    windows = (0,) * len(layers)                  # unused by ssm
    x, new_caches, _ = _run_layers(body, x, layers, windows, caches, policy)
    return x, new_caches


def _init_zamba(cfg: ModelConfig, gen) -> tuple[dict, dict]:
    dtype = _dtype(cfg.param_dtype)
    bag = ParamBag(gen)
    bag.dense("embed", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
              dtype, scale=1.0)
    _layer_stack(bag, "layers", lambda: _init_ssm_layer(gen, cfg, dtype),
                 cfg.num_layers)
    shared = bag.sub("shared")
    attn_mod.init_gqa(shared, cfg, dtype)
    init_norm(shared, "attn_norm", cfg.d_model, cfg.norm, dtype)
    init_mlp(shared, cfg.d_model, cfg.hybrid.shared_attn_d_ff, cfg.mlp_act,
             dtype)
    init_norm(shared, "mlp_norm", cfg.d_model, cfg.norm, dtype)
    init_norm(bag, "final_norm", cfg.d_model, cfg.norm, dtype)
    return bag.done()


def n_attn_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.hybrid.attn_every


def _shared_attn_block(shared: dict, x: Tensor, positions: Tensor,
                       cfg: ModelConfig, cache, collect_kv: bool, mesh=None,
                       seq_axes=()) -> tuple[Tensor, Optional[dict]]:
    h = apply_norm(shared["attn_norm"], x, cfg.norm)
    a, new_cache = attn_mod.gqa_attention(shared["attn"], h, positions, cfg,
                                          cache=cache, collect_kv=collect_kv,
                                          mesh=mesh, seq_axes=seq_axes)
    x = x + a
    h = apply_norm(shared["mlp_norm"], x, cfg.norm)
    return (x + mlp(shared["mlp"], h, cfg.mlp_act, mesh,
                    cfg.hybrid.shared_attn_d_ff), new_cache)


def _zamba_backbone(params: dict, x: Tensor, positions: Tensor,
                    cfg: ModelConfig, caches: Optional[dict],
                    collect_kv: bool, mesh=None, seq_axes=()
                    ) -> tuple[Tensor, Optional[dict]]:
    """Groups of ``attn_every`` ssm layers, each followed by the shared
    attention block, ``n_sites`` times; trailing ssm layers close the
    stack.  caches = {"ssm": stacked (L, ...), "attn": stacked
    (n_sites, ...)}."""
    every = cfg.hybrid.attn_every
    L = cfg.num_layers
    sites = n_attn_sites(cfg)
    body_n = sites * every
    layers = params["layers"]
    new_ssm, new_attn = [], []
    for g in range(sites):
        lo, hi = g * every, (g + 1) * every
        g_ssm = (_map(lambda a: a[lo:hi], caches["ssm"])
                 if caches is not None else None)
        g_attn = _index(caches["attn"], g) if caches is not None else None
        x, nc = _ssm_stack(layers[lo:hi], x, cfg, g_ssm, collect_kv,
                           cfg.remat_policy, mesh)
        new_ssm.append(nc)
        x, na = _shared_attn_block(params["shared"], x, positions, cfg,
                                   g_attn, collect_kv, mesh, seq_axes)
        new_attn.append(na)
    if body_n < L:
        tail = (_map(lambda a: a[body_n:], caches["ssm"])
                if caches is not None else None)
        x, nc = _ssm_stack(layers[body_n:], x, cfg, tail, collect_kv,
                           cfg.remat_policy, mesh)
        new_ssm.append(nc)
    if caches is None and not collect_kv:
        return x, None
    ssm_all = new_ssm[0]
    for part in new_ssm[1:]:
        ssm_all = _cat(ssm_all, part)
    return x, {"ssm": ssm_all, "attn": _stack(new_attn)}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

_INITS = {"dense": _init_decoder_lm, "moe": _init_decoder_lm,
          "vlm": _init_decoder_lm, "audio": _init_encdec,
          "ssm": _init_mamba, "hybrid": _init_zamba}


def init_model(cfg: ModelConfig, generator: torch.Generator
               ) -> tuple[ParamTree, dict]:
    """The model's parameters drawn from ``generator``, on its device, and
    the logical-axes tree of the reference's structure and names."""
    if cfg.family not in _INITS:
        raise ValueError(f"unknown family {cfg.family!r}")
    params, logical = _INITS[cfg.family](cfg, generator)
    return ParamTree(params), logical


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: shapes and
    dtypes, no storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_abstract(cfg: ModelConfig) -> tuple[ParamTree, dict]:
    """:func:`init_model` on the ``meta`` device: every parameter's shape
    and dtype, with no allocation (a 236e9-parameter config included)."""
    return init_model(cfg, _MetaGenerator())


def _backbone_hidden(params: dict, batch: dict, cfg: ModelConfig, mesh,
                     caches, collect_kv: bool):
    """Family dispatch: returns (hidden (B,S,d) normed, caches, aux,
    labels)."""
    aux = None
    if cfg.family in ("dense", "moe", "vlm"):
        x, positions, labels = _lm_inputs(params, batch, cfg, mesh)
        x, new_caches, aux = _decoder_backbone(params, x, positions, cfg,
                                               mesh, caches, collect_kv)
    elif cfg.family == "audio":
        tokens = batch["tokens"]
        labels = batch.get("labels")
        x = _embed(params, tokens, cfg, mesh)
        B, S = x.shape[:2]
        enc_out = (_whisper_encode(params, batch["frames"], cfg, mesh)
                   if "frames" in batch else None)
        x, new_caches = _whisper_decode_stack(
            params, x, _positions(B, S, x.device), cfg, enc_out, caches,
            collect_kv, mesh)
    elif cfg.family == "ssm":
        x = _embed(params, batch["tokens"], cfg, mesh)
        labels = batch.get("labels")
        ssm_caches = caches["ssm"] if caches is not None else None
        x, new_ssm = _ssm_stack(params["layers"], x, cfg, ssm_caches,
                                collect_kv, cfg.remat_policy, mesh)
        new_caches = {"ssm": new_ssm} if new_ssm is not None else None
    elif cfg.family == "hybrid":
        x = _embed(params, batch["tokens"], cfg, mesh)
        labels = batch.get("labels")
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = _positions(B, S, x.device)
        x, new_caches = _zamba_backbone(params, x, positions, cfg, caches,
                                        collect_kv, mesh)
    else:
        raise ValueError(cfg.family)
    if aux is None:
        aux = x.new_zeros((), dtype=torch.float32)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return x, new_caches, aux, labels


def loss_fn(model, batch: dict, cfg: ModelConfig, mesh=None
            ) -> tuple[Tensor, Metrics]:
    """Training loss (next-token CE + MoE aux) of ``batch`` (this rank's
    shard on a mesh)."""
    params = model.tree()
    x, _, aux, labels = _backbone_hidden(params, batch, cfg, mesh, None,
                                         False)
    ce, n = _chunked_ce(params, x, labels, cfg, mesh)
    loss = ce
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss, Metrics(loss=loss, ce=ce, aux=aux, n_tokens=n)


def prefill_step(model, batch: dict, cfg: ModelConfig, mesh=None
                 ) -> tuple[Tensor, dict]:
    """Run the full prompt, return (last-position logits (B,V), cache)."""
    params = model.tree()
    x, caches, _, _ = _backbone_hidden(params, batch, cfg, mesh, None, True)
    return _head_logits(params, x[:, -1, :], cfg, mesh), caches


def decode_step(model, cache: dict, batch: dict, cfg: ModelConfig,
                mesh=None, seq_axes=()) -> tuple[Tensor, dict]:
    """One-token decode.  batch = {"tokens": (B,1), "positions": (B,1)}.
    On a mesh the self-attention caches may split their sequence over
    ``seq_axes`` (``launch.input_specs.decode_seq_axes``; see
    ``models.attention``)."""
    params = model.tree()
    tokens, positions = batch["tokens"], batch["positions"]
    x = _embed(params, tokens, cfg, mesh)
    if cfg.family in ("dense", "moe", "vlm"):
        x, new_caches, _ = _decoder_backbone(params, x, positions, cfg,
                                             mesh, cache, collect_kv=False,
                                             seq_axes=seq_axes)
    elif cfg.family == "audio":
        x, new_caches = _whisper_decode_stack(params, x, positions, cfg,
                                              None, cache, collect_kv=False,
                                              mesh=mesh, seq_axes=seq_axes)
    elif cfg.family == "ssm":
        x, new_ssm = _ssm_stack(params["layers"], x, cfg, cache["ssm"],
                                False, cfg.remat_policy, mesh)
        new_caches = {"ssm": new_ssm}
    elif cfg.family == "hybrid":
        x, new_caches = _zamba_backbone(params, x, positions, cfg, cache,
                                        collect_kv=False, mesh=mesh,
                                        seq_axes=seq_axes)
    else:
        raise ValueError(cfg.family)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _head_logits(params, x[:, -1, :], cfg, mesh), new_caches


def pad_cache_to(cache: dict, cfg: ModelConfig, max_seq: int) -> dict:
    """Pad the sequence axis of attention caches from prefill length S to
    ``max_seq`` so decode can append tokens at positions >= S.

    SSM states and whisper cross-attention K/V have no growable axis and
    are left untouched.
    """
    def pad(tree, axis):
        def f(a):
            if a.shape[axis] >= max_seq:
                return a
            widths = [0, 0] * (a.dim() - axis - 1) + [0, max_seq -
                                                      a.shape[axis]]
            return F.pad(a, widths)
        return _map(f, tree)

    if cfg.family in ("dense", "moe", "vlm"):
        return {k: pad(v, 2 if k == "layers" else 1)
                for k, v in cache.items()}
    if cfg.family == "audio":
        return {"self": pad(cache["self"], 2),
                "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
    if cfg.family == "ssm":
        return cache
    if cfg.family == "hybrid":
        return {"ssm": cache["ssm"], "attn": pad(cache["attn"], 2)}
    raise ValueError(cfg.family)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Zeroed decode cache for every family, on ``device`` (default: the
    card)."""
    from repro_torch._device import resolve_device
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg.dtype)

    def stacked(n, one):
        return _map(lambda a: torch.zeros((n,) + tuple(a.shape),
                                          dtype=a.dtype, device=device), one)

    if cfg.family in ("dense", "moe", "vlm"):
        make = (attn_mod.init_mla_cache if cfg.mla is not None
                else attn_mod.init_gqa_cache)
        one = make(cfg, batch, max_seq, dtype, device)
        kinds = _layer_kinds(cfg)
        n_prefix = (0 if cfg.moe is None
                    else next((i for i, k in enumerate(kinds) if k == "moe"),
                              0))
        cache: dict[str, Any] = {f"layer{i}": _map(torch.clone, one)
                                 for i in range(n_prefix)}
        cache["layers"] = stacked(cfg.num_layers - n_prefix, one)
        return cache
    if cfg.family == "audio":
        h, hd = cfg.num_heads, cfg.resolved_head_dim
        L = cfg.num_layers
        cross = (L, batch, max_seq, h, hd)
        return {"self": stacked(L, attn_mod.init_gqa_cache(
                    cfg, batch, max_seq, dtype, device)),
                "cross_k": torch.zeros(cross, dtype=dtype, device=device),
                "cross_v": torch.zeros(cross, dtype=dtype, device=device)}
    if cfg.family == "ssm":
        return {"ssm": stacked(cfg.num_layers, ssm_mod.init_ssm_cache(
            cfg, batch, dtype, device))}
    if cfg.family == "hybrid":
        return {"ssm": stacked(cfg.num_layers, ssm_mod.init_ssm_cache(
                    cfg, batch, dtype, device)),
                "attn": stacked(n_attn_sites(cfg), attn_mod.init_gqa_cache(
                    cfg, batch, max_seq, dtype, device))}
    raise ValueError(cfg.family)
