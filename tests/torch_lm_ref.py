"""Shared by the LM parity tests (tests/test_torch_models*.py): each reduced
architecture run once per process through the reference (``repro.models``,
JAX on the CPU) and once through the port with the reference's parameters
carried over by ``bridge.model_params``.

The batch is tests/test_models_smoke.py's (B = 2, S = 32, tokens from
PRNGKey(1), labels rolled by one, the vlm / audio stubs); the decode step
appends one token on the prefill cache padded by ``pad_cache_to``, at
capacity factor 100 for MoE configs (as that test does).  Results are
numpy arrays or floats, cached by arch name, so the parametrised cases of
one arch share one run of each package.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import model as RM
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import model as TM

B, S = 2, 32
LOSS_RTOL = 1e-5          # port vs reference loss, relative
GRAD_TOL = 1e-4           # each gradient leaf, a fraction of its max |g|
LOGIT_TOL = 1e-4          # prefill / decode logits, a fraction of max |logit|


def ref_batch(cfg, key, seq=S, labels=True) -> dict:
    """tests/test_models_smoke.py's ``_batch``."""
    tok = jax.random.randint(key, (B, seq), 0, cfg.vocab_size)
    batch = {"tokens": tok}
    if labels:
        batch["labels"] = jnp.roll(tok, -1, axis=1)
    if cfg.vlm is not None:
        batch["img_embeds"] = 0.02 * jax.random.normal(
            key, (B, cfg.vlm.num_image_tokens, cfg.d_model))
    if cfg.encdec is not None:
        batch["frames"] = 0.02 * jax.random.normal(key, (B, seq, cfg.d_model))
    return batch


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def big_capacity(cfg):
    """MoE configs at capacity factor 100: no token is dropped."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))


def image_tokens(cfg) -> int:
    return cfg.vlm.num_image_tokens if cfg.vlm is not None else 0


def shapes(tree):
    """The leaf shapes of a nested dict, as a nested dict of tuples."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-30))


@functools.lru_cache(maxsize=None)
def reference(arch: str) -> dict:
    """The reference's params, loss, gradients, prefill and decode on the
    reduced config."""
    cfg = ref_get_arch(arch).reduced()
    params, logical = RM.init_model(cfg, jax.random.PRNGKey(0))
    batch = ref_batch(cfg, jax.random.PRNGKey(1))
    (loss, met), grads = jax.value_and_grad(
        lambda p: RM.loss_fn(p, batch, cfg), has_aux=True)(params)
    c100 = big_capacity(cfg)
    prompt = ref_batch(c100, jax.random.PRNGKey(2), labels=False)
    logits, cache = RM.prefill_step(params, prompt, c100)
    cache = RM.pad_cache_to(cache, c100, S + 1 + image_tokens(cfg))
    step = {"tokens": jax.random.randint(jax.random.PRNGKey(3), (B, 1), 0,
                                         cfg.vocab_size),
            "positions": jnp.full((B, 1), S + image_tokens(cfg), jnp.int32)}
    dlogits, dcache = RM.decode_step(params, cache, step, c100)
    return dict(
        params=to_numpy(params), logical=logical, batch=to_numpy(batch),
        loss=float(loss), aux=float(met.aux), grads=to_numpy(grads),
        prompt=to_numpy(prompt), logits=np.asarray(logits),
        cache_shapes=jax.tree.map(lambda a: tuple(a.shape), cache),
        step=to_numpy(step), dlogits=np.asarray(dlogits),
        dcache_shapes=jax.tree.map(lambda a: tuple(a.shape), dcache),
        init_cache_shapes=jax.tree.map(
            lambda a: tuple(a.shape),
            jax.eval_shape(lambda: RM.init_cache(cfg, B, 64))))


@functools.lru_cache(maxsize=None)
def port(arch: str) -> dict:
    """The port on the reference's params and inputs."""
    ref = reference(arch)
    cfg = get_arch(arch).reduced()
    model = bridge.model_params(cfg, ref["params"], device="cpu")
    loss, met = TM.loss_fn(model, to_torch(ref["batch"]), cfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(named.items(), grads)}
    c100 = big_capacity(cfg)
    with torch.no_grad():
        logits, cache = TM.prefill_step(model, to_torch(ref["prompt"]), c100)
        cache = TM.pad_cache_to(cache, c100, S + 1 + image_tokens(cfg))
        dlogits, dcache = TM.decode_step(model, cache,
                                         to_torch(ref["step"]), c100)
    return dict(
        model=model, loss=float(loss.detach()), aux=float(met.aux.detach()),
        grads=jax.tree.map(lambda t: t.numpy(),
                           bridge.reference_tree(grads)),
        logits=logits.numpy(), cache_shapes=shapes(cache),
        dlogits=dlogits.numpy(), dcache_shapes=shapes(dcache),
        init_cache_shapes=shapes(TM.init_cache(cfg, B, 64, device="cpu")))


# --- the checks each test file parametrises over its archs ------------------

def check_loss(arch):
    ref, got = reference(arch), port(arch)
    assert abs(got["loss"] - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"])
    assert abs(got["aux"] - ref["aux"]) <= LOSS_RTOL * max(abs(ref["aux"]),
                                                           1e-30)


def check_grads(arch):
    ref, got = reference(arch), port(arch)
    assert (jax.tree_util.tree_structure(got["grads"])
            == jax.tree_util.tree_structure(ref["grads"]))
    paths = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    for (path, g_ref), g in zip(paths, jax.tree.leaves(got["grads"])):
        assert g.shape == g_ref.shape, path
        bound = GRAD_TOL * float(np.max(np.abs(g_ref)))
        assert float(np.max(np.abs(g - g_ref))) <= bound, (
            jax.tree_util.keystr(path), float(np.max(np.abs(g - g_ref))),
            bound)


def check_prefill(arch):
    ref, got = reference(arch), port(arch)
    assert got["logits"].shape == ref["logits"].shape
    assert rel_err(got["logits"], ref["logits"]) <= LOGIT_TOL


def check_decode(arch):
    ref, got = reference(arch), port(arch)
    assert got["dlogits"].shape == ref["dlogits"].shape
    assert rel_err(got["dlogits"], ref["dlogits"]) <= LOGIT_TOL


def check_cache_shapes(arch):
    ref, got = reference(arch), port(arch)
    assert got["cache_shapes"] == ref["cache_shapes"]
    assert got["dcache_shapes"] == ref["dcache_shapes"]
    assert got["init_cache_shapes"] == ref["init_cache_shapes"]


def check_logical(arch):
    cfg = get_arch(arch).reduced()
    _, logical = TM.init_model(cfg, torch.Generator().manual_seed(0))
    assert logical == reference(arch)["logical"]


# --- tests/test_models_smoke.py's per-arch cases on the port's own init ----

def port_model(arch, cfg=None):
    cfg = cfg or get_arch(arch).reduced()
    model, logical = TM.init_model(cfg, torch.Generator().manual_seed(0))
    return cfg, model, logical


def port_batch(cfg, seed=1, seq=S, labels=True):
    """The port's counterpart of ``ref_batch``, drawn with torch."""
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, seq), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": tok}
    if labels:
        batch["labels"] = torch.roll(tok, -1, dims=1)
    if cfg.vlm is not None:
        batch["img_embeds"] = 0.02 * torch.randn(
            (B, cfg.vlm.num_image_tokens, cfg.d_model), generator=g)
    if cfg.encdec is not None:
        batch["frames"] = 0.02 * torch.randn((B, seq, cfg.d_model),
                                             generator=g)
    return batch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_forward_loss_finite(arch):
    cfg, model, logical = port_model(arch)
    # logical axes mirror the params (the layer lists stacked)
    assert (jax.tree_util.tree_structure(bridge.reference_tree(model))
            == jax.tree_util.tree_structure(
                logical, is_leaf=lambda x: isinstance(x, tuple)))
    with torch.no_grad():
        loss, met = TM.loss_fn(model, port_batch(cfg), cfg)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(met.aux))


def check_train_step_finite_grads(arch):
    cfg, model, _ = port_model(arch)
    loss, _ = TM.loss_fn(model, port_batch(cfg), cfg)
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                allow_unused=True)
    flat = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in flat)
    assert any(float(g.abs().max()) > 0 for g in flat)


def check_prefill_decode_consistency(arch):
    """decode(prefill(S tokens), token S) == prefill(S+1 tokens) last
    logits, at capacity factor 100 for MoE configs."""
    cfg, model, _ = port_model(arch)
    cfg = big_capacity(cfg)
    full = port_batch(cfg, seq=S + 1, labels=False)
    part = dict(full, tokens=full["tokens"][:, :S])
    img = image_tokens(cfg)
    with torch.no_grad():
        want, _ = TM.prefill_step(model, full, cfg)
        _, cache = TM.prefill_step(model, part, cfg)
        cache = TM.pad_cache_to(cache, cfg, S + 1 + img)
        got, _ = TM.decode_step(model, cache, {
            "tokens": full["tokens"][:, S:S + 1],
            "positions": torch.full((B, 1), S + img, dtype=torch.int32)},
            cfg)
    assert rel_err(got.numpy(), want.numpy()) < 2e-2


def check_init_cache(arch):
    cfg = get_arch(arch).reduced()
    cache = TM.init_cache(cfg, B, 64, device="cpu")
    assert list(_leaves(cache))      # non-empty for every family
