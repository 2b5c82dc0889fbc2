"""The port's decoder LMs (dense, moe, vlm) against the reference's
(``repro.models``, JAX on the CPU).

For each reduced config the reference's ``init_model`` params are carried
over by ``bridge.model_params`` and the port is held to the reference on
the same batch (tests/torch_lm_ref.py): the loss and the MoE aux within
1e-5 relative, every gradient leaf within 1e-4 of that leaf's max |g|,
the prefill logits and the decode logits after ``pad_cache_to`` within
1e-4 of max |logit|, the cache shapes equal, the logical-axes tree equal
in structure and names.  tests/test_models_smoke.py's cases run on the
port's own init at that test's bounds; tests/test_perf_variants.py's
attention cases (:28-96) run on the port at that test's bounds and are
held to the reference at 1e-5 as well.  The MoE dispatch is held to the
reference's on handed-over router probabilities: the same expert ids,
and on the same gates the same slot tables, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import torch_lm_ref as L
from repro.configs import get_arch as ref_get_arch
from repro.models import model as RM
from repro.models.layers import ParamBag as RefBag
from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

ARCHS = ["deepseek-v2-236b", "gemma-7b", "gemma2-9b", "llava-next-34b",
         "olmoe-1b-7b", "stablelm-1.6b", "starcoder2-15b"]
VARIANT_TOL = 1e-5        # each port variant against the reference's


# --- the port against the reference, on the reference's params -------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    L.check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    L.check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(arch):
    L.check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_match_reference(arch):
    L.check_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_reference(arch):
    L.check_cache_shapes(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_match_reference(arch):
    L.check_logical(arch)


# --- tests/test_models_smoke.py on the port ---------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_finite(arch):
    L.check_forward_loss_finite(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_finite_grads(arch):
    L.check_train_step_finite_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    L.check_prefill_decode_consistency(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes(arch):
    L.check_init_cache(arch)


def test_gemma2_local_global_windows():
    w = np.asarray(TM.layer_windows(get_arch("gemma2-9b")))
    assert w.shape == (42,)
    assert w[0] == 4096 and w[1] == A.GLOBAL_WINDOW
    assert (w[0::2] == 4096).all() and (w[1::2] == A.GLOBAL_WINDOW).all()
    ref = np.asarray(RM.layer_windows(ref_get_arch("gemma2-9b")))
    np.testing.assert_array_equal(w, ref)


def test_chunked_attention_matches_full():
    cfg, model, _ = L.port_model("stablelm-1.6b")
    batch = L.port_batch(cfg)
    with torch.no_grad():
        l1, _ = TM.loss_fn(model, batch, dataclasses.replace(
            cfg, attn_impl="chunked", q_chunk=8))
        l2, _ = TM.loss_fn(model, batch, dataclasses.replace(
            cfg, attn_impl="full"))
    assert abs(float(l1) - float(l2)) < 1e-3


def test_chunked_ce_matches_unchunked():
    cfg, model, _ = L.port_model("stablelm-1.6b")
    batch = L.port_batch(cfg)
    with torch.no_grad():
        l1, _ = TM.loss_fn(model, batch, dataclasses.replace(cfg, ce_chunk=8))
        l2, _ = TM.loss_fn(model, batch, dataclasses.replace(cfg, ce_chunk=0))
    assert abs(float(l1) - float(l2)) < 1e-3


def test_sliding_window_masks_long_range():
    """A local layer cannot see past its window."""
    from repro_torch.models.layers import ParamBag
    cfg = get_arch("gemma2-9b").reduced(sliding_window=4, num_layers=1)
    bag = ParamBag(torch.Generator().manual_seed(0))
    A.init_gqa(bag, cfg, torch.float32)
    p = bag.params["attn"]
    x = torch.randn((1, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(16)[None]
    with torch.no_grad():
        out1, _ = A.gqa_attention(p, x, pos, cfg, window=4)
        x2 = x.clone()
        x2[0, 0] += 10.0
        out2, _ = A.gqa_attention(p, x2, pos, cfg, window=4)
    np.testing.assert_allclose(out1[0, 4:].numpy(), out2[0, 4:].numpy(),
                               atol=1e-5)
    assert float((out1[0, :4] - out2[0, :4]).abs().max()) > 1e-3


# --- tests/test_perf_variants.py's attention cases on the port --------------

@pytest.fixture(scope="module")
def attn_setup():
    """One gemma2 attention layer (window 16) on the reference's params and
    input, for both packages."""
    rcfg = ref_get_arch("gemma2-9b").reduced(sliding_window=16, num_layers=1)
    bag = RefBag(jax.random.PRNGKey(0))
    RA.init_gqa(bag, rcfg, jnp.float32)
    rp = bag.params["attn"]
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 64, rcfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(64)[None], (2, 64))
    cfg = get_arch("gemma2-9b").reduced(sliding_window=16, num_layers=1)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return (rcfg, rp, x, pos), (cfg, tp, torch.from_numpy(np.array(x)),
                                torch.from_numpy(np.array(pos)))


@pytest.mark.parametrize("window", [A.GLOBAL_WINDOW, 16])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("q_chunk", [16, 32])
def test_online_softmax_matches_full(attn_setup, window, cap, q_chunk):
    (rcfg, rp, rx, rpos), (cfg, p, x, pos) = attn_setup
    c_full = dataclasses.replace(cfg, attn_impl="full",
                                 attn_logit_softcap=cap)
    c_onl = dataclasses.replace(cfg, attn_impl="online", q_chunk=q_chunk,
                                attn_logit_softcap=cap)
    with torch.no_grad():
        o1, _ = A.gqa_attention(p, x, pos, c_full, window=window)
        o2, _ = A.gqa_attention(p, x, pos, c_onl, window=window)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=2e-5)
    r_onl = dataclasses.replace(rcfg, attn_impl="online", q_chunk=q_chunk,
                                attn_logit_softcap=cap)
    ref, _ = RA.gqa_attention(rp, rx, rpos, r_onl, window=window)
    assert L.rel_err(o2.numpy(), ref) <= VARIANT_TOL


def test_online_softmax_grads_match(attn_setup):
    (rcfg, rp, rx, rpos), (cfg, p, x, pos) = attn_setup
    c_full = dataclasses.replace(cfg, attn_impl="full")
    c_onl = dataclasses.replace(cfg, attn_impl="online", q_chunk=16)

    def grad(impl_cfg):
        xx = x.clone().requires_grad_(True)
        out, _ = A.gqa_attention(p, xx, pos, impl_cfg)
        return torch.autograd.grad((out ** 2).sum(), xx)[0].numpy()

    g1, g2 = grad(c_full), grad(c_onl)
    np.testing.assert_allclose(g1, g2, rtol=1e-3, atol=1e-3)
    r_onl = dataclasses.replace(rcfg, attn_impl="online", q_chunk=16)
    ref = jax.grad(lambda xx: jnp.sum(
        RA.gqa_attention(rp, xx, rpos, r_onl)[0] ** 2))(rx)
    assert L.rel_err(g2, ref) <= VARIANT_TOL


def test_dus_cache_update_matches_blend(attn_setup):
    (rcfg, rp, rx, _), (cfg, p, x, _) = attn_setup
    cache = A.init_gqa_cache(cfg, 2, 64, torch.float32, device="cpu")
    tok, tpos = x[:, 10:11], torch.full((2, 1), 10, dtype=torch.int32)
    with torch.no_grad():
        _, c1 = A.gqa_attention(p, tok, tpos, cfg, cache=cache)
        _, c2 = A.gqa_attention(
            p, tok, tpos, dataclasses.replace(cfg, cache_update="dus"),
            cache=cache)
    rcache = RA.init_gqa_cache(rcfg, 2, 64, jnp.float32)
    _, rc = RA.gqa_attention(rp, rx[:, 10:11], jnp.full((2, 1), 10,
                                                        jnp.int32),
                             dataclasses.replace(rcfg, cache_update="dus"),
                             cache=rcache)
    for k in ("k", "v"):
        np.testing.assert_array_equal(c1[k].numpy(), c2[k].numpy())
        assert L.rel_err(c2[k].numpy(), rc[k]) <= VARIANT_TOL


def test_online_impl_full_model_loss():
    ref = L.reference("gemma-7b")
    cfg = get_arch("gemma-7b").reduced()
    model = L.port("gemma-7b")["model"]
    batch = L.to_torch(ref["batch"])
    with torch.no_grad():
        l_full, _ = TM.loss_fn(model, batch,
                               dataclasses.replace(cfg, attn_impl="full"))
        l_onl, _ = TM.loss_fn(model, batch, dataclasses.replace(
            cfg, attn_impl="online", q_chunk=16))
    assert abs(float(l_full) - float(l_onl)) < 1e-3
    rcfg = dataclasses.replace(ref_get_arch("gemma-7b").reduced(),
                               attn_impl="online", q_chunk=16)
    r_onl, _ = RM.loss_fn(jax.tree.map(jnp.asarray, ref["params"]),
                          jax.tree.map(jnp.asarray, ref["batch"]), rcfg)
    assert abs(float(l_onl) - float(r_onl)) <= VARIANT_TOL * abs(float(r_onl))


@pytest.mark.parametrize("policy", ["none", "dots", "nothing"])
def test_remat_policies_same_loss(policy):
    """Each remat policy gives finite grads, and the reference's loss and
    gradients (its default policy) at the parity bounds."""
    ref = L.reference("stablelm-1.6b")
    cfg = get_arch("stablelm-1.6b").reduced(remat_policy=policy)
    model = L.port("stablelm-1.6b")["model"]
    loss, _ = TM.loss_fn(model, L.to_torch(ref["batch"]), cfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert abs(float(loss.detach()) - ref["loss"]) <= \
        L.LOSS_RTOL * abs(ref["loss"])
    from repro_torch import bridge
    got = bridge.reference_tree(dict(zip(named, grads)))
    for g, g_ref in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got)),
                        jax.tree.leaves(ref["grads"])):
        assert float(np.max(np.abs(g - g_ref))) <= \
            L.GRAD_TOL * float(np.max(np.abs(g_ref)))


# --- the MoE dispatch on the reference's router probabilities --------------

def _ref_dispatch(gates, eidx, E, C):
    """The slot tables of ``repro.models.moe._local_moe`` (:101-124, one
    device: every expert local), line for line."""
    T, k = eidx.shape
    flat_e = eidx.reshape(-1)
    flat_tok = jnp.repeat(jnp.arange(T), k)
    flat_gate = gates.reshape(-1)
    key = flat_e
    order = jnp.argsort(key, stable=True)
    sorted_e = key[order]
    counts = jnp.bincount(key, length=E + 1)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    slot = jnp.arange(T * k) - starts[sorted_e]
    keep = (sorted_e < E) & (slot < C)
    e_idx = jnp.where(keep, sorted_e, E)
    s_idx = jnp.where(keep, slot, C)
    tok = jnp.full((E + 1, C + 1), T, jnp.int32).at[e_idx, s_idx].set(
        flat_tok[order].astype(jnp.int32), mode="drop")
    gate = jnp.zeros((E + 1, C + 1), jnp.float32).at[e_idx, s_idx].set(
        flat_gate[order], mode="drop")
    return np.asarray(tok[:E, :C]), np.asarray(gate[:E, :C])


@pytest.mark.parametrize("T,E,k", [(64, 4, 2), (512, 64, 8), (300, 160, 6)])
def test_moe_dispatch_matches_reference(T, E, k):
    """At capacity 1.25: the port routes the reference's probabilities to
    the same experts; on the reference's gates it builds the same
    tok_for_slot and gate_for_slot tables, and so drops the same slots."""
    from repro.configs.base import MoEConfig
    rng = np.random.default_rng(T + E + k)
    logits = rng.standard_normal((T, E)).astype(np.float32) * 3.0
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, eidx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    moe = MoEConfig(num_experts=E, top_k=k, d_ff_expert=8)
    C = max(int(moe.capacity_factor * T * k / E), 8)
    assert TMoE.capacity(moe, T) == C
    tok_ref, gate_ref = _ref_dispatch(gates, eidx, E, C)
    assert (tok_ref == T).any()          # some slots dropped or empty
    t_gates, t_eidx = TMoE.route(torch.from_numpy(np.array(probs)), k)
    np.testing.assert_array_equal(t_eidx.numpy(), np.asarray(eidx))
    np.testing.assert_allclose(t_gates.numpy(), np.asarray(gates),
                               rtol=1e-6)
    tok, gate = TMoE.dispatch(torch.from_numpy(np.array(gates)),
                              torch.from_numpy(np.array(eidx)).long(), E, C)
    np.testing.assert_array_equal(tok.numpy(), tok_ref)
    np.testing.assert_array_equal(gate.numpy(), gate_ref)
    tok2, _ = TMoE.dispatch(t_gates, t_eidx, E, C)
    np.testing.assert_array_equal(tok2.numpy(), tok_ref)


# --- the layer primitives on the same inputs --------------------------------

@pytest.mark.parametrize("case", ["rmsnorm", "layernorm", "rope", "rope_25",
                                  "softcap", "activate", "causal_mask",
                                  "cross_entropy"])
def test_layer_primitives_match_reference(case):
    """repro_torch.models.layers against repro.models.layers: f32 norms,
    RoPE on the interleaved pairs of the first int(D·frac) dims (stablelm's
    25 %), softcap, the four activations, the windowed causal mask, the
    masked cross entropy."""
    import repro.models.layers as RL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, 4, 12)).astype(np.float32) * 3

    def both(ref_fn, port_fn, *args):
        ref = ref_fn(*(jnp.asarray(a) for a in args))
        got = port_fn(*(torch.from_numpy(np.array(a)) for a in args))
        return got, ref

    if case in ("rmsnorm", "layernorm"):
        p = {"scale": rng.standard_normal(12).astype(np.float32),
             "bias": rng.standard_normal(12).astype(np.float32)}
        got, ref = both(lambda a, s, b: RL.apply_norm(
            {"scale": s, "bias": b}, a, case), lambda a, s, b: TL.apply_norm(
            {"scale": s, "bias": b}, a, case), x, p["scale"], p["bias"])
        assert L.rel_err(got.numpy(), ref) <= 1e-6
    elif case.startswith("rope"):
        frac = 0.25 if case == "rope_25" else 1.0
        pos = np.arange(6, dtype=np.int32)[None].repeat(2, 0) + 5
        got, ref = both(lambda a, q: RL.apply_rope(a, q, 10000.0, frac),
                        lambda a, q: TL.apply_rope(a, q, 10000.0, frac),
                        x, pos)
        assert L.rel_err(got.numpy(), ref) <= 1e-6
        if frac < 1:        # int(12 * 0.25) = 3 -> 2 dims rotate
            np.testing.assert_array_equal(got[..., 2:].numpy(), x[..., 2:])
    elif case == "softcap":
        got, ref = both(lambda a: RL.softcap(a, 2.5),
                        lambda a: TL.softcap(a, 2.5), x)
        assert L.rel_err(got.numpy(), ref) <= 1e-6
        assert TL.softcap(torch.ones(2), None).tolist() == [1.0, 1.0]
    elif case == "activate":
        for kind in ("silu", "gelu", "gelu_mlp", "relu"):
            got, ref = both(lambda a: RL.activate(a, kind),
                            lambda a: TL.activate(a, kind), x)
            assert L.rel_err(got.numpy(), ref) <= 1e-6, kind
    elif case == "causal_mask":
        q = np.arange(9, dtype=np.int32)[None]
        for window in (None, 3):
            got, ref = both(lambda a, b: RL.causal_mask(a, b, window),
                            lambda a, b: TL.causal_mask(a, b, window), q, q)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        logits = rng.standard_normal((2, 5, 30)).astype(np.float32) * 4
        labels = rng.integers(0, 30, (2, 5)).astype(np.int32)
        labels[0, :2] = -1
        (got, n), (ref, rn) = both(RL.cross_entropy, TL.cross_entropy,
                                   logits, labels)
        assert int(n) == int(rn) == 8
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
