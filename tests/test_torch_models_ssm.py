"""The port's Mamba2 (ssm), Zamba2 (hybrid) and whisper (audio) models
against the reference's (``repro.models``, JAX on the CPU), with the
bounds of tests/test_torch_models.py: the reference's params carried over
by ``bridge.model_params``; loss within 1e-5 relative, every gradient leaf
within 1e-4 of its max |g|, prefill and decode logits within 1e-4 of max
|logit|, cache shapes and the logical-axes tree equal
(tests/torch_lm_ref.py); tests/test_models_smoke.py's per-arch cases on
the port's own init.  The chunked SSD scan and its pieces are held to the
reference's on the same inputs, the padded final state included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as RS
import torch_lm_ref as L
from repro.configs import get_arch as ref_get_arch
from repro_torch.configs import get_arch
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ARCHS = ["mamba2-780m", "whisper-base", "zamba2-1.2b"]


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


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("S,L_chunk", [(64, 16), (48, 16), (32, 32)])
def test_ssd_chunked_matches_reference(S, L_chunk):
    """_ssd_chunked on the same (xd, a, B, C), zero-padded to a chunk
    multiple as ``ssm_block`` pads a ragged S: y and the final state."""
    rng = np.random.default_rng(S + L_chunk)
    Bsz, H, P, G, N = 2, 4, 8, 2, 16
    pad = (-S) % L_chunk
    xd = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    a = -np.abs(rng.standard_normal((Bsz, S, H))).astype(np.float32) * 0.3
    Bm = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((Bsz, S, G, N)).astype(np.float32)
    padded = [np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
              for v in (xd, a, Bm, Cm)]
    y_ref, h_ref = RS._ssd_chunked(*map(jnp.asarray, padded), L_chunk)
    y, h = TS._ssd_chunked(*map(_t, padded), L_chunk)
    assert L.rel_err(y.numpy(), y_ref) <= 1e-5
    assert L.rel_err(h.numpy(), h_ref) <= 1e-5


def test_conv_and_gated_norm_match_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 20, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    ref = RS._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b))
    got = TS._causal_depthwise_conv(_t(x), _t(w), _t(b))
    assert L.rel_err(got.numpy(), ref) <= 1e-6
    z = rng.standard_normal((2, 20, 24)).astype(np.float32)
    ref = RS._gated_rmsnorm(jnp.asarray(x), jnp.asarray(z), jnp.asarray(b))
    got = TS._gated_rmsnorm(_t(x), _t(z), _t(b))
    assert L.rel_err(got.numpy(), ref) <= 1e-6


def test_ssm_state_carries_across_a_split_prompt():
    """A prefill of S tokens, then its state decoding one token at a time,
    gives the full prefill's last logits (the chunked scan and the
    recurrence agree)."""
    cfg, model, _ = L.port_model("mamba2-780m")
    full = L.port_batch(cfg, seq=40, labels=False)
    with torch.no_grad():
        want, _ = TM.prefill_step(model, full, cfg)
        _, cache = TM.prefill_step(model, dict(tokens=full["tokens"][:, :36]),
                                   cfg)
        for j in range(36, 40):
            got, cache = TM.decode_step(model, cache, {
                "tokens": full["tokens"][:, j:j + 1],
                "positions": torch.full((2, 1), j, dtype=torch.int32)}, cfg)
    assert L.rel_err(got.numpy(), want.numpy()) < 1e-4


def test_zamba_shared_block_is_shared():
    """zamba2's one attention+MLP block serves every site: its gradient
    sums over the sites, and the model holds it once."""
    cfg = get_arch("zamba2-1.2b").reduced()
    assert TM.n_attn_sites(cfg) == cfg.num_layers // cfg.hybrid.attn_every
    ref_cfg = ref_get_arch("zamba2-1.2b").reduced()
    assert TM.n_attn_sites(cfg) == ref_cfg.num_layers // \
        ref_cfg.hybrid.attn_every
    _, model, _ = L.port_model("zamba2-1.2b")
    names = [n for n, _ in model.named_parameters() if ".attn." in n]
    assert names and all(n.startswith("shared.") for n in names)
