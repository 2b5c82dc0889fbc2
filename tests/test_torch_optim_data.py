"""The port's optimizers, schedules, LM data, config registry and seeded
model init against the reference's (``repro.optim``, ``repro.data``,
``repro.configs``, ``repro.models``).

Optimizers: three AdamW and three SGD steps from the same params, grads
and state (the reference's state after one step, carried over by
``bridge.opt_state``) within 1e-6 relative of the reference; the
schedules equal at every step within f32 rounding; the clip's norm within
f32 rounding; tests/test_optim_data.py's optimizer, schedule and clip
cases on the port.  The LM batch is the port's own draw (torch cannot
reproduce JAX's): deterministic in (seed, step), labels the tokens
shifted by one, 5 % ± 1 % of the 8-gram stream flipped.  The registry's
configs equal the reference's, ``reduced()`` too, and ``cell_applicable``
answers as the reference's.  ``init_model`` draws every normal leaf with
the reference's std (within 5 %), and zeros and ones where the reference
puts them; one generator seed gives the same bits twice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import torch_lm_ref as L
from repro.configs.base import OptimConfig as RefOptimConfig
from repro.data import synthetic as RD
from repro.models import model as RM
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import make_schedule as ref_make_schedule
from repro.optim.optimizers import clip_by_global_norm as ref_clip
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.configs import OptimConfig
from repro_torch.data.synthetic import (LMBatchSpec, host_slice, lm_batch,
                                        spec_for)
from repro_torch.models import model as TM
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import clip_by_global_norm, global_norm

OPT_RTOL = 1e-6
ARCHS = sorted(RC.ARCHS)


# --- optimizers -------------------------------------------------------------

def _tree(rng):
    """A model-shaped params tree: a stacked layer axis and a scalar."""
    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": f32(16, 8), "layers": {"w": f32(2, 8, 8),
                                            "b": f32(2, 8)},
            "scale": f32()}


def _named(tree):
    return bridge.named_tensors(tree, device="cpu")


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(0)
    cfg = dict(name=name, lr=0.05, warmup_steps=2, total_steps=10,
               weight_decay=0.1, grad_clip=1.5)
    rinit, rupdate = ref_make_optimizer(RefOptimConfig(**cfg))
    _, update = make_optimizer(OptimConfig(**cfg))
    params = jax.tree.map(jnp.asarray, _tree(rng))
    state = rinit(params)
    grads = [jax.tree.map(jnp.asarray, _tree(rng)) for _ in range(4)]
    params, state, _ = rupdate(params, state, grads[0])
    t_params = _named(jax.tree.map(np.asarray, params))
    t_state = bridge.opt_state(jax.tree.map(
        lambda x: None if x is None else np.asarray(x), state,
        is_leaf=lambda x: x is None), device="cpu")
    for g in grads[1:]:
        params, state, rstats = rupdate(params, state, g)
        t_params, t_state, stats = update(t_params, t_state, _named(g))
    want = _named(jax.tree.map(np.asarray, params))
    for k, p in t_params.items():
        assert L.rel_err(p.numpy(), want[k].numpy()) <= OPT_RTOL, k
    assert int(t_state.step) == int(state.step) == 4
    for mine, ref in ((t_state.mu, state.mu), (t_state.nu, state.nu)):
        if ref is None:
            assert mine is None
            continue
        ref = _named(jax.tree.map(np.asarray, ref))
        for k, m in mine.items():
            assert m.dtype == torch.float32
            assert L.rel_err(m.numpy(), ref[k].numpy()) <= OPT_RTOL, k
    assert abs(float(stats["grad_norm"]) - float(rstats["grad_norm"])) <= \
        OPT_RTOL * float(rstats["grad_norm"])
    assert float(stats["lr"]) == pytest.approx(float(rstats["lr"]),
                                               rel=OPT_RTOL)


def test_moments_are_f32_for_bf16_params():
    init, update = make_optimizer(OptimConfig(lr=1e-2, warmup_steps=0))
    params = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    state = init(params)
    assert state.mu["w"].dtype == state.nu["w"].dtype == torch.float32
    new, state, _ = update(params, state,
                           {"w": torch.full((4, 4), 0.5,
                                            dtype=torch.bfloat16)})
    assert new["w"].dtype == torch.bfloat16
    assert state.mu["w"].dtype == torch.float32
    assert float(new["w"][0, 0]) < 1.0


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_converges_quadratic(name):
    cfg = OptimConfig(name=name, lr=0.1 if name == "adamw" else 0.05,
                      warmup_steps=0, total_steps=200, weight_decay=0.0,
                      schedule="constant", grad_clip=1e9)
    init, update = make_optimizer(cfg)
    target = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor(0.5)}
    params = {k: torch.zeros_like(v) for k, v in target.items()}
    state = init(params)
    for _ in range(200):
        grads = {k: params[k] - target[k] for k in params}
        params, state, _ = update(params, state, grads)
    assert max(float((params[k] - target[k]).abs().max())
               for k in params) < 1e-2


def test_weight_decay_decoupled():
    cfg = OptimConfig(name="adamw", lr=0.1, warmup_steps=0,
                      weight_decay=0.5, schedule="constant")
    init, update = make_optimizer(cfg)
    params = {"w": torch.ones(4)}
    params, _, _ = update(params, init(params), {"w": torch.zeros(4)})
    assert float(params["w"][0]) < 1.0     # decay applied with zero grads


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=110, schedule=schedule)
    ref = ref_make_schedule(RefOptimConfig(**cfg))
    mine = make_schedule(OptimConfig(**cfg))
    steps = np.arange(0, 131)
    want = np.asarray([float(ref(jnp.int32(s))) for s in steps], np.float32)
    got = mine(torch.from_numpy(steps.astype(np.int32))).numpy()
    # within f32 rounding: the cosine's 1 + cos(pi frac) cancels near the
    # end, so its rounding is a few ulps of the base rate there
    np.testing.assert_allclose(got, want, rtol=2 ** -22,
                               atol=2 ** -22 * cfg["lr"])
    assert float(mine(7)) == pytest.approx(float(ref(7)), rel=2 ** -22)


def test_schedule_warmup_cosine():
    s = make_schedule(OptimConfig(lr=1.0, warmup_steps=10, total_steps=110,
                                  schedule="cosine"))
    assert float(s(0)) == pytest.approx(0.1)
    assert float(s(9)) == pytest.approx(1.0)
    assert float(s(10)) == pytest.approx(1.0, abs=1e-3)
    assert float(s(110)) == pytest.approx(0.0, abs=1e-6)
    assert float(s(60)) == pytest.approx(0.5, abs=0.01)


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(20.0)
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    (r_clipped, r_norm) = ref_clip(jax.tree.map(jnp.asarray, tree), 0.5)
    clipped, norm = clip_by_global_norm(_named(tree), 0.5)
    assert float(norm) == pytest.approx(float(r_norm), rel=2 ** -22)
    want = _named(jax.tree.map(np.asarray, r_clipped))
    for k, v in clipped.items():
        assert L.rel_err(v.numpy(), want[k].numpy()) <= OPT_RTOL


# --- LM data ----------------------------------------------------------------

def test_lm_batch_deterministic():
    spec = LMBatchSpec(4, 32, 1000)
    b1 = lm_batch(spec, seed=7, step=3, device="cpu")
    b2 = lm_batch(spec, seed=7, step=3, device="cpu")
    b3 = lm_batch(spec, seed=7, step=4, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert not torch.equal(b1["tokens"],
                           lm_batch(spec, 8, 3, device="cpu")["tokens"])
    # next-token structure
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert b1["tokens"].shape == (4, 32) and b1["tokens"].dtype == torch.int32
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 1000


def test_lm_batch_flip_share():
    """The 8-gram of each row repeats; 5 % of the stream is noise."""
    spec = LMBatchSpec(64, 4095, 50_000)
    b = lm_batch(spec, seed=0, step=0, device="cpu")
    stream = torch.cat([b["tokens"], b["labels"][:, -1:]], 1).numpy()
    phases = stream.reshape(64, -1, 8)                  # (rows, reps, 8)
    base = np.array([[np.bincount(col).argmax() for col in row.T]
                     for row in phases])                # the mode a phase
    share = float((phases != base[:, None, :]).mean())
    assert abs(share - 0.05) <= 0.01


def test_lm_batch_stubs():
    cfg = TC.get_arch("llava-next-34b").reduced()
    spec = spec_for(cfg, TC.ShapeConfig("t", "train", 64, 4))
    b = lm_batch(spec, 0, 0, device="cpu")
    assert b["tokens"].shape == (4, 64 - cfg.vlm.num_image_tokens)
    assert b["img_embeds"].shape == (4, cfg.vlm.num_image_tokens,
                                     cfg.d_model)
    assert 0.015 < float(b["img_embeds"].std()) < 0.025
    cfg = TC.get_arch("whisper-base").reduced()
    b = lm_batch(spec_for(cfg, TC.ShapeConfig("t", "train", 64, 4)), 0, 0,
                 device="cpu")
    assert b["frames"].shape == (4, 64, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference(arch):
    for shape in RC.SHAPES:
        for override in (None, 2):
            want = RD.spec_for(RC.get_arch(arch), RC.get_shape(shape),
                               override)
            got = spec_for(TC.get_arch(arch), TC.get_shape(shape), override)
            assert tuple(got) == tuple(want)


def test_host_slice():
    b = lm_batch(LMBatchSpec(8, 16, 100), 0, 0, device="cpu")
    parts = [host_slice(b, h, 4) for h in range(4)]
    for k in b:
        assert torch.equal(torch.cat([p[k] for p in parts]), b[k])
        assert parts[0][k].shape[0] == 2


# --- the config registry ----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert TC.get_arch(arch).to_dict() == RC.get_arch(arch).to_dict()
    assert (TC.get_arch(arch).reduced().to_dict()
            == RC.get_arch(arch).reduced().to_dict())
    assert TC.get_arch(arch).source and \
        TC.get_arch(arch).source == RC.get_arch(arch).source


def test_registry_matches_reference():
    assert sorted(TC.ARCHS) == sorted(RC.ARCHS)
    assert TC.SUBQUADRATIC == RC.SUBQUADRATIC
    for arch in RC.ARCHS:
        for shape in RC.SHAPES:
            assert TC.cell_applicable(arch, shape) == \
                RC.cell_applicable(arch, shape)
            assert dataclasses.asdict(TC.get_shape(shape)) == \
                dataclasses.asdict(RC.get_shape(shape))
    with pytest.raises(KeyError):
        TC.get_arch("nope")
    with pytest.raises(KeyError):
        TC.get_shape("nope")


# --- the port's seeded init -------------------------------------------------

def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_follows_reference_rule(arch):
    """Every leaf as the reference draws it: zeros and ones where the
    reference's are; A_log in log [1, 16); every other leaf normal with
    std = 1 for embeddings, fan_in ** -0.5 otherwise (within 5 %, pooled
    over the layers of a stack)."""
    cfg = TC.get_arch(arch).reduced()
    model, _ = TM.init_model(cfg, torch.Generator().manual_seed(0))
    mine = dict(_flat(jax.tree.map(lambda t: t.numpy(),
                                   bridge.reference_tree(model))))
    ref_params, _ = RM.init_model(RC.get_arch(arch).reduced(),
                                  jax.random.PRNGKey(0))
    ref = dict(_flat(jax.tree.map(np.asarray, ref_params)))
    assert sorted(mine) == sorted(ref)
    for name, w in mine.items():
        r = ref[name]
        assert w.shape == r.shape and w.dtype == r.dtype, name
        if not r.any() or (r == 1).all():
            np.testing.assert_array_equal(w, r, err_msg=name)
        elif name.endswith("A_log"):
            assert (w >= 0).all() and (w < np.log(16.0)).all()
        else:
            stacked = name.split("/")[0] in TM.STACKED
            shape = w.shape[1:] if stacked else w.shape
            fan_in = shape[0] if len(shape) >= 2 else shape[-1]
            std = 1.0 if name.split("/")[-1] == "embed" else fan_in ** -0.5
            assert abs(float(w.std()) / std - 1) < 0.05, (name, w.std(), std)
            assert abs(float(w.mean())) < 0.1 * std, name


def test_init_model_is_deterministic():
    cfg = TC.get_arch("zamba2-1.2b").reduced()
    a, _ = TM.init_model(cfg, torch.Generator().manual_seed(5))
    b, _ = TM.init_model(cfg, torch.Generator().manual_seed(5))
    c, _ = TM.init_model(cfg, torch.Generator().manual_seed(6))
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not all(torch.equal(pa[k], pc[k]) for k in pa)


def test_model_params_carry_bf16_bit_for_bit():
    cfg = TC.get_arch("stablelm-1.6b").reduced(dtype="bfloat16",
                                               param_dtype="bfloat16")
    ref_params, _ = RM.init_model(
        RC.get_arch("stablelm-1.6b").reduced(dtype="bfloat16",
                                             param_dtype="bfloat16"),
        jax.random.PRNGKey(0))
    ref = jax.tree.map(np.asarray, ref_params)
    model = bridge.model_params(cfg, ref, device="cpu")
    back = bridge.reference_tree(model)
    for (path, r), t in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree.leaves(back)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      r.view(np.int16), err_msg=str(path))
    with pytest.raises(ValueError):
        bridge.model_params(cfg.reduced(num_layers=1), ref, device="cpu")
