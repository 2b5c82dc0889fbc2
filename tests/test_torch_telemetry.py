"""The port's telemetry (``repro_torch.runtime.telemetry``) and configs
(``repro_torch.configs``) against the reference's.

The four ``grad_spectrum`` cases of tests/test_telemetry.py run on the
port, on the reference's own gradients, held to that test's assertions
(σ within rtol 1e-3 of the dense SVD, the rank, the energy bounds); then
the port's σ / rank / energy against the reference's on the same inputs:
σ within rtol 1e-3 of the reference's (its own bound against the dense
SVD), the same rank, energy within 1e-3.  ``gradient_rank_summary`` is
held to the reference's names, order and spectra on a nested dict of
gradients, and the reference's model-gradient case runs on the port's
model gradients (the reduced stablelm) and on the same gradients in the
reference's layout (``bridge.reference_tree``) beside the reference's own.
The ``LatencyStats`` lock regression runs as the reference's.
The config dataclasses have the reference's fields, defaults and
``to_dict``.
"""
import collections
import dataclasses
import threading
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as rcb
import repro.configs.paper_rsl as rrsl
from conftest import make_lowrank
from repro.runtime import telemetry as rtel
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tcb
from repro_torch.configs import paper_rsl as trsl
from repro_torch.runtime import telemetry as T

SIGMA_RTOL = 1e-3         # test_grad_spectrum_lowrank
ENERGY_ATOL = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _parity(got, ref):
    assert got["sigma"].shape == tuple(ref["sigma"].shape)
    assert int(got["rank"]) == int(ref["rank"])
    # Ritz values past the rank are rounding noise (~1e-8 sigma_1)
    s_ref = np.asarray(ref["sigma"])
    np.testing.assert_allclose(got["sigma"].numpy(), s_ref,
                               rtol=SIGMA_RTOL,
                               atol=1e-6 * max(float(s_ref.max()), 1e-30))
    np.testing.assert_allclose(float(got["energy_r"]),
                               float(ref["energy_r"]), atol=ENERGY_ATOL)


# --- tests/test_telemetry.py's grad_spectrum cases on the port ----------------

def test_grad_spectrum_lowrank(rng):
    g = make_lowrank(rng, 300, 200, 5)
    out = T.grad_spectrum(_t(g), k=12)
    assert int(out["rank"]) == 5
    s_true = jnp.linalg.svd(g, compute_uv=False)[:5]
    np.testing.assert_allclose(out["sigma"][:5].numpy(), np.asarray(s_true),
                               rtol=1e-3)
    assert float(out["energy_r"]) > 0.999   # rank-5 captures everything
    _parity(out, rtel.grad_spectrum(g, k=12))


def test_grad_spectrum_full_rank(rng):
    g = jax.random.normal(rng, (128, 96))
    out = T.grad_spectrum(_t(g), k=8)
    assert int(out["rank"]) == 8            # >= k Ritz values above tol
    assert float(out["energy_r"]) < 0.9     # white spectrum: top-8 is partial
    ref = rtel.grad_spectrum(g, k=8)
    # the two draw different start vectors: on a white spectrum the Ritz
    # values of 32 GK steps agree in rank and energy, not to rounding
    assert int(out["rank"]) == int(ref["rank"])
    np.testing.assert_allclose(float(out["energy_r"]),
                               float(ref["energy_r"]), rtol=0.05)


def test_grad_spectrum_zero_gradient():
    """A dead layer (all-zero gradient) reports rank 0 and energy 0 —
    not NaN from a 0/0 energy ratio."""
    out = T.grad_spectrum(torch.zeros((64, 48)), k=8)
    assert int(out["rank"]) == 0
    assert float(out["energy_r"]) == 0.0
    assert bool(torch.all(torch.isfinite(out["sigma"])))
    _parity(out, rtel.grad_spectrum(jnp.zeros((64, 48)), k=8))


def test_grad_spectrum_rank_clamped_to_k(rng):
    """The numerical rank above the probe width clamps to k."""
    g = make_lowrank(rng, 96, 72, 8)        # true rank 8, probed with k=4
    out = T.grad_spectrum(_t(g), k=4)
    assert int(out["rank"]) == 4
    assert out["sigma"].shape == (4,)
    assert 0.0 < float(out["energy_r"]) <= 1.0
    _parity(out, rtel.grad_spectrum(g, k=4))


def test_grad_spectrum_of_a_stacked_gradient():
    """A (layers, m, n) leaf is read as (layers, m·n), as the reference
    reshapes it."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (20, 9, 10)).astype(np.float32))
    out, flat = T.grad_spectrum(g, k=6), T.grad_spectrum(g.reshape(20, 90),
                                                         k=6)
    for key in out:
        assert torch.equal(out[key], flat[key])


# --- gradient_rank_summary ------------------------------------------------------

class _Pair(NamedTuple):
    kernel: object
    bias: object


def _tree(leaf):
    """One nested tree of gradients, built by ``leaf(seed, shape)`` for
    either package: dict keys out of order, a list (the reference names
    an index "?"), a namedtuple, an OrderedDict in insertion order, a
    None, vectors and narrow matrices that are skipped, a stacked
    (layers, m, n) leaf, and two leaves of one size (a stable sort)."""
    return {
        "zeta": {"w": leaf(1, (80, 70)), "b": leaf(2, (70,))},
        "alpha": [leaf(3, (96, 72)), leaf(4, (72, 96))],
        "mlp": _Pair(kernel=leaf(5, (120, 64)), bias=leaf(6, (64,))),
        "ordered": collections.OrderedDict(
            [("z", leaf(7, (64, 90))), ("a", leaf(8, (90, 64)))]),
        "stack": leaf(9, (3, 70, 66)),
        "narrow": leaf(10, (400, 8)),
        "none": None,
    }


def _leaf_ref(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _leaf_port(seed, shape):
    return torch.from_numpy(_leaf_ref(seed, shape))


def test_gradient_rank_summary_names_and_order_match_reference(
        monkeypatch):
    """The same names, in the same order, for the same leaves (the middle
    layer of a stack; of two leaves under one name, the later).  Each
    package's ``grad_spectrum`` is stood in by one that returns its leaf:
    the spectra themselves are held above."""
    def leaf_of(g, k=16):
        return {"leaf": np.asarray(g), "k": k}

    monkeypatch.setattr(rtel, "grad_spectrum", leaf_of)
    monkeypatch.setattr(T, "grad_spectrum", leaf_of)
    tree_ref, tree = _tree(_leaf_ref), _tree(_leaf_port)
    ref = rtel.gradient_rank_summary(
        tree_ref, rcb.FsvdConfig(compression_min_dim=60), k=6, max_leaves=6)
    got = T.gradient_rank_summary(
        tree, tcb.FsvdConfig(compression_min_dim=60), k=6, max_leaves=6)
    assert list(got) == list(ref) == [
        "stack", "mlp/kernel", "alpha/?", "ordered/z", "ordered/a"]
    for name in ref:
        assert got[name]["k"] == ref[name]["k"] == 6
        np.testing.assert_array_equal(got[name]["leaf"], ref[name]["leaf"])
    assert got["stack"]["leaf"].shape == (70, 66)
    # no leaf reaches the default compression_min_dim of 256
    assert T.gradient_rank_summary(tree, None, k=6) == {}


def test_gradient_rank_summary_takes_named_parameters():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(64, 80),
                                torch.nn.Linear(80, 72))
    model(torch.randn(5, 64)).pow(2).sum().backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    got = T.gradient_rank_summary(
        grads, tcb.FsvdConfig(compression_min_dim=60), k=4)
    assert list(got) == ["1.weight", "0.weight"]        # by size, desc
    ref = rtel.gradient_rank_summary(
        {k: jnp.asarray(v.numpy()) for k, v in grads.items()},
        rcb.FsvdConfig(compression_min_dim=60), k=4)
    assert list(ref) == list(got)
    for name in got:
        # rank-5 gradients (a batch of 5): exact in 16 GK steps
        _parity(got[name], ref[name])
        assert int(got[name]["rank"]) == 4


def test_summary_on_model_grads():
    """tests/test_telemetry.py::test_summary_on_model_grads on the port's
    model; then on the reference's params and batch (carried over), the
    port's summary of its stacked gradients beside the reference's."""
    import torch_lm_ref as L
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.models import model as TM
    cfg, model, _ = L.port_model("stablelm-1.6b")
    batch = L.port_batch(cfg)
    loss, _ = TM.loss_fn(model, batch, cfg)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    summary = T.gradient_rank_summary(
        grads, tcb.FsvdConfig(compression_min_dim=64), k=8, max_leaves=4)
    assert len(summary) >= 1
    for name, s in summary.items():
        assert s["sigma"].shape == (8,)
        assert bool(torch.isfinite(s["sigma"]).all())
        assert 0 <= int(s["rank"]) <= 8
    # the same leaves, names and spectra as the reference on its gradients
    ref = L.reference("stablelm-1.6b")
    model = bridge.model_params(get_arch("stablelm-1.6b").reduced(),
                                ref["params"], device="cpu")
    loss, _ = TM.loss_fn(model, L.to_torch(ref["batch"]), cfg)
    named = dict(model.named_parameters())
    stacked = bridge.reference_tree(dict(zip(named, torch.autograd.grad(
        loss, list(named.values())))))
    got = T.gradient_rank_summary(
        stacked, tcb.FsvdConfig(compression_min_dim=64), k=8, max_leaves=4)
    want = rtel.gradient_rank_summary(
        jax.tree.map(jnp.asarray, ref["grads"]),
        rcb.FsvdConfig(compression_min_dim=64), k=8, max_leaves=4)
    assert list(got) == list(want) and len(got) == 4
    for name in got:
        _parity(got[name], want[name])


# --- LatencyStats ---------------------------------------------------------------

def test_latency_stats_summary_matches_reference():
    a, b = T.LatencyStats(window=16), rtel.LatencyStats(window=16)
    assert a.summary() == b.summary() and a.percentile(50) == 0.0
    for i in range(40):
        a.record(i * 0.5)
        b.record(i * 0.5)
    assert a.summary() == b.summary()
    assert a.percentile(90) == b.percentile(90)
    assert a.count == 40


def test_latency_stats_reader_does_not_block_recorders(monkeypatch):
    """Regression: percentile()/summary() used to run np.percentile over
    the whole window while holding the lock record() needs on the
    dispatch hot path.  Park a reader inside a slow percentile and prove
    records still land while it is stuck."""
    stats = T.LatencyStats(window=256)
    for i in range(64):
        stats.record(float(i))

    in_percentile = threading.Event()
    release = threading.Event()
    real_percentile = np.percentile

    def slow_percentile(data, p, *args, **kwargs):
        in_percentile.set()
        assert release.wait(timeout=10.0), "recorder never released reader"
        return real_percentile(data, p, *args, **kwargs)

    monkeypatch.setattr(T.np, "percentile", slow_percentile)
    out = {}
    reader = threading.Thread(
        target=lambda: out.setdefault("summary", stats.summary()))
    reader.start()
    try:
        assert in_percentile.wait(timeout=10.0)
        # reader is parked mid-percentile: the hot path must not care
        t0 = time.monotonic()
        for i in range(32):
            stats.record(1000.0 + i)
        elapsed = time.monotonic() - t0
        assert stats.count == 96          # records landed while parked
        assert elapsed < 5.0              # and never waited on the reader
    finally:
        release.set()
        reader.join(timeout=10.0)
    assert not reader.is_alive()
    # the reader's snapshot predates the concurrent records
    assert out["summary"]["count"] == 64
    assert out["summary"]["max_ms"] == 63.0


# --- configs ----------------------------------------------------------------------

def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = None
    return out


@pytest.mark.parametrize("name", [
    "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig", "EncDecConfig",
    "VLMConfig", "ModelConfig", "ShapeConfig", "FsvdConfig", "OptimConfig",
    "CheckpointConfig", "RuntimeConfig", "MeshConfig", "RunConfig"])
def test_config_fields_and_defaults_match_reference(name):
    got, ref = getattr(tcb, name), getattr(rcb, name)
    assert _fields(got) == _fields(ref)
    assert got.__dataclass_params__.frozen and ref.__dataclass_params__.frozen
    assert getattr(tconfigs, name) is got


def test_run_config_to_dict_and_reduced_match_reference():
    def model(mod):
        return mod.ModelConfig(
            name="m", family="moe", num_layers=12, d_model=1024,
            num_heads=16, num_kv_heads=4, d_ff=4096, vocab_size=32000,
            sliding_window=512, attn_pattern=("local", "global"),
            moe=mod.MoEConfig(num_experts=8, top_k=2, d_ff_expert=1024,
                              num_shared_experts=2, d_ff_shared=512),
            mla=mod.MLAConfig(64, 96, 32, 16, 64),
            ssm=mod.SSMConfig(d_state=64))

    def run(mod):
        return mod.RunConfig(model=model(mod), shape=mod.SHAPES["train_4k"],
                             fsvd=mod.FsvdConfig(compress_gradients=True),
                             seed=3)

    assert run(tcb).to_dict() == run(rcb).to_dict()
    assert model(tcb).reduced().to_dict() == model(rcb).reduced().to_dict()
    assert model(tcb).reduced(d_model=64).resolved_head_dim == \
        model(rcb).reduced(d_model=64).resolved_head_dim
    assert {k: dataclasses.asdict(v) for k, v in tcb.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rcb.SHAPES.items()}
    assert tcb.FsvdConfig() == tcb.FsvdConfig() and \
        hash(tcb.FsvdConfig()) == hash(tcb.FsvdConfig())
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcb.FsvdConfig().max_iters = 3


def test_rsl_config_matches_reference():
    assert _fields(trsl.RSLConfig) == _fields(rrsl.RSLConfig)
    for name in ("CONFIG", "CONFIG_100M"):
        assert dataclasses.asdict(getattr(trsl, name)) == \
            dataclasses.asdict(getattr(rrsl, name))
        assert getattr(tconfigs, name) is getattr(trsl, name)
