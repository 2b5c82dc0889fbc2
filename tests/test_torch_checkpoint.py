"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's.

Mirrors tests/test_checkpoint.py — atomicity, validity checks, keep-N GC,
async writes, resume, per-leaf CRC32 and the write failpoints — less its
tenant-registry case (:255), which waits for the port's serving layer
(ROADMAP Queue 1 item 5).  Then the format itself, both ways: a tree or a
session state written by either package loads in the other, bit for bit,
with the same leaf names, the same CRCs and the same metadata; and a
bf16 basis, which the port writes as float32 because the reference cannot
load a bf16 leaf.  Every load here asks for the CPU: the port's default
device is the card.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.checkpoint as rck
from repro_torch import bridge
from repro_torch.api import (Factorization, RankEstimate, SVDSpec,
                             estimate_rank, factorize, session)
from repro_torch.api.session import Session
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, load_session_state,
                                    save_checkpoint, save_session_state,
                                    valid_steps)
from repro_torch.runtime import faults
from repro_torch.runtime.faults import FaultInjected

CPU = "cpu"


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": np.zeros(4, np.float32),
            "o": rng.standard_normal((8, 4)).astype(np.float32),
            "c": np.asarray(3, np.int32)}


def _tree(a):
    return {"params": {"w": torch.from_numpy(a["w"]),
                       "b": torch.from_numpy(a["b"])},
            "opt": [torch.from_numpy(a["o"]), torch.from_numpy(a["c"])]}


def _ref_tree(a):
    return {"params": {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])},
            "opt": [jnp.asarray(a["o"]), jnp.asarray(a["c"])]}


@pytest.fixture
def tree():
    return _tree(_arrays())


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    fields = {"Factorization": ("U", "s", "V", "iterations", "breakdown"),
              "RankEstimate": ("rank", "iterations", "eigenvalues")}
    if type(t).__name__ in fields:      # either package's result types
        return [getattr(t, f) for f in fields[type(t).__name__]]
    return [t]


def _assert_bit_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x.reshape(-1).view(np.uint8),
                                      y.reshape(-1).view(np.uint8))


def _manifest(path, step):
    with open(os.path.join(str(path), f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _names_and_crcs(path, step):
    return [(leaf["name"], leaf["dtype"], leaf["shape"], leaf["bytes"],
             leaf["crc32"]) for leaf in _manifest(path, step)["leaves"]]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    from repro.runtime import faults as ref_faults
    faults.disarm_all()
    ref_faults.disarm_all()
    yield
    faults.disarm_all()
    ref_faults.disarm_all()


# --- tests/test_checkpoint.py, case by case --------------------------------

def test_roundtrip(tmp_path, tree):
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    out, extra = load_checkpoint(str(tmp_path), 7, tree, device=CPU)
    _assert_bit_equal(tree, out)


def test_corrupt_checkpoint_ignored(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    p2 = tmp_path / "step_2"
    leaf = next(f for f in os.listdir(p2) if f.endswith(".npy"))
    with open(p2 / leaf, "wb") as f:
        f.write(b"xx")
    assert latest_step(str(tmp_path)) == 1


def test_missing_manifest_ignored(tmp_path, tree):
    save_checkpoint(str(tmp_path), 3, tree)
    os.remove(tmp_path / "step_3" / "manifest.json")
    assert latest_step(str(tmp_path)) is None


def test_keep_n_gc(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    names = sorted(os.listdir(tmp_path))
    assert "step_3" in names and "step_4" in names
    assert "step_1" not in names and "step_2" not in names


def test_async_writer(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    mgr.save(5, tree)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 5


def test_async_writer_saves_the_snapshot(tmp_path, tree):
    """The host copy is taken before the writer thread starts: an
    in-place write to a leaf after save() does not reach the disk."""
    want = tree["params"]["w"].clone()
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    mgr.save(6, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    out, _ = load_checkpoint(str(tmp_path), 6, tree, device=CPU)
    assert torch.equal(out["params"]["w"], want)


def test_restore_latest_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(9, tree, extra={"note": "hi"})
    got = mgr.restore_latest(tree, device=CPU)
    assert got is not None
    step, out, extra = got
    assert step == 9 and extra["note"] == "hi"
    _assert_bit_equal(tree, out)


def test_shape_mismatch_raises(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    bad = {"params": {k: torch.zeros((2,) + tuple(v.shape), dtype=v.dtype)
                      for k, v in tree["params"].items()},
           "opt": [torch.zeros((2,) + tuple(v.shape), dtype=v.dtype)
                   for v in tree["opt"]]}
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path), 1, bad, device=CPU)


def test_extra_metadata_survives(tmp_path, tree):
    save_checkpoint(str(tmp_path), 4, tree, extra={"mesh": [16, 16]})
    _, extra = load_checkpoint(str(tmp_path), 4, tree, device=CPU)
    assert extra["mesh"] == [16, 16]


def test_load_defaults_to_the_card(tmp_path, tree):
    """No device given: the leaves go to the CUDA card, and without one
    the load raises instead of quietly using the CPU."""
    save_checkpoint(str(tmp_path), 1, tree)
    if torch.cuda.is_available():
        out, _ = load_checkpoint(str(tmp_path), 1, tree)
        assert out["params"]["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(str(tmp_path), 1, tree)


def _fact(method="fsvd"):
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    A = np.array(jax.random.normal(k1, (24, 5))
                 @ jax.random.normal(k2, (5, 18)))
    A = torch.from_numpy(A)
    return A, factorize(A, SVDSpec(method=method, rank=4, max_iters=16),
                        generator=torch.Generator().manual_seed(5))


def test_factorization_roundtrip_bit_equal(tmp_path):
    _, fact = _fact()
    save_checkpoint(str(tmp_path), 1, {"fact": fact})
    out, _ = load_checkpoint(str(tmp_path), 1, {"fact": fact}, device=CPU)
    back = out["fact"]
    assert isinstance(back, Factorization) and back.method == fact.method
    _assert_bit_equal(fact, back)


def test_rank_estimate_roundtrip_bit_equal(tmp_path):
    key = jax.random.PRNGKey(6)
    k1, k2 = jax.random.split(key)
    A = torch.from_numpy(np.array(jax.random.normal(k1, (30, 7))
                                  @ jax.random.normal(k2, (7, 22))))
    est = estimate_rank(A, generator=torch.Generator().manual_seed(6))
    save_checkpoint(str(tmp_path), 2, {"rank": est})
    out, _ = load_checkpoint(str(tmp_path), 2, {"rank": est}, device=CPU)
    back = out["rank"]
    assert isinstance(back, RankEstimate) and back.method == est.method
    assert int(back.rank) == int(est.rank) == 7
    _assert_bit_equal(est, back)


def _lowrank(seed, m, n, r):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.normal(k1, (m, r))
                                     @ jax.random.normal(k2, (r, n))))


def test_session_state_roundtrip(tmp_path):
    A = _lowrank(7, 20, 16, 4)
    sess = session(A, SVDSpec(method="fsvd", rank=3, max_iters=12),
                   generator=torch.Generator().manual_seed(7))
    sess.solve()
    save_session_state(str(tmp_path), 1, sess)
    fact, meta = load_session_state(str(tmp_path), 1, device=CPU)
    assert meta["spec"]["rank"] == 3 and meta["spec"]["method"] == "fsvd"
    assert fact.method == sess.fact.method
    _assert_bit_equal(fact, sess.fact)


def test_session_state_before_first_solve(tmp_path):
    sess = session(torch.eye(8), SVDSpec(rank=2),
                   generator=torch.Generator().manual_seed(0))
    save_session_state(str(tmp_path), 0, sess)
    fact, meta = load_session_state(str(tmp_path), 0, device=CPU)
    assert fact is None and meta["step"] == 0


def _flip_leaf_byte(step_dir):
    leaf = next(f for f in sorted(os.listdir(step_dir))
                if f.endswith(".npy"))
    path = os.path.join(str(step_dir), leaf)
    with open(path, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        old = f.read(1)
        f.seek(-4, os.SEEK_END)
        f.write(bytes([old[0] ^ 0xFF]))


def test_crc_rejects_same_size_bitrot(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    _flip_leaf_byte(tmp_path / "step_2")
    assert valid_steps(str(tmp_path)) == [1]
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="CRC32"):
        load_checkpoint(str(tmp_path), 2, tree, device=CPU)
    out, _ = load_checkpoint(str(tmp_path), 1, tree, device=CPU)
    _assert_bit_equal(tree, out)


def test_write_crash_failpoint_leaves_no_partial_state(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    faults.arm(faults.CHECKPOINT_WRITE, mode="raise", p=1.0)
    with pytest.raises(FaultInjected):
        save_checkpoint(str(tmp_path), 2, tree)
    faults.disarm_all()
    assert valid_steps(str(tmp_path)) == [1]
    assert not (tmp_path / "step_2").exists()


def test_corrupt_failpoint_bitrot_is_detected(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    faults.arm(faults.CHECKPOINT_WRITE, mode="corrupt", p=1.0)
    save_checkpoint(str(tmp_path), 2, tree)
    faults.disarm_all()
    assert (tmp_path / "step_2").exists()     # written...
    assert valid_steps(str(tmp_path)) == [1]  # ...but never trusted
    assert latest_step(str(tmp_path)) == 1


@pytest.mark.parametrize("writer", ["manager", "async_manager", "session"])
def test_keep_n_never_counts_a_corrupt_fresh_step(tmp_path, tree, writer):
    """keep=1: a new step whose bytes the corrupt failpoint mangled after
    its CRC is not counted toward keep-N, so the good step it follows
    stays on disk and stays the newest valid one."""
    if writer == "session":
        sess = session(torch.eye(8), SVDSpec(rank=2),
                       generator=torch.Generator().manual_seed(0))
        sess.solve()

        def save(step):
            save_session_state(str(tmp_path), step, sess, keep=1)
    else:
        mgr = CheckpointManager(str(tmp_path), keep=1,
                                async_write=writer == "async_manager")

        def save(step):
            mgr.save(step, tree)
            mgr.wait()
    save(1)
    faults.arm(faults.CHECKPOINT_WRITE, mode="corrupt", p=1.0)
    save(2)
    faults.disarm_all()
    assert (tmp_path / "step_2").exists()
    assert (tmp_path / "step_1").exists()
    assert latest_step(str(tmp_path)) == 1
    save(3)                       # a clean save then drops the good one
    assert valid_steps(str(tmp_path)) == [3]
    assert not (tmp_path / "step_1").exists()


def test_session_restore_falls_back_to_newest_verified(tmp_path):
    A = _lowrank(11, 20, 16, 4)
    g = torch.Generator().manual_seed(11)
    sess = session(A, SVDSpec(method="fsvd", rank=3, max_iters=12),
                   generator=g)
    sess.solve()
    sess.save(str(tmp_path), step=1)
    sess.update(A + 1e-4 * torch.randn(A.shape, generator=g))
    sess.save(str(tmp_path), step=2)
    _flip_leaf_byte(tmp_path / "step_2")
    restored = Session.restore(str(tmp_path), A, generator=g)
    assert restored._step == 1                 # newer step was rotten
    for a, b in zip(_leaves(restored.fact), _leaves(sess.fact)):
        assert a.shape == b.shape


# --- the format, both ways --------------------------------------------------

def test_tree_written_by_the_reference_loads_in_the_port(tmp_path):
    a = _arrays(3)
    rck.save_checkpoint(str(tmp_path / "ref"), 1, _ref_tree(a),
                        extra={"k": [1, 2]})
    out, extra = load_checkpoint(str(tmp_path / "ref"), 1, _tree(a),
                                 device=CPU)
    assert extra == {"k": [1, 2]}
    _assert_bit_equal(out, _tree(a))
    save_checkpoint(str(tmp_path / "port"), 1, _tree(a))
    assert _names_and_crcs(tmp_path / "ref", 1) == \
        _names_and_crcs(tmp_path / "port", 1)


def test_tree_written_by_the_port_loads_in_the_reference(tmp_path):
    a = _arrays(4)
    save_checkpoint(str(tmp_path), 1, _tree(a), extra={"k": "v"})
    out, extra = rck.load_checkpoint(str(tmp_path), 1, _ref_tree(a))
    assert extra == {"k": "v"}
    _assert_bit_equal(out, _ref_tree(a))


def _ref_session(seed=13):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    A = jax.random.normal(k1, (30, 5)) @ jax.random.normal(k2, (5, 22))
    sess = rapi.session(A, rapi.SVDSpec(method="fsvd", rank=4,
                                        max_iters=16), key=key)
    sess.solve()
    sess.update(A + 1e-4 * jax.random.normal(k2, A.shape))
    return sess, A


def test_session_state_from_the_reference_loads_in_the_port(tmp_path):
    """The reference's save_session_state → the port's loader: U, s, V,
    iterations and breakdown bit for bit, the same meta; the port's own
    save of that state writes the same leaf names and CRCs, and the same
    meta."""
    ref, A = _ref_session()
    rck.save_session_state(str(tmp_path / "ref"), 2, ref)
    fact, meta = load_session_state(str(tmp_path / "ref"), 2, device=CPU)
    _assert_bit_equal(fact, ref.fact)
    assert fact.method == ref.fact.method
    assert meta == json.loads(json.dumps(ref.meta()))
    back = Session.restore(str(tmp_path / "ref"),
                           torch.from_numpy(np.array(A)),
                           generator=torch.Generator().manual_seed(1))
    assert back.meta() == meta and back.solves == ref.solves
    assert back.spec == bridge.spec(ref.spec)
    back.save(str(tmp_path / "port"), 2)
    assert _names_and_crcs(tmp_path / "ref", 2) == \
        _names_and_crcs(tmp_path / "port", 2)
    assert _manifest(tmp_path / "port", 2)["extra"] == \
        _manifest(tmp_path / "ref", 2)["extra"]


def test_session_state_from_the_port_loads_in_the_reference(tmp_path):
    ref, A = _ref_session(17)
    At = torch.from_numpy(np.array(A))
    sess = session(At, bridge.spec(ref.spec),
                   generator=torch.Generator().manual_seed(2))
    sess.solve()
    sess.update(At + 1e-4)
    sess.save(str(tmp_path), 5)
    fact, meta = rck.load_session_state(str(tmp_path), 5)
    _assert_bit_equal(fact, sess.fact)
    assert fact.method == sess.fact.method
    assert meta == json.loads(json.dumps(sess.meta()))
    # the reference resumes the port's stream
    back = rapi.Session.restore(str(tmp_path), A, key=jax.random.PRNGKey(0))
    assert back.solves == sess.solves and back.history == sess.history
    assert back.spec == ref.spec


def _bf16_fact():
    _, f = _fact()
    return Factorization(f.U.to(torch.bfloat16), f.s,
                         f.V.to(torch.bfloat16), f.iterations, f.breakdown,
                         method=f.method)


def test_bf16_basis_is_written_as_float32_the_reference_loads(tmp_path):
    """numpy saves a bf16 array as raw ``<V2`` bytes, which the
    reference's own loader cannot read (np.load returns void).  The port
    writes a bf16 leaf as float32 — exact — and the reference loads it,
    with the values of the bf16 basis; the port reads it back as float32
    of the same values.  No ml_dtypes is needed."""
    f = _bf16_fact()
    save_checkpoint(str(tmp_path), 1, {"fact": f})
    man = _manifest(tmp_path, 1)["leaves"]
    assert [leaf["dtype"] for leaf in man] == ["float32", "float32",
                                               "float32", "int32", "bool"]
    ref_tmpl = {"fact": bridge_ref_fact(f)}
    out, _ = rck.load_checkpoint(str(tmp_path), 1, ref_tmpl)
    np.testing.assert_array_equal(np.asarray(out["fact"].U),
                                  f.U.float().numpy())
    back, _ = load_checkpoint(str(tmp_path), 1, {"fact": f}, device=CPU)
    assert back["fact"].U.dtype == torch.float32
    assert torch.equal(back["fact"].U, f.U.float())
    assert torch.equal(back["fact"].V, f.V.float())


def test_bf16_leaf_written_by_the_reference_loads_bit_for_bit(tmp_path):
    """The reference writes a bf16 leaf as ``<V2`` (manifest dtype
    bfloat16) and cannot load it back; the port reads it as bfloat16 bit
    for bit."""
    f = _bf16_fact()
    ref = bridge_ref_fact(f)
    rck.save_checkpoint(str(tmp_path), 1, {"fact": ref})
    assert _manifest(tmp_path, 1)["leaves"][0]["dtype"] == "bfloat16"
    with pytest.raises(TypeError):
        rck.load_checkpoint(str(tmp_path), 1, {"fact": ref})
    back, _ = load_checkpoint(str(tmp_path), 1, {"fact": f}, device=CPU)
    assert back["fact"].U.dtype == torch.bfloat16
    assert torch.equal(back["fact"].U.view(torch.int16),
                       f.U.view(torch.int16))
    assert torch.equal(back["fact"].s, f.s)


def bridge_ref_fact(f):
    """The port's Factorization as the reference's (bf16 through
    ml_dtypes, which JAX brings)."""
    def arr(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return rapi.Factorization(arr(f.U), arr(f.s), arr(f.V),
                              arr(f.iterations), arr(f.breakdown),
                              method=f.method)
