"""The port's distributed layer against the reference's, on the CPU: the
cases of tests/test_distributed.py.

The reference runs in a subprocess with 8 forced host devices; the port
in a gloo world of 8 CPU processes (``tests/torch_world.py``), port rank
r holding exactly the rows (and columns) that reference device r holds.
Both are fed the same numpy inputs and, where a start vector matters, the
same q1.  One reference run and one port world serve the whole module.

Bounds are the reference tests' own; port against reference is held at
``SOLVERS[method]["stol"]``·σ_max for solves (the single-device parity
bound the port's tests use) and at the reference's 1e-4 for products.
The reference's ``fsvd_blocked`` on a sharded operand syncs the host once
per basis column (minutes on 8 host devices), so its single-device solve,
which it holds to the sharded one at 1e-5, stands in for it.
The collectives of a Lanczos half-step are counted through the port's one
collective helper: one in the row layout, with and without the kernels
and on ("pod", "data"), two with a "model" axis.  Every rank must return
the same global results bit for bit.  ``test_partition_rules_divisibility
_fallback`` and ``test_sharded_train_step_runs`` come with the models.
"""
import numpy as np
import pytest

import torch_world as tw
from test_solver_parity import SOLVERS

REFERENCE = """
from jax.sharding import PartitionSpec as P
from repro.api import SVDSpec, estimate_rank, factorize
from repro.configs.base import FsvdConfig
from repro.core.operators import DenseOp, GramOp, SparseOp
from repro.distributed import compression as C
from repro.distributed import gk_dist as gd
from repro.distributed.matvec import place_operator, sharded_operator
from repro.launch.mesh import make_mesh
J = {k: jnp.asarray(v) for k, v in IN.items()}
mesh42 = make_mesh((4, 2), ("data", "model"))
mesh8 = make_mesh((8,), ("data",))

op = sharded_operator(place_operator(J["mv_A"], mesh42), mesh42)
OUT["mv_mv"] = op.mv(J["mv_p"])
OUT["mv_rmv"] = op.rmv(J["mv_q"])
OUT["mv_fused"] = op.mv_fused(J["mv_p"], J["mv_q"], 0.5)

OUT["fs_s"] = gd.fsvd_sharded(J["fs_A"], mesh42, 8, 40, q1=J["fs_q1"]).s
OUT["fs_rank"] = gd.rank_sharded(J["fs_A"], mesh42, max_iters=100,
                                 key=jax.random.PRNGKey(3)).rank

mesh222 = make_mesh((2, 2, 2), ("pod", "data", "model"))
OUT["mp_mv"] = sharded_operator(place_operator(J["mv_A"], mesh222),
                                mesh222).mv(J["mv_p"])

cfg = FsvdConfig(compression_rank=8, compression_min_dim=32, max_iters=24)

def body(g, sm, e):
    mean, new_ef, stats = C.compressed_mean_grads(
        {"w": g[0], "tiny": sm[0]}, {"w": e[0], "tiny": jnp.zeros(())},
        "data", cfg)
    return (mean["w"][None], mean["tiny"][None], new_ef["w"][None],
            jnp.stack([stats.dense_bytes, stats.compressed_bytes])[None])

cm = jax.jit(jax.shard_map(body, mesh=mesh8,
    in_specs=(P("data"), P("data"), P("data")),
    out_specs=(P("data"), P("data"), P("data"), P("data")),
    check_vma=False))(J["cm_G"], J["cm_small"], jnp.zeros(J["cm_G"].shape))
OUT["cm_mean"], OUT["cm_tiny"], OUT["cm_ef"] = cm[0][0], cm[1][0], cm[2][0]
OUT["cm_bytes"] = cm[3][0]

cfg2 = FsvdConfig(compression_rank=2, compression_min_dim=8, max_iters=6)
Wstar = J["ef_W"]

def run(x):
    x = x[0]
    def one(i, carry):
        W, e = carry
        g = x.T @ (x @ (W - Wstar)) / x.shape[0]
        mean, new_e, _ = C.compressed_mean_grads({"w": g}, {"w": e}, "data",
                                                 cfg2)
        return W - 0.1 * mean["w"], new_e["w"]
    W, _ = jax.lax.fori_loop(0, 150, one, (jnp.zeros_like(Wstar),
                                           jnp.zeros_like(Wstar)))
    return W[None]

OUT["ef_W"] = jax.jit(jax.shard_map(run, mesh=mesh8, in_specs=(P("data"),),
                                    out_specs=P("data"),
                                    check_vma=False))(J["ef_X"])[0]

for tag, shape, axes, backend in [("rows", (8,), ("data",), "xla"),
                                  ("rows_pallas", (8,), ("data",), "pallas"),
                                  ("pods", (2, 4), ("pod", "data"), "xla"),
                                  ("model", (4, 2), ("data", "model"),
                                   "xla")]:
    op = sharded_operator(J["hs_A"], make_mesh(shape, axes), backend=backend)
    u, nu = op.lanczos_step(J["hs_p"], J["hs_q"], 0.4, J["hs_Q"])
    v, nv = op.lanczos_rstep(J["hs_q"], J["hs_p"], 0.2, J["hs_P"])
    OUT[f"hs_{tag}_u"], OUT[f"hs_{tag}_v"] = u, v
    OUT[f"hs_{tag}_norms"] = jnp.stack([nu, nv])

# fsvd_blocked's host loop on a sharded operand takes minutes on 8 host
# devices; the reference holds it to its single-device solve at 1e-5
# (tests/test_distributed.py:244), so the single-device solve stands in
for method, kw in [("fsvd_sharded", dict(max_iters=48)),
                   ("fsvd_blocked", dict()),
                   ("rsvd", dict(power_iters=3, oversample=10))]:
    q1 = J["ss_q1"] if method == "fsvd_sharded" else None
    A = J["ss_A"] if method == "fsvd_blocked" else sharded_operator(
        J["ss_A"], mesh8)
    OUT["ss_" + method] = factorize(
        A, SVDSpec(method=method, rank=8, **kw), key=jax.random.PRNGKey(7),
        q1=q1).s

sop = sharded_operator(SparseOp.fromdense(J["sp_dense"]), mesh8)
OUT["sp_mv"], OUT["sp_rmv"] = sop.mv(J["sp_p"]), sop.rmv(J["sp_q"])
OUT["sp_s"] = factorize(SparseOp.fromdense(J["sp_dense"]),
                        SVDSpec(method="fsvd_blocked", rank=6),
                        key=jax.random.PRNGKey(8)).s
OUT["sp_rank"] = estimate_rank(sharded_operator(GramOp(DenseOp(J["sp_lr"])),
                                                mesh8),
                               key=jax.random.PRNGKey(11)).rank
"""


def _inputs(rng):
    f32 = np.float32

    def normal(*shape):
        return rng.standard_normal(shape).astype(f32)

    low = normal(128, 8) @ normal(8, 96)
    mask = rng.uniform(size=(90, 60)) < 0.08
    return {
        "mv_A": normal(64, 32), "mv_p": normal(32), "mv_q": normal(64),
        "fs_A": normal(256, 64) @ normal(64, 128),
        "fs_q1": (2.0 + normal(256)).astype(f32),
        "cm_G": (0.01 * normal(8, 128, 96) + low[None]).astype(f32),
        "cm_small": np.broadcast_to(np.arange(8, dtype=f32)[:, None],
                                    (8, 8)).copy(),
        "ef_W": normal(32, 24), "ef_X": normal(8, 16, 32),
        "hs_A": normal(128, 64), "hs_p": normal(64), "hs_q": normal(128),
        "hs_Q": np.linalg.qr(normal(128, 9))[0].astype(f32),
        "hs_P": np.linalg.qr(normal(64, 9))[0].astype(f32),
        "ss_A": (1e3 * (normal(100, 12) @ normal(12, 70)
                        + 1e-4 * normal(100, 70))).astype(f32),
        "ss_q1": (2.0 + normal(100)).astype(f32),
        "sp_dense": np.where(mask, normal(90, 60), 0.0).astype(f32),
        "sp_p": normal(60), "sp_q": normal(90),
        "sp_lr": normal(64, 7) @ normal(7, 48),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distributed")
    IN = _inputs(np.random.default_rng(20))
    np.savez(d / "in.npz", **IN)
    proc = tw.start_reference(REFERENCE, str(d / "in.npz"),
                              str(d / "ref.npz"))
    port = tw.run_port(tw.distributed_cases, str(d), str(d / "in.npz"))
    ref = tw.finish_reference(proc, str(d / "ref.npz"))
    return IN, ref, port


def _d(x):
    return np.asarray(x, np.float64)


def test_every_rank_returns_the_same_global_results(runs):
    _, _, port = runs
    for key in port[0]:
        if key == "cm_ef":          # each rank's own residual
            continue
        for r in range(1, tw.WORLD):
            np.testing.assert_array_equal(port[r][key], port[0][key],
                                          err_msg=f"{key} on rank {r}")


def test_sharded_matvec_matches_dense(runs):
    IN, ref, port = runs
    A, p, q = _d(IN["mv_A"]), _d(IN["mv_p"]), _d(IN["mv_q"])
    got = port[0]
    want = {"mv_mv": A @ p, "mv_rmv": A.T @ q, "mv_fused": A @ p - 0.5 * q}
    for key, w in want.items():
        assert np.max(np.abs(got[key] - w)) < 1e-4, key
        assert np.max(np.abs(got[key] - ref[key])) < 1e-4, key


def test_distributed_fsvd_matches_dense(runs):
    IN, ref, port = runs
    s_true = np.linalg.svd(_d(IN["fs_A"]), compute_uv=False)[:8]
    got = port[0]
    assert np.max(np.abs(got["fs_s"] - s_true) / s_true) < 1e-3
    assert int(got["fs_rank"]) == int(ref["fs_rank"]) == 64
    assert int(got["fs_warned"]) == 2          # both shims warn
    assert np.max(np.abs(got["fs_s"] - ref["fs_s"])) / s_true[0] \
        < SOLVERS["fsvd_sharded"]["stol"]


def test_multipod_mesh_axes(runs):
    IN, ref, port = runs
    want = _d(IN["mv_A"]) @ _d(IN["mv_p"])
    assert np.max(np.abs(port[0]["mp_mv"] - want)) < 1e-4
    assert np.max(np.abs(port[0]["mp_mv"] - ref["mp_mv"])) < 1e-4


def test_compressed_mean_grads(runs):
    IN, ref, port = runs
    mean_true = _d(IN["cm_G"]).mean(0)
    for r, got in enumerate(port):
        rel = np.linalg.norm(got["cm_mean"] - mean_true) \
            / np.linalg.norm(mean_true)
        assert rel < 5e-3, (r, rel)     # low-rank-dominated mean captured
        assert np.max(np.abs(got["cm_tiny"] - 3.5)) < 1e-6   # plain mean
        assert np.linalg.norm(got["cm_ef"]) > 0          # residual kept
        # this rank's residual is what compression dropped of its gradient
        np.testing.assert_allclose(got["cm_ef"],
                                   IN["cm_G"][r] - got["cm_mean"],
                                   rtol=0, atol=1e-5)
    assert list(port[0]["cm_counts"]) == [1, 1]
    np.testing.assert_array_equal(port[0]["cm_bytes"], ref["cm_bytes"])
    assert np.linalg.norm(port[0]["cm_mean"] - ref["cm_mean"]) \
        / np.linalg.norm(mean_true) < 5e-3


def test_ef_accumulates_what_compression_drops(runs):
    IN, ref, port = runs
    Wstar = _d(IN["ef_W"])
    err = np.linalg.norm(port[0]["ef_W"] - Wstar) / np.linalg.norm(Wstar)
    assert err < 0.15     # converges to the optimum despite rank-2 comm
    assert np.linalg.norm(ref["ef_W"] - Wstar) / np.linalg.norm(Wstar) < 0.15


@pytest.mark.parametrize("tag,calls", [("rows", [1, 1]),
                                       ("rows_pallas", [1, 1]),
                                       ("pods", [1, 1]), ("model", [2, 2])])
def test_fused_step_is_one_collective_per_half_step(runs, tag, calls):
    """One collective per half-step in the row layout (a "model" axis adds
    the matvec-reduce collective, never one per dot), and the half-step's
    vectors and norms are the reference's."""
    _, ref, port = runs
    for got in port:
        assert list(got[f"hs_{tag}_calls"]) == calls
    got = port[0]
    for key in ("u", "v"):
        np.testing.assert_allclose(got[f"hs_{tag}_{key}"],
                                   ref[f"hs_{tag}_{key}"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[f"hs_{tag}_norms"],
                               ref[f"hs_{tag}_norms"], rtol=1e-5)


@pytest.mark.parametrize("method", [m for m, _ in tw.SOLVER_CASES])
def test_sharded_solvers_match_dense_on_8_devices(runs, method):
    """Sharded against the port's single-device solve with the same draws
    (1e-5·σ_max; the 1e3 scale covers the scale-relative drop threshold of
    the distributed orthonormalization), and against the reference's
    sharded solve at the method's parity bound."""
    IN, ref, port = runs
    smax = np.linalg.svd(_d(IN["ss_A"]), compute_uv=False)[0]
    got = port[0]
    err = np.max(np.abs(got[f"ss_{method}"] - got[f"ss_{method}_single"]))
    assert err / smax < 1e-5, f"{method}: sharded vs single {err / smax:.2e}"
    err = np.max(np.abs(got[f"ss_{method}"] - ref[f"ss_{method}"]))
    assert err / smax < SOLVERS[method]["stol"]


def test_sharded_sparse_and_gram_operands(runs):
    IN, ref, port = runs
    dense = _d(IN["sp_dense"])
    got = port[0]
    assert np.max(np.abs(got["sp_mv"] - dense @ _d(IN["sp_p"]))) < 1e-4
    assert np.max(np.abs(got["sp_rmv"] - dense.T @ _d(IN["sp_q"]))) < 1e-4
    s_true = np.linalg.svd(dense, compute_uv=False)[:6]
    assert np.max(np.abs(got["sp_s"] - s_true)) / s_true[0] < 1e-5
    assert np.max(np.abs(got["sp_s"] - ref["sp_s"])) / s_true[0] \
        < SOLVERS["fsvd_blocked"]["stol"]
    assert int(got["sp_rank"]) == int(ref["sp_rank"]) == 7
