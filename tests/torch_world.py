"""Two ways to run one distributed case on the CPU, for the port's
distributed tests:

  * :func:`run_reference` — the reference package in a subprocess that
    sees 8 forced host devices (as tests/test_distributed.py does), fed a
    ``.npz`` of inputs and writing a ``.npz`` of outputs;
  * :func:`run_port` — the port in a gloo world of 8 CPU processes
    (``repro_torch.launch.mesh.run_world``, ``spawn``, a ``FileStore``
    under the test's own directory, so parallel test workers never fight
    over a TCP port, and a short timeout, so a dead rank fails the test
    instead of hanging it).  Rank r writes ``rank<r>.npz``.

The world's functions live in modules that import neither JAX nor the
reference (spawn imports them in every rank): this one and the port.
``gpu_fsvd_case`` is the card's: two ranks share cuda:0 over gloo
(tests/test_torch_gpu.py).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
WORLD_TIMEOUT_S = 60.0          # a collective waits this long for a rank


def start_reference(body: str, inputs: str, outputs: str):
    """Start ``body`` in a fresh 8-device Python (it reads ``IN``, a dict
    of the inputs, and fills ``OUT``, saved to ``outputs``).  Returns the
    process; :func:`finish_reference` waits for it."""
    prog = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp
        import numpy as np
        IN = dict(np.load(%r, allow_pickle=False))
        OUT = {}
    """ % inputs) + textwrap.dedent(body) + textwrap.dedent("""
        np.savez(%r, **{k: np.asarray(v) for k, v in OUT.items()})
    """ % outputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", prog],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def finish_reference(proc, outputs: str, timeout: float = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"reference failed:\n{err[-4000:]}"
    return dict(np.load(outputs))


def run_port(fn, directory: str, inputs: str, world: int = WORLD) -> list:
    """Run ``fn(rank, world, inputs, directory)`` on every rank of a
    ``world``-process gloo world; returns each rank's ``rank<r>.npz`` as
    a dict."""
    from repro_torch.launch.mesh import run_world
    run_world(fn, world, os.path.join(directory, "rendezvous"),
              (inputs, directory), timeout_s=WORLD_TIMEOUT_S, threads=1)
    return [dict(np.load(os.path.join(directory, f"rank{r}.npz")))
            for r in range(world)]


def save_rank(directory: str, rank: int, out: dict) -> None:
    np.savez(os.path.join(directory, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


def _mesh_on(shape, axes, device_type):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, device_type=device_type)


def _mesh(shape, axes):
    return _mesh_on(shape, axes, "cpu")


def _gen(seed):
    import torch
    return torch.Generator().manual_seed(seed)


# --- tests/test_torch_distributed.py: the cases of tests/test_distributed.py

def distributed_cases(rank, world, inputs, directory):
    import warnings

    import torch

    from repro_torch.api import (DenseOp, GramOp, SparseOp, SVDSpec,
                                 estimate_rank, factorize)
    from repro_torch.configs.base import FsvdConfig
    from repro_torch.core.linop import ReproDeprecationWarning
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.gk_dist import fsvd_sharded, rank_sharded
    from repro_torch.distributed.matvec import (ShardedOp, collective_stats,
                                                place_operator,
                                                reset_collectives,
                                                sharded_operator)
    IN = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    out = {}
    mesh42 = _mesh((4, 2), ("data", "model"))
    mesh8 = _mesh((8,), ("data",))

    # test_sharded_matvec_matches_dense
    A = IN["mv_A"]
    op = ShardedOp(place_operator(A, mesh42), mesh42)
    out["mv_mv"] = op.mv(IN["mv_p"])
    out["mv_rmv"] = op.rmv(IN["mv_q"])
    out["mv_fused"] = op.mv_fused(IN["mv_p"], IN["mv_q"], 0.5)

    # test_distributed_fsvd_matches_dense (the deprecated shims)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        f = fsvd_sharded(IN["fs_A"], mesh42, 8, 40, q1=IN["fs_q1"])
        rk = rank_sharded(IN["fs_A"], mesh42, max_iters=100,
                          generator=_gen(3))
    out["fs_s"] = f.s
    out["fs_rank"] = int(rk.rank)
    out["fs_warned"] = sum(issubclass(w.category, ReproDeprecationWarning)
                           for w in caught)

    # test_multipod_mesh_axes
    mesh222 = _mesh((2, 2, 2), ("pod", "data", "model"))
    op = ShardedOp(place_operator(A, mesh222), mesh222)
    out["mp_mv"] = op.mv(IN["mv_p"])

    # test_compressed_mean_grads: rank r holds worker r's gradient
    cfg = FsvdConfig(compression_rank=8, compression_min_dim=32,
                     max_iters=24)
    grads = {"w": IN["cm_G"][rank], "tiny": IN["cm_small"][rank]}
    ef = {"w": torch.zeros(IN["cm_G"].shape[1:]), "tiny": torch.zeros(())}
    mean, new_ef, stats = C.compressed_mean_grads(grads, ef, "data", cfg,
                                                  mesh=mesh8)
    out["cm_mean"] = mean["w"]
    out["cm_tiny"] = mean["tiny"]
    out["cm_ef"] = new_ef["w"]
    out["cm_bytes"] = [float(stats.dense_bytes),
                       float(stats.compressed_bytes)]
    out["cm_counts"] = [stats.num_compressed, stats.num_plain]

    # test_ef_accumulates_what_compression_drops: DP-SGD on a quadratic
    cfg = FsvdConfig(compression_rank=2, compression_min_dim=8, max_iters=6)
    X, Wstar = IN["ef_X"][rank], IN["ef_W"]
    W = torch.zeros_like(Wstar)
    e = torch.zeros_like(Wstar)
    for _ in range(150):
        g = X.T @ (X @ (W - Wstar)) / X.shape[0]
        mean, new_e, _ = C.compressed_mean_grads({"w": g}, {"w": e}, "data",
                                                 cfg, mesh=mesh8)
        W, e = W - 0.1 * mean["w"], new_e["w"]
    out["ef_W"] = W

    # test_fused_step_is_one_collective_per_half_step
    for tag, shape, axes, backend in HALF_STEP_MESHES:
        mesh = _mesh(shape, axes)
        op = sharded_operator(IN["hs_A"], mesh, backend=backend)
        reset_collectives()
        u, nu = op.lanczos_step(op.place_basis(IN["hs_p"], "right"),
                                op.place_basis(IN["hs_q"], "left"), 0.4,
                                op.place_basis(IN["hs_Q"], "left"))
        calls = [collective_stats()["calls"]]
        reset_collectives()
        v, nv = op.lanczos_rstep(op.place_basis(IN["hs_q"], "left"),
                                 op.place_basis(IN["hs_p"], "right"), 0.2,
                                 op.place_basis(IN["hs_P"], "right"))
        calls.append(collective_stats()["calls"])
        out[f"hs_{tag}_calls"] = calls
        out[f"hs_{tag}_u"] = op.gather_basis(u, "left")
        out[f"hs_{tag}_v"] = op.gather_basis(v, "right")
        out[f"hs_{tag}_norms"] = [float(nu), float(nv)]

    # test_sharded_solvers_match_dense_on_8_devices
    A = IN["ss_A"]
    for method, kw in SOLVER_CASES:
        spec = SVDSpec(method=method, rank=8, **kw)
        q1 = IN["ss_q1"] if method == "fsvd_sharded" else None
        sh = factorize(sharded_operator(A, mesh8), spec, generator=_gen(7),
                       q1=q1)
        single = factorize(A, spec.replace(
            method="fsvd" if method == "fsvd_sharded" else method),
            generator=_gen(7), q1=q1)
        out[f"ss_{method}"] = sh.s
        out[f"ss_{method}_single"] = single.s

    # test_sharded_sparse_and_gram_operands
    sop = sharded_operator(SparseOp.fromdense(IN["sp_dense"]), mesh8)
    out["sp_mv"] = sop.mv(IN["sp_p"])
    out["sp_rmv"] = sop.rmv(IN["sp_q"])
    out["sp_s"] = factorize(sop, SVDSpec(method="fsvd_blocked", rank=6),
                            generator=_gen(8)).s
    gop = sharded_operator(GramOp(DenseOp(IN["sp_lr"])), mesh8)
    out["sp_rank"] = int(estimate_rank(gop, generator=_gen(11)).rank)
    save_rank(directory, rank, out)


HALF_STEP_MESHES = [("rows", (8,), ("data",), "xla"),
                    ("rows_pallas", (8,), ("data",), "pallas"),
                    ("pods", (2, 4), ("pod", "data"), "xla"),
                    ("model", (4, 2), ("data", "model"), "xla")]
SOLVER_CASES = [("fsvd_sharded", dict(max_iters=48)),
                ("fsvd_blocked", dict()),
                ("rsvd", dict(power_iters=3, oversample=10))]


# --- tests/test_torch_distributed_parity.py: the sharded solver battery

# SOLVERS[method]["spec"] of tests/test_solver_parity.py (the parity test
# asserts the two agree; this module cannot import JAX's zoo)
METHOD_SPECS = {
    "fsvd": dict(max_iters=48),
    "fsvd_blocked": dict(),
    "rsvd": dict(power_iters=3, oversample=10),
    "fsvd_sharded": dict(max_iters=48),
    "rbk": dict(passes=4, sketch_dim=16),
    "gnystrom": dict(sketch_dim=48),
}
GK_METHODS = ("fsvd", "fsvd_sharded")          # these take the injected q1
ROW_MESHES = [((8,), ("data",)), ((2, 4), ("pod", "data")),
              ((4, 2), ("pod", "data"))]
MODEL_MESHES = [((4, 2), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model"))]
MODEL_NAMES = ("lowrank_noise", "illcond", "wide")


def _solve(method, A, q1, mesh=None):
    """σ and V of ``method`` on A (sharded over ``mesh`` if given) with
    the shared draws: generator seed 7, and q1 for the GK methods."""
    from repro_torch.api import SVDSpec, factorize
    from repro_torch.distributed.matvec import sharded_operator
    spec = SVDSpec(method=method, rank=8, **METHOD_SPECS[method])
    if mesh is None:
        if method == "fsvd_sharded":
            spec = spec.replace(method="fsvd")
        operand = A
    else:
        operand = sharded_operator(A, mesh)
    out = factorize(operand, spec, generator=_gen(7),
                    q1=q1 if method in GK_METHODS else None)
    return out.s, out.V


def mesh_tag(spec) -> str:
    """"data8", "pod2,data4", ... for a (shape, axes) mesh spec."""
    shape, axes = spec
    return ",".join(f"{a}{n}" for n, a in zip(shape, axes))


def parity_cases(rank, world, inputs, directory):
    import torch
    IN = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    names = sorted(k[4:] for k in IN if k.startswith("zoo_"))
    meshes = {spec: _mesh(*spec) for spec in ROW_MESHES + MODEL_MESHES}
    out = {}
    for method in sorted(METHOD_SPECS):
        for name in names:
            A, q1 = IN[f"zoo_{name}"], IN[f"q1_{name}"]
            key = f"{method}/{name}"
            out[f"{key}/single"], out[f"{key}/single_V"] = _solve(method, A,
                                                                  q1)
            for spec in ROW_MESHES[:1] + (MODEL_MESHES if name in
                                          MODEL_NAMES else []):
                s, V = _solve(method, A, q1, meshes[spec])
                out[f"{key}/{mesh_tag(spec)}"] = s
                out[f"{key}/{mesh_tag(spec)}_V"] = V
        A, q1 = IN["zoo_lowrank_noise"], IN["q1_lowrank_noise"]
        for spec in ROW_MESHES[1:]:
            out[f"{method}/lowrank_noise/{mesh_tag(spec)}"] = _solve(
                method, A, q1, meshes[spec])[0]
        A, q1 = IN["zoo_graded"], IN["q1_graded"]
        out[f"{method}/graded/rerun"] = _solve(method, A, q1,
                                               meshes[ROW_MESHES[0]])[0]
    save_rank(directory, rank, out)


# --- tests/test_torch_distributed_layout.py: placement, plans, guards

# every factorization of 8 into mesh axes under the canonical names
# (tests/test_partition_property.py's MESHES)
LAYOUT_MESHES = [((8,), ("data",)), ((8,), ("model",)),
                 ((2, 4), ("pod", "data")), ((4, 2), ("pod", "data")),
                 ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
                 ((2, 2, 2), ("pod", "data", "model"))]
LAYOUT_DIMS = [(1, 1), (7, 13), (48, 48), (33, 5), (16, 40)]


def layout_cases(rank, world, inputs, directory):
    import torch

    import repro_torch.core.gk as gk_mod
    from repro_torch.api import (GramOp, ScaledOp, SVDSpec, TransposedOp,
                                 estimate_rank, factorize, plan,
                                 resolve_method, trace_count)
    from repro_torch.api.plan import clear_plan_cache
    from repro_torch.configs.base import FsvdConfig
    from repro_torch.core.operators import DenseOp, sharding_mesh
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.gk_dist import gk_sharded
    from repro_torch.distributed.partition import (operator_counts,
                                                   padded_operand_shape,
                                                   place_operator,
                                                   shard_shape)
    from repro_torch.distributed.matvec import sharded_operator
    IN = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    out = {}

    # the three placement laws over every factorization of the 8 ranks
    for ix, spec in enumerate(LAYOUT_MESHES):
        mesh = _mesh(*spec)
        for m, n in LAYOUT_DIMS:
            key = f"law/{ix}/{m}x{n}"
            A = torch.randn(m, n, generator=_gen(1000 * ix + m + n))
            op = sharded_operator(A, mesh)
            out[f"{key}/shape"] = list(op.shape)
            out[f"{key}/dense"] = op.to_dense()
            r, c = operator_counts(mesh)
            mp, np_ = padded_operand_shape((m, n), mesh)
            out[f"{key}/tiling"] = [r, c, mp, np_, *shard_shape((mp, np_),
                                                                mesh)]
            out[f"{key}/block"] = list(place_operator(
                torch.zeros(mp, np_), mesh).shape)
            t_then_place = sharded_operator(A.T, mesh)
            place_then_t = sharded_operator(A, mesh).T
            out[f"{key}/t_shapes"] = [*t_then_place.shape,
                                      *place_then_t.shape]
            out[f"{key}/t_dense"] = t_then_place.to_dense()
            out[f"{key}/pt_dense"] = place_then_t.to_dense()
            q = torch.randn(m, generator=_gen(7 + m))
            out[f"{key}/t_mv"] = float(
                (t_then_place.mv(q) - place_then_t.mv(q)).abs().max()
                / (torch.linalg.vector_norm(A) + 1e-30))

    mesh8 = _mesh((8,), ("data",))
    mesh24 = _mesh((2, 4), ("data", "model"))
    A = IN["plan_A"]
    # tests/test_plan.py: auto resolves to fsvd_sharded, the mesh keys
    op8, op24 = sharded_operator(A, mesh8), sharded_operator(A, mesh24)
    out["plan_auto"] = resolve_method(SVDSpec(method="auto", tol=1e-2),
                                      op8) == "fsvd_sharded"
    p = plan(SVDSpec(method="fsvd_sharded", rank=4), like=op8)
    k8, k24 = p.operand_key(op8), p.operand_key(op24)
    out["plan_keys"] = [k8 is not None, k24 is not None, k8 != k24]
    clear_plan_cache(reset_stats=True)
    t0 = trace_count()
    spec = SVDSpec(method="fsvd_sharded", rank=4, max_iters=20)
    f1 = plan(spec, like=op8).solve(op8, generator=_gen(7))
    f2 = plan(spec, like=op8).solve(op8, generator=_gen(8))
    out["plan_traces"] = trace_count() - t0
    out["plan_s"] = torch.stack([f1.s, f2.s])

    # a product's collective carries each rank's local block or partial:
    # (calls, floats sent, floats received) of mv, rmatmat and to_dense
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    X = torch.randn(96, 3, generator=_gen(9))
    for tag, operand in [("8", op8), ("24", op24)]:
        rows = []
        for fn in (lambda: operand.mv(A[0]), lambda: operand.rmatmat(X),
                   operand.to_dense):
            reset_collectives()
            fn()
            st = collective_stats()
            rows.append([st["calls"], st["floats_sent"],
                         st["floats_received"]])
        out[f"payload_{tag}"] = rows

    # fsvd_sharded refuses the host loop and a plain operand
    op = sharded_operator(IN["small"], mesh8)
    for tag, operand, spec in [
            ("host", op, SVDSpec(method="fsvd_sharded", rank=4,
                                 host_loop=True)),
            ("dense", IN["small"], SVDSpec(method="fsvd_sharded", rank=4))]:
        try:
            factorize(operand, spec, generator=_gen(1))
            out[f"refuse_{tag}"] = ""
        except (ValueError, TypeError) as e:
            out[f"refuse_{tag}"] = f"{type(e).__name__}: {e}"
    out["refuse_ok"] = list(factorize(
        op, SVDSpec(method="fsvd_sharded", rank=4),
        generator=_gen(1)).s.shape)

    # estimate_rank's default flips to the fixed-k loop on a sharded operand
    def no_host_loop(*a, **kw):
        raise AssertionError("sharded estimate_rank took the host loop")

    real = gk_mod.gk_bidiag_host
    gk_mod.gk_bidiag_host = no_host_loop
    try:
        op = sharded_operator(IN["rank9"], mesh8)
        out["ingraph_rank"] = int(estimate_rank(op, generator=_gen(2)).rank)
        for tag, operand, spec in [("explicit", op,
                                    SVDSpec(host_loop=True)),
                                   ("dense", IN["rank9"], None)]:
            try:
                estimate_rank(operand, spec, generator=_gen(2))
                out[f"ingraph_{tag}"] = ""
            except AssertionError as e:
                out[f"ingraph_{tag}"] = str(e)
    finally:
        gk_mod.gk_bidiag_host = real

    # wrappers report the mesh; the legacy GK shim gathers its bases
    op = sharded_operator(IN["rank9"], mesh24)
    out["mesh_walk"] = [sharding_mesh(w) is mesh24 for w in (
        op, GramOp(op), TransposedOp(op), ScaledOp(2.0, TransposedOp(op)),
        sharded_operator(GramOp(DenseOp(IN["rank9"])), mesh24))] + [
        sharding_mesh(DenseOp(IN["rank9"])) is None]
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = gk_sharded(IN["rank9"], mesh24, 6,
                         q1=2.0 + torch.randn(40, generator=_gen(3)))
    out["gk_P"], out["gk_Q"] = res.P, res.Q
    out["gk_ab"] = torch.stack([res.alphas, res.betas])
    # GK on the transpose of a sharded operand: its seam swaps sides
    spec = SVDSpec(method="fsvd", rank=4, max_iters=20)
    q1 = 2.0 + torch.randn(24, generator=_gen(4))
    out["tr_s"] = factorize(op.T, spec, q1=q1).s
    out["tr_single"] = factorize(IN["rank9"].T.contiguous(), spec, q1=q1).s

    # a stacked (L, m, n) leaf is compressed layer by layer
    cfg = FsvdConfig(compression_rank=4, compression_min_dim=16,
                     max_iters=12)
    G = IN["stack_G"][rank]
    ef = C.init_error_feedback({"w": G, "b": G[0, 0]}, cfg)
    out["ef_shape_w"], out["ef_shape_b"] = list(ef["w"].shape), ef["b"].dim()
    mean, _, stats = C.compressed_mean_grads({"w": G, "b": G[0, 0]}, ef,
                                             "data", cfg, mesh=mesh8)
    out["stack_mean"] = mean["w"]
    out["stack_b"] = mean["b"]
    out["stack_counts"] = [stats.num_compressed, stats.num_plain]
    save_rank(directory, rank, out)


# --- tests/test_torch_gpu.py: two ranks on one card

def gpu_fsvd_case(rank, world, inputs, directory):
    """fsvd_sharded over (world,) ("data",) on cuda:0 with the stage-1
    kernels, beside the single-device port on the same card and q1."""
    import torch

    from repro_torch.api import DenseOp, SVDSpec, factorize
    from repro_torch.distributed.matvec import sharded_operator
    from repro_torch.kernels import gk_step as gs
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    IN = {k: torch.from_numpy(v).cuda() for k, v in np.load(inputs).items()}
    spec = SVDSpec(method="fsvd_sharded", rank=8, max_iters=48,
                   backend="pallas")
    op = sharded_operator(IN["A"], _mesh_on((world,), ("data",), "cuda"),
                          backend="pallas")
    gs.reset_launches()
    sharded = factorize(op, spec, q1=IN["q1"])
    launches = dict(gs.LAUNCHES)
    single = factorize(DenseOp(IN["A"], backend="pallas"),
                       spec.replace(method="fsvd"), q1=IN["q1"])
    save_rank(directory, rank, {
        "sharded": sharded.s.cpu(), "single": single.s.cpu(),
        "launches": [launches["mv_qtv"], launches["rmv_qtv"]]})
