"""The sharded-vs-single-device battery of tests/test_solver_parity.py
(``test_sharded_matches_single_device``, ``test_sharded_parity_on_model_
axis_meshes``, ``test_sigma_bitwise_across_row_mesh_factorizations``,
``test_sigma_bitwise_run_to_run``) for the port, on a gloo world of 8
CPU processes, beside the reference on 8 forced host devices.

Every registered method runs on the parity zoo twice in the port: on the
plain CPU tensor and sharded over the 8 ranks, with the same draws
(generator seed 7; the GK methods also take the same injected q1 as the
reference).  Bounds: sharded against single-device at 1e-5·σ_max with
the subspace floors of the reference test where the spectrum has a gap;
sharded port against sharded reference at ``SOLVERS[method]["stol"]``·
σ_max, the single-device parity bound (the reference's sharded
``fsvd_blocked`` syncs the host per basis column, minutes on 8 host
devices, so its single-device solve, held to the sharded one at 1e-5 by
the reference, stands in); σ bit for bit across the (8,), (2, 4) and
(4, 2) row meshes, and from run to run.
"""
import numpy as np
import pytest

import torch_world as tw
from test_solver_parity import R, SOLVERS, ZOO

REFERENCE = """
from repro.api import SVDSpec, factorize
from repro.distributed.matvec import sharded_operator
from repro.launch.mesh import make_mesh
import repro.distributed.gk_dist  # registers fsvd_sharded
mesh8 = make_mesh((8,), ("data",))
SPECS = {%s}
for method, kw in SPECS.items():
    for name in [k[4:] for k in IN if k.startswith("zoo_")]:
        A = jnp.asarray(IN["zoo_" + name])
        q1 = jnp.asarray(IN["q1_" + name]) if method in (
            "fsvd", "fsvd_sharded") else None
        operand = A if method == "fsvd_blocked" else sharded_operator(A,
                                                                      mesh8)
        OUT[method + "/" + name] = factorize(
            operand, SVDSpec(method=method, rank=%d, **kw),
            key=jax.random.PRNGKey(7), q1=q1).s
""" % (", ".join(f"{m!r}: {c['spec']!r}" for m, c in SOLVERS.items()), R)

METHODS = sorted(SOLVERS)
NAMES = sorted(ZOO)
DATA8 = tw.mesh_tag(tw.ROW_MESHES[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distributed_parity")
    rng = np.random.default_rng(7)
    IN = {}
    for name in NAMES:
        A = np.asarray(ZOO[name][0], np.float32)
        IN[f"zoo_{name}"] = A
        IN[f"q1_{name}"] = (2.0 + rng.standard_normal(A.shape[0])).astype(
            np.float32)
    np.savez(d / "in.npz", **IN)
    proc = tw.start_reference(REFERENCE, str(d / "in.npz"),
                              str(d / "ref.npz"))
    port = tw.run_port(tw.parity_cases, str(d), str(d / "in.npz"))
    ref = tw.finish_reference(proc, str(d / "ref.npz"))
    return ref, port


def _smax(name):
    return float(np.linalg.svd(np.asarray(ZOO[name][0], np.float64),
                               compute_uv=False)[0])


def test_world_specs_are_the_parity_specs():
    assert tw.METHOD_SPECS == {m: c["spec"] for m, c in SOLVERS.items()}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_single_device(runs, method, name):
    ref, port = runs
    got = port[0]
    key = f"{method}/{name}"
    smax = _smax(name)
    for r in range(1, tw.WORLD):       # every rank holds the same answer
        np.testing.assert_array_equal(port[r][f"{key}/{DATA8}"],
                                      got[f"{key}/{DATA8}"])
    err = np.max(np.abs(got[f"{key}/{DATA8}"] - got[f"{key}/single"]))
    assert err / smax < 1e-5, \
        f"{method} on {name}: sharded σ deviates {err:.2e} vs σ_max {smax:.2e}"
    if ZOO[name][1]:
        cos = np.linalg.svd(got[f"{key}/single_V"].T @ got[f"{key}/{DATA8}_V"],
                            compute_uv=False)
        floor = 0.99 if method == "rsvd" else 0.9999
        assert cos.min() > floor, \
            f"{method} on {name}: sharded/single subspaces diverge " \
            f"(min cos {cos.min():.6f})"
    err = np.max(np.abs(got[f"{key}/{DATA8}"] - ref[key]))
    assert err / smax < SOLVERS[method]["stol"], \
        f"{method} on {name}: port vs reference σ {err / smax:.2e}"


@pytest.mark.parametrize("name", list(tw.MODEL_NAMES))
@pytest.mark.parametrize("method", METHODS)
def test_sharded_parity_on_model_axis_meshes(runs, method, name):
    """Meshes with a "model" (column) axis change the local GEMV shapes;
    values must still track the single-device run at f32 tolerance."""
    _, port = runs
    got = port[0]
    smax = _smax(name)
    for spec in tw.MODEL_MESHES:
        err = np.max(np.abs(got[f"{method}/{name}/{tw.mesh_tag(spec)}"]
                            - got[f"{method}/{name}/single"]))
        assert err / smax < 1e-5, \
            f"{method} on {name} mesh {spec}: σ deviates {err:.2e}"


@pytest.mark.parametrize("method", METHODS)
def test_sigma_bitwise_across_row_mesh_factorizations(runs, method):
    """σ bits must not depend on how the 8 row shards are spelled as mesh
    axes: (8,), (2, 4) and (4, 2) all sum the same 8 local partials in the
    same shard order."""
    _, port = runs
    for got in port:
        base = got[f"{method}/lowrank_noise/{DATA8}"]
        for spec in tw.ROW_MESHES[1:]:
            np.testing.assert_array_equal(
                base, got[f"{method}/lowrank_noise/{tw.mesh_tag(spec)}"],
                err_msg=f"{method}: σ bits differ between (8,)('data',) "
                        f"and {spec}")


@pytest.mark.parametrize("method", METHODS)
def test_sigma_bitwise_run_to_run(runs, method):
    _, port = runs
    got = port[0]
    np.testing.assert_array_equal(got[f"{method}/graded/{DATA8}"],
                                  got[f"{method}/graded/rerun"])
