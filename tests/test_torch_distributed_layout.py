"""The port's operator placement, plan keys and guards on a gloo world of 8
CPU processes (``tests/torch_world.py``).

  * the three laws of tests/test_partition_property.py over every
    factorization of the 8 ranks into ("pod", "data", "model") axes, on
    fixed shapes that do and do not tile (placement round-trips bit for
    bit; block shapes tile the padded operand, and every rank's block has
    the block shape; ``ShardedOp.T`` commutes with placement);
  * tests/test_plan.py:228,245: ``auto`` resolves a sharded operand to
    ``fsvd_sharded``, the mesh is part of the runner key, and two solves
    on one placement build one runner;
  * tests/test_distributed.py:317,340: ``fsvd_sharded`` refuses the host
    loop (and a plain operand), and ``estimate_rank`` takes the fixed-k
    loop on a sharded operand by default;
  * a product's one collective carries each rank's local block;
  * ``sharding_mesh`` walks wrappers, the deprecated ``gk_sharded`` gives
    global bases, F-SVD runs on the transpose of a sharded operand, and
    a stacked (L, m, n) gradient leaf is compressed layer by layer.
"""
import numpy as np
import pytest

import torch_world as tw

SPEC_IDS = [tw.mesh_tag(s) for s in tw.LAYOUT_MESHES]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_distributed_layout")
    rng = np.random.default_rng(5)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    low = normal(64, 3) @ normal(3, 48)
    IN = {"plan_A": normal(96, 10) @ normal(10, 72),
          "small": normal(32, 16),
          "rank9": normal(40, 9) @ normal(9, 24),
          "stack_G": (low[None, None] + 1e-3 * normal(8, 2, 64, 48)).astype(
              np.float32)}
    np.savez(d / "in.npz", **IN)
    return IN, tw.run_port(tw.layout_cases, str(d), str(d / "in.npz"))


def _cases(ix):
    return [f"law/{ix}/{m}x{n}" for m, n in tw.LAYOUT_DIMS]


@pytest.mark.parametrize("ix", range(len(tw.LAYOUT_MESHES)), ids=SPEC_IDS)
def test_place_gather_round_trips_exactly(port, ix):
    _, ranks = port
    for key, (m, n) in zip(_cases(ix), tw.LAYOUT_DIMS):
        for got in ranks:
            assert list(got[f"{key}/shape"]) == [m, n]
            np.testing.assert_array_equal(got[f"{key}/dense"],
                                          ranks[0][f"{key}/dense"])
        assert got[f"{key}/dense"].shape == (m, n)


@pytest.mark.parametrize("ix", range(len(tw.LAYOUT_MESHES)), ids=SPEC_IDS)
def test_shard_shapes_tile_the_operand(port, ix):
    _, ranks = port
    for key, (m, n) in zip(_cases(ix), tw.LAYOUT_DIMS):
        r, c, mp, np_, bm, bn = (int(x) for x in ranks[0][f"{key}/tiling"])
        assert bm * r == mp and bn * c == np_
        assert 0 <= mp - m < r and 0 <= np_ - n < c
        assert {tuple(got[f"{key}/block"]) for got in ranks} == {(bm, bn)}


@pytest.mark.parametrize("ix", range(len(tw.LAYOUT_MESHES)), ids=SPEC_IDS)
def test_transpose_commutes_with_placement(port, ix):
    _, ranks = port
    for key, (m, n) in zip(_cases(ix), tw.LAYOUT_DIMS):
        got = ranks[0]
        assert list(got[f"{key}/t_shapes"]) == [n, m, n, m]
        dense = got[f"{key}/dense"]
        np.testing.assert_array_equal(got[f"{key}/t_dense"], dense.T)
        np.testing.assert_array_equal(got[f"{key}/pt_dense"], dense.T)
        assert float(got[f"{key}/t_mv"]) < 1e-5


def test_auto_resolves_sharded_and_mesh_keys_cache(port):
    _, ranks = port
    for got in ranks:
        assert bool(got["plan_auto"])
        assert list(got["plan_keys"]) == [True, True, True]


def test_sharded_compile_once(port):
    IN, ranks = port
    s_true = np.linalg.svd(IN["plan_A"].astype(np.float64),
                           compute_uv=False)[:4]
    for got in ranks:
        assert int(got["plan_traces"]) == 1
        for s in got["plan_s"]:
            np.testing.assert_allclose(s, s_true, rtol=1e-3)


@pytest.mark.parametrize("tag,rows,cols", [("8", 8, 1), ("24", 2, 4)])
def test_a_collective_carries_only_the_local_block(port, tag, rows, cols):
    """mv, rmatmat and to_dense of the 96 x 72 operand: one collective
    each, in which a rank sends its own partial or block (never a buffer
    of the global size) and receives the world's."""
    _, ranks = port
    bm, bn = 96 // rows, 72 // cols
    want = [[1, n, tw.WORLD * n] for n in (bm, bn * 3, bm * bn)]
    for got in ranks:
        assert got[f"payload_{tag}"].tolist() == want


def test_fsvd_sharded_rejects_host_loop(port):
    _, ranks = port
    for got in ranks:
        assert str(got["refuse_host"]).startswith("ValueError") \
            and "host_loop" in str(got["refuse_host"])
        assert str(got["refuse_dense"]).startswith("TypeError") \
            and "ShardedOp" in str(got["refuse_dense"])
        assert list(got["refuse_ok"]) == [4]


def test_estimate_rank_sharded_defaults_to_in_graph(port):
    _, ranks = port
    for got in ranks:
        assert int(got["ingraph_rank"]) == 9
        # an explicit host_loop=True is still the caller's to choose, and
        # dense operands keep the paper's early-exit host default
        assert "host loop" in str(got["ingraph_explicit"])
        assert "host loop" in str(got["ingraph_dense"])


def test_sharding_mesh_walks_wrappers(port):
    _, ranks = port
    for got in ranks:
        assert all(got["mesh_walk"])


def test_gk_sharded_returns_global_bases(port):
    IN, ranks = port
    A = IN["rank9"].astype(np.float64)
    got = ranks[0]
    P, Q = got["gk_P"].astype(np.float64), got["gk_Q"].astype(np.float64)
    assert P.shape == (24, 6) and Q.shape == (40, 7)
    np.testing.assert_allclose(P.T @ P, np.eye(6), atol=1e-5)
    np.testing.assert_allclose(Q.T @ Q, np.eye(7), atol=1e-5)
    # A P_k = Q_{k+1} B_{k+1,k}
    alphas, betas = got["gk_ab"].astype(np.float64)
    B = np.zeros((7, 6))
    B[np.arange(6), np.arange(6)] = alphas
    B[np.arange(1, 7), np.arange(6)] = betas
    np.testing.assert_allclose(A @ P, Q @ B, atol=1e-4 * np.linalg.norm(A))


def test_fsvd_on_the_transpose_of_a_sharded_operand(port):
    """The transpose's Lanczos seam is the inner operand's with the sides
    swapped (rows and columns of a ("data", "model") mesh)."""
    IN, ranks = port
    smax = float(np.linalg.svd(IN["rank9"].astype(np.float64),
                               compute_uv=False)[0])
    for got in ranks:
        assert np.max(np.abs(got["tr_s"] - got["tr_single"])) / smax < 1e-5


def test_stacked_gradient_leaf_compresses_by_layer(port):
    IN, ranks = port
    G = IN["stack_G"].astype(np.float64)
    mean_true = G.mean(0)
    for got in ranks:
        assert list(got["ef_shape_w"]) == [2, 64, 48]
        assert int(got["ef_shape_b"]) == 0          # a scalar for the bias
        assert list(got["stack_counts"]) == [1, 1]
        rel = np.linalg.norm(got["stack_mean"] - mean_true) \
            / np.linalg.norm(mean_true)
        assert rel < 5e-3
        np.testing.assert_allclose(got["stack_b"], mean_true[0, 0],
                                   rtol=1e-5)
