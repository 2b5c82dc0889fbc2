"""The port's sharded training path against the reference and against its
own single-device step, on the CPU.

  * ``logical_to_spec`` / ``param_shardings`` entry for entry against the
    reference's, over ``jax.sharding.AbstractMesh`` (2, 4), (4, 2),
    (2, 2, 2), (16, 16) and (2, 16, 16), for every leaf of every registry
    arch at full size (no devices needed; the port takes a {name: size}
    mapping), and ``spec_for_batch`` likewise;
  * in gloo worlds of CPU processes (``tests/torch_train_world.py``; each
    world spawned once for the module): the tensor-parallel sharded step
    of three reduced archs (stablelm: heads and kv heads split; gemma2:
    kv heads whole on (1, 4); deepseek-v2: MLA with experts) on (2, 2) and
    (1, 4) ("data", "model"), stablelm's also on (1, 2) and (4, 1),
    against the single-device step on the global batch (loss within 1e-5
    relative, gradients and updated parameters within 1e-4 of each
    leaf's max, tests/torch_lm_ref.py's bounds), and the reduced MoE
    arch's on (2, 2), (1, 2) and (2, 1) at the same bounds with no slot
    dropped and no aux loss; prefill and two decode tokens on (2, 2) and
    (1, 4) against one device; ``psum_large`` bit for bit the
    gather-then-sum ``psum``; the
    expert-parallel ``moe_block`` on (1, 2) and (2, 2)
    against the single-device ``_local_moe`` on each batch shard (y within
    1e-5 of max |y|, gradients within 1e-4); the reference's
    ``test_partition_rules_divisibility_fallback`` and
    ``test_sharded_train_step_runs``; reshard-on-restore (a checkpoint of
    a (2, 2) Trainer restores on (4,) and on one process with equal
    values); the compressed step on ("pod",) (2,) against the dense-mean
    step (the same loss and small leaves, the byte accounting
    ``k (m + n) + r m`` against ``m n``, and the same bytes as the
    reference's ``build_compressed_train_step``, which runs in a
    subprocess with 8 forced host devices beside the worlds).
Every rank must return the same global results bit for bit.  The
sharded step's gradient exchange (one all-to-all of each rank's own
blocks) gives every rank's blocks bit for bit what the whole-gather
exchange gives, on (2, 2), (4, 1) and (1, 4); the step refuses a mesh
whose exchange cannot fit a rank (deepseek-v2-236b's parameters whole on
an 80 GB card).
"""
import functools
import os

import numpy as np
import pytest
import torch

import torch_world as tw
import torch_train_world as ttw
from repro.compat import abstract_mesh
from repro.configs import get_arch as ref_get_arch
from repro.distributed import partition as RP
from repro.launch import input_specs as RI
from repro_torch.configs import ARCHS, get_arch
from repro_torch.distributed import partition as TP
from repro_torch.launch import input_specs as TI

REFERENCE = """
from repro.configs import get_arch
from repro.configs.base import FsvdConfig, OptimConfig
from repro.data.synthetic import LMBatchSpec, lm_batch
from repro.launch.mesh import make_mesh
from repro.runtime.steps import build_compressed_train_step, init_state
mesh = make_mesh((2,), ("pod",))
cfg = get_arch("stablelm-1.6b").reduced()
opt = OptimConfig(name="sgd", lr=0.1, warmup_steps=0, grad_clip=1e9)
step = build_compressed_train_step(cfg, opt, mesh, FsvdConfig(
    compression_rank=4, compression_min_dim=64, max_iters=16))
with mesh:
    _, met = jax.jit(step)(init_state(cfg, opt, jax.random.PRNGKey(0)),
                           lm_batch(LMBatchSpec(4, 32, cfg.vocab_size), 0, 0))
for k in ("loss", "skipped", "comm_dense_bytes", "comm_compressed_bytes"):
    OUT[k] = met[k]

# the loss and gradients of the (2, 4) mesh step on the port's weights
from repro.launch import input_specs as ispec
from repro.models import model as RM
mesh = make_mesh((2, 4), ("data", "model"))


def build(node, path):
    if isinstance(node, dict):
        return {k: build(v, f"{path}:{k}") for k, v in node.items()}
    assert IN[path].shape == node.shape, path
    return jnp.asarray(IN[path], node.dtype)


def flat(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            flat(v, f"{path}:{k}")
    else:
        OUT[path] = node


for tag, pre, arch in (("mesh24", "ref24", "stablelm-1.6b"),
                       ("mesh24zb", "ref24zb", "zamba2-1.2b")):
    cfg = get_arch(arch).reduced()
    struct, shard = ispec.params_struct_and_shardings(cfg, mesh)
    batch = {k: jnp.asarray(IN[pre + k]) for k in ("tokens", "labels")}
    with mesh:
        loss, grads = jax.jit(
            jax.value_and_grad(lambda p, b: RM.loss_fn(p, b, cfg, mesh)[0]),
            in_shardings=(shard, ispec.batch_shardings(batch, mesh)))(
                build(struct, pre + "p"), batch)
    OUT[tag + "_loss"] = loss
    flat(grads, tag + "_g")
"""

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


@functools.lru_cache(maxsize=None)
def _ref_init(arch):
    return RI.abstract_init(ref_get_arch(arch))


@functools.lru_cache(maxsize=None)
def _port_init(arch):
    return TI.abstract_init(get_arch(arch))


def _pairs(logical, struct, path=""):
    """(path, axes, shape) of every leaf of a logical-axes tree."""
    if isinstance(logical, dict):
        for k in sorted(logical):
            yield from _pairs(logical[k], struct[k], f"{path}/{k}")
    else:
        yield path, tuple(logical), tuple(struct.shape)


def _norm(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_logical_to_spec_matches_reference(shape, axes):
    amesh = abstract_mesh(shape, axes)
    sizes = dict(zip(axes, shape))
    n = 0
    for arch in sorted(ARCHS):
        r_struct, r_logical = _ref_init(arch)
        p_struct, p_logical = _port_init(arch)
        ref = list(_pairs(r_logical, r_struct))
        port = list(_pairs(p_logical, p_struct))
        assert [p for p, _, _ in ref] == [p for p, _, _ in port], arch
        specs = TP.param_shardings(p_logical, p_struct, sizes)
        for (path, r_axes, r_shape), (_, p_axes, p_shape) in zip(ref, port):
            assert (r_axes, r_shape) == (p_axes, p_shape), (arch, path)
            want = _norm(RP.logical_to_spec(r_axes, r_shape, amesh))
            got = TP.logical_to_spec(p_axes, p_shape, sizes)
            assert got == want, (arch, path, got, want)
            node = specs
            for part in path.strip("/").split("/"):
                node = node[part]
            assert node == got, (arch, path)
            assert "pod" not in TP.spec_axes(got)
            n += 1
    assert n > 150


@pytest.mark.parametrize("batch,ndim,seq", [(8, 2, False), (4, 3, False),
                                            (1, 2, True), (1, 4, True),
                                            (3, 2, False)])
def test_spec_for_batch_matches_reference(batch, ndim, seq):
    for shape, axes in MESHES[:3]:
        want = RP.spec_for_batch(abstract_mesh(shape, axes), batch, ndim,
                                 seq_axis_shard=seq)
        got = TP.spec_for_batch(dict(zip(axes, shape)), batch, ndim,
                                seq_axis_shard=seq)
        assert got == _norm(want), (shape, got, want)


def test_partition_rules_divisibility_fallback():
    """tests/test_distributed.py's case on the port's rules."""
    mesh = {"data": 2, "model": 4}
    s1 = TP.logical_to_spec(("embed", "heads", "head_dim"), (64, 8, 32), mesh)
    s2 = TP.logical_to_spec(("embed", "kv_heads", "head_dim"), (64, 3, 32),
                            mesh)            # 3 % 4 != 0 -> replicated
    s3 = TP.logical_to_spec(("experts", "embed", "mlp"), (8, 64, 128), mesh)
    assert "model" in s1
    assert "model" not in s2
    # conflict rule: experts claim model; mlp must NOT re-claim it
    assert s3.count("model") == 1 and "data" in s3


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True)


def test_compressed_step_refuses_moe_and_meshes_without_pods():
    from repro_torch.configs import FsvdConfig, OptimConfig
    from repro_torch.runtime.steps import build_compressed_train_step
    with pytest.raises(ValueError, match="MoE"):
        build_compressed_train_step(get_arch("olmoe-1b-7b").reduced(),
                                    OptimConfig(), {"pod": 2}, FsvdConfig())
    with pytest.raises(ValueError, match="pod"):
        build_compressed_train_step(get_arch("stablelm-1.6b").reduced(),
                                    OptimConfig(), {"data": 2}, FsvdConfig())


@pytest.mark.parametrize("arch, shape, fits", [
    ("stablelm-1.6b", (16, 16), True),
    ("olmoe-1b-7b", (16, 16), True),
    ("stablelm-1.6b", (2, 2), True),
    ("olmoe-1b-7b", (1, 2), True),
    ("starcoder2-15b", (16, 16), True),
    ("deepseek-v2-236b", (16, 16), True),
    ("llava-next-34b", (16, 16), True),
    ("llava-next-34b", (2, 1), False),
    ("llava-next-34b", (2, 2), True)])
def test_sharded_step_refuses_a_mesh_whose_gradients_do_not_fit(
        monkeypatch, arch, shape, fits):
    """A rank of the sharded step holds the parameters whole beside its
    gradient, then its gradient beside the rows it sends, then those
    beside the rows it receives, then those beside the blocks its gathers
    rebuild: on an 80 GB card the production mesh fits stablelm-1.6b,
    olmoe-1b-7b and starcoder2-15b (the whole-gather exchange refused all
    three: world + 1 gradients) and, since a leaf whole on "model" sends
    each rank of its batch group 1/16 of its block, deepseek-v2's 236e9
    parameters (their MLA latents and router whole on "model") and
    llava-next-34b's attention weights (56 heads whole on "model"; 230.6
    GB sent a rank when the rank at "model" position 0 sent every rank
    its block, 4.3 GB now); llava-next-34b's 34e9 fit a (2, 2) mesh,
    whose "model" axis halves its heads, MLP and vocabulary, not a
    (2, 1) one that holds them whole.  The bound is the largest moment to
    the byte."""
    from repro_torch.runtime import steps as S
    monkeypatch.setattr(S, "_device_bytes", lambda mesh: 80 * 10 ** 9)
    mesh = dict(zip(("data", "model"), shape))
    layout = S.param_layout(get_arch(arch), mesh)
    b = S.exchange_bytes(layout, mesh)
    need = max(b["params"] + b["grad"], b["grad"] + b["sent"],
               b["sent"] + b["received"], b["received"] + b["gathered"])
    if arch == "llava-next-34b" and shape == (16, 16):
        assert b["sent"] < 5 * 10 ** 9
    world = shape[0] * shape[1]
    assert (need <= 80 * 10 ** 9) == fits
    if world == 256:
        # the whole-gather exchange's bound, (world + 1) gradients
        assert need < (world + 1) * b["grad"] / 50
    if fits:
        S._check_exchange_fits(layout, mesh)
    else:
        with pytest.raises(ValueError, match="more than the device"):
            S._check_exchange_fits(layout, mesh)
    S._check_exchange_fits(layout, mesh, device_bytes=need)
    with pytest.raises(ValueError, match="more than the device"):
        S._check_exchange_fits(layout, mesh, device_bytes=need - 1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("reference")
    np.savez(ref_dir / "in.npz", **ttw.reference_inputs())
    proc = tw.start_reference(REFERENCE, str(ref_dir / "in.npz"),
                              str(ref_dir / "ref.npz"))
    out = {}
    for world, fn in ((4, ttw.world4_cases), (2, ttw.world2_cases),
                      (8, ttw.world8_cases)):
        d = tmp_path_factory.mktemp(f"world{world}")
        np.savez(d / "in.npz", none=np.zeros(1))
        out[world] = (str(d), tw.run_port(fn, str(d), str(d / "in.npz"),
                                          world=world))
    out["reference"] = tw.finish_reference(proc, str(ref_dir / "ref.npz"))
    return out


def test_every_rank_returns_the_same_bits(worlds):
    # each rank's own batch shard, or its own blocks
    per_rank = {"moe22", "moe12", "sv", "ref24_g", "ref24_lo", "ref24_hi",
                "ref24zb_g", "ref24zb_lo", "ref24zb_hi"}
    for world in (2, 4, 8):
        ranks = worlds[world][1]
        for key in ranks[0]:
            if any(key.startswith(p) for p in per_rank) \
                    or key.endswith(("_err",)):
                continue
            for r in range(1, world):
                np.testing.assert_array_equal(ranks[r][key], ranks[0][key],
                                              err_msg=f"{key} on rank {r}")


@pytest.mark.parametrize("world,tag", [(4, "dm22"), (4, "ms22"),
                                       (2, "ms12"), (2, "ms21"),
                                       (4, "dm41"), (4, "dm14"),
                                       (4, "ms41"), (4, "ms14"),
                                       (2, "dm12"), (4, "gm22"),
                                       (4, "gm14"), (4, "dv22"),
                                       (4, "dv14"), (4, "mb22"),
                                       (4, "mb14"), (4, "zb22"),
                                       (4, "zb14")])
def test_sharded_step_matches_single_device(worlds, world, tag):
    """The sharded step against one device on the global batch: a dense
    reduced arch tensor parallel over "model" on (2, 2), (1, 2) and (1, 4)
    and data parallel on (4, 1) ("dm.."), gemma2's with its kv heads
    whole on (1, 4) ("gm.."), deepseek-v2's MLA and experts ("dv.."),
    the Mamba2 layers by heads over "model" (mamba2 "mb..", zamba2
    "zb..": 16 SSD heads, 8 or 4 a rank), and the reduced MoE arch,
    experts over "model" and the batch over "data", on (2, 2), (1, 2)
    and (2, 1) with no slot dropped and no aux loss ("ms..", "dv..": the
    two terms it takes by batch shard)."""
    if tag[:2] in ("mb", "zb"):
        # the Mamba2 leaves computed by "model" block: wz, wx, out_norm,
        # w_out of each of the two layers (zamba2: and its shared block's
        # attention and MLP weights)
        assert int(worlds[world][1][0][f"{tag}_blocked"]) >= 8
    for got in worlds[world][1]:
        loss, want = float(got[f"{tag}_loss"]), float(got[f"{tag}_loss_single"])
        assert abs(loss - want) <= 1e-5 * abs(want)
        assert abs(float(got[f"{tag}_gnorm"])
                   - float(got[f"{tag}_gnorm_single"])) \
            <= 1e-5 * float(got[f"{tag}_gnorm_single"])
        assert float(got[f"{tag}_grad_err"]) < 1e-4
        assert float(got[f"{tag}_param_err"]) < 1e-4


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "1x4"])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_gradient_exchange_matches_whole_gather(worlds, mesh, kind):
    """Each rank's summed gradient blocks, the optimizer's input, are bit
    for bit what the whole-gather exchange gives (every rank's whole
    gradient, added over the batch axes in shard order, the rank's block
    cut out), on every leaf, for a dense and a MoE arch at its published
    capacity and aux loss; the norm, summed by owned blocks, within 1e-6
    of the whole-gather norm; one all-to-all in the exchange, and in the
    step beside it only the tensor-parallel sums' (none without a
    "model" axis)."""
    tag = f"ex{mesh}{kind}"
    for got in worlds[4][1]:
        assert int(got[f"{tag}_leaves"]) > 10
        assert int(got[f"{tag}_differ"]) == 0
        assert float(got[f"{tag}_norm_rel"]) < 1e-6
        assert np.isfinite(float(got[f"{tag}_loss"]))
        assert int(got[f"{tag}_a2a_calls"]) == 1
        steps = int(got[f"{tag}_step_a2a_calls"])
        assert steps == 1 if mesh == "4x1" else steps > 1
    # the loss and the norm: the same bits on every rank
    ranks = worlds[4][1]
    for key in (f"{tag}_loss", f"{tag}_gnorm"):
        assert all(float(r[key]) == float(ranks[0][key]) for r in ranks)


# the sequence blocks of a decode cache, and the part of one device's cache
# (on the same rows) a rank holds: None where the Mamba2 state, split by
# heads, sits beside a conv window kept whole
SERVE_SPLITS = {"sv22": (1, 2), "sv14": (1, 4), "svgm14": (4, 4),
                "svdv14": (4, 4), "svgw14": (4, 4), "svb41": (4, 4),
                "svzb22": (2, None), "svmb14": (1, None)}


@pytest.mark.parametrize("tag", list(SERVE_SPLITS))
def test_tp_prefill_and_decode_match_single_device(worlds, tag):
    """Prefill and two decode tokens (``torch_train_world.SERVE_CASES``),
    each rank with its serving blocks and its block of the cache padded
    to 32 positions, against one device on the rank's rows: logits within
    1e-5 of max |logit|, the same bits on every rank of a "model" group.
    The cache a rank holds is its kv heads' where they divide "model"
    (stablelm), else a block of its sequence: over "model" for gemma2's 2
    kv heads on (1, 4), with its heads split or, with 6 heads, whole, and
    for deepseek-v2's MLA latents; over "data" for a batch of one, the
    whole batch on every rank (stablelm on (4, 1); zamba2 on (2, 2), its
    kv heads and Mamba2 state by heads over "model")."""
    ranks = worlds[4][1]
    M = 2 if tag.endswith("22") else 4
    blocks, part = SERVE_SPLITS[tag]
    for got in ranks:
        assert float(got[f"{tag}_logit_err"]) < 1e-5
        assert int(got[f"{tag}_seq_blocks"]) == blocks
        if part is not None:
            whole = int(got[f"{tag}_cache_bytes_single"])
            assert int(got[f"{tag}_cache_bytes"]) * part == whole
        else:
            assert int(got[f"{tag}_cache_bytes"]) < int(
                got[f"{tag}_cache_bytes_single"])
    for r in range(0, 4, M):
        for q in range(r, r + M):
            np.testing.assert_array_equal(ranks[q][f"{tag}_logit_sums"],
                                          ranks[r][f"{tag}_logit_sums"])


@pytest.mark.parametrize("mesh,kind", [("2x2", "hybrid"), ("1x4", "hybrid"),
                                       ("1x4", "whole")])
def test_gradient_exchange_keeps_leaves_whole_on_model(worlds, mesh, kind):
    """The exchange's two classes of leaves on zamba2 (the Mamba2 conv's
    weight and bias: split over "model" by the rules, whole in the layer,
    summed over "model") and on a reduced arch whose 6 heads do not
    divide a 4-way "model" axis (its attention weights whole on "model",
    each rank sent 1/4 of their blocks): each rank's summed blocks bit
    for bit the whole gather's, the norm within 1e-6, one all-to-all in
    the exchange."""
    tag = f"ex{mesh}{kind}"
    ranks = worlds[4][1]
    for got in ranks:
        assert int(got[f"{tag}_leaves"]) > 10
        assert int(got[f"{tag}_differ"]) == 0
        assert float(got[f"{tag}_norm_rel"]) < 1e-6
        assert int(got[f"{tag}_a2a_calls"]) == 1
    if kind == "whole":
        # the attention weights travel as slices: more than the norms
        assert int(ranks[0][f"{tag}_sliced_bytes"]) > 100 * int(
            ranks[0]["ex1x4dense_sliced_bytes"])
    for key in (f"{tag}_loss", f"{tag}_gnorm"):
        assert all(float(r[key]) == float(ranks[0][key]) for r in ranks)


@pytest.mark.parametrize("mesh", ["22", "14"])
def test_large_sum_matches_gather_then_sum(worlds, mesh):
    """``psum_large`` (one all-to-all of slices, their sums, one
    all-gather) against ``psum`` (one all-gather, the parts added in
    shard order) over every group of (2, 2) and (1, 4), one axis order
    against the mesh's: the same bits for f32, bf16 and f64 tensors of
    ragged sizes, with fewer bytes received."""
    for got in worlds[4][1]:
        assert int(got[f"rd{mesh}_differ"]) == 0
        assert int(got[f"rd{mesh}_bytes"]) < int(got[f"rd{mesh}_gather_bytes"])


@pytest.mark.parametrize("world,tag", [(2, "moe12"), (4, "moe22")])
def test_ep_moe_block_matches_local_moe(worlds, world, tag):
    for got in worlds[world][1]:
        assert float(got[f"{tag}_y_err"]) < 1e-5
        for part in ("expert", "router", "x"):
            assert float(got[f"{tag}_{part}_grad_err"]) < 1e-4, part
        assert abs(float(got[f"{tag}_aux"]) - float(got[f"{tag}_aux_want"])) \
            <= 1e-6 * abs(float(got[f"{tag}_aux_want"]))
    # the ranks of one EP group hold the same y bit for bit
    ranks = worlds[world][1]
    mp = 2
    for r in range(0, world, mp):
        assert all(ranks[r + j][f"{tag}_y_sum"] == ranks[r][f"{tag}_y_sum"]
                   for j in range(mp))


def test_tp_step_matches_reference_on_a_model_mesh(worlds):
    """The port's tensor-parallel step of reduced stablelm on (2, 4)
    ("data", "model": heads, kv heads, the MLP's width and the vocabulary
    split four ways) against the reference's loss and gradients on a
    (2, 4) mesh of 8 host devices (GSPMD's split of the same step), on
    the same weights (the port's init, carried over by
    ``bridge.reference_tree``) and batch: the loss within 1e-5 relative,
    each rank's block of each gradient leaf within 1e-4 of that leaf's
    max (tests/torch_lm_ref.py's bounds)."""
    _hold_to_reference(worlds, "mesh24", "ref24")


def test_mamba2_split_matches_reference_on_a_model_mesh(worlds):
    """The port's step of reduced zamba2 on (2, 4): its Mamba2 layers by
    heads over "model" (16 SSD heads, 4 a rank; the conv's leaves whole,
    the gated norm's sum of squares summed over "model") and its shared
    attention block by heads, against the reference's GSPMD step on a
    (2, 4) mesh of 8 host devices on the same weights and batch, at the
    same bounds."""
    _hold_to_reference(worlds, "mesh24zb", "ref24zb")


def _hold_to_reference(worlds, ref_tag, tag):
    from repro_torch import bridge
    ref = worlds["reference"]
    tree: dict = {}
    for key, v in ref.items():
        if key.startswith(f"{ref_tag}_g:"):
            *path, leaf = key.split(":")[1:]
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
    want = bridge.named_tensors(tree, device="cpu")
    loss = float(ref[f"{ref_tag}_loss"])
    for got in worlds[8][1]:
        assert abs(float(got[f"{tag}_loss"]) - loss) <= 1e-5 * abs(loss)
        names = [k.split(":", 1)[1] for k in got
                 if k.startswith(f"{tag}_g:")]
        assert sorted(names) == sorted(want)
        for k in names:
            w = want[k].numpy()
            block = w[tuple(slice(a, b) for a, b in
                            zip(got[f"{tag}_lo:{k}"], got[f"{tag}_hi:{k}"]))]
            err = float(np.abs(got[f"{tag}_g:{k}"] - block).max())
            assert err <= 1e-4 * float(np.abs(w).max()), (k, err)


def test_sharded_train_step_runs(worlds):
    """tests/test_distributed.py's case: reduced olmoe on (2, 2, 2), two
    steps, finite."""
    for got in worlds[8][1]:
        assert np.all(np.isfinite(got["losses"]))
        assert int(got["skipped"]) == 0


def test_reshard_on_restore(worlds):
    directory, ranks = worlds[4]
    for got in ranks:
        assert bool(got["reshard_resumed"])
        assert int(got["reshard_step"]) == 2
        assert int(got["reshard_opt_step"]) == 2
        assert float(got["reshard_max_diff"]) == 0.0
        assert np.isfinite(float(got["reshard_next_loss"]))
    # one process, no mesh: the whole state, equal values
    from repro_torch.configs import (CheckpointConfig, OptimConfig,
                                     RunConfig, ShapeConfig)
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.trainer import Trainer
    cfg = get_arch(ttw.ARCH).reduced()
    opt = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                    optim=opt, checkpoint=CheckpointConfig(
                        directory=os.path.join(directory, "ckpt"),
                        every_steps=2, async_write=False))
    tr = Trainer(run, S.build_train_step(cfg, opt), None,
                 S.init_state(cfg, opt, torch.Generator().manual_seed(7)),
                 install_sigterm=False, log_fn=lambda s: None)
    assert tr.maybe_resume() and tr.step == 2
    whole = dict(np.load(os.path.join(directory, "whole.npz")))
    for k, p in tr.state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), whole[k])
    for k, v in tr.state.opt.mu.items():
        np.testing.assert_array_equal(v.numpy(), whole[f"mu/{k}"])


def test_compressed_step_matches_dense_mean(worlds):
    for got in worlds[2][1]:
        assert float(got["cm_loss"]) == float(got["cm_loss_dense"])
        assert int(got["cm_n_small"]) > 0
        assert float(got["cm_small_max_diff"]) == 0.0
        assert float(got["cm_dense_bytes"]) == float(got["cm_dense_want"])
        assert float(got["cm_compressed_bytes"]) == \
            float(got["cm_compressed_want"])
        assert float(got["cm_compressed_bytes"]) < \
            float(got["cm_dense_bytes"])
        assert int(got["cm_skipped"]) == 0


def test_compressed_step_bytes_match_reference(worlds):
    """The reference's compressed step runs on 8 forced host devices and
    counts the same dense and compressed bytes as the port's."""
    ref = worlds["reference"]
    assert np.isfinite(float(ref["loss"])) and int(ref["skipped"]) == 0
    for got in worlds[2][1]:
        assert float(got["cm_dense_bytes"]) == \
            float(ref["comm_dense_bytes"])
        assert float(got["cm_compressed_bytes"]) == \
            float(ref["comm_compressed_bytes"])
