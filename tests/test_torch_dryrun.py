"""The port's dry run (``repro_torch.launch.dryrun``) and its cost analysis
(``repro_torch.launch.op_analysis``) against the reference's, on the CPU.

  * ``active_param_count`` and ``model_flops`` equal the reference's for
    every registry arch and (arch x shape), exactly.  ``repro.launch.dryrun``
    sets ``XLA_FLAGS`` when imported, so the reference's numbers come from
    its ``input_specs.abstract_init`` and its own rule (6·N·D, 2·N·D);
  * ``op_analysis`` against ``repro.launch.hlo_analysis`` on the
    reference analyzer's cases (tests/test_perf_variants.py): a loop of 7
    products, one 512² product (FLOPs and bytes), the threshold, the
    dtype sizes; and its dot FLOPs against ``FlopCounterMode`` on a step;
  * ``run_cell`` on fake worlds of 256 and 512 ranks (fake CPU tensors)
    for one reduced arch of each family; a reduced dense train cell on an
    (8, 1) and on a (2, 4) ("data", "model") mesh against the reference's
    compiled HLO of the same cell (dot FLOPs within 10 %; the reference
    compiles both in one subprocess with 8 forced host devices); the
    expert-parallel sums of a traced rank of a 256-rank world receive
    only their groups' bytes;
  * the sharded step's exchange on fake worlds of 8: every rank's plan
    agrees with every other's (what r sends r' is what r' expects from
    r), and a traced rank's peak stays below the whole-gather exchange's
    world + 1 gradients;
  * the CLI: a cell a port check refuses fails, a cell that does not
    apply is skipped, and the run exits 1, as the reference's does.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_world as tw
from repro.configs import get_arch as ref_get_arch
from repro.launch import hlo_analysis as H
from repro.launch import input_specs as RI
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.base import OptimConfig, ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as O
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import steps as S

ARCH = "stablelm-1.6b"
SMALL = ShapeConfig("t", "train", 64, 16)    # the (8, 1) cell's shape

REFERENCE = """
from repro.configs import get_arch
from repro.configs.base import OptimConfig, ShapeConfig
from repro.launch import hlo_analysis
from repro.launch import input_specs as ispec
from repro.launch.mesh import make_mesh
from repro.runtime import steps
cfg = get_arch("stablelm-1.6b").reduced(pin_activations=True)
opt = OptimConfig()
for key, shape in (("dot_flops", (8, 1)), ("dot_flops_model", (2, 4))):
    mesh = make_mesh(shape, ("data", "model"))
    cell = ispec.cell_inputs(cfg, ShapeConfig("t", "train", 64, 16), opt,
                             mesh)
    fn = steps.build_train_step(cfg, opt, mesh)
    with mesh:
        compiled = jax.jit(fn, in_shardings=cell["in_shardings"],
                           donate_argnums=(0,)).lower(
            *cell["args_struct"]).compile()
    OUT[key] = hlo_analysis.analyze(compiled.as_text()).dot_flops
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's (8, 1) and (2, 4) cells, compiled in one
    subprocess while the module's other cases run."""
    d = tmp_path_factory.mktemp("dryrun_ref")
    np.savez(d / "in.npz", none=np.zeros(1))
    proc = tw.start_reference(REFERENCE, str(d / "in.npz"), str(d / "ref.npz"))
    yield lambda: tw.finish_reference(proc, str(d / "ref.npz"))
    if proc.poll() is None:
        proc.kill()


def test_reference_starts(reference):
    """Start the reference's compile first, so it overlaps the cases
    below (pytest runs a file's cases in order)."""
    assert callable(reference)


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------

def _reference_counts(arch):
    """``repro.launch.dryrun.active_param_count``'s rule on the
    reference's abstract init."""
    import jax
    cfg = ref_get_arch(arch)
    params, logical = RI.abstract_init(cfg)
    flat_p = jax.tree_util.tree_leaves(params)
    flat_l = jax.tree_util.tree_leaves(
        logical, is_leaf=lambda x: isinstance(x, tuple))
    total = active = 0
    for p, axes in zip(flat_p, flat_l):
        n = int(np.prod(p.shape))
        total += n
        if cfg.moe is not None and "experts" in axes:
            active += n * cfg.moe.top_k // cfg.moe.num_experts
        else:
            active += n
    return total, active


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_and_model_flops_match_reference(arch):
    total, active = _reference_counts(arch)
    assert D.active_param_count(get_arch(arch)) == (total, active)
    for name, shape in SHAPES.items():
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        want = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind] \
            * active * tokens
        assert D.model_flops(get_arch(arch), get_shape(name)) == want, name


# ---------------------------------------------------------------------------
# the analyzer against the reference's
# ---------------------------------------------------------------------------

def _hlo(fn, *structs):
    import jax
    return jax.jit(fn).lower(*structs).compile().as_text()


def test_op_analysis_counts_every_loop_iteration():
    import jax
    import jax.numpy as jnp
    m = 256
    a = jax.ShapeDtypeStruct((m, m), jnp.float32)

    def scanned(x):
        def body(x, _):
            return x @ x, None
        return jax.lax.scan(body, x, None, length=7)[0]

    def loop(x):
        for _ in range(7):
            x = x @ x
        return x
    want = 7 * 2 * m ** 3
    ref = H.analyze(_hlo(scanned, a), vmem_threshold=0).dot_flops
    got = O.analyze(loop, torch.randn(m, m), threshold=0).dot_flops
    assert abs(ref - want) / want < 0.01
    assert abs(got - want) / want < 0.01
    assert abs(got - ref) / ref < 0.01


def test_op_analysis_plain_matmul():
    import jax
    import jax.numpy as jnp
    m = 512
    a = jax.ShapeDtypeStruct((m, m), jnp.float32)
    ref = H.analyze(_hlo(lambda x, y: x @ y, a, a), vmem_threshold=0)
    x, y = torch.randn(m, m), torch.randn(m, m)
    got = O.analyze(lambda p, q: p @ q, x, y, threshold=0)
    for cost in (ref, got):
        assert abs(cost.dot_flops - 2 * m ** 3) / (2 * m ** 3) < 0.01
        # reads 2 x 1 MB, writes 1 MB
        assert 2.5e6 < cost.hbm_bytes < 4e6
    assert got.total_collective_bytes == 0


def test_op_analysis_counts_vector_dots_as_the_reference_does():
    """A matrix-vector product and a dot are HLO ``dot``s: 2 n m and 2 n
    FLOPs in both analyzers."""
    import jax
    import jax.numpy as jnp
    m, n = 300, 200
    a = jax.ShapeDtypeStruct((m, n), jnp.float32)
    v = jax.ShapeDtypeStruct((n,), jnp.float32)
    ref = H.analyze(_hlo(lambda x, y: (x @ y, y @ y), a, v)).dot_flops
    got = O.analyze(lambda x, y: (x @ y, y @ y), torch.randn(m, n),
                    torch.randn(n)).dot_flops
    assert got == ref == 2 * m * n + 2 * n


def test_op_analysis_threshold():
    import jax
    import jax.numpy as jnp
    m = 128            # 64 KiB buffers, below the threshold
    a = jax.ShapeDtypeStruct((m, m), jnp.float32)
    ref = H.analyze(_hlo(lambda x, y: x @ y, a, a), vmem_threshold=2 ** 20)
    got = O.analyze(lambda p, q: p @ q, torch.randn(m, m), torch.randn(m, m),
                    threshold=2 ** 20)
    for cost in (ref, got):
        assert cost.hbm_bytes == 0.0
        assert cost.dot_flops > 0


@pytest.mark.parametrize("hlo,dtype", [("bf16", torch.bfloat16),
                                       ("f32", torch.float32),
                                       ("s32", torch.int32),
                                       ("c64", torch.complex64)])
def test_op_analysis_dtype_sizes(hlo, dtype):
    assert O.type_bytes((2, 3), dtype) == \
        H._first_type_bytes(f"{hlo}[2,3]{{1,0}}") == 6 * H._DTYPE_BYTES[hlo]
    assert O.type_bytes((), dtype) == H._first_type_bytes(f"{hlo}[]")


def test_op_analysis_dot_flops_are_flop_counter_modes():
    """On a reduced train step (forward, recomputed forward, backward) the
    analyzer's dot FLOPs are ``FlopCounterMode``'s, to the FLOP."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.synthetic import LMBatchSpec, lm_batch
    cfg = get_arch(ARCH).reduced()
    opt = OptimConfig()
    batch = lm_batch(LMBatchSpec(2, 64, cfg.vocab_size), 0, 0, device="cpu")
    step = S.build_train_step(cfg, opt)
    state = S.init_state(cfg, opt, torch.Generator().manual_seed(0))
    got = O.analyze(step, state, batch, threshold=0)
    state = S.init_state(cfg, opt, torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert got.dot_flops == fc.get_total_flops() > 0
    assert got.hbm_bytes > 0


def test_op_analysis_counts_collectives_by_kind():
    """A gather and an all-to-all of the sharded step's exchange on a fake
    world of 4: bytes and calls by the reference's kinds."""
    from repro_torch.distributed.matvec import _all_gather, _all_to_all

    def fn(x):
        _all_gather(x)
        _all_to_all(x, [2, 2, 2, 2], [3, 1, 2, 2])
    with D.fake_world(4):
        cost = O.analyze(fn, torch.zeros(8))
    assert cost.collective_counts["all-gather"] == 1
    assert cost.collective_bytes["all-gather"] == 4 * 8 * 4
    assert cost.collective_counts["all-to-all"] == 1
    assert cost.collective_bytes["all-to-all"] == 8 * 4
    assert cost.total_collective_bytes == 5 * 8 * 4


# ---------------------------------------------------------------------------
# cells on fake worlds
# ---------------------------------------------------------------------------

def _reduced(arch):
    """``cfg_overrides`` that make ``arch`` its ``reduced()`` config, with
    16 experts for a MoE arch (they split over a 16-way "model" axis)."""
    full, small = get_arch(arch), get_arch(arch).reduced()
    out = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
           if getattr(small, f.name) != getattr(full, f.name)}
    if small.moe is not None:
        out["moe"] = dataclasses.replace(small.moe, num_experts=16)
    return out


KEYS = {"arch", "shape", "mesh", "kind", "status", "devices", "trace_s",
        "flops_per_device", "bytes_per_device", "memory", "collectives",
        "params_total", "params_active", "model_flops_global"}

# one reduced arch of each family, across the three kinds of cell
FAMILY_CELLS = [("stablelm-1.6b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                ("llava-next-34b", "prefill_32k"),
                ("whisper-base", "decode_32k"), ("mamba2-780m", "decode_32k"),
                ("zamba2-1.2b", "decode_32k"), ("mamba2-780m", "long_500k"),
                ("zamba2-1.2b", "long_500k")]


def _train_collectives(arch, shape, model=16, pods=1):
    """The collectives of a dense arch's train step on a rank of a mesh
    with a ``model``-way "model" axis and ``pods`` pods, by kind, from the
    config.

    One all-to-all for the gradient exchange, and one all-gather for
    each group of ranks that own gradient blocks alike: the leaves whole
    on "model" (over "model", and "pod"), the qkv biases whole on every
    rank (over the world), and on two pods the blocks split over "model"
    (over "pod"); one all-gather for the parameters
    (every leaf's FSDP group is ("pod", "data"), or "data"), one for the
    loss terms.  Each large-tensor sum over "model"
    (``psum_large``) is one all-to-all and one all-gather: the embedding's
    rows where the vocabulary splits; in each layer, where its split
    divides, the MLP's output and, in the backward pass, its input's
    gradient, and the same two of attention; in the backward pass, each
    CE chunk's input gradient.  The layers' recompute stops at the last
    tensor their backward saved, before the block's closing sum, so it
    adds no collective; a CE chunk's recompute runs its max's gather and
    its sum-exp's gather again (the loss reads both), four gathers a
    chunk."""
    cfg = dataclasses.replace(get_arch(arch), **_reduced(arch))
    assert cfg.family == "dense" and cfg.remat_policy == "nothing"
    chunks = get_shape(shape).seq_len // cfg.ce_chunk
    vocab = cfg.vocab_size % model == 0
    per_layer = 2 * ((cfg.d_ff % model == 0) + (cfg.num_heads % model == 0))
    large = vocab * (1 + chunks) + cfg.num_layers * per_layer
    exchange = 1 + cfg.qkv_bias + (pods > 1)
    return {"all-to-all": 1 + large,
            "all-gather": 2 + exchange + large + vocab * 4 * chunks}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_run_cell_on_a_fake_world(arch, shape, multi_pod):
    rec = D.run_cell(arch, shape, multi_pod, cfg_overrides=_reduced(arch),
                     device="cpu", device_bytes=10 ** 15)
    assert rec["status"] == "ok", rec
    assert KEYS <= set(rec)
    assert rec["devices"] == (512 if multi_pod else 256)
    assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] >= 0
    assert set(rec["collectives"]) == set(O.COLLECTIVE_KINDS) | {
        "total_bytes"}
    assert rec["params_active"] <= rec["params_total"]
    if rec["kind"] == "train":
        coll = rec["collectives"]
        want = _train_collectives(arch, shape, pods=2 if multi_pod else 1)
        assert {k: coll[k]["count"] for k in want} == want
    assert not torch.distributed.is_initialized()


def test_run_cell_fails_past_the_device_memory():
    rec = D.run_cell("stablelm-1.6b", "train_4k", False,
                     cfg_overrides=_reduced("stablelm-1.6b"), device="cpu",
                     device_bytes=10 ** 9)
    assert rec["status"] == "failed" and rec["failure"] == D.MEMORY
    assert rec["memory"]["peak_bytes"] > 10 ** 9
    assert "more than the device's 1.0 GB" in rec["error"]


def test_cell_on_a_data_mesh_matches_reference_flops(reference):
    """A reduced dense train cell on an (8, 1) ("data", "model") mesh: the
    port's dot FLOPs a rank within 10 % of the reference's compiled HLO
    (``hlo_analysis.analyze``).  Both take the reference's tuned profile
    (``pin_activations``, its dry run's ``--pin``; the identity in the
    port): without it the reference's partitioner follows the FSDP
    weights and runs attention on the global batch on every device, 1.58x
    the FLOPs a device of the batch split that both run here."""
    with D.fake_world(8):
        mesh = make_mesh((8, 1), ("data", "model"), device_type="cpu")
        rec = D.trace_cell(get_arch(ARCH).reduced(pin_activations=True),
                           SMALL, mesh, {"mesh": "data8"}, device="cpu")
    assert rec["status"] == "ok", rec
    want = float(reference()["dot_flops"])
    assert abs(rec["flops_per_device"] - want) / want < 0.10, \
        (rec["flops_per_device"], want)


def test_cell_on_a_model_mesh_matches_reference_flops(reference):
    """The same reduced dense train cell on a (2, 4) ("data", "model")
    mesh: the port's tensor-parallel step (heads, kv heads, the MLP's
    width and the vocabulary split 4 ways, the batch 2 ways) counts its
    dot FLOPs a rank within 10 % of the reference's compiled HLO, whose
    partitioner splits the same dimensions over "model"."""
    with D.fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        rec = D.trace_cell(get_arch(ARCH).reduced(pin_activations=True),
                           SMALL, mesh, {"mesh": "data2model4"},
                           device="cpu")
    assert rec["status"] == "ok", rec
    want = float(reference()["dot_flops_model"])
    assert abs(rec["flops_per_device"] - want) / want < 0.10, \
        (rec["flops_per_device"], want)


def _large_bytes(tensors, g):
    """The bytes a rank receives in each of the two collectives of
    ``psum_large`` over a group of ``g``: every member's row of slices,
    each slice a whole number of 8 bytes."""
    row = 0
    for t in tensors:
        per = max(8 // t.element_size(), 1)
        row += -(-t.numel() // (g * per)) * per * t.element_size()
    return g * row


def test_ep_sums_receive_only_their_groups_bytes():
    """The expert-parallel block of a reduced MoE arch (16 experts) traced
    as rank 0 of a fake 256-rank world on the (16, 16) mesh, forward and
    backward: each EP sum (the output's, the tokens' and gates'
    gradients) receives 2 x its payload from its 16-rank "model" group,
    the FSDP gather and its gradients' sum their 16-rank "data" group's,
    the aux mean one float from each of the 256 ranks, by kind to the
    byte.  Gathering each sum over the world would receive 128 x the
    EP sums' bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.partition import _pack
    from repro_torch.models import moe as Mo
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").reduced(),
                              **_reduced("olmoe-1b-7b"))
    moe, D_ = cfg.moe, cfg.d_model
    E, F, k = moe.num_experts, moe.d_ff_expert, moe.top_k
    Bl, S_ = 2, 64
    with D.fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = torch.empty(Bl, S_, D_, requires_grad=True)
            p = {"w_router": torch.empty(D_, E, requires_grad=True),
                 "w_gate": torch.empty(1, D_ // 16, F, requires_grad=True),
                 "w_up": torch.empty(1, D_ // 16, F, requires_grad=True),
                 "w_down": torch.empty(1, F, D_ // 16, requires_grad=True)}
            mode = O.CostMode(threshold=0)
            with mode:
                y, aux = Mo.moe_block(p, x, cfg, mesh)
                torch.autograd.grad(y.sum() + aux, [x, *p.values()])
            T = Bl * S_
            y_like = torch.empty(T, D_)
            blocks = [torch.empty(1, D_ // 16, F), torch.empty(1, D_ // 16, F),
                      torch.empty(1, F, D_ // 16)]
            whole = [torch.empty(1, D_, F), torch.empty(1, D_, F),
                     torch.empty(1, F, D_)]
            ep = (_large_bytes([y_like], 16)
                  + _large_bytes([y_like, torch.empty(T, k)], 16))
            fsdp = _large_bytes(whole, 16)
            gather = 16 * _pack(blocks).numel() * 4
    cost = mode.cost()
    assert cost.collective_counts["all-to-all"] == 3
    assert cost.collective_counts["all-gather"] == 5
    assert cost.collective_bytes["all-to-all"] == ep + fsdp
    assert cost.collective_bytes["all-gather"] == ep + fsdp + gather \
        + 256 * 4
    # the world-wide gather of the output's sum alone
    assert 256 * T * D_ * 4 > 60 * ep


@pytest.mark.parametrize("shape,arch", [((2, 4), "olmoe-1b-7b"),
                                        ((4, 2), "olmoe-1b-7b"),
                                        ((8, 1), ARCH), ((1, 8), ARCH)])
def test_exchange_plans_agree_across_ranks(shape, arch):
    """What each rank's plan sends every other is what that one's plan
    expects from it, on every rank of a fake world of 8; a rank at
    "model" position 0 sends the most, as ``exchange_bytes`` counts."""
    cfg = get_arch(arch).reduced()
    plans = []
    for r in range(8):
        with D.fake_world(8, rank=r):
            mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
            layout = S.param_layout(cfg, mesh)
            plans.append(S._exchange_plan(layout, mesh))
    for r in range(8):
        for q in range(8):
            assert plans[r].send_counts[q] == plans[q].recv_counts[r]
    b = S.exchange_bytes(layout, dict(zip(("data", "model"), shape)))
    sent = [4 * sum(p.send_counts) for p in plans]
    assert max(sent) == sent[0] >= b["sent"]
    assert all(4 * sum(p.recv_counts) >= b["received"] for p in plans)


@pytest.mark.parametrize("shape,arch", [((8, 1), ARCH),
                                        ((2, 4), "olmoe-1b-7b")])
def test_traced_rank_holds_less_than_every_gradient(shape, arch):
    """A rank's traced peak in a world of 8 stays below world + 1 of its
    gradients, what the whole-gather exchange held at least."""
    cfg = get_arch(arch).reduced()
    with D.fake_world(8):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        rec = D.trace_cell(cfg, ShapeConfig("t", "train", 32, 8), mesh,
                           {"mesh": "x".join(map(str, shape))}, device="cpu")
        grad = S.exchange_bytes(S.param_layout(cfg, mesh), mesh)["grad"]
    assert rec["status"] == "ok", rec
    assert rec["memory"]["peak_bytes"] < 9 * grad


def test_cli_records_refused_and_skipped_cells(tmp_path, capsys,
                                              monkeypatch):
    """A train cell of a batch of one (long_500k's shape, made a train
    cell here: the reference has none) is refused by the sharded step on
    both meshes, as a replicated batch would add each sequence's
    gradient once a batch rank; stablelm-1.6b's long_500k does not apply
    (no sub-quadratic attention).  The run exits 1."""
    shape = get_shape("long_500k")
    monkeypatch.setattr(D, "get_shape", lambda name: dataclasses.replace(
        shape, kind="train") if name == "long_500k" else get_shape(name))

    def run(arch):
        D.main(["--arch", arch, "--shape", "long_500k", "--mesh", "both",
                "--device", "cpu", "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as e:
        run("mamba2-780m")
    assert e.value.code == 1
    assert "done: 0 ok / 0 skipped / 2 failed" in capsys.readouterr().out
    run("stablelm-1.6b")
    assert "done: 0 ok / 2 skipped / 0 failed" in capsys.readouterr().out
    for mesh in ("pod16x16", "pod2x16x16"):
        with open(tmp_path / f"mamba2-780m_long_500k_{mesh}.json") as f:
            rec = json.load(f)
        assert rec["status"] == "failed" and rec["failure"] == D.CHECK
        assert "does not split" in rec["error"]
        assert "once a batch rank" in rec["error"]
        with open(tmp_path / f"stablelm-1.6b_long_500k_{mesh}.json") as f:
            assert json.load(f)["status"] == "skipped"


def test_cli_help_names_what_has_no_counterpart(capsys):
    with pytest.raises(SystemExit):
        D.main(["--help"])
    out = capsys.readouterr().out
    assert "--save-hlo has no counterpart" in out and "--device" in out
