"""The gloo worlds of the port's sharded training tests (no JAX: spawn
imports this module in every rank).

Each function runs on every rank of a world of CPU processes
(``torch_world.run_port``) and writes ``rank<r>.npz``: the sharded
results beside the single-device port's on the same inputs, computed in
the same rank, so the test only compares numbers.  ``gpu_sharded_case``
is the card's (tests/test_torch_gpu.py): two ranks on cuda:0.
"""
import functools
import math
import os

import numpy as np

from torch_world import _mesh, _mesh_on, save_rank

ARCH = "stablelm-1.6b"
MOE_ARCH = "olmoe-1b-7b"
B, S = 4, 32


def _rel(got, want) -> float:
    want = want.detach().double()
    got = got.detach().double()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-30))


def _batch(cfg, batch=B, seq=S, device="cpu"):
    from repro_torch.data.synthetic import LMBatchSpec, lm_batch
    return lm_batch(LMBatchSpec(batch, seq, cfg.vocab_size), 0, 0,
                    device=device)


def _state(cfg, opt, seed=0, device="cpu"):
    import torch

    from repro_torch.runtime import steps as S_
    return S_.init_state(cfg, opt, torch.Generator(device=device)
                         .manual_seed(seed))


def _no_drops(cfg):
    """``cfg`` with a capacity that drops no routed slot on any batch
    shard (C = T) and no aux loss: the two terms the expert-parallel
    step takes by batch shard, where the single device takes them over
    the global batch."""
    import dataclasses
    moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k,
        aux_loss_weight=0.0))


def dense_step_case(mesh, out: dict, tag: str, arch: str = ARCH) -> None:
    """The sharded step of a reduced arch against the single-device step
    on the global batch: loss, this rank's gradient blocks (AdamW step,
    ``keep_grads``), its parameter blocks after an SGD step.  A MoE arch
    runs without drops or aux loss (:func:`_no_drops`), so that the
    global batch's gradients are exactly the sum of the shards'."""
    from repro_torch.configs import OptimConfig, get_arch
    from repro_torch.distributed import partition as P
    from repro_torch.runtime import steps as S_
    cfg = get_arch(arch).reduced()
    if cfg.moe is not None:
        cfg = _no_drops(cfg)
    batch = _batch(cfg)
    errs = {"grad": 0.0, "param": 0.0}
    for name, opt in (("adamw", OptimConfig(lr=1e-3, warmup_steps=0)),
                      ("sgd", OptimConfig(name="sgd", lr=0.1, warmup_steps=0,
                                          weight_decay=0.01))):
        sharded = S_.shard_state(_state(cfg, opt), mesh, cfg)
        sharded, met = S_.build_train_step(cfg, opt, mesh, keep_grads=True)(
            sharded, batch)
        single, want = S_.build_train_step(cfg, opt, keep_grads=True)(
            _state(cfg, opt), batch)
        for k, lf in sharded.layout.items():
            if name == "adamw":
                errs["grad"] = max(errs["grad"], _rel(
                    met["grads"][k], P.local_block(want["grads"][k],
                                                   lf.spec, mesh)))
            else:
                p = dict(single.model.named_parameters())[k]
                errs["param"] = max(errs["param"], _rel(
                    sharded.params[k], P.local_block(p.detach(), lf.spec,
                                                     mesh)))
        if name == "adamw":
            out[f"{tag}_loss"] = float(met["loss"])
            out[f"{tag}_loss_single"] = float(want["loss"])
            out[f"{tag}_gnorm"] = float(met["grad_norm"])
            out[f"{tag}_gnorm_single"] = float(want["grad_norm"])
            # the leaves the layers compute by their "model" block
            out[f"{tag}_blocked"] = sum(lf.model_block for lf in
                                        sharded.layout.values())
    out[f"{tag}_grad_err"] = errs["grad"]
    out[f"{tag}_param_err"] = errs["param"]


def serve_case(mesh, out: dict, tag: str, arch: str = ARCH,
               new_tokens: int = 2, batch: int = B, max_seq: int = 32,
               **overrides) -> None:
    """Prefill and ``new_tokens`` decode steps of a reduced arch (with
    ``overrides``) on ``mesh``, each rank with its serving blocks
    (``steps.serving_model``), its batch shard (the whole batch where it
    does not split) and its block of the cache, padded to ``max_seq``
    (``input_specs.sequence_block`` over ``decode_seq_axes``), against
    one device on the same rows: the largest logit difference over max
    |logit|, the cache's bytes on the rank against one device's, the
    number of sequence blocks, and the logits' checksum (the same on
    every rank of a "model" group)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import partition as P
    from repro_torch.launch import input_specs as I
    from repro_torch.models import model as M
    from repro_torch.runtime import steps as S_
    cfg = get_arch(arch).reduced(**overrides)
    model, _ = M.init_model(cfg, torch.Generator().manual_seed(3))
    tokens = _batch(cfg, batch=batch, seq=16)["tokens"]
    local = S_.shard_batch({"tokens": tokens}, mesh)
    rows = P.block_slices(P.spec_for_batch(mesh, batch, 2), (batch, 16),
                          mesh)[0]
    seq = I.decode_seq_axes(cfg, mesh, batch, max_seq)
    mine = S_.serving_model(model, cfg, mesh)
    err, scale, sums = 0.0, 0.0, []
    caches = {}
    for who, m, b, mesh_, axes in (
            ("single", model, {"tokens": tokens[rows]}, None, ()),
            ("mesh", mine, local, mesh, seq)):
        logits, cache = S_.build_prefill_step(cfg, mesh_)(m, b)
        cache = M.pad_cache_to(cache, cfg, max_seq)
        if mesh_ is not None:
            cache = I.sequence_block(cache, mesh, seq)
        decode = S_.build_decode_step(cfg, mesh_, axes)
        steps = [logits]
        tok = logits.argmax(-1)[:, None].int()
        for t in range(new_tokens):
            pos = torch.full_like(tok, 16 + t)
            logits, cache = decode(m, cache, {"tokens": tok,
                                              "positions": pos})
            steps.append(logits)
            tok = logits.argmax(-1)[:, None].int()
        caches[who] = (steps, sum(t.numel() * t.element_size() for t in
                                  _leaves(cache)))
    for got, want in zip(caches["mesh"][0], caches["single"][0]):
        err = max(err, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
        sums.append(got.double().sum().item())
    sizes = P.mesh_sizes(mesh)
    out[f"{tag}_logit_err"] = err / scale
    out[f"{tag}_cache_bytes"] = caches["mesh"][1]
    out[f"{tag}_cache_bytes_single"] = caches["single"][1]
    out[f"{tag}_seq_blocks"] = int(np.prod([sizes[a] for a in seq]))
    out[f"{tag}_logit_sums"] = np.array(sums)


def moe_case(mesh, out: dict, tag: str, seed: int = 5) -> None:
    """The expert-parallel ``moe_block`` on this rank's batch shard with its
    expert blocks against the single-device ``_local_moe`` on every batch
    shard: y, the gradients of sum(y * r) for the expert blocks, the
    router and the tokens, and the aux loss."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import partition as P
    from repro_torch.models import moe as M
    cfg = get_arch(MOE_ARCH).reduced()
    moe, D = cfg.moe, cfg.d_model
    g = torch.Generator().manual_seed(seed)
    E, F = moe.num_experts, moe.d_ff_expert
    x = torch.randn(B, S, D, generator=g)
    r = torch.randn(B, S, D, generator=g)
    w = {"w_router": torch.randn(D, E, generator=g) * D ** -0.5,
         "w_gate": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "w_up": torch.randn(E, D, F, generator=g) * D ** -0.5,
         "w_down": torch.randn(E, F, D, generator=g) * F ** -0.5}
    spec = {"w_router": (), "w_gate": ("model", "data"),
            "w_up": ("model", "data"), "w_down": ("model", None, "data")}
    bspec = P.spec_for_batch(mesh, B, 3)
    shards = [P.block_slices(bspec, x.shape, mesh, c)
              for c in P.rank_coords(mesh)]
    mine = P.block_slices(bspec, x.shape, mesh)
    # the single device on each distinct batch shard
    want = {k: torch.zeros_like(v) for k, v in w.items()}
    seen, aux_want = set(), []
    for sl in shards:
        if sl[0].start in seen:
            continue
        seen.add(sl[0].start)
        leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
        xs = x[sl].clone().requires_grad_()
        y, aux = M._local_moe(xs, *(leaves[k] for k in
                                    ("w_router", "w_gate", "w_up",
                                     "w_down")), moe=moe, act=cfg.mlp_act)
        grads = torch.autograd.grad((y * r[sl]).sum(),
                                    [xs] + list(leaves.values()))
        for k, gk in zip(leaves, grads[1:]):
            want[k] += gk
        aux_want.append(float(aux))
        if sl == mine:
            y_want, x_want = y.detach(), grads[0]
            router_want = grads[1 + list(leaves).index("w_router")]
    # the expert-parallel block on this rank
    blocks = {k: P.local_block(v, spec[k], mesh).requires_grad_()
              for k, v in w.items()}
    xs = x[mine].clone().requires_grad_()
    y, aux = M.moe_block(blocks, xs, cfg, mesh)
    grads = torch.autograd.grad((y * r[mine]).sum(),
                                [xs] + list(blocks.values()))
    out[f"{tag}_y_err"] = _rel(y, y_want)
    out[f"{tag}_x_grad_err"] = _rel(grads[0], x_want)
    out[f"{tag}_router_grad_err"] = _rel(grads[1], router_want)
    out[f"{tag}_expert_grad_err"] = max(
        _rel(gk, P.local_block(want[k], spec[k], mesh))
        for k, gk in zip(list(blocks)[1:], grads[2:]))
    out[f"{tag}_aux"] = float(aux)
    out[f"{tag}_aux_want"] = float(np.mean(aux_want))
    out[f"{tag}_y_sum"] = y.detach().double().sum().item()


def reshard_case(mesh, rank, directory, out: dict) -> None:
    """A sharded Trainer on ``mesh`` checkpoints two steps; a fresh one on
    a (4,) ("data",) mesh restores it, resharded."""
    from repro_torch.configs import (CheckpointConfig, OptimConfig,
                                     RunConfig, RuntimeConfig, ShapeConfig,
                                     get_arch)
    from repro_torch.runtime import steps as S_
    from repro_torch.runtime.trainer import Trainer
    cfg = get_arch(ARCH).reduced()
    opt = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", S, B),
                    optim=opt,
                    checkpoint=CheckpointConfig(
                        directory=os.path.join(directory, "ckpt"),
                        every_steps=2, async_write=True),
                    runtime=RuntimeConfig(log_every=0))

    def batch_fn(step):
        from repro_torch.data.synthetic import LMBatchSpec, lm_batch
        return lm_batch(LMBatchSpec(B, S, cfg.vocab_size), 0, step,
                        device="cpu")
    shard = functools.partial(S_.shard_state, mesh=mesh, cfg=cfg)
    tr = Trainer(run, S_.build_train_step(cfg, opt, mesh), batch_fn,
                 shard(_state(cfg, opt)), state_sharding_fn=shard,
                 install_sigterm=False, log_fn=lambda s: None)
    tr.run(2)
    whole = S_.gather_state(tr.state)
    mesh4 = _mesh((4,), ("data",))
    shard4 = functools.partial(S_.shard_state, mesh=mesh4, cfg=cfg)
    tr4 = Trainer(run, S_.build_train_step(cfg, opt, mesh4), batch_fn,
                  shard4(_state(cfg, opt, seed=9)), state_sharding_fn=shard4,
                  install_sigterm=False, log_fn=lambda s: None)
    out["reshard_resumed"] = tr4.maybe_resume()
    out["reshard_step"] = tr4.step
    back = S_.gather_state(tr4.state)
    diffs = [float((a.detach() - b.detach()).abs().max()) for a, b in
             zip(whole.model.parameters(), back.model.parameters())]
    for tree_a, tree_b in ((whole.opt.mu, back.opt.mu),
                           (whole.opt.nu, back.opt.nu)):
        diffs += [float((tree_a[k] - tree_b[k]).abs().max()) for k in tree_a]
    out["reshard_max_diff"] = max(diffs)
    out["reshard_opt_step"] = int(back.opt.step)
    if rank == 0:
        np.savez(os.path.join(directory, "whole.npz"),
                 **{k: p.detach().numpy() for k, p in
                    whole.model.named_parameters()},
                 **{f"mu/{k}": v.numpy() for k, v in whole.opt.mu.items()})
    # one more step on the resharded state: finite, the same everywhere
    _, met = tr4.train_step(tr4.state, batch_fn(2))
    out["reshard_next_loss"] = float(met["loss"])


def _block_of_region(g, lf, region, mesh):
    """This rank's block (under ``lf.spec``) of ``g``, its region (under
    ``region``) of the leaf."""
    from repro_torch.distributed import partition as P
    me = P.my_coord(mesh)
    reg = P.block_slices(region, lf.shape, mesh, me)
    blk = P.block_slices(lf.spec, lf.shape, mesh, me)
    return g[tuple(slice(b.start - r.start, b.stop - r.start)
                   for b, r in zip(blk, reg))].contiguous()


def whole_gather_oracle(grads, layout, mesh):
    """The sharded step's gradient exchange as it was first written: every
    rank's whole gradient gathered with one collective, added over the
    batch axes in shard order, this rank's block cut from the sum; and
    the norm of every summed gradient, each element once.  Returns
    (this rank's blocks, the norm)."""
    import torch

    from repro_torch.distributed import partition as P
    from repro_torch.runtime import steps as S_
    names = list(layout)
    parts = P.gather_packed([grads[k] for k in names])
    sizes = P.mesh_sizes(mesh)
    groups = [S_._contributors(mesh, c) for c in range(sizes.get("model", 1))]
    region = S_._regions(layout, mesh)
    me = P.my_coord(mesh)
    sq, mine = [], {}
    for i, k in enumerate(names):
        lf = layout[k]
        if not lf.model_block:
            g = S_._add([parts[i][r] for r in groups[0]])
            sq.append(g.float().square().sum())
            mine[k] = P.local_block(g, lf.spec, mesh)
            continue
        for c, grp in enumerate(groups):
            g = S_._add([parts[i][r] for r in grp])
            sq.append(g.float().square().sum())
            if c == me.get("model", 0):
                mine[k] = _block_of_region(g, lf, region[k], mesh)
    return mine, torch.stack(sq).sum().sqrt()


def exchange_case(mesh, out: dict, tag: str, arch: str = ARCH,
                  **overrides) -> None:
    """One sharded AdamW step of a reduced arch (with ``overrides``; at
    its published capacity and aux loss): this rank's summed gradient
    blocks against :func:`whole_gather_oracle` on the same rank's
    gradients (the number of leaves whose bits differ), the norm against
    the oracle's; the loss, the norm and the collectives by kind, the
    same on every rank; the bytes of the leaves whole on "model" that
    the exchange cuts into slices."""
    import torch

    from repro_torch.configs import OptimConfig, get_arch
    from repro_torch.distributed import partition as P
    from repro_torch.distributed.matvec import (collective_stats,
                                                reset_collectives)
    from repro_torch.runtime import steps as S_
    cfg = get_arch(arch).reduced(**overrides)
    opt = OptimConfig(lr=1e-3, warmup_steps=0)
    seen, calls = {}, {}
    exchange = S_._exchange

    def spy(grads, *args):
        seen.update({k: v.clone() for k, v in grads.items()})
        before = collective_stats()["by_kind"]["all-to-all"]["calls"]
        got = exchange(grads, *args)
        calls["a2a"] = collective_stats()["by_kind"]["all-to-all"][
            "calls"] - before
        return got
    state = S_.shard_state(_state(cfg, opt), mesh, cfg)
    step = S_.build_train_step(cfg, opt, mesh, keep_grads=True)
    S_._exchange = spy
    try:
        reset_collectives()
        _, met = step(state, _batch(cfg))
        stats = collective_stats()
    finally:
        S_._exchange = exchange
    want, norm = whole_gather_oracle(seen, state.layout, mesh)
    out[f"{tag}_leaves"] = len(want)
    out[f"{tag}_differ"] = sum(not torch.equal(met["grads"][k], want[k])
                               for k in want)
    out[f"{tag}_loss"] = float(met["loss"])
    out[f"{tag}_gnorm"] = float(met["grad_norm"])
    out[f"{tag}_norm_rel"] = abs(float(met["grad_norm"]) - float(norm)) \
        / float(norm)
    out[f"{tag}_a2a_calls"] = calls["a2a"]
    out[f"{tag}_step_a2a_calls"] = stats["by_kind"]["all-to-all"]["calls"]
    out[f"{tag}_ag_calls"] = stats["by_kind"]["all-gather"]["calls"]
    out[f"{tag}_sliced_bytes"] = sum(
        math.prod(lf.shape) * lf.dtype.itemsize
        for lf in state.layout.values()
        if not lf.model_block and "model" not in P.spec_axes(lf.spec))


def reduce_case(mesh, out: dict, tag: str) -> None:
    """``psum_large`` against ``psum`` (the gather-then-sum) on tensors of
    ragged sizes and three dtypes, over each group of ``mesh``'s axes,
    one mesh order reversed: the number of sums whose bits differ, and
    the bytes a rank receives from each."""
    import torch

    from repro_torch.distributed.matvec import (collective_stats, psum,
                                                psum_large,
                                                reset_collectives)
    g = torch.Generator().manual_seed(11 + int(mesh.get_rank()))
    xs = [torch.randn(7, 5, generator=g),
          torch.randn(3, generator=g).bfloat16(),
          torch.randn(2, 13, 3, generator=g).double(),
          torch.randn(1000, generator=g)]
    differ = 0
    got_bytes, want_bytes = 0, 0
    for axes in (("model",), ("data",), ("data", "model"),
                 ("model", "data")):
        reset_collectives()
        big = psum_large(xs, mesh, axes)
        got_bytes += sum(v["bytes"] for v in
                         collective_stats()["by_kind"].values())
        reset_collectives()
        small = [psum(x, mesh, axes) for x in xs]
        want_bytes += sum(v["bytes"] for v in
                          collective_stats()["by_kind"].values())
        differ += sum(not torch.equal(a, b) for a, b in zip(big, small))
    out[f"{tag}_differ"] = differ
    out[f"{tag}_bytes"] = got_bytes
    out[f"{tag}_gather_bytes"] = want_bytes


# the tensor-parallel train steps held against one device: a reduced arch
# whose kv heads divide "model" (stablelm), one whose kv heads stay whole
# on (1, 4) (gemma2: 4 heads, 2 kv heads), MLA with experts
# (deepseek-v2), and the Mamba2 layers split by heads (mamba2: 16 SSD
# heads; zamba2: its Mamba2 layers and the shared attention block)
TP_ARCHS = (("dm", ARCH), ("gm", "gemma2-9b"), ("dv", "deepseek-v2-236b"),
            ("mb", "mamba2-780m"), ("zb", "zamba2-1.2b"))

# prefill and decode against one device: (tag, mesh, serve_case's
# arguments).  gemma2 (2 kv heads on (1, 4)) and deepseek-v2's MLA
# latents split the cache's sequence over "model", as does gemma2 with 6
# heads (the attention whole on every rank); a batch of one splits it over
# "data" (stablelm on (4, 1); zamba2 on (2, 2), its kv heads and Mamba2
# state by heads over "model"); mamba2 holds its state by heads
SERVE_CASES = (("sv22", (2, 2), {}), ("sv14", (1, 4), {}),
               ("svgm14", (1, 4), dict(arch="gemma2-9b")),
               ("svdv14", (1, 4), dict(arch="deepseek-v2-236b")),
               ("svgw14", (1, 4), dict(arch="gemma2-9b", num_heads=6)),
               ("svb41", (4, 1), dict(batch=1)),
               ("svzb22", (2, 2), dict(arch="zamba2-1.2b", batch=1)),
               ("svmb14", (1, 4), dict(arch="mamba2-780m")))

# the gradient exchange beyond a dense and a MoE arch: zamba2 (the Mamba2
# conv, whole in its layer but split over "model" by the rules) and a
# reduced arch with 6 heads on (1, 4), its attention weights whole on
# "model"
EXCHANGE_CASES = (((2, 2), "hybrid", "zamba2-1.2b", {}),
                  ((1, 4), "hybrid", "zamba2-1.2b", {}),
                  ((1, 4), "whole", ARCH, dict(num_heads=6, num_kv_heads=6)))


def world4_cases(rank, world, inputs, directory):
    """(2, 2) ("data", "model"): the dense and the MoE step, the EP block,
    the reshard; on (2, 2), (4, 1) and (1, 4) the gradient exchange
    against the whole-gather oracle, and on the last two the steps
    against one device; the tensor-parallel steps and the large-tensor
    sum on (2, 2) and (1, 4); prefill and decode (:data:`SERVE_CASES`)."""
    out = {}
    mesh = _mesh((2, 2), ("data", "model"))
    dense_step_case(mesh, out, "ms22", MOE_ARCH)
    moe_case(mesh, out, "moe22")
    reshard_case(mesh, rank, directory, out)
    for shape in ((2, 2), (4, 1), (1, 4)):
        m = _mesh(shape, ("data", "model"))
        name = "x".join(map(str, shape))
        for arch, kind in ((ARCH, "dense"), (MOE_ARCH, "moe")):
            exchange_case(m, out, f"ex{name}{kind}", arch)
        if shape != (2, 2):
            dense_step_case(m, out, f"ms{shape[0]}{shape[1]}", MOE_ARCH)
        if shape != (4, 1):
            tag = f"{shape[0]}{shape[1]}"
            for prefix, arch in TP_ARCHS:
                dense_step_case(m, out, prefix + tag, arch)
            reduce_case(m, out, f"rd{tag}")
    for shape, kind, arch, overrides in EXCHANGE_CASES:
        exchange_case(_mesh(shape, ("data", "model")), out,
                      f"ex{'x'.join(map(str, shape))}{kind}", arch,
                      **overrides)
    dense_step_case(_mesh((4, 1), ("data", "model")), out, "dm41")
    for tag, shape, kw in SERVE_CASES:
        serve_case(_mesh(shape, ("data", "model")), out, tag, **kw)
    save_rank(directory, rank, out)


def compressed_case(mesh, out: dict) -> None:
    """The compressed step on ("pod",) against the sharded dense-mean step
    on the same mesh, SGD without clipping: the loss, the small leaves,
    the byte accounting (k (m + n) + r m floats of a compressed m x n
    gradient against m n, by the shapes of the reference's tree)."""
    from repro_torch import bridge
    from repro_torch.configs import FsvdConfig, OptimConfig, get_arch
    from repro_torch.distributed import compression as C
    from repro_torch.runtime import steps as S_
    cfg = get_arch(ARCH).reduced()
    opt = OptimConfig(name="sgd", lr=0.1, warmup_steps=0, grad_clip=1e9)
    fcfg = FsvdConfig(compression_rank=4, compression_min_dim=64,
                      max_iters=16)
    batch = _batch(cfg)
    comp, met = S_.build_compressed_train_step(cfg, opt, mesh, fcfg)(
        _state(cfg, opt), batch)
    dense, dmet = S_.build_train_step(cfg, opt, mesh)(
        S_.shard_state(_state(cfg, opt), mesh, cfg), batch)
    out["cm_loss"], out["cm_loss_dense"] = float(met["loss"]), \
        float(dmet["loss"])
    small = [float((p.detach() - dense.params[k]).abs().max())
             for k, p in comp.model.named_parameters()
             if p.dim() < 2 or min(p.shape[0], int(np.prod(p.shape[1:])))
             < fcfg.compression_min_dim]
    out["cm_small_max_diff"] = max(small)
    out["cm_n_small"] = len(small)
    out["cm_dense_bytes"] = float(met["comm_dense_bytes"])
    out["cm_compressed_bytes"] = float(met["comm_compressed_bytes"])
    r = fcfg.compression_rank
    k = min(max(2 * r, r + 2), fcfg.max_iters)
    dense_want = comp_want = 0
    for g in _leaves(bridge.reference_tree(comp.model)):
        lay = C._layout(g, fcfg)
        if lay is None:
            continue
        L, m, n = (1,) + lay[1:] if lay[0] == "2d" else lay[1:]
        dense_want += 4 * L * m * n
        comp_want += 4 * L * (k * (m + n) + r * m)
    out["cm_dense_want"], out["cm_compressed_want"] = dense_want, comp_want
    out["cm_skipped"] = int(met["skipped"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def world2_cases(rank, world, inputs, directory):
    """(1, 2) ("data", "model"): the tensor-parallel dense step, the EP
    block and the MoE step; (2, 1): the MoE step; ("pod",) (2,): the
    compressed step."""
    out = {}
    mesh = _mesh((1, 2), ("data", "model"))
    dense_step_case(mesh, out, "dm12")
    moe_case(mesh, out, "moe12")
    dense_step_case(mesh, out, "ms12", MOE_ARCH)
    dense_step_case(_mesh((2, 1), ("data", "model")), out, "ms21", MOE_ARCH)
    compressed_case(_mesh((2,), ("pod",)), out)
    save_rank(directory, rank, out)


# the archs held against the reference's step on a (2, 4) mesh: (tag, arch)
REFERENCE_ARCHS = (("ref24", ARCH), ("ref24zb", "zamba2-1.2b"))


def reference_inputs() -> dict:
    """The inputs of :func:`reference_mesh_case` for the reference's
    subprocess, as numpy arrays, for each of :data:`REFERENCE_ARCHS`: the
    port's seed-0 weights of the reduced arch in the reference's pytree
    layout (``bridge.reference_tree``), each under ``<tag>p:<path>``,
    and the batch's ``<tag>tokens`` and ``<tag>labels``."""
    from repro_torch import bridge
    from repro_torch.configs import OptimConfig, get_arch
    out = {}
    for tag, arch in REFERENCE_ARCHS:
        cfg = get_arch(arch).reduced()

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}:{k}")
            else:
                out[path] = node.numpy()
        walk(bridge.reference_tree(_state(cfg, OptimConfig()).model),
             f"{tag}p")
        out.update({f"{tag}{k}": v.numpy() for k, v in _batch(cfg).items()})
    return out


def reference_mesh_case(mesh, out: dict, tag: str, arch: str = ARCH) -> None:
    """The sharded step of the reduced ``arch`` on :func:`reference_inputs`'
    weights and batch: its loss and this rank's block of each gradient
    leaf, with the block's bounds, for the test to hold against the
    reference's step on a mesh of the same shape."""
    from repro_torch.configs import OptimConfig, get_arch
    from repro_torch.distributed import partition as P
    from repro_torch.runtime import steps as S_
    cfg = get_arch(arch).reduced()
    opt = OptimConfig()
    state = S_.shard_state(_state(cfg, opt), mesh, cfg)
    _, met = S_.build_train_step(cfg, opt, mesh, keep_grads=True)(
        state, _batch(cfg))
    out[f"{tag}_loss"] = float(met["loss"])
    for k, lf in state.layout.items():
        sl = P.block_slices(lf.spec, lf.shape, mesh)
        out[f"{tag}_g:{k}"] = met["grads"][k].numpy()
        out[f"{tag}_lo:{k}"] = np.array([s.start for s in sl])
        out[f"{tag}_hi:{k}"] = np.array([s.stop for s in sl])


def world8_cases(rank, world, inputs, directory):
    """tests/test_distributed.py::test_sharded_train_step_runs: a reduced
    MoE arch, (2, 2, 2) ("pod", "data", "model"), two real steps; and the
    tensor-parallel steps of :data:`REFERENCE_ARCHS` on (2, 4) ("data",
    "model") for the reference's step on the same mesh
    (:func:`reference_mesh_case`)."""
    from repro_torch.configs import OptimConfig, get_arch
    from repro_torch.runtime import steps as S_
    out: dict = {}
    for tag, arch in REFERENCE_ARCHS:
        reference_mesh_case(_mesh((2, 4), ("data", "model")), out, tag, arch)
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = get_arch(MOE_ARCH).reduced()
    opt = OptimConfig(lr=1e-3)
    state = S_.shard_state(_state(cfg, opt), mesh, cfg)
    step = S_.build_train_step(cfg, opt, mesh)
    losses = []
    for t in range(2):
        from repro_torch.data.synthetic import LMBatchSpec, lm_batch
        state, met = step(state, lm_batch(LMBatchSpec(8, 32, cfg.vocab_size),
                                          0, t, device="cpu"))
        losses.append(float(met["loss"]))
    blocks = sorted(state.params)
    save_rank(directory, rank, {
        **out,
        "losses": np.array(losses),
        "skipped": int(met["skipped"]),
        "param_sum": sum(state.params[k].double().sum().item()
                         for k in blocks
                         if not state.layout[k].spec)})


# --- tests/test_torch_gpu.py: two ranks on one card

def gpu_sharded_case(rank, world, inputs, directory):
    """One sharded step of reduced olmoe on (1, 2) ("data", "model") over
    cuda:0, beside the single-card step on the same state and batch."""
    import torch

    from repro_torch.configs import OptimConfig, get_arch
    from repro_torch.runtime import steps as S_
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(MOE_ARCH).reduced()
    opt = OptimConfig(lr=1e-3, warmup_steps=0)
    mesh = _mesh_on((1, 2), ("data", "model"), "cuda")
    batch = _batch(cfg, device="cuda")
    sharded, met = S_.build_train_step(cfg, opt, mesh)(
        S_.shard_state(_state(cfg, opt, device="cuda"), mesh, cfg), batch)
    _, want = S_.build_train_step(cfg, opt)(_state(cfg, opt, device="cuda"),
                                             batch)
    save_rank(directory, rank, {
        "loss": float(met["loss"]), "single": float(want["loss"]),
        "skipped": int(met["skipped"]),
        "device": str(next(iter(sharded.params.values())).device)})
