"""Dispatch-level cost analysis of one step.  Counterpart of
``repro.launch.hlo_analysis``.

The reference re-derives the roofline inputs from the post-SPMD HLO text
of a compiled step.  The port has no HLO: a step is the stream of aten
ops it dispatches, and :class:`CostMode` (a ``TorchDispatchMode``) sees
each of them as it runs, on real tensors or on fake ones
(``FakeTensorMode``, which is how the dry run traces a step with no
storage).  It derives the reference's three inputs, per device (the
ops one rank runs):

  * dot FLOPs        — every matrix product: ``mm``, ``addmm``, ``bmm``,
                       ``baddbmm`` (``matmul``, ``linear`` and
                       ``einsum`` decompose into these before they reach
                       the mode) at 2 x M x N x K, the matrix-vector and
                       vector dots (``mv``, ``addmv``, ``dot``: 2 x the
                       matrix's elements), and fused attention
                       (``_scaled_dot_product_*``, forward and backward)
                       by ``torch.utils.flop_counter``'s formulas, so the
                       count is ``FlopCounterMode``'s on the same ops
                       (which leaves the vector dots out);
  * collective bytes — the result bytes of every ``c10d`` collective
                       (the output buffers), and their counts, by the
                       reference's kinds (:data:`COLLECTIVE_KINDS`);
  * HBM bytes        — the bytes each op writes to outputs of at least
                       ``threshold`` bytes (a view writes nothing; an
                       in-place op or a copy into a slice writes that
                       slice, as the reference's ``dynamic-update-slice``
                       counts only the update; allocations without a
                       write, ``empty`` and its kin, write nothing), plus
                       the operand reads of products, reductions and
                       collectives, each operand of at least
                       ``threshold`` bytes read once.

A dispatch trace meets every executed loop iteration, so no trip count
is parsed.  What does not carry over is fusion.  XLA fuses elementwise
chains into one kernel whose intermediates stay on chip, and charges a
fusion's operand reads (capped at its result's size); eager PyTorch runs
every op as a kernel of its own.  So here every op's output is charged
as written (an intermediate XLA would have kept on chip included), and
elementwise ops' reads are not charged (the reference charges reads only
of products, fusions and collectives).  Two steps' bytes compare with
each other, not with the reference's.

The default ``threshold`` (:data:`L2_THRESHOLD`, 12.5 MB) replaces the
TPU's ``VMEM_THRESHOLD`` (16 MiB of a v5e core's ~100 MiB VMEM): an
H100 keeps what one kernel writes and the next reads in its 50 MB L2 at
best, beside the consumer's other operand, its output and every other
stream, so a quarter of the L2 is taken as the largest buffer that can
stay there.  Not measured.

:class:`CostMode` also counts live bytes: every storage an op makes (and
each one :meth:`CostMode.track` is given, such as a step's arguments) is
added when made and taken off when freed, rounded up to the 512 bytes
of the CUDA caching allocator on a CUDA device, so ``peak_bytes`` is the
most the traced code held at once.  An op that holds a scratch buffer
while it runs (:data:`CUDA_SCRATCH`) adds it to the peak of that moment.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# a quarter of an H100's 50 MB L2 (module docstring); not measured
L2_THRESHOLD = 50_000_000 // 4

# the CUDA caching allocator's rounding of every block (512 bytes)
CUDA_ROUND = 512

# ops whose CUDA kernel holds a scratch buffer of the given multiple of
# its output's bytes while it runs: the softmax backward (measured on the
# card, torch 2.11: one output-sized buffer at every shape tried, last
# dimension 512 to 50,176; the forward softmax holds none)
CUDA_SCRATCH = {torch.ops.aten._softmax_backward_data.default: 1}

_aten = torch.ops.aten

# products whose FLOPs are 2 x M x N x K (K the contracted size), and
# the matrix-vector and vector dots (the reference's HLO ``dot`` covers
# them too; ``FlopCounterMode`` does not count them)
_PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
_VECTOR_DOTS = {_aten.mv, _aten.addmv, _aten.dot, _aten.vdot}

# fused attention, counted by torch.utils.flop_counter's formulas
_ATTENTION = {getattr(_aten, name) for name in (
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_efficient_attention_backward",
    "_scaled_dot_product_flash_attention_backward",
    "_scaled_dot_product_cudnn_attention_backward")
    if hasattr(_aten, name)}

# reductions: their operands are read whole
_REDUCTIONS = {getattr(_aten, name) for name in (
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "var", "std", "var_mean", "std_mean", "linalg_vector_norm",
    "norm", "logsumexp", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "cumsum",
    "topk", "sort", "nll_loss_forward", "nll_loss_backward",
    "native_layer_norm", "native_layer_norm_backward", "any", "all")
    if hasattr(_aten, name)}

# ops that allocate without writing, or make a range (the reference's
# ``iota``): no bytes written
_NO_WRITE = {getattr(_aten, name) for name in (
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "arange", "lift_fresh")
    if hasattr(_aten, name)}

# c10d op name prefixes -> the reference's kinds
_C10D_KINDS = (("allgather", "all-gather"), ("_allgather", "all-gather"),
               ("allreduce", "all-reduce"),
               ("reduce_scatter", "reduce-scatter"),
               ("_reduce_scatter", "reduce-scatter"),
               ("alltoall", "all-to-all"), ("send", "collective-permute"),
               ("recv", "collective-permute"))


def type_bytes(shape, dtype: torch.dtype) -> int:
    """The bytes of a ``shape`` tensor of ``dtype`` (the reference's
    ``_first_type_bytes`` of one HLO type)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpCost:
    """The reference's ``HLOCost``: per-device dot FLOPs, HBM bytes, and
    collective bytes and counts by kind."""
    dot_flops: float
    hbm_bytes: float
    collective_bytes: dict          # kind -> bytes
    collective_counts: dict         # kind -> calls

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(x) -> list:
    out = []
    for t in tree_flatten(x)[0]:
        if isinstance(t, torch.nn.Module):       # a model: its parameters
            out += list(t.parameters()) + list(t.buffers())
        elif isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _product_flops(func, args) -> float:
    """2 x (batch x) M x K x N of ``mm`` / ``bmm`` (operands first) or
    ``addmm`` / ``baddbmm`` (after the added term)."""
    a, b = (args[0], args[1]) if func in (_aten.mm, _aten.bmm) \
        else (args[1], args[2])
    return 2.0 * a.numel() * b.shape[-1]


def _attention_flops(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    fn = flop_registry.get(func.overloadpacket)
    return 0.0 if fn is None else float(fn(*args, **kwargs, out_val=out))


def _collective_kind(func) -> str | None:
    if func.namespace != "c10d":
        return None
    name = func.__name__.split(".")[0]
    for prefix, kind in _C10D_KINDS:
        if name.startswith(prefix):
            return kind
    return None


def _written(func, args, out) -> list:
    """The tensors an op writes: its fresh outputs, and the arguments it
    writes in place; none for a view."""
    schema = func._schema
    written = []
    for i, arg in enumerate(schema.arguments):
        alias = arg.alias_info
        if alias is not None and alias.is_write and i < len(args):
            written += _tensors(args[i])
    for ret in schema.returns:
        if ret.alias_info is not None:           # a view or an in-place op
            return written
    return written + _tensors(out)


class CostMode(TorchDispatchMode):
    """Counts the dot FLOPs, HBM bytes, collectives and live bytes of the
    ops dispatched under it (module docstring).  Enter it inside a
    ``FakeTensorMode`` to trace a step with no storage."""

    def __init__(self, threshold: int = L2_THRESHOLD):
        super().__init__()
        self.threshold = threshold
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._lock = threading.Lock()
        self._seen: dict = {}              # id(storage) -> weakref

    # --- live bytes -------------------------------------------------------
    def _add_storage(self, t: torch.Tensor, rounded: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        if rounded:
            n = -(-n // CUDA_ROUND) * CUDA_ROUND

        def freed(_, key=key, n=n):
            with self._lock:
                self.live_bytes -= n
                if self._seen.get(key) is ref_:
                    del self._seen[key]
        ref_ = weakref.ref(st, freed)
        with self._lock:
            self._seen[key] = ref_
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, tree) -> int:
        """Count the storages of the tensors of ``tree`` as live from now
        on (until freed); returns their bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._add_storage(t, t.device.type == "cuda")
        return self.live_bytes - before

    # --- the dispatch ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":           # metadata: no work, no bytes
            return out
        packet = func.overloadpacket
        reads = ()
        if packet in _PRODUCTS:
            self.dot_flops += _product_flops(packet, args)
            reads = _tensors(args)
        elif packet in _VECTOR_DOTS:
            # 2 x the matrix's (or the vector's) elements
            self.dot_flops += 2.0 * args[1 if packet is _aten.addmv
                                         else 0].numel()
            reads = _tensors(args)
        elif packet in _ATTENTION:
            self.dot_flops += _attention_flops(func, args, kwargs, out)
            reads = _tensors(args)
        elif packet in _REDUCTIONS:
            reads = _tensors(args)
        kind = _collective_kind(func)
        if kind is not None:
            res = _tensors(args[0]) if args else []
            self.coll_bytes[kind] += sum(_bytes(t) for t in res)
            self.coll_counts[kind] += 1
            reads = _tensors(args[1:2])
            written = res
        elif packet in _NO_WRITE:
            written = []
        else:
            written = _written(func, args, out)
        thr = self.threshold
        self.hbm_bytes += sum(b for b in map(_bytes, written) if b >= thr)
        self.hbm_bytes += sum(b for b in map(_bytes, reads) if b >= thr)
        for t in _tensors(out):
            self._add_storage(t, t.device.type == "cuda")
        scratch = CUDA_SCRATCH.get(func)
        if scratch:
            held = sum(-(-_bytes(t) // CUDA_ROUND) * CUDA_ROUND
                       for t in _tensors(out) if t.device.type == "cuda")
            with self._lock:
                self.peak_bytes = max(self.peak_bytes,
                                      self.live_bytes + scratch * held)
        return out

    def cost(self) -> OpCost:
        return OpCost(self.dot_flops, self.hbm_bytes, dict(self.coll_bytes),
                      dict(self.coll_counts))


def analyze(fn: Callable, *args: Any, threshold: int = L2_THRESHOLD,
            **kwargs: Any) -> OpCost:
    """The :class:`OpCost` of one call ``fn(*args, **kwargs)``, on the
    tensors given (real or fake): the counterpart of the reference's
    ``analyze(hlo_text)``."""
    with CostMode(threshold) as mode:
        fn(*args, **kwargs)
    return mode.cost()
