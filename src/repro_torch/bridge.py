"""State carried across from the reference package, as numpy arrays.

The parity tests run ``repro`` (JAX) and ``repro_torch`` on the same
inputs.  These functions turn what the reference holds — an operand (dense,
sparse COO triplets, low-rank factors, or any reference operator), a
matrix-free problem, a start vector, a sketch test matrix, a hashed-sign
table and a sketch-resident state, a ``Factorization``, an ``SVDSpec``,
a manifold point, a tangent vector, an RSL dataset, a model's parameter
pytree and an optimizer state — into the port's objects, given as numpy
arrays (``np.asarray`` of a JAX array) or as objects with the reference's
field names.  Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch._device import to_tensor, torch_dtype
from repro_torch.api.results import Factorization
from repro_torch.api.spec import SVDSpec
from repro_torch.core import manifold as mf
from repro_torch.core import operators as ops
from repro_torch.core.operators import DenseOp
from repro_torch.core.sketch import GaussianSketch, SparseSignSketch
from repro_torch.data.synthetic import MatrixFreeProblem, RSLDataset
from repro_torch.models.model import STACKED, ParamTree
from repro_torch.optim.optimizers import OptState
from repro_torch.sketchres.state import SketchState, _HashedSketch


def operand(A, *, backend: str = "xla", device=None) -> DenseOp:
    """The reference's dense operand ``A`` (m, n) as a :class:`DenseOp`."""
    return DenseOp(to_tensor(np.asarray(A), device=device), backend=backend)


def sparse_operand(data, indices, spshape, *, backend: str = "xla",
                   device=None) -> ops.SparseOp:
    """A reference ``SparseOp``'s COO triplets (``data`` (nnz,),
    ``indices`` (nnz, 2), ``spshape``) as the port's, in the same entry
    order, so both packages build the same ELL pack."""
    return ops.SparseOp.from_coo(
        to_tensor(np.asarray(data), device=device),
        to_tensor(np.asarray(indices, np.int32), device=device),
        tuple(int(d) for d in spshape), backend=backend)


def lowrank(U, s, Vt, extra=(), scale=1.0, *, device=None) -> ops.LowRankOp:
    """A reference ``LowRankOp``'s fields as the port's."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    sc = scale if isinstance(scale, (int, float)) else arr(scale)
    return ops.LowRankOp(arr(U), arr(s), arr(Vt),
                         extra=tuple((arr(L), arr(R)) for L, R in extra),
                         scale=sc)


def operator(ref: Any, *, backend=None, device=None) -> ops.Operator:
    """Any reference operator (``DenseOp``, ``SparseOp``, ``LowRankOp``,
    ``KroneckerOp``, ``SumOp``, ``ScaledOp``, ``TransposedOp``, ``GramOp``,
    ``SinglePassOp``), read by its class name and fields, as the port's.
    ``backend`` overrides the dense and sparse operators' own."""
    kind = type(ref).__name__

    def sub(x):
        return operator(x, backend=backend, device=device)

    if kind == "DenseOp":
        return operand(ref.A, backend=backend or ref.backend, device=device)
    if kind == "SparseOp":
        return sparse_operand(ref.data, ref.indices, ref.spshape,
                              backend=backend or ref.backend, device=device)
    if kind == "LowRankOp":
        return lowrank(ref.U, ref.s, ref.Vt, ref.extra, ref.scale,
                       device=device)
    if kind == "KroneckerOp":
        return ops.KroneckerOp(sub(ref.a), sub(ref.b))
    if kind == "SumOp":
        return ops.SumOp(tuple(sub(t) for t in ref.terms))
    if kind == "ScaledOp":
        alpha = ref.alpha if isinstance(ref.alpha, (int, float)) else \
            float(np.asarray(ref.alpha))
        return ops.ScaledOp(alpha, sub(ref.op))
    if kind == "TransposedOp":
        return ops.TransposedOp(sub(ref.inner))
    if kind == "GramOp":
        return ops.GramOp(sub(ref.inner), ref.side)
    if kind == "SinglePassOp":
        return ops.SinglePassOp(sub(ref.inner))
    raise TypeError(f"no port of a reference {kind}")


def problem(ref: Any, *, backend=None, device=None) -> MatrixFreeProblem:
    """A reference ``MatrixFreeProblem`` (``op``, ``dense``) as the
    port's."""
    return MatrixFreeProblem(
        operator(ref.op, backend=backend, device=device),
        to_tensor(np.asarray(ref.dense), device=device))


def start_vector(q1, *, device=None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A GK start vector ``q1`` (m,) drawn on the reference side."""
    return to_tensor(np.asarray(q1), device=device, dtype=dtype)


def sketch(ref: Any, *, backend=None, device=None, dtype=None):
    """A reference test matrix (``repro.core.sketch``) as the port's: a
    ``SparseSignSketch`` (``idx``, ``signs``, ``n`` and optionally
    ``backend``) or a ``GaussianSketch`` (``T``), the arrays as numpy
    arrays.  ``backend`` overrides the sketch's own; ``dtype`` casts the
    weights."""
    if hasattr(ref, "idx"):
        idx_np = np.asarray(ref.idx, np.int32)
        n = int(ref.n)
        if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= n):
            raise ValueError(f"sketch indices must lie in [0, {n}), got "
                             f"[{idx_np.min()}, {idx_np.max()}]")
        idx = to_tensor(idx_np, device=device)
        signs = to_tensor(np.asarray(ref.signs), device=device, dtype=dtype)
        return SparseSignSketch(idx, signs, n,
                                backend=backend or getattr(ref, "backend",
                                                           "xla"))
    return GaussianSketch(to_tensor(np.asarray(ref.T), device=device,
                                    dtype=dtype))


def hashed_sketch(slots, signs, d: int, *, device=None) -> _HashedSketch:
    """A hashed-sign table (``slots`` (n, ζ) in [0, d), ``signs`` (n, ζ))
    drawn on the reference side — ``repro.sketchres.state._hashed`` — as
    the port's, to hand to ``sketch_operand(omega=, psi=)``."""
    slots_np = np.asarray(slots, np.int32)
    if slots_np.size and (slots_np.min() < 0 or slots_np.max() >= d):
        raise ValueError(f"slots must lie in [0, {d}), got "
                         f"[{slots_np.min()}, {slots_np.max()}]")
    return _HashedSketch(to_tensor(slots_np, device=device),
                         to_tensor(np.asarray(signs, np.float32),
                                   device=device), int(d))


def sketch_state(ref: Any, omega: _HashedSketch, psi: _HashedSketch, *,
                 device=None) -> SketchState:
    """A reference ``SketchState`` (panels ``Y`` / ``Z``, ``folded_mass``,
    ``base_norm``, ``zeta``, ``budget``, ``backend``) as the port's,
    carrying the tables ``omega`` / ``psi`` (from :func:`hashed_sketch`)
    in place of the reference's PRNG keys."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return SketchState(Y=arr(ref.Y), Z=arr(ref.Z),
                       folded_mass=arr(ref.folded_mass).to(torch.float32),
                       base_norm=arr(ref.base_norm).to(torch.float32),
                       tables=(omega, psi), zeta=int(ref.zeta),
                       budget=float(ref.budget), backend=ref.backend)


def factorization(ref: Any, *, device=None) -> Factorization:
    """A reference ``Factorization`` (or any object with ``U``, ``s``,
    ``V``, ``iterations``, ``breakdown`` and optionally ``method``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return Factorization(arr(ref.U), arr(ref.s), arr(ref.V),
                         arr(ref.iterations), arr(ref.breakdown),
                         method=getattr(ref, "method", "fsvd"))


def spec(ref: Any) -> SVDSpec:
    """A reference ``SVDSpec`` (a dataclass instance) or a mapping of its
    fields; a numpy/JAX ``dtype`` maps to the torch dtype of that name."""
    fields = dict(ref) if isinstance(ref, Mapping) else \
        dataclasses.asdict(ref)
    fields["dtype"] = torch_dtype(fields.get("dtype"))
    return SVDSpec(**fields)


def fixed_rank_point(ref: Any, *, device=None) -> mf.FixedRankPoint:
    """A reference ``FixedRankPoint`` (``U``, ``s``, ``V``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return mf.FixedRankPoint(arr(ref.U), arr(ref.s), arr(ref.V))


def tangent_vector(ref: Any, *, device=None) -> mf.TangentVector:
    """A reference ``TangentVector`` (``M``, ``Up``, ``Vp``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return mf.TangentVector(arr(ref.M), arr(ref.Up), arr(ref.Vp))


def rsl_dataset(ref: Any, *, device=None) -> RSLDataset:
    """A reference ``RSLDataset`` (``X``, ``V``, ``y``, ``Wu``, ``Wv``)."""
    def arr(x):
        return to_tensor(np.asarray(x), device=device)
    return RSLDataset(arr(ref.X), arr(ref.V), arr(ref.y), arr(ref.Wu),
                      arr(ref.Wv))


# ---------------------------------------------------------------------------
# model parameters and optimizer state
# ---------------------------------------------------------------------------

def _split_layers(tree: Mapping, device) -> dict:
    """A reference parameter pytree (nested mappings of arrays) in the
    port's layout: each stacked key (``layers``, ``enc_layers``,
    ``dec_layers``) split along axis 0 into a list of per-layer
    subtrees."""
    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            node = np.asarray(node)
        return to_tensor(node, device=device)

    def layer(node, i):
        if isinstance(node, Mapping):
            return {k: layer(v, i) for k, v in node.items()}
        return node[i]

    def depth(node):
        while isinstance(node, Mapping):
            node = next(iter(node.values()))
        return node.shape[0]

    out = {}
    for k, v in tree.items():
        v = conv(v)
        out[k] = ([layer(v, i) for i in range(depth(v))] if k in STACKED
                  else v)
    return out


def _names(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_names(v, name + "."))
        elif isinstance(v, list):
            for i, t in enumerate(v):
                out.update(_names(t, f"{name}.{i}."))
        else:
            out[name] = v
    return out


def named_tensors(ref_tree: Mapping, *, device=None) -> dict:
    """A pytree of numpy arrays (or tensors) in the reference's parameter
    layout (params, gradients, moments) as the port's name -> tensor dict,
    named as the model's ``named_parameters()`` (``layers.0.attn.wq``).
    Tensors keep their device unless ``device`` is given."""
    return _names(_split_layers(ref_tree, device))


def model_params(cfg, ref_params: Mapping, *, device=None) -> ParamTree:
    """The reference's ``init_model`` params (a pytree of numpy arrays) as
    the port's model, on ``device`` (default: the card).  bfloat16 arrays
    are carried over bit for bit.  The layer stacks must have the
    config's depth."""
    tree = _split_layers(ref_params, device)
    depths = {"layers": None, "enc_layers": None, "dec_layers":
              cfg.num_layers}
    if cfg.encdec is not None:
        depths["enc_layers"] = cfg.encdec.encoder_layers
    n_prefix = sum(1 for k in tree if k.startswith("layer")
                   and k[5:].isdigit())
    depths["layers"] = cfg.num_layers - n_prefix
    for k, want in depths.items():
        if k in tree and len(tree[k]) != want:
            raise ValueError(f"{k}: {len(tree[k])} layers, the config "
                             f"has {want}")
    return ParamTree(tree)


def reference_tree(named) -> dict:
    """The port's parameters or gradients (a model, or a name -> tensor
    mapping such as ``dict(model.named_parameters())``) in the
    reference's pytree layout: nested dicts, each layer list stacked along
    a new axis 0.  Tensors are detached, on their own device."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    root: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.detach()

    def collapse(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return stack([collapse(node[str(i)]) for i in range(len(node))])
        return {k: collapse(v) for k, v in node.items()}

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items, 0)

    return collapse(root)


def opt_state(ref: Any, *, device=None) -> OptState:
    """A reference ``OptState`` (``step``, ``mu``, ``nu``: pytrees shaped
    like the params, ``nu`` None for SGD) as the port's, keyed by the
    port's parameter names."""
    def named(tree):
        return None if tree is None else named_tensors(tree, device=device)
    return OptState(to_tensor(np.asarray(ref.step, np.int32), device=device),
                    named(ref.mu), named(ref.nu))
