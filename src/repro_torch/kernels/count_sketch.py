"""The index preparation and the wrapper around the COO scatter-add kernel
of ``csrc/count_sketch.cu``.

Counterpart of ``repro.kernels.count_sketch``:

  ``scatter_add``  out[rows[e], cols[e]] += vals[e] on a fresh (m, d) f32
                   panel; duplicate coordinates sum, and a coordinate
                   outside the panel is dropped

``rows`` / ``cols`` are (E,) int32 and ``vals`` (E,) f32, bf16 or f64, all
contiguous.  :func:`sort_keys` prepares the index on the tensors' device,
as ``sparse_matvec.ell_pack`` does for its kernel: the int64 destination
key ``row·d + col`` (``m·d``, past the panel's end, for a coordinate
outside it; no host sync checks for one) and its stable sort, which keeps
the entries of one destination in entry order.  :func:`segment_sum` is the
kernel: it sums each run of equal keys in entry order and writes every
cell once, so the panel is bit for bit the plain version's on the CPU
(``index_add_`` there adds one entry after another, as ``np.add.at``
does).

The contract is that of ``kernels.gk_step``: the wrapper checks its
inputs, allocates with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES["scatter_add"]``; for CPU tensors, and only for
them, it returns the plain version from ``kernels.ref``.  An empty stream
returns zeros without a launch, as the reference's wrapper does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor
F32, I32, I64 = torch.float32, torch.int32, torch.int64

# dtype of vals -> the kernel's kind
KINDS = {F32: 0, torch.bfloat16: 1, torch.float64: 2}

LAUNCHES = {"scatter_add": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "count_sketch_scatter_add": [_P, _P, _P, _I, _L, _L, _P, _P],
    "count_sketch_error_string": [_I],
}


def reset_launches() -> None:
    LAUNCHES["scatter_add"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("count_sketch", _SIGNATURES)
    lib.count_sketch_error_string.restype = ctypes.c_char_p
    return lib


def _panel(shape) -> tuple[int, int]:
    m, d = (int(s) for s in shape)
    if m < 0 or d < 0:
        raise ValueError(f"panel shape must be non-negative, got {shape}")
    return m, d


def _stream_inputs(rows: Tensor, cols: Tensor, vals: Tensor) -> int:
    for name, x in (("rows", rows), ("cols", cols), ("vals", vals)):
        if not isinstance(x, Tensor) or x.dim() != 1:
            raise ValueError(f"{name} must be a 1-D tensor")
    E = rows.shape[0]
    if cols.shape[0] != E or vals.shape[0] != E:
        raise ValueError(f"rows, cols and vals must have one length, got "
                         f"{E}, {cols.shape[0]}, {vals.shape[0]}")
    for name, x in (("rows", rows), ("cols", cols)):
        if x.dtype != I32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if vals.dtype not in KINDS:
        raise TypeError(f"vals must be float64, float32 or bfloat16, got "
                        f"{vals.dtype}")
    return E


def sort_keys(rows: Tensor, cols: Tensor,
              shape) -> tuple[Tensor, Tensor]:
    """(sorted keys, permutation), both (E,) int64: the destination key
    ``row·d + col`` of every entry (``m·d`` where the coordinate lies
    outside the (m, d) panel), stably sorted, so equal keys keep their
    entry order."""
    m, d = _panel(shape)
    keys = rows.to(I64)
    outside = (keys < 0) | (keys >= m) | (cols < 0) | (cols >= d)
    keys.mul_(d).add_(cols).masked_fill_(outside, m * d)
    return torch.sort(keys, stable=True)


def segment_sum(keys: Tensor, perm: Tensor, vals: Tensor,
                shape) -> Tensor:
    """The kernel alone: the (m, d) f32 panel from :func:`sort_keys`'s
    output and the entries' values (CUDA tensors, contiguous)."""
    m, d = _panel(shape)
    for name, x in (("keys", keys), ("perm", perm)):
        if not isinstance(x, Tensor) or x.dtype != I64 or x.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
    if not gs._on_cuda(keys, perm, vals):
        raise ValueError("segment_sum is the CUDA kernel alone; CPU tensors "
                         "take scatter_add's plain version")
    out = torch.empty(m * d, dtype=F32, device=vals.device)
    rc = _lib().count_sketch_scatter_add(
        keys.data_ptr(), perm.data_ptr(), vals.data_ptr(), KINDS[vals.dtype],
        keys.shape[0], m * d, out.data_ptr(), gs._stream())
    if rc != 0:
        msg = _lib().count_sketch_error_string(rc).decode()
        raise RuntimeError(f"scatter_add: CUDA error {rc} ({msg})")
    LAUNCHES["scatter_add"] += 1
    return out.view(m, d)


def scatter_add(rows: Tensor, cols: Tensor, vals: Tensor,
                shape) -> Tensor:
    """Dense (m, d) f32 accumulation of a COO stream.  rows / cols (E,)
    int32; vals (E,) f32/bf16/f64 → (m, d) f32.  Duplicate coordinates sum
    in entry order; a coordinate outside the panel is dropped."""
    E = _stream_inputs(rows, cols, vals)
    m, d = _panel(shape)
    if not gs._on_cuda(rows, cols, vals):
        return ref.scatter_add(rows, cols, vals, (m, d))
    if E == 0 or m * d == 0:
        return torch.zeros((m, d), dtype=F32, device=vals.device)
    keys, perm = sort_keys(rows, cols, (m, d))
    return segment_sum(keys, perm, vals, (m, d))
