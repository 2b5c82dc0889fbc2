"""Wrapper around the sparse-sign sketch kernels of ``csrc/sketch_matvec.cu``.

Counterpart of ``repro.kernels.sketch_matvec``:

  ``sketch_matmat``  Y = Tᵀ X,  Y[i, :] = Σ_s signs[i, s] · X[idx[i, s], :]

with the test matrix T (N, d) in its (d, ζ) ELL pack (``core.sketch``).
``signs`` (d, ζ) is f32, bf16 or f64 and ``idx`` (d, ζ) int32, both
contiguous; X (N, b) is f32, bf16 or f64 with ANY strides — the range
sketch passes a transposed view of the operand, which is read in place
and never copied.  The output is (d, b) f32.

Two kernels, chosen by X's strides: a row-major X streams whole rows in
16-byte loads; a transposed view (stride 1 down its rows) is gathered row
by row of the matrix below it, each chunk of ``chunk_rows(ζ)`` sketch rows
walked in ascending source order, from the permutation
:func:`gather_order`, which ``SparseSignSketch`` makes once and keeps.
Both give each Y[i, c] the same fmaf chain in slot order.

The contract is that of ``kernels.gk_step``: the wrapper checks its
inputs, allocates with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES["sketch_matmat"]``; for CPU tensors, and only for
them, it returns the plain version from ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor

# nonzeros per column of the sparse-sign ensemble (the reference's ZETA)
ZETA = 8
# slots of a chunk of sketch rows the range kernel sorts (kMaxChunkSlots)
CHUNK_SLOTS = 1024
RANGE_ROWS = 16         # most rows below X a range-kernel block owns

# dtype of signs / X -> the kernel's kind
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

LAUNCHES = {"sketch_matmat": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sketch_matmat": [_P, _I, _P, _P, _I, _L, _I, _I, _P, _I, _L, _L, _L,
                      _L, _P, _P],
    "sketch_error_string": [_I],
}


def reset_launches() -> None:
    LAUNCHES["sketch_matmat"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("sketch_matvec", _SIGNATURES)
    lib.sketch_error_string.restype = ctypes.c_char_p
    return lib


def _float2d(name: str, x: Tensor) -> None:
    if not isinstance(x, Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor")
    if x.dtype not in KINDS:
        raise TypeError(f"{name} must be float64, float32 or bfloat16, got "
                        f"{x.dtype}")


def chunk_rows(zeta: int) -> int:
    """Sketch rows in a chunk of the range kernel: as many as
    ``CHUNK_SLOTS`` slots hold (one at least; 0 past what one row
    allows)."""
    return CHUNK_SLOTS // zeta


def gather_order(idx: Tensor) -> Tensor:
    """The range kernel's permutation of a (d, ζ) pack, on its device:
    within each chunk of ``chunk_rows(ζ)`` sketch rows, the chunk's flat
    slots sorted by source row (stable).  Returns (2, d·ζ) int32: row 0
    the sorted source rows, row 1 the flat slot i·ζ + s each came from."""
    d, zeta = idx.shape
    flat = idx.reshape(-1).long()
    per = max(chunk_rows(zeta), 1) * zeta
    chunk = torch.arange(flat.shape[0], device=idx.device) // per
    order = torch.sort(flat, stable=True).indices
    order = order[torch.sort(chunk[order], stable=True).indices]
    return torch.stack([flat[order], order]).to(torch.int32)


def range_rows(d: int, zeta: int, b: int) -> int:
    """Rows below X (columns of X) a range-kernel block owns: ``RANGE_ROWS``
    where the grid (chunks × row groups) still holds two blocks an SM,
    else the largest power of two that does (one at least)."""
    per = max(chunk_rows(zeta), 1)
    chunks = -(-d // per)
    rows = RANGE_ROWS
    while rows > 1 and chunks * -(-b // rows) < 2 * gs.SMS:
        rows //= 2
    return rows


def _ranges(X: Tensor, zeta: int) -> bool:
    """Whether X takes the range kernel: a transposed view (unit stride
    down its rows, not along them) and chunks that fit its limit."""
    return X.stride(0) == 1 and X.stride(1) != 1 and chunk_rows(zeta) >= 1


def sketch_matmat(signs: Tensor, idx: Tensor, X: Tensor,
                  order: Optional[Tensor] = None) -> Tensor:
    """Y = Tᵀ X for T in the sparse-sign ELL pack.  signs / idx (d, ζ);
    X (N, b), any strides → (d, b) f32.  Every index must lie in [0, N),
    as ``core.sketch.make_sketch`` and ``bridge.sketch`` ensure; the
    kernel does not check.  ``order``, ``gather_order(idx)`` (the
    sketch's own, kept), serves a transposed view; without it one is made
    for the call."""
    _float2d("signs", signs)
    _float2d("X", X)
    if not isinstance(idx, Tensor) or idx.shape != signs.shape:
        raise ValueError("idx must be a tensor of the shape of signs, "
                         f"{tuple(signs.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    devices = {signs.device, idx.device, X.device}
    if len(devices) != 1:
        raise ValueError(f"inputs are on different devices: {devices}")
    dev = devices.pop()
    d, zeta = signs.shape
    if order is not None and (not isinstance(order, Tensor)
                              or order.shape != (2, d * zeta)
                              or order.dtype != torch.int32
                              or order.device != dev
                              or not order.is_contiguous()):
        raise ValueError(f"order must be the contiguous (2, {d * zeta}) "
                         f"int32 gather_order of idx on {dev}")
    if dev.type == "cpu":
        return ref.sketch_matmat(signs, idx, X)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not (signs.is_contiguous() and idx.is_contiguous()):
        raise ValueError("signs and idx must be contiguous")
    N, b = X.shape
    if d == 0 or b == 0:
        raise ValueError(f"empty sketch ({d} rows) or block ({b} columns)")
    ranges = _ranges(X, zeta)
    if ranges and order is None:
        order = gather_order(idx)
    Y = torch.empty(d, b, dtype=torch.float32, device=dev)
    rc = _lib().sketch_matmat(
        signs.data_ptr(), KINDS[signs.dtype], idx.data_ptr(),
        order.data_ptr() if ranges else None, zeta, d, chunk_rows(zeta),
        range_rows(d, zeta, b), X.data_ptr(), KINDS[X.dtype], N, b,
        X.stride(0), X.stride(1), Y.data_ptr(), gs._stream())
    if rc != 0:
        msg = _lib().sketch_error_string(rc).decode()
        raise RuntimeError(f"sketch_matmat: CUDA error {rc} ({msg})")
    LAUNCHES["sketch_matmat"] += 1
    return Y
