"""The ELL pack, its window layout and the wrapper around the sparse
matvec kernels of ``csrc/sparse_matvec.cu``.

Counterpart of ``repro.kernels.sparse_matvec``:

  ``ell_pack``       COO triplets → padded ELL rows ``vals`` / ``cols``
                     (m, L), L the largest row population
  ``window_layout``  a pack with each row's slots reordered by window of
                     x, for rows of ``LONG_ROW`` slots or more (built once
                     per operator, which then holds the pack in that order)
  ``sparse_matvec``  Y[i, :] = Σ_s vals[i, s] · X[cols[i, s], :]

The pack and the layout are built with torch ops on the tensors' own
device, so the same code runs on the CPU in the tests and on the card.
``vals`` is f32, bf16 or f64 and ``cols`` int32, both contiguous; X is
(n,) or (n, b) f32 and contiguous.  The output is (m,) or (m, b) f32: a
block of b columns is one launch (the reference vmaps its kernel over the
columns).

What bounds the kernel is bytes: the pack is streamed once, and every
slot gathers an element of x.  On the transposed pack of a tall matrix
(rows of thousands of slots, x of a few MB) those gathers are random
32-byte sectors of L2, four times the pack's own bytes.  So one vector
through long rows goes through the window layout when the operator has
one: x is cut into windows of ``WINDOW`` f32 that fit a block's shared
memory, each block stages one window and sums the rows' segments in it,
gathering from shared memory, and a second pass adds each row's
``windows`` partials in window order (``window_plan`` cuts the rows;
``csrc/sparse_matvec.cu`` says more).  Without a layout, and for a block
of columns, a long row is a block's team that gathers from L2.

The contract is that of ``kernels.gk_step``: the wrapper checks its
inputs, allocates with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES["sparse_matvec"]``; for CPU tensors, and only for
them, it returns the plain version from ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor

# dtype of vals -> the kernel's kind
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
MAX_COLS = 65535 * 32          # gridDim.y limit times the columns per chunk
# as in the CUDA source (kLongRow, kWindow, ...)
LONG_ROW = 1024                # slots from which a row is long
WINDOW = 49152                 # f32 of x a window holds: 192 KB
WINDOW_BLOCKS = gs.SMS         # one 192 KB block on each SM

LAUNCHES = {"sparse_matvec": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sparse_matvec": [_P, _I, _P, _L, _I, _P, _L, _P, _P],
    "sparse_matvec_windows": [_P, _I, _P, _P, _L, _I, _I, _P, _L, _L, _I,
                              _P, _P, _P],
    "sparse_error_string": [_I],
}


class WindowLayout(NamedTuple):
    """A pack by window of x: ``vals`` / ``cols`` (m, L) hold each row's
    slots stably reordered by window (column // ``WINDOW``), and row i's
    segment in window w is slots ``offsets[i, w]`` to ``offsets[i, w + 1]``
    (``offsets`` (m, windows + 1) int32).  ``vals`` / ``cols`` are an ELL
    pack of the same matrix (the same slots in each row, in another
    order), and the layout serves only that pack: :func:`sparse_matvec`
    takes it with those very tensors."""
    vals: torch.Tensor
    cols: torch.Tensor
    offsets: torch.Tensor


class WindowPlan(NamedTuple):
    """How the window kernel cuts its work: ``windows`` windows of x times
    ``groups`` groups of ``rows_per_group`` rows, a block each."""
    windows: int
    groups: int
    rows_per_group: int


def reset_launches() -> None:
    LAUNCHES["sparse_matvec"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_matvec", _SIGNATURES)
    lib.sparse_error_string.restype = ctypes.c_char_p
    return lib


def ell_pack(data: Tensor, indices: Tensor,
             spshape) -> tuple[Tensor, Tensor]:
    """Pack COO triplets into padded ELL rows, on the tensors' device.

    ``data`` (nnz,), ``indices`` (nnz, 2) of [row, col] → ``(vals (m, L),
    cols (m, L) int32)`` with L the largest row population (at least 1).
    Entries keep their COO order within a row (a stable sort by row);
    duplicate coordinates keep separate slots (they sum), and empty slots
    hold (value 0, column 0), which is exact since ``0 · x[0] == 0``.  The
    same slots, bit for bit, as the reference's NumPy ``ell_pack``.
    Positions are int64: m · L may pass 2³¹.  Raises ``ValueError`` when
    an index lies outside ``spshape``, so the kernel never gathers out of
    bounds.
    """
    m, n = int(spshape[0]), int(spshape[1])
    dev = data.device
    if indices.dim() != 2 or indices.shape[1] != 2 \
            or indices.shape[0] != data.shape[0]:
        raise ValueError(f"indices must be (nnz, 2) with nnz = "
                         f"{data.shape[0]}, got {tuple(indices.shape)}")
    if indices.shape[0]:
        lo = indices.amin(0).tolist()
        hi = indices.amax(0).tolist()
        if min(lo) < 0 or hi[0] >= m or hi[1] >= n:
            raise ValueError(f"COO indices span rows [{lo[0]}, {hi[0]}] and "
                             f"columns [{lo[1]}, {hi[1]}], outside the "
                             f"shape ({m}, {n})")
    rows = indices[:, 0].long()
    counts = torch.bincount(rows, minlength=m)
    L = max(int(counts.max()) if counts.numel() else 0, 1)
    order = torch.argsort(rows, stable=True)
    r_sorted = rows[order]
    del rows
    start = torch.cumsum(counts, 0) - counts         # first slot of a row
    slot = torch.arange(r_sorted.shape[0], device=dev) - start[r_sorted]
    flat = r_sorted.mul_(L).add_(slot)               # row * L + slot
    del slot
    vals = torch.zeros(m * L, dtype=data.dtype, device=dev)
    vals[flat] = data[order]
    cols = torch.zeros(m * L, dtype=torch.int32, device=dev)
    cols[flat] = indices[:, 1][order].to(torch.int32)
    return vals.view(m, L), cols.view(m, L)


def window_count(n: int) -> int:
    """Windows of ``WINDOW`` f32 that cover an x of length n (one at least)."""
    return max(-(-n // WINDOW), 1)


def window_layout(vals: Tensor, cols: Tensor, n: int) -> WindowLayout:
    """The window layout of an ELL pack whose columns index an x of length
    ``n``, on the pack's device: a stable sort of each row's slots by
    window, and each window's first slot found by a binary search.  Its
    ``vals`` / ``cols`` are a new pack (the offsets add 4 · (windows + 1)
    bytes a row), which the operator holds in place of the one it was
    built from.  A pack of rows shorter than ``LONG_ROW`` gains nothing
    from it: the operator builds none for those."""
    m, L = cols.shape
    windows = window_count(n)
    win = torch.div(cols, WINDOW, rounding_mode="floor")
    win, order = torch.sort(win, dim=1, stable=True)
    bounds = torch.arange(windows + 1, dtype=win.dtype, device=win.device)
    offsets = torch.searchsorted(win, bounds.expand(m, -1).contiguous())
    del win
    return WindowLayout(torch.gather(vals, 1, order),
                        torch.gather(cols, 1, order),
                        offsets.to(torch.int32))


def window_plan(m: int, n: int) -> WindowPlan:
    """The window kernel's plan for an (m, L) pack and an x of length n:
    ``ceil(n / WINDOW)`` windows, and the rows cut into as many equal
    groups as fill ``WINDOW_BLOCKS`` blocks (at least one).  The sums do
    not depend on it: each (row, window) partial is one warp's, and the
    partials are added in window order."""
    windows = window_count(n)
    groups = min(max(WINDOW_BLOCKS // windows, 1), m)
    per = -(-m // groups)
    return WindowPlan(windows, -(-m // per), per)


def sparse_matvec(vals: Tensor, cols: Tensor, X: Tensor,
                  layout: Optional[WindowLayout] = None) -> Tensor:
    """Y = A X for A in padded-ELL rows.  vals / cols (m, L); X (n,) or
    (n, b) f32, contiguous → (m,) or (m, b) f32.  Every column index must
    lie in [0, n): :func:`ell_pack` raises on any that does not, and the
    kernel itself does not check.  ``layout``, a :func:`window_layout`
    whose ``vals`` / ``cols`` are these very tensors (the operator holds
    such a pack), takes one vector through the window kernel; a block of
    columns reads the pack without it."""
    if not isinstance(vals, Tensor) or vals.dim() != 2:
        raise ValueError("vals must be a 2-D tensor")
    if vals.dtype not in KINDS:
        raise TypeError(f"vals must be float64, float32 or bfloat16, got "
                        f"{vals.dtype}")
    if not isinstance(cols, Tensor) or cols.shape != vals.shape:
        raise ValueError("cols must be a tensor of the shape of vals, "
                         f"{tuple(vals.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if not isinstance(X, Tensor) or X.dim() not in (1, 2):
        raise ValueError("X must be a 1-D or 2-D tensor")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")
    devices = {vals.device, cols.device, X.device}
    if len(devices) != 1:
        raise ValueError(f"inputs are on different devices: {devices}")
    dev = devices.pop()
    if layout is not None:
        _check_layout(layout, vals, cols, X.shape[0], dev)
        if X.dim() != 1:
            layout = None
    if dev.type == "cpu":
        if layout is not None:
            return ref.sparse_matvec_windows(vals, cols, layout.offsets, X)
        return ref.sparse_matvec(vals, cols, X)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not (vals.is_contiguous() and cols.is_contiguous()
            and X.is_contiguous()):
        raise ValueError("vals, cols and X must be contiguous")
    m, L = vals.shape
    n = X.shape[0]
    b = 1 if X.dim() == 1 else X.shape[1]
    if m == 0 or n == 0 or b == 0:
        raise ValueError(f"empty operand ({m} x {n}) or block ({b} columns)")
    if b > MAX_COLS:
        raise ValueError(f"block of {b} columns; at most {MAX_COLS}")
    Y = torch.empty((m,) + tuple(X.shape[1:]), dtype=torch.float32,
                    device=dev)
    if layout is None:
        rc = _lib().sparse_matvec(vals.data_ptr(), KINDS[vals.dtype],
                                  cols.data_ptr(), m, L, X.data_ptr(), b,
                                  Y.data_ptr(), gs._stream())
    else:
        plan = window_plan(m, n)
        part = torch.empty(plan.windows * m, dtype=torch.float32, device=dev)
        rc = _lib().sparse_matvec_windows(
            vals.data_ptr(), KINDS[vals.dtype], cols.data_ptr(),
            layout.offsets.data_ptr(), m, L,
            plan.windows, X.data_ptr(), n, plan.rows_per_group, plan.groups,
            part.data_ptr(), Y.data_ptr(), gs._stream())
    if rc != 0:
        msg = _lib().sparse_error_string(rc).decode()
        raise RuntimeError(f"sparse_matvec: CUDA error {rc} ({msg})")
    LAUNCHES["sparse_matvec"] += 1
    return Y


def _check_layout(layout: WindowLayout, vals: Tensor, cols: Tensor, n: int,
                  dev: torch.device) -> None:
    """Raise unless ``layout`` is the layout of the pack ``vals`` / ``cols``
    (the very tensors) for an x of length ``n`` (the offsets themselves
    are trusted: ``window_layout`` made them)."""
    if not isinstance(layout, WindowLayout):
        raise TypeError("layout must be a WindowLayout")
    if layout.vals is not vals or layout.cols is not cols:
        raise ValueError("the window layout is not of this pack: pass its "
                         "own vals and cols")
    off = layout.offsets
    if off.shape != (vals.shape[0], window_count(n) + 1) \
            or off.dtype != torch.int32:
        raise ValueError(f"the window layout does not fit a "
                         f"{tuple(vals.shape)} pack and an x of {n} "
                         f"elements")
    if off.device != dev or not off.is_contiguous():
        raise ValueError(f"the window layout must be contiguous on {dev}")
