"""The ELL pack, its window layout and the wrapper around the sparse
matvec kernels of ``csrc/sparse_matvec.cu``.

Counterpart of ``repro.kernels.sparse_matvec``:

  ``ell_pack``       COO triplets → padded ELL rows ``vals`` / ``cols``
                     (m, L), L the largest row population
  ``window_layout``  a pack with each row's slots stably reordered by
                     sub-window of ``SUB`` rows of x, its padding last,
                     and where each window's (or sub-window's) segment
                     starts
  ``pack_layout``    the layout an operator builds once for a pack, or
                     None (it then holds the pack in that order)
  ``sparse_matvec``  Y[i, :] = Σ_s vals[i, s] · X[cols[i, s], :]

The pack and the layout are built with torch ops on the tensors' own
device, so the same code runs on the CPU in the tests and on the card.
``vals`` is f32, bf16 or f64 and ``cols`` int32, both contiguous; X is
(n,) or (n, b) f32 and contiguous.  The output is (m,) or (m, b) f32: a
block of b columns is one launch (the reference vmaps its kernel over the
columns).

What bounds the kernels is bytes: the pack is streamed once, and every
slot gathers an element of x, or a row of X's b columns.  Gathered from
L2, each costs 32-byte sectors: on the transposed pack of a tall matrix
(rows of thousands of slots, x of a few MB) four times the pack's own
bytes, and for a block of 20 columns (80 bytes over three sectors) twelve
times.  So the operator's window layout serves both: every window of x
(``WINDOW`` f32 for one vector; ``block_plan``'s ``ratio`` sub-windows ×
b columns, at most ``BLOCK_FLOATS`` f32, for a block) is one contiguous
segment of each row.  A block of threads stages one window in shared
memory and sums the rows' segments in it, gathering from shared memory,
and a second pass adds each row's partials in window order
(``window_plan`` and ``block_plan`` cut the work; ``csrc/sparse_matvec.cu``
says more).  One vector through short rows (the forward pack), a pack
without a layout and a block wider than ``MAX_BLOCK_COLS`` columns take
the warp-per-row kernel, which gathers from L2.

Memory is bounded by the pack: the operator's layout (``pack_layout``)
keeps its sub-window table only where that is at most a quarter of the
pack's bytes (``sub_table_fits``), and a block product takes the block
kernel only where its partials scratch is at most the pack's bytes, or
one window's (``block_scratch_fits``).  A wide, sparse matrix (rows of a
few hundred slots over an x of a million) fails both, holds no layout,
and takes the warp-per-row kernel.

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
# as in the CUDA source (kLongRow, kSub, kWindow, ...)
LONG_ROW = 1024                # slots from which a row is long
SUB = 512                      # rows of x in a sub-window of the layout
WINDOW = 49152                 # f32 of x a window holds: 192 KB
WINDOW_SUBS = WINDOW // SUB    # 96 sub-windows a window
WINDOW_BLOCKS = gs.SMS         # one 192 KB block on each SM
MAX_BLOCK_COLS = 32            # a block window's columns: 8 lanes x 4
BLOCK_FLOATS = 51200           # f32 of X a block window holds: 200 KB
BLOCK_WAVE_SHARE = 0.94        # least share of the last wave's SMs a
                               # block plan keeps busy, where it can
TABLE_SHARE = 4                # a layout's sub-window table takes at most
                               # this share (1 / 4) of its pack's bytes

LAUNCHES = {"sparse_matvec": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sparse_matvec": [_P, _I, _P, _L, _I, _P, _L, _P, _P],
    "sparse_matvec_windows": [_P, _I, _P, _P, _L, _I, _I, _P, _L, _L, _I,
                              _P, _P, _P],
    "sparse_matvec_block": [_P, _I, _P, _P, _L, _I, _I, _I, _I, _P, _L, _I,
                            _L, _I, _P, _P, _P],
    "sparse_error_string": [_I],
}


class WindowLayout(NamedTuple):
    """A pack by window of x: ``vals`` / ``cols`` (m, L) hold each row's
    slots stably reordered by sub-window (column // ``SUB``), the row's
    padding after them, so a window of consecutive sub-windows is one
    contiguous segment of a row.  ``window_offsets`` (m, windows + 1)
    int32: where row i's segment in each ``WINDOW``-sized window of one
    vector starts (the last column: where its padding starts).
    ``offsets`` (m, subs + 1) int32, or None: the same at every
    sub-window, which a block window of any width reads; a layout keeps
    it only where it is small beside the pack (:func:`sub_table_fits`).
    ``vals`` / ``cols`` are an ELL pack of the same matrix (the same slots
    in each row, in another order), and the layout serves only that pack:
    :func:`sparse_matvec` takes it with those very tensors."""
    vals: torch.Tensor
    cols: torch.Tensor
    offsets: Optional[torch.Tensor]
    window_offsets: torch.Tensor


class WindowPlan(NamedTuple):
    """How the window kernel cuts its work: ``windows`` windows of x times
    ``groups`` groups of ``rows_per_group`` rows, a block each."""
    windows: int
    groups: int
    rows_per_group: int


class BlockPlan(NamedTuple):
    """How the block kernel cuts a block of b columns: windows of
    ``ratio`` sub-windows of X's rows (all b columns), ``windows`` of
    them, times ``groups`` groups of ``rows_per_group`` rows, a block
    each."""
    ratio: int
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


def sub_count(n: int) -> int:
    """Sub-windows of ``SUB`` rows that cover an x of length n (one at
    least)."""
    return max(-(-n // SUB), 1)


def slot_bytes(dtype: torch.dtype) -> int:
    """Bytes of one slot of a pack: its value and its 4-byte column."""
    return torch.empty((), dtype=dtype).element_size() + 4


def sub_table_fits(L: int, n: int, dtype: torch.dtype) -> bool:
    """Whether a pack of rows of L slots (values of ``dtype``) over an x of
    length n keeps a layout's sub-window table: its 4 · (subs + 1) bytes a
    row at most 1 / ``TABLE_SHARE`` of the row's own bytes."""
    return 4 * (sub_count(n) + 1) * TABLE_SHARE <= L * slot_bytes(dtype)


def window_layout(vals: Tensor, cols: Tensor, n: int, counts: Tensor,
                  sub_table: bool = True) -> WindowLayout:
    """The window layout of an ELL pack whose columns index an x of length
    ``n``, on the pack's device: a stable sort of each row's slots by
    sub-window, and each window's (with ``sub_table``, each sub-window's)
    first slot found by a binary search.  ``counts`` (m,), each row's
    population, marks the slots past it as padding, which sorts last and
    lies in no window.  Its ``vals`` / ``cols`` are a new pack, which the
    operator holds in place of the one it was built from; the tables add
    4 · (windows + 1) bytes a row, and 4 · (subs + 1) with the sub-window
    table."""
    m, L = cols.shape
    if not isinstance(counts, Tensor) or counts.shape != (m,):
        raise ValueError(f"counts must be the {m} rows' populations")
    subs = sub_count(n)
    key = torch.div(cols, SUB, rounding_mode="floor")
    slot = torch.arange(L, dtype=torch.int32, device=cols.device)
    key.masked_fill_(slot[None, :] >= counts.to(key)[:, None], subs)
    key, order = torch.sort(key, dim=1, stable=True)
    edges = [min(w * WINDOW_SUBS, subs) for w in range(window_count(n) + 1)]
    at = torch.arange(subs + 1) if sub_table else torch.tensor(edges)
    starts = torch.searchsorted(key, at.to(key).expand(m, -1).contiguous(),
                                out_int32=True)
    del key
    return WindowLayout(torch.gather(vals, 1, order),
                        torch.gather(cols, 1, order),
                        starts if sub_table else None,
                        starts[:, edges].contiguous() if sub_table
                        else starts)


def pack_layout(vals: Tensor, cols: Tensor, n: int,
                counts: Tensor) -> Optional[WindowLayout]:
    """The layout an operator holds for a pack (``counts`` its rows'
    populations), or None where no windowed path serves the pack: with
    the sub-window table where :func:`sub_table_fits` (blocks of
    columns), else for rows of ``LONG_ROW`` slots or more with the window
    table alone (one vector).  So a layout never adds more than
    1 / ``TABLE_SHARE`` of the pack's bytes, or 4 · (windows + 1) bytes
    a row of ``LONG_ROW`` slots or more."""
    L = cols.shape[1]
    blocks = sub_table_fits(L, n, vals.dtype)
    if not blocks and L < LONG_ROW:
        return None
    return window_layout(vals, cols, n, counts, sub_table=blocks)


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


def block_ratio(b: int) -> int:
    """Sub-windows of X's rows in a block window of b columns, staged at
    a pitch of b rounded up to 4 floats: as many as ``BLOCK_FLOATS``
    holds (0 past what one sub-window allows)."""
    return BLOCK_FLOATS // (SUB * -(-b // 4) * 4)


def block_windows(n: int, b: int) -> int:
    """Block windows of ``block_ratio(b)`` sub-windows that cover an X of
    n rows (one at least)."""
    ratio = block_ratio(b)
    if ratio < 1:
        raise ValueError(f"a block window takes at most "
                         f"{BLOCK_FLOATS // SUB} columns, got {b}")
    return max(-(-n // (ratio * SUB)), 1)


def block_scratch_fits(L: int, n: int, b: int, dtype: torch.dtype) -> bool:
    """Whether the block kernel serves b columns through a pack of rows of
    L slots (values of ``dtype``) over an X of n rows: its partials,
    windows × b f32 a row, take at most the row's own bytes, or are one
    window's (then the output's own size).  Past that, the partials would
    outweigh the pack in memory and in traffic (a wide, sparse matrix:
    few slots in each window of a row), and the warp-per-row kernel
    serves the shape."""
    windows = block_windows(n, b)
    return windows == 1 or windows * b * 4 <= L * slot_bytes(dtype)


def block_plan(m: int, n: int, b: int) -> BlockPlan:
    """The block kernel's plan for an (m, L) pack and an (n, b) X:
    windows of ``block_ratio(b)`` sub-windows, and the rows cut into the
    fewest equal groups whose blocks (windows × groups, one an SM at a
    time) keep ``BLOCK_WAVE_SHARE`` of the SMs of their last wave busy,
    else the share that comes closest (fewer groups stage X fewer times).
    The plan is fixed by (m, n, b); the sums are fixed by the window size
    alone: each (row, window, column) partial is one lane's chain in slot
    order, added in window order."""
    ratio = block_ratio(b)
    windows = block_windows(n, b)
    best, best_share = 1, 0.0
    for g in range(1, min(m, max(8 * gs.SMS // windows, 1)) + 1):
        blocks = windows * g
        share = blocks / (-(-blocks // gs.SMS) * gs.SMS)
        if share > best_share + 1e-12:
            best, best_share = g, share
        if share >= BLOCK_WAVE_SHARE:
            best = g
            break
    per = -(-m // best)
    return BlockPlan(ratio, windows, -(-m // per), per)


def sparse_matvec(vals: Tensor, cols: Tensor, X: Tensor,
                  layout: Optional[WindowLayout] = None) -> Tensor:
    """Y = A X for A in padded-ELL rows.  vals / cols (m, L); X (n,) or
    (n, b) f32, contiguous → (m,) or (m, b) f32.  Every column index must
    lie in [0, n): :func:`ell_pack` raises on any that does not, and the
    kernel itself does not check.  ``layout``, a :func:`window_layout`
    whose ``vals`` / ``cols`` are these very tensors (the operator holds
    such a pack), takes one vector through long rows (``LONG_ROW`` slots
    or more) by window of x, and a block of 2 to ``MAX_BLOCK_COLS``
    columns by block window where the layout has its sub-window table and
    :func:`block_scratch_fits`; the rest reads the pack a warp a row.  So
    the path, and with it every sum's order, is fixed by (m, L, n, b, the
    values' dtype) and the layout's tables."""
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
    m, L = vals.shape
    n = X.shape[0]
    b = 1 if X.dim() == 1 else X.shape[1]
    path = "rows"            # the warp-per-row kernel, else a window path
    if layout is not None:
        _check_layout(layout, vals, cols, n, dev)
        if X.dim() == 1 and L >= LONG_ROW:
            path = "windows"
        elif (X.dim() == 2 and 2 <= b <= MAX_BLOCK_COLS
              and layout.offsets is not None
              and block_scratch_fits(L, n, b, vals.dtype)):
            path = "block"
    if dev.type == "cpu":
        if path == "windows":
            return ref.sparse_matvec_windows(vals, cols,
                                             layout.window_offsets, X, 1)
        if path == "block":
            return ref.sparse_matvec_windows(vals, cols, layout.offsets, X,
                                             block_ratio(b))
        return ref.sparse_matvec(vals, cols, X)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not (vals.is_contiguous() and cols.is_contiguous()
            and X.is_contiguous()):
        raise ValueError("vals, cols and X must be contiguous")
    if m == 0 or n == 0 or b == 0:
        raise ValueError(f"empty operand ({m} x {n}) or block ({b} columns)")
    if b > MAX_COLS:
        raise ValueError(f"block of {b} columns; at most {MAX_COLS}")
    Y = torch.empty((m,) + tuple(X.shape[1:]), dtype=torch.float32,
                    device=dev)
    kind = KINDS[vals.dtype]
    if path == "rows":
        rc = _lib().sparse_matvec(vals.data_ptr(), kind, cols.data_ptr(), m,
                                  L, X.data_ptr(), b, Y.data_ptr(),
                                  gs._stream())
    elif path == "windows":
        plan = window_plan(m, n)
        part = torch.empty(plan.windows * m, dtype=torch.float32, device=dev)
        rc = _lib().sparse_matvec_windows(
            vals.data_ptr(), kind, cols.data_ptr(),
            layout.window_offsets.data_ptr(), m, L, plan.windows,
            X.data_ptr(), n, plan.rows_per_group, plan.groups,
            part.data_ptr(), Y.data_ptr(), gs._stream())
    else:
        plan = block_plan(m, n, b)
        part = torch.empty(plan.windows * m * b, dtype=torch.float32,
                           device=dev)
        rc = _lib().sparse_matvec_block(
            vals.data_ptr(), kind, cols.data_ptr(),
            layout.offsets.data_ptr(), m, L, sub_count(n), plan.ratio,
            plan.windows, X.data_ptr(), n, b, plan.rows_per_group,
            plan.groups, part.data_ptr(), Y.data_ptr(), gs._stream())
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
    m = vals.shape[0]
    tables = [(layout.window_offsets, window_count(n) + 1)]
    if layout.offsets is not None:
        tables.append((layout.offsets, sub_count(n) + 1))
    for off, cols_ in tables:
        if not isinstance(off, Tensor) or off.shape != (m, cols_) \
                or off.dtype != torch.int32:
            raise ValueError(f"the window layout does not fit a "
                             f"{tuple(vals.shape)} pack and an x of {n} "
                             f"elements")
        if off.device != dev or not off.is_contiguous():
            raise ValueError(f"the window layout must be contiguous on "
                             f"{dev}")
