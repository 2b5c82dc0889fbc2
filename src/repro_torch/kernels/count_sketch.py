"""The wrapper around the COO scatter-add kernels of ``csrc/count_sketch.cu``.

Counterpart of ``repro.kernels.count_sketch``:

  ``scatter_add``  out[rows[e], cols[e]] += vals[e] on a fresh (m, d) f32
                   panel; duplicate coordinates sum, and a coordinate
                   outside the panel is dropped

``rows`` / ``cols`` are (E,) int32 and ``vals`` (E,) f32, bf16 or f64, all
contiguous.  On the card it is a stable binned fold, stages on the current
stream, with no sort of the stream and no host sync (:func:`bin_plan`
sizes them, :func:`fold` runs them):

  1. :func:`count_bins`   the flattened panel is cut into tiles of
     ``2**TILE_BITS`` cells (16,384: 64 KB of f32, one block's shared
     memory) and into at most ``BATCH_BINS`` bins of 2**k tiles, and the
     stream into slices, one per warp; each warp counts its slice's
     entries per bin (integer atomics);
  2. :func:`scan_counts`  the inclusive scan of the bin-major count matrix
     (``torch.cumsum``, index preparation as ``sparse_matvec.ell_pack``'s
     torch ops are);
  3. :func:`scatter_bins` every entry's (cell inside its bin, f32 value)
     goes to its bin, each bin in entry order: a block sorts each batch of
     4,096 entries by bin in shared memory and writes it bin by bin;
  4. :func:`count_parts`, :func:`scan_counts`, :func:`scatter_parts`
     where bins hold more than ``2**DIRECT_SUB_BITS`` tiles: steps 1–3
     again inside each bin, keyed by its parts (one tile each up to
     ``BATCH_BINS**2`` tiles), so a tile's block reads only its own
     entries;
  5. :func:`sum_tiles`    one block per tile routes the entries of its
     tile to the warp that owns their cell and adds them onto the tile in
     shared memory in bin order, then writes the tile once.

So each cell is summed one entry after another in entry order, starting
from 0: the order of ``index_add_`` on the CPU and of ``np.add.at``, and
the panel is the plain version's bit for bit on any values.  The bound
is bytes (12 an entry and the panel); the stages move about three times
that, and each of a bin's tiles reads the whole bin unless step 4 split
it.  Skew: a tile's entries are summed by one block and a cell's by one
warp, so a stream into one tile, or one cell, is as slow as that block,
or that warp, walking it alone.  Streams of 2**31 entries or more are
refused (positions are int32).

The contract is that of ``kernels.gk_step``: the wrapper checks its
inputs, allocates with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES["scatter_add"]`` per call, whatever the number of
stages; for CPU tensors, and only for them, it returns the plain version
from ``kernels.ref``.  An empty stream returns zeros without a launch, as
the reference's wrapper does.  :func:`bin_entries` returns the bins that
step 5 reads (it syncs with the host to cut them to length: tests and
checks only); ``ref.bin_entries`` is their plain model.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor
F32, I32 = torch.float32, torch.int32

# dtype of vals -> the kernel's kind
KINDS = {F32: 0, torch.bfloat16: 1, torch.float64: 2}

TILE_BITS = 14               # 16,384 f32 cells: 64 KB of shared memory
MAX_TILE_BITS = 15           # 128 KB, within a block's 227 KB
BATCH_BINS = 512             # most bins (or parts a bin) a batch sorts by
DIRECT_SUB_BITS = 2          # step 5 reads bins of up to 2**this tiles
WARPS = 8                    # slices (warps) a block in steps 1, 3 and 4
MAX_SLICES = 4096
MIN_SLICE = 4096             # entries a slice at least, for short streams
PART_SLICES = 32             # slices a bin in step 4
MAX_COUNTERS = 2 ** 21       # a count matrix's int32 counters, 8 MB
CHUNK = 256                  # entries a warp loads at once (32 lanes x 8)
MAX_ENTRIES = 2 ** 31 - 1    # stream positions are int32

LAUNCHES = {"scatter_add": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "count_sketch_bin_count": [_P, _P, _L, _L, _L, _I, _I, _I, _L, _P, _P],
    "count_sketch_bin_scatter": [_P, _P, _P, _I, _L, _L, _L, _I, _I, _I, _L,
                                 _P, _P, _P, _P],
    "count_sketch_part_count": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "count_sketch_part_scatter": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                                  _P],
    "count_sketch_tile_sum": [_P, _P, _I, _I, _I, _I, _L, _P, _P],
    "count_sketch_error_string": [_I],
}


class BinPlan(NamedTuple):
    """How a stream of ``entries`` is binned into an (m, d) panel."""
    m: int
    d: int
    entries: int
    tile_bits: int     # a tile_sum block's 2**tile_bits cells
    bin_bits: int      # a bin's 2**bin_bits cells: 2**k tiles
    bins: int          # at most BATCH_BINS; the last may be ragged
    slices: int        # one warp each, a multiple of WARPS
    slice_len: int     # entries a slice, a multiple of CHUNK
    part_bits: int     # step 5 reads bins of 2**part_bits cells
    part_slices: int   # step 4's slices a bin; 0 where step 4 does not run

    @property
    def parts(self) -> int:
        """Step 4's parts a bin (1 where it does not run)."""
        return 1 << (self.bin_bits - self.part_bits)


def reset_launches() -> None:
    LAUNCHES["scatter_add"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("count_sketch", _SIGNATURES)
    lib.count_sketch_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int) -> None:
    if rc != 0:
        msg = _lib().count_sketch_error_string(rc).decode()
        raise RuntimeError(f"scatter_add: CUDA error {rc} ({msg})")


def _panel(shape) -> tuple[int, int]:
    m, d = (int(s) for s in shape)
    if m < 0 or d < 0:
        raise ValueError(f"panel shape must be non-negative, got {shape}")
    return m, d


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def bin_plan(entries: int, shape, tile_bits: int = TILE_BITS) -> BinPlan:
    """Bins, parts and slices for ``entries`` entries into a non-empty
    (m, d) panel (``tile_bits`` other than ``TILE_BITS`` is for tests of
    bins of many tiles on small panels).  Bins are the fewest tiles, a
    power of two, that leave the panel at most ``BATCH_BINS`` bins.
    Slices: one per ``MIN_SLICE`` entries, at most ``MAX_SLICES``,
    rounded up to a multiple of ``WARPS``.  Where a bin holds more than
    ``2**DIRECT_SUB_BITS`` tiles, step 4 cuts it into parts of one tile
    (of 2**k tiles past ``BATCH_BINS`` parts), in ``PART_SLICES`` slices a
    bin.  No count matrix holds more than ``MAX_COUNTERS``."""
    m, d = _panel(shape)
    if not 5 <= tile_bits <= MAX_TILE_BITS:
        raise ValueError(f"tile_bits must be in [5, {MAX_TILE_BITS}], got "
                         f"{tile_bits}")
    if m * d == 0:
        raise ValueError("bin_plan needs a non-empty panel")
    if entries > MAX_ENTRIES:
        raise ValueError(f"{entries} entries: scatter_add takes fewer than "
                         f"2**31 (stream positions are int32)")
    bin_bits = max(tile_bits, (_cdiv(m * d, BATCH_BINS) - 1).bit_length())
    bins = _cdiv(m * d, 1 << bin_bits)
    slices = min(MAX_SLICES, _cdiv(max(entries, 1), MIN_SLICE))
    slices = _cdiv(slices, WARPS) * WARPS
    slice_len = _cdiv(_cdiv(max(entries, 1), slices), CHUNK) * CHUNK
    part_bits, part_slices = bin_bits, 0
    if bin_bits - tile_bits > DIRECT_SUB_BITS:
        part_bits = max(tile_bits,
                        bin_bits - (BATCH_BINS - 1).bit_length())
        cap = MAX_COUNTERS // (bins << (bin_bits - part_bits))
        part_slices = max(WARPS, min(PART_SLICES, cap // WARPS * WARPS))
    return BinPlan(m, d, entries, tile_bits, bin_bits, bins, slices,
                   slice_len, part_bits, part_slices)


def count_bins(rows: Tensor, cols: Tensor, plan: BinPlan) -> Tensor:
    """Step 1: the (bins * slices,) int32 bin-major count matrix."""
    p = plan
    counts = torch.empty(p.bins * p.slices, dtype=I32, device=rows.device)
    _check(_lib().count_sketch_bin_count(
        rows.data_ptr(), cols.data_ptr(), p.entries, p.m, p.d, p.bin_bits,
        p.bins, p.slices, p.slice_len, counts.data_ptr(), gs._stream()))
    return counts


def scan_counts(counts: Tensor) -> Tensor:
    """Steps 2 and 4: the inclusive scan (int32) of a count matrix."""
    return torch.cumsum(counts, 0, dtype=I32)


def scatter_bins(rows: Tensor, cols: Tensor, vals: Tensor, plan: BinPlan,
                 counts: Tensor, incl: Tensor) -> Tensor:
    """Step 3: (entries, 2) int32 pairs (cell inside the bin, the f32
    value's bits), bin after bin, each bin in entry order; the first
    ``incl[-1]`` pairs are written (entries outside the panel have
    none)."""
    p = plan
    binned = torch.empty((p.entries, 2), dtype=I32, device=rows.device)
    _check(_lib().count_sketch_bin_scatter(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), KINDS[vals.dtype],
        p.entries, p.m, p.d, p.bin_bits, p.bins, p.slices, p.slice_len,
        counts.data_ptr(), incl.data_ptr(), binned.data_ptr(),
        gs._stream()))
    return binned


def count_parts(binned: Tensor, incl: Tensor, plan: BinPlan) -> Tensor:
    """Step 4's count: step 3's pairs counted by part inside each bin,
    the (bins * parts * part_slices,) int32 count matrix (bin, part,
    slice)."""
    p = plan
    counts = torch.empty(p.bins * p.parts * p.part_slices, dtype=I32,
                         device=binned.device)
    _check(_lib().count_sketch_part_count(
        binned.data_ptr(), incl.data_ptr(), p.slices, p.bins, p.part_bits,
        p.parts, p.part_slices, counts.data_ptr(), gs._stream()))
    return counts


def scatter_parts(binned: Tensor, incl: Tensor, plan: BinPlan,
                  counts: Tensor, part_incl: Tensor) -> Tensor:
    """Step 4's scatter: step 3's pairs, each bin's cut into its parts in
    entry order (cell inside the part); the first ``incl[-1]`` pairs are
    written."""
    p = plan
    parted = torch.empty_like(binned)
    _check(_lib().count_sketch_part_scatter(
        binned.data_ptr(), incl.data_ptr(), p.slices, p.bins, p.part_bits,
        p.parts, p.part_slices, counts.data_ptr(), part_incl.data_ptr(),
        parted.data_ptr(), gs._stream()))
    return parted


def _binned(rows: Tensor, cols: Tensor, vals: Tensor,
            plan: BinPlan) -> tuple[Tensor, Tensor]:
    """Steps 1–4: the pairs step 5 reads and their scan."""
    counts = count_bins(rows, cols, plan)
    incl = scan_counts(counts)
    binned = scatter_bins(rows, cols, vals, plan, counts, incl)
    if not plan.part_slices:
        return binned, incl
    counts = count_parts(binned, incl, plan)
    part_incl = scan_counts(counts)
    return scatter_parts(binned, incl, plan, counts, part_incl), part_incl


def sum_tiles(binned: Tensor, incl: Tensor, plan: BinPlan) -> Tensor:
    """Step 5: the (m, d) f32 panel, one block per tile, from the pairs
    and scan of step 4 where the plan runs it, else of step 3."""
    p = plan
    S, bins = p.slices, p.bins
    if p.part_slices:
        S, bins = p.part_slices, p.bins * p.parts
    out = torch.empty(p.m * p.d, dtype=F32, device=binned.device)
    _check(_lib().count_sketch_tile_sum(
        binned.data_ptr(), incl.data_ptr(), S, p.tile_bits,
        p.part_bits - p.tile_bits, bins, p.m * p.d, out.data_ptr(),
        gs._stream()))
    return out.view(p.m, p.d)


def fold(rows: Tensor, cols: Tensor, vals: Tensor, plan: BinPlan) -> Tensor:
    """The stages on CUDA tensors of a non-empty stream: the (m, d) f32
    panel.  :func:`scatter_add` checks, plans and counts around it."""
    binned, incl = _binned(rows, cols, vals, plan)
    return sum_tiles(binned, incl, plan)


def bin_entries(rows: Tensor, cols: Tensor, vals: Tensor,
                plan: BinPlan) -> tuple[Tensor, Tensor, Tensor]:
    """Steps 1–4 alone: the bins of ``2**plan.part_bits`` cells that step
    5 reads, as (offsets (bins + 1,) int64, cells (N,) int32 inside the
    bin, values (N,) f32), bin b's pairs at ``offsets[b]:offsets[b + 1]``
    in entry order, N the entries inside the panel.  Cutting the pairs to
    N syncs with the host: this is for tests and checks, not the fold."""
    E = _stream_inputs(rows, cols, vals)
    if E != plan.entries:
        raise ValueError(f"a plan for {plan.entries} entries, given {E}")
    shape = (plan.m, plan.d)
    if not gs._on_cuda(rows, cols, vals) or E == 0:
        return ref.bin_entries(rows, cols, vals, shape, plan.part_bits)
    binned, incl = _binned(rows, cols, vals, plan)
    S = plan.part_slices or plan.slices
    bins = _cdiv(plan.m * plan.d, 1 << plan.part_bits)  # no ragged parts
    ends = incl.view(-1, S)[:bins, -1].long()
    offsets = torch.cat([ends.new_zeros(1), ends])
    n = int(offsets[-1])
    return offsets, binned[:n, 0].contiguous(), \
        binned[:n, 1].contiguous().view(F32)


def scatter_add(rows: Tensor, cols: Tensor, vals: Tensor, shape) -> Tensor:
    """Dense (m, d) f32 accumulation of a COO stream.  rows / cols (E,)
    int32; vals (E,) f32/bf16/f64 → (m, d) f32.  Duplicate coordinates sum
    in entry order; a coordinate outside the panel is dropped."""
    E = _stream_inputs(rows, cols, vals)
    m, d = _panel(shape)
    if not gs._on_cuda(rows, cols, vals):
        return ref.scatter_add(rows, cols, vals, (m, d))
    if E == 0 or m * d == 0:
        return torch.zeros((m, d), dtype=F32, device=vals.device)
    out = fold(rows, cols, vals, bin_plan(E, (m, d)))
    LAUNCHES["scatter_add"] += 1
    return out
