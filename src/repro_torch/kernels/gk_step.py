"""Wrappers around the fused GK kernels of ``csrc/gk_step.cu``.

Counterpart of ``repro.kernels.gk_step`` (four Pallas kernels) and of
``repro.kernels.gk_matvec`` (two):

  ``mv_qtv``     (u, c)  = (A p − α y, Qᵀ u)      stage 1, left half-step
  ``rmv_qtv``    (v, c)  = (Aᵀ q − β y, Pᵀ v)     stage 1, right half-step
  ``proj_qtv``   (w, c') = (u − Q c, Qᵀ w)        one pass over Q
  ``proj_norm``  (v, ‖v‖²) = (u − Q c, Σ v²)      one pass over Q
  ``matvec_fused``   u = A p − α y                stage 1 with no basis
  ``rmatvec_fused``  v = Aᵀ q − β y

Vectors are 1-D f32 tensors; A and the basis are 2-D, contiguous, f32 or
bf16 each.  The fused matvecs also take an f64 A: every element is
converted to f32 before it is multiplied and the sums accumulate in f32,
as in the reference kernel (so an f64 operand is multiplied in f32).
``alpha`` / ``beta`` are a Python number or a one-element f32 tensor on
the device (a device scalar never forces a host sync).

``matvec_fused`` has a row kernel of its own: a persistent grid sized to
the card (``matvec_plan``), each warp on its own rows with stage 1's row
loop, and no barrier, so u has the bits of ``mv_qtv``'s u.

``rmatvec_fused`` and ``rmv_qtv``'s v come from one Aᵀq pass: threads own
columns of A (16-byte loads where A allows; row groups where A is
narrow), one block per (column tile, row chunk) in a grid of one wave
(``rmv_plan``), whose partial column sums a finishing pass adds in a
fixed order, lanes on adjacent columns whatever the chunk count.
``rmv_qtv`` then forms c = Pᵀv as ``reorth.qtv`` does, so its v has
``rmatvec_fused``'s bits and its c ``reorth.qtv(P, v)``'s.

The projection pair is bound by the bytes of the basis, which it reads
from device memory once a call: each block copies tiles of whole rows,
one contiguous run of the array whatever k's parity, into shared memory
in 16-byte chunks, two stages deep, and takes both products from there
(``proj_plan`` cuts the basis; ``csrc/proj_tiles.cuh`` says more).

The four GK-step kernels also take stacked inputs of one shape, the
half-steps of a batched solve: A (B, m, n), vectors (B, len), α / β a
(B,) tensor or a Python number, bases (B, L, k).  One call covers the
batch: each launch has a grid dimension over the examples, and each
example's blocks run the plan of its own shape (``rows_plan``,
``rmv_plan``, ``proj_plan``), so its outputs are bit for bit those of a
single launch on it; B = 1 is that single launch.

Each wrapper checks its inputs and raises on what the kernel does not
take, allocates outputs and scratch with ``torch.empty``, launches on the
current stream and adds one to ``LAUNCHES[name]``.  For CPU tensors, and
only for them, it returns the plain version from ``kernels.ref`` instead
(and counts nothing).  There is no fallback: a CUDA tensor either runs
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

Tensor = torch.Tensor
F32, BF16 = torch.float32, torch.bfloat16

STORAGE_DTYPES = (F32, BF16)
# storage dtype of A -> a_kind of the fused matvecs
A_KINDS = {torch.float64: 2, F32: 0, BF16: 1}
THREADS = 256          # threads per block, as in the CUDA source
GROUP = THREADS // 32  # rows a block of the row kernel handles at once
MAX_BLOCKS = 2048      # grid cap of the row kernel
SMS = 132              # streaming multiprocessors of an H100 SXM
MV_BLOCKS_PER_SM = 4   # resident blocks of matvec_fused's kernel on an SM
RMV_BLOCKS_PER_SM = 4  # resident blocks of the Aᵀq partial kernel on an SM
MAX_K = 49152          # basis columns: k f32 of shared memory per block
MAX_BATCH = 65535      # stacked examples: the grid's y limit
# the projection pair's plan, as in the CUDA source (kProjBlocks, ...)
PROJ_BLOCKS = 264      # grid cap: two blocks on each of 132 SMs
STAGE_BYTES = {F32: 24576, BF16: 32768}   # basis bytes a tile aims at
MAX_TILE_ROWS = 512
SMEM_LIMIT = 232448 - 256  # 227 KB a block can have, less its static part
STAGES = 2             # copy buffers a block cycles through
REG_K = 256            # up to this width c and c' sit in registers
C_SHARED = 1           # ProjPlan.flags: c in shared memory (k > REG_K)

# Calls of each TPU-kernel-level function that launched on the card (a
# call may be more than one launch: its finishing pass is part of it, and
# a stacked call covers its whole batch).  Added to under a lock: plans
# solve on the card from several threads at once.
LAUNCHES = {"mv_qtv": 0, "rmv_qtv": 0, "proj_qtv": 0, "proj_norm": 0,
            "matvec_fused": 0, "rmatvec_fused": 0}
_COUNT_LOCK = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "gk_mv_qtv": [_P, _I, _P, _P, _P, _P, _I, _L, _L, _I, _L, _I,
                  _I, _P, _P, _P, _P],
    "gk_rmv_qtv": [_P, _I, _P, _P, _P, _P, _I, _L, _L, _I, _I, _L, _L,
                   _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "gk_proj_qtv": [_P, _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P],
    "gk_proj_norm": [_P, _P, _I, _P, _L, _I, _I, _I, _I, _I, _I, _P, _P,
                     _P, _P],
    "gk_matvec_fused": [_P, _I, _P, _P, _P, _L, _L, _I, _P, _P],
    "gk_rmatvec_fused": [_P, _I, _P, _P, _P, _L, _L, _I, _L, _L, _P, _P,
                         _P],
    "gk_error_string": [_I],
}


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("gk_step", _SIGNATURES)
    lib.gk_error_string.restype = ctypes.c_char_p
    return lib


def rows_plan(L: int) -> tuple[int, int]:
    """(rows per block, blocks) of the row kernel for a length-L vector.

    A function of L alone, so the blocking, and with it the order of every
    cross-block sum, is the same on every run and every card."""
    per = -(-L // MAX_BLOCKS)
    per = max(GROUP, -(-per // GROUP) * GROUP)
    return per, -(-L // per)


def matvec_plan(m: int) -> int:
    """Blocks of ``matvec_fused``'s persistent kernel for m rows: as many as
    the card holds at once (``SMS`` × ``MV_BLOCKS_PER_SM``), fewer where
    that would leave a block without a row.  Warp w of the grid's
    ``GROUP`` × blocks warps takes rows w, w + warps, ...  The grid does
    not change a bit of u: each row is one warp's dot product."""
    return max(1, min(SMS * MV_BLOCKS_PER_SM, -(-m // GROUP)))


class RmvPlan(NamedTuple):
    """How the Aᵀq partial kernel cuts an (m, n) A: a block's ``THREADS``
    threads form ``THREADS // cols`` row groups of ``cols`` threads, and
    a column tile is ``tile_cols`` = ``cols`` × the elements of A in 16
    bytes; every tile is cut into ``chunks`` chunks of ``rows`` rows (the
    last may be shorter).  Block b takes tile b % ``tiles`` over chunk
    b // ``tiles`` and writes its partial column sums to slot b; the
    finishing pass adds a column's chunks in a fixed order."""
    cols: int
    tile_cols: int
    tiles: int
    rows: int
    chunks: int


def rmv_plan(m: int, n: int, dtype: torch.dtype) -> RmvPlan:
    """The Aᵀq plan for an (m, n) A of ``dtype``: one group of ``THREADS``
    threads a block wherever n fills it, else groups as narrow as n
    allows (a power of two); as many row chunks as fit beside the tiles
    in the blocks the card holds at once (``SMS`` × ``RMV_BLOCKS_PER_SM``),
    each chunk with a row (one chunk, and a block per tile, where the
    tiles alone pass that).

    A function of (m, n, dtype) alone, so the order of every cross-block
    sum, and with it σ's bits, is the same on every run and every card.
    ``gk_step.cu`` refuses a plan past its own limits."""
    V = 16 // dtype.itemsize
    cols = 1
    while cols < THREADS and cols * V < n:
        cols *= 2
    tiles = -(-n // (cols * V))
    chunks = max(1, min(m, SMS * RMV_BLOCKS_PER_SM // tiles))
    rows = -(-m // chunks)
    return RmvPlan(cols, cols * V, tiles, rows, -(-m // rows))


class ProjPlan(NamedTuple):
    """How ``proj_qtv`` / ``proj_norm`` cut a basis: tiles of ``tile_rows``
    rows, walked by ``grid`` blocks (block b takes tiles b, b + grid, ...)
    through a ring of ``stages`` shared-memory buffers; ``flags`` say
    whether c sits in shared memory too, ``smem`` is its bytes."""
    tile_rows: int
    tiles: int
    grid: int
    stages: int
    flags: int
    smem: int


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def proj_plan(L: int, k: int, dtype: torch.dtype) -> ProjPlan:
    """The projection pair's plan for an (L, k) basis of ``dtype``.

    A function of (L, k, dtype) alone, so the order of every cross-block
    sum, and with it σ's bits, is the same on every run and every card.
    A tile aims at ``STAGE_BYTES[dtype]`` bytes of basis, in a multiple of
    8 rows (one per warp) where it holds 8 or more, so that with an
    aligned base every tile starts on a 16-byte boundary.  Up to
    ``STAGES`` buffers come first.  Up to ``REG_K`` columns c and the sums
    of c' = Qᵀw sit in registers; past it c takes shared memory where it
    fits beside the buffers (else it is read from device memory), and the
    sums of c' accumulate in place in the partials in device memory.
    ``gk_step.cu`` refuses a plan past its own limits."""
    row = k * dtype.itemsize
    rows = MAX_TILE_ROWS if row == 0 else min(
        MAX_TILE_ROWS, max(1, STAGE_BYTES[dtype] // row))
    if rows >= GROUP:
        rows -= rows % GROUP
    stage = _round16(4 * rows) + _round16(rows * row) + 32
    stages = max(1, min(STAGES, SMEM_LIMIT // stage))
    vec = _round16(4 * k)
    flags, smem = 0, stages * stage
    if k > REG_K and smem + vec <= SMEM_LIMIT:
        flags, smem = C_SHARED, smem + vec
    tiles = -(-L // rows)
    return ProjPlan(rows, tiles, min(tiles, PROJ_BLOCKS), stages, flags,
                    smem)


# --- input checks ---------------------------------------------------------

def _matrix(name: str, X: Tensor, rows: Optional[int] = None,
            dtypes=STORAGE_DTYPES, lead: tuple = ()) -> None:
    """X is a 2-D tensor of ``dtypes`` with ``rows`` rows, or a stack of
    them with leading dimensions ``lead``."""
    if not isinstance(X, Tensor) or X.dim() != 2 + len(lead) \
            or tuple(X.shape[:len(lead)]) != lead:
        raise ValueError(f"{name} must be a 2-D tensor" if not lead else
                         f"{name} must be a stack of {lead[0]} 2-D tensors")
    if X.dtype not in dtypes:
        names = [str(d).removeprefix("torch.") for d in dtypes]
        raise TypeError(f"{name} must be {', '.join(names[:-1])} or "
                        f"{names[-1]}, got {X.dtype}")
    if rows is not None and X.shape[-2] != rows:
        raise ValueError(f"{name} has {X.shape[-2]} rows, expected {rows}")


def _vector(name: str, x: Tensor, length: int, lead: tuple = ()) -> None:
    if not isinstance(x, Tensor) or tuple(x.shape) != lead + (length,):
        raise ValueError(f"{name} must be a 1-D tensor of length {length}"
                         if not lead else f"{name} must be a stack of "
                         f"{lead[0]} vectors of length {length}")
    if x.dtype != F32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")


def _lead(A: Tensor) -> tuple:
    """() for a 2-D operand, (B,) for a stack of B (B ≤ ``MAX_BATCH``)."""
    if isinstance(A, Tensor) and A.dim() == 3:
        if not 1 <= A.shape[0] <= MAX_BATCH:
            raise ValueError(f"a stack of {A.shape[0]} examples; the "
                             f"kernels take 1 to {MAX_BATCH}")
        return (A.shape[0],)
    return ()


def _on_cuda(*tensors: Tensor) -> bool:
    """True if all tensors are on one CUDA device, False if all are on the
    CPU; raises otherwise, or on a non-contiguous CUDA tensor."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs are on different devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")
    return True


def _scalar(x, device: torch.device, count: int = 1) -> Tensor:
    """``count`` f32 scalars on the device, one per stacked example: a
    view of an f32 device tensor of ``count`` elements, or a Python
    number repeated."""
    if isinstance(x, Tensor):
        if x.numel() != count or x.dtype != F32 or x.device != device:
            what = "a one-element" if count == 1 else f"a {count}-element"
            raise ValueError(f"the scalar must be {what} float32 tensor on "
                             f"{device}")
        return x.reshape(count).contiguous()
    return torch.full((count,), float(x), dtype=F32, device=device)


def _basis_width(Q: Tensor) -> int:
    k = Q.shape[-1]
    if k > MAX_K:
        raise ValueError(f"basis has {k} columns; the kernel takes at most "
                         f"{MAX_K}")
    return k


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().gk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# --- the four kernels -----------------------------------------------------

def mv_qtv(A: Tensor, p: Tensor, y: Tensor, alpha,
           Q: Tensor) -> tuple[Tensor, Tensor]:
    """(u, c) = (A p − α y, Qᵀ u) in one pass over A and Q.
    A (m, n); p (n,); y (m,); Q (m, k) → u (m,), c (k,) f32.  Stacked:
    A (B, m, n), p (B, n), y (B, m), α (B,), Q (B, m, k) → u (B, m),
    c (B, k), one call for the batch."""
    lead = _lead(A)
    _matrix("A", A, lead=lead)
    m, n = A.shape[-2:]
    _vector("p", p, n, lead)
    _vector("y", y, m, lead)
    _matrix("Q", Q, rows=m, lead=lead)
    if not _on_cuda(A, p, y, Q):
        return ref.mv_qtv(A, p, y, alpha, Q)
    if m == 0 or n == 0:
        raise ValueError(f"empty operand {tuple(A.shape)}")
    k = _basis_width(Q)
    B = lead[0] if lead else 1
    per, grid = rows_plan(m)
    a = _scalar(alpha, A.device, B)
    u = torch.empty(lead + (m,), dtype=F32, device=A.device)
    c = torch.empty(lead + (k,), dtype=F32, device=A.device)
    part = torch.empty(B * k * grid, dtype=F32, device=A.device)
    rc = _lib().gk_mv_qtv(
        A.data_ptr(), int(A.dtype == BF16), p.data_ptr(), y.data_ptr(),
        a.data_ptr(), Q.data_ptr(), int(Q.dtype == BF16), m, n, k, per, grid,
        B, u.data_ptr(), part.data_ptr(), c.data_ptr(), _stream())
    _check(rc, "mv_qtv")
    _count("mv_qtv")
    return u, c


def rmv_qtv(A: Tensor, q: Tensor, y: Tensor, beta,
            P: Tensor) -> tuple[Tensor, Tensor]:
    """(v, c) = (Aᵀ q − β y, Pᵀ v) from row-major A, no stored transpose.
    A (m, n); q (m,); y (n,); P (n, k) → v (n,), c (k,) f32.  Stacked as
    ``mv_qtv``: A (B, m, n), q (B, m), y (B, n), β (B,), P (B, n, k)."""
    lead = _lead(A)
    _matrix("A", A, lead=lead)
    m, n = A.shape[-2:]
    _vector("q", q, m, lead)
    _vector("y", y, n, lead)
    _matrix("P", P, rows=n, lead=lead)
    if not _on_cuda(A, q, y, P):
        return ref.rmv_qtv(A, q, y, beta, P)
    if m == 0 or n == 0:
        raise ValueError(f"empty operand {tuple(A.shape)}")
    k = _basis_width(P)
    B = lead[0] if lead else 1
    plan, pp = rmv_plan(m, n, A.dtype), proj_plan(n, k, P.dtype)
    b = _scalar(beta, A.device, B)
    vpart = torch.empty(B * plan.tiles * plan.chunks * plan.tile_cols,
                        dtype=F32, device=A.device)
    v = torch.empty(lead + (n,), dtype=F32, device=A.device)
    c = torch.empty(lead + (k,), dtype=F32, device=A.device)
    part = torch.empty(B * k * pp.grid, dtype=F32, device=A.device)
    rc = _lib().gk_rmv_qtv(
        A.data_ptr(), int(A.dtype == BF16), q.data_ptr(), y.data_ptr(),
        b.data_ptr(), P.data_ptr(), int(P.dtype == BF16), m, n, k,
        plan.cols, plan.rows, plan.chunks, vpart.data_ptr(), pp.tile_rows,
        pp.grid, pp.stages, pp.flags, B, v.data_ptr(), part.data_ptr(),
        c.data_ptr(), _stream())
    _check(rc, "rmv_qtv")
    _count("rmv_qtv")
    return v, c


def _proj(name: str, plain, u: Tensor, Q: Tensor, c: Tensor):
    lead = _lead(Q)
    _matrix("Q", Q, lead=lead)
    L, k = Q.shape[-2:]
    _vector("u", u, L, lead)
    _vector("c", c, k, lead)
    if not _on_cuda(u, Q, c):
        return plain(u, Q, c)
    if L == 0:
        raise ValueError("empty basis")
    _basis_width(Q)
    B = lead[0] if lead else 1
    plan = proj_plan(L, k, Q.dtype)
    w = torch.empty(lead + (L,), dtype=F32, device=u.device)
    nout = 1 if name == "proj_norm" else k
    out = torch.empty(lead + (nout,), dtype=F32, device=u.device)
    part = torch.empty(B * nout * plan.grid, dtype=F32, device=u.device)
    fn = getattr(_lib(), f"gk_{name}")
    rc = fn(u.data_ptr(), Q.data_ptr(), int(Q.dtype == BF16), c.data_ptr(),
            L, k, plan.tile_rows, plan.grid, plan.stages, plan.flags, B,
            w.data_ptr(), part.data_ptr(), out.data_ptr(), _stream())
    _check(rc, name)
    _count(name)
    return w, out


def proj_qtv(u: Tensor, Q: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """(w, c') = (u − Q c, Qᵀ w) in one pass over Q.
    u (L,); Q (L, k); c (k,) → w (L,), c' (k,) f32.  Stacked: u (B, L),
    Q (B, L, k), c (B, k) → w (B, L), c' (B, k)."""
    return _proj("proj_qtv", ref.proj_qtv, u, Q, c)


def proj_norm(u: Tensor, Q: Tensor, c: Tensor) -> tuple[Tensor, Tensor]:
    """(v, ‖v‖²) = (u − Q c, Σ v²) in one pass over Q.
    u (L,); Q (L, k); c (k,) → v (L,), ‖v‖² () f32.  Stacked: u (B, L),
    Q (B, L, k), c (B, k) → v (B, L), ‖v‖² (B,)."""
    v, nrm2 = _proj("proj_norm", ref.proj_norm, u, Q, c)
    return v, nrm2.reshape(v.shape[:-1])


# --- the fused matvecs: stage 1 with an empty basis ------------------------

def matvec_fused(A: Tensor, p: Tensor, y: Tensor, alpha) -> Tensor:
    """u = A p − α y in one pass over A.  A (m, n) f64/f32/bf16; p (n,);
    y (m,) → (m,) f32."""
    _matrix("A", A, dtypes=A_KINDS)
    m, n = A.shape
    _vector("p", p, n)
    _vector("y", y, m)
    if not _on_cuda(A, p, y):
        return ref.matvec_fused(A, p, y, alpha)
    if m == 0 or n == 0:
        raise ValueError(f"empty operand {tuple(A.shape)}")
    a = _scalar(alpha, A.device)
    u = torch.empty(m, dtype=F32, device=A.device)
    rc = _lib().gk_matvec_fused(
        A.data_ptr(), A_KINDS[A.dtype], p.data_ptr(), y.data_ptr(),
        a.data_ptr(), m, n, matvec_plan(m), u.data_ptr(), _stream())
    _check(rc, "matvec_fused")
    _count("matvec_fused")
    return u


def rmatvec_fused(A: Tensor, q: Tensor, y: Tensor, beta) -> Tensor:
    """v = Aᵀ q − β y in one pass over row-major A.  A (m, n) f64/f32/bf16;
    q (m,); y (n,) → (n,) f32."""
    _matrix("A", A, dtypes=A_KINDS)
    m, n = A.shape
    _vector("q", q, m)
    _vector("y", y, n)
    if not _on_cuda(A, q, y):
        return ref.rmatvec_fused(A, q, y, beta)
    if m == 0 or n == 0:
        raise ValueError(f"empty operand {tuple(A.shape)}")
    plan = rmv_plan(m, n, A.dtype)
    b = _scalar(beta, A.device)
    vpart = torch.empty(plan.tiles * plan.chunks * plan.tile_cols,
                        dtype=F32, device=A.device)
    v = torch.empty(n, dtype=F32, device=A.device)
    rc = _lib().gk_rmatvec_fused(
        A.data_ptr(), A_KINDS[A.dtype], q.data_ptr(), y.data_ptr(),
        b.data_ptr(), m, n, plan.cols, plan.rows, plan.chunks,
        vpart.data_ptr(), v.data_ptr(), _stream())
    _check(rc, "rmatvec_fused")
    _count("rmatvec_fused")
    return v
