"""Wrappers around the reorthogonalization kernels of ``csrc/reorth.cu``.

Counterpart of ``repro.kernels.reorth`` (two Pallas kernels):

  ``qtv``          c = Qᵀ v           one pass over Q
  ``subtract_qc``  w = v − Q c        one pass over Q

One classical Gram-Schmidt pass is the pair (``ops.reorth`` repeats it).
Q (m, k) is f32 or bf16 and contiguous, read in place (the reference pads
its rows to a block multiple; the kernels mask the ragged edge); v, c and
w are 1-D f32.  Both kernels are epilogues of the projection pair's flat
staged tiles, cut by ``gk_step.proj_plan``: ``qtv`` is ``proj_qtv``'s
c' = Qᵀw fold with w = v, ``subtract_qc`` its w = v − Q c half alone, so
``subtract_qc(v, Q, c)`` has the bits of ``proj_norm(v, Q, c)``'s w.  The
contract is that of ``kernels.gk_step``: each wrapper checks its inputs,
allocates outputs and scratch with ``torch.empty``, launches on the
current stream and adds one to ``LAUNCHES[name]``; for CPU tensors, and
only for them, it returns the plain version from ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor
F32, BF16 = torch.float32, torch.bfloat16

LAUNCHES = {"qtv": 0, "subtract_qc": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "reorth_qtv": [_P, _I, _P, _L, _I, _I, _I, _I, _I, _P, _P, _P],
    "reorth_subtract_qc": [_P, _P, _I, _P, _L, _I, _I, _I, _I, _I, _P, _P],
    "reorth_error_string": [_I],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("reorth", _SIGNATURES)
    lib.reorth_error_string.restype = ctypes.c_char_p
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().reorth_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def _basis(Q: Tensor, v: Tensor) -> tuple[int, int]:
    gs._matrix("Q", Q)
    m, k = Q.shape
    gs._vector("v", v, m)
    return m, k


def _plan(Q: Tensor) -> gs.ProjPlan:
    """The staged-tile plan of a non-empty basis the kernels take."""
    m, k = Q.shape
    if m == 0 or k == 0:
        raise ValueError(f"empty basis ({m} x {k})")
    gs._basis_width(Q)
    return gs.proj_plan(m, k, Q.dtype)


def qtv(Q: Tensor, v: Tensor) -> Tensor:
    """c = Qᵀ v.  Q (m, k) f32/bf16; v (m,) f32 → c (k,) f32."""
    m, k = _basis(Q, v)
    if not gs._on_cuda(Q, v):
        return ref.qtv(Q, v)
    plan = _plan(Q)
    part = torch.empty(k * plan.grid, dtype=F32, device=Q.device)
    c = torch.empty(k, dtype=F32, device=Q.device)
    rc = _lib().reorth_qtv(Q.data_ptr(), int(Q.dtype == BF16), v.data_ptr(),
                           m, k, plan.tile_rows, plan.grid, plan.stages,
                           plan.flags, part.data_ptr(), c.data_ptr(),
                           gs._stream())
    _check(rc, "qtv")
    LAUNCHES["qtv"] += 1
    return c


def subtract_qc(v: Tensor, Q: Tensor, c: Tensor) -> Tensor:
    """w = v − Q c.  v (m,) f32; Q (m, k) f32/bf16; c (k,) f32 → w (m,)
    f32."""
    m, k = _basis(Q, v)
    gs._vector("c", c, k)
    if not gs._on_cuda(v, Q, c):
        return ref.subtract_qc(v, Q, c)
    plan = _plan(Q)
    w = torch.empty(m, dtype=F32, device=v.device)
    rc = _lib().reorth_subtract_qc(v.data_ptr(), Q.data_ptr(),
                                   int(Q.dtype == BF16), c.data_ptr(), m, k,
                                   plan.tile_rows, plan.grid, plan.stages,
                                   plan.flags, w.data_ptr(), gs._stream())
    _check(rc, "subtract_qc")
    LAUNCHES["subtract_qc"] += 1
    return w
