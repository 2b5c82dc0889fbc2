"""Wrapper around the low-rank materialization kernel of
``csrc/lowrank_update.cu``.

Counterpart of ``repro.kernels.lowrank_update``:

  ``lowrank_matmul``  W = U diag(s) Vᵀ → (m, n) f32, W written once

U (m, r) and Vt (r, n) are f32, bf16 or f64 with any strides (read in
place: a transposed view is not copied); s (r,) of any float dtype is
cast to f32, as the reference wrapper does.  The reference's
``materialize`` picks tiles that divide the shape and falls back to a jnp
product when none does; this kernel masks its ragged edges, so
``lowrank_matmul`` itself serves every shape and no ``materialize`` is
needed.

The contract is that of ``kernels.gk_step``: the wrapper checks its
inputs, allocates with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES["lowrank_matmul"]``; for CPU tensors, and only for
them, it returns the plain version from ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor

# dtype of U / Vt -> the kernel's kind
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

LAUNCHES = {"lowrank_matmul": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "lowrank_matmul": [_P, _I, _L, _L, _P, _P, _I, _L, _L, _I, _L, _L, _P,
                       _P],
    "lowrank_error_string": [_I],
}


def reset_launches() -> None:
    LAUNCHES["lowrank_matmul"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("lowrank_update", _SIGNATURES)
    lib.lowrank_error_string.restype = ctypes.c_char_p
    return lib


def _factor(name: str, x: Tensor) -> None:
    if not isinstance(x, Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a 2-D tensor")
    if x.dtype not in KINDS:
        raise TypeError(f"{name} must be float64, float32 or bfloat16, got "
                        f"{x.dtype}")


def lowrank_matmul(U: Tensor, s: Tensor, Vt: Tensor) -> Tensor:
    """W = U diag(s) Vᵀ.  U (m, r); s (r,); Vt (r, n) → (m, n) f32."""
    _factor("U", U)
    _factor("Vt", Vt)
    r = U.shape[1]
    if not isinstance(s, Tensor) or s.shape != (r,):
        raise ValueError(f"s must be a 1-D tensor of length {r}")
    if not s.is_floating_point():
        raise TypeError(f"s must be a float tensor, got {s.dtype}")
    if Vt.shape[0] != r:
        raise ValueError(f"Vt has {Vt.shape[0]} rows, expected {r}")
    devices = {U.device, s.device, Vt.device}
    if len(devices) != 1:
        raise ValueError(f"inputs are on different devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return ref.lowrank_matmul(U, s, Vt)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    m, n = U.shape[0], Vt.shape[1]
    if m == 0 or n == 0:
        raise ValueError(f"empty output ({m} x {n})")
    s32 = s.to(torch.float32).contiguous()
    W = torch.empty(m, n, dtype=torch.float32, device=dev)
    rc = _lib().lowrank_matmul(
        U.data_ptr(), KINDS[U.dtype], U.stride(0), U.stride(1),
        s32.data_ptr(), Vt.data_ptr(), KINDS[Vt.dtype], Vt.stride(0),
        Vt.stride(1), r, m, n, W.data_ptr(), gs._stream())
    if rc != 0:
        msg = _lib().lowrank_error_string(rc).decode()
        raise RuntimeError(f"lowrank_matmul: CUDA error {rc} ({msg})")
    LAUNCHES["lowrank_matmul"] += 1
    return W
