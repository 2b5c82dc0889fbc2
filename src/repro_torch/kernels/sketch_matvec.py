"""Wrapper around the sparse-sign sketch kernel of ``csrc/sketch_matvec.cu``.

Counterpart of ``repro.kernels.sketch_matvec``:

  ``sketch_matmat``  Y = Tᵀ X,  Y[i, :] = Σ_s signs[i, s] · X[idx[i, s], :]

with the test matrix T (N, d) in its (d, ζ) ELL pack (``core.sketch``).
``signs`` (d, ζ) is f32, bf16 or f64 and ``idx`` (d, ζ) int32, both
contiguous; X (N, b) is f32, bf16 or f64 with ANY strides — the range
sketch passes a transposed view of the operand, which is read in place
and never copied.  The output is (d, b) f32.

The contract is that of ``kernels.gk_step``: the wrapper checks its
inputs, allocates with ``torch.empty``, launches on the current stream and
adds one to ``LAUNCHES["sketch_matmat"]``; for CPU tensors, and only for
them, it returns the plain version from ``kernels.ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import gk_step as gs
from repro_torch.kernels import ref

Tensor = torch.Tensor

# nonzeros per column of the sparse-sign ensemble (the reference's ZETA)
ZETA = 8

# dtype of signs / X -> the kernel's kind
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}

LAUNCHES = {"sketch_matmat": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "sketch_matmat": [_P, _I, _P, _I, _L, _P, _I, _L, _L, _L, _L, _P, _P],
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


def sketch_matmat(signs: Tensor, idx: Tensor, X: Tensor) -> Tensor:
    """Y = Tᵀ X for T in the sparse-sign ELL pack.  signs / idx (d, ζ);
    X (N, b), any strides → (d, b) f32.  Every index must lie in [0, N),
    as ``core.sketch.make_sketch`` and ``bridge.sketch`` ensure; the
    kernel does not check."""
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
    if dev.type == "cpu":
        return ref.sketch_matmat(signs, idx, X)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not (signs.is_contiguous() and idx.is_contiguous()):
        raise ValueError("signs and idx must be contiguous")
    d, zeta = signs.shape
    N, b = X.shape
    if d == 0 or b == 0:
        raise ValueError(f"empty sketch ({d} rows) or block ({b} columns)")
    Y = torch.empty(d, b, dtype=torch.float32, device=dev)
    rc = _lib().sketch_matmat(
        signs.data_ptr(), KINDS[signs.dtype], idx.data_ptr(), zeta, d,
        X.data_ptr(), KINDS[X.dtype], N, b, X.stride(0), X.stride(1),
        Y.data_ptr(), gs._stream())
    if rc != 0:
        msg = _lib().sketch_error_string(rc).decode()
        raise RuntimeError(f"sketch_matmat: CUDA error {rc} ({msg})")
    LAUNCHES["sketch_matmat"] += 1
    return Y
