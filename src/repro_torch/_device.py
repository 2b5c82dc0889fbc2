"""Device placement shared by the entry points.

The port runs on the CUDA card unless the caller asks for the CPU, either
with ``device="cpu"`` or by passing CPU tensors.  A numpy operand with no
``device`` goes to ``cuda``; without a card that raises instead of
quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NP_TO_TORCH = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and
    raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (or CPU tensors) "
            "to run the plain-torch path on the CPU")
    return torch.device("cuda")


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """Map a torch dtype, or a numpy float dtype or its name, to a torch
    dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _NP_TO_TORCH[name]
    except KeyError:
        raise TypeError(f"no torch dtype for {dtype!r}") from None


def to_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor on ``device``: tensors keep their device unless one is
    given; anything else (numpy arrays, lists, scalars) goes to
    :func:`resolve_device`.  bfloat16 numpy arrays (``ml_dtypes``) are
    carried over bit for bit."""
    dtype = torch_dtype(dtype)
    if isinstance(x, torch.Tensor):
        if device is not None or dtype is not None:
            x = x.to(device=device, dtype=dtype)
        return x
    dev = resolve_device(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr, copy=True).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=dev, dtype=dtype)
