"""Randomized SVD baseline (Halko, Martinsson & Tropp 2011): the paper's
comparison algorithm ("R-SVD"), with the default (p = 10) and oversampled
variants of Tables 1b/2 and Figure 1.

Counterpart of ``repro.core.rsvd``.  The Gaussian test matrix Ω is drawn
from an explicit ``torch.Generator``, or passed in as ``omega`` (the
reference's own draw in a parity test).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._device import to_tensor
from repro_torch.core._keys import normal, resolve_generator
from repro_torch.core.gk import _store_dtype
from repro_torch.core.operators import as_operator

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RSVDResult:
    U: Tensor
    s: Tensor
    V: Tensor


def rsvd(A, k: int, *, p: int = 10, power_iters: int = 0,
         generator: Optional[torch.Generator] = None, omega=None,
         dtype: Optional[torch.dtype] = None, precision=None,
         callback=None, device=None) -> RSVDResult:
    """Top-k triplets via Gaussian range sketching (HMT Algorithms 4.3/5.1).

    ``p`` is the oversampling; ``power_iters`` the q subspace iterations
    with QR re-orthonormalization; ``omega`` an (n, min(k + p, m, n))
    test matrix to use instead of a fresh draw from ``generator``.
    ``precision="bf16"`` stores the sketch/range bases half-width between
    passes over A (the QRs and the small SVD stay in the compute dtype).
    ``callback`` gets one ``on_info`` with an empty residual trace.
    """
    A = as_operator(A, device=device)
    m, n = A.shape
    if dtype is None:
        dtype = torch.promote_types(A.dtype, torch.float32)
    store = _store_dtype(precision, dtype)
    l = min(k + p, min(m, n))
    if omega is None:
        generator = resolve_generator(generator, caller="rsvd",
                                      device=A.device)
        omega = normal(generator, (n, l), device=A.device, dtype=dtype)
    omega = to_tensor(omega, device=A.device, dtype=dtype)
    if tuple(omega.shape) != (n, l):
        raise ValueError(f"omega must be ({n}, {l}), got "
                         f"{tuple(omega.shape)}")

    Y = A.matmat(omega.to(store)).to(dtype)              # (m, l)
    Q = torch.linalg.qr(Y)[0]
    for _ in range(power_iters):
        Z = A.rmatmat(Q.to(store)).to(dtype)              # (n, l)
        Z = torch.linalg.qr(Z)[0]
        Y = A.matmat(Z.to(store)).to(dtype)
        Q = torch.linalg.qr(Y)[0]
    B = A.rmatmat(Q.to(store)).T.to(dtype)                # (l, n) = Qᵀ A
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    if callback is not None:
        from repro_torch.api.callbacks import ConvergenceInfo
        dev = U.device
        callback.on_info(ConvergenceInfo(
            torch.zeros(0, device=dev),
            torch.tensor(power_iters, dtype=torch.int32, device=dev),
            torch.tensor(False, device=dev), method="rsvd"))
    return RSVDResult(U[:, :k], s[:k], Vt[:k, :].T)
