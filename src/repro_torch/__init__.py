"""repro_torch — the PyTorch/CUDA port of :mod:`repro`.

It mirrors the reference package module for module (``core``,
``kernels``, ``api``) and imports ``torch`` and numpy only.  Dense
operands live on the CUDA device by default; the entry points raise when
no card is visible unless the caller passes ``device="cpu"`` or CPU
tensors, in which case every kernel wrapper takes its plain-torch
version.  See ``README.md`` ("PyTorch/CUDA port") for what is ported.

    from repro_torch.api import SVDSpec, factorize, estimate_rank
    fact = factorize(A, SVDSpec(method="fsvd", rank=20, backend="pallas"),
                     generator=torch.Generator("cuda").manual_seed(0))
"""
