"""Built-in solver registrations: ``fsvd`` only, in this slice.

The reference's other methods are not ported yet; :func:`not_ported`
names the ``ROADMAP.md`` row that will bring each one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.registry import register_solver
from repro_torch.api.results import Factorization
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import resolve_generator
from repro_torch.core.fsvd import fsvd as _fsvd

NOT_PORTED = {
    "rsvd": "ROADMAP.md Queue 1 item 4 (core/rsvd.py)",
    "fsvd_blocked": "ROADMAP.md Queue 1 item 4 (core/gk_block.py)",
    "rbk": "ROADMAP.md Queue 1 item 4 (core/sketch.py)",
    "gnystrom": "ROADMAP.md Queue 1 item 4 (core/sketch.py)",
    "fsvd_sharded": "ROADMAP.md Queue 1 item 12 (distributed/gk_dist.py)",
}


def not_ported(method: str) -> NotImplementedError:
    return NotImplementedError(
        f"method={method!r} is not ported to repro_torch yet: "
        f"{NOT_PORTED[method]}")


@register_solver("fsvd")
def solve_fsvd(A, spec: SVDSpec, *,
               generator: Optional[torch.Generator] = None, q1=None,
               callback=None) -> Factorization:
    """Paper Alg 2: k-step GK bidiagonalization + Ritz extraction."""
    if q1 is None:
        generator = resolve_generator(
            generator, caller="factorize(method='fsvd')", device=A.device)
    res = _fsvd(A, spec.rank, spec.max_iters, generator=generator, q1=q1,
                eps=spec.tol, relative_eps=spec.relative_tol,
                reorth_passes=spec.reorth_passes,
                host_loop=bool(spec.host_loop), dtype=spec.dtype,
                precision=spec.precision, callback=callback)
    return Factorization(res.U, res.s, res.V, res.kprime, res.breakdown,
                         method="fsvd")
