"""The distribution layer of the port (counterpart of
``repro.distributed``): the logical-axis rules of the model parameters
and the operator placement (``partition``), sharded
GK products on a ``torch.distributed`` mesh (``ShardedOp``, with the one
collective helper ``psum``), distributed F-SVD through the
``repro_torch.api`` facade (``gk_dist``: the ``fsvd_sharded`` method) and
Krylov low-rank gradient compression (``compression``)."""
from repro_torch.distributed.matvec import (ShardedOp, place_operator, psum,
                                            sharded_operator)

__all__ = ["ShardedOp", "place_operator", "sharded_operator", "psum"]
