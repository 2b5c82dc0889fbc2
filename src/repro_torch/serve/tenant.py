"""Per-tenant Session state: repeat clients get *tracked* solves.

Counterpart of ``repro.serve.tenant``.  A tenant's first request pays the
cold Krylov budget; every later request against its drifted operand
warm-starts from the previous Ritz basis and runs the Session's learned
refine budget — strictly fewer GK iterations end-to-end.

The registry is a bounded LRU: past ``max_tenants`` live sessions the
coldest is evicted — checkpointed first (``repro_torch.checkpoint``,
atomic) when a ``checkpoint_dir`` is configured, so an evicted tenant that
returns restores its factorization and keeps refining instead of
re-paying the cold solve.

Where the reference folds ``crc32(tenant_id)`` into a PRNG key, a tenant
here gets its own generator, ``fold_in(seed, crc32(tenant_id))`` on the
registry's device, with the seed taken from the ``generator=`` argument.
"""
from __future__ import annotations

import collections
import os
import threading
import zlib
from typing import Any, Dict, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.api.session import Session
from repro_torch.api.spec import SVDSpec
from repro_torch.core._keys import fold_in


def _tenant_generator(seed: int, tenant_id: str, device) -> torch.Generator:
    """Deterministic per-tenant generator (stable across restarts, unlike
    ``hash``)."""
    return fold_in(seed, zlib.crc32(str(tenant_id).encode()), device=device)


class TenantRegistry:
    """LRU map tenant-id -> :class:`~repro_torch.api.session.Session`.

    Thread-safe for lookups/insertions; the sessions themselves are NOT —
    the server funnels all tenant solves through its single dispatch
    worker, which is the supported usage.  Sessions live on ``device``
    (default: the card).
    """

    def __init__(self, spec: Optional[SVDSpec] = None, *,
                 max_tenants: int = 32,
                 checkpoint_dir: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None,
                 refine_iters: Optional[int] = None,
                 restart_angle: float = 0.5,
                 update_tol: Optional[float] = None):
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
        self.spec = spec or SVDSpec()
        self.max_tenants = int(max_tenants)
        self.checkpoint_dir = checkpoint_dir
        self.device = resolve_device(device)
        self.refine_iters = refine_iters
        self.restart_angle = float(restart_angle)
        # parity gate for the zero-iteration structured-drift path; None
        # lets each session learn it from its own stream (see Session).
        self.update_tol = update_tol
        self._seed = 0 if generator is None else generator.initial_seed()
        self._sessions: "collections.OrderedDict[str, Session]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self._counters = {"creates": 0, "restores": 0, "evictions": 0,
                          "reuses": 0, "restore_failures": 0}

    def _tenant_dir(self, tenant_id: str) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, str(tenant_id))

    # --- lookup ---------------------------------------------------------
    def get(self, tenant_id: str, A: Any) -> Session:
        """The tenant's session (most-recently-used), created — or
        restored from its eviction checkpoint — around operand ``A``."""
        with self._lock:
            sess = self._sessions.get(tenant_id)
            if sess is not None:
                self._sessions.move_to_end(tenant_id)
                self._counters["reuses"] += 1
                return sess
            sess = self._make(tenant_id, A)
            self._sessions[tenant_id] = sess
            while len(self._sessions) > self.max_tenants:
                old_id, old = self._sessions.popitem(last=False)
                self._counters["evictions"] += 1
                self._checkpoint(old_id, old)
            return sess

    def _make(self, tenant_id: str, A: Any) -> Session:
        gen = _tenant_generator(self._seed, tenant_id, self.device)
        directory = self._tenant_dir(tenant_id)
        if directory is not None:
            try:
                sess = Session.restore(directory, A, generator=gen,
                                       device=self.device)
                self._counters["restores"] += 1
                return sess
            except FileNotFoundError:
                pass
            except Exception:    # noqa: BLE001 — a tenant must never be
                # unservable because its checkpoint rotted or the restore
                # failpoint fired: fall back to a fresh (cold) session.
                # Session.restore already skipped to the newest VERIFIED
                # step, so landing here means none survived.
                self._counters["restore_failures"] += 1
        self._counters["creates"] += 1
        # track_residuals costs r extra matvecs + a host sync per solve —
        # a latency-critical serving session skips it.  Structured-drift
        # (delta) requests still hit the gated update path: the session
        # measures its gate reference lazily, when the first delta comes.
        return Session(A, self.spec, generator=gen,
                       refine_iters=self.refine_iters,
                       restart_angle=self.restart_angle,
                       track_residuals=False,
                       update_tol=self.update_tol, device=self.device)

    def _checkpoint(self, tenant_id: str, sess: Session) -> None:
        directory = self._tenant_dir(tenant_id)
        if directory is not None and sess.fact is not None:
            sess.save(directory, keep=1)

    def touch(self, tenant_id: str) -> Optional[Session]:
        """The tenant's live session, bumped to most-recently-used; None
        when not resident.  Delta and entries requests route here: unlike
        :meth:`get` they carry no full operand to create a session
        around, so a missing tenant is the caller's error to surface."""
        with self._lock:
            sess = self._sessions.get(tenant_id)
            if sess is not None:
                self._sessions.move_to_end(tenant_id)
                self._counters["reuses"] += 1
            return sess

    # --- maintenance ----------------------------------------------------
    def peek(self, tenant_id: str) -> Optional[Session]:
        """The tenant's live session without touching LRU order (stats /
        tests); None when not resident."""
        with self._lock:
            return self._sessions.get(tenant_id)

    def save_all(self) -> int:
        """Checkpoint every resident session (graceful shutdown)."""
        with self._lock:
            items = list(self._sessions.items())
        n = 0
        for tenant_id, sess in items:
            if self.checkpoint_dir is not None and sess.fact is not None:
                self._checkpoint(tenant_id, sess)
                n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {**self._counters, "resident": len(self._sessions)}


__all__ = ["TenantRegistry"]
