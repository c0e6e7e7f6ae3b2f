"""Admission control for the always-on service: a bounded global queue
with per-tenant quotas (DESIGN.md §7).  A copy of ``repro``'s module:
it is plain Python, and importing ``repro``'s would load JAX.

Quota semantics:

* **Per-tenant outstanding cap** (``max_outstanding_per_tenant``): the
  number of a tenant's queries that are queued, coalescing, or in flight.
  Exceeding it rejects **immediately** with :class:`QuotaExceeded` —
  blocking a over-quota tenant would let one client's burst occupy the
  submission path and starve the others, inverting the isolation the
  quota exists to provide.  The slot is released when the query's
  terminal status is delivered (not when it is popped for execution).
* **Global queue depth** (``max_depth``) is the backpressure bound: a
  full queue blocks :meth:`AdmissionQueue.admit` until the dispatcher
  drains space or the submit timeout elapses, then rejects with
  :class:`Backpressure`.  This is load shedding for *everyone* — it says
  the service as a whole is saturated, not that one tenant misbehaves.

The queue itself is FIFO; fairness across tenants comes from the quota
(no tenant can hold more than its cap of the queue), not from reordering.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class QuotaExceeded(RuntimeError):
    """A tenant's outstanding-query quota is exhausted (immediate reject)."""


class Backpressure(RuntimeError):
    """The global admission queue stayed full past the submit timeout."""


@dataclasses.dataclass
class Request:
    """One admitted query riding through the service."""

    query: Any                    # repro_torch.core.session.Query
    tenant: str
    stream: Any                   # repro_torch.serve.stream.ResultStream
    collect: int                  # per-worker match-materialization budget
    submitted_at: float
    seq: int = 0                  # admission order (diagnostics)


class AdmissionQueue:
    """Thread-safe bounded FIFO with per-tenant outstanding quotas."""

    def __init__(
        self,
        max_depth: int = 256,
        max_outstanding_per_tenant: int = 64,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if max_outstanding_per_tenant < 1:
            raise ValueError(
                "max_outstanding_per_tenant must be >= 1, got "
                f"{max_outstanding_per_tenant}"
            )
        self.max_depth = max_depth
        self.max_outstanding_per_tenant = max_outstanding_per_tenant
        self._clock = clock
        self._cond = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._outstanding: Dict[str, int] = collections.defaultdict(int)
        self._seq = 0

    # -- producer side (client threads) ------------------------------------

    def admit(self, req: Request, timeout: Optional[float] = None) -> None:
        """Admit ``req`` or raise.  Quota violations reject immediately;
        a full queue blocks up to ``timeout`` seconds (``None`` = do not
        block) waiting for the dispatcher to drain space."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while True:
                if self._outstanding[req.tenant] >= self.max_outstanding_per_tenant:
                    raise QuotaExceeded(
                        f"tenant {req.tenant!r} has "
                        f"{self._outstanding[req.tenant]} outstanding queries "
                        f"(cap {self.max_outstanding_per_tenant})"
                    )
                if len(self._q) < self.max_depth:
                    break
                remaining = None if deadline is None else deadline - self._clock()
                if remaining is None or remaining <= 0:
                    raise Backpressure(
                        f"admission queue full ({self.max_depth} deep) past "
                        f"submit timeout ({timeout})"
                    )
                self._cond.wait(remaining)
            req.seq = self._seq
            self._seq += 1
            self._outstanding[req.tenant] += 1
            self._q.append(req)
            self._cond.notify_all()

    # -- consumer side (the dispatcher thread) -----------------------------

    def pop(self, timeout: Optional[float] = None) -> List[Request]:
        """Drain every queued request, waiting up to ``timeout`` seconds
        for the first one.  Returns ``[]`` on timeout."""
        with self._cond:
            if not self._q and timeout:
                self._cond.wait(timeout)
            out = list(self._q)
            self._q.clear()
            if out:
                self._cond.notify_all()  # wake blocked submitters
            return out

    def release(self, tenant: str) -> None:
        """A query of ``tenant`` reached its terminal status: free its
        quota slot."""
        with self._cond:
            self._outstanding[tenant] -= 1
            if self._outstanding[tenant] <= 0:
                del self._outstanding[tenant]

    def kick(self) -> None:
        """Wake a blocked :meth:`pop` (shutdown path)."""
        with self._cond:
            self._cond.notify_all()

    # -- gauges ------------------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def outstanding(self, tenant: Optional[str] = None) -> int:
        with self._cond:
            if tenant is not None:
                return self._outstanding.get(tenant, 0)
            return sum(self._outstanding.values())
