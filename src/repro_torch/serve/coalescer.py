"""Continuous same-bucket coalescing: the admission → execution scheduler
(DESIGN.md §7).  A copy of ``repro``'s module: it is plain Python, and
importing ``repro``'s would load JAX.

Pending queries accumulate in buckets keyed by
``Enumerator.coalesce_key`` — the ``(p_pad, max_parents, n_t, w, n_elab,
fingerprint[, CSR or partition shape])`` pack-compatibility key, extended
by the request's ``collect_matches`` budget (a different budget means a
different engine cfg, so a different match ring).  A bucket **dispatches** as a
packed lane group the moment either condition holds:

* **lane budget fills**: the bucket reaches ``max_lanes`` entries — a
  full pack, go now; waiting longer only adds latency;
* **batch window closes**: the bucket's *oldest* entry has waited
  ``window_s`` — dispatch partial, padding the missing lanes with inert
  state (shape stability is free; idle lanes freeze immediately).

This is deliberately a plain data structure with an injectable clock and
no thread of its own: the service's single dispatcher thread drives it,
which keeps dispatch order deterministic (FIFO within a bucket, buckets
by fill/ripeness order) and keeps every engine launch on one thread.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

Batch = Tuple[Any, List[Any]]  # (key, items)


class Coalescer:
    """Same-key batch accumulator with a lane budget and a time window."""

    def __init__(
        self,
        max_lanes: int = 8,
        window_s: float = 0.002,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        self.max_lanes = max_lanes
        self.window_s = window_s
        self._clock = clock
        # insertion-ordered: the first bucket to receive an entry is the
        # first to ripen, so iteration order == dispatch order
        self._buckets: "collections.OrderedDict[Any, List[Any]]" = collections.OrderedDict()
        self._oldest: Dict[Any, float] = {}

    def add(self, key: Any, item: Any) -> Optional[Batch]:
        """Add ``item`` under ``key``; if that fills the lane budget, the
        full batch is popped and returned for immediate dispatch."""
        bucket = self._buckets.get(key)
        if bucket is None:
            self._buckets[key] = bucket = []
            self._oldest[key] = self._clock()
        bucket.append(item)
        if len(bucket) >= self.max_lanes:
            return self._pop(key)
        return None

    def ripe(self) -> List[Batch]:
        """Pop every bucket whose oldest entry has waited ``window_s``."""
        now = self._clock()
        due = [k for k, t in self._oldest.items() if now - t >= self.window_s]
        return [self._pop(k) for k in due]

    def flush(self) -> List[Batch]:
        """Pop everything (shutdown drain / forced dispatch)."""
        return [self._pop(k) for k in list(self._buckets)]

    def next_deadline(self) -> Optional[float]:
        """Clock time when the earliest bucket ripens (None when empty) —
        the dispatcher sleeps at most until then."""
        if not self._oldest:
            return None
        return min(self._oldest.values()) + self.window_s

    def pending(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def _pop(self, key: Any) -> Batch:
        items = self._buckets.pop(key)
        del self._oldest[key]
        return (key, items)
