"""Serving metrics: counters, latency percentiles, QPS, batch occupancy.

Pure-host instrumentation for the always-on service (DESIGN.md §7).  All
observation methods are thread-safe (client threads observe rejections,
the dispatcher thread observes dispatches/completions) and cheap: counters
and fixed-size reservoirs, no allocation proportional to traffic.

:meth:`ServiceMetrics.snapshot` is the one read surface — a flat dict the
service CLI prints, ``bench_serving.py`` gates on, and tests assert
against.  Latency percentiles are nearest-rank over a sliding window of
the most recent observations; QPS is completions over the window's time
span, so an idle server decays toward 0 instead of averaging over its
whole uptime.

The port's copy of ``repro``'s module.  The port's sessions compile
nothing: their one-off cost is an adjacency upload per index version and
layout, so where ``repro`` reports compiles this reports uploads
(``warmup_uploads``, ``cache_uploads``, and a hit rate of hits over
uploads plus hits).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Optional


class LatencyWindow:
    """Sliding window of the most recent ``cap`` latency observations with
    nearest-rank percentiles.  Not thread-safe on its own — callers hold
    the :class:`ServiceMetrics` lock."""

    def __init__(self, cap: int = 4096):
        self._buf: collections.deque = collections.deque(maxlen=cap)

    def record(self, value_s: float) -> None:
        self._buf.append(float(value_s))

    def __len__(self) -> int:
        return len(self._buf)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile ``p`` ∈ [0, 100] (0.0 when empty)."""
        if not self._buf:
            return 0.0
        ordered = sorted(self._buf)
        rank = max(0, min(len(ordered) - 1, int(round(p / 100.0 * len(ordered))) - 1))
        return ordered[rank]

    def mean(self) -> float:
        return sum(self._buf) / len(self._buf) if self._buf else 0.0

    def max(self) -> float:
        return max(self._buf) if self._buf else 0.0


# Counter names the service increments; snapshot() emits every one (zeros
# included) so downstream dashboards see a stable schema.
COUNTERS = (
    "submitted",            # admitted + rejected + unsat short-circuits
    "admitted",             # entered the admission queue
    "completed",            # terminal ok results delivered
    "failed",               # terminal error results delivered
    "rejected_quota",       # per-tenant outstanding cap hit (immediate)
    "rejected_backpressure",  # global queue full past the submit timeout
    "unsat",                # unsatisfiable queries answered without the engine
    "retries",              # overflow retries spent across completed queries
    "index_updates",        # update_index() calls (no-op edits included)
    "cache_invalidated",    # adjacency uploads dropped on index swap
    "dispatches",           # engine pack invocations
    "chunks",               # ResultChunks streamed
    "warmup_uploads",       # adjacency uploads spent by start()'s warmup_profile
)


class ServiceMetrics:
    """Thread-safe counters + windows for one :class:`EnumerationService`."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 window: int = 4096):
        self._clock = clock
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {name: 0 for name in COUNTERS}
        self._latency = LatencyWindow(window)       # submit -> terminal
        self._queue_wait = LatencyWindow(window)    # submit -> dispatch
        self._completion_times: collections.deque = collections.deque(maxlen=window)
        self._lanes_occupied = 0
        self._lanes_total = 0
        self._started_at = clock()

    # -- observation (any thread) -----------------------------------------

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def observe_dispatch(self, occupied: int, lanes: int) -> None:
        """One engine pack went out with ``occupied`` of ``lanes`` lanes
        carrying real queries (the rest are inert shape padding)."""
        with self._lock:
            self._counters["dispatches"] += 1
            self._lanes_occupied += occupied
            self._lanes_total += lanes

    def observe_queue_wait(self, wait_s: float) -> None:
        with self._lock:
            self._queue_wait.record(wait_s)

    def observe_completion(self, latency_s: float, retries: int = 0,
                           ok: bool = True) -> None:
        with self._lock:
            self._counters["completed" if ok else "failed"] += 1
            self._counters["retries"] += retries
            self._latency.record(latency_s)
            self._completion_times.append(self._clock())

    # -- read surface ------------------------------------------------------

    def qps(self) -> float:
        """Completions per second over the sliding completion window."""
        with self._lock:
            times = self._completion_times
            if len(times) < 2:
                return 0.0
            span = times[-1] - times[0]
            return (len(times) - 1) / span if span > 0 else 0.0

    def snapshot(self, cache: Optional[Dict[str, int]] = None,
                 queue_depth: int = 0, coalescing: int = 0,
                 in_flight: int = 0) -> Dict[str, float]:
        """Flat stats dict.  ``cache`` is ``Enumerator.cache_stats()``;
        ``queue_depth`` / ``coalescing`` / ``in_flight`` are sampled by the
        service at call time (they are gauges, not counters)."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            out["uptime_s"] = self._clock() - self._started_at
            out["queue_depth"] = queue_depth
            out["coalescing"] = coalescing
            out["in_flight"] = in_flight
            out["latency_p50_s"] = self._latency.percentile(50)
            out["latency_p99_s"] = self._latency.percentile(99)
            out["latency_mean_s"] = self._latency.mean()
            out["latency_max_s"] = self._latency.max()
            out["queue_wait_p50_s"] = self._queue_wait.percentile(50)
            out["queue_wait_p99_s"] = self._queue_wait.percentile(99)
            out["batch_occupancy"] = (
                self._lanes_occupied / self._lanes_total if self._lanes_total else 0.0
            )
        out["qps"] = self.qps()
        if cache is not None:
            out["cache_uploads"] = cache["uploads"]
            out["cache_hits"] = cache["cache_hits"]
            out["cache_evictions"] = cache["evictions"]
            out["cache_entries"] = cache["entries"]
            lookups = cache["uploads"] + cache["cache_hits"]
            out["cache_hit_rate"] = cache["cache_hits"] / lookups if lookups else 0.0
        return out


def format_snapshot(stats: Dict[str, float]) -> str:
    """Human-readable multi-line rendering of :meth:`ServiceMetrics.snapshot`
    (the ``repro_torch.launch.serve`` stats lines)."""
    lines = [
        "queries   submitted={submitted:.0f} completed={completed:.0f} "
        "failed={failed:.0f} unsat={unsat:.0f} retries={retries:.0f}",
        "admission rejected_quota={rejected_quota:.0f} "
        "rejected_backpressure={rejected_backpressure:.0f} "
        "queue_depth={queue_depth:.0f} coalescing={coalescing:.0f} "
        "in_flight={in_flight:.0f}",
        "batches   dispatches={dispatches:.0f} occupancy={batch_occupancy:.2f} "
        "chunks={chunks:.0f}",
        "latency   p50={latency_p50_s:.4f}s p99={latency_p99_s:.4f}s "
        "max={latency_max_s:.4f}s qps={qps:.1f}",
    ]
    if "cache_uploads" in stats:
        lines.append(
            "cache     uploads={cache_uploads:.0f} hits={cache_hits:.0f} "
            "evictions={cache_evictions:.0f} hit_rate={cache_hit_rate:.2f}"
        )
    return "\n".join(line.format(**stats) for line in lines)
