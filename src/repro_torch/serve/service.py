"""The always-on enumeration service (DESIGN.md §7), over the port's session.

:class:`EnumerationService` turns the session API into a long-lived
server with the admission / coalescing / execution split of ``repro``'s
service, the continuous-batching shape production inference stacks use:

* **Admission** (`repro_torch.serve.admission`): many client threads call
  :meth:`submit`; each query passes per-tenant quota + global
  backpressure checks and lands in a bounded FIFO.  Unsatisfiable
  queries short-circuit to an empty terminal result without queueing.
* **Coalescing** (`repro_torch.serve.coalescer`): the single dispatcher
  thread drains admissions into buckets keyed by
  ``Enumerator.coalesce_key(query) + (collect,)`` and dispatches a bucket
  the moment its lane budget fills or its batch window closes, so
  heterogeneous concurrent load runs as packs: one step kernel launch per
  step for every lane of a bucket.
* **Execution**: each dispatch is one ``Enumerator.run_pack`` call,
  padded with inert lanes to a fixed ``max_lanes``; overflowed lanes ride
  the doubled-``stack_cap`` retry and report ``retries`` in their
  terminal status.  Results stream back per client as chunked
  match-mapping slices (`repro_torch.serve.stream`), and
  `repro_torch.serve.metrics` records QPS, queue depth, batch occupancy,
  latency percentiles, and the upload cache's hit rate.

Every pack runs on the dispatcher thread, on the session's device (the
CUDA card unless the service was built with ``device="cpu"``).  Client
threads prepare queries: numpy for a dense index, the CSR-native domain
fixpoint on the device for a sparse one (K8 and K3 with ``use_pallas``).
All threads launch on their current stream, which is the default stream.
One dispatcher is the right shape for one device: packs, not threads,
are the parallelism axis (DESIGN.md §7).  A pack that raises fails its
batch's streams with the error; it is never re-run elsewhere.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Union

from repro_torch.core.engine import EngineConfig
from repro_torch.core.graph import Graph, PackedGraph
from repro_torch.core.session import Enumerator, Query, SubgraphIndex
from repro_torch.serve.admission import AdmissionQueue, Backpressure, QuotaExceeded, Request
from repro_torch.serve.coalescer import Coalescer
from repro_torch.serve.metrics import ServiceMetrics
from repro_torch.serve.stream import ResultChunk, ResultStatus, ResultStream

__all__ = [
    "EnumerationService", "ServiceConfig",
    "Backpressure", "QuotaExceeded",
]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the serving layer (the engine's own knobs live in
    :class:`~repro_torch.core.engine.EngineConfig`).

    Attributes:
      max_lanes: pack width of every dispatch; buckets dispatch early when
        this many queries coalesce.
      batch_window_s: longest a pending query waits for lane-mates before
        its bucket dispatches partially filled.
      max_queue_depth: global admission bound (backpressure past it).
      max_outstanding_per_tenant: per-tenant quota on queued + in-flight
        queries (immediate reject past it).
      chunk_size: match mappings per streamed :class:`ResultChunk`.
      max_cache_entries: the adjacency uploads per layout the service's
        own :class:`Enumerator` keeps (its ``max_cache_entries``).  Each
        entry is a whole target version on the device (39.5 MB of bitmaps
        for PPIS32's largest target), so the default, 0, keeps the
        session's two: the live index version and the one it replaced.
      default_collect: match-materialization budget (per worker) applied
        when ``submit(collect=None)``; 0 = counting mode, no chunks.
      memory_budget_bytes: device-memory budget for resident target planes
        (DESIGN.md §9).  When set (and the service builds its own session)
        the enumerator runs the out-of-core partitioned backend, and its
        packs run their queries one by one.  ``None`` keeps the whole
        target resident.
      warmup_profile: patterns (or prepared queries) that
        ``Enumerator.warm`` warms during :meth:`start`, before the
        dispatcher accepts work: their adjacency uploads, kernel library
        loads and first engine use move from the first dispatch to start.
    """

    max_lanes: int = 8
    batch_window_s: float = 0.002
    max_queue_depth: int = 256
    max_outstanding_per_tenant: int = 64
    chunk_size: int = 256
    max_cache_entries: int = 0
    default_collect: int = 0
    memory_budget_bytes: Optional[int] = None
    warmup_profile: tuple = ()


class EnumerationService:
    """A long-lived enumeration server over one :class:`Enumerator` session.

    Typical use::

        svc = EnumerationService(index, n_workers=8, service=ServiceConfig())
        with svc:                                    # start()/stop(drain=True)
            handles = [svc.submit(p, tenant="t0") for p in patterns]
            for h in handles:
                ms = h.result(timeout=60.0)          # terminal MatchSet
        print(svc.stats())                           # metrics snapshot

    ``**config_kwargs`` go to the :class:`Enumerator` (``device="cpu"``,
    ``variant=``, engine keywords).
    """

    def __init__(
        self,
        index: Union[SubgraphIndex, Graph, PackedGraph, None] = None,
        config: Optional[EngineConfig] = None,
        service: Optional[ServiceConfig] = None,
        enumerator: Optional[Enumerator] = None,
        clock=time.monotonic,
        **config_kwargs,
    ):
        self.service_config = service or ServiceConfig()
        sc = self.service_config
        if enumerator is not None:
            if index is not None or config is not None or config_kwargs:
                raise ValueError(
                    "pass either enumerator= or (index/config/**kwargs), not both"
                )
            self.enumerator = enumerator
        else:
            self.enumerator = Enumerator(
                index, config=config,
                max_cache_entries=sc.max_cache_entries,
                memory_budget_bytes=sc.memory_budget_bytes,
                **config_kwargs,
            )
        self._clock = clock
        self.metrics = ServiceMetrics(clock=clock)
        self.admission = AdmissionQueue(
            max_depth=sc.max_queue_depth,
            max_outstanding_per_tenant=sc.max_outstanding_per_tenant,
            clock=clock,
        )
        self.coalescer = Coalescer(
            max_lanes=sc.max_lanes, window_s=sc.batch_window_s, clock=clock,
        )
        # collect -> EngineConfig with that collect_matches budget
        self._cfgs: Dict[int, EngineConfig] = {}
        self._in_flight = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._drain_on_stop = True
        self._warmed = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EnumerationService":
        """Start the dispatcher thread (idempotent).

        If ``ServiceConfig.warmup_profile`` names patterns, they are warmed
        synchronously first (``Enumerator.warm`` with the service's
        ``default_collect`` budget and ``max_lanes``, the shape of its
        dispatches), so the dispatcher opens with their adjacency uploaded
        and their kernels loaded."""
        if self.service_config.warmup_profile and not self._warmed:
            self._warmed = True
            n = self.enumerator.warm(
                self.service_config.warmup_profile,
                collect_matches=self.service_config.default_collect,
                lanes=self.service_config.max_lanes,
            )
            self.metrics.inc("warmup_uploads", n["uploads"])
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="sge-serve-dispatch", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop the dispatcher.  ``drain=True`` executes everything already
        admitted or coalescing first; ``drain=False`` fails pending queries
        with a terminal shutdown error."""
        if self._thread is None:
            # never started: resolve whatever queued so clients can't hang
            self._settle_pending(drain)
            return
        self._drain_on_stop = drain
        self._stop.set()
        self.admission.kick()
        self._thread.join(timeout)
        self._thread = None

    def __enter__(self) -> "EnumerationService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # -- client surface ----------------------------------------------------

    def submit(
        self,
        query: Union[Query, Graph],
        tenant: str = "default",
        name: Optional[str] = None,
        collect: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> ResultStream:
        """Submit one query; returns its :class:`ResultStream` immediately.

        ``query`` is a prepared :class:`Query` or a raw pattern
        :class:`Graph` (prepared here against the service's index, on the
        calling thread).  ``collect`` is the per-worker
        match-materialization budget: > 0 streams mapping chunks, 0 counts
        only.  ``timeout`` bounds how long a full queue may block this call
        (backpressure); quota violations reject immediately with
        :class:`QuotaExceeded`.
        """
        t0 = self._clock()
        self.metrics.inc("submitted")
        q = query if isinstance(query, Query) else self.enumerator.prepare(query, name=name)
        collect = self.service_config.default_collect if collect is None else collect
        stream = ResultStream(name=name or q.name, tenant=tenant)
        if not q.plan.satisfiable:
            # answered from the plan alone: no queue slot, no engine
            self.metrics.inc("unsat")
            ms = self.enumerator.run_pack([q], pack_size=1)[0]
            ms.name = stream.name
            stream._finish(ResultStatus(
                ok=True, matchset=ms, error=None, retries=0, n_chunks=0,
                latency_s=self._clock() - t0,
            ))
            self.metrics.observe_completion(self._clock() - t0, retries=0)
            return stream
        req = Request(query=q, tenant=tenant, stream=stream, collect=collect,
                      submitted_at=t0)
        try:
            self.admission.admit(req, timeout=timeout)
        except QuotaExceeded:
            self.metrics.inc("rejected_quota")
            raise
        except Backpressure:
            self.metrics.inc("rejected_backpressure")
            raise
        self.metrics.inc("admitted")
        return stream

    def stats(self) -> Dict[str, float]:
        """Point-in-time metrics snapshot (counters, latency percentiles,
        QPS, batch occupancy, queue gauges, upload-cache stats)."""
        return self.metrics.snapshot(
            cache=self.enumerator.cache_stats(),
            queue_depth=self.admission.depth(),
            coalescing=self.coalescer.pending(),
            in_flight=self._in_flight,
        )

    def update_index(self, add_edges=(), remove_edges=()):
        """Apply an edge-edit set to the live target (DESIGN.md §8).

        Builds the next index version via :meth:`SubgraphIndex.update`
        (bitmaps and CSR planes patched, untouched planes shared), swaps it
        in for queries prepared from now on, and drops the retired
        version's device uploads (``Enumerator.invalidate_index``).
        Returns the :class:`~repro_torch.core.delta.GraphDelta`.

        Safe to call from any client thread while the dispatcher runs:
        queries already prepared keep their own version (coalesce keys and
        upload-cache keys carry the index fingerprint, so versions never
        share a pack), the session's cache lock orders the drop against the
        dispatcher's uploads, and the swap itself is a single attribute
        assignment.
        """
        old = self.enumerator.index
        if old is None:
            raise ValueError("update_index: service has no index")
        new_index, delta = old.update(
            add_edges=add_edges, remove_edges=remove_edges
        )
        self.metrics.inc("index_updates")
        if delta.is_empty:
            return delta  # no-op edit: same index object, nothing to swap
        self.enumerator.index = new_index
        dropped = self.enumerator.invalidate_index(delta.old_fingerprint)
        if dropped:
            self.metrics.inc("cache_invalidated", dropped)
        return delta

    # -- dispatcher --------------------------------------------------------

    def _bucket_key(self, req: Request) -> tuple:
        return self.enumerator.coalesce_key(
            req.query, self._cfg_for(req.collect)
        ) + (req.collect,)

    def _bucket_key_or_fail(self, req: Request) -> Optional[tuple]:
        """The request's bucket key, or None after failing its stream when
        the key cannot be formed (say, a memory budget too small for one
        row of its target): the dispatcher must not die."""
        try:
            return self._bucket_key(req)
        except Exception as e:  # noqa: BLE001 — server must not die
            self._fail(req, f"{type(e).__name__}: {e}")
            return None

    def _cfg_for(self, collect: int) -> EngineConfig:
        cfg = self._cfgs.get(collect)
        if cfg is None:
            base = self.enumerator.config
            cfg = base if collect == base.collect_matches else dataclasses.replace(
                base, collect_matches=collect
            )
            self._cfgs[collect] = cfg
        return cfg

    def _dispatch_loop(self) -> None:
        sc = self.service_config
        idle_wait = max(sc.batch_window_s, 1e-3)
        while True:
            deadline = self.coalescer.next_deadline()
            if deadline is None:
                timeout = idle_wait
            else:
                timeout = min(idle_wait, max(deadline - self._clock(), 0.0))
            if self._stop.is_set():
                timeout = 0.0
            for req in self.admission.pop(timeout=timeout):
                self.metrics.observe_queue_wait(self._clock() - req.submitted_at)
                key = self._bucket_key_or_fail(req)
                if key is None:
                    continue
                full = self.coalescer.add(key, req)
                if full is not None:
                    self._execute(*full)
            for key, batch in self.coalescer.ripe():
                self._execute(key, batch)
            if self._stop.is_set():
                drained = self.admission.depth() == 0 and self.coalescer.pending() == 0
                if not self._drain_on_stop:
                    self._settle_pending(drain=False)
                    return
                if drained:
                    return

    def _settle_pending(self, drain: bool) -> None:
        """Resolve everything still queued/coalescing — executed (drain)
        or failed with a shutdown status — so no client blocks forever."""
        batches = []
        for req in self.admission.pop(timeout=0):
            key = self._bucket_key_or_fail(req)
            if key is not None:
                batches.append((key, [req]))
        batches += self.coalescer.flush()
        for key, batch in batches:
            if drain:
                self._execute(key, batch)
            else:
                for req in batch:
                    self._fail(req, "service stopped before execution")

    def _fail(self, req: Request, error: str) -> None:
        req.stream._finish(ResultStatus(
            ok=False, matchset=None, error=error, retries=0, n_chunks=0,
            latency_s=self._clock() - req.submitted_at,
        ))
        self.admission.release(req.tenant)
        self.metrics.observe_completion(
            self._clock() - req.submitted_at, retries=0, ok=False,
        )

    def _execute(self, key: tuple, batch: list) -> None:
        """Run one coalesced bucket as a single padded pack and deliver."""
        sc = self.service_config
        cfg = self._cfg_for(batch[0].collect)
        self._in_flight = len(batch)
        try:
            try:
                results = self.enumerator.run_pack(
                    [r.query for r in batch], pack_size=sc.max_lanes, cfg=cfg,
                )
            except Exception as e:  # noqa: BLE001 — server must not die
                for req in batch:
                    self._fail(req, f"{type(e).__name__}: {e}")
                return
            self.metrics.observe_dispatch(len(batch), sc.max_lanes)
            for req, ms in zip(batch, results):
                n_chunks = 0
                if req.collect:
                    maps = ms.mappings()  # decodes the pack's match buffer
                    for start in range(0, len(maps), sc.chunk_size):
                        part = maps[start:start + sc.chunk_size]
                        req.stream._push_chunk(ResultChunk(
                            seq=n_chunks,
                            mappings=tuple(part),
                            final=start + sc.chunk_size >= len(maps),
                        ))
                        n_chunks += 1
                    self.metrics.inc("chunks", n_chunks)
                latency = self._clock() - req.submitted_at
                req.stream._finish(ResultStatus(
                    ok=True, matchset=ms, error=None, retries=ms.retries,
                    n_chunks=n_chunks, latency_s=latency,
                ))
                self.admission.release(req.tenant)
                self.metrics.observe_completion(latency, retries=ms.retries)
        finally:
            self._in_flight = 0
