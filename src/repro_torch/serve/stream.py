"""Per-client streaming result handles (DESIGN.md §7).

A :class:`ResultStream` is what :meth:`EnumerationService.submit` hands
back: a thread-safe one-producer (the dispatcher) / one-consumer (the
client) channel carrying zero or more :class:`ResultChunk` slices of the
query's match mappings followed by exactly one terminal
:class:`ResultStatus`.

Chunks are deterministic: the dispatcher slices the engine's match buffer
in buffer order into ``chunk_size`` pieces with consecutive ``seq``
numbers, so for a given query + config the chunk sequence is identical
across runs and its concatenation is bit-identical to a one-shot
``Enumerator.run(query, collect_matches=...)`` — the property
``tests/test_torch_serving.py`` locks down.  The port's copy of ``repro``'s
module, over the port's :class:`~repro_torch.core.session.MatchSet`.  Counting-mode queries
(``collect=0``) stream no chunks, only the terminal status.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.session import MatchSet


@dataclasses.dataclass(frozen=True)
class ResultChunk:
    """One slice of a query's match mappings, in engine-buffer order."""

    seq: int                                   # 0-based, consecutive
    mappings: Tuple[Tuple[int, ...], ...]      # order position -> target node
    final: bool                                # last chunk of this stream


@dataclasses.dataclass(frozen=True)
class ResultStatus:
    """Terminal status of a served query."""

    ok: bool
    matchset: Optional[MatchSet]   # present iff ok
    error: Optional[str]           # present iff not ok
    retries: int                   # overflow retries spent (0 = clean)
    n_chunks: int
    latency_s: float               # submit -> terminal


class ServiceError(RuntimeError):
    """Raised by :meth:`ResultStream.result` when the query failed."""


_DONE = object()


class ResultStream:
    """Client-side handle for one submitted query."""

    def __init__(self, name: str, tenant: str):
        self.name = name
        self.tenant = tenant
        self._q: "queue_mod.Queue" = queue_mod.Queue()
        self._done = threading.Event()
        self._status: Optional[ResultStatus] = None
        self._seen: List[ResultChunk] = []   # consumed chunks (replayable)
        self._drained = False

    # -- producer side (service dispatcher only) ---------------------------

    def _push_chunk(self, chunk: ResultChunk) -> None:
        self._q.put(chunk)

    def _finish(self, status: ResultStatus) -> None:
        self._status = status
        self._done.set()
        self._q.put(_DONE)

    # -- consumer side (one consumer thread; chunks replay once seen) ------

    def __iter__(self) -> Iterator[ResultChunk]:
        """Yield chunks as they arrive; returns when the stream completes
        (the terminal status is read via :meth:`result` / :meth:`status`).
        Already-consumed chunks are replayed first, so iterating twice is
        safe."""
        yield from self._seen
        while not self._drained:
            item = self._q.get()
            if item is _DONE:
                self._drained = True
                return
            self._seen.append(item)
            yield item

    def chunks(self, timeout: Optional[float] = None) -> List[ResultChunk]:
        """Every chunk of the stream (blocks until terminal)."""
        while not self._drained:
            item = self._q.get(timeout=timeout)
            if item is _DONE:
                self._drained = True
                break
            self._seen.append(item)
        return list(self._seen)

    def status(self, timeout: Optional[float] = None) -> ResultStatus:
        """Block for the terminal status."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.name!r} not terminal after {timeout}s")
        assert self._status is not None
        return self._status

    def result(self, timeout: Optional[float] = None) -> MatchSet:
        """Block for the terminal :class:`MatchSet`; raise
        :class:`ServiceError` if the query failed."""
        st = self.status(timeout)
        if not st.ok:
            raise ServiceError(f"query {self.name!r} failed: {st.error}")
        assert st.matchset is not None
        return st.matchset

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def mappings(self, timeout: Optional[float] = None) -> List[Tuple[int, ...]]:
        """Concatenation of every streamed chunk, in order — bit-identical
        to ``Enumerator.run(query, collect_matches=...).mappings()``."""
        out: List[Tuple[int, ...]] = []
        for chunk in self.chunks(timeout=timeout):
            out.extend(chunk.mappings)
        return out
