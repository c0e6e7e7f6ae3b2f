"""Prepared-query session API for subgraph enumeration (dense subset).

A port of the dense single-query half of ``repro.core.session``:

* :class:`SubgraphIndex` — a prepared target: the :class:`PackedGraph`
  bitmaps plus label/degree metadata, built once and reused across queries.
* :class:`Query` — a pattern compiled against an index into a
  :class:`SearchPlan` padded to a shape bucket (``p_pad ∈ {16, 32, 64,
  128}``, ``max_parents = 8``).
* :class:`Enumerator` — the session: an :class:`EngineConfig`, a device,
  and a cache of each index's adjacency on that device (the dominant
  upload), with ``run(query)`` and its doubled-``stack_cap`` overflow retry.

``repro`` also batches preparation and execution (``prepare_batch``,
``run_batch``, ``stream``, ``run_pack``) and maintains results under graph
edits (``run_delta``); those raise ``NotImplementedError`` here, naming the
ROADMAP item that brings them.

Typical use::

    index = SubgraphIndex.build(target)             # once per target
    enum = Enumerator(index, n_workers=16)          # on the CUDA card
    ms = enum.run(enum.prepare(pattern))
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine as eng
from repro_torch.core import extend
from repro_torch.core.engine import EngineConfig, EngineResult
from repro_torch.core.frontier import init_state
from repro_torch.core.graph import Graph, PackedGraph
from repro_torch.core.plan import SearchPlan, build_plan

# Padded pattern-position buckets: every plan's ``p_pad`` snaps up to one of
# these (beyond the last, to multiples of it), as in ``repro``, so plans of
# one bucket have one set of tensor shapes.
SHAPE_BUCKETS: Tuple[int, ...] = (16, 32, 64, 128)

# Fixed parent-slot padding for bucketed plans (the ordering expands it when
# a dense pattern genuinely needs more).
DEFAULT_MAX_PARENTS = 8

# Cap on the lazily materialized match buffer (per worker).
_MATERIALIZE_CAP = 1 << 17

# adjacency uploads an Enumerator keeps: the current index version and one
# more, as ``repro`` keeps for an update handoff
_ADJ_CACHE_ENTRIES = 2


def snap_p_pad(n_p: int) -> int:
    """Smallest shape bucket that holds ``n_p`` pattern positions."""
    for b in SHAPE_BUCKETS:
        if n_p <= b:
            return b
    top = SHAPE_BUCKETS[-1]
    return ((n_p + top - 1) // top) * top


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 item {item}")


# ---------------------------------------------------------------------------
# SubgraphIndex — a prepared target
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubgraphIndex:
    """A target graph prepared for repeated querying (host numpy).

    ``fingerprint`` is a content hash of the packed target; an
    :class:`Enumerator` keys its device copy of the adjacency by it.
    """

    packed: PackedGraph
    n_labels: int
    label_counts: np.ndarray  # [n_labels] int64
    max_degree: int
    build_s: float
    fingerprint: str = ""

    @staticmethod
    def build(
        target: Union[Graph, PackedGraph, "SubgraphIndex"],
        sparse: bool = False,
    ) -> "SubgraphIndex":
        if isinstance(target, SubgraphIndex):
            return target
        if sparse:
            raise _not_ported("SubgraphIndex.build(sparse=True)", "7 (sparse path)")
        t0 = time.perf_counter()
        packed = target if isinstance(target, PackedGraph) else PackedGraph.from_graph(target)
        n_labels = int(packed.labels.max()) + 1 if packed.n else 0
        counts = np.bincount(packed.labels, minlength=max(n_labels, 1)).astype(np.int64)
        degs = packed.deg_out + packed.deg_in
        return SubgraphIndex(
            packed=packed,
            n_labels=n_labels,
            label_counts=counts,
            max_degree=int(degs.max()) if packed.n else 0,
            build_s=time.perf_counter() - t0,
            fingerprint=_fingerprint_packed(packed),
        )

    @property
    def n(self) -> int:
        return self.packed.n

    @property
    def w(self) -> int:
        return self.packed.w

    @property
    def n_edge_labels(self) -> int:
        return self.packed.n_edge_labels


def _fingerprint_packed(packed: PackedGraph) -> str:
    """Content hash of a packed target (the same bytes as ``repro``'s)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((packed.n, packed.w, packed.adj_bits.shape)).encode())
    h.update(np.ascontiguousarray(packed.adj_bits).tobytes())
    h.update(np.ascontiguousarray(packed.labels).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Query — a pattern compiled against an index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Query:
    """A pattern prepared against a :class:`SubgraphIndex`."""

    pattern: Graph
    plan: SearchPlan
    variant: str
    name: str
    prepare_s: float
    index: Optional[SubgraphIndex] = dataclasses.field(default=None, repr=False)

    @property
    def index_fingerprint(self) -> str:
        """Fingerprint of the index this query binds to ("" if none)."""
        return self.index.fingerprint if self.index is not None else ""

    @property
    def satisfiable(self) -> bool:
        return self.plan.satisfiable


def prepare_query(
    pattern: Graph,
    index: Union[SubgraphIndex, Graph, PackedGraph],
    variant: str = "ri-ds-si-fc",
    name: Optional[str] = None,
    p_pad: Optional[int] = None,
    max_parents: Optional[int] = None,
    seed_edge=None,
) -> Query:
    """Compile ``pattern`` against ``index`` into a bucketed :class:`Query`
    (host preprocessing: numpy domains, ordering, plan)."""
    index = SubgraphIndex.build(index)
    t0 = time.perf_counter()
    plan = build_plan(
        pattern,
        index.packed,
        variant=variant,
        p_pad=p_pad if p_pad is not None else snap_p_pad(pattern.n),
        max_parents=max_parents if max_parents is not None else DEFAULT_MAX_PARENTS,
        seed_edge=seed_edge,
    )
    return Query(
        pattern=pattern,
        plan=plan,
        variant=variant,
        name=name or f"q{pattern.n}n{pattern.m}m",
        prepare_s=time.perf_counter() - t0,
        index=index,
    )


# ---------------------------------------------------------------------------
# MatchSet — the result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatchSet:
    """Result of enumerating one query: counts, per-worker stats, lazy matches."""

    name: str
    query_index: int
    matches: int
    states: int
    steps: int
    steals: int
    steal_rounds: int
    mean_steal_depth: float
    mean_expand_depth: float
    per_worker_states: Optional[np.ndarray]
    per_worker_matches: Optional[np.ndarray]
    per_worker_steals: Optional[np.ndarray]
    preprocess_s: float
    match_s: float
    plan: SearchPlan
    engine: EngineResult
    retries: int = 0  # overflow retries spent (stack_cap doubled each time)
    _match_buf: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    _materialize: Optional[Callable[[], Optional[np.ndarray]]] = dataclasses.field(
        default=None, repr=False
    )
    _mappings: Optional[List[Tuple[int, ...]]] = dataclasses.field(default=None, repr=False)

    @property
    def total_s(self) -> float:
        return self.preprocess_s + self.match_s

    def mappings(self) -> List[Tuple[int, ...]]:
        """Materialized match mappings (order position -> target node).

        Lazy: if the engine ran in counting mode, the prepared query is
        re-run once with a match buffer sized to hold every match; the
        result is cached on the MatchSet.
        """
        if self._mappings is not None:
            return self._mappings
        if self.matches == 0:
            self._mappings = []
            return self._mappings
        if self.matches > _MATERIALIZE_CAP and self._match_buf is None:
            raise RuntimeError(
                f"{self.matches} matches exceed the materialization cap "
                f"({_MATERIALIZE_CAP}); re-run with an explicit "
                "collect_matches budget and consume engine.match_buf directly"
            )
        buf = self._match_buf
        if buf is None and self._materialize is not None:
            buf = self._materialize()
        out: List[Tuple[int, ...]] = []
        if buf is not None:
            rows = buf.reshape(-1, buf.shape[-1])[:, : self.plan.n_p]
            valid = (rows >= 0).all(axis=1)
            out = [tuple(int(x) for x in r) for r in rows[valid]]
        self._mappings = out
        return out


def _empty_engine_result() -> EngineResult:
    return EngineResult(
        matches=0, states=0, steps=0, steals=0, steal_rounds=0,
        mean_steal_depth=0.0, mean_expand_depth=0.0,
        per_worker_states=None, per_worker_matches=None,
        overflow=False, match_buf=None,
    )


# ---------------------------------------------------------------------------
# Enumerator — the session
# ---------------------------------------------------------------------------

class Enumerator:
    """A subgraph-enumeration session on one device.

    ``device=None`` means the CUDA card; without one the constructor raises
    and asks for ``device="cpu"``.  The session uploads each index's
    adjacency once and keeps the two most recent uploads;
    :meth:`cache_stats` counts uploads and reuses.  PyTorch compiles
    nothing here, so ``repro``'s compile counters have no counterpart.
    """

    def __init__(
        self,
        index: Union[SubgraphIndex, Graph, PackedGraph, None] = None,
        config: Optional[EngineConfig] = None,
        variant: str = "ri-ds-si-fc",
        mesh=None,
        memory_budget_bytes: Optional[int] = None,
        device=None,
        **config_kwargs,
    ):
        if mesh is not None:
            raise _not_ported("Enumerator(mesh=...)", "11 (multi-device)")
        if memory_budget_bytes is not None:
            raise _not_ported("Enumerator(memory_budget_bytes=...)", "9 (out-of-core)")
        cfg = config or EngineConfig(**config_kwargs)
        if config is not None and config_kwargs:
            cfg = dataclasses.replace(config, **config_kwargs)
        self.config = cfg
        self.variant = variant
        self.device = eng.resolve_device(device)
        self.index = SubgraphIndex.build(index) if index is not None else None
        self._rows: "collections.OrderedDict[str, torch.Tensor]" = collections.OrderedDict()
        self.uploads = 0
        self.cache_hits = 0

    # -- cache -------------------------------------------------------------

    def cache_stats(self) -> Dict[str, int]:
        """``uploads`` (adjacency copies made to the device), ``cache_hits``
        (runs that reused one) and current ``entries``."""
        return {"uploads": self.uploads, "cache_hits": self.cache_hits,
                "entries": len(self._rows)}

    cache_info = cache_stats

    def _plan_arrays(self, query: Query) -> extend.PlanArrays:
        """The query's plan on the device, with its index's adjacency
        uploaded once per index version (hand-built queries without an
        index upload their own)."""
        plan = query.plan
        fp = query.index_fingerprint
        if not fp:
            return extend.make_plan_arrays(plan, self.device)
        rows = self._rows.get(fp)
        if rows is None:
            rows = extend.upload_rows(plan.adj_bits, self.device)
            self._rows[fp] = rows
            self.uploads += 1
            while len(self._rows) > _ADJ_CACHE_ENTRIES:
                self._rows.popitem(last=False)
        else:
            self._rows.move_to_end(fp)
            self.cache_hits += 1
        return extend.make_plan_arrays(plan, self.device, rows=rows)

    # -- preparation -------------------------------------------------------

    def prepare(
        self,
        pattern: Graph,
        variant: Optional[str] = None,
        name: Optional[str] = None,
        index: Union[SubgraphIndex, Graph, PackedGraph, None] = None,
        seed_edge=None,
    ) -> Query:
        """Compile a pattern into a bucketed :class:`Query` for this session."""
        idx = index if index is not None else self.index
        if idx is None:
            raise ValueError(
                "Enumerator has no default SubgraphIndex; pass index= to "
                "prepare() or construct Enumerator(index, ...)"
            )
        return prepare_query(pattern, idx, variant=variant or self.variant, name=name,
                             seed_edge=seed_edge)

    def prepare_batch(self, patterns, variant=None, names=None, index=None, backend=None):
        raise _not_ported("Enumerator.prepare_batch (device domain fixpoint)", "5")

    # -- execution ---------------------------------------------------------

    def run(self, query: Union[Query, Graph], collect_matches: int = 0) -> MatchSet:
        """Run one prepared query.

        A run whose stack high-watermark breached its ring capacity has
        undercounted, so an ``overflow`` result is never returned silently:
        the query is retried once with a doubled ``stack_cap`` (with a
        warning; ``MatchSet.retries`` records it).  If the doubled cap still
        overflows, a ``RuntimeError`` asks for an explicit budget.
        """
        query = query if isinstance(query, Query) else self.prepare(query)
        if not query.plan.satisfiable:
            return self._matchset(query, -1, _empty_engine_result(), 0.0)
        cfg = self.config
        if collect_matches:
            cfg = dataclasses.replace(cfg, collect_matches=collect_matches)
        t0 = time.perf_counter()
        res = self._run_single(cfg, query)
        retries = 0
        if res.overflow:
            res = self._retry_overflowed(cfg, query)
            retries = 1
        match_s = time.perf_counter() - t0
        return self._matchset(query, -1, res, match_s, retries=retries)

    def _run_single(self, cfg: EngineConfig, query: Query) -> EngineResult:
        """One engine invocation (no retry)."""
        arrays = self._plan_arrays(query)
        state = init_state(query.plan, cfg, self.device)
        return eng.result_from_state(eng._engine_loop(cfg, arrays, state), cfg)

    def _retry_overflowed(self, cfg: EngineConfig, query: Query) -> EngineResult:
        """``cfg``'s run of ``query`` overflowed (undercounted): warn and
        re-run once with a doubled ``stack_cap``; raise if even that
        overflows."""
        cap = cfg.resolved_stack_cap(query.plan.p_pad)
        warnings.warn(
            f"query {query.name!r} overflowed its worker stacks "
            f"(stack_cap={cap}); retrying once with stack_cap={2 * cap} — "
            "set EngineConfig.stack_cap to avoid the duplicated work",
            RuntimeWarning,
            stacklevel=3,
        )
        res = self._run_single(dataclasses.replace(cfg, stack_cap=2 * cap), query)
        if res.overflow:
            raise RuntimeError(
                f"engine stack overflow persists at stack_cap={2 * cap} "
                f"for query {query.name!r} — set an explicit "
                "EngineConfig.stack_cap budget"
            )
        return res

    def run_delta(self, query, old_matches, delta):
        raise _not_ported("Enumerator.run_delta (dynamic graphs)", "10")

    def run_batch(self, queries):
        raise _not_ported("Enumerator.run_batch", "6 (session, batched half)")

    def stream(self, queries):
        raise _not_ported("Enumerator.stream", "6 (session, batched half)")

    def run_pack(self, queries, cfg=None):
        raise _not_ported("Enumerator.run_pack", "6 (session, batched half)")

    # -- result assembly ---------------------------------------------------

    def _matchset(
        self, query: Query, idx: int, res: EngineResult, match_s: float,
        retries: int = 0,
    ) -> MatchSet:
        materialize = None
        if res.match_buf is None and query.plan.satisfiable:
            def materialize(q: Query = query, m: int = res.matches):
                # a power-of-two buffer, as repro sizes it
                cap = min(1 << max(m - 1, 1).bit_length(), _MATERIALIZE_CAP)
                return self.run(q, collect_matches=cap).engine.match_buf

        return MatchSet(
            name=query.name,
            query_index=idx,
            matches=res.matches,
            states=res.states,
            steps=res.steps,
            steals=res.steals,
            steal_rounds=res.steal_rounds,
            mean_steal_depth=res.mean_steal_depth,
            mean_expand_depth=res.mean_expand_depth,
            per_worker_states=res.per_worker_states,
            per_worker_matches=res.per_worker_matches,
            per_worker_steals=res.per_worker_steals,
            preprocess_s=query.prepare_s,
            match_s=match_s,
            plan=query.plan,
            engine=res,
            retries=retries,
            _match_buf=res.match_buf,
            _materialize=materialize,
        )


# Process-wide sessions for the one-shot wrapper: one Enumerator (and so one
# adjacency cache) per (config, device).
_SHARED: Dict[Tuple[EngineConfig, str], Enumerator] = {}


def shared_enumerator(cfg: EngineConfig, device=None) -> Enumerator:
    """The process-wide session for ``cfg`` on ``device`` (created on first
    use; ``device=None`` is the CUDA card)."""
    dev = eng.resolve_device(device)
    key = (cfg, str(dev))
    s = _SHARED.get(key)
    if s is None:
        s = _SHARED[key] = Enumerator(config=cfg, device=dev)
    return s
