"""Prepared-query session API for subgraph enumeration.

A port of ``repro.core.session``:

* :class:`SubgraphIndex` — a prepared target: the :class:`PackedGraph`
  bitmaps plus label/degree metadata, built once and reused across
  queries; or, with ``build(graph, sparse=True)``, a **CSR-only** index
  whose adjacency is the target's :class:`CsrPlanes` (dense bitmaps never
  exist — the layout of the paper's 33k-node PDBSv1 targets).  A dense
  index is **versioned**: ``update(add_edges, remove_edges)`` returns a
  new index (patched bitmaps and CSR planes, ``version + 1``, a chained
  fingerprint) and its :class:`~repro_torch.core.delta.GraphDelta`.
* :class:`Query` — a pattern compiled against an index into a
  :class:`SearchPlan` padded to a shape bucket (``p_pad ∈ {16, 32, 64,
  128}``, ``max_parents = 8``); CSR-only against a sparse index.
* :class:`Enumerator` — the session: an :class:`EngineConfig`, a device,
  and a cache of each index's adjacency on that device (the dominant
  upload: bitmaps, or CSR planes under the csr backend), with

    - ``prepare(pattern)``           — host (numpy) preprocessing; for a
      sparse index the CSR-native domain fixpoint on the device;
    - ``prepare_batch(patterns)``    — the AC ⇄ FC domain fixpoint on the
      device for whole same-bucket pattern batches
      (`repro_torch.core.domains.compute_domains_batch`, over dense planes
      or CSR segments), the default for raw patterns given to the batched
      methods;
    - ``run(query)``                 — one query, with its doubled
      ``stack_cap`` overflow retry;
    - ``run_batch(queries)`` / ``stream(queries)`` — LPT-balanced packs of
      same-key queries, each pack one engine run whose steps launch one
      kernel for every lane of the pack; ``run_pack`` runs one given pack;
    - ``run_delta(query, old, delta)`` — maintain a match set across one
      index update: removals by membership test, insertions by engine runs
      seeded from the inserted arcs; ``invalidate_index(fingerprint)``
      drops a retired version's device copies.

``Enumerator(..., memory_budget_bytes=N)`` selects the out-of-core
partitioned backend: each target's CSR rows are split into the fewest
contiguous partitions whose padded resident planes fit ``N`` bytes
(``step_backend="partitioned"`` with ``n_partitions=k`` picks the count
instead), and a run streams them through the device
(`repro_torch.core.engine.run_partitioned`).  Such a session runs the
queries of a pack or a stream one by one, as ``repro``'s does.

``Enumerator(..., mesh=...)`` shards each run's worker stacks over a
:class:`~repro_torch.core.engine.Mesh` of devices (an int ``n``: the
first ``n`` cards, or ``n`` shards on a CPU session), with plan arrays
replicated once per distinct device (`repro_torch.core.engine`).
``n_workers`` snaps up to a multiple of the mesh's worker-axis size
(`repro_torch.core.engine.mesh_worker_axis`); results equal the
unsharded session's, and packs and streams run their queries singly, as
``repro``'s mesh sessions do.

An explicitly dense step backend (``"jnp"`` / ``"pallas"``) cannot run a
CSR-only plan; the session raises ``ValueError`` at prepare and run entry.

PyTorch compiles nothing here, so ``repro``'s compile cache has no
counterpart.  A session's one-off cost is instead the **upload** of each
index version's adjacency per layout, and wherever ``repro`` counts
``compiles`` the port counts ``uploads``: ``cache_stats()["uploads"]``,
``warm()["uploads"]`` (fresh uploads spent warming), and the service's
``cache_uploads`` / ``warmup_uploads``, whose hit rate is hits over
uploads plus hits.  :meth:`Enumerator.warm` moves that upload, the loading
of the kernel libraries a query's step launches and the first use of the
engine's ops ahead of the first real run.  A lock guards the upload
cache, so one thread may run packs while others prepare queries or retire
index versions.

Typical use::

    index = SubgraphIndex.build(target)             # once per target
    enum = Enumerator(index, n_workers=16)          # on the CUDA card
    ms = enum.run(enum.prepare(pattern))
    for ms in enum.stream(patterns):                # device preprocessing
        print(ms.name, ms.matches)
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
import warnings
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import delta as delta_mod
from repro_torch.core import domains as dom_mod
from repro_torch.core import engine as eng
from repro_torch.core import extend
from repro_torch.core.delta import DeltaMatchSet, GraphDelta
from repro_torch.core.engine import EngineConfig, EngineResult
from repro_torch.core.frontier import (
    EngineState,
    init_delta_state,
    init_spill_state,
    init_state,
    stack_states,
)
from repro_torch.core.graph import (
    WORD_BITS,
    CsrPlanes,
    CsrPlaneSet,
    Graph,
    PackedGraph,
    bitmap_to_indices,
    n_words,
    popcount,
)
from repro_torch.core.plan import SearchPlan, build_csr_plan, build_plan, variant_flags
from repro_torch.core.scheduler import balance_assignment
from repro_torch.kernels import ops as kops

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


def snap_arc_pad(n_arcs: int) -> int:
    """Arc-slot bucket for the device domain engine: multiples of 8."""
    return max(8, ((n_arcs + 7) // 8) * 8)


def snap_loop_pad(n_loops: int) -> int:
    """Self-loop-slot bucket: 1 (the loop-free common case) or multiples
    of 4."""
    return 1 if n_loops == 0 else ((n_loops + 3) // 4) * 4


def snap_batch_pad(n: int) -> int:
    """Pattern-batch lane bucket: the next power of two, as in ``repro``.
    The lanes beyond the batch are frozen from the start, so they cost no
    sweep."""
    return 1 << max(n - 1, 0).bit_length()


def _match_count(old) -> int:
    """Prior-match count without materializing mappings: a MatchSet-like
    object carries it as ``.matches`` (an int); anything else is a
    sequence of mappings."""
    m = getattr(old, "matches", None)
    if isinstance(m, int):
        return m
    try:
        return len(old)
    except TypeError:
        return len(list(old))


# ---------------------------------------------------------------------------
# SubgraphIndex — a prepared target
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubgraphIndex:
    """A target graph prepared for repeated querying (host numpy).

    ``fingerprint`` is a content hash of the target; an
    :class:`Enumerator` keys its device copy of the adjacency by it.
    :meth:`update` makes a new version: ``version + 1`` and a fingerprint
    chained through the edit, so a run on the new version never reads the
    old version's upload.

    A **sparse** index (``build(graph, sparse=True)``) never materializes
    the dense adjacency bitmaps: ``packed`` is a metadata shell whose
    ``adj_bits`` has a zero node axis, ``graph`` keeps the host
    :class:`Graph` for CSR-native preprocessing, and the canonical
    :class:`CsrPlanes` are built eagerly.  Plans built against it are
    CSR-only (only the ``csr`` / ``auto`` step backends run them).
    """

    packed: PackedGraph
    n_labels: int
    label_counts: np.ndarray  # [n_labels] int64
    max_degree: int
    build_s: float
    version: int = 0
    fingerprint: str = ""
    sparse: bool = False
    graph: Optional[Graph] = dataclasses.field(default=None, repr=False, compare=False)
    # the per-plane CSR adjacency of a dense index, built lazily; update()
    # patches only its touched planes and shares the rest across versions
    _plane_set: Optional[CsrPlaneSet] = dataclasses.field(default=None, repr=False,
                                                          compare=False)
    # the flat CSR planes, built lazily for a dense index (eagerly for a sparse one)
    _csr_flat: Optional[CsrPlanes] = dataclasses.field(default=None, repr=False,
                                                       compare=False)

    @staticmethod
    def build(
        target: Union[Graph, PackedGraph, "SubgraphIndex"],
        sparse: bool = False,
    ) -> "SubgraphIndex":
        if isinstance(target, SubgraphIndex):
            return target
        if sparse:
            return SubgraphIndex._build_sparse(target)
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

    @staticmethod
    def _build_sparse(target: Graph) -> "SubgraphIndex":
        """CSR-only index of a host :class:`Graph`: the packed form is a
        metadata shell (labels and degrees, plus an ``adj_bits`` placeholder
        with a zero node axis) and the canonical :class:`CsrPlanes` are the
        adjacency."""
        if not isinstance(target, Graph):
            raise TypeError(
                "SubgraphIndex.build(sparse=True) needs a host Graph — a "
                f"{type(target).__name__} has already materialized (or "
                "implies) the dense bitmaps"
            )
        t0 = time.perf_counter()
        w = n_words(target.n)
        nl = target.n_edge_labels
        planes = target.csr_planes(nl)
        labels = np.asarray(target.labels, dtype=np.int32)
        packed = PackedGraph(
            n=target.n,
            w=w,
            adj_bits=np.zeros((nl, 2, 0, w), dtype=np.uint32),
            labels=labels,
            deg_out=target.out_degrees(),
            deg_in=target.in_degrees(),
        )
        n_labels = int(labels.max()) + 1 if target.n else 0
        counts = np.bincount(labels, minlength=max(n_labels, 1)).astype(np.int64)
        degs = packed.deg_out + packed.deg_in
        return SubgraphIndex(
            packed=packed,
            n_labels=n_labels,
            label_counts=counts,
            max_degree=int(degs.max()) if target.n else 0,
            build_s=time.perf_counter() - t0,
            fingerprint=_fingerprint_sparse(planes, labels, target.n, w),
            sparse=True,
            graph=target,
            _csr_flat=planes,
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

    def plane_set(self) -> CsrPlaneSet:
        """Per-plane CSR adjacency, built lazily and patched (not rebuilt)
        by :meth:`update` — untouched planes share buffers across versions."""
        if self.sparse:
            raise ValueError(
                "sparse SubgraphIndex has no per-plane set derived from "
                "dense bitmaps; use csr_planes() for the flat adjacency"
            )
        if self._plane_set is None:
            object.__setattr__(self, "_plane_set", CsrPlaneSet.from_bitmaps(self.packed.adj_bits))
        return self._plane_set

    def csr_planes(self) -> CsrPlanes:
        """The index's canonical :class:`CsrPlanes` (cached): plans built
        against it read them through their ``csr_factory``, so the csr
        backend never re-derives planes per plan.  A dense index takes them
        from :meth:`plane_set`, so an update's patched planes reach the csr
        step."""
        if self._csr_flat is None:
            object.__setattr__(self, "_csr_flat", self.plane_set().to_planes())
        return self._csr_flat

    # -- incremental update ------------------------------------------------

    def update(
        self,
        add_edges: Iterable = (),
        remove_edges: Iterable = (),
    ) -> Tuple["SubgraphIndex", GraphDelta]:
        """Apply an edge edit, returning ``(new_index, delta)`` (host numpy,
        as in ``repro``).

        Edits are ``(u, v)`` or ``(u, v, elab)`` arc triples with set
        semantics: duplicate inserts and removals of absent arcs are
        dropped, and an arc both inserted and removed in the *same* call
        cancels before anything is applied.  A true no-op returns ``self``
        unchanged (same object, same version) with an empty delta.

        The new index patches a copy of the dense bitmaps (bit flips on
        touched rows), re-sorts only the touched rows of the touched CSR
        planes (untouched planes share buffers by reference), recomputes
        degrees for touched nodes only, and shares the label arrays.  Node
        set and node labels are immutable; inserting an arc with a new edge
        label grows the plane axis.  Degrees are recomputed from the
        patched bitmaps, i.e. as *distinct-arc* counts.

        A sparse (CSR-only) index cannot be updated.
        """
        if self.sparse:
            raise NotImplementedError(
                "incremental update of a sparse (CSR-only) SubgraphIndex is "
                "not supported — rebuild with SubgraphIndex.build(graph, "
                "sparse=True), or build a dense index when deltas are needed"
            )
        t0 = time.perf_counter()
        adds = delta_mod.normalize_edges(add_edges)
        rems = delta_mod.normalize_edges(remove_edges)
        cancel = set(adds) & set(rems)
        packed = self.packed
        n, w, nl = packed.n, packed.w, packed.n_edge_labels
        for (u, v, l) in tuple(adds) + tuple(rems):
            if not (0 <= u < n and 0 <= v < n):
                raise ValueError(f"edit arc ({u}, {v}) out of range for n={n}")
            if l < 0:
                raise ValueError(f"negative edge label {l}")

        def present(t) -> bool:
            u, v, l = t
            if l >= nl:
                return False
            return bool((int(packed.adj_bits[l, 0, u, v // WORD_BITS]) >> (v % WORD_BITS)) & 1)

        eff_add = tuple(t for t in adds if t not in cancel and not present(t))
        eff_rem = tuple(t for t in rems if t not in cancel and present(t))
        if not eff_add and not eff_rem:
            return self, GraphDelta(
                added=(), removed=(),
                old_version=self.version, new_version=self.version,
                old_fingerprint=self.fingerprint, new_fingerprint=self.fingerprint,
            )

        nl_new = max(nl, 1 + max((l for (_, _, l) in eff_add), default=-1))
        if nl_new > nl:
            adj = np.zeros((nl_new, 2, n, w), dtype=np.uint32)
            adj[:nl] = packed.adj_bits
        else:
            adj = packed.adj_bits.copy()
        for (u, v, l) in eff_add:
            adj[l, 0, u, v // WORD_BITS] |= np.uint32(1) << np.uint32(v % WORD_BITS)
            adj[l, 1, v, u // WORD_BITS] |= np.uint32(1) << np.uint32(u % WORD_BITS)
        for (u, v, l) in eff_rem:
            adj[l, 0, u, v // WORD_BITS] &= ~(np.uint32(1) << np.uint32(v % WORD_BITS))
            adj[l, 1, v, u // WORD_BITS] &= ~(np.uint32(1) << np.uint32(u % WORD_BITS))

        # degrees: recompute touched endpoints from the patched bitmaps
        deg_out = packed.deg_out.copy()
        deg_in = packed.deg_in.copy()
        touched_src = np.fromiter({u for (u, _, _) in eff_add + eff_rem}, dtype=np.int64)
        touched_dst = np.fromiter({v for (_, v, _) in eff_add + eff_rem}, dtype=np.int64)
        if len(touched_src):
            deg_out[touched_src] = popcount(adj[:, 0, touched_src, :]).sum(axis=0)
        if len(touched_dst):
            deg_in[touched_dst] = popcount(adj[:, 1, touched_dst, :]).sum(axis=0)

        new_packed = PackedGraph(
            n=n, w=w, adj_bits=adj, labels=packed.labels, deg_out=deg_out, deg_in=deg_in,
        )

        # CSR plane set: patch only touched (plane, row) pairs; untouched
        # planes' buffers are shared by reference
        new_plane_set = None
        if self._plane_set is not None:
            rows_of: Dict[int, Dict[int, np.ndarray]] = {}
            for (u, v, l) in eff_add + eff_rem:
                rows_of.setdefault(l * 2, {})[u] = None
                rows_of.setdefault(l * 2 + 1, {})[v] = None
            for p, rows in rows_of.items():
                for r in rows:
                    rows[r] = bitmap_to_indices(adj[p // 2, p % 2, r])
            new_plane_set = self.plane_set().grown(2 * nl_new).patched(rows_of)

        # the fingerprint chains through the edit, byte for byte as repro's
        h = hashlib.blake2b(digest_size=16)
        h.update(self.fingerprint.encode())
        h.update(repr((eff_add, eff_rem)).encode())
        new_fp = h.hexdigest()

        degs = deg_out + deg_in
        new_index = SubgraphIndex(
            packed=new_packed,
            n_labels=self.n_labels,
            label_counts=self.label_counts,
            max_degree=int(degs.max()) if n else 0,
            build_s=time.perf_counter() - t0,
            version=self.version + 1,
            fingerprint=new_fp,
            _plane_set=new_plane_set,
        )
        delta = GraphDelta(
            added=eff_add,
            removed=eff_rem,
            old_version=self.version,
            new_version=new_index.version,
            old_fingerprint=self.fingerprint,
            new_fingerprint=new_fp,
        )
        return new_index, delta


def _fingerprint_packed(packed: PackedGraph) -> str:
    """Content hash of a packed target (the same bytes as ``repro``'s)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((packed.n, packed.w, packed.adj_bits.shape)).encode())
    h.update(np.ascontiguousarray(packed.adj_bits).tobytes())
    h.update(np.ascontiguousarray(packed.labels).tobytes())
    return h.hexdigest()


def _fingerprint_sparse(planes: CsrPlanes, labels: np.ndarray, n: int, w: int) -> str:
    """Content hash of a sparse index: shapes, CSR adjacency and node
    labels (the same bytes as ``repro``'s)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((n, w, planes.n_planes, planes.nnz, "csr")).encode())
    h.update(np.ascontiguousarray(planes.indptr).tobytes())
    h.update(np.ascontiguousarray(planes.indices).tobytes())
    h.update(np.ascontiguousarray(labels).tobytes())
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
    # per-anchor plan cache for run_delta: {(pa, pb, elab): SearchPlan}
    _anchors: Dict[Tuple[int, int, int], SearchPlan] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )
    _anchor_domains: Optional[dom_mod.DomainResult] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def bucket(self) -> Tuple[int, int, int, int, int]:
        """The shape key ``(p_pad, max_parents, n_t, w, n_elab)``: queries of
        one bucket stack into one pack (:meth:`Enumerator.coalesce_key`)."""
        p = self.plan
        return (p.p_pad, p.max_parents, p.n_t, p.w, p.n_edge_labels)

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
    device=None,
    use_pallas: bool = False,
) -> Query:
    """Compile ``pattern`` against ``index`` into a bucketed :class:`Query`.

    A dense index runs host preprocessing (numpy domains, ordering, plan).
    A **sparse** index compiles through
    :func:`~repro_torch.core.plan.build_csr_plan`: the ``ri-ds*`` variants
    run the CSR-native domain fixpoint on ``device`` (default: the CUDA
    card; with K8 and K3 when ``use_pallas``), and the plan is CSR-only.

    ``seed_edge`` (``"auto"`` or an explicit ``(u, v, elab)`` pattern-edge
    triple) anchors that edge at ordering positions 0/1, so an engine with
    ``root_seeding="edge"`` / ``"auto"`` seeds from its target edge class;
    ``"auto"`` selects over the index's cached CSR planes.
    """
    index = SubgraphIndex.build(index)
    t0 = time.perf_counter()
    p_pad = p_pad if p_pad is not None else snap_p_pad(pattern.n)
    max_parents = max_parents if max_parents is not None else DEFAULT_MAX_PARENTS
    if index.sparse:
        plan = build_csr_plan(
            pattern, index.graph, variant=variant, p_pad=p_pad, max_parents=max_parents,
            w=index.w, seed_edge=seed_edge, planes=index.csr_planes(), device=device,
            use_pallas=use_pallas,
        )
    else:
        plan = build_plan(
            pattern, index.packed, variant=variant, p_pad=p_pad, max_parents=max_parents,
            csr_factory=index.csr_planes, seed_edge=seed_edge,
        )
    return Query(
        pattern=pattern,
        plan=plan,
        variant=variant,
        name=name or _default_name(pattern),
        prepare_s=time.perf_counter() - t0,
        index=index,
    )


def _default_name(pattern: Graph) -> str:
    """Default query name, shared by prepare_query and prepare_batch."""
    return f"q{pattern.n}n{pattern.m}m"


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
    adjacency once per layout (dense bitmaps, or CSR planes under the csr
    backend) and keeps the ``max_cache_entries`` most recent uploads of
    each (0, the default, keeps two: the current index version and one
    more, for an update handoff); the domain fixpoint of
    :meth:`prepare_batch` reads the same upload.

    ``step_backend="auto"`` defers the step backend to the target: queries
    against targets beyond ``extend.CSR_AUTO_NT`` (32,768) nodes, and every
    CSR-only query, run the sparse ``csr`` step; smaller dense ones the
    ``jnp`` step.  ``memory_budget_bytes`` (> 0) selects the out-of-core
    ``"partitioned"`` backend, its partition count derived per target so
    that the resident padded planes fit the budget.
    :meth:`cache_stats` counts uploads, reuses and evictions, and
    :meth:`warm` spends the uploads (and the kernel loads) of a set of
    queries up front; these stand for ``repro``'s compile counters.

    ``domain_backend`` picks where :meth:`prepare_batch` (and so the
    batched methods, for raw patterns) computes domains: ``"device"`` (the
    default) or ``"numpy"`` (per-query host preprocessing).

    ``mesh`` (``None``, a :class:`~repro_torch.core.engine.Mesh`, or an
    int: the first ``n`` cards on a CUDA session, ``n`` shards on a CPU
    one) shards every run's worker stacks over the mesh's devices; the
    mesh's first device is the session's (``device=None`` takes it from a
    ``Mesh``), and ``n_workers`` snaps up to a multiple of the size of its
    worker axis.
    Each upload then holds one replica per distinct device of the mesh, and
    ``uploads`` counts an index version's upload in one layout once,
    however many replicas it made.
    """

    def __init__(
        self,
        index: Union[SubgraphIndex, Graph, PackedGraph, None] = None,
        config: Optional[EngineConfig] = None,
        variant: str = "ri-ds-si-fc",
        mesh=None,
        domain_backend: str = "device",
        max_cache_entries: int = 0,
        memory_budget_bytes: Optional[int] = None,
        device=None,
        **config_kwargs,
    ):
        if domain_backend not in ("device", "numpy"):
            raise ValueError(
                f"domain_backend must be 'device' or 'numpy', got {domain_backend!r}"
            )
        if max_cache_entries < 0:
            raise ValueError(f"max_cache_entries must be >= 0, got {max_cache_entries}")
        cfg = config or EngineConfig(**config_kwargs)
        if config is not None and config_kwargs:
            cfg = dataclasses.replace(config, **config_kwargs)
        if memory_budget_bytes is not None:
            if memory_budget_bytes <= 0:
                raise ValueError(
                    f"memory_budget_bytes must be positive, got {memory_budget_bytes}"
                )
            # a budget implies the out-of-core backend; the partition count
            # is derived per target (_partition_count)
            cfg = dataclasses.replace(cfg, step_backend="partitioned")
        self.memory_budget_bytes = memory_budget_bytes
        if device is None and isinstance(mesh, eng.Mesh):
            device = mesh.devices[0]
        self.device = eng.resolve_device(device)
        self.mesh = eng.coerce_mesh(mesh, self.device)
        # where uploads are replicated: each distinct device of the mesh
        self._devices = (self.device,)
        if self.mesh is not None:
            self.device = self.mesh.devices[0]  # a card's index filled in
            self._devices = self.mesh.distinct_devices
            # snap up so every shard owns the same number of stacks
            n_dev = len(self.mesh.shard_devices)
            cfg = dataclasses.replace(cfg, n_workers=-(-cfg.n_workers // n_dev) * n_dev)
        self.config = cfg
        self.variant = variant
        self.domain_backend = domain_backend
        self.index = SubgraphIndex.build(index) if index is not None else None
        self.max_cache_entries = max_cache_entries
        # LRU-ordered uploads per layout: hits move an entry to the back, a
        # new upload evicts from the front past the bound
        self._rows: "collections.OrderedDict[str, torch.Tensor]" = collections.OrderedDict()
        self._csr: "collections.OrderedDict[str, extend.CsrUpload]" = collections.OrderedDict()
        # the domain fixpoint's target arrays, per cached adjacency upload
        self._dom_targets: Dict[str, Union[dom_mod.TargetDomainArrays,
                                           dom_mod.CsrTargetDomainArrays]] = {}
        # guards the caches and their counters: a service's dispatcher
        # thread runs packs while client threads prepare batches and retire
        # index versions (invalidate_index)
        self._cache_lock = threading.Lock()
        self.uploads = 0
        self.cache_hits = 0
        self.evictions = 0
        # sticky high-water match-ring size for seeded delta runs (see
        # _run_seeded): grow-retries fold into one steady-state size
        self._delta_mcap = self._DELTA_MCAP

    # -- cache -------------------------------------------------------------

    def cache_stats(self) -> Dict[str, int]:
        """``uploads`` (adjacency copies made to the device), ``cache_hits``
        (runs that reused one), ``evictions`` (uploads dropped past the
        bound), current ``entries`` and the configured ``max_entries``
        (0: two per layout).  The service's metrics snapshot reads it."""
        with self._cache_lock:
            return {"uploads": self.uploads, "cache_hits": self.cache_hits,
                    "evictions": self.evictions,
                    "entries": len(self._rows) + len(self._csr),
                    "max_entries": self.max_cache_entries}

    cache_info = cache_stats

    def invalidate_index(self, fingerprint: str) -> int:
        """Drop the device copies of index version ``fingerprint`` (one
        retired by ``SubgraphIndex.update``): its adjacency uploads and the
        domain fixpoint's arrays built on them.  Returns the number of
        uploads dropped (what ``cache_stats()["entries"]`` counts).
        Correctness never depends on it — the cache is keyed by the
        fingerprint, so a run never reads another version's upload."""
        if not fingerprint:
            return 0
        with self._cache_lock:
            dropped = sum(cache.pop(fingerprint, None) is not None
                          for cache in (self._rows, self._csr))
            self._dom_targets.pop(fingerprint, None)
        return dropped

    def _cached(self, cache: "collections.OrderedDict", fp: str, make: Callable):
        """``cache[fp]``, made by ``make()`` and counted as an upload on a
        miss (keeping the ``max_cache_entries`` most recent entries, two
        when 0), as a hit otherwise.  The caller holds ``_cache_lock``, so
        two threads that miss together upload once."""
        hit = cache.get(fp)
        if hit is None:
            hit = cache[fp] = make()
            self.uploads += 1
            while len(cache) > (self.max_cache_entries or _ADJ_CACHE_ENTRIES):
                old, _ = cache.popitem(last=False)
                self.evictions += 1
                self._dom_targets.pop(old, None)
        else:
            cache.move_to_end(fp)
            self.cache_hits += 1
        return hit

    def _replicated(self, make_one: Callable) -> Callable[[], Dict[str, object]]:
        """A ``make`` for :meth:`_cached`: ``make_one(device)`` on each
        distinct device of the session, keyed by the device's name."""
        return lambda: {str(d): make_one(d) for d in self._devices}

    def _row_uploads(self, fp: str, adj_bits: np.ndarray) -> Dict[str, torch.Tensor]:
        """The kernels' flattened adjacency of index version ``fp`` on each
        device of the session, uploaded once
        (:func:`~repro_torch.core.extend.upload_rows`)."""
        with self._cache_lock:
            return self._cached(self._rows, fp, self._replicated(
                lambda d: extend.upload_rows(adj_bits, d)))

    def _csr_uploads(self, fp: str,
                     planes: Callable[[], CsrPlanes]) -> Dict[str, extend.CsrUpload]:
        """The CSR planes of index version ``fp`` on each device of the
        session, uploaded once (:func:`~repro_torch.core.extend.upload_csr`)."""
        with self._cache_lock:
            return self._cached(self._csr, fp, self._replicated(
                lambda d: extend.upload_csr(planes(), d)))

    def _adjacency_rows(self, fp: str, adj_bits: np.ndarray) -> torch.Tensor:
        """:meth:`_row_uploads` on the session's device."""
        return self._row_uploads(fp, adj_bits)[str(self.device)]

    def _csr_upload(self, fp: str, planes: Callable[[], CsrPlanes]) -> extend.CsrUpload:
        """:meth:`_csr_uploads` on the session's device."""
        return self._csr_uploads(fp, planes)[str(self.device)]

    def _plan_replicas(self, queries: Sequence[Query],
                       cfg: Optional[EngineConfig] = None) -> Dict[str, extend.AnyPlanArrays]:
        """The plans of a pack (one coalesce key) on each device of the
        session, keyed by the device's name, in the layout of the step
        backend ``cfg`` resolves for them, with their index's adjacency
        uploaded once per index version (hand-built queries without an
        index upload their own)."""
        cfg = cfg or self.config
        plans = [q.plan for q in queries]
        fp = queries[0].index_fingerprint
        if not fp:
            return {str(d): extend.plan_arrays_for(cfg, plans, d) for d in self._devices}
        if extend.resolve_step_backend_for_plan(cfg, plans[0]) == "csr":
            ups = self._csr_uploads(fp, lambda: extend.plan_csr(plans[0]))
            return {name: extend.plan_arrays_for(cfg, plans, torch.device(name), csr=up)
                    for name, up in ups.items()}
        ups = self._row_uploads(fp, plans[0].adj_bits)
        return {name: extend.plan_arrays_for(cfg, plans, torch.device(name), rows=up)
                for name, up in ups.items()}

    def _plan_arrays(self, queries: Sequence[Query],
                     cfg: Optional[EngineConfig] = None) -> extend.AnyPlanArrays:
        """:meth:`_plan_replicas` on the session's device."""
        return self._plan_replicas(queries, cfg)[str(self.device)]

    def _run_engine(self, cfg: EngineConfig, queries: Sequence[Query],
                    state: EngineState) -> EngineState:
        """The round loop over ``state``: sharded over the session's mesh
        (one query), or on its device."""
        if self.mesh is None:
            return eng._engine_loop(cfg, self._plan_arrays(queries, cfg), state)
        fn = eng.make_sharded_engine_fn(cfg, self.mesh)
        return fn(self._plan_replicas(queries, cfg), state)

    def _target_domain_arrays(self, index: SubgraphIndex):
        """The domain fixpoint's target arrays for ``index``, built around
        the session's adjacency upload so the target is on the device once:
        dense planes as a view of the flattened rows
        (:class:`~repro_torch.core.domains.TargetDomainArrays`), or, for a
        sparse index, the CSR segments over the uploaded ``indices``
        (:class:`~repro_torch.core.domains.CsrTargetDomainArrays`)."""
        fp = index.fingerprint
        with self._cache_lock:
            if index.sparse:
                upload = self._cached(self._csr, fp, self._replicated(
                    lambda d: extend.upload_csr(index.csr_planes(), d)))[str(self.device)]
                arrays = self._dom_targets.get(fp)
                if arrays is None:
                    arrays = dom_mod.csr_target_domain_arrays(
                        index.graph, index.w, planes=index.csr_planes(), upload=upload)
                    self._dom_targets[fp] = arrays
                return arrays
            rows = self._cached(self._rows, fp, self._replicated(
                lambda d: extend.upload_rows(index.packed.adj_bits, d)))[str(self.device)]
            arrays = self._dom_targets.get(fp)
            if arrays is None:
                adj_flat = rows[:-1].view(2 * index.n_edge_labels, index.n, index.w)
                arrays = dom_mod.target_domain_arrays(index.packed, adj_flat=adj_flat)
                self._dom_targets[fp] = arrays
            return arrays

    # -- preparation -------------------------------------------------------

    def prepare(
        self,
        pattern: Graph,
        variant: Optional[str] = None,
        name: Optional[str] = None,
        index: Union[SubgraphIndex, Graph, PackedGraph, None] = None,
        seed_edge=None,
    ) -> Query:
        """Compile a pattern into a bucketed :class:`Query` for this session.

        ``seed_edge`` is forwarded to :func:`prepare_query` (edge-centric
        seeding).  A sparse index yields a CSR-only plan, whose domain
        fixpoint runs on this session's device (with K8 and K3 when
        ``use_pallas``); if the session's step backend is explicitly dense
        (``"jnp"`` / ``"pallas"``), that combination can never run, so it
        raises here."""
        idx = index if index is not None else self.index
        if idx is None:
            raise ValueError(
                "Enumerator has no default SubgraphIndex; pass index= to "
                "prepare() or construct Enumerator(index, ...)"
            )
        q = prepare_query(pattern, idx, variant=variant or self.variant, name=name,
                          seed_edge=seed_edge, device=self.device,
                          use_pallas=self.config.use_pallas)
        extend.validate_backend_for_plan(self.config, q.plan)
        return q

    def prepare_batch(
        self,
        patterns: Sequence[Graph],
        variant: Optional[str] = None,
        names: Optional[Sequence[str]] = None,
        index: Union[SubgraphIndex, Graph, PackedGraph, None] = None,
        backend: Optional[str] = None,
    ) -> List[Query]:
        """Prepare a batch of patterns with **device** domain preprocessing:
        patterns are grouped by domain bucket ``(p_pad, arc_pad,
        loop_pad)`` and each group's AC ⇄ FC fixpoint runs as one batched
        fixpoint (:func:`~repro_torch.core.domains.compute_domains_batch`;
        with ``use_pallas`` its arc tests and popcounts are the K5 and K3
        kernels).  Results are bit-identical to per-query :meth:`prepare`
        (the numpy oracle).  ``backend='numpy'`` (or
        ``Enumerator(domain_backend='numpy')``) runs per-query
        :meth:`prepare` instead.

        A **sparse** index runs the same grouped fixpoint over its CSR
        segments (one K8 launch per sweep with ``use_pallas``) and
        assembles CSR-only plans: dense adjacency bitmaps never exist.
        """
        idx = index if index is not None else self.index
        if idx is None:
            raise ValueError(
                "Enumerator has no default SubgraphIndex; pass index= to "
                "prepare_batch() or construct Enumerator(index, ...)"
            )
        idx = SubgraphIndex.build(idx)
        variant = variant or self.variant
        patterns = list(patterns)
        if names is not None and len(names) != len(patterns):
            raise ValueError(
                f"names has {len(names)} entries for {len(patterns)} patterns"
            )

        def name_of(i, p):
            return names[i] if names is not None else _default_name(p)

        backend = backend or self.domain_backend
        if backend == "numpy":
            return [
                self.prepare(p, variant=variant, name=name_of(i, p), index=idx)
                for i, p in enumerate(patterns)
            ]

        flags = variant_flags(variant)
        groups: Dict[tuple, List[int]] = {}
        for i, p in enumerate(patterns):
            n_p, n_a, n_l = dom_mod.domain_bucket(p)
            key = (snap_p_pad(n_p), snap_arc_pad(n_a), snap_loop_pad(n_l))
            groups.setdefault(key, []).append(i)

        out: List[Optional[Query]] = [None] * len(patterns)
        tgt_arrays = self._target_domain_arrays(idx)
        for (p_pad, a_pad, l_pad), idxs in groups.items():
            t0 = time.perf_counter()
            doms = dom_mod.compute_domains_batch(
                [patterns[i] for i in idxs],
                idx.packed,
                use_ac=flags["use_ac"],
                use_fc=flags["use_fc"],
                interleave=flags["interleave"],
                use_pallas=self.config.use_pallas,
                p_pad=p_pad,
                arc_pad=a_pad,
                loop_pad=l_pad,
                batch_pad=snap_batch_pad(len(idxs)),
                tgt_arrays=tgt_arrays,
            )
            dom_s = (time.perf_counter() - t0) / max(len(idxs), 1)
            for i, dres in zip(idxs, doms):
                t1 = time.perf_counter()
                if idx.sparse:
                    plan = build_csr_plan(
                        patterns[i], idx.graph, variant=variant,
                        p_pad=snap_p_pad(patterns[i].n), max_parents=DEFAULT_MAX_PARENTS,
                        w=idx.w, domains=dres, planes=idx.csr_planes(),
                    )
                else:
                    plan = build_plan(
                        patterns[i], idx.packed, variant=variant,
                        p_pad=snap_p_pad(patterns[i].n), max_parents=DEFAULT_MAX_PARENTS,
                        domains=dres, csr_factory=idx.csr_planes,
                    )
                extend.validate_backend_for_plan(self.config, plan)
                out[i] = Query(
                    pattern=patterns[i],
                    plan=plan,
                    variant=variant,
                    name=name_of(i, patterns[i]),
                    prepare_s=dom_s + (time.perf_counter() - t1),
                    index=idx,
                )
        return out  # type: ignore[return-value]

    def _coerce(self, q: Union[Query, Graph]) -> Query:
        return q if isinstance(q, Query) else self.prepare(q)

    def _coerce_all(self, queries: Iterable[Union[Query, Graph]]) -> List[Query]:
        """Coerce a mixed Query/Graph sequence; raw patterns go through the
        batched device preprocessing path in one sweep."""
        qs = list(queries)
        todo = [i for i, q in enumerate(qs) if not isinstance(q, Query)]
        if todo:
            prepared = self.prepare_batch([qs[i] for i in todo])
            for i, q in zip(todo, prepared):
                qs[i] = q
        return qs  # type: ignore[return-value]

    # -- execution ---------------------------------------------------------

    def run(self, query: Union[Query, Graph], collect_matches: int = 0) -> MatchSet:
        """Run one prepared query.

        A run whose stack high-watermark breached its ring capacity has
        undercounted, so an ``overflow`` result is never returned silently:
        the query is retried once with a doubled ``stack_cap`` (with a
        warning; ``MatchSet.retries`` records it).  If the doubled cap still
        overflows, a ``RuntimeError`` asks for an explicit budget.
        """
        query = self._coerce(query)
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
        """One engine invocation, a pack of one (no retry) or sharded over
        the mesh, or one out-of-core run."""
        extend.validate_backend_for_plan(cfg, query.plan)
        if extend.resolve_step_backend_for_plan(cfg, query.plan) == "partitioned":
            return self._run_partitioned(cfg, query)
        state = init_state(query.plan, cfg, self.device)
        return eng.result_from_state(self._run_engine(cfg, [query], state), cfg)

    def _partition_count(self, cfg: EngineConfig, plan: SearchPlan) -> int:
        """Partition count for a plan under this session: an explicit
        ``EngineConfig.n_partitions`` wins; otherwise the session's
        ``memory_budget_bytes`` derives the smallest count whose padded
        resident planes fit; otherwise 1 (the whole target resident)."""
        if cfg.n_partitions > 0:
            return cfg.n_partitions
        if self.memory_budget_bytes is not None:
            return extend.plan_partitions_budget(plan, self.memory_budget_bytes).n_parts
        return 1

    def _run_partitioned(self, cfg: EngineConfig, query: Query) -> EngineResult:
        """One out-of-core run (:func:`~repro_torch.core.engine.run_partitioned`)
        at this session's partition count, over its mesh if it has one.  It
        uploads one partition's planes per visit, never the whole target's,
        so it does not use the session's adjacency cache."""
        runc = dataclasses.replace(cfg, step_backend="partitioned",
                                   n_partitions=self._partition_count(cfg, query.plan))
        return eng.run_partitioned(query.plan, runc, mesh=self.mesh, device=self.device)

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

    def warm(
        self,
        queries: Iterable[Union[Query, Graph]],
        collect_matches: int = 0,
        lanes: int = 1,
    ) -> Dict[str, int]:
        """Pay the one-off costs of the given queries' runs up front.

        PyTorch compiles nothing, but a session's first run of a query
        pays for the upload of its index version's adjacency in the step
        layout, for loading the kernel libraries its step launches (built
        with ``nvcc`` first if the build directory lacks them) and for the
        first use of the engine's ops.  For each satisfiable query this
        uploads the adjacency through the same cache as :meth:`run_pack`
        (for a pack of ``lanes`` copies), loads on a CUDA device the
        libraries of the kernels the resolved step backend and
        ``use_pallas`` select (:func:`~repro_torch.core.extend.step_kernels`),
        and runs one **inert** pack of width ``lanes`` (zero stack sizes:
        the round loop returns at once) through the engine loop.  A
        partitioned session runs one inert single query through the
        partitioned loop instead: its runs stream partitions and use no
        session upload.  Under a mesh every query runs singly, so ``lanes``
        is ignored and the inert query goes through the sharded loop (with
        an upload to each device of the mesh).  Pass the
        ``collect_matches`` budget later submits will use, as ``repro``
        asks.

        Returns ``{"warmed": queries warmed, "uploads": fresh adjacency
        uploads spent}`` (0 uploads means everything was already warm);
        unsatisfiable queries are skipped.
        """
        before = self.uploads
        warmed = 0
        for q in self._coerce_all(queries):
            if not q.plan.satisfiable:
                continue
            cfg = self.config
            if collect_matches:
                cfg = dataclasses.replace(cfg, collect_matches=collect_matches)
            extend.validate_backend_for_plan(cfg, q.plan)
            if self.device.type == "cuda":
                kops.load_kernels(extend.step_kernels(cfg, q.plan))
            if extend.resolve_step_backend_for_plan(cfg, q.plan) == "partitioned":
                runc = dataclasses.replace(cfg, step_backend="partitioned",
                                           n_partitions=self._partition_count(cfg, q.plan))
                pp = extend.plan_partitions(q.plan, runc.n_partitions)
                arrays = {str(d): extend.make_part_plan_arrays(q.plan, pp, 0, d)
                          for d in self._devices}
                state = _inert_state(init_state(q.plan, runc, self.device))
                spill = init_spill_state(runc.n_workers, runc.resolved_spill_cap(q.plan.p_pad),
                                         q.plan.p_pad, q.plan.w, self.device)
                eng.make_partitioned_engine_fn(runc, self.mesh)(
                    arrays if self.mesh is not None else arrays[str(self.device)],
                    state, spill)
            elif self.mesh is not None:
                self._run_engine(cfg, [q], _inert_state(init_state(q.plan, cfg, self.device)))
            else:
                n = max(lanes, 1)
                arrays = self._plan_arrays([q] * n, cfg)
                state = _inert_state(init_state(q.plan, cfg, self.device))
                eng._engine_loop(cfg, arrays, stack_states([state] * n))
            warmed += 1
        return {"warmed": warmed, "uploads": self.uploads - before}

    # -- execution: delta ---------------------------------------------------

    def run_delta(
        self,
        query: Union[Query, Graph],
        old_matches,
        delta: GraphDelta,
    ) -> DeltaMatchSet:
        """Incrementally maintain ``old_matches`` across one index update.

        ``query`` must be prepared against the delta's **new** index
        version (after ``new_index, delta = index.update(...)``, call
        ``enum.prepare(pattern, index=new_index)``); ``old_matches`` is the
        prior result for the old version — a :class:`MatchSet`, an ``[M,
        n_p]`` array or a list of node-indexed mappings.  Work is restricted
        to the delta:

        * removals invalidate prior matches by membership test (no
          enumeration at all);
        * insertions are enumerated by anchoring each distinct pattern
          edge onto each compatible inserted target arc and running the
          engine from those seeds only
          (`repro_torch.core.frontier.init_delta_state`), on this session's
          step backend, deduplicated by the max-inserted-edge-index rule
          (`repro_torch.core.delta`).

        ``result.apply(old_matches)`` equals a fresh enumeration's sorted
        node-indexed mappings.
        """
        query = self._coerce(query)
        if delta.new_fingerprint and query.index_fingerprint != delta.new_fingerprint:
            raise ValueError(
                "run_delta: query is not prepared against the delta's new "
                "index version (fingerprint mismatch) — after "
                "SubgraphIndex.update(), prepare the query against the "
                "returned index"
            )
        t0 = time.perf_counter()
        removed: List[Tuple[int, ...]] = []
        if delta.removed:
            old_arr = delta_mod.as_mapping_array(old_matches)
            n_old = len(old_arr)
            removed = delta_mod.invalidated_mappings(query.pattern, old_arr, delta.removed)
        else:
            n_old = _match_count(old_matches)
        added: List[Tuple[int, ...]] = []
        states = seeds = anchors = retries = 0
        if delta.added and query.plan.satisfiable:
            for anchor, aplan in self._anchor_plans(query):
                sd, sm, sc = delta_mod.build_anchor_seeds(aplan, anchor, delta.added)
                if not sd.shape[0]:
                    continue
                anchors += 1
                seeds += int(sd.shape[0])
                rows, st, rt = self._run_seeded(query, aplan, sd, sm, sc)
                states += st
                retries += rt
                added.extend(delta_mod.filter_new_matches(
                    query.pattern, delta_mod.canonical_mappings(aplan, rows),
                    delta.added, anchor,
                ))
        return DeltaMatchSet(
            name=query.name,
            added=sorted(added),
            removed=sorted(removed),
            n_old=n_old,
            states=states,
            n_seeds=seeds,
            n_anchors=anchors,
            preprocess_s=query.prepare_s,
            match_s=time.perf_counter() - t0,
            retries=retries,
            delta=delta,
        )

    def _anchor_plans(self, query: Query) -> Iterator[Tuple[Tuple[int, int, int], SearchPlan]]:
        """``(anchor, plan)`` per distinct pattern edge triple, cached on
        the query.  Domains are ordering-independent, so one DomainResult
        (the query plan's own) is shared by every anchor plan; anchor plans
        keep the query's padding.  An edge-seeded query's plan *is* its
        seed edge's anchor plan and is reused by identity."""
        if query.index is None:
            raise ValueError(
                "run_delta needs a query bound to a SubgraphIndex "
                "(prepare it through an Enumerator / prepare_query)"
            )
        idx = query.index
        if query._anchor_domains is None:
            query._anchor_domains = query.plan.domains
        for anchor in delta_mod.pattern_edge_triples(query.pattern):
            aplan = query._anchors.get(anchor)
            if aplan is None:
                if query.plan.seed_edge == anchor:
                    aplan = query.plan
                else:
                    pa, pb, _ = anchor
                    aplan = build_plan(
                        query.pattern, idx.packed, variant=query.variant,
                        p_pad=query.plan.p_pad, max_parents=query.plan.max_parents,
                        domains=query._anchor_domains,
                        anchor=(pa,) if pa == pb else (pa, pb),
                        csr_factory=idx.csr_planes,
                    )
                query._anchors[anchor] = aplan
            yield anchor, aplan

    # first match-ring size for seeded runs; grown (pow2) if any worker's
    # per-run match count wraps its ring
    _DELTA_MCAP = 256

    def _run_seeded(
        self,
        query: Query,
        aplan: SearchPlan,
        sd: np.ndarray,
        sm: np.ndarray,
        sc: np.ndarray,
    ) -> Tuple[np.ndarray, int, int]:
        """Run the engine from delta seed entries, in worker-capacity
        chunks; returns ``(match rows in aplan position space [K, n_p],
        states, retries)``.  Seeded runs always collect matches (the delta
        result is the mappings); a run whose per-worker match count wraps
        the collect ring, or that overflows its stacks, is retried with a
        doubled ring / stack cap."""
        cfg0 = self.config
        aq = Query(
            pattern=query.pattern, plan=aplan, variant=query.variant,
            name=f"{query.name}~delta", prepare_s=0.0, index=query.index,
        )
        v = cfg0.n_workers
        cap0 = cfg0.resolved_stack_cap(aplan.p_pad)
        chunk = v * max(cap0 // 2, 1)
        rows_out: List[np.ndarray] = []
        states = retries = 0
        for j in range(0, int(sd.shape[0]), chunk):
            cs, cm, cc = sd[j:j + chunk], sm[j:j + chunk], sc[j:j + chunk]
            # start from the largest ring any earlier seeded run needed
            mcap = max(self._DELTA_MCAP, self._delta_mcap)
            cap = cap0
            while True:
                cfg = dataclasses.replace(cfg0, collect_matches=mcap, stack_cap=cap)
                state = init_delta_state(aplan, cfg, cs, cm, cc, self.device)
                res = eng.result_from_state(self._run_engine(cfg, [aq], state), cfg)
                if res.overflow:
                    if cap >= cap0 * 4:
                        raise RuntimeError(
                            f"delta run for {query.name!r} still overflows "
                            f"at stack_cap={cap} — set an explicit "
                            "EngineConfig.stack_cap budget"
                        )
                    cap *= 2
                    retries += 1
                    continue
                pw = res.per_worker_matches
                top = int(np.max(pw)) if pw is not None and pw.size else res.matches
                if top > mcap:
                    mcap = 1 << (top - 1).bit_length()
                    self._delta_mcap = max(self._delta_mcap, mcap)
                    retries += 1
                    continue
                break
            states += res.states
            if res.match_buf is not None and res.matches:
                rows = res.match_buf.reshape(-1, res.match_buf.shape[-1])
                valid = (rows[:, : aplan.n_p] >= 0).all(axis=1)
                rows_out.append(rows[valid][:, : aplan.n_p])
        if rows_out:
            return np.concatenate(rows_out, axis=0), states, retries
        return np.zeros((0, aplan.n_p), dtype=np.int32), states, retries

    # -- execution: packs ---------------------------------------------------

    def coalesce_key(self, query: Query, cfg: Optional[EngineConfig] = None) -> tuple:
        """The pack-compatibility key of a query: queries with equal keys
        stack lane for lane into one pack (same tensor shapes, one target).
        ``stream``/``run_batch`` group by it.

        The key is the shape bucket ``(p_pad, max_parents, n_t, w,
        n_elab)`` plus the query's index fingerprint — queries against
        different contents never share a pack, since a pack reads one
        adjacency.  Under the csr backend (as ``cfg``, default the
        session's, resolves it) it also carries the plan's padded CSR shape
        (:func:`~repro_torch.core.extend.csr_shape_bucket`), and under the
        partitioned backend its partition identity
        (:func:`~repro_torch.core.extend.partitioned_shape_bucket`), as in
        ``repro``.
        """
        cfg = cfg or self.config
        key = query.bucket + (query.index_fingerprint,)
        resolved = extend.resolve_step_backend_for_plan(cfg, query.plan)
        if resolved == "csr":
            key = key + extend.csr_shape_bucket(query.plan)
        elif resolved == "partitioned":
            key = key + extend.partitioned_shape_bucket(
                query.plan, self._partition_count(cfg, query.plan))
        return key

    def run_pack(
        self,
        queries: Sequence[Union[Query, Graph]],
        pack_size: Optional[int] = None,
        cfg: Optional[EngineConfig] = None,
    ) -> List[MatchSet]:
        """Execute queries that share one :meth:`coalesce_key` as packs of
        ``pack_size`` lanes, returning one :class:`MatchSet` per query in
        input order (``query_index`` is the input position).

        No grouping or balancing — the caller has already decided the
        pack; mixed keys raise.  Unsatisfiable queries get empty results
        without touching the engine.  ``cfg`` overrides the session config;
        overflowed lanes go through the doubled-``stack_cap`` single retry.
        Under the partitioned backend or a mesh the queries run one by one.
        """
        cfg = cfg or self.config
        qs = self._coerce_all(queries)
        pack_size = pack_size or max(len(qs), 1)
        out: List[Optional[MatchSet]] = [None] * len(qs)
        live: List[int] = []
        for i, q in enumerate(qs):
            if q.plan.satisfiable:
                live.append(i)
            else:
                out[i] = self._matchset(q, i, _empty_engine_result(), 0.0)
        if live:
            keys = {self.coalesce_key(qs[i], cfg) for i in live}
            if len(keys) > 1:
                raise ValueError(
                    f"run_pack requires one coalesce_key per pack, got {len(keys)}: "
                    f"{sorted(keys)}"
                )
            if self.mesh is not None or cfg.step_backend == "partitioned":
                # the sharded loop and the host partition-scheduling loop
                # run one query at a time
                for i in live:
                    out[i] = self.run(qs[i], collect_matches=cfg.collect_matches)
                    out[i].query_index = i
            else:
                for j in range(0, len(live), pack_size):
                    for ms in self._run_pack(live[j:j + pack_size], qs, cfg, pack_size):
                        out[ms.query_index] = ms
        return out  # type: ignore[return-value]

    def stream(
        self,
        queries: Iterable[Union[Query, Graph]],
        pack_size: int = 4,
    ) -> Iterator[MatchSet]:
        """Yield one :class:`MatchSet` per query as packs drain.

        Queries are grouped by :meth:`coalesce_key`, LPT-balanced into packs
        of ``pack_size`` (padded with inert lanes, as in ``repro``), and run
        pack by pack; each finished pack yields its results at once.
        ``MatchSet.query_index`` carries the position in the input.  Under
        the partitioned backend or a mesh each query runs singly, in input
        order.
        """
        qs: List[Query] = self._coerce_all(queries)
        cfg = self.config
        if self.mesh is not None or cfg.step_backend == "partitioned":
            for i, q in enumerate(qs):
                if not q.plan.satisfiable:
                    yield self._matchset(q, i, _empty_engine_result(), 0.0)
                else:
                    ms = self.run(q)
                    ms.query_index = i
                    yield ms
            return
        groups: Dict[tuple, List[int]] = {}
        for i, q in enumerate(qs):
            if not q.plan.satisfiable:
                yield self._matchset(q, i, _empty_engine_result(), 0.0)
            else:
                groups.setdefault(self.coalesce_key(q, cfg), []).append(i)

        for idxs in groups.values():
            weights = [_predict_work(qs[i].plan) for i in idxs]
            n_packs = max(1, (len(idxs) + pack_size - 1) // pack_size)
            assignment = balance_assignment(weights, n_packs)
            for pack_id in range(n_packs):
                members = [i for i, a in zip(idxs, assignment) if a == pack_id]
                # LPT balances weight, not count: an overloaded pack is split
                # into pack_size chunks
                for j in range(0, len(members), pack_size):
                    yield from self._run_pack(members[j:j + pack_size], qs, cfg, pack_size)

    def run_batch(
        self,
        queries: Sequence[Union[Query, Graph]],
        pack_size: int = 4,
    ) -> List[MatchSet]:
        """Run a batch of queries; exactly one result per query, in order."""
        queries = list(queries)
        out: List[Optional[MatchSet]] = [None] * len(queries)
        for ms in self.stream(queries, pack_size=pack_size):
            out[ms.query_index] = ms
        return out  # type: ignore[return-value]

    def _run_pack(
        self, members: List[int], qs: List[Query], cfg: EngineConfig, pack_size: int
    ) -> Iterator[MatchSet]:
        """Run one pack of same-key queries, padded to ``pack_size`` lanes
        with inert ones (no work: frozen from the first round), and yield
        its results.  Every step of the pack launches one kernel for all
        its lanes."""
        t0 = time.perf_counter()
        pack = [qs[i] for i in members]
        for q in pack:
            extend.validate_backend_for_plan(cfg, q.plan)
        arrays = self._plan_arrays(pack + [pack[0]] * (pack_size - len(pack)), cfg)
        states = [init_state(q.plan, cfg, self.device) for q in pack]
        states += [_inert_state(states[0])] * (pack_size - len(pack))
        final = eng._engine_loop(cfg, arrays, stack_states(states))
        match_s = (time.perf_counter() - t0) / max(len(members), 1)
        for lane, i in enumerate(members):
            res = eng.result_from_state(final, cfg, lane)
            if res.overflow:
                # the pack undercounted this lane; go straight to the
                # doubled-stack_cap single retry (re-running at the original
                # cap would overflow again)
                res = self._retry_overflowed(cfg, qs[i])
                yield self._matchset(qs[i], i, res, match_s, retries=1)
                continue
            yield self._matchset(qs[i], i, res, match_s)

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


def _predict_work(plan: SearchPlan) -> float:
    """Cheap work proxy: product of the first few domain sizes (the weight
    of LPT pack balancing)."""
    sizes = popcount(plan.dom_bits[: min(plan.n_p, 4)])
    return float(np.prod(np.maximum(sizes, 1), dtype=np.float64))


def _inert_state(template: EngineState) -> EngineState:
    """A copy of ``template`` with no work: size 0, empty candidate bitmaps.
    It pads a pack to its lane count; the round loop freezes such a lane
    before its first step."""
    return template._replace(
        size=torch.zeros_like(template.size),
        st_cand=torch.zeros_like(template.st_cand),
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
