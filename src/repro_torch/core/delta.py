"""Delta algebra for incremental enumeration over dynamic graphs.

A copy of ``repro.core.delta`` (host numpy).  The paper's targets
(biochemical / social networks) change; Das et al. (arXiv 1807.09417 /
2001.11433) maintain enumerations under edge edit streams instead of
recomputing.  This module holds the host-side pieces of that machinery:

* :class:`GraphDelta` — the *effective* edit set of one
  ``SubgraphIndex.update()`` call: added / removed ``(u, v, elab)`` arc
  triples after insert∩remove cancellation and no-op filtering, plus the
  version/fingerprint pair tying it to exactly one index transition.
* :func:`apply_delta` — set-semantics host-graph edit (the test/oracle
  twin of the index's bitmap patching).
* :func:`build_anchor_seeds` — edge-centric seeding: for an anchor pattern
  edge ``(pa, pb, l)`` and its anchor plan (ordering forced to start
  ``pa, pb``), every compatible inserted target edge becomes one engine
  seed entry whose candidate bitmap is pinned to the edge's head.
* :func:`filter_new_matches` — the max-inserted-edge-index dedup rule: a
  new match is credited to exactly one (anchor, inserted-edge) pair — the
  highest-indexed inserted edge it uses — which is equivalent to
  enumerating the insertions one at a time on the growing graph.
* :class:`DeltaMatchSet` — the result of ``Enumerator.run_delta``:
  invalidated old mappings + new mappings, with ``apply()`` producing the
  full post-update match list that a fresh enumeration must equal.

Mappings here are **node-indexed** (``m[pattern_node] = target_node``),
not ordering-position-indexed: anchor plans use per-anchor orderings, so
position space is not comparable across plans.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.graph import Graph, WORD_BITS, bitmap_from_indices
from repro_torch.core.plan import SearchPlan

EdgeTriple = Tuple[int, int, int]  # (src, dst, edge_label)


def normalize_edges(
    edges: Iterable[Union[Tuple[int, int], EdgeTriple]],
) -> Tuple[EdgeTriple, ...]:
    """Canonicalize an edit list to sorted, distinct ``(u, v, elab)`` arc
    triples (2-tuples get edge label 0).  Arcs are directed: an undirected
    edit must pass both ``(u, v)`` and ``(v, u)``."""
    out = set()
    for e in edges:
        if len(e) == 2:
            u, v = e
            l = 0
        else:
            u, v, l = e
        out.add((int(u), int(v), int(l)))
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """The effective edit set of one index update.

    ``added`` / ``removed`` hold only arcs that actually changed the edge
    set: insert∩remove of the same arc in one update cancels, duplicate
    inserts and removals of absent arcs drop out.  The version/fingerprint
    pairs pin the delta to exactly one ``old index → new index``
    transition — ``Enumerator.run_delta`` refuses a query prepared against
    any other version.
    """

    added: Tuple[EdgeTriple, ...]
    removed: Tuple[EdgeTriple, ...]
    old_version: int
    new_version: int
    old_fingerprint: str
    new_fingerprint: str

    @property
    def is_empty(self) -> bool:
        return not self.added and not self.removed


def apply_delta(
    g: Graph,
    added: Iterable[EdgeTriple] = (),
    removed: Iterable[EdgeTriple] = (),
) -> Graph:
    """Set-semantics edit of a host :class:`Graph`: the distinct arc-triple
    set minus ``removed`` plus ``added``; nodes and node labels unchanged.
    The host twin of the index's bitmap patching — conformance tests build
    the "fresh recompute" side with this."""
    triples = set(zip(g.src.tolist(), g.dst.tolist(), g.edge_labels.tolist()))
    triples -= set(normalize_edges(removed))
    triples |= set(normalize_edges(added))
    es = sorted(triples)
    return Graph.from_edges(
        g.n,
        [(u, v) for (u, v, _) in es],
        labels=g.labels,
        edge_labels=[l for (_, _, l) in es],
    )


# ---------------------------------------------------------------------------
# mappings: canonical node-indexed form, invalidation, dedup
# ---------------------------------------------------------------------------

def pattern_edge_triples(pattern: Graph) -> Tuple[EdgeTriple, ...]:
    """Distinct ``(pa, pb, elab)`` arc triples of the pattern, sorted."""
    return tuple(sorted(set(
        zip(pattern.src.tolist(), pattern.dst.tolist(), pattern.edge_labels.tolist())
    )))


def as_node_mappings(old) -> List[Tuple[int, ...]]:
    """Coerce prior matches to node-indexed tuples.

    Accepts a ``MatchSet`` (position-indexed ``mappings()`` are permuted
    through its ``plan.order``), a ``[M, n_p]`` array, or an iterable of
    node-indexed tuples."""
    if hasattr(old, "mappings") and hasattr(old, "plan"):
        order = [int(x) for x in old.plan.order[: old.plan.n_p]]
        out = []
        for row in old.mappings():
            nm = [0] * len(order)
            for i, t in enumerate(row):
                nm[order[i]] = int(t)
            out.append(tuple(nm))
        return out
    if isinstance(old, np.ndarray):
        return [tuple(r) for r in old.tolist()]
    if isinstance(old, list) and all(isinstance(m, tuple) for m in old):
        return old  # already node-indexed int tuples: no per-element coercion
    return [tuple(int(x) for x in m) for m in old]


def as_mapping_array(old) -> np.ndarray:
    """Array twin of :func:`as_node_mappings`: ``[M, n_p]`` int64 rows.

    The maintained-set hot path (``Enumerator.run_delta`` over a long edit
    stream) keeps prior matches in this form so invalidation is pure numpy
    with no per-tuple coercion; an empty input yields ``[0, 0]``."""
    if isinstance(old, np.ndarray):
        return np.ascontiguousarray(old, dtype=np.int64)
    maps = as_node_mappings(old)
    if not maps:
        return np.zeros((0, 0), dtype=np.int64)
    return np.asarray(maps, dtype=np.int64)


def invalidated_mappings(
    pattern: Graph,
    old_maps: Sequence[Tuple[int, ...]],
    removed: Iterable[EdgeTriple],
) -> List[Tuple[int, ...]]:
    """Old matches killed by the removals: a match dies iff some pattern
    edge's image ``(m[pa], m[pb], l)`` is a removed arc (membership test —
    no re-enumeration; non-induced semantics make this exact).  Vectorized
    over the match set: one ``isin`` per pattern edge on integer-encoded
    arcs, so a step over a large maintained set stays O(|old| · m_p) numpy
    work rather than python tuple hashing."""
    rem = sorted(set(removed))
    if not rem or not len(old_maps):
        return []
    pe = pattern_edge_triples(pattern)
    M = np.asarray(old_maps, dtype=np.int64)
    # encode (u, v, l) injectively: base strictly above every value seen
    B = int(max(
        M.max(),
        max(x for t in rem for x in t),
        max(l for (_, _, l) in pe),
    )) + 2
    rem_codes = np.asarray([(u * B + v) * B + l for (u, v, l) in rem],
                           dtype=np.int64)
    kill = np.zeros(len(M), dtype=bool)
    for (u, v, l) in pe:
        kill |= np.isin((M[:, u] * B + M[:, v]) * B + l, rem_codes)
    return [tuple(r) for r in M[kill].tolist()]


def filter_new_matches(
    pattern: Graph,
    node_maps: Sequence[Tuple[int, ...]],
    added: Sequence[EdgeTriple],
    anchor: EdgeTriple,
) -> List[Tuple[int, ...]]:
    """The max-inserted-edge-index dedup rule.

    A new match may use several inserted arcs and is found once per
    (anchor pattern edge, inserted arc) pair; keep it only in the run
    whose anchor image is the **highest-indexed** inserted arc it uses.
    Injectivity makes pattern-edge images distinct, so exactly one pair
    wins — equivalent to inserting the arcs one at a time and counting
    matches new at each step (Das et al.'s edge-at-a-time view).
    """
    aidx = {t: i for i, t in enumerate(added)}
    pe = pattern_edge_triples(pattern)
    pa, pb, al = anchor
    kept = []
    for m in node_maps:
        ai = aidx.get((m[pa], m[pb], al))
        if ai is None:
            continue  # anchor image not inserted (cannot happen for seeds)
        used = [aidx[img] for (u, v, l) in pe if (img := (m[u], m[v], l)) in aidx]
        if ai == max(used):
            kept.append(m)
    return kept


def canonical_mappings(
    plan: SearchPlan, rows: np.ndarray
) -> List[Tuple[int, ...]]:
    """Position-indexed match-buffer rows ``[K, >=n_p]`` → node-indexed
    tuples via the plan's ordering."""
    order = [int(x) for x in plan.order[: plan.n_p]]
    out = []
    for row in np.asarray(rows):
        nm = [0] * len(order)
        for i in range(len(order)):
            nm[order[i]] = int(row[i])
        out.append(tuple(nm))
    return out


# ---------------------------------------------------------------------------
# edge-centric seeding
# ---------------------------------------------------------------------------

def _bit(bits: np.ndarray, v: int) -> bool:
    return bool((int(bits[v // WORD_BITS]) >> (v % WORD_BITS)) & 1)


def build_anchor_seeds(
    plan: SearchPlan,
    anchor: EdgeTriple,
    added: Sequence[EdgeTriple],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Engine seeds pinning anchor pattern edge ``(pa, pb, l)`` onto each
    compatible inserted arc.

    ``plan`` must be the anchor plan: ordering starts ``pa, pb`` (just
    ``pa`` for a self-loop anchor).  Per inserted arc ``(tu, tv, l)``:

    * non-loop anchor — a depth-1 entry mapping position 0 to ``tu`` whose
      candidate bitmap is ``{tv}``, emitted iff ``tu`` passes the position-0
      candidate check and ``tv`` the position-1 check (the engine trusts
      stored candidate bits, so seeds are pre-validated with
      `repro_torch.core.extend.host_cand_bitmap` — exactly the engine's formula,
      anchor-edge adjacency included);
    * self-loop anchor (``pa == pb``, needs ``tu == tv``) — a depth-0
      entry with candidate ``{tu}`` ∩ the position-0 check.

    Returns ``(depth [K], map [K, p_pad], cand [K, w])``.
    """
    from repro_torch.core.extend import host_cand_bitmap

    pa, pb, al = anchor
    p_pad, w, n_t = plan.p_pad, plan.w, plan.n_t
    empty = np.full(p_pad, -1, dtype=np.int32)
    depths: List[int] = []
    maps: List[np.ndarray] = []
    cands: List[np.ndarray] = []
    if plan.satisfiable:
        loop = pa == pb
        assert int(plan.order[0]) == pa, "anchor plan must order pa first"
        if not loop:
            assert int(plan.order[1]) == pb, "anchor plan must order pb second"
        cand0 = host_cand_bitmap(plan, 0, empty)
        for (tu, tv, tl) in added:
            if tl != al:
                continue
            if loop:
                if tu != tv or not _bit(cand0, tu):
                    continue
                depths.append(0)
                maps.append(empty)
                cands.append(bitmap_from_indices(np.array([tu]), n_t, w))
            else:
                if tu == tv or not _bit(cand0, tu):
                    continue
                m = empty.copy()
                m[0] = tu
                if not _bit(host_cand_bitmap(plan, 1, m), tv):
                    continue
                depths.append(1)
                maps.append(m)
                cands.append(bitmap_from_indices(np.array([tv]), n_t, w))
    if not depths:
        return (
            np.zeros(0, dtype=np.int32),
            np.zeros((0, p_pad), dtype=np.int32),
            np.zeros((0, w), dtype=np.uint32),
        )
    return (
        np.asarray(depths, dtype=np.int32),
        np.stack(maps).astype(np.int32),
        np.stack(cands).astype(np.uint32),
    )


# ---------------------------------------------------------------------------
# DeltaMatchSet — the run_delta result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeltaMatchSet:
    """Result of ``Enumerator.run_delta``: the match-set *difference*.

    ``added`` / ``removed`` are sorted node-indexed mappings; ``matches``
    is the post-update total; :meth:`apply` materializes the post-update
    match list from the prior one (the ``old ⊕ delta`` side of the
    identity ``full(G±e) == old ⊕ delta(±e)``).
    """

    name: str
    added: List[Tuple[int, ...]]
    removed: List[Tuple[int, ...]]
    n_old: int
    states: int
    n_seeds: int
    n_anchors: int
    preprocess_s: float
    match_s: float
    retries: int = 0
    delta: Optional[GraphDelta] = None

    @property
    def matches(self) -> int:
        return self.n_old - len(self.removed) + len(self.added)

    def apply(self, old) -> List[Tuple[int, ...]]:
        """Post-update node-indexed match list: old minus invalidated plus
        new, sorted."""
        rm = set(self.removed)
        out = [m for m in as_node_mappings(old) if m not in rm]
        out.extend(self.added)
        return sorted(out)

    def apply_array(self, old: np.ndarray) -> np.ndarray:
        """Array twin of :meth:`apply`: lexicographically sorted
        ``[M, n_p]`` int64 rows, kept vectorized so a long edit stream can
        maintain a large match set without per-step tuple churn."""
        old = as_mapping_array(old)
        n_p = old.shape[1] if old.size else (
            len(self.added[0]) if self.added else len(self.removed[0])
        )
        if self.removed and len(old):
            rm = np.asarray(self.removed, dtype=np.int64)
            kill = np.zeros(len(old), dtype=bool)
            for r in rm:  # |removed| is delta-sized; each test is one pass
                kill |= (old == r).all(axis=1)
            old = old[~kill]
        parts = [old.reshape(-1, n_p)]
        if self.added:
            parts.append(np.asarray(self.added, dtype=np.int64))
        out = np.concatenate(parts, axis=0)
        return out[np.lexsort(out.T[::-1])] if len(out) else out
