"""Sequential reference oracle for subgraph enumeration.

:func:`ref_enumerate` is a recursive RI/RI-DS search over a
:class:`~repro_torch.core.plan.SearchPlan` with plain Python sets (a copy
of ``repro.core.ref.ref_enumerate`` for dense and CSR-only plans).  Its ``states``
counter is the paper's search-space metric: a state is counted each time a
consistent extension ``M ∪ {μ_d → v}`` is formed.  The engine must agree
with it on both matches and states.

:func:`ref_delta` is the incremental oracle (a copy of ``repro``'s): it
replays an edit one inserted arc at a time through full re-enumerations,
independently of the anchored engine path of ``Enumerator.run_delta``.

:func:`ref_enumerate_partitioned` is the out-of-core oracle (a copy of
``repro``'s): a sequential mirror of ``engine.run_partitioned``'s
scheduling loop, whose matches and states equal :func:`ref_enumerate`'s and
whose ``visits`` / ``spilled`` / ``dead_spills`` the engine's statistics
must equal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph, PackedGraph, bitmap_to_indices
from repro_torch.core.plan import SearchPlan, build_plan


def _adjacency(plan: SearchPlan):
    """``adj(elab, dir, t)``: target row ``t`` of the plan's adjacency plane
    as a set, cached per row."""
    adj_sets = {}

    def adj(lab: int, d: int, t: int) -> set:
        key = (lab, d, t)
        if key not in adj_sets:
            if plan.csr is not None and plan.adj_bits.shape[2] == 0:
                # CSR-only plan (build_csr_plan): read the adjacency plane's row
                ptr = plan.csr.indptr[lab * 2 + d]
                adj_sets[key] = set(plan.csr.indices[ptr[t]:ptr[t + 1]].tolist())
            else:
                adj_sets[key] = set(bitmap_to_indices(plan.adj_bits[lab, d, t]).tolist())
        return adj_sets[key]

    return adj


@dataclasses.dataclass
class RefResult:
    matches: int
    states: int
    mappings: Optional[List[Tuple[int, ...]]] = None  # order-position -> target


def ref_enumerate(
    pattern: Graph,
    target: Graph,
    variant: str = "ri-ds-si-fc",
    packed: Optional[PackedGraph] = None,
    plan: Optional[SearchPlan] = None,
    record_mappings: bool = False,
    max_states: Optional[int] = None,
) -> RefResult:
    """Sequential reference RI/RI-DS enumeration over a SearchPlan.

    Semantics match the vectorized engine exactly: per position, candidates
    are ``domain ∧ ¬used ∧ (adjacency rows of mapped parents)``; every
    candidate accepted increments ``states``; full-depth candidates are
    matches.
    """
    if plan is None:
        packed = packed or PackedGraph.from_graph(target)
        plan = build_plan(pattern, packed, variant=variant)
    if not plan.satisfiable or pattern.n == 0:
        return RefResult(matches=0, states=0, mappings=[] if record_mappings else None)

    n_p = plan.n_p
    dom = [set(bitmap_to_indices(plan.dom_bits[i]).tolist()) for i in range(n_p)]
    adj = _adjacency(plan)

    mapping = [-1] * n_p
    used = set()
    out = RefResult(matches=0, states=0, mappings=[] if record_mappings else None)

    def candidates(pos: int) -> List[int]:
        cand = dom[pos] - used
        for j in range(int(plan.n_parents[pos])):
            pp = int(plan.parent_pos[pos, j])
            pd = int(plan.parent_dir[pos, j])
            pl = int(plan.parent_elab[pos, j])
            cand = cand & adj(pl, pd, mapping[pp])
            if not cand:
                break
        return sorted(cand)

    def rec(pos: int) -> None:
        if max_states is not None and out.states >= max_states:
            return
        for v in candidates(pos):
            out.states += 1
            if pos == n_p - 1:
                out.matches += 1
                if record_mappings:
                    out.mappings.append(tuple(mapping[:pos] + [v]))
            else:
                mapping[pos] = v
                used.add(v)
                rec(pos + 1)
                used.discard(v)
                mapping[pos] = -1
            if max_states is not None and out.states >= max_states:
                return

    rec(0)
    return out


# ---------------------------------------------------------------------------
# out-of-core partitioned oracle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefPartitionedResult:
    """Sequential mirror of the out-of-core scheduling loop: match and state
    counts equal :func:`ref_enumerate`'s (partitioning changes scheduling,
    never the search tree), and the spill accounting is an independent
    model of the engine's statistics."""

    matches: int
    states: int
    mappings: Optional[List[Tuple[int, ...]]] = None
    n_parts: int = 1
    visits: int = 0  # partition swap-ins (first residency included)
    spilled: int = 0  # children parked for a non-resident partition
    dead_spills: int = 0  # spilled entries whose candidates died at intake


def ref_enumerate_partitioned(
    pattern: Graph,
    target: Graph,
    n_parts: int,
    variant: str = "ri-ds-si-fc",
    packed: Optional[PackedGraph] = None,
    plan: Optional[SearchPlan] = None,
    record_mappings: bool = False,
) -> RefPartitionedResult:
    """Sequential oracle for partitioned enumeration.

    Mirrors the engine's outer scheduling loop: target rows are partitioned
    by the same degree-balanced partitioner
    (`repro_torch.core.extend.plan_partitions`); only the resident
    partition's adjacency rows may be read; a child whose candidate set
    survives its resident parents but still owes intersections to
    non-resident parents is parked in the pool of its first pending
    parent's partition; the resident partition is enumerated to
    quiescence, then the deepest pool's partition is swapped in and its
    entries finish constraining at intake (dead / re-spill / resume).
    Because only fully constrained entries are ever extended, ``matches``
    and ``states`` are those of the monolithic :func:`ref_enumerate`, while
    ``visits`` / ``spilled`` / ``dead_spills`` model the scheduling itself.
    """
    from repro_torch.core.extend import plan_partitions

    if plan is None:
        packed = packed or PackedGraph.from_graph(target)
        plan = build_plan(pattern, packed, variant=variant)
    out = RefPartitionedResult(
        matches=0, states=0, mappings=[] if record_mappings else None,
        n_parts=max(1, n_parts),
    )
    if not plan.satisfiable or pattern.n == 0:
        return out
    pp = plan_partitions(plan, max(1, n_parts))
    node_start = pp.node_start
    n_p = plan.n_p
    dom = [set(bitmap_to_indices(plan.dom_bits[i]).tolist()) for i in range(n_p)]
    adj = _adjacency(plan)

    def part_of(t: int) -> int:
        return int(np.searchsorted(node_start, t, side="right") - 1)

    # per-partition pools of parked entries (pos, mapping, cand, pending
    # parent slots): the host-side image of the engine's spill rings
    pools: List[List[tuple]] = [[] for _ in range(pp.n_parts)]
    lo = hi = 0  # resident row range

    def expand(pos: int, mapping: List[int], cand: set) -> None:
        """Depth-first search of a fully constrained entry within the
        resident partition."""
        for v in sorted(cand):
            out.states += 1
            if pos == n_p - 1:
                out.matches += 1
                if record_mappings:
                    out.mappings.append(tuple(mapping + [v]))
                continue
            m2 = mapping + [v]
            used = set(m2)
            cpos = pos + 1
            cand2 = dom[cpos] - used
            pend: List[int] = []
            for j in range(int(plan.n_parents[cpos])):
                if not cand2:
                    break
                t = m2[int(plan.parent_pos[cpos, j])]
                if lo <= t < hi:
                    cand2 = cand2 & adj(
                        int(plan.parent_elab[cpos, j]),
                        int(plan.parent_dir[cpos, j]), t,
                    )
                else:
                    pend.append(j)
            if not cand2:
                continue
            if pend:
                out.spilled += 1
                tgt = part_of(m2[int(plan.parent_pos[cpos, pend[0]])])
                pools[tgt].append((cpos, m2, cand2, tuple(pend)))
            else:
                expand(cpos, m2, cand2)

    # roots prefill the pools per owning partition, as
    # engine.partition_root_entries does
    for pid in range(pp.n_parts):
        plo, phi = int(node_start[pid]), int(node_start[pid + 1])
        rcand = {t for t in dom[0] if plo <= t < phi}
        if rcand:
            pools[pid].append((0, [], rcand, ()))

    cur = next((pid for pid in range(pp.n_parts) if pools[pid]), None)
    while cur is not None:
        lo, hi = int(node_start[cur]), int(node_start[cur + 1])
        out.visits += 1
        while pools[cur]:
            pos, m2, cand2, pend = pools[cur].pop()
            npend: List[int] = []
            for j in pend:
                if not cand2:
                    break
                t = m2[int(plan.parent_pos[pos, j])]
                if lo <= t < hi:
                    cand2 = cand2 & adj(
                        int(plan.parent_elab[pos, j]),
                        int(plan.parent_dir[pos, j]), t,
                    )
                else:
                    npend.append(j)
            if not cand2:
                out.dead_spills += 1
                continue
            if npend:
                tgt = part_of(m2[int(plan.parent_pos[pos, npend[0]])])
                pools[tgt].append((pos, m2, cand2, tuple(npend)))
                continue
            expand(pos, m2, cand2)
        nxt, depth_best = None, 0
        for pid in range(pp.n_parts):
            if len(pools[pid]) > depth_best:
                nxt, depth_best = pid, len(pools[pid])
        if nxt is None:
            break
        cur = nxt
    if record_mappings:
        out.mappings.sort()
    return out


# ---------------------------------------------------------------------------
# incremental oracle
# ---------------------------------------------------------------------------

def ref_node_mappings(
    pattern: Graph, target: Graph, variant: str = "ri-ds-si-fc"
) -> List[Tuple[int, ...]]:
    """Sorted node-indexed mappings (``m[pattern_node] = target_node``) of a
    full sequential enumeration — the ordering-independent form delta
    results are compared in."""
    packed = PackedGraph.from_graph(target)
    plan = build_plan(pattern, packed, variant=variant)
    res = ref_enumerate(
        pattern, target, variant=variant, packed=packed, plan=plan,
        record_mappings=True,
    )
    order = [int(x) for x in plan.order[: plan.n_p]]
    out = []
    for row in res.mappings:
        nm = [0] * len(order)
        for i, t in enumerate(row):
            nm[order[i]] = int(t)
        out.append(tuple(nm))
    return sorted(out)


@dataclasses.dataclass
class RefDeltaResult:
    """Incremental-oracle result: sorted node-indexed mapping sets."""

    added: List[Tuple[int, ...]]
    removed: List[Tuple[int, ...]]
    n_old: int

    @property
    def matches(self) -> int:
        return self.n_old - len(self.removed) + len(self.added)


def ref_delta(
    pattern: Graph,
    old_target: Graph,
    added=(),
    removed=(),
    variant: str = "ri-ds-si-fc",
) -> RefDeltaResult:
    """Incremental enumeration oracle, independent of the anchored engine
    path: removals invalidate old matches by arc-membership test; then the
    effective insertions are replayed **one arc at a time** on the growing
    graph, fully re-enumerating at each step and crediting each match to
    the step whose arc it uses (a match needing arc ``i`` cannot exist
    before step ``i``, so this partitions the new matches exactly).
    Mirrors ``SubgraphIndex.update``'s set semantics: insert∩remove of one
    arc cancels, duplicate inserts and removals of absent arcs drop out.
    """
    from repro_torch.core.delta import apply_delta, normalize_edges, pattern_edge_triples

    adds = normalize_edges(added)
    rems = normalize_edges(removed)
    cancel = set(adds) & set(rems)
    old_arcs = set(
        zip(
            old_target.src.tolist(),
            old_target.dst.tolist(),
            old_target.edge_labels.tolist(),
        )
    )
    eff_add = tuple(t for t in adds if t not in cancel and t not in old_arcs)
    eff_rem = tuple(t for t in rems if t not in cancel and t in old_arcs)

    old_maps = ref_node_mappings(pattern, old_target, variant)
    pe = pattern_edge_triples(pattern)
    rset = set(eff_rem)
    removed_maps = [
        m for m in old_maps if any((m[u], m[v], l) in rset for (u, v, l) in pe)
    ]

    g = apply_delta(old_target, removed=eff_rem)
    added_maps: List[Tuple[int, ...]] = []
    for arc in eff_add:
        g = apply_delta(g, added=[arc])
        added_maps.extend(
            m
            for m in ref_node_mappings(pattern, g, variant)
            if any((m[u], m[v], l) == arc for (u, v, l) in pe)
        )
    return RefDeltaResult(
        added=sorted(added_maps), removed=removed_maps, n_old=len(old_maps)
    )
