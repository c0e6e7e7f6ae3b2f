"""RI static node ordering (GreatestConstraintFirst) with the paper's
domain-size tie-breaking (RI-DS-SI).

RI orders the pattern nodes *before* the search so that each node visited is
maximally constrained by already-ordered nodes.  The greedy criteria, applied
lexicographically when selecting the next node ``u`` among the unordered:

  1. ``w_m(u)`` — number of ``u``'s neighbors already in the ordering
     (the paper's "number of neighbors in the partial ordering").
  2. ``w_n(u)`` — number of ``u``'s unordered neighbors that are themselves
     neighbors of ordered nodes ("nodes in the ordering reachable via nodes
     not in the ordering").
  3. ``deg(u)`` — total degree.
  4. **SI tie-break (this paper, §4.2.1)**: smaller domain first.  This is the
     constraint-first principle continued: among otherwise identical nodes,
     the one with fewer candidate target nodes is more constrained.

The first node is the one with maximum degree (domain-size tie-broken under
SI).  Neighborhoods are undirected unions of in- and out-neighbors, matching
the RI reference implementation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import CsrPlanes, Graph, deg_bucket_caps, deg_bucket_index


@dataclasses.dataclass(frozen=True)
class Ordering:
    """A static search order over pattern nodes.

    Attributes:
      order: ``[n_p]`` pattern node ids, ``order[i]`` is searched at depth i.
      parents: per position ``i``, a list of ``(pos_j, direction, edge_label)``
        triples — one per pattern edge between ``order[i]`` and an
        earlier-ordered node ``order[pos_j]``.  ``direction == 0`` means the
        pattern edge is ``(order[pos_j] -> order[i])`` (check the target
        out-row of the mapped parent), ``1`` means ``(order[i] ->
        order[pos_j])`` (check the target in-row).
    """

    order: np.ndarray
    parents: Tuple[Tuple[Tuple[int, int, int], ...], ...]

    @property
    def n(self) -> int:
        return int(self.order.shape[0])

    @property
    def max_parents(self) -> int:
        return max((len(p) for p in self.parents), default=0)

    def parent_arrays(self, max_parents: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Dense ``(parent_pos, parent_dir, parent_elab, n_parents)`` arrays,
        padded with ``parent_pos == -1``."""
        mp = max(1, max_parents or self.max_parents, self.max_parents)
        n = self.n
        pos = np.full((n, mp), -1, dtype=np.int32)
        dr = np.zeros((n, mp), dtype=np.int32)
        el = np.zeros((n, mp), dtype=np.int32)
        cnt = np.zeros((n,), dtype=np.int32)
        for i, plist in enumerate(self.parents):
            cnt[i] = len(plist)
            for j, (p, d, l) in enumerate(plist):
                pos[i, j], dr[i, j], el[i, j] = p, d, l
        return pos, dr, el, cnt


def _neighbor_sets(g: Graph) -> List[set]:
    nbr = [set() for _ in range(g.n)]
    for u, v in zip(g.src.tolist(), g.dst.tolist()):
        if u != v:
            nbr[u].add(v)
            nbr[v].add(u)
    return nbr


def greatest_constraint_first(
    pattern: Graph,
    domain_sizes: Optional[np.ndarray] = None,
    singleton_first: bool = False,
    seed_order: Optional[Tuple[int, ...]] = None,
) -> Ordering:
    """Compute the RI (GreatestConstraintFirst) ordering.

    Args:
      pattern: the pattern graph.
      domain_sizes: optional ``[n_p]`` candidate-set sizes.  When given, ties
        on ``(w_m, w_n, deg)`` are broken in favor of the smaller domain
        (RI-DS-SI, paper §4.2.1).
      singleton_first: RI-DS places all pattern nodes with singleton domains
        at the *beginning* of the ordering (paper §4.1).  Requires
        ``domain_sizes``.
      seed_order: optional forced prefix of pattern node ids placed at the
        front of the ordering verbatim (duplicates collapsed).  Used by the
        delta-seeding path (DESIGN.md §8) to anchor a pattern edge's
        endpoints at positions 0/1; overrides ``singleton_first``'s
        pre-placement, the greedy criteria still order the rest.

    Returns:
      An :class:`Ordering` with per-position parent constraint lists.
    """
    n = pattern.n
    deg = pattern.degrees()
    nbr = _neighbor_sets(pattern)
    ds = None
    if domain_sizes is not None:
        ds = np.asarray(domain_sizes, dtype=np.int64)
        if ds.shape != (n,):
            raise ValueError(f"domain_sizes has shape {ds.shape}, expected {(n,)}")

    in_order = np.zeros(n, dtype=bool)
    order: List[int] = []

    def key(u: int) -> Tuple:
        w_m = sum(1 for v in nbr[u] if in_order[v])
        w_n = sum(
            1
            for v in nbr[u]
            if not in_order[v] and any(in_order[x] for x in nbr[v])
        )
        k = (w_m, w_n, int(deg[u]))
        if ds is not None:
            # smaller domain preferred => negate for max-selection
            k = k + (-int(ds[u]),)
        # deterministic final tie-break on node id (smaller id first)
        return k + (-u,)

    # Delta seeding: anchor endpoints are forced to the front.
    if seed_order is not None:
        for u in seed_order:
            u = int(u)
            if not in_order[u]:
                order.append(u)
                in_order[u] = True
    # RI-DS: singleton domains first (their assignment is forced).
    elif singleton_first and ds is not None:
        for u in np.nonzero(ds == 1)[0].tolist():
            order.append(int(u))
            in_order[u] = True

    # first non-singleton node: max degree (SI: domain tie-break applies too)
    while len(order) < n:
        best, best_key = None, None
        for u in range(n):
            if in_order[u]:
                continue
            k = key(u)
            if best_key is None or k > best_key:
                best, best_key = u, k
        order.append(int(best))
        in_order[best] = True

    # Build per-position parent constraints from pattern edges.
    pos_of = {u: i for i, u in enumerate(order)}
    parents: List[List[Tuple[int, int, int]]] = [[] for _ in range(n)]
    for u, v, l in zip(pattern.src.tolist(), pattern.dst.tolist(), pattern.edge_labels.tolist()):
        iu, iv = pos_of[u], pos_of[v]
        if iu < iv:
            # edge (u -> v), u ordered earlier: at position iv, parent iu, out-dir
            parents[iv].append((iu, 0, int(l)))
        elif iv < iu:
            # edge (u -> v), v ordered earlier: at position iu, parent iv, in-dir
            parents[iu].append((iv, 1, int(l)))
        # self loops (iu == iv) cannot be parent constraints (one position);
        # they are enforced as unary domain constraints in
        # repro_torch.core.domains.initial_domains.
    return Ordering(order=np.asarray(order, dtype=np.int32), parents=tuple(tuple(p) for p in parents))


# ---------------------------------------------------------------------------
# edge-centric seed selection (HiPerMotif-style)
# ---------------------------------------------------------------------------

def edge_class_stats(planes: CsrPlanes) -> np.ndarray:
    """Target arc counts per ``(edge_label, src-deg-bucket, dst-deg-bucket)``
    class — ``[n_elab, B, B]`` int64, ``B`` the pow2 degree-bucket ladder
    (`repro_torch.core.graph.deg_bucket_caps`) of the planes' ``deg_cap``.

    Each out-plane arc ``(s, t)`` with label ``l`` is counted once, at
    ``(l, bucket(outdeg_l(s)), bucket(indeg_l(t)))`` — the class frequency
    table :func:`select_seed_edge` ranks pattern edges by.  O(nnz) host
    work over already-built :class:`CsrPlanes`.
    """
    caps = deg_bucket_caps(max(planes.deg_cap, 1))
    b = len(caps)
    nl = planes.n_edge_labels
    hist = np.zeros((nl, b, b), dtype=np.int64)
    ptr = planes.indptr.astype(np.int64)
    for l in range(nl):
        out_len = np.diff(ptr[2 * l])  # [n_t] per-source outdeg_l
        in_len = np.diff(ptr[2 * l + 1])  # [n_t] per-dest indeg_l
        s, e = int(ptr[2 * l, 0]), int(ptr[2 * l, -1])
        cols = planes.indices[s:e]  # arc destinations, row-major
        if cols.size == 0:
            continue
        sb = deg_bucket_index(np.repeat(out_len, out_len), caps)
        db = deg_bucket_index(in_len[cols], caps)
        np.add.at(hist, (l, sb, db), 1)
    return hist


def select_seed_edge(pattern: Graph, planes: CsrPlanes) -> Optional[Tuple[int, int, int]]:
    """Rarest-edge-class seed selection (HiPerMotif).

    Ranks every non-self-loop pattern edge ``(u, v, l)`` by how many target
    arcs could host it: the sum of :func:`edge_class_stats` classes with
    matching label and src/dst degree buckets **at least** the pattern
    endpoints' per-label degrees (an arc in a smaller bucket can never
    satisfy the endpoint's adjacency requirements).  Returns the edge with
    the fewest compatible arcs — the root frontier edge seeding enumerates
    — with deterministic ``(count, l, u, v)`` tie-breaking, or ``None``
    when the pattern has no usable edge (empty or all self-loops).
    """
    if pattern.m == 0:
        return None
    hist = edge_class_stats(planes)
    caps = deg_bucket_caps(max(planes.deg_cap, 1))
    nl_t = hist.shape[0]
    src, dst, elab = pattern.src, pattern.dst, pattern.edge_labels
    best = None
    seen = set()
    for u, v, l in zip(src.tolist(), dst.tolist(), elab.tolist()):
        if u == v or (l, u, v) in seen:
            continue
        seen.add((l, u, v))
        if l >= nl_t:
            count = 0  # label absent from the target: trivially rarest
        else:
            po = int(np.sum((src == u) & (elab == l)))
            pi = int(np.sum((dst == v) & (elab == l)))
            sb = int(deg_bucket_index(np.asarray([po]), caps)[0])
            db = int(deg_bucket_index(np.asarray([pi]), caps)[0])
            count = int(hist[l, sb:, db:].sum())
        k = (count, l, u, v)
        if best is None or k < best:
            best = k
    if best is None:
        return None
    return (best[2], best[3], best[1])
