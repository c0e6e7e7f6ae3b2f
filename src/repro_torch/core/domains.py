"""RI-DS domain assignment, numpy oracle: initial compatibility domains,
arc-consistency filtering, and the paper's singleton forward checking (FC).

A copy of the host half of ``repro.core.domains``.  Domains are packed
``[n_p, w]`` uint32 bitmaps over target nodes.  Pipeline (paper §4.1 /
§4.2.2):

  1. ``initial_domains`` — label equality, degree dominance and self-loop
     dominance (a pattern self-loop with label ``l`` needs a target
     self-loop with label ``l``; self-loops are never parent constraints,
     so this is their one enforcement point).
  2. ``arc_consistency`` — drop ``t`` from ``D(p)`` if some pattern edge
     ``(p, q)`` has no counterpart ``(t, t')`` with ``t' ∈ D(q)``.
  3. ``forward_check_singletons`` — remove each singleton's target from
     every other domain, repeating on new singletons.
  4. ``fixpoint_domains`` (variant ``ri-ds-si-acfc``) — 2 and 3 interleaved
     to their joint fixpoint.

Contracts: ``satisfiable is False`` implies all-zero ``bits``; a pattern
edge label the target lacks makes the query unsatisfiable in every variant.
The device fixpoint of ``repro`` is not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import (
    Graph,
    PackedGraph,
    WORD_BITS,
    bitmap_from_indices,
    popcount,
)


@dataclasses.dataclass
class DomainResult:
    """Packed domains plus satisfiability flag.

    Invariant: ``satisfiable is False`` implies ``bits`` is all-zero, so an
    unsatisfiable result can never seed a search.
    """

    bits: np.ndarray  # [n_p, w] uint32
    satisfiable: bool

    def sizes(self) -> np.ndarray:
        return popcount(self.bits)


def _unsat(bits: np.ndarray) -> DomainResult:
    """The canonical unsatisfiable result: zeroed bits (see class invariant)."""
    return DomainResult(np.zeros_like(bits), False)


# ---------------------------------------------------------------------------
# pattern constraint extraction
# ---------------------------------------------------------------------------

def _self_loops(pattern: Graph) -> List[Tuple[int, int]]:
    """All pattern self-loop constraints ``(u, elab)``.

    Self-loops cannot be parent constraints (both endpoints are the same
    ordering position), so they are enforced as unary domain constraints in
    :func:`initial_domains` / the device engine's initial phase."""
    return [
        (int(u), int(l))
        for u, v, l in zip(pattern.src.tolist(), pattern.dst.tolist(),
                           pattern.edge_labels.tolist())
        if u == v
    ]


def _pattern_arcs(pattern: Graph) -> np.ndarray:
    """All directed constraint arcs ``(p, q, dir, elab)``.

    For pattern edge ``(p -> q)`` with label ``l`` we emit two arcs:
      * ``(p, q, dir=0, l)``: every ``t ∈ D(p)`` needs an out-edge with label
        ``l`` to some ``t' ∈ D(q)``;
      * ``(q, p, dir=1, l)``: every ``t ∈ D(q)`` needs an in-edge from some
        ``t' ∈ D(p)``.

    Self-loops (``u == v``) are excluded: their binary form ("some D(u) node
    is an out-neighbor") is strictly weaker than the true unary constraint
    ("t itself carries the loop"), which :func:`initial_domains` enforces.
    """
    arcs = []
    for u, v, l in zip(pattern.src.tolist(), pattern.dst.tolist(),
                       pattern.edge_labels.tolist()):
        if u == v:
            continue
        arcs.append((u, v, 0, l))
        arcs.append((v, u, 1, l))
    return np.asarray(arcs, dtype=np.int32).reshape(-1, 4)


def target_self_loop_bits(target: PackedGraph) -> np.ndarray:
    """``[n_elab, w]`` bitmaps: bit ``t`` set iff the target has a self-loop
    ``(t, t)`` with edge label ``l`` — the diagonal of each adjacency plane."""
    n, w = target.n, target.w
    out = np.zeros((target.n_edge_labels, w), dtype=np.uint32)
    if n == 0:
        return out
    t = np.arange(n)
    word = t // WORD_BITS
    shift = (t % WORD_BITS).astype(np.uint32)
    for l in range(target.n_edge_labels):
        diag = (target.adj_bits[l, 0, t, word] >> shift) & np.uint32(1)
        idx = np.nonzero(diag)[0]
        if idx.size:
            out[l] = bitmap_from_indices(idx, n, w)
    return out


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def initial_domains(pattern: Graph, target: PackedGraph) -> np.ndarray:
    """``D0(p) = { t : lab(t) == lab(p), deg_out(t) >= deg_out(p),
    deg_in(t) >= deg_in(p), self-loops of p ⊆ self-loops of t }``
    as ``[n_p, w]`` bitmaps.

    The self-loop clause is the bugfix for patterns with loop edges: a loop
    with a label the target lacks empties the domain outright."""
    p_out = pattern.out_degrees()
    p_in = pattern.in_degrees()
    w = target.w
    bits = np.zeros((pattern.n, w), dtype=np.uint32)
    for p in range(pattern.n):
        ok = (
            (target.labels == pattern.labels[p])
            & (target.deg_out >= p_out[p])
            & (target.deg_in >= p_in[p])
        )
        idx = np.nonzero(ok)[0]
        if idx.size:
            bits[p] = bitmap_from_indices(idx, target.n, w)
    loops = _self_loops(pattern)
    if loops:
        loop_bits = target_self_loop_bits(target)
        for p, l in loops:
            if l >= target.n_edge_labels:
                bits[p] = 0  # label overflow: no target loop can match
            else:
                bits[p] &= loop_bits[l]
    return bits


def arc_consistency(
    pattern: Graph,
    target: PackedGraph,
    bits: np.ndarray,
    max_iters: Optional[int] = None,
) -> DomainResult:
    """Filter domains to (iterated) arc consistency.

    For arc ``(p, q, dir, l)``: keep ``t`` in ``D(p)`` only if
    ``adj_bits[l, dir, t] & D(q)`` is non-empty — a row-wise AND + any-bit
    test over the target adjacency bitmaps, vectorized over all ``t``.
    A label ``l`` with no adjacency plane (``l >= n_elab``) is treated as an
    all-empty plane, so the arc's domain empties (label-overflow bugfix —
    this used to raise ``IndexError``).
    """
    bits = bits.copy()
    arcs = _pattern_arcs(pattern)
    if arcs.size == 0:
        if np.all(popcount(bits) > 0):
            return DomainResult(bits, True)
        return _unsat(bits)
    n_elab = target.adj_bits.shape[0]
    it = 0
    while True:
        it += 1
        changed = False
        for p, q, d, l in arcs.tolist():
            if l >= n_elab:
                rows_any = np.zeros(target.n, dtype=bool)
            else:
                rows = target.adj_bits[l, d]  # [n_t, w]
                rows_any = np.any(rows & bits[q][None, :], axis=-1)  # [n_t]
            mask = (
                bitmap_from_indices(np.nonzero(rows_any)[0], target.n, target.w)
                if rows_any.any()
                else np.zeros(target.w, np.uint32)
            )
            nb = bits[p] & mask
            if not np.array_equal(nb, bits[p]):
                bits[p] = nb
                changed = True
                if not nb.any():
                    return _unsat(bits)
        if not changed or (max_iters is not None and it >= max_iters):
            break
    if np.all(popcount(bits) > 0):
        return DomainResult(bits, True)
    return _unsat(bits)


def forward_check_singletons(bits: np.ndarray) -> DomainResult:
    """The paper's FC (§4.2.2): propagate injectivity from singleton domains.

    Pattern nodes with ``|D(p)| == 1`` are guaranteed to be assigned their
    single target node; remove that node from every *other* domain, and
    iterate on newly created singletons.
    """
    bits = bits.copy()
    n_p = bits.shape[0]
    sizes = popcount(bits)
    if np.any(sizes == 0):
        return _unsat(bits)
    processed = np.zeros(n_p, dtype=bool)
    while True:
        new = np.nonzero((sizes == 1) & ~processed)[0]
        if new.size == 0:
            break
        # Union bitmap of all newly discovered singleton targets.  Collision
        # (two singletons sharing a target) surfaces as an emptied domain.
        union = np.zeros(bits.shape[1], dtype=np.uint32)
        for p in new.tolist():
            if (union & bits[p]).any():
                return _unsat(bits)  # two singletons collide
            union |= bits[p]
            processed[p] = True
        keep = ~processed
        bits[keep] &= ~union[None, :]
        sizes = popcount(bits)
        if np.any(sizes == 0):
            return _unsat(bits)
    return DomainResult(bits, True)


def fixpoint_domains(
    pattern: Graph,
    target: PackedGraph,
    bits: np.ndarray,
    max_iters: Optional[int] = None,
) -> DomainResult:
    """AC ⇄ FC joint fixpoint (numpy oracle for the device engine).

    Alternates arc consistency and singleton forward checking until neither
    removes a candidate: FC removals re-trigger AC.  Both rules are monotone
    prunings, so the joint fixpoint is unique and iteration order does not
    affect the result (DESIGN.md §5).
    """
    res = DomainResult(bits.copy(), True)
    while True:
        res = arc_consistency(pattern, target, res.bits, max_iters=max_iters)
        if not res.satisfiable:
            return res
        nxt = forward_check_singletons(res.bits)
        if not nxt.satisfiable or np.array_equal(nxt.bits, res.bits):
            return nxt
        res = nxt


def compute_domains(
    pattern: Graph,
    target: PackedGraph,
    use_ac: bool = True,
    use_fc: bool = False,
    ac_iters: Optional[int] = None,
    interleave: bool = False,
) -> DomainResult:
    """Full RI-DS domain pipeline (numpy oracle).

    ``use_ac=False`` yields RI's implicit domains (label + degree + self-loop
    compat only); ``use_fc=True`` adds the paper's singleton forward checking;
    ``interleave=True`` (with both) runs AC and FC to their joint fixpoint
    (variant ``ri-ds-si-acfc``) instead of the sequential AC → FC pass.

    A pattern edge label outside the target's label range makes the query
    unsatisfiable in **every** variant (label-overflow bugfix): without this,
    variant ``ri`` plans would hand the engine out-of-range adjacency plane
    indices that tensor gathers would read from the wrong label.
    """
    bits = initial_domains(pattern, target)
    if pattern.m and int(pattern.edge_labels.max()) >= target.n_edge_labels:
        return _unsat(bits)
    if not np.all(popcount(bits) > 0):
        return _unsat(bits)
    if use_ac and use_fc and interleave:
        return fixpoint_domains(pattern, target, bits, max_iters=ac_iters)
    res = DomainResult(bits, True)
    if use_ac:
        res = arc_consistency(pattern, target, res.bits, max_iters=ac_iters)
        if not res.satisfiable:
            return res
    if use_fc:
        res = forward_check_singletons(res.bits)
    return res
