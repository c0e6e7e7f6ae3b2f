"""RI-DS domain assignment, numpy oracle: initial compatibility domains,
arc-consistency filtering, and the paper's singleton forward checking (FC).

A port of the dense half of ``repro.core.domains``: the numpy oracle
(copied) and the device fixpoint (PyTorch, with the K3 / K4 / K5 kernels).
Domains are packed ``[n_p, w]`` uint32 bitmaps over target nodes.
Pipeline (paper §4.1 / §4.2.2):

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

The device fixpoint (:func:`compute_domains_device`,
:func:`compute_domains_batch`) runs the same pipeline on the card as Jacobi
sweeps over padded pattern batches, bit-identical to the oracle when run to
convergence.  Its CSR twin (:func:`compute_domains_csr`, and
:func:`compute_domains_sparse` for any variant) runs the same sweeps over
the target's CSR planes (:class:`CsrTargetDomainArrays`, the ``csr_arc_sweep``
kernel K8), so dense adjacency bitmaps never exist.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import (
    CsrPlanes,
    Graph,
    PackedGraph,
    WORD_BITS,
    bitmap_from_indices,
    popcount,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


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


def initial_domains_sparse(pattern: Graph, target: Graph, w: int) -> np.ndarray:
    """:func:`initial_domains` computed from a host :class:`Graph` directly
    — no :class:`PackedGraph` (hence no dense adjacency bitmaps) is ever
    materialized.  Bit-identical to the packed form for the same target;
    the entry point for CSR-only plans."""
    t_out = target.out_degrees()
    t_in = target.in_degrees()
    p_out = pattern.out_degrees()
    p_in = pattern.in_degrees()
    bits = np.zeros((pattern.n, w), dtype=np.uint32)
    for p in range(pattern.n):
        ok = (
            (target.labels == pattern.labels[p])
            & (t_out >= p_out[p])
            & (t_in >= p_in[p])
        )
        idx = np.nonzero(ok)[0]
        if idx.size:
            bits[p] = bitmap_from_indices(idx, target.n, w)
    loops = _self_loops(pattern)
    if loops:
        loop_bits = _graph_loop_bits(target, w, target.n_edge_labels)
        for p, l in loops:
            if l >= target.n_edge_labels:
                bits[p] = 0  # label overflow: no target loop can match
            else:
                bits[p] &= loop_bits[l]
    return bits


def _graph_loop_bits(target: Graph, w: int, n_elab: int) -> np.ndarray:
    """``[n_elab, w]``: bit ``t`` set iff the target has a self-loop
    ``(t, t)`` with edge label ``l`` (from the edge list)."""
    loop_mask = target.src == target.dst
    loop_bits = np.zeros((n_elab, w), dtype=np.uint32)
    for l in range(n_elab):
        idx = target.src[loop_mask & (target.edge_labels == l)]
        if idx.size:
            loop_bits[l] = bitmap_from_indices(idx, target.n, w)
    return loop_bits


def compute_domains_sparse(
    pattern: Graph,
    target: Graph,
    w: int,
    use_ac: bool = False,
    use_fc: bool = False,
    interleave: bool = False,
    use_pallas: bool = False,
    ac_iters: Optional[int] = None,
    tgt_arrays: Optional["CsrTargetDomainArrays"] = None,
    device=None,
) -> DomainResult:
    """Domain pipeline over a host :class:`Graph` — dense adjacency bitmaps
    are never materialized, for any variant.

    With the default flags (variant ``ri``) this is
    :func:`initial_domains_sparse` plus the label-overflow / empty-domain
    unsat rules of :func:`compute_domains`, on the host.  Any of ``use_ac``
    / ``use_fc`` runs the CSR-native device fixpoint
    (:func:`compute_domains_csr`) on ``device`` instead.  Bit-identical to
    :func:`compute_domains` on the packed form of the same target."""
    if use_ac or use_fc:
        return compute_domains_csr(
            pattern, target, w, use_ac=use_ac, use_fc=use_fc,
            interleave=interleave, use_pallas=use_pallas, ac_iters=ac_iters,
            tgt_arrays=tgt_arrays, device=device,
        )
    bits = initial_domains_sparse(pattern, target, w)
    if pattern.m and int(pattern.edge_labels.max()) >= target.n_edge_labels:
        return _unsat(bits)
    if not np.all(popcount(bits) > 0):
        return _unsat(bits)
    return DomainResult(bits, True)


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


# ---------------------------------------------------------------------------
# device-resident fixpoint engine
# ---------------------------------------------------------------------------

class TargetDomainArrays(NamedTuple):
    """Device-resident target-side inputs to the fixpoint engine.

    Built once per target (:func:`target_domain_arrays`) and shared by every
    pattern of a batch; the session builds it around the adjacency it
    already holds on the device."""

    adj_flat: torch.Tensor  # [n_elab * 2, n_t, w] int32 (label-major planes)
    labels: torch.Tensor  # [n_t] int32
    deg_out: torch.Tensor  # [n_t] int32
    deg_in: torch.Tensor  # [n_t] int32
    loop_bits: torch.Tensor  # [n_elab, w] int32 self-loop diagonals


class CsrTargetDomainArrays(NamedTuple):
    """CSR-layout target inputs to the **same** fixpoint engine — the
    sparse twin of :class:`TargetDomainArrays`.

    ``seg_start[p, t] / seg_len[p, t]`` bound target node ``t``'s neighbor
    segment of plane ``p = elab * 2 + dir`` inside the flat ``indices``
    array (`repro_torch.core.graph.CsrPlanes`, global offsets); ``indices``
    is sentinel-tailed and over-padded by ``deg_cap``.  ``deg_cap`` (the
    padded row cap, ``repro``'s ``seg_iota`` length) caps each row's walk.
    The footprint is ``O(nnz + n_planes · n_t)`` words."""

    seg_start: torch.Tensor  # [n_planes, n_t] int32 global segment offsets
    seg_len: torch.Tensor  # [n_planes, n_t] int32 row lengths
    indices: torch.Tensor  # [n_idx] int32 flat CSR columns (sentinel tail)
    deg_cap: int  # padded max row length
    labels: torch.Tensor  # [n_t] int32
    deg_out: torch.Tensor  # [n_t] int32
    deg_in: torch.Tensor  # [n_t] int32
    loop_bits: torch.Tensor  # [n_elab, w] int32 self-loop diagonals


class PatternDomainArrays(NamedTuple):
    """Per-pattern padded inputs to the fixpoint engine (host numpy).

    Shapes ``[p_pad] / [a_pad] / [l_pad]`` (with a leading lane axis when
    stacked for a batch); invalid slots are neutral (``valid == False``)."""

    labels: np.ndarray  # [p_pad] int32 (-1 pad: matches no target label)
    deg_out: np.ndarray  # [p_pad] int32
    deg_in: np.ndarray  # [p_pad] int32
    valid: np.ndarray  # [p_pad] bool
    arc_p: np.ndarray  # [a_pad] int32
    arc_q: np.ndarray  # [a_pad] int32
    arc_dir: np.ndarray  # [a_pad] int32
    arc_lab: np.ndarray  # [a_pad] int32
    arc_valid: np.ndarray  # [a_pad] bool
    loop_p: np.ndarray  # [l_pad] int32
    loop_lab: np.ndarray  # [l_pad] int32
    loop_valid: np.ndarray  # [l_pad] bool


def target_domain_arrays(target: PackedGraph, device=None,
                         adj_flat: Optional[torch.Tensor] = None) -> TargetDomainArrays:
    """Ship a packed target to ``device`` (default: the CUDA card) for
    domain preprocessing.  ``adj_flat`` optionally supplies the adjacency
    planes already on the device (``[2 · n_elab, n_t, w]``, a view), so the
    target is not uploaded twice."""
    from repro_torch.core.engine import resolve_device  # engine imports this module

    dev = adj_flat.device if adj_flat is not None else resolve_device(device)
    ne = target.n_edge_labels

    def bits(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    if adj_flat is None:
        adj_flat = bits(target.adj_bits.reshape(ne * 2, target.n, target.w))
    return TargetDomainArrays(
        adj_flat=adj_flat,
        labels=i32(target.labels),
        deg_out=i32(target.deg_out),
        deg_in=i32(target.deg_in),
        loop_bits=bits(target_self_loop_bits(target)),
    )


def csr_target_domain_arrays(
    target: Graph,
    w: int,
    planes: Optional[CsrPlanes] = None,
    device=None,
    upload=None,
) -> CsrTargetDomainArrays:
    """Ship a host :class:`Graph`'s CSR planes to ``device`` (default: the
    CUDA card) for sparse domain preprocessing — never materializing dense
    adjacency bitmaps.  The padding (``deg_cap`` to a multiple of 8,
    ``nnz`` to 1024-multiples, plus a ``deg_cap`` sentinel tail) is that of
    `repro_torch.core.extend.upload_csr`, whose result ``upload`` may pass
    the planes already on the device (its ``indices`` are shared, not
    copied)."""
    from repro_torch.core.engine import resolve_device  # engine imports this module
    from repro_torch.core.extend import upload_csr

    if planes is None:
        planes = target.csr_planes(target.n_edge_labels)
    if upload is None:
        upload = upload_csr(planes, resolve_device(device))
    dev = upload.indices.device
    ptr = upload.indptr

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    loop_bits = _graph_loop_bits(target, w, planes.n_edge_labels)
    return CsrTargetDomainArrays(
        seg_start=ptr[:, :-1].contiguous(),
        seg_len=(ptr[:, 1:] - ptr[:, :-1]).contiguous(),
        indices=upload.indices,
        deg_cap=upload.deg_cap,
        labels=i32(target.labels),
        deg_out=i32(target.out_degrees()),
        deg_in=i32(target.in_degrees()),
        loop_bits=torch.from_numpy(loop_bits.view(np.int32)).to(dev),
    )


def pattern_domain_arrays(
    pattern: Graph,
    p_pad: Optional[int] = None,
    arc_pad: Optional[int] = None,
    loop_pad: Optional[int] = None,
) -> PatternDomainArrays:
    """Pad a pattern's unary + binary constraints into a shape bucket."""
    arcs = _pattern_arcs(pattern)
    loops = _self_loops(pattern)
    n_p, n_a, n_l = pattern.n, arcs.shape[0], len(loops)
    p_pad = max(p_pad or n_p, n_p, 1)
    a_pad = max(arc_pad or n_a, n_a, 1)
    l_pad = max(loop_pad or n_l, n_l, 1)

    labels = np.full(p_pad, -1, dtype=np.int32)
    labels[:n_p] = pattern.labels
    deg_out = np.zeros(p_pad, dtype=np.int32)
    deg_out[:n_p] = pattern.out_degrees()
    deg_in = np.zeros(p_pad, dtype=np.int32)
    deg_in[:n_p] = pattern.in_degrees()
    valid = np.zeros(p_pad, dtype=bool)
    valid[:n_p] = True

    arc = np.zeros((a_pad, 4), dtype=np.int32)
    arc[:n_a] = arcs
    arc_valid = np.zeros(a_pad, dtype=bool)
    arc_valid[:n_a] = True

    loop_p = np.zeros(l_pad, dtype=np.int32)
    loop_lab = np.zeros(l_pad, dtype=np.int32)
    loop_valid = np.zeros(l_pad, dtype=bool)
    for j, (p, l) in enumerate(loops):
        loop_p[j], loop_lab[j], loop_valid[j] = p, l, True

    return PatternDomainArrays(
        labels=labels, deg_out=deg_out, deg_in=deg_in, valid=valid,
        arc_p=arc[:, 0], arc_q=arc[:, 1], arc_dir=arc[:, 2], arc_lab=arc[:, 3],
        arc_valid=arc_valid,
        loop_p=loop_p, loop_lab=loop_lab, loop_valid=loop_valid,
    )


def domain_bucket(pattern: Graph) -> Tuple[int, int, int]:
    """Un-padded bucket dimensions ``(n_p, n_arcs, n_loops)`` of a pattern
    (the session snaps each up to its shape bucket)."""
    n_loops = int(np.sum(pattern.src == pattern.dst))
    return pattern.n, 2 * (pattern.m - n_loops), n_loops


# Kernel routing modes of the device engine:
#   "off"     — plain PyTorch reductions (`repro_torch.kernels.ref`);
#   "sweep"   — one `arc_any_sweep` (K4) launch per AC sweep, popcounts by
#               `popcount_rows` (K3) (the single-query path);
#   "per-arc" — `adjacency_any` (K5) over the live (pattern, arc) pairs,
#               one launch per AC sweep, popcounts by K3 (the batched path;
#               ``repro`` named it for its per-arc-slot K5 calls, since its
#               sweep kernel did not compose with vmap).
PALLAS_MODES = ("off", "sweep", "per-arc")

# AC sweeps that tested at least one arc (any layout, any kernel mode)
# since the last `reset_sweep_count()`: what a route's kernel launches per
# sweep are read against.
ac_sweeps = 0


def reset_sweep_count() -> None:
    global ac_sweeps
    ac_sweeps = 0


def _slot_table(node: np.ndarray, take: np.ndarray, p_pad: int) -> np.ndarray:
    """``[L, p_pad, K]`` table of the slots ``j`` with ``take[l, j]`` and
    ``node[l, j] == p``, per lane ``l`` and pattern node ``p``, padded with
    ``J`` (one past the last slot)."""
    n_lanes, n_slots = node.shape
    counts = np.zeros((n_lanes, p_pad), dtype=np.int64)
    lanes, slots = np.nonzero(take)
    np.add.at(counts, (lanes, node[lanes, slots]), 1)
    table = np.full((n_lanes, p_pad, int(counts.max(initial=0))), n_slots, dtype=np.int64)
    fill = np.zeros_like(counts)
    for l, j in zip(lanes.tolist(), slots.tolist()):
        p = node[l, j]
        table[l, p, fill[l, p]] = j
        fill[l, p] += 1
    return table


def _and_by_node(masks: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[l, p] = ⋀_k masks[l, table[l, p, k]]`` (all ones where a node
    has no slot): the per-node AND that ``repro`` scatters with
    ``.at[p].set(b[p] & m)``, which torch has no bitwise-AND scatter for.
    ``masks`` is ``[L, J, w]``; index ``J`` is the appended all-ones row."""
    n_lanes, _, w = masks.shape
    ones = torch.full((n_lanes, 1, w), -1, dtype=masks.dtype, device=masks.device)
    ext = torch.cat([masks, ones], dim=1)
    out = torch.full((n_lanes, table.shape[1], w), -1, dtype=masks.dtype, device=masks.device)
    lane = torch.arange(n_lanes, device=masks.device)[:, None]
    for k in range(table.shape[2]):
        out &= ext[lane, table[:, :, k]]
    return out


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """OR over axis 1 of ``[L, n, w]`` words (torch has no bitwise-OR
    reduction): a halving tree of ``log2 n`` ORs."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        half = x.shape[1] // 2
        x = x[:, :half] | x[:, half:]
    return x[:, 0]


def _device_fixpoint(
    use_ac: bool,
    use_fc: bool,
    interleave: bool,
    pallas_mode: str,
    max_iters: Optional[int],
    tgt: TargetDomainArrays,
    pat: PatternDomainArrays,
    live: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """The AC ⇄ FC fixpoint over a batch of ``L`` padded patterns
    (``pat`` fields stacked along a leading lane axis).

    Returns ``(bits [L, p_pad, w] int32 on the device, satisfiable [L]
    bool)``; bits are zeroed where unsatisfiable (the
    :class:`DomainResult` invariant).  Each lane runs its own loop, as a
    vmapped ``lax.while_loop`` runs it in ``repro``: a lane that has
    converged, became unsatisfiable or spent ``max_iters`` stops changing,
    and only the lanes still running are swept.  ``live`` (``[L]`` bool)
    marks pad lanes, which are frozen from the start.  One host
    synchronisation per iteration reads every lane's flags.

    ``tgt`` selects the layout: :class:`TargetDomainArrays` tests arc
    support on dense adjacency planes (one launch per sweep over the arcs
    of every live lane: K4 single, K5 batched), a
    :class:`CsrTargetDomainArrays` on CSR segments (K8, one launch per
    sweep, in both kernel modes); the rest is the same code.
    """
    use_kernels = pallas_mode != "off"
    is_csr = isinstance(tgt, CsrTargetDomainArrays)
    n_elab, w = tgt.loop_bits.shape
    dev = tgt.labels.device
    n_lanes, p_pad = pat.labels.shape
    live = np.ones(n_lanes, dtype=bool) if live is None else np.asarray(live, dtype=bool)

    def on_dev(a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    def pop_rows(bits):  # [..., n, w] -> [..., n]
        flat = bits.reshape(-1, w)
        out = kops.popcount_rows(flat) if use_kernels else kref.popcount_rows_ref(flat)
        return out.view(bits.shape[:-1])

    valid = on_dev(pat.valid, torch.bool)  # [L, p_pad]

    # ---- initial domains: label + degree + self-loop dominance ------------
    flags = (
        (tgt.labels == on_dev(pat.labels)[..., None])
        & (tgt.deg_out >= on_dev(pat.deg_out)[..., None])
        & (tgt.deg_in >= on_dev(pat.deg_in)[..., None])
        & valid[..., None]
    )  # [L, p_pad, n_t]
    bits = kops.pack_bits(flags, w)
    loop_masks = torch.where(
        on_dev(pat.loop_lab < n_elab, torch.bool)[..., None],  # overflow: no loop matches
        tgt.loop_bits[on_dev(np.clip(pat.loop_lab, 0, n_elab - 1), torch.long)], 0)
    bits = bits & _and_by_node(loop_masks, on_dev(_slot_table(pat.loop_p, pat.loop_valid, p_pad),
                                                  torch.long))

    # label overflow on any constraint (arc or loop) ⇒ unsatisfiable in every
    # variant, matching `compute_domains`
    overflow = (np.any(pat.arc_valid & (pat.arc_lab >= n_elab), axis=1)
                | np.any(pat.loop_valid & (pat.loop_lab >= n_elab), axis=1))
    unsat = on_dev(overflow, torch.bool) | (valid & (pop_rows(bits) == 0)).any(dim=-1)

    # ---- one AC sweep: all arcs at once (Jacobi) ---------------------------
    arc_row = np.clip(pat.arc_lab, 0, n_elab - 1) * 2 + pat.arc_dir  # [L, a_pad]
    arc_dead = pat.arc_valid & (pat.arc_lab >= n_elab)
    arc_live = pat.arc_valid & ~arc_dead
    arc_table = on_dev(_slot_table(pat.arc_p, pat.arc_valid, p_pad), torch.long)
    # pad slots are left out of the table (AND with all ones); dead arcs
    # support nothing
    base_masks = torch.where(on_dev(arc_dead, torch.bool)[..., None], 0,
                             torch.full((1, 1, w), -1, dtype=torch.int32, device=dev))

    def ac_sweep(bits, act):
        global ac_sweeps
        lanes, slots = np.nonzero(act[:, None] & arc_live)  # the arcs to test
        masks = base_masks.clone()
        if lanes.size:
            src = bits[on_dev(lanes, torch.long), on_dev(pat.arc_q[lanes, slots], torch.long)]
            rows = arc_row[lanes, slots]
            if is_csr:
                sweep = kops.csr_arc_sweep if use_kernels else kref.csr_arc_sweep_ref
                ok = sweep(tgt.seg_start, tgt.seg_len, tgt.indices, on_dev(rows), src,
                           deg_cap=tgt.deg_cap)
            elif pallas_mode == "sweep":
                ok = kops.arc_any_sweep(tgt.adj_flat, on_dev(rows), src)
            elif pallas_mode == "per-arc":
                ok = kops.adjacency_any_pairs(tgt.adj_flat, on_dev(rows), src)
            else:
                ok = kref.adjacency_any_pairs_ref(tgt.adj_flat, torch.from_numpy(rows), src)
            ac_sweeps += 1
            masks[on_dev(lanes, torch.long), on_dev(slots, torch.long)] = kops.pack_bits(ok, w)
        return bits & _and_by_node(masks, arc_table), torch.zeros_like(unsat)

    # ---- one FC step: all singletons at once -------------------------------
    def fc_step(bits, act):
        sizes = pop_rows(bits)
        single = (sizes == 1) & valid
        union = _or_rows(torch.where(single[..., None], bits, 0))  # [L, w]
        # collision: two singletons share a target ⇔ the OR loses a bit
        collide = torch.where(single, sizes, 0).sum(dim=-1) > pop_rows(union)
        new = torch.where(single[..., None], bits, bits & ~union[:, None, :])
        return new, collide

    # ---- fixpoint loops ----------------------------------------------------
    mi = max_iters if max_iters is not None else p_pad * w * WORD_BITS + 2

    def run_loop(step, bits, unsat):
        it = np.zeros(n_lanes, dtype=np.int64)
        changed = np.ones(n_lanes, dtype=bool)
        u_host = unsat.cpu().numpy()
        while True:
            act = live & changed & ~u_host & (it < mi)
            if not act.any():
                return bits, unsat
            nb, step_unsat = step(bits, act)
            act_t = on_dev(act, torch.bool)
            u2 = unsat | step_unsat | (valid & (pop_rows(nb) == 0)).any(dim=-1)
            ch = (nb != bits).flatten(1).any(dim=-1)
            bits = torch.where(act_t[:, None, None], nb, bits)
            unsat = torch.where(act_t, u2, unsat)
            flags = torch.stack([unsat, ch]).cpu().numpy()  # the iteration's one sync
            u_host = flags[0]
            changed = np.where(act, flags[1], changed)
            it += act

    if use_ac and use_fc and interleave:
        def both(b, act):
            b1, u1 = ac_sweep(b, act)
            b2, u2 = fc_step(b1, act)
            return b2, u1 | u2

        bits, unsat = run_loop(both, bits, unsat)
    else:
        if use_ac:
            bits, unsat = run_loop(ac_sweep, bits, unsat)
        if use_fc:
            bits, unsat = run_loop(fc_step, bits, unsat)

    bits = torch.where(unsat[:, None, None], 0, bits)
    return bits, ~unsat.cpu().numpy()


def device_fixpoint(
    use_ac: bool = True,
    use_fc: bool = False,
    interleave: bool = False,
    pallas_mode: str = "off",
    max_iters: Optional[int] = None,
    batched: bool = False,
) -> Callable:
    """The device fixpoint ``(TargetDomainArrays, PatternDomainArrays) ->
    (bits, satisfiable)`` for one flag combination.

    ``batched=True`` takes pattern arrays with a leading batch axis (and an
    optional ``live`` lane mask) and returns ``[B, p_pad, w]`` bits and
    ``[B]`` flags; otherwise one pattern, ``[p_pad, w]`` and a bool.  As in
    ``repro``, the batched path takes K5 (``"per-arc"``), not K4; it
    launches K5 once per sweep over every live (pattern, arc) pair.
    """
    if pallas_mode not in PALLAS_MODES:
        raise ValueError(f"pallas_mode {pallas_mode!r} not in {PALLAS_MODES}")
    if batched and pallas_mode == "sweep":
        raise ValueError("pallas_mode='sweep' does not compose with batching; "
                         "use 'per-arc'")
    fn = functools.partial(_device_fixpoint, use_ac, use_fc, interleave, pallas_mode, max_iters)
    if batched:
        return fn

    def single(tgt: TargetDomainArrays, pat: PatternDomainArrays):
        bits, sat = fn(tgt, PatternDomainArrays(*(np.asarray(x)[None] for x in pat)))
        return bits[0], bool(sat[0])

    return single


def _host_bits(bits: torch.Tensor) -> np.ndarray:
    return bits.cpu().numpy().view(np.uint32)


def compute_domains_device(
    pattern: Graph,
    target: PackedGraph,
    use_ac: bool = True,
    use_fc: bool = False,
    interleave: bool = False,
    use_pallas: bool = False,
    ac_iters: Optional[int] = None,
    tgt_arrays: Optional[TargetDomainArrays] = None,
    device=None,
) -> DomainResult:
    """Single-query device preprocessing on ``device`` (default: the CUDA
    card, or ``tgt_arrays``' device); bit-identical to
    :func:`compute_domains` with the same flags **when run to
    convergence** (``ac_iters=None``, the default).  A finite ``ac_iters``
    bounds *Jacobi whole-sweeps* here but *Gauss-Seidel passes* in the
    numpy oracle, so truncated runs may differ — both remain sound
    over-approximations of the fixpoint.  ``use_pallas`` sweeps with K4
    and counts with K3."""
    tgt = tgt_arrays if tgt_arrays is not None else target_domain_arrays(target, device)
    fn = device_fixpoint(
        use_ac=use_ac, use_fc=use_fc, interleave=interleave,
        pallas_mode="sweep" if use_pallas else "off",
        max_iters=ac_iters, batched=False,
    )
    bits, sat = fn(tgt, pattern_domain_arrays(pattern))
    return DomainResult(_host_bits(bits)[: pattern.n].copy(), sat)


def compute_domains_csr(
    pattern: Graph,
    target: Graph,
    w: int,
    use_ac: bool = True,
    use_fc: bool = False,
    interleave: bool = False,
    use_pallas: bool = False,
    ac_iters: Optional[int] = None,
    tgt_arrays: Optional[CsrTargetDomainArrays] = None,
    device=None,
) -> DomainResult:
    """Single-query CSR-native device preprocessing on ``device`` (default:
    the CUDA card, or ``tgt_arrays``' device): :func:`compute_domains_device`
    without a :class:`PackedGraph` — the AC sweeps walk the target's CSR
    segments, so dense adjacency bitmaps never exist.  Bit-identical to
    :func:`compute_domains` on the packed form of the same target when run
    to convergence.  ``use_pallas`` sweeps with K8 and counts with K3."""
    tgt = (tgt_arrays if tgt_arrays is not None
           else csr_target_domain_arrays(target, w, device=device))
    fn = device_fixpoint(
        use_ac=use_ac, use_fc=use_fc, interleave=interleave,
        pallas_mode="sweep" if use_pallas else "off",
        max_iters=ac_iters, batched=False,
    )
    bits, sat = fn(tgt, pattern_domain_arrays(pattern))
    return DomainResult(_host_bits(bits)[: pattern.n].copy(), sat)


def compute_domains_batch(
    patterns: Sequence[Graph],
    target: PackedGraph,
    use_ac: bool = True,
    use_fc: bool = False,
    interleave: bool = False,
    use_pallas: bool = False,
    p_pad: Optional[int] = None,
    arc_pad: Optional[int] = None,
    loop_pad: Optional[int] = None,
    batch_pad: Optional[int] = None,
    tgt_arrays: Optional[TargetDomainArrays] = None,
    device=None,
) -> List[DomainResult]:
    """Batched device preprocessing: one fixpoint over a padded pattern
    batch (the ``Enumerator.prepare_batch`` backend).

    All patterns share one bucket ``(p_pad, arc_pad, loop_pad)``;
    unspecified pads snap to the batch maxima.  ``batch_pad`` lanes beyond
    ``len(patterns)`` replicate lane 0, are frozen from the start (they
    cost no sweep) and are discarded.  ``use_pallas`` tests the live
    (pattern, arc) pairs of each sweep with one K5 launch (with
    :class:`CsrTargetDomainArrays` ``tgt_arrays``, one K8 launch) and
    counts with K3.
    """
    patterns = list(patterns)
    if not patterns:
        return []
    dims = [domain_bucket(p) for p in patterns]
    p_pad = p_pad or max(d[0] for d in dims)
    arc_pad = arc_pad or max(d[1] for d in dims)
    loop_pad = loop_pad or max(d[2] for d in dims)
    arrs = [
        pattern_domain_arrays(p, p_pad=p_pad, arc_pad=arc_pad, loop_pad=loop_pad)
        for p in patterns
    ]
    b_pad = max(batch_pad or len(arrs), len(arrs))
    arrs = arrs + [arrs[0]] * (b_pad - len(arrs))
    stacked = PatternDomainArrays(*(np.stack(cols) for cols in zip(*arrs)))
    tgt = tgt_arrays if tgt_arrays is not None else target_domain_arrays(target, device)
    fn = device_fixpoint(
        use_ac=use_ac, use_fc=use_fc, interleave=interleave,
        pallas_mode="per-arc" if use_pallas else "off",
        max_iters=None, batched=True,
    )
    bits, sat = fn(tgt, stacked, live=np.arange(b_pad) < len(patterns))
    bits = _host_bits(bits)
    return [
        DomainResult(bits[i, : p.n].copy(), bool(sat[i]))
        for i, p in enumerate(patterns)
    ]
