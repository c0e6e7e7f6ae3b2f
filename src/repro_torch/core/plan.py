"""SearchPlan — the static preprocessing product handed to the engine.

A copy of ``repro.core.plan``.  Ordering runs on the host in numpy; domains come from the numpy oracle
`repro_torch.core.domains.compute_domains` (:func:`build_plan`), or, for a
**CSR-only** plan (:func:`build_csr_plan`), from the host initial domains
or the CSR-native device fixpoint, never materializing dense adjacency
bitmaps.  The engine uploads the arrays once per query
(`repro_torch.core.extend.plan_arrays_for`).  ``seed_edge=`` anchors a
pattern edge at ordering positions 0/1 for edge-centric root seeding
(`repro_torch.core.frontier.root_seed_entries`).

Pattern self-loops never appear in the parent tables (both endpoints share
one ordering position); they are enforced as unary constraints baked into
``dom_bits``, which every candidate check inherits.

Variants (paper terminology):

  * ``ri``            — RI: static domains are label+degree compat only.
  * ``ri-ds``         — RI-DS: + arc-consistent domains, singletons first.
  * ``ri-ds-si``      — + domain-size tie-breaking in the ordering (§4.2.1).
  * ``ri-ds-si-fc``   — + singleton forward checking (§4.2.2).
  * ``ri-ds-si-acfc`` — AC ⇄ FC interleaved to their joint fixpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import domains as dom_mod
from repro_torch.core import ordering as ord_mod
from repro_torch.core.graph import (
    CsrPlanes, Graph, PackedGraph, csr_planes_from_bitmaps, n_words, popcount,
)

VARIANTS = ("ri", "ri-ds", "ri-ds-si", "ri-ds-si-fc", "ri-ds-si-acfc")


def variant_flags(variant: str) -> Dict[str, bool]:
    """Decompose a variant name into preprocessing switches:
    ``use_ac`` (arc consistency), ``use_si`` (domain-size ordering
    tie-break), ``use_fc`` (singleton forward checking), ``interleave``
    (AC ⇄ FC joint fixpoint)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}, expected one of {VARIANTS}")
    return dict(
        use_ac=variant != "ri",
        use_si=variant in ("ri-ds-si", "ri-ds-si-fc", "ri-ds-si-acfc"),
        use_fc=variant in ("ri-ds-si-fc", "ri-ds-si-acfc"),
        interleave=variant == "ri-ds-si-acfc",
    )


@dataclasses.dataclass
class SearchPlan:
    """Static arrays for the vectorized search engine (host numpy).

    All position-indexed arrays are padded to ``p_pad`` positions and
    ``max_parents`` parent slots.
    """

    variant: str
    n_p: int  # actual number of pattern nodes
    p_pad: int  # padded position count (>= n_p)
    n_t: int
    w: int  # bitmap words per row
    order: np.ndarray  # [p_pad] int32 pattern node id per position (-1 pad)
    parent_pos: np.ndarray  # [p_pad, max_parents] int32, -1 padded
    parent_dir: np.ndarray  # [p_pad, max_parents] int32
    parent_elab: np.ndarray  # [p_pad, max_parents] int32
    n_parents: np.ndarray  # [p_pad] int32
    dom_bits: np.ndarray  # [p_pad, w] uint32 — domain of order[i], position space
    adj_bits: np.ndarray  # [n_elab, 2, n_t, w] uint32 ([n_elab, 2, 0, w] when
    # the plan is CSR-only — see ``csr`` and :func:`build_csr_plan`)
    satisfiable: bool
    # Sparse adjacency: set by build_csr_plan (then adj_bits is an empty
    # placeholder and only step_backend="csr" can run the plan), or derived
    # from adj_bits and cached by `repro_torch.core.extend.plan_csr`.
    csr: Optional[CsrPlanes] = None
    # Lazy CsrPlanes supplier (a session passes its index's cached planes),
    # consulted by `repro_torch.core.extend.plan_csr` when ``csr`` is unset.
    csr_factory: Optional[Callable[[], CsrPlanes]] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    domains: Optional[dom_mod.DomainResult] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    # Edge-centric seeding: the pattern edge ``(u, v, elab)`` whose
    # endpoints occupy ordering positions 0/1, selected by
    # `repro_torch.core.ordering.select_seed_edge` (or forced explicitly).
    # When set, ``EngineConfig.root_seeding="edge"|"auto"`` enumerates this
    # edge class's target arcs directly into depth-1 root entries.
    seed_edge: Optional[Tuple[int, int, int]] = None

    @property
    def max_parents(self) -> int:
        return int(self.parent_pos.shape[1])

    @property
    def n_edge_labels(self) -> int:
        return int(self.adj_bits.shape[0])

    def domain_sizes(self) -> np.ndarray:
        return popcount(self.dom_bits[: self.n_p])


# the SearchPlan fields that are arrays or plain values (what
# plan_from_numpy reads), in declaration order
PLAN_ARRAY_FIELDS = (
    "variant", "n_p", "p_pad", "n_t", "w", "order", "parent_pos",
    "parent_dir", "parent_elab", "n_parents", "dom_bits", "adj_bits",
    "satisfiable", "seed_edge",
)


def plan_from_numpy(d: Mapping[str, object]) -> SearchPlan:
    """Build a port :class:`SearchPlan` from another plan's arrays.

    ``d`` maps each name of :data:`PLAN_ARRAY_FIELDS` to a numpy array or a
    plain value, for example ``{f: getattr(p, f) for f in
    PLAN_ARRAY_FIELDS}`` of a ``repro`` ``SearchPlan``.  Feeding one plan to
    both engines keeps an engine mismatch from hiding behind a
    preprocessing mismatch.  An optional ``"csr"`` entry (an object with
    ``n_t``, ``indptr``, ``indices`` and ``deg_cap``, such as ``repro``'s
    ``CsrPlanes``) carries a CSR-only plan's adjacency."""
    missing = [f for f in PLAN_ARRAY_FIELDS if f not in d]
    if missing:
        raise KeyError(f"plan arrays missing {missing}")
    csr = d.get("csr")
    if csr is not None:
        csr = CsrPlanes(n_t=int(csr.n_t), indptr=np.asarray(csr.indptr, dtype=np.int32),
                        indices=np.asarray(csr.indices, dtype=np.int32),
                        deg_cap=int(csr.deg_cap))
    seed = d["seed_edge"]
    return SearchPlan(
        variant=str(d["variant"]),
        n_p=int(d["n_p"]),
        p_pad=int(d["p_pad"]),
        n_t=int(d["n_t"]),
        w=int(d["w"]),
        order=np.asarray(d["order"], dtype=np.int32),
        parent_pos=np.asarray(d["parent_pos"], dtype=np.int32),
        parent_dir=np.asarray(d["parent_dir"], dtype=np.int32),
        parent_elab=np.asarray(d["parent_elab"], dtype=np.int32),
        n_parents=np.asarray(d["n_parents"], dtype=np.int32),
        dom_bits=np.asarray(d["dom_bits"], dtype=np.uint32),
        adj_bits=np.asarray(d["adj_bits"], dtype=np.uint32),
        satisfiable=bool(d["satisfiable"]),
        csr=csr,
        seed_edge=None if seed is None else tuple(int(x) for x in seed),
    )


def build_plan(
    pattern: Graph,
    target: PackedGraph,
    variant: str = "ri-ds-si-fc",
    p_pad: Optional[int] = None,
    max_parents: Optional[int] = None,
    ac_iters: Optional[int] = None,
    domains: Optional[dom_mod.DomainResult] = None,
    anchor: Optional[Tuple[int, ...]] = None,
    csr_factory: Optional[Callable[[], CsrPlanes]] = None,
    seed_edge=None,
) -> SearchPlan:
    """Run preprocessing (domains + ordering) and emit a :class:`SearchPlan`.

    ``domains`` short-circuits the domain pipeline with a precomputed
    :class:`~repro_torch.core.domains.DomainResult` matching the variant's
    flags.  ``anchor`` forces the given pattern node ids to the front of
    the ordering.  ``csr_factory`` supplies the target's CSR planes when the
    plan runs under the csr backend.

    ``seed_edge`` enables edge-centric seeding: ``"auto"`` picks the rarest
    target edge class (:func:`repro_torch.core.ordering.select_seed_edge`
    over ``csr_factory``'s planes when given, else planes derived from the
    dense bitmaps); an explicit ``(u, v, elab)`` pattern-edge triple forces
    the choice.  The edge's endpoints are anchored to ordering positions
    0/1 and recorded on ``SearchPlan.seed_edge``.  Mutually exclusive with
    ``anchor``.
    """
    flags = variant_flags(variant)
    use_ds, use_si = flags["use_ac"], flags["use_si"]
    seed = _resolve_seed_edge(
        pattern, seed_edge,
        csr_factory if csr_factory is not None
        else (lambda: csr_planes_from_bitmaps(target.adj_bits)),
    )
    if domains is not None:
        if domains.bits.shape != (pattern.n, target.w):
            raise ValueError(
                f"precomputed domains shape {domains.bits.shape} != "
                f"{(pattern.n, target.w)}"
            )
        dres = domains
    else:
        dres = dom_mod.compute_domains(
            pattern, target, use_ac=use_ds, use_fc=flags["use_fc"],
            ac_iters=ac_iters, interleave=flags["interleave"],
        )
    return _assemble_plan(
        pattern, dres, variant, use_ds, use_si, p_pad, max_parents,
        n_t=target.n, w=target.w, adj_bits=target.adj_bits, anchor=anchor,
        csr_factory=csr_factory, seed_edge=seed,
    )


def build_csr_plan(
    pattern: Graph,
    target: Graph,
    variant: str = "ri",
    p_pad: Optional[int] = None,
    max_parents: Optional[int] = None,
    w: Optional[int] = None,
    ac_iters: Optional[int] = None,
    domains: Optional[dom_mod.DomainResult] = None,
    use_pallas: bool = False,
    anchor: Optional[Tuple[int, ...]] = None,
    seed_edge=None,
    planes: Optional[CsrPlanes] = None,
    device=None,
) -> SearchPlan:
    """Build a **CSR-only** :class:`SearchPlan` straight from a host
    :class:`Graph`: the dense ``[n_elab, 2, n_t, w]`` adjacency bitmaps are
    never materialized.  ``plan.adj_bits`` is an empty placeholder and
    ``plan.csr`` holds the canonical adjacency planes; only
    ``step_backend="csr"`` (or ``"auto"``) can run the result.

    ``ri`` computes its initial domains on the host; the ``ri-ds*``
    variants run the CSR-native device fixpoint on ``device`` (default: the
    CUDA card; `repro_torch.core.domains.compute_domains_csr`, with K8 and
    K3 when ``use_pallas``).  Domains are bit-identical to :func:`build_plan`
    for the same variant.  ``domains=`` short-circuits with a precomputed
    :class:`~repro_torch.core.domains.DomainResult`; ``planes=`` passes
    already-built :class:`CsrPlanes`.  ``seed_edge`` is as in
    :func:`build_plan`, selected over these planes.
    """
    flags = variant_flags(variant)
    use_ds, use_si = flags["use_ac"], flags["use_si"]
    w = w or n_words(target.n)
    n_elab = target.n_edge_labels
    if planes is None:
        planes = target.csr_planes(n_elab)
    if domains is not None:
        if domains.bits.shape != (pattern.n, w):
            raise ValueError(
                f"precomputed domains shape {domains.bits.shape} != "
                f"{(pattern.n, w)}"
            )
        dres = domains
    else:
        tgt_arrays = (
            dom_mod.csr_target_domain_arrays(target, w, planes=planes, device=device)
            if (use_ds or flags["use_fc"]) else None
        )
        dres = dom_mod.compute_domains_sparse(
            pattern, target, w, use_ac=use_ds, use_fc=flags["use_fc"],
            interleave=flags["interleave"], use_pallas=use_pallas,
            ac_iters=ac_iters, tgt_arrays=tgt_arrays,
        )
    seed = _resolve_seed_edge(pattern, seed_edge, lambda: planes)
    return _assemble_plan(
        pattern, dres, variant, use_ds, use_si, p_pad, max_parents,
        n_t=target.n, w=w, adj_bits=np.zeros((n_elab, 2, 0, w), dtype=np.uint32),
        anchor=anchor, csr=planes, seed_edge=seed,
    )


def _resolve_seed_edge(pattern: Graph, seed_edge, planes_factory):
    """Normalize a ``seed_edge=`` argument to a validated ``(u, v, elab)``
    pattern-edge triple (or ``None``): ``"auto"`` consults
    `repro_torch.core.ordering.select_seed_edge` over the factory's planes;
    an explicit triple must name an existing non-self-loop pattern edge."""
    if seed_edge is None:
        return None
    if isinstance(seed_edge, str):
        if seed_edge != "auto":
            raise ValueError(f"seed_edge={seed_edge!r}; expected 'auto' or a (u, v, elab) triple")
        return ord_mod.select_seed_edge(pattern, planes_factory())
    u, v, lab = (int(x) for x in seed_edge)
    if u == v:
        raise ValueError(f"seed_edge {(u, v, lab)} is a self-loop")
    hit = np.any((pattern.src == u) & (pattern.dst == v) & (pattern.edge_labels == lab))
    if not hit:
        raise ValueError(f"seed_edge {(u, v, lab)} is not a pattern edge")
    return (u, v, lab)


def _assemble_plan(
    pattern: Graph,
    dres: dom_mod.DomainResult,
    variant: str,
    use_ds: bool,
    use_si: bool,
    p_pad: Optional[int],
    max_parents: Optional[int],
    n_t: int,
    w: int,
    adj_bits: np.ndarray,
    anchor: Optional[Tuple[int, ...]] = None,
    csr: Optional[CsrPlanes] = None,
    csr_factory: Optional[Callable[[], CsrPlanes]] = None,
    seed_edge: Optional[Tuple[int, int, int]] = None,
) -> SearchPlan:
    """Ordering + padded-array assembly shared by :func:`build_plan` and
    :func:`build_csr_plan`."""
    dom_sizes = popcount(dres.bits)

    # the seed edge's endpoints become the forced ordering prefix (0/1)
    if seed_edge is not None:
        if anchor is not None:
            raise ValueError("anchor= and seed_edge= are mutually exclusive")
        anchor = (seed_edge[0], seed_edge[1])

    # RI ignores domains when ordering; RI-DS places singletons first (but its
    # greedy tie-break does not see domain sizes); SI adds the size tie-break.
    if anchor is not None:
        ordering = ord_mod.greatest_constraint_first(
            pattern,
            domain_sizes=dom_sizes if use_si else None,
            seed_order=tuple(anchor),
        )
    elif use_si:
        ordering = ord_mod.greatest_constraint_first(
            pattern, domain_sizes=dom_sizes, singleton_first=True
        )
    elif use_ds:
        # expose only singleton-ness, so placement matches RI-DS while the
        # greedy tie-break stays size-blind (all non-singletons look equal).
        flat = np.where(dom_sizes == 1, 1, 2).astype(np.int64)
        ordering = ord_mod.greatest_constraint_first(
            pattern, domain_sizes=flat, singleton_first=True
        )
    else:
        ordering = ord_mod.greatest_constraint_first(pattern)

    n_p = pattern.n
    p_pad = max(p_pad or n_p, n_p, 1)
    ppos, pdir, pelab, pcnt = ordering.parent_arrays(max_parents)
    mp = ppos.shape[1]

    order = np.full(p_pad, -1, dtype=np.int32)
    order[:n_p] = ordering.order
    parent_pos = np.full((p_pad, mp), -1, dtype=np.int32)
    parent_pos[:n_p] = ppos
    parent_dir = np.zeros((p_pad, mp), dtype=np.int32)
    parent_dir[:n_p] = pdir
    parent_elab = np.zeros((p_pad, mp), dtype=np.int32)
    parent_elab[:n_p] = pelab
    n_parents = np.zeros(p_pad, dtype=np.int32)
    n_parents[:n_p] = pcnt

    dom_pos = np.zeros((p_pad, w), dtype=np.uint32)
    dom_pos[:n_p] = dres.bits[ordering.order]

    return SearchPlan(
        variant=variant,
        n_p=n_p,
        p_pad=p_pad,
        n_t=n_t,
        w=w,
        order=order,
        parent_pos=parent_pos,
        parent_dir=parent_dir,
        parent_elab=parent_elab,
        n_parents=n_parents,
        dom_bits=dom_pos,
        adj_bits=adj_bits,
        satisfiable=dres.satisfiable,
        csr=csr,
        csr_factory=csr_factory,
        domains=dres,
        seed_edge=seed_edge,
    )
