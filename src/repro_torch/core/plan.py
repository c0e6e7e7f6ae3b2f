"""SearchPlan — the static preprocessing product handed to the engine.

A copy of the dense half of ``repro.core.plan``.  Ordering and domains run
on the host in numpy (domains from the numpy oracle
`repro_torch.core.domains.compute_domains`); the engine uploads the arrays
once per query (`repro_torch.core.extend.make_plan_arrays`).

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
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import domains as dom_mod
from repro_torch.core import ordering as ord_mod
from repro_torch.core.graph import Graph, PackedGraph, popcount

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
    adj_bits: np.ndarray  # [n_elab, 2, n_t, w] uint32
    satisfiable: bool
    domains: Optional[dom_mod.DomainResult] = dataclasses.field(
        default=None, compare=False, repr=False
    )

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
    "satisfiable",
)


def plan_from_numpy(d: Mapping[str, object]) -> SearchPlan:
    """Build a port :class:`SearchPlan` from another plan's arrays.

    ``d`` maps each name of :data:`PLAN_ARRAY_FIELDS` to a numpy array or a
    plain value, for example ``{f: getattr(p, f) for f in
    PLAN_ARRAY_FIELDS}`` of a ``repro`` ``SearchPlan``.  Feeding one plan to
    both engines keeps an engine mismatch from hiding behind a
    preprocessing mismatch."""
    missing = [f for f in PLAN_ARRAY_FIELDS if f not in d]
    if missing:
        raise KeyError(f"plan arrays missing {missing}")
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
    seed_edge=None,
) -> SearchPlan:
    """Run preprocessing (domains + ordering) and emit a :class:`SearchPlan`.

    ``domains`` short-circuits the domain pipeline with a precomputed
    :class:`~repro_torch.core.domains.DomainResult` matching the variant's
    flags.  ``anchor`` forces the given pattern node ids to the front of
    the ordering.  Edge-centric seeding (``seed_edge``) is not ported yet.
    """
    if seed_edge is not None:
        raise NotImplementedError(
            "seed_edge= (edge-centric seeding) is not ported yet: "
            "ROADMAP Queue 1 item 8"
        )
    flags = variant_flags(variant)
    use_ds, use_si = flags["use_ac"], flags["use_si"]
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
    )


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
) -> SearchPlan:
    """Ordering + padded-array assembly."""
    dom_sizes = popcount(dres.bits)

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
        domains=dres,
    )
