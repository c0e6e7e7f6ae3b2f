"""The expansion step — candidate bitmaps, lowest-untried-bit extraction,
child emission, match counting — behind the step-backend seam.

One expansion step, for every popped lane: extract the lowest untried
candidate bit ``v``, extend the mapping, build the child's candidate
bitmap ``dom[pos+1] ∧ ¬used' ∧ ⋀ adj_rows(mapped parents)`` (the paper's
check-consistency-before-spawning rule, §3.1), and flag matches at full
depth.  The step flattens all ``V·expand_width`` lanes into one batch, so a
kernel sees one launch of ``V·expand_width`` blocks.  A port of
``repro.core.extend``; the backend names are ``repro``'s:

* ``"jnp"`` — :class:`JnpStepBackend`, plain PyTorch ops; with
  ``EngineConfig.use_pallas`` the candidate AND goes through the
  ``candidate_mask`` kernel (K2).
* ``"pallas"`` — :class:`PallasStepBackend`, the fused ``extend_step``
  kernel (K1): extraction, the AND-tree and match flagging in one launch.
* ``"csr"`` — :class:`CsrStepBackend`, the sparse layout
  (:class:`CsrPlanArrays`): instead of ANDing dense ``[n_t, w]`` adjacency
  rows, the first mapped parent's CSR segment proposes candidates and a
  binary search in every other parent's sorted segment keeps them.  With
  ``use_pallas`` the whole step is the ``csr_extend_bucketed`` kernel (K7,
  ``csr_walk="bucketed"``) or ``csr_extend`` (K6, ``csr_walk="flat"``).
* ``"auto"`` — resolves per plan: ``"csr"`` past :data:`CSR_AUTO_NT`
  target nodes (and always for a CSR-only plan), else ``"jnp"``.

All are bit-identical on every :class:`StepLanes` field the engine
consumes.  On CPU tensors the kernels run their plain versions.

``"partitioned"`` — :class:`PartitionedCsrStepBackend`, the out-of-core
step over one resident row partition of the target
(:class:`PartPlanArrays`): the csr walk (K7 / K6 with ``use_pallas``) with
the parents whose rows are not resident left out, so a child that still
owes them an intersection is flagged for the spill ring
(:func:`make_partitioned_step_fn`).  It is not a drop-in backend: only
``repro_torch.core.engine.run_partitioned`` drives it.

A step covers a whole **pack** of queries that share one target
(`repro_torch.core.frontier`): their plan arrays are stacked along the
position axis (:func:`make_pack_arrays`, :func:`make_csr_pack_arrays`),
each lane's child position is offset by its query's ``lane · p_pad``, and
so one kernel launch per step serves every lane of the pack.  A single
query is the pack of one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, Sequence, Tuple, TYPE_CHECKING, Union

import numpy as np
import torch

from repro_torch.core import frontier
from repro_torch.core.frontier import EngineState, SpillState
from repro_torch.core.graph import (
    WORD_BITS, CsrPlanes, PartitionedPlanes, bitmap_from_indices, csr_planes_from_bitmaps,
    deg_bucket_caps, partition_csr_planes,
)
from repro_torch.core.plan import SearchPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import lowest_bit

if TYPE_CHECKING:  # engine imports extend
    from repro_torch.core.engine import EngineConfig

# the drop-in step backends; EngineConfig also takes "auto" and
# "partitioned" (run only by engine.run_partitioned), as in repro
STEP_BACKENDS = ("jnp", "pallas", "csr")

# "auto" resolution threshold: beyond this many target nodes the dense
# [n_elab, 2, n_t, w] bitmaps cost O(n_t²/32) words (PDBSv1's 33,067
# nodes: ~273 MB) and the sparse layout takes over.
CSR_AUTO_NT = 32768

# int32 sentinel for padded CSR segment slots: larger than any node id, so
# sentinel-masked segments stay sorted for the binary search.
CSR_SENTINEL = np.int32(2**31 - 1)


def resolve_step_backend(cfg: "EngineConfig", n_t: int) -> str:
    """Resolve ``cfg.step_backend`` for a plan with ``n_t`` target nodes:
    ``"auto"`` picks ``"csr"`` past :data:`CSR_AUTO_NT` (an explicit backend
    always wins)."""
    if cfg.step_backend != "auto":
        return cfg.step_backend
    return "csr" if n_t > CSR_AUTO_NT else "jnp"


class PlanArrays(NamedTuple):
    """Device-resident static plan arrays of a pack of ``L`` queries (see
    SearchPlan), stacked along the position axis: query ``l``'s position
    ``i`` is row ``l · p_pad + i``.

    ``rows`` is the flattened adjacency with the all-ones neutral row
    appended (what the kernels take); ``adj_bits`` is a view of it, so the
    target is on the device once, shared by the pack."""

    order_valid: torch.Tensor  # [L * p_pad] bool (True for real positions)
    parent_pos: torch.Tensor  # [L * p_pad, mp] int32
    parent_dir: torch.Tensor  # [L * p_pad, mp] int32
    parent_elab: torch.Tensor  # [L * p_pad, mp] int32
    dom_bits: torch.Tensor  # [L * p_pad, w] int32
    adj_bits: torch.Tensor  # [n_elab, 2, n_t, w] int32, a view of rows[:-1]
    rows: torch.Tensor  # [n_elab * 2 * n_t + 1, w] int32
    n_p: torch.Tensor  # [L] int32 actual pattern size per query
    p_pad: int  # padded positions per query
    n_p_max: int  # the largest n_p of the pack


def bits_to_tensor(bits: np.ndarray, device) -> torch.Tensor:
    """A uint32 bitmap array as an int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint32).view(np.int32)).to(device)


def upload_rows(adj_bits: np.ndarray, device) -> torch.Tensor:
    """The kernels' flattened adjacency (``[n_elab * 2 * n_t + 1, w]``,
    neutral row last) on ``device``, from ``[n_elab, 2, n_t, w]`` bitmaps."""
    return kops.flatten_adj_rows(bits_to_tensor(adj_bits, device))


def make_plan_arrays(plan: SearchPlan, device, rows: Optional[torch.Tensor] = None) -> PlanArrays:
    """Upload ``plan`` as a pack of one (see :func:`make_pack_arrays`)."""
    return make_pack_arrays([plan], device, rows=rows)


def _stack_plans(plans: Sequence[SearchPlan], device) -> dict:
    """The per-query plan arrays of a pack, stacked along the position axis
    (the fields :class:`PlanArrays` and :class:`CsrPlanArrays` share)."""
    first = plans[0]
    for p in plans[1:]:
        if p.parent_pos.shape != first.parent_pos.shape or p.dom_bits.shape != first.dom_bits.shape:
            raise ValueError("a pack's plans must share p_pad, max_parents and w")

    def cat_i32(name):
        a = np.concatenate([np.asarray(getattr(p, name), dtype=np.int32) for p in plans])
        return torch.from_numpy(a).to(device)

    n_p = [p.n_p for p in plans]
    return dict(
        order_valid=torch.from_numpy(np.concatenate([p.order >= 0 for p in plans])).to(device),
        parent_pos=cat_i32("parent_pos"),
        parent_dir=cat_i32("parent_dir"),
        parent_elab=cat_i32("parent_elab"),
        dom_bits=bits_to_tensor(np.concatenate([p.dom_bits for p in plans]), device),
        n_p=torch.tensor(n_p, dtype=torch.int32, device=device),
        p_pad=first.p_pad,
        n_p_max=max(n_p),
    )


def make_pack_arrays(plans: Sequence[SearchPlan], device,
                     rows: Optional[torch.Tensor] = None) -> PlanArrays:
    """Upload the plans of one pack, stacked along the position axis.

    The plans must share their padding and their target adjacency (one
    ``adj_bits`` object, or equal ones): the pack reads one copy.  ``rows``
    optionally supplies that copy already uploaded (:func:`upload_rows`),
    the dominant transfer, so every plan of one target shares it."""
    first = plans[0]
    for p in plans[1:]:
        if p.adj_bits is not first.adj_bits and not np.array_equal(p.adj_bits, first.adj_bits):
            raise ValueError("a pack's plans must share one target adjacency")
    stacked = _stack_plans(plans, device)
    if rows is None:
        rows = upload_rows(first.adj_bits, device)
    return PlanArrays(adj_bits=rows[:-1].view(first.adj_bits.shape), rows=rows, **stacked)


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _abstract_plan_fields(w: int, p_pad: int, max_parents: int) -> dict:
    """The fields :class:`PlanArrays` and :class:`CsrPlanArrays` share, for
    a pack of one, as ``device="meta"`` tensors."""
    return dict(
        order_valid=_meta(p_pad, dtype=torch.bool),
        parent_pos=_meta(p_pad, max_parents),
        parent_dir=_meta(p_pad, max_parents),
        parent_elab=_meta(p_pad, max_parents),
        dom_bits=_meta(p_pad, w),
        n_p=_meta(1),
        p_pad=p_pad,
        n_p_max=p_pad,
    )


def abstract_plan_arrays(n_t: int, w: int, p_pad: int, max_parents: int,
                         n_elab: int = 1) -> PlanArrays:
    """A pack of one's :class:`PlanArrays` as ``device="meta"`` tensors (no
    storage): ``repro``'s shapes, ``n_p`` as ``[1]``, bitmap words
    ``int32``, ``adj_bits`` a view of ``rows``.  The pattern size is
    unknown, so ``n_p_max`` is ``p_pad``."""
    rows = _meta(n_elab * 2 * n_t + 1, w)
    return PlanArrays(adj_bits=rows[:-1].view(n_elab, 2, n_t, w), rows=rows,
                      **_abstract_plan_fields(w, p_pad, max_parents))


PLAN_LOGICAL = PlanArrays(
    order_valid=(None,),
    parent_pos=(None, None),
    parent_dir=(None, None),
    parent_elab=(None, None),
    dom_bits=(None, "tensor"),
    adj_bits=(None, None, None, "tensor"),
    rows=(None, "tensor"),
    n_p=(None,),
    p_pad=None,
    n_p_max=None,
)


# ---------------------------------------------------------------------------
# CSR plan arrays (the sparse twin of PlanArrays)
# ---------------------------------------------------------------------------

class CsrUpload(NamedTuple):
    """A target's CSR planes on the device, as the sparse step reads them:
    ``indptr`` ``[n_planes, n_t + 1]`` (global offsets) and ``indices``
    ``[nnz_pad + deg_cap]``, over-padded with :data:`CSR_SENTINEL` so a
    ``deg_cap``-wide window from any row start stays inside it."""

    indptr: torch.Tensor  # [n_planes, n_t + 1] int32
    indices: torch.Tensor  # [nnz_pad + deg_cap] int32
    deg_cap: int  # padded max row length


class CsrPlanArrays(NamedTuple):
    """Device-resident plan arrays of a pack of ``L`` queries in CSR
    adjacency layout: :class:`PlanArrays` with the dense ``adj_bits`` /
    ``rows`` replaced by the target's CSR planes (one copy for the pack).
    ``deg_cap`` is ``repro``'s ``seg_iota`` length."""

    order_valid: torch.Tensor  # [L * p_pad] bool
    parent_pos: torch.Tensor  # [L * p_pad, mp] int32
    parent_dir: torch.Tensor  # [L * p_pad, mp] int32
    parent_elab: torch.Tensor  # [L * p_pad, mp] int32
    dom_bits: torch.Tensor  # [L * p_pad, w] int32
    indptr: torch.Tensor  # [n_planes, n_t + 1] int32, global offsets
    indices: torch.Tensor  # [nnz_pad + deg_cap] int32, sentinel-padded tail
    deg_cap: int  # padded max row length
    n_p: torch.Tensor  # [L] int32 actual pattern size per query
    p_pad: int
    n_p_max: int


def _pad_deg_cap(deg_cap: int) -> int:
    """Segment-walk width: max row degree snapped up to a multiple of 8
    (min 8), as ``repro`` pads it."""
    return max(8, ((deg_cap + 7) // 8) * 8)


def _pad_nnz(nnz: int) -> int:
    """nnz shape bucket (multiples of 1024), as ``repro`` pads it."""
    return max(1024, ((nnz + 1023) // 1024) * 1024)


def abstract_csr_plan_arrays(n_t: int, w: int, p_pad: int, max_parents: int,
                             n_elab: int = 1, nnz: int = 0,
                             deg_cap: int = 8) -> CsrPlanArrays:
    """A pack of one's :class:`CsrPlanArrays` as ``device="meta"`` tensors,
    padded as :func:`upload_csr` pads ``nnz`` entries of rows at most
    ``deg_cap`` long (``deg_cap`` stands for ``repro``'s ``seg_iota``)."""
    deg_cap = _pad_deg_cap(deg_cap)
    return CsrPlanArrays(indptr=_meta(n_elab * 2, n_t + 1),
                         indices=_meta(_pad_nnz(nnz) + deg_cap), deg_cap=deg_cap,
                         **_abstract_plan_fields(w, p_pad, max_parents))


CSR_PLAN_LOGICAL = CsrPlanArrays(
    order_valid=(None,),
    parent_pos=(None, None),
    parent_dir=(None, None),
    parent_elab=(None, None),
    dom_bits=(None, "tensor"),
    indptr=(None, None),
    indices=(None,),
    deg_cap=None,
    n_p=(None,),
    p_pad=None,
    n_p_max=None,
)


def plan_csr(plan: SearchPlan) -> CsrPlanes:
    """The plan's CSR planes, resolved once and cached on the plan:
    ``plan.csr`` (CSR-only plans) wins, then ``plan.csr_factory`` (plans
    built by a session share their index's planes), then a conversion of
    the dense bitmaps."""
    cp = plan.csr
    if cp is None:
        if plan.csr_factory is not None:
            cp = plan.csr_factory()
        else:
            cp = csr_planes_from_bitmaps(np.asarray(plan.adj_bits))
        plan.csr = cp  # cache: the conversion is O(n_t · w) host work
    return cp


def upload_csr(planes: CsrPlanes, device) -> CsrUpload:
    """``planes`` padded as ``repro``'s ``make_csr_plan_arrays`` pads them,
    on ``device``."""
    deg_cap = _pad_deg_cap(planes.deg_cap)
    indices = np.full(_pad_nnz(planes.nnz) + deg_cap, CSR_SENTINEL, dtype=np.int32)
    indices[: planes.nnz] = planes.indices
    return CsrUpload(
        indptr=torch.from_numpy(np.ascontiguousarray(planes.indptr, dtype=np.int32)).to(device),
        indices=torch.from_numpy(indices).to(device),
        deg_cap=deg_cap,
    )


def make_csr_plan_arrays(plan: SearchPlan, device,
                         csr: Optional[CsrUpload] = None) -> CsrPlanArrays:
    """Upload ``plan`` in CSR layout as a pack of one (see
    :func:`make_csr_pack_arrays`)."""
    return make_csr_pack_arrays([plan], device, csr=csr)


def make_csr_pack_arrays(plans: Sequence[SearchPlan], device,
                         csr: Optional[CsrUpload] = None) -> CsrPlanArrays:
    """Upload the plans of one pack in CSR layout, stacked along the
    position axis.  The plans must share their padding and their target
    (checked on the planes unless ``csr``, the target's planes already
    uploaded by :func:`upload_csr`, is given).  CSR-only plans use their
    planes directly; dense-built plans derive them (:func:`plan_csr`),
    bit for bit the same adjacency relation."""
    stacked = _stack_plans(plans, device)
    if csr is None:
        cp = plan_csr(plans[0])
        for p in plans[1:]:
            other = plan_csr(p)
            if other is not cp and not (np.array_equal(other.indptr, cp.indptr)
                                        and np.array_equal(other.indices, cp.indices)):
                raise ValueError("a pack's plans must share one target adjacency")
        csr = upload_csr(cp, device)
    return CsrPlanArrays(indptr=csr.indptr, indices=csr.indices, deg_cap=csr.deg_cap,
                         **stacked)


# ---------------------------------------------------------------------------
# partitioned plan arrays (out-of-core targets)
# ---------------------------------------------------------------------------

class PartPlanArrays(NamedTuple):
    """Device-resident plan arrays of one query for **one resident
    partition** of a row-partitioned target (:class:`PartitionedPlanes`).

    :class:`CsrPlanArrays` with the plane rows restricted to the resident
    partition: ``indptr`` is over partition-**local** rows (global row
    ``t`` is local row ``t - part_lo``); ``indices`` keep **global** column
    ids.  Every partition of a target is padded to the same shapes
    (``max_local`` rows, ``max_nnz`` entries), as ``repro`` pads them for
    one compile.  ``part_lo`` / ``part_hi`` bound the resident global rows
    and ``part_starts`` routes spill entries to the partition owning their
    first pending parent."""

    order_valid: torch.Tensor  # [p_pad] bool
    parent_pos: torch.Tensor  # [p_pad, mp] int32
    parent_dir: torch.Tensor  # [p_pad, mp] int32
    parent_elab: torch.Tensor  # [p_pad, mp] int32
    dom_bits: torch.Tensor  # [p_pad, w] int32
    indptr: torch.Tensor  # [n_planes, max_loc_pad + 1] int32, local rows
    indices: torch.Tensor  # [nnz_pad + deg_cap] int32, global columns
    deg_cap: int  # padded max row length over all partitions
    part_starts: torch.Tensor  # [n_parts + 1] int32 global row boundaries
    part_lo: int  # resident range start (global row)
    part_hi: int  # resident range end (exclusive)
    n_p: torch.Tensor  # [1] int32
    p_pad: int
    n_p_max: int


AnyPlanArrays = Union[PlanArrays, CsrPlanArrays, PartPlanArrays]


def _pad_rows(n: int) -> int:
    """Local-row shape bucket (multiples of 64, min 64), as ``repro`` pads
    it so all partitions of a target share one shape."""
    return max(64, ((n + 63) // 64) * 64)


def _partition_cache(plan: SearchPlan) -> dict:
    cache = getattr(plan, "_partitions", None)
    if cache is None:
        cache = plan._partitions = {}
    return cache


def plan_partitions(plan: SearchPlan, n_parts: int) -> PartitionedPlanes:
    """The plan's target partitioning at ``n_parts``, computed once and
    cached on the plan (partitioning is O(nnz) host work per count)."""
    cache = _partition_cache(plan)
    pp = cache.get(n_parts)
    if pp is None:
        pp = cache[n_parts] = partition_csr_planes(plan_csr(plan), n_parts=n_parts)
    return pp


def plan_partitions_budget(plan: SearchPlan, max_bytes: int) -> PartitionedPlanes:
    """Partitioning at the smallest count whose **padded** resident plane
    arrays (:func:`part_resident_nbytes`, what the device holds) fit
    ``max_bytes``; cached on the plan under both the budget and the
    resulting count, so ``plan_partitions(plan, pp.n_parts)`` returns the
    same object."""
    cache = _partition_cache(plan)
    key = ("budget", int(max_bytes))
    pp = cache.get(key)
    if pp is None:
        cp = plan_csr(plan)
        pp = partition_csr_planes(cp, max_bytes=max_bytes)
        while part_resident_nbytes(pp) > max_bytes and pp.n_parts < cp.n_t:
            pp = partition_csr_planes(cp, n_parts=pp.n_parts + 1)
        if part_resident_nbytes(pp) > max_bytes:
            raise ValueError(
                f"memory_budget_bytes={max_bytes} cannot hold even a "
                f"single-row partition's padded planes "
                f"({part_resident_nbytes(pp)} bytes at n_parts={pp.n_parts})"
            )
        cache[key] = pp
        cache.setdefault(pp.n_parts, pp)
    return pp


def partitioned_shape_bucket(plan: SearchPlan, n_parts: int) -> Tuple[int, ...]:
    """``(n_parts, max_loc_pad, nnz_pad, *bucket_caps)``: the partition
    identity ``repro``'s session folds into its compile-cache and coalesce
    keys (the trailing entries are the pow2 degree-bucket ladder, as in
    :func:`csr_shape_bucket`)."""
    pp = plan_partitions(plan, n_parts)
    return (
        pp.n_parts,
        _pad_rows(pp.max_local),
        _pad_nnz(pp.max_nnz),
    ) + deg_bucket_caps(_pad_deg_cap(pp.deg_cap))


def part_resident_nbytes(pp: PartitionedPlanes) -> int:
    """Device bytes of one resident partition's padded plane arrays
    (``indptr`` + ``indices`` + ``part_starts``), what the memory budget
    bounds; slightly above ``PartitionedPlanes.max_resident_nbytes``
    because of the shared-shape padding."""
    max_loc_pad = _pad_rows(pp.max_local)
    nnz_pad = _pad_nnz(pp.max_nnz)
    deg_cap = _pad_deg_cap(pp.deg_cap)
    return 4 * (pp.n_planes * (max_loc_pad + 1) + nnz_pad + deg_cap + pp.n_parts + 1)


def make_part_plan_arrays(plan: SearchPlan, pp: PartitionedPlanes, pid: int,
                          device) -> PartPlanArrays:
    """Upload ``plan`` with partition ``pid`` of ``pp`` resident, on
    ``device``.  All partitions pad to common shapes (see
    :class:`PartPlanArrays`): padded local rows repeat the plane's end
    offset (zero-length rows), padded ``indices`` entries are
    :data:`CSR_SENTINEL`."""
    part = pp.parts[pid]
    max_loc_pad = _pad_rows(pp.max_local)
    deg_cap = _pad_deg_cap(pp.deg_cap)
    n_loc = part.n_t
    indptr = np.zeros((pp.n_planes, max_loc_pad + 1), dtype=np.int32)
    indptr[:, : n_loc + 1] = part.indptr
    indptr[:, n_loc + 1 :] = part.indptr[:, -1:]
    indices = np.full(_pad_nnz(pp.max_nnz) + deg_cap, CSR_SENTINEL, dtype=np.int32)
    indices[: part.nnz] = part.indices
    return PartPlanArrays(
        indptr=torch.from_numpy(indptr).to(device),
        indices=torch.from_numpy(indices).to(device),
        deg_cap=deg_cap,
        part_starts=torch.from_numpy(pp.node_start.astype(np.int32)).to(device),
        part_lo=int(pp.node_start[pid]),
        part_hi=int(pp.node_start[pid + 1]),
        **_stack_plans([plan], device),
    )


def is_csr_only(plan: SearchPlan) -> bool:
    """True for plans built by ``build_csr_plan``: the dense adjacency was
    never materialized, so only the csr layout can run them."""
    return plan.csr is not None and plan.adj_bits.shape[2] == 0


def resolve_step_backend_for_plan(cfg: "EngineConfig", plan: SearchPlan) -> str:
    """:func:`resolve_step_backend` with the plan in hand: a CSR-only plan
    has no dense layout, so ``"auto"`` always resolves to ``"csr"`` for it."""
    if is_csr_only(plan) and cfg.step_backend == "auto":
        return "csr"
    return resolve_step_backend(cfg, plan.n_t)


def step_kernels(cfg: "EngineConfig", plan: SearchPlan) -> Tuple[str, ...]:
    """The kernels whose libraries a run of ``plan`` under ``cfg`` launches
    in its steps: K1 under ``"pallas"``, K2 under ``"jnp"`` with
    ``use_pallas``, K7 or K6 (by ``csr_walk``) under ``"csr"`` and
    ``"partitioned"`` with ``use_pallas``; none on the plain paths."""
    resolved = resolve_step_backend_for_plan(cfg, plan)
    if resolved == "pallas":
        return ("extend_step",)
    if not cfg.use_pallas:
        return ()
    if resolved == "jnp":
        return ("candidate_mask",)
    return ("csr_extend_bucketed",) if cfg.csr_walk == "bucketed" else ("csr_extend",)


def validate_backend_for_plan(cfg: "EngineConfig", plan: SearchPlan) -> None:
    """Fail fast when an explicitly dense step backend is asked to run a
    CSR-only plan (the session calls this at prepare and run entry)."""
    if cfg.step_backend in ("jnp", "pallas") and is_csr_only(plan):
        raise ValueError(
            f"step_backend={cfg.step_backend!r} is a dense backend, but the "
            "plan is CSR-only (layout: csr — built by build_csr_plan, so "
            "dense adj_bits were never materialized); valid backends for "
            "this plan are 'csr', 'auto', or 'partitioned'"
        )


def plan_arrays_for(cfg: "EngineConfig", plans: Sequence[SearchPlan], device,
                    rows: Optional[torch.Tensor] = None,
                    csr: Optional[CsrUpload] = None) -> AnyPlanArrays:
    """The one plan-array construction point: dense :class:`PlanArrays` or
    sparse :class:`CsrPlanArrays` for a pack, per the step backend resolved
    for its first plan (a pack shares one target, so one resolution).
    ``rows`` / ``csr`` pass the target already uploaded in that layout."""
    resolved = resolve_step_backend_for_plan(cfg, plans[0])
    if resolved == "partitioned":
        raise ValueError(
            "step_backend='partitioned' builds per-partition arrays inside "
            "repro_torch.core.engine.run_partitioned (one PartPlanArrays per "
            "swap), not one plan-array set"
        )
    if resolved == "csr":
        return make_csr_pack_arrays(plans, device, csr=csr)
    if is_csr_only(plans[0]):
        raise ValueError(
            "plan is CSR-only (built by build_csr_plan: dense adj_bits were "
            "never materialized) — run it with step_backend='csr' or 'auto'"
        )
    return make_pack_arrays(plans, device, rows=rows)


def csr_shape_bucket(plan: SearchPlan) -> Tuple[int, ...]:
    """``(nnz_pad, *bucket_caps)``: the padded shape of a plan's CSR arrays
    with the pow2 degree-bucket ladder, ``repro``'s extra pack key under the
    csr backend."""
    cp = plan_csr(plan)
    return (_pad_nnz(cp.nnz),) + deg_bucket_caps(_pad_deg_cap(cp.deg_cap))


# ---------------------------------------------------------------------------
# bit helpers (batched over lanes; repro vmaps the one-lane forms)
# ---------------------------------------------------------------------------

def pop_lowest_bit(cand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extract the lowest set bit of each row of a ``[B, W]`` bitmap.

    Returns ``(valid, v, cand_without_v)``; ``v`` is the global bit index.
    """
    w = cand.shape[1]
    valid, widx, v, lowbit = lowest_bit(cand)
    sel = (torch.arange(w, device=cand.device)[None, :] == widx[:, None]) & valid[:, None]
    return valid, v, cand ^ torch.where(sel, lowbit[:, None], 0)


def bit_row(v: torch.Tensor, w: int) -> torch.Tensor:
    """One-hot ``[B, w]`` bitmaps with bit ``v[b]`` set (``v >= 0``)."""
    bit = torch.ones_like(v) << (v % WORD_BITS)
    hit = torch.arange(w, device=v.device)[None, :] == (v // WORD_BITS)[:, None]
    return torch.where(hit, bit[:, None], 0)


def compute_cand(
    plan: PlanArrays, row: torch.Tensor, map_: torch.Tensor, used: torch.Tensor
) -> torch.Tensor:
    """Candidate bitmaps ``[B, W]`` for the stacked plan rows ``row``
    (``lane · p_pad + position``) given the mappings and used-bitmaps, in
    plain PyTorch:
    ``dom[row] ∧ ¬used ∧ ⋀_parents adj_bits[elab, dir, mapped_parent]``."""
    n_t = plan.adj_bits.shape[2]
    safe_pos = row.long()
    cand = plan.dom_bits[safe_pos] & ~used
    pp, pd, pl = (a[safe_pos] for a in (plan.parent_pos, plan.parent_dir, plan.parent_elab))
    for j in range(pp.shape[1]):
        real = pp[:, j] >= 0
        t = torch.where(real, map_.gather(1, pp[:, j:j + 1].clamp_min(0).long())[:, 0], 0)
        row = plan.adj_bits[pl[:, j].long(), pd[:, j].long(), t.clamp(0, n_t - 1).long()]
        cand = torch.where(real[:, None], cand & row, cand)
    return cand


def host_cand_bitmap(plan: SearchPlan, pos: int, mapping: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of :func:`compute_cand` for one entry.

    ``mapping`` is a ``[p_pad]`` int array whose positions ``< pos`` hold the
    partial embedding (-1 elsewhere); returns the ``[w]`` uint32 candidate
    bitmap ``dom[pos] ∧ ¬used ∧ ⋀_parents adj_row`` with exactly the
    engine's semantics.  Root seeding (`repro_torch.core.frontier`) uses it
    to build engine seeds, whose candidate bitmaps the engine trusts and
    never re-checks.  Works for dense and CSR-only plans.
    """
    pos = int(pos)
    prefix = np.asarray(mapping[:pos], dtype=np.int64)
    used = bitmap_from_indices(prefix[prefix >= 0], plan.n_t, plan.w)
    cand = plan.dom_bits[pos] & ~used
    dense = plan.adj_bits.shape[2] > 0
    cp = None if dense else plan_csr(plan)
    for j in range(plan.max_parents):
        pp = int(plan.parent_pos[pos, j])
        if pp < 0:
            continue
        t = int(mapping[pp])
        pd = int(plan.parent_dir[pos, j])
        pl = int(plan.parent_elab[pos, j])
        if dense:
            row = plan.adj_bits[pl, pd, t]
        else:
            plane = pl * 2 + pd
            s, e = int(cp.indptr[plane, t]), int(cp.indptr[plane, t + 1])
            row = bitmap_from_indices(cp.indices[s:e], plan.n_t, plan.w)
        cand = cand & row
    return cand


def _extend_payload(depth, map_, used, valid, v, p_pad, w):
    """``(map2, used2)``: the child's mapping (``v`` at position ``depth``)
    and used-bitmap (``used ∨ bit(v)``), unchanged on invalid lanes."""
    col = torch.arange(p_pad, device=depth.device)[None, :] == depth.clamp(0, p_pad - 1)[:, None]
    map2 = torch.where(valid[:, None] & col, v[:, None], map_)
    used2 = torch.where(valid[:, None], used | bit_row(v.clamp_min(0), w), used)
    return map2, used2


# ---------------------------------------------------------------------------
# the step-backend seam
# ---------------------------------------------------------------------------

class StepLanes(NamedTuple):
    """Everything one expansion produces per flattened lane ``[B = V·E]``.

    ``v`` is informational (-1 or unspecified on invalid lanes; every
    consumer gates on ``valid``).
    """

    valid: torch.Tensor  # [B] bool — lane had an untried candidate
    v: torch.Tensor  # [B] int32 — extracted target node
    is_match: torch.Tensor  # [B] bool — extension completed the pattern
    has_child: torch.Tensor  # [B] bool — child has a non-empty candidate set
    cand2: torch.Tensor  # [B, W] int32 — parent candidates minus v
    map2: torch.Tensor  # [B, P] int32 — mapping extended with v
    used2: torch.Tensor  # [B, W] int32 — used-bitmap with v set
    child_cand: torch.Tensor  # [B, W] int32 — zeroed unless a child is wanted


class StepBackend(Protocol):
    """One expansion over a flat batch of popped lanes: the ``V·E`` lanes of
    each query of the pack, query after query."""

    name: str

    def expand_lanes(self, depth, map_, used, cand) -> StepLanes:
        ...


class _PackLanes:
    """Per flat lane of a pack's step: the stacked-plan row offset of its
    query (``lane · p_pad``) and that query's pattern size."""

    def __init__(self, cfg: "EngineConfig", plan: PlanArrays):
        self.plan = plan
        self.p_pad, self.w = plan.p_pad, plan.dom_bits.shape[1]
        per_query = cfg.n_workers * cfg.expand_width
        lane = torch.arange(plan.n_p.shape[0], device=plan.n_p.device).repeat_interleave(per_query)
        self.row_base = (lane * self.p_pad).to(torch.int32)
        self.n_p = plan.n_p[lane]

    def rows_at(self, pos: torch.Tensor) -> torch.Tensor:
        """Stacked plan rows of each lane's order position ``pos``."""
        return self.row_base + pos.clamp(0, self.p_pad - 1)


class JnpStepBackend(_PackLanes):
    """Plain PyTorch step (``repro``'s loose-ops reference backend); with
    ``cfg.use_pallas`` the candidate AND runs the ``candidate_mask`` kernel."""

    name = "jnp"

    def __init__(self, cfg: "EngineConfig", plan: PlanArrays):
        super().__init__(cfg, plan)
        self.use_kernel = cfg.use_pallas

    def _compute_cand(self, row, map2, used2):
        plan = self.plan
        if not self.use_kernel:
            return compute_cand(plan, row, map2, used2)
        r = row.long()
        row_idx = kops.flat_row_index(
            plan.parent_pos[r], plan.parent_dir[r], plan.parent_elab[r], map2,
            plan.adj_bits.shape[2], plan.rows.shape[0] - 1,
        )
        return kops.candidate_mask(plan.rows, plan.dom_bits, row.to(torch.int32),
                                   row_idx, used2)

    def expand_lanes(self, depth, map_, used, cand) -> StepLanes:
        valid, v, cand2 = pop_lowest_bit(cand)
        map2, used2 = _extend_payload(depth, map_, used, valid, v, self.p_pad, self.w)
        is_match = valid & (depth + 1 >= self.n_p)
        want_child = valid & ~is_match
        child = self._compute_cand(self.rows_at(torch.where(want_child, depth + 1, 0)),
                                   map2, used2)
        child = torch.where(want_child[:, None], child, 0)
        has_child = want_child & (child != 0).any(dim=-1)
        return StepLanes(valid, v, is_match, has_child, cand2, map2, used2, child)


class PallasStepBackend(_PackLanes):
    """The fused step: one ``extend_step`` kernel launch per expansion.

    PyTorch only computes what the kernel's inputs need up front — the
    extracted ``v`` feeds the adjacency-row table — and the cheap ``map2`` /
    ``used2`` payloads; all other ``w``-wide work is in the kernel.

    The kernel takes one pattern size; a pack's queries may differ, so each
    lane's depth is shifted by ``n_p_max - n_p`` of its query, which keeps
    ``depth + 1 >= n_p`` (the only use of ``depth`` in the kernel) exact."""

    name = "pallas"

    def __init__(self, cfg: "EngineConfig", plan: PlanArrays):
        super().__init__(cfg, plan)
        self.depth_shift = plan.n_p_max - self.n_p

    def expand_lanes(self, depth, map_, used, cand) -> StepLanes:
        plan = self.plan
        valid, v, _ = pop_lowest_bit(cand)
        map2, used2 = _extend_payload(depth, map_, used, valid, v, self.p_pad, self.w)
        child_row = self.rows_at(depth + 1)
        cr = child_row.long()
        row_idx = kops.flat_row_index(
            plan.parent_pos[cr], plan.parent_dir[cr], plan.parent_elab[cr], map2,
            plan.adj_bits.shape[2], plan.rows.shape[0] - 1,
        )
        cand2, child, meta = kops.extend_step(
            plan.rows, plan.dom_bits, child_row.to(torch.int32), row_idx,
            (depth + self.depth_shift).to(torch.int32), plan.n_p_max, used, cand,
        )
        return StepLanes(
            valid=meta[:, 0] != 0,
            v=meta[:, 1],
            is_match=meta[:, 2] != 0,
            has_child=meta[:, 3] != 0,
            cand2=cand2,
            map2=map2,
            used2=used2,
            child_cand=child,
        )


class CsrStepBackend(_PackLanes):
    """The sparse step: child candidates come from a CSR walk instead of the
    dense-row AND-tree.

    Per lane, the lead (first mapped) parent's segment proposes
    candidates; each survives iff its bit is set in ``dom[pos+1] ∧ ¬used'``
    and a binary search finds it in every other mapped parent's sorted
    segment.  Survivors scatter back into the ``[w]`` candidate bitmap the
    stack stores, so every downstream structure is identical to the dense
    backends; parentless positions keep ``dom ∧ ¬used``.

    PyTorch computes what the walk's inputs need up front — the extracted
    ``v`` extends the mapping, whose mapped parents select the segments —
    and the ``map2`` / ``used2`` payloads.  The rest is one call: K7
    (``csr_walk="bucketed"``) or K6 (``"flat"``) with ``use_pallas``, their
    plain versions without.  As in :class:`PallasStepBackend`, each lane's
    depth is shifted by ``n_p_max - n_p`` of its query."""

    name = "csr"

    def __init__(self, cfg: "EngineConfig", plan: CsrPlanArrays):
        super().__init__(cfg, plan)
        self.depth_shift = plan.n_p_max - self.n_p
        self.n_planes = plan.indptr.shape[0]
        self.n_t = plan.indptr.shape[1] - 1
        bucketed = cfg.csr_walk == "bucketed"
        if cfg.use_pallas:
            self._step = kops.csr_extend_bucketed if bucketed else kops.csr_extend
        else:
            self._step = kref.csr_extend_bucketed_ref if bucketed else kref.csr_extend_ref

    def _segments(self, row: torch.Tensor, map2: torch.Tensor):
        """Per-lane CSR segment bounds of the parents of stacked plan row
        ``row``: ``(start, length)`` int32 ``[B, mp]``, length ``-1`` on
        unused parent slots."""
        plan = self.plan
        r = row.long()
        pp, pd, pe = plan.parent_pos[r], plan.parent_dir[r], plan.parent_elab[r]
        t = map2.gather(1, pp.clamp_min(0).long())
        t = torch.where(pp >= 0, t, 0).clamp(0, self.n_t - 1).long()
        plane = (pe * 2 + pd).clamp(0, self.n_planes - 1).long()
        start = plan.indptr[plane, t]
        length = plan.indptr[plane, t + 1] - start
        return start, torch.where(pp >= 0, length, -1).to(torch.int32)

    def _expand(self, depth, map_, used, cand) -> Tuple[StepLanes, tuple]:
        """The step's lanes, and what :meth:`_segments` returns beyond the
        segment bounds."""
        plan = self.plan
        valid, v, _ = pop_lowest_bit(cand)
        map2, used2 = _extend_payload(depth, map_, used, valid, v, self.p_pad, self.w)
        child_row = self.rows_at(depth + 1)
        start, length, *route = self._segments(child_row, map2)
        cand2, child, meta = self._step(
            plan.indices, plan.dom_bits, start, length, child_row.to(torch.int32),
            (depth + self.depth_shift).to(torch.int32), plan.n_p_max, used, cand,
            deg_cap=plan.deg_cap,
        )
        lanes = StepLanes(
            valid=meta[:, 0] != 0,
            v=meta[:, 1],
            is_match=meta[:, 2] != 0,
            has_child=meta[:, 3] != 0,
            cand2=cand2,
            map2=map2,
            used2=used2,
            child_cand=child,
        )
        return lanes, tuple(route)

    def expand_lanes(self, depth, map_, used, cand) -> StepLanes:
        return self._expand(depth, map_, used, cand)[0]


class PartStepLanes(NamedTuple):
    """:class:`StepLanes` plus the spill routing of a partitioned step.
    ``lanes.has_child`` is narrowed to *live* children (every real parent
    resident and applied); ``spill`` flags children whose partial
    candidates survived but still owe intersections to non-resident
    parents."""

    lanes: StepLanes
    spill: torch.Tensor  # [B] bool — child parked for a non-resident partition
    pending: torch.Tensor  # [B] int32 bitmask of unapplied parent slots
    spill_part: torch.Tensor  # [B] int32 partition of the first pending parent (-1)


class PartitionedCsrStepBackend(CsrStepBackend):
    """The out-of-core step: candidates are intersected with the rows of
    the parents **resident** in the swapped-in partition; the other
    parents go into a per-child ``pending`` bitmask and the child is
    flagged for the spill ring instead of the live stack.

    The walk is :class:`CsrStepBackend`'s — K7 or K6 with ``use_pallas`` —
    with non-resident parent slots given segment length ``-1`` like unused
    ones, so the lead is the first resident parent and membership is
    tested in resident segments only; a lane with no resident parent gets
    ``dom ∧ ¬used``.  The partial candidate set over-approximates the
    child's, and the host finishes it at intake when the pending parents'
    partitions are resident.  Only fully constrained entries reach a live
    stack, so the match set equals the monolithic run's."""

    name = "partitioned"

    def __init__(self, cfg: "EngineConfig", plan: PartPlanArrays):
        super().__init__(cfg, plan)  # n_t: the padded local row count
        self.n_parts = plan.part_starts.shape[0] - 1

    def _segments(self, row: torch.Tensor, map2: torch.Tensor):
        """Resident-masked segment bounds plus spill routing: ``(start,
        length, pending, spill_part)``, length ``-1`` on unused and on
        non-resident parent slots."""
        plan = self.plan
        r = row.long()
        pp, pd, pe = plan.parent_pos[r], plan.parent_dir[r], plan.parent_elab[r]
        real = pp >= 0
        t = torch.where(real, map2.gather(1, pp.clamp_min(0).long()), 0)
        resident = real & (t >= plan.part_lo) & (t < plan.part_hi)
        t_loc = (t - plan.part_lo).clamp(0, self.n_t - 1).long()
        plane = (pe * 2 + pd).clamp(0, self.n_planes - 1).long()
        start = plan.indptr[plane, t_loc]
        length = torch.where(resident, plan.indptr[plane, t_loc + 1] - start, -1)

        pend = (real & ~resident).to(torch.int32)
        slot_bit = 1 << torch.arange(pend.shape[1], dtype=torch.int32, device=pend.device)
        pending = (pend * slot_bit).sum(dim=1, dtype=torch.int32)
        first = pend.argmax(dim=1, keepdim=True)  # the first pending slot (0 if none)
        t_first = t.gather(1, first)[:, 0].to(torch.int32).contiguous()
        spill_part = torch.searchsorted(plan.part_starts, t_first, right=True).to(torch.int32) - 1
        spill_part = torch.where(pending != 0, spill_part, -1)
        return start, length.to(torch.int32), pending, spill_part

    def expand_lanes_part(self, depth, map_, used, cand) -> PartStepLanes:
        lanes, (pending, spill_part) = self._expand(depth, map_, used, cand)
        # the walk's has_child: a child is wanted and its partial
        # candidates are non-empty
        survived = lanes.has_child
        return PartStepLanes(lanes=lanes._replace(has_child=survived & (pending == 0)),
                             spill=survived & (pending != 0), pending=pending,
                             spill_part=spill_part)

    def expand_lanes(self, depth, map_, used, cand) -> StepLanes:
        return self.expand_lanes_part(depth, map_, used, cand).lanes


def make_step_backend(cfg: "EngineConfig", plan: AnyPlanArrays) -> StepBackend:
    """Backend for ``cfg`` over ``plan``; the array layout must match the
    resolved backend (:func:`plan_arrays_for` guarantees it; ``"auto"``
    resolves by layout here)."""
    if isinstance(plan, PartPlanArrays):
        if cfg.step_backend != "partitioned":
            raise ValueError(f"step_backend={cfg.step_backend!r} cannot run PartPlanArrays")
        return PartitionedCsrStepBackend(cfg, plan)
    if cfg.step_backend == "partitioned":
        raise ValueError("step_backend='partitioned' needs PartPlanArrays "
                         "(build them with make_part_plan_arrays; run via "
                         "repro_torch.core.engine.run_partitioned)")
    if isinstance(plan, CsrPlanArrays):
        if cfg.step_backend not in ("csr", "auto"):
            raise ValueError(f"step_backend={cfg.step_backend!r} cannot run CsrPlanArrays")
        return CsrStepBackend(cfg, plan)
    if cfg.step_backend == "csr":
        raise ValueError("step_backend='csr' needs CsrPlanArrays "
                         "(build them with make_csr_plan_arrays / plan_arrays_for)")
    if cfg.step_backend in ("jnp", "auto"):
        return JnpStepBackend(cfg, plan)
    if cfg.step_backend == "pallas":
        return PallasStepBackend(cfg, plan)
    raise ValueError(
        f"unknown step_backend {cfg.step_backend!r}; expected one of {STEP_BACKENDS}"
    )


# ---------------------------------------------------------------------------
# the shared expansion step (frontier pop -> backend -> counters -> push)
# ---------------------------------------------------------------------------

def make_step_fn(cfg: "EngineConfig", plan: AnyPlanArrays):
    """Build one full expansion step ``(EngineState, active) -> EngineState``
    over every lane of a pack.

    ``active`` (``[L]`` bool, or None for all) freezes the lanes where it
    is False, counters included, as ``repro``'s vmapped ``while_loop``
    freezes a lane whose condition is false.  The returned state shares
    (and the step updates in place) the stack tensors of the state it was
    given."""
    backend = make_step_backend(cfg, plan)

    def step(st: EngineState, active: Optional[torch.Tensor] = None) -> EngineState:
        return _step(cfg, backend, st, active)[0]

    return step


def make_partitioned_step_fn(cfg: "EngineConfig", plan: PartPlanArrays):
    """The partitioned expansion step ``(EngineState, SpillState) ->
    (EngineState, SpillState)`` of one query: :func:`make_step_fn`'s pop →
    expand → counters → push, with the children that owe intersections to
    non-resident partitions pushed to their worker's spill ring instead of
    the live stack.  Updates both states' tensors in place."""
    backend = PartitionedCsrStepBackend(cfg, plan)

    def step(st: EngineState, spill: SpillState) -> Tuple[EngineState, SpillState]:
        return _step(cfg, backend, st, None, spill)

    return step


def _step(cfg: "EngineConfig", backend, st: EngineState, active: Optional[torch.Tensor],
          spill: Optional[SpillState] = None) -> Tuple[EngineState, Optional[SpillState]]:
    """One expansion step of every lane of a pack, and, given ``spill``
    (a partitioned step of one query), its spill-ring pushes."""
    e = cfg.expand_width
    n_lanes, v_q, s_cap = st.st_depth.shape
    v_loc = n_lanes * v_q  # the pack's workers as one flat axis (views)
    st_depth, st_map, st_used, st_cand = (
        x.flatten(0, 1) for x in (st.st_depth, st.st_map, st.st_used, st.st_cand))
    size = st.size.flatten()
    pop = frontier.pop_top_k(
        st_depth, st_map, st_used, st_cand,
        st.base.flatten(), size, e, store_used=cfg.store_used,
        active=None if active is None else active.repeat_interleave(v_q),
    )

    b = v_loc * e
    popped = (pop.depth.reshape(b), pop.map.reshape(b, -1), pop.used.reshape(b, -1),
              pop.cand.reshape(b, -1))
    if spill is None:
        lanes = backend.expand_lanes(*popped)
    else:
        part = backend.expand_lanes_part(*popped)
        lanes = part.lanes

    def sh(x):
        return x.reshape((v_loc, e) + x.shape[1:])

    valid = sh(lanes.valid) & pop.lane_on
    is_match = sh(lanes.is_match) & pop.lane_on
    has_child = sh(lanes.has_child) & pop.lane_on
    cand2, map2, used2, child_cand = (
        sh(x) for x in (lanes.cand2, lanes.map2, lanes.used2, lanes.child_cand)
    )

    def per_worker(x):
        return x.sum(dim=1, dtype=torch.int32).view(n_lanes, v_q)

    states = st.states + per_worker(valid)
    exp_depth = st.exp_depth + per_worker(torch.where(valid, pop.depth, 0))
    matches = st.matches + per_worker(is_match)

    if cfg.collect_matches > 0:
        # the step's m-th match of a worker goes to ring slot
        # (matches + m) % mcap of its match buffer
        mbuf = st.match_buf.flatten(0, 1)
        mcap = mbuf.shape[1]
        m_int = is_match.to(torch.int32)
        m_prefix = torch.cumsum(m_int, dim=1).to(torch.int32) - m_int
        n_out = min(e, mcap)
        src, take = frontier.invert_slots(torch.where(is_match, m_prefix, -1), n_out)
        vidx = torch.arange(v_loc, device=src.device)[:, None]
        slots = (st.matches.flatten()[:, None]
                 + torch.arange(n_out, device=src.device)[None, :]) % mcap
        frontier.write_slots(mbuf, vidx, slots, map2[vidx, src], take)

    if spill is not None:
        spill = frontier.push_spill(
            spill, sh(part.spill) & pop.lane_on,
            pop.depth + 1, map2, child_cand, sh(part.pending), sh(part.spill_part),
        )

    parent_keep = pop.lane_on & (cand2 != 0).any(dim=-1)
    new_size = frontier.push_entries(
        st_depth, st_map, st_used, st_cand, st.base.flatten(), size,
        pop.k, parent_keep, has_child,
        pop.depth, pop.map, pop.used, cand2,
        pop.depth + 1, map2, used2, child_cand,
        store_used=cfg.store_used,
    ).view(n_lanes, v_q)
    overflow = st.overflow | frontier.overflowed(new_size, s_cap)
    if active is not None:  # a frozen lane keeps its flag, as its stacks
        overflow = torch.where(active, overflow, st.overflow)
    st = st._replace(
        size=new_size, matches=matches, states=states,
        exp_depth=exp_depth, overflow=overflow,
    )
    return st, spill

