"""Ring-buffer frontier stacks: the state layer of the engine.

Each of ``V`` workers owns a ring-buffer stack of search-tree entries
(:class:`EngineState`): an entry is ``(depth, mapping, used-bitmap,
candidate-bitmap)`` and a task is one candidate bit.  This module pops the
top ``expand_width`` entries, pushes surviving parents below fresh children,
and tracks overflow; it knows nothing of what an expansion computes
(`repro_torch.core.extend`) or how rounds are driven
(`repro_torch.core.engine`).  A port of ``repro.core.frontier``.

Unlike the JAX package, the stack tensors are updated **in place**: a
functional update would copy every ``[V, S, W]`` stack each step.  The
pushes write through :func:`write_slots`, which reads back the old value
where no entry is pushed, so each slot is written by at most one source.

Every :class:`EngineState` tensor carries a leading **pack axis** ``L``:
one lane per query of a pack (``repro`` vmaps its engine over packs
instead).  A single query is a pack of one.  :func:`pop_top_k` and
:func:`push_entries` see the ``L·V`` workers of a pack as one flat worker
axis; only the steal round keeps the lanes apart.

The out-of-core step (``step_backend="partitioned"``, one query) also
parks partially constrained children in per-worker **spill rings**
(:class:`SpillState`, :func:`push_spill`), which the host drains.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core.graph import WORD_BITS, bitmap_from_indices, bitmap_to_indices
from repro_torch.core.plan import SearchPlan

if TYPE_CHECKING:  # engine imports extend imports frontier
    from repro_torch.core.engine import EngineConfig


class EngineState(NamedTuple):
    st_depth: torch.Tensor  # [L, V, S] int32
    st_map: torch.Tensor  # [L, V, S, P] int32
    st_used: torch.Tensor  # [L, V, S, W] int32 ([L, V, S, 1] without store_used)
    st_cand: torch.Tensor  # [L, V, S, W] int32
    base: torch.Tensor  # [L, V] int32 ring-buffer base
    size: torch.Tensor  # [L, V] int32
    matches: torch.Tensor  # [L, V] int32
    states: torch.Tensor  # [L, V] int32
    exp_depth: torch.Tensor  # [L, V] int32 summed depth of expanded entries
    steals: torch.Tensor  # [L, V] int32 entries received
    steal_depth: torch.Tensor  # [L, V] int32 summed depth of stolen entries
    steal_rounds: torch.Tensor  # [L] int32 rounds with any transfer
    steps: torch.Tensor  # [L] int32
    overflow: torch.Tensor  # [L] bool — stack high-watermark breached
    match_buf: torch.Tensor  # [L, V, Mcap, P] int32 (Mcap >= 1)


class Popped(NamedTuple):
    """Top-of-stack lanes selected by :func:`pop_top_k`.

    Off lanes (``lane_on == False``) carry zeroed depth/candidates so the
    expansion backend never has to re-check the lane mask for validity.
    """

    depth: torch.Tensor  # [V, E] int32 (0 on off lanes)
    map: torch.Tensor  # [V, E, P] int32
    used: torch.Tensor  # [V, E, W] int32
    cand: torch.Tensor  # [V, E, W] int32 (0 on off lanes)
    lane_on: torch.Tensor  # [V, E] bool
    k: torch.Tensor  # [V] int32 entries actually popped per worker


def invert_slots(dest: torch.Tensor, n_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert a per-row source → output-position map.

    ``dest`` is ``[R, n_src]`` with each source's output position, or
    ``-1`` (or anything ``>= n_out``) for a source that writes nothing;
    valid positions of one row must be distinct.  Returns ``(src, has)``,
    both ``[R, n_out]``: the source index writing each position (0 where
    none) and whether any does.  This replaces JAX's ``mode="drop"``
    scatters: dropped writes land in a spare column that is cut off."""
    rows, n_src = dest.shape
    idx = torch.where((dest >= 0) & (dest < n_out), dest, n_out).long()
    src = torch.zeros((rows, n_out + 1), dtype=torch.long, device=dest.device)
    src.scatter_(1, idx, torch.arange(n_src, device=dest.device).expand(rows, n_src))
    has = torch.zeros((rows, n_out + 1), dtype=torch.bool, device=dest.device)
    has.scatter_(1, idx, True)
    return src[:, :n_out], has[:, :n_out]


def write_slots(dst: torch.Tensor, ridx: torch.Tensor, slots: torch.Tensor,
                values: torch.Tensor, take: torch.Tensor) -> None:
    """``dst[ridx, slots] = values`` in place where ``take``, unchanged
    elsewhere.  ``(ridx, slots)`` pairs must be distinct."""
    old = dst[ridx, slots]
    mask = take.reshape(take.shape + (1,) * (values.dim() - take.dim()))
    dst[ridx, slots] = torch.where(mask, values, old)


class SpillState(NamedTuple):
    """Per-worker ring of entries parked for a non-resident partition (the
    out-of-core step; one query, so no pack axis).

    A spill entry is a child whose candidate bitmap is only *partially*
    constrained: ``sp_pending`` bit ``j`` set means parent slot ``j``'s
    adjacency row lives outside the resident partition and has not been
    intersected yet.  ``sp_part`` is the partition of the first pending
    parent: the host drains the rings into per-partition pools.  The
    used-bitmap is not stored (intake rebuilds it from the mapping).
    ``sp_overflow`` latches when a push would pass the capacity; the
    round loop yields for a drain well before that (:func:`spill_watermark`)."""

    sp_depth: torch.Tensor  # [V, C] int32
    sp_map: torch.Tensor  # [V, C, P] int32
    sp_cand: torch.Tensor  # [V, C, W] int32 partially constrained candidates
    sp_pending: torch.Tensor  # [V, C] int32 bitmask of unapplied parent slots
    sp_part: torch.Tensor  # [V, C] int32 partition owning the first pending parent
    sp_size: torch.Tensor  # [V] int32
    sp_overflow: torch.Tensor  # [] bool — a push passed the capacity


def init_spill_state(v: int, spill_cap: int, p_pad: int, w: int, device) -> SpillState:
    def full(shape, value=0, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return SpillState(
        sp_depth=full((v, spill_cap)),
        sp_map=full((v, spill_cap, p_pad), -1),
        sp_cand=full((v, spill_cap, w)),
        sp_pending=full((v, spill_cap)),
        sp_part=full((v, spill_cap), -1),
        sp_size=full((v,)),
        sp_overflow=full((), False, torch.bool),
    )


def push_spill(
    spill: SpillState,
    flags: torch.Tensor,  # [V, E] lanes that produced a spill entry
    e_depth: torch.Tensor,  # [V, E] int32
    e_map: torch.Tensor,  # [V, E, P] int32
    e_cand: torch.Tensor,  # [V, E, W] int32
    e_pending: torch.Tensor,  # [V, E] int32
    e_part: torch.Tensor,  # [V, E] int32
) -> SpillState:
    """Append the flagged lanes to each worker's spill ring, **in place**.
    A worker's flagged lanes take consecutive slots from its ``sp_size``
    (prefix sum); pushes past the capacity are dropped and latch
    ``sp_overflow``, and ``sp_size`` stops at the capacity.  ``repro``
    scatters with ``mode="drop"``; here each of the ``min(E, C)`` slots
    after ``sp_size`` gathers its lane (:func:`invert_slots`)."""
    v_loc, c_cap = spill.sp_depth.shape
    e = flags.shape[1]
    fl = flags.to(torch.int32)
    offs = torch.cumsum(fl, dim=1).to(torch.int32) - fl
    fits = flags & (spill.sp_size[:, None] + offs < c_cap)
    n_out = min(e, c_cap)
    src, take = invert_slots(torch.where(fits, offs, -1), n_out)
    vidx = torch.arange(v_loc, device=flags.device)[:, None]
    # n_out <= c_cap consecutive slots modulo c_cap are distinct; the ones
    # past the capacity take nothing
    slots = (spill.sp_size[:, None] + torch.arange(n_out, device=flags.device)) % c_cap
    for dst, val in ((spill.sp_depth, e_depth), (spill.sp_map, e_map), (spill.sp_cand, e_cand),
                     (spill.sp_pending, e_pending), (spill.sp_part, e_part)):
        write_slots(dst, vidx, slots, val[vidx, src], take)
    new_size = spill.sp_size + fl.sum(dim=1, dtype=torch.int32)
    return spill._replace(
        sp_size=new_size.clamp(max=c_cap),
        sp_overflow=spill.sp_overflow | (new_size > c_cap).any(),
    )


def spill_watermark(spill: SpillState, margin: int) -> torch.Tensor:
    """True when any worker's ring is within ``margin`` pushes of its
    capacity: the round loop's cue to return to the host for a drain."""
    c_cap = spill.sp_depth.shape[1]
    return (spill.sp_size >= c_cap - margin).any()


def used_from_map(map_: torch.Tensor, depth: torch.Tensor, w: int) -> torch.Tensor:
    """Reconstruct used-bitmaps ``[..., w]`` from mapped targets at
    positions < depth (the ``store_used=False`` stack representation)."""
    p_pad = map_.shape[-1]
    words = torch.arange(w, device=map_.device)
    u = torch.zeros(map_.shape[:-1] + (w,), dtype=torch.int32, device=map_.device)
    for j in range(p_pad):
        t = map_[..., j]
        valid = (j < depth) & (t >= 0)
        t = t.clamp_min(0)
        bit = torch.ones_like(t) << (t % WORD_BITS)
        hit = valid[..., None] & (words == (t // WORD_BITS)[..., None])
        u = u | torch.where(hit, bit[..., None], 0)
    return u


def pop_top_k(
    st_depth: torch.Tensor,
    st_map: torch.Tensor,
    st_used: torch.Tensor,
    st_cand: torch.Tensor,
    base: torch.Tensor,
    size: torch.Tensor,
    expand_width: int,
    store_used: bool = True,
    active: Optional[torch.Tensor] = None,
) -> Popped:
    """Select each worker's top ``expand_width`` entries (top-first lanes).

    ``k = min(size, expand_width, free_space)`` per worker — the capacity
    guard: a worker never pops more than it could push back (each popped
    entry re-emits at most a parent + a child), so a full ring freezes
    rather than corrupts.  Popping is logical only: ``size`` is adjusted by
    the subsequent :func:`push_entries`, which reuses the vacated slots.
    ``active`` (``[V]`` bool) freezes the workers where it is False:
    they pop nothing, so the step leaves them unchanged.
    """
    v_loc, s_cap = st_depth.shape
    w = st_cand.shape[2]
    dev = st_depth.device
    e = expand_width

    k = torch.minimum(size.clamp(max=e), s_cap - size)
    if active is not None:
        k = torch.where(active, k, 0)
    lane = torch.arange(e, dtype=torch.int32, device=dev)[None, :]
    lane_on = lane < k[:, None]
    pos = size[:, None] - 1 - lane  # top-first
    slot = torch.where(lane_on, (base[:, None] + pos) % s_cap, 0).long()
    vidx = torch.arange(v_loc, device=dev)[:, None]

    depth = torch.where(lane_on, st_depth[vidx, slot], 0)
    cand = torch.where(lane_on[..., None], st_cand[vidx, slot], 0)
    map_ = st_map[vidx, slot]
    used = st_used[vidx, slot] if store_used else used_from_map(map_, depth, w)
    return Popped(depth, map_, used, cand, lane_on, k)


def push_entries(
    st_depth: torch.Tensor,
    st_map: torch.Tensor,
    st_used: torch.Tensor,
    st_cand: torch.Tensor,
    base: torch.Tensor,
    size: torch.Tensor,
    k: torch.Tensor,
    parent_keep: torch.Tensor,  # [V, E] parents with remaining candidates
    has_child: torch.Tensor,  # [V, E] lanes that emitted a live child
    p_depth: torch.Tensor,  # parent re-push payload ([V, E] / [V, E, ...])
    p_map: torch.Tensor,
    p_used: torch.Tensor,
    p_cand: torch.Tensor,
    c_depth: torch.Tensor,  # child payload
    c_map: torch.Tensor,
    c_used: torch.Tensor,
    c_cand: torch.Tensor,
    store_used: bool = True,
) -> torch.Tensor:
    """Push surviving parents below their fresh children, lanes k-1 .. 0,
    into the stacks **in place**; returns the new ``size``.

    Emission is reversed-lane (lane k-1 first) so lane 0 — the deepest,
    top-of-stack entry — ends back on top: per-worker DFS order is
    preserved across steps.  Output positions come from a per-worker prefix
    sum over ``(parent_keep, has_child)``; they fill ``[0, total_push)``
    above ``size - k``, so the write is an inverse gather over those
    positions (see :func:`invert_slots`).
    """
    v_loc, s_cap = st_depth.shape
    e = parent_keep.shape[1]
    dev = st_depth.device
    rev = torch.arange(e - 1, -1, -1, device=dev)
    pk_r = parent_keep[:, rev].to(torch.int32)
    hc_r = has_child[:, rev].to(torch.int32)
    per_lane = pk_r + hc_r
    offs = torch.cumsum(per_lane, dim=1).to(torch.int32) - per_lane
    parent_out = torch.where(pk_r > 0, offs, -1)[:, rev]
    child_out = torch.where(hc_r > 0, offs + pk_r, -1)[:, rev]
    total_push = per_lane.sum(dim=1, dtype=torch.int32)
    push_base = size - k

    # valid positions are < total_push <= s_cap - push_base, so capping the
    # range at s_cap keeps every written slot distinct
    n_out = min(2 * e, s_cap)
    src, take = invert_slots(torch.cat([parent_out, child_out], dim=1), n_out)
    o = torch.arange(n_out, device=dev)[None, :]
    slots = ((base + push_base)[:, None] + o) % s_cap
    vidx = torch.arange(v_loc, device=dev)[:, None]

    def payload(p, c):
        return torch.cat([p, c], dim=1)[vidx, src]

    write_slots(st_depth, vidx, slots, payload(p_depth, c_depth), take)
    write_slots(st_map, vidx, slots, payload(p_map, c_map), take)
    write_slots(st_cand, vidx, slots, payload(p_cand, c_cand), take)
    if store_used:
        write_slots(st_used, vidx, slots, payload(p_used, c_used), take)
    return push_base + total_push


def overflowed(size: torch.Tensor, s_cap: int) -> torch.Tensor:
    """High-watermark check over the last (worker) axis of ``size``: a
    completely full ring (``size == s_cap``) counts as overflow — the pop
    guard then freezes the worker, silently undercounting, which is why the
    session retries with a doubled cap
    (`repro_torch.core.session.Enumerator.run`)."""
    return (size > s_cap - 1).any(dim=-1)


def init_state(plan: SearchPlan, cfg: "EngineConfig", device) -> EngineState:
    """Initial work distribution of one query, as a pack of one lane,
    dispatched on ``cfg.root_seeding``.

    ``"vertex"`` is the paper's §3.3 scheme — depth-0 candidates split into
    equal contiguous target-node ranges, one root entry per worker.
    ``"edge"`` enumerates the plan's seed edge class into depth-1 entries
    (:func:`root_seed_entries`) dealt round-robin across workers
    (:func:`init_delta_state`); when the class is too populous for the
    stacks, it falls back to a depth-0 split restricted to the qualifying
    source nodes — deterministic per ``(plan, cfg)``, so counters agree
    across step backends.  ``"auto"`` is ``"edge"`` iff the plan carries a
    seed edge.  The match set is the same under every mode.
    """
    mode = cfg.root_seeding
    if mode == "auto":
        mode = "edge" if plan.seed_edge is not None else "vertex"
    if mode != "edge":
        return _init_vertex_state(plan, cfg, device)
    if plan.seed_edge is None:
        raise ValueError(
            "root_seeding='edge' requires a plan built with seed_edge= "
            "(plan.seed_edge is unset; see repro_torch.core.plan.build_plan)"
        )
    sd, sm, sc = root_seed_entries(plan)
    k = int(sd.shape[0])
    per_worker = -(-k // cfg.n_workers) if k else 0
    if per_worker <= cfg.resolved_stack_cap(plan.p_pad) - 1:
        return init_delta_state(plan, cfg, sd, sm, sc, device)
    mask = bitmap_from_indices(sm[:, 0].astype(np.int64), plan.n_t, plan.w)
    return _init_vertex_state(plan, cfg, device, root_mask=mask)


def root_seed_entries(plan: SearchPlan) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Depth-1 engine seeds for edge-centric root seeding (host numpy).

    The seed edge's endpoints hold ordering positions 0/1, so each target
    arc of the seed class becomes one partial embedding: position 0 maps to
    the arc's source ``t`` and the entry stores position 1's candidate
    bitmap (`repro_torch.core.extend.host_cand_bitmap`, which the engine
    trusts).  Sources are drawn from ``dom[0]`` restricted to rows with a
    non-empty segment in the seed constraint's plane, so the work follows
    the rare class, not the target.  Returns ``(seed_depth [K], seed_map
    [K, p_pad], seed_cand [K, w])`` sorted by source node.
    """
    from repro_torch.core.extend import host_cand_bitmap, plan_csr  # extend imports frontier

    p_pad, w = plan.p_pad, plan.w
    empty = (
        np.zeros((0,), np.int32),
        np.zeros((0, p_pad), np.int32),
        np.zeros((0, w), np.uint32),
    )
    if not plan.satisfiable or plan.n_p < 2:
        return empty

    dom0_idx = bitmap_to_indices(plan.dom_bits[0])
    # the position-1 parent slot referencing position 0 is the seed edge
    j0 = next(
        (j for j in range(plan.max_parents) if int(plan.parent_pos[1, j]) == 0), None
    )
    if j0 is not None:
        plane = int(plan.parent_elab[1, j0]) * 2 + int(plan.parent_dir[1, j0])
        ptr = plan_csr(plan).indptr[plane].astype(np.int64)
        dom0_idx = dom0_idx[ptr[dom0_idx + 1] - ptr[dom0_idx] > 0]
    seeds_m, seeds_c = [], []
    m = np.full(p_pad, -1, dtype=np.int32)
    for t in dom0_idx.tolist():
        m[0] = t
        c1 = host_cand_bitmap(plan, 1, m)
        if c1.any():
            seeds_m.append(m.copy())
            seeds_c.append(c1)
    if not seeds_m:
        return empty
    return (
        np.ones(len(seeds_m), dtype=np.int32),
        np.stack(seeds_m).astype(np.int32),
        np.stack(seeds_c).astype(np.uint32),
    )


def stack_states(states) -> EngineState:
    """Join single- or multi-lane states of one shape into one pack."""
    return EngineState(*(torch.cat(xs, dim=0) for xs in zip(*states)))


def _state_shapes(cfg: "EngineConfig", w: int, p_pad: int) -> dict:
    """``(shape, dtype, fill)`` of every :class:`EngineState` field of a pack
    of one lane with ``w`` bitmap words and ``p_pad`` positions."""
    v = cfg.n_workers
    s_cap = cfg.resolved_stack_cap(p_pad)
    mcap = max(1, cfg.collect_matches)
    i32, per_worker, scalar = torch.int32, (1, v), (1,)
    return dict(
        st_depth=((1, v, s_cap), i32, 0),
        st_map=((1, v, s_cap, p_pad), i32, -1),
        st_used=((1, v, s_cap, w if cfg.store_used else 1), i32, 0),
        st_cand=((1, v, s_cap, w), i32, 0),
        base=(per_worker, i32, 0),
        size=(per_worker, i32, 0),
        matches=(per_worker, i32, 0),
        states=(per_worker, i32, 0),
        exp_depth=(per_worker, i32, 0),
        steals=(per_worker, i32, 0),
        steal_depth=(per_worker, i32, 0),
        steal_rounds=(scalar, i32, 0),
        steps=(scalar, i32, 0),
        overflow=(scalar, torch.bool, 0),
        match_buf=((1, v, mcap, p_pad), i32, -1),
    )


def _empty_state(plan: SearchPlan, cfg: "EngineConfig", device) -> EngineState:
    """A pack of one lane with empty stacks and zero counters."""
    return EngineState(**{
        name: torch.full(shape, fill, dtype=dtype, device=device)
        for name, (shape, dtype, fill) in _state_shapes(cfg, plan.w, plan.p_pad).items()})


def abstract_engine_state(cfg: "EngineConfig", w: int, p_pad: int) -> EngineState:
    """The state of a pack of one lane as ``device="meta"`` tensors (no
    storage): ``repro``'s shapes behind the pack axis, bitmap words
    ``int32``."""
    return EngineState(**{
        name: torch.empty(shape, dtype=dtype, device="meta")
        for name, (shape, dtype, _) in _state_shapes(cfg, w, p_pad).items()})


# ``repro``'s logical axes behind the unnamed pack axis
STATE_LOGICAL = EngineState(
    st_depth=(None, "worker", None),
    st_map=(None, "worker", None, None),
    st_used=(None, "worker", None, "tensor"),
    st_cand=(None, "worker", None, "tensor"),
    base=(None, "worker"),
    size=(None, "worker"),
    matches=(None, "worker"),
    states=(None, "worker"),
    exp_depth=(None, "worker"),
    steals=(None, "worker"),
    steal_depth=(None, "worker"),
    steal_rounds=(None,),
    steps=(None,),
    overflow=(None,),
    match_buf=(None, "worker", None, None),
)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host int32 / uint32 array as an int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _init_vertex_state(
    plan: SearchPlan, cfg: "EngineConfig", device, root_mask: Optional[np.ndarray] = None
) -> EngineState:
    """Depth-0 candidates split into equal contiguous target-node ranges,
    one root entry per worker; ``root_mask`` optionally restricts the root
    candidates (edge seeding's capacity fallback)."""
    v, w = cfg.n_workers, plan.w
    splits = np.linspace(0, plan.n_t, v + 1).astype(np.int64)
    root_cands = np.zeros((v, w), dtype=np.uint32)
    for kk in range(v):
        idx = np.arange(splits[kk], splits[kk + 1])
        if idx.size:
            root_cands[kk] = bitmap_from_indices(idx, plan.n_t, w) & plan.dom_bits[0]
    if root_mask is not None:
        root_cands &= root_mask[None, :]
    if not plan.satisfiable:
        root_cands[:] = 0

    state = _empty_state(plan, cfg, device)
    state.st_cand[0, :, 0] = _upload(root_cands, device)
    return state._replace(size=_upload(root_cands.any(axis=1).astype(np.int32), device)[None])


def init_delta_state(
    plan: SearchPlan,
    cfg: "EngineConfig",
    seed_depth: np.ndarray,
    seed_map: np.ndarray,
    seed_cand: np.ndarray,
    device,
) -> EngineState:
    """A pack of one lane whose worker stacks start from the given partial
    embeddings instead of :func:`init_state`'s depth-0 root split.

    ``seed_depth [K]`` / ``seed_map [K, p_pad]`` / ``seed_cand [K, w]`` must
    already be engine-valid (`repro_torch.core.extend.host_cand_bitmap`
    semantics: candidate bits are trusted, never re-checked).  Seeds are
    dealt round-robin across the ``V`` workers, so seed ``i`` lands in
    worker ``i % V``, slot ``i // V``; with ``cfg.store_used`` each entry's
    used-bitmap holds its mapped prefix.  The caller keeps ``K`` small
    enough that no worker exceeds the stack capacity.
    """
    v = cfg.n_workers
    p_pad, w = plan.p_pad, plan.w
    s_cap = cfg.resolved_stack_cap(p_pad)

    seed_depth = np.asarray(seed_depth, dtype=np.int32)
    seed_map = np.asarray(seed_map, dtype=np.int32)
    seed_cand = np.asarray(seed_cand, dtype=np.uint32)
    k = int(seed_depth.shape[0])
    per_worker = -(-k // v) if k else 0
    if per_worker > s_cap - 1:
        raise ValueError(
            f"{k} delta seeds over {v} workers exceed stack_cap={s_cap}; "
            "chunk the seed batch"
        )

    # the first per_worker slots of every stack, filled on the host
    st_depth = np.zeros((v, per_worker), dtype=np.int32)
    st_map = np.full((v, per_worker, p_pad), -1, dtype=np.int32)
    st_cand = np.zeros((v, per_worker, w), dtype=np.uint32)
    st_used = np.zeros((v, per_worker, w), dtype=np.uint32)
    size = np.zeros((v,), dtype=np.int32)
    for i in range(k):
        wk, slot = i % v, i // v
        st_depth[wk, slot] = seed_depth[i]
        st_map[wk, slot] = seed_map[i]
        st_cand[wk, slot] = seed_cand[i]
        if cfg.store_used:
            prefix = seed_map[i, : seed_depth[i]].astype(np.int64)
            st_used[wk, slot] = bitmap_from_indices(prefix[prefix >= 0], plan.n_t, w)
        size[wk] = slot + 1

    state = _empty_state(plan, cfg, device)
    if per_worker:
        state.st_depth[0, :, :per_worker] = _upload(st_depth, device)
        state.st_map[0, :, :per_worker] = _upload(st_map, device)
        state.st_cand[0, :, :per_worker] = _upload(st_cand, device)
        if cfg.store_used:
            state.st_used[0, :, :per_worker] = _upload(st_used, device)
    return state._replace(size=_upload(size, device)[None])
