"""Frontier-vectorized parallel RI/RI-DS search engine — the round-loop layer.

The array form of the paper's work-stealing DFS: `repro_torch.core.frontier`
owns the ring-buffer stacks, `repro_torch.core.extend` the expansion step
(plain PyTorch, or the ``extend_step`` / ``candidate_mask`` CUDA kernels),
`repro_torch.core.scheduler` the steal policy, and this module the round
loop and the steal round.  A port of the single-device half of
``repro.core.engine``.

``repro`` runs the loop as a ``lax.while_loop`` on the device, vmapped
over the queries of a pack.  Here the host drives it: each round enqueues
``rebalance_interval`` steps and one steal round without waiting, then
synchronises once to read each pack lane's loop condition
``sum(size) > 0 & steps < max_steps & ~overflow``.  A lane whose
condition is false is frozen, counters included, as the vmapped loop
freezes it; a single query is the pack of one.  ``steps`` advances by
whole rounds, as in ``repro``, so every counter is identical.

Counters are per-worker int32; cross-query aggregation happens on the host
in Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import extend, frontier, scheduler
from repro_torch.core.extend import AnyPlanArrays, plan_arrays_for
from repro_torch.core.frontier import EngineState, init_state
from repro_torch.core.plan import SearchPlan


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA card.  Raises when no card is present rather than running
    on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters (the fields and defaults of ``repro``'s).

    Attributes:
      n_workers: number of (virtual) workers ``V``, all run vectorized.
      expand_width: entries expanded per worker per step (lanes per worker).
      steal_chunk: entries a donor offers per steal round — the paper's
        task group size (Fig. 4: 4 is best).
      keep_min: donors never drop below this size.
      recv_cap: max entries a receiver accepts per round.
      rebalance_interval: steps between steal rounds.
      work_stealing: disable to reproduce the paper's Fig. 3 ablation.
      stack_cap: ring-buffer capacity per worker; 0 = auto
        (``expand_width * (p_pad + 2) + steal_chunk + 8``).
      max_steps: safety bound on outer loop iterations (0 = 2**30).
      collect_matches: if > 0, materialize up to this many mappings per
        worker into a ring buffer.
      step_backend: ``"jnp"`` (plain PyTorch step), ``"pallas"`` (the
        fused ``extend_step`` kernel), ``"csr"`` (the sparse CSR step) or
        ``"auto"`` (``"csr"`` past ``extend.CSR_AUTO_NT`` target nodes and
        for CSR-only plans, else ``"jnp"``).  ``repro``'s
        ``"partitioned"`` is refused until its slice is ported.
      use_pallas: with ``step_backend="jnp"``, route the candidate AND
        through the ``candidate_mask`` kernel; with ``"csr"``, run the step
        as the ``csr_extend_bucketed`` / ``csr_extend`` kernel.
      store_used: keep per-entry used-bitmaps on the stack (True) or
        recompute them from the mapping at expansion time (False).
      n_partitions, spill_cap: settings of the out-of-core backend
        (not ported yet; kept so configurations carry over).
      root_seeding: how worker stacks are first filled
        (`repro_torch.core.frontier.init_state`): ``"vertex"``, the paper's
        depth-0 root split over the first position's domain; ``"edge"``,
        the plan's seed edge class (``plan.seed_edge``) as depth-1 entries,
        which shrinks the root frontier of hub-heavy targets; ``"auto"``,
        ``"edge"`` iff the plan carries a seed edge.  The match set is the
        same under every mode.
      csr_walk: the CSR lead-segment schedule: ``"bucketed"`` (default)
        caps each lane's walk at its row's pow2 degree bucket, ``"flat"``
        walks the global ``deg_cap``.  Ignored by the dense backends.
    """

    n_workers: int = 1
    expand_width: int = 8
    steal_chunk: int = 4
    keep_min: int = 2
    recv_cap: int = 4
    rebalance_interval: int = 8
    work_stealing: bool = True
    stack_cap: int = 0
    max_steps: int = 0
    collect_matches: int = 0
    step_backend: str = "jnp"
    use_pallas: bool = False
    store_used: bool = True
    n_partitions: int = 0
    spill_cap: int = 0
    root_seeding: str = "vertex"
    csr_walk: str = "bucketed"

    def __post_init__(self):
        if self.step_backend in extend.LATER_STEP_BACKENDS:
            raise NotImplementedError(
                f"step_backend={self.step_backend!r} is not ported yet: "
                + extend.LATER_STEP_BACKENDS[self.step_backend]
            )
        valid = extend.STEP_BACKENDS + ("auto",)
        if self.step_backend not in valid:
            raise ValueError(f"step_backend={self.step_backend!r}; expected one of {valid}")
        if self.root_seeding not in ("vertex", "edge", "auto"):
            raise ValueError(
                f"root_seeding={self.root_seeding!r}; expected 'vertex', 'edge', or 'auto'"
            )
        if self.csr_walk not in ("bucketed", "flat"):
            raise ValueError(
                f"csr_walk={self.csr_walk!r}; expected 'bucketed' or 'flat'"
            )

    def resolved_stack_cap(self, p_pad: int) -> int:
        if self.stack_cap:
            return self.stack_cap
        return self.expand_width * (p_pad + 2) + self.steal_chunk + 8


class EngineResult(NamedTuple):
    matches: int
    states: int
    steps: int
    steals: int
    steal_rounds: int
    mean_steal_depth: float
    mean_expand_depth: float
    per_worker_states: np.ndarray
    per_worker_matches: np.ndarray
    overflow: bool
    match_buf: Optional[np.ndarray]
    per_worker_steals: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# steal round (cross-worker, array ops over the V axis)
# ---------------------------------------------------------------------------

def _steal_round(cfg: EngineConfig, state: EngineState,
                 active: Optional[torch.Tensor] = None) -> EngineState:
    """Move donated stack-bottom entries to empty workers of the same pack
    lane, in place; lanes where ``active`` is False take no part.

    ``repro`` scatters each donated slot to its receiver and drops the
    rest; here each receiver's intake slots gather their donor entry
    (`repro_torch.core.frontier.invert_slots`), so every written slot has
    one source."""
    policy = scheduler.StealPolicy(
        steal_chunk=cfg.steal_chunk, keep_min=cfg.keep_min, recv_cap=cfg.recv_cap
    )
    n_lanes, v_workers, s_cap = state.st_depth.shape
    c = cfg.steal_chunk
    dev = state.st_depth.device

    # a frozen lane plans with empty stacks: nothing is donated, so nothing moves
    sizes = state.size if active is None else torch.where(active[:, None], state.size, 0)
    _, accepted, dest_rank, dest_pos = scheduler.plan_steals(sizes, policy)
    wor = scheduler.receiver_workers(sizes)  # [L, V] worker per rank

    # donated rows from stack bottoms: donor d slot j = logical position j
    slot_j = torch.arange(c, dtype=torch.int32, device=dev).expand(n_lanes, v_workers, c)
    src_slot = ((state.base[..., None] + slot_j) % s_cap).long()
    taken = slot_j < accepted[..., None]
    rank = dest_rank.clamp(0, v_workers - 1).long().view(n_lanes, -1)
    dest_w = torch.where(taken, wor.gather(1, rank).view(n_lanes, v_workers, c), -1)

    # intake position q of receiver w takes the donated slot addressed to it
    n_in = min(cfg.recv_cap, s_cap)
    flat_dest = torch.where((dest_w >= 0) & (dest_pos < n_in), dest_w * n_in + dest_pos, -1)
    src, has = frontier.invert_slots(flat_dest.view(n_lanes, -1), v_workers * n_in)
    src, has = src.view(n_lanes, v_workers, n_in), has.view(n_lanes, v_workers, n_in)
    lane = torch.arange(n_lanes, device=dev)[:, None, None]
    from_slot = src_slot[lane, src // c, src % c]
    # the pack's workers as one flat axis: worker w of lane l is row l·V + w
    src_row = (lane * v_workers + src // c).flatten(0, 1)
    from_slot = from_slot.flatten(0, 1)
    q = torch.arange(n_in, device=dev)
    dst_slot = ((state.base[..., None] + q) % s_cap).flatten(0, 1)  # receivers are empty
    didx = torch.arange(n_lanes * v_workers, device=dev)[:, None]
    has_f = has.flatten(0, 1)

    depth_in = state.st_depth.flatten(0, 1)[src_row, from_slot].view(n_lanes, v_workers, n_in)
    for name in ("st_depth", "st_map", "st_used", "st_cand"):
        arr = getattr(state, name).flatten(0, 1)
        frontier.write_slots(arr, didx, dst_slot, arr[src_row, from_slot], has_f)

    recv_cnt = has.sum(dim=-1, dtype=torch.int32)
    depth_add = torch.where(has, depth_in, 0).sum(dim=-1, dtype=torch.int32)
    return state._replace(
        base=(state.base + accepted) % s_cap,  # accepted slots were a bottom prefix
        size=state.size - accepted + recv_cnt,
        steals=state.steals + recv_cnt,
        steal_depth=state.steal_depth + depth_add,
        steal_rounds=state.steal_rounds + (accepted.sum(dim=-1) > 0).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# round loop
# ---------------------------------------------------------------------------

def make_expand_fn(cfg: EngineConfig, plan: AnyPlanArrays):
    """The worker-local part of one round: ``rebalance_interval`` steps.

    ``repro`` ends a CSR round with a ring compaction (base → 0), a layout
    hook for its segment gathers.  The port addresses every ring modulo its
    base, so it leaves the rings where they are: its state equals
    ``repro``'s up to that rotation, with the same results."""
    step = extend.make_step_fn(cfg, plan)

    def expand(state: EngineState, active: Optional[torch.Tensor] = None) -> EngineState:
        for _ in range(cfg.rebalance_interval):
            state = step(state, active)
        return state

    return expand


def make_round_fn(cfg: EngineConfig, plan: AnyPlanArrays):
    """One round: ``rebalance_interval`` expansion steps, then one steal
    round, on the pack lanes where ``active`` (``[L]`` bool, None for all)
    holds.  Enqueues device work only; nothing here waits for the device."""
    expand = make_expand_fn(cfg, plan)

    def body(state: EngineState, active: Optional[torch.Tensor] = None) -> EngineState:
        state = expand(state, active)
        if cfg.work_stealing and cfg.n_workers > 1:
            state = _steal_round(cfg, state, active)
        ri = cfg.rebalance_interval
        return state._replace(
            steps=state.steps + (ri if active is None else active.to(torch.int32) * ri))

    return body


def _engine_loop(cfg: EngineConfig, plan: AnyPlanArrays, state: EngineState) -> EngineState:
    """Run rounds until every pack lane has drained its stacks, reached
    ``max_steps``, or overflowed (a full ring freezes its worker, so an
    overflowed run can never drain; the session retries it with a doubled
    ``stack_cap``).  One host synchronisation per round reads every lane's
    condition; a lane whose condition is false stays frozen."""
    max_steps = cfg.max_steps or (1 << 30)
    body = make_round_fn(cfg, plan)
    while True:
        active = (state.size.sum(dim=-1) > 0) & (state.steps < max_steps) & ~state.overflow
        on = active.cpu().numpy()
        if not on.any():
            return state
        state = body(state, None if on.all() else active)


def run(plan: SearchPlan, cfg: EngineConfig, mesh=None, device=None) -> EngineResult:
    """Enumerate all isomorphic subgraphs described by ``plan`` on
    ``device`` (default: the CUDA card; raises without one).  The plan
    arrays follow the resolved step backend (dense bitmaps, or CSR planes
    for ``"csr"`` / large-``n_t`` ``"auto"``).  ``mesh=`` (worker stacks
    sharded over several cards) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: ROADMAP Queue 1 item 11 (multi-device)"
        )
    device = resolve_device(device)
    arrays = plan_arrays_for(cfg, [plan], device)
    final = _engine_loop(cfg, arrays, init_state(plan, cfg, device))
    return result_from_state(final, cfg)


def result_from_state(final: EngineState, cfg: EngineConfig, lane: int = 0) -> EngineResult:
    """Reduce pack lane ``lane`` of a drained :class:`EngineState` to an
    :class:`EngineResult`."""
    final = EngineState(*(x[lane] for x in final))

    def host(t):
        return t.cpu().numpy()

    steals = int(final.steals.sum())
    sdepth = int(final.steal_depth.sum())
    states = int(final.states.sum())
    edepth = int(final.exp_depth.sum())
    return EngineResult(
        matches=int(final.matches.sum()),
        states=states,
        steps=int(final.steps),
        steals=steals,
        steal_rounds=int(final.steal_rounds),
        mean_steal_depth=(sdepth / steals) if steals else 0.0,
        mean_expand_depth=(edepth / states) if states else 0.0,
        per_worker_states=host(final.states),
        per_worker_matches=host(final.matches),
        overflow=bool(final.overflow),
        match_buf=host(final.match_buf) if cfg.collect_matches else None,
        per_worker_steals=host(final.steals),
    )
