"""Frontier-vectorized parallel RI/RI-DS search engine — the round-loop layer.

The array form of the paper's work-stealing DFS: `repro_torch.core.frontier`
owns the ring-buffer stacks, `repro_torch.core.extend` the expansion step
(plain PyTorch, or the ``extend_step`` / ``candidate_mask`` CUDA kernels),
`repro_torch.core.scheduler` the steal policy, and this module the round
loop and the steal rounds, and the host scheduling loop of the out-of-core
path (:func:`run_partitioned`).  A port of ``repro.core.engine``.

``repro`` runs the loop as a ``lax.while_loop`` on the device, vmapped
over the queries of a pack.  Here the host drives it: each round enqueues
``rebalance_interval`` steps and one steal round without waiting, then
synchronises once to read each pack lane's loop condition
``sum(size) > 0 & steps < max_steps & ~overflow``.  A lane whose
condition is false is frozen, counters included, as the vmapped loop
freezes it; a single query is the pack of one.  ``steps`` advances by
whole rounds, as in ``repro``, so every counter is identical.

**Multi-device** (``run(plan, cfg, mesh=...)``): ``repro`` shards the
worker axis over a mesh with ``shard_map``, one program driving every
device.  The port's counterpart is one process that drives a tuple of
devices (:class:`Mesh`): the ``V`` worker stacks split into ``D`` equal
shards, each on its device with its own replica of the plan arrays; each
shard steps on its device, and the steal round gathers every shard's
occupancy and bottom rows to every distinct device, plans the same steals
and lets each shard take the entries addressed to its own receivers
(:func:`_steal_round_sharded`).  The collectives are copies between
devices.  Devices may repeat, so one card (or the CPU) can hold several
shards; the result equals the unsharded run entry for entry.

Counters are per-worker int32; cross-query aggregation happens on the host
in Python ints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import extend, frontier, scheduler
from repro_torch.core.extend import AnyPlanArrays, plan_arrays_for
from repro_torch.core.frontier import EngineState, SpillState, init_state
from repro_torch.core.graph import bitmap_from_indices
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
        fused ``extend_step`` kernel), ``"csr"`` (the sparse CSR step),
        ``"auto"`` (``"csr"`` past ``extend.CSR_AUTO_NT`` target nodes and
        for CSR-only plans, else ``"jnp"``) or ``"partitioned"`` (the
        out-of-core path, :func:`run_partitioned`: the target's CSR rows
        stream through the device one partition at a time).
      use_pallas: with ``step_backend="jnp"``, route the candidate AND
        through the ``candidate_mask`` kernel; with ``"csr"`` and
        ``"partitioned"``, run the step as the ``csr_extend_bucketed`` /
        ``csr_extend`` kernel.
      store_used: keep per-entry used-bitmaps on the stack (True) or
        recompute them from the mapping at expansion time (False).
      n_partitions: with ``step_backend="partitioned"``, how many
        contiguous row partitions the target streams through (0 → 1).  The
        session derives it from ``memory_budget_bytes``.
      spill_cap: per-worker spill-ring capacity under the partitioned
        backend; 0 = auto (see :meth:`resolved_spill_cap`).
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
        valid = extend.STEP_BACKENDS + ("auto", "partitioned")
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

    def resolved_spill_cap(self, p_pad: int) -> int:
        """Spill-ring capacity: at least twice the pushes one round can make
        (:func:`part_spill_margin`, the drain watermark), so the round loop
        always yields to the host before a ring can overflow."""
        if self.spill_cap:
            return self.spill_cap
        return max(4 * self.resolved_stack_cap(p_pad),
                   2 * self.rebalance_interval * self.expand_width)


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

_STACK_FIELDS = ("st_depth", "st_map", "st_used", "st_cand")


def _steal_plan(cfg: EngineConfig, sizes: torch.Tensor, s_cap: int):
    """The steal round's plan over the occupancy ``sizes`` (``[L, V]``), a
    pure function of it: ``(accepted, src, has, any_transfer)``.

    ``accepted[l, d]`` is how many bottom entries donor ``d`` gives up;
    intake position ``q`` of receiver ``w`` takes donated slot ``src[l, w,
    q]`` (donor ``src // C``, its ``src % C``-th bottom entry) where
    ``has[l, w, q]``, for ``q`` below ``min(recv_cap, s_cap)``;
    ``any_transfer[l]`` is 1 where lane ``l`` moves anything.  ``repro``
    scatters each donated slot to its receiver and drops the rest; the
    port inverts the scatter (`repro_torch.core.frontier.invert_slots`), so
    every written slot has one source."""
    policy = scheduler.StealPolicy(
        steal_chunk=cfg.steal_chunk, keep_min=cfg.keep_min, recv_cap=cfg.recv_cap
    )
    n_lanes, v_workers = sizes.shape
    c = cfg.steal_chunk
    _, accepted, dest_rank, dest_pos = scheduler.plan_steals(sizes, policy)
    wor = scheduler.receiver_workers(sizes)  # [L, V] worker per rank
    slot_j = torch.arange(c, dtype=torch.int32, device=sizes.device).expand(n_lanes, v_workers, c)
    taken = slot_j < accepted[..., None]
    rank = dest_rank.clamp(0, v_workers - 1).long().view(n_lanes, -1)
    dest_w = torch.where(taken, wor.gather(1, rank).view(n_lanes, v_workers, c), -1)
    n_in = min(cfg.recv_cap, s_cap)
    flat_dest = torch.where((dest_w >= 0) & (dest_pos < n_in), dest_w * n_in + dest_pos, -1)
    src, has = frontier.invert_slots(flat_dest.view(n_lanes, -1), v_workers * n_in)
    return (accepted, src.view(n_lanes, v_workers, n_in), has.view(n_lanes, v_workers, n_in),
            (accepted.sum(dim=-1) > 0).to(torch.int32))


def _steal_round(cfg: EngineConfig, state: EngineState,
                 active: Optional[torch.Tensor] = None) -> EngineState:
    """Move donated stack-bottom entries to empty workers of the same pack
    lane, in place (the plan: :func:`_steal_plan`); lanes where ``active``
    is False take no part."""
    n_lanes, v_workers, s_cap = state.st_depth.shape
    c = cfg.steal_chunk
    dev = state.st_depth.device

    # a frozen lane plans with empty stacks: nothing is donated, so nothing moves
    sizes = state.size if active is None else torch.where(active[:, None], state.size, 0)
    accepted, src, has, any_transfer = _steal_plan(cfg, sizes, s_cap)
    n_in = has.shape[-1]

    # donated rows from stack bottoms: donor d slot j = logical position j
    src_slot = ((state.base[..., None] + torch.arange(c, dtype=torch.int32, device=dev))
                % s_cap).long()
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
    for name in _STACK_FIELDS:
        arr = getattr(state, name).flatten(0, 1)
        frontier.write_slots(arr, didx, dst_slot, arr[src_row, from_slot], has_f)

    recv_cnt = has.sum(dim=-1, dtype=torch.int32)
    depth_add = torch.where(has, depth_in, 0).sum(dim=-1, dtype=torch.int32)
    return state._replace(
        base=(state.base + accepted) % s_cap,  # accepted slots were a bottom prefix
        size=state.size - accepted + recv_cnt,
        steals=state.steals + recv_cnt,
        steal_depth=state.steal_depth + depth_add,
        steal_rounds=state.steal_rounds + any_transfer,
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


# ---------------------------------------------------------------------------
# multi-device: worker stacks sharded over a tuple of devices
# ---------------------------------------------------------------------------

def _canonical_device(d) -> torch.device:
    """``d`` as a ``torch.device`` with a CUDA card's index filled in."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of devices with named axes: the port's counterpart of a
    ``jax.sharding.Mesh``.

    ``devices`` is flat, in row-major order over ``axis_sizes``, whose
    product is the number of devices; a 1-D mesh needs no sizes and its
    one axis is ``"data"`` by default.  Devices may repeat: ``Mesh((cuda:0,
    cuda:0))`` is two shards on one card, ``Mesh((cpu,) * 4, ("data",
    "model"), (2, 2))`` a 2 × 2 mesh on the CPU.  ``torch.device("meta")``
    placeholders lay out a production topology that no engine runs on
    (`repro_torch.launch.mesh`).

    The engine shards the worker axis over the mesh's worker axis
    (:func:`mesh_worker_axis`): shard ``k`` of ``D = len(shard_devices)``
    holds workers ``k·V/D`` to ``(k+1)·V/D - 1`` on the first device of
    the ``k``-th slice along that axis (``repro``'s ``shard_map`` runs it
    replicated over the other axes)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        devices = tuple(_canonical_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a Mesh needs at least one device")
        names = tuple(self.axis_names)
        if self.axis_sizes is None:
            if len(names) != 1:
                raise ValueError(f"a mesh over axes {names} needs axis_sizes")
            sizes = (len(devices),)
        else:
            sizes = tuple(int(n) for n in self.axis_sizes)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axis names {names} do not match axis sizes {sizes}")
        if min(sizes) < 1 or int(np.prod(sizes)) != len(devices):
            raise ValueError(f"axis sizes {sizes} do not multiply to {len(devices)} devices")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The device of each worker shard: the first device of each slice
        along the worker axis, in order."""
        a = self.axis_names.index(mesh_worker_axis(self))
        stride = int(np.prod(self.axis_sizes[a + 1:]))
        return tuple(self.devices[k * stride] for k in range(self.axis_sizes[a]))

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each shard's device once, in mesh order: where plan arrays are
        replicated."""
        return tuple(dict.fromkeys(self.shard_devices))


def mesh_worker_axis(mesh: Mesh) -> str:
    """The mesh axis the worker dimension shards over: ``data`` by
    convention, else the mesh's first axis."""
    return "data" if "data" in mesh.axis_names else mesh.axis_names[0]


def mesh_signature(mesh: Optional[Mesh]) -> Optional[tuple]:
    """Hashable identity of a mesh: axis names, axis sizes and the device
    of each shard."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.shape.values()),
            tuple(str(d) for d in mesh.devices))


def coerce_mesh(mesh, device=None) -> Optional[Mesh]:
    """``None``, a :class:`Mesh`, or an int ``n``: on a CUDA ``device`` the
    first ``n`` cards (``ValueError`` naming how many exist when there are
    fewer), on the CPU ``n`` shards on the CPU.  A mesh whose first device
    is not ``device``, or of ``meta`` placeholders, raises ``ValueError``;
    anything else ``TypeError``."""
    if mesh is None:
        return None
    device = resolve_device(device if device is not None
                            else mesh.devices[0] if isinstance(mesh, Mesh) else None)
    if isinstance(mesh, int):
        if mesh < 1:
            raise ValueError(f"mesh={mesh}: a mesh needs at least one device")
        if device.type == "cuda":
            count = torch.cuda.device_count()
            if mesh > count:
                raise ValueError(
                    f"mesh={mesh} devices requested but only {count} CUDA "
                    f"card{'s' if count != 1 else ''} on this machine"
                )
            mesh = Mesh(tuple(torch.device("cuda", i) for i in range(mesh)))
        else:
            mesh = Mesh((device,) * mesh)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh, int, or None, got {type(mesh)!r}")
    if mesh.devices[0] != _canonical_device(device):
        raise ValueError(
            f"the mesh's first device {mesh.devices[0]} is not the run's device {device}"
        )
    if any(d.type == "meta" for d in mesh.devices):
        raise ValueError(f"mesh{mesh.shape} holds meta placeholders; no engine runs on them")
    return mesh


def _check_divisible(cfg: EngineConfig, mesh: Mesh) -> int:
    n_dev = len(mesh.shard_devices)
    if cfg.n_workers % n_dev:
        raise ValueError(
            f"n_workers={cfg.n_workers} not divisible by mesh axis "
            f"{mesh_worker_axis(mesh)!r} size {n_dev}; round up to a multiple"
        )
    return cfg.n_workers // n_dev


def _own(x: torch.Tensor, device) -> torch.Tensor:
    """A copy of ``x`` on ``device`` in storage of its own: the steps write
    in place, so a shard must never be a view of another tensor."""
    return x.to(device, copy=True).contiguous()


def _split(tree, mesh: Mesh, axis: int, replicated: Tuple[str, ...]) -> list:
    """Each field of a state tuple split along the worker ``axis`` into the
    mesh's shards, each on its device; the ``replicated`` fields copied to
    every shard."""
    n = next(x for name, x in zip(tree._fields, tree)
             if name not in replicated).shape[axis] // len(mesh.shard_devices)
    return [type(tree)(*(
        _own(x, dev) if name in replicated else _own(x.narrow(axis, k * n, n), dev)
        for name, x in zip(tree._fields, tree)))
        for k, dev in enumerate(mesh.shard_devices)]


def _join(shards: Sequence, axis: int, first: Tuple[str, ...], any_of: Tuple[str, ...]):
    """The inverse of :func:`_split` on the first shard's device: worker
    fields joined in worker order, the ``first`` fields the first shard's,
    the ``any_of`` flags set where any shard's is."""
    home = shards[0][0].device
    out = {}
    for name in shards[0]._fields:
        xs = [getattr(s, name).to(home) for s in shards]
        out[name] = (torch.stack(xs).any(dim=0) if name in any_of else xs[0] if name in first
                     else torch.cat(xs, dim=axis))
    return type(shards[0])(**out)


def shard_state(state: EngineState, mesh: Mesh) -> List[EngineState]:
    """Split a one-query :class:`EngineState` (``[1, V, ...]``) along ``V``
    into ``D`` shards, each on its mesh device; the loop scalars
    (``steal_rounds``, ``steps``, ``overflow``) are copied to every shard."""
    return _split(state, mesh, 1, ("steal_rounds", "steps", "overflow"))


def gather_state(shards: Sequence[EngineState]) -> EngineState:
    """Join shards in worker order on the first shard's device: the
    inverse of :func:`shard_state`.  ``steal_rounds`` and ``steps`` are the
    first shard's, ``overflow`` any shard's (``repro``'s replicated
    out-specs)."""
    return _join(shards, 1, ("steal_rounds", "steps"), ("overflow",))


def shard_spill(spill: SpillState, mesh: Mesh) -> List[SpillState]:
    """:func:`shard_state` for a :class:`SpillState` (no pack axis):
    rings split along ``V``, ``sp_overflow`` copied to every shard."""
    return _split(spill, mesh, 0, ("sp_overflow",))


def gather_spill(shards: Sequence[SpillState]) -> SpillState:
    """Join spill shards in worker order; ``sp_overflow`` is any shard's."""
    return _join(shards, 0, (), ("sp_overflow",))



def _steal_round_sharded(cfg: EngineConfig, shards: List[EngineState]) -> List[EngineState]:
    """One steal round over the worker shards of one query, in place: the
    multi-shard form of :func:`_steal_round`, entry for entry the same
    round computed in one address space.

    Every shard's ``size`` is gathered into one ``[V]`` vector, on which
    the first shard's device plans the steals (the plan is a pure function
    of it) and inverts them into each receiver's intake sources.  Each
    shard's bottom ``steal_chunk`` rows of ``st_depth``, ``st_map``,
    ``st_used`` and ``st_cand`` are gathered to every distinct device (the
    steal traffic, ``V·C·(1 + P + 2W)`` words per round); each shard then
    writes the entries addressed to its own receivers and advances its
    donors' ``base`` and ``size`` by its slice of the global ``accepted``.
    ``steal_rounds`` counts rounds with any transfer, globally."""
    _, v_loc, s_cap = shards[0].st_depth.shape
    c = cfg.steal_chunk
    home = shards[0].st_depth.device

    sizes = torch.cat([s.size.to(home) for s in shards], dim=1)  # [1, V]
    accepted, src, has, any_transfer = _steal_plan(cfg, sizes, s_cap)
    n_in = has.shape[-1]
    control = (src[0], has[0], accepted[0], any_transfer)

    # each shard's bottom C entries (donor d slot j = logical position j);
    # the gathers make new tensors, so no shard's stacks alias them
    def bottom(s: EngineState, name: str) -> torch.Tensor:
        dev = s.st_depth.device
        src_slot = ((s.base[0][:, None] + torch.arange(c, device=dev)) % s_cap).long()
        return getattr(s, name)[0][torch.arange(v_loc, device=dev)[:, None], src_slot]

    donated = {name: [bottom(s, name) for s in shards] for name in _STACK_FIELDS}
    on_device = {}
    for dev in dict.fromkeys(s.st_depth.device for s in shards):
        on_device[dev] = (
            {name: torch.cat([x.to(dev) for x in xs]) for name, xs in donated.items()},
            tuple(t.to(dev) for t in control))

    out = []
    for k, s in enumerate(shards):
        dev = s.st_depth.device
        don, (src_g, has_g, acc_g, any_transfer) = on_device[dev]
        rows = slice(k * v_loc, (k + 1) * v_loc)
        src_k, has_k = src_g[rows], has_g[rows]
        d_row, d_col = src_k // c, src_k % c
        q = torch.arange(n_in, device=dev)
        dst_slot = (s.base[0][:, None] + q) % s_cap  # receivers are empty
        didx = torch.arange(v_loc, device=dev)[:, None]
        for name in _STACK_FIELDS:
            frontier.write_slots(getattr(s, name)[0], didx, dst_slot,
                                 don[name][d_row, d_col], has_k)
        depth_in = don["st_depth"][d_row, d_col]
        recv_cnt = has_k.sum(dim=-1, dtype=torch.int32)[None]
        depth_add = torch.where(has_k, depth_in, 0).sum(dim=-1, dtype=torch.int32)[None]
        acc_k = acc_g[rows][None]
        out.append(s._replace(
            base=(s.base + acc_k) % s_cap,  # accepted slots were a bottom prefix
            size=s.size - acc_k + recv_cnt,
            steals=s.steals + recv_cnt,
            steal_depth=s.steal_depth + depth_add,
            steal_rounds=s.steal_rounds + any_transfer,
        ))
    return out


def _loop_flags(s: EngineState, *extra: torch.Tensor) -> torch.Tensor:
    """``[entries, overflowed, steps, *extra]`` of one shard, as int64."""
    return torch.stack([t.to(torch.int64) for t in (
        s.size.sum(), s.overflow.any(), s.steps[0]) + extra])


def _sync_flags(per_shard: Sequence[torch.Tensor]) -> np.ndarray:
    """Per-shard int vectors read on the host with one synchronisation."""
    home = per_shard[0].device
    return torch.stack([t.to(home) for t in per_shard]).cpu().numpy()


def _sharded_engine_loop(cfg: EngineConfig, plans: Sequence[AnyPlanArrays],
                         shards: List[EngineState]) -> List[EngineState]:
    """The round loop over the worker shards of one query (``plans[k]``
    the plan arrays on shard ``k``'s device): each shard's
    ``rebalance_interval`` steps on its device with ``V/D × expand_width``
    lanes, one :func:`_steal_round_sharded`, ``steps`` advanced once.  The
    condition is global: entries left on any shard, ``max_steps``, and no
    shard overflowed, read with one host synchronisation per round."""
    max_steps = cfg.max_steps or (1 << 30)
    shard_cfg = dataclasses.replace(cfg, n_workers=cfg.n_workers // len(shards))
    expands = [make_expand_fn(shard_cfg, p) for p in plans]
    steal = cfg.work_stealing and cfg.n_workers > 1
    while True:
        flags = _sync_flags([_loop_flags(s) for s in shards])
        if not (flags[:, 0].sum() > 0 and flags[0, 2] < max_steps and not flags[:, 1].any()):
            return shards
        shards = [expand(s) for expand, s in zip(expands, shards)]
        if steal:
            shards = _steal_round_sharded(cfg, shards)
        shards = [s._replace(steps=s.steps + cfg.rebalance_interval) for s in shards]


def make_sharded_engine_fn(cfg: EngineConfig, mesh: Mesh):
    """``(arrays, EngineState) -> EngineState`` with the worker axis of a
    one-query state sharded over ``mesh``: ``arrays`` maps each distinct
    device (``str``) to the plan arrays there, and the state lies on the
    mesh's first device, as the result does.

    ``cfg.n_workers`` must be a multiple of the worker axis's size (the session
    snaps it up; `repro_torch.core.session.Enumerator`)."""
    _check_divisible(cfg, mesh)

    def fn(arrays: Dict[str, AnyPlanArrays], state: EngineState) -> EngineState:
        shards = _sharded_engine_loop(cfg, [arrays[str(d)] for d in mesh.shard_devices],
                                      shard_state(state, mesh))
        return gather_state(shards)

    return fn


def run_sharded(plan: SearchPlan, cfg: EngineConfig, mesh: Mesh) -> EngineResult:
    """Enumerate with worker stacks sharded over ``mesh`` (see :func:`run`),
    the plan arrays replicated once per distinct device."""
    fn = make_sharded_engine_fn(cfg, mesh)
    arrays = {str(d): plan_arrays_for(cfg, [plan], d) for d in mesh.distinct_devices}
    return result_from_state(fn(arrays, init_state(plan, cfg, mesh.devices[0])), cfg)


def run(plan: SearchPlan, cfg: EngineConfig, mesh=None, device=None) -> EngineResult:
    """Enumerate all isomorphic subgraphs described by ``plan`` on
    ``device`` (default: the CUDA card; raises without one).  The plan
    arrays follow the resolved step backend (dense bitmaps, or CSR planes
    for ``"csr"`` / large-``n_t`` ``"auto"``); ``"partitioned"`` routes to
    :func:`run_partitioned`.  With ``mesh`` (a :class:`Mesh`, or an int as
    :func:`coerce_mesh` reads it) the worker stacks shard over its devices
    (:func:`run_sharded`); the result equals the unsharded run's."""
    if cfg.step_backend == "partitioned":
        return run_partitioned(plan, cfg, mesh=mesh, device=device)
    mesh = coerce_mesh(mesh, device)
    if mesh is not None:
        return run_sharded(plan, cfg, mesh)
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


# ---------------------------------------------------------------------------
# out-of-core partitioned execution
# ---------------------------------------------------------------------------
#
# The target's CSR planes are row-partitioned (PartitionedPlanes); at any
# moment exactly ONE partition's planes are on the device.  Children whose
# parent rows are all resident are fully constrained and go to the live
# stacks; children owing intersections to non-resident rows are parked in
# per-worker spill rings with a pending-parent bitmask.  The host drains the
# rings into per-partition pools, enumerates the resident partition to
# quiescence, swaps in the partition with the deepest pool, finishes
# constraining its pooled entries at intake (dead / live seed / re-spill
# toward the next pending parent), and repeats until every pool is empty.
# Only fully constrained entries are ever extracted, so the match set is the
# monolithic run's: partitioning changes scheduling, never results.

def part_spill_margin(cfg: EngineConfig) -> int:
    """Most spill pushes per worker in one round: the drain watermark.  The
    round loop yields to the host while this much ring headroom remains, so
    a round can never overflow a ring."""
    return cfg.rebalance_interval * cfg.expand_width


def make_part_round_fn(cfg: EngineConfig, plan: extend.PartPlanArrays):
    """One partitioned round over ``(EngineState, SpillState)``:
    ``rebalance_interval`` partitioned steps, then a steal round over the
    live stacks (spill rings are worker-local and never stolen from: they
    hold parked, not runnable, work).  ``repro`` compacts the rings each
    round; the port addresses them modulo their base and does not."""
    step = extend.make_partitioned_step_fn(cfg, plan)

    def body(st: EngineState, spill: SpillState):
        for _ in range(cfg.rebalance_interval):
            st, spill = step(st, spill)
        if cfg.work_stealing and cfg.n_workers > 1:
            st = _steal_round(cfg, st)
        return st._replace(steps=st.steps + cfg.rebalance_interval), spill

    return body


def _part_engine_loop(cfg: EngineConfig, plans: Sequence[extend.PartPlanArrays],
                      sts: List[EngineState], spills: List[SpillState]):
    """Run partitioned rounds over the worker shards of one leg (one shard
    without a mesh; ``plans[k]`` the resident partition on shard ``k``'s
    device) until the live stacks drain, ``max_steps`` is reached, a stack
    or a spill ring overflows, or a ring crosses its drain watermark:
    ``repro``'s ``while_loop`` condition, taken over all shards and read
    once per round (one host synchronisation).  The host then drains the
    rings and, if work remains, comes back with the same live state.

    Each shard's round is :func:`make_part_round_fn` over its own workers,
    **its steal round included**: as in ``repro``
    (``_part_sharded_device_loop``), under a mesh entries are stolen only
    within a shard, and each shard counts its own ``steal_rounds`` (ROADMAP
    Queue 3 f)."""
    max_steps = cfg.max_steps or (1 << 30)
    shard_cfg = dataclasses.replace(cfg, n_workers=cfg.n_workers // len(sts))
    bodies = [make_part_round_fn(shard_cfg, p) for p in plans]
    margin = part_spill_margin(cfg)
    while True:
        flags = _sync_flags([_loop_flags(st, sp.sp_overflow, frontier.spill_watermark(sp, margin))
                             for st, sp in zip(sts, spills)])
        if not (flags[:, 0].sum() > 0 and flags[0, 2] < max_steps
                and not flags[:, [1, 3, 4]].any()):
            return sts, spills
        sts, spills = map(list, zip(*(body(st, sp) for body, st, sp in zip(bodies, sts, spills))))


def make_partitioned_engine_fn(cfg: EngineConfig, mesh: Optional[Mesh] = None):
    """``(arrays, EngineState, SpillState) -> (EngineState, SpillState)``:
    the inner engine of one leg of :func:`run_partitioned`.  Without a mesh
    ``arrays`` is the resident partition's :class:`~repro_torch.core.extend.
    PartPlanArrays`; with one, a map from each distinct device (``str``) to
    its replica, and the states lie on the mesh's first device, sharded
    inside and gathered in worker order after."""
    if mesh is None:
        def one(arrays, st: EngineState, spill: SpillState):
            (st,), (spill,) = _part_engine_loop(cfg, [arrays], [st], [spill])
            return st, spill

        return one
    _check_divisible(cfg, mesh)

    def fn(arrays, st: EngineState, spill: SpillState):
        sts, spills = _part_engine_loop(
            cfg, [arrays[str(d)] for d in mesh.shard_devices],
            shard_state(st, mesh), shard_spill(spill, mesh))
        return gather_state(sts), gather_spill(spills)

    return fn


def _intake_entry(plan: SearchPlan, pp, pid: int, depth: int,
                  map_row: np.ndarray, cand: np.ndarray, pending: int):
    """Apply the now-resident pending parents of one pooled entry: AND the
    partition's adjacency rows into ``cand`` and clear their pending bits.
    Returns the updated ``(cand, pending)``."""
    lo, hi = int(pp.node_start[pid]), int(pp.node_start[pid + 1])
    part = pp.parts[pid]
    j = 0
    rem = pending
    while rem:
        if rem & 1:
            t = int(map_row[int(plan.parent_pos[depth, j])])
            if lo <= t < hi:
                plane = int(plan.parent_elab[depth, j]) * 2 + int(plan.parent_dir[depth, j])
                s = int(part.indptr[plane, t - lo])
                e = int(part.indptr[plane, t - lo + 1])
                cand = cand & bitmap_from_indices(
                    part.indices[s:e].astype(np.int64), plan.n_t, plan.w)
                pending &= ~(1 << j)
        rem >>= 1
        j += 1
    return cand, pending


def _intake_chunk(plan: SearchPlan, pp, pid: int, pools, chunk_n: int):
    """Pop up to ``chunk_n`` entries from partition ``pid``'s pool and
    finish or advance their constraints: dead entries are dropped, entries
    still pending go to the partition of their (new) first pending parent,
    fully constrained ones become live seeds.  Returns ``(seed_depth,
    seed_map, seed_cand, n_dead)``, possibly with no seeds."""
    pool = pools[pid]
    sd, sm, sc = [], [], []
    n_dead = 0
    while pool and len(sd) < chunk_n:
        depth, map_row, cand, pending = pool.pop()
        cand, pending = _intake_entry(plan, pp, pid, depth, map_row, cand, pending)
        if not cand.any():
            n_dead += 1
            continue
        if pending:
            j0 = (pending & -pending).bit_length() - 1
            t = int(map_row[int(plan.parent_pos[depth, j0])])
            pools[int(np.searchsorted(pp.node_start, t, side="right") - 1)].append(
                (depth, map_row, cand, pending))
            continue
        sd.append(depth)
        sm.append(map_row)
        sc.append(cand)
    return (
        np.asarray(sd, dtype=np.int32),
        np.asarray(sm, dtype=np.int32).reshape(len(sm), plan.p_pad),
        np.asarray(sc, dtype=np.uint32).reshape(len(sc), plan.w),
        n_dead,
    )


def _drain_spill(spill: SpillState):
    """Every worker's spill-ring entries as host tuples ``(depth, map,
    cand, pending, part)``, ``cand`` as ``uint32`` words (slots past
    ``sp_size`` are stale and not read)."""
    d_, m_, c_, pe_, pa_, sz_ = (t.cpu().numpy() for t in (
        spill.sp_depth, spill.sp_map, spill.sp_cand, spill.sp_pending, spill.sp_part,
        spill.sp_size))
    c_ = c_.view(np.uint32)
    return [(int(d_[v, i]), m_[v, i].copy(), c_[v, i].copy(), int(pe_[v, i]), int(pa_[v, i]))
            for v in range(sz_.shape[0]) for i in range(int(sz_[v]))]


_PART_MAX_ATTEMPTS = 4


def partition_root_entries(plan: SearchPlan, cfg: EngineConfig, pp):
    """Root pool entries for the partitioned scheduling loop, in partition and row
    order: ``[(part, (depth, map_row, cand, pending)), ...]``.

    Under vertex seeding each partition gets **one** entry ``(0, [-1 ...],
    dom[0] ∩ its rows, 0)``, so roots are enumerated while their own rows
    are resident.  Under edge seeding the plan's seed arcs
    (`repro_torch.core.frontier.root_seed_entries`) become depth-1 entries
    of the partition owning ``map[0]``, with no pending parents (position
    1's constraints all reference position 0 and are applied on the host
    when the seeds are built)."""
    mode = cfg.root_seeding
    if mode == "auto":
        mode = "edge" if plan.seed_edge is not None else "vertex"
    entries = []
    if mode == "edge":
        if plan.seed_edge is None:
            raise ValueError(
                "root_seeding='edge' requires a plan built with seed_edge= "
                "(plan.seed_edge is unset; see repro_torch.core.plan.build_plan)"
            )
        sd, sm, sc = frontier.root_seed_entries(plan)
        for i in range(sd.shape[0]):
            part = int(np.searchsorted(pp.node_start, int(sm[i, 0]), side="right") - 1)
            entries.append((part, (int(sd[i]), sm[i].copy(), sc[i].copy(), 0)))
        return entries
    if not plan.satisfiable:
        return entries
    m0 = np.full(plan.p_pad, -1, dtype=np.int32)
    for pid in range(pp.n_parts):
        lo, hi = int(pp.node_start[pid]), int(pp.node_start[pid + 1])
        if hi <= lo:
            continue
        cand = plan.dom_bits[0] & bitmap_from_indices(np.arange(lo, hi), plan.n_t, plan.w)
        if cand.any():
            entries.append((pid, (0, m0.copy(), cand, 0)))
    return entries


def run_partitioned(plan: SearchPlan, cfg: EngineConfig, mesh=None, device=None,
                    stats: Optional[dict] = None) -> EngineResult:
    """Enumerate ``plan`` against a row-partitioned target streamed through
    device memory, on ``device`` (default: the CUDA card; raises without
    one): the host scheduling loop of the out-of-core path.

    ``cfg.n_partitions`` partitions (0 → 1; with 1 no extension leaves the
    resident range, which is the csr backend's search) are visited: the
    resident one is enumerated to quiescence in *legs* (seed → round loop
    to drain, with host ring drains at the spill watermark), then the
    partition with the deepest spill pool is swapped in and re-seeded from
    its pool.  A stack or spill-ring overflow retries the leg with that
    capacity doubled, at most :data:`_PART_MAX_ATTEMPTS` times.

    With ``mesh`` (see :func:`coerce_mesh`) worker stacks and spill rings
    shard over its devices and the resident partition is replicated
    (:func:`make_partitioned_engine_fn`); the host drains the rings
    gathered in worker order, and the next partition is the next one with
    a non-empty pool, round-robin, as in ``repro``.

    ``stats``, if given, is filled with ``repro``'s scheduling counters
    (resident bytes, visits, legs, rounds, spills, deaths)."""
    mesh = coerce_mesh(mesh, device)
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    if cfg.step_backend != "partitioned":
        cfg = dataclasses.replace(cfg, step_backend="partitioned")
    if mesh is not None:
        _check_divisible(cfg, mesh)
    n_parts = max(1, cfg.n_partitions)
    pp = extend.plan_partitions(plan, n_parts)
    p_pad, w, v = plan.p_pad, plan.w, cfg.n_workers
    mcap = max(1, cfg.collect_matches)

    pools = [[] for _ in range(n_parts)]
    leg_cfg = cfg
    totals = dict(matches=0, states=0, steps=0, steals=0, steal_rounds=0,
                  steal_depth=0, exp_depth=0)
    pw_states = np.zeros(v, dtype=np.int64)
    pw_matches = np.zeros(v, dtype=np.int64)
    pw_steals = np.zeros(v, dtype=np.int64)
    match_rows = []
    n_visits = n_legs = n_rounds = n_spilled = n_dead = 0
    max_pool = 0

    def run_leg(arrays, seed):
        """One leg: seed → round loop to quiescence, draining the rings at
        the watermark; retries with a doubled capacity on overflow.
        Returns the final state and the leg's drained spill entries."""
        nonlocal leg_cfg, n_rounds
        for _ in range(_PART_MAX_ATTEMPTS):
            fn = make_partitioned_engine_fn(leg_cfg, mesh)
            st = frontier.init_delta_state(plan, leg_cfg, *seed, device)
            spill = frontier.init_spill_state(v, leg_cfg.resolved_spill_cap(p_pad), p_pad, w,
                                              device)
            staged = []
            while True:
                st, spill = fn(arrays, st, spill)
                n_rounds += 1
                if bool(st.overflow.any()):
                    leg_cfg = dataclasses.replace(
                        leg_cfg, stack_cap=2 * leg_cfg.resolved_stack_cap(p_pad))
                    break
                if bool(spill.sp_overflow):
                    leg_cfg = dataclasses.replace(
                        leg_cfg, spill_cap=2 * leg_cfg.resolved_spill_cap(p_pad))
                    break
                staged.extend(_drain_spill(spill))
                spill = spill._replace(sp_size=torch.zeros_like(spill.sp_size))
                max_steps = leg_cfg.max_steps or (1 << 30)
                if int(st.size.sum()) == 0 or int(st.steps[0]) >= max_steps:
                    return st, staged
        raise RuntimeError(
            f"partitioned leg kept overflowing after {_PART_MAX_ATTEMPTS} "
            f"capacity doublings (stack_cap={leg_cfg.stack_cap}, "
            f"spill_cap={leg_cfg.spill_cap})"
        )

    def absorb(st, staged):
        """Fold a finished leg into the run's totals and commit its spills."""
        nonlocal n_spilled, max_pool
        st = EngineState(*(x[0] for x in st))  # the query's pack lane

        def host(t):
            return t.cpu().numpy().astype(np.int64)

        totals["matches"] += int(st.matches.sum())
        totals["states"] += int(st.states.sum())
        totals["steps"] += int(st.steps)
        totals["steals"] += int(st.steals.sum())
        totals["steal_rounds"] += int(st.steal_rounds)
        totals["steal_depth"] += int(st.steal_depth.sum())
        totals["exp_depth"] += int(st.exp_depth.sum())
        pw_states[:] += host(st.states)
        pw_matches[:] += host(st.matches)
        pw_steals[:] += host(st.steals)
        if cfg.collect_matches:
            m = st.matches.cpu().numpy()
            buf = st.match_buf.cpu().numpy()
            for v_ in range(v):
                k = min(int(m[v_]), mcap)
                if k:
                    match_rows.append(buf[v_, :k])
        for depth, map_row, cand, pending, part in staged:
            pools[part].append((depth, map_row, cand, pending))
        n_spilled += len(staged)
        max_pool = max(max_pool, max((len(p) for p in pools), default=0))

    # roots enter through the pools, each batch owned by the partition whose
    # rows it maps, so a partition's first leg extends against its own rows
    for part, entry in partition_root_entries(plan, cfg, pp):
        pools[part].append(entry)

    current = next((pid for pid in range(n_parts) if pools[pid]), None)
    while current is not None:
        if mesh is None:
            arrays = extend.make_part_plan_arrays(plan, pp, current, device)
        else:
            arrays = {str(d): extend.make_part_plan_arrays(plan, pp, current, d)
                      for d in mesh.distinct_devices}
        n_visits += 1
        while True:
            chunk_n = v * max(leg_cfg.resolved_stack_cap(p_pad) // 2, 1)
            sd, sm, sc, dead = _intake_chunk(plan, pp, current, pools, chunk_n)
            n_dead += dead
            if sd.shape[0] == 0:
                if pools[current]:
                    continue  # the chunk was all dead or re-routed; keep draining
                break  # the partition is quiescent
            absorb(*run_leg(arrays, (sd, sm, sc)))
            n_legs += 1
        nxt = None
        if mesh is not None:  # round-robin partition rotation under a mesh
            nxt = next((p % n_parts for p in range(current + 1, current + n_parts + 1)
                        if pools[p % n_parts]), None)
        else:  # the deepest spill pool next
            depth_best = 0
            for pid in range(n_parts):
                if len(pools[pid]) > depth_best:
                    nxt, depth_best = pid, len(pools[pid])
        current = nxt

    if stats is not None:
        stats.update(
            n_parts=n_parts,
            visits=n_visits,
            legs=n_legs,
            rounds=n_rounds,
            spilled=n_spilled,
            dead_spills=n_dead,
            max_pool=max_pool,
            cut_edges=pp.cut_edges,
            resident_plane_bytes=extend.part_resident_nbytes(pp),
            per_part_nbytes=[p.nbytes for p in pp.parts],
            final_stack_cap=leg_cfg.resolved_stack_cap(p_pad),
            final_spill_cap=leg_cfg.resolved_spill_cap(p_pad),
        )

    match_buf = None
    if cfg.collect_matches:
        rows = (np.concatenate(match_rows, axis=0) if match_rows
                else np.zeros((0, p_pad), np.int32))
        match_buf = np.full((1, max(1, rows.shape[0]), p_pad), -1, np.int32)
        match_buf[0, : rows.shape[0]] = rows

    steals = totals["steals"]
    states = totals["states"]
    return EngineResult(
        matches=totals["matches"],
        states=states,
        steps=totals["steps"],
        steals=steals,
        steal_rounds=totals["steal_rounds"],
        mean_steal_depth=(totals["steal_depth"] / steals) if steals else 0.0,
        mean_expand_depth=(totals["exp_depth"] / states) if states else 0.0,
        per_worker_states=pw_states,
        per_worker_matches=pw_matches,
        overflow=False,
        match_buf=match_buf,
        per_worker_steals=pw_steals,
    )
