"""The port's out-of-core partitioned path against the JAX package's, on the CPU.

* partitioning: ``Graph.partition`` byte-equal to ``repro``'s at several
  counts and in budget mode, with the same errors;
  ``plan_partitions_budget`` / ``part_resident_nbytes`` give the same
  count, bytes and ``ValueError``; ``make_part_plan_arrays`` equals
  ``repro``'s arrays;
* spill rings: ``init_spill_state``, ``push_spill`` (drops past the
  capacity and the overflow latch included) and ``spill_watermark`` equal
  ``repro``'s;
* the step: one ``expand_lanes_part`` equals ``repro``'s on every lane
  output, ``pending`` and ``spill_part``, under both walks' plain versions,
  on lanes whose every parent is off the partition and lanes with mixed
  parents; the ``EngineState`` (rings read from their base) and
  ``SpillState`` after each partitioned round equal ``repro``'s;
* the driver: ``partition_root_entries`` (vertex and edge seeds) and
  ``run_partitioned`` equal ``repro``'s counter for counter, per worker,
  and on every ``stats`` key, at 1, 2 and 4 partitions under vertex and
  edge seeding, with a spill ring that forces watermark drains and with a
  stack that forces leg retries; ``ref_enumerate_partitioned`` equals
  ``repro``'s oracle and the engine's scheduling statistics;
* sessions: ``Enumerator(memory_budget_bytes=)`` derives ``repro``'s
  count and results, dense and sparse indexes, collected mappings, packs
  and streams run singly, ``coalesce_key``, and a CPU run launches no
  kernel.

Counters and bitmaps are integers: exact equality.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import Enumerator as JaxEnumerator  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core import extend as jax_extend  # noqa: E402
from repro.core import frontier as jax_frontier  # noqa: E402
from repro.core import ref as jax_ref  # noqa: E402
from repro.core.plan import build_csr_plan as jax_build_csr_plan  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex, enumerate_subgraphs  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import extend, frontier, ref  # noqa: E402
from repro_torch.core.frontier import EngineState, SpillState  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from tests.conftest import extract_connected_pattern, power_law_target  # noqa: E402
from tests.test_torch_engine import assert_engine_results_equal  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402
from tests.test_torch_sparse import RINGS, _from_base, _port_plan  # noqa: E402

CPU = "cpu"
KW = dict(n_workers=4, expand_width=2)
# the port's partitioned step paths: (use_pallas, csr_walk); on the CPU
# use_pallas runs the kernels' entry points, which take their plain versions
WALKS = [(False, "bucketed"), (False, "flat"), (True, "bucketed"), (True, "flat")]


def _sparse_case(rng, n=300):
    """tests/test_partitioned.py's case: a power-law target and a 4-node
    pattern grown from it."""
    tgt = power_law_target(rng, n, avg_deg=3.0, n_labels=6)
    return tgt, extract_connected_pattern(rng, tgt, 4)


@functools.lru_cache(maxsize=None)
def _case(n=300, seeded=False, pattern_seed=None):
    """(target, pattern, repro's CSR-only plan) of the seed-0 case; the
    plan carries a seed edge when ``seeded``.  ``pattern_seed`` swaps the
    pattern for the first 4-node one grown with that seed: 7 gives one
    whose positions 2 and 3 have two parents each (so a lane can have a
    resident and a non-resident parent), 1 one with 122 states."""
    tgt, pat = _sparse_case(np.random.default_rng(0), n)
    if pattern_seed is not None:
        pat = extract_connected_pattern(np.random.default_rng(pattern_seed), tgt, 4)
    return tgt, pat, jax_build_csr_plan(pat, tgt, seed_edge="auto" if seeded else None)


def _plans(n=300, seeded=False, pattern_seed=None):
    """A fresh port plan beside repro's (the partition caches live on the
    plans, so each test gets a port plan of its own)."""
    tgt, pat, jplan = _case(n, seeded, pattern_seed)
    return tgt, pat, jplan, _port_plan(jplan)


def _resident_bytes(jplan, n_parts):
    """repro's padded resident bytes of ``jplan`` at ``n_parts``: budgets
    at the boundaries of its derivation."""
    return jax_extend.part_resident_nbytes(jax_extend.plan_partitions(jplan, n_parts))


def _assert_planes_equal(got, want, msg=""):
    assert got.n_t == want.n_t and got.deg_cap == want.deg_cap, msg
    for f in ("indptr", "indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{msg} {f}"


def _assert_partitions_equal(got, want):
    assert got.n_t == want.n_t and got.n_parts == want.n_parts
    for f in ("node_start", "cut_per_part"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for pid, (a, b) in enumerate(zip(got.parts, want.parts)):
        _assert_planes_equal(a, b, f"part {pid}")
    for f in ("n_planes", "cut_edges", "deg_cap", "max_local", "max_nnz", "max_resident_nbytes"):
        assert getattr(got, f) == getattr(want, f), f
    nodes = np.arange(got.n_t)
    np.testing.assert_array_equal(got.part_of(nodes), want.part_of(nodes))


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_parts", (1, 2, 3, 5, 8))
def test_partitions_byte_equal(n_parts):
    tgt, _, _ = _case(200)
    _assert_partitions_equal(to_port(tgt).partition(n_parts=n_parts),
                             tgt.partition(n_parts=n_parts))


def test_partitions_byte_equal_budget_mode():
    """max_bytes= picks repro's count; the argument errors are repro's."""
    tgt, _, _ = _case(200)
    g = to_port(tgt)
    whole = tgt.csr_planes().nbytes
    for budget in (whole // 2, whole // 3, whole // 4):
        got, want = g.partition(max_bytes=budget), tgt.partition(max_bytes=budget)
        assert want.n_parts > 1
        _assert_partitions_equal(got, want)
    for kw in (dict(n_parts=2, max_bytes=whole), {}, dict(n_parts=0), dict(max_bytes=0),
               dict(max_bytes=500)):
        msgs = []
        for graph in (g, tgt):
            with pytest.raises(ValueError) as e:
                graph.partition(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw


def test_plan_partitions_budget_matches_repro():
    """Budget derivation over the padded resident bytes gives repro's count,
    bytes and shape bucket, caches as repro's does, and raises repro's
    ValueError when nothing fits."""
    _, _, jplan, plan = _plans()
    whole = _resident_bytes(jplan, 1)
    assert extend.part_resident_nbytes(extend.plan_partitions(plan, 1)) == whole
    counts = set()
    for budget in (whole - 1, _resident_bytes(jplan, 2), _resident_bytes(jplan, 4)):
        plan = _port_plan(jplan)  # a fresh partition cache per budget
        want = jax_extend.plan_partitions_budget(jplan, budget)
        got = extend.plan_partitions_budget(plan, budget)
        _assert_partitions_equal(got, want)
        assert extend.part_resident_nbytes(got) == jax_extend.part_resident_nbytes(want)
        assert extend.part_resident_nbytes(got) <= budget
        assert extend.plan_partitions(plan, got.n_parts) is got
        assert extend.plan_partitions_budget(plan, budget) is got
        assert extend.partitioned_shape_bucket(plan, got.n_parts) == \
            jax_extend.partitioned_shape_bucket(jplan, want.n_parts)
        counts.add(got.n_parts)
    assert len(counts) > 1
    msgs = []
    for fn, p in ((extend.plan_partitions_budget, plan),
                  (jax_extend.plan_partitions_budget, jplan)):
        with pytest.raises(ValueError, match="cannot (fit|hold)") as e:
            fn(p, 64)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n_parts", (1, 3))
def test_make_part_plan_arrays_matches_repro(n_parts):
    _, _, jplan, plan = _plans()
    pp, jpp = extend.plan_partitions(plan, n_parts), jax_extend.plan_partitions(jplan, n_parts)
    for pid in range(n_parts):
        got = extend.make_part_plan_arrays(plan, pp, pid, CPU)
        want = jax_extend.make_part_plan_arrays(jplan, jpp, pid)
        for f in ("order_valid", "parent_pos", "parent_dir", "parent_elab", "indptr",
                  "indices", "part_starts"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(got.dom_bits.numpy().view(np.uint32),
                                      np.asarray(want.dom_bits))
        assert got.deg_cap == want.seg_iota.shape[0]
        assert (got.part_lo, got.part_hi) == (int(want.part_lo), int(want.part_hi))
        assert got.n_p.tolist() == [int(want.n_p)] and got.p_pad == plan.p_pad
        assert extend.part_resident_nbytes(pp) == 4 * (
            got.indptr.numel() + got.indices.numel() + got.part_starts.numel())


# ---------------------------------------------------------------------------
# spill rings
# ---------------------------------------------------------------------------

def _assert_spill_equal(got: SpillState, want, msg=""):
    for name, a, b in zip(SpillState._fields, got, want):
        b = np.asarray(b)
        a = a.numpy()
        a = a.view(b.dtype) if b.dtype == np.uint32 else a
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def test_spill_ring_matches_repro():
    """Pushes of random lanes into a 7-slot ring: slots, sizes, drops past
    the capacity and the overflow latch, and the watermark at every margin,
    equal repro's after each push."""
    rng = np.random.default_rng(3)
    v, e, cap, p_pad, w = 3, 5, 7, 6, 2
    got = frontier.init_spill_state(v, cap, p_pad, w, CPU)
    want = jax_frontier.init_spill_state(v, cap, p_pad, w)
    _assert_spill_equal(got, want, "init")
    latched = False
    for k in range(6):
        flags = rng.random((v, e)) < 0.6
        depth = rng.integers(1, p_pad, (v, e)).astype(np.int32)
        map_ = rng.integers(-1, 50, (v, e, p_pad)).astype(np.int32)
        cand = rng.integers(0, 2**32, (v, e, w), dtype=np.uint64).astype(np.uint32)
        pending = rng.integers(1, 256, (v, e)).astype(np.int32)
        part = rng.integers(0, 4, (v, e)).astype(np.int32)
        got = frontier.push_spill(got, torch.from_numpy(flags), torch.from_numpy(depth),
                                  torch.from_numpy(map_), torch.from_numpy(cand.view(np.int32)),
                                  torch.from_numpy(pending), torch.from_numpy(part))
        want = jax_frontier.push_spill(want, flags, depth, map_, cand, pending, part)
        _assert_spill_equal(got, want, f"push {k}")
        latched |= bool(got.sp_overflow)
        for margin in range(cap + 2):
            assert bool(frontier.spill_watermark(got, margin)) == bool(
                jax_frontier.spill_watermark(want, margin)), (k, margin)
    assert latched and (got.sp_size == cap).all()


# ---------------------------------------------------------------------------
# the partitioned step
# ---------------------------------------------------------------------------

def _random_lanes(rng, plan, b, lo, hi):
    """``b`` lanes at random depths with distinct targets mapped below their
    depth (each in the rows ``[lo, hi)`` with probability 1/2), used-bitmaps
    of those targets and random candidates within the depth's domain (some
    empty)."""
    p_pad, w, n_t = plan.p_pad, plan.w, plan.n_t
    depth = rng.integers(0, plan.n_p, b).astype(np.int32)
    map_ = np.full((b, p_pad), -1, np.int32)
    used = np.zeros((b, w), np.uint32)
    cand = np.zeros((b, w), np.uint32)
    for i in range(b):
        pool = rng.permutation(np.arange(lo, hi)) if rng.random() < 0.5 else rng.permutation(n_t)
        t = pool[: int(depth[i])]
        map_[i, : depth[i]] = t
        for x in t:
            used[i, x // 32] |= np.uint32(1) << np.uint32(x % 32)
        if i % 7:
            bits = rng.integers(0, 2**32, w, dtype=np.uint64).astype(np.uint32)
            cand[i] = bits & plan.dom_bits[depth[i]] & ~used[i]
    return depth, map_, used, cand


@pytest.mark.parametrize("use_pallas,walk", WALKS)
def test_expand_lanes_part_matches_repro(use_pallas, walk):
    """One partitioned step of random lanes, with partition 1 of 4 resident,
    equals repro's on every lane output, ``pending`` and ``spill_part``
    (repro's plain walk; the port's plain walk or its kernels' entry
    points).  The lanes include ones whose every real parent is off the
    partition and ones with resident and off-partition parents."""
    rng = np.random.default_rng(5)
    _, _, jplan, plan = _plans(pattern_seed=7)
    pp, jpp = extend.plan_partitions(plan, 4), jax_extend.plan_partitions(jplan, 4)
    lo, hi = int(pp.node_start[1]), int(pp.node_start[2])
    depth, map_, used, cand = _random_lanes(rng, plan, 96, lo, hi)
    cfg = EngineConfig(step_backend="partitioned", use_pallas=use_pallas, csr_walk=walk,
                       n_workers=48, expand_width=2)
    jcfg = JaxConfig(step_backend="partitioned", csr_walk=walk)
    jbackend = jax_extend.PartitionedCsrStepBackend(
        jcfg, jax_extend.make_part_plan_arrays(jplan, jpp, 1))
    want = jax.jit(jbackend.expand_lanes_part)(depth, map_, used, cand)
    backend = extend.PartitionedCsrStepBackend(cfg, extend.make_part_plan_arrays(plan, pp, 1, CPU))
    got = backend.expand_lanes_part(*(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                                       else a) for a in (depth, map_, used, cand)))
    for name in got.lanes._fields:
        a, b = getattr(got.lanes, name).numpy(), np.asarray(getattr(want.lanes, name))
        a = a.view(b.dtype) if b.dtype == np.uint32 else a
        if name == "v":  # informational off valid lanes
            a, b = a[np.asarray(want.lanes.valid)], b[np.asarray(want.lanes.valid)]
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("spill", "pending", "spill_part"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the lanes the step meets: a wanted child with every real parent off
    # the partition, and one with resident and off-partition parents
    kinds = set()
    for i in np.nonzero(np.asarray(want.lanes.valid) & ~np.asarray(want.lanes.is_match))[0]:
        pos = depth[i] + 1
        m2 = map_[i].copy()
        m2[depth[i]] = int(np.asarray(want.lanes.v)[i])
        ts = [int(m2[j]) for j in plan.parent_pos[pos] if j >= 0]
        res = [lo <= t < hi for t in ts]
        if ts and not any(res):
            kinds.add("all off")
        elif any(res) and not all(res):
            kinds.add("mixed")
    assert kinds == {"all off", "mixed"}
    assert np.asarray(want.spill).any() and np.asarray(want.lanes.has_child).any()


@pytest.mark.parametrize("store_used,collect", [(True, 4), (False, 0)])
def test_partitioned_round_state_matches_repro(store_used, collect):
    """From a partition's first leg seeds, after each of several partitioned
    rounds (steps, then the steal round), every EngineState tensor equals
    repro's, each ring read from its base (repro compacts the rings every
    round, the port does not), and every SpillState tensor equals
    repro's."""
    _, _, jplan, plan = _plans()
    kw = dict(n_workers=3, expand_width=2, rebalance_interval=3, store_used=store_used,
              collect_matches=collect, step_backend="partitioned", n_partitions=3)
    jcfg = JaxConfig(**kw)
    jpp, pp = jax_extend.plan_partitions(jplan, 3), extend.plan_partitions(plan, 3)
    pools = [[] for _ in range(3)]
    for part, entry in jax_eng.partition_root_entries(jplan, jcfg, jpp):
        pools[part].append(entry)
    pid = 2
    sd, sm, sc, _ = jax_eng._intake_chunk(jplan, jpp, pid, pools, 6)
    jround = jax.jit(jax_eng.make_part_round_fn(jcfg, jax_extend.make_part_plan_arrays(
        jplan, jpp, pid)))
    cap = jcfg.resolved_spill_cap(plan.p_pad)
    want = [(jax_frontier.init_delta_state(jplan, jcfg, sd, sm, sc),
             jax_frontier.init_spill_state(3, cap, plan.p_pad, plan.w))]
    for _ in range(6):
        want.append(jround(want[-1]))
    assert int(np.asarray(want[-1][1].sp_size).sum()) > 0
    rotated = False
    for use_pallas, walk in WALKS[::3]:
        cfg = EngineConfig(use_pallas=use_pallas, csr_walk=walk, **kw)
        body = eng.make_part_round_fn(cfg, extend.make_part_plan_arrays(plan, pp, pid, CPU))
        st = frontier.init_delta_state(plan, cfg, sd, sm, sc, CPU)
        spill = frontier.init_spill_state(3, cap, plan.p_pad, plan.w, CPU)
        for i, (w_st, w_sp) in enumerate(want):
            if i:
                st, spill = body(st, spill)
            rotated |= bool(st.base.any())
            msg = f"after {i} rounds, {walk} use_pallas={use_pallas}"
            for name, a, b in zip(EngineState._fields, st, w_st):
                if name == "base":
                    continue
                b = np.asarray(b)
                a = a[0].numpy()
                a = a.view(b.dtype) if b.dtype == np.uint32 else a
                if name in RINGS:
                    a = _from_base(a, st.base[0].numpy())
                    b = _from_base(b, np.asarray(w_st.base))
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {msg}")
            _assert_spill_equal(spill, w_sp, msg)
    assert rotated


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeded,n_parts", [(False, 2), (False, 5), (True, 2), (True, 4)])
def test_partition_root_entries_match_repro(seeded, n_parts):
    _, _, jplan, plan = _plans(seeded=seeded)
    mode = "edge" if seeded else "vertex"
    got = eng.partition_root_entries(plan, EngineConfig(root_seeding=mode),
                                     extend.plan_partitions(plan, n_parts))
    want = jax_eng.partition_root_entries(jplan, JaxConfig(root_seeding=mode),
                                          jax_extend.plan_partitions(jplan, n_parts))
    assert len(got) == len(want) > 1
    for (gp, g), (wp, w) in zip(got, want):
        assert gp == wp and g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[2].dtype == np.uint32
    if not seeded:  # the same refusal as repro's for an unseeded plan
        for fn, p, cfg, pp in ((eng.partition_root_entries, plan, EngineConfig,
                                extend.plan_partitions(plan, n_parts)),
                               (jax_eng.partition_root_entries, jplan, JaxConfig,
                                jax_extend.plan_partitions(jplan, n_parts))):
            with pytest.raises(ValueError, match="seed_edge"):
                fn(p, cfg(root_seeding="edge"), pp)


def _run_both(cfg_kw, seeded=False, n=300):
    """run_partitioned of the port and of repro on one plan: (port result,
    port stats, repro result, repro stats)."""
    _, _, jplan, plan = _plans(n, seeded)
    stats, jstats = {}, {}
    got = eng.run_partitioned(plan, EngineConfig(**cfg_kw), device=CPU, stats=stats)
    want = jax_eng.run_partitioned(jplan, JaxConfig(**cfg_kw), stats=jstats)
    return got, stats, want, jstats


def _assert_run_equal(got, stats, want, jstats):
    assert_engine_results_equal(got, want)
    for f in ("mean_steal_depth", "mean_expand_depth", "overflow"):
        assert getattr(got, f) == getattr(want, f), f
    assert stats == jstats


@pytest.mark.parametrize("seeding", ["vertex", "edge"])
@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_run_partitioned_matches_repro(n_parts, seeding):
    """Every counter, per-worker counter and stats key equals repro's; the
    scheduling statistics equal the partitioned oracle's and the results
    the monolithic oracle's."""
    kw = dict(KW, step_backend="partitioned", n_partitions=n_parts, root_seeding=seeding)
    got, stats, want, jstats = _run_both(kw, seeded=seeding == "edge")
    _assert_run_equal(got, stats, want, jstats)
    tgt, pat, _, plan = _plans(seeded=seeding == "edge")
    oracle = ref.ref_enumerate_partitioned(to_port(pat), to_port(tgt), n_parts, plan=plan)
    mono = ref.ref_enumerate(to_port(pat), to_port(tgt), plan=plan)
    assert got.matches == oracle.matches == mono.matches
    if seeding == "vertex":  # the oracles seed from vertices: depth-0 states count
        assert got.states == oracle.states == mono.states
        assert (stats["visits"], stats["spilled"], stats["dead_spills"]) == (
            oracle.visits, oracle.spilled, oracle.dead_spills)
    if n_parts > 1:
        assert stats["spilled"] > 0 and stats["visits"] > n_parts - 1


@pytest.mark.parametrize("n_parts", [2, 4])
def test_run_partitioned_two_parent_pattern_matches_repro(n_parts):
    """The pattern whose positions have two parents, so children can owe an
    intersection to one partition after another: repro's counters, stats,
    and the partitioned oracle's."""
    kw = dict(KW, step_backend="partitioned", n_partitions=n_parts)
    _, _, jplan, plan = _plans(pattern_seed=7)
    stats, jstats = {}, {}
    got = eng.run_partitioned(plan, EngineConfig(**kw), device=CPU, stats=stats)
    _assert_run_equal(got, stats, jax_eng.run_partitioned(jplan, JaxConfig(**kw), stats=jstats),
                      jstats)
    tgt, pat, _ = _case(pattern_seed=7)
    oracle = ref.ref_enumerate_partitioned(to_port(pat), to_port(tgt), n_parts, plan=plan)
    assert (got.matches, got.states, stats["visits"], stats["spilled"], stats["dead_spills"]) == (
        oracle.matches, oracle.states, oracle.visits, oracle.spilled, oracle.dead_spills)
    assert stats["spilled"] > 0


def test_tiny_spill_ring_matches_repro():
    """A spill ring two slots above the watermark margin makes the round
    loop yield for host drains within a leg (rounds > legs): still repro's
    counters and stats."""
    margin = eng.part_spill_margin(EngineConfig(**KW))
    kw = dict(KW, step_backend="partitioned", n_partitions=4, spill_cap=margin + 2)
    got, stats, want, jstats = _run_both(kw)
    _assert_run_equal(got, stats, want, jstats)
    assert stats["rounds"] > stats["legs"] and stats["spilled"] > 0


def test_tiny_stack_leg_retries_match_repro():
    """A stack that overflows inside a leg retries the leg at doubled
    capacities, as repro does: the same counters, stats and final caps."""
    kw = dict(n_workers=2, expand_width=2, stack_cap=3, step_backend="partitioned",
              n_partitions=3)
    got, stats, want, jstats = _run_both(kw)
    _assert_run_equal(got, stats, want, jstats)
    assert stats["final_stack_cap"] > 3 and not got.overflow


def test_run_partitioned_raises_after_max_attempts(monkeypatch):
    """A leg that keeps overflowing raises repro's RuntimeError after
    ``_PART_MAX_ATTEMPTS`` doublings."""
    _, _, _, plan = _plans()
    monkeypatch.setattr(eng, "_PART_MAX_ATTEMPTS", 1)
    with pytest.raises(RuntimeError, match="kept overflowing after 1 capacity doublings"):
        eng.run_partitioned(plan, EngineConfig(n_workers=2, expand_width=2, stack_cap=2,
                                               n_partitions=3), device=CPU)


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_ref_enumerate_partitioned_matches_repro(n_parts):
    """The port's partitioned oracle equals repro's on results, sorted
    mappings and scheduling statistics, and the monolithic oracle's
    results."""
    tgt, pat, jplan, plan = _plans()
    got = ref.ref_enumerate_partitioned(to_port(pat), to_port(tgt), n_parts, plan=plan,
                                        record_mappings=True)
    want = jax_ref.ref_enumerate_partitioned(pat, tgt, n_parts, plan=jplan,
                                             record_mappings=True)
    for f in ("matches", "states", "mappings", "n_parts", "visits", "spilled", "dead_spills"):
        assert getattr(got, f) == getattr(want, f), f
    mono = ref.ref_enumerate(to_port(pat), to_port(tgt), plan=plan, record_mappings=True)
    assert (got.matches, got.states) == (mono.matches, mono.states)
    assert got.mappings == sorted(mono.mappings)


def test_partitioned_backend_needs_its_driver():
    """Plan arrays and step backends refuse the mismatched layouts, as
    repro's do; run() routes "partitioned" to run_partitioned."""
    _, _, jplan, plan = _plans()
    cfg = EngineConfig(step_backend="partitioned", **KW)
    with pytest.raises(ValueError, match="per-partition arrays"):
        extend.plan_arrays_for(cfg, [plan], CPU)
    with pytest.raises(ValueError, match="per-partition arrays"):
        jax_extend.plan_arrays_for(JaxConfig(step_backend="partitioned"), jplan)
    csr = extend.plan_arrays_for(EngineConfig(step_backend="csr"), [plan], CPU)
    with pytest.raises(ValueError, match="needs PartPlanArrays"):
        extend.make_step_backend(cfg, csr)
    part = extend.make_part_plan_arrays(plan, extend.plan_partitions(plan, 2), 0, CPU)
    with pytest.raises(ValueError, match="cannot run PartPlanArrays"):
        extend.make_step_backend(EngineConfig(step_backend="csr"), part)
    assert extend.make_step_backend(cfg, part).name == "partitioned"
    got = eng.run(plan, EngineConfig(step_backend="partitioned", n_partitions=2, **KW),
                  device=CPU)
    want = eng.run_partitioned(plan, EngineConfig(n_partitions=2, **KW), device=CPU)
    assert_engine_results_equal(got, want)


def test_run_partitioned_defaults_to_the_card():
    _, _, _, plan = _plans()
    cfg = EngineConfig(step_backend="partitioned", **KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            eng.run_partitioned(plan, cfg)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _sessions(sparse: bool, **kw):
    """repro's session and the port's over the seed-0 case's target."""
    tgt, pat, _ = _case()
    jenum = JaxEnumerator(JaxIndex.build(tgt, sparse=sparse), **KW, **kw)
    enum = Enumerator(SubgraphIndex.build(to_port(tgt), sparse=sparse), device=CPU, **KW, **kw)
    return jenum, enum, pat


def test_session_memory_budget_derives_repro_count():
    """memory_budget_bytes forces the partitioned backend and derives repro's
    partition count; the run equals repro's; a budget <= 0 raises repro's
    ValueError."""
    _, _, jplan, _ = _plans()
    budget = _resident_bytes(jplan, 4)
    jenum, enum, pat = _sessions(True, memory_budget_bytes=budget)
    assert enum.config.step_backend == jenum.config.step_backend == "partitioned"
    jq, q = jenum.prepare(pat), enum.prepare(to_port(pat))
    n_parts = enum._partition_count(enum.config, q.plan)
    assert n_parts == jenum._partition_count(jenum.config, jq.plan) > 1
    assert extend.part_resident_nbytes(extend.plan_partitions(q.plan, n_parts)) <= budget
    assert enum.coalesce_key(q) == jenum.coalesce_key(jq)
    assert_engine_results_equal(enum.run(q), jenum.run(jq))
    tgt, _, _ = _case()
    for budget in (0, -5):
        msgs = []
        for cls, idx in ((Enumerator, SubgraphIndex.build(to_port(tgt))),
                         (JaxEnumerator, JaxIndex.build(tgt))):
            kw = dict(device=CPU) if cls is Enumerator else {}
            with pytest.raises(ValueError) as e:
                cls(idx, memory_budget_bytes=budget, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_session_partitioned_matches_repro(sparse):
    """step_backend="partitioned", n_partitions=2 on a dense and on a
    sparse index: repro's counters, per worker, and the csr session's."""
    jenum, enum, pat = _sessions(sparse, step_backend="partitioned", n_partitions=2)
    jq, q = jenum.prepare(pat), enum.prepare(to_port(pat))
    got = enum.run(q)
    assert_engine_results_equal(got, jenum.run(jq))
    assert enum.coalesce_key(q) == jenum.coalesce_key(jq)
    mono = Enumerator(enum.index, device=CPU, step_backend="csr", **KW)
    want = mono.run(mono.prepare(to_port(pat)))
    assert (got.matches, got.states) == (want.matches, want.states)


def test_session_collect_matches_sorted_mappings():
    """Collected and lazily materialised mappings equal the oracle's and
    the monolithic csr session's, sorted."""
    tgt, pat, jplan, _ = _plans()
    enum = Enumerator(SubgraphIndex.build(to_port(tgt), sparse=True), device=CPU,
                      memory_budget_bytes=_resident_bytes(jplan, 4), **KW)
    q = enum.prepare(to_port(pat))
    assert enum._partition_count(enum.config, q.plan) > 2
    want = sorted(ref.ref_enumerate(to_port(pat), to_port(tgt), plan=q.plan,
                                    record_mappings=True).mappings)
    collected = enum.run(q, collect_matches=64)
    assert collected.engine.match_buf.shape[0] == 1
    assert sorted(collected.mappings()) == want
    assert sorted(enum.run(q).mappings()) == want
    mono = Enumerator(enum.index, device=CPU, step_backend="csr", **KW)
    assert sorted(mono.run(mono.prepare(to_port(pat))).mappings()) == want


def test_session_packs_and_streams_run_singly():
    """run_pack, stream and run_batch of a partitioned session give each
    query its single run's counters, in input order."""
    tgt, _, _ = _case()
    pats = [_case(pattern_seed=seed)[1] for seed in (None, 7, 1)]
    enum = Enumerator(SubgraphIndex.build(to_port(tgt), sparse=True), device=CPU,
                      step_backend="partitioned", n_partitions=3, **KW)
    qs = [enum.prepare(to_port(p)) for p in pats]
    singles = [enum.run(q) for q in qs]
    packed = enum.run_pack([qs[1], qs[2]], pack_size=2)
    assert [ms.query_index for ms in packed] == [0, 1]
    streamed = list(enum.stream(qs, pack_size=2))
    assert [ms.query_index for ms in streamed] == [0, 1, 2]
    batch = enum.run_batch(qs, pack_size=4)
    for got, want in zip(packed + streamed + batch, singles[1:] + singles + singles):
        assert_engine_results_equal(got, want)
    # a collect_matches budget threaded through run_pack's cfg
    cfg = dataclasses.replace(enum.config, collect_matches=64)
    (ms,) = enum.run_pack([qs[1]], cfg=cfg)
    assert ms.engine.match_buf is not None
    assert sorted(ms.mappings()) == sorted(singles[1].mappings())


def test_cpu_partitioned_run_launches_no_kernel():
    _, _, _, plan = _plans()
    ops.reset_launch_counts()
    for use_pallas, walk in WALKS:
        eng.run_partitioned(plan, EngineConfig(n_partitions=2, use_pallas=use_pallas,
                                               csr_walk=walk, **KW), device=CPU)
    tgt, pat, _ = _case()
    res = enumerate_subgraphs(to_port(pat), to_port(tgt), device=CPU, step_backend="partitioned",
                              n_partitions=2, use_pallas=True, **KW)
    assert res.matches > 0
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
