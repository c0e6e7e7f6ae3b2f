"""Edge-centric root seeding of the port against the JAX package's, on the
CPU.

* seed selection: ``edge_class_stats`` / ``select_seed_edge`` over the
  planes of dense and sparse targets, a label the target lacks, an
  all-self-loop pattern;
* plans: ``build_plan`` / ``build_csr_plan`` with ``seed_edge="auto"`` and
  an explicit triple, every variant: order, parent tables, domains and the
  seed edge; the errors for a self-loop, a non-edge and ``anchor=`` with
  ``seed_edge=``;
* seeds: ``host_cand_bitmap``, ``root_seed_entries`` and ``init_state``
  under ``"edge"`` / ``"auto"``, seeded and on the capacity fallback;
* engine: per-worker counters under ``"edge"`` and ``"auto"`` on every path
  of the port (dense ``jnp``, ``jnp`` + ``use_pallas``, ``pallas``, ``csr``
  on a dense and on a sparse index), all five variants, against
  ``repro``'s ``jnp`` run; node-indexed match sets equal the
  vertex-seeded run's;
* sessions: packs of edge-seeded queries lane for lane against their single
  runs and ``repro``'s, the doubled-``stack_cap`` retry, and the root
  frontier of a ``power_law_graph`` target.

Counters and bitmaps are integers: exact equality (uint32 words compared
through ``.view(np.uint32)``).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import Enumerator as JaxEnumerator  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core import extend as jax_extend  # noqa: E402
from repro.core import frontier as jax_frontier  # noqa: E402
from repro.core import ordering as jax_ordering  # noqa: E402
from repro.core.graph import Graph as JaxGraph  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.graph import csr_planes_from_bitmaps as jax_planes_from_bitmaps  # noqa: E402
from repro.core.graph import popcount as jax_popcount  # noqa: E402
from repro.core.plan import build_csr_plan as jax_build_csr_plan  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import extend, frontier, ordering  # noqa: E402
from repro_torch.core.frontier import EngineState, init_state  # noqa: E402
from repro_torch.core.graph import PackedGraph, csr_planes_from_bitmaps, popcount  # noqa: E402
from repro_torch.core.plan import VARIANTS, build_csr_plan, build_plan  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from tests.conftest import bump_edge_label, extract_connected_pattern  # noqa: E402
from tests.test_backend_conformance import CASES, HUB_CASES  # noqa: E402
from tests.test_torch_engine import assert_engine_results_equal  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

CPU = "cpu"
KW = dict(n_workers=4, expand_width=2)
# every engine path of the port: (label, step_backend, use_pallas, sparse index)
PORT_PATHS = [
    ("jnp", "jnp", False, False),
    ("jnp+use_pallas", "jnp", True, False),
    ("pallas", "pallas", False, False),
    ("csr dense index", "csr", False, False),
    ("csr sparse index", "csr", False, True),
]
# the plan fields edge seeding decides
SEED_PLAN_FIELDS = ("order", "parent_pos", "parent_dir", "parent_elab", "n_parents",
                    "dom_bits", "seed_edge", "satisfiable")
# bench_hubheavy's CI-sized target (its SMOKE_NT) and its pattern recipe
SMOKE_NT = 4000


def _planes_pair(tgt):
    """(port planes, repro planes) of a target: from the graph (a sparse
    index's) and from the packed bitmaps (a dense index's)."""
    g = to_port(tgt)
    return [(g.csr_planes(g.n_edge_labels), tgt.csr_planes(tgt.n_edge_labels)),
            (csr_planes_from_bitmaps(PackedGraph.from_graph(g).adj_bits),
             jax_planes_from_bitmaps(JaxPacked.from_graph(tgt).adj_bits))]


def _assert_seed_plans_equal(got, want, what=""):
    for f in SEED_PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f"{f} {what}")


def _explicit_edge(pat, avoid):
    """A non-self-loop pattern edge other than ``avoid`` (the last one)."""
    edges = [(int(u), int(v), int(l)) for u, v, l in
             zip(pat.src, pat.dst, pat.edge_labels) if u != v]
    others = [e for e in edges if e != tuple(avoid)]
    return (others or edges)[-1]


def _assert_states_equal(got: EngineState, want, what=""):
    for name, a, b in zip(EngineState._fields, got, want):
        b = np.asarray(b)
        a = a[0].numpy()  # the port's state is a pack of one query
        a = a.view(b.dtype) if b.dtype == np.uint32 else a
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {what}")


def _node_mappings(match_buf, plan, n_p):
    """Sorted pattern-node-indexed match sets (column i holds position i,
    i.e. pattern node ``plan.order[i]``)."""
    buf = np.asarray(match_buf)
    rows = buf.reshape(-1, buf.shape[-1])[:, :n_p]
    rows = rows[(rows >= 0).all(axis=1)]
    out = np.empty_like(rows)
    out[:, np.asarray(plan.order[:n_p])] = rows
    return sorted(map(tuple, out.tolist()))


# ---------------------------------------------------------------------------
# seed selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_seed_selection_matches_repro(rng, case):
    tgt, pat = CASES[case](rng)
    for mine, theirs in _planes_pair(tgt):
        np.testing.assert_array_equal(ordering.edge_class_stats(mine),
                                      jax_ordering.edge_class_stats(theirs))
        want = jax_ordering.select_seed_edge(pat, theirs)
        assert want is not None
        assert ordering.select_seed_edge(to_port(pat), mine) == want


def test_seed_selection_edge_cases(rng):
    """A pattern edge whose label the target lacks counts 0 arcs and wins;
    an all-self-loop or edgeless pattern has no seed edge."""
    tgt, pat = CASES["edge_labels"](rng)
    lacking = bump_edge_label(pat, int(pat.m) - 1, 9)
    loops = JaxGraph.from_edges(2, [(0, 0), (1, 1)], undirected=True)
    edgeless = JaxGraph.from_edges(3, [])
    for mine, theirs in _planes_pair(tgt):
        want = jax_ordering.select_seed_edge(lacking, theirs)
        assert want[2] == 9
        assert ordering.select_seed_edge(to_port(lacking), mine) == want
        for p in (loops, edgeless):
            assert jax_ordering.select_seed_edge(p, theirs) is None
            assert ordering.select_seed_edge(to_port(p), mine) is None


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", ["edge_labels", "hub_power_law"])
def test_seed_plans_match_repro(rng, case, variant):
    """Dense and CSR-only plans with ``seed_edge="auto"`` and with an
    explicit triple: the seed edge's endpoints hold positions 0/1, and every
    array equals repro's."""
    tgt, pat = CASES[case](rng)
    g, p = to_port(tgt), to_port(pat)
    pk, jpk = PackedGraph.from_graph(g), JaxPacked.from_graph(tgt)
    auto = jax_build_plan(pat, jpk, variant=variant, seed_edge="auto")
    for seed in ("auto", _explicit_edge(pat, auto.seed_edge)):
        want = jax_build_plan(pat, jpk, variant=variant, seed_edge=seed)
        assert list(want.order[:2]) == list(want.seed_edge[:2])
        _assert_seed_plans_equal(build_plan(p, pk, variant=variant, seed_edge=seed), want,
                                 f"dense {seed}")
        got = build_csr_plan(p, g, variant=variant, seed_edge=seed, device=CPU)
        assert extend.is_csr_only(got)
        _assert_seed_plans_equal(got, want, f"csr {seed}")
        if variant == "ri":  # repro's CSR fixpoint for ri-ds* compiles per variant
            _assert_seed_plans_equal(got, jax_build_csr_plan(pat, tgt, variant=variant,
                                                             seed_edge=seed), f"csr {seed}")


def test_seed_plan_errors_match_repro(rng):
    tgt, pat = CASES["dense"](rng)
    edge = (int(pat.src[0]), int(pat.dst[0]), int(pat.edge_labels[0]))
    builds = ((lambda **kw: build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)), **kw)),
              (lambda **kw: jax_build_plan(pat, JaxPacked.from_graph(tgt), **kw)))
    for build in builds:
        with pytest.raises(ValueError, match="self-loop"):
            build(seed_edge=(edge[0], edge[0], edge[2]))
        with pytest.raises(ValueError, match="not a pattern edge"):
            build(seed_edge=(edge[0], edge[1], edge[2] + 3))
        with pytest.raises(ValueError, match="mutually exclusive"):
            build(seed_edge="auto", anchor=edge[:2])
        assert build(seed_edge=None).seed_edge is None


# ---------------------------------------------------------------------------
# seeds and initial states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["edge_labels", "sparse_power_law"])
def test_host_cand_bitmap_matches_repro(rng, case):
    """For every position of a dense and a CSR-only seed plan, under
    mappings of random target nodes (some with -1 gaps), the host candidate
    bitmap equals repro's, and on the dense plan without gaps the engine's
    own formula (`repro_torch.core.extend.compute_cand`)."""
    tgt, pat = CASES[case](rng)
    jpk = JaxPacked.from_graph(tgt)
    plans = [(build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)), seed_edge="auto"),
              jax_build_plan(pat, jpk, seed_edge="auto")),
             (build_csr_plan(to_port(pat), to_port(tgt), seed_edge="auto", device=CPU),
              jax_build_csr_plan(pat, tgt, seed_edge="auto"))]
    arrays = extend.make_plan_arrays(plans[0][0], CPU)
    for mine, theirs in plans:
        for pos in range(mine.n_p):
            for trial in range(6):
                m = np.full(mine.p_pad, -1, dtype=np.int32)
                m[:pos] = rng.integers(0, mine.n_t, size=pos)
                if trial % 2:
                    m[:pos][rng.random(pos) < 0.3] = -1
                got = extend.host_cand_bitmap(mine, pos, m)
                np.testing.assert_array_equal(got, jax_extend.host_cand_bitmap(theirs, pos, m))
                if mine is plans[0][0] and (m[:pos] >= 0).all():
                    used = frontier.used_from_map(torch.from_numpy(m)[None], torch.tensor([pos]),
                                                  mine.w)
                    eng_cand = extend.compute_cand(arrays, torch.tensor([pos]),
                                                   torch.from_numpy(m)[None], used)
                    np.testing.assert_array_equal(eng_cand[0].numpy().view(np.uint32), got)


@pytest.mark.parametrize("store_used", [True, False])
@pytest.mark.parametrize("case", HUB_CASES + ("dense",))
def test_seeds_and_init_state_match_repro(rng, case, store_used):
    """``root_seed_entries`` and the ``"edge"`` / ``"auto"`` initial states
    (depth-1 seeds dealt round-robin, used-bitmaps of the mapped prefix)
    equal repro's; ``"auto"`` on a plan without a seed edge is the vertex
    split."""
    tgt, pat = CASES[case](rng)
    jpk = JaxPacked.from_graph(tgt)
    jplan = jax_build_plan(pat, jpk, seed_edge="auto")
    plan = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)), seed_edge="auto")
    sd, sm, sc = frontier.root_seed_entries(plan)
    wd, wm, wc = jax_frontier.root_seed_entries(jplan)
    assert wd.shape[0] > 0
    for a, b in ((sd, wd), (sm, wm), (sc, wc)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (np.diff(sm[:, 0]) > 0).all()  # sorted by source node
    kw = dict(n_workers=3, expand_width=2, store_used=store_used)
    for seeding in ("edge", "auto"):
        st = init_state(plan, EngineConfig(root_seeding=seeding, **kw), CPU)
        _assert_states_equal(st, jax_eng.init_state(jplan, JaxConfig(root_seeding=seeding, **kw)),
                             seeding)
        live = torch.arange(st.st_depth.shape[-1])[None, :] < st.size[0][:, None]
        assert set(st.st_depth[0][live].tolist()) == {1}  # depth-1 seeds only
    vplan = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)))
    _assert_states_equal(init_state(vplan, EngineConfig(root_seeding="auto", **kw), CPU),
                         jax_eng.init_state(jax_build_plan(pat, jpk),
                                            JaxConfig(root_seeding="auto", **kw)), "vertex")


def test_edge_seeding_needs_a_seed_edge(rng):
    tgt, pat = CASES["dense"](rng)
    plan = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)))
    with pytest.raises(ValueError, match="repro_torch.core.plan.build_plan"):
        init_state(plan, EngineConfig(root_seeding="edge"), CPU)
    with pytest.raises(ValueError, match="seed_edge"):
        jax_eng.init_state(jax_build_plan(pat, JaxPacked.from_graph(tgt)),
                           JaxConfig(root_seeding="edge"))


def test_capacity_fallback_matches_repro(rng):
    """repro's fallback setting (one worker, a 9-arc explicit seed class,
    ``stack_cap=9``): the state is the depth-0 split masked to the seed
    sources, as repro's, and the run's counters equal repro's."""
    tgt, pat = CASES["hub_power_law"](rng)
    jplan = jax_build_plan(pat, JaxPacked.from_graph(tgt), seed_edge=(3, 2, 0))
    plan = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)), seed_edge=(3, 2, 0))
    kw = dict(n_workers=1, expand_width=2, root_seeding="edge", stack_cap=9)
    sd, sm, _ = frontier.root_seed_entries(plan)
    assert sd.shape[0] > 8  # more seeds than the one stack holds
    st = init_state(plan, EngineConfig(step_backend="csr", **kw), CPU)
    _assert_states_equal(st, jax_eng.init_state(jplan, JaxConfig(step_backend="csr", **kw)))
    assert int(st.size.sum()) == 1 and int(st.st_depth[0, 0, 0]) == 0
    root = st.st_cand[0, 0, 0].numpy().view(np.uint32)
    assert set(np.nonzero(np.unpackbits(root.view(np.uint8), bitorder="little"))[0]) <= set(
        sm[:, 0].tolist())
    want = jax_eng.run(jplan, JaxConfig(step_backend="jnp", **kw))
    assert not want.overflow
    for backend in ("jnp", "pallas", "csr"):
        got = eng.run(plan, EngineConfig(step_backend=backend, **kw), device=CPU)
        assert_engine_results_equal(got, want)


def test_init_delta_state_refuses_overfull_stacks(rng):
    tgt, pat = CASES["hub_power_law"](rng)
    plan = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)), seed_edge="auto")
    sd, sm, sc = frontier.root_seed_entries(plan)
    cfg = EngineConfig(n_workers=1, stack_cap=int(sd.shape[0]))
    with pytest.raises(ValueError, match="exceed stack_cap"):
        frontier.init_delta_state(plan, cfg, sd, sm, sc, CPU)
    st = frontier.init_delta_state(plan, EngineConfig(n_workers=2, stack_cap=sd.shape[0]),
                                   sd, sm, sc, CPU)
    assert st.size[0].tolist() == [(sd.shape[0] + 1) // 2, sd.shape[0] // 2]


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

def _port_sessions(tgt, variant, **kw):
    dense = SubgraphIndex.build(to_port(tgt))
    sparse = SubgraphIndex.build(to_port(tgt), sparse=True)
    return {label: Enumerator(sparse if sp else dense, variant=variant, device=CPU,
                              step_backend=backend, use_pallas=use_pallas, **kw)
            for label, backend, use_pallas, sp in PORT_PATHS}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", HUB_CASES)
def test_edge_seeded_counters_match_repro(rng, case, variant):
    """Every port path under ``"edge"`` and ``"auto"`` gives repro's ``jnp``
    edge-seeded counters, per worker; the node-indexed match sets equal the
    vertex-seeded run's."""
    tgt, pat = CASES[case](rng)
    jplan = JaxEnumerator(JaxIndex.build(tgt), variant=variant).prepare(pat, seed_edge="auto").plan
    want = jax_eng.run(jplan, JaxConfig(step_backend="jnp", root_seeding="edge",
                                        collect_matches=512, **KW))
    venum = Enumerator(SubgraphIndex.build(to_port(tgt)), variant=variant, device=CPU, **KW)
    vq = venum.prepare(to_port(pat))
    vertex = _node_mappings(venum.run(vq, collect_matches=512).engine.match_buf, vq.plan, pat.n)
    assert len(vertex) == want.matches  # nothing dropped
    for seeding in ("edge", "auto"):
        for label, enum in _port_sessions(tgt, variant, root_seeding=seeding, **KW).items():
            q = enum.prepare(to_port(pat), seed_edge="auto")
            _assert_seed_plans_equal(q.plan, jplan, label)
            ms = enum.run(q, collect_matches=512)
            assert_engine_results_equal(ms, want)
            assert _node_mappings(ms.engine.match_buf, q.plan, pat.n) == vertex, label


@pytest.mark.parametrize("sparse,backend,use_pallas", [
    (False, "jnp", False), (False, "pallas", False), (True, "csr", True)])
def test_edge_seeded_packs_equal_single_runs(rng, sparse, backend, use_pallas):
    """``run_batch`` / ``stream`` packs of edge-seeded queries of 3 to 6
    nodes (shorter lanes' depths shifted in the step): each lane equals its
    query's single run, and each single run equals repro's."""
    tgt, _ = CASES["dense"](rng)
    pats = [extract_connected_pattern(rng, tgt, n) for n in (3, 4, 5, 6, 4)]
    kw = dict(KW, root_seeding="edge")
    enum = Enumerator(SubgraphIndex.build(to_port(tgt), sparse=sparse), device=CPU,
                      step_backend=backend, use_pallas=use_pallas, **kw)
    jenum = JaxEnumerator(JaxIndex.build(tgt), step_backend="jnp", **kw)
    qs = [enum.prepare(to_port(p), name=f"p{i}", seed_edge="auto") for i, p in enumerate(pats)]
    assert len({q.plan.n_p for q in qs}) > 2 and all(q.plan.seed_edge for q in qs)
    singles = [enum.run(q) for q in qs]
    for p, one in zip(pats, singles):
        assert_engine_results_equal(one, jenum.run(jenum.prepare(p, seed_edge="auto")))
    for results in (enum.run_batch(qs, pack_size=4), list(enum.stream(qs, pack_size=3))):
        by_index = {ms.query_index: ms for ms in results}
        for i, one in enumerate(singles):
            assert_engine_results_equal(by_index[i], one)
    assert [ms.matches for ms in enum.run_pack(qs[:4], pack_size=4)] == [
        ms.matches for ms in singles[:4]]


@pytest.mark.parametrize("n_workers,stack_cap", [(1, 5), (1, 8), (2, 6)])
def test_edge_seeded_overflow_retry_matches_repro(rng, n_workers, stack_cap):
    """An overflowing edge-seeded query warns and retries once with a
    doubled ``stack_cap``, which can turn the capacity fallback into seeds
    (``(1, 8)``), keep the fallback (``(1, 5)``) or keep the seeds
    (``(2, 6)``); the retried counters equal repro's."""
    tgt, pat = CASES["dense"](rng)
    kw = dict(n_workers=n_workers, expand_width=2, stack_cap=stack_cap, root_seeding="edge")
    jenum = JaxEnumerator(JaxIndex.build(tgt), **kw)
    with pytest.warns(RuntimeWarning, match="overflowed"):
        want = jenum.run(jenum.prepare(pat, seed_edge="auto"))
    assert want.retries == 1
    index = SubgraphIndex.build(to_port(tgt))
    for backend, use_pallas in (("jnp", False), ("pallas", False), ("csr", True)):
        enum = Enumerator(index, device=CPU, step_backend=backend, use_pallas=use_pallas, **kw)
        q = enum.prepare(to_port(pat), seed_edge="auto")
        with pytest.warns(RuntimeWarning, match="overflowed"):
            got = enum.run(q)
        assert got.retries == 1 and not got.engine.overflow
        assert_engine_results_equal(got, want)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            (packed,) = enum.run_pack([q])
        assert packed.retries == 1
        assert_engine_results_equal(packed, want)


def test_root_frontier_on_power_law_matches_repro():
    """bench_hubheavy's CI-sized target and pattern: the vertex root
    frontier (``|dom[0]|``) and the edge root frontier (seed entries) equal
    repro's, and edge seeding shrinks it."""
    jtgt = jax_graphgen.power_law_graph(SMOKE_NT, avg_deg=4.0, alpha=1.5, n_labels=32, seed=7)
    tgt = graphgen.power_law_graph(SMOKE_NT, avg_deg=4.0, alpha=1.5, n_labels=32, seed=7)
    np.testing.assert_array_equal(tgt.src, jtgt.src)
    deg = jtgt.out_degrees() + jtgt.in_degrees()
    start = int(np.argsort(deg)[-80])
    jpat = jax_graphgen.extract_pattern(jtgt, 6, seed=7, start=start)
    pat = graphgen.extract_pattern(tgt, 6, seed=7, start=start)
    np.testing.assert_array_equal(pat.src, jpat.src)
    vplan = build_csr_plan(pat, tgt, variant="ri", device=CPU)
    eplan = build_csr_plan(pat, tgt, variant="ri", seed_edge="auto", device=CPU)
    jv = jax_build_csr_plan(jpat, jtgt, variant="ri")
    je = jax_build_csr_plan(jpat, jtgt, variant="ri", seed_edge="auto")
    assert eplan.seed_edge == je.seed_edge
    vertex = int(popcount(vplan.dom_bits[0]).sum())
    edge = int(frontier.root_seed_entries(eplan)[0].shape[0])
    assert vertex == int(jax_popcount(jv.dom_bits[0]).sum())
    assert edge == int(jax_frontier.root_seed_entries(je)[0].shape[0])
    assert 0 < edge < vertex
