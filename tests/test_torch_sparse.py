"""The port's sparse (CSR) path against the JAX package's, on the CPU.

* domains: ``compute_domains_sparse`` / ``compute_domains_csr`` and the
  batched fixpoint over :class:`CsrTargetDomainArrays` equal ``repro``'s
  and the dense numpy oracle, bit for bit with the same satisfiable flag,
  over every pipeline, the fixed-seed corpus (self-loops, two edge labels,
  labels the target lacks) and the domain-rule cases;
* engine: CSR-only plans of all five variants on the sparse power-law case
  of ``tests/test_backend_conformance.py`` give ``repro``'s ``matches``,
  ``states``, ``steps``, ``steals``, ``steal_rounds`` and per-worker
  counters on both walks, with and without the kernels' entry points, and
  the dense run's sorted mappings; the ``EngineState`` after each round
  equals ``repro``'s, rings read from their base (``repro`` compacts them
  to base 0 after a CSR round, the port does not); a pack's final
  state equals ``repro``'s vmapped pack lane for lane; the bucketed walk
  equals the flat one on a hub-heavy target; ``"auto"`` resolves as in
  ``repro``;
* sessions: a sparse ``SubgraphIndex`` through ``prepare``,
  ``prepare_batch`` (device and numpy) and ``stream`` packs, every lane
  equal to its single run and to ``repro``; the fail-fast errors of a
  dense backend on a CSR-only plan.

Counters and bitmaps are integers: exact equality.
"""

import jax
import numpy as np
import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import Enumerator as JaxEnumerator  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.core import domains as jax_dom  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core import extend as jax_extend  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.plan import build_csr_plan as jax_build_csr_plan  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex, enumerate_subgraphs  # noqa: E402
from repro_torch.core import domains as dom  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import extend, multi  # noqa: E402
from repro_torch.core.frontier import EngineState, init_state  # noqa: E402
from repro_torch.core.graph import PackedGraph, n_words  # noqa: E402
from repro_torch.core.plan import (  # noqa: E402
    PLAN_ARRAY_FIELDS,
    VARIANTS,
    build_csr_plan,
    build_plan,
    plan_from_numpy,
    variant_flags,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from tests.conftest import extract_connected_pattern  # noqa: E402
from tests.test_backend_conformance import CASES, _hub_power_law, _sparse_power_law  # noqa: E402
from tests.test_core_domains import PIPELINES  # noqa: E402
from tests.test_torch_domains import _assert_same, _corpus  # noqa: E402
from tests.test_torch_engine import assert_engine_results_equal  # noqa: E402
from tests.test_torch_plan import _bugfix_cases, to_port  # noqa: E402

CPU = "cpu"
KW = dict(n_workers=4, expand_width=2)
# the port's CSR step paths: (use_pallas, csr_walk); on the CPU use_pallas
# runs the kernels' entry points, which take their plain versions
CSR_PATHS = [(False, "bucketed"), (False, "flat"), (True, "bucketed"), (True, "flat")]


def _port_plan(jplan):
    """repro's plan as the port's, CSR planes included."""
    d = {f: getattr(jplan, f) for f in PLAN_ARRAY_FIELDS}
    d["csr"] = jplan.csr
    return plan_from_numpy(d)


def _sorted_mappings(buf, n_p):
    rows = np.asarray(buf).reshape(-1, np.asarray(buf).shape[-1])[:, :n_p]
    return sorted(tuple(int(x) for x in r) for r in rows if (r >= 0).all())


def _assert_plans_equal(got, want, msg=""):
    for f in PLAN_ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f"{msg} {f}")


# ---------------------------------------------------------------------------
# domains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_domains_match_repro_and_oracle(use_pallas):
    """compute_domains_sparse over every pipeline equals repro's (whose
    AC/FC pipelines run its CSR fixpoint) and the dense numpy oracle."""
    for k, (tgt, pat) in enumerate(_corpus()):
        g, p = to_port(tgt), to_port(pat)
        w = n_words(g.n)
        packed = PackedGraph.from_graph(g)
        for use_ac, use_fc, interleave in PIPELINES:
            flags = dict(use_ac=use_ac, use_fc=use_fc, interleave=interleave)
            want = jax_dom.compute_domains_sparse(pat, tgt, w, **flags)
            _assert_same(want, dom.compute_domains(p, packed, **flags), f"case {k} {flags} oracle")
            got = dom.compute_domains_sparse(p, g, w, use_pallas=use_pallas, device=CPU, **flags)
            _assert_same(got, want, f"case {k} {flags}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_sparse_rule_cases_every_variant(variant):
    """Self-loops, a self-loop label, a loop-only pattern, edge and loop
    labels the target lacks and an AC-unsatisfiable star: the CSR fixpoint,
    single and batched, equals repro's and the dense oracle."""
    f = variant_flags(variant)
    flags = dict(use_ac=f["use_ac"], use_fc=f["use_fc"], interleave=f["interleave"])
    for name, (tgt, pat) in _bugfix_cases().items():
        g, p = to_port(tgt), to_port(pat)
        w = n_words(g.n)
        want = jax_dom.compute_domains_sparse(pat, tgt, w, **flags)
        _assert_same(dom.compute_domains(p, PackedGraph.from_graph(g), **flags), want, name)
        _assert_same(dom.compute_domains_sparse(p, g, w, device=CPU, **flags), want, name)
        arrays = dom.csr_target_domain_arrays(g, w, device=CPU)
        for use_pallas in (False, True):
            got = dom.compute_domains_csr(p, g, w, use_pallas=use_pallas, tgt_arrays=arrays,
                                          **dict(flags, use_ac=True))
            _assert_same(got, jax_dom.compute_domains_csr(pat, tgt, w, **dict(flags, use_ac=True)),
                         f"{name} csr use_pallas={use_pallas}")
            (batched,) = dom.compute_domains_batch([p], PackedGraph.from_graph(g),
                                                   use_pallas=use_pallas, tgt_arrays=arrays,
                                                   **flags)
            _assert_same(batched, want, f"{name} batched use_pallas={use_pallas}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_batch_matches_repro(rng, use_pallas):
    """One batched CSR fixpoint over patterns of different sizes and an
    unsatisfiable lane, padded to 8 lanes, equals repro's batch over its
    CSR arrays and the per-query oracle."""
    tgt, _ = _sparse_power_law(rng)
    pats = [extract_connected_pattern(rng, tgt, n) for n in (2, 3, 4, 5, 6)]
    pats = [p for p in pats if p.m]
    g = to_port(tgt)
    w = n_words(g.n)
    jarrays = jax_dom.csr_target_domain_arrays(tgt, w)
    arrays = dom.csr_target_domain_arrays(g, w, device=CPU)
    packed = PackedGraph.from_graph(g)
    for use_ac, use_fc, interleave in PIPELINES[1:]:
        flags = dict(use_ac=use_ac, use_fc=use_fc, interleave=interleave)
        want = jax_dom.compute_domains_batch(pats, None, batch_pad=8, tgt_arrays=jarrays,
                                             **flags)
        got = dom.compute_domains_batch([to_port(p) for p in pats], None, batch_pad=8,
                                        use_pallas=use_pallas, tgt_arrays=arrays, **flags)
        for i, (a, b, p) in enumerate(zip(got, want, pats)):
            _assert_same(a, b, f"lane {i} {flags}")
            _assert_same(a, dom.compute_domains(to_port(p), packed, **flags), f"lane {i} oracle")


def test_csr_target_arrays_and_pallas_sweep_match_repro(rng):
    """The CSR target arrays equal repro's; repro's fixpoint through its
    Pallas sweep kernel (interpret mode) gives the port's bits."""
    tgt, pat = _sparse_power_law(rng)
    g = to_port(tgt)
    w = n_words(g.n)
    want = jax_dom.csr_target_domain_arrays(tgt, w)
    got = dom.csr_target_domain_arrays(g, w, device=CPU)
    for name in ("seg_start", "seg_len", "indices", "labels", "deg_out", "deg_in"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(got.loop_bits.numpy().view(np.uint32),
                                  np.asarray(want.loop_bits))
    assert got.deg_cap == want.seg_iota.shape[0]
    flags = dict(use_ac=True, use_fc=True, interleave=True)
    jres = jax_dom.compute_domains_csr(pat, tgt, w, use_pallas=True, tgt_arrays=want, **flags)
    for use_pallas in (False, True):
        _assert_same(dom.compute_domains_csr(to_port(pat), g, w, use_pallas=use_pallas,
                                             tgt_arrays=got, **flags), jres)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_csr_only_variant_matrix(rng, variant):
    """build_csr_plan under every variant gives repro's plan (domains equal
    the dense plan's); every CSR step path reproduces repro's csr run
    counter for counter, and the dense jnp run's sorted mappings."""
    tgt, pat = _sparse_power_law(rng)
    g, p = to_port(tgt), to_port(pat)
    jdense = jax_build_plan(pat, JaxPacked.from_graph(tgt), variant=variant)
    jplan = jax_build_csr_plan(pat, tgt, variant=variant)
    plan = build_csr_plan(p, g, variant=variant, device=CPU)
    assert plan.adj_bits.shape[2] == 0 and extend.is_csr_only(plan)
    _assert_plans_equal(plan, jplan, variant)
    np.testing.assert_array_equal(plan.dom_bits, jdense.dom_bits)
    want = jax_eng.run(jplan, JaxConfig(step_backend="csr", collect_matches=512, **KW))
    ref_maps = _sorted_mappings(jax_eng.run(
        jdense, JaxConfig(step_backend="jnp", collect_matches=512, **KW)).match_buf, pat.n)
    assert len(ref_maps) == want.matches
    for use_pallas, walk in CSR_PATHS:
        cfg = EngineConfig(step_backend="csr", use_pallas=use_pallas, csr_walk=walk,
                           collect_matches=512, **KW)
        got = eng.run(plan, cfg, device=CPU)
        assert_engine_results_equal(got, want)
        assert _sorted_mappings(got.match_buf, pat.n) == ref_maps


@pytest.mark.parametrize("case", sorted(CASES))
def test_csr_backend_on_dense_plans_matches_repro(rng, case):
    """The csr backend on dense-built plans (planes derived from the
    bitmaps), end to end over the conformance corpus, equals repro's."""
    tgt, pat = CASES[case](rng)
    kw = dict(step_backend="csr", **KW)
    want = jax_eng.run(jax_build_plan(pat, JaxPacked.from_graph(tgt)), JaxConfig(**kw))
    for use_pallas, walk in CSR_PATHS[::3]:
        got = enumerate_subgraphs(p := to_port(pat), to_port(tgt), device=CPU,
                                  use_pallas=use_pallas, csr_walk=walk, **kw)
        assert got.plan.n_p == p.n
        assert_engine_results_equal(got.engine, want)


RINGS = ("st_depth", "st_map", "st_used", "st_cand")


def _from_base(x, base):
    """A ``[V, S, ...]`` ring array read from each worker's ``base``: slot
    ``i`` of the result is physical slot ``(base + i) % S``."""
    s_cap = x.shape[1]
    idx = (base[:, None] + np.arange(s_cap)) % s_cap
    return np.take_along_axis(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), axis=1)


@pytest.mark.parametrize("store_used,collect", [(True, 8), (False, 0)])
def test_csr_round_state_matches_repro(rng, store_used, collect):
    """After each of several rounds (steps, then the steal round), every
    EngineState tensor equals repro's; each ring, stale slots included, is
    compared as read from its base, since repro ends a CSR round by rotating
    its rings to base 0 and the port leaves them in place."""
    tgt, pat = _sparse_power_law(rng)
    jplan = jax_build_csr_plan(pat, tgt, variant="ri")
    plan = _port_plan(jplan)
    kw = dict(n_workers=3, expand_width=2, rebalance_interval=3, store_used=store_used,
              collect_matches=collect)
    jcfg = JaxConfig(step_backend="csr", **kw)
    jround = jax.jit(jax_eng.make_round_fn(jcfg, jax_eng.plan_arrays_for(jcfg, jplan)))
    want = [jax_eng.init_state(jplan, jcfg)]
    for _ in range(6):  # steals move a base in round 5
        want.append(jround(want[-1]))
    rotated = False  # a port ring whose base left 0, so the rotation is tested
    for use_pallas, walk in CSR_PATHS:
        cfg = EngineConfig(step_backend="csr", use_pallas=use_pallas, csr_walk=walk, **kw)
        body = eng.make_round_fn(cfg, extend.plan_arrays_for(cfg, [plan], CPU))
        st = init_state(plan, cfg, CPU)
        for i, w in enumerate(want):
            if i:
                st = body(st)
            rotated |= bool(st.base.any())
            for name, a, b in zip(EngineState._fields, st, w):
                if name == "base":
                    continue
                b = np.asarray(b)
                a = a[0].numpy()
                a = a.view(b.dtype) if b.dtype == np.uint32 else a
                if name in RINGS:
                    a = _from_base(a, st.base[0].numpy())
                    b = _from_base(b, np.asarray(w.base))
                np.testing.assert_array_equal(a, b, err_msg=f"{name} after {i} rounds, "
                                                            f"{walk} use_pallas={use_pallas}")
    assert int(np.asarray(want[-1].states).sum()) > 0
    assert rotated


@pytest.mark.parametrize("kw", [
    dict(n_workers=3, expand_width=2),
    dict(n_workers=2, expand_width=2, max_steps=24, collect_matches=4),
])
def test_csr_pack_lanes_equal_single_runs(rng, kw):
    """multi.run_batch over four CSR-only plans of different sizes: every
    EngineState field of every lane equals the same plan's single run (a
    lane that stops early is frozen, ring layout included, through the
    rounds it sits out), and the counters equal repro's
    single csr runs."""
    tgt, _ = _sparse_power_law(rng)
    pats = [extract_connected_pattern(rng, tgt, n) for n in (2, 3, 3, 4)]
    jplans = [jax_build_csr_plan(p, tgt, variant="ri-ds-si-fc", p_pad=16, max_parents=8)
              for p in pats]
    plans = [_port_plan(p) for p in jplans]
    for i in range(1, len(plans)):  # one target: one planes object
        plans[i].csr = plans[0].csr
    for use_pallas, walk in CSR_PATHS[::3]:
        cfg = EngineConfig(step_backend="csr", use_pallas=use_pallas, csr_walk=walk, **kw)
        final = multi.run_batch(plans, cfg, device=CPU)
        for lane, (plan, jplan) in enumerate(zip(plans, jplans)):
            single = multi.run_batch([plan], cfg, device=CPU)
            for name, a, b in zip(EngineState._fields, final, single):
                np.testing.assert_array_equal(a[lane].numpy(), b[0].numpy(),
                                              err_msg=f"{name} lane {lane}, {walk} {use_pallas}")
            want = jax_eng.run(jplan, JaxConfig(step_backend="csr", **kw))
            assert_engine_results_equal(eng.result_from_state(final, cfg, lane), want)
    assert len(set(final.steps.tolist())) > 1  # lanes stopped at different rounds


def test_bucketed_equals_flat_on_hub_target(rng):
    """On the hub-heavy case (deg_cap ~40x the p95 degree) both walks give
    every counter of repro's run, which itself agrees between its walks."""
    tgt, pat = _hub_power_law(rng)
    jplan = jax_build_csr_plan(pat, tgt, variant="ri")
    plan = build_csr_plan(to_port(pat), to_port(tgt), variant="ri", device=CPU)
    want = jax_eng.run(jplan, JaxConfig(step_backend="csr", csr_walk="flat", **KW))
    assert want.states > 0
    for use_pallas, walk in CSR_PATHS:
        got = eng.run(plan, EngineConfig(step_backend="csr", use_pallas=use_pallas,
                                         csr_walk=walk, **KW), device=CPU)
        assert_engine_results_equal(got, want)


def test_auto_resolves_csr_past_threshold(rng, monkeypatch):
    """"auto" picks csr past CSR_AUTO_NT (lowered under the test target's
    size) and always for a CSR-only plan, as repro's rule does, and gives
    the jnp run's counters; an explicit backend ignores the threshold."""
    assert extend.CSR_AUTO_NT == jax_extend.CSR_AUTO_NT
    auto, jauto = EngineConfig(step_backend="auto"), JaxConfig(step_backend="auto")
    for n_t in (extend.CSR_AUTO_NT, extend.CSR_AUTO_NT + 1):
        assert extend.resolve_step_backend(auto, n_t) == jax_extend.resolve_step_backend(
            jauto, n_t)
    tgt, pat = CASES["dense"](rng)
    plan = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)))
    monkeypatch.setattr(extend, "CSR_AUTO_NT", plan.n_t - 1)
    cfg = EngineConfig(step_backend="auto", **KW)
    assert isinstance(extend.plan_arrays_for(cfg, [plan], CPU), extend.CsrPlanArrays)
    assert isinstance(extend.plan_arrays_for(EngineConfig(step_backend="jnp"), [plan], CPU),
                      extend.PlanArrays)
    assert_engine_results_equal(eng.run(plan, cfg, device=CPU),
                                eng.run(plan, EngineConfig(step_backend="jnp", **KW),
                                        device=CPU))
    monkeypatch.setattr(extend, "CSR_AUTO_NT", 10**9)
    sparse = build_csr_plan(to_port(pat), to_port(tgt), device=CPU)
    assert extend.resolve_step_backend_for_plan(cfg, sparse) == "csr"
    assert extend.resolve_step_backend_for_plan(cfg, plan) == "jnp"


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _sparse_sessions(tgt, variant="ri-ds-si-fc", **kw):
    """repro's sparse session and the port's over the same target."""
    jenum = JaxEnumerator(JaxIndex.build(tgt, sparse=True), variant=variant,
                          config=JaxConfig(step_backend="csr", **KW))
    index = SubgraphIndex.build(to_port(tgt), sparse=True)
    enum = Enumerator(index, variant=variant, device=CPU, step_backend="csr", **KW, **kw)
    return jenum, enum


@pytest.mark.parametrize("variant", VARIANTS)
def test_sparse_session_matches_repro(rng, variant):
    """A sparse index yields CSR-only plans equal to repro's; runs equal
    repro's sparse session counter for counter and the dense session's
    sorted mappings; the index fingerprint and pack key are repro's."""
    tgt, pat = _sparse_power_law(rng)
    jenum, enum = _sparse_sessions(tgt, variant, use_pallas=True)
    jq = jenum.prepare(pat)
    q = enum.prepare(to_port(pat))
    assert q.plan.adj_bits.shape[2] == 0 and q.index.sparse
    _assert_plans_equal(q.plan, jq.plan)
    assert q.index.fingerprint == jq.index.fingerprint
    assert enum.coalesce_key(q) == jenum.coalesce_key(jq)
    want, got = jenum.run(jq), enum.run(q)
    assert_engine_results_equal(got, want)
    dense = Enumerator(SubgraphIndex.build(to_port(tgt)), variant=variant, device=CPU, **KW)
    assert sorted(got.mappings()) == sorted(dense.run(dense.prepare(to_port(pat))).mappings())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_prepare_batch_matches_repro(rng, use_pallas):
    """prepare_batch on a sparse index (the batched CSR fixpoint; numpy
    backend: per-query prepare) gives repro's plans, and the dense index's
    numpy plans, for every query."""
    tgt, _ = _sparse_power_law(rng)
    pats = [extract_connected_pattern(rng, tgt, n) for n in (3, 4, 4, 5, 6, 7)]
    names = [f"q{i}" for i in range(len(pats))]
    for variant in ("ri", "ri-ds-si-acfc"):
        jenum, enum = _sparse_sessions(tgt, variant, use_pallas=use_pallas)
        want = jenum.prepare_batch(pats, names=names)
        dense = Enumerator(SubgraphIndex.build(to_port(tgt)), variant=variant, device=CPU)
        host = dense.prepare_batch([to_port(p) for p in pats], names=names, backend="numpy")
        for backend in ("device", "numpy"):
            got = enum.prepare_batch([to_port(p) for p in pats], names=names, backend=backend)
            assert [q.name for q in got] == names
            for g, w, h in zip(got, want, host):
                assert extend.is_csr_only(g.plan)
                _assert_plans_equal(g.plan, w.plan, f"{variant} {backend} vs repro")
                np.testing.assert_array_equal(g.plan.dom_bits, h.plan.dom_bits)


def test_sparse_stream_packs_equal_singles(rng):
    """Raw patterns into stream on a sparse index: packs of 3 over 7
    queries (one pack padded with an inert lane); every lane equals the same
    query's single run, and repro's single run (repro's vmapped csr pack is
    too slow on the CPU to run here).  Patterns whose search exceeds 3,000
    states are passed over, to keep the CPU run short."""
    tgt, _ = _sparse_power_law(rng)
    jenum, enum = _sparse_sessions(tgt, "ri-ds-si-acfc", use_pallas=True)
    pats, want = [], []
    while len(pats) < 7:
        p = extract_connected_pattern(rng, tgt, int(rng.integers(3, 5)))
        if p.m:
            ms = jenum.run(jenum.prepare(p))
            if ms.states <= 3000:
                pats.append(p)
                want.append(ms)
    streamed = sorted(enum.stream([to_port(p) for p in pats], pack_size=3),
                      key=lambda m: m.query_index)
    assert [m.query_index for m in streamed] == list(range(len(pats)))
    for ms, w in zip(streamed, want):
        assert_engine_results_equal(ms, w)
        single = enum.run(enum.prepare(to_port(pats[ms.query_index])))
        assert_engine_results_equal(single, ms)
    assert enum.cache_stats()["uploads"] == 1  # the planes went to the device once


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_sparse_index_dense_backend_fails_fast(rng, backend):
    """An explicitly dense step backend can never run a CSR-only plan:
    prepare() says so, naming the backend and the valid ones, before any
    upload."""
    tgt, pat = _sparse_power_law(rng)
    enum = Enumerator(SubgraphIndex.build(to_port(tgt), sparse=True), device=CPU,
                      step_backend=backend, **KW)
    with pytest.raises(ValueError, match="CSR-only") as ei:
        enum.prepare(to_port(pat))
    msg = str(ei.value)
    assert backend in msg and "'csr'" in msg
    assert enum.cache_stats()["uploads"] == 0


def test_csr_only_query_dense_run_fails_fast(rng):
    """Running a CSR-only query through a dense-configured session raises
    at run entry, before any upload; so does a pack."""
    tgt, pat = _sparse_power_law(rng)
    idx = SubgraphIndex.build(to_port(tgt), sparse=True)
    q = Enumerator(idx, device=CPU, step_backend="csr", **KW).prepare(to_port(pat))
    dense = Enumerator(idx, device=CPU, step_backend="jnp", **KW)
    with pytest.raises(ValueError, match="CSR-only"):
        dense.run(q)
    with pytest.raises(ValueError, match="CSR-only"):
        dense.run_batch([q, q], pack_size=2)
    assert dense.cache_stats()["uploads"] == 0
    with pytest.raises(TypeError, match="host Graph"):
        SubgraphIndex.build(PackedGraph.from_graph(to_port(tgt)), sparse=True)


def test_cpu_sparse_run_launches_no_kernel(rng):
    """On the CPU the sparse path runs the plain versions: no launches."""
    tgt, pat = _sparse_power_law(rng)
    ops.reset_launch_counts()
    jenum, enum = _sparse_sessions(tgt, "ri-ds-si-acfc", use_pallas=True)
    enum.run(enum.prepare(to_port(pat)))
    enum.run_batch([to_port(pat)] * 2, pack_size=2)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_plan_csr_derivation_matches_index_planes(rng):
    """A dense index's plans read the index's cached planes under the csr
    backend; they equal the planes derived from the plan's bitmaps."""
    tgt, pat = CASES["edge_labels"](rng)
    index = SubgraphIndex.build(to_port(tgt))
    q = Enumerator(index, device=CPU, step_backend="csr", **KW).prepare(to_port(pat))
    assert extend.plan_csr(q.plan) is index.csr_planes()
    derived = build_plan(to_port(pat), index.packed)
    cp = extend.plan_csr(derived)
    np.testing.assert_array_equal(cp.indptr, index.csr_planes().indptr)
    np.testing.assert_array_equal(cp.indices, index.csr_planes().indices)
    assert extend.csr_shape_bucket(q.plan) == jax_extend.csr_shape_bucket(
        jax_build_plan(pat, JaxPacked.from_graph(tgt)))
    assert not extend.is_csr_only(q.plan)


def test_sparse_edge_seeding_refused(rng):
    """The refusals that stay with edge seeding, each as repro's: edge root
    seeding of a plan without a seed edge, a self-loop or non-edge
    ``seed_edge``, and ``anchor=`` together with ``seed_edge=``."""
    tgt, pat = _sparse_power_law(rng)
    enum = Enumerator(SubgraphIndex.build(to_port(tgt), sparse=True), device=CPU,
                      step_backend="csr", root_seeding="edge", **KW)
    jenum = JaxEnumerator(JaxIndex.build(tgt, sparse=True), step_backend="csr",
                          root_seeding="edge", **KW)
    for e, p in ((enum, to_port(pat)), (jenum, pat)):
        with pytest.raises(ValueError, match="seed_edge"):
            e.run(e.prepare(p))
    edge = (int(pat.src[0]), int(pat.dst[0]), int(pat.edge_labels[0]))
    builds = ((lambda **kw: build_csr_plan(to_port(pat), to_port(tgt), device=CPU, **kw)),
              (lambda **kw: jax_build_csr_plan(pat, tgt, **kw)))
    for build in builds:
        with pytest.raises(ValueError, match="self-loop"):
            build(seed_edge=(edge[0], edge[0], edge[2]))
        with pytest.raises(ValueError, match="not a pattern edge"):
            build(seed_edge=(edge[0], edge[1], edge[2] + 7))
        with pytest.raises(ValueError, match="mutually exclusive"):
            build(seed_edge=edge, anchor=edge[:2])
