"""The port's batch path against the JAX package's, on the CPU.

``Enumerator.prepare_batch`` (device domain fixpoint), ``run_batch``,
``stream``, ``run_pack`` and ``multi.enumerate_many`` / ``multi.run_batch``
of `repro_torch` must equal ``repro``'s: the plan arrays of every prepared
query, and for every query ``matches``, ``states``, ``steps``, ``steals``,
``steal_rounds`` and the per-worker arrays — with every pack lane equal to
the same query's single ``run`` as well.  The cases follow
``tests/test_session.py``: unsatisfiable queries kept aligned, self-loops
and label overflow through ``prepare_batch``, an overflowed pack lane and
its doubled-cap retry, and a ``run_pack`` with mixed keys, which raises.
At the state level, a pack's final ``EngineState`` equals repro's vmapped
pack lane for lane, including a pack whose lanes stop at different rounds
(drained, capped by ``max_steps``, overflowed).  Integers: exact.
"""

import numpy as np
import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import Enumerator as JaxEnumerator  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.core import multi as jax_multi  # noqa: E402
from repro.core import scheduler as jax_scheduler  # noqa: E402
from repro.core import session as jax_sess  # noqa: E402
from repro.core.graph import Graph as JaxGraph  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex, multi  # noqa: E402
from repro_torch.core import scheduler  # noqa: E402
from repro_torch.core import session as sess  # noqa: E402
from repro_torch.core.frontier import EngineState  # noqa: E402
from repro_torch.core.graph import Graph, PackedGraph  # noqa: E402
from repro_torch.core.plan import PLAN_ARRAY_FIELDS, build_plan, plan_from_numpy  # noqa: E402
from tests.conftest import bump_edge_label, extract_connected_pattern, random_graph  # noqa: E402
from tests.test_torch_engine import PORT_PATHS, assert_engine_results_equal  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

CPU = "cpu"
KW = dict(n_workers=4, expand_width=2)


def _corpus(rng, n_pats=5):
    """tests/test_session.py's corpus: one target, extracted patterns."""
    tgt = random_graph(rng, 40, 120, n_labels=3)
    pats = []
    while len(pats) < n_pats:
        p = extract_connected_pattern(rng, tgt, int(rng.integers(2, 5)))
        if p.m > 0:
            pats.append(p)
    return tgt, pats


def _sessions(tgt, variant="ri-ds-si-fc", **kw):
    """repro's session and the port's three step paths on one target."""
    jenum = JaxEnumerator(JaxIndex.build(tgt), config=JaxConfig(**KW, **kw), variant=variant)
    index = SubgraphIndex.build(to_port(tgt))
    ports = {f"{b}+{p}": Enumerator(index, variant=variant, device=CPU, step_backend=b,
                                    use_pallas=p, **KW, **kw)
             for b, p in PORT_PATHS}
    return jenum, ports


def _assert_matchsets_equal(got, want):
    assert [m.name for m in got] == [m.name for m in want]
    assert [m.query_index for m in got] == [m.query_index for m in want]
    for g, w in zip(got, want):
        assert g.retries == w.retries, g.name
        if w.per_worker_states is None:  # unsatisfiable: the engine never ran
            assert g.per_worker_states is None and (g.matches, g.states) == (0, 0)
            continue
        assert_engine_results_equal(g, w)


def _assert_plans_equal(got, want):
    for f in PLAN_ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# preparation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["ri-ds", "ri-ds-si-fc", "ri-ds-si-acfc"])
def test_prepare_batch_matches_repro_and_prepare(rng, variant):
    """prepare_batch (device fixpoint, plain and K5/K3 routes) gives
    repro's prepare_batch plans and the port's per-query numpy prepare."""
    tgt, pats = _corpus(rng, n_pats=8)
    names = [f"q{i}" for i in range(len(pats))]
    jenum = JaxEnumerator(JaxIndex.build(tgt), config=JaxConfig(**KW), variant=variant)
    want = jenum.prepare_batch(pats, names=names)
    index = SubgraphIndex.build(to_port(tgt))
    port_pats = [to_port(p) for p in pats]
    for use_pallas in (False, True):
        enum = Enumerator(index, variant=variant, device=CPU, use_pallas=use_pallas, **KW)
        got = enum.prepare_batch(port_pats, names=names)
        host = enum.prepare_batch(port_pats, names=names, backend="numpy")
        assert [q.name for q in got] == names == [q.name for q in host]
        for g, h, w in zip(got, host, want):
            _assert_plans_equal(g.plan, w.plan)
            _assert_plans_equal(h.plan, w.plan)
            assert g.index is index and g.variant == variant


def test_prepare_batch_selfloops_and_unsat(rng):
    """Self-loop patterns and a label-overflow (unsatisfiable) pattern keep
    their order and results through the batched path (raw Graphs into
    run_batch), as in repro."""
    tgt = random_graph(rng, 20, 50, n_labels=2, selfloops=3)
    good = extract_connected_pattern(rng, tgt, 3)
    assert good.m
    bad = bump_edge_label(good, 0, 9)
    jenum, ports = _sessions(tgt)
    want = jenum.run_batch([good, bad, good], pack_size=2)
    assert want[1].matches == 0 and want[0].matches >= 1
    for label, enum in ports.items():
        got = enum.run_batch([to_port(good), to_port(bad), to_port(good)], pack_size=2)
        _assert_matchsets_equal(got, want)
        assert not got[1].plan.satisfiable and not got[1].plan.dom_bits.any()


def test_domain_backend_option(rng):
    tgt, pats = _corpus(rng, n_pats=3)
    index = SubgraphIndex.build(to_port(tgt))
    host = Enumerator(index, device=CPU, domain_backend="numpy", **KW)
    dev = Enumerator(index, device=CPU, **KW)
    for a, b in zip(host.prepare_batch([to_port(p) for p in pats]),
                    dev.prepare_batch([to_port(p) for p in pats])):
        _assert_plans_equal(a.plan, b.plan)
    with pytest.raises(ValueError, match="domain_backend"):
        Enumerator(index, device=CPU, domain_backend="gpu")
    with pytest.raises(ValueError, match="names"):
        dev.prepare_batch([to_port(pats[0])], names=["a", "b"])


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["ri", "ri-ds-si-acfc"])
def test_run_batch_and_stream_match_repro(rng, variant):
    """Packs of 3 over 7 queries (so a pack is padded with an inert lane):
    every counter equals repro's run_batch / stream and the port's own
    single runs, on all three step paths."""
    tgt, pats = _corpus(rng, n_pats=7)
    jenum, ports = _sessions(tgt, variant=variant)
    jqs = [jenum.prepare(p, name=f"q{i}") for i, p in enumerate(pats)]
    want = jenum.run_batch(jqs, pack_size=3)
    want_stream = sorted(jenum.stream(jqs, pack_size=3), key=lambda m: m.query_index)
    for label, enum in ports.items():
        qs = [enum.prepare(to_port(p), name=f"q{i}") for i, p in enumerate(pats)]
        got = enum.run_batch(qs, pack_size=3)
        _assert_matchsets_equal(got, want)
        streamed = sorted(enum.stream(qs, pack_size=3), key=lambda m: m.query_index)
        _assert_matchsets_equal(streamed, want_stream)
        for q, ms in zip(qs, got):
            single = enum.run(q)
            single.query_index = ms.query_index
            _assert_matchsets_equal([ms], [single])


def test_run_batch_keeps_unsatisfiable_aligned(rng):
    """One result per query, in order, unsatisfiable ones included; the
    enumerate_many wrapper inherits it, equal to repro's."""
    tgt, pats = _corpus(rng, n_pats=3)
    bad = JaxGraph.from_edges(2, [(0, 1)], labels=[99, 0], undirected=True)
    mixed = [pats[0], bad, pats[1], bad, pats[2]]
    names = [f"m{i}" for i in range(len(mixed))]
    jenum, ports = _sessions(tgt)
    want = jenum.run_batch([jenum.prepare(p, name=n) for p, n in zip(mixed, names)],
                           pack_size=2)
    for label, enum in ports.items():
        got = enum.run_batch([enum.prepare(to_port(p), name=n) for p, n in zip(mixed, names)],
                             pack_size=2)
        _assert_matchsets_equal(got, want)
        assert got[1].matches == got[3].matches == 0

    jcfg, cfg = JaxConfig(**KW), EngineConfig(**KW)
    want_many = jax_multi.enumerate_many(mixed, tgt, cfg=jcfg, pack_size=2, names=names)
    got_many = multi.enumerate_many([to_port(p) for p in mixed], to_port(tgt), cfg=cfg,
                                    pack_size=2, names=names, device=CPU)
    assert [(r.name, r.matches, r.states, r.steps) for r in got_many] == \
        [(r.name, r.matches, r.states, r.steps) for r in want_many]
    with pytest.raises(ValueError, match="names"):
        multi.enumerate_many([to_port(pats[0])], to_port(tgt), cfg=cfg, names=["a", "b"],
                             device=CPU)


def test_run_pack_matches_run_and_refuses_mixed_keys(rng):
    tgt, pats = _corpus(rng, n_pats=5)
    jenum, ports = _sessions(tgt)
    jqs = [jenum.prepare(p, name=f"q{i}") for i, p in enumerate(pats)]
    bad = JaxGraph.from_edges(2, [(0, 1)], labels=[99, 0], undirected=True)
    want = jenum.run_pack(jqs, pack_size=4)
    want_mixed = jenum.run_pack([jqs[0], jenum.prepare(bad), jqs[1]], pack_size=4)
    other = random_graph(rng, 25, 60, n_labels=3)
    other_q = extract_connected_pattern(rng, other, 3)
    for label, enum in ports.items():
        qs = [enum.prepare(to_port(p), name=f"q{i}") for i, p in enumerate(pats)]
        _assert_matchsets_equal(enum.run_pack(qs, pack_size=4), want)
        mixed = enum.run_pack([qs[0], enum.prepare(to_port(bad)), qs[1]], pack_size=4)
        _assert_matchsets_equal(mixed, want_mixed)
        qo = sess.prepare_query(to_port(other_q), to_port(other))
        with pytest.raises(ValueError, match="coalesce_key"):
            enum.run_pack([qs[0], qo])
        assert enum.coalesce_key(qs[0]) == jenum.coalesce_key(jqs[0])


def test_overflow_retry_in_batch_path(rng):
    """An overflowed pack lane goes straight to the doubled-cap single
    retry; counters equal repro's, lane for lane."""
    tgt = random_graph(rng, 40, 120, n_labels=2)
    pat = extract_connected_pattern(rng, tgt, 6)
    small = extract_connected_pattern(rng, tgt, 3)
    kw = dict(n_workers=2, expand_width=2, stack_cap=8)
    jenum = JaxEnumerator(JaxIndex.build(tgt), **kw)
    with pytest.warns(RuntimeWarning, match="overflowed"):
        want = jenum.run_batch([jenum.prepare(pat, name="big"),
                                jenum.prepare(small, name="small")])
    assert [m.retries for m in want] == [1, 0]
    index = SubgraphIndex.build(to_port(tgt))
    for backend, use_pallas in PORT_PATHS:
        enum = Enumerator(index, device=CPU, step_backend=backend, use_pallas=use_pallas, **kw)
        with pytest.warns(RuntimeWarning, match="overflowed"):
            got = enum.run_batch([enum.prepare(to_port(pat), name="big"),
                                  enum.prepare(to_port(small), name="small")])
        _assert_matchsets_equal(got, want)


# ---------------------------------------------------------------------------
# state level: a pack's final state, lane for lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_workers=3, expand_width=2),
    dict(n_workers=2, expand_width=2, max_steps=40, collect_matches=4),
    dict(n_workers=2, expand_width=2, stack_cap=9, store_used=False),
])
def test_pack_state_matches_repro_vmapped_pack(rng, kw):
    """multi.run_batch over four plans of different sizes equals repro's
    vmapped pack in every EngineState field of every lane; the configs make
    lanes stop at different rounds (drained, capped by max_steps,
    overflowed), which must freeze each as vmap does."""
    tgt = random_graph(rng, 30, 90, n_labels=2)
    pats = [extract_connected_pattern(rng, tgt, n) for n in (2, 3, 5, 6)]
    jpacked = JaxPacked.from_graph(tgt)
    jplans = [jax_build_plan(p, jpacked, p_pad=16) for p in pats]
    want = jax_multi.run_batch(jplans, JaxConfig(**kw))
    plans = [plan_from_numpy({f: getattr(p, f) for f in PLAN_ARRAY_FIELDS}) for p in jplans]
    for i in range(1, len(plans)):  # one target: one adjacency object
        plans[i].adj_bits = plans[0].adj_bits
    for backend, use_pallas in PORT_PATHS:
        cfg = EngineConfig(step_backend=backend, use_pallas=use_pallas, **kw)
        final = multi.run_batch(plans, cfg, device=CPU)
        for name, a, b in zip(EngineState._fields, final, want):
            b = np.asarray(b)
            a = a.numpy()
            a = a.view(b.dtype) if b.dtype == np.uint32 else a
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, {backend} {use_pallas}")
    assert len(set(np.asarray(want.steps).tolist())) > 1  # lanes stopped at different rounds


def test_pack_refuses_plans_of_two_targets(rng):
    g1 = to_port(random_graph(rng, 12, 20))
    g2 = to_port(random_graph(rng, 12, 22))
    p = Graph.from_edges(2, [(0, 1)], undirected=True)
    plans = [build_plan(p, PackedGraph.from_graph(g), p_pad=16) for g in (g1, g2)]
    with pytest.raises(ValueError, match="one target adjacency"):
        multi.run_batch(plans, EngineConfig(**KW), device=CPU)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def test_buckets_and_balancing_match_repro(rng):
    for n in (0, 1, 3, 7, 8, 9, 33):
        assert sess.snap_arc_pad(n) == jax_sess.snap_arc_pad(n)
        assert sess.snap_loop_pad(n) == jax_sess.snap_loop_pad(n)
        assert sess.snap_batch_pad(max(n, 1)) == jax_sess.snap_batch_pad(max(n, 1))
    weights = rng.integers(1, 100, 23).astype(np.float64)
    for shards in (1, 4, 7):
        a = scheduler.balance_assignment(weights, shards)
        np.testing.assert_array_equal(a, jax_scheduler.balance_assignment(weights, shards))
        assert scheduler.imbalance(weights, a, shards) == \
            jax_scheduler.imbalance(weights, a, shards)
    tgt, pats = _corpus(rng, n_pats=3)
    jenum = JaxEnumerator(JaxIndex.build(tgt), config=JaxConfig(**KW))
    enum = Enumerator(SubgraphIndex.build(to_port(tgt)), device=CPU, **KW)
    for p in pats:
        assert sess._predict_work(enum.prepare(to_port(p)).plan) == \
            jax_sess._predict_work(jenum.prepare(p).plan)
