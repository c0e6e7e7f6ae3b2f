"""The port's always-on service against the JAX package's, on the CPU.

* units: the coalescer, the admission queue, ``LatencyWindow`` and
  ``ServiceMetrics`` replay one event script under a fake clock in both
  packages and give identical outputs;
* the whole slice: the same queries queued into ``repro.serve`` and
  ``repro_torch.serve`` before ``start()`` (window 0, so the dispatch
  schedule is deterministic), then ``stop(drain=True)``: every per-query
  counter, ``retries`` (a small ``stack_cap`` that overflows) and streamed
  chunk, and the snapshot's deterministic counters, are equal;
* ``tests/test_serving.py``'s semantics on the port's service, with
  upload counts where ``repro`` counts compiles (the port compiles
  nothing; its one-off cost is an adjacency upload per index version and
  layout), ``tests/test_incremental_conformance.py``'s live
  ``update_index``, ``tests/test_system.py``'s command-line smoke, and
  ``tests/test_partitioned.py``'s ``Enumerator.warm`` cases;
* the session's upload cache: ``max_cache_entries``, ``evictions`` and
  its lock, with client threads updating the index and preparing sparse
  queries while the dispatcher runs packs.

Every service here is stopped before its test ends, and no test changes
global state.
"""

import dataclasses
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.serve import EnumerationService as JaxService  # noqa: E402
from repro.serve import ServiceConfig as JaxServiceConfig  # noqa: E402
from repro.serve import admission as jax_admission  # noqa: E402
from repro.serve import coalescer as jax_coalescer  # noqa: E402
from repro.serve import metrics as jax_metrics  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, Query, SubgraphIndex  # noqa: E402
from repro_torch.core import extend  # noqa: E402
from repro_torch.core.delta import apply_delta  # noqa: E402
from repro_torch.core.plan import build_csr_plan  # noqa: E402
from repro_torch.core.ref import ref_node_mappings  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Backpressure,
    Coalescer,
    EnumerationService,
    QuotaExceeded,
    ServiceConfig,
    ServiceError,
)
from repro_torch.serve import admission as port_admission  # noqa: E402
from repro_torch.serve import coalescer as port_coalescer  # noqa: E402
from repro_torch.serve import metrics as metrics_mod  # noqa: E402
from repro_torch.serve.admission import AdmissionQueue, Request  # noqa: E402
from tests.conftest import (  # noqa: E402
    bump_edge_label,
    extract_connected_pattern,
    power_law_target,
    random_graph,
)
from tests.test_incremental_conformance import _dense, _sample_edits  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

CPU = "cpu"
KW = dict(n_workers=4, expand_width=2)
CFG = EngineConfig(**KW)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _corpus(rng, n_pats=6, n=40, m=120):
    tgt = random_graph(rng, n, m, n_labels=3)
    pats = []
    while len(pats) < n_pats:
        p = extract_connected_pattern(rng, tgt, int(rng.integers(2, 5)))
        if p.m > 0:
            pats.append(p)
    return tgt, pats


def _port_corpus(rng, n_pats=6, n=40, m=120):
    tgt, pats = _corpus(rng, n_pats, n, m)
    return to_port(tgt), [to_port(p) for p in pats]


def _counters(ms):
    return (ms.matches, ms.states, ms.steps, ms.steals, ms.steal_rounds, ms.retries,
            None if ms.per_worker_states is None else np.asarray(ms.per_worker_states).tolist(),
            None if ms.per_worker_matches is None else np.asarray(ms.per_worker_matches).tolist(),
            None if ms.per_worker_steals is None else np.asarray(ms.per_worker_steals).tolist())


# ---------------------------------------------------------------------------
# parity of the plain-Python units, under one event script and a fake clock
# ---------------------------------------------------------------------------

def _coalescer_log(mod, max_lanes, window_s, script):
    clk = FakeClock()
    c = mod.Coalescer(max_lanes=max_lanes, window_s=window_s, clock=clk)
    log = []
    for op, arg in script:
        if op == "t":
            clk.t = arg
        elif op == "add":
            log.append(("add", c.add(*arg)))
        else:
            log.append((op, getattr(c, op)()))
    return log


def _coalescer_script(rng, n=60):
    script, t = [], 0.0
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            script.append(("add", (f"k{int(rng.integers(3))}", int(rng.integers(100)))))
        elif r < 0.75:
            t += float(rng.choice([0.0, 0.25, 0.5, 1.0]))
            script.append(("t", t))
        else:
            script.append((str(rng.choice(["ripe", "next_deadline", "pending", "flush"])), None))
    return script + [("ripe", None), ("flush", None)]


@pytest.mark.parametrize("max_lanes,window_s", [(1, 0.0), (3, 0.5), (8, 1.0)])
def test_coalescer_event_script_parity(max_lanes, window_s):
    """The port's coalescer is repro's: the same adds, clock steps, ripe /
    flush / deadline / pending reads give the same outputs."""
    script = _coalescer_script(np.random.default_rng(max_lanes))
    assert (_coalescer_log(port_coalescer, max_lanes, window_s, script)
            == _coalescer_log(jax_coalescer, max_lanes, window_s, script))
    for mod in (port_coalescer, jax_coalescer):
        for bad in (dict(max_lanes=0), dict(window_s=-1.0)):
            with pytest.raises(ValueError):
                mod.Coalescer(**bad)


def _admission_log(mod, script):
    q = mod.AdmissionQueue(max_depth=4, max_outstanding_per_tenant=2, clock=FakeClock())
    log = []
    for op, arg in script:
        try:
            if op == "admit":
                req = mod.Request(query=None, tenant=arg, stream=None, collect=0,
                                  submitted_at=0.0)
                q.admit(req, timeout=None)
                log.append(("admit", req.seq))
            elif op == "pop":
                log.append(("pop", [(r.tenant, r.seq) for r in q.pop(timeout=0)]))
            elif op == "release":
                q.release(arg)
                log.append(("release", arg))
            else:
                log.append((op, q.depth(), q.outstanding(), q.outstanding(arg)))
        except (mod.QuotaExceeded, mod.Backpressure) as e:
            log.append((op, type(e).__name__, str(e)))
    return log


def test_admission_event_script_parity():
    """Quota rejects, backpressure rejects (no blocking), FIFO pops,
    releases and gauges: the same outputs, error texts included."""
    rng = np.random.default_rng(5)
    script, held = [], []
    for _ in range(80):
        r = rng.random()
        tenant = f"t{int(rng.integers(3))}"
        if r < 0.5:
            script.append(("admit", tenant))
            held.append(tenant)
        elif r < 0.65:
            script.append(("pop", None))
        elif r < 0.85 and held:
            script.append(("release", held.pop(int(rng.integers(len(held))))))
        else:
            script.append(("gauges", tenant))
    log = _admission_log(port_admission, script)
    assert log == _admission_log(jax_admission, script)
    kinds = {entry[1] for entry in log if entry[0] == "admit" and isinstance(entry[1], str)}
    assert kinds == {"QuotaExceeded", "Backpressure"}  # the script reaches both


@pytest.mark.parametrize("cap", [1, 7, 100])
def test_latency_window_parity(cap):
    values = np.random.default_rng(cap).exponential(0.01, 250).tolist()
    port, ref = metrics_mod.LatencyWindow(cap), jax_metrics.LatencyWindow(cap)
    for i, v in enumerate(values):
        port.record(v)
        ref.record(v)
        if i % 17 == 0:
            for p in (0, 1, 50, 90, 99, 100):
                assert port.percentile(p) == ref.percentile(p)
            assert (len(port), port.mean(), port.max()) == (len(ref), ref.mean(), ref.max())


def test_service_metrics_parity():
    """The same observations give the same snapshot; only the names that
    count compiles in repro count uploads in the port."""
    snaps = []
    for mod, cache in ((metrics_mod, dict(uploads=3, cache_hits=9, evictions=1, entries=2)),
                       (jax_metrics, dict(compiles=3, cache_hits=9, evictions=1, entries=2))):
        clk = FakeClock()
        m = mod.ServiceMetrics(clock=clk, window=16)
        for i in range(40):
            clk.t = 0.01 * i
            m.inc("submitted")
            m.observe_queue_wait(0.001 * (i % 5))
            m.observe_dispatch(1 + i % 4, 4)
            m.observe_completion(0.002 * (i % 7), retries=i % 2, ok=i % 9 != 0)
        snaps.append(m.snapshot(cache=cache, queue_depth=2, coalescing=1, in_flight=3))
    port, ref = snaps
    renamed = {"warmup_uploads": "warmup_compiles", "cache_uploads": "cache_compiles"}
    assert {renamed.get(k, k) for k in port} == set(ref)
    for k, v in port.items():
        assert v == ref[renamed.get(k, k)], k


# ---------------------------------------------------------------------------
# the whole slice: both services on the same queued-before-start traffic
# ---------------------------------------------------------------------------

def _served(svc_cls, cfg_cls, service_kw, index, queries):
    """Queue every ``(query or pattern, collect, tenant)`` before start(),
    then drain: the dispatcher's first pop takes them all, full buckets
    dispatch at once and the rest ripen in the same pass (window 0)."""
    svc = svc_cls(index, **service_kw)
    handles = [svc.submit(q, tenant=tenant, collect=collect, name=f"q{i}")
               for i, (q, collect, tenant) in enumerate(queries)]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # overflow retries warn
            svc.start()
            statuses = [h.status(timeout=240.0) for h in handles]
    finally:
        svc.stop(drain=True)
    # as plain tuples: each package has its own ResultChunk class
    return svc.stats(), statuses, [[(c.seq, c.mappings, c.final) for c in h.chunks()]
                                   for h in handles]


SNAPSHOT_COUNTERS = ("submitted", "admitted", "unsat", "completed", "dispatches", "chunks",
                     "rejected_quota", "rejected_backpressure", "index_updates", "failed",
                     "retries")


@pytest.mark.parametrize("case", ["mixed", "overflow"])
def test_service_parity_with_repro(case):
    """repro.serve and repro_torch.serve on the same queries: per query,
    every counter, per-worker counters and ``retries``; every streamed
    chunk; the snapshot's deterministic counters."""
    rng = np.random.default_rng(11)
    if case == "mixed":
        tgt, pats = _corpus(rng, n_pats=7)
        pats.append(bump_edge_label(pats[0], 0, 9))  # unsatisfiable: short-circuits
        kw, service = KW, dict(max_lanes=3, batch_window_s=0.0, chunk_size=5)
        collects = [16, 0, 16, 0, 16, 0, 16, 4]
    else:
        tgt = random_graph(rng, 40, 120, n_labels=2)
        pats = [extract_connected_pattern(rng, tgt, 4) for _ in range(3)]
        pats.append(extract_connected_pattern(rng, tgt, 2))
        kw, service = dict(n_workers=2, expand_width=2, stack_cap=4), dict(
            max_lanes=4, batch_window_s=0.0, chunk_size=7)
        collects = [8, 0, 8, 0]
    traffic = [(p, c, f"t{i % 3}") for i, (p, c) in enumerate(zip(pats, collects))]
    jax_stats, jax_st, jax_chunks = _served(
        JaxService, JaxServiceConfig,
        dict(config=JaxConfig(**kw), service=JaxServiceConfig(**service)),
        JaxIndex.build(tgt), traffic)
    port_stats, port_st, port_chunks = _served(
        EnumerationService, ServiceConfig,
        dict(config=EngineConfig(**kw), service=ServiceConfig(**service), device=CPU),
        SubgraphIndex.build(to_port(tgt)), [(to_port(p), c, t) for p, c, t in traffic])
    for a, b in zip(port_st, jax_st):
        assert a.ok and b.ok
        assert _counters(a.matchset) == _counters(b.matchset)
        assert (a.retries, a.n_chunks) == (b.retries, b.n_chunks)
        assert a.retries == a.matchset.retries
    assert port_chunks == jax_chunks
    for k in SNAPSHOT_COUNTERS:
        assert port_stats[k] == jax_stats[k], k
    if case == "overflow":
        assert [st.retries for st in port_st] == [1, 1, 1, 0]  # the 2-node query fits
    else:
        assert port_stats["unsat"] == 1 and port_stats["chunks"] > len(pats)


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port: coalescer and admission units
# ---------------------------------------------------------------------------

def test_coalescer_lane_budget_dispatches_immediately():
    clk = FakeClock()
    c = Coalescer(max_lanes=3, window_s=10.0, clock=clk)
    assert c.add("k", 1) is None
    assert c.add("k", 2) is None
    key, items = c.add("k", 3)  # budget filled: no window wait
    assert (key, items) == ("k", [1, 2, 3])
    assert c.pending() == 0 and c.ripe() == []


def test_coalescer_window_ripens_oldest_first():
    clk = FakeClock()
    c = Coalescer(max_lanes=8, window_s=1.0, clock=clk)
    c.add("a", 1)
    clk.t = 0.5
    c.add("b", 2)
    c.add("a", 3)          # does not reset bucket a's window
    assert c.ripe() == []
    assert c.next_deadline() == pytest.approx(1.0)  # bucket a's oldest + window
    clk.t = 1.0
    assert c.ripe() == [("a", [1, 3])]   # b not due yet
    clk.t = 1.5
    assert c.ripe() == [("b", [2])]
    assert c.next_deadline() is None


def test_coalescer_flush_and_fifo_order():
    c = Coalescer(max_lanes=8, window_s=1.0, clock=FakeClock())
    for i in range(3):
        c.add("x", i)
    c.add("y", 99)
    assert c.flush() == [("x", [0, 1, 2]), ("y", [99])]
    assert c.pending() == 0


def _req(tenant="t"):
    return Request(query=None, tenant=tenant, stream=None, collect=0, submitted_at=0.0)


def test_admission_quota_rejects_immediately():
    q = AdmissionQueue(max_depth=16, max_outstanding_per_tenant=2)
    q.admit(_req("a"))
    q.admit(_req("a"))
    with pytest.raises(QuotaExceeded):
        q.admit(_req("a"), timeout=5.0)  # quota never blocks, even with a timeout
    q.admit(_req("b"))  # other tenants unaffected
    assert q.outstanding("a") == 2 and q.outstanding("b") == 1
    # quota frees on release (terminal status), not on pop (execution start)
    assert len(q.pop(timeout=0)) == 3
    assert q.outstanding("a") == 2
    q.release("a")
    q.admit(_req("a"))


def test_admission_backpressure_blocks_then_rejects():
    q = AdmissionQueue(max_depth=1, max_outstanding_per_tenant=8)
    q.admit(_req("a"))
    with pytest.raises(Backpressure):
        q.admit(_req("b"), timeout=None)  # no timeout = no blocking
    with pytest.raises(Backpressure):
        q.admit(_req("b"), timeout=0.01)
    done = []

    def late_pop():
        q.pop(timeout=0)
        done.append(True)

    t = threading.Timer(0.05, late_pop)
    t.start()
    q.admit(_req("b"), timeout=5.0)  # a concurrent pop() frees space
    t.join()
    assert done and q.depth() == 1


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port: the service
# ---------------------------------------------------------------------------

def test_stream_chunks_concatenate_bit_identically(rng):
    """Chunks arrive in deterministic seq order and concatenate to exactly
    the one-shot run's mappings; counts match too."""
    tgt, pats = _port_corpus(rng, n_pats=4)
    index = SubgraphIndex.build(tgt)
    ref = Enumerator(index, config=CFG, device=CPU)
    sc = ServiceConfig(max_lanes=4, batch_window_s=0.001, chunk_size=3)
    svc = EnumerationService(index, config=CFG, service=sc, device=CPU)
    with svc:
        handles = [svc.submit(p, collect=64) for p in pats]
        for p, h in zip(pats, handles):
            chunks = h.chunks(timeout=120.0)
            ms = h.result()
            one = ref.run(ref.prepare(p), collect_matches=64)
            assert (ms.matches, ms.states) == (one.matches, one.states)
            assert [c.seq for c in chunks] == list(range(len(chunks)))
            assert all(len(c.mappings) <= 3 for c in chunks)
            if chunks:
                assert chunks[-1].final and not any(c.final for c in chunks[:-1])
            assert [m for c in chunks for m in c.mappings] == one.mappings()
            assert h.status().n_chunks == len(chunks)
    # a second identical service streams the identical chunk sequence
    with EnumerationService(index, config=CFG, service=sc, device=CPU) as svc2:
        h2 = svc2.submit(pats[0], collect=64)
        assert h2.chunks(timeout=120.0) == handles[0].chunks()


def test_counting_mode_streams_no_chunks(rng):
    tgt, pats = _port_corpus(rng, n_pats=2)
    index = SubgraphIndex.build(tgt)
    ref = Enumerator(index, config=CFG, device=CPU)
    with EnumerationService(index, config=CFG, device=CPU) as svc:
        h = svc.submit(pats[0], collect=0)
        assert h.chunks(timeout=120.0) == []
        assert h.result().matches == ref.run(ref.prepare(pats[0])).matches


def test_concurrent_clients_match_standalone_runs(rng):
    """Many client threads, coalesced packs: every streamed result equals
    a standalone run; metrics add up."""
    tgt, pats = _port_corpus(rng, n_pats=8)
    index = SubgraphIndex.build(tgt)
    ref = Enumerator(index, config=CFG, device=CPU)
    expected = [ref.run(ref.prepare(p)) for p in pats]
    svc = EnumerationService(index, config=CFG, device=CPU,
                             service=ServiceConfig(max_lanes=4, batch_window_s=0.005))
    results = [None] * len(pats)
    errors = []

    def client(i):
        try:
            h = svc.submit(pats[i], tenant=f"t{i % 3}", collect=0, timeout=30.0)
            results[i] = h.result(timeout=120.0)
        except BaseException as e:
            errors.append(e)

    with svc:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(pats))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    assert not errors, errors
    for ms, exp in zip(results, expected):
        assert _counters(ms) == _counters(exp)
    stats = svc.stats()
    assert stats["completed"] == len(pats)
    assert stats["dispatches"] >= 1
    assert 0 < stats["batch_occupancy"] <= 1
    assert stats["latency_p99_s"] >= stats["latency_p50_s"] > 0
    assert stats["cache_uploads"] == 1 and stats["cache_hit_rate"] >= 0


def test_unsatisfiable_short_circuits(rng):
    tgt, pats = _port_corpus(rng, n_pats=1)
    index = SubgraphIndex.build(tgt)
    bad = to_port(bump_edge_label(pats[0], 0, 9))
    svc = EnumerationService(index, config=CFG, device=CPU)  # not even started
    h = svc.submit(bad, collect=8)
    assert h.done  # answered at submit time, no queue slot, no engine
    assert h.result().matches == 0 and h.chunks() == []
    assert svc.stats()["unsat"] == 1
    assert svc.enumerator.cache_stats()["uploads"] == 0
    svc.stop()


def test_overflow_retry_reported_with_concurrent_inflight(rng):
    """Several in-flight queries whose stacks overflow: each rides the
    doubled-stack_cap retry, reports retries=1 in its terminal status, and
    still counts exactly like a roomy run."""
    tgt = to_port(random_graph(rng, 40, 120, n_labels=2))
    index = SubgraphIndex.build(tgt)
    bigs = [to_port(extract_connected_pattern(rng, tgt, 4)) for _ in range(3)]
    small = to_port(extract_connected_pattern(rng, tgt, 2))
    roomy = Enumerator(index, n_workers=2, expand_width=2, device=CPU)
    expected = {i: roomy.run(roomy.prepare(p)) for i, p in enumerate(bigs + [small])}
    svc = EnumerationService(
        index, config=EngineConfig(n_workers=2, expand_width=2, stack_cap=4), device=CPU,
        service=ServiceConfig(max_lanes=4, batch_window_s=0.001))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the retry warns
        with svc:
            handles = [svc.submit(p, tenant=f"t{i}", collect=0, timeout=30.0)
                       for i, p in enumerate(bigs + [small])]
            statuses = [h.status(timeout=240.0) for h in handles]
    for i, st in enumerate(statuses):
        assert st.ok
        assert st.matchset.matches == expected[i].matches
        assert st.retries == st.matchset.retries
    assert [st.retries for st in statuses[:3]] == [1, 1, 1], (
        "every overflowed in-flight query must report its retry"
    )
    assert statuses[3].retries == 0, "the small query must not report a retry"
    assert svc.stats()["retries"] == 3


def test_service_quota_and_backpressure(rng):
    tgt, pats = _port_corpus(rng, n_pats=1)
    svc = EnumerationService(
        SubgraphIndex.build(tgt), config=CFG, device=CPU,
        service=ServiceConfig(max_queue_depth=3, max_outstanding_per_tenant=2))
    # dispatcher not started: submissions stay queued deterministically
    svc.submit(pats[0], tenant="a")
    svc.submit(pats[0], tenant="a")
    with pytest.raises(QuotaExceeded):
        svc.submit(pats[0], tenant="a")
    svc.submit(pats[0], tenant="b")          # queue now full (depth 3)
    with pytest.raises(Backpressure):
        svc.submit(pats[0], tenant="c", timeout=0.01)
    stats = svc.stats()
    assert stats["rejected_quota"] == 1 and stats["rejected_backpressure"] == 1
    assert stats["queue_depth"] == 3
    svc.stop(drain=True)  # a draining stop executes what was admitted
    assert svc.stats()["completed"] == 3


def test_service_stop_without_drain_fails_pending(rng):
    tgt, pats = _port_corpus(rng, n_pats=1)
    svc = EnumerationService(SubgraphIndex.build(tgt), config=CFG, device=CPU)
    h = svc.submit(pats[0])
    svc.stop(drain=False)
    st = h.status(timeout=10.0)
    assert not st.ok and "stopped" in st.error
    with pytest.raises(ServiceError):
        h.result()
    assert svc.admission.outstanding("default") == 0  # the slot was released


def test_failed_pack_fails_its_streams_and_the_server_lives(rng):
    """An exception inside a dispatch fails that batch's streams with the
    error text (nothing re-runs them elsewhere); later batches run."""
    tgt, pats = _port_corpus(rng, n_pats=2)
    index = SubgraphIndex.build(tgt)
    svc = EnumerationService(index, config=CFG, device=CPU,
                             service=ServiceConfig(batch_window_s=0.0))
    real = svc.enumerator.run_pack
    calls = []

    def run_pack(queries, pack_size=None, cfg=None):
        calls.append(len(queries))
        if len(calls) == 1:
            raise RuntimeError("launch failed")
        return real(queries, pack_size=pack_size, cfg=cfg)

    svc.enumerator.run_pack = run_pack
    with svc:
        st = svc.submit(pats[0]).status(timeout=60.0)
        assert not st.ok and st.error == "RuntimeError: launch failed"
        ms = svc.submit(pats[1]).result(timeout=60.0)
    ref = Enumerator(index, config=CFG, device=CPU)
    assert _counters(ms) == _counters(ref.run(ref.prepare(pats[1])))
    stats = svc.stats()
    assert (stats["failed"], stats["completed"], calls) == (1, 1, [1, 1])


def test_unkeyable_request_fails_its_stream_and_the_server_lives(rng):
    """A budget far too small for the target makes the coalesce key raise
    (while it derives the partition count): the request's stream fails
    with the error and the dispatcher goes on (a later request is answered
    too)."""
    tgt, pat = _sparse_case(rng, n=60)
    svc = EnumerationService(SubgraphIndex.build(tgt), config=CFG, device=CPU,
                             service=ServiceConfig(batch_window_s=0.0, memory_budget_bytes=1))
    q = svc.enumerator.prepare(pat)
    with svc:
        first = svc.submit(q).status(timeout=60.0)
        second = svc.submit(q).status(timeout=60.0)
    assert not first.ok and first.error and first.error == second.error
    assert svc.stats()["failed"] == 2 and svc.admission.outstanding() == 0


def test_integration_mixed_dense_csr_clients(rng):
    """One service, step_backend='auto', 12 client threads with dense AND
    CSR-only queries in flight at once: the coalescer keeps the buckets
    apart while every client's streamed result stays bit-identical to a
    standalone run.  The dense bucket uploads its index once; the CSR-only
    queries carry no index and upload their own planes per pack."""
    dense_tgt, dense_pats = _port_corpus(rng, n_pats=8, n=50, m=160)
    sparse_tgt = to_port(random_graph(rng, 200, 420, n_labels=3))
    cfg = EngineConfig(**KW, step_backend="auto")
    index = SubgraphIndex.build(dense_tgt)
    queries = []
    for i in range(12):
        if i % 3 == 2:
            pat = to_port(extract_connected_pattern(rng, sparse_tgt, 3))
            queries.append(Query(pattern=pat, plan=build_csr_plan(pat, sparse_tgt, device=CPU),
                                 variant="ri", name=f"csr{i}", prepare_s=0.0))
        else:
            queries.append(None)  # dense: prepared by the service from the raw pattern
    svc = EnumerationService(index, config=cfg, device=CPU,
                             service=ServiceConfig(max_lanes=4, batch_window_s=0.005))
    ref = Enumerator(config=cfg, device=CPU)
    results = [None] * len(queries)
    errors = []

    def client(i):
        try:
            q = queries[i] if queries[i] is not None else dense_pats[i % len(dense_pats)]
            h = svc.submit(q, tenant=f"t{i % 4}", collect=16, timeout=30.0)
            results[i] = (h.result(timeout=240.0), h.mappings())
        except BaseException as e:
            errors.append(e)

    with svc:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(240.0)
    assert not errors, errors
    prep = Enumerator(index, config=cfg, device=CPU)
    prepared = [q if q is not None else prep.prepare(dense_pats[i % len(dense_pats)])
                for i, q in enumerate(queries)]
    n_buckets = len({prep.coalesce_key(q) for q in prepared})
    assert n_buckets >= 2, "dense and csr queries must occupy distinct buckets"
    versions = {q.index_fingerprint for q in prepared} - {""}
    assert svc.enumerator.cache_stats()["uploads"] == len(versions) == 1
    for (ms, maps), q in zip(results, prepared):
        one = ref.run(q, collect_matches=16)
        assert _counters(ms) == _counters(one)
        assert maps == one.mappings()
    stats = svc.stats()
    assert stats["completed"] == len(queries)
    assert stats["dispatches"] >= n_buckets


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port: metrics
# ---------------------------------------------------------------------------

def test_latency_window_empty_and_single():
    w = metrics_mod.LatencyWindow(cap=8)
    assert len(w) == 0
    assert w.percentile(50) == w.percentile(99) == w.mean() == w.max() == 0.0
    w.record(0.25)
    for p in (0, 50, 99, 100):
        assert w.percentile(p) == 0.25
    assert w.mean() == 0.25 and w.max() == 0.25


def test_latency_window_nearest_rank_exact():
    w = metrics_mod.LatencyWindow(cap=16)
    for v_ in (5.0, 1.0, 3.0, 2.0, 4.0):  # sorted: [1..5]
        w.record(v_)
    assert w.percentile(50) == 2.0
    assert w.percentile(90) == 4.0
    assert w.percentile(99) == 5.0
    assert w.percentile(0) == 1.0
    assert w.percentile(100) == 5.0


def test_latency_window_wraparound_keeps_most_recent():
    w = metrics_mod.LatencyWindow(cap=100)
    for v_ in range(250):
        w.record(float(v_))
    assert len(w) == 100            # retained: [150.0 .. 249.0]
    assert w.max() == 249.0
    assert w.mean() == (150.0 + 249.0) / 2
    assert w.percentile(50) == 199.0
    assert w.percentile(99) == 248.0
    assert w.percentile(100) == 249.0


def test_service_metrics_concurrent_record():
    m = metrics_mod.ServiceMetrics(window=4096)
    n_threads, per_thread = 8, 400

    def observer(tid):
        for i in range(per_thread):
            m.observe_queue_wait(0.001 * tid)
            m.observe_completion(1.0, retries=(i % 2), ok=(i % 10 != 0))
            m.inc("submitted")

    threads = [threading.Thread(target=observer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = n_threads * per_thread
    snap = m.snapshot()
    assert snap["submitted"] == total
    assert snap["completed"] + snap["failed"] == total
    assert snap["failed"] == n_threads * (per_thread // 10)
    assert snap["retries"] == n_threads * (per_thread // 2)
    assert snap["latency_p50_s"] == 1.0 and snap["latency_max_s"] == 1.0
    assert snap["qps"] >= 0.0


def test_snapshot_schema_stable_and_formats():
    m = metrics_mod.ServiceMetrics()
    snap = m.snapshot()
    for name in metrics_mod.COUNTERS:
        assert name in snap
    assert "warmup_uploads" in snap and "warmup_compiles" not in snap
    assert isinstance(metrics_mod.format_snapshot(snap), str)
    full = m.snapshot(cache=dict(uploads=2, cache_hits=6, evictions=0, entries=2))
    assert full["cache_hit_rate"] == 0.75
    assert "uploads=2" in metrics_mod.format_snapshot(full)


# ---------------------------------------------------------------------------
# warm-up: uploads move to start(), first dispatches upload nothing
# ---------------------------------------------------------------------------

def test_warmup_profile_uploads_at_start(rng):
    """ServiceConfig.warmup_profile warms the dispatch shape during
    start(); the first real submits then upload nothing new."""
    tgt, pats = _port_corpus(rng, n_pats=3)
    svc = EnumerationService(
        SubgraphIndex.build(tgt), config=CFG, device=CPU,
        service=ServiceConfig(max_lanes=4, batch_window_s=0.001, warmup_profile=tuple(pats)))
    with svc:
        warm_spent = svc.stats()["warmup_uploads"]
        assert warm_spent >= 1
        uploads = svc.enumerator.cache_stats()["uploads"]
        handles = [svc.submit(p) for p in pats]
        for h in handles:
            assert h.result(timeout=240.0).states >= 0
        assert svc.enumerator.cache_stats()["uploads"] == uploads
        assert svc.stats()["warmup_uploads"] == warm_spent
    with svc:  # start() is idempotent: re-entering does not re-warm
        assert svc.stats()["warmup_uploads"] == warm_spent


def _sparse_case(rng, n=120):
    tgt = to_port(power_law_target(rng, n, avg_deg=3.0, n_labels=6))
    return tgt, to_port(extract_connected_pattern(rng, tgt, 4))


@pytest.mark.parametrize("backend_kw,fresh", (
    (dict(step_backend="csr"), 1),
    # a partitioned run streams its partitions and uses no session upload
    (dict(step_backend="partitioned", n_partitions=2), 0),
))
def test_warm_spends_uploads_upfront(rng, backend_kw, fresh):
    """Enumerator.warm() pays the upload at warm-up; the run after it
    uploads nothing, and a second warm is free."""
    tgt, pat = _sparse_case(rng)
    s = Enumerator(SubgraphIndex.build(tgt), n_workers=2, expand_width=2, device=CPU,
                   **backend_kw)
    q = s.prepare(pat)
    assert s.warm([q]) == {"warmed": 1, "uploads": fresh}
    uploads = s.cache_info()["uploads"]
    assert s.run(q).states > 0
    assert s.cache_info()["uploads"] == uploads
    assert s.warm([q]) == {"warmed": 1, "uploads": 0}  # already warm


def test_warm_pack_lanes_covers_dispatch_width(rng):
    """warm(lanes=N) warms the pack shape run_pack uses, so a warmed
    service's first dispatch uploads nothing."""
    tgt, _ = _sparse_case(rng)
    pats = [to_port(extract_connected_pattern(rng, tgt, 4)) for _ in range(3)]
    s = Enumerator(SubgraphIndex.build(tgt), n_workers=2, expand_width=2, device=CPU)
    qs = [s.prepare(p) for p in pats]
    assert s.warm(qs, lanes=4) == {"warmed": 3, "uploads": 1}
    uploads = s.cache_info()["uploads"]
    s.run_pack(qs, pack_size=4)
    assert s.cache_info()["uploads"] == uploads


def test_warm_skips_unsatisfiable(rng):
    from repro_torch.core.graph import Graph

    tgt = to_port(random_graph(rng, 20, 40, n_labels=2))
    bad = Graph.from_edges(2, [(0, 1)], labels=[7, 0], undirected=True)
    s = Enumerator(SubgraphIndex.build(tgt), n_workers=2, expand_width=2, device=CPU)
    q = s.prepare(bad)
    assert not q.plan.satisfiable
    assert s.warm([q]) == {"warmed": 0, "uploads": 0}


def test_warm_raw_patterns_and_launches_nothing_on_the_cpu(rng):
    """Raw patterns are prepared in one batch; on the CPU warm loads no
    kernel library and launches no kernel."""
    tgt, pats = _port_corpus(rng, n_pats=3)
    s = Enumerator(SubgraphIndex.build(tgt), device=CPU, step_backend="pallas",
                   use_pallas=True, collect_matches=8, **KW)
    loaded = dict(_build._launchers)
    ops.reset_launch_counts()
    assert s.warm(pats, collect_matches=8, lanes=2) == {"warmed": 3, "uploads": 1}
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    assert _build._launchers == loaded


@pytest.mark.parametrize("kw,sparse,want", [
    (dict(step_backend="pallas"), False, ("extend_step",)),
    (dict(step_backend="jnp", use_pallas=True), False, ("candidate_mask",)),
    (dict(step_backend="jnp"), False, ()),
    (dict(step_backend="auto", use_pallas=True), False, ("candidate_mask",)),
    (dict(step_backend="auto", use_pallas=True), True, ("csr_extend_bucketed",)),
    (dict(step_backend="csr", use_pallas=True, csr_walk="flat"), True, ("csr_extend",)),
    (dict(step_backend="csr"), True, ()),
    (dict(step_backend="partitioned", use_pallas=True, csr_walk="flat"), True, ("csr_extend",)),
])
def test_step_kernels_name_what_the_step_launches(rng, kw, sparse, want):
    """The libraries warm() loads on a card are those of the kernels the
    resolved step launches: on the CPU, wrapping the kernel entry points
    shows which of them a run calls."""
    tgt, pat = _sparse_case(rng, n=60)
    s = Enumerator(SubgraphIndex.build(tgt, sparse=sparse), device=CPU, variant="ri", **KW,
                   **kw)
    q = s.prepare(pat)
    assert extend.step_kernels(s.config, q.plan) == want
    called = set()
    names = ("extend_step", "candidate_mask", "csr_extend", "csr_extend_bucketed")
    real = {n: getattr(ops, n) for n in names}

    def wrap(name):
        def fn(*a, **k):
            called.add(name)
            return real[name](*a, **k)
        return fn

    try:
        for n in names:
            setattr(ops, n, wrap(n))
        s.run(q)
    finally:
        for n in names:
            setattr(ops, n, real[n])
    assert called == set(want)


# ---------------------------------------------------------------------------
# the session's upload cache: bound, evictions, lock
# ---------------------------------------------------------------------------

def test_max_cache_entries_bounds_uploads_per_layout(rng):
    tgt, pat = _dense(rng)
    tgt, pat = to_port(tgt), to_port(pat)
    with pytest.raises(ValueError, match="max_cache_entries"):
        Enumerator(SubgraphIndex.build(tgt), device=CPU, max_cache_entries=-1)
    for bound, kept in ((0, 2), (1, 1), (3, 3)):
        idx = SubgraphIndex.build(tgt)
        s = Enumerator(idx, device=CPU, max_cache_entries=bound, **KW)
        for _ in range(4):
            s.run(s.prepare(pat, index=idx))
            idx, _ = idx.update(add_edges=_sample_edits(rng, tgt, k_add=1, k_rem=0)[0])
        st = s.cache_stats()
        assert st == dict(uploads=4, cache_hits=0, evictions=4 - kept, entries=kept,
                          max_entries=bound)
    assert isinstance(s._cache_lock, type(threading.Lock()))


def test_upload_cache_lock_under_thread_stress(rng):
    """More threads than cores, a short switch interval: uploads, hits,
    evictions and drops race on one session.  With the lock, every upload
    is still an entry, evicted or dropped, and every lookup is an upload
    or a hit."""
    import sys

    tgt, _ = _dense(rng)
    index = SubgraphIndex.build(to_port(tgt))
    s = Enumerator(index, device=CPU, max_cache_entries=2, **KW)
    n_threads, rounds = 16, 150
    dropped, errors = [], []

    def worker(t):
        try:
            for i in range(rounds):
                s._adjacency_rows(f"v{(t + i) % 5}", index.packed.adj_bits)
                if i % 7 == t % 7:
                    dropped.append(s.invalidate_index(f"v{i % 5}"))
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    st = s.cache_stats()
    assert st["entries"] <= 2
    assert st["uploads"] == st["entries"] + st["evictions"] + sum(dropped)
    assert st["uploads"] + st["cache_hits"] == n_threads * rounds


def test_service_update_index(rng):
    """The service swaps index versions live: queries submitted after
    update_index() run against the new content, metrics record the swap,
    and the retired version's uploads are dropped."""
    tgt, pat = _dense(rng)
    adds, rems = _sample_edits(rng, tgt, k_add=4, k_rem=3)
    tgt, pat = to_port(tgt), to_port(pat)
    want_old = len(ref_node_mappings(pat, tgt))
    want_new = len(ref_node_mappings(pat, apply_delta(tgt, adds, rems)))
    svc = EnumerationService(SubgraphIndex.build(tgt), n_workers=2, expand_width=2,
                             device=CPU, service=ServiceConfig(batch_window_s=0.0))
    with svc:
        assert svc.submit(pat).result(timeout=60.0).matches == want_old
        delta = svc.update_index(add_edges=adds, remove_edges=rems)
        assert not delta.is_empty
        assert svc.submit(pat).result(timeout=60.0).matches == want_new
        # degenerate edit: counted, but nothing swapped
        assert svc.update_index(add_edges=[adds[0]]).is_empty
    stats = svc.stats()
    assert stats["index_updates"] == 2
    assert stats["cache_invalidated"] >= 1


def test_concurrent_updates_and_sparse_prepares_during_dispatch(rng):
    """Client threads update the dense index, prepare batches on each new
    version and prepare CSR-only queries on a sparse index (the device
    fixpoint) while the dispatcher runs packs: every result equals a
    standalone run, and the upload cache stays consistent (entries within
    the bound; every upload is still an entry, evicted or dropped)."""
    dense, pats = _port_corpus(rng, n_pats=4, n=40, m=120)
    sparse, spat = _sparse_case(rng, n=80)
    sparse_idx = SubgraphIndex.build(sparse, sparse=True)
    spats = [spat] + [to_port(extract_connected_pattern(rng, sparse, 3)) for _ in range(3)]
    cfg = EngineConfig(**KW, step_backend="auto")
    svc = EnumerationService(SubgraphIndex.build(dense), config=cfg, device=CPU,
                             variant="ri-ds-si-acfc",
                             service=ServiceConfig(max_lanes=2, batch_window_s=0.001))
    served, errors = [], []
    lock = threading.Lock()

    def updater():
        try:
            for k in range(3):
                adds, rems = _sample_edits(rng_u, dense, k_add=3, k_rem=2)
                svc.update_index(add_edges=adds, remove_edges=rems)
                qs = svc.enumerator.prepare_batch(pats, index=svc.enumerator.index)
                collect = 8 * (k % 2)
                hs = [svc.submit(q, tenant="u", collect=collect) for q in qs]
                got = [(q, h.result(timeout=120.0), collect, h.mappings())
                       for q, h in zip(qs, hs)]
                with lock:
                    served.extend(got)
        except BaseException as e:
            errors.append(e)

    def sparse_client(c):
        try:
            for p in spats[c::2]:
                q = svc.enumerator.prepare(p, index=sparse_idx)
                h = svc.submit(q, tenant=f"s{c}", collect=0)
                with lock:
                    served.append((q, h.result(timeout=120.0), 0, []))
        except BaseException as e:
            errors.append(e)

    rng_u = np.random.default_rng(17)
    with svc:
        threads = ([threading.Thread(target=updater)]
                   + [threading.Thread(target=sparse_client, args=(c,)) for c in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(240.0)
    assert not errors, errors
    assert len(served) == 3 * len(pats) + len(spats)
    ref = Enumerator(config=cfg, device=CPU)
    for q, ms, collect, maps in served:
        one = ref.run(q, collect_matches=collect)
        assert _counters(ms) == _counters(one)
        if collect:
            assert maps == one.mappings()
    st, stats = svc.enumerator.cache_stats(), svc.stats()
    assert st["entries"] <= 2 * 2  # two layouts, two uploads each
    assert st["uploads"] == st["entries"] + st["evictions"] + stats["cache_invalidated"]
    assert stats["completed"] == len(served) and stats["index_updates"] == 3


# ---------------------------------------------------------------------------
# the command-line entry point (tests/test_system.py's smoke)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [["--no-csr"], ["--use-pallas"]], ids=["dense", "csr-kernels"])
def test_serve_cli_smoke(extra, capsys):
    """The service entry point: synthetic clients through one
    EnumerationService, streamed results verified against standalone runs
    inside the entry point itself."""
    from repro_torch.launch.serve import main

    assert main(["--smoke", "--clients", "2", "--queries", "2", "--target-n", "36",
                 "--window-ms", "1", "--device", "cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert "verified OK" in out and "device=cpu" in out


def test_service_entry_points_default_to_the_card(rng):
    tgt, pats = _port_corpus(rng, n_pats=1)
    if torch.cuda.is_available():
        assert EnumerationService(SubgraphIndex.build(tgt)).enumerator.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnumerationService(SubgraphIndex.build(tgt))
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke"])


def test_service_config_parity_of_fields():
    """The port's ServiceConfig has repro's fields; only the upload-cache
    bound's default differs (an entry is a whole target on the device)."""
    port = {f.name: f.default for f in dataclasses.fields(ServiceConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxServiceConfig)}
    assert set(port) == set(ref)
    assert {k for k in port if port[k] != ref[k]} == {"max_cache_entries"}
