"""Multi-device work stealing and the paper's driver: the port against the
JAX package, on the CPU.

The port shards a query's worker stacks over a tuple of devices
(`repro_torch.core.engine.Mesh`); here the shards are CPU shards, the
counterpart of ``repro``'s forced host devices (``tests/test_sharded.py``).

* engine: ``run(plan, cfg, mesh=D)`` for D in 1, 2, 4 equals the port's
  unsharded run and ``repro``'s ``eng.run`` on every counter, every
  ``per_worker_*`` and the match buffer, on the plain, ``use_pallas``,
  fused and CSR (flat and bucketed) steps, vertex- and edge-seeded;
* D = 1 against ``repro``'s own sharded path (a one-device ``jax`` mesh),
  the partitioned mesh included, on every counter and ``stats`` key;
* D > 1 against ``repro`` run in a subprocess with four forced host
  devices: dense and csr at D = 2 and 4, and the partitioned mesh at D = 2,
  whose shard-local steals change the counters with D;
* sessions: ``Enumerator(mesh=)`` coercion, snapping and errors,
  ``mesh_signature``, packs, streams, ``warm`` and ``run_delta`` under a mesh;
* the driver ``repro_torch.launch.sge_run`` against
  ``repro.launch.sge_run`` in each mode, sparse, partitioned and sharded.

Counters are integers: exact equality.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core.plan import PLAN_ARRAY_FIELDS, plan_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.test_backend_conformance import CASES  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
KW = dict(n_workers=8, expand_width=2, collect_matches=64)
# the port's step paths: the plain step, the candidate_mask twin, the fused
# step's twin, and the CSR walk's twins (flat and bucketed)
PATHS = {
    "jnp": dict(step_backend="jnp"),
    "jnp+use_pallas": dict(step_backend="jnp", use_pallas=True),
    "pallas": dict(step_backend="pallas"),
    "csr bucketed": dict(step_backend="csr", use_pallas=True),
    "csr flat": dict(step_backend="csr", csr_walk="flat"),
}
SHARDS = (1, 2, 4)
RESULT_FIELDS = ("matches", "states", "steps", "steals", "steal_rounds")
PER_WORKER = ("per_worker_states", "per_worker_matches", "per_worker_steals")


def _plans(case, seed=0, **kw):
    """``repro``'s plan of a conformance case and the same plan in the port."""
    tgt, pat = CASES[case](np.random.default_rng(seed))
    jplan = jax_build_plan(pat, JaxPacked.from_graph(tgt), **kw)
    return jplan, plan_from_numpy({f: getattr(jplan, f) for f in PLAN_ARRAY_FIELDS})


def _assert_same(got, want, what=""):
    assert tuple(getattr(got, f) for f in RESULT_FIELDS) == tuple(
        getattr(want, f) for f in RESULT_FIELDS), what
    for f in PER_WORKER:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f"{what} {f}")


def _assert_buffers_equal(got, want, what=""):
    a, b = np.asarray(got.match_buf), np.asarray(want.match_buf)
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=what)


# ---------------------------------------------------------------------------
# the engine at D = 1, 2, 4 against the unsharded run and repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "selfloops", "edge_labels"])
def test_sharded_engine_matches_unsharded_and_repro(case):
    jplan, plan = _plans(case)
    want = jax_eng.run(jplan, JaxConfig(**KW))
    for label, kw in PATHS.items():
        cfg = EngineConfig(**KW, **kw)
        single = eng.run(plan, cfg, device=CPU)
        _assert_same(single, want, label)
        _assert_buffers_equal(single, want, label)
        for d in SHARDS:
            got = eng.run(plan, cfg, mesh=d, device=CPU)
            _assert_same(got, single, f"{label} D={d}")
            _assert_buffers_equal(got, single, f"{label} D={d}")


@pytest.mark.parametrize("label", ["jnp", "csr flat", "csr bucketed"])
def test_sharded_edge_seeding_matches_repro(label):
    """Edge-seeded depth-1 roots shard unchanged (``repro``'s
    ``test_mesh_edge_seeding_conformance``), with more steals than workers."""
    jplan, plan = _plans("dense", seed=3, seed_edge="auto")
    kw = dict(KW, root_seeding="edge")
    want = jax_eng.run(jplan, JaxConfig(**kw))
    assert want.steals > 0
    single = eng.run(plan, EngineConfig(**kw, **PATHS[label]), device=CPU)
    _assert_same(single, want, label)
    for d in SHARDS:
        got = eng.run(plan, EngineConfig(**kw, **PATHS[label]), mesh=d, device=CPU)
        _assert_same(got, want, f"{label} D={d}")
        _assert_buffers_equal(got, single, f"{label} D={d}")


def test_sharded_sparse_case_walks_agree():
    """Flat and bucketed walks agree under a mesh on the power-law case
    (``repro``'s ``test_mesh_bucketed_walk_conformance``)."""
    _, plan = _plans("sparse_power_law")
    cfg = EngineConfig(n_workers=4, expand_width=2, step_backend="csr")
    want = eng.run(plan, cfg, device=CPU)
    for d in (2, 4):
        for walk in ("flat", "bucketed"):
            got = eng.run(plan, EngineConfig(n_workers=4, expand_width=2, step_backend="csr",
                                             csr_walk=walk), mesh=d, device=CPU)
            _assert_same(got, want, f"{walk} D={d}")


def test_sharded_steal_round_entry_for_entry():
    """One sharded steal round leaves every stack tensor and counter as the
    unsharded round does (on stacks taken mid-run, with transfers)."""
    _, plan = _plans("dense", seed=3)
    cfg = EngineConfig(n_workers=8, expand_width=2)
    arrays = eng.plan_arrays_for(cfg, [plan], CPU)
    st = eng.init_state(plan, cfg, CPU)
    expand = eng.make_expand_fn(cfg, arrays)
    moved = 0
    for _ in range(6):
        st = expand(st)
        for d in (2, 4):
            mesh = eng.coerce_mesh(d, CPU)
            got = eng.gather_state(eng._steal_round_sharded(cfg, eng.shard_state(st, mesh)))
            want = eng._steal_round(cfg, eng.EngineState(*(x.clone() for x in st)))
            for name, a, b in zip(eng.EngineState._fields, got, want):
                assert torch.equal(a, b), f"{name} D={d}"
        st = eng._steal_round(cfg, st)
        moved += int(st.steals.sum())
    assert moved > 0


def test_shard_and_gather_round_trip():
    _, plan = _plans("dense")
    cfg = EngineConfig(n_workers=8, expand_width=2, collect_matches=4)
    st = eng.init_state(plan, cfg, CPU)
    mesh = eng.coerce_mesh(4, CPU)
    shards = eng.shard_state(st, mesh)
    assert all(s.size.shape == (1, 2) for s in shards)
    assert all(s.st_cand.is_contiguous() for s in shards)
    # shards own their storage: writing one leaves the state unchanged
    shards[1].st_cand.fill_(7)
    assert not torch.equal(st.st_cand[:, 2:4], shards[1].st_cand)
    shards = eng.shard_state(st, mesh)
    for name, a, b in zip(eng.EngineState._fields, eng.gather_state(shards), st):
        assert torch.equal(a, b), name
    spill = eng.frontier.init_spill_state(8, 16, plan.p_pad, plan.w, CPU)
    back = eng.gather_spill(eng.shard_spill(spill, mesh))
    for name, a, b in zip(eng.SpillState._fields, back, spill):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# D = 1 against repro's sharded path
# ---------------------------------------------------------------------------

def _jax_mesh1():
    return jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])


@pytest.mark.parametrize("label", ["jnp", "csr bucketed"])
def test_one_shard_matches_repro_mesh(label):
    jplan, plan = _plans("dense")
    kw = dict(KW, step_backend=PATHS[label]["step_backend"])
    want = jax_eng.run(jplan, JaxConfig(**kw), mesh=_jax_mesh1())
    got = eng.run(plan, EngineConfig(**kw), mesh=1, device=CPU)
    _assert_same(got, want, label)
    _assert_buffers_equal(got, want, label)


@pytest.mark.parametrize("seeding", ["vertex", "edge"])
def test_one_shard_partitioned_matches_repro_mesh(seeding):
    jplan, plan = _plans("sparse_power_law", seed_edge="auto" if seeding == "edge" else None)
    kw = dict(n_workers=4, expand_width=2, n_partitions=2, step_backend="partitioned",
              root_seeding=seeding)
    jstats, stats = {}, {}
    want = jax_eng.run_partitioned(jplan, JaxConfig(**kw), mesh=_jax_mesh1(), stats=jstats)
    got = eng.run_partitioned(plan, EngineConfig(**kw), mesh=1, device=CPU, stats=stats)
    _assert_same(got, want, seeding)
    assert stats == jstats


# ---------------------------------------------------------------------------
# D > 1 against repro on four forced host devices (a subprocess)
# ---------------------------------------------------------------------------

# (case, config keywords, devices, partitions or 0) of the subprocess runs
MULTI_RUNS = [
    ("dense", dict(step_backend="jnp"), 2, 0),
    ("dense", dict(step_backend="jnp"), 4, 0),
    ("dense", dict(step_backend="csr"), 2, 0),
    ("dense", dict(step_backend="csr"), 4, 0),
    ("dense", dict(step_backend="partitioned", n_partitions=2), 2, 2),
    ("sparse_power_law", dict(step_backend="partitioned", n_partitions=2), 2, 2),
]
MULTI_KW = dict(n_workers=8, expand_width=2, collect_matches=64)
MULTI_SEED = 3

_MULTI_SCRIPT = r"""
import json, sys
import jax
import numpy as np
from repro.core import EngineConfig
from repro.core import engine as eng
from repro.core.graph import PackedGraph
from repro.core.plan import build_plan
from tests.test_backend_conformance import CASES

runs, base, seed = json.loads(sys.argv[1])
out = []
for case, kw, d, parts in runs:
    tgt, pat = CASES[case](np.random.default_rng(seed))
    plan = build_plan(pat, PackedGraph.from_graph(tgt))
    mesh = jax.make_mesh((d,), ("data",), devices=jax.devices()[:d])
    cfg = EngineConfig(**base, **kw)
    stats = {}
    if parts:
        r = eng.run_partitioned(plan, cfg, mesh=mesh, stats=stats)
    else:
        r = eng.run(plan, cfg, mesh=mesh)
    out.append(dict(
        counters=[int(getattr(r, f)) for f in ("matches", "states", "steps", "steals",
                                                  "steal_rounds")],
        per_worker=[np.asarray(getattr(r, f)).astype(int).tolist() for f in (
            "per_worker_states", "per_worker_matches", "per_worker_steals")],
        match_buf=np.asarray(r.match_buf).astype(np.int64).tolist(),
        stats=stats))
print(json.dumps(out))
"""


def test_multi_shard_matches_repro_on_forced_devices():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = json.dumps([MULTI_RUNS, MULTI_KW, MULTI_SEED])
    proc = subprocess.run([sys.executable, "-c", _MULTI_SCRIPT, arg], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    wants = json.loads(proc.stdout.strip().splitlines()[-1])
    by_run = {}
    for (case, kw, d, parts), want in zip(MULTI_RUNS, wants):
        _, plan = _plans(case, seed=MULTI_SEED)
        stats = {}
        cfg = EngineConfig(**MULTI_KW, **kw)
        if parts:
            got = eng.run_partitioned(plan, cfg, mesh=d, device=CPU, stats=stats)
        else:
            got = eng.run(plan, cfg, mesh=d, device=CPU)
        by_run[(case, d, parts)] = got
        what = f"{case} {kw} D={d}"
        assert [getattr(got, f) for f in RESULT_FIELDS] == want["counters"], what
        assert [np.asarray(getattr(got, f)).tolist() for f in PER_WORKER] == \
            want["per_worker"], what
        assert np.asarray(got.match_buf).tolist() == want["match_buf"], what
        assert stats == want["stats"], what
    # the partitioned mesh steals within each shard, so D changes its
    # schedule, never its matches
    changed = False
    for case in ("dense", "sparse_power_law"):
        _, plan = _plans(case, seed=MULTI_SEED)
        one = eng.run_partitioned(plan, EngineConfig(
            **MULTI_KW, step_backend="partitioned", n_partitions=2), mesh=1, device=CPU)
        two = by_run[(case, 2, 2)]
        assert (one.matches, one.states) == (two.matches, two.states)
        changed |= (one.steps, one.steals) != (two.steps, two.steals)
    assert changed


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

def _session_case(seed=0):
    tgt, pat = CASES["dense"](np.random.default_rng(seed))
    return SubgraphIndex.build(to_port(tgt)), to_port(pat), tgt, pat


def test_session_mesh_int_coercion_and_snapping():
    idx, _, _, _ = _session_case()
    s = Enumerator(idx, n_workers=4, expand_width=2, mesh=1, device=CPU)
    assert s.mesh is not None and s.mesh.size == 1 and s.config.n_workers == 4
    s = Enumerator(idx, n_workers=7, expand_width=2, mesh=2, device=CPU)
    assert s.config.n_workers == 8  # snapped up to a multiple of the mesh
    s = Enumerator(idx, n_workers=4, mesh=3, device=CPU)
    assert s.config.n_workers == 6 and s.mesh.devices == (torch.device(CPU),) * 3
    s = Enumerator(idx, n_workers=4, mesh=eng.Mesh((CPU, CPU)))
    assert s.device == torch.device(CPU)  # a Mesh names the session's device
    assert Enumerator(idx, device=CPU).mesh is None
    # more cards than the machine has: an error naming the count, no fallback
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} CUDA card"):
        eng.coerce_mesh(n + 1, "cuda")
    if n:
        with pytest.raises(ValueError, match=f"only {n} CUDA card"):
            Enumerator(idx, mesh=n + 1)


def test_session_mesh_errors():
    idx, _, _, _ = _session_case()
    for bad in ("2", 2.0, [CPU]):
        with pytest.raises(TypeError, match="mesh must be"):
            Enumerator(idx, mesh=bad, device=CPU)
    with pytest.raises(ValueError, match="first device"):
        Enumerator(idx, mesh=eng.Mesh(("meta", CPU)), device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        Enumerator(idx, mesh=0, device=CPU)
    with pytest.raises(ValueError, match="not divisible"):
        eng.make_sharded_engine_fn(EngineConfig(n_workers=3), eng.coerce_mesh(2, CPU))
    with pytest.raises(ValueError, match="not divisible"):
        eng.make_partitioned_engine_fn(EngineConfig(n_workers=3), eng.coerce_mesh(2, CPU))


def test_mesh_signature_distinguishes_sessions():
    idx, pat, _, _ = _session_case()
    a = Enumerator(idx, n_workers=8, expand_width=4, mesh=1, device=CPU)
    b = Enumerator(idx, n_workers=8, expand_width=4, mesh=2, device=CPU)
    assert eng.mesh_signature(a.mesh) != eng.mesh_signature(b.mesh)
    assert eng.mesh_signature(b.mesh) == eng.mesh_signature(eng.coerce_mesh(2, CPU))
    assert eng.mesh_signature(None) is None
    assert eng.mesh_signature(b.mesh) == (("data",), (2,), ("cpu", "cpu"))
    assert eng.mesh_worker_axis(b.mesh) == "data"
    assert a.run(a.prepare(pat)).matches == b.run(b.prepare(pat)).matches


def _ms_counters(ms):
    return (ms.matches, ms.states, ms.steps, ms.steals, ms.steal_rounds,
            ms.per_worker_states.tolist(), ms.per_worker_matches.tolist(),
            ms.per_worker_steals.tolist(), ms.retries)


@pytest.mark.parametrize("backend,d", [("jnp", 2), ("jnp", 4), ("csr", 2)])
def test_session_batch_stream_and_warm_under_a_mesh(backend, d):
    idx, _, tgt, _ = _session_case(seed=3)
    rng = np.random.default_rng(5)
    from tests.conftest import extract_connected_pattern
    pats = [to_port(extract_connected_pattern(rng, tgt, k)) for k in (3, 4, 5, 4)]
    kw = dict(n_workers=8, expand_width=2, step_backend=backend, use_pallas=True)
    base = Enumerator(idx, device=CPU, **kw)
    want = [base.run(base.prepare(p, name=f"q{i}")) for i, p in enumerate(pats)]
    s = Enumerator(idx, device=CPU, mesh=d, **kw)
    qs = [s.prepare(p, name=f"q{i}") for i, p in enumerate(pats)]
    assert s.warm(qs, lanes=4) == {"warmed": 4, "uploads": 1}
    assert s.warm(qs) == {"warmed": 4, "uploads": 0}
    single = [s.run(q) for q in qs]
    batch = s.run_batch(qs, pack_size=2)
    streamed = sorted(s.stream(qs, pack_size=2), key=lambda m: m.query_index)
    packed = s.run_pack(qs[:2], pack_size=2)
    assert [m.query_index for m in batch] == [0, 1, 2, 3]
    assert [m.query_index for m in streamed] == [0, 1, 2, 3]
    for i, w in enumerate(want):
        for got in (single[i], batch[i], streamed[i]) + tuple(packed[i:i + 1]):
            assert _ms_counters(got) == _ms_counters(w), i
    assert s.run(qs[3]).mappings() == want[3].mappings()
    assert s.cache_stats()["uploads"] == 1  # one upload, one replica per device


def test_session_partitioned_under_a_mesh():
    idx, pat, _, _ = _session_case(seed=3)
    kw = dict(n_workers=8, expand_width=2, step_backend="partitioned", n_partitions=2)
    base = Enumerator(idx, device=CPU, step_backend="csr", n_workers=8, expand_width=2)
    want = base.run(base.prepare(pat), collect_matches=64)
    s = Enumerator(idx, device=CPU, mesh=2, **kw)
    q = s.prepare(pat)
    assert s.warm([q])["warmed"] == 1
    got = s.run(q, collect_matches=64)
    assert (got.matches, got.states) == (want.matches, want.states)
    assert sorted(got.mappings()) == sorted(want.mappings())
    one = Enumerator(idx, device=CPU, mesh=1, **kw).run(q)
    ref = eng.run_partitioned(q.plan, EngineConfig(**kw), mesh=1, device=CPU)
    _assert_same(one.engine, ref)
    assert [m.matches for m in s.run_batch([q, q])] == [want.matches] * 2


def test_run_delta_under_a_mesh():
    """``run_delta`` on a sharded session equals the unsharded session's
    (``tests/test_incremental_conformance.py``'s mesh delta)."""
    idx0, pat, tgt, _ = _session_case(seed=3)
    arcs = [(int(u), int(v), int(l)) for u, v, l in zip(tgt.src, tgt.dst, tgt.edge_labels)]
    # the edit re-inserts arcs an earlier edit removed, so it adds matches
    idx, _ = idx0.update(remove_edges=arcs[:12])
    new_idx, delta = idx.update(add_edges=arcs[:12], remove_edges=arcs[12:20])
    assert delta.added and delta.removed
    results = []
    for mesh in (None, 2, 4):
        s = Enumerator(idx, device=CPU, mesh=mesh, n_workers=8, expand_width=2,
                       step_backend="jnp", use_pallas=True)
        old = s.run(s.prepare(pat), collect_matches=256)
        dm = s.run_delta(s.prepare(pat, index=new_idx), old, delta)
        results.append((sorted(dm.added), sorted(dm.removed), dm.n_seeds, dm.n_anchors))
    assert results[1] == results[0] and results[2] == results[0]
    assert results[0][0] and results[0][1]


def test_engine_routes_meshes():
    """``run(mesh=)`` routes the partitioned backend to ``run_partitioned``
    and other backends to ``run_sharded``; no mesh is refused."""
    jplan, plan = _plans("dense")
    kw = dict(n_workers=4, expand_width=2)
    got = eng.run(plan, EngineConfig(step_backend="partitioned", n_partitions=2, **kw),
                  mesh=2, device=CPU)
    want = eng.run_partitioned(plan, EngineConfig(n_partitions=2, **kw), mesh=2, device=CPU)
    _assert_same(got, want)
    mesh = eng.coerce_mesh(2, CPU)
    _assert_same(eng.run(plan, EngineConfig(**kw), mesh=mesh, device=CPU),
                 eng.run_sharded(plan, EngineConfig(**kw), mesh))
    ops.reset_launch_counts()
    eng.run(plan, EngineConfig(step_backend="pallas", **kw), mesh=2, device=CPU)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)  # CPU: plain versions


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

LINE = re.compile(r"^(\S+)\s+matches=(\d+)\s+states=(\d+)\s+steps=(\d+)(?:\s+steals=(\d+))?")
TOTAL = re.compile(r"(\d+) queries, (\d+) matches, (\d+) states")
DRIVER = ["--collection", "pdbsv1-like", "--scale", "0.01", "--workers", "4"]


def _parse(out: str):
    per_query = {}
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            per_query[m.group(1)] = tuple(int(x) for x in m.groups()[1:] if x is not None)
    total = TOTAL.search(out)
    return per_query, tuple(int(x) for x in total.groups())


def _run_port(argv, capsys):
    from repro_torch.launch import sge_run

    assert sge_run.main(argv + ["--device", CPU]) == 0
    return capsys.readouterr().out


def _run_repro(argv, capsys, monkeypatch):
    from repro.launch import sge_run as jax_sge_run

    monkeypatch.setattr(sys, "argv", ["sge_run"] + argv)
    assert jax_sge_run.main() == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    pytest.param(["--mode", "single"], id="single"),
    pytest.param(["--mode", "packed"], id="packed"),
    pytest.param(["--mode", "stream"], id="stream"),
    pytest.param(["--sparse-index", "--step-backend", "csr", "--variant", "ri-ds-si-acfc"],
                 id="sparse-csr"),
    pytest.param(["--partitions", "2"], id="partitions"),
])
def test_driver_matches_repro(extra, capsys, monkeypatch):
    port = _run_port(DRIVER + extra + ["--use-pallas"], capsys)
    want = _run_repro(DRIVER + extra, capsys, monkeypatch)
    got_q, got_t = _parse(port)
    want_q, want_t = _parse(want)
    assert len(got_q) == got_t[0] > 0
    assert got_q == want_q and got_t == want_t
    assert "engine uploads=" in port


def test_driver_devices_matches_repro(capsys, monkeypatch):
    port = _run_port(DRIVER + ["--devices", "2"], capsys)
    want = _run_repro(DRIVER, capsys, monkeypatch)
    assert _parse(port) == _parse(want)
    m = re.search(r"mesh: 2 device\(s\) x 2 workers; entries stolen into each device: "
                  r"d0=(\d+) d1=(\d+)", port)
    assert m, port
    steals = sum(q[3] for q in _parse(port)[0].values())
    assert int(m.group(1)) + int(m.group(2)) == steals


def test_driver_refusals(capsys, monkeypatch):
    from repro_torch.launch import sge_run

    bad = DRIVER + ["--sparse-index", "--step-backend", "jnp"]
    with pytest.raises(SystemExit) as got:
        sge_run.main(bad + ["--device", CPU])
    from repro.launch import sge_run as jax_sge_run

    monkeypatch.setattr(sys, "argv", ["sge_run"] + bad)
    with pytest.raises(SystemExit) as want:
        jax_sge_run.main()
    assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sge_run.main(DRIVER)
    n = torch.cuda.device_count()
    if n:
        with pytest.raises(SystemExit, match=f"only {n} CUDA card"):
            sge_run.main(DRIVER + ["--devices", str(n + 1)])
