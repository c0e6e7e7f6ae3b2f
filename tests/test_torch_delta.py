"""Dynamic graphs in the port against the JAX package's, on the CPU.

* ``SubgraphIndex.update``: bitmaps, degrees, ``version``, fingerprint
  bytes, the ``GraphDelta``, ``plane_set()`` and ``csr_planes()`` equal
  ``repro``'s on every corpus, chained over three versions; its edge cases
  (duplicate insert, absent removal, cancelling insert and remove, a mixed
  edit, out-of-range and negative-label errors, a new edge label, self-loop
  insert and delete) against ``repro``'s outcome; untouched CSR planes
  shared by identity;
* ``Enumerator.run_delta`` on every dense path of the port (``jnp``,
  ``jnp`` + ``use_pallas``, ``pallas``, ``csr`` on a dense index: the
  kernels' plain versions here) against ``repro``'s ``jnp`` run on
  ``added``, ``removed``, ``n_old``, ``states``, ``n_seeds``, ``n_anchors``
  and ``retries``, and ``dm.apply(old)`` against a fresh run's sorted
  mappings; add-only, remove-only and single-arc deltas; seed chunking and
  match-ring growth;
* the incremental oracle (``ref_delta``, ``ref_node_mappings``) and the
  pure delta functions against ``repro``'s;
* anchor plans, stale queries, versioned uploads and ``invalidate_index``,
  a sparse index's refusals, and a Hypothesis edit-stream property against
  the port's own oracle.

``repro`` runs ``jnp`` only, one session per corpus (its updates reuse
that session's traces).  Counters and mappings are integers: exact
equality.
"""

import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import Enumerator as JaxEnumerator  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.core import delta as jax_delta  # noqa: E402
from repro.core import ref as jax_ref  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro_torch.core import Enumerator, SubgraphIndex, delta  # noqa: E402
from repro_torch.core import ref  # noqa: E402
from repro_torch.core.graph import Graph, PackedGraph  # noqa: E402
from repro_torch.core.plan import build_plan  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from tests.conftest import extract_connected_pattern, power_law_target, random_graph  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

CPU = "cpu"
KW = dict(n_workers=4, expand_width=2)
# the port's paths that can run a delta: (label, step_backend, use_pallas)
PORT_PATHS = [
    ("jnp", "jnp", False),
    ("jnp+use_pallas", "jnp", True),
    ("pallas", "pallas", False),
    ("csr dense index", "csr", False),
]
PATH_IDS = [p[0] for p in PORT_PATHS]
DM_FIELDS = ("added", "removed", "n_old", "states", "n_seeds", "n_anchors", "retries")


# ---------------------------------------------------------------------------
# corpora (the JAX package's incremental corpora), canonicalised arc sets
# ---------------------------------------------------------------------------

def _canon(tgt):
    return jax_delta.apply_delta(tgt)


def _dense(rng):
    tgt = _canon(random_graph(rng, 24, 60, n_labels=2))
    return tgt, extract_connected_pattern(rng, tgt, 4)


def _selfloops(rng):
    tgt = _canon(random_graph(rng, 20, 48, n_labels=1, selfloops=5))
    return tgt, extract_connected_pattern(rng, tgt, 4)


def _multi_elab(rng):
    tgt = _canon(random_graph(rng, 22, 56, n_labels=2, n_elabs=3))
    return tgt, extract_connected_pattern(rng, tgt, 4)


def _power_law(rng):
    tgt = _canon(power_law_target(rng, 300, avg_deg=3.0, n_labels=4, selfloops=2))
    return tgt, extract_connected_pattern(rng, tgt, 4)


CORPORA = {"dense": _dense, "selfloops": _selfloops, "multi_elab": _multi_elab,
           "power_law": _power_law}
REF_CORPORA = ("dense", "selfloops", "multi_elab")


def _arcs(g):
    return list(zip(g.src.tolist(), g.dst.tolist(), g.edge_labels.tolist()))


def _sample_edits(rng, tgt, k_add=4, k_rem=3, loops=False):
    """``k_add`` absent arcs to insert (labels within the target's range)
    and ``k_rem`` present arcs to remove."""
    present = _arcs(tgt)
    aset = set(present)
    nl = int(tgt.edge_labels.max()) + 1 if tgt.m else 1
    absent = []
    while len(absent) < k_add:
        u, v = (int(x) for x in rng.integers(0, tgt.n, 2))
        if u == v and not loops:
            continue
        t = (u, v, int(rng.integers(0, nl)))
        if t not in aset and t not in absent:
            absent.append(t)
    rem_idx = rng.choice(len(present), size=min(k_rem, len(present)), replace=False)
    return absent, [present[i] for i in rem_idx]


def _relevant_edits(rng, tgt, pat, k):
    """``k`` absent arcs, both arcs of each edge, whose endpoint labels and
    edge label are a pattern edge's: every one can seed an anchor."""
    pe = sorted(set(zip(pat.labels[pat.src].tolist(), pat.labels[pat.dst].tolist(),
                        pat.edge_labels.tolist())))
    present, adds = set(_arcs(tgt)), []
    while len(adds) < k:
        la, lb, el = pe[int(rng.integers(len(pe)))]
        u = int(rng.choice(np.nonzero(tgt.labels == la)[0]))
        v = int(rng.choice(np.nonzero(tgt.labels == lb)[0]))
        if u != v and (u, v, el) not in present and (u, v, el) not in adds:
            adds += [(u, v, el), (v, u, el)]
    return adds


@functools.lru_cache(maxsize=None)
def _case(corpus):
    """``(target, pattern, adds, rems)`` of a corpus, the same on every call."""
    rng = np.random.default_rng(sorted(CORPORA).index(corpus))
    tgt, pat = CORPORA[corpus](rng)
    adds, rems = _sample_edits(rng, tgt, k_add=4, k_rem=3, loops=corpus == "selfloops")
    return tgt, pat, adds, rems


@functools.lru_cache(maxsize=None)
def _jax_session(corpus, **kw):
    """One ``repro`` jnp session per corpus and configuration: the index
    versions it sees share its traces, so XLA compiles stay few."""
    tgt = _case(corpus)[0]
    return JaxEnumerator(JaxIndex.build(tgt), step_backend="jnp", **dict(KW, **kw))


def _jax_delta(corpus, adds, rems, **kw):
    """``repro``'s old run and ``run_delta`` of one edit."""
    je = _jax_session(corpus, **kw)
    pat = _case(corpus)[1]
    ms_old = je.run(je.prepare(pat))
    new_idx, d = je.index.update(add_edges=adds, remove_edges=rems)
    return ms_old, je.run_delta(je.prepare(pat, index=new_idx), ms_old, d)


@functools.lru_cache(maxsize=None)
def _jax_corpus_delta(corpus):
    _, _, adds, rems = _case(corpus)
    return _jax_delta(corpus, adds, rems)


def _port_enum(tgt, backend="jnp", use_pallas=False, **kw):
    return Enumerator(SubgraphIndex.build(to_port(tgt)), step_backend=backend,
                      use_pallas=use_pallas, device=CPU, **dict(KW, **kw))


def _port_delta(enum, pat, adds, rems, seed_edge=None):
    """The port's old run, ``run_delta`` and fresh run of the new version;
    asserts ``old ⊕ delta == fresh`` on counts and sorted mappings."""
    q = enum.prepare(pat, seed_edge=seed_edge)
    ms_old = enum.run(q)
    new_idx, d = enum.index.update(add_edges=adds, remove_edges=rems)
    q2 = enum.prepare(pat, index=new_idx, seed_edge=seed_edge)
    dm = enum.run_delta(q2, ms_old, d)
    fresh = enum.run(q2)
    assert dm.matches == fresh.matches
    assert dm.apply(ms_old) == sorted(delta.as_node_mappings(fresh))
    return dm, q2, new_idx


def _assert_dm_equal(got, want):
    for f in DM_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _assert_plane_sets_equal(got, want):
    assert got.n_t == want.n_t and got.n_planes == want.n_planes
    for a, b in zip(got.indptrs + got.indices, want.indptrs + want.indices):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _assert_indexes_equal(got, want):
    for f in ("adj_bits", "deg_out", "deg_in", "labels"):
        a, b = getattr(got.packed, f), getattr(want.packed, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.max_degree, got.version, got.fingerprint, got.n_labels) == (
        want.max_degree, want.version, want.fingerprint, want.n_labels)
    np.testing.assert_array_equal(got.label_counts, want.label_counts)
    a, b = got.csr_planes(), want.csr_planes()
    assert a.deg_cap == b.deg_cap
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def _assert_deltas_equal(got, want):
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ---------------------------------------------------------------------------
# SubgraphIndex.update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_update_matches_repro(corpus):
    """Three chained updates: every version's bitmaps, degrees, version,
    fingerprint, delta and planes equal repro's."""
    tgt, _, adds, rems = _case(corpus)
    rng = np.random.default_rng(7)
    mine, theirs = SubgraphIndex.build(to_port(tgt)), JaxIndex.build(tgt)
    assert mine.fingerprint == theirs.fingerprint and mine.version == theirs.version == 0
    _assert_plane_sets_equal(mine.plane_set(), theirs.plane_set())
    g = tgt
    for step in range(3):
        if step:
            adds, rems = _sample_edits(rng, g, k_add=3, k_rem=2, loops=corpus == "selfloops")
        mine, d_mine = mine.update(add_edges=adds, remove_edges=rems)
        theirs, d_theirs = theirs.update(add_edges=adds, remove_edges=rems)
        _assert_deltas_equal(d_mine, d_theirs)
        assert mine.version == step + 1
        _assert_indexes_equal(mine, theirs)
        _assert_plane_sets_equal(mine.plane_set(), theirs.plane_set())
        g = jax_delta.apply_delta(g, added=adds, removed=rems)
    # the patched index is content-equal to a fresh build of the edited graph
    fresh = SubgraphIndex.build(to_port(g))
    for f in ("adj_bits", "deg_out", "deg_in"):
        np.testing.assert_array_equal(getattr(mine.packed, f), getattr(fresh.packed, f))
    np.testing.assert_array_equal(mine.csr_planes().indptr, fresh.csr_planes().indptr)
    np.testing.assert_array_equal(mine.csr_planes().indices, fresh.csr_planes().indices)


def _edge_case_edits(tgt):
    """Named ``(add_edges, remove_edges)`` edits of the multi-label corpus."""
    arcs = _arcs(tgt)
    absent, _ = _sample_edits(np.random.default_rng(3), tgt, k_add=2, k_rem=0)
    free = next(u for u in range(tgt.n) if (u, u, 0) not in set(arcs))
    nl = int(tgt.edge_labels.max()) + 1
    return {
        "duplicate_insert": ([arcs[0], arcs[0]], []),
        "absent_removal": ([], [absent[0]]),
        "cancel_absent": ([absent[0]], [absent[0]]),
        "cancel_present": ([arcs[0]], [arcs[0]]),
        "mixed": ([absent[0], absent[0], arcs[1]], [arcs[2], absent[1]]),
        "two_tuples": ([absent[0][:2]], [arcs[2][:2]]),
        "out_of_range": ([(0, tgt.n, 0)], []),
        "out_of_range_removal": ([], [(-1, 0, 0)]),
        "negative_label": ([(0, 1, -1)], []),
        "new_edge_label": ([(absent[0][0], absent[0][1], nl)], []),
        "selfloop_insert": ([(free, free, 0)], []),
        "selfloop_delete": ([], [next(a for a in arcs if a[0] == a[1])]),
    }


EDGE_CASES = ["absent_removal", "cancel_absent", "cancel_present", "duplicate_insert",
              "mixed", "negative_label", "new_edge_label", "out_of_range",
              "out_of_range_removal", "selfloop_delete", "selfloop_insert", "two_tuples"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_update_edge_cases_match_repro(case):
    """Each degenerate or unusual edit has repro's outcome: the same error,
    or the same index (``self`` on a no-op) and delta."""
    tgt = _canon(random_graph(np.random.default_rng(11), 22, 56, n_labels=2, n_elabs=3,
                              selfloops=3))
    edits = _edge_case_edits(tgt)
    assert sorted(edits) == EDGE_CASES
    adds, rems = edits[case]
    mine, theirs = SubgraphIndex.build(to_port(tgt)), JaxIndex.build(tgt)
    mine.plane_set(), theirs.plane_set()
    try:
        want = theirs.update(add_edges=adds, remove_edges=rems)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mine.update(add_edges=adds, remove_edges=rems)
        assert str(got.value) == str(e)
        return
    got_idx, got_d = mine.update(add_edges=adds, remove_edges=rems)
    _assert_deltas_equal(got_d, want[1])
    assert (got_idx is mine) == (want[0] is theirs)
    assert got_d.is_empty == want[1].is_empty
    _assert_indexes_equal(got_idx, want[0])
    _assert_plane_sets_equal(got_idx.plane_set(), want[0].plane_set())
    if case == "new_edge_label":
        assert got_idx.n_edge_labels == mine.n_edge_labels + 1
        assert got_idx.plane_set().n_planes == mine.plane_set().n_planes + 2
    if case.startswith(("duplicate", "absent", "cancel")):
        assert got_idx is mine and got_d.is_empty


@pytest.mark.parametrize("edit", ["insert", "remove"])
def test_update_shares_untouched_planes(edit):
    """Untouched (edge label, direction) planes keep their arrays by
    identity; the touched pair gets new ones."""
    tgt = _case("multi_elab")[0]
    idx = SubgraphIndex.build(to_port(tgt))
    ps = idx.plane_set()
    assert ps.n_planes >= 4
    if edit == "insert":
        (arc,), _ = _sample_edits(np.random.default_rng(5), tgt, k_add=1, k_rem=0)
        new_idx, _ = idx.update(add_edges=[arc])
    else:
        arc = _arcs(tgt)[0]
        new_idx, _ = idx.update(remove_edges=[arc])
    ps2 = new_idx.plane_set()
    touched = {2 * arc[2], 2 * arc[2] + 1}
    for p in range(ps.n_planes):
        same = (ps2.indices[p] is ps.indices[p], ps2.indptrs[p] is ps.indptrs[p])
        assert same == ((False, False) if p in touched else (True, True)), p


# ---------------------------------------------------------------------------
# Enumerator.run_delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", PORT_PATHS, ids=PATH_IDS)
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_run_delta_matches_repro(corpus, path):
    _, backend, use_pallas = path
    tgt, pat, adds, rems = _case(corpus)
    _, want = _jax_corpus_delta(corpus)
    got, _, _ = _port_delta(_port_enum(tgt, backend, use_pallas), to_port(pat), adds, rems)
    _assert_dm_equal(got, want)


@pytest.mark.parametrize("path", PORT_PATHS, ids=PATH_IDS)
@pytest.mark.parametrize("kind", ["add_only", "remove_only", "single_arc"])
def test_delta_kinds_match_repro(kind, path):
    _, backend, use_pallas = path
    tgt, pat, adds, rems = _case("dense")
    adds, rems = {"add_only": (adds, []), "remove_only": ([], rems),
                  "single_arc": (adds[:1], [])}[kind]
    _, want = _jax_delta("dense", adds, rems)
    got, _, _ = _port_delta(_port_enum(tgt, backend, use_pallas), to_port(pat), adds, rems)
    _assert_dm_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_chunked(adds):
    je = _jax_session("dense", n_workers=2, stack_cap=12)
    je._DELTA_MCAP = je._delta_mcap = 1  # a ring of 1: every chunk grows it
    return _jax_delta("dense", list(adds), [], n_workers=2, stack_cap=12)[1]


@pytest.mark.parametrize("path", PORT_PATHS, ids=PATH_IDS)
def test_seed_chunking_and_ring_growth_match_repro(path):
    """Two workers with 12 stack slots take an anchor's 15 seeds in two
    chunks, and a match ring of 1 grows by retries: the retries, counters
    and sets equal repro's."""
    _, backend, use_pallas = path
    tgt, pat, _, _ = _case("dense")
    adds = _relevant_edits(np.random.default_rng(9), tgt, pat, 30)
    want = _jax_chunked(tuple(adds))
    enum = _port_enum(tgt, backend, use_pallas, n_workers=2, stack_cap=12)
    enum._DELTA_MCAP = enum._delta_mcap = 1
    got, q2, _ = _port_delta(enum, to_port(pat), adds, [])
    assert want.retries >= 2
    assert max(delta.build_anchor_seeds(p, a, got.delta.added)[0].shape[0]
               for a, p in enum._anchor_plans(q2)) > 12
    _assert_dm_equal(got, want)
    assert enum._delta_mcap == _jax_session("dense", n_workers=2, stack_cap=12)._delta_mcap


@pytest.mark.parametrize("corpus", REF_CORPORA)
def test_ref_delta_matches_repro(corpus):
    """The port's incremental oracle equals repro's, and the port's
    run_delta equals the port's oracle."""
    tgt, pat, adds, rems = _case(corpus)
    want = jax_ref.ref_delta(pat, tgt, added=adds, removed=rems)
    got = ref.ref_delta(to_port(pat), to_port(tgt), added=adds, removed=rems)
    assert (got.added, got.removed, got.n_old, got.matches) == (
        want.added, want.removed, want.n_old, want.matches)
    assert ref.ref_node_mappings(to_port(pat), to_port(tgt)) == jax_ref.ref_node_mappings(pat, tgt)
    dm, _, _ = _port_delta(_port_enum(tgt), to_port(pat), adds, rems)
    assert (dm.added, dm.removed, dm.matches) == (got.added, got.removed, got.matches)


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_delta_functions_match_repro(corpus):
    """On the same anchor plans, the seeds, invalidation, dedup and both
    ``apply`` forms are byte-equal to repro's."""
    tgt, pat, adds, rems = _case(corpus)
    adds = delta.normalize_edges(adds)
    g, p = to_port(tgt), to_port(pat)
    packed, jpacked = PackedGraph.from_graph(g), JaxIndex.build(tgt).packed
    old = np.asarray(jax_ref.ref_node_mappings(pat, tgt), dtype=np.int64).reshape(-1, pat.n)
    new = np.asarray(jax_ref.ref_node_mappings(pat, jax_delta.apply_delta(tgt, adds, rems)),
                     dtype=np.int64).reshape(-1, pat.n)
    assert delta.pattern_edge_triples(p) == jax_delta.pattern_edge_triples(pat)
    got_rm = delta.invalidated_mappings(p, old, rems)
    assert got_rm == jax_delta.invalidated_mappings(pat, old, rems)
    for anchor in delta.pattern_edge_triples(p):
        pa, pb, _ = anchor
        a = (pa,) if pa == pb else (pa, pb)
        aplan = build_plan(p, packed, anchor=a)
        jplan = jax_build_plan(pat, jpacked, anchor=a)
        np.testing.assert_array_equal(aplan.order, jplan.order)
        seeds = delta.build_anchor_seeds(aplan, anchor, adds)
        for x, y in zip(seeds, jax_delta.build_anchor_seeds(jplan, anchor, adds)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        rows = new[:, np.asarray(aplan.order[:aplan.n_p])]
        maps = delta.canonical_mappings(aplan, rows)
        assert maps == jax_delta.canonical_mappings(jplan, rows)
        assert delta.filter_new_matches(p, maps, adds, anchor) == \
            jax_delta.filter_new_matches(pat, maps, adds, anchor)
    kept = set(map(tuple, old.tolist()))
    added = sorted(m for m in map(tuple, new.tolist()) if m not in kept)
    kw = dict(added=added, removed=sorted(got_rm), n_old=len(old), states=0, n_seeds=0,
              n_anchors=0, preprocess_s=0.0, match_s=0.0)
    dm, jdm = delta.DeltaMatchSet("q", **kw), jax_delta.DeltaMatchSet("q", **kw)
    assert dm.apply(old) == jdm.apply(old)
    a, b = dm.apply_array(old), jdm.apply_array(old)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert a.tolist() == [list(m) for m in dm.apply(old)]


def test_run_delta_rejects_stale_query():
    tgt, pat, adds, _ = _case("dense")
    enum = _port_enum(tgt)
    q_old = enum.prepare(to_port(pat))
    ms = enum.run(q_old)
    _, d = enum.index.update(add_edges=adds)
    with pytest.raises(ValueError, match="fingerprint"):
        enum.run_delta(q_old, ms, d)


def test_delta_reuses_edge_seeded_query_plan():
    """An edge-seeded query's plan is its seed edge's anchor plan, by
    identity; every other anchor gets its own plan.  The edge-seeded delta
    (csr, ``root_seeding="auto"``) finds repro's added and removed sets."""
    tgt, pat, adds, rems = _case("power_law")
    enum = _port_enum(tgt, "csr", root_seeding="auto")
    dm, q2, _ = _port_delta(enum, to_port(pat), adds, rems, seed_edge="auto")
    assert q2.plan.seed_edge is not None
    _, want = _jax_corpus_delta("power_law")
    assert (dm.added, dm.removed) == (want.added, want.removed)
    anchors = dict(enum._anchor_plans(q2))
    seed = q2.plan.seed_edge
    assert seed in anchors and anchors[seed] is q2.plan
    assert all(p is not q2.plan for a, p in anchors.items() if a != seed)
    # the edit may remove the seed edge's every target arc: the anchor is
    # then simply absent from the seeds, and the gate still holds
    seed_arcs = [a for a in _arcs(tgt) if a[2] == seed[2]]
    enum2 = _port_enum(tgt, "csr", root_seeding="auto")
    _port_delta(enum2, to_port(pat), [], seed_arcs, seed_edge="auto")


def test_vertex_seeded_query_builds_all_anchor_plans():
    """Without a seed edge every anchor gets its own plan at the query's
    padding, sharing one DomainResult, with repro's orderings."""
    tgt, pat, _, _ = _case("dense")
    enum = _port_enum(tgt)
    q = enum.prepare(to_port(pat))
    assert q.plan.seed_edge is None
    anchors = dict(enum._anchor_plans(q))
    je = _jax_session("dense")
    want = dict(je._anchor_plans(je.prepare(pat)))
    assert sorted(anchors) == sorted(want)
    for a, aplan in anchors.items():
        assert aplan is not q.plan
        assert (aplan.p_pad, aplan.max_parents) == (q.plan.p_pad, q.plan.max_parents)
        assert aplan.domains is q._anchor_domains
        np.testing.assert_array_equal(aplan.order, want[a].order)
        np.testing.assert_array_equal(aplan.parent_pos, want[a].parent_pos)
    assert dict(enum._anchor_plans(q)) == anchors  # cached on the query


# ---------------------------------------------------------------------------
# versioned uploads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [PORT_PATHS[0], PORT_PATHS[3]], ids=["dense rows", "csr"])
def test_versions_get_their_own_uploads(path):
    """A new version uploads its own adjacency; re-running either version
    hits its own upload, with the old version's counts."""
    _, backend, use_pallas = path
    tgt, pat, adds, rems = _case("dense")
    enum = _port_enum(tgt, backend, use_pallas)
    q1 = enum.prepare(to_port(pat))
    ms1 = enum.run(q1)
    new_idx, _ = enum.index.update(add_edges=adds, remove_edges=rems)
    assert new_idx.fingerprint != enum.index.fingerprint
    q2 = enum.prepare(to_port(pat), index=new_idx)
    assert q2.bucket == q1.bucket
    before = enum.cache_stats()
    ms2 = enum.run(q2)
    mid = enum.cache_stats()
    assert mid["uploads"] == before["uploads"] + 1
    assert mid["entries"] == before["entries"] + 1
    fresh = _port_enum(jax_delta.apply_delta(tgt, adds, rems), backend, use_pallas)
    assert ms2.matches == fresh.run(fresh.prepare(to_port(pat))).matches
    ms1b, ms2b = enum.run(q1), enum.run(q2)
    after = enum.cache_stats()
    assert after["uploads"] == mid["uploads"] and after["entries"] == mid["entries"]
    assert after["cache_hits"] == mid["cache_hits"] + 2
    assert (ms1b.matches, ms2b.matches) == (ms1.matches, ms2.matches)


def test_invalidate_index_drops_retired_version():
    tgt, pat, adds, _ = _case("dense")
    enum = _port_enum(tgt)
    enum.prepare_batch([to_port(pat)])  # the domain fixpoint's arrays, on the upload
    enum.run(enum.prepare(to_port(pat)))
    new_idx, d = enum.index.update(add_edges=adds)
    enum.run(enum.prepare(to_port(pat), index=new_idx))
    entries = enum.cache_stats()["entries"]
    assert d.old_fingerprint in enum._dom_targets
    dropped = enum.invalidate_index(d.old_fingerprint)
    assert dropped >= 1
    assert enum.cache_stats()["entries"] == entries - dropped
    assert d.old_fingerprint not in enum._dom_targets
    assert enum.invalidate_index(d.old_fingerprint) == 0
    assert enum.invalidate_index("") == 0


def test_coalesce_key_distinguishes_versions():
    tgt, pat, adds, _ = _case("dense")
    for backend in ("jnp", "csr"):
        enum = _port_enum(tgt, backend)
        new_idx, _ = enum.index.update(add_edges=adds)
        k1 = enum.coalesce_key(enum.prepare(to_port(pat)))
        k2 = enum.coalesce_key(enum.prepare(to_port(pat), index=new_idx))
        assert k1 != k2


def test_sparse_index_refuses_update_as_repro_does():
    tgt, _, adds, _ = _case("dense")
    messages = []
    for idx in (SubgraphIndex.build(to_port(tgt), sparse=True), JaxIndex.build(tgt, sparse=True)):
        with pytest.raises(NotImplementedError) as e_update:
            idx.update(add_edges=adds)
        with pytest.raises(ValueError) as e_planes:
            idx.plane_set()
        messages.append((str(e_update.value), str(e_planes.value)))
    assert messages[0] == messages[1]
    assert "item" not in messages[0][0]


def test_cpu_delta_runs_launch_no_kernel():
    """On the CPU every path runs its kernels' plain versions."""
    tgt, pat, adds, rems = _case("dense")
    ops.reset_launch_counts()
    for _, backend, use_pallas in PORT_PATHS:
        _port_delta(_port_enum(tgt, backend, use_pallas), to_port(pat), adds, rems)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


# ---------------------------------------------------------------------------
# property: random edit streams, against the port's own oracle
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - environment without hypothesis
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 10_000), n_steps=st.integers(1, 3),
           k_add=st.integers(0, 4), k_rem=st.integers(0, 4))
    def test_property_random_edit_streams(seed, n_steps, k_add, k_rem):
        """A match set maintained through a random stream of edits ends
        equal to the port's oracle on the final graph (both sides sorted)."""
        rng = np.random.default_rng(seed)
        tgt = _canon(random_graph(rng, 12, 26, n_labels=2, selfloops=int(rng.integers(0, 3))))
        pat = extract_connected_pattern(rng, tgt, int(rng.integers(3, 5)))
        if pat.m == 0:
            return
        enum = _port_enum(tgt, n_workers=2)
        p = to_port(pat)
        cur = delta.as_node_mappings(enum.run(enum.prepare(p)))
        idx, g = enum.index, to_port(tgt)
        for _ in range(n_steps):
            adds, rems = _sample_edits(rng, g, k_add=k_add, k_rem=min(k_rem, g.m), loops=True)
            idx, d = idx.update(add_edges=adds, remove_edges=rems)
            cur = enum.run_delta(enum.prepare(p, index=idx), cur, d).apply(cur)
            g = delta.apply_delta(g, added=adds, removed=rems)
        assert sorted(cur) == sorted(ref.ref_node_mappings(p, g))
