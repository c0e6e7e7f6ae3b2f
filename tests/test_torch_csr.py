"""The port's CSR layer against the JAX package's, on the CPU.

* graph: ``Graph.csr`` / ``Graph.csr_planes`` / ``csr_planes_from_bitmaps``
  / ``CsrPlaneSet`` and the degree-bucket ladder equal ``repro``'s,
  including empty graphs, isolated nodes, self-loops, duplicate edges and
  two edge labels (the cases of ``tests/test_core_graph.py``), and
  ``power_law_graph`` gives ``repro``'s graphs;
* plan arrays: ``make_csr_plan_arrays`` equals ``repro``'s
  ``CsrPlanArrays`` (segment bounds, sentinel-padded indices, padded
  ``deg_cap``);
* kernels: the plain versions of K6 (``csr_extend``), K7
  (``csr_extend_bucketed``) and K8 (``csr_arc_sweep``) equal
  ``repro.kernels.ref``'s oracles and the Pallas kernels run in interpret
  mode, over small sweeps with ragged rows, duplicate entries, unused and
  absent parent slots.

Bitwise integer results: the tolerance is exact equality, compared as
uint32 words.  The interpret-mode cases stay tiny (b <= 16, deg_cap <= 32):
those kernels run per lane in Python.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import extend as jax_extend  # noqa: E402
from repro.core import graph as jax_graph  # noqa: E402
from repro.core.plan import build_csr_plan as jax_build_csr_plan  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro.kernels import csr_extend as jax_ce  # noqa: E402
from repro.kernels import domain_ac as jax_ac  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import extend  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.core.plan import build_csr_plan  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import csr_extend as ce_mod  # noqa: E402
from repro_torch.kernels import domain_ac as ac_mod  # noqa: E402
from tests.conftest import extract_connected_pattern, power_law_target  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

SENTINEL = 2**31 - 1


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy uint32/int32 -> torch int32 with the same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# graph layer
# ---------------------------------------------------------------------------

def _graph_cases(rng):
    """(name, repro Graph, n_elab for csr_planes) — the edge cases of
    tests/test_core_graph.py's CSR tests."""
    n = 12
    edges = [(int(u), int(v)) for u, v in rng.integers(0, n, (40, 2)) if u != v]
    dup = [(int(u), int(v)) for u, v in rng.integers(0, 14, (50, 2))]
    dup += dup[:5]
    G = jax_graph.Graph
    return {
        "random": (G.from_edges(n, edges), None),
        "empty": (G.from_edges(0, []), 1),
        "isolated": (G.from_edges(5, [(1, 3), (3, 1)]), None),
        "self_loops": (G.from_edges(4, [(2, 2), (2, 0), (2, 3)]), None),
        "duplicates": (G.from_edges(3, [(0, 1), (0, 2), (0, 1), (0, 1)]), None),
        "two_labels": (G.from_edges(14, dup, edge_labels=rng.integers(0, 2, len(dup))), None),
        "spare_label": (G.from_edges(6, [(0, 1), (2, 3), (3, 3)], undirected=True), 3),
    }


GRAPH_CASES = ("random", "empty", "isolated", "self_loops", "duplicates", "two_labels",
               "spare_label")


def _assert_planes_equal(got, want):
    assert (got.n_t, got.deg_cap, got.n_planes, got.nnz) == (
        want.n_t, want.deg_cap, want.n_planes, want.nnz)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indptr.dtype == want.indptr.dtype and got.indices.dtype == want.indices.dtype


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_csr_planes_match_repro(rng, case):
    jg, n_elab = _graph_cases(rng)[case]
    g = to_port(jg)
    for got, want in zip(g.csr(), jg.csr()):
        np.testing.assert_array_equal(got, want)
    _assert_planes_equal(g.csr_planes(n_elab), jg.csr_planes(n_elab))
    adj = graph.PackedGraph.from_graph(g).adj_bits
    want = jax_graph.csr_planes_from_bitmaps(jax_graph.PackedGraph.from_graph(jg).adj_bits)
    _assert_planes_equal(graph.csr_planes_from_bitmaps(adj), want)
    # the per-plane set splits and re-joins to the same flat planes
    ps, jps = graph.CsrPlaneSet.from_bitmaps(adj), jax_graph.CsrPlaneSet.from_bitmaps(adj)
    assert ps.n_planes == jps.n_planes and ps.nnz == jps.nnz
    for a, b in zip(ps.indptrs + ps.indices, jps.indptrs + jps.indices):
        np.testing.assert_array_equal(a, b)
    _assert_planes_equal(ps.to_planes(), jps.to_planes())


def test_csr_planes_label_overflow_rejected():
    g = graph.Graph.from_edges(2, [(0, 1)], edge_labels=[3])
    with pytest.raises(ValueError, match="edge label"):
        g.csr_planes(n_elab=2)


@pytest.mark.parametrize("deg_cap", [0, 1, 8, 9, 24, 16373])
def test_deg_buckets_match_repro(rng, deg_cap):
    caps = graph.deg_bucket_caps(deg_cap)
    assert caps == jax_graph.deg_bucket_caps(deg_cap)
    deg = rng.integers(0, max(deg_cap, 1) + 1, 200)
    np.testing.assert_array_equal(graph.deg_bucket_index(deg, caps),
                                  jax_graph.deg_bucket_index(deg, caps))


@pytest.mark.parametrize("n,alpha,seed", [(300, 2.0, 0), (2000, 1.5, 7)])
def test_power_law_graph_matches_repro(n, alpha, seed):
    got = graphgen.power_law_graph(n, avg_deg=4.0, alpha=alpha, n_labels=5, seed=seed)
    want = jax_graphgen.power_law_graph(n, avg_deg=4.0, alpha=alpha, n_labels=5, seed=seed)
    for f in ("src", "dst", "labels", "edge_labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


# ---------------------------------------------------------------------------
# CSR plan arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["ri", "ri-ds-si-fc"])
def test_csr_plan_arrays_match_repro(rng, variant):
    jt = power_law_target(rng, 300, avg_deg=3.0, n_labels=3, n_edge_labels=2)
    jp = extract_connected_pattern(rng, jt, 5)
    jplan = jax_build_csr_plan(jp, jt, variant=variant, p_pad=16, max_parents=8)
    plan = build_csr_plan(to_port(jp), to_port(jt), variant=variant, p_pad=16, max_parents=8,
                          device="cpu")
    want = jax_extend.make_csr_plan_arrays(jplan)
    got = extend.make_csr_plan_arrays(plan, "cpu")
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.deg_cap == want.seg_iota.shape[0]
    np.testing.assert_array_equal(_bits(got.dom_bits), np.asarray(want.dom_bits))
    for f in ("parent_pos", "parent_dir", "parent_elab", "order_valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert extend.csr_shape_bucket(plan) == jax_extend.csr_shape_bucket(jplan)
    assert extend.is_csr_only(plan) and jax_extend.is_csr_only(jplan)


# ---------------------------------------------------------------------------
# kernels: the plain versions against repro's oracles and Pallas kernels
# ---------------------------------------------------------------------------

def csr_step_inputs(rng, b, w, mp, n_rows, deg_cap, p_pad):
    """Random inputs of the sparse step: ``n_rows`` sorted rows over a small
    node pool (so parents' segments overlap), ragged and zero lengths, one
    row at ``deg_cap``, some rows with an adjacent duplicate entry; a third
    of the parent slots unused and every fourth lane without parents; dense
    domains, sparse used-bitmaps, every third candidate bitmap empty, most
    lanes short of a match (so they want a child)."""
    n_t = w * 32
    pool = min(n_t, deg_cap + 4)
    lens = rng.integers(0, deg_cap + 1, n_rows)
    lens[::5] = 0
    lens[min(1, n_rows - 1)] = deg_cap
    rows = []
    for length in lens.tolist():
        r = np.sort(rng.choice(pool, size=min(length, pool), replace=False))
        if r.size >= 2 and rng.random() < 0.3:
            r[1] = r[0]  # an adjacent duplicate: still sorted
        rows.append(r)
    lens = np.array([r.size for r in rows], dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    indices = np.full(int(lens.sum()) + deg_cap, SENTINEL, np.int32)
    indices[: lens.sum()] = np.concatenate(rows) if rows else []
    pick = rng.integers(0, n_rows, (b, mp))
    seg_start = starts[pick].astype(np.int32)
    seg_len = lens[pick].astype(np.int32)
    seg_len[rng.random((b, mp)) < 1 / 3] = -1
    seg_len[::4] = -1

    def u32(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    cand = u32(b, w)
    one_word = np.arange(w)[None, :] == rng.integers(0, w, b)[:, None]
    cand = np.where((rng.random(b) < 0.5)[:, None], np.where(one_word, cand, 0), cand)
    cand[::3] = 0
    n_p = p_pad // 2 + 1
    depth = rng.integers(0, max(n_p - 1, 1), b)  # mostly lanes that want a child
    depth[::5] = n_p - 1  # and some matches
    return dict(indices=indices, dom_bits=u32(p_pad, w) | u32(p_pad, w),
                seg_start=seg_start, seg_len=seg_len,
                child_pos=rng.integers(0, p_pad, b).astype(np.int32),
                depth=depth.astype(np.int32),
                n_p=n_p, used=u32(b, w) & u32(b, w) & u32(b, w), cand=cand)


CSR_ORDER = ("indices", "dom_bits", "seg_start", "seg_len", "child_pos", "depth", "n_p",
             "used", "cand")
# (b, w, mp, n_rows, deg_cap, p_pad)
SHAPES_CSR = [(1, 1, 1, 3, 8, 2), (8, 2, 2, 10, 8, 4), (16, 3, 3, 40, 16, 6),
              (12, 5, 4, 60, 32, 8), (16, 2, 8, 12, 24, 16), (9, 4, 0, 6, 8, 4)]


def _jax_args(x):
    return [jnp.asarray(np.int32(x[k]) if k == "n_p" else x[k]) for k in CSR_ORDER]


def _port_args(x):
    return [x[k] if k == "n_p" else _t(x[k]) for k in CSR_ORDER]


def _assert_step_equal(got, want, label):
    for name, g, o in zip(("cand2", "child", "meta"), got, want):
        np.testing.assert_array_equal(_bits(g), np.asarray(o).view(np.uint32),
                                      err_msg=f"{name} vs {label}")


@pytest.mark.parametrize("b,w,mp,n_rows,deg_cap,p_pad", SHAPES_CSR)
def test_csr_extend_plain_matches_jax(rng, b, w, mp, n_rows, deg_cap, p_pad):
    x = csr_step_inputs(rng, b, w, mp, n_rows, deg_cap, p_pad)
    got = ops.csr_extend(*_port_args(x), deg_cap=deg_cap)
    if mp:  # repro's oracle needs a parent slot; its kernel adds a neutral one
        _assert_step_equal(got, jax_ref.csr_extend_ref(*_jax_args(x), deg_cap=deg_cap), "ref")
    _assert_step_equal(got, jax_ce.csr_extend(*_jax_args(x), deg_cap=deg_cap, interpret=True),
                       "pallas")


@pytest.mark.parametrize("b,w,mp,n_rows,deg_cap,p_pad", SHAPES_CSR)
def test_csr_extend_bucketed_plain_matches_jax(rng, b, w, mp, n_rows, deg_cap, p_pad):
    x = csr_step_inputs(rng, b, w, mp, n_rows, deg_cap, p_pad)
    got = ops.csr_extend_bucketed(*_port_args(x), deg_cap=deg_cap)
    if mp:
        _assert_step_equal(got, jax_ref.csr_extend_bucketed_ref(
            *_jax_args(x), deg_cap=deg_cap, chunk=8), "ref")
    _assert_step_equal(got, jax_ce.csr_extend_bucketed(
        *_jax_args(x), deg_cap=deg_cap, chunk=8, interpret=True), "pallas")
    # the two walks give the same bits
    _assert_step_equal(got, [t.numpy() for t in ops.csr_extend(*_port_args(x),
                                                                deg_cap=deg_cap)], "flat")


def csr_sweep_inputs(rng, n_planes, n_t, w, n_arcs, deg_cap):
    """The input recipe of tests/test_kernels.py::test_csr_arc_sweep:
    ragged rows, empty rows and full-``deg_cap`` rows, a sentinel tail."""
    degs = rng.integers(0, deg_cap + 1, (n_planes, n_t)).astype(np.int32)
    indices = np.full(int(degs.sum()) + deg_cap, SENTINEL, np.int32)
    seg_start = np.zeros((n_planes, n_t), np.int32)
    off = 0
    for p in range(n_planes):
        for t in range(n_t):
            seg_start[p, t] = off
            d = int(degs[p, t])
            indices[off:off + d] = rng.integers(0, n_t, d)
            off += d
    arc_row = rng.integers(0, n_planes, n_arcs).astype(np.int32)
    masks = rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32)
    masks[0] = 0
    masks[-1] &= rng.integers(0, 2**32, w, dtype=np.uint32)
    return seg_start, degs, indices, arc_row, masks


# tests/test_kernels.py::test_csr_arc_sweep's sweep, plus rows longer than deg_cap
@pytest.mark.parametrize("n_planes,n_t,w,n_arcs,deg_cap,cut", [
    (2, 4, 1, 2, 8, False), (4, 33, 2, 6, 8, False), (2, 300, 10, 9, 16, False),
    (6, 70, 3, 5, 32, False), (2, 50, 2, 4, 8, True)])
def test_csr_arc_sweep_plain_matches_jax(rng, n_planes, n_t, w, n_arcs, deg_cap, cut):
    seg_start, degs, indices, arc_row, masks = csr_sweep_inputs(rng, n_planes, n_t, w, n_arcs,
                                                                deg_cap)
    walk_cap = deg_cap // 2 if cut else deg_cap  # the sweep reads min(len, deg_cap)
    jargs = [jnp.asarray(a) for a in (seg_start, degs, indices, arc_row, masks)]
    got = ops.csr_arc_sweep(*(_t(a) for a in (seg_start, degs, indices, arc_row, masks)),
                            deg_cap=walk_cap).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ref.csr_arc_sweep_ref(
        *jargs, deg_cap=walk_cap)))
    np.testing.assert_array_equal(got, np.asarray(jax_ac.csr_arc_sweep(
        *jargs, deg_cap=walk_cap, interpret=True)))


def test_csr_arc_sweep_plain_past_one_grid_dimension(rng):
    """More arcs than one CUDA grid dimension's 65,535 blocks (a sparse
    prepare_batch of about 1,400 48-arc patterns sends them in one sweep):
    the plain version equals repro's oracle on every arc."""
    n_arcs = 65_540
    seg_start, degs, indices, arc_row, masks = csr_sweep_inputs(rng, 3, 6, 1, n_arcs, 8)
    got = ops.csr_arc_sweep(*(_t(a) for a in (seg_start, degs, indices, arc_row, masks)),
                            deg_cap=8).numpy()
    want = np.asarray(jax_ref.csr_arc_sweep_ref(
        *(jnp.asarray(a) for a in (seg_start, degs, indices, arc_row, masks)), deg_cap=8))
    assert got.shape == (n_arcs, 6)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_csr_cpu_tensors_take_the_plain_version(rng):
    """On CPU tensors K6, K7 and K8 run their plain versions and count no
    launch; their CUDA wrappers refuse CPU tensors."""
    x = csr_step_inputs(rng, 8, 2, 2, 10, 8, 4)
    sweep = [_t(a) for a in csr_sweep_inputs(rng, 2, 10, 1, 3, 8)]
    ops.reset_launch_counts()
    ops.csr_extend(*_port_args(x), deg_cap=8)
    ops.csr_extend_bucketed(*_port_args(x), deg_cap=8)
    ops.csr_arc_sweep(*sweep, deg_cap=8)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ce_mod.csr_extend_cuda(*_port_args(x), deg_cap=8)
    with pytest.raises(ValueError, match="CUDA"):
        ce_mod.csr_extend_bucketed_cuda(*_port_args(x), deg_cap=8)
    with pytest.raises(ValueError, match="CUDA"):
        ac_mod.csr_arc_sweep_cuda(*sweep, deg_cap=8)
