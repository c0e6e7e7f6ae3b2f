"""Host preprocessing of the port against the JAX package: packed
adjacency, domains, ordering and plan arrays are identical, for every
variant, on the conformance cases and the domain-rule edge cases
(self-loops, an edge label the target lacks).  Integer arrays: exact."""

import numpy as np
import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import domains as jax_dom  # noqa: E402
from repro.core.graph import Graph as JaxGraph  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.plan import VARIANTS as JAX_VARIANTS  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro_torch.core import domains as dom  # noqa: E402
from repro_torch.core.graph import Graph, PackedGraph  # noqa: E402
from repro_torch.core.plan import PLAN_ARRAY_FIELDS, VARIANTS, build_plan, plan_from_numpy  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from tests.conftest import bump_edge_label  # noqa: E402
from tests.test_backend_conformance import CASES  # noqa: E402

PLAN_CASES = ("dense", "selfloops", "edge_labels")


def to_port(g: JaxGraph) -> Graph:
    """The same graph as the port's :class:`Graph`."""
    return Graph(n=g.n, src=g.src.copy(), dst=g.dst.copy(), labels=g.labels.copy(),
                 edge_labels=g.edge_labels.copy())


def _bugfix_cases():
    """(target, pattern) pairs of tests/test_domains_bugfixes.py."""
    tri_loop = JaxGraph.from_edges(3, [(0, 1), (1, 2), (2, 0), (0, 0)], undirected=True)
    loop_lab = JaxGraph.from_edges(2, [(0, 1), (0, 0)], edge_labels=[0, 1], undirected=True)
    path = JaxGraph.from_edges(4, [(0, 1), (1, 2), (2, 3)], undirected=True)
    return {
        "selfloop": (tri_loop, JaxGraph.from_edges(2, [(0, 1), (0, 0)], undirected=True)),
        "selfloop_label": (loop_lab, JaxGraph.from_edges(
            2, [(0, 1), (0, 0)], edge_labels=[0, 0], undirected=True)),
        "loop_only": (loop_lab, JaxGraph.from_edges(1, [(0, 0)], edge_labels=[1],
                                                    undirected=True)),
        "label_overflow": (path, bump_edge_label(
            JaxGraph.from_edges(2, [(0, 1)], undirected=True), 0, 7)),
        "loop_label_overflow": (path, JaxGraph.from_edges(1, [(0, 0)], edge_labels=[9],
                                                          undirected=True)),
        "ac_unsat_star": (path, JaxGraph.from_edges(4, [(0, 1), (0, 2), (0, 3)],
                                                    undirected=True)),
    }


def assert_plans_equal(got, want):
    for f in PLAN_ARRAY_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_variants_are_repro_variants():
    assert VARIANTS == JAX_VARIANTS


@pytest.mark.parametrize("case", PLAN_CASES)
def test_packed_graph_matches_repro(rng, case):
    tgt, _ = CASES[case](rng)
    got, want = PackedGraph.from_graph(to_port(tgt)), JaxPacked.from_graph(tgt)
    assert (got.n, got.w) == (want.n, want.w)
    for f in ("adj_bits", "labels", "deg_out", "deg_in"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", PLAN_CASES)
def test_build_plan_matches_repro(rng, case, variant):
    tgt, pat = CASES[case](rng)
    want = jax_build_plan(pat, JaxPacked.from_graph(tgt), variant=variant, p_pad=16,
                          max_parents=8)
    got = build_plan(to_port(pat), PackedGraph.from_graph(to_port(tgt)), variant=variant,
                     p_pad=16, max_parents=8)
    assert_plans_equal(got, want)


@pytest.mark.parametrize("name", sorted(_bugfix_cases()))
def test_domain_rules_match_repro(name):
    """Self-loop and label-overflow rules: the same bits and satisfiability
    in every pipeline mode, and the same plan in every variant."""
    tgt, pat = _bugfix_cases()[name]
    jpk, tpk = JaxPacked.from_graph(tgt), PackedGraph.from_graph(to_port(tgt))
    for use_ac, use_fc, interleave in [(False, False, False), (True, False, False),
                                       (True, True, False), (True, True, True)]:
        a = jax_dom.compute_domains(pat, jpk, use_ac=use_ac, use_fc=use_fc, interleave=interleave)
        b = dom.compute_domains(to_port(pat), tpk, use_ac=use_ac, use_fc=use_fc,
                                interleave=interleave)
        assert a.satisfiable == b.satisfiable
        np.testing.assert_array_equal(a.bits, b.bits)
        if not b.satisfiable:
            assert not b.bits.any()
    for variant in VARIANTS:
        assert_plans_equal(build_plan(to_port(pat), tpk, variant=variant),
                           jax_build_plan(pat, jpk, variant=variant))


def test_plan_from_numpy_round_trip(rng):
    tgt, pat = CASES["selfloops"](rng)
    want = jax_build_plan(pat, JaxPacked.from_graph(tgt), variant="ri-ds-si-acfc")
    assert_plans_equal(plan_from_numpy({f: getattr(want, f) for f in PLAN_ARRAY_FIELDS}), want)
    with pytest.raises(KeyError, match="dom_bits"):
        plan_from_numpy({f: getattr(want, f) for f in PLAN_ARRAY_FIELDS if f != "dom_bits"})


def test_graphgen_matches_repro():
    """The port's generator copy makes the same collections from a seed."""
    kw = dict(pattern_edges=(4, 8), patterns_per_target=2, scale=0.05, seed=3)
    for name in graphgen.COLLECTIONS:
        got = graphgen.make_collection(name, **kw)
        want = jax_graphgen.make_collection(name, **kw)
        assert [i.name for i in got] == [i.name for i in want]
        for gi, wi in zip(got, want):
            for g, w in ((gi.target, wi.target), (gi.pattern, wi.pattern)):
                assert g.n == w.n
                for f in ("src", "dst", "labels", "edge_labels"):
                    np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        # keeping only the first target keeps its graph and patterns
        first = graphgen.make_collection(name, n_targets=1, **kw)
        assert [i.name for i in first] == [i.name for i in want if "/t0/" in i.name]
        for gi, wi in zip(first, want):
            for f in ("src", "dst", "labels", "edge_labels"):
                np.testing.assert_array_equal(getattr(gi.pattern, f), getattr(wi.pattern, f))
                np.testing.assert_array_equal(getattr(gi.target, f), getattr(wi.target, f))
