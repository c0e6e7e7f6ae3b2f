"""The port's device domain fixpoint against the JAX package's, on the CPU.

`repro_torch.core.domains.compute_domains_device` (both kernel routes:
``use_pallas=False``, plain reductions, and ``True``, the K4 sweep and K3
popcount, run here through their plain versions) and
``compute_domains_batch`` (plain, and K5 per arc slot) must equal
``repro.core.domains``' functions of the same name and the numpy oracle
``compute_domains``, bit for bit, with the same satisfiable flag: over the
pipelines of every variant, on the fixed-seed corpus of
``tests/test_domains_bugfixes.py`` (self-loops, two edge labels, labels
the target lacks), on its hand-made rule cases, with finite ``ac_iters``
(Jacobi sweeps on both sides), and with ``use_pallas=True`` on the JAX side
(its Pallas kernels in interpret mode).  Bitmaps are integers: exact.
"""

import numpy as np
import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import domains as jax_dom  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro_torch.core import domains as dom  # noqa: E402
from repro_torch.core.graph import PackedGraph  # noqa: E402
from repro_torch.core.plan import VARIANTS, variant_flags  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from tests.conftest import bump_edge_label, extract_connected_pattern, random_graph  # noqa: E402
from tests.test_core_domains import PIPELINES  # noqa: E402
from tests.test_torch_plan import _bugfix_cases, to_port  # noqa: E402

CPU = "cpu"


def _corpus():
    """(target, pattern) pairs of test_device_fixpoint_matches_numpy_fixed_seeds,
    with two more seeds."""
    out = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        tgt = random_graph(rng, 12, 24, n_labels=2, n_elabs=2, selfloops=seed % 3)
        pat = extract_connected_pattern(rng, tgt, 3)
        if pat.m == 0:
            continue
        if seed % 2:
            pat = bump_edge_label(pat, int(rng.integers(pat.m)), 5)
        out.append((tgt, pat))
    return out


def _assert_same(got, want, msg=""):
    assert got.satisfiable == want.satisfiable, msg
    np.testing.assert_array_equal(np.asarray(got.bits), np.asarray(want.bits), err_msg=msg)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_device_fixpoint_matches_repro_and_oracle(use_pallas):
    for k, (tgt, pat) in enumerate(_corpus()):
        jpacked = JaxPacked.from_graph(tgt)
        packed = PackedGraph.from_graph(to_port(tgt))
        tgt_arrays = dom.target_domain_arrays(packed, CPU)
        for use_ac, use_fc, interleave in PIPELINES:
            flags = dict(use_ac=use_ac, use_fc=use_fc, interleave=interleave)
            oracle = dom.compute_domains(to_port(pat), packed, **flags)
            want = jax_dom.compute_domains_device(pat, jpacked, **flags)
            got = dom.compute_domains_device(to_port(pat), packed, use_pallas=use_pallas,
                                             tgt_arrays=tgt_arrays, **flags)
            _assert_same(want, oracle, f"case {k} {flags}: repro vs oracle")
            _assert_same(got, want, f"case {k} {flags}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_rule_cases_every_variant(variant):
    """Self-loops, a self-loop label, a loop-only pattern, edge and loop
    labels the target lacks, and an AC-unsatisfiable star, for every
    variant's pipeline, single and batched."""
    f = variant_flags(variant)
    flags = dict(use_ac=f["use_ac"], use_fc=f["use_fc"], interleave=f["interleave"])
    for name, (tgt, pat) in _bugfix_cases().items():
        packed = PackedGraph.from_graph(to_port(tgt))
        want = jax_dom.compute_domains_device(pat, JaxPacked.from_graph(tgt), **flags)
        _assert_same(dom.compute_domains(to_port(pat), packed, **flags), want, name)
        for use_pallas in (False, True):
            got = dom.compute_domains_device(to_port(pat), packed, use_pallas=use_pallas,
                                             device=CPU, **flags)
            _assert_same(got, want, f"{name} use_pallas={use_pallas}")
            (batched,) = dom.compute_domains_batch([to_port(pat)], packed, use_pallas=use_pallas,
                                                   device=CPU, **flags)
            _assert_same(batched, want, f"{name} batched use_pallas={use_pallas}")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_batch_matches_repro_and_oracle(use_pallas):
    """One batch over patterns of different sizes, self-loops and an
    unsatisfiable lane (so lanes stop at different iterations), padded to
    8 lanes, equals repro's batch and the per-query oracle."""
    rng = np.random.default_rng(1)
    tgt = random_graph(rng, 14, 30, n_labels=2, selfloops=2)
    pats = []
    while len(pats) < 5:
        p = extract_connected_pattern(rng, tgt, int(rng.integers(2, 5)))
        if p.m:
            pats.append(p)
    pats.append(bump_edge_label(pats[0], 0, 7))  # unsatisfiable lane
    jpacked = JaxPacked.from_graph(tgt)
    packed = PackedGraph.from_graph(to_port(tgt))
    for use_ac, use_fc, interleave in PIPELINES[1:]:
        flags = dict(use_ac=use_ac, use_fc=use_fc, interleave=interleave)
        want = jax_dom.compute_domains_batch(pats, jpacked, batch_pad=8, **flags)
        got = dom.compute_domains_batch([to_port(p) for p in pats], packed, batch_pad=8,
                                        use_pallas=use_pallas, device=CPU, **flags)
        assert len(got) == len(pats)
        for i, (g, w, p) in enumerate(zip(got, want, pats)):
            _assert_same(g, w, f"lane {i} {flags}")
            _assert_same(g, dom.compute_domains(to_port(p), packed, **flags), f"lane {i} oracle")


def test_pallas_interpret_matches(rng):
    """repro's use_pallas routes (Pallas kernels in interpret mode: the
    sweep kernel single, the per-arc kernels batched) give the port's bits."""
    tgt = random_graph(rng, 10, 20, n_labels=2, selfloops=1)
    pat = extract_connected_pattern(rng, tgt, 3)
    assert pat.m
    jpacked = JaxPacked.from_graph(tgt)
    packed = PackedGraph.from_graph(to_port(tgt))
    flags = dict(use_ac=True, use_fc=True, interleave=True)
    want = jax_dom.compute_domains_device(pat, jpacked, use_pallas=True, **flags)
    (want_b,) = jax_dom.compute_domains_batch([pat], jpacked, use_pallas=True, **flags)
    _assert_same(want_b, want)
    for use_pallas in (False, True):
        _assert_same(dom.compute_domains_device(to_port(pat), packed, use_pallas=use_pallas,
                                                device=CPU, **flags), want)
        (got_b,) = dom.compute_domains_batch([to_port(pat)], packed, use_pallas=use_pallas,
                                             device=CPU, **flags)
        _assert_same(got_b, want)


@pytest.mark.parametrize("ac_iters", [1, 2])
def test_finite_ac_iters_are_jacobi_sweeps(ac_iters):
    """A finite ``ac_iters`` bounds whole Jacobi sweeps, as in repro's
    device engine (not the oracle's Gauss-Seidel passes)."""
    rng = np.random.default_rng(3)
    tgt = random_graph(rng, 16, 28, n_labels=2)
    pat = extract_connected_pattern(rng, tgt, 5)
    jpacked = JaxPacked.from_graph(tgt)
    packed = PackedGraph.from_graph(to_port(tgt))
    for use_fc, interleave in ((False, False), (True, True)):
        flags = dict(use_ac=True, use_fc=use_fc, interleave=interleave, ac_iters=ac_iters)
        want = jax_dom.compute_domains_device(pat, jpacked, **flags)
        got = dom.compute_domains_device(to_port(pat), packed, device=CPU, **flags)
        _assert_same(got, want, str(flags))


def test_arrays_and_routing():
    """The padded pattern arrays and buckets equal repro's; the target
    arrays can wrap an adjacency already on the device; the routing modes
    are repro's, and the batched path refuses the sweep kernel."""
    rng = np.random.default_rng(2)
    tgt = random_graph(rng, 9, 16, n_labels=2, selfloops=2)
    pat = extract_connected_pattern(rng, tgt, 4)
    port_pat = to_port(pat)
    for pads in ((None, None, None), (16, 24, 4)):
        want = jax_dom.pattern_domain_arrays(pat, *pads)
        got = dom.pattern_domain_arrays(port_pat, *pads)
        for name, a, b in zip(dom.PatternDomainArrays._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert dom.domain_bucket(port_pat) == jax_dom.domain_bucket(pat)
    assert dom.PALLAS_MODES == jax_dom.PALLAS_MODES

    packed = PackedGraph.from_graph(to_port(tgt))
    own = dom.target_domain_arrays(packed, CPU)
    jt = jax_dom.target_domain_arrays(JaxPacked.from_graph(tgt))
    for name, a, b in zip(dom.TargetDomainArrays._fields, own, jt):
        np.testing.assert_array_equal(a.numpy().view(np.asarray(b).dtype), np.asarray(b),
                                      err_msg=name)
    shared = dom.target_domain_arrays(packed, adj_flat=own.adj_flat)
    assert shared.adj_flat is own.adj_flat

    with pytest.raises(ValueError, match="pallas_mode"):
        dom.device_fixpoint(pallas_mode="tpu")
    with pytest.raises(ValueError, match="batching"):
        dom.device_fixpoint(pallas_mode="sweep", batched=True)


def test_cpu_fixpoint_launches_no_kernel():
    """On CPU tensors every route runs the plain versions."""
    tgt, pat = _corpus()[0]
    packed = PackedGraph.from_graph(to_port(tgt))
    ops.reset_launch_counts()
    dom.compute_domains_device(to_port(pat), packed, use_fc=True, use_pallas=True, device=CPU)
    dom.compute_domains_batch([to_port(pat)], packed, use_fc=True, use_pallas=True, device=CPU)
    assert set(ops.launch_counts().values()) == {0}
