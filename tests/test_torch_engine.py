"""The port's engine and session against the JAX package's, on the CPU.

* state level: after each of several shared expansion steps, every
  ``EngineState`` tensor of the port's ``"jnp"``, ``"jnp"`` + ``use_pallas``
  and ``"pallas"`` backends equals ``repro``'s ``"jnp"`` state, fed the same
  plan (`repro_torch.core.plan.plan_from_numpy`);
* end to end: ``repro_torch.enumerate_subgraphs(..., device="cpu")`` equals
  ``repro.core.enumerate_subgraphs`` counter for counter, per-worker
  counters included, over every variant and conformance case, a worker and
  width sweep, ``work_stealing=False``, match mappings (compared sorted),
  and stack overflow with the doubled-cap retry.

Counters and bitmaps are integers: exact equality.
"""

import jax
import numpy as np
import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import Enumerator as JaxEnumerator  # noqa: E402
from repro.core import SubgraphIndex as JaxIndex  # noqa: E402
from repro.core import enumerate_subgraphs as jax_enumerate  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core import extend as jax_extend  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro_torch.core import EngineConfig, Enumerator, SubgraphIndex, enumerate_subgraphs  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import extend  # noqa: E402
from repro_torch.core.frontier import EngineState, init_state  # noqa: E402
from repro_torch.core.plan import PLAN_ARRAY_FIELDS, VARIANTS, plan_from_numpy  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from tests.test_backend_conformance import CASES  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

CPU = "cpu"
# the port's dense step paths: (step_backend, use_pallas)
PORT_PATHS = [("jnp", False), ("jnp", True), ("pallas", False)]


def _counters(r):
    return (r.matches, r.states, r.steps, r.steals, r.steal_rounds)


def assert_engine_results_equal(got, want):
    assert _counters(got) == _counters(want)
    for f in ("per_worker_states", "per_worker_matches", "per_worker_steals"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# state level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store_used,collect", [(True, 8), (False, 0)])
def test_state_level_conformance(rng, store_used, collect):
    tgt, pat = CASES["selfloops"](rng)
    jplan = jax_build_plan(pat, JaxPacked.from_graph(tgt))
    plan = plan_from_numpy({f: getattr(jplan, f) for f in PLAN_ARRAY_FIELDS})
    kw = dict(n_workers=3, expand_width=2, store_used=store_used, collect_matches=collect)
    jcfg = JaxConfig(step_backend="jnp", **kw)
    jstep = jax.jit(jax_extend.make_step_fn(jcfg, jax_eng.plan_arrays_for(jcfg, jplan)))
    ref_states = [jax_eng.init_state(jplan, jcfg)]
    for _ in range(5):
        ref_states.append(jstep(ref_states[-1]))
    for backend, use_pallas in PORT_PATHS:
        cfg = EngineConfig(step_backend=backend, use_pallas=use_pallas, **kw)
        step = extend.make_step_fn(cfg, extend.make_plan_arrays(plan, CPU))
        st = init_state(plan, cfg, CPU)
        for i, want in enumerate(ref_states):
            if i:
                st = step(st)
            for name, a, b in zip(EngineState._fields, st, want):
                b = np.asarray(b)
                a = a[0].numpy()  # the port's state is a pack of one query
                a = a.view(b.dtype) if b.dtype == np.uint32 else a
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{name} after {i} steps, {backend} use_pallas={use_pallas}")


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_end_to_end_matches_repro(rng, case, variant):
    tgt, pat = CASES[case](rng)
    kw = dict(n_workers=4, expand_width=2)
    want = jax_enumerate(pat, tgt, variant=variant, **kw)
    for backend, use_pallas in PORT_PATHS:
        got = enumerate_subgraphs(to_port(pat), to_port(tgt), variant=variant, device=CPU,
                                  step_backend=backend, use_pallas=use_pallas, **kw)
        assert_engine_results_equal(got.engine, want.engine)


@pytest.mark.parametrize("n_workers", [1, 4, 16])
@pytest.mark.parametrize("expand_width", [2, 5])
def test_worker_width_sweep(rng, n_workers, expand_width):
    tgt, pat = CASES["dense"](rng)
    kw = dict(n_workers=n_workers, expand_width=expand_width)
    want = jax_enumerate(pat, tgt, **kw)
    for backend, use_pallas in PORT_PATHS:
        got = enumerate_subgraphs(to_port(pat), to_port(tgt), device=CPU,
                                  step_backend=backend, use_pallas=use_pallas, **kw)
        assert_engine_results_equal(got.engine, want.engine)


def test_without_work_stealing(rng):
    tgt, pat = CASES["dense"](rng)
    kw = dict(n_workers=4, expand_width=2, work_stealing=False)
    want = jax_enumerate(pat, tgt, **kw)
    assert want.steals == 0
    for backend, use_pallas in PORT_PATHS:
        got = enumerate_subgraphs(to_port(pat), to_port(tgt), device=CPU,
                                  step_backend=backend, use_pallas=use_pallas, **kw)
        assert_engine_results_equal(got.engine, want.engine)


def test_mappings_match_repro(rng):
    """Materialized mappings, compared sorted (the order of the match
    buffer is an engine detail)."""
    tgt, pat = CASES["selfloops"](rng)
    jenum = JaxEnumerator(JaxIndex.build(tgt), n_workers=4, expand_width=2)
    want = sorted(jenum.run(jenum.prepare(pat)).mappings())
    assert want
    for backend, use_pallas in PORT_PATHS:
        enum = Enumerator(SubgraphIndex.build(to_port(tgt)), n_workers=4, expand_width=2,
                          step_backend=backend, use_pallas=use_pallas, device=CPU)
        ms = enum.run(enum.prepare(to_port(pat)))
        assert sorted(ms.mappings()) == want


def test_overflow_retry_matches_repro(rng):
    """A stack_cap too small overflows, warns, retries once with a doubled
    cap, and then agrees with repro's retried run; a cap that still
    overflows when doubled raises."""
    tgt, pat = CASES["dense"](rng)
    jenum = JaxEnumerator(JaxIndex.build(tgt), n_workers=2, expand_width=2, stack_cap=8)
    with pytest.warns(RuntimeWarning, match="overflowed"):
        want = jenum.run(jenum.prepare(pat))
    assert want.retries == 1
    index = SubgraphIndex.build(to_port(tgt))
    for backend, use_pallas in PORT_PATHS:
        enum = Enumerator(index, n_workers=2, expand_width=2, stack_cap=8, device=CPU,
                          step_backend=backend, use_pallas=use_pallas)
        with pytest.warns(RuntimeWarning, match="overflowed"):
            got = enum.run(enum.prepare(to_port(pat)))
        assert got.retries == 1 and not got.engine.overflow
        assert_engine_results_equal(got, want)
    tiny = Enumerator(index, n_workers=2, expand_width=2, stack_cap=3, device=CPU)
    with pytest.warns(RuntimeWarning, match="overflowed"):
        with pytest.raises(RuntimeError, match="stack overflow persists"):
            tiny.run(tiny.prepare(to_port(pat)))


def test_cpu_run_launches_no_kernel(rng):
    """On the CPU every path runs the plain versions: no kernel launches."""
    tgt, pat = CASES["dense"](rng)
    ops.reset_launch_counts()
    for backend, use_pallas in PORT_PATHS:
        enumerate_subgraphs(to_port(pat), to_port(tgt), device=CPU, n_workers=2,
                            step_backend=backend, use_pallas=use_pallas)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


# ---------------------------------------------------------------------------
# configuration values: accepted as repro accepts them; what later slices
# bring is refused, not accepted silently
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 3])
def test_partitioned_config_value_accepted(k):
    """The out-of-core backend and its settings are accepted as repro's
    (with the same resolved spill capacity); an unknown backend raises
    repro's ValueError."""
    kw = dict(step_backend="partitioned", n_partitions=k, expand_width=4)
    cfg, jcfg = EngineConfig(**kw), JaxConfig(**kw)
    assert (cfg.step_backend, cfg.n_partitions, cfg.spill_cap) == (
        jcfg.step_backend, jcfg.n_partitions, jcfg.spill_cap)
    for p_pad in (16, 32):
        assert cfg.resolved_spill_cap(p_pad) == jcfg.resolved_spill_cap(p_pad)
    assert extend.resolve_step_backend(cfg, 10) == jax_extend.resolve_step_backend(jcfg, 10)
    msgs = []
    for make in (EngineConfig, JaxConfig):
        with pytest.raises(ValueError, match="step_backend") as e:
            make(step_backend="partitioned-" + str(k))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seeding", ["vertex", "edge", "auto"])
def test_root_seeding_values_accepted(seeding):
    """Every root seeding mode of repro is accepted; others raise as there."""
    assert EngineConfig(root_seeding=seeding).root_seeding == JaxConfig(
        root_seeding=seeding).root_seeding
    for cfg in (EngineConfig, JaxConfig):
        with pytest.raises(ValueError, match="root_seeding"):
            cfg(root_seeding=seeding + "s")


@pytest.mark.parametrize("backend", ["csr", "auto"])
def test_sparse_config_values_accepted(backend):
    """The sparse path's step backends are accepted, and resolve per target
    size as repro resolves them (a CSR-only plan always takes csr)."""
    cfg = EngineConfig(step_backend=backend, csr_walk="flat")
    jcfg = JaxConfig(step_backend=backend, csr_walk="flat")
    assert (cfg.step_backend, cfg.csr_walk) == (jcfg.step_backend, jcfg.csr_walk)
    for n_t in (1, extend.CSR_AUTO_NT, extend.CSR_AUTO_NT + 1, 10 * extend.CSR_AUTO_NT):
        assert extend.resolve_step_backend(cfg, n_t) == jax_extend.resolve_step_backend(
            jcfg, n_t)


def test_later_session_features_refused(rng):
    tgt, pat = CASES["dense"](rng)
    g, p = to_port(tgt), to_port(pat)
    with pytest.raises(ValueError, match="step_backend"):
        EngineConfig(step_backend="tpu")
