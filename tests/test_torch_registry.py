"""The port's cell registry against ``repro.configs.registry``, on the CPU.

* ``tests/test_configs_registry.py``'s checks on the port: the 11
  architectures, the 40 + 4 cell matrix, the five skipped ``long_500k``
  cells, ``model_flops`` and one smoke per architecture;
* every cell against ``repro``'s of the same name: kind, skip reason, note,
  ``donate``, ``model_flops`` (exactly), argument shapes, dtypes mapped
  (``repro``'s ``uint32`` bitmap words are the port's ``int32``) and the
  logical trees; every port argument is a ``device="meta"`` tensor and no
  build makes a concrete tensor.  The ``sge`` cells are the port's packs of
  one: every state field carries the pack axis (``[1, ...]``, logical
  ``None``), the plan's ``n_p`` is ``[1]``, ``repro``'s CSR ``seg_iota``
  is the port's ``deg_cap`` and the dense plan adds ``rows`` (``adj_bits``
  is a view of it);
* the cells' functions on small shapes against ``repro``'s, from the same
  numpy inputs and ``repro``'s parameters (``params_from_numpy``): the
  ``sge`` rounds (dense and CSR) field by field, rings read from their
  base; minitron's ``SMOKE`` in fp32 through the prefill, decode and train
  cells; gcn-cora's train cell; din's serve cell; and ``sge.smoke``.

Tolerances: integers exactly; fp32 1e-5 relative to each element and to
the reference's largest magnitude (``tests/test_torch_lm.py``,
``tests/test_torch_train.py``, ``tests/test_torch_gnn.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

from repro.configs import din as jax_din  # noqa: E402
from repro.configs import gcn_cora as jax_gcn_cora  # noqa: E402
from repro.configs import gnn_common as jax_gc  # noqa: E402
from repro.configs import lm_common as jax_lm  # noqa: E402
from repro.configs import minitron_8b as jax_minitron  # noqa: E402
from repro.configs import registry as jax_registry  # noqa: E402
from repro.configs import sge as jax_sge  # noqa: E402
from repro.core import EngineConfig as JaxConfig  # noqa: E402
from repro.core import engine as jax_eng  # noqa: E402
from repro.core import extend as jax_extend  # noqa: E402
from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core.plan import build_csr_plan as jax_build_csr_plan  # noqa: E402
from repro.core.plan import build_plan as jax_build_plan  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.recsys import din as jax_din_mod  # noqa: E402
from repro_torch.configs import din, gcn_cora, gnn_common, lm_common, minitron_8b  # noqa: E402
from repro_torch.configs import registry, sge  # noqa: E402
from repro_torch.core import EngineConfig, extend  # noqa: E402
from repro_torch.core.frontier import EngineState, init_state  # noqa: E402
from repro_torch.core.plan import PLAN_ARRAY_FIELDS, plan_from_numpy  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import params_from_numpy  # noqa: E402
from repro_torch.models.recsys import din as din_mod  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.tree import leaves, leaves_with_paths  # noqa: E402

CPU = "cpu"
TOL = 1e-5

ARCHS = sorted(registry.load_all())
JAX_CELLS = {c.name: c for c in jax_registry.all_cells()}
CELLS = {c.name: c for c in registry.all_cells()}

LM_ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b", "nemotron-4-15b", "minitron-8b",
            "stablelm-12b"]
GNN_ARCHS = ["gcn-cora", "graphcast", "schnet", "graphsage-reddit"]


# ---------------------------------------------------------------------------
# tests/test_configs_registry.py on the port
# ---------------------------------------------------------------------------

def test_all_assigned_archs_registered():
    for a in LM_ARCHS + GNN_ARCHS + ["din", "sge"]:
        assert a in ARCHS
    assert len(ARCHS) == 11


def test_cell_matrix_complete():
    cells = registry.all_cells()
    assigned = [c for c in cells if c.arch != "sge"]
    assert len(assigned) == 40  # 10 archs x 4 shapes
    skipped = [c for c in assigned if c.build is None]
    # exactly the five full-attention long_500k cells are skipped
    assert sorted(c.arch for c in skipped) == sorted(LM_ARCHS)
    assert all(c.shape == "long_500k" for c in skipped)
    assert all(c.skip_reason for c in skipped)
    sge_cells = [c for c in cells if c.arch == "sge"]
    # 3 dense collection rounds + the sparse-CSR pdbsv1 round
    assert len(sge_cells) == 4
    assert len(registry.all_cells(include_skipped=False)) == 39


def test_cells_have_model_flops():
    for cell in registry.all_cells(include_skipped=False):
        b = cell.build()
        assert b.model_flops > 0, cell.name
        assert len(b.args) == len(b.logical), cell.name


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke(arch):
    out = registry.get(arch).smoke(device=CPU)
    assert isinstance(out, dict) and out


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError, match=r"unknown arch 'sge-x'; have \['din', "):
        registry.get("sge-x")


def test_helpers():
    assert registry.round_up(10, 4) == 12 and registry.round_up(12, 4) == 12
    assert gnn_common.round_up is registry.round_up
    d = registry.abstract_dict({"a": ((2, 3), torch.bfloat16), "b": ((), torch.int32)})
    assert [(tuple(t.shape), t.dtype, t.is_meta) for t in d.values()] == [
        ((2, 3), torch.bfloat16, True), ((), torch.int32, True)]


def test_archs_match_repro():
    """Names, families, notes and the cells' names, kinds and order."""
    mine, theirs = registry.load_all(), jax_registry.load_all()
    assert sorted(mine) == sorted(theirs)  # registration follows import order
    assert [m.replace("repro_torch.", "repro.") for m in registry.ARCH_MODULES] == \
        jax_registry.ARCH_MODULES
    for name, a in mine.items():
        b = theirs[name]
        assert (a.name, a.family, a.notes) == (b.name, b.family, b.notes)
        assert [(c.shape, c.kind) for c in a.cells.values()] == \
            [(c.shape, c.kind) for c in b.cells.values()]


# ---------------------------------------------------------------------------
# every cell against repro's
# ---------------------------------------------------------------------------

class _NoConcrete(TorchDispatchMode):
    """Records every operator that returns a tensor which is not meta."""

    def __init__(self):
        super().__init__()
        self.concrete = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and not t.is_meta for t in tree_flatten(out)[0]):
            self.concrete.append(str(func))
        return out


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dtype(sds) -> torch.dtype:
    name = np.dtype(sds.dtype).name
    return torch.int32 if name == "uint32" else getattr(torch, name)


def _check_sge_args(b, jb):
    """The pack-of-one layout against repro's: plan fields by name, state
    fields with the pack axis in front."""
    (plan, state), (jplan, jstate) = b.args, jb.args
    (plan_log, state_log), (jplan_log, jstate_log) = b.logical, jb.logical
    for name, x in jplan._asdict().items():
        if name == "seg_iota":  # the CSR walk width: an int in the port
            assert plan.deg_cap == x.shape[0]
            assert plan_log.deg_cap is None and getattr(jplan_log, name) == (None,)
            continue
        got, log = getattr(plan, name), getattr(plan_log, name)
        want_shape, want_log = x.shape, getattr(jplan_log, name)
        if name == "n_p":  # one per pack lane
            want_shape, want_log = (1,), (None,)
        assert (tuple(got.shape), got.dtype, log) == (want_shape, _dtype(x), want_log), name
    assert plan.p_pad == plan.n_p_max == sge.P_PAD
    if hasattr(plan, "rows"):
        n_elab, _, n_t, w = plan.adj_bits.shape
        assert tuple(plan.rows.shape) == (n_elab * 2 * n_t + 1, w)
        assert plan.adj_bits._base is plan.rows
        assert plan_log.rows == (None, "tensor")
    assert list(EngineState._fields) == list(jstate._fields)
    for name, x in jstate._asdict().items():
        got = getattr(state, name)
        assert (tuple(got.shape), got.dtype, getattr(state_log, name)) == (
            (1,) + x.shape, _dtype(x), (None,) + getattr(jstate_log, name)), name


@pytest.mark.parametrize("name", sorted(JAX_CELLS))
def test_cell_matches_repro(name):
    cell, jcell = CELLS[name], JAX_CELLS[name]
    assert (cell.name, cell.arch, cell.shape, cell.kind, cell.skip_reason) == (
        jcell.name, jcell.arch, jcell.shape, jcell.kind, jcell.skip_reason)
    if jcell.build is None:
        assert cell.build is None
        return
    with _NoConcrete() as mode:
        b = cell.build()
    assert mode.concrete == []
    jb = jcell.build()
    assert (b.note, b.donate) == (jb.note, jb.donate)
    assert type(b.model_flops) is float and b.model_flops == jb.model_flops
    assert len(b.args) == len(jb.args) == len(b.logical) == len(jb.logical)
    tensors = [x for x in leaves(b.args) if isinstance(x, torch.Tensor)]
    assert tensors and all(x.is_meta for x in tensors)
    if cell.arch == "sge":
        _check_sge_args(b, jb)
        return
    mine, theirs = dict(leaves_with_paths(b.args)), _jax_leaves(jb.args)
    assert list(mine) == list(theirs)
    for path, x in theirs.items():
        assert (tuple(mine[path].shape), mine[path].dtype) == (x.shape, _dtype(x)), path
    assert b.logical == jb.logical


# ---------------------------------------------------------------------------
# the cells' functions on small shapes
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what=""):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL * scale, err_msg=what)


def _close_trees(got, want):
    mine, theirs = dict(leaves_with_paths(got)), _jax_leaves(want)
    assert list(mine) == list(theirs)
    for k in mine:
        _close(mine[k], theirs[k], what=k)


def _shapes(tree) -> list:
    return [tuple(x.shape) for x in leaves(tree) if isinstance(x, torch.Tensor)]


RINGS = ("st_depth", "st_map", "st_used", "st_cand")


def _from_base(x, base):
    """A ``[V, S, ...]`` ring read from each worker's ``base``."""
    s_cap = x.shape[1]
    idx = (base[:, None] + np.arange(s_cap)) % s_cap
    return np.take_along_axis(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)), axis=1)


def _assert_states_equal(st, jst, what):
    for name, a, b in zip(EngineState._fields, st, jst):
        if name == "base":
            continue
        b = np.asarray(b)
        a = a[0].numpy()
        a = a.view(b.dtype) if b.dtype == np.uint32 else a
        if name in RINGS:
            a = _from_base(a, st.base[0].numpy())
            b = _from_base(b, np.asarray(jst.base))
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {what}")


SGE_KW = dict(n_workers=4, expand_width=4, steal_chunk=4, rebalance_interval=8)
SGE_N = 200


@pytest.fixture(scope="module")
def sge_instance():
    tgt = jax_graphgen.random_graph(SGE_N, 700, n_labels=3, seed=3)
    pat = jax_graphgen.extract_pattern(tgt, 6, seed=4)
    return tgt, pat


@pytest.mark.parametrize("csr", [False, True], ids=["dense", "csr"])
def test_sge_round_matches_repro(sge_instance, csr):
    """Two rounds of the cell's ``fn`` from ``init_state`` on a 200-node
    target with 4 × 4 lanes, from one plan (``repro``'s, carried across),
    equal ``repro``'s cell rounds field by field; the dense cell's concrete
    plan and state have the cell's abstract shapes."""
    tgt, pat = sge_instance
    w = sge._w_for(SGE_N)
    if csr:
        jplan = jax_build_csr_plan(pat, tgt, variant=sge.CSR_VARIANT, p_pad=sge.P_PAD,
                                   max_parents=sge.MAX_PARENTS, w=w)
        b, jb = sge.build_csr_round(SGE_N, EngineConfig(**SGE_KW)), \
            jax_sge.build_csr_round(SGE_N, JaxConfig(**SGE_KW))
        jcfg = JaxConfig(step_backend="csr", **SGE_KW)
        cfg = EngineConfig(step_backend="csr", use_pallas=True, **SGE_KW)
    else:
        jplan = jax_build_plan(pat, JaxPacked.from_graph(tgt, pad_words_to=128),
                               variant="ri-ds-si-fc", p_pad=sge.P_PAD,
                               max_parents=sge.MAX_PARENTS)
        b, jb = sge.build_round(SGE_N, EngineConfig(**SGE_KW)), \
            jax_sge.build_round(SGE_N, JaxConfig(**SGE_KW))
        jcfg, cfg = JaxConfig(**SGE_KW), EngineConfig(**SGE_KW)
    d = {f: getattr(jplan, f) for f in PLAN_ARRAY_FIELDS}
    d["csr"] = jplan.csr
    plan = plan_from_numpy(d)
    assert plan.w == w and plan.p_pad == sge.P_PAD
    arrays = extend.plan_arrays_for(cfg, [plan], CPU)
    st = init_state(plan, cfg, CPU)
    assert _shapes(st) == _shapes(b.args[1])
    if not csr:
        assert _shapes(arrays) == _shapes(b.args[0])
    jround = jax.jit(jb.fn)
    jarrays, jst = jax_extend.plan_arrays_for(jcfg, jplan), jax_eng.init_state(jplan, jcfg)
    for i in (1, 2):
        st, jst = b.fn(arrays, st), jround(jarrays, jst)
        _assert_states_equal(st, jst, f"after {i} rounds")
    assert int(st.states.sum()) > 0 and int(st.steps[0]) == 2 * SGE_KW["rebalance_interval"]


def test_sge_smoke_matches_repro():
    mine, theirs = sge.smoke(device=CPU), jax_sge.smoke()
    assert (mine["matches"], mine["states"]) == (theirs["matches"], theirs["states"])
    assert mine["engine_uploads"] == theirs["engine_compiles"] == 1.0


def _lm_cfgs():
    """minitron's ``SMOKE`` in fp32 in both packages, and ``repro``'s
    parameters with the port's copy of them."""
    jcfg = dataclasses.replace(jax_minitron.SMOKE, dtype=jnp.float32)
    cfg = dataclasses.replace(minitron_8b.SMOKE, dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, tree


def test_lm_serving_cells_match_repro():
    """``build_prefill`` at batch 2 × seq 16, then ``build_decode`` (KV
    length 32) on a 16-token prefill's cache: logits and caches."""
    jcfg, cfg, tree = _lm_cfgs()
    params = params_from_numpy(tree, device=CPU)
    toks = jax_graphgen.lm_batch(2, 16, cfg.vocab_size, seed=3)["tokens"]
    b, jb = lm_common.build_prefill(cfg, 2, 16), jax_lm.build_prefill(jcfg, 2, 16)
    assert _shapes(params) == _shapes(b.args[0]) and tuple(b.args[1].shape) == toks.shape
    logits, cache = b.fn(params, torch.from_numpy(toks))
    jlogits, jcache = jax.jit(jb.fn)(tree, jnp.asarray(toks))
    _close(logits, jlogits, "prefill logits")
    for a, c in zip(cache, jcache):
        _close(a, c, "prefill cache")
    b, jb = lm_common.build_decode(cfg, 2, 32), jax_lm.build_decode(jcfg, 2, 32)
    _, cache = tf.prefill(params, cfg, torch.from_numpy(toks), max_len=32)
    _, jcache = jax_tf.prefill(tree, jcfg, jnp.asarray(toks), max_len=32)
    assert _shapes(cache) == _shapes(b.args[1])
    nxt = np.array([[5], [9]], np.int32)
    logits, cache = b.fn(params, cache, torch.from_numpy(nxt), torch.tensor(16, dtype=torch.int32))
    jlogits, jcache = jax.jit(jb.fn)(tree, jcache, jnp.asarray(nxt), jnp.int32(16))
    _close(logits, jlogits, "decode logits")
    for a, c in zip(cache, jcache):
        _close(a, c, "decode cache")


def test_lm_train_cell_matches_repro():
    """One step of ``build_train`` (``OPT``) at batch 2 × seq 16: metrics,
    parameters and the optimizer state."""
    jcfg, cfg, tree = _lm_cfgs()
    b, jb = lm_common.build_train(cfg, 2, 16), jax_lm.build_train(jcfg, 2, 16)
    batch = jax_graphgen.lm_batch(2, 16, cfg.vocab_size, seed=5)
    params = params_from_numpy(tree, device=CPU)
    state = opt.init(params)
    assert _shapes((params, state)) == _shapes(b.args[:2])
    params, state, metrics = b.fn(params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    jp, jo, jm = jax.jit(jb.fn)(tree, jax_lm.opt_mod.init(tree), batch)
    assert sorted(metrics) == sorted(jm)
    for k in metrics:
        _close(metrics[k], jm[k], k)
    _close_trees(params, jp)
    _close_trees(state, jo)


def test_gcn_cell_matches_repro():
    """gcn-cora's train cell on a 512-node graph: one step's metrics and
    parameters."""
    shape = gnn_common.SMOKE_SHAPE
    b = gnn_common.build_cell(gcn_cora.MODEL, shape)
    jmd = jax_gcn_cora.ARCH.cells["full_graph_sm"].build.args[0]  # repro's GnnModelDef
    jb = jax_gc.build_cell(jmd, shape)
    tree = jax.tree.map(np.asarray, jax_common.init_from_specs(
        jax.random.PRNGKey(0), jax_gcn_cora.gcn.param_specs(jax_gcn_cora.CFG, shape.d_feat,
                                                            shape.d_out)))
    arrays = gnn_common.batch_arrays(shape, False, False, seed=2)
    params = params_from_numpy(tree, device=CPU)
    state = opt.init(params)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    assert _shapes((params, state, batch)) == _shapes(b.args)
    params, state, metrics = b.fn(params, state, batch)
    jp, _, jm = jax.jit(jb.fn)(tree, jax_gc.opt_mod.init(tree), arrays)
    for k in metrics:
        _close(metrics[k], jm[k], k)
    _close_trees(params, jp)


def test_din_serve_cell_matches_repro():
    """din's serve cell at ``SMOKE_CFG`` on 16 rows: the scores."""
    cfg, jcfg = din.SMOKE_CFG, jax_din.SMOKE_CFG
    b, jb = din.build_serve(cfg, 16), jax_din.build_serve(jcfg, 16)
    tree = jax.tree.map(np.asarray, jax_common.init_from_specs(
        jax.random.PRNGKey(1), jax_din_mod.param_specs(jcfg)))
    arrays = jax_graphgen.din_batch(16, cfg.seq_len, cfg.n_items, cfg.n_cats, cfg.d_dense,
                                    seed=4)
    arrays.pop("click")
    params = params_from_numpy(tree, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    assert _shapes((params, batch)) == _shapes(b.args)
    with torch.no_grad():
        scores = b.fn(params, batch)
    _close(scores, jax.jit(jb.fn)(tree, arrays), "scores")
    assert din_mod.param_specs(cfg).keys() == jax_din_mod.param_specs(jcfg).keys()
