"""The port's GNN family against ``repro``'s: the message-passing substrate,
GCN, GraphSAGE, SchNet and GraphCast (forward, loss, gradients, one train
step), their configs, the synthetic batches and the neighbour sampler.

Both packages start from the same parameters (``repro``'s
``init_from_specs(PRNGKey(0), specs)`` carried over with
``params_from_numpy``) and the same numpy batches.

Tolerances, fp32: forward outputs and losses within 1e-5 of the
reference's largest magnitude; gradients within 1e-4 of each leaf's largest
magnitude (the frameworks sum in other orders, and a gather's backward adds
its edges in another order); one train step's parameters within 1e-5 in
relative L2 over the tree.  Data and sampled blocks are equal byte for byte.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.configs import gnn_common as jax_gc  # noqa: E402
from repro.configs import graphcast as jax_graphcast_cfg  # noqa: E402
from repro.configs import gcn_cora as jax_gcn_cfg  # noqa: E402
from repro.configs import graphsage_reddit as jax_sage_cfg  # noqa: E402
from repro.configs import schnet as jax_schnet_cfg  # noqa: E402
from repro.core.graph import Graph as JaxGraph  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.gnn import common as jax_gcommon  # noqa: E402
from repro.models.gnn import gcn as jax_gcn  # noqa: E402
from repro.models.gnn import graphcast as jax_graphcast  # noqa: E402
from repro.models.gnn import sage as jax_sage  # noqa: E402
from repro.models.gnn import sampler as jax_sampler  # noqa: E402
from repro.models.gnn import schnet as jax_schnet  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.configs import gcn_cora, gnn_common, graphcast as graphcast_cfg  # noqa: E402
from repro_torch.configs import graphsage_reddit, schnet as schnet_cfg  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.models.gnn import common as gcommon  # noqa: E402
from repro_torch.models.gnn import gcn, graphcast, sage, schnet  # noqa: E402
from repro_torch.models.gnn import sampler as sampler_mod  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
CPU = "cpu"

# (port config module, repro config module, port model module, repro model module)
MODELS = {
    "gcn-cora": (gcn_cora, jax_gcn_cfg, gcn, jax_gcn),
    "graphsage-reddit": (graphsage_reddit, jax_sage_cfg, sage, jax_sage),
    "schnet": (schnet_cfg, jax_schnet_cfg, schnet, jax_schnet),
    "graphcast": (graphcast_cfg, jax_graphcast_cfg, graphcast, jax_graphcast),
}
# one small shape per task: node classification, a sampled block read from a
# feature table, per-graph regression
TASK_SHAPES = {
    "node_cls": gnn_common.GnnShape(200, 700, 12, 5, "node_cls").padded(),
    "block_cls": gnn_common.GnnShape(200, 700, 12, 5, "block_cls", table_nodes=300).padded(),
    "graph_reg": gnn_common.GnnShape(120, 256, 8, 1, "graph_reg", n_graphs=4).padded(),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL, what=""):
    want = _np(want).astype(np.float64)
    scale = max(1e-30, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(_np(got).astype(np.float64) - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _tensors(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _carried(jax_specs, seed=0):
    """``repro``'s parameters and the same values as port tensors."""
    jp = jax_common.init_from_specs(jax.random.PRNGKey(seed), jax_specs)
    return jp, common.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


@functools.lru_cache(maxsize=None)
def _model_params(name, d_in, d_out):
    """``repro``'s parameters of model ``name`` (its SMOKE, else CFG), drawn
    once per shape: repro's eager draws compile per leaf shape."""
    return jax_common.init_from_specs(
        jax.random.PRNGKey(0), MODELS[name][3].param_specs(_cfgs(name)[1], d_in, d_out))


def _carried_model(name, d_in, d_out):
    jp = _model_params(name, d_in, d_out)
    return jp, common.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def _cfgs(name):
    mod, jmod, _, _ = MODELS[name]
    return mod.MODEL, (getattr(jmod, "SMOKE", None) or jmod.CFG)


def _batch(md, shape, seed=0):
    arrays = gnn_common.batch_arrays(shape, md.with_positions, md.with_mesh, seed=seed)
    return {k: jnp.asarray(v) for k, v in arrays.items()}, _tensors(arrays)


# ---------------------------------------------------------------------------
# counterparts of tests/test_models_gnn.py
# ---------------------------------------------------------------------------

def test_segment_ops():
    data = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    seg = torch.tensor([0, 0, 1, 1])
    np.testing.assert_allclose(_np(gcommon.segment_sum(data, seg, 2)), [[3.0], [7.0]])
    np.testing.assert_allclose(_np(gcommon.segment_mean(data, seg, 2)), [[1.5], [3.5]])
    np.testing.assert_allclose(_np(gcommon.segment_max(data, seg, 2)), [[2.0], [4.0]])


def test_sym_norm_weights():
    # path 0-1-2 (directed both ways)
    src = torch.tensor([0, 1, 1, 2])
    dst = torch.tensor([1, 0, 2, 1])
    w = _np(gcommon.sym_norm_weights(src, dst, 3))
    # deg+1: node0=2, node1=3, node2=2
    np.testing.assert_allclose(w[0], 1 / np.sqrt(2 * 3), rtol=1e-6)
    np.testing.assert_allclose(w[2], 1 / np.sqrt(3 * 2), rtol=1e-6)


def test_gcn_node_permutation_equivariance(rng):
    """Relabeling nodes permutes GCN outputs identically."""
    cfg = gcn.GCNConfig(n_layers=2, d_hidden=8)
    n, e, f = 10, 30, 5
    params = common.init_from_specs(gcn.param_specs(cfg, f, 3), 0, CPU)
    feats = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    out = gcn.forward(params, cfg, {"feats": feats, "src": src, "dst": dst})
    perm = rng.permutation(n)
    inv = torch.from_numpy(np.argsort(perm))
    batch_p = {"feats": feats[perm], "src": inv[src.long()], "dst": inv[dst.long()]}
    out_p = gcn.forward(params, cfg, batch_p)
    np.testing.assert_allclose(_np(out_p), _np(out)[perm], rtol=1e-4, atol=1e-5)


def test_schnet_translation_invariance(rng):
    """SchNet depends on positions only through distances."""
    cfg = schnet.SchNetConfig(n_interactions=2, d_hidden=8, n_rbf=6, cutoff=4.0)
    n, e, f = 8, 20, 4
    params = common.init_from_specs(schnet.param_specs(cfg, f, 2), 0, CPU)
    batch = _tensors({
        "feats": rng.normal(size=(n, f)).astype(np.float32),
        "src": rng.integers(0, n, e).astype(np.int32),
        "dst": rng.integers(0, n, e).astype(np.int32),
        "positions": rng.normal(size=(n, 3)).astype(np.float32),
    })
    out1 = schnet.forward(params, cfg, batch)
    out2 = schnet.forward(params, cfg, dict(batch, positions=batch["positions"] + 100.0))
    np.testing.assert_allclose(_np(out1), _np(out2), rtol=2e-3, atol=1e-4)


def _ring_csr(n=60):
    edges = [(i, (i + 1) % n) for i in range(n)] + [(i, (i + 7) % n) for i in range(n)]
    return Graph.from_edges(n, edges, undirected=True).csr()[:2], edges


def test_neighbor_sampler_block_validity(rng):
    (indptr, indices), _ = _ring_csr()
    n = 60
    labels = rng.integers(0, 5, n)
    s = sampler_mod.NeighborSampler(indptr, indices, labels, fanout=(3, 2), seed=0)
    seeds = rng.choice(n, size=8, replace=False)
    block = s.sample(seeds)
    n_pad, e_pad = sampler_mod.block_shape(8, (3, 2))
    assert block.feats_idx.shape == (n_pad,)
    assert block.src.shape == (e_pad,)
    # real edges reference valid local ids
    assert block.src[: block.n_edges].max() < block.n_nodes
    assert block.dst[: block.n_edges].max() < block.n_nodes
    # labels present exactly on seeds
    assert np.all(block.labels[:8] == labels[seeds])
    assert np.all(block.labels[8:] == -1)
    # local->global mapping consistent: seed rows match
    assert np.array_equal(block.feats_idx[:8], seeds)


def test_bucket_balancer_on_skewed_blocks(rng):
    sizes = rng.pareto(1.2, 128) * 100 + 10
    n = 16
    asg = sampler_mod.balance_buckets(sizes, n)
    # LPT: makespan within 4/3 of the lower bound max(mean, biggest item)
    makespan = np.bincount(asg, weights=sizes, minlength=n).max()
    opt_lb = max(sizes.sum() / n, sizes.max())
    assert makespan <= 4.0 / 3.0 * opt_lb + 1e-9
    np.testing.assert_array_equal(asg, jax_sampler.balance_buckets(sizes, n))


# ---------------------------------------------------------------------------
# the substrate against repro
# ---------------------------------------------------------------------------

def test_segment_max_empty_segment_and_tied_gradient():
    """An empty segment is -inf in both; tied maxima (a duplicated edge)
    split the gradient equally in both."""
    data = np.asarray([[1.0, 5.0], [1.0, 2.0], [3.0, 2.0], [0.5, 4.0]], np.float32)
    seg = np.asarray([0, 0, 2, 2], np.int32)
    want = jax_gcommon.segment_max(jnp.asarray(data), jnp.asarray(seg), 4)
    got = gcommon.segment_max(torch.from_numpy(data), torch.from_numpy(seg), 4)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert np.all(np.isneginf(_np(got)[[1, 3]]))

    def jf(x):
        out = jax_gcommon.segment_max(x, jnp.asarray(seg), 4)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * jnp.arange(1.0, 9.0).reshape(4, 2))

    jg = jax.grad(jf)(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    out = gcommon.segment_max(x, torch.from_numpy(seg), 4)
    w = torch.arange(1.0, 9.0).reshape(4, 2)
    torch.where(torch.isfinite(out), out, 0.0).mul(w).sum().backward()
    np.testing.assert_array_equal(_np(x.grad), np.asarray(jg))
    assert _np(x.grad)[0, 0] == _np(x.grad)[1, 0] == 0.5  # the tie in segment 0


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_aggregators_and_gathers_against_repro(rng, agg):
    data = rng.normal(size=(40, 6)).astype(np.float32)
    seg = rng.integers(0, 12, 40).astype(np.int32)  # some segments empty
    jf = lambda x: jax_gcommon.AGGREGATORS[agg](x, jnp.asarray(seg), 15)  # noqa: E731
    want = jf(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = gcommon.AGGREGATORS[agg](x, torch.from_numpy(seg), 15)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    cot = rng.normal(size=(15, 6)).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jnp.where(jnp.isfinite(jf(v)), jf(v), 0.0) * cot))(
        jnp.asarray(data))
    torch.where(torch.isfinite(got), got, 0.0).mul(torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(x.grad), np.asarray(jg), rtol=1e-6, atol=1e-6)
    idx = rng.integers(0, 40, 25).astype(np.int32)
    np.testing.assert_array_equal(
        _np(gcommon.gather_src(torch.from_numpy(data), torch.from_numpy(idx))),
        np.asarray(jax_gcommon.gather_src(jnp.asarray(data), jnp.asarray(idx))))


def test_sym_norm_weights_and_masked_ce_against_repro(rng):
    src = rng.integers(0, 30, 90).astype(np.int32)
    dst = rng.integers(0, 30, 90).astype(np.int32)
    _close(gcommon.sym_norm_weights(torch.from_numpy(src), torch.from_numpy(dst), 30),
           jax_gcommon.sym_norm_weights(jnp.asarray(src), jnp.asarray(dst), 30), 1e-6)
    logits = rng.normal(size=(30, 7)).astype(np.float32) * 3
    labels = rng.integers(-1, 7, 30).astype(np.int32)
    got = gcommon.masked_softmax_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_gcommon.masked_softmax_ce(jnp.asarray(logits), jnp.asarray(labels))
    _close(got[0], want[0], 1e-6)
    assert float(got[1]) == float(want[1])
    none = np.full(30, -1, np.int32)  # nothing labelled: 0 over a count floored at 1
    assert float(gcommon.masked_softmax_ce(torch.from_numpy(logits),
                                           torch.from_numpy(none))[0]) == 0.0


def test_mlp_specs_and_apply_against_repro(rng):
    dims = [6, 9, 4]
    js = jax_gcommon.mlp_specs(dims, "m")
    ps = gcommon.mlp_specs(dims, "m")
    assert {k: (s.shape, s.logical, s.init) for k, s in ps.items()} == \
        {k: (s.shape, s.logical, s.init) for k, s in js.items()}
    jp, tp = _carried(js)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    for final_act in (False, True):
        _close(gcommon.mlp_apply(tp, "m", torch.from_numpy(x), 2, final_act=final_act),
               jax_gcommon.mlp_apply(jp, "m", jnp.asarray(x), 2, final_act=final_act))


def test_rbf_expand_and_linspace_against_repro(rng):
    for cutoff in (10.0, 5.0, 4.0, 0.3):
        for n in (1, 2, 6, 8, 50, 300):
            np.testing.assert_array_equal(_np(schnet.rbf_centres(cutoff, n)),
                                          np.asarray(jnp.linspace(0.0, cutoff, n)))
    for n, cutoff in ((300, 10.0), (8, 5.0), (6, 4.0)):
        dist = (rng.random(50) * cutoff * 1.2).astype(np.float32)
        _close(schnet.rbf_expand(torch.from_numpy(dist), n, cutoff),
               jax_schnet.rbf_expand(jnp.asarray(dist), n, cutoff), 1e-6)
    x = rng.normal(size=100).astype(np.float32) * 5
    _close(schnet.ssp(torch.from_numpy(x)), jax_schnet.ssp(jnp.asarray(x)), 1e-6)


# ---------------------------------------------------------------------------
# the models against repro, with carried parameters
# ---------------------------------------------------------------------------

def _value_and_grads(jax_loss, port_loss, jp, tp, jbatch, tbatch):
    (jl, jm), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jp, jbatch)
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tl, tm = port_loss(live, tbatch)
    grads = dict(zip(live, torch.autograd.grad(tl, list(live.values()))))
    return (jl, jm, jg), (tl, tm, grads)


@pytest.mark.parametrize("name,task", [(name, "node_cls") for name in sorted(MODELS)] + [
    ("graphsage-reddit", "block_cls"), ("schnet", "block_cls"), ("gcn-cora", "graph_reg")])
def test_model_forward_loss_and_grads_against_repro(name, task):
    """Each model at its SMOKE width (gcn and graphsage at CFG, which is
    small) under the task's loss glue, with ``repro``'s parameters: every
    model on node classification, and each other task's glue (a block read
    from a feature table, per-graph regression) through one model or two."""
    md, jcfg = _cfgs(name)
    shape = TASK_SHAPES[task]
    jmd_fwd = MODELS[name][3].forward
    cfg = md.smoke_cfg or md.cfg
    jp, tp = _carried_model(name, shape.d_feat, shape.d_out)
    jbatch, tbatch = _batch(md, shape, seed=3)
    jloss = jax_gc.task_loss(lambda p, b: jmd_fwd(p, jcfg, b), shape)
    tloss = gnn_common.task_loss(lambda p, b: md.forward(p, cfg, b), shape)
    (jl, _, jg), (tl, _, tg) = _value_and_grads(jloss, tloss, jp, tp, jbatch, tbatch)
    _close(tl, jl, what="loss")
    for k in jg:
        _close(tg[k], jg[k], GRAD_TOL, what=f"grad {k}")
    if task == "node_cls":
        with torch.no_grad():
            want = jax.jit(lambda p, b: jmd_fwd(p, jcfg, b))(jp, jbatch)
            _close(md.forward(tp, cfg, tbatch), want, what="forward")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_loss_fn_against_repro(name):
    """Each model's own ``loss_fn`` (schnet's three branches: per-graph
    energies, labels, node targets; graphcast's two)."""
    md, jcfg = _cfgs(name)
    cfg = md.smoke_cfg or md.cfg
    _, _, mod, jmod = MODELS[name]
    rng = np.random.default_rng(5)
    shapes = {"labels": TASK_SHAPES["node_cls"]}
    if name in ("schnet", "graphcast"):
        shapes["targets"] = dataclasses.replace(TASK_SHAPES["node_cls"], d_out=3)
    if name == "schnet":
        shapes["graph"] = TASK_SHAPES["graph_reg"]
    for branch, shape in shapes.items():
        jp, tp = _carried_model(name, shape.d_feat, shape.d_out)
        arrays = gnn_common.batch_arrays(shape, md.with_positions, md.with_mesh, seed=4)
        if branch == "targets":
            arrays.pop("labels")
            arrays["targets"] = rng.normal(size=(shape.n_nodes, shape.d_out)).astype(np.float32)
        jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
        (jl, jm, jg), (tl, tm, tg) = _value_and_grads(
            lambda p, b: jmod.loss_fn(p, jcfg, b), lambda p, b: mod.loss_fn(p, cfg, b),
            jp, tp, jbatch, _tensors(arrays))
        _close(tl, jl, what=f"{branch} loss")
        assert sorted(tm) == sorted(jm)
        for k in jm:
            _close(tm[k], jm[k], what=f"{branch} metric {k}")
        for k in jg:
            _close(tg[k], jg[k], GRAD_TOL, what=f"{branch} grad {k}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_train_step_against_repro(name):
    """One ``make_train_step`` step (``OPT``): parameters within 1e-5 in
    relative L2, the loss and grad norm within 1e-5."""
    md, jcfg = _cfgs(name)
    cfg = md.smoke_cfg or md.cfg
    shape = TASK_SHAPES["node_cls"]
    jmod = MODELS[name][3]
    jp, tp = _carried_model(name, shape.d_feat, shape.d_out)
    jbatch, tbatch = _batch(md, shape, seed=6)
    jstep = jax.jit(jax_trainer.make_train_step(
        jax_gc.task_loss(lambda p, b: jmod.forward(p, jcfg, b), shape), jax_gc.OPT))
    jp2, _, jmet = jstep(jp, jax_opt.init(jp), jbatch)
    step = make_train_step(gnn_common.task_loss(lambda p, b: md.forward(p, cfg, b), shape),
                           gnn_common.OPT)
    tp2, state, tmet = step(tp, opt.init(tp), tbatch)
    assert int(state.step) == 1
    for k in ("loss_total", "grad_norm", "lr"):
        _close(tmet[k], jmet[k], what=k)
    diff = sum(float(((tp2[k].double() - torch.from_numpy(np.asarray(v, np.float64))) ** 2).sum())
               for k, v in jp2.items())
    norm = sum(float((np.asarray(v, np.float64) ** 2).sum()) for v in jp2.values())
    assert (diff / norm) ** 0.5 <= TOL


def test_graphcast_processor_layers_are_checkpointed():
    """Under gradients each processor layer runs inside
    ``torch.utils.checkpoint`` (its forward twice); without, once."""
    md, _ = _cfgs("graphcast")
    cfg = md.smoke_cfg
    shape = TASK_SHAPES["node_cls"]
    params = common.init_from_specs(graphcast.param_specs(cfg, shape.d_feat, shape.d_out), 0, CPU)
    _, batch = _batch(md, shape)
    calls = []
    orig = graphcast._proc_layer

    def counted(*a):
        calls.append(1)
        return orig(*a)

    graphcast._proc_layer = counted
    try:
        with torch.no_grad():
            graphcast.forward(params, cfg, batch)
        assert len(calls) == cfg.n_layers
        calls.clear()
        p = {k: v.requires_grad_() for k, v in params.items()}
        graphcast.forward(p, cfg, batch).square().sum().backward()
        assert len(calls) == 2 * cfg.n_layers
        assert p["proc_edge_w0"].grad.shape == (cfg.n_layers, 3 * cfg.d_hidden, cfg.d_hidden)
    finally:
        graphcast._proc_layer = orig


# ---------------------------------------------------------------------------
# configs, shapes, data and the sampler
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else np.dtype(dt).name


def _spec_table(specs):
    return {k: (tuple(s.shape), tuple(s.logical), s.init, s.scale, _dtype_name(s.dtype))
            for k, s in specs.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_specs_and_flops_equal_at_cfg(name):
    """Names, shapes, logical axes, init and scale of every parameter, and
    ``fwd_flops``, equal ``repro``'s at CFG and SMOKE on every shape
    (shapes only: nothing is computed)."""
    mod, jmod, pmod, jpmod = MODELS[name]
    assert dataclasses.asdict(mod.CFG) == dataclasses.asdict(jmod.CFG)
    if hasattr(jmod, "SMOKE"):
        assert dataclasses.asdict(mod.SMOKE) == dataclasses.asdict(jmod.SMOKE)
    shapes, jshapes = gnn_common.gnn_shapes(), jax_gc.gnn_shapes()
    for sname, shape in shapes.items():
        for cfg, jcfg in ((mod.CFG, jmod.CFG), (mod.MODEL.smoke_cfg, getattr(jmod, "SMOKE", None))):
            if cfg is None:
                continue
            assert _spec_table(pmod.param_specs(cfg, shape.d_feat, shape.d_out)) == \
                _spec_table(jpmod.param_specs(jcfg, shape.d_feat, shape.d_out))
        assert mod.fwd_flops(mod.CFG, shape) == jmod.fwd_flops(jmod.CFG, jshapes[sname])
    assert mod.MODEL.name == jmod.ARCH.name == name


def test_gnn_shapes_equal():
    got = {k: dataclasses.asdict(v) for k, v in gnn_common.gnn_shapes().items()}
    want = {k: dataclasses.asdict(v) for k, v in jax_gc.gnn_shapes().items()}
    assert got == want
    assert gnn_common.round_up(10, 4) == 12 and gnn_common.round_up(12, 4) == 12


@pytest.mark.parametrize("task", sorted(TASK_SHAPES))
@pytest.mark.parametrize("pos,mesh", [(False, False), (True, False), (False, True)])
def test_batch_concrete_equals_repro(task, pos, mesh):
    shape = TASK_SHAPES[task]
    want = jax_gc.batch_concrete(shape, pos, mesh, seed=7)
    got = gnn_common.batch_concrete(shape, pos, mesh, seed=7, device=CPU)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == getattr(torch, v.dtype.name), k
        np.testing.assert_array_equal(_np(got[k]), v, err_msg=k)


def test_graphgen_model_inputs_equal_repro():
    for kw in (dict(n_classes=5), dict(with_positions=True, n_graphs=4), dict()):
        want = jax_graphgen.gnn_batch(96, 300, 7, seed=3, **kw)
        got = graphgen.gnn_batch(96, 300, 7, seed=3, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    for n in (5, 100, 512):
        want, got = jax_graphgen.mesh_overlay(n, seed=2), graphgen.mesh_overlay(n, seed=2)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
        assert graphgen.mesh_overlay_shapes(n) == jax_graphgen.mesh_overlay_shapes(n)
        assert {k: v.shape for k, v in got.items()} == \
            {k: s for k, (s, _) in graphgen.mesh_overlay_shapes(n).items()}
    assert graphgen.MESH_OVERLAY_LOGICAL == jax_graphgen.MESH_OVERLAY_LOGICAL
    for r in range(7):
        assert graphgen.icosa_mesh_shape(r) == jax_graphgen.icosa_mesh_shape(r)
    assert graphgen.icosa_mesh_shape(6)[0] == 40962


def test_neighbor_sampler_blocks_equal_repro(rng):
    """The same seed draws the same blocks, call after call."""
    (indptr, indices), edges = _ring_csr(80)
    jindptr, jindices, _ = JaxGraph.from_edges(80, edges, undirected=True).csr()
    np.testing.assert_array_equal(indptr, jindptr)
    labels = rng.integers(0, 6, 80)
    for fanout, seed in (((3, 2), 0), ((15, 10), 5), ((4,), 9)):
        ours = sampler_mod.NeighborSampler(indptr, indices, labels, fanout, seed=seed)
        theirs = jax_sampler.NeighborSampler(jindptr, jindices, labels, fanout, seed=seed)
        assert sampler_mod.block_shape(16, fanout) == jax_sampler.block_shape(16, fanout)
        for _ in range(3):
            seeds = rng.choice(80, size=16, replace=False)
            a, b = ours.sample(seeds), theirs.sample(seeds)
            for f in ("feats_idx", "src", "dst", "labels"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
            assert (a.n_nodes, a.n_edges) == (b.n_nodes, b.n_edges)


def test_sampled_block_through_sage_against_repro():
    """A sampled block (padding ids -1 in ``feats_idx``) through
    GraphSAGE's ``block_cls`` loss: the padded rows are zeroed in both."""
    (indptr, indices), _ = _ring_csr(60)
    labels = np.random.default_rng(1).integers(0, 5, 60)
    block = sampler_mod.NeighborSampler(indptr, indices, labels, (3, 2), seed=0).sample(
        np.arange(8))
    assert (block.feats_idx < 0).any()
    table = np.random.default_rng(2).normal(size=(60, 6)).astype(np.float32)
    arrays = {"table": table, "feats_idx": block.feats_idx.astype(np.int32), "src": block.src,
              "dst": block.dst, "labels": block.labels.astype(np.int32)}
    n_pad, e_pad = sampler_mod.block_shape(8, (3, 2))
    shape = gnn_common.GnnShape(n_pad, e_pad, 6, 5, "block_cls", table_nodes=60)
    cfg = sage.SAGEConfig(d_hidden=8)
    jp, tp = _carried(jax_sage.param_specs(cfg, 6, 5))
    jl, _ = jax.jit(jax_gc.task_loss(lambda p, b: jax_sage.forward(p, cfg, b), shape))(
        jp, {k: jnp.asarray(v) for k, v in arrays.items()})
    tl, _ = gnn_common.task_loss(lambda p, b: sage.forward(p, cfg, b), shape)(tp, _tensors(arrays))
    _close(tl, jl)


# ---------------------------------------------------------------------------
# parameters and entry points
# ---------------------------------------------------------------------------

def test_init_from_specs():
    specs = {"b": common.ParamSpec((3, 4), (None, None)),
             "a": common.ParamSpec((5,), (None,), init="zeros"),
             "c": common.ParamSpec((2, 2), (None, None), init="ones"),
             "d": common.ParamSpec((400, 300), (None, None), scale=0.01)}
    p = common.init_from_specs(specs, 3, CPU)
    assert list(p) == list(specs)
    assert torch.equal(p["a"], torch.zeros(5)) and torch.equal(p["c"], torch.ones(2, 2))
    assert abs(float(p["d"].std()) - 0.01) < 5e-4
    gen = torch.Generator().manual_seed(3)  # leaves drawn in sorted key order
    want_b = torch.randn(12, generator=gen).mul_(3 ** -0.5).reshape(3, 4)
    assert torch.equal(p["b"], want_b)
    again = common.init_from_specs(specs, torch.Generator().manual_seed(3), CPU)
    assert all(torch.equal(p[k], again[k]) for k in specs)
    with pytest.raises(ValueError, match="unknown init"):
        common.init_param((2,), "uniform", torch.float32, gen, torch.device(CPU))
    assert transformer.params_from_numpy is common.params_from_numpy


def test_entry_points_default_to_the_card():
    shape = TASK_SHAPES["node_cls"]
    specs = gcn.param_specs(gcn_cora.CFG, shape.d_feat, shape.d_out)
    if torch.cuda.is_available():
        assert common.init_from_specs(specs)["w0"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.init_from_specs(specs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn_common.batch_concrete(shape, False, False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gnn_common.gnn_smoke(gcn_cora.MODEL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graphcast_cfg.smoke()
