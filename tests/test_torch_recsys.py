"""The port's recsys family against ``repro``'s: lookups and embedding bags,
DIN's training loss with its gradients, one train step, pointwise scoring,
retrieval scoring with its top-k, the config and the synthetic batches.

Both packages start from the same parameters (``repro``'s
``init_from_specs(PRNGKey(0), specs)`` carried over with
``params_from_numpy``) and the same numpy batches.  Tolerances as in
``tests/test_torch_gnn.py``: values within 1e-5 of the reference's largest
magnitude, gradients within 1e-4 of each leaf's largest, one train step's
parameters within 1e-5 in relative L2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.configs import din as jax_din_cfg  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.recsys import din as jax_din  # noqa: E402
from repro.models.recsys import embedding as jax_emb  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.configs import din as din_cfg  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.recsys import din as din_mod  # noqa: E402
from repro_torch.models.recsys.embedding import embedding_bag, lookup, table_spec  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

TOL = 1e-5
GRAD_TOL = 1e-4
CPU = "cpu"
SMALL = din_mod.DINConfig(embed_dim=4, seq_len=5, attn_mlp=(8, 4), mlp=(16, 8),
                          n_items=40, n_cats=7, d_dense=3)


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


def _jax_cfg(cfg):
    return jax_din.DINConfig(**dataclasses.asdict(cfg))


def _carried(cfg, seed=0):
    jp = jax_common.init_from_specs(jax.random.PRNGKey(seed), jax_din.param_specs(_jax_cfg(cfg)))
    return jp, common.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def _din_setup(rng, batch=6):
    """tests/test_models_recsys.py's setup, on the port."""
    params = common.init_from_specs(din_mod.param_specs(SMALL), 0, CPU)
    batch_d = _tensors({
        "hist_items": rng.integers(0, 40, (batch, 5)).astype(np.int32),
        "hist_cats": rng.integers(0, 7, (batch, 5)).astype(np.int32),
        "hist_len": rng.integers(1, 6, batch).astype(np.int32),
        "target_item": rng.integers(0, 40, batch).astype(np.int32),
        "target_cat": rng.integers(0, 7, batch).astype(np.int32),
        "dense": rng.normal(size=(batch, 3)).astype(np.float32),
        "click": rng.integers(0, 2, batch).astype(np.int32),
    })
    return SMALL, params, batch_d


# ---------------------------------------------------------------------------
# counterparts of tests/test_models_recsys.py
# ---------------------------------------------------------------------------

def test_embedding_bag_against_loop(rng):
    table = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    ids = torch.tensor([3, 7, -1, 7, 2, -1, -1, 11], dtype=torch.int32)
    bags = torch.tensor([0, 0, 0, 1, 1, 1, 2, 3], dtype=torch.int32)
    out_sum = embedding_bag(table, ids, bags, 4, mode="sum")
    out_mean = embedding_bag(table, ids, bags, 4, mode="mean")
    expect = np.zeros((4, 6), np.float32)
    counts = np.zeros(4)
    for t, b in zip(ids.tolist(), bags.tolist()):
        if t >= 0:
            expect[b] += _np(table[t])
            counts[b] += 1
    np.testing.assert_allclose(_np(out_sum), expect, rtol=1e-6)
    np.testing.assert_allclose(_np(out_mean), expect / np.maximum(counts, 1)[:, None], rtol=1e-6)
    with pytest.raises(ValueError):
        embedding_bag(table, ids, bags, 4, mode="max")


def test_embedding_bag_weighted(rng):
    table = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    ids = torch.tensor([1, 2], dtype=torch.int32)
    bags = torch.tensor([0, 0], dtype=torch.int32)
    w = torch.tensor([0.5, 2.0])
    out = embedding_bag(table, ids, bags, 1, weights=w)
    expect = 0.5 * _np(table[1]) + 2.0 * _np(table[2])
    np.testing.assert_allclose(_np(out[0]), expect, rtol=1e-6)


def test_din_loss_and_grad(rng):
    cfg, params, batch = _din_setup(rng)
    live = {k: v.requires_grad_() for k, v in params.items()}
    loss, _ = din_mod.loss_fn(live, cfg, batch)
    grads = torch.autograd.grad(loss, list(live.values()))
    assert torch.isfinite(loss)
    assert 0.2 < float(loss.detach()) < 2.0  # ~ln 2 at init
    for g in grads:
        assert bool(torch.isfinite(g).all())


def test_din_history_mask(rng):
    """Positions beyond hist_len must not influence the score."""
    cfg, params, batch = _din_setup(rng, batch=2)
    batch["hist_len"] = torch.tensor([2, 5], dtype=torch.int32)
    s1 = din_mod.score(params, cfg, batch)
    hist = batch["hist_items"].clone()
    hist[0, 2:] = (hist[0, 2:] + 13) % 40  # change masked-out items of row 0
    s2 = din_mod.score(params, cfg, dict(batch, hist_items=hist))
    np.testing.assert_allclose(float(s1[0]), float(s2[0]), rtol=1e-5)
    # row 1 uses all 5 positions; leave it untouched -> identical anyway
    np.testing.assert_allclose(float(s1[1]), float(s2[1]), rtol=1e-5)


def test_score_candidates_matches_pointwise(rng):
    """Retrieval wide-scoring == calling score per candidate."""
    cfg, params, batch = _din_setup(rng, batch=1)
    nc = 9
    cand = {
        "hist_items": batch["hist_items"], "hist_cats": batch["hist_cats"],
        "hist_len": batch["hist_len"],
        "cand_items": torch.from_numpy(rng.integers(0, 40, nc).astype(np.int32)),
        "cand_cats": torch.from_numpy(rng.integers(0, 7, nc).astype(np.int32)),
        "dense": batch["dense"],
    }
    wide = din_mod.score_candidates(params, cfg, cand)
    for i in range(nc):
        single = dict(batch, target_item=cand["cand_items"][i:i + 1],
                      target_cat=cand["cand_cats"][i:i + 1])
        s = din_mod.score(params, cfg, single)
        np.testing.assert_allclose(float(wide[i]), float(s[0]), rtol=1e-4, atol=1e-5)


def test_lookup_clamps_negative():
    table = torch.arange(12.0).reshape(4, 3)
    out = lookup(table, torch.tensor([-1, 2]))
    np.testing.assert_allclose(_np(out[0]), _np(table[0]))
    np.testing.assert_allclose(_np(out[1]), _np(table[2]))


# ---------------------------------------------------------------------------
# against repro
# ---------------------------------------------------------------------------

def test_lookup_and_embedding_bag_against_repro(rng):
    table = rng.normal(size=(30, 5)).astype(np.float32)
    ids = rng.integers(-1, 30, (4, 6)).astype(np.int32)
    np.testing.assert_array_equal(_np(lookup(torch.from_numpy(table), torch.from_numpy(ids))),
                                  np.asarray(jax_emb.lookup(jnp.asarray(table), jnp.asarray(ids))))
    flat = ids.reshape(-1)
    bags = np.sort(rng.integers(0, 7, flat.size)).astype(np.int32)
    w = rng.random(flat.size).astype(np.float32)
    for mode in ("sum", "mean"):
        for weights in (None, w):
            want = jax_emb.embedding_bag(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags),
                                         8, mode=mode,
                                         weights=None if weights is None else jnp.asarray(w))
            got = embedding_bag(torch.from_numpy(table), torch.from_numpy(flat),
                                torch.from_numpy(bags), 8, mode=mode,
                                weights=None if weights is None else torch.from_numpy(w))
            _close(got, want, 1e-6, what=mode)


def _batch(cfg, b, seed):
    arrays = graphgen.din_batch(b, cfg.seq_len, cfg.n_items, cfg.n_cats, cfg.d_dense, seed=seed)
    return {k: jnp.asarray(v) for k, v in arrays.items()}, _tensors(arrays)


@pytest.mark.parametrize("cfg", [SMALL, din_cfg.SMOKE_CFG], ids=["small", "smoke"])
def test_din_loss_grads_and_scores_against_repro(cfg):
    """``loss_fn`` and every gradient (the tables' dense), ``score`` and
    ``score_candidates`` with ``repro``'s parameters."""
    jcfg = _jax_cfg(cfg)
    jp, tp = _carried(cfg)
    jb, tb = _batch(cfg, 16, seed=3)
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p, b: jax_din.loss_fn(p, jcfg, b),
                                             has_aux=True))(jp, jb)
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tl, tm = din_mod.loss_fn(live, cfg, tb)
    tg = dict(zip(live, torch.autograd.grad(tl, list(live.values()))))
    _close(tl, jl, what="loss")
    _close(tm["loss"], jl, what="metric")
    for k in jg:
        assert tg[k].shape == jg[k].shape and tg[k].layout == torch.strided, k
        _close(tg[k], jg[k], GRAD_TOL, what=f"grad {k}")
    with torch.no_grad():
        _close(din_mod.score(tp, cfg, tb), jax.jit(lambda p, b: jax_din.score(p, jcfg, b))(jp, jb))
        cand = {"hist_items": tb["hist_items"][:1], "hist_cats": tb["hist_cats"][:1],
                "hist_len": tb["hist_len"][:1], "dense": tb["dense"][:1],
                "cand_items": torch.arange(64, dtype=torch.int32) * 7 % cfg.n_items,
                "cand_cats": torch.arange(64, dtype=torch.int32) % cfg.n_cats}
        want = jax.jit(lambda p, b: jax_din.score_candidates(p, jcfg, b))(
            jp, {k: jnp.asarray(_np(v)) for k, v in cand.items()})
        _close(din_mod.score_candidates(tp, cfg, cand), want)


def test_train_step_against_repro():
    """One ``make_train_step`` step (``OPT``) at SMOKE_CFG: parameters
    within 1e-5 in relative L2; the dense table gradient moves (decays) the
    rows no batch touched exactly as ``repro``'s AdamW does."""
    cfg = din_cfg.SMOKE_CFG
    jcfg = _jax_cfg(cfg)
    jp, tp = _carried(cfg, seed=1)
    jb, tb = _batch(cfg, 8, seed=0)
    jstep = jax.jit(jax_trainer.make_train_step(lambda p, b: jax_din.loss_fn(p, jcfg, b),
                                                jax_din_cfg.OPT))
    jp2, _, jmet = jstep(jp, jax_opt.init(jp), jb)
    start = {k: v.clone() for k, v in tp.items()}
    step = make_train_step(lambda p, b: din_mod.loss_fn(p, cfg, b), din_cfg.OPT)
    tp2, _, tmet = step(tp, opt.init(tp), tb)
    for k in ("loss_total", "grad_norm", "lr"):
        _close(tmet[k], jmet[k], what=k)
    diff = sum(float(((tp2[k].double() - torch.from_numpy(np.asarray(v, np.float64))) ** 2).sum())
               for k, v in jp2.items())
    norm = sum(float((np.asarray(v, np.float64) ** 2).sum()) for v in jp2.values())
    assert (diff / norm) ** 0.5 <= TOL
    touched = np.unique(np.concatenate([_np(tb["hist_items"]).ravel(),
                                        _np(tb["target_item"])]))
    untouched = np.setdiff1d(np.arange(cfg.n_items), touched)
    assert untouched.size > 0
    moved = tp2["item_table"][untouched] - start["item_table"][untouched]
    assert bool((moved != 0).any())  # weight decay on every row
    _close(tp2["item_table"][untouched], np.asarray(jp2["item_table"])[untouched], 1e-6)


def test_score_candidates_topk_against_repro():
    """``torch.topk`` against ``jax.lax.top_k`` over the same scores:
    values equal within 1e-5; indices equal wherever the value is not tied."""
    cfg = din_cfg.SMOKE_CFG
    jcfg = _jax_cfg(cfg)
    jp, tp = _carried(cfg, seed=2)
    jb, tb = _batch(cfg, 1, seed=5)
    nc = 2048  # more candidates than items: tied scores are certain
    cand = {"hist_items": tb["hist_items"], "hist_cats": tb["hist_cats"],
            "hist_len": tb["hist_len"], "dense": tb["dense"],
            "cand_items": torch.arange(nc, dtype=torch.int32) % cfg.n_items,
            "cand_cats": torch.arange(nc, dtype=torch.int32) % cfg.n_cats}
    jv, ji = jax.jit(lambda p, b: jax.lax.top_k(jax_din.score_candidates(p, jcfg, b), 100))(
        jp, {k: jnp.asarray(_np(v)) for k, v in cand.items()})
    with torch.no_grad():
        tv, ti = torch.topk(din_mod.score_candidates(tp, cfg, cand), 100)
    _close(tv, jv)
    jv, ji, ti = np.asarray(jv), np.asarray(ji), _np(ti)
    ties = np.isin(jv, jv[np.r_[np.diff(jv) == 0, False] | np.r_[False, np.diff(jv) == 0]])
    assert ties.any()
    np.testing.assert_array_equal(ti[~ties], ji[~ties])


def test_param_specs_equal_at_cfg():
    """Names, shapes, logical axes, init and scale at CFG, SMOKE_CFG and the
    test config (shapes only), and the configs and FLOP counts."""
    for cfg in (din_cfg.CFG, din_cfg.SMOKE_CFG, SMALL):
        got = {k: (s.shape, s.logical, s.init, s.scale) for k, s in
               din_mod.param_specs(cfg).items()}
        want = {k: (s.shape, s.logical, s.init, s.scale) for k, s in
                jax_din.param_specs(_jax_cfg(cfg)).items()}
        assert got == want
        assert all(s.dtype == torch.float32 for s in din_mod.param_specs(cfg).values())
        assert cfg.d_emb == _jax_cfg(cfg).d_emb
    assert dataclasses.asdict(din_cfg.CFG) == dataclasses.asdict(jax_din_cfg.CFG)
    assert dataclasses.asdict(din_cfg.SMOKE_CFG) == dataclasses.asdict(jax_din_cfg.SMOKE_CFG)
    assert din_cfg.OPT == opt.AdamWConfig(**dataclasses.asdict(jax_din_cfg.OPT))
    for b in (65536, 512, 262144, 1_000_000):  # the four cells' batches
        assert din_cfg._score_flops(din_cfg.CFG, b) == jax_din_cfg._score_flops(jax_din_cfg.CFG, b)
    spec = table_spec(10, 3)
    assert (spec.shape, spec.logical, spec.scale) == ((10, 3), ("tensor", None), 0.01)


def test_din_batch_equals_repro():
    for args in ((8, 10, 1000, 50, 8, 0), (33, 100, 10_000_000, 10_000, 8, 4)):
        want, got = jax_graphgen.din_batch(*args), graphgen.din_batch(*args)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    tb = din_cfg.batch_tensors(din_cfg.SMOKE_CFG, 8, seed=0, device=CPU)
    want = jax_graphgen.din_batch(8, 10, 1000, 50, 8, seed=0)
    for k, v in want.items():
        np.testing.assert_array_equal(_np(tb[k]), v)


def test_din_smoke_on_the_cpu():
    out = din_cfg.smoke(device=CPU)
    assert set(out) == {"loss"} and np.isfinite(out["loss"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert din_cfg.batch_tensors(din_cfg.SMOKE_CFG, 2)["dense"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        din_cfg.smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        din_cfg.batch_tensors(din_cfg.SMOKE_CFG, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.init_from_specs(din_mod.param_specs(SMALL))
