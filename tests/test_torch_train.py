"""The port's training path against ``repro``'s: the chunked loss and
``loss_fn`` with its gradients, remat, AdamW, ``make_train_step``,
``TrainLoop`` and the driver (``repro_torch.launch.train``).

Both packages start from the same numpy parameters (``repro``'s
``init_params`` through ``params_from_numpy``) and the same numpy batches.

Tolerances.  One operation in fp32 (a loss, its gradients, one AdamW
update, one train step): 1e-5, relative to each element and to the
reference's largest magnitude (the frameworks sum in other orders; the
observed differences are below 2e-6).  Multi-step histories in fp32 (six
``TrainLoop`` steps): losses 1e-5, parameters and moments 2e-5; AdamW's
first steps divide each gradient by its own size plus ``eps`` (1e-8), so
an element whose gradient is near zero carries its last-place difference
into a visible parameter change: 2.2e-6 is the largest seen over six
steps, dense and MoE, accum 1 and 2.  bf16 parameters: relative L2 2e-2.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.launch import train as jax_launch  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train import trainer as jax_trainer  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.moe import MoEConfig  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.tree import leaves, leaves_with_paths  # noqa: E402
from tests.test_models_lm import tiny_cfg  # noqa: E402

TOL_FP32 = 1e-5
TOL_HISTORY_PARAMS = 2e-5
TOL_BF16 = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL_FP32, what=""):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale, err_msg=what)


def _close_l2(got, want, tol=TOL_BF16):
    got, want = _np(got), _np(want)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), (
        np.linalg.norm(got - want) / np.linalg.norm(want))


def _by_path(jax_tree) -> dict:
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}


def _close_trees(got, want, tol=TOL_FP32):
    """Every leaf of the port's tree against ``repro``'s, by path."""
    mine, theirs = dict(leaves_with_paths(got)), _by_path(want)
    assert list(mine) == list(theirs)
    for k in mine:
        _close(mine[k], theirs[k], tol, what=k)


def port_cfg(jcfg) -> tf.LMConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["dtype"] = getattr(torch, jnp.dtype(jcfg.dtype).name)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(jcfg.moe))
    return tf.LMConfig(**kw)


@functools.lru_cache(maxsize=None)
def _model(moe: bool):
    """tiny_cfg in fp32 in both packages and repro's initial parameters."""
    jcfg = dataclasses.replace(tiny_cfg(moe), dtype=jnp.float32)
    return jcfg, port_cfg(jcfg), jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0),
                                                                             jcfg))


def _batch(cfg, seed=1, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = np.roll(toks, -1, axis=-1)
    labels[..., -1] = -1
    labels[..., 3] = -1
    return {"tokens": toks, "labels": labels}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 7, 5, 64])  # divides 24 tokens, does not, > tokens
def test_lm_loss_matches_repro(rng, chunk):
    hidden = rng.normal(size=(2, 12, 32)).astype(np.float32)
    head = (rng.normal(size=(32, 97)) / 6).astype(np.float32)
    labels = rng.integers(0, 97, (2, 12)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, 11] = -1

    def jax_loss(h, w):
        return jax_tf.lm_loss(h, w, jnp.asarray(labels), chunk)

    (want, want_count), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                        has_aux=True)(hidden, head)
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    got, count = tf.lm_loss(h, w, torch.from_numpy(labels), chunk)
    got.backward()
    assert float(count) == float(want_count) == 18
    _close(got, want)
    _close(h.grad, want_grads[0])
    _close(w.grad, want_grads[1])


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_loss_fn_value_and_grads_match_repro(moe):
    jcfg, cfg, tree = _model(moe)
    batch = _batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: jax_tf.loss_fn(p, jcfg, _jnp(batch)), has_aux=True))(_jnp(tree))
    params = tf.params_from_numpy(tree, device="cpu")
    live = [p.requires_grad_() for p in leaves(params)]
    got, got_m = tf.loss_fn(params, cfg, _torch(batch))
    grads = torch.autograd.grad(got, live)
    _close(got, want)
    assert got_m.keys() == want_m.keys()
    for k in got_m:
        _close(got_m[k], want_m[k], what=k)
    if moe:
        assert float(got.detach()) != float(got_m["lm_loss"].detach())  # the aux term is in
    want_g = _by_path(want_g)
    for (path, _), g in zip(leaves_with_paths(params), grads):
        _close(g, want_g[path], what=path)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_remat_on_and_off_equal(moe):
    """Checkpointed layers recompute the same values: loss and gradients are
    bit-identical on the CPU, and remat leaves no-grad forwards alone."""
    _, cfg, tree = _model(moe)
    batch = _torch(_batch(cfg, seed=5))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = tf.params_from_numpy(tree, device="cpu")
        live = [p.requires_grad_() for p in leaves(params)]
        loss, _ = tf.loss_fn(params, c, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, live)))
        with torch.no_grad():
            hidden, _ = tf.forward(params, c, batch["tokens"])
        out[-1] += (hidden,)
    (l1, g1, h1), (l2, g2, h2) = out
    assert torch.equal(l1, l2) and torch.equal(h1, h2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=1),
    dict(),
])
def test_schedule_matches_repro(cfg):
    mine, theirs = opt.AdamWConfig(**cfg), jax_opt.AdamWConfig(**cfg)
    steps = [0, 1, 2, 5, 9, 10, 11, 50, 99, 100, 101, 5000, 10000, 20000]
    got = [opt.schedule(mine, torch.tensor(s, dtype=torch.int32)) for s in steps]
    want = [jax_opt.schedule(theirs, jnp.asarray(s, jnp.int32)) for s in steps]
    for s, g, w in zip(steps, got, want):
        assert g.dtype == torch.float32
        _close(g, w, what=str(s))


def _opt_tree(rng, dtype):
    t = {"embed": rng.normal(size=(7, 5)), "layers": {"wq": rng.normal(size=(2, 5, 3)),
                                                      "g1": rng.normal(size=(2, 5))},
         "lm_head": rng.normal(size=(5, 7)) * 1e-3}
    return jax.tree.map(lambda x: np.asarray(x, np.float32).astype(dtype), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_update_matches_repro(rng, dtype, clip):
    """Three updates from the same parameters and gradients; the port's are
    in place (its moments and parameters are overwritten)."""
    jdt = jnp.dtype(dtype)
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=clip)
    params = _opt_tree(rng, jdt)
    mine = tf.params_from_numpy(params, device="cpu")
    state = opt.init(mine)
    theirs, jstate = _jnp(params), jax_opt.init(_jnp(params))
    for i in range(3):
        grads = _opt_tree(rng, jdt)
        _close(opt.global_norm(tf.params_from_numpy(grads, device="cpu")),
               jax_opt.global_norm(_jnp(grads)))
        out, state, m = opt.update(opt.AdamWConfig(**cfg), tf.params_from_numpy(grads, device="cpu"),
                                   state, mine)
        assert out is mine
        theirs, jstate, jm = jax_opt.update(jax_opt.AdamWConfig(**cfg), _jnp(grads), jstate, theirs)
        assert int(state.step) == int(jstate.step) == i + 1 and state.step.dtype == torch.int32
        _close(m["grad_norm"], jm["grad_norm"])
        _close(m["lr"], jm["lr"])
        _close_trees(state.mu, jstate.mu)
        _close_trees(state.nu, jstate.nu)
        for (path, p), j in zip(leaves_with_paths(mine), jax.tree.leaves(theirs)):
            assert p.dtype == getattr(torch, dtype), path
            if dtype == "float32":
                _close(p, j, what=path)
            else:
                _close_l2(p, j)
        assert all(m_.dtype == torch.float32 for m_ in leaves(state.mu) + leaves(state.nu))


# the four AdamW tests of tests/test_optimizer.py, on the port

def test_adamw_first_step_analytic():
    cfg = opt.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0, grad_clip=0.0,
                          warmup_steps=0, total_steps=10**9, min_lr_ratio=1.0)
    params = {"w": torch.tensor([1.0, -2.0])}
    grads = {"w": torch.tensor([0.5, -0.5])}
    state = opt.init(params)
    new_p, new_s, _ = opt.update(cfg, grads, state, params)
    # bias-corrected first step = lr * g/(|g| + eps) = lr * sign(g)
    np.testing.assert_allclose(new_p["w"].numpy(), [1.0 - 0.1, -2.0 + 0.1], rtol=1e-5)
    assert int(new_s.step) == 1


def test_adamw_converges_quadratic():
    cfg = opt.AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=1.0, warmup_steps=5,
                          total_steps=300)
    target = torch.tensor([3.0, -1.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.update(cfg, grads, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_grad_clip_caps_norm():
    cfg = opt.AdamWConfig(lr=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros(4)}
    grads = {"w": torch.full((4,), 100.0)}
    _, new_s, metrics = opt.update(cfg, grads, opt.init(params), params)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    # post-clip first moment has norm <= (1-b1)*clip
    assert float(torch.linalg.norm(new_s.mu["w"])) <= 0.1 + 1e-6


def test_schedule_shape():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(opt.schedule(cfg, 0)) == 0.0
    assert float(opt.schedule(cfg, 10)) == pytest.approx(1.0)
    assert float(opt.schedule(cfg, 100)) == pytest.approx(0.1, rel=1e-3)


# ---------------------------------------------------------------------------
# the train step and the loop
# ---------------------------------------------------------------------------

OPT_CFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@functools.lru_cache(maxsize=None)
def _jax_step(moe: bool, accum: int):
    jcfg, _, _ = _model(moe)
    return jax.jit(jax_trainer.make_train_step(lambda p, b: jax_tf.loss_fn(p, jcfg, b),
                                               jax_opt.AdamWConfig(**OPT_CFG), accum))


def _port_step(moe: bool, accum: int):
    _, cfg, _ = _model(moe)
    return trainer.make_train_step(lambda p, b: tf.loss_fn(p, cfg, b), opt.AdamWConfig(**OPT_CFG),
                                   accum)


def _accum_batches(data, accum, reshape):
    for b in data:
        yield {k: reshape(v, accum) for k, v in b.items()} if accum > 1 else b


@pytest.mark.parametrize("moe,accum", [(False, 1), (False, 2), (True, 1), (True, 2)],
                         ids=["dense-accum1", "dense-accum2", "moe-accum1", "moe-accum2"])
def test_train_step_matches_repro(moe, accum):
    """Two steps of ``make_train_step`` against ``repro``'s jitted step:
    every metric, the state and the parameters."""
    jcfg, cfg, tree = _model(moe)
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    jstep, step = _jax_step(moe, accum), _port_step(moe, accum)
    jp, jo = _jnp(tree), jax_opt.init(_jnp(tree))
    params = tf.params_from_numpy(tree, device="cpu")
    state = opt.init(params)
    for seed in (11, 12):
        batch = _batch(cfg, seed=seed, shape=shape)
        jp, jo, jm = jstep(jp, jo, _jnp(batch))
        params, state, m = step(params, state, _torch(batch))
        assert sorted(m) == sorted(jm)  # a jitted dict comes back in key order
        for k in m:
            _close(m[k], jm[k], what=k)
    _close_trees(params, jp)
    _close_trees(state, jo)


@pytest.mark.parametrize("moe,accum", [(False, 1), (True, 2)], ids=["dense-accum1", "moe-accum2"])
def test_train_loop_history_matches_repro(moe, accum):
    """Six ``TrainLoop`` steps of both packages on ``lm_data_iterator``'s
    stream (the same numpy batches) from the same parameters."""
    jcfg, cfg, tree = _model(moe)
    loop_cfg = dict(total_steps=6, log_every=1)
    logs, jlogs = [], []
    jloop = jax_trainer.TrainLoop(_jax_step(moe, accum), jax_trainer.LoopConfig(**loop_cfg),
                                  log=jlogs.append)
    jdata = _accum_batches(jax_launch.lm_data_iterator(jcfg, 2 * accum, 16, seed=3), accum,
                           lambda x, a: x.reshape(a, 2, 16))
    jp, jo, jh = jloop.run(_jnp(tree), jax_opt.init(_jnp(tree)), jdata)
    loop = trainer.TrainLoop(_port_step(moe, accum), trainer.LoopConfig(**loop_cfg),
                             log=logs.append)
    data = _accum_batches(launch.lm_data_iterator(cfg, 2 * accum, 16, seed=3, device="cpu"),
                          accum, lambda x, a: x.reshape(a, 2, 16))
    params = tf.params_from_numpy(tree, device="cpu")
    pp, po, hist = loop.run(params, opt.init(params), data)
    assert pp is params  # updated in place
    assert len(hist) == len(jh) == 6
    _close(hist, jh)
    _close_trees(pp, jp, TOL_HISTORY_PARAMS)
    _close_trees(po, jo, TOL_HISTORY_PARAMS)
    assert [m.split(" loss")[0] for m in logs] == [m.split(" loss")[0] for m in jlogs]


def _quadratic(lib):
    def loss_fn(params, batch):
        loss = lib.sum((params["w"] - batch) ** 2)
        return loss, {"loss": loss}
    return loss_fn


QUAD_OPT = dict(lr=0.3, warmup_steps=0, total_steps=20, weight_decay=0.0)


@pytest.mark.parametrize("skip", [True, False])
def test_nonfinite_step_matches_repro(skip):
    """A batch whose loss is infinite: skipped (the parameters after it are
    the ones before it, and no step is counted), or with ``skip_nonfinite``
    off applied (NaN parameters from then on), as in ``repro``."""
    data = [[1.0, 2.0, 3.0]] * 3 + [[math.inf] * 3] + [[1.0, 2.0, 3.0]] * 3
    loop_cfg = dict(total_steps=7, log_every=1, skip_nonfinite=skip)
    jlogs, logs = [], []
    jstep = jax.jit(jax_trainer.make_train_step(_quadratic(jnp), jax_opt.AdamWConfig(**QUAD_OPT)))
    jp, jo, jh = jax_trainer.TrainLoop(jstep, jax_trainer.LoopConfig(**loop_cfg),
                                       log=jlogs.append).run(
        {"w": jnp.zeros(3)}, jax_opt.init({"w": jnp.zeros(3)}), [jnp.asarray(b) for b in data])
    step = trainer.make_train_step(_quadratic(torch), opt.AdamWConfig(**QUAD_OPT))
    params = {"w": torch.zeros(3)}
    pp, po, hist = trainer.TrainLoop(step, trainer.LoopConfig(**loop_cfg), log=logs.append).run(
        params, opt.init(params), [torch.tensor(b) for b in data])
    assert [m.split(" (")[0] for m in logs] == [m.split(" (")[0] for m in jlogs]
    assert len(hist) == len(jh) == (6 if skip else 7)
    np.testing.assert_allclose(hist, jh, rtol=TOL_FP32)  # NaN equals NaN
    np.testing.assert_allclose(pp["w"].numpy(), np.asarray(jp["w"]), rtol=TOL_FP32)
    assert int(po.step) == int(jo.step) == (6 if skip else 7)
    if skip:
        assert any("non-finite loss, skipping update (1)" in m for m in logs)
        assert np.isfinite(pp["w"].numpy()).all()
    else:
        assert np.isnan(pp["w"].numpy()).all()


def test_too_many_nonfinite_steps_raise():
    step = trainer.make_train_step(_quadratic(torch), opt.AdamWConfig(**QUAD_OPT))
    params = {"w": torch.zeros(3)}
    before = params["w"].clone()
    loop = trainer.TrainLoop(step, trainer.LoopConfig(total_steps=10, max_consecutive_bad=2),
                             log=lambda *_: None)
    with pytest.raises(RuntimeError, match="too many consecutive non-finite steps"):
        loop.run(params, opt.init(params), [torch.full((3,), math.nan)] * 10)
    assert torch.equal(params["w"], before)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_lm_data_iterator_matches_repro():
    jcfg, cfg, _ = _model(False)
    mine = launch.lm_data_iterator(cfg, 3, 10, seed=4, device="cpu")
    theirs = jax_launch.lm_data_iterator(jcfg, 3, 10, seed=4)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_train_driver_loss_improves(tmp_path):
    """``tests/test_system.py::test_train_driver_loss_improves`` on the port."""
    cfg = tf.LMConfig(name="sys-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab_size=64, activation="swiglu", max_seq_len=32, loss_chunk=16,
                      kv_block=8)
    _, _, history = launch.train_lm(cfg, steps=25, batch=4, seq=24, lr=3e-3,
                                    ckpt_dir=str(tmp_path / "ck"), log=lambda *_: None,
                                    device="cpu")
    assert len(history) == 25
    assert history[-1] < history[0], "training must reduce loss"


def test_main_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "grok-1-314b", "--steps", "4", "--device", "cpu", "--ckpt-dir", ck,
            "--accum", "2", "--set", "n_layers=1"]
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] grok-1-314b: loss " in out and "improved" in out
    argv[3] = "6"
    assert launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "[trainer] restored checkpoint at step 4" in out
    assert launch.main(["--arch", "minitron-8b", "--steps", "2", "--device", "cpu"]) == 0
    assert "[train] minitron-8b: loss " in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit", "schnet", "graphcast", "din"])
def test_non_lm_archs_refused(arch):
    """An unknown id is a ``KeyError``, as in ``repro``'s registry."""
    with pytest.raises(KeyError, match="unknown arch"):
        launch.main(["--arch", arch + "-x", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit", "schnet", "graphcast", "din"])
def test_non_lm_archs_run_their_smoke(arch, capsys):
    """A GNN or recsys id runs its config's smoke (one train step on
    synthetic data) and prints its finite loss, as ``repro``'s driver does."""
    assert launch.main(["--arch", arch, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith(f"[train] {arch} smoke: {{'loss': ")
    assert math.isfinite(float(out.split("'loss': ")[1].rstrip("}")))


def test_sge_refused():
    """An unknown id near ``sge`` is a ``KeyError``, as in ``repro``'s registry."""
    with pytest.raises(KeyError, match="unknown arch 'sge-x'"):
        launch.main(["--arch", "sge-x", "--device", "cpu"])


def test_sge_runs_its_smoke(capsys):
    """``sge`` runs its config's smoke (an enumeration checked against the
    sequential oracle) and prints its matches and states."""
    assert launch.main(["--arch", "sge", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out == ("[train] sge smoke: {'matches': 39.0, 'states': 72.0, "
                   "'engine_uploads': 1.0}")


def test_training_entry_points_default_to_the_card():
    _, cfg, _ = _model(False)
    if torch.cuda.is_available():
        assert next(launch.lm_data_iterator(cfg, 1, 4))["tokens"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.lm_data_iterator(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.train_lm(cfg, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "minitron-8b", "--steps", "1"])
