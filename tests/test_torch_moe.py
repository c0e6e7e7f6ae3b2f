"""The port's MoE layer and MoE LMs against ``repro.models.moe`` and
``repro.models.transformer`` (grok-1's and kimi-k2's ``SMOKE``).

Weights are ``repro``'s own (``init_params`` from a PRNG key) carried across
by `repro_torch.models.transformer.params_from_numpy`, or drawn with numpy
and handed to both.  Tolerances:

- fp32: 1e-5, relative to each element and to the reference's largest
  magnitude (the frameworks differ in the order of fp32 sums only), and
  the same (token, k) pairs kept and dropped;
- bf16: 2e-2 in relative L2 norm, the tolerance of ``repro``'s own
  decode-vs-prefill test (``tests/test_models_lm.py``): the two round some
  bf16 intermediates (the expert SwiGLU, attention outputs) to neighbouring
  values; elementwise (2e-2) for the port's own decode-vs-prefill, as in
  ``repro``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.configs import grok_1_314b as jax_grok  # noqa: E402
from repro.configs import kimi_k2_1t_a32b as jax_kimi  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import grok_1_314b, kimi_k2_1t_a32b  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL_FP32 = 1e-5
TOL_BF16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODELS = {"grok": (jax_grok, grok_1_314b), "kimi": (jax_kimi, kimi_k2_1t_a32b)}


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL_FP32):
    """Elementwise: ``|got - want| <= tol · (|want| + max(1, max |want|))``."""
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _close_l2(got, want, tol=TOL_BF16):
    """``‖got - want‖₂ <= tol · ‖want‖₂``."""
    got, want = _np(got), _np(want)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), (
        np.linalg.norm(got - want) / np.linalg.norm(want))


def _cfgs(model: str, dt: str = "float32", **kw):
    """``SMOKE`` of ``model`` in both packages, in dtype ``dt``, with ``kw``
    replaced (``moe_kw`` replaces fields of its MoEConfig)."""
    jmod, mod = MODELS[model]
    jdt, tdt = DTYPES[dt]
    moe_kw = kw.pop("moe_kw", {})
    jcfg = dataclasses.replace(jmod.SMOKE, dtype=jdt, **kw)
    cfg = dataclasses.replace(mod.SMOKE, dtype=tdt, **kw)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _params(jcfg):
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    return tree, tf.params_from_numpy(tree, device="cpu")


def _moe_inputs(rng, t, d, e, f, router_scale=1.0):
    x = rng.normal(size=(t, d)).astype(np.float32)
    router = (rng.normal(size=(d, e)) * router_scale / np.sqrt(d)).astype(np.float32)
    wg, wu = (rng.normal(size=(e, d, f)).astype(np.float32) / np.sqrt(d) for _ in range(2))
    wd = rng.normal(size=(e, f, d)).astype(np.float32) / np.sqrt(f)
    return x, router, wg, wu, wd


def _repro_kept(x, router, cfg):
    """The (token, k) pairs ``repro``'s dispatch keeps, as flat ids."""
    t = x.shape[0]
    logits = jnp.asarray(x) @ jnp.asarray(router)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    g = jax_moe.n_groups(cfg, t)
    tg = t // g
    c = jax_moe.capacity(cfg, tg)
    _, _, tok_s, _, keep = jax.vmap(lambda te: jax_moe._dispatch_one_group(
        cfg.n_experts, c, te, jnp.zeros_like(te, jnp.float32)))(top_e.reshape(g, tg, -1))
    tok_s, keep = np.asarray(tok_s), np.asarray(keep)
    top_e = np.asarray(top_e)
    kept = set()
    for gi in range(g):
        seen = {}
        for tok, kp in zip(tok_s[gi], keep[gi]):
            j = seen.get(tok, 0)
            seen[tok] = j + 1
            if kp:
                kept.add((gi * tg + int(tok), j))
    # repro's pairs of one token come out in ascending expert order; name
    # each by its position in top_e instead
    order = np.argsort(top_e, axis=1)
    return {int(tok) * cfg.top_k + int(order[tok, j]) for tok, j in kept}


# ---------------------------------------------------------------------------
# MoEConfig, groups, capacity
# ---------------------------------------------------------------------------

def test_moe_config_groups_and_capacity_match_repro():
    assert [(f.name, f.default) for f in dataclasses.fields(moe.MoEConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jax_moe.MoEConfig)]
    for e, k, cf, r, groups in [(8, 2, 1.25, 64, 32), (384, 8, 1.25, 64, 32), (4, 2, 0.3, 8, 4),
                                (2, 1, 100.0, 4, 1), (8, 4, 4.0, 1, 6)]:
        mine = moe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf,
                             capacity_round=r, dispatch_groups=groups)
        theirs = jax_moe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf,
                                   capacity_round=r, dispatch_groups=groups)
        for t in (1, 2, 7, 12, 64, 96, 1000, 4096, 8192):
            assert moe.n_groups(mine, t) == jax_moe.n_groups(theirs, t), (e, t)
            assert moe.capacity(mine, t) == jax_moe.capacity(theirs, t), (e, t)


# ---------------------------------------------------------------------------
# moe_ffn and the aux loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,e,k,groups,cf,rnd,router_scale", [
    (12, 4, 2, 8, 1.25, 8, 1.0),     # T not divisible by dispatch_groups: 4 groups
    (7, 4, 2, 32, 1.25, 8, 1.0),     # one group
    (32, 8, 4, 4, 1.25, 8, 1.0),     # several groups
    (32, 4, 2, 4, 0.5, 1, 3.0),      # overflowing experts: pairs dropped
    (40, 8, 1, 2, 0.3, 1, 4.0),      # top-1, heavy drops
    (24, 6, 3, 32, 2.0, 4, 1.0),
])
def test_moe_ffn_matches_repro(rng, t, e, k, groups, cf, rnd, router_scale):
    d, f = 16, 24
    cfg = dict(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf, capacity_round=rnd,
               dispatch_groups=groups)
    mine, theirs = moe.MoEConfig(**cfg), jax_moe.MoEConfig(**cfg)
    args = _moe_inputs(rng, t, d, e, f, router_scale=router_scale)
    want, want_aux = jax_moe.moe_ffn(*map(jnp.asarray, args), theirs)
    got, aux = moe.moe_ffn(*map(_t, args), mine)
    _close(got, want)
    _close(aux, want_aux)
    logits, _, top_e = moe.route(_t(args[0]), _t(args[1]), mine)
    disp = moe.dispatch(top_e, mine)
    kept = _repro_kept(args[0], args[1], theirs)
    assert set(disp.pairs.tolist()) == kept
    assert int(disp.counts.sum()) == len(kept) and len(disp.pairs) == len(kept)
    assert disp.capacity == jax_moe.capacity(theirs, t // jax_moe.n_groups(theirs, t))
    if cf < 1:
        assert len(kept) < t * k  # the case drops pairs
    # expert-major: the experts of the kept pairs never decrease
    experts = top_e.reshape(-1)[disp.pairs]
    assert bool((experts[1:] >= experts[:-1]).all())


def test_moe_ffn_bf16_matches_repro(rng):
    d, f, t = 32, 48, 48
    cfg = dict(n_experts=8, top_k=2, d_ff_expert=f, capacity_round=4, dispatch_groups=4)
    args = _moe_inputs(rng, t, d, 8, f)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jargs[1] = jnp.asarray(args[1])  # the router stays fp32
    want, want_aux = jax_moe.moe_ffn(*jargs, jax_moe.MoEConfig(**cfg))
    targs = [_t(np.asarray(a)) for a in jargs]
    got, aux = moe.moe_ffn(*targs, moe.MoEConfig(**cfg))
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close_l2(got, want)
    _close(aux, want_aux)


def test_moe_combine_is_deterministic(rng):
    cfg = moe.MoEConfig(n_experts=8, top_k=4, d_ff_expert=24, capacity_round=4,
                        capacity_factor=0.7, dispatch_groups=4)
    args = [_t(a).to(torch.bfloat16) for a in _moe_inputs(rng, 64, 16, 8, 24)]
    a, _ = moe.moe_ffn(*args, cfg)
    b, _ = moe.moe_ffn(*args, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_capacity_and_combination(rng, groups):
    """``tests/test_models_lm.py``'s case: top-1 routing with ample capacity
    gives each token its selected expert's SwiGLU."""
    cfg = moe.MoEConfig(n_experts=2, top_k=1, d_ff_expert=16, capacity_round=4,
                        capacity_factor=100.0, dispatch_groups=groups)
    t, d = 12, 8
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    router = torch.cat([torch.ones(d, 1), -torch.ones(d, 1)], dim=1)
    wg, wu = (torch.from_numpy(rng.normal(size=(2, d, 16)).astype(np.float32)) * 0.1
              for _ in range(2))
    wd = torch.from_numpy(rng.normal(size=(2, 16, d)).astype(np.float32)) * 0.1
    out, aux = moe.moe_ffn(x, router, wg, wu, wd, cfg)
    assert out.shape == (t, d) and bool(torch.isfinite(aux))
    sel = (x @ router).argmax(-1)
    expect = torch.stack([(torch.nn.functional.silu(x[i] @ wg[e]) * (x[i] @ wu[e])) @ wd[e]
                          for i, e in enumerate(sel.tolist())])
    _close(out, expect.numpy(), 1e-5)


@pytest.mark.parametrize("groups,t,factor", [(1, 64, 0.01), (4, 64, 0.1)])
def test_moe_capacity_drops_overflow(groups, t, factor):
    """Everyone routes to expert 0: only ``capacity`` tokens per group get
    an output, as in ``repro``'s test."""
    cfg = moe.MoEConfig(n_experts=2, top_k=1, d_ff_expert=8, capacity_round=4,
                        capacity_factor=factor, dispatch_groups=groups)
    x = torch.ones(t, 4)
    router = torch.zeros(4, 2)
    router[:, 0] = 1.0
    out, _ = moe.moe_ffn(x, router, torch.full((2, 4, 8), 0.1), torch.full((2, 4, 8), 0.1),
                         torch.full((2, 8, 4), 0.1), cfg)
    cap = moe.capacity(cfg, t // groups)
    nz = out.ne(0).any(-1)
    assert int(nz.sum()) == groups * cap
    # the first ``cap`` tokens of each group keep their pair
    assert nz.view(groups, -1)[:, :cap].all() and not nz.view(groups, -1)[:, cap:].any()


def test_aux_load_balance_loss_matches_repro(rng):
    logits = rng.normal(size=(20, 6)).astype(np.float32)
    top_e = np.argsort(-logits, axis=1)[:, :2].astype(np.int64)
    want = jax_moe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(top_e), 6)
    _close(moe.aux_load_balance_loss(_t(logits), _t(top_e), 6), want)


# ---------------------------------------------------------------------------
# MoE LM parameters and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["grok", "kimi"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_init_params_shapes_dtypes_and_counts_match_repro(model, dt):
    jcfg, cfg = _cfgs(model, dt)
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    mine = tf.init_params(cfg, seed=0, device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat) == 3 + len(mine["layers"])
    for path, want in flat.items():
        keys = [p.key for p in path]
        got = mine[keys[0]] if len(keys) == 1 else mine["layers"][keys[1]]
        assert got.shape == want.shape, keys
        assert str(got.dtype).split(".")[-1] == want.dtype.name, keys
        np.testing.assert_allclose(float(got.float().std()), float(want.astype(np.float32).std()),
                                   rtol=0.3)
    assert mine["layers"]["router"].dtype == torch.float32
    assert sum(p.numel() for p in [mine["embed"], mine["final_norm"], mine["lm_head"],
                                   *mine["layers"].values()]) == cfg.param_count()
    for c, jc in ((cfg, jcfg), (MODELS[model][1].CFG, MODELS[model][0].CFG)):
        assert (c.param_count(), c.active_param_count()) == (
            jc.param_count(), jc.active_param_count())
    as_bf16 = tf.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert as_bf16["layers"]["router"].dtype == torch.float32
    assert as_bf16["layers"]["we_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# forward, prefill, decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["grok", "kimi"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_forward_matches_repro(model, dt):
    jcfg, cfg = _cfgs(model, dt)
    close = _close if dt == "float32" else _close_l2
    tree, params = _params(jcfg)
    toks = graphgen.lm_batch(2, 12, cfg.vocab_size, seed=5)["tokens"]
    want, want_aux = jax.jit(lambda p, t: jax_tf.forward(p, jcfg, t))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))
    got, aux = tf.forward(params, cfg, toks)
    close(got, want)
    _close(aux, want_aux, TOL_FP32 if dt == "float32" else TOL_BF16)
    assert aux.dtype == torch.float32 and float(aux) > 0


@pytest.mark.parametrize("model", ["grok", "kimi"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_prefill_and_decode_match_repro(model, dt):
    """``prefill`` of 9 tokens, then two chained ``decode_step``s: logits and
    the whole cache after each, against ``repro``; K9 runs once per layer in
    the prefill and never in a decode step."""
    jcfg, cfg = _cfgs(model, dt)
    close = _close if dt == "float32" else _close_l2
    tree, params = _params(jcfg)
    toks = graphgen.lm_batch(2, 11, cfg.vocab_size, seed=3)["tokens"]
    jparams = jax.tree.map(jnp.asarray, tree)
    want, wcache = jax.jit(lambda p, t: jax_tf.prefill(p, jcfg, t, max_len=16))(
        jparams, jnp.asarray(toks[:, :9]))
    calls = []
    flash = ops.flash_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return flash(*args, **kw)

    ops.flash_attention = counting
    try:
        got, cache = tf.prefill(params, cfg, toks[:, :9], max_len=16)
        assert calls == [(2 * cfg.n_heads, 9, cfg.head_dim)] * cfg.n_layers
        close(got, want)
        for g, w in zip(cache, wcache):
            close(g, w)
        step = jax.jit(lambda p, c, t, n: jax_tf.decode_step(p, jcfg, c, t, n))
        for pos in (9, 10):
            want, wcache = step(jparams, wcache, jnp.asarray(toks[:, pos:pos + 1]),
                                jnp.int32(pos))
            got, cache = tf.decode_step(params, cfg, cache, toks[:, pos:pos + 1], pos)
            close(got, want)
            for g, w in zip(cache, wcache):
                close(g, w)
        assert len(calls) == cfg.n_layers
    finally:
        ops.flash_attention = flash


@pytest.mark.parametrize("model", ["grok", "kimi"])
def test_decode_matches_prefill_drop_free(model):
    """``tests/test_models_lm.py``'s KV-cache gate for MoE: with a capacity
    that drops nothing (``capacity_factor = n_experts / top_k``), prefill of
    9 tokens equals prefill of 8 and one decode step (bf16, its tolerance)."""
    _, cfg = _cfgs(model, "bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks = graphgen.lm_batch(2, 9, cfg.vocab_size, seed=1)["tokens"]
    full, _ = tf.prefill(params, cfg, toks, max_len=16)
    _, cache = tf.prefill(params, cfg, toks[:, :8], max_len=16)
    step, _ = tf.decode_step(params, cfg, cache, toks[:, 8:9], 8)
    assert full.shape == (2, cfg.vocab_size) and full.dtype == torch.float32
    _close(step, full.numpy(), TOL_BF16)
