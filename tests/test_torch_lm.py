"""The port's LM serving path against ``repro.models`` at ``minitron_8b.SMOKE``.

Weights are ``repro``'s own (``init_params`` from a PRNG key), carried
across by `repro_torch.models.transformer.params_from_numpy`; activations
are drawn with numpy.  Tolerances:

- fp32: 1e-5, relative to each element and to the reference's largest
  magnitude (the two frameworks differ only in the order of fp32 sums; an
  element near 0 that sums terms of size ~30 keeps their rounding).  This
  holds through both layers and the LM head: the port's prefill attention
  is the plain K9 (a dense softmax) where ``repro``'s is a blockwise online
  softmax, and the two agree to rounding;
- bf16 at depth 2: 2e-2, the tolerance of ``repro``'s own decode-vs-prefill
  test (``tests/test_models_lm.py``), in relative L2 norm when held against
  ``repro``: the two attention algorithms round a few bf16 attention
  outputs (values up to ~35, one unit in the last place 0.25) to
  neighbouring values, which moves single logits by a few hundredths;
  elementwise for the port's own decode-vs-prefill, as in ``repro``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.configs import lm_common as jax_lm_common  # noqa: E402
from repro.configs import minitron_8b as jax_cfgs  # noqa: E402
from repro.data import graphgen as jax_graphgen  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import minitron_8b as cfgs  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

TOL_FP32 = 1e-5
TOL_BF16 = 2e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dt: str, **kw):
    """``SMOKE`` in both packages, in dtype ``dt``, with ``kw`` replaced."""
    jdt, tdt = DTYPES[dt]
    return (dataclasses.replace(jax_cfgs.SMOKE, dtype=jdt, **kw),
            dataclasses.replace(cfgs.SMOKE, dtype=tdt, **kw))


def _params(jcfg):
    """``repro``'s parameters (numpy tree) and the port's copy of them."""
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    return tree, tf.params_from_numpy(tree, device="cpu")


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


def _layer0(tree):
    return jax.tree.map(lambda w: w[0], tree["layers"])


# ---------------------------------------------------------------------------
# configurations, data, parameters
# ---------------------------------------------------------------------------

def test_configs_and_tokens_match_repro():
    for mine, theirs in ((cfgs.CFG, jax_cfgs.CFG), (cfgs.SMOKE, jax_cfgs.SMOKE)):
        for f in dataclasses.fields(mine):
            if f.name != "dtype":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        assert mine.dtype == torch.bfloat16 and theirs.dtype == jnp.bfloat16
        assert (mine.head_dim, mine.gated, mine.param_count()) == (
            theirs.head_dim, theirs.gated, theirs.param_count())
    assert cfgs.PREFILL_SHAPE == jax_lm_common.PREFILL_SHAPE
    assert cfgs.DECODE_SHAPE == jax_lm_common.DECODE_SHAPE
    for k, v in graphgen.lm_batch(3, 17, 256, seed=7).items():
        np.testing.assert_array_equal(v, jax_graphgen.lm_batch(3, 17, 256, seed=7)[k])


@pytest.mark.parametrize("activation", ["squared_relu", "swiglu"])
def test_init_params_shapes_and_scales_match_repro(activation):
    jcfg, cfg = _cfgs("float32", activation=activation)
    tree, _ = _params(jcfg)
    mine = tf.init_params(cfg, seed=0, device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat) == 3 + len(mine["layers"])
    for path, want in flat.items():
        keys = [p.key for p in path]
        got = mine[keys[0]] if len(keys) == 1 else mine["layers"][keys[1]]
        assert got.shape == want.shape and got.dtype == torch.float32, keys
        # ones for norms; else standard normal × the same scale (loose moments)
        np.testing.assert_allclose(float(got.std()), float(want.std()), rtol=0.3)
    assert sum(p.numel() for p in [mine["embed"], mine["final_norm"], mine["lm_head"],
                                   *mine["layers"].values()]) == cfg.param_count()


def test_params_from_numpy_keeps_values_and_dtypes():
    tree, mine = _params(_cfgs("bfloat16")[0])
    assert mine["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mine["layers"]["wq"].float().numpy(),
                                  tree["layers"]["wq"].astype(np.float32))
    as32 = tf.params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert as32["embed"].dtype == torch.float32


def test_constructors_default_to_the_card():
    tree, _ = _params(_cfgs("float32")[0])
    if torch.cuda.is_available():
        assert tf.empty_cache(cfgs.SMOKE, 1, 8)[0].is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.init_params(cfgs.SMOKE, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.empty_cache(cfgs.SMOKE, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.params_from_numpy(tree)


# ---------------------------------------------------------------------------
# modules, fp32
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_repro(rng):
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32) * 3
    gamma = rng.normal(size=(16,)).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(gamma)),
           jax_common.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(attn.apply_rope(_t(x), _t(pos)),
           jax_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    for name in ("gelu", "silu", "relu", "squared_relu"):
        _close(common.ACTIVATIONS[name](_t(x)), jax_common.ACTIVATIONS[name](jnp.asarray(x)))


@pytest.mark.parametrize("q_offset,valid", [(0, 1), (5, 6), (11, 12), (3, 12)])
def test_decode_attention_matches_repro(rng, q_offset, valid):
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    want = jax_attn.decode_attention(*map(jnp.asarray, (q, k, v)), jnp.int32(q_offset),
                                     jnp.int32(valid))
    _close(attn.decode_attention(_t(q), _t(k), _t(v), q_offset, valid), want)


@pytest.mark.parametrize("s,s_kv,q_offset,valid,kv_block", [
    (9, 9, 0, None, 4), (5, 16, 6, 11, 8), (7, 20, 0, 7, 8), (1, 16, 9, 10, 8)])
def test_blockwise_attention_matches_repro(rng, s, s_kv, q_offset, valid, kv_block):
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s_kv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s_kv, 2, 16)).astype(np.float32)
    want = jax_attn.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), q_offset=q_offset,
        kv_valid_len=None if valid is None else jnp.int32(valid), kv_block=kv_block)
    got = attn.blockwise_attention(_t(q), _t(k), _t(v), q_offset=q_offset, kv_valid_len=valid,
                                   kv_block=kv_block)
    _close(got, want)


@pytest.mark.parametrize("activation", ["squared_relu", "swiglu"])
def test_ffn_dense_matches_repro(rng, activation):
    jcfg, cfg = _cfgs("float32", activation=activation)
    tree, params = _params(jcfg)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = jax_tf._ffn_dense(jnp.asarray(x), _layer0(tree), jcfg)
    _close(tf._ffn_dense(_t(x), tf.layer_params(params, 0), cfg), want)


def test_layer_matches_repro(rng):
    """One block without a cache (blockwise attention on both sides) and
    with a zero cache at ``cache_len`` 0 (the port's K9 path)."""
    jcfg, cfg = _cfgs("float32")
    tree, params = _params(jcfg)
    b, s, s_max = 2, 9, 16
    h = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    zero = np.zeros((b, s_max, cfg.n_kv_heads, cfg.head_dim), np.float32)
    (want, _), _ = jax_tf._layer(jcfg, (jnp.asarray(h), jnp.float32(0)), _layer0(tree),
                                 jnp.asarray(pos))
    got, _, _ = tf._layer(cfg, _t(h), tf.layer_params(params, 0), _t(pos))
    _close(got, want)
    (want, _), (wk, wv) = jax_tf._layer(jcfg, (jnp.asarray(h), jnp.float32(0)), _layer0(tree),
                                        jnp.asarray(pos), (jnp.asarray(zero),) * 2,
                                        jnp.int32(0))
    cache = (_t(zero), _t(zero))
    got, _, (gk, gv) = tf._layer(cfg, _t(h), tf.layer_params(params, 0), _t(pos), cache, 0)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_prefill_and_decode_match_repro(dt):
    """``prefill`` of 9 tokens, then two chained ``decode_step``s: logits and
    the whole cache after each, against ``repro``; K9 runs once per layer in
    the prefill and never in a decode step."""
    jcfg, cfg = _cfgs(dt)
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


@pytest.mark.parametrize("activation", ["squared_relu", "swiglu"])
def test_decode_matches_prefill(activation):
    """The port's own KV-cache gate, as ``tests/test_models_lm.py`` runs it
    for ``repro``: prefill of 9 tokens against prefill of 8 and one decode
    step (bf16, its tolerance)."""
    cfg = dataclasses.replace(cfgs.SMOKE, activation=activation)
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks = graphgen.lm_batch(2, 9, cfg.vocab_size, seed=1)["tokens"]
    full, _ = tf.prefill(params, cfg, toks, max_len=16)
    _, cache = tf.prefill(params, cfg, toks[:, :8], max_len=16)
    step, _ = tf.decode_step(params, cfg, cache, toks[:, 8:9], 8)
    assert full.shape == (2, cfg.vocab_size) and full.dtype == torch.float32
    _close(step, full.numpy(), TOL_BF16)


def test_cache_overflow_raises():
    params = tf.init_params(cfgs.SMOKE, seed=0, device="cpu")
    toks = graphgen.lm_batch(1, 9, cfgs.SMOKE.vocab_size)["tokens"]
    _, cache = tf.prefill(params, cfgs.SMOKE, toks[:, :8], max_len=8)
    with pytest.raises(ValueError, match="cannot take"):
        tf.decode_step(params, cfgs.SMOKE, cache, toks[:, 8:9], 8)
