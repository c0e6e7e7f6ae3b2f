"""The rest of the port's LM family against ``repro``: sliding-window
attention, the five LM configurations, ``lm_common``'s shapes and
``n_active``, and ``overrides``.

Tolerances as in ``tests/test_torch_lm.py``: fp32 1e-5, relative to each
element and to the reference's largest magnitude (the frameworks differ in
the order of fp32 sums only); bf16 2e-2 in relative L2 norm.  ``forward``'s
final hidden states through two layers: 1e-4 in fp32.  They are
``rms_norm`` of residuals up to ~60 whose last-place rounding (~5e-5, 1e-6
of the residual) the norm scales into the normed output (largest ~3.5): on
grok's SMOKE with 16 tokens the two frameworks differ by 2e-5 of it with
or without a window, while its MoE layer alone agrees to 2e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.configs import grok_1_314b as jax_grok  # noqa: E402
from repro.configs import kimi_k2_1t_a32b as jax_kimi  # noqa: E402
from repro.configs import lm_common as jax_lm_common  # noqa: E402
from repro.configs import minitron_8b as jax_minitron  # noqa: E402
from repro.configs import nemotron_4_15b as jax_nemotron  # noqa: E402
from repro.configs import overrides as jax_overrides  # noqa: E402
from repro.configs import stablelm_12b as jax_stablelm  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.models.moe import MoEConfig as JaxMoEConfig  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    grok_1_314b,
    kimi_k2_1t_a32b,
    lm_common,
    minitron_8b,
    nemotron_4_15b,
    overrides,
    stablelm_12b,
)
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.moe import MoEConfig  # noqa: E402

TOL_FP32 = 1e-5
TOL_FORWARD = 1e-4
TOL_BF16 = 2e-2
CONFIGS = {"grok_1_314b": (jax_grok, grok_1_314b), "kimi_k2_1t_a32b": (jax_kimi, kimi_k2_1t_a32b),
           "minitron_8b": (jax_minitron, minitron_8b),
           "nemotron_4_15b": (jax_nemotron, nemotron_4_15b),
           "stablelm_12b": (jax_stablelm, stablelm_12b)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL_FP32):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _close_l2(got, want, tol=TOL_BF16):
    got, want = _np(got), _np(want)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), (
        np.linalg.norm(got - want) / np.linalg.norm(want))


def _same_config(mine, theirs):
    """The port's LMConfig has repro's fields, and every one equals repro's
    (the MoEConfig field by field, the dtype by name)."""
    names = {f.name for f in dataclasses.fields(mine)}
    assert {f.name for f in dataclasses.fields(theirs)} == names
    for name in names:
        a, b = getattr(mine, name), getattr(theirs, name)
        if name == "dtype":
            assert str(a).split(".")[-1] == jnp.dtype(b).name
        elif name == "moe" and a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, name


# ---------------------------------------------------------------------------
# windowed attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,window,q_chunk,kh", [
    (16, 5, 4, 2),    # window < S, GQA 2
    (16, 16, 8, 1),   # window = S, GQA 4
    (12, 40, 4, 4),   # window > S, no grouping
    (24, 1, 8, 2),    # a window of one key back
    (9, 3, 9, 2),     # one chunk
])
def test_windowed_attention_matches_repro(rng, s, window, q_chunk, kh):
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, kh, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, kh, 16)).astype(np.float32)
    want = jax_attn.windowed_attention(*map(jnp.asarray, (q, k, v)), window=window,
                                       q_chunk=q_chunk)
    got = attn.windowed_attention(_t(q), _t(k), _t(v), window=window, q_chunk=q_chunk)
    _close(got, want)
    # a window that covers the sequence is full causal attention
    if window >= s:
        _close(got, attn.blockwise_attention(_t(q), _t(k), _t(v), kv_block=4))


def test_windowed_attention_bf16_and_chunk_errors(rng):
    q, k, v = (rng.normal(size=(1, 16, 4, 8)).astype(np.float32) for _ in range(3))
    want = jax_attn.windowed_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                       window=6, q_chunk=4)
    got = attn.windowed_attention(*(_t(a).bfloat16() for a in (q, k, v)), window=6, q_chunk=4)
    assert got.dtype == torch.bfloat16
    _close_l2(got, want)
    with pytest.raises(ValueError, match="does not divide"):
        attn.windowed_attention(_t(q), _t(k), _t(v), window=6, q_chunk=5)


@pytest.mark.parametrize("name,window", [("stablelm_12b", 5), ("stablelm_12b", 64),
                                         ("grok_1_314b", 3), ("minitron_8b", 4)])
def test_forward_with_window_matches_repro(name, window):
    """``forward`` runs ``windowed_attention`` (query chunks of kv_block 8);
    a windowed prefill and decode step attend over the cache in full, as in
    ``repro``."""
    jmod, mod = CONFIGS[name]
    jcfg = dataclasses.replace(jmod.SMOKE, dtype=jnp.float32, attn_window=window)
    cfg = dataclasses.replace(mod.SMOKE, dtype=torch.float32, attn_window=window)
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    params = tf.params_from_numpy(tree, device="cpu")
    toks = graphgen.lm_batch(2, 16, cfg.vocab_size, seed=4)["tokens"]
    jparams = jax.tree.map(jnp.asarray, tree)
    want, want_aux = jax.jit(lambda p, t: jax_tf.forward(p, jcfg, t))(jparams, jnp.asarray(toks))
    got, aux = tf.forward(params, cfg, toks)
    _close(got, want, TOL_FORWARD)
    _close(aux, want_aux)
    want, wcache = jax.jit(lambda p, t: jax_tf.prefill(p, jcfg, t, max_len=16))(
        jparams, jnp.asarray(toks[:, :15]))
    got, cache = tf.prefill(params, cfg, toks[:, :15], max_len=16)
    _close(got, want)
    want, _ = jax_tf.decode_step(jparams, jcfg, wcache, jnp.asarray(toks[:, 15:]), jnp.int32(15))
    got, _ = tf.decode_step(params, cfg, cache, toks[:, 15:], 15)
    _close(got, want)


def test_formerly_refused_configs_match_repro():
    """The MoE and window configs that the port refused before they were
    ported (minitron's SMOKE with a 4-expert MoE, and with a window of 4)
    now give ``repro``'s results."""
    moe_kw = dict(n_experts=4, top_k=2, d_ff_expert=32)
    jcfg = dataclasses.replace(jax_minitron.SMOKE, dtype=jnp.float32, moe=JaxMoEConfig(**moe_kw))
    cfg = dataclasses.replace(minitron_8b.SMOKE, dtype=torch.float32, moe=MoEConfig(**moe_kw))
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    toks = graphgen.lm_batch(1, 8, cfg.vocab_size)["tokens"]
    want, _ = jax_tf.prefill(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks), max_len=16)
    got, _ = tf.prefill(tf.params_from_numpy(tree, device="cpu"), cfg, toks, max_len=16)
    _close(got, want)
    assert tf.init_params(cfg, seed=0, device="cpu")["layers"]["we_gate"].shape == (2, 4, 64, 32)

    jcfg = dataclasses.replace(jax_minitron.SMOKE, dtype=jnp.float32, attn_window=4)
    cfg = dataclasses.replace(minitron_8b.SMOKE, dtype=torch.float32, attn_window=4)
    tree = jax.tree.map(np.asarray, jax_tf.init_params(jax.random.PRNGKey(0), jcfg))
    want, _ = jax_tf.forward(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks))
    got, _ = tf.forward(tf.params_from_numpy(tree, device="cpu"), cfg, toks)
    _close(got, want, TOL_FORWARD)
    x = np.zeros((1, 8, 4, 16), np.float32)
    _close(attn.windowed_attention(_t(x), _t(x), _t(x), window=4),
           jax_attn.windowed_attention(*(jnp.asarray(x),) * 3, window=4))


# ---------------------------------------------------------------------------
# configurations, shapes, overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_match_repro(name):
    jmod, mod = CONFIGS[name]
    for mine, theirs in ((mod.CFG, jmod.CFG), (mod.SMOKE, jmod.SMOKE)):
        _same_config(mine, theirs)
        assert (mine.head_dim, mine.gated, mine.param_count(), mine.active_param_count()) == (
            theirs.head_dim, theirs.gated, theirs.param_count(), theirs.active_param_count())
        assert lm_common.n_active(mine) == jax_lm_common._n_active(theirs)
    assert stablelm_12b.CFG.head_dim == 160 and kimi_k2_1t_a32b.CFG.head_dim == 112


def test_lm_common_shapes_match_repro():
    for shape in ("TRAIN_SHAPE", "PREFILL_SHAPE", "DECODE_SHAPE", "LONG_SHAPE"):
        assert getattr(lm_common, shape) == getattr(jax_lm_common, shape), shape
    assert minitron_8b.PREFILL_SHAPE == lm_common.PREFILL_SHAPE
    assert minitron_8b.DECODE_SHAPE == lm_common.DECODE_SHAPE


@pytest.mark.parametrize("assignments", [
    ["n_layers=4", "attn_window=4096"],
    ["moe.top_k=4", "moe.capacity_factor=2.5", "moe.router_dtype=bfloat16"],
    ["moe.n_shared_experts=2", "rope_theta=500000", "name=x"],
    ["kv_block = 512", "moe.dispatch_groups=8"],
    [],
])
@pytest.mark.parametrize("name", ["grok_1_314b", "kimi_k2_1t_a32b", "stablelm_12b"])
def test_overrides_match_repro(name, assignments):
    jmod, mod = CONFIGS[name]
    if mod.CFG.moe is None and any(a.startswith("moe.") for a in assignments):
        with pytest.raises(overrides.OverrideError, match="is None"):
            overrides.apply(mod.CFG, assignments)
        with pytest.raises(jax_overrides.OverrideError, match="is None"):
            jax_overrides.apply(jmod.CFG, assignments)
        return
    _same_config(overrides.apply(mod.CFG, assignments), jax_overrides.apply(jmod.CFG, assignments))


@pytest.mark.parametrize("assignment,match", [
    ("n_layers", "key=value"), ("nope=1", "unknown field"), ("moe.nope=1", "unknown field"),
    ("n_layers=x", "invalid literal"), ("moe.top_k.x=1", "not a config dataclass"),
    ("dtype=float32", "unsupported field type"),
])
def test_override_errors_match_repro(assignment, match):
    errors = (overrides.OverrideError, ValueError)
    jerrors = (jax_overrides.OverrideError, ValueError)
    with pytest.raises(errors, match=match) as mine:
        overrides.apply(kimi_k2_1t_a32b.CFG, [assignment])
    with pytest.raises(jerrors, match=match) as theirs:
        jax_overrides.apply(jax_kimi.CFG, [assignment])
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert issubclass(overrides.OverrideError, ValueError)


def test_override_bool_and_tuple_coercion():
    @dataclasses.dataclass(frozen=True)
    class C:
        flag: bool = False
        sizes: tuple = (1, 2)

    assert overrides.apply(C(), ["flag=yes", "sizes=3,4,5"]) == C(True, (3, 4, 5))
    assert jax_overrides.apply(C(), ["flag=yes", "sizes=3,4,5"]) == C(True, (3, 4, 5))
    for mod in (overrides, jax_overrides):
        with pytest.raises(mod.OverrideError, match="bool"):
            mod.apply(C(), ["flag=maybe"])
