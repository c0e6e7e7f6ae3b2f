"""The port's error-feedback int8 compression against
``repro.distributed.compression``, on the CPU.

Payload, scale and residual bit for bit against ``repro``'s on seeded fp32
and bf16 gradients (several shapes and magnitudes, a 0-d leaf), an all-zero
tensor (the 1e-12 clamp on the scale), values that land on .5 ties (round
half to even), ``decompress``, ``init_error`` and ``compress_grads`` over a
tree with a bf16 leaf (which comes back as bf16), and the 50-step error
feedback of ``tests/test_optimizer.py`` (within 1e-2 of the true gradient,
every step's residual equal to ``repro``'s).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.distributed import compression as jax_comp  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402

SHAPES = [(), (1,), (7,), (64,), (33, 17), (4, 8, 9)]


def _torch(x: np.ndarray) -> torch.Tensor:
    """The same bits as a torch tensor (bf16 through its 16-bit words)."""
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(x.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _bits(x) -> np.ndarray:
    """Raw bits of a torch tensor or a JAX array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x.view(
        {1: np.int8, 4: np.int32}[x.dtype.itemsize])


def _check(g: np.ndarray, e: np.ndarray):
    want = jax_comp.compress(jnp.asarray(g), jnp.asarray(e))
    got = comp.compress(_torch(g), _torch(e))
    assert [x.dtype for x in got] == [torch.int8, torch.float32, torch.float32]
    for name, a, b in zip(("payload", "scale", "residual"), got, want):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    np.testing.assert_array_equal(_bits(comp.decompress(got[0], got[1])),
                                  _bits(jax_comp.decompress(want[0], want[1])))
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_compress_matches_repro(dtype, shape):
    rng = np.random.default_rng(2 * SHAPES.index(shape) + (dtype == "bfloat16"))
    g_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    for scale in (1e-8, 1e-3, 1.0, 1e4):
        g = (rng.normal(size=shape) * scale).astype(g_dtype)
        e = (rng.normal(size=shape) * scale * 0.01).astype(np.float32)
        _check(g, e)


def test_all_zero_tensor_clamps_the_scale():
    z = np.zeros((5, 3), np.float32)
    q, s, r = _check(z, z)
    assert float(s) == np.float32(1e-12) and not q.any() and not r.any()


def test_half_ties_round_to_even():
    """``e / scale`` exactly on .5: round half to even, both signs."""
    for s in (1.0, 0.25, 2.0 ** -20):
        vals = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5], np.float32)
        q, scale, _ = _check(vals * np.float32(s), np.zeros(10, np.float32))
        assert float(scale) == s
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4]


def test_init_error_and_compress_grads_match_repro():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(8,)).astype(np.float32),
            "b": {"c": rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16),
                  "d": np.full((3,), -2.0, np.float32)}}
    grads = {"a": _torch(tree["a"]), "b": {"c": _torch(tree["b"]["c"]),
                                           "d": _torch(tree["b"]["d"])}}
    jgrads = {"a": jnp.asarray(tree["a"]), "b": {"c": jnp.asarray(tree["b"]["c"]),
                                                 "d": jnp.asarray(tree["b"]["d"])}}
    err = comp.init_error(grads)
    assert [(p, tuple(x.shape), x.dtype, bool(x.any())) for p, x in leaves_with_paths(err)] == [
        ("['a']", (8,), torch.float32, False), ("['b']['c']", (4, 6), torch.float32, False),
        ("['b']['d']", (3,), torch.float32, False)]
    jerr = jax_comp.init_error(jgrads)
    for _ in range(3):  # the residual carries over
        out, err = comp.compress_grads(grads, err)
        jout, jerr = jax_comp.compress_grads(jgrads, jerr)
        assert out["b"]["c"].dtype == torch.bfloat16 and out["a"].dtype == torch.float32
        for (p, x), y in zip(leaves_with_paths(out), (jout["a"], jout["b"]["c"],
                                                      jout["b"]["d"])):
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=p)
        for (p, x), y in zip(leaves_with_paths(err), (jerr["a"], jerr["b"]["c"],
                                                      jerr["b"]["d"])):
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=p)
    # tests/test_optimizer.py::test_compress_grads_tree
    np.testing.assert_allclose(out["a"].numpy(), tree["a"], atol=0.02)


def test_error_feedback_unbiased_over_50_steps():
    """``tests/test_optimizer.py::test_compression_error_feedback_unbiased``
    on the port, every step's payload and residual equal to ``repro``'s."""
    rng = np.random.default_rng(0)
    g_true = rng.normal(size=(64,)).astype(np.float32)
    err, jerr = torch.zeros(64), jnp.zeros(64)
    total_dec = np.zeros(64)
    for _ in range(50):
        q, s, err = comp.compress(torch.from_numpy(g_true), err)
        jq, js, jerr = jax_comp.compress(jnp.asarray(g_true), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(err), _bits(jerr))
        total_dec += comp.decompress(q, s).numpy()
    np.testing.assert_allclose(total_dec / 50, g_true, atol=1e-2)
