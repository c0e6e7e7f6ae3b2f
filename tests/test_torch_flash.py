"""K9's plain version against the JAX package's flash attention.

`repro_torch.kernels.ref.flash_attention_ref` (what
`repro_torch.kernels.ops.flash_attention` runs on CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernel against on the card) must agree with
the Pallas kernel ``repro.kernels.flash_attention.flash_attention`` in
interpret mode over the sweep of ``tests/test_extensions.py``, with that
test's tolerances, and with ``repro.kernels.ref.flash_attention_ref`` at
ragged shapes: fp32 to 1e-5 (the two differ only in summation order), bf16
to 2e-2 (a few units in the last place of a bf16 output near 1).  Inputs
are drawn with numpy and, for bf16, rounded once by JAX and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# tests/test_extensions.py::test_flash_attention_kernel's sweep
SWEEP = [
    (2, 64, 32, 16, 16, "float32", 1e-4),
    (4, 128, 64, 32, 64, "float32", 1e-4),
    (2, 64, 32, 16, 16, "bfloat16", 2e-1),
    (1, 32, 16, 32, 32, "float32", 1e-4),
]
# ragged lengths: S = S_kv, S > S_kv and S < S_kv
RAGGED = [(3, 1, 1, 16), (2, 9, 9, 32), (2, 37, 37, 24), (2, 37, 9, 16), (2, 9, 37, 16),
          (1, 1, 37, 8)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(rng, shapes, dtype):
    """numpy draws as JAX arrays of ``dtype`` and the same values as torch
    CPU tensors."""
    jx = [jnp.asarray(rng.normal(size=s), dtype) for s in shapes]
    tt = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)) for x in jx]
    return jx, tt


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("bh,s,d,bq,bk,dt,tol", SWEEP)
def test_flash_plain_matches_pallas(rng, bh, s, d, bq, bk, dt, tol):
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(bh, s, d)] * 3, dt)
    want = jax_flash(q, k, v, block_q=bq, block_k=bk)
    got = ops.flash_attention(tq, tk, tv, block_q=bq, block_k=bk)
    assert got.dtype == getattr(torch, dt) and got.shape == (bh, s, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,s_kv,d", RAGGED)
def test_flash_plain_matches_ref_ragged(rng, bh, s, s_kv, d, dt):
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(bh, s, d), (bh, s_kv, d), (bh, s_kv, d)], dt)
    want = jax_ref.flash_attention_ref(q, k, v)
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == getattr(torch, dt) and got.shape == (bh, s, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])


def test_flash_cpu_takes_the_plain_version_and_other_devices_raise(rng):
    """CPU tensors run the plain version and launch (and count) no kernel;
    the CUDA wrapper refuses CPU tensors, and the entry point refuses a
    device that is neither."""
    _, (q, k, v) = _inputs(rng, [(2, 9, 16)] * 3, "float32")
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    assert "flash_attention" in _build.KERNELS
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention_cuda(q, k, v)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        ops.flash_attention(*meta)
