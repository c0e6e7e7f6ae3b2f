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

The CUDA kernel's bf16 route computes in another order than the plain
version: BK-key tiles from the last to the first, an online softmax in
fp32, P in two bf16 terms (``hi = bf16(P)``, ``lo = bf16(P - hi)``) for the
tensor cores' P V (the denominator sums the fp32 P), fp32 accumulation.
``_tc_emulation`` repeats that arithmetic on the CPU and must meet the same
bf16 tolerance (2e-2, relative and absolute) against the Pallas kernel and
``repro``'s oracle, also where large values of v cancel, which P in one
bf16 term misses; and the wrapper's padding of the head width (TMA rows of
a multiple of 16 bytes) must leave the result of the plain version
unchanged.
"""

import math

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
TC_BQ = 128  # query rows per block of the bf16 route
TC_BK = (64, 128)  # its KV tile widths (64 at a padded head width of 256)


def _inputs(rng, shapes, dtype):
    """numpy draws as JAX arrays of ``dtype`` and the same values as torch
    CPU tensors."""
    jx = [jnp.asarray(rng.normal(size=s), dtype) for s in shapes]
    tt = [torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype)) for x in jx]
    return jx, tt


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tc_emulation(q, k, v, bk: int, scale=None, p_terms: int = 2) -> "torch.Tensor":
    """The bf16 route's arithmetic on CPU tensors: per 128-row query tile,
    the KV tiles of ``bk`` keys it needs, last first; scores, running max
    and denominator in fp32 (exp2 of scaled scores, masked entries weight
    0); P in ``p_terms`` bf16 terms for P V (the kernel's two: ``hi =
    bf16(P)``, ``lo = bf16(P - hi)``), the denominator from the fp32 P; the
    output ``acc / max(l, 1e-30)`` in q's dtype.  ``scale`` defaults to
    ``1/√d``."""
    bh, s, d = q.shape
    s_kv = k.shape[1]
    sl2 = (d ** -0.5 if scale is None else scale) * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(bh, s, d)
    for q0 in range(0, s, TC_BQ):
        rows = torch.arange(q0, min(q0 + TC_BQ, s))
        qt = qf[:, rows]
        m = torch.full((bh, len(rows)), -1e30)
        l = torch.zeros(bh, len(rows))
        acc = torch.zeros(bh, len(rows), d)
        n_kv = -(-min(s_kv, s, q0 + TC_BQ) // bk)
        for t in range(n_kv):
            keys = torch.arange((n_kv - 1 - t) * bk, (n_kv - t) * bk)
            real = keys[keys < s_kv]
            sc = torch.full((bh, len(rows), bk), -math.inf)
            sc[..., :len(real)] = qt @ kf[:, real].transpose(1, 2)
            sc = torch.where(keys[None, None, :] <= rows[None, :, None], sc, -math.inf)
            mx = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2((m - mx) * sl2)
            p = torch.exp2(sc * sl2 - (mx * sl2)[..., None])
            l = l * alpha + p.sum(-1)
            p = p[..., :len(real)]
            pv = torch.zeros_like(acc)
            for _ in range(p_terms):
                term = p.to(torch.bfloat16).float()
                pv += term @ vf[:, real]
                p = p - term
            acc = acc * alpha[..., None] + pv
            m = mx
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _scaled_plain(q, k, v, scale: float) -> "torch.Tensor":
    """The plain version's arithmetic in fp32 with the softmax scale given
    (`repro_torch.kernels.ref.flash_attention_ref` takes ``1/√d`` of the
    width it is handed)."""
    sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = torch.arange(q.shape[1])[:, None] >= torch.arange(k.shape[1])[None, :]
    p = torch.softmax(torch.where(mask, sc, torch.tensor(-1e30)), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


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


@pytest.mark.parametrize("bk", TC_BK)
@pytest.mark.parametrize("bh,s,d,bq,bk_pallas,dt,tol", [c for c in SWEEP if c[5] == "bfloat16"])
def test_flash_tc_emulation_matches_pallas(rng, bh, s, d, bq, bk_pallas, dt, tol, bk):
    """The bf16 route's arithmetic (bf16 P in P V) against the Pallas kernel
    in interpret mode and ``repro``'s oracle, both all fp32 inside, at the
    bf16 tolerance 2e-2 (tighter than the sweep's 2e-1 for the Pallas
    kernel against its bf16 inputs)."""
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(bh, s, d)] * 3, dt)
    got = _tc_emulation(tq, tk, tv, bk)
    assert got.dtype == torch.bfloat16 and got.shape == (bh, s, d)
    for want in (jax_flash(q, k, v, block_q=bq, block_k=bk_pallas),
                 jax_ref.flash_attention_ref(q, k, v)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("bk", TC_BK)
@pytest.mark.parametrize("bh,s,s_kv,d", RAGGED + [(2, 300, 127, 16), (1, 129, 129, 24)])
def test_flash_tc_emulation_matches_ref_ragged(rng, bh, s, s_kv, d, bk):
    """The same at ragged lengths against ``repro``'s oracle: S = S_kv, S >
    S_kv and S < S_kv, one row past a 128-row tile, a KV tile cut short."""
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(bh, s, d), (bh, s_kv, d), (bh, s_kv, d)],
                                      "bfloat16")
    got = _tc_emulation(tq, tk, tv, bk)
    want = jax_ref.flash_attention_ref(q, k, v)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("d", [8, 24, 100, 13])
def test_flash_head_dim_padding(rng, d):
    """The wrapper's padding of the head width for the bf16 route: zero
    columns up to a multiple of 8, softmax scale 1/√(real d), output sliced
    back, gives the unpadded plain result (fp32: 1e-5; the bf16 route's
    arithmetic on the padded bf16 inputs: 2e-2)."""
    width = fa_mod.padded_head_dim(d)
    assert width % fa_mod.ROW_ALIGN == 0 and d <= width < d + fa_mod.ROW_ALIGN
    for dt in ("float32", "bfloat16"):
        _, (q, k, v) = _inputs(rng, [(2, 37, d), (2, 45, d), (2, 45, d)], dt)
        padded = [fa_mod.pad_head_dim(t, width) for t in (q, k, v)]
        for t, p in zip((q, k, v), padded):
            assert p.shape == t.shape[:-1] + (width,) and p.is_contiguous()
            assert p.data_ptr() % 16 == 0 and not p[..., d:].any()
            assert torch.equal(p[..., :d], t)
            if width == d:
                assert p is t
        want = ops.flash_attention(q, k, v)  # the plain version, unpadded
        got = _scaled_plain(*padded, d ** -0.5)[..., :d]
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])
        if dt == "bfloat16":
            got = _tc_emulation(*padded, 128 if width <= 128 else 64, d ** -0.5)[..., :d]
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dt], atol=TOL[dt])


def test_flash_pad_head_dim_realigns_offset_views():
    """A contiguous view that starts off a 16-byte boundary is copied, since
    a TMA tensor map needs an aligned base."""
    base = torch.zeros(2 * 9 * 8 + 4, dtype=torch.bfloat16)
    view = base[4:].view(2, 9, 8)
    assert view.data_ptr() % 16 != 0
    got = fa_mod.pad_head_dim(view, 8)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_flash_tc_two_p_terms_hold_cancelling_values(rng):
    """Where a few keys share a row's weight and large values of v cancel,
    P in one bf16 term (2^-9) moves outputs near 0 by more than the bf16
    tolerance; the kernel's two terms keep P to about 2^-17 and meet it
    against ``repro``'s oracle (q and k of scale 2, v of scale 30: scores of
    a few units, outputs that sum terms of ±30)."""
    (q, k, v), (tq, tk, tv) = _inputs(rng, [(4, 512, 128)] * 3, "bfloat16")
    q, k, v = (jnp.asarray(np.array(x, np.float32) * c, jnp.bfloat16)
               for x, c in ((q, 2), (k, 2), (v, 30)))
    tq, tk, tv = (torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16) for x in (q, k, v))
    want = _f32(jax_ref.flash_attention_ref(q, k, v))
    lim = TOL["bfloat16"] + TOL["bfloat16"] * np.abs(want)
    one = np.abs(_f32(_tc_emulation(tq, tk, tv, 128, p_terms=1)) - want)
    assert (one > lim).sum() > 0
    two = _f32(_tc_emulation(tq, tk, tv, 128))
    np.testing.assert_allclose(two, want, rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
