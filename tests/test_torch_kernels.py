"""The port's K1–K5 plain versions against the JAX package's kernels.

`repro_torch.kernels.ref.extend_step_ref` / `candidate_mask_ref` /
`popcount_rows_ref` / `adjacency_any_ref` / `arc_any_sweep_ref` (what the
port's kernel entry points run on CPU tensors, and what ``chip_smoke.py``
holds the CUDA kernels against on the card) must equal, bit for bit, both
``repro.kernels.ref``'s oracles and the Pallas kernels run in interpret
mode, over the shape sweeps of the JAX package's own kernel tests.
Bitwise integer kernels: the tolerance is exact equality, compared as
uint32 words.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.kernels import candidate_mask as jax_cm  # noqa: E402
from repro.kernels import domain_ac as jax_ac  # noqa: E402
from repro.kernels import popcount_reduce as jax_pc  # noqa: E402
from repro.kernels import extend_step as jax_es  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import candidate_mask as cm_mod  # noqa: E402
from repro_torch.kernels import domain_ac as ac_mod  # noqa: E402
from repro_torch.kernels import popcount_reduce as pc_mod  # noqa: E402
from repro_torch.kernels import extend_step as es_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from tests.test_extend_step import SHAPES_ES  # noqa: E402
from tests.test_kernels import SHAPES_CM  # noqa: E402

# the sweeps of tests/test_kernels.py::test_adjacency_any_and_popcount and
# ::test_arc_any_sweep
SHAPES_ANY = [(1, 1), (5, 1), (300, 10), (1000, 130), (257, 129)]
SHAPES_SWEEP = [(2, 1, 1, 1), (4, 10, 3, 6), (2, 300, 5, 16), (6, 257, 129, 9)]


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy uint32/int32 -> torch int32 with the same bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _inputs(rng, b, w, mp, n_rows, p_pad):
    """The input recipe of tests/test_extend_step.py, with every third
    candidate bitmap empty and half the others cut to one random word (so
    the lowest set bit is not always in word 0)."""
    rows = np.concatenate(
        [rng.integers(0, 2**32, (n_rows, w), dtype=np.uint32),
         np.full((1, w), 0xFFFFFFFF, np.uint32)], 0)
    dom = rng.integers(0, 2**32, (p_pad, w), dtype=np.uint32)
    pos = rng.integers(0, p_pad, b).astype(np.int32)
    row_idx = rng.integers(0, n_rows + 1, (b, mp)).astype(np.int32)
    depth = rng.integers(0, p_pad, b).astype(np.int32)
    n_p = p_pad // 2 + 1
    used = rng.integers(0, 2**32, (b, w), dtype=np.uint32)
    cand = rng.integers(0, 2**32, (b, w), dtype=np.uint32)
    one_word = np.arange(w)[None, :] == rng.integers(0, w, b)[:, None]
    cand = np.where((rng.random(b) < 0.5)[:, None], np.where(one_word, cand, 0), cand)
    cand[::3] = 0
    return rows, dom, pos, row_idx, depth, n_p, used, cand


@pytest.mark.parametrize("b,w,mp,n_rows,p_pad", SHAPES_ES)
def test_extend_step_plain_matches_jax(rng, b, w, mp, n_rows, p_pad):
    rows, dom, pos, row_idx, depth, n_p, used, cand = _inputs(rng, b, w, mp, n_rows, p_pad)
    jargs = [jnp.asarray(x) for x in (rows, dom, pos, row_idx, depth, np.int32(n_p), used, cand)]
    oracle = jax_ref.extend_step_ref(*jargs)
    pallas = jax_es.extend_step(*jargs, interpret=True)
    got = ops.extend_step(_t(rows), _t(dom), _t(pos), _t(row_idx), _t(depth), n_p,
                          _t(used), _t(cand))
    for name, g, o, p in zip(("cand2", "child", "meta"), got, oracle, pallas):
        g = _bits(g)
        np.testing.assert_array_equal(g, np.asarray(o).view(np.uint32), err_msg=f"{name} vs ref")
        np.testing.assert_array_equal(g, np.asarray(p).view(np.uint32), err_msg=f"{name} vs pallas")


@pytest.mark.parametrize("b,w,mp,n_rows,p_pad", SHAPES_CM)
def test_candidate_mask_plain_matches_jax(rng, b, w, mp, n_rows, p_pad):
    rows, dom, pos, row_idx, _, _, used, _ = _inputs(rng, b, w, mp, n_rows, p_pad)
    jargs = [jnp.asarray(x) for x in (rows, dom, pos, row_idx, used)]
    oracle = np.asarray(jax_ref.candidate_mask_ref(*jargs))
    pallas = np.asarray(jax_cm.candidate_mask(*jargs, interpret=True))
    got = _bits(ops.candidate_mask(_t(rows), _t(dom), _t(pos), _t(row_idx), _t(used)))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("n,w", SHAPES_ANY)
def test_popcount_and_adjacency_any_plain_match_jax(rng, n, w):
    rows = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
    rows[::3] &= rng.integers(0, 2**32, (len(rows[::3]), w), dtype=np.uint32)
    for mask in (rng.integers(0, 2**32, (w,), dtype=np.uint32),
                 np.zeros(w, np.uint32), np.eye(1, w, w - 1, dtype=np.uint32)[0]):
        jr, jm = jnp.asarray(rows), jnp.asarray(mask)
        got = ops.adjacency_any(_t(rows), _t(mask)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_ref.adjacency_any_ref(jr, jm)))
        np.testing.assert_array_equal(got, np.asarray(jax_ac.adjacency_any(jr, jm, interpret=True)))
    got = ops.popcount_rows(_t(rows)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ref.popcount_rows_ref(jnp.asarray(rows))))
    np.testing.assert_array_equal(
        got, np.asarray(jax_pc.popcount_rows(jnp.asarray(rows), interpret=True)))


@pytest.mark.parametrize("n_planes,n_t,w,n_arcs", SHAPES_SWEEP)
def test_arc_any_sweep_plain_matches_jax(rng, n_planes, n_t, w, n_arcs):
    adj = rng.integers(0, 2**32, (n_planes, n_t, w), dtype=np.uint32)
    adj &= rng.integers(0, 2**32, (n_planes, n_t, w), dtype=np.uint32)  # sparser rows
    arc_row = rng.integers(0, n_planes, n_arcs).astype(np.int32)
    masks = rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32)
    masks[0] = 0
    jargs = [jnp.asarray(x) for x in (adj, arc_row, masks)]
    got = ops.arc_any_sweep(_t(adj), _t(arc_row), _t(masks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ref.arc_any_sweep_ref(*jargs)))
    np.testing.assert_array_equal(got, np.asarray(jax_ac.arc_any_sweep(*jargs, interpret=True)))


@pytest.mark.parametrize("n,w", [(1, 1), (31, 1), (32, 1), (33, 2), (70, 3), (100, 5)])
def test_pack_bits_matches_jax(rng, n, w):
    flags = (rng.random(n) < 0.5).astype(np.int32)
    want = np.asarray(jax_ref.pack_bits_ref(jnp.asarray(flags), w))
    np.testing.assert_array_equal(_bits(ops.pack_bits(_t(flags), w)), want)
    batch = (rng.random((3, n)) < 0.5).astype(np.int32)  # leading axes pack row by row
    np.testing.assert_array_equal(
        _bits(ops.pack_bits(_t(batch), w)),
        np.stack([np.asarray(jax_ref.pack_bits_ref(jnp.asarray(f), w)) for f in batch]))


def test_cpu_tensors_take_the_plain_version(rng):
    """On CPU tensors the entry points run the plain versions and launch
    (and count) no kernel; the CUDA wrappers refuse CPU tensors."""
    rows, dom, pos, row_idx, depth, n_p, used, cand = _inputs(rng, 8, 5, 2, 6, 4)
    ops.reset_launch_counts()
    ops.extend_step(_t(rows), _t(dom), _t(pos), _t(row_idx), _t(depth), n_p, _t(used), _t(cand))
    ops.candidate_mask(_t(rows), _t(dom), _t(pos), _t(row_idx), _t(used))
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        cm_mod.candidate_mask_cuda(_t(rows), _t(dom), _t(pos), _t(row_idx), _t(used))
    with pytest.raises(ValueError, match="CUDA"):
        es_mod.extend_step_cuda(_t(rows), _t(dom), _t(pos), _t(row_idx), _t(depth), n_p,
                                _t(used), _t(cand))
    ops.popcount_rows(_t(rows))
    ops.adjacency_any(_t(rows), _t(used[0]))
    ops.arc_any_sweep(_t(rows)[None], _t(pos[:2] * 0), _t(used[:2]))
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        pc_mod.popcount_rows_cuda(_t(rows))
    with pytest.raises(ValueError, match="CUDA"):
        ac_mod.adjacency_any_cuda(_t(rows), _t(used[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ac_mod.arc_any_sweep_cuda(_t(rows)[None], _t(pos[:2] * 0), _t(used[:2]))


def test_bit_helpers_match_numpy(rng):
    words = np.concatenate([
        np.array([0, 1, 2, 3, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x00010000], np.uint32),
        rng.integers(0, 2**32, 500, dtype=np.uint32)])
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(kref.popcount32(_t(words)).numpy(), bits.sum(1))
    nz = words != 0
    want_tz = np.where(nz, np.argmax(bits == 1, axis=1), 32)
    np.testing.assert_array_equal(kref.ctz32(_t(words)).numpy(), want_tz)


def test_flatten_and_row_index_match_jax(rng):
    """The kernels' adjacency layout and per-lane row table equal repro's
    (vmapped over lanes there, batched here)."""
    ne, n_t, w, b, mp, p_pad = 2, 9, 3, 12, 4, 6
    adj = rng.integers(0, 2**32, (ne, 2, n_t, w), dtype=np.uint32)
    np.testing.assert_array_equal(
        _bits(cm_mod.flatten_adj_rows(_t(adj))),
        np.asarray(jax_cm.flatten_adj_rows(jnp.asarray(adj))))
    ppos = rng.integers(-1, p_pad, (b, mp)).astype(np.int32)
    pdir = rng.integers(0, 2, (b, mp)).astype(np.int32)
    pel = rng.integers(0, ne, (b, mp)).astype(np.int32)
    mapping = rng.integers(-1, n_t, (b, p_pad)).astype(np.int32)
    n_rows = ne * 2 * n_t
    want = np.stack([np.asarray(jax_cm.flat_row_index(
        jnp.asarray(ppos[l]), jnp.asarray(pdir[l]), jnp.asarray(pel[l]),
        jnp.asarray(mapping[l]), n_t, n_rows)) for l in range(b)])
    got = cm_mod.flat_row_index(_t(ppos), _t(pdir), _t(pel), _t(mapping), n_t, n_rows)
    np.testing.assert_array_equal(got.numpy(), want)
