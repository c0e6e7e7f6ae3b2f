"""K5's batched form and the shared K4 / K5 kernel design, on the CPU.

`repro_torch.kernels.ref.adjacency_any_pairs_ref` (what
``ops.adjacency_any_pairs`` runs on CPU tensors, and what ``chip_smoke.py``
holds batched K5 against on the card) must equal, bit for bit, ``repro``'s
K5 vmapped over pairs (``jax.vmap(repro.kernels.domain_ac.adjacency_any)``
in interpret mode, over the gathered planes, as ``repro``'s batched
fixpoint runs it) and ``repro.kernels.ref.adjacency_any_ref`` per pair.

The CUDA kernel (``csrc/arc_any.cuh``) cannot run here, so
:func:`_arc_any_emulation` repeats its per-tile logic in numpy — blocks of
(plane, ``R`` rows), the pair scan, mask chunks of ``C`` at an odd stride,
each row read as part of the flat word array (head words to a 16-byte
boundary, 16-byte units in the kernel's lane order, tail words), nonzero
words compacted into ``S`` slots or the row marked and read again, the
test in batches with a warp-wide early stop, the direct test of a plane
with at most two pairs — and must give the plain version's flags at the
launcher's layouts and at forced small ones.  Integer kernels: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.core.graph import PackedGraph as JaxPacked  # noqa: E402
from repro.core import domains as jax_dom  # noqa: E402
from repro.kernels import domain_ac as jax_ac  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import domains as dom  # noqa: E402
from repro_torch.core.graph import PackedGraph  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import domain_ac as ac_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from tests.conftest import extract_connected_pattern, random_graph  # noqa: E402
from tests.test_core_domains import PIPELINES  # noqa: E402
from tests.test_torch_plan import to_port  # noqa: E402

# arc_any.cuh: a warp, its 16-byte loads per lane per pass, the words tested
# between two early-stop votes, the most pairs a plane may have for the direct
# test (no compaction)
LANES, UNITS, STOP_EVERY, DIRECT = 32, 4, ac_mod.STOP_EVERY, 2

# (n_planes, n_t, w, n_pairs): w of 1, 33 and 393 (the served width); n_t
# not a multiple of any row tile; pairs sharing planes; every plane named
SHAPES_PAIRS = [(1, 1, 1, 1), (2, 65, 1, 5), (3, 100, 33, 7), (2, 257, 393, 9)]


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))


def _pair_inputs(rng, n_planes, n_t, w, n_pairs, density=0.05):
    """Sparse planes (a few set bits per row, as served), every plane named
    by some pair (when there are enough pairs), random and sparse masks."""
    bits = rng.random((n_planes, n_t, w * 32)) < density
    adj = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32).copy()
    plane = rng.integers(0, n_planes, n_pairs).astype(np.int32)
    plane[: min(n_planes, n_pairs)] = np.arange(min(n_planes, n_pairs))
    masks = rng.integers(0, 2**32, (n_pairs, w), dtype=np.uint32)
    masks[::2] &= rng.integers(0, 2**32, (len(masks[::2]), w), dtype=np.uint32)
    masks[::3] = np.where(rng.random((len(masks[::3]), w)) < 0.1, masks[::3], 0)
    return adj, plane, masks


@pytest.mark.parametrize("n_planes,n_t,w,n_pairs", SHAPES_PAIRS)
def test_adjacency_any_pairs_plain_matches_jax(rng, n_planes, n_t, w, n_pairs):
    adj, plane, masks = _pair_inputs(rng, n_planes, n_t, w, n_pairs)
    got = ops.adjacency_any_pairs(_t(adj), _t(plane), _t(masks)).numpy()
    rows = jnp.asarray(adj[plane])  # the [n_pairs, n_t, w] gather vmap takes
    vmapped = jax.vmap(lambda r, m: jax_ac.adjacency_any(r, m, interpret=True))(
        rows, jnp.asarray(masks))
    np.testing.assert_array_equal(got, np.asarray(vmapped))
    per_pair = np.stack([np.asarray(jax_ref.adjacency_any_ref(rows[i], jnp.asarray(masks[i])))
                         for i in range(n_pairs)])
    np.testing.assert_array_equal(got, per_pair)
    np.testing.assert_array_equal(  # K4's plain version is the same function
        ops.arc_any_sweep(_t(adj), _t(plane), _t(masks)).numpy(), got)


def test_adjacency_any_pairs_plain_plane_out_of_range(rng):
    """A pair whose plane lies outside [0, n_planes) supports no node."""
    adj, plane, masks = _pair_inputs(rng, 2, 40, 3, 6, density=0.5)
    plane[[1, 4]] = [2, -1]
    got = kref.adjacency_any_pairs_ref(_t(adj), _t(plane), _t(masks)).numpy()
    assert not got[[1, 4]].any()
    for i in (0, 2, 3, 5):
        np.testing.assert_array_equal(
            got[i], kref.adjacency_any_ref(_t(adj[plane[i]]), _t(masks[i])).numpy())


# ---------------------------------------------------------------------------
# the kernel's per-tile logic
# ---------------------------------------------------------------------------

def _append_order(head: int, w: int):
    """A row's columns in the order the kernel's warp compacts them, one list
    per pass: lane by lane (a warp scan of the lanes' counts), each lane's
    head or tail word (lanes 0-2 and 4-6, first pass only), then its
    ``UNITS`` 16-byte units, word by word."""
    n_units = (w - head) // 4
    tail0 = head + 4 * n_units
    edge = {lane: lane for lane in range(head)}
    edge.update({4 + j: tail0 + j for j in range(w - tail0)})
    passes = []
    for u0 in range(0, max(n_units, 1), LANES * UNITS):
        cols = []
        for lane in range(LANES):
            if u0 == 0 and lane in edge:
                cols.append(edge[lane])
            for k in range(UNITS):
                u = u0 + LANES * k + lane
                if u < n_units:
                    cols += [head + 4 * u + comp for comp in range(4)]
        passes.append(cols)
    return passes


def _compact(row: np.ndarray, head: int, slots: int):
    """``load_tile`` for one row: its nonzero (column, word) pairs in slot
    order, or ``None`` when more than ``slots`` (the row is read again)."""
    cols, cnt = [], 0
    for order in _append_order(head, row.shape[0]):
        for c in order:
            if row[c]:
                if cnt < slots:
                    cols.append(c)
                cnt += 1
        if cnt > slots:
            return None
    return np.asarray(cols, dtype=np.int64)


def _arc_any_emulation(adj, plane, masks, rows, slots, chunk, base_word=0, stats=None):
    """The kernel's result, block by block, in numpy.  ``plane`` ``None`` is
    the one-pair form (every pair on plane 0); ``base_word`` is the word
    offset of ``adj``'s first word from a 16-byte boundary.  ``stats``
    counts the row words tested (over all pairs of a chunk at once) and the
    rows read again."""
    n_planes, n_t, w = adj.shape
    n_pairs = masks.shape[0]
    ws = w | 1
    q = np.zeros(n_pairs, np.int64) if plane is None else plane.astype(np.int64)
    on = (q >= 0) & (q < n_planes)
    owner = np.where(on, q, 0)
    out = np.full((n_pairs, n_t), -1, np.int64)
    stats = {} if stats is None else stats
    stats.setdefault("words", 0)
    stats.setdefault("reread", 0)
    for p in range(n_planes):
        mine = np.nonzero(owner == p)[0]  # the pair scan: pair order
        for t0 in range(0, n_t, rows):
            if mine.size == 0:
                continue
            if mine.size <= min(DIRECT, chunk):  # each lane tests its own words
                staged = np.where(on[mine, None], masks[mine], 0)
                row = adj[p, t0:t0 + rows]
                out[mine, t0:t0 + rows] = ((row[None] & staged[:, None]) != 0).any(axis=2)
                continue
            tile = []
            for r in range(min(rows, n_t - t0)):
                word0 = base_word + (p * n_t + t0 + r) * w
                tile.append(_compact(adj[p, t0 + r], min(w, (4 - word0 % 4) % 4), slots))
            for first in range(0, mine.size, chunk):
                pairs = mine[first:first + chunk]  # lanes take pairs i and i + 32
                staged = np.zeros((pairs.size, ws), np.uint32)
                staged[:, :w] = np.where(on[pairs, None], masks[pairs], 0)
                for r, cols in enumerate(tile):
                    row = adj[p, t0 + r]
                    if cols is None:  # read again, 32 words at a time
                        stats["reread"] += 1
                        nz = np.nonzero(row)[0]
                        batches = [nz[(nz >= c0) & (nz < c0 + 32)] for c0 in range(0, w, 32)]
                    else:
                        batches = [cols[k0:k0 + STOP_EVERY]
                                   for k0 in range(0, cols.size, STOP_EVERY)]
                    acc = np.zeros(pairs.size, np.uint32)
                    for batch in batches:  # OR of mask & word, a warp vote after each batch
                        for c in batch:
                            acc |= staged[:, c] & row[c]
                        stats["words"] += batch.size
                        if acc.all():
                            break
                    out[pairs, t0 + r] = acc != 0
    assert (out >= 0).all(), "a flag was never written"
    return out.astype(np.int32)


def _plain(adj, plane, masks):
    plane = np.zeros(masks.shape[0], np.int32) if plane is None else plane
    return kref.adjacency_any_pairs_ref(_t(adj), _t(plane), _t(masks)).numpy()


def _layouts(n_planes, n_t, w, n_pairs):
    """The launcher's layout, and forced small tiles, slots and chunks (rows
    read again, several chunks, ragged last tile)."""
    lay = ac_mod.arc_any_layout(n_planes, n_t, w, n_pairs)
    return [(lay.rows, lay.slots, lay.chunk), (7, 8, 3), (1, 8, 1), (64, 16, 5)]


@pytest.mark.parametrize("n_planes,n_t,w,n_pairs", SHAPES_PAIRS + [(2, 150, 393, 40),
                                                           (2, 37, 600, 5)])  # two load passes
@pytest.mark.parametrize("base_word", [0, 1, 3])
def test_kernel_emulation_matches_plain(rng, n_planes, n_t, w, n_pairs, base_word):
    adj, plane, masks = _pair_inputs(rng, n_planes, n_t, w, n_pairs)
    if n_pairs > 2:
        plane[-1] = n_planes  # one pair out of range
    want = _plain(adj, plane, masks)
    for rows, slots, chunk in _layouts(n_planes, n_t, w, n_pairs):
        got = _arc_any_emulation(adj, plane, masks, rows, slots, chunk, base_word)
        np.testing.assert_array_equal(got, want, err_msg=f"R={rows} S={slots} C={chunk}")


@pytest.mark.parametrize("w", [1, 33, 393])
@pytest.mark.parametrize("fill", ["zeros", "ones"])
def test_kernel_emulation_edge_masks_and_rows(rng, w, fill):
    """All-zero and all-ones masks against all-zero, all-ones (every row
    read again) and sparse rows, one-pair form and pairs; with all-ones
    masks the early stop leaves words untested."""
    n_t = 37
    adj, plane, _ = _pair_inputs(rng, 3, n_t, w, 8)
    adj[1] = 0
    adj[2] = 0xFFFFFFFF
    masks = np.full((8, w), 0 if fill == "zeros" else 0xFFFFFFFF, np.uint32)
    want = _plain(adj, plane, masks)
    for rows, slots, chunk in _layouts(3, n_t, w, 8):
        stats = {}
        got = _arc_any_emulation(adj, plane, masks, rows, slots, chunk, stats=stats)
        np.testing.assert_array_equal(got, want)
        if fill == "ones" and w > STOP_EVERY:  # every pair hits at once: rows stop early
            zero = {}
            _arc_any_emulation(adj, plane, masks * 0, rows, slots, chunk, stats=zero)
            assert stats["words"] < zero["words"]
        if slots < w:
            assert stats["reread"] > 0
    one = _arc_any_emulation(adj[2:3], None, masks[:1], 5, 2, 1, base_word=2)
    np.testing.assert_array_equal(one[0], kref.adjacency_any_ref(_t(adj[2]), _t(masks[0])).numpy())


def test_kernel_emulation_on_served_rows(rng):
    """A plane of about 25 neighbours per row at the served width (w = 393),
    many pairs on two planes (several chunks at the launcher's layout): no
    row is read again and the flags equal the plain version's."""
    n_t, w = 300, 393
    adj = np.zeros((2, n_t, w), np.uint32)
    for p in range(2):
        for t in range(n_t):
            nb = rng.choice(w * 32, 25, replace=False)
            np.bitwise_or.at(adj[p, t], nb // 32, np.uint32(1) << (nb % 32).astype(np.uint32))
    masks = np.zeros((300, w), np.uint32)
    for i in range(300):
        nb = rng.choice(w * 32, 33, replace=False)
        np.bitwise_or.at(masks[i], nb // 32, np.uint32(1) << (nb % 32).astype(np.uint32))
    plane = rng.integers(0, 2, 300).astype(np.int32)
    lay = ac_mod.arc_any_layout(2, 12575, w, 300)  # the served tile, on a cut plane
    assert lay.chunk < 150  # pairs per plane span several chunks
    stats = {}
    got = _arc_any_emulation(adj, plane, masks, lay.rows, lay.slots, lay.chunk, stats=stats)
    np.testing.assert_array_equal(got, _plain(adj, plane, masks))
    assert stats["reread"] == 0


@pytest.mark.parametrize("n_planes,n_t,w,n_pairs", [
    (1, 12575, 393, 1), (2, 12575, 393, 48), (2, 12575, 393, 288), (2, 12575, 393, 70000),
    (1, 1, 1, 1), (4, 100, 33, 3), (2, 33067, 1034, 48), (2, 1000, ac_mod.MAX_W, 3),
    (1, 5, ac_mod.MAX_W, 1), (64, 12575, 393, 100)])
def test_arc_any_layout_fits(n_planes, n_t, w, n_pairs):
    """The launcher's layout fits one block's shared memory (two blocks per
    SM at the served width), keeps at least one mask per chunk up to MAX_W,
    and puts no limit on the number of pairs; at the served planes (n_t
    12,575, w 393) the grid is about two blocks per SM."""
    lay = ac_mod.arc_any_layout(n_planes, n_t, w, n_pairs)
    assert 1 <= lay.rows <= min(n_t, ac_mod.MAX_ROWS)
    assert lay.slots % ac_mod.STOP_EVERY == 0
    assert ac_mod.STOP_EVERY <= lay.slots < w + ac_mod.STOP_EVERY
    assert 1 <= lay.chunk <= min(n_pairs, ac_mod.CHUNK_CAP)
    assert lay.smem == ac_mod.arc_any_smem(lay.rows, lay.slots, lay.chunk, w)
    assert lay.smem <= ac_mod.ARC_ANY_MAX_SMEM
    if w <= 1034:
        assert lay.smem <= ac_mod.SMEM_TARGET
    if (n_t, w) == (12575, 393) and n_planes <= 2:
        blocks = -(-n_t // lay.rows) * n_planes
        assert 0.9 * ac_mod.ROW_BLOCKS <= blocks <= ac_mod.ROW_BLOCKS
        assert lay.slots >= 45  # the served rows have at most 45 nonzero words


# ---------------------------------------------------------------------------
# the fixpoint's routing and the wrappers
# ---------------------------------------------------------------------------

def _batch_case():
    rng = np.random.default_rng(5)
    tgt = random_graph(rng, 14, 30, n_labels=2, n_elabs=2, selfloops=1)
    pats = []
    while len(pats) < 4:
        p = extract_connected_pattern(rng, tgt, int(rng.integers(3, 6)))
        if p.m:
            pats.append(p)
    return tgt, pats


@pytest.mark.parametrize("use_ac,use_fc,interleave", PIPELINES[1:])
def test_batched_fixpoint_one_k5_call_per_sweep(monkeypatch, use_ac, use_fc, interleave):
    """The per-arc route calls ``ops.adjacency_any_pairs`` once per AC sweep
    over every live (lane, arc) pair, never the one-arc form; the plain
    route makes as many sweeps; both give repro's bits."""
    tgt, pats = _batch_case()
    packed = PackedGraph.from_graph(to_port(tgt))
    flags = dict(use_ac=use_ac, use_fc=use_fc, interleave=interleave)
    calls = {"per-arc": [], "off": []}
    pairs_k, pairs_ref = ops.adjacency_any_pairs, kref.adjacency_any_pairs_ref

    def counted(route, fn):
        def call(adj, plane, masks):
            calls[route].append(int(plane.shape[0]))
            return fn(adj, plane, masks)
        return call

    def refuse(*args):
        raise AssertionError("the batched fixpoint called K5's one-arc form")

    monkeypatch.setattr(ops, "adjacency_any_pairs", counted("per-arc", pairs_k))
    monkeypatch.setattr(kref, "adjacency_any_pairs_ref", counted("off", pairs_ref))
    monkeypatch.setattr(ops, "adjacency_any", refuse)
    want = jax_dom.compute_domains_batch(pats, JaxPacked.from_graph(tgt), batch_pad=8, **flags)
    sweeps = {}
    for use_pallas, route in ((True, "per-arc"), (False, "off")):
        dom.reset_sweep_count()
        calls["off"].clear()  # on the CPU, ops.adjacency_any_pairs runs the plain version
        got = dom.compute_domains_batch([to_port(p) for p in pats], packed, batch_pad=8,
                                        use_pallas=use_pallas, device="cpu", **flags)
        sweeps[route] = dom.ac_sweeps
        for g, w_ in zip(got, want):
            assert g.satisfiable == w_.satisfiable
            np.testing.assert_array_equal(g.bits, np.asarray(w_.bits))
    assert sweeps["per-arc"] > 0 and len(calls["per-arc"]) == sweeps["per-arc"]
    assert calls["off"] == calls["per-arc"] and sweeps["off"] == sweeps["per-arc"]
    arcs = [dom.domain_bucket(to_port(p))[1] for p in pats]
    assert calls["per-arc"][0] == sum(arcs)  # the first sweep tests every lane's arcs


def test_pairs_cpu_takes_plain_and_cuda_wrappers_refuse_cpu(rng):
    adj, plane, masks = _pair_inputs(rng, 2, 9, 3, 4)
    ops.reset_launch_counts()
    ops.adjacency_any_pairs(_t(adj), _t(plane), _t(masks))
    assert ops.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ac_mod.adjacency_any_pairs_cuda(_t(adj), _t(plane), _t(masks))


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A kernel's library is named by its source and every local header it
    includes, so an edited header is rebuilt; the shared K4 / K5 header is
    in both of their sources."""
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path("k") != before
    monkeypatch.undo()
    for name in ("adjacency_any", "arc_any_sweep"):
        assert "arc_any.cuh" in [p.name for p in _build.sources(name)]
