"""The K8 kernel design (``csrc/csr_arc_sweep.cuh``), on the CPU.

The CUDA kernel cannot run here, so :func:`_csr_sweep_emulation` repeats its
per-block logic in numpy: the arcs cut into chunks of ``CHUNK`` and grouped
by plane within a chunk, up to ``GROUP`` per group in order of appearance,
each block finding its group from the chunk's keys alone (``find_group``:
one 64-bit mask of the arcs on each arc's key, ballots of the arcs that open
a key and of those that open two groups); the builder blocks' bit-transposed
table (a warp holds word ``i`` of the group's masks, one ballot per bit);
and a sweep block per (group, tile of ``SWEEP_ROWS`` rows): the capped,
clipped row bounds, rows longer than ``HUB_LEN`` left to the whole block,
each warp's walk over its 32 rows' concatenated entries in passes of
``32 · SWEEP_UNROLL`` (each entry's row found by a binary search over the
warp's inclusive prefix sum, a row no longer read once every arc of the
group has support), the block walk of hub rows in passes of ``256 ·
HUB_UNROLL`` with the next pass's entries loaded under the current one and
the warps' partial results ORed, and the flag store.  It must equal, bit for
bit, `repro_torch.kernels.ref.csr_arc_sweep_ref`, ``repro``'s oracle and its
Pallas kernel in interpret mode, on seeded numpy inputs.  Integer kernels:
exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.kernels import domain_ac as jax_ac  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import domain_ac as ac_mod  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from tests.test_torch_csr import csr_sweep_inputs  # noqa: E402

SENTINEL = 2**31 - 1
LANES, WARPS = 32, ac_mod.SWEEP_WARPS
THREADS = LANES * WARPS
ROWS, UNROLL = ac_mod.SWEEP_ROWS, ac_mod.SWEEP_UNROLL
HUB_LEN, HUB_UNROLL = ac_mod.HUB_LEN, ac_mod.HUB_UNROLL
GROUP, CHUNK, TABLE_WORDS = ac_mod.GROUP, ac_mod.ARC_CHUNK, ac_mod.TABLE_WORDS


# ---------------------------------------------------------------------------
# the kernel's per-block logic
# ---------------------------------------------------------------------------

def _find_group(arc_row, n_planes, chunk, slot):
    """``find_group``: ``(plane, arcs)`` of group ``slot`` of chunk ``chunk``;
    plane -1 for arcs on no plane, -2 (and no arcs) for a slot the chunk does
    not fill."""
    keys = [int(p) if 0 <= p < n_planes else n_planes
            for p in arc_row[chunk * CHUNK:(chunk + 1) * CHUNK]]
    same = [sum(1 << j for j, k in enumerate(keys) if k == key) for key in keys]
    rank = [bin(s & ((1 << i) - 1)).count("1") for i, s in enumerate(same)]
    n = [bin(s).count("1") for s in same]
    lead = sum(1 << i for i in range(len(keys)) if rank[i] == 0)  # two ballots of 32 arcs
    two = sum(1 << i for i in range(len(keys)) if rank[i] == 0 and n[i] > GROUP)
    plane, arcs = -2, [None] * GROUP
    for i, key in enumerate(keys):
        before = (1 << ((same[i] & -same[i]).bit_length() - 1)) - 1  # arcs before the key's first
        g = bin(lead & before).count("1") + bin(two & before).count("1") + rank[i] // GROUP
        if g == slot:
            arcs[rank[i] % GROUP] = chunk * CHUNK + i
            if rank[i] % GROUP == 0:
                plane = key if key < n_planes else -1
    return plane, [a for a in arcs if a is not None]


def _ballot_table(masks, arcs, w, stats):
    """A group's table, built warp by warp: bit ``j`` of ``T[32 i + b]`` is
    bit ``b`` of word ``i`` of the ``j``-th arc's mask (one ballot per
    bit).  Counts each mask word read in ``stats["mask_reads"]``."""
    table = np.zeros(32 * w, np.uint32)
    for i0 in range(0, w, TABLE_WORDS):
        for i in range(i0, min(i0 + TABLE_WORDS, w)):
            held = [int(masks[a, i]) for a in arcs]  # lane j holds arc j's word i
            for a in arcs:
                stats["mask_reads"][a, i] += 1
            for b in range(32):
                table[32 * i + b] = sum(((x >> b) & 1) << j for j, x in enumerate(held))
    return table


def _bounds(seg_start, seg_len, plane, t, n_idx, deg_cap):
    s = int(seg_start[plane, t])
    hi = min(s + min(int(seg_len[plane, t]), deg_cap), n_idx)
    lo = max(s, 0)
    return lo, max(hi - lo, 0)


def _warp_walk(rows, indices, table, full, acc, n_bits, reads):
    """One warp over its 32 rows ``[(lo, n)]``: passes of ``32 · UNROLL``
    entries; an entry's row is the first whose inclusive offset passes it
    (the kernel's five-step shuffle search); an entry is read only if its
    row lacked support from some arc when the pass began."""
    incl = np.cumsum([n for _, n in rows])
    total = int(incl[-1])
    for base in range(0, total, LANES * UNROLL):
        done = [acc[r] == full for r in range(LANES)]
        for k in range(base, min(base + LANES * UNROLL, total)):
            rr = 0
            for step in (16, 8, 4, 2, 1):
                if incl[rr + step - 1] <= k:
                    rr += step
            if done[rr]:
                continue
            at = rows[rr][0] + k - (incl[rr] - rows[rr][1])
            reads[at] += 1
            u = int(indices[at])
            if 0 <= u < n_bits:
                acc[rr] |= int(table[u])


def _block_walk(lo, n, indices, table, full, n_bits, reads):
    """The whole block over one hub row: passes of ``THREADS · HUB_UNROLL``
    entries, the next pass's entries read under the current one, each warp
    ORing its part; stops at a pass that begins with every arc supported."""
    step = THREADS * HUB_UNROLL
    acc = 0
    for k in range(min(step, n)):
        reads[lo + k] += 1
    for base in range(0, n, step):
        if acc == full:
            break
        for k in range(base + step, min(base + 2 * step, n)):  # the next pass, in flight
            reads[lo + k] += 1
        for w0 in range(0, step, LANES):  # each warp's part, ORed into the row
            part = 0
            for j in range(HUB_UNROLL):
                for lane in range(LANES):
                    k = base + THREADS * j + w0 + lane
                    if k < n and 0 <= int(indices[lo + k]) < n_bits:
                        part |= int(table[int(indices[lo + k])])
            acc |= part
    return acc


def _csr_sweep_emulation(seg_start, seg_len, indices, arc_row, masks, deg_cap, stats=None):
    """The kernel's result, from the per-block logic above; ``stats`` (a
    dict) gains the mask words and entries each group read."""
    n_planes, n_t = seg_start.shape
    n_arcs, w = masks.shape
    n_idx = indices.size
    out = np.full((n_arcs, n_t), -7, np.int32)  # every flag must be written
    stats = {} if stats is None else stats
    stats.update(mask_reads=np.zeros((n_arcs, w), np.int64), groups=[], entry_reads=[])
    if n_arcs == 0 or n_t == 0:
        return out
    lay = ac_mod.csr_sweep_layout(n_planes, n_t, w, n_arcs)
    per_chunk = ac_mod.slots_per_chunk(n_planes, n_arcs)
    for g in range(lay.slots):
        plane, arcs = _find_group(arc_row, n_planes, g // per_chunk, g % per_chunk)
        if plane == -2:
            continue
        stats["groups"].append((plane, arcs))
        table = (_ballot_table(masks, arcs, w, stats) if plane >= 0
                 else np.zeros(32 * w, np.uint32))
        full = (1 << len(arcs)) - 1
        reads = np.zeros(n_idx, np.int64)
        for t0 in range(0, n_t, ROWS):
            acc = [0] * ROWS
            rows = [(0, 0)] * ROWS
            if plane >= 0:
                rows = [_bounds(seg_start, seg_len, plane, t, n_idx, deg_cap) if t < n_t
                        else (0, 0) for t in range(t0, t0 + ROWS)]
            hubs = [r for r in range(ROWS) if rows[r][1] > HUB_LEN]
            walked = [(lo, 0) if n > HUB_LEN else (lo, n) for lo, n in rows]
            for w0 in range(0, ROWS, LANES):
                sub = acc[w0:w0 + LANES]
                _warp_walk(walked[w0:w0 + LANES], indices, table, full, sub, 32 * w, reads)
                acc[w0:w0 + LANES] = sub
            for r in hubs:
                acc[r] |= _block_walk(*rows[r], indices, table, full, 32 * w, reads)
            for j, a in enumerate(arcs):
                for r in range(min(ROWS, n_t - t0)):
                    out[a, t0 + r] = (acc[r] >> j) & 1
        stats["entry_reads"].append(reads)
    return out


# ---------------------------------------------------------------------------
# inputs and checks
# ---------------------------------------------------------------------------

def _edge_inputs(rng, layout, n_planes, n_t, w, n_arcs, deg_cap, arcs, fill=None):
    """``(seg_start, seg_len, indices, arc_row, masks)``: rows laid out plane
    after plane ("recipe"), the same rows in another order ("shuffled") or
    at random starts, some negative or past the end ("overlap"); rows of
    more than ``HUB_LEN`` entries and one longer than ``deg_cap``; entries
    from ``[-3, 32 w + 20)`` and a sentinel tail; arcs on planes in range
    ("in"), out of range ("out") or all on one plane ("one")."""
    lens = rng.integers(0, min(deg_cap, 12) + 1, (n_planes, n_t))
    if deg_cap > HUB_LEN:
        lens[:, 3::41] = rng.integers(HUB_LEN + 1, deg_cap + 1, lens[:, 3::41].shape)
    lens[0, min(5, n_t - 1)] = deg_cap + 7
    total = int(lens.sum())
    indices = np.full(total + deg_cap + 7, SENTINEL, np.int32)
    indices[:total] = rng.integers(-3, 32 * w + 20, total)
    starts = np.concatenate([[0], np.cumsum(lens.ravel())[:-1]]).reshape(n_planes, n_t)
    if layout == "shuffled":
        starts = starts.ravel()[rng.permutation(starts.size)].reshape(n_planes, n_t)
    elif layout == "overlap":
        starts = rng.integers(-50, indices.size + 50, (n_planes, n_t))
    arc_row = {"in": rng.integers(0, n_planes, n_arcs), "one": np.full(n_arcs, n_planes - 1),
               "out": rng.integers(-3, n_planes + 3, n_arcs)}[arcs]
    masks = (rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32)
             & rng.integers(0, 2**32, (n_arcs, w), dtype=np.uint32))
    if fill is not None:
        masks[:] = fill
    return (starts.astype(np.int32), lens.astype(np.int32), indices, arc_row.astype(np.int32),
            masks)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))


def _check(inputs, deg_cap, jax_oracle=True, pallas=False):
    """Emulation against the plain version (and repro's oracle, and its
    Pallas kernel in interpret mode); returns the emulation's stats."""
    stats = {}
    got = _csr_sweep_emulation(*inputs, deg_cap, stats=stats)
    want = kref.csr_arc_sweep_ref(*(_t(a) for a in inputs), deg_cap=deg_cap).numpy()
    np.testing.assert_array_equal(got, want)
    jargs = [jnp.asarray(a) for a in inputs]
    if jax_oracle:
        np.testing.assert_array_equal(got, np.asarray(jax_ref.csr_arc_sweep_ref(
            *jargs, deg_cap=deg_cap)))
    if pallas:
        np.testing.assert_array_equal(got, np.asarray(jax_ac.csr_arc_sweep(
            *jargs, deg_cap=deg_cap, interpret=True)))
    return stats


def _assert_read_once(inputs, stats, deg_cap):
    """Each mask word is read once into its group's table, and a group reads
    each entry of each of its plane's rows at most once (an index that
    several rows share, at most once per row)."""
    seg_start, seg_len, indices, arc_row, _ = inputs
    on_plane = (arc_row >= 0) & (arc_row < seg_start.shape[0])
    np.testing.assert_array_equal(stats["mask_reads"][on_plane], 1)
    assert not stats["mask_reads"][~on_plane].any()
    for (plane, _), reads in zip(stats["groups"], stats["entry_reads"]):
        cover = np.zeros(indices.size + 1, np.int64)
        if plane >= 0:
            for t in range(seg_start.shape[1]):
                lo, n = _bounds(seg_start, seg_len, plane, t, indices.size, deg_cap)
                if n:
                    cover[lo] += 1
                    cover[lo + n] -= 1
        assert (reads <= np.cumsum(cover)[:-1]).all()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_planes,n_t,w,n_arcs,deg_cap", [
    (2, 4, 1, 2, 8), (4, 33, 2, 6, 8), (2, 300, 10, 9, 16), (6, 70, 3, 5, 32)])
def test_emulation_matches_plain_oracle_and_pallas(rng, n_planes, n_t, w, n_arcs, deg_cap):
    """tests/test_kernels.py::test_csr_arc_sweep's sweep (the recipe of
    tests/test_torch_csr.py), also with a walk cap below the longest row."""
    inputs = csr_sweep_inputs(rng, n_planes, n_t, w, n_arcs, deg_cap)
    _assert_read_once(inputs, _check(inputs, deg_cap, pallas=True), deg_cap)
    _check(inputs, deg_cap // 2, pallas=True)


EDGES = {
    "recipe": ("recipe", 2, 300, 33, 40, 24, "in"),
    "shuffled rows, 70 arcs on one plane": ("shuffled", 3, 277, 40, 70, 24, "one"),
    "overlapping rows, planes out of range": ("overlap", 3, 300, 5, 70, 24, "out"),
    "hub rows": ("recipe", 2, 260, 3, 9, 5000, "in"),
    "hub rows, overlapping": ("overlap", 2, 300, 2, 40, 700, "in"),
    "no arcs": ("recipe", 2, 300, 5, 0, 8, "in"),
}


@pytest.mark.parametrize("fill", [None, 0, 0xFFFFFFFF], ids=["random", "zeros", "ones"])
@pytest.mark.parametrize("case", list(EDGES))
def test_emulation_edge_cases(rng, case, fill):
    """Rows that do not follow each other, walk caps below the longest row,
    entries past the domain bitmap and negative ones, sentinels, planes out
    of range, more than 32 arcs on one plane, no arcs, n_t off the tile,
    hub rows; random, all-zero and all-ones masks."""
    layout, n_planes, n_t, w, n_arcs, deg_cap, arcs = EDGES[case]
    inputs = _edge_inputs(rng, layout, n_planes, n_t, w, n_arcs, deg_cap, arcs, fill)
    assert n_t % ROWS
    stats = _check(inputs, deg_cap, jax_oracle=arcs != "out")
    _assert_read_once(inputs, stats, deg_cap)
    _check(inputs, 1, jax_oracle=arcs != "out")


def test_hub_rows_take_the_block_walk_and_stop_early(rng):
    """A row past HUB_LEN is walked by the block in passes of THREADS ·
    HUB_UNROLL entries; with every bit set, the block stops after the first
    pass (and the next one, already in flight) instead of reading the row."""
    n = 5 * THREADS * HUB_UNROLL
    seg_start = np.array([[0, n]], np.int32)
    seg_len = np.array([[n, 3]], np.int32)
    indices = rng.integers(0, 64, n + 8).astype(np.int32)
    arc_row = np.zeros(3, np.int32)
    for fill, passes in ((0xFFFFFFFF, 2), (0, 5)):
        stats = {}
        inputs = (seg_start, seg_len, indices, arc_row, np.full((3, 2), fill, np.uint32))
        _check(inputs, n, jax_oracle=False)
        _csr_sweep_emulation(*inputs, n, stats=stats)
        read = stats["entry_reads"][0]
        assert read[:n].sum() == min(passes * THREADS * HUB_UNROLL, n)


def test_warp_walk_stops_reading_a_row_with_support(rng):
    """Within a warp, a row's entries are read pass by pass until every arc
    of the group has support: all-ones masks read one pass of a long row."""
    n = 4 * LANES * UNROLL  # below HUB_LEN: the warp walks it
    assert n <= HUB_LEN
    inputs = (np.zeros((1, 1), np.int32), np.full((1, 1), n, np.int32),
              np.arange(n, dtype=np.int32), np.zeros(2, np.int32),
              np.full((2, n // 32 + 1), 0xFFFFFFFF, np.uint32))
    stats = _check(inputs, n, jax_oracle=False)
    assert stats["entry_reads"][0].sum() == LANES * UNROLL


@pytest.mark.parametrize("n_planes,pattern", [(2, "alternate"), (3, "blocks"), (5, "random"),
                                              (1, "one"), (2, "out")])
def test_groups_cover_each_arc_once_in_order(rng, n_planes, pattern):
    """Per chunk of CHUNK arcs, find_group's groups are the chunk's arcs on
    one key, up to GROUP each, in order of appearance; every arc is in
    exactly one group and no slot past the last group holds one."""
    n_arcs = 150
    arc_row = {"alternate": np.arange(n_arcs) % 2, "blocks": np.arange(n_arcs) // 50,
               "random": rng.integers(0, n_planes, n_arcs), "one": np.zeros(n_arcs),
               "out": rng.integers(-2, n_planes + 2, n_arcs)}[pattern].astype(np.int32)
    per_chunk = ac_mod.slots_per_chunk(n_planes, n_arcs)
    seen = []
    for c in range(-(-n_arcs // CHUNK)):
        want = []  # the chunk's groups in order of appearance
        keys = [int(p) if 0 <= p < n_planes else -1 for p in arc_row[c * CHUNK:(c + 1) * CHUNK]]
        for key in dict.fromkeys(keys):
            on = [c * CHUNK + i for i, k in enumerate(keys) if k == key]
            want += [(key, on[j:j + GROUP]) for j in range(0, len(on), GROUP)]
        got = [_find_group(arc_row, n_planes, c, s) for s in range(per_chunk)]
        assert got[:len(want)] == want
        assert all(p == -2 and not a for p, a in got[len(want):])
        seen += [a for _, arcs in want for a in arcs]
    assert sorted(seen) == list(range(n_arcs))


def test_ballot_table_is_the_bit_transpose(rng):
    """Bit j of T[u] is bit u of arc j's mask, for every u < 32 w."""
    w, arcs = 5, [3, 0, 7]
    masks = rng.integers(0, 2**32, (8, w), dtype=np.uint32)
    table = _ballot_table(masks, arcs, w, dict(mask_reads=np.zeros((8, w), np.int64)))
    for u in range(32 * w):
        for j, a in enumerate(arcs):
            assert (int(table[u]) >> j) & 1 == (int(masks[a, u // 32]) >> (u % 32)) & 1


# ---------------------------------------------------------------------------
# the host's layout rule
# ---------------------------------------------------------------------------

def test_layout_constants_come_from_the_header():
    """The host reads the layout's constants from ``csr_arc_sweep.cuh``."""
    k = _build.header_constants((_build.CSRC / "csr_arc_sweep.cuh").read_text())
    assert (WARPS, ROWS, UNROLL, HUB_LEN, HUB_UNROLL, GROUP, CHUNK, TABLE_WORDS) == (
        k["kWarps"], k["kRows"], k["kUnroll"], k["kHubLen"], k["kHubUnroll"], k["kGroup"],
        k["kChunk"], k["kTableWords"])
    assert k["kThreads"] == 32 * k["kWarps"] == k["kRows"]
    assert k["kGroup"] == 32 and k["kChunk"] == 64  # a table word, find_group's 64-bit mask


@pytest.mark.parametrize("n_planes,n_arcs", [(1, 1), (2, 48), (2, 63), (2, 64), (3, 65),
                                             (64, 48), (3, 70_000), (0, 5)])
def test_layout_has_a_slot_for_every_group(rng, n_planes, n_arcs):
    """slots_per_chunk covers the groups of any chunk, whatever its arcs'
    planes (all one plane, all different, out of range)."""
    per_chunk = ac_mod.slots_per_chunk(n_planes, n_arcs)
    m = min(CHUNK, n_arcs)
    for arc_row in (np.zeros(m), np.arange(m), rng.integers(-1, n_planes + 1, m),
                    np.arange(m) % max(n_planes, 1)):
        keys = np.where((arc_row >= 0) & (arc_row < n_planes), arc_row, n_planes)
        groups = sum(-(-c // GROUP) for c in np.unique(keys, return_counts=True)[1])
        assert groups <= per_chunk


@pytest.mark.parametrize("w", [1, 33, 1034, 1035, ac_mod.MAX_W, 4 * ac_mod.MAX_W])
def test_layout_shared_memory_and_table_at_any_width(w):
    """K8's shared memory does not grow with w (the masks go to the table in
    device memory), so every width up to MAX_W and past it fits a block's
    default 48 KB; the table is slots · GROUP · w words."""
    lay = ac_mod.csr_sweep_layout(2, 33067, w, 48)
    assert lay.smem <= 48 * 1024
    assert lay.smem == ac_mod.csr_sweep_layout(2, 100, 1, 1).smem
    assert lay.table_words == lay.slots * GROUP * w
    assert lay.table_blocks == lay.slots * -(-w // (WARPS * TABLE_WORDS))


def test_layout_grid_limits():
    """Target A's sweep (48 arcs on 2 planes): 4 slots (2 groups formed),
    130 tiles of 256 rows; 70,000 arcs fit one launch; a grid past 2^31 - 1
    blocks is beyond one launch."""
    a = ac_mod.csr_sweep_layout(2, 33067, 1034, 48)
    assert (a.slots, a.tiles, a.table_blocks, a.sweep_blocks) == (4, 130, 4 * 33, 4 * 130)
    many = ac_mod.csr_sweep_layout(3, 40, 2, 70_000)
    assert max(many.table_blocks, many.sweep_blocks) < 2**31 - 1
    huge = ac_mod.csr_sweep_layout(2, 2**30, 1, 20_000)
    assert huge.sweep_blocks > 2**31 - 1  # csr_arc_sweep_cuda raises ValueError for such a sweep
