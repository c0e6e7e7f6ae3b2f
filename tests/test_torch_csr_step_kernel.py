"""The shared K6 / K7 kernel design (``csrc/csr_extend.cuh``), on the CPU.

The CUDA kernel cannot run here, so :func:`_csr_step_emulation` repeats its
per-lane logic in numpy: blocks of ``L`` lanes (``csr_step_layout``), one
warp per lane; each row read once as head words to a 16-byte boundary,
16-byte units in the warp's pass order and tail words (for every word
offset of the row); the first nonzero word of ``cand`` found by a
min-reduction on the pass that writes ``cand2``, ``used`` read only from
then on and only for lanes that may want a child; the dom row staged at its
own offset; the walk led by the shortest real parent segment (the pivot), short
segments compared through the warp's shuffles and longer ones
binary-searched; a pivot longer than ``LONG_WALK`` entries walked by the
whole block as bitmaps.  It must equal, bit for bit,
`repro_torch.kernels.ref.csr_extend_ref`, `csr_extend_bucketed_ref` and
``repro``'s Pallas kernels in interpret mode, on ``test_torch_csr``'s
shapes, on hub rows longer than four times the threshold in either parent
slot, and at edge cases.  Integer kernels: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.kernels import csr_extend as jax_ce  # noqa: E402
from repro_torch.kernels import csr_extend as ce_mod  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from tests.test_torch_csr import (  # noqa: E402
    CSR_ORDER,
    SENTINEL,
    SHAPES_CSR,
    _jax_args,
    _port_args,
    csr_step_inputs,
)

# csr_extend.cuh: a warp, 16-byte units per thread per pass, pivot entries
# per thread per trip of a long walk, threads of a block
LANES, UNITS, UNROLL = 32, ce_mod.UNITS, ce_mod.UNROLL
THREADS = LANES * ce_mod.CSR_STEP_WARPS
LONG_WALK = ce_mod.LONG_WALK


# ---------------------------------------------------------------------------
# the kernel's per-lane logic
# ---------------------------------------------------------------------------

def _row_passes(w: int, r: int):
    """``RowSplit`` for a row of ``w`` words starting ``r`` words past a
    16-byte boundary: per pass, per lane, the words the lane holds (its head
    or tail word, then its units' words), and the units' first words."""
    head = min(w, (4 - r) % 4)
    n_units = (w - head) // 4
    tail0 = head + 4 * n_units
    n_passes = max(1, -(-n_units // (LANES * UNITS)))
    passes = []
    for p in range(n_passes):
        lanes = []
        for lane in range(LANES):
            words = []
            if p == 0 and lane < head:
                words.append(lane)
            if p == n_passes - 1 and 4 <= lane and tail0 + lane - 4 < w:
                words.append(tail0 + lane - 4)
            for k in range(UNITS):
                u = p * LANES * UNITS + LANES * k + lane
                if u < n_units:
                    words += [head + 4 * u + j for j in range(4)]
            lanes.append(words)
        passes.append(lanes)
    return passes, head, n_units


def _member(seg: np.ndarray, u: int) -> bool:
    """``member``: a segment of at most 32 entries through the warp's
    shuffles (any equal), a longer one by the kernel's branchless binary
    search (the lower bound kept in ``[pos, pos + m]``)."""
    n = seg.size
    if n <= 32:
        return bool((seg == u).any())
    pos, m = 0, n
    while m > 1:
        half = m >> 1
        if seg[pos + half] < u:
            pos += half
        m -= half
    a = seg[pos]
    b = seg[pos + 1] if pos + 1 < n else a
    return bool(a == u or (a < u and b == u))


def _lane_stream(c, us, dm, need_base, r_c, r_d, stats):
    """The lane's passes: ``(first, v, cand2, base or None)``.  Counts every
    row word read in ``stats``."""
    w = c.size
    passes, _, _ = _row_passes(w, r_c)
    first, v, lowbit, base = None, -1, 0, None
    cand2 = np.zeros(w, np.uint32)

    def read(name, words):
        for i in words:
            stats[name][i] += 1

    def base_words(words, vm_word):
        for i in words:
            read("used", [i])
            base[i] &= ~us[i] & ~np.uint32(lowbit if i == vm_word else 0)

    for p, lanes in enumerate(passes):
        words = [i for ws in lanes for i in ws]
        read("cand", words)
        if first is None:
            mins = [min((i for i in ws if c[i]), default=None) for ws in lanes]
            nz = [m for m in mins if m is not None]
            if nz:  # the warp's min-reduction
                first = min(nz)
                word = int(c[first])
                lowbit = word & -word
                v = first * 32 + lowbit.bit_length() - 1
                if need_base:
                    staged = _row_passes(w, r_d)[0]  # dom at its own word offset
                    base = np.zeros(w, np.uint32)
                    for ws in (i for lp in staged for i in lp):
                        for i in ws:
                            stats["dom"][i] += 1
                            base[i] = dm[i]
                    for q in range(p):  # the passes before: cand was zero there
                        base_words([i for ws in passes[q] for i in ws], None)
        for i in words:
            cand2[i] = c[i] ^ np.uint32(lowbit if i == first else 0)
        if first is not None and need_base:
            base_words(words, first)
    return first, v, cand2, base


def _walk_warp(indices, segs, d, base, w, stats):
    """A short pivot (at most ``LONG_WALK`` entries) walked by its warp,
    32 entries per trip (``walk<1>`` up to 32 entries, ``walk<4>`` beyond),
    each slot in order until no entry of the trip is left."""
    d_start, d_len = segs[d]
    unroll = 1 if d_len <= 32 else UNROLL
    child = np.zeros(w, np.uint32)
    for k0 in range(0, d_len, LANES * unroll):
        trip = [k0 + lane + r * LANES for lane in range(LANES) for r in range(unroll)]
        alive = {}
        for k in trip:
            if k >= d_len:
                continue
            stats["entries"][d] = stats["entries"].get(d, 0) + 1
            u = int(indices[d_start + k])
            prev = int(indices[d_start + k - 1]) if k > 0 else ~u
            uc = min(max(u, 0), 32 * w - 1)
            if prev != u and (int(base[uc >> 5]) >> (uc & 31)) & 1:
                alive[k] = u
        for j, (start, n) in enumerate(segs):
            if not alive:
                break
            if j == d or n < 0:
                continue
            seg = indices[start:start + n]
            alive = {k: u for k, u in alive.items() if _member(seg, u)}
        for u in alive.values():
            uc = min(max(u, 0), 32 * w - 1)
            child[uc >> 5] |= np.uint32(1 << (uc & 31))
    return child


def _walk_block(indices, segs, d, base, w, stats):
    """A long pivot walked by every thread of the block as bitmaps
    (``walk_bitmap``): the pivot's in-range entries set in base, ANDed with
    each other real segment's bitmap; ids outside ``[0, 32 w)`` searched
    exactly and ORed in at their clamped bit."""
    d_start, d_len = segs[d]
    n_bits = 32 * w
    drv = indices[d_start:d_start + d_len].astype(np.int64)
    threads = set()
    for k0 in range(0, d_len, THREADS * UNROLL):
        for r in range(UNROLL):
            for t in range(THREADS):
                if k0 + r * THREADS + t < d_len:
                    threads.add(t)
    stats["long_warps"].append(len({t // LANES for t in threads}))
    stats["entries"][d] = stats["entries"].get(d, 0) + d_len
    child = np.zeros(w, np.uint32)
    for u in drv[(drv >= 0) & (drv < n_bits)]:
        if (int(base[u >> 5]) >> (u & 31)) & 1:
            child[u >> 5] |= np.uint32(1 << (u & 31))
    edge = (int(base[0]) & 1, (int(base[w - 1]) >> 31) & 1)
    for j, (start, n) in enumerate(segs):
        if j == d or n < 0:
            continue
        seg = indices[start:start + n].astype(np.int64)
        bitmap = np.zeros(w, np.uint32)
        for v in seg[(seg >= 0) & (seg < n_bits)]:
            bitmap[v >> 5] |= np.uint32(1 << (v & 31))
        child &= bitmap
    for k, u in enumerate(drv.tolist()):
        if 0 <= u < n_bits or not edge[0 if u < 0 else 1] or (k and drv[k - 1] == u):
            continue
        if all(j == d or n < 0 or u in indices[start:start + n]
               for j, (start, n) in enumerate(segs)):
            child[0 if u < 0 else w - 1] |= np.uint32(1 if u < 0 else 1 << 31)
    return child


def _csr_step_emulation(x, deg_cap, cand_word=0, dom_word=0, lanes=None, stats=None):
    """The kernel's ``(cand2, child, meta)`` in numpy.  ``cand_word`` /
    ``dom_word`` are the word offsets of ``cand``'s and ``dom_bits``' first
    word from a 16-byte boundary (``used``, ``cand2`` and ``child`` share
    ``cand``'s); ``lanes`` forces the lanes per block.  ``stats`` counts the
    row words read, the pivot entries walked and the long walks."""
    cand = np.asarray(x["cand"], np.uint32)
    used = np.asarray(x["used"], np.uint32)
    dom = np.asarray(x["dom_bits"], np.uint32)
    indices = np.asarray(x["indices"], np.int64)
    b, w = cand.shape
    mp = x["seg_len"].shape[1]
    L = ce_mod.csr_step_layout(w, mp, b).lanes if lanes is None else lanes
    assert L >= 1
    stats = {} if stats is None else stats
    for name in ("cand", "used", "dom"):
        stats[name] = np.zeros((b, w), np.int64)
    stats.update(entries_total=0, long=[], long_warps=[], first_longest=0, barriers=0)
    cand2 = np.zeros((b, w), np.uint32)
    child = np.zeros((b, w), np.uint32)
    meta = np.zeros((b, 4), np.int32)
    for blk in range(0, b, L):
        lanes_here = range(blk, min(blk + L, b))
        plan = {}
        for l in lanes_here:
            segs = [(int(s), -1 if n < 0 else min(int(n), deg_cap))
                    for s, n in zip(x["seg_start"][l], x["seg_len"][l])]
            real = [j for j, (_, n) in enumerate(segs) if n >= 0]
            d = min(real, key=lambda j: (segs[j][1], j)) if real else -1
            if real and segs[real[0]][1] > segs[d][1]:
                stats["first_longest"] += 1
            need_base = int(x["depth"][l]) + 1 < x["n_p"]
            plan[l] = (segs, d, need_base, need_base and d >= 0 and segs[d][1] > LONG_WALK)
        any_long = any(p[3] for p in plan.values())
        stats["barriers"] += 1 + 2 * any_long
        for l in lanes_here:
            segs, d, need_base, is_long = plan[l]
            lane_stats = {k: stats[k][l] for k in ("cand", "used", "dom")}
            lane_stats["entries"] = {}
            lane_stats["long_warps"] = stats["long_warps"]
            r_c = (cand_word + l * w) % 4
            r_d = (dom_word + int(x["child_pos"][l]) * w) % 4
            first, v, cand2[l], base = _lane_stream(cand[l], used[l], dom[x["child_pos"][l]],
                                                    need_base, r_c, r_d, lane_stats)
            valid = first is not None
            want = valid and need_base
            if want and d >= 0:
                walk = _walk_block if is_long else _walk_warp
                child[l] = walk(indices, segs, d, base, w, lane_stats)
                if is_long:
                    stats["long"].append(l)
                assert set(lane_stats["entries"]) <= {d}, "only the pivot is walked"
                assert lane_stats["entries"].get(d, 0) == segs[d][1], "every pivot entry once"
                stats["entries_total"] += segs[d][1]
            elif want:
                child[l] = base
            meta[l] = (int(valid), v if valid else -1, int(valid and not need_base),
                       int(want and bool(child[l].any())))
    return cand2, child, meta


def _np_inputs(x):
    return {k: (x[k] if k == "n_p" else np.asarray(x[k])) for k in CSR_ORDER}


def _bits(a):
    return np.asarray(a).view(np.uint32) if np.asarray(a).dtype != np.uint32 else np.asarray(a)


def _assert_equal(got, want, label):
    for name, g, o in zip(("cand2", "child", "meta"), got, want):
        g, o = np.asarray(g), np.asarray(o)
        if name == "meta":
            np.testing.assert_array_equal(g, o.astype(np.int32), err_msg=f"meta vs {label}")
        else:
            np.testing.assert_array_equal(_bits(g), _bits(o), err_msg=f"{name} vs {label}")


def _plain(x, deg_cap):
    args = _port_args(x)
    flat = [t.numpy() for t in kref.csr_extend_ref(*args, deg_cap=deg_cap)]
    bucketed = [t.numpy() for t in kref.csr_extend_bucketed_ref(*args, deg_cap=deg_cap)]
    return flat, bucketed


def _pallas(x, deg_cap):
    return (jax_ce.csr_extend(*_jax_args(x), deg_cap=deg_cap, interpret=True),
            jax_ce.csr_extend_bucketed(*_jax_args(x), deg_cap=deg_cap, chunk=8, interpret=True))


def _check_all(x, deg_cap, pallas=True, **kw):
    stats = {}
    got = _csr_step_emulation(_np_inputs(x), deg_cap, stats=stats, **kw)
    flat, bucketed = _plain(x, deg_cap)
    _assert_equal(got, flat, "csr_extend_ref")
    _assert_equal(got, bucketed, "csr_extend_bucketed_ref")
    if pallas:
        k6, k7 = _pallas(x, deg_cap)
        _assert_equal(got, k6, "repro csr_extend (interpret)")
        _assert_equal(got, k7, "repro csr_extend_bucketed (interpret)")
    return stats


def _assert_rows_read_once(x, stats):
    """cand read once; used and the dom row once for lanes that want a
    child, never for the others."""
    cand = np.asarray(x["cand"])
    want = (cand != 0).any(axis=1) & (np.asarray(x["depth"]) + 1 < x["n_p"])
    assert (stats["cand"] == 1).all()
    assert (stats["used"][want] == 1).all() and (stats["used"][~want] == 0).all()
    assert (stats["dom"][want] == 1).all() and (stats["dom"][~want] == 0).all()


# ---------------------------------------------------------------------------
# the row split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 3, 33, 1034, 1035])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_row_split_covers_each_word_once_in_order(w, r):
    """Head words to the 16-byte boundary, units on it, tail words: every
    word in exactly one (pass, lane), each pass after the one before."""
    passes, head, n_units = _row_passes(w, r)
    seen = []
    for lanes in passes:
        words = sorted(i for ws in lanes for i in ws)
        assert not seen or words[0] > seen[-1]
        seen += words
    assert seen == list(range(w))
    assert n_units == 0 or (r + head) % 4 == 0  # the units start on a 16-byte boundary
    assert all(len(ws) <= 4 * UNITS + 1 for lanes in passes for ws in lanes)


# ---------------------------------------------------------------------------
# the emulation against the plain versions and repro's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,w,mp,n_rows,deg_cap,p_pad", SHAPES_CSR)
@pytest.mark.parametrize("offsets", [(0, 0), (0, 3), (2, 1)])
def test_emulation_matches_plain_and_pallas(rng, b, w, mp, n_rows, deg_cap, p_pad, offsets):
    x = csr_step_inputs(rng, b, w, mp, n_rows, deg_cap, p_pad)
    stats = _check_all(x, deg_cap, pallas=offsets == (0, 0), cand_word=offsets[0],
                       dom_word=offsets[1])
    _assert_rows_read_once(x, stats)
    for lanes in (1, 3):  # forced blocks: b not a multiple of the lanes per block
        got = _csr_step_emulation(_np_inputs(x), deg_cap, cand_word=offsets[0],
                                  dom_word=offsets[1], lanes=lanes)
        _assert_equal(got, _plain(x, deg_cap)[0], f"{lanes} lanes per block")


def hub_inputs(rng, b, w, hub_len, short_max=12, p_pad=8):
    """Rows 0 and 1 are hubs of ``hub_len`` and ``hub_len // 2 + 40`` sorted
    ids of ``[0, 32 w)`` (both longer than twice ``LONG_WALK``, row 0 more
    than four times); the other rows hold 0 to ``short_max`` ids, most
    drawn from hub 0, some with an adjacent duplicate.  Lanes cycle through
    the slot orders (hub, short), (short, hub), (hub 0, hub 1), (hub 1, hub
    0), (hub), (short, short), (unused, hub), (hub, hub 0 again); every
    seventh lane has no candidates, every eleventh is a match."""
    n_t = 32 * w
    hub0 = np.sort(rng.choice(n_t, hub_len, replace=False))
    hub1 = np.sort(rng.choice(n_t, hub_len // 2 + 40, replace=False))
    rows = [hub0, hub1]
    for i in range(2, 60):
        r = np.sort(rng.choice(hub0 if i % 3 else n_t, int(rng.integers(0, short_max + 1)),
                               replace=False))
        if r.size >= 2 and i % 5 == 0:
            r[1] = r[0]
        rows.append(r)
    lens = np.array([r.size for r in rows], np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    deg_cap = int(lens.max())
    indices = np.full(int(lens.sum()) + deg_cap, SENTINEL, np.int32)
    indices[:lens.sum()] = np.concatenate(rows)
    short = rng.integers(2, len(rows), (b, 2))
    orders = [(0, "s0"), ("s0", 0), (0, 1), (1, 0), (0, None), ("s0", "s1"), (None, 0), (0, 0)]
    node = np.full((b, 2), -1)
    for lane in range(b):
        for slot, o in enumerate(orders[lane % len(orders)]):
            node[lane, slot] = -1 if o is None else (short[lane, int(o[1])] if isinstance(o, str)
                                                     else o)
    seg_start = np.where(node >= 0, starts[node.clip(0)], 0).astype(np.int32)
    seg_len = np.where(node >= 0, lens[node.clip(0)], -1).astype(np.int32)

    def u32(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint32)

    cand = u32(b, w)
    one_word = np.arange(w)[None, :] == rng.integers(0, w, b)[:, None]
    cand = np.where((rng.random(b) < 0.5)[:, None], np.where(one_word, cand, 0), cand)
    cand[6::7] = 0
    n_p = 5
    depth = rng.integers(0, n_p - 1, b)
    depth[10::11] = n_p - 1
    x = dict(indices=indices, dom_bits=u32(p_pad, w) | u32(p_pad, w) | u32(p_pad, w),
             seg_start=seg_start, seg_len=seg_len,
             child_pos=rng.integers(0, p_pad, b).astype(np.int32), depth=depth.astype(np.int32),
             n_p=n_p, used=u32(b, w) & u32(b, w) & u32(b, w), cand=cand)
    return x, deg_cap


@pytest.mark.parametrize("w,b", [(40, 24), (64, 17)])
def test_emulation_hub_rows_in_either_slot(rng, w, b):
    """Hub rows over four times the long-walk threshold, driving or
    searched, in either slot: the block walks the long pivots as bitmaps
    (every warp of the block), short pivots search the hubs, and the
    bits equal the plain versions' and repro's kernels'."""
    x, deg_cap = hub_inputs(rng, b, w, 4 * LONG_WALK + 100)
    stats = _check_all(x, deg_cap, pallas=w == 40)
    _assert_rows_read_once(x, stats)
    assert stats["long"], "no lane took the block-wide walk"
    assert all(n == ce_mod.CSR_STEP_WARPS for n in stats["long_warps"])
    assert stats["first_longest"] > 0  # the lead is the hub: the pivot is the short row


def test_emulation_hub_against_itself_and_ids_past_the_bitmap(rng):
    """A long pivot against itself (the same hub in both slots), and ids
    outside [0, 32 w) in rows (clamped to the first or last bit; the block
    walk searches them exactly): equal to the plain versions.  One such id
    per clamped bit: the plain versions add the survivors' bits, which is
    their OR only while no two survivors share a bit."""
    x, deg_cap = hub_inputs(rng, 16, 40, 3 * LONG_WALK)
    idx = x["indices"]
    n_bits = 32 * 40
    # hub 0 (row 0, ids sorted and distinct) starts below the bitmap and ends past it
    start, n = int(x["seg_start"][0, 0]), int(x["seg_len"][0, 0])
    idx[start] = -3
    idx[start + n - 1] = n_bits + 5
    x["seg_len"][:, 1] = np.where(np.arange(16) % 2 == 0, x["seg_len"][:, 0], x["seg_len"][:, 1])
    x["seg_start"][:, 1] = np.where(np.arange(16) % 2 == 0, x["seg_start"][:, 0],
                                    x["seg_start"][:, 1])
    x["dom_bits"][:, 0] |= 1
    x["dom_bits"][:, -1] |= np.uint32(1 << 31)
    x["used"][:, 0] &= ~np.uint32(1)
    x["used"][:, -1] &= ~np.uint32(1 << 31)
    stats = _check_all(x, deg_cap, pallas=False)
    assert stats["long"]


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

def _edge_case(rng, case, w):
    b, mp, n_rows, deg_cap, p_pad = 13, 3, 12, 8, 4
    x = csr_step_inputs(rng, b, w, mp, n_rows, deg_cap, p_pad)
    if case == "mp0":
        x = csr_step_inputs(rng, b, w, 0, n_rows, deg_cap, p_pad)
    elif case == "no_parents":
        x["seg_len"][:] = -1
    elif case == "empty_cand":
        x["cand"][:] = 0
    elif case == "zero_rows":
        x["seg_len"][x["seg_len"] >= 0] = 0
    elif case == "full_rows":  # every real slot one row of deg_cap sorted ids
        x["seg_start"][:] = 0
        x["seg_len"][x["seg_len"] >= 0] = deg_cap
        x["indices"][:deg_cap] = np.arange(deg_cap)  # sorted
    elif case == "duplicates":
        idx = x["indices"]
        body = idx[idx != SENTINEL]
        dup = np.sort(np.repeat(body, 2)[:body.size])
        x["indices"][:body.size] = dup
    return x, deg_cap


@pytest.mark.parametrize("w", [1, 2, 3, 33, 1034, 1035])
@pytest.mark.parametrize("case", ["mp0", "no_parents", "empty_cand", "zero_rows", "full_rows",
                                  "duplicates"])
def test_emulation_edge_cases(rng, w, case):
    x, deg_cap = _edge_case(rng, case, w)
    stats = _check_all(x, deg_cap, pallas=w <= 33)
    _assert_rows_read_once(x, stats)


# ---------------------------------------------------------------------------
# the host's layout rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [0, 2, 8, 16])
def test_layout_fits_every_width(mp):
    """Lanes per block for every w up to MAX_W: at least one, at most one
    per warp, their shared memory within 227 KB; never more lanes at a
    wider row; eight at the served width (w 1,034) for a full step."""
    prev = ce_mod.CSR_STEP_WARPS
    for w in range(1, ce_mod.MAX_W + 1):
        lay = ce_mod.csr_step_layout(w, mp, 4096)
        assert 1 <= lay.lanes <= min(prev, ce_mod.CSR_STEP_WARPS), w
        assert lay.smem == 4 * lay.lanes * lay.lane_words <= ce_mod.CSR_STEP_MAX_SMEM, w
        assert lay.lane_words >= 2 * (w + 3) + 2 * mp
        prev = lay.lanes
    assert ce_mod.csr_step_layout(1034, 8, 4096).lanes == ce_mod.CSR_STEP_WARPS
    assert ce_mod.csr_step_layout(ce_mod.MAX_W, 8, 4096).lanes == 1


@pytest.mark.parametrize("b,lanes", [(1, 1), (7, 1), (264, 1), (265, 2), (512, 2), (1024, 4),
                                     (4096, 8), (4097, 8)])
def test_layout_spreads_small_batches(b, lanes):
    """A small batch gets fewer lanes per block, so its blocks still cover
    the card's SMs (about two blocks per SM)."""
    lay = ce_mod.csr_step_layout(1034, 8, b)
    assert lay.lanes == lanes
    assert -(-b // lay.lanes) >= min(b, ce_mod.TARGET_BLOCKS // 2)


def test_layout_has_no_lane_past_the_shared_memory():
    """Where one lane's base and child do not fit 227 KB the rule gives no
    lane (the wrappers refuse such a width); that starts above MAX_W."""
    first = next(w for w in range(ce_mod.MAX_W, 2 * ce_mod.MAX_W)
                 if ce_mod.csr_step_layout(w, 8, 1).lanes == 0)
    assert first > ce_mod.MAX_W
    assert ce_mod.csr_step_layout(first, 8, 1).smem == 0


def test_layout_constants_come_from_the_header():
    """The host reads the rule's constants from ``csr_extend.cuh`` itself,
    so an edit of the header moves the host's rule (and this file's
    emulation) with it."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / "csr_extend.cuh").read_text()
    k = ce_mod.header_constants(text)
    assert (ce_mod.CSR_STEP_WARPS, ce_mod.CSR_STEP_MAX_SMEM, ce_mod.LONG_WALK, ce_mod.UNITS,
            ce_mod.UNROLL, ce_mod.HEADER, ce_mod.TARGET_BLOCKS) == (
        k["kWarps"], k["kMaxSmem"], k["kLongWalk"], k["kUnits"], k["kUnroll"], k["kHeader"],
        k["kTargetBlocks"])
    assert k["kThreads"] == 32 * k["kWarps"]
    edited = text.replace("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")
    assert edited != text
    assert ce_mod.header_constants(edited)["kThreads"] == 128
    assert ce_mod.header_constants(
        "constexpr unsigned kA = 0xFFu;\nconstexpr size_t kB = 2 * kA;") == {"kA": 255, "kB": 510}
