"""The shared K1 / K2 kernel design (``csrc/dense_step.cuh``), on the CPU.

The CUDA kernel cannot run here, so :func:`_dense_step_emulation` repeats
its per-lane logic in numpy: blocks of ``L`` lanes (``dense_step_layout``),
one warp per lane; K1's pass over ``cand`` as head words to a 16-byte
boundary, 16-byte units in the warp's pass order and tail words (for every
word offset of the row), the first nonzero word found by a min-reduction on
the pass that writes ``cand2``, and the early stop of a lane that wants no
child (no ``used``, dom or adjacency row read); the real parent slots
compacted in ballot order, 32 slots per trip; the rows met word by word,
a pass of ``WORDS`` words per thread loading word ``i`` of ``used``, the dom
row and up to ``SLOTS - 2`` real rows (further groups of ``SLOTS`` rows
within the pass for a lane with more; ``FEW_WORDS`` words and groups of
``FEW_SLOTS`` for a lane with at most ``FEW_SLOTS`` rows); K2's form without the ``cand``
pass, the meta row and the early stop.  It must equal, bit for bit,
`repro_torch.kernels.ref.extend_step_ref`, `candidate_mask_ref` and
``repro``'s Pallas kernels in interpret mode, on the JAX package's own
shape sweeps and at edge cases.  Integer kernels: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.kernels import candidate_mask as jax_cm  # noqa: E402
from repro.kernels import extend_step as jax_es  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import extend_step as es_mod  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from tests.test_extend_step import SHAPES_ES  # noqa: E402
from tests.test_kernels import SHAPES_CM  # noqa: E402
from tests.test_torch_kernels import _inputs, _t  # noqa: E402

# dense_step.cuh: a warp, 16-byte units per thread per pass over cand, rows
# loaded per group and words per thread per pass (and the wider pass of a
# lane with few rows)
LANES, UNITS = 32, es_mod.UNITS
SLOTS, WORDS, FEW_SLOTS, FEW_WORDS = es_mod.SLOTS, es_mod.WORDS, es_mod.FEW_SLOTS, es_mod.FEW_WORDS


# ---------------------------------------------------------------------------
# the kernel's per-lane logic
# ---------------------------------------------------------------------------

def _cand_passes(w: int, r: int):
    """``RowSplit`` for a row of ``w`` words starting ``r`` words past a
    16-byte boundary: per pass, per lane, the words the lane holds (its head
    or tail word, then its units' words)."""
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
    return passes


def _cand_pass(c, r, stats_row):
    """K1's pass over one lane's ``cand``: ``(first, v, cand2)``, ``first``
    None when ``cand`` is empty.  Counts each word read in ``stats_row``."""
    first, lowbit = None, 0
    cand2 = c.copy()
    for lanes in _cand_passes(c.size, r):
        for ws in lanes:
            stats_row[ws] += 1
        if first is None:
            mins = [min((i for i in ws if c[i]), default=None) for ws in lanes]
            nz = [m for m in mins if m is not None]
            if nz:  # the warp's min-reduction over the pass
                first = min(nz)
                word = int(c[first])
                lowbit = word & -word
                cand2[first] ^= np.uint32(lowbit)
    v = -1 if first is None else first * 32 + lowbit.bit_length() - 1
    return first, v, lowbit, cand2


def _compact(slots, n_rows):
    """The real slots in ballot order, 32 slots per trip."""
    real = []
    for t0 in range(0, slots.size, LANES):
        trip = slots[t0:t0 + LANES]
        real += [int(r) for r in trip if r != n_rows]  # lane j holds slot t0 + j
    return real


def _rows_meet(sources, w, first, lowbit, stats, l):
    """The child of one lane from its sources (``used``, the dom row, the
    real rows): passes of ``K`` words per thread, word ``i`` of every source
    of a group of ``S`` loaded before any is ANDed; ``(S, K)`` is
    ``(FEW_SLOTS, FEW_WORDS)`` for a lane with at most ``FEW_SLOTS`` sources,
    else ``(SLOTS, WORDS)``."""
    S, K = (FEW_SLOTS, FEW_WORDS) if len(sources) <= FEW_SLOTS else (SLOTS, WORDS)
    stats["passes"].append((len(sources), -(-w // (LANES * K))))
    child = np.zeros(w, np.uint32)
    writes = np.zeros(w, np.int64)
    for c0 in range(0, w, LANES * K):
        held = [[c0 + lane + LANES * k for k in range(K) if c0 + lane + LANES * k < w]
                for lane in range(LANES)]
        idx = np.array(sorted(i for ws in held for i in ws))
        acc = None
        for g0 in range(0, len(sources), S):
            x = np.full(idx.size, 0xFFFFFFFF, np.uint32)
            for j, (name, row) in enumerate(sources[g0:g0 + S]):
                stats[name][l, idx] += 1
                word = row[idx]
                if g0 + j == 0:  # used, and bit v cleared at word first
                    word = ~word & np.where(idx == first, ~np.uint32(lowbit), np.uint32(0xFFFFFFFF))
                x &= word
            acc = x if acc is None else acc & x
        child[idx] = acc
        writes[idx] += 1
    assert (writes == 1).all(), "every child word written once"
    return child


def _dense_step_emulation(x, step=True, cand_word=0, lanes=None, stats=None):
    """The kernel's ``(cand2, child, meta)`` (K1, ``step``) or ``out`` (K2)
    in numpy.  ``cand_word`` is the word offset of ``cand``'s first word from
    a 16-byte boundary (``cand2`` shares it); ``lanes`` forces the lanes per
    block.  ``stats`` counts the words read of each input per lane and the
    blocks."""
    rows = np.asarray(x["rows"], np.uint32)
    dom = np.asarray(x["dom_bits"], np.uint32)
    used = np.asarray(x["used"], np.uint32)
    row_idx = np.asarray(x["row_idx"])
    b, w = used.shape
    mp = row_idx.shape[1]
    n_rows = rows.shape[0] - 1
    L = es_mod.dense_step_layout(mp, b).lanes if lanes is None else lanes
    assert L >= 1
    stats = {} if stats is None else stats
    for name in ("cand", "used", "dom", "rows"):
        stats[name] = np.zeros((b, w), np.int64)
    stats["blocks"], stats["passes"] = 0, []
    cand2 = np.zeros((b, w), np.uint32)
    child = np.zeros((b, w), np.uint32)
    meta = np.zeros((b, 4), np.int32)
    seen = np.zeros(b, np.int64)
    for blk in range(0, b, L):
        stats["blocks"] += 1
        for warp in range(L):
            l = blk + warp
            if l >= b:  # a warp without a lane leaves
                continue
            seen[l] += 1
            first, v, lowbit = None, -1, 0
            want = True
            if step:
                c = np.asarray(x["cand"][l], np.uint32)
                first, v, lowbit, cand2[l] = _cand_pass(c, (cand_word + l * w) % 4,
                                                        stats["cand"][l])
                valid = first is not None
                want = valid and int(x["depth"][l]) + 1 < x["n_p"]
                if not want:  # early stop: a zero child, no other row read
                    meta[l] = (int(valid), v, int(valid), 0)
                    continue
            sources = [("used", used[l]), ("dom", dom[int(x["pos"][l])])]
            sources += [("rows", rows[r]) for r in _compact(row_idx[l], n_rows)]
            child[l] = _rows_meet(sources, w, -1 if first is None else first, lowbit, stats, l)
            meta[l] = (1, v, 0, int(child[l].any()))
    assert (seen == 1).all(), "every lane has one warp"
    return (cand2, child, meta) if step else child


# ---------------------------------------------------------------------------
# inputs and the references
# ---------------------------------------------------------------------------

def _np_inputs(rng, b, w, mp, n_rows, p_pad):
    rows, dom, pos, row_idx, depth, n_p, used, cand = _inputs(rng, b, w, mp, n_rows, p_pad)
    return dict(rows=rows, dom_bits=dom, pos=pos, row_idx=row_idx, depth=depth, n_p=n_p,
                used=used, cand=cand)


def _plain(x, step=True):
    if step:
        got = kref.extend_step_ref(_t(x["rows"]), _t(x["dom_bits"]), _t(x["pos"]),
                                   _t(x["row_idx"]), _t(x["depth"]), x["n_p"], _t(x["used"]),
                                   _t(x["cand"]))
        return [t.numpy() for t in got]
    return kref.candidate_mask_ref(_t(x["rows"]), _t(x["dom_bits"]), _t(x["pos"]),
                                   _t(x["row_idx"]), _t(x["used"])).numpy()


def _pallas(x, step=True):
    if step:
        args = [jnp.asarray(x[k]) for k in ("rows", "dom_bits", "pos", "row_idx", "depth")]
        return jax_es.extend_step(*args, jnp.asarray(np.int32(x["n_p"])), jnp.asarray(x["used"]),
                                  jnp.asarray(x["cand"]), interpret=True)
    return jax_cm.candidate_mask(*[jnp.asarray(x[k]) for k in
                                   ("rows", "dom_bits", "pos", "row_idx", "used")],
                                 interpret=True)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype != np.uint32 else a


def _assert_equal(got, want, label, step=True):
    if not step:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"out vs {label}")
        return
    for name, g, o in zip(("cand2", "child", "meta"), got, want):
        if name == "meta":
            np.testing.assert_array_equal(np.asarray(g), np.asarray(o).astype(np.int32),
                                          err_msg=f"meta vs {label}")
        else:
            np.testing.assert_array_equal(_bits(g), _bits(o), err_msg=f"{name} vs {label}")


def _check(x, step=True, pallas=True, **kw):
    stats = {}
    got = _dense_step_emulation(x, step=step, stats=stats, **kw)
    _assert_equal(got, _plain(x, step), "the plain version", step)
    if pallas:
        _assert_equal(got, _pallas(x, step), "repro's Pallas kernel (interpret)", step)
    return stats


def _assert_rows_read_once(x, stats, step=True):
    """K1: cand read once by every lane; used, the dom row and each real row
    once for lanes that want a child, never for the others.  K2: every lane
    reads its rows once."""
    b, w = np.asarray(x["used"]).shape
    n_rows = np.asarray(x["rows"]).shape[0] - 1
    if step:
        assert (stats["cand"] == 1).all()
        want = (np.asarray(x["cand"]) != 0).any(axis=1) & (np.asarray(x["depth"]) + 1 < x["n_p"])
    else:
        assert not stats["cand"].any()
        want = np.ones(b, bool)
    n_real = (np.asarray(x["row_idx"]) != n_rows).sum(axis=1)
    for name, n in (("used", 1), ("dom", 1), ("rows", n_real)):
        per_lane = np.broadcast_to(np.asarray(n), (b,))[:, None]
        np.testing.assert_array_equal(stats[name][want], np.broadcast_to(per_lane, (b, w))[want])
        assert not stats[name][~want].any(), f"{name} read by a lane that wants no child"


# ---------------------------------------------------------------------------
# the row split of the cand pass
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 33, 393, 1034, 1035])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_cand_split_covers_each_word_once_in_order(w, r):
    """Head words to the 16-byte boundary, units on it, tail words: every
    word in exactly one (pass, lane), each pass after the one before."""
    seen = []
    for lanes in _cand_passes(w, r):
        words = sorted(i for ws in lanes for i in ws)
        assert not seen or words[0] > seen[-1]
        seen += words
    assert seen == list(range(w))
    assert all(len(ws) <= 4 * UNITS + 1 for lanes in _cand_passes(w, r) for ws in lanes)


# ---------------------------------------------------------------------------
# the emulation against the plain versions and repro's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,w,mp,n_rows,p_pad", SHAPES_ES)
@pytest.mark.parametrize("cand_word", [0, 1, 3])
def test_extend_step_emulation_matches_plain_and_pallas(rng, b, w, mp, n_rows, p_pad, cand_word):
    x = _np_inputs(rng, b, w, mp, n_rows, p_pad)
    stats = _check(x, pallas=cand_word == 0, cand_word=cand_word)
    _assert_rows_read_once(x, stats)
    for lanes in (1, 3):  # forced blocks: b not a multiple of the lanes per block
        got = _dense_step_emulation(x, cand_word=cand_word, lanes=lanes)
        _assert_equal(got, _plain(x), f"{lanes} lanes per block")


@pytest.mark.parametrize("b,w,mp,n_rows,p_pad", SHAPES_CM)
def test_candidate_mask_emulation_matches_plain_and_pallas(rng, b, w, mp, n_rows, p_pad):
    x = _np_inputs(rng, b, w, mp, n_rows, p_pad)
    stats = _check(x, step=False)
    _assert_rows_read_once(x, stats, step=False)
    got = _dense_step_emulation(x, step=False, lanes=3)
    _assert_equal(got, _plain(x, step=False), "3 lanes per block", step=False)


EDGE_CASES = ["random", "mp0", "mp1", "mp9", "mp33", "all_neutral", "all_empty", "all_matches",
              "zero_rows", "ones_rows"]


def _edge_case(rng, case, w):
    b, mp, n_rows, p_pad = 13, 3, 12, 4
    if case.startswith("mp"):
        mp = int(case[2:])
        n_rows = max(n_rows, 2 * mp)
    x = _np_inputs(rng, b, w, mp, n_rows, p_pad)
    if case == "all_neutral":
        x["row_idx"][:] = n_rows
    elif case == "all_empty":
        x["cand"][:] = 0
    elif case == "all_matches":
        x["depth"][:] = x["n_p"] - 1
    elif case in ("zero_rows", "ones_rows"):
        x["rows"][:n_rows] = 0 if case == "zero_rows" else 0xFFFFFFFF
        x["row_idx"][:, 0] = 0  # at least one real slot in every lane
    if case in ("mp9", "mp33"):  # every slot real in half the lanes: two groups of rows
        x["row_idx"][::2] = rng.integers(0, n_rows, (x["row_idx"][::2].shape))
    return x


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 33, 393, 1034, 1035])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_emulation_edge_cases(rng, w, case):
    """K1 and K2 at every listed width and edge case, against the plain
    versions, and against repro's Pallas kernels up to w = 33 and mp = 9."""
    x = _edge_case(rng, case, w)
    mp = x["row_idx"].shape[1]
    for step in (True, False):
        # repro's Pallas K2 takes no mp = 0 (its K1 pads one neutral slot)
        stats = _check(x, step=step, pallas=w <= 33 and mp <= 9 and (step or mp > 0),
                       cand_word=w % 4)
        _assert_rows_read_once(x, stats, step=step)
        if step and case in ("all_empty", "all_matches"):  # every lane stops early
            assert not (stats["used"].any() or stats["dom"].any() or stats["rows"].any())


def test_emulation_two_groups_and_two_trips(rng):
    """33 real slots: two trips of row indices compacted into one list, and
    four groups of rows within each pass (SLOTS rows a group)."""
    x = _np_inputs(rng, 9, 70, 33, 80, 4)
    x["row_idx"][:] = rng.integers(0, 80, x["row_idx"].shape)
    assert len(_compact(x["row_idx"][0], 80)) == 33 > LANES
    for step in (True, False):
        stats = _check(x, step=step, pallas=False)
        _assert_rows_read_once(x, stats, step=step)


def test_emulation_takes_the_wider_pass_for_few_rows(rng):
    """Lanes with at most FEW_SLOTS sources (used, dom, up to FEW_SLOTS - 2
    real rows) take FEW_WORDS words per pass, the others WORDS: at w 393,
    fewer passes (round trips) for the lanes with few rows."""
    x = _np_inputs(rng, 40, 393, 8, 60, 8)
    n_real = np.arange(40) % 9  # 0 to 8 real rows
    x["row_idx"][:] = np.where(np.arange(8)[None, :] < n_real[:, None],
                               rng.integers(0, 60, x["row_idx"].shape), 60)
    stats = _check(x, step=False, pallas=False)
    passes = dict(stats["passes"])
    assert passes[2] == passes[FEW_SLOTS] == -(-393 // (LANES * FEW_WORDS))
    assert passes[FEW_SLOTS + 1] == passes[10] == -(-393 // (LANES * WORDS))
    assert FEW_SLOTS * FEW_WORDS <= SLOTS * WORDS  # no more registers of row data


# ---------------------------------------------------------------------------
# the host's layout rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [0, 1, 8, 9, 33, 1000])
def test_layout_fits_the_shared_memory(mp):
    """At least one lane, at most one per warp, their row lists within 227
    KB, for every batch size; eight lanes per block for a full step."""
    for b in (1, 7, 264, 265, 4096, 16384, 100_000):
        lay = es_mod.dense_step_layout(mp, b)
        assert 1 <= lay.lanes <= es_mod.DENSE_STEP_WARPS
        assert lay.smem == 4 * lay.lanes * lay.lane_words <= es_mod.DENSE_STEP_MAX_SMEM
        assert lay.lane_words >= mp and lay.lane_words % 4 == 0
    assert es_mod.dense_step_layout(mp, 4096).lanes == es_mod.DENSE_STEP_WARPS


def test_layout_has_no_lane_past_the_shared_memory():
    """A row list that does not fit 227 KB gives no lane (the wrappers refuse
    such an mp)."""
    too_many = es_mod.DENSE_STEP_MAX_SMEM // 4 + 4
    assert es_mod.dense_step_layout(too_many, 1).lanes == 0
    assert es_mod.dense_step_layout(too_many - 8, 1).lanes == 1


@pytest.mark.parametrize("b,lanes", [(1, 1), (7, 1), (264, 1), (265, 2), (1024, 4), (2115, 8),
                                     (4096, 8), (16384, 8)])
def test_layout_spreads_small_batches(b, lanes):
    """A small batch gets fewer lanes per block, so its blocks still cover
    the card's SMs (about two blocks per SM); b 2,115 leaves 3 lanes in the
    last block."""
    lay = es_mod.dense_step_layout(8, b)
    assert lay.lanes == lanes
    assert -(-b // lay.lanes) >= min(b, es_mod.TARGET_BLOCKS // 2)


def test_layout_constants_come_from_the_header():
    """The host reads the rule's constants from ``dense_step.cuh`` itself, so
    an edit of the header moves the host's rule (and this file's emulation)
    with it."""
    text = (_build.CSRC / "dense_step.cuh").read_text()
    k = _build.header_constants(text)
    assert (es_mod.DENSE_STEP_WARPS, es_mod.DENSE_STEP_MAX_SMEM, es_mod.UNITS, es_mod.WORDS,
            es_mod.SLOTS, es_mod.FEW_WORDS, es_mod.FEW_SLOTS, es_mod.TARGET_BLOCKS) == (
        k["kWarps"], k["kMaxSmem"], k["kUnits"], k["kWords"], k["kSlots"], k["kFewWords"],
        k["kFewSlots"], k["kTargetBlocks"])
    for name in ("extend_step", "candidate_mask"):
        assert _build.CSRC / "dense_step.cuh" in _build.sources(name)
    edited = text.replace("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")
    assert edited != text and _build.header_constants(edited)["kWarps"] == 4
