"""Plain PyTorch versions of the engine's kernels, and the bit helpers
they share.

Each function computes exactly what its kernel computes
(`repro_torch.kernels.candidate_mask`, `repro_torch.kernels.extend_step`,
`repro_torch.kernels.popcount_reduce`, `repro_torch.kernels.domain_ac`,
`repro_torch.kernels.csr_extend`, `repro_torch.kernels.flash_attention`)
and mirrors ``repro.kernels.ref``.  The kernel wrappers run these on CPU
tensors; the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.

Bitmaps are ``int32`` tensors carrying the bits of ``uint32`` words: torch
has no ``~``, ``>>`` or ``-`` for ``uint32`` and no popcount.  The
popcount widens each word to ``int64`` (masked to its low 32 bits) so that
the SWAR steps never overflow a signed type.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
META_WIDTH = 4  # (valid, v, is_match, has_child) per lane


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (SWAR), as int32."""
    y = x.to(torch.int64) & 0xFFFFFFFF
    y = y - ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F
    return (((y * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of each 32-bit word (32 for a zero word), as int32."""
    y = x.to(torch.int64) & 0xFFFFFFFF
    return popcount32(((y & -y) - 1).to(torch.int32))


def lowest_bit(cand: torch.Tensor):
    """Lowest set bit of each row of a ``[b, w]`` bitmap.

    Returns ``(valid [b] bool, widx [b] int64, v [b] int32, lowbit [b]
    int32)``: whether the row has a set bit, the index of its first
    non-zero word, the global bit index, and the one-hot word of the bit.
    ``v``, ``widx`` and ``lowbit`` are meaningless on rows that are not
    ``valid``; callers gate on it.
    """
    nz = cand != 0
    valid = nz.any(dim=-1)
    widx = nz.to(torch.int32).argmax(dim=-1)  # first maximum: first non-zero word
    word = cand.gather(-1, widx[:, None])[:, 0]
    v = widx.to(torch.int32) * WORD_BITS + ctz32(word)
    return valid, widx, v, word & -word


def candidate_mask_ref(
    rows: torch.Tensor,  # [n_rows + 1, w] int32 (last row all ones)
    dom_bits: torch.Tensor,  # [p_pad, w] int32
    pos: torch.Tensor,  # [b] int32 order position per lane
    row_idx: torch.Tensor,  # [b, mp] int32 flattened adjacency row per parent
    used: torch.Tensor,  # [b, w] int32
) -> torch.Tensor:
    """``dom[pos] ∧ ¬used ∧ ⋀_j rows[row_idx[:, j]]`` per lane.

    ``row_idx`` entries must already point at the neutral all-ones row for
    unused parent slots.
    """
    cand = dom_bits[pos.long()] & ~used
    for j in range(row_idx.shape[1]):
        cand = cand & rows[row_idx[:, j].long()]
    return cand


def extend_step_ref(
    rows: torch.Tensor,  # [n_rows + 1, w] int32 (last row all ones)
    dom_bits: torch.Tensor,  # [p_pad, w] int32
    child_pos: torch.Tensor,  # [b] int32 order position of the child
    row_idx: torch.Tensor,  # [b, mp] int32 (unused slots -> n_rows)
    depth: torch.Tensor,  # [b] int32 depth of the popped entry
    n_p: int,  # actual pattern size
    used: torch.Tensor,  # [b, w] int32
    cand: torch.Tensor,  # [b, w] int32
):
    """The fused expansion step, one lane per row.

    Per lane: extract the lowest set candidate bit ``v`` (``cand2`` is the
    residual), build ``child = dom[child_pos] ∧ ¬used ∧ ¬bit(v) ∧ ⋀_j
    rows[row_idx[:, j]]``, zero it unless a child is wanted, and emit
    ``meta = (valid, v, is_match, has_child)`` int32 columns (``v`` is -1
    on invalid lanes).  Returns ``(cand2, child_cand, meta)``.
    """
    w = cand.shape[1]
    valid, widx, v, lowbit = lowest_bit(cand)
    sel = (torch.arange(w, device=cand.device)[None, :] == widx[:, None]) & valid[:, None]
    vmask = torch.where(sel, lowbit[:, None], 0)
    cand2 = cand ^ vmask
    child = dom_bits[child_pos.long()] & ~used & ~vmask
    for j in range(row_idx.shape[1]):
        child = child & rows[row_idx[:, j].long()]
    return _finish_step(valid, v, depth, n_p, cand2, child)


def _finish_step(valid, v, depth, n_p, cand2, child):
    """The step kernels' shared tail: zero ``child`` unless a child is
    wanted and emit ``meta = (valid, v, is_match, has_child)``."""
    is_match = valid & (depth + 1 >= n_p)
    want_child = valid & ~is_match
    child = torch.where(want_child[:, None], child, 0)
    has_child = want_child & (child != 0).any(dim=-1)
    meta = torch.stack(
        [
            valid.to(torch.int32),
            torch.where(valid, v, -1),
            is_match.to(torch.int32),
            has_child.to(torch.int32),
        ],
        dim=1,
    )
    return cand2, child, meta


CSR_SENTINEL = 2**31 - 1  # pads CSR segments: larger than any node id


def _extract(cand, dom_bits, child_pos, used):
    """Lowest-bit extraction and the child base of the CSR steps:
    ``(valid, v, cand2, base = dom[child_pos] ∧ ¬used ∧ ¬bit(v))``."""
    w = cand.shape[1]
    valid, widx, v, lowbit = lowest_bit(cand)
    sel = (torch.arange(w, device=cand.device)[None, :] == widx[:, None]) & valid[:, None]
    vmask = torch.where(sel, lowbit[:, None], 0)
    base = dom_bits[child_pos.long()] & ~used & ~vmask
    return valid, v, cand ^ vmask, base


def _lead_slot(seg_start, seg_len):
    """Per lane: whether any parent slot is real (``seg_len >= 0``), and the
    first real slot's segment start and length (length 0 without one).
    A plan without parent slots gets one neutral slot, as in ``repro``."""
    b = seg_len.shape[0]
    if seg_len.shape[1] == 0:
        seg_start = torch.zeros((b, 1), dtype=torch.int32, device=seg_len.device)
        seg_len = torch.full((b, 1), -1, dtype=torch.int32, device=seg_len.device)
    real = seg_len >= 0
    has_parent = real.any(dim=1)
    d = real.to(torch.int32).argmax(dim=1)  # first real slot (0 if none)
    bidx = torch.arange(b, device=seg_len.device)
    d_start = seg_start[bidx, d]
    d_len = torch.where(has_parent, seg_len[bidx, d], 0)
    return seg_start, seg_len, real, d, has_parent, d_start, d_len


def _member_slots(real, d):
    """The parent slots some lane must search (real and not its lead);
    the others would leave every lane's survivors unchanged."""
    other = real & (torch.arange(real.shape[1], device=real.device)[None, :] != d[:, None])
    return [j for j, on in enumerate(other.any(dim=0).tolist()) if on]


def _bit_of(u, base):
    """``(word, bit)`` of node ids ``u`` (clipped to the bitmap) and whether
    that bit is set in the lane's ``base`` row."""
    w = base.shape[1]
    u_c = u.clamp(0, w * WORD_BITS - 1)
    word = (u_c // WORD_BITS).long()
    bit = u_c % WORD_BITS
    in_base = ((base.gather(1, word) >> bit) & 1) != 0
    return word, bit, in_base


def _scatter_bits(walked, ok, word, bit):
    """OR ``bit`` into ``walked[:, word]`` where ``ok`` (``walked`` has one
    spare column that takes the dropped entries).  A row's survivors are
    distinct (deduped), so an add is the OR."""
    w = walked.shape[1] - 1
    bits = torch.where(ok, torch.ones_like(bit) << bit, 0)
    walked.scatter_add_(1, torch.where(ok, word, w), bits)


def csr_extend_ref(
    indices: torch.Tensor,  # [nnz_pad + deg_cap] int32 flat CSR columns
    dom_bits: torch.Tensor,  # [p_pad, w] int32
    seg_start: torch.Tensor,  # [b, mp] int32 segment offsets into ``indices``
    seg_len: torch.Tensor,  # [b, mp] int32 (-1 on unused parent slots)
    child_pos: torch.Tensor,  # [b] int32 order position of the child
    depth: torch.Tensor,  # [b] int32 depth of the popped entry
    n_p: int,  # actual pattern size
    used: torch.Tensor,  # [b, w] int32
    cand: torch.Tensor,  # [b, w] int32
    *,
    deg_cap: int,
):
    """The sparse expansion step, one lane per row (``repro``'s
    ``csr_extend_ref``): extract the lowest candidate bit ``v``, form
    ``base = dom[child_pos] ∧ ¬used ∧ ¬bit(v)``, walk the **first** real
    parent's CSR segment (``deg_cap`` wide, masked at its length) and keep
    each entry that differs from the one before it, is set in ``base`` and
    is found by a binary search in every other real parent's sorted segment
    (its first ``deg_cap`` entries).  Survivors scatter into the child;
    parentless lanes keep ``base``.  Returns ``(cand2, child, meta)`` as
    :func:`extend_step_ref`."""
    b, w = cand.shape
    valid, v, cand2, base = _extract(cand, dom_bits, child_pos, used)
    seg_start, seg_len, real, d, has_parent, d_start, d_len = _lead_slot(seg_start, seg_len)
    n_idx = indices.shape[0]
    offs = torch.arange(deg_cap, dtype=torch.int32, device=cand.device)[None, :]
    u = indices[(d_start[:, None] + offs).clamp(0, n_idx - 1).long()]  # [b, K]
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=u.device),
                     u[:, 1:] == u[:, :-1]], dim=1)
    word, bit, in_base = _bit_of(u, base)
    ok = (offs < d_len[:, None]) & ~dup & in_base
    for j in _member_slots(real, d):
        seg = indices[(seg_start[:, j:j + 1] + offs).clamp(0, n_idx - 1).long()]
        seg = torch.where(offs < seg_len[:, j:j + 1], seg, CSR_SENTINEL).contiguous()
        p = torch.searchsorted(seg, u.contiguous())
        hit = seg.gather(1, p.clamp(0, deg_cap - 1)) == u
        skip = ~real[:, j] | (d == j)
        ok = ok & (skip[:, None] | hit)
    walked = torch.zeros((b, w + 1), dtype=torch.int32, device=cand.device)
    _scatter_bits(walked, ok, word, bit)
    child = torch.where(has_parent[:, None], walked[:, :w], base)
    return _finish_step(valid, v, depth, n_p, cand2, child)


def csr_extend_bucketed_ref(
    indices: torch.Tensor,  # [nnz_pad + deg_cap] int32 flat CSR columns
    dom_bits: torch.Tensor,  # [p_pad, w] int32
    seg_start: torch.Tensor,  # [b, mp] int32 segment offsets into ``indices``
    seg_len: torch.Tensor,  # [b, mp] int32 (-1 on unused parent slots)
    child_pos: torch.Tensor,  # [b] int32
    depth: torch.Tensor,  # [b] int32
    n_p: int,
    used: torch.Tensor,  # [b, w] int32
    cand: torch.Tensor,  # [b, w] int32
    *,
    deg_cap: int,
    chunk: int = 8,
):
    """:func:`csr_extend_ref` with ``repro``'s degree-bucketed walk
    (``csr_extend_bucketed_ref``): same contract, same results.  The lead
    segment is walked in ``chunk``-wide trips, each lane up to its row's
    pow2 bucket cap ``min(max(nextpow2(len), chunk), deg_cap)``, and
    membership is a fixed-trip lower-bound binary search over each other
    parent's ``[start, start + len)`` in the flat ``indices``."""
    b, w = cand.shape
    dev = cand.device
    valid, v, cand2, base = _extract(cand, dom_bits, child_pos, used)
    seg_start, seg_len, real, d, has_parent, d_start, d_len = _lead_slot(seg_start, seg_len)
    n_idx = indices.shape[0]

    m = d_len.clamp_min(1) - 1
    for shift in (1, 2, 4, 8, 16):
        m = m | (m >> shift)
    bcap = torch.minimum((m + 1).clamp_min(chunk), torch.full_like(m, deg_cap))
    trips = (bcap + chunk - 1) // chunk
    n_trips = int(trips.max()) if b else 0

    offs_c = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
    lo0 = seg_start
    hi0 = lo0 + seg_len.clamp_min(0)
    search_iters = max(1, deg_cap).bit_length() + 1

    def at(i):
        return indices[i.clamp(0, n_idx - 1).long()]

    prev = torch.full((b,), -1, dtype=torch.int32, device=dev)
    walked = torch.zeros((b, w + 1), dtype=torch.int32, device=dev)
    member_slots = _member_slots(real, d)
    for i in range(n_trips):
        k = i * chunk + offs_c
        u = at(d_start[:, None] + k)  # [b, chunk]
        left = torch.cat([prev[:, None], u[:, :-1]], dim=1)
        word, bit, in_base = _bit_of(u, base)
        ok = (k < d_len[:, None]) & (u != left) & in_base
        rem = (d_len - i * chunk).clamp(0, chunk)
        last = u.gather(1, (rem - 1).clamp_min(0).long()[:, None])[:, 0]
        prev = torch.where(rem > 0, last, prev)
        for j in member_slots:
            lo = lo0[:, j:j + 1].expand_as(u)
            hi = hi0[:, j:j + 1].expand_as(u)
            for _ in range(search_iters):
                pred = lo < hi
                mid = (lo + hi) >> 1
                go = pred & (at(mid) < u)
                lo, hi = torch.where(go, mid + 1, lo), torch.where(pred & ~go, mid, hi)
            hit = (lo < hi0[:, j:j + 1]) & (at(lo) == u)
            skip = ~real[:, j] | (d == j)
            ok = ok & (skip[:, None] | hit)
        _scatter_bits(walked, ok, word, bit)
    child = torch.where(has_parent[:, None], walked[:, :w], base)
    return _finish_step(valid, v, depth, n_p, cand2, child)


def csr_arc_sweep_ref(
    seg_start: torch.Tensor,  # [n_planes, n_t] int32 global offsets into indices
    seg_len: torch.Tensor,  # [n_planes, n_t] int32 row lengths
    indices: torch.Tensor,  # [n_idx] int32 flat CSR columns (sentinel tail)
    arc_row: torch.Tensor,  # [n_arcs] int32 plane index per arc
    masks: torch.Tensor,  # [n_arcs, w] int32 (D(q) bitmap per arc)
    *,
    deg_cap: int,
    arcs_per_pass: int = 32,
) -> torch.Tensor:
    """All arcs of one CSR AC sweep: ``out[a, t] = any(u in row(arc_row[a],
    t)[:min(len, deg_cap)] : bit u set in masks[a])`` -> ``[n_arcs, n_t]``
    int32 (``repro``'s ``csr_arc_sweep_ref``).  Bit-tests the whole flat
    ``indices`` per arc and reduces each row by a prefix-sum difference over
    ``[seg_start, seg_start + len)``; entries outside ``[0, w · 32)`` (the
    sentinel tail) and arcs whose plane lies outside ``[0, n_planes)``
    support nothing.  ``arcs_per_pass`` arcs at a time bound the ``[arcs,
    n_idx]`` transient."""
    n_idx = indices.shape[0]
    n_arcs, w = masks.shape
    n_planes = seg_start.shape[0]
    if n_planes == 0 or w == 0:  # no plane or no node: nothing is supported
        return torch.zeros((n_arcs, seg_start.shape[1]), dtype=torch.int32, device=masks.device)
    on_plane = (arc_row >= 0) & (arc_row < n_planes)
    sl = seg_len.clamp(max=deg_cap)
    u_c = indices.clamp(0, w * WORD_BITS - 1)
    word = (u_c // WORD_BITS).long()
    bit = u_c % WORD_BITS
    node_ok = (indices >= 0) & (indices < w * WORD_BITS)
    out = torch.empty((n_arcs, seg_start.shape[1]), dtype=torch.int32, device=masks.device)
    for a0 in range(0, n_arcs, arcs_per_pass):
        m = masks[a0:a0 + arcs_per_pass]
        r = arc_row[a0:a0 + arcs_per_pass].long().clamp(0, n_planes - 1)
        hits = node_ok & (((m[:, word] >> bit) & 1) != 0)  # [arcs, n_idx]
        c = torch.zeros((m.shape[0], n_idx + 1), dtype=torch.int32, device=masks.device)
        c[:, 1:] = torch.cumsum(hits, dim=1, dtype=torch.int32)
        lo = seg_start[r].clamp(0, n_idx)
        hi = torch.maximum(torch.minimum(seg_start[r] + sl[r], torch.full_like(lo, n_idx)), lo)
        out[a0:a0 + arcs_per_pass] = ((c.gather(1, hi.long()) - c.gather(1, lo.long()) > 0)
                                      & on_plane[a0:a0 + arcs_per_pass, None]).to(torch.int32)
    return out


def popcount_rows_ref(bits: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of ``[n, w]`` bitmaps -> ``[n]`` int32."""
    return popcount32(bits).sum(dim=-1, dtype=torch.int32)


def adjacency_any_ref(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row "does ``rows[t] ∧ mask`` have any set bit" — the inner test
    of RI-DS arc consistency.  ``[n_t, w] × [w] -> [n_t]`` int32 in {0, 1}."""
    return ((rows & mask[None, :]) != 0).any(dim=-1).to(torch.int32)


def adjacency_any_pairs_ref(
    adj_flat: torch.Tensor,  # [n_planes, n_t, w] int32
    plane: torch.Tensor,  # [n_pairs] int32 plane index per pair
    masks: torch.Tensor,  # [n_pairs, w] int32 (D(q) bitmap per pair)
) -> torch.Tensor:
    """The support tests of one sweep's (pattern, arc) pairs: ``out[i, t] =
    any(adj_flat[plane[i], t] ∧ masks[i])`` -> ``[n_pairs, n_t]`` int32; a
    plane index outside ``[0, n_planes)`` supports no node.  One pair at a
    time, so the ``[n_pairs, n_t, w]`` gather is never materialized."""
    out = torch.zeros((masks.shape[0], adj_flat.shape[1]), dtype=torch.int32,
                      device=masks.device)
    for i, r in enumerate(plane.tolist()):
        if 0 <= r < adj_flat.shape[0]:
            out[i] = adjacency_any_ref(adj_flat[r], masks[i])
    return out


def arc_any_sweep_ref(
    adj_flat: torch.Tensor,  # [n_planes, n_t, w] int32
    arc_row: torch.Tensor,  # [n_arcs] int32 plane index per arc
    masks: torch.Tensor,  # [n_arcs, w] int32 (D(q) bitmap per arc)
) -> torch.Tensor:
    """All arcs of one AC sweep: ``out[a, t] = any(adj_flat[arc_row[a], t]
    ∧ masks[a])`` -> ``[n_arcs, n_t]`` int32, the same function as
    :func:`adjacency_any_pairs_ref` (K4 and K5 share one kernel)."""
    return adjacency_any_pairs_ref(adj_flat, arc_row, masks)


def pack_bits_ref(flags: torch.Tensor, w: int) -> torch.Tensor:
    """Pack ``[..., n]`` {0, 1} flags into ``[..., w]`` int32 words, bit
    ``t % 32`` of word ``t // 32`` for flag ``t`` (LSB first)."""
    n = flags.shape[-1]
    padded = torch.zeros(flags.shape[:-1] + (w * WORD_BITS,), dtype=torch.int64,
                         device=flags.device)
    padded[..., :n] = flags.to(torch.int64)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=flags.device) << torch.arange(
        WORD_BITS, device=flags.device)
    words = (padded.reshape(flags.shape[:-1] + (w, WORD_BITS)) * weights).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense causal attention, the plain version of K9.

    ``q`` ``[BH, S, d]``, ``k`` / ``v`` ``[BH, S_kv, d]``; scores in fp32,
    query ``i`` sees keys ``j <= i`` (both counted from 0, also when
    ``S != S_kv``); returns ``[BH, S, d]`` in the dtype of ``q``.
    """
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (q.shape[-1] ** 0.5)
    n_q, n_k = s.shape[-2:]
    mask = (torch.arange(n_q, device=q.device)[:, None]
            >= torch.arange(n_k, device=q.device)[None, :])
    s = torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
