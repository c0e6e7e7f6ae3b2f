"""Plain PyTorch versions of the engine's kernels, and the bit helpers
they share.

Each function computes exactly what its kernel computes
(`repro_torch.kernels.candidate_mask`, `repro_torch.kernels.extend_step`,
`repro_torch.kernels.popcount_reduce`, `repro_torch.kernels.domain_ac`)
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


def popcount_rows_ref(bits: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of ``[n, w]`` bitmaps -> ``[n]`` int32."""
    return popcount32(bits).sum(dim=-1, dtype=torch.int32)


def adjacency_any_ref(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row "does ``rows[t] ∧ mask`` have any set bit" — the inner test
    of RI-DS arc consistency.  ``[n_t, w] × [w] -> [n_t]`` int32 in {0, 1}."""
    return ((rows & mask[None, :]) != 0).any(dim=-1).to(torch.int32)


def arc_any_sweep_ref(
    adj_flat: torch.Tensor,  # [n_planes, n_t, w] int32
    arc_row: torch.Tensor,  # [n_arcs] int32 plane index per arc
    masks: torch.Tensor,  # [n_arcs, w] int32 (D(q) bitmap per arc)
) -> torch.Tensor:
    """All arcs of one AC sweep: ``out[a, t] = any(adj_flat[arc_row[a], t]
    ∧ masks[a])`` -> ``[n_arcs, n_t]`` int32.  One arc at a time, so the
    ``[n_arcs, n_t, w]`` gather is never materialized."""
    out = torch.empty((masks.shape[0], adj_flat.shape[1]), dtype=torch.int32,
                      device=masks.device)
    for a, r in enumerate(arc_row.tolist()):
        out[a] = adjacency_any_ref(adj_flat[r], masks[a])
    return out


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
