"""K5 ``adjacency_any``, K4 ``arc_any_sweep`` and K8 ``csr_arc_sweep``: the
support test of RI-DS arc consistency, as CUDA kernels.

One AC test for a constraint arc ``(p, q, dir, label)`` asks, for every
target node ``t``, whether ``adj_rows[t] ∧ D(q)`` has a set bit: an
``[n_t, w]`` bitmap AND against a broadcast ``[w]`` mask, then an any per
row.  K5 and K4 compute one function over dense planes,
``out[i, t] = any(adj_flat[plane[i], t] ∧ masks[i])`` (a plane index outside
``[0, n_planes)`` supports no node), with one device implementation,
``csrc/arc_any.cuh``:

* :func:`adjacency_any_pairs_cuda` (K5) — the live (pattern, arc) pairs of
  one sweep of the batched (``"per-arc"``) fixpoint, one launch per sweep:
  ``repro``'s batched path runs ``repro/kernels/domain_ac.py::adjacency_any``
  vmapped over lanes and mapped over arc slots; a pair names its plane by
  index, so the vmapped ``[n_pairs, n_t, w]`` gather is never made.
  :func:`adjacency_any_cuda` is its one-arc form, ``rows [n_t, w] × mask
  [w] -> [n_t]``, a one-pair launch of the same kernel.
* :func:`arc_any_sweep_cuda` (K4) — every arc of one sweep of the
  single-query (``"sweep"``) fixpoint.  Replaces
  ``repro/kernels/domain_ac.py::arc_any_sweep``, whose ``(arc, row tile)``
  grid chased a scalar-prefetched ``arc_row`` table.

The kernel (built twice, as ``csrc/adjacency_any.cu`` and
``csrc/arc_any_sweep.cu``, so each keeps its library and launch count)
gives a block one (plane, tile of ``R`` rows): it reads the tile once with
16-byte loads, compacts each row's nonzero words into ``S`` shared-memory
slots, and tests them against the masks of the pairs on its plane, staged
``C`` at a time; :func:`arc_any_layout` picks ``R``, ``S`` and ``C``.  Bound
by memory: each named plane read once, the masks, the ``[n_pairs, n_t]``
flags.

:func:`csr_arc_sweep_cuda` (K8, ``csrc/csr_arc_sweep.cu`` + ``csrc/csr_arc_sweep.cuh``)
is the same sweep over CSR planes: ``out[a, t] = any(u ∈ row(arc_row[a],
t)[:min(len, deg_cap)] : bit u ∈ masks[a])``.  It replaces
``repro/kernels/domain_ac.py::csr_arc_sweep`` (body ``_csr_sweep_kernel``),
whose ``(arc, row tile)`` grid chose the plane's segment bounds through a
scalar-prefetched ``arc_row`` and tested each row against one arc.  Here the
arcs are grouped by plane on the card: each chunk of :data:`ARC_CHUNK` arcs
forms groups of up to :data:`GROUP` arcs of one plane, in order of
appearance, and every block finds its own group from its chunk's planes, so
the grids are sized on the host (:func:`csr_sweep_layout`) and nothing is
read back.  One call is two kernels: the first transposes each group's masks
by warp ballots into a table ``T[g, u]``, whose bit ``j`` is bit ``u`` of
the group's ``j``-th mask; the second, launched as a programmatic dependent
of the first, gives a block one (group, tile of :data:`SWEEP_ROWS` rows): it
reads the tile's bounds and first entries while the table is built, then
tests each entry against all of the group's arcs with one lookup of ``T``.
A warp walks its 32 rows' capped entries as one run (a row stops being read
once every arc of the group has support); rows longer than :data:`HUB_LEN`
are walked by the whole block.  The sparse fixpoint calls it once per AC
sweep over the arcs of every live pattern.  Bound by memory: each named
plane's bounds and entries read once (as far as the furthest-reading arc on
it needs), the masks, and the ``[n_arcs, n_t]`` flags; the table adds ``32 ·
w`` words per group, written once and read from L2.

The plain versions are `repro_torch.kernels.ref.adjacency_any_ref`,
`adjacency_any_pairs_ref`, `arc_any_sweep_ref` and `csr_arc_sweep_ref`;
`repro_torch.kernels.ops` picks by device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (the plain versions)
    adjacency_any_pairs_ref,
    adjacency_any_ref,
    arc_any_sweep_ref,
    csr_arc_sweep_ref,
)

# since ops.reset_launch_counts()
launches = {"adjacency_any": 0, "arc_any_sweep": 0, "csr_arc_sweep": 0}

# K4 / K5 stage at least one mask per chunk in shared memory, which a block
# gets 48 KB of by default (K8 keeps its masks in a table in global memory and
# its shared memory does not grow with w, so it takes any width)
MAX_W = 48 * 1024 // 4

# csrc/arc_any.cuh's block and the layout rule of its shared memory
ARC_ANY_WARPS = 16  # kThreads / 32
ARC_ANY_MAX_SMEM = 232448  # kMaxSmem, 227 KB
CHUNK_CAP = 64  # kMaxChunk: masks per chunk, two per lane
ROW_BLOCKS = 264  # two 512-thread blocks on each of the H100's 132 SMs
MAX_ROWS = 128  # rows per tile
ROW_SLOTS = 6144  # compacted (column, word) slots per tile, 8 bytes each
STOP_EVERY = 8  # kStopEvery: words per test batch; a row's slots come in batches
SMEM_TARGET = 110 * 1024  # two blocks per SM

_ARC_ANY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_CSR_SWEEP_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])

# csrc/csr_arc_sweep.cuh's blocks and the layout rule of its grids and table
# (K8); these are its constants, read from the header
_KS = _build.header_constants((_build.CSRC / "csr_arc_sweep.cuh").read_text())
SWEEP_WARPS = _KS["kWarps"]  # warps of a block (table and sweep)
SWEEP_ROWS = _KS["kRows"]  # rows per tile, one per thread
SWEEP_UNROLL = _KS["kUnroll"]  # entries per lane in flight in a warp walk
HUB_LEN = _KS["kHubLen"]  # a row with more capped entries is walked by the whole block
HUB_UNROLL = _KS["kHubUnroll"]  # entries per thread in flight in a block walk
GROUP = _KS["kGroup"]  # arcs per group, the bits of a table word
ARC_CHUNK = _KS["kChunk"]  # arcs whose groups one block works out (one thread each)
TABLE_WORDS = _KS["kTableWords"]  # mask words per table warp


class ArcAnyLayout(NamedTuple):
    rows: int  # R: target rows per block
    slots: int  # S: nonzero words kept per row (a row with more is read again)
    chunk: int  # C: masks staged per pass over the tile
    smem: int  # dynamic shared memory of a block, bytes


def arc_any_smem(rows: int, slots: int, chunk: int, w: int) -> int:
    """``arc_any::smem_bytes``: (column, word) slots ``[R][S]`` (8 bytes),
    masks ``[C][w | 1]``, counts ``[R]``, pair ids ``[C]``, a 16-word scan
    (4 bytes each), flags ``[C][R]`` (1 byte)."""
    return 8 * rows * slots + 4 * (chunk * (w | 1) + rows + chunk + ARC_ANY_WARPS) + chunk * rows


def arc_any_layout(n_planes: int, n_t: int, w: int, n_pairs: int) -> ArcAnyLayout:
    """The tile of one K4 / K5 launch.  ``R`` spreads the planes' rows over
    about :data:`ROW_BLOCKS` blocks (at most :data:`MAX_ROWS` rows each); ``S``
    shares :data:`ROW_SLOTS` among the ``R`` rows, in multiples of
    :data:`STOP_EVERY` (never more than ``w`` rounds up to); ``C`` fills the
    rest of :data:`SMEM_TARGET` with masks (at least one)."""
    rows = max(1, min(MAX_ROWS, n_t, -(-n_t * n_planes // ROW_BLOCKS)))
    slots = max(STOP_EVERY, min(-(-w // STOP_EVERY), ROW_SLOTS // rows // STOP_EVERY) * STOP_EVERY)
    fixed = arc_any_smem(rows, slots, 0, w)
    per_mask = arc_any_smem(rows, slots, 1, w) - fixed
    chunk = max(1, min(n_pairs, CHUNK_CAP, (SMEM_TARGET - fixed) // per_mask))
    return ArcAnyLayout(rows, slots, chunk, arc_any_smem(rows, slots, chunk, w))


class CsrSweepLayout(NamedTuple):
    slots: int  # group slots: ARC_CHUNK arcs form at most slots_per_chunk groups
    tiles: int  # row tiles of SWEEP_ROWS rows
    table_blocks: int  # slots · word blocks of SWEEP_WARPS · TABLE_WORDS mask words
    sweep_blocks: int  # slots · tiles, one per (group, row tile)
    table_words: int  # the table, slots · GROUP · w int32 words
    smem: int  # static shared memory of a sweep block, bytes (any w)


def slots_per_chunk(n_planes: int, n_arcs: int) -> int:
    """The most groups ``m = min(ARC_CHUNK, n_arcs)`` arcs can form: a key (a
    plane, or "no plane" for arcs outside ``[0, n_planes)``) with ``n`` of
    them forms ``ceil(n / GROUP)``, so at most ``(m + (GROUP - 1) ·
    min(n_planes + 1, m)) // GROUP``."""
    m = min(ARC_CHUNK, n_arcs)
    return (m + (GROUP - 1) * min(n_planes + 1, m)) // GROUP


def csr_sweep_layout(n_planes: int, n_t: int, w: int, n_arcs: int) -> CsrSweepLayout:
    """The grids and table of one K8 call, as the header's ``csr_sweep::launch``
    sizes them from the same constants: every chunk of :data:`ARC_CHUNK` arcs has
    :func:`slots_per_chunk` group slots whatever its arcs' planes, so nothing
    is read back to size the grids."""
    slots = -(-n_arcs // ARC_CHUNK) * slots_per_chunk(n_planes, n_arcs)
    tiles = -(-n_t // SWEEP_ROWS)
    return CsrSweepLayout(
        slots=slots, tiles=tiles, table_blocks=slots * -(-w // (SWEEP_WARPS * TABLE_WORDS)),
        sweep_blocks=slots * tiles, table_words=slots * GROUP * w,
        smem=4 * (4 * SWEEP_ROWS + ARC_CHUNK + GROUP + 7))


def _check_w(w: int) -> None:
    if w > MAX_W:
        raise ValueError(f"w = {w} words exceeds the kernels' shared-memory mask ({MAX_W})")


def _arc_any(name: str, adj: torch.Tensor, plane: Optional[torch.Tensor],
             masks: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` (K5 or K4) on ``adj [n_planes, n_t, w]``,
    ``plane [n_pairs]`` (``None``: every pair on plane 0) and ``masks
    [n_pairs, w]``; returns ``[n_pairs, n_t]`` int32."""
    n_planes, n_t, w = adj.shape
    n_pairs = masks.shape[0]
    _check_w(w)
    if n_planes == 0:  # no plane: nothing is supported
        return torch.zeros((n_pairs, n_t), dtype=torch.int32, device=masks.device)
    out = torch.empty((n_pairs, n_t), dtype=torch.int32, device=masks.device)
    if n_pairs == 0 or n_t == 0:
        return out
    lay = arc_any_layout(n_planes, n_t, w, n_pairs)
    fn = _build.launcher(name, _ARC_ANY_ARGTYPES)
    rc = fn(adj.data_ptr(), None if plane is None else plane.data_ptr(), masks.data_ptr(),
            out.data_ptr(), n_planes, n_t, w, n_pairs, lay.rows, lay.slots, lay.chunk,
            torch.cuda.current_stream(masks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches[name] += 1
    return out


def _sweep(name: str, adj_flat: torch.Tensor, plane: torch.Tensor, masks: torch.Tensor,
           plane_name: str) -> torch.Tensor:
    """Check and launch K5's batched form or K4, which take the same
    arguments."""
    _build.check_cuda_args((adj_flat, plane, masks), ("adj_flat", plane_name, "masks"))
    if adj_flat.dim() != 3 or masks.dim() != 2 or masks.shape[1] != adj_flat.shape[2] \
            or plane.shape != (masks.shape[0],):
        raise ValueError(f"adj_flat {tuple(adj_flat.shape)} / {plane_name} "
                         f"{tuple(plane.shape)} / masks {tuple(masks.shape)} must be "
                         "[n_planes, n_t, w] / [n_pairs] / [n_pairs, w]")
    return _arc_any(name, adj_flat, plane, masks)


def adjacency_any_pairs_cuda(adj_flat: torch.Tensor, plane: torch.Tensor,
                             masks: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream over the pairs of one sweep:
    ``[n_planes, n_t, w] × [n_pairs] × [n_pairs, w] -> [n_pairs, n_t]``
    int32, ``out[i, t] = any(adj_flat[plane[i], t] ∧ masks[i])``; a plane
    outside ``[0, n_planes)`` supports no node."""
    return _sweep("adjacency_any", adj_flat, plane, masks, "plane")


def adjacency_any_cuda(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream for one arc: ``[n_t, w] × [w] ->
    [n_t]`` int32 (a one-pair launch of :func:`adjacency_any_pairs_cuda`'s
    kernel)."""
    _build.check_cuda_args((rows, mask), ("rows", "mask"))
    if rows.dim() != 2 or mask.shape != (rows.shape[1],):
        raise ValueError(f"rows {tuple(rows.shape)} / mask {tuple(mask.shape)} "
                         "must be [n_t, w] / [w]")
    return _arc_any("adjacency_any", rows[None], None, mask[None])[0]


def arc_any_sweep_cuda(adj_flat: torch.Tensor, arc_row: torch.Tensor,
                       masks: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current stream: ``[n_planes, n_t, w] × [n_arcs] ×
    [n_arcs, w] -> [n_arcs, n_t]`` int32; an ``arc_row`` outside ``[0,
    n_planes)`` supports no node."""
    return _sweep("arc_any_sweep", adj_flat, arc_row, masks, "arc_row")


def csr_arc_sweep_cuda(seg_start: torch.Tensor, seg_len: torch.Tensor, indices: torch.Tensor,
                       arc_row: torch.Tensor, masks: torch.Tensor,
                       deg_cap: int) -> torch.Tensor:
    """Launch K8 on the current stream: ``[n_planes, n_t]`` segment bounds,
    ``[n_idx]`` indices, ``[n_arcs]`` planes and ``[n_arcs, w]`` masks ->
    ``[n_arcs, n_t]`` int32.  An ``arc_row`` outside ``[0, n_planes)``
    supports no node.  One call is two kernels on the stream (the mask table,
    then the sweep; :func:`csr_sweep_layout`) and counts one launch."""
    _build.check_cuda_args((seg_start, seg_len, indices, arc_row, masks),
                           ("seg_start", "seg_len", "indices", "arc_row", "masks"))
    if seg_start.dim() != 2 or seg_len.shape != seg_start.shape or indices.dim() != 1 \
            or masks.dim() != 2 or arc_row.shape != (masks.shape[0],):
        raise ValueError(f"seg_start {tuple(seg_start.shape)} / seg_len {tuple(seg_len.shape)} "
                         f"/ indices {tuple(indices.shape)} / arc_row {tuple(arc_row.shape)} "
                         f"/ masks {tuple(masks.shape)} must be [n_planes, n_t] twice / "
                         "[n_idx] / [n_arcs] / [n_arcs, w]")
    n_planes, n_t = seg_start.shape
    n_arcs, w = masks.shape
    lay = csr_sweep_layout(n_planes, n_t, w, n_arcs)
    if max(lay.table_blocks, lay.sweep_blocks) > 2**31 - 1:
        raise ValueError(f"{n_arcs} arcs over n_t = {n_t} at w = {w} exceed one launch's grid "
                         "(2^31 - 1 blocks of (group, mask words) or (group, row tile))")
    out = torch.empty((n_arcs, n_t), dtype=torch.int32, device=masks.device)
    if n_arcs == 0 or n_t == 0:
        return out
    table = torch.empty(lay.table_words, dtype=torch.int32, device=masks.device)
    fn = _build.launcher("csr_arc_sweep", _CSR_SWEEP_ARGTYPES)
    rc = fn(seg_start.data_ptr(), seg_len.data_ptr(), indices.data_ptr(), arc_row.data_ptr(),
            masks.data_ptr(), out.data_ptr(), table.data_ptr(), lay.table_words, n_planes, n_t,
            indices.shape[0], w, n_arcs, int(deg_cap),
            torch.cuda.current_stream(masks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_arc_sweep launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches["csr_arc_sweep"] += 1
    return out
