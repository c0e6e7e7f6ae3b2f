"""K1, ``extend_step``: the engine's fused expansion step, as a CUDA kernel.

For a batch of ``b`` popped lanes, one launch does all the ``w``-wide work
of a step: extract the lowest set bit ``v`` of the lane's candidates (the
parent keeps ``cand2 = cand ^ bit(v)``), build the child's candidates
``dom[child_pos] ∧ ¬used ∧ ¬bit(v) ∧ ⋀_j rows[row_idx[l, j]]``, zero them
unless a child is wanted, and emit ``meta = (valid, v, is_match,
has_child)`` per lane.

Replaces the Pallas TPU kernel ``repro/kernels/extend_step.py``
(``extend_step``, body ``_kernel``, helper ``_lowest_bit``), whose grid
``(b, mp + 2)`` ran in order and kept each lane's bitmaps in VMEM.  The
source ``csrc/extend_step.cu`` is a thin launcher of ``csrc/dense_step.cuh``,
the device code it shares with K2 (`repro_torch.kernels.candidate_mask`):
one warp per lane, :func:`dense_step_layout` lanes per block, no block
barrier.  A lane issues its index loads and its first pass over ``cand``
together; ``cand`` is read once as 16-byte units, and the pass that writes
``cand2`` finds the first nonzero word by a warp min-reduction.  A lane
that wants no child (``cand`` empty, or ``depth + 1 >= n_p``) writes a zero
child and reads no other row.  For the others a ballot compacts the real
parent slots, and each pass of :data:`WORDS` words per thread loads those
words of ``used``, the dom row and up to :data:`SLOTS` ``- 2`` real rows
before it ANDs any (:data:`FEW_WORDS` words for a lane with at most
:data:`FEW_SLOTS` rows; the rows sit at different word offsets from a
16-byte boundary, so they meet word by word in registers).  Bound by memory: per
launch it reads ``cand`` and the index words of every lane and ``used``,
the dom row and the real rows of the lanes that want a child (each
distinct row once), and writes ``2 · b · w`` words and ``4 · b`` words of
meta.  ``cand`` and ``cand2`` share one 16-byte alignment: a ``cand`` view
off that boundary is copied first.

The plain version is `repro_torch.kernels.ref.extend_step_ref`;
`repro_torch.kernels.ops.extend_step` picks between the two by device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import META_WIDTH, extend_step_ref  # noqa: F401  (the plain version)

launches = 0  # kernel launches since ops.reset_launch_counts()

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

# csrc/dense_step.cuh owns the block and the layout rule of its shared
# memory (for K1 and K2); these are its constants, read from the header
_K = _build.header_constants((_build.CSRC / "dense_step.cuh").read_text())
DENSE_STEP_WARPS = _K["kWarps"]  # lanes per block at most, one warp each
DENSE_STEP_MAX_SMEM = _K["kMaxSmem"]  # 227 KB
UNITS = _K["kUnits"]  # 16-byte units per thread per pass over cand
SLOTS = _K["kSlots"]  # rows loaded together: used, dom and real rows
WORDS = _K["kWords"]  # words per thread per pass of a SLOTS group
FEW_SLOTS = _K["kFewSlots"]  # a lane with at most this many rows takes the wider pass
FEW_WORDS = _K["kFewWords"]  # words per thread per pass of a FEW_SLOTS group
TARGET_BLOCKS = _K["kTargetBlocks"]  # two blocks on each of the H100's 132 SMs


class DenseStepLayout(NamedTuple):
    lanes: int  # L: lanes per block, one warp each
    lane_words: int  # shared memory of one lane, 4-byte words
    smem: int  # dynamic shared memory of a block, bytes


def dense_step_layout(mp: int, b: int) -> DenseStepLayout:
    """The block of one K1 / K2 launch over ``b`` lanes, as the header's
    ``dense_step::lanes_per_block`` picks it from the same constants:
    enough lanes for about :data:`TARGET_BLOCKS` blocks, at most
    :data:`DENSE_STEP_WARPS` and at most what fits
    :data:`DENSE_STEP_MAX_SMEM` (0 when one lane does not fit).  A lane's
    shared memory is its list of real row indices, ``mp`` words rounded up
    to 16 bytes."""
    words = (mp + 3) // 4 * 4
    fit = DENSE_STEP_WARPS if words == 0 else min(DENSE_STEP_WARPS,
                                                  DENSE_STEP_MAX_SMEM // (4 * words))
    lanes = 0 if fit < 1 else max(1, min(fit, -(-b // TARGET_BLOCKS)))
    return DenseStepLayout(lanes, words, 4 * lanes * words)


def extend_step_cuda(rows, dom_bits, child_pos, row_idx, depth, n_p, used, cand):
    """Launch the kernel on the current stream; returns ``(cand2, child,
    meta)`` like the plain version.  ``n_p`` is a Python int."""
    global launches
    _build.check_cuda_args((rows, dom_bits, child_pos, row_idx, depth, used, cand),
                           ("rows", "dom_bits", "child_pos", "row_idx", "depth", "used",
                            "cand"))
    b, w = cand.shape
    if used.shape != (b, w) or rows.dim() != 2 or rows.shape[1] != w \
            or dom_bits.dim() != 2 or dom_bits.shape[1] != w:
        raise ValueError(f"used {tuple(used.shape)}, rows {tuple(rows.shape)} and "
                         f"dom_bits {tuple(dom_bits.shape)} must be [{b}, {w}] / [*, {w}]")
    if child_pos.shape != (b,) or depth.shape != (b,) \
            or row_idx.dim() != 2 or row_idx.shape[0] != b:
        raise ValueError(f"child_pos / depth / row_idx must be [{b}] / [{b}] / [{b}, mp]")
    if dense_step_layout(row_idx.shape[1], b).lanes < 1:
        raise ValueError(f"mp = {row_idx.shape[1]} parent slots exceed the kernel's shared memory")
    if cand.data_ptr() % 16:  # cand2, a fresh tensor, starts on a 16-byte boundary
        cand = cand.clone()
    cand2 = torch.empty_like(cand)
    child = torch.empty_like(cand)
    meta = torch.empty((b, META_WIDTH), dtype=torch.int32, device=cand.device)
    if b == 0:
        return cand2, child, meta
    fn = _build.launcher("extend_step", _ARGTYPES)
    rc = fn(rows.data_ptr(), dom_bits.data_ptr(), child_pos.data_ptr(),
            row_idx.data_ptr(), depth.data_ptr(), int(n_p), used.data_ptr(),
            cand.data_ptr(), cand2.data_ptr(), child.data_ptr(), meta.data_ptr(),
            b, w, row_idx.shape[1], rows.shape[0] - 1,
            torch.cuda.current_stream(cand.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extend_step launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches += 1
    return cand2, child, meta
