"""K6 ``csr_extend`` and K7 ``csr_extend_bucketed``: the sparse expansion
step, as CUDA kernels.

For a batch of ``b`` popped lanes, one launch does the whole sparse step:
extract the lowest set bit ``v`` of the lane's candidates (the parent keeps
``cand2 = cand ^ bit(v)``), form ``base = dom[child_pos] ∧ ¬used ∧
¬bit(v)``, walk the **lead** (first real) parent's CSR segment of the
flat ``indices`` array, and keep each entry that differs from the one
before it, is set in ``base`` and is found by a binary search in every
other real parent's sorted segment.  Survivors are ORed into the child
(``base`` for a lane without parents), the child is zeroed unless one is
wanted, and ``meta = (valid, v, is_match, has_child)`` is emitted.
``seg_start`` / ``seg_len`` (``[b, mp]``, length ``-1`` on unused parent
slots) bound each parent's segment; ``indices`` is over-padded by
``deg_cap`` sentinel entries.

* :func:`csr_extend_cuda` (K6, ``csrc/csr_extend.cu``) replaces
  ``repro/kernels/csr_extend.py::csr_extend`` (body ``_kernel``, the flat
  ``deg_cap``-wide walk, ``EngineConfig.csr_walk="flat"``).
* :func:`csr_extend_bucketed_cuda` (K7, ``csrc/csr_extend_bucketed.cu``)
  replaces ``repro/kernels/csr_extend.py::csr_extend_bucketed`` (body
  ``_kernel_bucketed``, the walk up to the row's pow2 degree bucket, the
  default ``csr_walk="bucketed"``).

Both sources are thin launchers of one device implementation,
``csrc/csr_extend.cuh``: ``deg_cap`` bounds every row, so on the card both
walks stop at the row's end and give the same bits.  One warp per lane,
:func:`csr_step_layout` lanes per block; each row word is read once with
16-byte loads (the first-nonzero search rides on the pass that writes
``cand2``); the walk is led by the **shortest** real parent segment (the pivot),
whose survivors are the same intersection as the lead's, and a pivot
longer than :data:`LONG_WALK` entries is walked by every warp of its
block.  ``base`` and the child live in shared memory (``w + 3`` words
each per lane) and survivors are ORed in with ``atomicOr``.  Bound by
memory: a lane reads ``cand``, and for a wanted child ``used``, its dom
row, the pivot segment and the searches' probes, and writes ``2 · w``
words and its meta row.

The plain versions are `repro_torch.kernels.ref.csr_extend_ref` and
`csr_extend_bucketed_ref`; `repro_torch.kernels.ops` picks by device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import header_constants
from repro_torch.kernels.ref import (  # noqa: F401  (the plain versions)
    META_WIDTH,
    csr_extend_bucketed_ref,
    csr_extend_ref,
)

launches = {"csr_extend": 0, "csr_extend_bucketed": 0}  # since ops.reset_launch_counts()

# base and child live in shared memory: 2 · (w + 3) words per lane, and one
# lane's must fit the 227 KB a block can be given
MAX_W = 227 * 1024 // 8 - 64


# csrc/csr_extend.cuh owns the block and the layout rule of its shared
# memory; these are its constants, read from the header itself
_K = header_constants((_build.CSRC / "csr_extend.cuh").read_text())
CSR_STEP_WARPS = _K["kWarps"]  # warps per block, each with at most one lane
CSR_STEP_MAX_SMEM = _K["kMaxSmem"]  # 227 KB
LONG_WALK = _K["kLongWalk"]  # a longer pivot segment is walked by the whole block
UNITS = _K["kUnits"]  # 16-byte units per thread per pass over a row
UNROLL = _K["kUnroll"]  # pivot entries a thread loads before it tests them
HEADER = _K["kHeader"]  # per-lane words after the segment table
TARGET_BLOCKS = _K["kTargetBlocks"]  # two blocks on each of the H100's 132 SMs


class CsrStepLayout(NamedTuple):
    lanes: int  # L: lanes per block, one warp each
    lane_words: int  # shared memory of one lane, 4-byte words
    smem: int  # dynamic shared memory of a block, bytes


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def csr_step_lane_words(w: int, mp: int) -> int:
    """``csr_step::lane_words``: base and child (``w + 3`` words each, so a
    row at any word offset keeps its 16-byte units aligned, rounded to 16
    bytes), segment starts and lengths (``mp`` each) and the header."""
    return 2 * _round4(w + 3) + _round4(2 * mp + HEADER)


def csr_step_layout(w: int, mp: int, b: int) -> CsrStepLayout:
    """The block of one K6 / K7 launch over ``b`` lanes, as the header's
    ``csr_step::lanes_per_block`` picks it from the same constants: enough
    lanes for about :data:`TARGET_BLOCKS` blocks, at most
    :data:`CSR_STEP_WARPS` and at most what fits :data:`CSR_STEP_MAX_SMEM`
    (0 when one lane does not fit)."""
    words = csr_step_lane_words(w, mp)
    fit = min(CSR_STEP_WARPS, CSR_STEP_MAX_SMEM // (4 * words))
    lanes = 0 if fit < 1 else max(1, min(fit, -(-b // TARGET_BLOCKS)))
    return CsrStepLayout(lanes, words, 4 * lanes * words)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(indices, dom_bits, seg_start, seg_len, child_pos, depth, used, cand, deg_cap):
    _build.check_cuda_args(
        (indices, dom_bits, seg_start, seg_len, child_pos, depth, used, cand),
        ("indices", "dom_bits", "seg_start", "seg_len", "child_pos", "depth", "used", "cand"))
    b, w = cand.shape
    if used.shape != (b, w) or dom_bits.dim() != 2 or dom_bits.shape[1] != w:
        raise ValueError(f"used {tuple(used.shape)} / dom_bits {tuple(dom_bits.shape)} "
                         f"must be [{b}, {w}] / [*, {w}]")
    if seg_start.dim() != 2 or seg_start.shape[0] != b or seg_len.shape != seg_start.shape:
        raise ValueError(f"seg_start {tuple(seg_start.shape)} / seg_len "
                         f"{tuple(seg_len.shape)} must both be [{b}, mp]")
    if child_pos.shape != (b,) or depth.shape != (b,) or indices.dim() != 1:
        raise ValueError(f"child_pos / depth / indices must be [{b}] / [{b}] / [n_idx]")
    if w > MAX_W or csr_step_layout(w, seg_len.shape[1], b).lanes < 1:
        raise ValueError(f"w = {w} words / mp = {seg_len.shape[1]} parent slots exceed the "
                         f"kernels' shared memory (MAX_W = {MAX_W})")
    if deg_cap < 1:
        raise ValueError(f"deg_cap must be positive, got {deg_cap}")
    # the kernel reads cand and used and writes cand2 and child in the same
    # 16-byte units: all four start on a 16-byte boundary (a fresh tensor does)
    used, cand = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (used, cand))
    cand2 = torch.empty_like(cand)
    child = torch.empty_like(cand)
    meta = torch.empty((b, META_WIDTH), dtype=torch.int32, device=cand.device)
    return b, w, used, cand, cand2, child, meta


def csr_extend_cuda(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p,
                    used, cand, deg_cap: int):
    """Launch K6 (the flat walk) on the current stream; returns ``(cand2,
    child, meta)`` like the plain version.  ``n_p`` is a Python int."""
    b, w, used, cand, cand2, child, meta = _check(indices, dom_bits, seg_start, seg_len,
                                                  child_pos, depth, used, cand, deg_cap)
    if b == 0:
        return cand2, child, meta
    fn = _build.launcher("csr_extend", _ARGTYPES)
    rc = fn(indices.data_ptr(), dom_bits.data_ptr(), seg_start.data_ptr(),
            seg_len.data_ptr(), child_pos.data_ptr(), depth.data_ptr(), int(n_p),
            used.data_ptr(), cand.data_ptr(), cand2.data_ptr(), child.data_ptr(),
            meta.data_ptr(), b, w, seg_len.shape[1], int(deg_cap),
            torch.cuda.current_stream(cand.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_extend launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches["csr_extend"] += 1
    return cand2, child, meta


def csr_extend_bucketed_cuda(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p,
                             used, cand, deg_cap: int):
    """Launch K7 (the degree-bucketed walk) on the current stream; returns
    ``(cand2, child, meta)`` like the plain version."""
    b, w, used, cand, cand2, child, meta = _check(indices, dom_bits, seg_start, seg_len,
                                                  child_pos, depth, used, cand, deg_cap)
    if b == 0:
        return cand2, child, meta
    fn = _build.launcher("csr_extend_bucketed", _ARGTYPES)
    rc = fn(indices.data_ptr(), dom_bits.data_ptr(), seg_start.data_ptr(),
            seg_len.data_ptr(), child_pos.data_ptr(), depth.data_ptr(), int(n_p),
            used.data_ptr(), cand.data_ptr(), cand2.data_ptr(), child.data_ptr(),
            meta.data_ptr(), b, w, seg_len.shape[1], int(deg_cap),
            torch.cuda.current_stream(cand.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_extend_bucketed launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches["csr_extend_bucketed"] += 1
    return cand2, child, meta
