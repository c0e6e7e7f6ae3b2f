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
  ``repro/kernels/csr_extend.py::csr_extend`` (body ``_kernel``): one
  128-thread block per lane strides over the lead's full ``deg_cap``
  window (the flat schedule, ``EngineConfig.csr_walk="flat"``).
* :func:`csr_extend_bucketed_cuda` (K7, ``csrc/csr_extend_bucketed.cu``)
  replaces ``repro/kernels/csr_extend.py::csr_extend_bucketed`` (body
  ``_kernel_bucketed``): one warp per lane walks 32 slots at a time up to
  the row's end (the default ``csr_walk="bucketed"``; ``deg_cap`` bounds
  every row, so the end lies inside the row's pow2 degree bucket), so short
  rows cost one trip and only hub lanes run long.

Both keep ``base`` and the child in shared memory (``2 · w`` words per
lane) and OR survivors in with ``atomicOr``.  They are bound by memory: a
lane reads ``cand``, ``used`` and its dom row (``3 · w`` words) and a few
segment words, and writes ``2 · w`` words and its meta row.

The plain versions are `repro_torch.kernels.ref.csr_extend_ref` and
`csr_extend_bucketed_ref`; `repro_torch.kernels.ops` picks by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (the plain versions)
    META_WIDTH,
    csr_extend_bucketed_ref,
    csr_extend_ref,
)

launches = {"csr_extend": 0, "csr_extend_bucketed": 0}  # since ops.reset_launch_counts()

# base and child live in shared memory: 2 · w words per block, within the
# 227 KB a block can be given
MAX_W = 227 * 1024 // 8 - 64

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
    if w > MAX_W:
        raise ValueError(f"w = {w} words exceeds the kernels' shared memory ({MAX_W})")
    if deg_cap < 1:
        raise ValueError(f"deg_cap must be positive, got {deg_cap}")
    cand2 = torch.empty_like(cand)
    child = torch.empty_like(cand)
    meta = torch.empty((b, META_WIDTH), dtype=torch.int32, device=cand.device)
    return b, w, cand2, child, meta


def csr_extend_cuda(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p,
                    used, cand, deg_cap: int):
    """Launch K6 (the flat walk) on the current stream; returns ``(cand2,
    child, meta)`` like the plain version.  ``n_p`` is a Python int."""
    b, w, cand2, child, meta = _check(indices, dom_bits, seg_start, seg_len, child_pos,
                                      depth, used, cand, deg_cap)
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
    launches["csr_extend"] += 1
    return cand2, child, meta


def csr_extend_bucketed_cuda(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p,
                             used, cand, deg_cap: int):
    """Launch K7 (the degree-bucketed walk) on the current stream; returns
    ``(cand2, child, meta)`` like the plain version."""
    b, w, cand2, child, meta = _check(indices, dom_bits, seg_start, seg_len, child_pos,
                                      depth, used, cand, deg_cap)
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
    launches["csr_extend_bucketed"] += 1
    return cand2, child, meta
