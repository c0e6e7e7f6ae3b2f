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
CUDA kernel (``csrc/extend_step.cu``) gives one block of 128 threads to
each lane: a block min-reduction finds the first non-zero word, ``__ffs``
the bit, the child is built in registers, and ``__syncthreads_or`` sets
``has_child``.  It is bound by memory: per launch it reads at most
``b · (3 + mp_real) · w · 4`` bytes and writes ``2 · b · w · 4 + 16 · b``.
A plan without parent slots (``mp == 0``) needs no neutral slot here: the
row loop simply runs no trips.

The plain version is `repro_torch.kernels.ref.extend_step_ref`;
`repro_torch.kernels.ops.extend_step` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import META_WIDTH, extend_step_ref  # noqa: F401  (the plain version)

launches = 0  # kernel launches since ops.reset_launch_counts()

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
    launches += 1
    return cand2, child, meta
