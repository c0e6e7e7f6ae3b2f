"""K2, ``candidate_mask``: batched candidate bitmaps, as a CUDA kernel.

For a batch of ``b`` search lanes::

    cand[l] = dom_bits[pos[l]] ∧ ¬used[l] ∧ ⋀_j rows[row_idx[l, j]]

over bitmaps of ``w`` int32 words.  ``rows`` is the flattened
``(edge_label, direction, target node)`` adjacency with a neutral all-ones
row appended at index ``n_rows``, which unused parent slots point at.

Replaces the Pallas TPU kernel ``repro/kernels/candidate_mask.py``
(``candidate_mask``, grid ``(b, mp + 1)`` with a scalar-prefetched row
index map).  The source ``csrc/candidate_mask.cu`` is a thin launcher of
``csrc/dense_step.cuh``, K1's device code without its pass over ``cand``,
its meta row and its early stop (see `repro_torch.kernels.extend_step`):
one warp per lane, ``dense_step_layout`` lanes per block; a ballot compacts
the real parent slots, and each pass loads its words of ``used``, the dom
row and the real rows before it ANDs any.  Bound by memory: per launch it
reads ``used``, the index words, the dom rows and the real adjacency rows
(each distinct row once) and writes ``b · w`` words.

The plain version is `repro_torch.kernels.ref.candidate_mask_ref`;
`repro_torch.kernels.ops.candidate_mask` picks between the two by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.extend_step import dense_step_layout
from repro_torch.kernels.ref import candidate_mask_ref  # noqa: F401  (the plain version)

launches = 0  # kernel launches since ops.reset_launch_counts()

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def candidate_mask_cuda(rows, dom_bits, pos, row_idx, used) -> torch.Tensor:
    """Launch the kernel on the current stream; see the module docstring."""
    global launches
    _build.check_cuda_args((rows, dom_bits, pos, row_idx, used),
                           ("rows", "dom_bits", "pos", "row_idx", "used"))
    b, w = used.shape
    if rows.dim() != 2 or rows.shape[1] != w or dom_bits.dim() != 2 or dom_bits.shape[1] != w:
        raise ValueError(f"rows {tuple(rows.shape)} / dom_bits {tuple(dom_bits.shape)} "
                         f"must be [*, {w}]")
    if pos.shape != (b,) or row_idx.dim() != 2 or row_idx.shape[0] != b:
        raise ValueError(f"pos {tuple(pos.shape)} / row_idx {tuple(row_idx.shape)} "
                         f"must be [{b}] / [{b}, mp]")
    if dense_step_layout(row_idx.shape[1], b).lanes < 1:
        raise ValueError(f"mp = {row_idx.shape[1]} parent slots exceed the kernel's shared memory")
    out = torch.empty_like(used)
    if b == 0:
        return out
    fn = _build.launcher("candidate_mask", _ARGTYPES)
    rc = fn(rows.data_ptr(), dom_bits.data_ptr(), pos.data_ptr(), row_idx.data_ptr(),
            used.data_ptr(), out.data_ptr(), b, w, row_idx.shape[1], rows.shape[0] - 1,
            torch.cuda.current_stream(used.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"candidate_mask launch failed with CUDA error {rc}")
    with _build.LAUNCH_LOCK:
        launches += 1
    return out


def flatten_adj_rows(adj_bits: torch.Tensor) -> torch.Tensor:
    """``[n_elab, 2, n_t, w] -> [n_elab * 2 * n_t + 1, w]`` with a trailing
    all-ones neutral row (AND identity) for padded parent slots."""
    ne, two, n_t, w = adj_bits.shape
    flat = adj_bits.reshape(ne * two * n_t, w)
    ones = torch.full((1, w), -1, dtype=adj_bits.dtype, device=adj_bits.device)
    return torch.cat([flat, ones], dim=0)


def flat_row_index(
    parent_pos: torch.Tensor,  # [b, mp] int32 (-1 padded)
    parent_dir: torch.Tensor,  # [b, mp] int32
    parent_elab: torch.Tensor,  # [b, mp] int32
    mapping: torch.Tensor,  # [b, p_pad] int32
    n_t: int,
    n_rows: int,
) -> torch.Tensor:
    """Per-lane flattened adjacency row indices ``[b, mp]`` (batched form of
    ``repro``'s vmapped ``flat_row_index``): the row of each parent's mapped
    target node, or ``n_rows`` (the neutral row) for unused slots."""
    real = parent_pos >= 0
    t = torch.where(real, mapping.gather(1, parent_pos.clamp_min(0).long()), 0)
    idx = (parent_elab * 2 + parent_dir) * n_t + t.clamp(0, n_t - 1)
    return torch.where(real, idx, n_rows).to(torch.int32)
