"""K5 ``adjacency_any``, K4 ``arc_any_sweep`` and K8 ``csr_arc_sweep``: the
support test of RI-DS arc consistency, as CUDA kernels.

One AC test for a constraint arc ``(p, q, dir, label)`` asks, for every
target node ``t``, whether ``adj_rows[t] ∧ D(q)`` has a set bit: an
``[n_t, w]`` bitmap AND against a broadcast ``[w]`` mask, then an any per
row.  Two granularities, as in ``repro``:

* :func:`adjacency_any_cuda` (K5) — one arc: ``rows [n_t, w] × mask [w] ->
  [n_t]``.  The batched (``"per-arc"``) device fixpoint launches it once
  per real (pattern, arc) slot, with ``rows`` a view of one adjacency
  plane.  Replaces ``repro/kernels/domain_ac.py::adjacency_any`` (grid
  over 256-row tiles, mask block pinned in VMEM).
* :func:`arc_any_sweep_cuda` (K4) — every arc of one sweep in one launch:
  ``out[a, t] = any(adj_flat[arc_row[a], t] ∧ masks[a])``.  The
  single-query (``"sweep"``) fixpoint uses it.  Replaces
  ``repro/kernels/domain_ac.py::arc_any_sweep``, whose
  ``(arc, row tile)`` grid chased a scalar-prefetched ``arc_row`` table.

Both CUDA kernels (``csrc/adjacency_any.cu``, ``csrc/arc_any_sweep.cu``)
copy the arc's mask into shared memory once per block and give each row to
one warp, which reads it 32 words at a time and stops at the first chunk
with a surviving bit (``__any_sync``).  They are bound by memory: without
the early stop, ``n_t · w · 4`` bytes per arc.

:func:`csr_arc_sweep_cuda` (K8, ``csrc/csr_arc_sweep.cu``) is the same
sweep over CSR planes: ``out[a, t] = any(u ∈ row(arc_row[a],
t)[:min(len, deg_cap)] : bit u ∈ masks[a])``.  It replaces
``repro/kernels/domain_ac.py::csr_arc_sweep`` (body
``_csr_sweep_kernel``), whose ``(arc, row tile)`` grid chose the plane's
segment bounds through a scalar-prefetched ``arc_row``.  Here the grid is
``(arc, row tile)``, arcs along grid x so one launch takes any number of
them: a block stages its arc's mask in shared memory and each thread walks
one row to its first hit.  The sparse fixpoint launches it once per AC
sweep over the arcs of every live pattern.  Bound by memory: each named
plane's bounds and entries read once (as far as the furthest-reading arc on
it needs), the masks, and the ``[n_arcs, n_t]`` flags.

The plain versions are `repro_torch.kernels.ref.adjacency_any_ref`,
`arc_any_sweep_ref` and `csr_arc_sweep_ref`; `repro_torch.kernels.ops`
picks by device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (the plain versions)
    adjacency_any_ref,
    arc_any_sweep_ref,
    csr_arc_sweep_ref,
)

# since ops.reset_launch_counts()
launches = {"adjacency_any": 0, "arc_any_sweep": 0, "csr_arc_sweep": 0}

# the mask lives in shared memory, which a block gets 48 KB of by default
MAX_W = 48 * 1024 // 4

_ANY_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_SWEEP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_CSR_SWEEP_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_w(w: int) -> None:
    if w > MAX_W:
        raise ValueError(f"w = {w} words exceeds the kernels' shared-memory mask ({MAX_W})")


def adjacency_any_cuda(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream: ``[n_t, w] × [w] -> [n_t]`` int32."""
    _build.check_cuda_args((rows, mask), ("rows", "mask"))
    if rows.dim() != 2 or mask.shape != (rows.shape[1],):
        raise ValueError(f"rows {tuple(rows.shape)} / mask {tuple(mask.shape)} "
                         "must be [n_t, w] / [w]")
    n_t, w = rows.shape
    _check_w(w)
    out = torch.empty((n_t,), dtype=torch.int32, device=rows.device)
    if n_t == 0:
        return out
    fn = _build.launcher("adjacency_any", _ANY_ARGTYPES)
    rc = fn(rows.data_ptr(), mask.data_ptr(), out.data_ptr(), n_t, w,
            torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adjacency_any launch failed with CUDA error {rc}")
    launches["adjacency_any"] += 1
    return out


def arc_any_sweep_cuda(adj_flat: torch.Tensor, arc_row: torch.Tensor,
                       masks: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current stream: ``[n_planes, n_t, w] × [n_arcs] ×
    [n_arcs, w] -> [n_arcs, n_t]`` int32.  ``arc_row`` values must lie in
    ``[0, n_planes)``."""
    _build.check_cuda_args((adj_flat, arc_row, masks), ("adj_flat", "arc_row", "masks"))
    if adj_flat.dim() != 3 or masks.dim() != 2 or masks.shape[1] != adj_flat.shape[2] \
            or arc_row.shape != (masks.shape[0],):
        raise ValueError(f"adj_flat {tuple(adj_flat.shape)} / arc_row {tuple(arc_row.shape)} "
                         f"/ masks {tuple(masks.shape)} must be [n_planes, n_t, w] / "
                         "[n_arcs] / [n_arcs, w]")
    n_planes, n_t, w = adj_flat.shape
    n_arcs = masks.shape[0]
    _check_w(w)
    if n_arcs > 65535:
        raise ValueError(f"{n_arcs} arcs exceed one launch's grid (65,535)")
    out = torch.empty((n_arcs, n_t), dtype=torch.int32, device=masks.device)
    if n_arcs == 0 or n_t == 0:
        return out
    fn = _build.launcher("arc_any_sweep", _SWEEP_ARGTYPES)
    rc = fn(adj_flat.data_ptr(), arc_row.data_ptr(), masks.data_ptr(), out.data_ptr(),
            n_planes, n_t, w, n_arcs, torch.cuda.current_stream(masks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"arc_any_sweep launch failed with CUDA error {rc}")
    launches["arc_any_sweep"] += 1
    return out


def csr_arc_sweep_cuda(seg_start: torch.Tensor, seg_len: torch.Tensor, indices: torch.Tensor,
                       arc_row: torch.Tensor, masks: torch.Tensor,
                       deg_cap: int) -> torch.Tensor:
    """Launch K8 on the current stream: ``[n_planes, n_t]`` segment bounds,
    ``[n_idx]`` indices, ``[n_arcs]`` planes and ``[n_arcs, w]`` masks ->
    ``[n_arcs, n_t]`` int32.  An ``arc_row`` outside ``[0, n_planes)``
    supports no node."""
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
    _check_w(w)
    if n_t > 65535 * 256:
        raise ValueError(f"n_t = {n_t} exceeds one launch's grid (65,535 row tiles of 256)")
    out = torch.empty((n_arcs, n_t), dtype=torch.int32, device=masks.device)
    if n_arcs == 0 or n_t == 0:
        return out
    fn = _build.launcher("csr_arc_sweep", _CSR_SWEEP_ARGTYPES)
    rc = fn(seg_start.data_ptr(), seg_len.data_ptr(), indices.data_ptr(), arc_row.data_ptr(),
            masks.data_ptr(), out.data_ptr(), n_planes, n_t, indices.shape[0], w, n_arcs,
            int(deg_cap), torch.cuda.current_stream(masks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_arc_sweep launch failed with CUDA error {rc}")
    launches["csr_arc_sweep"] += 1
    return out
