"""Public kernel entry points: one decision per call, by the device of the
tensors.

A CUDA tensor gets the hand-written CUDA kernel, or an exception; a CPU
tensor gets the kernel's plain PyTorch version (`repro_torch.kernels.ref`).
There is no fallback from one to the other.  Each kernel counts its
launches (:func:`launch_counts`), so a run can show that it went through
the kernels.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import candidate_mask as _cm
from repro_torch.kernels import csr_extend as _ce
from repro_torch.kernels import domain_ac as _ac
from repro_torch.kernels import extend_step as _es
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import popcount_reduce as _pc
from repro_torch.kernels import ref as kref

flatten_adj_rows = _cm.flatten_adj_rows
flat_row_index = _cm.flat_row_index
pack_bits = kref.pack_bits_ref


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def _launch(t: torch.Tensor, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``t``'s card as the current device: a
    kernel launches on the current device, so tensors on another card (a
    shard of a multi-card mesh) need it switched.  On the current card, the
    single-card path, nothing is switched."""
    if t.device.index == torch.cuda.current_device():
        return fn(*args, **kwargs)
    with torch.cuda.device(t.device):
        return fn(*args, **kwargs)


def candidate_mask(rows, dom_bits, pos, row_idx, used) -> torch.Tensor:
    """K2: ``dom[pos] ∧ ¬used ∧ ⋀_j rows[row_idx[:, j]]`` per lane
    (see `repro_torch.kernels.candidate_mask`)."""
    if _on_card(used):
        return _launch(used, _cm.candidate_mask_cuda, rows, dom_bits, pos, row_idx, used)
    return kref.candidate_mask_ref(rows, dom_bits, pos, row_idx, used)


def extend_step(rows, dom_bits, child_pos, row_idx, depth, n_p, used, cand):
    """K1: the fused expansion step; returns ``(cand2, child, meta)``
    (see `repro_torch.kernels.extend_step`)."""
    if _on_card(cand):
        return _launch(cand, _es.extend_step_cuda, rows, dom_bits, child_pos, row_idx, depth,
                       n_p, used, cand)
    return kref.extend_step_ref(rows, dom_bits, child_pos, row_idx, depth, n_p, used, cand)


def popcount_rows(bits) -> torch.Tensor:
    """K3: per-row popcount ``[n, w] -> [n]`` int32
    (see `repro_torch.kernels.popcount_reduce`)."""
    if _on_card(bits):
        return _launch(bits, _pc.popcount_rows_cuda, bits)
    return kref.popcount_rows_ref(bits)


def adjacency_any(rows, mask) -> torch.Tensor:
    """K5 for one arc: ``any(rows[t] ∧ mask)`` per row, ``[n_t]`` int32
    (see `repro_torch.kernels.domain_ac`)."""
    if _on_card(rows):
        return _launch(rows, _ac.adjacency_any_cuda, rows, mask)
    return kref.adjacency_any_ref(rows, mask)


def adjacency_any_pairs(adj_flat, plane, masks) -> torch.Tensor:
    """K5 over the pairs of one sweep: ``any(adj_flat[plane[i], t] ∧
    masks[i])``, ``[n_pairs, n_t]`` int32 (see `repro_torch.kernels.domain_ac`)."""
    if _on_card(masks):
        return _launch(masks, _ac.adjacency_any_pairs_cuda, adj_flat, plane, masks)
    return kref.adjacency_any_pairs_ref(adj_flat, plane, masks)


def arc_any_sweep(adj_flat, arc_row, masks) -> torch.Tensor:
    """K4: ``any(adj_flat[arc_row[a], t] ∧ masks[a])``, ``[n_arcs, n_t]``
    int32 (see `repro_torch.kernels.domain_ac`)."""
    if _on_card(masks):
        return _launch(masks, _ac.arc_any_sweep_cuda, adj_flat, arc_row, masks)
    return kref.arc_any_sweep_ref(adj_flat, arc_row, masks)


def csr_extend(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p, used, cand,
               deg_cap: int):
    """K6: the sparse step with the flat ``deg_cap``-wide lead-segment walk;
    returns ``(cand2, child, meta)`` (see `repro_torch.kernels.csr_extend`)."""
    if _on_card(cand):
        return _launch(cand, _ce.csr_extend_cuda, indices, dom_bits, seg_start, seg_len,
                       child_pos, depth, n_p, used, cand, deg_cap)
    return kref.csr_extend_ref(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p,
                               used, cand, deg_cap=deg_cap)


def csr_extend_bucketed(indices, dom_bits, seg_start, seg_len, child_pos, depth, n_p, used,
                        cand, deg_cap: int):
    """K7: the sparse step with the degree-bucketed lead-segment walk; the same
    bits as K6 (see `repro_torch.kernels.csr_extend`)."""
    if _on_card(cand):
        return _launch(cand, _ce.csr_extend_bucketed_cuda, indices, dom_bits, seg_start,
                       seg_len, child_pos, depth, n_p, used, cand, deg_cap)
    return kref.csr_extend_bucketed_ref(indices, dom_bits, seg_start, seg_len, child_pos,
                                        depth, n_p, used, cand, deg_cap=deg_cap)


def csr_arc_sweep(seg_start, seg_len, indices, arc_row, masks, deg_cap: int) -> torch.Tensor:
    """K8: the CSR AC sweep, ``[n_arcs, n_t]`` int32
    (see `repro_torch.kernels.domain_ac`)."""
    if _on_card(masks):
        return _launch(masks, _ac.csr_arc_sweep_cuda, seg_start, seg_len, indices, arc_row,
                       masks, deg_cap)
    return kref.csr_arc_sweep_ref(seg_start, seg_len, indices, arc_row, masks, deg_cap=deg_cap)


def flash_attention(q, k, v, block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """K9: causal attention over ``[BH, S, d]`` q and ``[BH, S_kv, d]`` k / v,
    in q's dtype (see `repro_torch.kernels.flash_attention`)."""
    if _on_card(q):
        return _launch(q, _fa.flash_attention_cuda, q, k, v, block_q=block_q, block_k=block_k)
    return kref.flash_attention_ref(q, k, v)


# each kernel's C signature, for loading its library ahead of a launch
_ARGTYPES = {
    "candidate_mask": _cm._ARGTYPES, "extend_step": _es._ARGTYPES,
    "popcount_rows": _pc._ARGTYPES, "adjacency_any": _ac._ARC_ANY_ARGTYPES,
    "arc_any_sweep": _ac._ARC_ANY_ARGTYPES, "csr_extend": _ce._ARGTYPES,
    "csr_extend_bucketed": _ce._ARGTYPES, "csr_arc_sweep": _ac._CSR_SWEEP_ARGTYPES,
    "flash_attention": _fa._ARGTYPES,
}


def load_kernels(names: Iterable[str]) -> None:
    """Build (where the build directory lacks them) and load the libraries
    of the named kernels, so that their first launch pays for neither."""
    names = list(names)
    if names:
        _build.build(names)
    for name in names:
        _build.launcher(name, _ARGTYPES[name])


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"extend_step": _es.launches, "candidate_mask": _cm.launches,
            "popcount_rows": _pc.launches, **_ac.launches, **_ce.launches,
            "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _es.launches = 0
    _cm.launches = 0
    _pc.launches = 0
    _fa.launches = 0
    for counts in (_ac.launches, _ce.launches):
        for name in counts:
            counts[name] = 0
