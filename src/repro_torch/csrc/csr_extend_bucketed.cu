// csr_extend_bucketed: K7, the sparse expansion step with the
// degree-bucketed walk.
//
// Replaces the Pallas TPU kernel
// repro/kernels/csr_extend.py::csr_extend_bucketed (body _kernel_bucketed).
// The device code is csr_extend.cuh, shared with K6 (csr_extend.cu): a row's
// pow2 bucket on the TPU bounds a walk that on the card stops at the row's
// end, so this file is only K7's library and C entry.
#include "csr_extend.cuh"

// The contract of csr_extend_launch (csr_extend.cu).
extern "C" int csr_extend_bucketed_launch(
    const void* indices, const void* dom, const void* seg_start,
    const void* seg_len, const void* child_pos, const void* depth, int n_p,
    const void* used, const void* cand, void* cand2, void* child, void* meta,
    int b, int w, int mp, int deg_cap, void* stream) {
  return csr_step::launch(indices, dom, seg_start, seg_len, child_pos, depth, n_p, used, cand,
                          cand2, child, meta, b, w, mp, deg_cap, stream);
}
