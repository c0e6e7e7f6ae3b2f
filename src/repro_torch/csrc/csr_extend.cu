// csr_extend: K6, the sparse expansion step with the flat walk.
//
// Replaces the Pallas TPU kernel repro/kernels/csr_extend.py::csr_extend
// (body _kernel).  The device code is csr_extend.cuh, shared with K7
// (csr_extend_bucketed.cu): the flat deg_cap-wide window was a static shape
// of the TPU, and on the card every walk stops at its row's end, so this
// file is only K6's library and C entry.
#include "csr_extend.cuh"

// All pointers are device pointers of contiguous int32 tensors (dom, used,
// cand, cand2 and child hold the bits of uint32 words; cand, used, cand2
// and child start on a common 16-byte boundary); returns cudaGetLastError()
// after the launch.  See csr_step::launch for the layout.
extern "C" int csr_extend_launch(const void* indices, const void* dom,
                                 const void* seg_start, const void* seg_len,
                                 const void* child_pos, const void* depth,
                                 int n_p, const void* used, const void* cand,
                                 void* cand2, void* child, void* meta, int b,
                                 int w, int mp, int deg_cap, void* stream) {
  return csr_step::launch(indices, dom, seg_start, seg_len, child_pos, depth, n_p, used, cand,
                          cand2, child, meta, b, w, mp, deg_cap, stream);
}
