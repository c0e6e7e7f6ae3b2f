// candidate_mask: K2, out[l] = dom[pos[l]] & ~used[l] & AND_j rows[row_idx[l, j]].
//
// Replaces the Pallas TPU kernel repro/kernels/candidate_mask.py::candidate_mask.
// The device code is dense_step.cuh, shared with K1 (extend_step.cu): this is
// its child half without the cand pass, the meta row or the early stop (every
// lane's row is built, as the plain version does); this file is K2's library
// and C entry.
#include "dense_step.cuh"

// All pointers are device pointers of contiguous int32 tensors (the bits of
// uint32 words).  Returns cudaGetLastError() after the launch.  See
// dense_step::launch for the layout.
extern "C" int candidate_mask_launch(const void* rows, const void* dom,
                                     const void* pos, const void* row_idx,
                                     const void* used, void* out, int b, int w,
                                     int mp, int n_rows, void* stream) {
  return dense_step::launch<false>(rows, dom, pos, row_idx, nullptr, 0, used, nullptr, nullptr,
                                   out, nullptr, b, w, mp, n_rows, stream);
}
