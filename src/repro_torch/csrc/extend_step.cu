// extend_step: K1, the engine's fused expansion step.
//
// Replaces the Pallas TPU kernel repro/kernels/extend_step.py::extend_step
// (body _kernel, helper _lowest_bit).  The device code is dense_step.cuh,
// shared with K2 (candidate_mask.cu), which computes the child half of this
// step from the same rows; this file is K1's library and C entry.
#include "dense_step.cuh"

// All pointers are device pointers of contiguous int32 tensors (the bits of
// uint32 words); cand and cand2 start on a common 16-byte boundary.  Returns
// cudaGetLastError() after the launch.  See dense_step::launch for the
// layout.
extern "C" int extend_step_launch(const void* rows, const void* dom,
                                  const void* child_pos, const void* row_idx,
                                  const void* depth, int n_p, const void* used,
                                  const void* cand, void* cand2, void* child,
                                  void* meta, int b, int w, int mp, int n_rows,
                                  void* stream) {
  return dense_step::launch<true>(rows, dom, child_pos, row_idx, depth, n_p, used, cand, cand2,
                                  child, meta, b, w, mp, n_rows, stream);
}
