// candidate_mask: per lane l, out[l] = dom[pos[l]] & ~used[l] & AND_j rows[row_idx[l, j]].
//
// Replaces the Pallas TPU kernel repro/kernels/candidate_mask.py::candidate_mask.
// There the grid walks (lane, parent slot) in order and a scalar-prefetched
// index map makes the DMA engine chase row_idx; here one thread block owns one
// lane, loads the lane's row indices into shared memory itself, and each
// thread strides over the w words, ANDing the gathered rows in registers.
// No 128-word padding: that was the TPU's lane width.
//
// Bound: memory.  Each lane reads its dom row, its used row and the real
// (non-neutral) adjacency rows, and writes one row; there is one AND per word
// read, far below the card's integer rate.  Slots holding the neutral
// all-ones row (index n_rows) are skipped: ANDing it is the identity.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
candidate_mask_kernel(const uint32_t* __restrict__ rows,
                      const uint32_t* __restrict__ dom,
                      const int32_t* __restrict__ pos,
                      const int32_t* __restrict__ row_idx,
                      const uint32_t* __restrict__ used,
                      uint32_t* __restrict__ out,
                      int w, int mp, int n_rows) {
  extern __shared__ int32_t s_rows[];  // this lane's row indices, [mp]
  const int l = blockIdx.x;
  const size_t lw = static_cast<size_t>(l) * w;
  for (int j = threadIdx.x; j < mp; j += blockDim.x) {
    s_rows[j] = row_idx[static_cast<size_t>(l) * mp + j];
  }
  __syncthreads();
  const uint32_t* d = dom + static_cast<size_t>(pos[l]) * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    uint32_t c = d[i] & ~used[lw + i];
    for (int j = 0; j < mp; ++j) {
      const int r = s_rows[j];
      if (r != n_rows) c &= rows[static_cast<size_t>(r) * w + i];
    }
    out[lw + i] = c;
  }
}

}  // namespace

// All pointers are device pointers of contiguous int32 tensors (the bits of
// uint32 words); returns cudaGetLastError() after the launch.
extern "C" int candidate_mask_launch(const void* rows, const void* dom,
                                     const void* pos, const void* row_idx,
                                     const void* used, void* out, int b, int w,
                                     int mp, int n_rows, void* stream) {
  candidate_mask_kernel<<<b, kThreads, mp * sizeof(int32_t),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(dom),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(row_idx),
      static_cast<const uint32_t*>(used), static_cast<uint32_t*>(out), w, mp,
      n_rows);
  return static_cast<int>(cudaGetLastError());
}
