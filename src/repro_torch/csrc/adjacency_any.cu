// adjacency_any: out[t] = (rows[t] & mask) != 0 for every row t of an
// [n_t, w] bitmap, as int32 {0, 1}: the support test of one RI-DS arc.
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::adjacency_any,
// whose grid walks 256-row tiles padded to 128-word lanes with the mask
// block pinned in VMEM.  Here each block copies the mask into shared memory
// once and its eight warps take kRowsPerBlock rows in turn: a warp reads a
// row 32 words at a time, ANDs them with the mask and asks __any_sync
// whether a bit survived, stopping at the first chunk that has one.
//
// Bound: memory.  Without the early stop the kernel reads n_t * w words of
// rows plus the mask and writes n_t flags; the early stop only reads less.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;

__global__ void __launch_bounds__(kThreads)
adjacency_any_kernel(const uint32_t* __restrict__ rows,
                     const uint32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int n_t, int w) {
  extern __shared__ uint32_t s_mask[];  // [w]
  for (int i = threadIdx.x; i < w; i += blockDim.x) s_mask[i] = mask[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_end = min(n_t, (blockIdx.x + 1) * kRowsPerBlock);
  for (int t = blockIdx.x * kRowsPerBlock + warp; t < row_end; t += kWarps) {
    const uint32_t* r = rows + static_cast<size_t>(t) * w;
    int found = 0;
    for (int base = 0; base < w; base += 32) {
      const int i = base + lane;
      const uint32_t hit = (i < w) ? (r[i] & s_mask[i]) : 0u;
      if (__any_sync(0xffffffffu, hit != 0u)) {
        found = 1;
        break;
      }
    }
    if (lane == 0) out[t] = found;
  }
}

}  // namespace

// rows, mask and out are device pointers of contiguous int32 tensors (rows
// and mask hold the bits of uint32 words); returns cudaGetLastError() after
// the launch.  The mask takes w * 4 bytes of shared memory (at most 48 KB).
extern "C" int adjacency_any_launch(const void* rows, const void* mask,
                                    void* out, int n_t, int w, void* stream) {
  const int blocks = (n_t + kRowsPerBlock - 1) / kRowsPerBlock;
  adjacency_any_kernel<<<blocks, kThreads, w * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(mask),
      static_cast<int32_t*>(out), n_t, w);
  return static_cast<int>(cudaGetLastError());
}
