// popcount_rows: out[r] = number of set bits in row r of an [n, w] bitmap.
//
// Replaces the Pallas TPU kernel repro/kernels/popcount_reduce.py::popcount_rows,
// whose grid walks 256-row tiles padded to 128-word lanes and reduces each
// tile with the VPU popcount.  Here one warp owns one row: each lane sums
// __popc over a stride of the row's words and a shuffle reduction adds the
// 32 partial counts.  No padding: the lanes past the row's end add nothing.
//
// Bound: memory.  The kernel reads n * w words once and writes n counts; one
// popcount and one add per word read is far below the card's integer rate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
popcount_rows_kernel(const uint32_t* __restrict__ bits,
                     int32_t* __restrict__ out, int n, int w) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp shares the row, so it leaves together
  const uint32_t* r = bits + static_cast<size_t>(row) * w;
  int c = 0;
  for (int i = lane; i < w; i += 32) c += __popc(r[i]);
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if (lane == 0) out[row] = c;
}

}  // namespace

// bits and out are device pointers of contiguous int32 tensors (bits holds
// the bits of uint32 words); returns cudaGetLastError() after the launch.
extern "C" int popcount_rows_launch(const void* bits, void* out, int n, int w,
                                    void* stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  popcount_rows_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<int32_t*>(out), n, w);
  return static_cast<int>(cudaGetLastError());
}
