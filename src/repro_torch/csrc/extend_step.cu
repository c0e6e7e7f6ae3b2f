// extend_step: the engine's fused expansion step, one thread block per lane.
//
// Replaces the Pallas TPU kernel repro/kernels/extend_step.py::extend_step
// (body _kernel, helper _lowest_bit).  Per lane l:
//   v        = lowest set bit of cand[l]          (valid iff cand[l] != 0)
//   cand2[l] = cand[l] ^ bit(v)
//   child[l] = dom[child_pos[l]] & ~used[l] & ~bit(v) & AND_j rows[row_idx[l, j]],
//              zeroed unless a child is wanted (valid and depth + 1 < n_p)
//   meta[l]  = (valid, v or -1, is_match, has_child)
//
// The TPU kernel walks a (lane, mp + 2) grid in order and keeps the lane's
// bitmaps in VMEM across grid steps, with the DMA engine chasing the
// scalar-prefetched row_idx.  Here the block does the whole lane: it loads
// its row indices into shared memory, finds the first non-zero word of cand
// with a block min-reduction and the bit with __ffs, builds the child in
// registers while striding over the w words, and sets has_child with
// __syncthreads_or.  Rows are read only for lanes that want a child, and
// neutral slots (index n_rows, the all-ones row) are skipped; both leave the
// result unchanged.
//
// Bound: memory.  A lane that wants a child reads cand, used, its dom row and
// its real adjacency rows and writes cand2 and child; the arithmetic is one or
// two bit operations per word read.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
extend_step_kernel(const uint32_t* __restrict__ rows,
                   const uint32_t* __restrict__ dom,
                   const int32_t* __restrict__ child_pos,
                   const int32_t* __restrict__ row_idx,
                   const int32_t* __restrict__ depth, int n_p,
                   const uint32_t* __restrict__ used,
                   const uint32_t* __restrict__ cand,
                   uint32_t* __restrict__ cand2,
                   uint32_t* __restrict__ child,
                   int32_t* __restrict__ meta,
                   int w, int mp, int n_rows) {
  extern __shared__ int32_t s_rows[];  // this lane's row indices, [mp]
  __shared__ int s_warp_min[kWarps];
  __shared__ int s_first;
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t lw = static_cast<size_t>(l) * w;
  const uint32_t* c = cand + lw;

  for (int j = tid; j < mp; j += blockDim.x) {
    s_rows[j] = row_idx[static_cast<size_t>(l) * mp + j];
  }

  // First non-zero word: a thread's first hit in its stride is its smallest.
  int first = w;
  for (int i = tid; i < w; i += blockDim.x) {
    if (c[i] != 0u) {
      first = i;
      break;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    first = min(first, __shfl_down_sync(0xffffffffu, first, off));
  }
  if ((tid & 31) == 0) s_warp_min[tid >> 5] = first;
  __syncthreads();
  if (tid == 0) {
    int m = s_warp_min[0];
    for (int k = 1; k < kWarps; ++k) m = min(m, s_warp_min[k]);
    s_first = m;
  }
  __syncthreads();
  first = s_first;

  const bool valid = first < w;
  const uint32_t word = valid ? c[first] : 0u;
  const uint32_t lowbit = word & (0u - word);
  const int v = valid ? first * 32 + (__ffs(static_cast<int>(word)) - 1) : -1;
  const bool is_match = valid && (depth[l] + 1 >= n_p);
  const bool want_child = valid && !is_match;

  const uint32_t* d = dom + static_cast<size_t>(child_pos[l]) * w;
  const uint32_t* u = used + lw;
  int any = 0;
  for (int i = tid; i < w; i += blockDim.x) {
    const uint32_t vm = (i == first) ? lowbit : 0u;
    cand2[lw + i] = c[i] ^ vm;
    uint32_t ch = 0u;
    if (want_child) {
      ch = d[i] & ~u[i] & ~vm;
      for (int j = 0; j < mp; ++j) {
        const int r = s_rows[j];
        if (r != n_rows) ch &= rows[static_cast<size_t>(r) * w + i];
      }
    }
    child[lw + i] = ch;
    any |= (ch != 0u);
  }
  const int has_child = __syncthreads_or(any);
  if (tid == 0) {
    int32_t* m = meta + static_cast<size_t>(l) * 4;
    m[0] = valid ? 1 : 0;
    m[1] = v;
    m[2] = is_match ? 1 : 0;
    m[3] = (want_child && has_child) ? 1 : 0;
  }
}

}  // namespace

// All pointers are device pointers of contiguous int32 tensors (the bits of
// uint32 words); returns cudaGetLastError() after the launch.
extern "C" int extend_step_launch(const void* rows, const void* dom,
                                  const void* child_pos, const void* row_idx,
                                  const void* depth, int n_p, const void* used,
                                  const void* cand, void* cand2, void* child,
                                  void* meta, int b, int w, int mp, int n_rows,
                                  void* stream) {
  extend_step_kernel<<<b, kThreads, mp * sizeof(int32_t),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(dom),
      static_cast<const int32_t*>(child_pos),
      static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(depth), n_p,
      static_cast<const uint32_t*>(used), static_cast<const uint32_t*>(cand),
      static_cast<uint32_t*>(cand2), static_cast<uint32_t*>(child),
      static_cast<int32_t*>(meta), w, mp, n_rows);
  return static_cast<int>(cudaGetLastError());
}
