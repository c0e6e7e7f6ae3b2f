// csr_extend: the sparse expansion step (flat walk), one thread block per lane.
//
// Replaces the Pallas TPU kernel repro/kernels/csr_extend.py::csr_extend
// (body _kernel).  Per lane l:
//   v        = lowest set bit of cand[l]          (valid iff cand[l] != 0)
//   cand2[l] = cand[l] ^ bit(v)
//   base     = dom[child_pos[l]] & ~used[l] & ~bit(v)
//   lead     = the first parent slot j with seg_len[l, j] >= 0
//   child[l] = OR of bit(u) over the lead segment's entries u that differ
//              from the entry before them, are set in base, and are found by
//              a binary search in every other real parent's sorted segment;
//              child[l] = base when the lane has no real parent.  Zeroed
//              unless a child is wanted (valid and depth + 1 < n_p).
//   meta[l]  = (valid, v or -1, is_match, has_child)
//
// The TPU kernel holds the whole flat indices array in VMEM and does the
// lane's deg_cap-wide vector work in one grid step.  Here the block finds v
// as extend_step does (block min-reduction, __ffs), builds base in shared
// memory, and its threads stride over the lead segment's full deg_cap
// window (slots at seg_len and beyond are masked: this is the flat schedule,
// whose cost is deg_cap per lane whatever the row's length).  Each surviving
// entry is ORed into a shared-memory child with atomicOr; __syncthreads_or
// gives has_child.  A parent segment is searched over its first
// min(seg_len, deg_cap) entries, as the TPU kernel's deg_cap-wide slice is.
//
// Bound: memory.  A lane reads cand, used and its dom row (w words each),
// its lead window and a few log2(deg_cap) searches, and writes cand2 and
// child.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool in_segment(const int32_t* __restrict__ indices,
                                           int lo, int hi, int32_t u) {
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (indices[mid] < u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && indices[lo] == u;
}

__global__ void __launch_bounds__(kThreads)
csr_extend_kernel(const int32_t* __restrict__ indices,
                  const uint32_t* __restrict__ dom,
                  const int32_t* __restrict__ seg_start,
                  const int32_t* __restrict__ seg_len,
                  const int32_t* __restrict__ child_pos,
                  const int32_t* __restrict__ depth, int n_p,
                  const uint32_t* __restrict__ used,
                  const uint32_t* __restrict__ cand,
                  uint32_t* __restrict__ cand2,
                  uint32_t* __restrict__ child,
                  int32_t* __restrict__ meta,
                  int w, int mp, int deg_cap) {
  // [w] base, [w] child, [mp] segment starts, [mp] segment lengths
  extern __shared__ uint32_t smem[];
  uint32_t* s_base = smem;
  uint32_t* s_child = smem + w;
  int32_t* s_start = reinterpret_cast<int32_t*>(smem + 2 * w);
  int32_t* s_len = s_start + mp;
  __shared__ int s_warp_min[kWarps];
  __shared__ int s_first;
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t lw = static_cast<size_t>(l) * w;
  const uint32_t* c = cand + lw;

  for (int j = tid; j < mp; j += blockDim.x) {
    s_start[j] = seg_start[static_cast<size_t>(l) * mp + j];
    s_len[j] = seg_len[static_cast<size_t>(l) * mp + j];
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

  int d = -1;  // the lead: first real parent slot
  for (int j = 0; j < mp; ++j) {
    if (s_len[j] >= 0) {
      d = j;
      break;
    }
  }
  const bool has_parent = d >= 0;

  const uint32_t* dm = dom + static_cast<size_t>(child_pos[l]) * w;
  const uint32_t* us = used + lw;
  for (int i = tid; i < w; i += blockDim.x) {
    const uint32_t vm = (i == first) ? lowbit : 0u;
    cand2[lw + i] = c[i] ^ vm;
    if (want_child) {
      const uint32_t b = dm[i] & ~us[i] & ~vm;
      s_base[i] = b;
      s_child[i] = has_parent ? 0u : b;
    }
  }
  __syncthreads();

  if (want_child && has_parent) {
    const int d_start = s_start[d];
    const int d_len = s_len[d];
    const int n_bits = w * 32;
    for (int k = tid; k < deg_cap; k += blockDim.x) {
      if (k >= d_len) continue;  // the flat window's masked slots
      const int32_t u = indices[d_start + k];
      if (k > 0 && indices[d_start + k - 1] == u) continue;  // dedupe
      const int uc = min(max(u, 0), n_bits - 1);
      const uint32_t bit = 1u << (uc & 31);
      if ((s_base[uc >> 5] & bit) == 0u) continue;
      bool ok = true;
      for (int j = 0; j < mp && ok; ++j) {
        if (j == d || s_len[j] < 0) continue;
        ok = in_segment(indices, s_start[j], s_start[j] + min(s_len[j], deg_cap), u);
      }
      if (ok) atomicOr(&s_child[uc >> 5], bit);
    }
  }
  __syncthreads();

  int any = 0;
  for (int i = tid; i < w; i += blockDim.x) {
    const uint32_t ch = want_child ? s_child[i] : 0u;
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

// All pointers are device pointers of contiguous int32 tensors (dom, used,
// cand, cand2 and child hold the bits of uint32 words); returns
// cudaGetLastError() after the launch.  Shared memory: (2 * w + 2 * mp) * 4
// bytes per block, raised above the 48 KB default when needed.
extern "C" int csr_extend_launch(const void* indices, const void* dom,
                                 const void* seg_start, const void* seg_len,
                                 const void* child_pos, const void* depth,
                                 int n_p, const void* used, const void* cand,
                                 void* cand2, void* child, void* meta, int b,
                                 int w, int mp, int deg_cap, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(w) + 2 * mp) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  csr_extend_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indices), static_cast<const uint32_t*>(dom),
      static_cast<const int32_t*>(seg_start),
      static_cast<const int32_t*>(seg_len),
      static_cast<const int32_t*>(child_pos),
      static_cast<const int32_t*>(depth), n_p,
      static_cast<const uint32_t*>(used), static_cast<const uint32_t*>(cand),
      static_cast<uint32_t*>(cand2), static_cast<uint32_t*>(child),
      static_cast<int32_t*>(meta), w, mp, deg_cap);
  return static_cast<int>(cudaGetLastError());
}
