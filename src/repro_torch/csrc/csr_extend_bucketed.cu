// csr_extend_bucketed: the sparse expansion step with the degree-bucketed
// walk, one warp per lane.
//
// Replaces the Pallas TPU kernel
// repro/kernels/csr_extend.py::csr_extend_bucketed (body _kernel_bucketed).
// Same contract and the same bits as csr_extend (see csr_extend.cu): lowest
// bit v, cand2 = cand ^ bit(v), base = dom[child_pos] & ~used & ~bit(v), the
// lead (first real parent) segment's deduped entries that are set in base
// and found in every other real parent's sorted segment ORed into the child,
// base for a parentless lane, meta = (valid, v or -1, is_match, has_child).
// Only the walk differs: the lane's trips stop at its row's pow2 degree
// bucket instead of the global deg_cap.  On a hub-heavy target almost every
// row is short, so a lane costs one trip while a hub lane runs long, alone.
//
// The TPU kernel walks chunk = 8 slots per fori_loop trip, up to
// min(max(nextpow2(seg_len), 8), deg_cap) rounded to whole trips, with a
// branchless binary search on the VMEM-resident indices.  Here a block is one
// warp: the warp builds base in shared memory (32 words per step), walks the
// lead segment 32 slots at a time up to min(seg_len, deg_cap), searches each
// surviving entry in the other parents' segments [start, start + len) to
// convergence, and ORs survivors into a shared-memory child with atomicOr;
// __any_sync gives has_child.
//
// Bound: memory.  A lane reads cand, used and its dom row (w words each) and
// its lead row, plus log2(len) reads per search, and writes cand2 and child.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;  // one warp per lane

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
csr_extend_bucketed_kernel(const int32_t* __restrict__ indices,
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
  const int l = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t lw = static_cast<size_t>(l) * w;
  const uint32_t* c = cand + lw;

  for (int j = lane; j < mp; j += kThreads) {
    s_start[j] = seg_start[static_cast<size_t>(l) * mp + j];
    s_len[j] = seg_len[static_cast<size_t>(l) * mp + j];
  }

  // First non-zero word, 32 words per step.
  int first = w;
  for (int base = 0; base < w; base += kThreads) {
    const int i = base + lane;
    const unsigned nz = __ballot_sync(0xffffffffu, i < w && c[i] != 0u);
    if (nz != 0u) {
      first = base + __ffs(static_cast<int>(nz)) - 1;
      break;
    }
  }
  __syncwarp();

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
  for (int i = lane; i < w; i += kThreads) {
    const uint32_t vm = (i == first) ? lowbit : 0u;
    cand2[lw + i] = c[i] ^ vm;
    if (want_child) {
      const uint32_t b = dm[i] & ~us[i] & ~vm;
      s_base[i] = b;
      s_child[i] = has_parent ? 0u : b;
    }
  }
  __syncwarp();

  if (want_child && has_parent) {
    const int d_start = s_start[d];
    const int d_len = s_len[d];
    // deg_cap is padded to a multiple of 8 at least the longest row, so a
    // well-formed row ends inside its pow2 bucket and the TPU kernel's bucket
    // cap never stops the walk before d_len
    const int walk = min(d_len, deg_cap);
    const int n_bits = w * 32;
    for (int k = lane; k < walk; k += kThreads) {
      const int32_t u = indices[d_start + k];
      if (k > 0 && indices[d_start + k - 1] == u) continue;  // dedupe
      const int uc = min(max(u, 0), n_bits - 1);
      const uint32_t bit = 1u << (uc & 31);
      if ((s_base[uc >> 5] & bit) == 0u) continue;
      bool ok = true;
      for (int j = 0; j < mp && ok; ++j) {
        if (j == d || s_len[j] < 0) continue;
        ok = in_segment(indices, s_start[j], s_start[j] + s_len[j], u);
      }
      if (ok) atomicOr(&s_child[uc >> 5], bit);
    }
  }
  __syncwarp();

  int any = 0;
  for (int i = lane; i < w; i += kThreads) {
    const uint32_t ch = want_child ? s_child[i] : 0u;
    child[lw + i] = ch;
    any |= (ch != 0u);
  }
  const int has_child = __any_sync(0xffffffffu, any);
  if (lane == 0) {
    int32_t* mt = meta + static_cast<size_t>(l) * 4;
    mt[0] = valid ? 1 : 0;
    mt[1] = v;
    mt[2] = is_match ? 1 : 0;
    mt[3] = (want_child && has_child) ? 1 : 0;
  }
}

}  // namespace

// All pointers are device pointers of contiguous int32 tensors (dom, used,
// cand, cand2 and child hold the bits of uint32 words); returns
// cudaGetLastError() after the launch.  Shared memory: (2 * w + 2 * mp) * 4
// bytes per block, raised above the 48 KB default when needed.
extern "C" int csr_extend_bucketed_launch(
    const void* indices, const void* dom, const void* seg_start,
    const void* seg_len, const void* child_pos, const void* depth, int n_p,
    const void* used, const void* cand, void* cand2, void* child, void* meta,
    int b, int w, int mp, int deg_cap, void* stream) {
  const size_t smem = (2 * static_cast<size_t>(w) + 2 * mp) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_extend_bucketed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  csr_extend_bucketed_kernel<<<b, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
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
