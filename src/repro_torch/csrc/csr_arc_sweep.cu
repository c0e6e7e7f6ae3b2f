// csr_arc_sweep: out[a, t] = 1 iff some entry u among the first
// min(seg_len[p, t], deg_cap) entries of row t of plane p = arc_row[a]
// (indices[seg_start[p, t] + k]) has bit u set in masks[a], for every arc a
// of one RI-DS arc-consistency sweep over CSR planes and every target node t.
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::csr_arc_sweep
// (body _csr_sweep_kernel), whose (arc, row tile) grid ran in order, chose
// the plane's seg_start / seg_len blocks through the scalar-prefetched
// arc_row table and sliced each row out of the VMEM-resident indices.  Here
// the grid is (arc, row tile) in any order: a block reads its arc's plane
// itself, stages the arc's mask in shared memory, and each thread walks one
// row and stops at its first hit.  Entries outside [0, w * 32) (the sentinel
// tail) support nothing, and no read goes past n_idx.
//
// Bound: memory.  Read once, each named plane's bounds (2 * n_t words) and
// each row's entries as far as the furthest-reading arc on that plane needs
// (to its first hit); every arc's mask (w words); n_t flags per arc written.
// Arcs that share a plane re-read its rows, mostly from L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one row per thread

__global__ void __launch_bounds__(kThreads)
csr_arc_sweep_kernel(const int32_t* __restrict__ seg_start,
                     const int32_t* __restrict__ seg_len,
                     const int32_t* __restrict__ indices,
                     const int32_t* __restrict__ arc_row,
                     const uint32_t* __restrict__ masks,
                     int32_t* __restrict__ out, int n_planes, int n_t,
                     int n_idx, int w, int deg_cap) {
  extern __shared__ uint32_t s_mask[];  // [w], this block's arc
  const int a = blockIdx.x;
  const uint32_t* m = masks + static_cast<size_t>(a) * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) s_mask[i] = m[i];
  __syncthreads();
  const int t = blockIdx.y * kThreads + threadIdx.x;
  if (t >= n_t) return;
  // an out-of-range plane index supports no node
  const int plane = arc_row[a];
  int found = 0;
  if (plane >= 0 && plane < n_planes) {
    const size_t pt = static_cast<size_t>(plane) * n_t + t;
    const int s = seg_start[pt];
    const int e = min(s + min(seg_len[pt], deg_cap), n_idx);
    const int n_bits = w * 32;
    for (int k = max(s, 0); k < e; ++k) {
      const int32_t u = indices[k];
      if (u >= 0 && u < n_bits && (s_mask[u >> 5] >> (u & 31)) & 1u) {
        found = 1;
        break;
      }
    }
  }
  out[static_cast<size_t>(a) * n_t + t] = found;
}

}  // namespace

// seg_start / seg_len [n_planes, n_t], indices [n_idx], arc_row [n_arcs],
// masks [n_arcs, w] and out [n_arcs, n_t] are device pointers of contiguous
// int32 tensors (masks holds the bits of uint32 words); returns
// cudaGetLastError() after the launch.  Arcs run along grid x (up to
// 2^31 - 1 of them), row tiles along grid y, so n_t is at most
// 65,535 * 256; the mask takes w * 4 bytes of shared memory.
extern "C" int csr_arc_sweep_launch(const void* seg_start, const void* seg_len,
                                    const void* indices, const void* arc_row,
                                    const void* masks, void* out, int n_planes,
                                    int n_t, int n_idx, int w, int n_arcs,
                                    int deg_cap, void* stream) {
  const dim3 grid(n_arcs, (n_t + kThreads - 1) / kThreads);
  csr_arc_sweep_kernel<<<grid, kThreads, w * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg_start),
      static_cast<const int32_t*>(seg_len),
      static_cast<const int32_t*>(indices),
      static_cast<const int32_t*>(arc_row), static_cast<const uint32_t*>(masks),
      static_cast<int32_t*>(out), n_planes, n_t, n_idx, w, deg_cap);
  return static_cast<int>(cudaGetLastError());
}
