// arc_any_sweep: out[a, t] = (adj_flat[arc_row[a], t] & masks[a]) != 0 for
// every arc a of one RI-DS arc-consistency sweep and every target node t,
// as int32 {0, 1}.
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::arc_any_sweep,
// whose grid (arc, 256-row tile) ran in order with the DMA engine choosing
// the adjacency plane through the scalar-prefetched arc_row table.  Here the
// grid is (row tile, arc) and the blocks run in any order: a block reads its
// arc's plane index itself, copies the arc's mask into shared memory, and
// runs adjacency_any's test on its rows (one warp per row, 32 words per
// step, __any_sync, stopping at the first chunk with a surviving bit).
//
// Bound: memory.  Without the early stop the sweep reads every plane that
// some arc names once (arcs on the same plane share it through L2 at best;
// streaming one plane per arc reads n_arcs * n_t * w words) plus the masks,
// and writes n_arcs * n_t flags.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 64;

__global__ void __launch_bounds__(kThreads)
arc_any_sweep_kernel(const uint32_t* __restrict__ adj_flat,
                     const int32_t* __restrict__ arc_row,
                     const uint32_t* __restrict__ masks,
                     int32_t* __restrict__ out, int n_planes, int n_t,
                     int w) {
  extern __shared__ uint32_t s_mask[];  // [w], this block's arc
  const int a = blockIdx.y;
  const uint32_t* m = masks + static_cast<size_t>(a) * w;
  for (int i = threadIdx.x; i < w; i += blockDim.x) s_mask[i] = m[i];
  __syncthreads();
  // an out-of-range plane index reads nothing and supports no node
  const int plane = arc_row[a];
  const bool on_plane = plane >= 0 && plane < n_planes;
  const uint32_t* rows =
      adj_flat + static_cast<size_t>(on_plane ? plane : 0) * n_t * w;
  int32_t* o = out + static_cast<size_t>(a) * n_t;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_end = min(n_t, (blockIdx.x + 1) * kRowsPerBlock);
  for (int t = blockIdx.x * kRowsPerBlock + warp; t < row_end; t += kWarps) {
    const uint32_t* r = rows + static_cast<size_t>(t) * w;
    int found = 0;
    for (int base = 0; on_plane && base < w; base += 32) {
      const int i = base + lane;
      const uint32_t hit = (i < w) ? (r[i] & s_mask[i]) : 0u;
      if (__any_sync(0xffffffffu, hit != 0u)) {
        found = 1;
        break;
      }
    }
    if (lane == 0) o[t] = found;
  }
}

}  // namespace

// adj_flat, arc_row, masks and out are device pointers of contiguous int32
// tensors (adj_flat and masks hold the bits of uint32 words); returns
// cudaGetLastError() after the launch.  One block column per arc, so
// n_arcs is at most 65,535; the mask takes w * 4 bytes of shared memory.
extern "C" int arc_any_sweep_launch(const void* adj_flat, const void* arc_row,
                                    const void* masks, void* out, int n_planes,
                                    int n_t, int w, int n_arcs, void* stream) {
  const dim3 grid((n_t + kRowsPerBlock - 1) / kRowsPerBlock, n_arcs);
  arc_any_sweep_kernel<<<grid, kThreads, w * sizeof(uint32_t),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(adj_flat),
      static_cast<const int32_t*>(arc_row), static_cast<const uint32_t*>(masks),
      static_cast<int32_t*>(out), n_planes, n_t, w);
  return static_cast<int>(cudaGetLastError());
}
