// arc_any.cuh: the support test of RI-DS arc consistency over dense
// adjacency planes, one device implementation for K5 (adjacency_any.cu) and
// K4 (arc_any_sweep.cu):
//
//   out[i, t] = (adj[plane[i], t] & masks[i]) != 0   for every pair i, row t
//
// as int32 {0, 1}, with adj an [n_planes, n_t, w] bitmap of uint32 words and
// a plane index outside [0, n_planes) supporting no node.  K4 passes one
// pair per arc of a sweep, K5 one pair per live (pattern, arc) slot of a
// batched sweep, or, in its one-arc form, plane == nullptr (every pair on
// plane 0).
//
// Replaces the Pallas TPU kernels repro/kernels/domain_ac.py::adjacency_any
// (256-row tiles against one mask pinned in VMEM) and ::arc_any_sweep (an
// (arc, row tile) grid that fetched the arc's plane tile per step through
// the scalar-prefetched arc_row table), where every arc streams its plane.
//
// Bound: memory.  A launch must read each named plane once (n_t * w words),
// the masks and the pair table, and write n_pairs * n_t flags.  The served
// planes are sparse (about 25 set bits of 12,575 per row, >= 94 % zero
// words), so the design streams each plane once and spends the per-pair
// work on the few nonzero words:
//
// * a block owns one (plane, tile of R rows).  It finds the pairs on its
//   plane itself by scanning the pair table (no sort, no host read-back) and
//   stages their masks in shared memory in chunks of C (cp.async, while the
//   warps compact their first rows), at an odd row stride so that 32 lanes
//   reading 32 masks at one column hit 32 banks;
// * a warp reads a row of its tile as part of the plane's flat word array:
//   the words up to the first 16-byte boundary, then 16-byte loads, kUnits
//   per lane issued before any is used, then the last words.  Its nonzero
//   words are compacted (a warp scan of the lanes' counts) into S (column,
//   word) slots in shared memory, once per launch.  A row with more than S
//   nonzero words is marked and tested from device memory instead (dense
//   rows: right, slower).  A plane with at most kDirect pairs (K5's one-arc
//   form) skips the compaction: each lane tests its own words;
// * the first chunk is tested on the stream: a warp compacts a row, issues
//   the loads of its next row, then tests this one, so that the memory
//   stays busy while the SMs test.  Every further chunk (a plane with more
//   than C pairs) tests the compacted rows again;
// * in the test each lane takes the pairs lane and lane + 32 of the chunk
//   and ORs mask & word over the row's nonzero words, without a branch; the
//   row stops early once every pair of the warp has a hit (checked every
//   kStopEvery words);
// * a chunk's flags are gathered in shared memory and written as rows of up
//   to R consecutive int32 per pair.
//
// The host picks R, S and C (repro_torch/kernels/domain_ac.py,
// arc_any_layout); smem_bytes() is the block's dynamic shared memory.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace arc_any {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 4;             // 16-byte loads per lane per pass over a row
constexpr int kMaxChunk = 64;         // masks per chunk: two pairs per lane
constexpr int kStopEvery = 8;         // words tested between two early-stop votes
constexpr int kDirect = 2;            // at most this many pairs on a plane: no compaction
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block may have

// Dynamic shared memory of a block: (column, word) slots [R][S] (8 bytes
// each), masks [C][ws], counts [R], pair ids [C], scan [kWarps] (4 bytes
// each), flags [C][R] (1 byte).  ws = w | 1.
inline size_t smem_bytes(int R, int S, int C, int w) {
  const size_t ws = static_cast<size_t>(w | 1);
  return 8 * static_cast<size_t>(R) * S + 4 * (C * ws + R + C + kWarps) +
         static_cast<size_t>(C) * R;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Plane of pair i, or -1 when its index lies outside [0, n_planes).
__device__ __forceinline__ int pair_plane(const int32_t* plane, int i, int n_planes) {
  const int q = plane ? plane[i] : 0;
  return (q >= 0 && q < n_planes) ? q : -1;
}

// The pairs of plane p (with those whose plane is out of range counted on
// plane 0) of rank first .. first + C - 1, in pair order, into s_pair.
// Returns how many there are.  For first == 0 it scans the whole table and
// sets *total to the plane's count.  Every thread calls it; it ends
// synchronised.
__device__ int gather_chunk(const int32_t* plane, int n_pairs, int n_planes, int p, int first,
                            int C, int* s_pair, int* s_scan, int* total) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int seen = 0;  // pairs of plane p before this window (the same in every thread)
  for (int base = 0; base < n_pairs && (first == 0 || seen < first + C); base += kThreads) {
    const int i = base + threadIdx.x;
    bool mine = false;
    if (i < n_pairs) {
      const int q = pair_plane(plane, i, n_planes);
      mine = (q < 0 ? 0 : q) == p;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) s_scan[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, all = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = s_scan[k];
      before += k < warp ? c : 0;
      all += c;
    }
    const int rank = seen + before + __popc(ballot & lanes_below());
    if (mine && rank >= first && rank < first + C) s_pair[rank - first] = i;
    seen += all;
    __syncthreads();  // s_scan is rewritten by the next window
  }
  if (first == 0) *total = seen;
  return min(max(seen - first, 0), C);
}

// The chunk's masks into s_mask rows of ws words, zero past w and for pairs
// whose plane is out of range: one warp per mask, each word an asynchronous
// 4-byte copy (cp.async, zero-filled where there is nothing to read), so
// that every copy of the chunk is in flight at once and the warps go on.
// Complete with wait_masks() and a block barrier.
__device__ void stage_masks(const uint32_t* __restrict__ masks, const int32_t* plane,
                            int n_planes, int w, int ws, int n, const int* s_pair,
                            uint32_t* s_mask) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m = warp; m < n; m += kWarps) {
    const int i = s_pair[m];
    const bool on = pair_plane(plane, i, n_planes) >= 0;
    const uint32_t* src = masks + static_cast<size_t>(i) * w;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(s_mask + static_cast<size_t>(m) * ws));
    for (int j = lane; j < ws; j += 32) {
      const bool take = on && j < w;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4 * j),
                   "l"(take ? src + j : masks), "r"(take ? 4 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_masks() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Store word v at column col in the next slot, if v is not zero.
__device__ __forceinline__ void put(uint32_t v, int col, uint2*& dst) {
  if (v != 0u) *dst++ = make_uint2(static_cast<uint32_t>(col), v);
}

// One row of the plane's flat word array on its way to a warp: the words
// before the first 16-byte boundary (lanes 0-2; rows are 4-byte aligned),
// those after the last whole 16-byte unit (lanes 4-6), and the units of the
// first pass, kUnits per lane.
struct RowLoad {
  const uint32_t* row;
  int head, n_units;
  uint32_t edge;
  uint4 v[kUnits];

  __device__ __forceinline__ int edge_col(int lane) const {
    return lane < 4 ? lane : head + 4 * n_units + lane - 4;
  }

  __device__ __forceinline__ void load_units(int u0, int lane) {
    const uint4* units = reinterpret_cast<const uint4*>(row + head);
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + 32 * k + lane;
      v[k] = u < n_units ? __ldg(units + u) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Issue every load of the row's first pass (row index t of the flat
  // [n_planes * n_t] rows).
  __device__ __forceinline__ void issue(const uint32_t* __restrict__ adj, size_t t, int w,
                                        int lane) {
    row = adj + t * w;
    head = min(w, static_cast<int>((4u - (reinterpret_cast<uintptr_t>(row) >> 2)) & 3u));
    n_units = (w - head) >> 2;
    const int c = edge_col(lane);
    edge = (lane < 4 ? lane < head : (lane < 8 && c < w)) ? __ldg(row + c) : 0u;
    load_units(0, lane);
  }

  // Compact the row's nonzero words into ent (loading any further pass
  // here), each lane's after those of the lanes below it (a warp scan of
  // their counts), and pad with zero slots to a multiple of kStopEvery (S
  // is one).  Returns the count, or -1 if there are more than S.
  __device__ __forceinline__ int compact(int S, uint2* ent, int lane) {
    int cnt = 0;  // the same in every lane
    uint32_t e = edge;
    for (int u0 = 0;;) {
      unsigned mine = min(e, 1u);
#pragma unroll
      for (int k = 0; k < kUnits; ++k)
        mine += min(v[k].x, 1u) + min(v[k].y, 1u) + min(v[k].z, 1u) + min(v[k].w, 1u);
      unsigned incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      uint2* dst = ent + cnt + static_cast<int>(incl - mine);
      cnt += static_cast<int>(__shfl_sync(0xffffffffu, incl, 31));
      if (cnt <= S) {
        put(e, edge_col(lane), dst);
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          const int col = head + 4 * (u0 + 32 * k + lane);
          put(v[k].x, col, dst);
          put(v[k].y, col + 1, dst);
          put(v[k].z, col + 2, dst);
          put(v[k].w, col + 3, dst);
        }
      }
      e = 0u;
      u0 += 32 * kUnits;
      if (u0 >= n_units || cnt > S) break;
      load_units(u0, lane);
    }
    if (cnt > S) return -1;
    if (lane < kStopEvery && cnt + lane < (cnt + kStopEvery - 1) / kStopEvery * kStopEvery)
      ent[cnt + lane] = make_uint2(0u, 0u);
    return cnt;
  }

  // The direct test of a plane with at most two pairs: every lane ORs the
  // masks' words at its own nonzero words' columns (loading any further
  // pass here); returns the two accumulators' votes as bits 0 and 1.
  __device__ __forceinline__ unsigned test_direct(const uint32_t* m0, const uint32_t* m1,
                                                  bool two, int lane) {
    uint32_t a0 = 0u, a1 = 0u;
    uint32_t e = edge;
    for (int u0 = 0;;) {
      if (e != 0u) {
        const int c = edge_col(lane);
        a0 |= m0[c] & e;
        if (two) a1 |= m1[c] & e;
      }
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int col = head + 4 * (u0 + 32 * k + lane);
        const uint32_t x[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (x[j] != 0u) {
            a0 |= m0[col + j] & x[j];
            if (two) a1 |= m1[col + j] & x[j];
          }
        }
      }
      e = 0u;
      u0 += 32 * kUnits;
      if (u0 >= n_units) break;
      load_units(u0, lane);
    }
    return (__any_sync(0xffffffffu, a0 != 0u) ? 1u : 0u) |
           (__any_sync(0xffffffffu, a1 != 0u) ? 2u : 0u);
  }
};

// Test row r of the tile (row index t of the flat rows, cnt compacted words
// in its slots, or -1) against the chunk's n masks; its flags to s_hit.
// Lane l has pairs l and l + 32 (C <= 64): for each nonzero word (column c,
// word v) it ORs mask[c] & v into one accumulator per pair, kStopEvery
// words at a time with no branch, and the row stops after the first batch
// that leaves every pair of the warp with a hit.
__device__ __forceinline__ void test_row(const uint32_t* __restrict__ adj, size_t t, int w,
                                         int ws, int R, int S, int n, int r, int cnt,
                                         const uint32_t* s_mask, const uint2* s_ent,
                                         uint8_t* s_hit) {
  const int lane = threadIdx.x & 31;
  const bool has0 = lane < n, has1 = lane + 32 < n;
  const uint32_t* m0 = s_mask + (has0 ? lane : 0) * ws;  // a lane without a pair reads mask 0
  const uint32_t* m1 = m0 + 32 * ws;                     // read only when has1
  uint32_t acc0 = 0u, acc1 = 0u;
  if (cnt >= 0) {
    const uint4* ent = reinterpret_cast<const uint4*>(s_ent + r * S);  // two slots each
    for (int k0 = 0; k0 < cnt; k0 += kStopEvery) {
      uint4 e[kStopEvery / 2];  // zero slots pad the last batch
#pragma unroll
      for (int j = 0; j < kStopEvery / 2; ++j) e[j] = ent[k0 / 2 + j];
#pragma unroll
      for (int j = 0; j < kStopEvery / 2; ++j) acc0 |= (m0[e[j].x] & e[j].y) | (m0[e[j].z] & e[j].w);
      if (has1) {
#pragma unroll
        for (int j = 0; j < kStopEvery / 2; ++j)
          acc1 |= (m1[e[j].x] & e[j].y) | (m1[e[j].z] & e[j].w);
      }
      if (__all_sync(0xffffffffu, (acc0 || !has0) && (acc1 || !has1))) break;
    }
  } else {  // more than S nonzero words: 32 words of the row at a time
    const uint32_t* row = adj + t * w;
    for (int c0 = 0; c0 < w; c0 += 32) {
      const uint32_t mine = c0 + lane < w ? __ldg(row + c0 + lane) : 0u;
      for (unsigned nz = __ballot_sync(0xffffffffu, mine != 0u); nz; nz &= nz - 1) {
        const int src = __ffs(nz) - 1;
        const uint32_t v = __shfl_sync(0xffffffffu, mine, src);
        acc0 |= m0[c0 + src] & v;
        if (has1) acc1 |= m1[c0 + src] & v;
      }
      if (__all_sync(0xffffffffu, (acc0 || !has0) && (acc1 || !has1))) break;
    }
  }
  if (has0) s_hit[lane * R + r] = acc0 != 0u;
  if (has1) s_hit[(lane + 32) * R + r] = acc1 != 0u;
}

// A chunk's flags, one row of up to R consecutive int32 per pair.
__device__ __forceinline__ void write_flags(int32_t* __restrict__ out, int n_t, int t0,
                                            int rows, int R, int n, const int* s_pair,
                                            const uint8_t* s_hit) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int m = warp; m < n; m += kWarps) {
    int32_t* o = out + static_cast<size_t>(s_pair[m]) * n_t + t0;
    for (int r = lane; r < rows; r += 32) o[r] = s_hit[m * R + r];
  }
}

__global__ void __launch_bounds__(kThreads, 2)
arc_any_kernel(const uint32_t* __restrict__ adj, const int32_t* __restrict__ plane,
               const uint32_t* __restrict__ masks, int32_t* __restrict__ out, int n_planes,
               int n_t, int w, int n_pairs, int R, int S, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = w | 1;
  uint2* s_ent = reinterpret_cast<uint2*>(smem);
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_ent + R * S);
  int* s_cnt = reinterpret_cast<int*>(s_mask + static_cast<size_t>(C) * ws);
  int* s_pair = s_cnt + R;
  int* s_scan = s_pair + C;
  uint8_t* s_hit = reinterpret_cast<uint8_t*>(s_scan + kWarps);

  const int n_tiles = (n_t + R - 1) / R;
  const int p = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - p * n_tiles) * R;
  const int rows = min(R, n_t - t0);
  const size_t t_base = static_cast<size_t>(p) * n_t + t0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int total;
  int n = gather_chunk(plane, n_pairs, n_planes, p, 0, C, s_pair, s_scan, &total);
  if (n == 0) return;  // no pair on this plane
  // The first chunk rides on the stream: a warp's first row is in flight
  // while the masks are staged, and each next row while it tests this one.
  // A plane with at most kDirect pairs tests each lane's own words directly.
  const bool direct = total == n && n <= kDirect;
  RowLoad ld;
  if (warp < rows) ld.issue(adj, t_base + warp, w, lane);
  stage_masks(masks, plane, n_planes, w, ws, n, s_pair, s_mask);
  // the first row is compacted while the masks arrive
  int cnt = warp < rows && !direct ? ld.compact(S, s_ent + warp * S, lane) : 0;
  wait_masks();
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    if (direct) {
      const unsigned hit = ld.test_direct(s_mask, s_mask + ws, n > 1, lane);
      if (lane < n) s_hit[lane * R + r] = (hit >> lane) & 1u;
      if (r + kWarps < rows) ld.issue(adj, t_base + r + kWarps, w, lane);
      continue;
    }
    if (r != warp) cnt = ld.compact(S, s_ent + r * S, lane);
    if (lane == 0) s_cnt[r] = cnt;
    __syncwarp();
    if (r + kWarps < rows) ld.issue(adj, t_base + r + kWarps, w, lane);
    test_row(adj, t_base + r, w, ws, R, S, n, r, cnt, s_mask, s_ent, s_hit);
  }
  __syncthreads();
  write_flags(out, n_t, t0, rows, R, n, s_pair, s_hit);
  // Every further chunk tests the compacted rows again.
  for (int first = C; first < total; first += C) {
    __syncthreads();  // s_pair, s_mask and s_hit are rewritten
    n = gather_chunk(plane, n_pairs, n_planes, p, first, C, s_pair, s_scan, &total);
    stage_masks(masks, plane, n_planes, w, ws, n, s_pair, s_mask);
    wait_masks();
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps)
      test_row(adj, t_base + r, w, ws, R, S, n, r, s_cnt[r], s_mask, s_ent, s_hit);
    __syncthreads();
    write_flags(out, n_t, t0, rows, R, n, s_pair, s_hit);
  }
}

// adj, plane (or nullptr), masks and out are device pointers of contiguous
// int32 tensors; R rows per block, S slots per row and C masks per chunk as
// arc_any_layout picks them.  One block per (plane, row tile), so any number
// of pairs.  Returns a CUDA error code (0 after a good launch).
inline int launch(const void* adj, const void* plane, const void* masks, void* out,
                  int n_planes, int n_t, int w, int n_pairs, int R, int S, int C,
                  void* stream) {
  const size_t bytes = smem_bytes(R, S, C, w);
  const long long blocks = static_cast<long long>((n_t + R - 1) / R) * n_planes;
  if (R < 1 || S < kStopEvery || S % kStopEvery || C < 1 || C > kMaxChunk || w < 1 ||
      bytes > kMaxSmem || blocks < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        arc_any_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  arc_any_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(adj), static_cast<const int32_t*>(plane),
      static_cast<const uint32_t*>(masks), static_cast<int32_t*>(out), n_planes, n_t, w,
      n_pairs, R, S, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace arc_any
}  // namespace
