// csr_arc_sweep.cuh: K8, the support test of one RI-DS arc-consistency sweep
// over CSR planes.  For every arc a and target node t:
//
//   out[a, t] = 1 iff some entry u among the first min(seg_len[p, t], deg_cap)
//               entries of row t of plane p = arc_row[a]
//               (indices[seg_start[p, t] + k]) has bit u set in masks[a].
//
// An arc_row outside [0, n_planes) supports nothing, an entry outside
// [0, w * 32) (the sentinel tail) supports nothing, and no read goes past
// n_idx.  seg_start may be any offsets: rows need not follow each other.
//
// Replaces the Pallas TPU kernel repro/kernels/domain_ac.py::csr_arc_sweep
// (body _csr_sweep_kernel), whose (arc, row tile) grid ran in order, chose the
// plane's seg_start / seg_len blocks through the scalar-prefetched arc_row
// table and tested each row against one arc's mask.
//
// Bound: memory.  Read once, each named plane's bounds (2 n_t words) and each
// row's entries as far as the furthest-reading arc on the plane needs; every
// arc's mask (w words); n_t flags per arc written.  The table below adds
// 32 w words per group, written once and read from L2.
//
// The design.  The arcs are grouped by plane: the arcs are cut into chunks of
// kChunk, and a chunk's arcs on one plane form groups of up to kGroup, in
// order of appearance (arcs on no plane form groups of their own, which
// support nothing).  A block finds its group itself (find_group: one thread
// per arc of the chunk counts the arcs before it on its plane), so the grids
// are sized on the host for the most groups a chunk can form and nothing is
// read back.  One sweep is two kernels on the caller's stream:
//
// 1. table_kernel: the bit-transposed mask table of each group: bit j of
//    T[g, u] is bit u of the mask of the group's j-th arc.  A warp holds word
//    i of the group's masks (lane j, arc j) and one __ballot_sync per bit
//    gives T[g, 32 i + b]; each mask word is read once.
// 2. sweep_kernel, launched as a programmatic dependent of the table kernel:
//    a block owns one (group, tile of kRows rows).  It reads the tile's
//    bounds once for all the group's arcs (one row per thread) and tests an
//    entry u against all of them with one lookup of T[g, u].  A warp walks
//    the concatenated capped entries of its 32 rows, kUnroll entries per lane
//    in flight: a binary search over the warp's inclusive prefix sum of
//    lengths (shuffles) names each entry's row, so neighbouring lanes read
//    neighbouring entries when rows are laid out as an indptr.  Everything
//    up to the first lookup (the group, the bounds, the first entries) runs
//    while the table kernel is still running; the block then waits for it
//    (griddepcontrol.wait).  Lookups OR into the row's word in shared memory;
//    a row stops being read once every arc of the group has found support.
//    Rows longer than kHubLen are left to the whole block: the block walks
//    them one after the other, kHubUnroll entries per thread in flight with
//    the next pass's loads issued under the current pass's lookups, and each
//    warp ORs its part of the row into the row's word.  Then each group arc's
//    flags go out, one coalesced store of kRows flags per arc.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace csr_sweep {

constexpr int kWarps = 8;                // warps of a block (both kernels)
constexpr int kThreads = 32 * kWarps;    // threads of a block
constexpr int kRows = kThreads;          // rows per tile: one per thread, 32 per warp
constexpr int kUnroll = 4;               // entries per lane in flight in a warp walk
constexpr int kHubLen = 512;             // a longer row is walked by the whole block
constexpr int kHubUnroll = 16;           // entries per thread in flight in a block walk
constexpr int kGroup = 32;               // arcs per group: the bits of a table word
constexpr int kChunk = 64;               // arcs grouped together, one thread each
constexpr int kTableWords = 4;           // mask words per table warp
constexpr int kNoGroup = -2;             // the plane of a group the chunk does not form
constexpr unsigned kFull = 0xFFFFFFFFu;

// Group slots per chunk: a key (a plane, or "no plane") with n of the chunk's
// m arcs forms ceil(n / kGroup) groups, so a chunk forms at most
// (m + (kGroup - 1) min(n_planes + 1, m)) / kGroup.
__host__ __device__ inline long long slots_per_chunk(int n_planes, int n_arcs) {
  const long long m = n_arcs < kChunk ? n_arcs : kChunk;
  const long long keys = n_planes + 1 < m ? n_planes + 1 : m;
  return (m + (kGroup - 1) * keys) / kGroup;
}

// The group in slot `slot` of chunk `chunk`, into shared memory: s_arc[j] its
// j-th arc (-1 past its last), s_grp[0] its plane (-1: arcs on no plane;
// kNoGroup: the chunk forms fewer groups), s_grp[1] its arcs.  A group's
// number is the groups of the keys that first appear earlier in the chunk
// (one each, two for a key with more than kGroup arcs) plus the arc's rank
// on its key over kGroup.  All threads of the block call it; thread i <
// kChunk takes the chunk's arc i.  s_key holds kChunk words, s_mask 4.
__device__ __forceinline__ void find_group(const int32_t* __restrict__ arc_row, int n_arcs,
                                           int n_planes, int chunk, int slot, int* s_key,
                                           unsigned* s_mask, int* s_arc, int* s_grp) {
  static_assert(kChunk == 64, "a chunk's keys are matched as one 64-bit mask");
  const int i = threadIdx.x;
  const int a = chunk * kChunk + i;
  const int m = min(kChunk, n_arcs - chunk * kChunk);
  if (i < kGroup) s_arc[i] = -1;
  if (i == 0) s_grp[0] = kNoGroup;
  int key = -1;
  if (i < m) {
    const int p = arc_row[a];
    key = p >= 0 && p < n_planes ? p : n_planes;
    s_key[i] = key;
  }
  __syncthreads();
  unsigned long long same = 0;  // the chunk's arcs on my key
  if (i < m) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m && s_key[j] == key) same |= 1ull << j;
  }
  const int rank = i < kChunk ? __popcll(same & ((1ull << i) - 1ull)) : 0, n = __popcll(same);
  const int first = __ffsll(static_cast<long long>(same)) - 1;
  if (i < kChunk) {  // warps 0 and 1: which arcs open a key, and which open two groups
    const unsigned lead = __ballot_sync(kFull, i < m && rank == 0);
    const unsigned two = __ballot_sync(kFull, i < m && rank == 0 && n > kGroup);
    if ((i & 31) == 0) {
      s_mask[i >> 5] = lead;
      s_mask[2 + (i >> 5)] = two;
    }
  }
  __syncthreads();
  if (i < m) {
    const unsigned long long before = (1ull << first) - 1ull;
    const unsigned long long lead = s_mask[0] | static_cast<unsigned long long>(s_mask[1]) << 32;
    const unsigned long long two = s_mask[2] | static_cast<unsigned long long>(s_mask[3]) << 32;
    const int g = __popcll(lead & before) + __popcll(two & before) + rank / kGroup;
    if (g == slot) {
      s_arc[rank % kGroup] = a;
      if (rank % kGroup == 0) {
        s_grp[0] = key < n_planes ? key : -1;
        s_grp[1] = min(kGroup, n - rank);
      }
    }
  }
  __syncthreads();
}

// ---- 1: the bit-transposed mask table -------------------------------------
__global__ void __launch_bounds__(kThreads)
table_kernel(const int32_t* __restrict__ arc_row, const uint32_t* __restrict__ masks,
             uint32_t* __restrict__ table, int n_arcs, int n_planes, int w, int per_chunk,
             int word_blocks) {
  __shared__ int s_key[kChunk], s_arc[kGroup], s_grp[2];
  __shared__ unsigned s_mask[4];
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");  // the sweep may start
  const int g = blockIdx.x / word_blocks;
  find_group(arc_row, n_arcs, n_planes, g / per_chunk, g % per_chunk, s_key, s_mask, s_arc,
             s_grp);
  const int lane = threadIdx.x & 31;
  const int i0 = ((blockIdx.x % word_blocks) * kWarps + (threadIdx.x >> 5)) * kTableWords;
  if (s_grp[0] < 0 || i0 >= w) return;  // no group, or arcs on no plane: no table
  const int a = s_arc[lane];
  uint32_t m[kTableWords];
#pragma unroll
  for (int k = 0; k < kTableWords; ++k)
    m[k] = a >= 0 && i0 + k < w ? masks[static_cast<size_t>(a) * w + i0 + k] : 0u;
  uint32_t* tg = table + static_cast<size_t>(g) * kGroup * w;
#pragma unroll
  for (int k = 0; k < kTableWords; ++k) {
    if (i0 + k >= w) break;
    uint32_t mine = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned v = __ballot_sync(kFull, (m[k] >> b) & 1u);
      if (lane == b) mine = v;
    }
    tg[static_cast<size_t>(i0 + k) * 32 + lane] = mine;
  }
}

// ---- 2: the sweep ---------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int32_t* __restrict__ seg_start, const int32_t* __restrict__ seg_len,
             const int32_t* __restrict__ indices, const int32_t* __restrict__ arc_row,
             const uint32_t* __restrict__ table, int32_t* __restrict__ out, int n_planes,
             int n_t, int n_idx, int w, int n_arcs, int deg_cap, int slots, int per_chunk) {
  __shared__ uint32_t s_acc[kRows];  // the group's arcs with support, per row
  __shared__ int s_key[kChunk], s_arc[kGroup], s_grp[2];
  __shared__ unsigned s_mask[4];
  __shared__ int s_hub_row[kRows], s_hub_lo[kRows], s_hub_n[kRows], s_n_hubs;
  const int g = blockIdx.x % slots;
  const int t0 = (blockIdx.x / slots) * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, r = threadIdx.x;
  s_acc[r] = 0;
  if (r == 0) s_n_hubs = 0;
  find_group(arc_row, n_arcs, n_planes, g / per_chunk, g % per_chunk, s_key, s_mask, s_arc,
             s_grp);
  const int plane = s_grp[0], size = s_grp[1];
  if (plane == kNoGroup) return;
  const uint32_t full = size == kGroup ? kFull : (1u << size) - 1u;
  const int t = t0 + r;
  int lo = 0, n = 0;  // the row's capped entries: indices[lo, lo + n)
  if (plane >= 0 && t < n_t) {
    const size_t pt = static_cast<size_t>(plane) * n_t + t;
    const int s = seg_start[pt];
    const long long hi = min(static_cast<long long>(s) + min(seg_len[pt], deg_cap),
                             static_cast<long long>(n_idx));
    lo = max(s, 0);
    n = static_cast<int>(max(hi - lo, 0LL));
  }
  const uint32_t* tg = table + static_cast<size_t>(g) * kGroup * w;
  const int n_bits = 32 * w;
  if (n > kHubLen) {  // left to the whole block
    const int h = atomicAdd(&s_n_hubs, 1);
    s_hub_row[h] = r;
    s_hub_lo[h] = lo;
    s_hub_n[h] = n;
    n = 0;
  }
  // the warp walk over its 32 rows' entries, kUnroll per lane in flight
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += x;
  }
  const int excl = incl - n;
  const int total = __shfl_sync(kFull, incl, 31);
  uint32_t* acc = s_acc + 32 * warp;
  int u[kUnroll], row[kUnroll];
  auto load = [&](int base) {  // entries base + 32 j + lane, of rows not yet supported by all
    int rr[kUnroll];  // the first row whose inclusive offset passes each entry, searched together
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) rr[j] = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        if (__shfl_sync(kFull, incl, rr[j] + step - 1) <= base + 32 * j + lane) rr[j] += step;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int k = base + 32 * j + lane, src = rr[j] & 31;
      const int at = __shfl_sync(kFull, lo, src) + k - __shfl_sync(kFull, excl, src);
      row[j] = k < total && acc[src] != full ? src : -1;
      u[j] = row[j] >= 0 ? indices[at] : -1;
    }
  };
  load(0);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the table is complete
  for (int base = 0; base < total; base += 32 * kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (u[j] >= 0 && u[j] < n_bits) {
        const uint32_t bits = __ldg(tg + u[j]);
        if (bits) atomicOr(acc + row[j], bits);
      }
    }
    __syncwarp();
    if (base + 32 * kUnroll < total) load(base + 32 * kUnroll);
  }
  __syncthreads();  // the hub list is complete
  // the block walk over the tile's hub rows
  const int n_hubs = s_n_hubs;
  for (int h = 0; h < n_hubs; ++h) {
    const int hr = s_hub_row[h], hlo = s_hub_lo[h], hn = s_hub_n[h];
    int hu[kHubUnroll], next[kHubUnroll];
#pragma unroll
    for (int j = 0; j < kHubUnroll; ++j)
      hu[j] = kThreads * j + r < hn ? indices[hlo + kThreads * j + r] : -1;
    for (int base = 0; base < hn; base += kThreads * kHubUnroll) {
      if (__shfl_sync(kFull, s_acc[hr], 0) == full) break;
      const int nb = base + kThreads * kHubUnroll;  // the next pass, in flight under this one
#pragma unroll
      for (int j = 0; j < kHubUnroll; ++j) {
        const int k = nb + kThreads * j + r;
        next[j] = k < hn ? indices[hlo + k] : -1;
      }
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < kHubUnroll; ++j)
        if (hu[j] >= 0 && hu[j] < n_bits) bits |= __ldg(tg + hu[j]);
      bits = __reduce_or_sync(kFull, bits);
      if (lane == 0 && bits) atomicOr(s_acc + hr, bits);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kHubUnroll; ++j) hu[j] = next[j];
    }
  }
  __syncthreads();
  if (t < n_t) {
    const uint32_t found = s_acc[r];
    for (int j = 0; j < size; ++j)
      out[static_cast<size_t>(s_arc[j]) * n_t + t] = static_cast<int32_t>((found >> j) & 1u);
  }
}

// One sweep: the two kernels above.  table holds table_words int32 words,
// at least slots * kGroup * w with slots = ceil(n_arcs / kChunk) *
// slots_per_chunk(n_planes, n_arcs); the grids have slots * ceil(w / (kWarps
// kTableWords)) and slots * ceil(n_t / kRows) blocks, at most 2^31 - 1 each.
// Returns a CUDA error code (0 after good launches).
inline int launch(const void* seg_start, const void* seg_len, const void* indices,
                  const void* arc_row, const void* masks, void* out, void* table,
                  long long table_words, int n_planes, int n_t, int n_idx, int w, int n_arcs,
                  int deg_cap, void* stream) {
  if (n_planes < 0 || n_t < 0 || n_idx < 0 || w < 0 || n_arcs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_arcs == 0 || n_t == 0) return 0;
  const long long per_chunk = slots_per_chunk(n_planes, n_arcs);
  const long long slots = (n_arcs + kChunk - 1) / kChunk * per_chunk;
  const long long tiles = (n_t + kRows - 1) / kRows;
  const long long word_blocks = (w + kWarps * kTableWords - 1) / (kWarps * kTableWords);
  if (table_words < slots * kGroup * static_cast<long long>(w) || slots * tiles > 0x7FFFFFFFLL ||
      slots * word_blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_blocks > 0)
    table_kernel<<<static_cast<unsigned>(slots * word_blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(arc_row), static_cast<const uint32_t*>(masks),
        static_cast<uint32_t*>(table), n_arcs, n_planes, w, static_cast<int>(per_chunk),
        static_cast<int>(word_blocks));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(slots * tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = word_blocks > 0 ? 1 : 0;  // else no table kernel to overlap: wait as usual
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sweep_kernel, static_cast<const int32_t*>(seg_start),
      static_cast<const int32_t*>(seg_len), static_cast<const int32_t*>(indices),
      static_cast<const int32_t*>(arc_row), static_cast<const uint32_t*>(table),
      static_cast<int32_t*>(out), n_planes, n_t, n_idx, w, n_arcs, deg_cap,
      static_cast<int>(slots), static_cast<int>(per_chunk));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace csr_sweep
}  // namespace
