// dense_step.cuh: the dense expansion step, one device implementation for
// K1 (extend_step.cu, the fused step) and K2 (candidate_mask.cu, its
// candidate AND alone).  Per lane l:
//
//   K1:  v        = lowest set bit of cand[l]          (valid iff cand[l] != 0)
//        cand2[l] = cand[l] ^ bit(v)
//        child[l] = dom[child_pos[l]] & ~used[l] & ~bit(v) & AND_j rows[row_idx[l, j]],
//                   zeroed unless a child is wanted (valid and depth + 1 < n_p)
//        meta[l]  = (valid, v or -1, is_match, has_child)
//   K2:  out[l]   = dom[pos[l]] & ~used[l] & AND_j rows[row_idx[l, j]]
//
// Slots holding the neutral all-ones row (index n_rows) are dropped: ANDing
// it is the identity.
//
// Replaces the Pallas TPU kernels repro/kernels/extend_step.py::extend_step
// (body _kernel, helper _lowest_bit) and
// repro/kernels/candidate_mask.py::candidate_mask, whose grids (lane, parent
// slot) ran in order, with the DMA engine chasing the scalar-prefetched row
// indices and the lane's bitmaps resident in VMEM.
//
// Bound: memory; one or two bit operations per word read.  K1 reads, for
// every lane, cand (w words) and its index words (child_pos, depth, mp row
// indices) and, for a lane that wants a child, used, its dom row and its real
// adjacency rows; it writes cand2 and child (w words each) and a meta row of
// 4 words.  K2 reads used, its index words (pos, mp row indices), the dom row
// and the real rows of every lane and writes its row.  A row that several
// lanes reference is counted once (the later reads find it in L2).
//
// The design:
//
// * one warp per lane, L lanes per block (lanes_per_block: about
//   kTargetBlocks blocks, so a small batch still spreads over the SMs, at
//   most kWarps lanes and what fits 227 KB), 32 L threads, no block barrier;
// * everything a lane needs first is issued together, up front: its child
//   position, depth, first 32 row indices (warp lane j holds slot j) and
//   K1's first pass over cand;
// * K1 reads cand once, as 16-byte units at its own alignment (head words to
//   the first 16-byte boundary on lanes 0-2, kUnits units per thread per
//   pass, tail words on lanes 4-6), and writes cand2 from the same registers
//   (cand and cand2 share a 16-byte alignment).  The first nonzero word is a
//   warp min-reduction over each pass's nonzero words, on the same pass that
//   writes cand2 (the XOR lands only on the word that holds bit v);
// * a K1 lane that wants no child (cand empty, or depth + 1 >= n_p) writes a
//   zero child (16-byte units) and its meta row and reads no used, dom or
//   adjacency row;
// * the real slots are compacted with a ballot, 32 slots per trip, into the
//   lane's row list in shared memory, so mp is not limited;
// * the rows meet in registers, word by word.  Row r of the table starts
//   (r w) mod 4 words past a 16-byte boundary, so the rows of one lane have
//   different offsets and a 16-byte unit of one row does not line up with a
//   unit of another.  A pass gives each thread K words (word i = c0 + lane +
//   32 k) and loads word i of used, the dom row and the real rows of a group
//   of S sources, every load of the pass issued before any AND (slots
//   unrolled, absent ones predicated off); each warp load reads 128
//   contiguous bytes, whatever the row's offset.  A lane with more rows
//   takes further groups within the pass.  The child goes out word by word.
//   Staging each row through shared memory with 16-byte cp.async copies at
//   its own offset, the design tried first, ran slower on the card: a lane
//   then passes through copy, wait, AND and write rounds chunk after chunk,
//   with fewer lanes per SM for the shared memory;
// * S x K = 20 words of row data in flight per thread: (kSlots, kWords) =
//   (10, 2), or (kFewSlots, kFewWords) = (5, 4) for a lane with at most 3
//   real rows, which then takes half the passes (a pass is a round trip to
//   memory, and on the main path the few lanes that want a child finish
//   after the empty ones).  64 registers for K1, so kMinBlocks blocks of
//   kWarps lanes fit an SM (32 warps); more words per pass cost lanes per SM
//   and ran slower at full batches, fewer give each lane more round trips;
// * has_child is a warp vote.
//
// K1's wrapper realigns a cand view off a 16-byte boundary (cand2 is fresh).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace dense_step {

constexpr int kWarps = 8;               // lanes per block at most, one warp each
constexpr int kMinBlocks = 4;           // blocks per SM the registers must allow
constexpr int kUnits = 4;               // 16-byte units per thread per pass over cand (1 pass at w 393)
constexpr int kSlots = 10;              // rows loaded per group: used, dom and 8 real rows in the first
constexpr int kWords = 2;               // words per thread per pass of a kSlots group
constexpr int kFewSlots = 5;            // a lane with at most this many rows takes the wider pass
constexpr int kFewWords = 4;            // words per thread per pass of a kFewSlots group
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may have
constexpr int kTargetBlocks = 264;      // two blocks on each of the H100's 132 SMs
constexpr unsigned kNone = 0xFFFFFFFFu;  // no nonzero word yet

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of one lane in words: the list of its real row indices (mp
// at most).
__host__ __device__ inline int lane_words(int mp) { return round4(mp); }

// Lanes per block for b lanes: enough to give about kTargetBlocks blocks, at
// most kWarps and at most what fits 227 KB (0 if one lane does not fit).  The
// host's copy, kernels/extend_step.py::dense_step_layout, reads the k*
// constants above from this file.
inline int lanes_per_block(int mp, int b) {
  const size_t bytes = 4 * static_cast<size_t>(lane_words(mp));
  const size_t fit = bytes == 0 ? kWarps : kMaxSmem / bytes;
  if (fit < 1) return 0;
  const int cap = static_cast<int>(fit < static_cast<size_t>(kWarps) ? fit : kWarps);
  const int want = (b + kTargetBlocks - 1) / kTargetBlocks;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

__device__ __forceinline__ uint32_t comp(const uint4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

__device__ __forceinline__ int word_offset(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// How a warp covers n words that start r words past a 16-byte boundary:
// head words [0, head), units of 4 words from head, tail words.  Pass p of
// the cand pass holds units p * 32 * kUnits + 32 * k + lane (k < kUnits), the
// head (pass 0, lanes 0-2) and the tail (last pass, lanes 4-6), so every word
// of a pass lies after every word of the pass before it.
struct RowSplit {
  int head, n_units, tail0, n_passes;

  __device__ __forceinline__ RowSplit(int n, int r) {
    head = min(n, (4 - r) & 3);
    n_units = (n - head) >> 2;
    tail0 = head + 4 * n_units;
    n_passes = max(1, (n_units + 32 * kUnits - 1) / (32 * kUnits));
  }

  // The head or tail word this lane holds in pass p (of n words), or -1.
  __device__ __forceinline__ int edge(int p, int lane, int n) const {
    if (p == 0 && lane < head) return lane;
    if (p == n_passes - 1 && lane >= 4 && tail0 + lane - 4 < n) return tail0 + lane - 4;
    return -1;
  }

  // The head or tail word this lane holds over all n words, or -1.
  __device__ __forceinline__ int edge_word(int lane, int n) const {
    return lane < head ? lane : (lane >= 4 && tail0 + lane - 4 < n ? tail0 + lane - 4 : -1);
  }
};

// n zero words to dst as 16-byte units (head and tail words one by one).
__device__ __forceinline__ void write_zeros(uint32_t* __restrict__ dst, int n, int lane) {
  const RowSplit s(n, word_offset(dst));
  uint4* units = reinterpret_cast<uint4*>(dst + s.head);
  for (int u = lane; u < s.n_units; u += 32) __stcs(units + u, make_uint4(0u, 0u, 0u, 0u));
  const int e = s.edge_word(lane, n);
  if (e >= 0) __stcs(dst + e, 0u);
}

// K1's pass over cand (w words): writes cand2 = cand ^ bit(v) and returns the
// first nonzero word (kNone if none), with v and its bit.  The loads of pass 0
// are the caller's first.
__device__ __forceinline__ unsigned cand_pass(const uint32_t* __restrict__ c,
                                              uint32_t* __restrict__ c2, int w, int lane, int& v,
                                              uint32_t& lowbit) {
  const RowSplit s(w, word_offset(c));
  const uint4* cu = reinterpret_cast<const uint4*>(c + s.head);
  uint4* c2u = reinterpret_cast<uint4*>(c2 + s.head);
  unsigned first = kNone;
  for (int p = 0; p < s.n_passes; ++p) {
    const int e_idx = s.edge(p, lane, w);
    uint4 x[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = p * 32 * kUnits + 32 * k + lane;
      x[k] = u < s.n_units ? __ldcs(cu + u) : make_uint4(0u, 0u, 0u, 0u);
    }
    const uint32_t e = e_idx >= 0 ? __ldcs(c + e_idx) : 0u;
    bool here = false;  // the first nonzero word is in this pass
    if (first == kNone) {
      unsigned mine = e != 0u ? static_cast<unsigned>(e_idx) : kNone;  // this thread's lowest
      uint32_t word = e;
#pragma unroll
      for (int k = kUnits - 1; k >= 0; --k) {
        const int i = s.head + 4 * (p * 32 * kUnits + 32 * k + lane);
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const uint32_t y = comp(x[k], j);
          if (y != 0u && static_cast<unsigned>(i + j) < mine) {
            mine = static_cast<unsigned>(i + j);
            word = y;
          }
        }
      }
      first = __reduce_min_sync(0xffffffffu, mine);
      if (first != kNone) {
        const int owner = __ffs(__ballot_sync(0xffffffffu, mine == first)) - 1;
        word = __shfl_sync(0xffffffffu, word, owner);
        lowbit = word & (0u - word);
        v = static_cast<int>(first) * 32 + __ffs(static_cast<int>(word)) - 1;
        here = true;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = p * 32 * kUnits + 32 * k + lane;
      if (u < s.n_units) {
        uint4 y = x[k];
        if (here) {
          const int i = s.head + 4 * u;
          y.x ^= i == static_cast<int>(first) ? lowbit : 0u;
          y.y ^= i + 1 == static_cast<int>(first) ? lowbit : 0u;
          y.z ^= i + 2 == static_cast<int>(first) ? lowbit : 0u;
          y.w ^= i + 3 == static_cast<int>(first) ? lowbit : 0u;
        }
        __stcs(c2u + u, y);
      }
    }
    if (e_idx >= 0) __stcs(c2 + e_idx, e ^ (here && e_idx == static_cast<int>(first) ? lowbit : 0u));
  }
  return first;
}

// One lane's child from its n_src sources (0 used, 1 the dom row, 2 + r real
// row r, whose index is s_idx[r]), bit v (word first) cleared: passes of K
// words per thread (word i = c0 + lane + 32 k) that load word i of every
// source of a group of S before they AND any; a lane with more sources takes
// further groups within the pass.  Returns whether this thread wrote a
// nonzero word.
template <int S, int K>
__device__ __forceinline__ bool meet_rows(const uint32_t* __restrict__ rows,
                                          const uint32_t* __restrict__ us,
                                          const uint32_t* __restrict__ dm, const int* s_idx,
                                          int n_src, uint32_t* __restrict__ ch, int w, int lane,
                                          unsigned first, uint32_t lowbit) {
  bool any = false;
  for (int c0 = 0; c0 < w; c0 += 32 * K) {
    uint32_t acc[K];
    for (int g0 = 0; g0 < n_src; g0 += S) {
      uint32_t x[S][K];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int src = g0 + j;
        const uint32_t* row = src >= n_src ? nullptr
                              : src == 0   ? us
                              : src == 1   ? dm
                                           : rows + static_cast<size_t>(s_idx[src - 2]) * w;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = c0 + lane + 32 * k;
          x[j][k] = row == nullptr || i >= w ? ~0u : src == 0 ? __ldcs(row + i) : __ldg(row + i);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = c0 + lane + 32 * k;
        uint32_t a = g0 == 0 ? ~x[0][k] & (i == static_cast<int>(first) ? ~lowbit : ~0u)
                             : acc[k] & x[0][k];
#pragma unroll
        for (int j = 1; j < S; ++j) a &= x[j][k];
        acc[k] = a;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = c0 + lane + 32 * k;
      if (i < w) {
        __stcs(ch + i, acc[k]);
        any |= acc[k] != 0u;
      }
    }
  }
  return any;
}

// kStep: K1 (cand pass, early stop, meta); else K2 (child of every lane, no
// bit cleared).
template <bool kStep>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
dense_step_kernel(const uint32_t* __restrict__ rows, const uint32_t* __restrict__ dom,
                  const int32_t* __restrict__ child_pos, const int32_t* __restrict__ row_idx,
                  const int32_t* __restrict__ depth, int n_p, const uint32_t* __restrict__ used,
                  const uint32_t* __restrict__ cand, uint32_t* __restrict__ cand2,
                  uint32_t* __restrict__ child, int32_t* __restrict__ meta, int b, int w, int mp,
                  int n_rows, int L) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l = blockIdx.x * L + warp;
  if (l >= b) return;  // no barrier follows: a warp without a lane leaves
  const size_t lw = static_cast<size_t>(l) * w;
  const int32_t* ri = row_idx + static_cast<size_t>(l) * mp;

  // up front: child position, depth, the first 32 row indices, cand's first pass
  const int pos = __ldg(child_pos + l);
  const int dep = kStep ? __ldg(depth + l) : 0;
  const int idx0 = lane < mp ? __ldg(ri + lane) : n_rows;
  int v = -1;
  uint32_t lowbit = 0u;
  const unsigned first = kStep ? cand_pass(cand + lw, cand2 + lw, w, lane, v, lowbit) : kNone;
  const bool valid = first != kNone;
  const bool want = !kStep || (valid && dep + 1 < n_p);
  if (!want) {  // no child wanted: no used, dom or adjacency row is read
    write_zeros(child + lw, w, lane);
    if (lane == 0)  // a valid lane here is a match
      *reinterpret_cast<int4*>(meta + static_cast<size_t>(l) * 4) =
          make_int4(valid ? 1 : 0, valid ? v : -1, valid ? 1 : 0, 0);
    return;
  }

  // the real slots, compacted into the lane's row list
  int* s_idx = reinterpret_cast<int*>(smem) + static_cast<size_t>(warp) * lane_words(mp);
  int n_real = 0;
  for (int t0 = 0; t0 < mp; t0 += 32) {
    const int r = t0 == 0 ? idx0 : (t0 + lane < mp ? __ldg(ri + t0 + lane) : n_rows);
    const bool real = t0 + lane < mp && r != n_rows;
    const unsigned bal = __ballot_sync(0xffffffffu, real);
    if (real) s_idx[n_real + __popc(bal & ((1u << lane) - 1u))] = r;
    n_real += __popc(bal);
  }
  __syncwarp();

  const int n_src = 2 + n_real;  // used, the dom row, the real rows
  const uint32_t* us = used + lw;
  const uint32_t* dm = dom + static_cast<size_t>(pos) * w;
  const bool any = n_src <= kFewSlots
                       ? meet_rows<kFewSlots, kFewWords>(rows, us, dm, s_idx, n_src, child + lw,
                                                         w, lane, first, lowbit)
                       : meet_rows<kSlots, kWords>(rows, us, dm, s_idx, n_src, child + lw, w,
                                                   lane, first, lowbit);
  if (kStep) {
    const bool has_child = __any_sync(0xffffffffu, any);
    if (lane == 0)
      *reinterpret_cast<int4*>(meta + static_cast<size_t>(l) * 4) =
          make_int4(1, v, 0, has_child ? 1 : 0);
  }
}

// One launch: L lanes per block (lanes_per_block), 32 L threads, ceil(b / L)
// blocks.  Pointers are device pointers of contiguous int32 tensors; K1's
// cand and cand2 start on a common 16-byte boundary.  Returns a CUDA error
// code (0 after a good launch).
template <bool kStep>
inline int launch(const void* rows, const void* dom, const void* child_pos, const void* row_idx,
                  const void* depth, int n_p, const void* used, const void* cand, void* cand2,
                  void* child, void* meta, int b, int w, int mp, int n_rows, void* stream) {
  const int L = lanes_per_block(mp, b);
  const bool apart = kStep && ((reinterpret_cast<uintptr_t>(cand) ^
                                 reinterpret_cast<uintptr_t>(cand2)) & 15u) != 0u;
  if (L < 1 || w < 1 || mp < 0 || b < 0 || apart) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const size_t bytes = 4 * static_cast<size_t>(L) * lane_words(mp);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dense_step_kernel<kStep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((b + L - 1) / L);
  dense_step_kernel<kStep><<<blocks, 32 * L, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(dom),
      static_cast<const int32_t*>(child_pos), static_cast<const int32_t*>(row_idx),
      static_cast<const int32_t*>(depth), n_p, static_cast<const uint32_t*>(used),
      static_cast<const uint32_t*>(cand), static_cast<uint32_t*>(cand2),
      static_cast<uint32_t*>(child), static_cast<int32_t*>(meta), b, w, mp, n_rows, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dense_step
}  // namespace
