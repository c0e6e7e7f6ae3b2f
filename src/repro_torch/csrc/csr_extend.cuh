// csr_extend.cuh: the sparse expansion step, one device implementation for
// K6 (csr_extend.cu, the flat walk) and K7 (csr_extend_bucketed.cu, the
// degree-bucketed walk).  Per lane l:
//
//   v        = lowest set bit of cand[l]          (valid iff cand[l] != 0)
//   cand2[l] = cand[l] ^ bit(v)
//   base     = dom[child_pos[l]] & ~used[l] & ~bit(v)
//   child[l] = OR of bit(u) over the node ids u found in the segment of every
//              real parent (seg_len >= 0) and set in base; base when the lane
//              has no real parent.  Zeroed unless a child is wanted (valid and
//              depth + 1 < n_p).
//   meta[l]  = (valid, v or -1, is_match, has_child)
//
// A segment is the sorted run indices[start, start + min(len, deg_cap)); an
// id u maps to bit min(max(u, 0), 32 * w - 1).  The plan bounds every row by
// deg_cap, where the TPU kernels' flat window (K6) and pow2 degree buckets
// (K7) both stop at the row's end, so the two walks give the same bits and
// share this code; the launchers differ only in their library and launch
// count.
//
// Replaces the Pallas TPU kernels repro/kernels/csr_extend.py::csr_extend
// (body _kernel: the first real parent's deg_cap-wide window, searchsorted in
// the others) and ::csr_extend_bucketed (body _kernel_bucketed: the same lead
// walked chunk by chunk up to its pow2 bucket, with a fixed-trip binary
// search), both one grid step per lane with the indices resident in VMEM.
//
// Bound: memory.  A lane reads cand (w words), and, when a child may be
// wanted, used and its dom row, its pivot segment (the one that leads the
// walk) and the searches' probes; it writes cand2, child and its meta row.
// The design:
//
// * one warp per lane, kWarps lanes per block at most; the host picks the
//   lanes per block L from w and b so that L lanes' shared memory (base and
//   child, w + 3 words each, and the segment table) fits 227 KB and a small
//   batch still spreads over the SMs (lanes_per_block);
// * each row word is read once: a warp reads the lane's cand, used and
//   cand2 rows as 16-byte units (rows are 4-byte aligned; the words before
//   the first 16-byte boundary and after the last unit go to lanes 0-2 and
//   4-6), kUnits units per thread per pass.  The first nonzero word of cand
//   is a warp min-reduction over each pass's nonzero words, on the same
//   pass that writes cand2 (the XOR lands only on the word holding bit v);
//   used is loaded only once cand has a nonzero word, and only for lanes
//   that may want a child;
// * the dom row is staged into the lane's base with 16-byte cp.async copies
//   at the row's own alignment (base word i sits at s_base[r + i], r the
//   row's word offset from a 16-byte boundary), issued when v is found;
// * the walk is led by the pivot, the shortest real parent segment: its
//   entries (each compared with the entry before it, to skip duplicates) are
//   tested against base and looked up in every other real segment.  The set of
//   survivors is the intersection of all real segments with base, which is
//   what the TPU kernels compute from the first real parent;
// * a pivot of at most kLongWalk entries is walked by its lane's warp, 32
//   entries per trip, with each other segment of at most 32 entries held one
//   entry per lane and compared through shuffles (no dependent loads) and a
//   longer one binary-searched; a longer pivot (a hub row, all parents
//   hubs) is walked by every warp of the block after a barrier, as
//   bitmaps: its entries in base ORed into the child, each other segment
//   built as a bitmap in shared memory and ANDed in (walk_bitmap), so no hub
//   is walked by one warp.  Blocks without a long lane pass no barrier
//   after the first;
// * survivors are ORed into the lane's shared child (atomicOr), which is
//   written out as 16-byte units; a warp vote gives has_child.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace csr_step {

constexpr int kWarps = 8;               // warps per block: at most kWarps lanes
constexpr int kThreads = 32 * kWarps;
constexpr int kUnits = 5;               // 16-byte units per thread per pass over a row (2 passes at w 1,034)
constexpr int kLongWalk = 8 * 32;       // longer pivot segments are walked by the block
constexpr int kUnroll = 4;              // pivot entries a thread loads before it tests them
constexpr int kPre = 8;                 // parent slots whose short segments a walk preloads
constexpr int kHeader = 2;              // per lane: pivot slot, walked-by-the-block flag
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may have
constexpr int kTargetBlocks = 264;      // two blocks on each of the H100's 132 SMs
constexpr unsigned kNone = 0xFFFFFFFFu;  // no nonzero word yet

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of one lane in words: base and child (w + 3 words each,
// rounded to 16 bytes, so that a row's 16-byte units land on 16-byte
// boundaries whatever its offset), segment starts and lengths [mp] each and
// the header.
__host__ __device__ inline int lane_words(int w, int mp) {
  return 2 * round4(w + 3) + round4(2 * mp + kHeader);
}

// Lanes per block for b lanes: enough to give about kTargetBlocks blocks,
// at most kWarps and at most what fits 227 KB (0 if one lane does not fit).
// The host's copy, kernels/csr_extend.py::csr_step_layout, reads the k*
// constants above from this file.
inline int lanes_per_block(int w, int mp, int b) {
  const size_t bytes = 4 * static_cast<size_t>(lane_words(w, mp));
  const size_t fit = kMaxSmem / bytes;
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

// How a warp covers a row of w words that starts r words past a 16-byte
// boundary: head words [0, head), units of 4 words from head, tail words.
// Pass p holds units p * 32 * kUnits + 32 * k + lane (k < kUnits), the head
// (pass 0, lanes 0-2) and the tail (last pass, lanes 4-6), so every word of
// a pass lies after every word of the pass before it.
struct RowSplit {
  int head, n_units, tail0, n_passes;

  __device__ __forceinline__ RowSplit(int w, int r) {
    head = min(w, (4 - r) & 3);
    n_units = (w - head) >> 2;
    tail0 = head + 4 * n_units;
    n_passes = max(1, (n_units + 32 * kUnits - 1) / (32 * kUnits));
  }

  // The head or tail word this lane holds in pass p, or -1.
  __device__ __forceinline__ int edge(int p, int lane, int w) const {
    if (p == 0 && lane < head) return lane;
    if (p == n_passes - 1 && lane >= 4 && tail0 + lane - 4 < w) return tail0 + lane - 4;
    return -1;
  }
};

// One pass of one row: this thread's units and edge word.
struct Pass {
  uint4 v[kUnits];
  uint32_t e;
};

__device__ __forceinline__ void load_pass(const uint32_t* __restrict__ row, const RowSplit& s,
                                          int p, int e_idx, int lane, Pass& out) {
  const uint4* units = reinterpret_cast<const uint4*>(row + s.head);
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = p * 32 * kUnits + 32 * k + lane;
    out.v[k] = u < s.n_units ? __ldcs(units + u) : make_uint4(0u, 0u, 0u, 0u);
  }
  out.e = e_idx >= 0 ? __ldcs(row + e_idx) : 0u;
}

// base[i] &= ~used[i] & ~(bit v at word first) over the words of pass p
// (base word i at sb[i], already holding the dom word).
__device__ __forceinline__ void base_pass(uint32_t* sb, const Pass& us, const RowSplit& s, int p,
                                          int e_idx, int first, uint32_t lowbit, int lane) {
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int u = p * 32 * kUnits + 32 * k + lane;
    if (u < s.n_units) {
      const int i = s.head + 4 * u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sb[i + j] &= ~comp(us.v[k], j) & ~(i + j == first ? lowbit : 0u);
    }
  }
  if (e_idx >= 0) sb[e_idx] &= ~us.e & ~(e_idx == first ? lowbit : 0u);
}

// The dom row (w words) into base: 16-byte cp.async copies between the
// row's 16-byte boundaries, 4-byte ones for its first and last words.
__device__ __forceinline__ void stage_dom(const uint32_t* __restrict__ dm, uint32_t* sb, int w,
                                          int lane) {
  const RowSplit s(w, word_offset(dm));
  for (int u = lane; u < s.n_units; u += 32) {
    const int i = s.head + 4 * u;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(sb + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(dm + i));
  }
  const int e = lane < s.head ? lane : (lane >= 4 && s.tail0 + lane - 4 < w ? s.tail0 + lane - 4 : -1);
  if (e >= 0) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(sb + e));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(dm + e));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_dom() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Whether each of a thread's U pivot entries u[r] still alive (ok[r]) lies
// in segment j = indices[lo, lo + n).  A segment of at most 32 entries is
// held one entry per lane (pre, loaded once per walk) and every lane's
// entries are compared with each of them through warp shuffles; a longer
// one takes a branchless binary search, the U entries in lockstep.  The
// warp must be converged (n is the same in every lane).
template <int U>
__device__ __forceinline__ void member(const int32_t* __restrict__ indices, int lo, int n,
                                       int32_t pre, const int32_t (&u)[U], bool (&ok)[U]) {
  if (n <= 32) {
    bool hit[U];
#pragma unroll
    for (int r = 0; r < U; ++r) hit[r] = false;
    for (int k = 0; k < n; ++k) {
      const int32_t e = __shfl_sync(0xffffffffu, pre, k);
#pragma unroll
      for (int r = 0; r < U; ++r) hit[r] |= e == u[r];
    }
#pragma unroll
    for (int r = 0; r < U; ++r) ok[r] = ok[r] && hit[r];
    return;
  }
  int pos[U];
#pragma unroll
  for (int r = 0; r < U; ++r) pos[r] = lo;
  // the lower bound lies in [pos, pos + m]; each halving keeps that
  for (int m = n; m > 1; m -= m >> 1) {
    const int half = m >> 1;
#pragma unroll
    for (int r = 0; r < U; ++r)
      if (ok[r] && __ldg(indices + pos[r] + half) < u[r]) pos[r] += half;
  }
#pragma unroll
  for (int r = 0; r < U; ++r) {
    if (!ok[r]) continue;
    const int32_t a = __ldg(indices + pos[r]);
    const int32_t b = pos[r] + 1 < lo + n ? __ldg(indices + pos[r] + 1) : a;
    ok[r] = a == u[r] || (a < u[r] && b == u[r]);
  }
}

// The lane's warp walks pivot entries k = lane + 32 * (r + U * i) < d_len
// (every lane runs the same trips): keep u when it differs from the entry
// before it, its bit is set in base (sb) and every other real segment holds
// it (member, slot by slot, until no entry of the warp is left); OR
// survivors into the child (sc).
template <int U>
__device__ __forceinline__ void walk(const int32_t* __restrict__ indices, const int* s_start,
                                     const int* s_len, int mp, int d, const uint32_t* sb,
                                     uint32_t* sc, int w) {
  const int lane = threadIdx.x & 31;
  const int d_start = s_start[d];
  const int d_len = s_len[d];
  const int n_bits = 32 * w;
  int32_t pre[kPre];  // the short segments of the first kPre slots, one entry per lane
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int n = j < mp && j != d ? s_len[j] : 0;
    pre[j] = lane < n && n <= 32 ? __ldg(indices + s_start[j] + lane) : 0;
  }
  for (int k0 = 0; k0 < d_len; k0 += 32 * U) {
    int32_t u[U];
    bool ok[U];
    int uc[U];
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int k = k0 + lane + 32 * r;
      ok[r] = k < d_len;
      u[r] = ok[r] ? __ldg(indices + d_start + k) : 0;
      const int32_t prev = ok[r] && k > 0 ? __ldg(indices + d_start + k - 1) : ~u[r];
      uc[r] = min(max(u[r], 0), n_bits - 1);
      ok[r] = ok[r] && prev != u[r] && ((sb[uc[r] >> 5] >> (uc[r] & 31)) & 1u);
    }
    for (int j = 0; j < mp; ++j) {
      bool any = false;
#pragma unroll
      for (int r = 0; r < U; ++r) any |= ok[r];
      if (!__any_sync(0xffffffffu, any)) break;
      const int n = s_len[j];
      if (j == d || n < 0) continue;
      int32_t pj = 0;
#pragma unroll
      for (int q = 0; q < kPre; ++q)
        if (q == j) pj = pre[q];
      if (j >= kPre && n <= 32) pj = lane < n ? __ldg(indices + s_start[j] + lane) : 0;
      member<U>(indices, s_start[j], n, pj, u, ok);
    }
#pragma unroll
    for (int r = 0; r < U; ++r)
      if (ok[r]) atomicOr(sc + (uc[r] >> 5), 1u << (uc[r] & 31));
  }
}

// OR bit(u) into bm for every entry u of seg[0, n) in [0, n_bits) whose bit
// is set in filter (every such entry without one).  Every thread of the
// block calls it.  The entries are read as 16-byte units at the segment's
// own alignment (its first and last entries one by one, threads 0-2 and
// 4-6), kUnroll units per thread in flight; a thread's run of entries in
// one word (a unit holds four sorted ids) takes one atomicOr.
__device__ __forceinline__ void or_entries(const int32_t* __restrict__ seg, int n, int n_bits,
                                           const uint32_t* filter, uint32_t* bm) {
  const int t = threadIdx.x;
  const int head = min(n, (4 - word_offset(seg)) & 3);
  const int n_units = (n - head) >> 2;
  const int tail0 = head + 4 * n_units;
  const auto keep = [&](int32_t x) {
    return x >= 0 && x < n_bits && (filter == nullptr || ((filter[x >> 5] >> (x & 31)) & 1u));
  };
  const int e = t < head ? t : (t >= 4 && tail0 + t - 4 < n ? tail0 + t - 4 : -1);
  if (e >= 0) {
    const int32_t x = __ldg(seg + e);
    if (keep(x)) atomicOr(bm + (x >> 5), 1u << (x & 31));
  }
  const int4* units = reinterpret_cast<const int4*>(seg + head);
  for (int u0 = 0; u0 < n_units; u0 += kThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int u = u0 + r * kThreads + t;
      v[r] = u < n_units ? __ldg(units + u) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int32_t x[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
      int word = -1;
      uint32_t bits = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!keep(x[j])) continue;
        if ((x[j] >> 5) != word) {
          if (bits != 0u) atomicOr(bm + word, bits);
          word = x[j] >> 5;
          bits = 0u;
        }
        bits |= 1u << (x[j] & 31);
      }
      if (bits != 0u) atomicOr(bm + word, bits);
    }
  }
}

// The long walk of a lane, by every thread of the block (every thread calls
// it).  A long pivot has only long segments beside it (it is the shortest),
// so the intersection is done on bitmaps: the pivot's entries set in base
// are ORed into the child, then for each other real segment its entries
// are ORed into a bitmap built where base was (base is not read again) and
// the child is ANDed with it (or_entries reads each segment once).  Ids
// outside [0, 32 w) map to a clamped bit, which a bitmap cannot tell apart,
// so such pivot entries are searched in each other segment one by one
// (never on the plan's rows).
__device__ __forceinline__ void walk_bitmap(const int32_t* __restrict__ indices, const int* s_start,
                                            const int* s_len, int mp, int d, uint32_t* sb,
                                            uint32_t* sc, int w) {
  const int t = threadIdx.x;
  const int d_len = s_len[d];
  const int32_t* drv = indices + s_start[d];
  const int n_bits = 32 * w;
  // base's first and last bits, for the clamped ids after base is overwritten
  const uint32_t edge_bits = (sb[0] & 1u) | ((sb[w - 1] >> 30) & 2u);
  or_entries(drv, d_len, n_bits, sb, sc);
  for (int j = 0; j < mp; ++j) {
    const int n = s_len[j];
    if (j == d || n < 0) continue;
    __syncthreads();  // the child is complete and base (or the last bitmap) is read
    for (int i = t; i < w; i += kThreads) sb[i] = 0u;
    __syncthreads();
    or_entries(indices + s_start[j], n, n_bits, nullptr, sb);
    __syncthreads();
    for (int i = t; i < w; i += kThreads) sc[i] &= sb[i];
  }
  // pivot entries outside [0, 32 w): exact searches, then their clamped bit
  __syncthreads();  // after the last AND of the child
  for (int k = t; k < d_len; k += kThreads) {
    const int32_t u = __ldg(drv + k);
    if (u >= 0 && u < n_bits) continue;
    const uint32_t bit = u < 0 ? 1u : 2u;
    if (!(edge_bits & bit) || (k > 0 && __ldg(drv + k - 1) == u)) continue;
    bool ok = true;
    for (int j = 0; j < mp && ok; ++j) {
      const int n = s_len[j];
      if (j == d || n < 0) continue;
      int lo = s_start[j], hi = s_start[j] + n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(indices + mid) < u)
          lo = mid + 1;
        else
          hi = mid;
      }
      ok = lo < s_start[j] + n && __ldg(indices + lo) == u;
    }
    if (ok) atomicOr(u < 0 ? sc : sc + (w - 1), u < 0 ? 1u : 0x80000000u);
  }
}

// The lane's child row from src (word i at src[i]; aligned: src + head is
// 16-byte aligned, else read word by word), or zeros when src is null, as
// 16-byte units; returns whether any word is nonzero (a warp vote).
__device__ __forceinline__ bool write_child(uint32_t* __restrict__ ch, const uint32_t* src,
                                            bool aligned, const RowSplit& s, int w, int lane) {
  uint4* units = reinterpret_cast<uint4*>(ch + s.head);
  bool any = false;
  for (int u = lane; u < s.n_units; u += 32) {
    const int i = s.head + 4 * u;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr)
      x = aligned ? *reinterpret_cast<const uint4*>(src + i)
                  : make_uint4(src[i], src[i + 1], src[i + 2], src[i + 3]);
    __stcs(units + u, x);
    any |= (x.x | x.y | x.z | x.w) != 0u;
  }
  const int e = lane < s.head ? lane : (lane >= 4 && s.tail0 + lane - 4 < w ? s.tail0 + lane - 4 : -1);
  if (e >= 0) {
    const uint32_t x = src != nullptr ? src[e] : 0u;
    __stcs(ch + e, x);
    any |= x != 0u;
  }
  return __any_sync(0xffffffffu, any);
}

__global__ void __launch_bounds__(kThreads)
csr_step_kernel(const int32_t* __restrict__ indices, const uint32_t* __restrict__ dom,
                const int32_t* __restrict__ seg_start, const int32_t* __restrict__ seg_len,
                const int32_t* __restrict__ child_pos, const int32_t* __restrict__ depth, int n_p,
                const uint32_t* __restrict__ used, const uint32_t* __restrict__ cand,
                uint32_t* __restrict__ cand2, uint32_t* __restrict__ child,
                int32_t* __restrict__ meta, int b, int w, int mp, int deg_cap, int L) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride_w = lane_words(w, mp);
  const int half_w = round4(w + 3);
  const int l = blockIdx.x * L + warp;
  const bool mine = warp < L && l < b;  // this warp has a lane
  uint32_t* s_lane = smem + static_cast<size_t>(mine ? warp : 0) * stride_w;
  int* s_start = reinterpret_cast<int*>(s_lane + 2 * half_w);
  int* s_len = s_start + mp;
  int* s_hdr = s_len + mp;

  // the lane's segments (lengths cut at deg_cap, -1 where not real) and its
  // pivot: the shortest real one, the first of equals
  int d = -1, d_len = INT_MAX;
  bool need_base = false;
  if (mine) {
    for (int j = lane; j < mp; j += 32) {
      const size_t at = static_cast<size_t>(l) * mp + j;
      const int n = seg_len[at];
      s_start[j] = seg_start[at];
      s_len[j] = n < 0 ? -1 : min(n, deg_cap);
    }
    __syncwarp();
    for (int j = 0; j < mp; ++j) {
      const int n = s_len[j];
      if (n >= 0 && n < d_len) {
        d = j;
        d_len = n;
      }
    }
    need_base = depth[l] + 1 < n_p;  // a child is wanted if cand is not empty
    if (lane == 0) s_hdr[0] = d;
  }
  const bool has_parent = d >= 0;
  const bool is_long = need_base && has_parent && d_len > kLongWalk;
  const bool any_long = __syncthreads_or(is_long);

  const size_t lw = static_cast<size_t>(mine ? l : 0) * w;
  const RowSplit s(w, word_offset(cand + lw));
  uint32_t* sb = s_lane + word_offset(dom + static_cast<size_t>(mine ? child_pos[l] : 0) * w);
  uint32_t* sc = s_lane + half_w + word_offset(cand + lw);  // child word i: 16-byte units as cand's
  unsigned first = kNone;
  int v = -1;
  if (mine) {
    const uint32_t* c = cand + lw;
    const uint32_t* us = used + lw;
    uint32_t* c2 = cand2 + lw;
    uint32_t lowbit = 0u;
    int p_star = -1;  // the pass that holds the first nonzero word
    for (int p = 0; p < s.n_passes; ++p) {
      const int e_idx = s.edge(p, lane, w);
      Pass cv, uv;
      load_pass(c, s, p, e_idx, lane, cv);
      if (first != kNone && need_base) load_pass(us, s, p, e_idx, lane, uv);
      if (first == kNone) {
        unsigned mine_first = kNone;  // this thread's lowest nonzero word of the pass
        if (cv.e != 0u) mine_first = e_idx;
#pragma unroll
        for (int k = kUnits - 1; k >= 0; --k) {
          const int i = s.head + 4 * (p * 32 * kUnits + 32 * k + lane);
#pragma unroll
          for (int j = 3; j >= 0; --j)
            if (comp(cv.v[k], j) != 0u) mine_first = min(mine_first, static_cast<unsigned>(i + j));
        }
        first = __reduce_min_sync(0xffffffffu, mine_first);
        if (first != kNone) {
          uint32_t word = 0u;
          if (mine_first == first) {
            if (e_idx == static_cast<int>(first)) word = cv.e;
#pragma unroll
            for (int k = 0; k < kUnits; ++k) {
              const int i = s.head + 4 * (p * 32 * kUnits + 32 * k + lane);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (i + j == static_cast<int>(first)) word = comp(cv.v[k], j);
            }
          }
          const unsigned bitpos = mine_first == first ? __ffs(static_cast<int>(word)) - 1 : 31u;
          v = static_cast<int>(first) * 32 +
              static_cast<int>(__reduce_min_sync(0xffffffffu, mine_first == first ? bitpos : 31u));
          lowbit = 1u << (v & 31);
          p_star = p;
          if (need_base) {
            stage_dom(dom + static_cast<size_t>(child_pos[l]) * w, sb, w, lane);
            if (has_parent)
              for (int i = lane; i < half_w / 4; i += 32)
                reinterpret_cast<uint4*>(s_lane + half_w)[i] = make_uint4(0u, 0u, 0u, 0u);
            load_pass(us, s, p, e_idx, lane, uv);
            wait_dom();
            __syncwarp();
            for (int q = 0; q < p; ++q) {  // passes before: cand was zero there
              const int eq = s.edge(q, lane, w);
              Pass uq;
              load_pass(us, s, q, eq, lane, uq);
              base_pass(sb, uq, s, q, eq, first, 0u, lane);
            }
          }
        }
      }
      // cand2 = cand ^ bit(v): only the word that holds v changes
      uint4* c2u = reinterpret_cast<uint4*>(c2 + s.head);
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = p * 32 * kUnits + 32 * k + lane;
        if (u < s.n_units) {
          uint4 x = cv.v[k];
          if (p == p_star) {
            const int i = s.head + 4 * u;
            x.x ^= i == static_cast<int>(first) ? lowbit : 0u;
            x.y ^= i + 1 == static_cast<int>(first) ? lowbit : 0u;
            x.z ^= i + 2 == static_cast<int>(first) ? lowbit : 0u;
            x.w ^= i + 3 == static_cast<int>(first) ? lowbit : 0u;
          }
          __stcs(c2u + u, x);
        }
      }
      if (e_idx >= 0) __stcs(c2 + e_idx, cv.e ^ (e_idx == static_cast<int>(first) ? lowbit : 0u));
      if (first != kNone && need_base) base_pass(sb, uv, s, p, e_idx, first, lowbit, lane);
    }
    __syncwarp();
  }
  const bool valid = first != kNone;
  const bool want_child = valid && need_base;

  // the walk, and the child and meta rows
  const auto finish = [&]() {
    const uint32_t* src = !want_child ? nullptr : has_parent ? sc : sb;
    const bool aligned =
        src != nullptr && (reinterpret_cast<uintptr_t>(src + s.head) & 15u) == 0u;
    const bool has_child = write_child(child + lw, src, aligned, s, w, lane) && want_child;
    if (lane == 0)
      *reinterpret_cast<int4*>(meta + static_cast<size_t>(l) * 4) =
          make_int4(valid ? 1 : 0, valid ? v : -1, valid && !need_base ? 1 : 0, has_child ? 1 : 0);
  };
  if (mine && !is_long) {
    if (want_child && has_parent) {
      if (d_len <= 32)
        walk<1>(indices, s_start, s_len, mp, d, sb, sc, w);
      else
        walk<kUnroll>(indices, s_start, s_len, mp, d, sb, sc, w);
      __syncwarp();
    }
    finish();
  }
  if (any_long) {
    if (mine && lane == 0) s_hdr[1] = is_long && want_child;
    __syncthreads();
    for (int q = 0; q < L; ++q) {
      uint32_t* sq = smem + static_cast<size_t>(q) * stride_w;
      const int* hq = reinterpret_cast<const int*>(sq + 2 * half_w) + 2 * mp;
      if (blockIdx.x * L + q >= b || !hq[1]) continue;
      const int* st = reinterpret_cast<const int*>(sq + 2 * half_w);
      const size_t lq = static_cast<size_t>(blockIdx.x) * L + q;
      uint32_t* sbq = sq + word_offset(dom + static_cast<size_t>(child_pos[lq]) * w);
      uint32_t* scq = sq + half_w + word_offset(cand + lq * w);
      walk_bitmap(indices, st, st + mp, mp, hq[0], sbq, scq, w);
    }
    __syncthreads();
    if (mine && is_long) finish();
  }
}

// One launch: L lanes per block (lanes_per_block), ceil(b / L) blocks.
// Pointers are device pointers of contiguous int32 tensors; cand, used,
// cand2 and child start on a common 16-byte boundary.  Returns a CUDA error
// code (0 after a good launch).
inline int launch(const void* indices, const void* dom, const void* seg_start, const void* seg_len,
                  const void* child_pos, const void* depth, int n_p, const void* used,
                  const void* cand, void* cand2, void* child, void* meta, int b, int w, int mp,
                  int deg_cap, void* stream) {
  const int L = lanes_per_block(w, mp, b);
  if (L < 1 || w < 1 || mp < 0 || deg_cap < 1 || b < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  const size_t bytes = 4 * static_cast<size_t>(L) * lane_words(w, mp);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((b + L - 1) / L);
  csr_step_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indices), static_cast<const uint32_t*>(dom),
      static_cast<const int32_t*>(seg_start), static_cast<const int32_t*>(seg_len),
      static_cast<const int32_t*>(child_pos), static_cast<const int32_t*>(depth), n_p,
      static_cast<const uint32_t*>(used), static_cast<const uint32_t*>(cand),
      static_cast<uint32_t*>(cand2), static_cast<uint32_t*>(child), static_cast<int32_t*>(meta),
      b, w, mp, deg_cap, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace csr_step
}  // namespace
