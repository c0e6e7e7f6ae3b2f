// flash_attention: causal attention forward over a flattened batch·head axis,
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b, j] / sqrt(d)) v[b, j],  j <= i,
// with query and key positions both counted from 0 (also when S != S_kv).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel), whose grid (BH, S/bq, S_kv/bk) ran in order and carried the
// online-softmax state (running max m, denominator l, accumulator) in VMEM
// scratch from one KV block to the next.  Here a block owns one (bh, query
// tile) and walks the KV tiles itself, so the carry stays in registers;
// blocks run in any order, the latest (heaviest) query tiles first.  Scores,
// m and l are fp32; masked entries (key past the query, or past S_kv) get
// weight 0, which also holds a row whose first tile is wholly masked; KV
// tiles wholly above the diagonal are neither loaded nor run (the TPU kernel
// runs them).  The output is acc / max(l, 1e-30) in q's dtype.  Two routes:
//
// bf16 (tc::flash_attention_tc): Hopper's tensor cores.  A block of three
// warpgroups owns 128 query rows.  The query tiles of one head are launched
// side by side (latest first), so the blocks on the card at once share a
// few heads' K and V in L2; with the heaviest tiles of every head first, as
// the fp32 route runs, each block would read its own head's K and V from
// device memory (4.4 GB at the served shape, 1.3 ms at 3.35 TB/s).
// Warpgroup 0 produces: one thread issues TMA loads of the Q tile (once)
// and of 128-key K and V tiles (64 keys at d = 256) into a two-stage ring in
// shared memory, K and V of each stage guarded by their own full and empty
// mbarriers; the warpgroup gives its registers up (setmaxnreg).
// Warpgroups 1 and 2 consume, 64 rows each:
//   - S = Q K^T by wgmma m64nBKk16, both operands read from shared memory in
//     the 128-byte swizzle TMA writes (a bf16 row of d = 128 takes two
//     64-column boxes);
//   - online softmax in registers: row max over the four lanes that share a
//     row, O rescaled by exp(m_old - m_new), only the diagonal tile and the
//     ragged end masked.  It runs while the tensor cores still work on the
//     previous tile's P V, issued together with this tile's Q K^T;
//   - O += P V by wgmma with A = P from registers: the fp32 accumulator
//     fragment of S, converted to bf16 in registers, is the A fragment of
//     the second product.  P goes in as two bf16 terms, hi = bf16(P) and
//     lo = bf16(P - hi), two products on the same V: one term (P to 2^-9)
//     misses K9's gate on the served layers, where large values of v
//     cancel (805-1,042 elements per layer, up to 4.5x the tolerance).  V's
//     tile [keys, d] is MN-major for B and is read transposed by the
//     instruction, never in memory.  The denominator l sums the fp32 P;
//   - epilogue: O / l in bf16, staged in the warpgroup's own rows of the Q
//     tile and written by a TMA store.
// The tensor maps are 3-D (column, row, bh) and carry the real S and S_kv,
// so TMA zero-fills past them (and past the head width) instead of reading
// the next head.  They are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda.  TMA needs a row stride of a multiple of 16 bytes:
// d % 8 == 0 here, and the wrapper zero-pads other head widths.
//
// fp32 (flash_attention_kernel): the CUDA cores, unchanged.  fp32 inputs on
// the tensor cores would run in TF32 (about three decimal digits), which
// misses K9's fp32 gate of 1e-5 and the fp32 decode-against-prefill checks.
// One 256-thread block owns one (bh, 64-row query tile); per KV tile:
//   - K and V (64 keys) are staged in shared memory as fp32; the query tile
//     is staged once.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i
//     and key columns tx + 16 j (i, j < 4) of the 64 x 64 score tile;
//   - row max and row sum are shuffle reductions over the 16 lanes that
//     share a row;
//   - the accumulator (rows ty + 16 i, columns tx + 16 j of d) is rescaled
//     by exp(m_old - m_new) and takes P V from P staged in shared memory.
//
// Bound: operations.  The work is QK^T and PV over the causal triangle,
// 2 * BH * d * S * (S + 1) FLOPs (for S == S_kv); the bytes (q, k, v read
// once, out written once) are far fewer.  bf16: that count at the dense bf16
// tensor-core rate (989 TFLOP/s); the two-term P V makes the tensor cores
// run 1.5x that count.  The wgmma route reaches the tensor cores;
// TMA and the ring keep the next tile's loads in flight under this tile's
// math, a warpgroup's softmax runs under its own P V, and the two consumer
// warpgroups fill each other's gaps.  Not done yet: ping-pong ordering of
// the two consumers (named barriers that take turns on the tensor cores),
// and the exp2 work a polynomial could move off the MUFU unit.  fp32: the same
// count at the CUDA cores' fp32 rate (67 TFLOP/s); that kernel stages tiles
// synchronously and runs fp32 FMAs from shared memory.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr int kLdP = kBK + 1;  // padded row of the P tile (no bank conflicts)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Rows [0, n) of a row-major [*, d] matrix into a [64, ld] fp32 tile, columns
// [0, cols); zero past row n or column d.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int cols, const T* src, int d,
                                          int n) {
  for (int e = threadIdx.x; e < kBK * cols; e += kThreads) {
    const int r = e / cols, c = e - r * cols;
    dst[r * ld + c] = (r < n && c < d) ? to_float(src[static_cast<size_t>(r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one block: the query and key tiles [64][ld], the value
// tile [64][DMAX] and the P tile [64][kLdP], all fp32.
__host__ __device__ constexpr int ld_qk(int d) { return d | 1; }  // odd: no bank conflicts
__host__ __device__ constexpr size_t smem_bytes(int d, int dmax) {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * ld_qk(d)
                          + static_cast<size_t>(kBK) * dmax + static_cast<size_t>(kBQ) * kLdP);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int bh, int s, int s_kv,
                       int d, float scale) {
  extern __shared__ float smem[];
  const int ld = ld_qk(d);
  float* qs = smem;
  float* ks = qs + kBQ * ld;
  float* vs = ks + kBK * ld;
  float* ps = vs + kBK * DMAX;

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int b = blockIdx.x % bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bh) * kBQ;  // longest rows first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* kb = k + static_cast<size_t>(b) * s_kv * d;
  const T* vb = v + static_cast<size_t>(b) * s_kv * d;
  load_tile(qs, ld, d, q + (static_cast<size_t>(b) * s + q0) * d, d, min(kBQ, s - q0));

  float m[kRows], l[kRows], acc[kRows][DMAX / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) acc[i][c] = 0.f;
  }

  // keys past the tile's last real row are masked for every row of it
  const int k_end = min(s_kv, min(s, q0 + kBQ));
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int nk = min(kBK, s_kv - k0);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile(ks, ld, d, kb + static_cast<size_t>(k0) * d, d, nk);
    load_tile(vs, DMAX, DMAX, vb + static_cast<size_t>(k0) * d, d, nk);
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = qi < s && kj < s_kv && kj <= qi;
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) {
        const float x = vs[kk * DMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * s + qi) * d;
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(o + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                   int s_kv, int d, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(DMAX, DMAX)));
  if (attr != cudaSuccess) return attr;
  const unsigned blocks = static_cast<unsigned>(bh) * ((s + kBQ - 1) / kBQ);
  flash_attention_kernel<T, DMAX><<<blocks, kThreads, smem_bytes(d, DMAX), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), bh, s, s_kv, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                     int s_kv, int d, float scale, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, out, bh, s, s_kv, d, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, bh, s, s_kv, d, scale, stream);
  return launch<T, 256>(q, k, v, out, bh, s, s_kv, d, scale, stream);
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA (sm_90a)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kStages = 2;     // K/V ring depth
constexpr int kBoxCols = 64;   // bf16 columns per TMA box: one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kProducerRegs = 24;   // setmaxnreg: 128 * 24 + 256 * 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, from a 1,024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes and is applied to address bits):
// the Q tile, kStages K tiles, kStages V tiles, then the mbarriers.  Each tile
// is DP / 64 boxes of [rows][64 columns], as TMA writes them.
template <int DP>
struct Layout {
  static constexpr int BK = DP == 256 ? 64 : 128;  // keys per tile
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;  // one K or one V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  // mbarriers: q_full, then per stage full_k, full_v, empty_k, empty_v
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
};
static_assert(Layout<128>::kSmem <= 232448 && Layout<256>::kSmem <= 232448, "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (column, row, bh) into shared memory; the
// barrier's transaction count falls by the box's bytes when it lands.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int col, int row,
                                          int b) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(col), "r"(row), "r"(b)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n committed groups of products are still running
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).  K-major operands (Q, K) use only
// the stride: 1,024 bytes from one 8-row group to the next.  The MN-major V
// also uses the leading offset: from one 64-column box to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

#define ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B^T, m64n64k16: A (64 x 16) and B (64 x 16), both K-major in shared
// memory; accumulate == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B^T, m64n128k16: A (64 x 16) and B (128 x 16), both K-major in shared
// memory; accumulate == 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16: A (64 x 16) from registers, B (16 x 64) MN-major in shared
// memory (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n128k16: A (64 x 16) from registers, B (16 x 128) MN-major in shared
// memory (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n256k16: A (64 x 16) from registers, B (16 x 256) MN-major in shared
// memory (imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

// S = Q K^T for one consumer warpgroup: DP / 16 steps of 16 columns of d
template <int BK, int DP>
__device__ __forceinline__ void qk(float (&sc)[BK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // step kk lies in box kk / 4, 32 bytes further along its 128-byte rows
    const uint64_t da = smem_desc(q_rows + (kk / 4) * (kBQ * kRowBytes) + (kk % 4) * 32, 16, 1024);
    const uint64_t db = smem_desc(k_tile + (kk / 4) * (BK * kRowBytes) + (kk % 4) * 32, 16, 1024);
    if constexpr (BK == 128) {
      wgmma_ss_n128(sc, da, db, kk);
    } else {
      wgmma_ss_n64(sc, da, db, kk);
    }
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&o)[DP / 2], const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(o, a, db);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n256(o, a, db);
  }
}

// O += P V for one consumer warpgroup: BK / 16 steps of 16 keys, each
// taking P's two terms (see to_a_fragments) against the same V rows
template <int BK, int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2], const uint32_t (&hi)[BK / 4],
                                   const uint32_t (&lo)[BK / 4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = smem_desc(v_tile + kk * 16 * kRowBytes, BK * kRowBytes, 1024);
    wgmma_rs<DP>(o, hi + 4 * kk, db);
    wgmma_rs<DP>(o, lo + 4 * kk, db);
  }
}

// Online softmax of one score tile (keys from k0) for this thread's rows,
// query positions row and row + 8, in place: masks if asked (masked scores
// become -inf, so their weight exp2(-inf) is exactly 0), updates the running
// max m and this thread's share of the denominator l, leaves P (fp32) in sc
// and returns the factors alpha that rescale O.  l sums P in fp32.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], bool mask, int k0, int row,
                                             int c2, int s_kv, float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int c = k0 + 8 * i + c2;
      if (c > row || c >= s_kv) sc[4 * i] = -INFINITY;
      if (c + 1 > row || c + 1 >= s_kv) sc[4 * i + 1] = -INFINITY;
      if (c > row + 8 || c >= s_kv) sc[4 * i + 2] = -INFINITY;
      if (c + 1 > row + 8 || c + 1 >= s_kv) sc[4 * i + 3] = -INFINITY;
    }
  }
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  alpha[0] = ex2((m[0] - mx0) * scale_log2);
  alpha[1] = ex2((m[1] - mx1) * scale_log2);
  m[0] = mx0;
  m[1] = mx1;
  const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    sc[4 * i] = ex2(fmaf(sc[4 * i], scale_log2, -ms0));
    sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], scale_log2, -ms0));
    sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], scale_log2, -ms1));
    sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], scale_log2, -ms1));
    sum0 += sc[4 * i] + sc[4 * i + 1];
    sum1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  l[0] = l[0] * alpha[0] + sum0;
  l[1] = l[1] * alpha[1] + sum1;
}

// P (fp32, in S's accumulator fragment) as the A operand of O += P V, in
// two bf16 terms: hi = bf16(P) and lo = bf16(P - hi), so that P V = hi V +
// lo V keeps P to about 2^-17 (one bf16 term, 2^-9, misses K9's gate where
// large values of v cancel).  S's fragment for keys [16 j, 16 j + 16)
// (blocks 2 j, 2 j + 1) is, pair by pair, the A-register fragment of step j,
// [4 j .. 4 j + 4) of hi and of lo.
template <int BK>
__device__ __forceinline__ void to_a_fragments(const float (&p)[BK / 2], uint32_t (&hi)[BK / 4],
                                               uint32_t (&lo)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = bf16x2(p[2 * i] - hf.x, p[2 * i + 1] - hf.y);
  }
}

// O *= alpha, row by row
template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    o[4 * i] *= alpha[0];
    o[4 * i + 1] *= alpha[0];
    o[4 * i + 2] *= alpha[1];
    o[4 * i + 3] *= alpha[1];
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                   int bh, int s, int s_kv, float scale_log2) {
  using L = Layout<DP>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBars;
  auto full_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto full_v = [&](int st) { return bar_q + 8u * (1 + kStages + st); };
  auto empty_k = [&](int st) { return bar_q + 8u * (1 + 2 * kStages + st); };
  auto empty_v = [&](int st) { return bar_q + 8u * (1 + 3 * kStages + st); };

  // the query tiles of one head are neighbours, latest (longest rows) first,
  // so the blocks running at once share a few heads' K and V in L2
  const int n_qt = (s + kBQ - 1) / kBQ;
  const int b = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x % n_qt)) * kBQ;
  // keys past the tile's last real row are masked for every row of it
  const int k_end = min(s_kv, min(s, q0 + kBQ));
  const int n_kv = (k_end + BK - 1) / BK;  // tiles t = 0.. hold keys from (n_kv - 1 - t) * BK

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 8);  // one arrival per consumer warp
      mbar_init(empty_v(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load; the others only
    // give their registers up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(sq + c * (kBQ * kRowBytes), &tq, bar_q, c * kBoxCols, q0, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % kStages, k0 = (n_kv - 1 - t) * BK;
        const int free = ((t / kStages) & 1) ^ 1;  // a fresh ring passes at once
        mbar_wait(empty_k(st), free);
        mbar_expect_tx(full_k(st), L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(sk + st * L::kKVBytes + c * (BK * kRowBytes), &tk, full_k(st), c * kBoxCols,
                   k0, b);
        }
        mbar_wait(empty_v(st), free);
        mbar_expect_tx(full_v(st), L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(sv + st * L::kKVBytes + c * (BK * kRowBytes), &tv, full_v(st), c * kBoxCols,
                   k0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: tile rows [64 cw, 64 cw + 64)
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  // Accumulator fragment (S and O alike): this thread holds rows r and r + 8
  // of the warpgroup's 64, columns 8 i + c2 and 8 i + c2 + 1 of every
  // 8-column block i, as x[4 i], x[4 i + 1] (row r) and x[4 i + 2], x[4 i + 3]
  // (row r + 8).
  const int r = warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  const int row = q0 + 64 * cw + r;  // query positions row and row + 8
  const uint32_t q_rows = sq + cw * (64 * kRowBytes);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // m: running row max of the raw scores; l: this thread's share of the
  // denominator (the quad's four shares are summed at the end)
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[BK / 2];
  uint32_t pa[BK / 4], pb[BK / 4];  // P of the tile whose P V is issued next: hi, lo
  auto k0_of = [&](int t) { return (n_kv - 1 - t) * BK; };
  // the diagonal tile(s) and the ragged end of the keys need masks
  auto masked = [&](int k0) { return k0 + BK - 1 > q0 + 64 * cw || k0 + BK > s_kv; };
  auto release = [&](uint32_t bar) {  // this warp no longer reads the buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  mbar_wait(bar_q, 0);
  if (n_kv > 0) {
    mbar_wait(full_k(0), 0);
    wgmma_fence();
    qk<BK, DP>(sc, q_rows, sk);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    release(empty_k(0));
    softmax_tile<BK>(sc, masked(k0_of(0)), k0_of(0), row, c2, s_kv, scale_log2, m, l,
                     alpha);  // O is still 0: alpha is not needed
    to_a_fragments<BK>(sc, pa, pb);
  }
  // Tile t's S = Q K^T is issued together with tile t - 1's O += P V, and
  // tile t's softmax runs while that product is still on the tensor cores.
  for (int t = 1; t < n_kv; ++t) {
    const int st = t % kStages, prev = (t - 1) % kStages;
    mbar_wait(full_k(st), (t / kStages) & 1);
    mbar_wait(full_v(prev), ((t - 1) / kStages) & 1);
    pin(o);
    wgmma_fence();  // o, pa and pb were written by ordinary instructions
    qk<BK, DP>(sc, q_rows, sk + st * L::kKVBytes);
    wgmma_commit();
    pv<BK, DP>(o, pa, pb, sv + prev * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<1>();  // S is in; P V may still run
    pin(sc);
    release(empty_k(st));
    softmax_tile<BK>(sc, masked(k0_of(t)), k0_of(t), row, c2, s_kv, scale_log2, m, l, alpha);
    wgmma_wait<0>();
    pin(o);
    pin(pa);  // read by the product until here
    pin(pb);
    release(empty_v(prev));
    rescale<DP>(o, alpha);
    to_a_fragments<BK>(sc, pa, pb);
  }
  if (n_kv > 0) {
    const int last = (n_kv - 1) % kStages;
    mbar_wait(full_v(last), ((n_kv - 1) / kStages) & 1);
    pin(o);
    wgmma_fence();
    pv<BK, DP>(o, pa, pb, sv + last * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
  }

  // Epilogue: O / max(l, 1e-30) in bf16, staged in this warpgroup's own rows
  // of the Q tile (read by no product any more) in the same swizzled boxes,
  // then stored by TMA, which drops rows past S and columns past d.
  const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const uint32_t box = q_rows + (i / 8) * (kBQ * kRowBytes);
    const uint32_t chunk = static_cast<uint32_t>(((i % 8) ^ (r & 7)) << 4) + 2 * c2;
    const uint32_t lo = bf16x2(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    const uint32_t hi = bf16x2(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(box + r * kRowBytes + chunk), "r"(lo)
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(box + (r + 8) * kRowBytes + chunk), "r"(hi)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (tid == 0 && q0 + 64 * cw < s) {
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_store(&to, q_rows + c * (kBQ * kRowBytes), c * kBoxCols, q0 + 64 * cw, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of a contiguous bf16 [bh, rows, d] array, boxes of 64 columns x
// box_rows rows x 1, 128-byte swizzle; reads past rows or d are zero-filled
// (a 2-D map would read the next head's rows instead).
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d, int rows, int bh,
            int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBoxCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                   int s_kv, int d, float scale, cudaStream_t stream) {
  using L = Layout<DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return attr;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  // with no keys nothing is loaded from K or V, but a map needs an array
  const void* kp = s_kv > 0 ? k : q;
  const void* vp = s_kv > 0 ? v : q;
  const int rows_kv = s_kv > 0 ? s_kv : s;
  CUtensorMap mq, mk, mv, mo;
  if (!encode(fn, &mq, q, d, s, bh, kBQ) || !encode(fn, &mk, kp, d, rows_kv, bh, L::BK) ||
      !encode(fn, &mv, vp, d, rows_kv, bh, L::BK) || !encode(fn, &mo, out, d, s, bh, 64)) {
    return cudaErrorInvalidValue;
  }
  const unsigned blocks = static_cast<unsigned>(bh) * ((s + kBQ - 1) / kBQ);
  flash_attention_tc<DP><<<blocks, kThreads, L::kSmem, stream>>>(mq, mk, mv, mo, bh, s, s_kv,
                                                                  scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s,
                     int s_kv, int d, float scale, cudaStream_t stream) {
  if (d <= 64) return launch<64>(q, k, v, out, bh, s, s_kv, d, scale, stream);
  if (d <= 128) return launch<128>(q, k, v, out, bh, s, s_kv, d, scale, stream);
  return launch<256>(q, k, v, out, bh, s, s_kv, d, scale, stream);
}

}  // namespace tc

}  // namespace

// q [bh, s, d], k and v [bh, s_kv, d], out [bh, s, d]: device pointers of
// contiguous tensors, all fp32 (is_bf16 == 0) or all bf16; 1 <= d <= 256,
// bh * ceil(s / 64) < 2^31.  bf16 also needs d % 8 == 0 and pointers
// aligned to 16 bytes (TMA); scale is the softmax scale (1 / sqrt of the
// real head width, which for bf16 may be less than d).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for arguments outside that).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int bh, int s, int s_kv, int d, int is_bf16, float scale,
                                      void* stream) {
  if (bh <= 0 || s <= 0 || s_kv < 0 || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
    if (d % 8 != 0 || any % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::dispatch(q, k, v, out, bh, s, s_kv, d, scale, st));
  }
  return static_cast<int>(dispatch<float>(q, k, v, out, bh, s, s_kv, d, scale, st));
}
