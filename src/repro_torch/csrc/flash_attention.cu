// flash_attention: causal attention forward over a flattened batch·head axis,
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b, j] / sqrt(d)) v[b, j],  j <= i,
// with query and key positions both counted from 0 (also when S != S_kv).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel), whose grid (BH, S/bq, S_kv/bk) ran in order and carried the
// online-softmax state (running max m, denominator l, accumulator) in VMEM
// scratch from one KV block to the next.  Here one block of 256 threads owns
// one (bh, 64-row query tile) and walks the KV tiles itself, so the carry
// stays in registers; blocks run in any order.  Per KV tile:
//   - K and V (64 keys) are staged in shared memory as fp32; the query tile
//     is staged once.  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i
//     and key columns tx + 16 j (i, j < 4) of the 64 x 64 score tile;
//   - scores, m and l are fp32; masked entries (key past the query, or past
//     S_kv) get weight 0; row max and row sum are shuffle reductions over
//     the 16 lanes that share a row;
//   - the accumulator (rows ty + 16 i, columns tx + 16 j of d) is rescaled
//     by exp(m_old - m_new) and takes P V from P staged in shared memory.
// The output is acc / max(l, 1e-30) in q's dtype.  KV tiles wholly above the
// diagonal are skipped (they add nothing; the TPU kernel runs them).  Ragged
// S and S_kv are masked inside the kernel, so no padding is needed.  Inputs
// are fp32 or bf16 (converted to fp32 on load), d <= 256.
//
// Bound: operations.  The work is QK^T and PV over the causal triangle,
// 2 * BH * d * S * (S + 1) FLOPs (for S == S_kv); the bytes (q, k, v read
// once, out written once) are far fewer.  The floor is that count at the
// card's dense bf16 tensor-core rate (989 TFLOP/s), or at the fp32 rate for
// fp32 inputs.  This first kernel runs its products as fp32 FMAs on the CUDA
// cores from shared memory (at most the 67 TFLOP/s fp32 rate), so it stays
// well above the bf16 floor; wgmma, TMA and warp specialisation are later work.
#include <cstdint>
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
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

}  // namespace

// q [bh, s, d], k and v [bh, s_kv, d], out [bh, s, d]: device pointers of
// contiguous tensors, all fp32 (is_bf16 == 0) or all bf16; 1 <= d <= 256,
// bh * ceil(s / 64) < 2^31.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without launching, for arguments outside that).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int bh, int s, int s_kv, int d, int is_bf16, float scale,
                                      void* stream) {
  if (bh <= 0 || s <= 0 || s_kv < 0 || d < 1 || d > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, bh, s, s_kv, d, scale, st)
                                  : dispatch<float>(q, k, v, out, bh, s, s_kv, d, scale, st));
}
