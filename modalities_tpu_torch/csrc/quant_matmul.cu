// Fused dequant-matmul for weight-only quantized serving on Hopper (sm_90a).
//
// Replaces: modalities_tpu/ops/pallas/quant_matmul.py:_kernel (the Pallas TPU
// kernel behind ops/quant_matmul.py:quant_matmul_or_fallback).
//
// Computes y [M, N] = ((x [M, K] @ widen(wq [K, N])) * scale [N]) cast to x's
// dtype, with fp32 accumulation. wq holds one byte per weight: int8, or fp8
// e4m3 (float8_e4m3fn). x is bf16 (every dense layer) or fp32 (the untied
// head, which the model computes in fp32).
//
// What bounds it on an H100: bytes. Serving calls it with M = 1..64 rows, so
// each weight byte feeds at most 2*64 operations, far below the ~295 operations
// per byte at which the tensor cores, not memory, become the limit. One decode
// step of the 2.7B model reads ~2.54 GB of int8 weights (75.4 MB a layer x 32,
// plus the 128.8 MB head): ~0.76 ms at 3.35 TB/s, against ~1.52 ms for the
// same weights in bf16. The weight must therefore cross device memory in its
// 1-byte form and be widened on chip; dequantizing outside the matmul would
// write and re-read a full-width copy and give the saving back.
//
// Design (simple first):
// - Each CTA (4 warps) owns a [BM, 64] output tile, BM = 16 or 64, and loops
//   over K in 64-deep steps. The 64x64 weight tile is read with 16-byte loads,
//   widened to x's dtype (exact in bf16 for both formats) and stored in shared
//   memory; the x tile goes beside it.
// - bf16 x: mma.sync m16n8k16 bf16 with fp32 accumulators; the widened weight
//   is stored n-major so each B fragment is one 32-bit shared-memory read.
//   fp32 x: plain fp32 FMA on the CUDA cores (no TF32: the head stays fp32).
// - Small M leaves too few output tiles to keep enough loads in flight, so K is
//   split over `splits` CTAs (chosen by the wrapper from K and N only, never
//   from M). Each split writes fp32 partials to a workspace; a second kernel
//   sums them in split order, applies the scale and casts. Every output element
//   is accumulated in the same order whatever M is, so a row's result does not
//   depend on the other rows in the batch.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBN = 64;       // output columns per CTA
constexpr int kBK = 64;       // K depth per shared-memory stage
constexpr int kThreads = 128; // 4 warps
constexpr int kPad = 8;       // bf16 elements of row padding against bank conflicts

template <bool FP8>
__device__ __forceinline__ float widen(uint8_t b) {
  if constexpr (FP8) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  } else {
    return static_cast<float>(static_cast<int8_t>(b));
  }
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stores one finished accumulator: the epilogue (scale, cast) when K is not
// split, the raw fp32 partial otherwise.
template <typename T>
__device__ __forceinline__ void store_out(T* y, float* ws, const float* scale, int splits, int split,
                                          int m, int n, int row, int col, float acc) {
  if (row >= m || col >= n) return;
  const int64_t idx = static_cast<int64_t>(row) * n + col;
  if (splits == 1) {
    const float v = __fmul_rn(acc, scale[col]);
    if constexpr (sizeof(T) == 2) {
      y[idx] = __float2bfloat16_rn(v);
    } else {
      y[idx] = v;
    }
  } else {
    ws[static_cast<int64_t>(split) * m * n + idx] = acc;
  }
}

// bf16 x through the tensor cores. MT m16 tiles per CTA (BM = 16 * MT).
template <int MT, bool FP8>
__global__ void __launch_bounds__(kThreads)
quant_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wq,
                     const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ ws, int m, int k, int n, int splits) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) __nv_bfloat16 xs[BM][kBK + kPad];
  __shared__ __align__(16) __nv_bfloat16 wsT[kBN][kBK + kPad];  // n-major widened weights

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_base = blockIdx.x * kBN;
  const int m_base = blockIdx.y * BM;
  const int ktiles = k / kBK;
  const int kps = (ktiles + splits - 1) / splits;
  const int kt0 = blockIdx.z * kps;
  const int kt1 = min(ktiles, kt0 + kps);

  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k_base = kt * kBK;
    // x tile: BM rows x 64 bf16 = 8 16-byte vectors a row
    for (int idx = tid; idx < BM * 8; idx += kThreads) {
      const int r = idx >> 3, c8 = idx & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m_base + r < m)
        v = *reinterpret_cast<const uint4*>(x + static_cast<int64_t>(m_base + r) * k + k_base + c8 * 8);
      *reinterpret_cast<uint4*>(&xs[r][c8 * 8]) = v;
    }
    // weight tile: 64 rows (k) x 64 bytes (n) = 4 16-byte vectors a row, widened
    // and transposed into wsT[n][k]
    for (int idx = tid; idx < kBK * 4; idx += kThreads) {
      const int kr = idx >> 2, c16 = (idx & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n_base + c16 < n)
        v = *reinterpret_cast<const uint4*>(wq + static_cast<int64_t>(k_base + kr) * n + n_base + c16);
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int b = 0; b < 16; ++b) wsT[c16 + b][kr] = __float2bfloat16_rn(widen<FP8>(bytes[b]));
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bfrag[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nc = warp * 16 + j * 8 + g;
        bfrag[j][0] = *reinterpret_cast<const uint32_t*>(&wsT[nc][kk + 2 * t4]);
        bfrag[j][1] = *reinterpret_cast<const uint32_t*>(&wsT[nc][kk + 2 * t4 + 8]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t afrag[4];
        const int r0 = i * 16 + g;
        afrag[0] = *reinterpret_cast<const uint32_t*>(&xs[r0][kk + 2 * t4]);
        afrag[1] = *reinterpret_cast<const uint32_t*>(&xs[r0 + 8][kk + 2 * t4]);
        afrag[2] = *reinterpret_cast<const uint32_t*>(&xs[r0][kk + 2 * t4 + 8]);
        afrag[3] = *reinterpret_cast<const uint32_t*>(&xs[r0 + 8][kk + 2 * t4 + 8]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16_16816(acc[i][j], afrag, bfrag[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = m_base + i * 16 + g;
      const int col = n_base + warp * 16 + j * 8 + 2 * t4;
      store_out(y, ws, scale, splits, blockIdx.z, m, n, row, col, acc[i][j][0]);
      store_out(y, ws, scale, splits, blockIdx.z, m, n, row, col + 1, acc[i][j][1]);
      store_out(y, ws, scale, splits, blockIdx.z, m, n, row + 8, col, acc[i][j][2]);
      store_out(y, ws, scale, splits, blockIdx.z, m, n, row + 8, col + 1, acc[i][j][3]);
    }
}

// fp32 x on the CUDA cores. Thread t owns column t % 64 and BM/2 rows.
template <int MT, bool FP8>
__global__ void __launch_bounds__(kThreads)
quant_mm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wq,
                    const float* __restrict__ scale, float* __restrict__ y, float* __restrict__ ws,
                    int m, int k, int n, int splits) {
  constexpr int BM = 16 * MT;
  constexpr int RPT = BM / 2;  // rows per thread
  __shared__ __align__(16) float xs[BM][kBK];
  __shared__ __align__(16) float wsf[kBK][kBN];

  const int tid = threadIdx.x;
  const int n_base = blockIdx.x * kBN;
  const int m_base = blockIdx.y * BM;
  const int ktiles = k / kBK;
  const int kps = (ktiles + splits - 1) / splits;
  const int kt0 = blockIdx.z * kps;
  const int kt1 = min(ktiles, kt0 + kps);
  const int col = tid & (kBN - 1);
  const int r_base = (tid / kBN) * RPT;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k_base = kt * kBK;
    // x tile: BM rows x 64 floats = 16 16-byte vectors a row
    for (int idx = tid; idx < BM * 16; idx += kThreads) {
      const int r = idx >> 4, c4 = idx & 15;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m_base + r < m)
        v = *reinterpret_cast<const float4*>(x + static_cast<int64_t>(m_base + r) * k + k_base + c4 * 4);
      *reinterpret_cast<float4*>(&xs[r][c4 * 4]) = v;
    }
    for (int idx = tid; idx < kBK * 4; idx += kThreads) {
      const int kr = idx >> 2, c16 = (idx & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n_base + c16 < n)
        v = *reinterpret_cast<const uint4*>(wq + static_cast<int64_t>(k_base + kr) * n + n_base + c16);
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int b = 0; b < 16; ++b) wsf[kr][c16 + b] = widen<FP8>(bytes[b]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = wsf[kk][col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] = fmaf(xs[r_base + r][kk], w, acc[r]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    store_out(y, ws, scale, splits, blockIdx.z, m, n, m_base + r_base + r, n_base + col, acc[r]);
}

// Sums the split partials in split order, applies the scale and casts.
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                    T* __restrict__ y, int m, int n, int splits) {
  const int64_t mn = static_cast<int64_t>(m) * n;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = ws[i];
    for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, ws[s * mn + i]);
    const float v = __fmul_rn(acc, scale[i % n]);
    if constexpr (sizeof(T) == 2) {
      y[i] = __float2bfloat16_rn(v);
    } else {
      y[i] = v;
    }
  }
}

template <typename T, bool FP8>
void launch(const void* x, const void* wq, const float* scale, void* y, float* ws, int m, int k, int n,
            int splits, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int tiles_n = (n + kBN - 1) / kBN;
  const T* xt = static_cast<const T*>(x);
  const uint8_t* w = static_cast<const uint8_t*>(wq);
  T* yt = static_cast<T*>(y);
  if (m <= 16) {
    const dim3 grid(tiles_n, (m + 15) / 16, splits);
    if constexpr (sizeof(T) == 2) {
      quant_mm_bf16_kernel<1, FP8><<<grid, block, 0, stream>>>(xt, w, scale, yt, ws, m, k, n, splits);
    } else {
      quant_mm_f32_kernel<1, FP8><<<grid, block, 0, stream>>>(xt, w, scale, yt, ws, m, k, n, splits);
    }
  } else {
    const dim3 grid(tiles_n, (m + 63) / 64, splits);
    if constexpr (sizeof(T) == 2) {
      quant_mm_bf16_kernel<4, FP8><<<grid, block, 0, stream>>>(xt, w, scale, yt, ws, m, k, n, splits);
    } else {
      quant_mm_f32_kernel<4, FP8><<<grid, block, 0, stream>>>(xt, w, scale, yt, ws, m, k, n, splits);
    }
  }
  if (splits > 1) {
    const int64_t mn = static_cast<int64_t>(m) * n;
    const int blocks = static_cast<int>(std::min<int64_t>((mn + 255) / 256, 4096));
    split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, scale, yt, m, n, splits);
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16. w_fp8: 0 = int8, 1 = float8_e4m3fn.
// Requires K % 64 == 0, N % 16 == 0 and 16-byte aligned x and wq (the wrapper
// checks). ws holds splits * M * N floats when splits > 1 (may be null
// otherwise). Returns cudaGetLastError() right after the launches.
extern "C" int mt_quant_matmul(const void* x, const void* wq, const void* scale, void* y, void* ws,
                               int m, int k, int n, int x_dtype, int w_fp8, int splits,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  if (splits < 1 || (splits > 1 && ws == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && n > 0) {
    if (x_dtype == 1) {
      if (w_fp8) launch<__nv_bfloat16, true>(x, wq, sc, y, w, m, k, n, splits, s);
      else launch<__nv_bfloat16, false>(x, wq, sc, y, w, m, k, n, splits, s);
    } else if (x_dtype == 0) {
      if (w_fp8) launch<float, true>(x, wq, sc, y, w, m, k, n, splits, s);
      else launch<float, false>(x, wq, sc, y, w, m, k, n, splits, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
