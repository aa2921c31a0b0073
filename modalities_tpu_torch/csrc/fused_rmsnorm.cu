// Fused RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: modalities_tpu/ops/pallas/fused_rmsnorm.py:_fwd_kernel and
// _bwd_kernel (the Pallas TPU kernels behind ops/rmsnorm.py:rms_norm_or_fallback
// and the custom_vjp of fused_rms_norm).
//
// Computes, per row of x [N, E]:
//     r = rsqrt(mean(x^2) + eps)                       (fp32)
//     y = (x * r) * scale + bias                       (fp32 math, stored in x's dtype)
// and writes r [N] in fp32: it is the residual the backward kernel reads.
// scale and bias are fp32 [E] and may be null, meaning identity.
//
// What bounds it on an H100: bytes. It reads x once (plus scale/bias) and
// writes y and r once; at E = 2560 that is ~10 KB per bf16 row. The serving
// path calls it with N = 8 rows at decode and N in {64, 16, 4, 1} at prefill,
// so one call moves well under 200 KB: 0.06 us at 3.35 TB/s, far below the
// ~2-4 us it takes to launch a kernel. Its floor at those shapes is launch
// latency, not bandwidth.
//
// Design: one CTA of 256 threads per row for E > 1024 (warp-shuffle partial
// sums, then a shared-memory combine in a fixed order, so a row's result never
// depends on the other rows); one warp per row, four rows per CTA, for
// E <= 1024. x and y move in 16-byte vectors, so E must be a multiple of 16
// bytes and x 16-byte aligned (the wrapper checks and raises otherwise); the
// second pass re-reads the row from L1/L2, not from device memory. Products and sums use explicit
// round-to-nearest intrinsics so the compiler cannot contract them into FMAs
// that would round differently from the plain PyTorch version.
//
// Backward, per row (g = dy * scale, x_hat = x * r, r from the forward):
//     dx = r * (g - x_hat * mean(g * x_hat))          (stored in x's dtype)
// and the column sums dscale = sum_rows dy * x_hat, dbias = sum_rows dy in
// fp32. Bounded by bytes as well: it reads x and dy and writes dx once (at
// the training shape, 8192 rows of 2560 bf16, ~126 MB: ~38 us at 3.35 TB/s).
// A CTA of 256 threads owns a block of rows; each thread keeps its columns of
// the current row in registers between the row reduction and the dx pass, and
// accumulates its columns' dscale/dbias over the block's rows in registers.
// The block writes one row of fp32 partials [n_blocks, E]; a second kernel
// sums them over the blocks in block order. No atomics: two calls give the
// same bits, and the row-block size depends on N only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Vec;  // 16 bytes of T

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void store(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// WARPS: warps that share one row (1 = warp per row, blockDim.y rows per CTA).
template <typename T, int WARPS>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                    const float* __restrict__ bias, T* __restrict__ y,
                                    float* __restrict__ r, int n, int e, float eps) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (WARPS == 1 && row >= n) return;  // warp-per-row CTAs may overhang N
  const int tid = threadIdx.x;  // 0 .. 32*WARPS-1 within the row
  const int threads = 32 * WARPS;
  const T* xr = x + static_cast<int64_t>(row) * e;
  T* yr = y + static_cast<int64_t>(row) * e;
  constexpr int VEC = Vec<T>::N;

  float ss = 0.f;
  for (int i = tid * VEC; i < e; i += threads * VEC) {
    float v[VEC];
    Vec<T>::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if constexpr (WARPS > 1) {
    __shared__ float partial[WARPS];
    if ((tid & 31) == 0) partial[tid >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ss = __fadd_rn(ss, partial[w]);  // same order in every thread
  }
  const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(e)), eps));
  if (tid == 0) r[row] = rr;

  for (int i = tid * VEC; i < e; i += threads * VEC) {
    float v[VEC];
    Vec<T>::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float o = __fmul_rn(v[j], rr);
      if (scale != nullptr) o = __fmul_rn(o, scale[i + j]);
      if (bias != nullptr) o = __fadd_rn(o, bias[i + j]);
      v[j] = o;
    }
    Vec<T>::store(yr + i, v);
  }
}

template <typename T>
void launch(const void* x, const float* scale, const float* bias, void* y, float* r, int n, int e,
            float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (e > 1024) {
    constexpr int kWarps = 8;  // one 256-thread CTA per row
    rms_norm_fwd_kernel<T, kWarps><<<n, dim3(32 * kWarps, 1), 0, stream>>>(xt, scale, bias, yt, r, n, e, eps);
  } else {
    constexpr int kRows = 4;  // one warp per row, four rows per CTA
    rms_norm_fwd_kernel<T, 1><<<(n + kRows - 1) / kRows, dim3(32, kRows), 0, stream>>>(
        xt, scale, bias, yt, r, n, e, eps);
  }
}

constexpr int kBwdThreads = 256;
constexpr int kBwdSweeps = 4;  // 16-byte vectors a thread holds per row: E <= 4 * 256 * VEC

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ r,
                    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ds_part,
                    float* __restrict__ db_part, int n, int e, int rows_per_block) {
  constexpr int VEC = Vec<T>::N;
  constexpr int WARPS = kBwdThreads / 32;
  __shared__ float partial[2][WARPS];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);
  float acc_s[kBwdSweeps][VEC], acc_b[kBwdSweeps][VEC];
#pragma unroll
  for (int k = 0; k < kBwdSweeps; ++k)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc_s[k][j] = acc_b[k][j] = 0.f;

  for (int row = row0; row < row1; ++row) {
    const T* xr = x + static_cast<int64_t>(row) * e;
    const T* dyr = dy + static_cast<int64_t>(row) * e;
    const float rr = r[row];
    float xh[kBwdSweeps][VEC], gg[kBwdSweeps][VEC], dyv[kBwdSweeps][VEC];
    float c = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdSweeps; ++k) {
      const int i = (tid + k * kBwdThreads) * VEC;
      if (i < e) {
        Vec<T>::load(xr + i, xh[k]);
        Vec<T>::load(dyr + i, dyv[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          xh[k][j] = __fmul_rn(xh[k][j], rr);
          gg[k][j] = scale != nullptr ? __fmul_rn(dyv[k][j], scale[i + j]) : dyv[k][j];
          c = __fadd_rn(c, __fmul_rn(gg[k][j], xh[k][j]));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, off));
    float* part = partial[row & 1];  // double-buffered: one barrier a row
    if ((tid & 31) == 0) part[tid >> 5] = c;
    __syncthreads();
    c = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c = __fadd_rn(c, part[w]);  // same order in every thread
    const float mean = __fdiv_rn(c, static_cast<float>(e));
    T* dxr = dx + static_cast<int64_t>(row) * e;
#pragma unroll
    for (int k = 0; k < kBwdSweeps; ++k) {
      const int i = (tid + k * kBwdThreads) * VEC;
      if (i < e) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o[j] = __fmul_rn(rr, __fsub_rn(gg[k][j], __fmul_rn(xh[k][j], mean)));
          acc_s[k][j] = __fadd_rn(acc_s[k][j], __fmul_rn(dyv[k][j], xh[k][j]));
          acc_b[k][j] = __fadd_rn(acc_b[k][j], dyv[k][j]);
        }
        Vec<T>::store(dxr + i, o);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kBwdSweeps; ++k) {
    const int i = (tid + k * kBwdThreads) * VEC;
    if (i < e) {
      const int64_t base = static_cast<int64_t>(blockIdx.x) * e + i;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (ds_part != nullptr) ds_part[base + j] = acc_s[k][j];
        if (db_part != nullptr) db_part[base + j] = acc_b[k][j];
      }
    }
  }
}

// Column sums of the [n_blocks, E] partials, in block order.
__global__ void column_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int n_blocks, int e) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= e) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s = __fadd_rn(s, part[static_cast<int64_t>(b) * e + j]);
  out[j] = s;
}

template <typename T>
void launch_bwd(const void* x, const float* scale, const float* r, const void* dy, void* dx, float* dscale,
                float* dbias, float* ws, int n, int e, int rows_per_block, cudaStream_t stream) {
  const int n_blocks = (n + rows_per_block - 1) / rows_per_block;
  float* ds_part = dscale != nullptr ? ws : nullptr;
  float* db_part = dbias != nullptr ? ws + static_cast<int64_t>(n_blocks) * e : nullptr;
  rms_norm_bwd_kernel<T><<<n_blocks, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, r, static_cast<const T*>(dy), static_cast<T*>(dx), ds_part, db_part, n, e,
      rows_per_block);
  const int grid = (e + 255) / 256;
  if (dscale != nullptr) column_sum_kernel<<<grid, 256, 0, stream>>>(ds_part, dscale, n_blocks, e);
  if (dbias != nullptr) column_sum_kernel<<<grid, 256, 0, stream>>>(db_part, dbias, n_blocks, e);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx). scale is fp32 [E] or null;
// r is the forward's fp32 [N]. dscale/dbias are fp32 [E] outputs or null
// (not wanted); ws holds 2 * ceil(N / rows_per_block) * E floats when either
// is wanted. Requires E * sizeof(T) % 16 == 0, E <= 1024 * (16 / sizeof(T))
// and 16-byte aligned x, dy, dx (the wrapper checks). Returns
// cudaGetLastError() after the launches.
extern "C" int mt_rms_norm_bwd(const void* x, const void* scale, const void* r, const void* dy, void* dx,
                               void* dscale, void* dbias, void* ws, int n, int e, int rows_per_block, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* rr = static_cast<const float*>(r);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* w = static_cast<float*>(ws);
  if (rows_per_block < 1 || ((ds != nullptr || db != nullptr) && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (dtype == 0) {
      launch_bwd<float>(x, sc, rr, dy, dx, ds, db, w, n, e, rows_per_block, s);
    } else if (dtype == 1) {
      launch_bwd<__nv_bfloat16>(x, sc, rr, dy, dx, ds, db, w, n, e, rows_per_block, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. Requires E * sizeof(T) % 16 == 0 and a
// 16-byte aligned x (the wrapper checks). Returns cudaGetLastError() right
// after the launch, so a refused launch is reported to the caller.
extern "C" int mt_rms_norm_fwd(const void* x, const void* scale, const void* bias, void* y, void* r,
                               int n, int e, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* rr = static_cast<float*>(r);
  if (n > 0) {
    if (dtype == 0) {
      launch<float>(x, sc, bi, y, rr, n, e, eps, s);
    } else if (dtype == 1) {
      launch<__nv_bfloat16>(x, sc, bi, y, rr, n, e, eps, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
