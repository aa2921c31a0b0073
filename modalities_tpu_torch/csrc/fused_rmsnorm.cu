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
// Backward, per row (g = dy * scale, x_hat = x * r, r from the forward):
//     dx = r * (g - x_hat * mean(g * x_hat))          (stored in x's dtype)
// and the column sums dscale = sum_rows dy * x_hat, dbias = sum_rows dy in
// fp32.
//
// What bounds both on an H100: bytes. The forward reads x once and writes y
// once (at x [32768, 1536] bf16, 201 MB: 60 us at 3.35 TB/s); the backward
// reads x and dy and writes dx once (x [8192, 2560] bf16, 126 MB: 38 us).
// At the serving path's decode and prefill shapes (N in {1, 4, 8, 16, 64} at
// E = 2560) a call moves under 700 KB and its floor is launch latency.
//
// Forward, on the training paths (more than 528 rows of E > 1024, or any
// rows of E <= 1024): a warp a row. Each lane loads its 16-byte vectors of
// the row into registers, all of them before the first is used, so every warp
// has a whole row of loads in flight and an SM holds 32 warps; the output
// comes from the same registers (the row is read once). There is no barrier a
// row and no shared-memory combine, which a CTA of 256 threads a row pays on
// every row, in every thread. scale and bias go to shared memory once a CTA.
// The row's sum takes the order of the kernel this one replaced (a CTA of 256
// threads a row for E > 1024, thread t over vectors t, t + 256, ...), lane l
// keeping one sum for each of that CTA's 8 warps: the bits are the ones that
// kernel gave. That kernel stays for rows of more than 8 KB (E > 4096 bf16,
// 2048 fp32) and for calls of at most 528 rows (the serving path's decode and
// prefill), where a row on 8 warps beats a warp a row on one SM. Either way a
// row's sum depends on E only, never on N or on which warp takes the row: a
// row's result is the same alone or in a batch (the serve engine's batch
// invariance).
//
// Backward: a CTA of 256 threads a row, over the rows b, b + G, b + 2G, ...
// of the grid's G CTAs (so at any moment the CTAs read neighbouring rows),
// through a ring of shared-memory stages: one thread issues 1-D bulk copies
// (cp.async.bulk, completion on an mbarrier a stage) of the CTA's next rows
// of x and dy while the CTA reduces the current one. Every thread owns fixed
// pairs of columns (pair p = columns 2p, 2p + 1, for p = tid, tid + 256, ...):
// at E = 2560 five a thread, at E = 1536 three, all threads busy; its scale
// and its dscale and dbias sums stay in registers over all of the CTA's rows.
// A row's sum g . x_hat is each thread's over its pairs in order, the
// warp-shuffle tree, then the 8 warp sums in order through a double-buffered
// shared array: one barrier a row, after which the next copy is issued. The
// stage is read twice (the row sum, then dx and the column sums), so it is
// refilled one row later. G depends on N only (the wrapper's
// ops/rmsnorm.py:backward_grid, at most 528 CTAs: four a SM); each CTA writes
// its fp32 column partials, [G, E], and a second kernel sums them over the
// CTAs in a fixed order with many CTAs. No atomics: two calls give the same
// bits, and the bits depend on N and E only.
//
// Products and sums use explicit round-to-nearest intrinsics so the compiler
// cannot contract them into FMAs that would round differently from the plain
// PyTorch version. Rows move as 16-byte vectors or bulk copies, so
// E * sizeof(T) must be a multiple of 16 and x (and dy) 16-byte aligned (the
// wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>
#include <utility>

#include "hopper.cuh"

namespace {

constexpr int kFwdWarps = 8;     // the forward: a CTA of 8 warps, a warp a row
constexpr int kFwdCtas = 528;    // four CTAs a SM of 132; a warp walks ceil(N / (8 * CTAs)) rows or fewer
constexpr int kTeamRows = 528;   // calls of at most this many rows take the team kernel (E > 1024)
constexpr int kMaxVecs = 16;     // 16-byte vectors a lane holds: rows of up to 32 * 16 * 16 bytes (8 KB)
constexpr int kParamVecs = 32 * kMaxVecs * 8 / 4 / (kFwdWarps * 32);  // float4s of scale (E <= 4096) a thread copies
constexpr int kThreads = 256;    // the backward: a CTA, the team that reduces one row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 16;    // column pairs a thread holds: E <= 2 * 16 * 256 = 8192
constexpr int kMaxStages = 8;
constexpr int kBarBytes = kMaxStages * 8;     // the ring's mbarriers, before its stages
constexpr uint32_t kBwdRingBytes = 48 << 10;  // several rows in flight a CTA, four CTAs a SM
constexpr size_t kDefaultSmem = 48 << 10;     // dynamic shared memory a launch gets without the opt-in

template <typename T>
struct Vec;  // 16 bytes of T, held as raw bits

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x), out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z), out[3] = __uint_as_float(v.w);
  }
  __device__ static void unpack(const float4& v, float* out) { out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w; }
  __device__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]), __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    return v;
  }
};

template <typename T>
struct Pair;  // two adjacent columns

template <>
struct Pair<float> {
  __device__ static float2 load(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static void store(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
};

template <>
struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// The sum of every thread's v in a fixed order (the warp-shuffle tree, then
// the warps in order), returned to every thread. `part` is this row's half of
// a double-buffered [2][kWarps] array: the one barrier a row is inside.
__device__ __forceinline__ float row_sum(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v = __fadd_rn(v, part[w]);
  return v;
}

// f(std::integral_constant<int, NV>) for the least instantiated NV with NV * 32 >= vectors.
template <typename F>
cudaError_t by_vecs(int vecs, F&& f) {
  const int nv = (vecs + 31) / 32;
  if (nv <= 1) return f(std::integral_constant<int, 1>{});
  if (nv <= 2) return f(std::integral_constant<int, 2>{});
  if (nv <= 4) return f(std::integral_constant<int, 4>{});
  if (nv <= 6) return f(std::integral_constant<int, 6>{});
  if (nv <= 8) return f(std::integral_constant<int, 8>{});
  if (nv <= 10) return f(std::integral_constant<int, 10>{});
  if (nv <= 12) return f(std::integral_constant<int, 12>{});
  return f(std::integral_constant<int, kMaxVecs>{});
}

// f(std::integral_constant<int, KP>) for the least instantiated KP with KP * 256 >= pairs.
template <typename F>
cudaError_t by_pairs(int pairs, F&& f) {
  const int kp = (pairs + kThreads - 1) / kThreads;
  if (kp <= 1) return f(std::integral_constant<int, 1>{});
  if (kp <= 2) return f(std::integral_constant<int, 2>{});
  if (kp <= 3) return f(std::integral_constant<int, 3>{});
  if (kp <= 4) return f(std::integral_constant<int, 4>{});
  if (kp <= 5) return f(std::integral_constant<int, 5>{});
  if (kp <= 6) return f(std::integral_constant<int, 6>{});
  if (kp <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, kMaxPairs>{});
}

// ------------------------------------------------------------------ forward
// A warp a row: every lane loads its 16-byte vectors of the row (vector c =
// lane, lane + 32, ...) into registers, all before the first is used, and
// computes the output from the same registers. Warp w of CTA b takes rows
// b * 8 + w, then that plus the grid's warp count, and so on. scale and bias
// are copied into shared memory once a CTA, while the first rows' loads are
// in flight, as float4 q of vector c at h * nvec + c (h = 0, 1 for bf16's 8
// columns a vector), so a warp's 16-byte reads of them are contiguous.
//
// The row's sum of squares is the team kernel's (rms_norm_fwd_team below),
// bit for bit: for E > 1024 a CTA of 256 threads a row, thread t summing
// vectors t, t + 256, ... in order, a shuffle tree in each warp, then the 8
// warp sums in order; for E <= 1024 it was a warp a row. Here lane l plays
// thread l of each of the VW team warps: vector c = l + 32k belongs to team
// warp k % VW, and the lane keeps one sum for each; then VW shuffle trees,
// and the VW sums in order.
template <typename T, int NV, int VW>
__global__ void __launch_bounds__(kFwdWarps * 32)
rms_norm_fwd_warp(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                  T* __restrict__ y, float* __restrict__ r, int n, int e, float eps) {
  extern __shared__ float4 params[];  // scale [E] (when given), then bias [E] (when given)
  constexpr int VEC = Vec<T>::N, H = VEC / 4;
  const int lane = threadIdx.x & 31, nvec = e / VEC, warps = gridDim.x * kFwdWarps;
  float4* ssm = params;
  float4* bsm = params + (scale != nullptr ? e / 4 : 0);
  int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  uint4 v[NV];
  auto load = [&]() {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (lane + 32 * k < nvec) v[k] = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * e)[lane + 32 * k];
  };
  if (row < n) load();
  auto stage = [&](const float* src, float4* dst) {
    float4 t[kParamVecs];  // every load in flight before the first store
#pragma unroll
    for (int i = 0; i < kParamVecs; ++i) {
      const int q = threadIdx.x + i * kFwdWarps * 32;
      if (q < e / 4) t[i] = __ldg(reinterpret_cast<const float4*>(src) + q);
    }
#pragma unroll
    for (int i = 0; i < kParamVecs; ++i) {
      const int q = threadIdx.x + i * kFwdWarps * 32;
      if (q < e / 4) dst[(q % H) * nvec + q / H] = t[i];
    }
  };
  if (scale != nullptr) stage(scale, ssm);
  if (bias != nullptr) stage(bias, bsm);
  __syncthreads();
  while (row < n) {
    float acc[VW];
#pragma unroll
    for (int w = 0; w < VW; ++w) acc[w] = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < nvec) {
        float f[VEC];
        Vec<T>::unpack(v[k], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[k % VW] = __fadd_rn(acc[k % VW], __fmul_rn(f[j], f[j]));
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int w = 0; w < VW; ++w) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[w] = __fadd_rn(acc[w], __shfl_xor_sync(0xffffffffu, acc[w], off));
      ss = VW == 1 ? acc[0] : __fadd_rn(ss, acc[w]);
    }
    const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(e)), eps));
    if (lane == 0) r[row] = rr;
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<int64_t>(row) * e);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        float f[VEC], p[VEC];
        Vec<T>::unpack(v[k], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = __fmul_rn(f[j], rr);
        if (scale != nullptr) {
#pragma unroll
          for (int h = 0; h < H; ++h) Vec<float>::unpack(ssm[h * nvec + c], p + 4 * h);
#pragma unroll
          for (int j = 0; j < VEC; ++j) f[j] = __fmul_rn(f[j], p[j]);
        }
        if (bias != nullptr) {
#pragma unroll
          for (int h = 0; h < H; ++h) Vec<float>::unpack(bsm[h * nvec + c], p + 4 * h);
#pragma unroll
          for (int j = 0; j < VEC; ++j) f[j] = __fadd_rn(f[j], p[j]);
        }
        yr[c] = Vec<T>::pack(f);
      }
    }
    row += warps;
    if (row < n) load();
  }
}

// The team kernel itself: a CTA a row, the row read a second time (from L2)
// for the output. It takes rows wider than a warp holds (over 8 KB), and for
// E > 1024 a call of at most kTeamRows rows (the serving path's decode and
// prefill): there a row's work on 8 warps beats a warp a row on one SM, and
// the two kernels give the same bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_team(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                  T* __restrict__ y, float* __restrict__ r, int e, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float partial[kWarps];
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(blockIdx.x) * e);
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<int64_t>(blockIdx.x) * e);
  float ss = 0.f;
  for (int c = threadIdx.x; c < e / VEC; c += kThreads) {
    float f[VEC];
    Vec<T>::unpack(xr[c], f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
  }
  ss = row_sum(ss, partial);
  const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(e)), eps));
  if (threadIdx.x == 0) r[blockIdx.x] = rr;
  for (int c = threadIdx.x; c < e / VEC; c += kThreads) {
    float f[VEC];
    Vec<T>::unpack(xr[c], f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      f[j] = __fmul_rn(f[j], rr);
      if (scale != nullptr) f[j] = __fmul_rn(f[j], scale[c * VEC + j]);
      if (bias != nullptr) f[j] = __fadd_rn(f[j], bias[c * VEC + j]);
    }
    yr[c] = Vec<T>::pack(f);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias, void* y, float* r, int n, int e,
                       float eps, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int vecs = e / Vec<T>::N;
  if (vecs > 32 * kMaxVecs || (e > 1024 && n <= kTeamRows)) {
    rms_norm_fwd_team<T><<<n, kThreads, 0, stream>>>(xt, scale, bias, yt, r, e, eps);
    return cudaSuccess;
  }
  const int grid = std::min((n + kFwdWarps - 1) / kFwdWarps, kFwdCtas);
  const size_t smem = sizeof(float) * e * ((scale != nullptr) + (bias != nullptr));  // at most 32 KB
  return by_vecs(vecs, [&](auto nv) {
    constexpr int NV = decltype(nv)::value;
    auto kernel = e > 1024 ? rms_norm_fwd_warp<T, NV, kWarps> : rms_norm_fwd_warp<T, NV, 1>;  // the team's warps
    kernel<<<grid, kFwdWarps * 32, smem, stream>>>(xt, scale, bias, yt, r, n, e, eps);
    return cudaSuccess;
  });
}

// ----------------------------------------------------------------- backward
// CTA b takes rows b, b + G, ... (G CTAs) through a ring of `stages` stages,
// each a row of x then the same row of dy. A stage is read twice (the row
// sum, then dx), so the copy into it is issued at the next row's barrier:
// `stages - 1` rows ahead. The CTA's column sums go to row b of ds_part and
// db_part ([G, E] fp32; either may be null).
template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_ring(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ r,
                  const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ ds_part,
                  float* __restrict__ db_part, int n, int e, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  __shared__ float partial[2][kWarps];
  const int tid = threadIdx.x, pairs = e / 2;
  const int rows = (n - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;  // rows b, b + G, ...
  auto row_of = [&](int i) { return blockIdx.x + static_cast<int64_t>(i) * gridDim.x; };
  const uint32_t row_bytes = e * sizeof(T);
  auto stage = [&](int i) { return smem + kBarBytes + (i % stages) * 2 * row_bytes; };
  auto load = [&](int i) {  // this CTA's row i of x and dy into stage i % stages
    uint64_t* bar = &full[i % stages];
    const int64_t off = row_of(i) * e;
    hopper::mbar_expect(bar, 2 * row_bytes);
    hopper::bulk_load(stage(i), x + off, row_bytes, bar);
    hopper::bulk_load(stage(i) + row_bytes, dy + off, row_bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
    for (int i = 0; i < min(stages, rows); ++i) load(i);
  }
  float sc[KP][2], acc_s[KP][2], acc_b[KP][2];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = tid + k * kThreads;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[k][j] = scale != nullptr && p < pairs ? scale[2 * p + j] : 1.f;
      acc_s[k][j] = acc_b[k][j] = 0.f;
    }
  }
  float r_next = r[row_of(0)];
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < rows; ++i) {
    const float rr = r_next;
    if (i + 1 < rows) r_next = r[row_of(i + 1)];  // one row ahead
    hopper::mbar_wait(&full[i % stages], (i / stages) & 1);
    const T* xs = reinterpret_cast<const T*>(stage(i));
    const T* dys = xs + e;
    float c = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = tid + k * kThreads;
      if (p < pairs) {
        const float2 xv = Pair<T>::load(xs + 2 * p), dv = Pair<T>::load(dys + 2 * p);
        const float xh[2] = {__fmul_rn(xv.x, rr), __fmul_rn(xv.y, rr)};
        const float dd[2] = {dv.x, dv.y};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float g = scale != nullptr ? __fmul_rn(dd[j], sc[k][j]) : dd[j];
          c = __fadd_rn(c, __fmul_rn(g, xh[j]));
        }
      }
    }
    c = row_sum(c, partial[i & 1]);
    // every thread is done with row i - 1's stage: refill it
    if (tid == 0 && i > 0 && i - 1 + stages < rows) load(i - 1 + stages);
    const float mean = __fdiv_rn(c, static_cast<float>(e));
    T* dxr = dx + row_of(i) * e;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = tid + k * kThreads;
      if (p < pairs) {
        const float2 xv = Pair<T>::load(xs + 2 * p), dv = Pair<T>::load(dys + 2 * p);
        const float xh[2] = {__fmul_rn(xv.x, rr), __fmul_rn(xv.y, rr)};
        const float dd[2] = {dv.x, dv.y};
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float g = scale != nullptr ? __fmul_rn(dd[j], sc[k][j]) : dd[j];
          o[j] = __fmul_rn(rr, __fsub_rn(g, __fmul_rn(xh[j], mean)));
          acc_s[k][j] = __fadd_rn(acc_s[k][j], __fmul_rn(dd[j], xh[j]));
          acc_b[k][j] = __fadd_rn(acc_b[k][j], dd[j]);
        }
        Pair<T>::store(dxr + 2 * p, o[0], o[1]);
      }
    }
  }
  const int64_t base = static_cast<int64_t>(blockIdx.x) * e;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int p = tid + k * kThreads;
    if (p < pairs) {
      if (ds_part != nullptr) Pair<float>::store(ds_part + base + 2 * p, acc_s[k][0], acc_s[k][1]);
      if (db_part != nullptr) Pair<float>::store(db_part + base + 2 * p, acc_b[k][0], acc_b[k][1]);
    }
  }
}

// Column sums of [ctas, E] fp32 partials (blockIdx.y picks one of two
// arrays): a CTA of 16 warps a tile of 32 columns; warp w adds up the rows
// [w * chunk, (w + 1) * chunk) in order, then warp 0 adds the 16 warp sums in
// order. The order depends on ctas and E only.
constexpr int kSumCols = 32;
constexpr int kSumWarps = 16;

struct ColumnSums {
  const float* part[2];
  float* out[2];
};

__global__ void __launch_bounds__(kSumWarps * 32) column_sum_kernel(ColumnSums cs, int ctas, int e) {
  __shared__ float sums[kSumWarps][kSumCols];
  const float* part = blockIdx.y == 0 ? cs.part[0] : cs.part[1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, j = blockIdx.x * kSumCols + lane;
  const int chunk = (ctas + kSumWarps - 1) / kSumWarps, b0 = warp * chunk, b1 = min(ctas, b0 + chunk);
  float s = 0.f;
  if (j < e) {
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s = __fadd_rn(s, part[static_cast<int64_t>(b) * e + j]);
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < e) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t = __fadd_rn(t, sums[w][lane]);
    (blockIdx.y == 0 ? cs.out[0] : cs.out[1])[j] = t;
  }
}

template <typename T>
cudaError_t launch_bwd_rows(const void* x, const float* scale, const float* r, const void* dy, void* dx,
                            float* ds_part, float* db_part, int n, int e, int rows_per_cta, cudaStream_t stream) {
  const int ctas = (n + rows_per_cta - 1) / rows_per_cta;
  const uint32_t row_bytes = e * sizeof(T);
  // stages of a row of x and dy that fit the ring, at least 3: two rows in flight while one is read twice
  const int stages = static_cast<int>(std::clamp<uint32_t>(kBwdRingBytes / (2 * row_bytes), 3, kMaxStages));
  const size_t smem = kBarBytes + static_cast<size_t>(stages) * 2 * row_bytes;
  return by_pairs(e / 2, [&](auto kp) {
    auto kernel = rms_norm_bwd_ring<T, decltype(kp)::value>;
    if (smem > kDefaultSmem) {  // wide rows: a ring above the default needs the opt-in
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<ctas, kThreads, smem, stream>>>(static_cast<const T*>(x), scale, r, static_cast<const T*>(dy),
                                              static_cast<T*>(dx), ds_part, db_part, n, e, stages);
    return cudaSuccess;
  });
}

// dscale (and dbias) from the partials of those wanted (the others null).
void launch_column_sums(const float* ds_part, const float* db_part, float* dscale, float* dbias, int ctas, int e,
                        cudaStream_t stream) {
  ColumnSums cs{};
  int count = 0;
  for (auto [part, out] : {std::make_pair(ds_part, dscale), std::make_pair(db_part, dbias)}) {
    if (out != nullptr) {
      cs.part[count] = part;
      cs.out[count++] = out;
    }
  }
  if (count > 0) {
    column_sum_kernel<<<dim3((e + kSumCols - 1) / kSumCols, count), kSumWarps * 32, 0, stream>>>(cs, ctas, e);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* scale, const float* r, const void* dy, void* dx, float* dscale,
                       float* dbias, float* ws, int n, int e, int rows_per_cta, cudaStream_t stream) {
  const int ctas = (n + rows_per_cta - 1) / rows_per_cta;
  float* ds_part = dscale != nullptr ? ws : nullptr;
  float* db_part = dbias != nullptr ? ws + static_cast<int64_t>(ctas) * e : nullptr;
  const cudaError_t err = launch_bwd_rows<T>(x, scale, r, dy, dx, ds_part, db_part, n, e, rows_per_cta, stream);
  if (err != cudaSuccess) return err;
  launch_column_sums(ds_part, db_part, dscale, dbias, ctas, e, stream);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx). scale is fp32 [E] or null;
// r is the forward's fp32 [N]. dscale/dbias are fp32 [E] outputs or null
// (not wanted); ws holds 2 * ceil(N / rows_per_cta) * E floats when either
// is wanted. Requires E * sizeof(T) % 16 == 0, E <= 2 * 16 * 256 and 16-byte
// aligned x, dy, dx (the wrapper checks). Returns cudaGetLastError() after
// the launches.
extern "C" int mt_rms_norm_bwd(const void* x, const void* scale, const void* r, const void* dy, void* dx,
                               void* dscale, void* dbias, void* ws, int n, int e, int rows_per_cta, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* rr = static_cast<const float*>(r);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* w = static_cast<float*>(ws);
  if (rows_per_cta < 1 || e / 2 > kMaxPairs * kThreads || ((ds != nullptr || db != nullptr) && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    cudaError_t err;
    if (dtype == 0) {
      err = launch_bwd<float>(x, sc, rr, dy, dx, ds, db, w, n, e, rows_per_cta, s);
    } else if (dtype == 1) {
      err = launch_bwd<__nv_bfloat16>(x, sc, rr, dy, dx, ds, db, w, n, e, rows_per_cta, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
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
    cudaError_t err;
    if (dtype == 0) {
      err = launch_fwd<float>(x, sc, bi, y, rr, n, e, eps, s);
    } else if (dtype == 1) {
      err = launch_fwd<__nv_bfloat16>(x, sc, bi, y, rr, n, e, eps, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
