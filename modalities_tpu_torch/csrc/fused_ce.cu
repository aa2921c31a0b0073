// Fused (vocab-streaming) cross entropy for Hopper (sm_90a): the forward
// (per-row logsumexp and label logit) and the two backward kernels, d_hidden
// and d_head_weight.
//
// Replaces: modalities_tpu/ops/pallas/fused_ce.py:_fwd_kernel, _bwd_dh_kernel
// and _bwd_dw_kernel (the Pallas TPU kernels behind the `lm_head_fused_ce`
// tier, ops/cross_entropy.py:fused_ce_sum_and_count).
//
// Computes what those kernels compute, for h [N, E], W [V, E], labels [N]:
//   forward: s = h . W^T (fp32), per row lse = m + log(max(l, 1e-37)) of an
//            online max m and exp-sum l over the vocab, and corr = s[label]
//            (0 when the label is not a vocab column, e.g. ignore_index);
//   dh:      dh = sum_v ds[n, v] W[v],   ds = gm[n] (exp(s - lse[n]) - [v == label[n]]);
//   dW:      dW = sum_n ds[n, v] h[n],
// with gm = g_total * mask from the wrapper (ignored rows have gm 0 and so
// touch neither gradient). s is regenerated tile by tile in every kernel: no
// [N, V] tensor, nor a [rows, V] chunk of one, is ever written to memory.
//
// What bounds them on an H100: operations. At the 32k training shape (N 32768,
// V 50304, E 1536, bf16) the forward does 2 N V E = 5.1e12 FLOPs and each
// backward kernel 4 N V E (the s tile again, then ds against W or h) against
// 0.25 GB of h and W: ~2e4 operations per byte, far above the ~295 where the
// tensor cores, not memory, become the limit.
//
// Design (right first; wgmma, TMA and warp specialisation are later work):
// - bf16: a CTA of 8 warps owns 16 output rows (rows of h for the forward and
//   dh, rows of W for dW) and streams the other matrix in tiles of 32 rows.
//   The contraction dim E is split over the warps: warp w holds the columns
//   [w E/8, (w+1) E/8) of its 16 rows as mma.sync m16n8k16 A fragments in
//   registers for the whole kernel, computes the partial s tile of its
//   columns, and the 8 partials are summed through shared memory in a fixed
//   order. The backward kernels round ds to bf16 (as the flash kernels round
//   P and dS) and multiply it against the same E-slice of the streamed tile,
//   read transposed with ldmatrix.trans, into a [16, E/8] fp32 accumulator
//   per warp: the [16, E] accumulator of a row block (96 KB at E 1536) lives
//   in the registers of the whole CTA, so every output element is summed by
//   one thread in a fixed order: no atomics, bitwise repeatable. Each warp
//   loads its own slice of the streamed tile with cp.async, double buffered.
//   The price of 16 rows per CTA: the streamed matrix is read once per 16
//   rows from L2 (N/16 x 154 MB = 316 GB per forward or dh at the 32k shape).
//   E must be a multiple of 128 (E/8 a multiple of 16), up to 1536.
// - fp32: one warp per output row on the CUDA cores (lanes split E, a fixed
//   xor-butterfly sum), plain FMA, no TF32: the version the plain PyTorch code
//   is held to in f32, at small shapes.
// Out-of-range rows on either side are zero-filled and masked (streamed vocab
// columns past V take no part in the softmax; rows past N carry gm 0); all
// flat offsets are 64-bit (N V reaches 1.65e9 at the 32k shape).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct CEParams {
  const void* h;        // [N, E]
  const void* w;        // [V, E], same dtype as h
  const int* labels;    // [N]
  const float* lse;     // backward: [N] from the forward
  const float* gm;      // backward: [N] g_total * mask
  float* lse_out;       // forward: [N]
  float* corr_out;      // forward: [N]
  void* dh;             // dh: [N, E] like h
  void* dw;             // dW: [V, E] like w
  int n, v, e;
};

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNegInf = -1e30f;
enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// B fragments (k16 x n8) of a row-major [k][n] bf16 tile: rows k are the
// streamed rows, n the E columns. Lanes 0-15 give the 16 row addresses.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float xor_sum16(float x) {  // over the 16 lanes of a half warp
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x;
}

__device__ __forceinline__ float xor_max16(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  return x;
}

template <int SW>
struct Cfg {
  static constexpr int kWarps = 8, kThreads = 256;
  static constexpr int kRows = 16;  // output rows of a CTA (one m16 tile)
  static constexpr int kBT = 32;    // streamed rows a tile
  static constexpr int SP = SW + 8;     // bf16 pitch of a warp's slice rows (conflict-free fragments)
  static constexpr int PP = kBT + 8;    // fp32 pitch of the partial-s rows
  static constexpr int DP = kBT + 8;    // bf16 pitch of the ds rows
  static constexpr int kStage = kBT * SP;  // bf16 elements of one buffer of one warp
  static constexpr int kSmem = 2 * kWarps * kStage * 2 + kWarps * kRows * PP * 4 + kRows * DP * 2;
};

// Rows [r0, r0 + R) of M [nm, e] bf16, columns [e0, e0 + SW), into buf[R][SP]
// by one warp; rows >= nm are zero-filled.
template <int SW>
__device__ __forceinline__ void load_slice(bf16* buf, const bf16* m, int e, int r0, int rows, int nm, int e0,
                                           int lane) {
  constexpr int VPR = SW / 8;  // 16-byte vectors a row
  for (int i = lane; i < rows * VPR; i += 32) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = r0 + r < nm;
    const bf16* src = in ? m + static_cast<long long>(r0 + r) * e + e0 + c : m;
    cp_async16(buf + r * Cfg<SW>::SP + c, src, in);
  }
}

template <int SW, int MODE>
__global__ void __launch_bounds__(256, 1) ce_bf16(const CEParams p) {
  using C = Cfg<SW>;
  constexpr int KT = SW / 16;       // k16 steps of a warp's slice
  constexpr int NJ = C::kBT / 8;    // n8 tiles of the s tile
  constexpr int NT = SW / 8;        // n8 tiles of a warp's accumulator slice
  constexpr int KB = C::kBT / 16;   // k16 steps of the ds . slice product
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sb = reinterpret_cast<bf16*>(smem);
  float* sp = reinterpret_cast<float*>(smem + 2 * C::kWarps * C::kStage * 2);
  bf16* sd = reinterpret_cast<bf16*>(sp + C::kWarps * C::kRows * C::PP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const bool dw = MODE == kDw;
  const bf16* A = static_cast<const bf16*>(dw ? p.w : p.h);  // the CTA's output rows
  const bf16* S = static_cast<const bf16*>(dw ? p.h : p.w);  // the streamed matrix
  const int na = dw ? p.v : p.n, ns = dw ? p.n : p.v;
  const int r0 = blockIdx.x * C::kRows, e0 = warp * SW;
  bf16* buf[2] = {sb + (warp * 2) * C::kStage, sb + (warp * 2 + 1) * C::kStage};

  // this warp's E-slice of the CTA's 16 rows, as A fragments for the whole kernel
  uint32_t af[KT][4];
  load_slice<SW>(buf[0], A, p.e, r0, C::kRows, na, e0, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const bf16* q = buf[0] + g * C::SP + kk * 16 + 2 * t4;
    af[kk][0] = ld32(q);
    af[kk][1] = ld32(q + 8 * C::SP);
    af[kk][2] = ld32(q + 8);
    af[kk][3] = ld32(q + 8 * C::SP + 8);
  }
  __syncwarp();

  // the reduction thread's place: row rr of the CTA, streamed columns cc, cc + 1 of a tile
  const int rr = tid >> 4, cc = (tid & 15) * 2, row = r0 + rr;
  int lab_r = -1;
  float lse_r = 0.f, gm_r = 0.f;
  if (!dw && row < na) {
    lab_r = p.labels[row];
    if (MODE == kDh) {
      lse_r = p.lse[row];
      gm_r = p.gm[row];
    }
  }
  float m = kNegInf, l = 0.f, corr = 0.f;  // forward: online statistics of row `row`
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int n_tiles = (ns + C::kBT - 1) / C::kBT;
  load_slice<SW>(buf[0], S, p.e, 0, C::kBT, ns, e0, lane);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int b0 = t * C::kBT;
    const bf16* cur = buf[t & 1];
    if (t + 1 < n_tiles) {
      load_slice<SW>(buf[(t + 1) & 1], S, p.e, b0 + C::kBT, C::kBT, ns, e0, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int c0 = b0 + cc;  // streamed index of this thread's first column
    float lse_c[2] = {0.f, 0.f}, gm_c[2] = {0.f, 0.f};
    int lab_c[2] = {-1, -1};
    if (dw) {  // dW: the statistics belong to the streamed rows (tokens)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (c0 + i < ns) {
          lse_c[i] = p.lse[c0 + i];
          gm_c[i] = p.gm[c0 + i];
          lab_c[i] = p.labels[c0 + i];
        }
    }

    // the partial s tile [16 x 32] of this warp's E-slice
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* q = cur + (j * 8 + g) * C::SP + kk * 16 + 2 * t4;
        const uint32_t bfr[2] = {ld32(q), ld32(q + 8)};
        mma_16816(s[j], af[kk], bfr);
      }
    float* mine = sp + warp * C::kRows * C::PP;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      *reinterpret_cast<float2*>(mine + g * C::PP + j * 8 + 2 * t4) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * C::PP + j * 8 + 2 * t4) = make_float2(s[j][2], s[j][3]);
    }
    __syncthreads();
    float x[2] = {0.f, 0.f};
#pragma unroll
    for (int w = 0; w < C::kWarps; ++w) {  // fixed order over the E-slices
      const float2 v = *reinterpret_cast<const float2*>(sp + (w * C::kRows + rr) * C::PP + cc);
      x[0] += v.x;
      x[1] += v.y;
    }

    if (MODE == kFwd) {
      const bool ok0 = c0 < ns, ok1 = c0 + 1 < ns;
      const float mx = xor_max16(fmaxf(ok0 ? x[0] : kNegInf, ok1 ? x[1] : kNegInf));
      const float mn = fmaxf(m, mx);
      l = l * expf(m - mn) + (ok0 ? expf(x[0] - mn) : 0.f) + (ok1 ? expf(x[1] - mn) : 0.f);
      m = mn;
      if (ok0 && c0 == lab_r) corr += x[0];
      if (ok1 && c0 + 1 == lab_r) corr += x[1];
      __syncthreads();  // every partial read before the next tile's are written
    } else {
      float ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = c0 + i;
        if (MODE == kDh) {
          ds[i] = c < ns ? gm_r * (expf(x[i] - lse_r) - (c == lab_r ? 1.f : 0.f)) : 0.f;
        } else {
          ds[i] = (c < ns && row < na) ? gm_c[i] * (expf(x[i] - lse_c[i]) - (row == lab_c[i] ? 1.f : 0.f)) : 0.f;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(sd + rr * C::DP + cc) = __floats2bfloat162_rn(ds[0], ds[1]);
      __syncthreads();  // also: every partial read before the next tile's are written
      uint32_t dsf[KB][4];
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        const bf16* q = sd + g * C::DP + kk * 16 + 2 * t4;
        dsf[kk][0] = ld32(q);
        dsf[kk][1] = ld32(q + 8 * C::DP);
        dsf[kk][2] = ld32(q + 8);
        dsf[kk][3] = ld32(q + 8 * C::DP + 8);
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bfr[2];
          ldsm_x2_trans(bfr, cur + (kk * 16 + (lane & 15)) * C::SP + j * 8);
          mma_16816(acc[j], dsf[kk], bfr);
        }
    }
    __syncwarp();  // this warp's reads of `cur` are done before the prefetch after next overwrites it
  }

  if (MODE == kFwd) {
    l = xor_sum16(l);
    corr = xor_sum16(corr);
    if ((tid & 15) == 0 && row < na) {
      p.lse_out[row] = m + logf(fmaxf(l, 1e-37f));
      p.corr_out[row] = corr;
    }
  } else {
    bf16* out = static_cast<bf16*>(dw ? p.dw : p.dh);
    const int ra = r0 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const long long col = e0 + j * 8 + 2 * t4;
      if (ra < na)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(ra) * p.e + col) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      if (rb < na)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(rb) * p.e + col) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

// ------------------------------------------------------------------ fp32 path
// One warp per output row; lanes split E and sum with an xor butterfly, so
// every lane holds the same dot product. Outputs are written by the lane that
// owns the column, in a fixed loop order.
constexpr int kWarpsF = 4;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) x += __shfl_xor_sync(0xffffffffu, x, k);
  return x;
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int e, int lane) {
  float s = 0.f;
  for (int i = lane; i < e; i += 32) s = fmaf(a[i], b[i], s);
  return warp_sum(s);
}

__global__ void __launch_bounds__(32 * kWarpsF) ce_fwd_f32(const CEParams p) {
  const int lane = threadIdx.x & 31, n = blockIdx.x * kWarpsF + (threadIdx.x >> 5);
  if (n >= p.n) return;
  const float* h = static_cast<const float*>(p.h) + static_cast<long long>(n) * p.e;
  const int lab = p.labels[n];
  float m = kNegInf, l = 0.f, corr = 0.f;
  for (int v = 0; v < p.v; ++v) {
    const float s = dot_f32(h, static_cast<const float*>(p.w) + static_cast<long long>(v) * p.e, p.e, lane);
    const float mn = fmaxf(m, s);
    l = l * expf(m - mn) + expf(s - mn);
    m = mn;
    if (v == lab) corr += s;
  }
  if (lane == 0) {
    p.lse_out[n] = m + logf(fmaxf(l, 1e-37f));
    p.corr_out[n] = corr;
  }
}

__global__ void __launch_bounds__(32 * kWarpsF) ce_dh_f32(const CEParams p) {
  const int lane = threadIdx.x & 31, n = blockIdx.x * kWarpsF + (threadIdx.x >> 5);
  if (n >= p.n) return;
  const float* h = static_cast<const float*>(p.h) + static_cast<long long>(n) * p.e;
  float* dh = static_cast<float*>(p.dh) + static_cast<long long>(n) * p.e;
  for (int i = lane; i < p.e; i += 32) dh[i] = 0.f;
  const float gm = p.gm[n], lse = p.lse[n];
  const int lab = p.labels[n];
  if (gm == 0.f) return;
  for (int v = 0; v < p.v; ++v) {
    const float* w = static_cast<const float*>(p.w) + static_cast<long long>(v) * p.e;
    const float ds = gm * (expf(dot_f32(h, w, p.e, lane) - lse) - (v == lab ? 1.f : 0.f));
    for (int i = lane; i < p.e; i += 32) dh[i] = fmaf(ds, w[i], dh[i]);
  }
}

__global__ void __launch_bounds__(32 * kWarpsF) ce_dw_f32(const CEParams p) {
  const int lane = threadIdx.x & 31, v = blockIdx.x * kWarpsF + (threadIdx.x >> 5);
  if (v >= p.v) return;
  const float* w = static_cast<const float*>(p.w) + static_cast<long long>(v) * p.e;
  float* dw = static_cast<float*>(p.dw) + static_cast<long long>(v) * p.e;
  for (int i = lane; i < p.e; i += 32) dw[i] = 0.f;
  for (int n = 0; n < p.n; ++n) {
    const float gm = p.gm[n];
    if (gm == 0.f) continue;
    const float* h = static_cast<const float*>(p.h) + static_cast<long long>(n) * p.e;
    const float ds = gm * (expf(dot_f32(h, w, p.e, lane) - p.lse[n]) - (p.labels[n] == v ? 1.f : 0.f));
    for (int i = lane; i < p.e; i += 32) dw[i] = fmaf(ds, h[i], dw[i]);
  }
}

// ------------------------------------------------------------------ launch
template <int SW>
int launch_bf16(const CEParams& p, int mode, cudaStream_t s) {
  using C = Cfg<SW>;
  void (*k)(const CEParams) = mode == kFwd ? ce_bf16<SW, kFwd> : mode == kDh ? ce_bf16<SW, kDh> : ce_bf16<SW, kDw>;
  const cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rows = mode == kDw ? p.v : p.n;
  k<<<(rows + C::kRows - 1) / C::kRows, C::kThreads, C::kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(const CEParams* p, int mode, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->n <= 0 || p->v <= 0 || p->e <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const int rows = mode == kDw ? p->v : p->n;
    const dim3 grid((rows + kWarpsF - 1) / kWarpsF);
    if (mode == kFwd) {
      ce_fwd_f32<<<grid, 32 * kWarpsF, 0, s>>>(*p);
    } else if (mode == kDh) {
      ce_dh_f32<<<grid, 32 * kWarpsF, 0, s>>>(*p);
    } else {
      ce_dw_f32<<<grid, 32 * kWarpsF, 0, s>>>(*p);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || p->e % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (p->e / 8) {
    case 16: return launch_bf16<16>(*p, mode, s);
    case 32: return launch_bf16<32>(*p, mode, s);
    case 192: return launch_bf16<192>(*p, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h, w, dh, dw; statistics are fp32, labels
// int32). bf16 needs E in {128, 256, 1536};
// rows must be contiguous and 16-byte aligned (the wrapper checks). Each
// returns cudaGetLastError() after its launch.
extern "C" int mt_fused_ce_fwd(const CEParams* p, int dtype, void* stream) { return launch(p, kFwd, dtype, stream); }

extern "C" int mt_fused_ce_bwd_dh(const CEParams* p, int dtype, void* stream) {
  return launch(p, kDh, dtype, stream);
}

extern "C" int mt_fused_ce_bwd_dw(const CEParams* p, int dtype, void* stream) {
  return launch(p, kDw, dtype, stream);
}
