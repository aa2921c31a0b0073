// Fused dequant-matmul for weight-only quantized serving on Hopper (sm_90a).
//
// Replaces: modalities_tpu/ops/pallas/quant_matmul.py:_kernel (the Pallas TPU
// kernel behind ops/quant_matmul.py:quant_matmul_or_fallback).
//
// Computes y [M, N] = ((x [M, K] @ widen(wq [K, N])) * scale [N]) cast to x's
// dtype, with fp32 accumulation. wq holds one byte per weight: int8, or fp8
// e4m3 (float8_e4m3fn). x is bf16 (every dense layer) or fp32 (the untied
// head, which the model computes in fp32). Serving calls it with M = 1..64.
//
// What bounds it on an H100: bytes. Each weight byte feeds at most 2 * 64
// operations, under the ~295 a byte at which the bf16 tensor cores become the
// limit; one decode step of the 2.7B model reads ~2.54 GB of int8 weights,
// ~0.77 ms at 3.35 TB/s. The weight must cross device memory in its 1-byte
// form and be widened on chip. The fp32 head at M = 64 is the exception: its
// three bf16 products (below) make 3 * 2MKN operations, 0.050 ms at 989.4
// TFLOP/s against 0.039 ms of bytes.
//
// Design (quant_mm_tc, one launch a call, no global workspace):
// - The weight is the wgmma's A operand and x its B: a CTA owns 128 output
//   columns (64 a consumer warpgroup, wgmma's M) for NB rows of x (wgmma's N:
//   8, 16 or 64, the fewest that hold M), so a decode step's 8 rows fill no
//   64-row tile.
// - K is split over the CTAs of a thread-block cluster (`splits`, 1..8, a
//   function of K and N only: ops/quant_matmul.py:split_k). Rank r takes k
//   tiles [r T / splits, (r + 1) T / splits) of T and owns four-column groups
//   [r 32 / splits, (r + 1) 32 / splits) of the tile's 32. After its main
//   loop every rank sends each column's fp32 partial into the owner's
//   receive buffer (st.async into distributed shared memory, counted by an
//   mbarrier there); each rank waits for its own barrier, sums its columns'
//   partials in rank order from its own shared memory, applies the scale and
//   the cast, and stores y. The only cluster barrier is the set-up one
//   (arrived at entry, waited for after the main loop); no rank reads a
//   peer's memory, so none waits for the others to leave.
// - A producer warp streams the rank's k tiles through a ring of STAGES by
//   TMA: 64 k x 128 columns of one-byte weights (a 2-D tensor map over wq,
//   built once per weight by mt_quant_matmul_prepare, 128-byte swizzled) and
//   x's 64 k x NB slice (a tensor map built per call: bf16 straight into the
//   swizzled K-major B tile, fp32 as it is; rows past M zero-filled). One
//   mbarrier a stage counts the bytes, another the consumer warps' release.
// - Each consumer warpgroup widens its 64 columns of the tile, 16 bytes a
//   thread, into a 128-byte-swizzled bf16 tile that wgmma reads MN-major (no
//   transpose), with 16-byte stores; both widenings are exact (int8: the
//   2^23 magic number; e4m3: cvt.rn.f16x2.e4m3x2, the f16 bits shifted into
//   bf16 and scaled by 2^112).
// - bf16 x: one accumulator over the rank's k tiles; tile t's wgmma group is
//   issued once the warpgroup has widened it, and tile t - 1's is waited for
//   after that (its stage and widened tile then go back).
// - fp32 x (the head): split into bf16 hi + mid + lo (x to 2^-24 relative),
//   each multiplied by the widened weight (exact in bf16): 3 wgmma a k16 step
//   into a fresh accumulator a k tile, added to an fp32 total on the CUDA
//   cores once that tile's group has completed, so the tensor cores'
//   accumulation spans 64 k and the rest is IEEE fp32.
// Every output element is summed in the same order whatever M is (the split
// does not depend on M; rows of x never mix; the products of a row do not
// depend on wgmma's N), and there are no atomics: the results are bitwise
// repeatable and batch invariant (chip_smoke.py phase 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

// What the wrapper passes (mirror: ops/quant_matmul.py:_QmmArgs): the weight's
// tensor map from mt_quant_matmul_prepare, then the call's operands.
struct QmmArgs {
  unsigned char wmap[128];
  const void* x;
  const float* scale;
  void* y;
  int m, k, n, splits;
  int x_f32, w_fp8, device;
};

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const void* x;
  const float* scale;
  void* y;
  int m, k, n, splits;
};

constexpr int kBN = 128;                   // output columns a CTA: 64 a consumer warpgroup
constexpr int kBK = 64;                    // k depth of a ring stage
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxRows = 64;               // rows of x a CTA; grid.y covers more

template <int NB, bool XF32>
struct Cfg {
  static constexpr int STAGES = XF32 && NB == 8 ? 6 : XF32 || NB == 64 ? 4 : 6;
  static constexpr int W_TILE = kBK * kBN;                  // bytes: 64 k rows of 128 one-byte weights
  static constexpr int X_TILE = NB * kBK * (XF32 ? 4 : 2);  // bytes: NB rows of 64 k
  static constexpr int STAGE = W_TILE + X_TILE;
  static constexpr int A_TILE = kBK * 64;   // bf16 elements: a warpgroup's widened 64 k x 64 columns
  static constexpr int PIECE = NB * kBK;    // bf16 elements: hi, mid or lo of an fp32 x tile
  static constexpr int RING = STAGES * STAGE;
  // The ranks' partials of this rank's columns: [rank][column][row], at most 8 ranks of ceil(32 / ranks)
  // four-column groups. bf16 x at NB 64 keeps them in the ring (two CTAs a SM), other instances apart.
  static constexpr int RECV = 160 * NB;
  static constexpr bool RECV_IN_RING = !XF32 && NB == 64;
  static constexpr int kSmem = 1024 + RING + 4 * A_TILE * 2 + (XF32 ? 6 * PIECE * 2 : 0) + (RECV_IN_RING ? 0 : RECV * 4) +
                               (2 * STAGES + 1) * 8;
  static_assert(!RECV_IN_RING || RING >= RECV * 4, "the partials fit in the ring");
  static_assert(STAGE % 1024 == 0 && PIECE * 2 % 1024 == 0, "tiles keep the 1024-byte alignment of their swizzle");
  static_assert(kSmem <= 232448, "fits an SM's shared memory");
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Four int8 weights (one word) -> four bf16 (two words), exactly: each byte,
// biased by 128, becomes the low byte of 2^23's mantissa, 2^23 + 128 is
// subtracted, and the integer's fp32 upper half is its bf16.
__device__ __forceinline__ uint2 widen4_s8(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(prmt(u, 0x4B000000u, 0x7650u)) - 8388736.f;
  const float f1 = __uint_as_float(prmt(u, 0x4B000000u, 0x7651u)) - 8388736.f;
  const float f2 = __uint_as_float(prmt(u, 0x4B000000u, 0x7652u)) - 8388736.f;
  const float f3 = __uint_as_float(prmt(u, 0x4B000000u, 0x7653u)) - 8388736.f;
  return make_uint2(prmt(__float_as_uint(f0), __float_as_uint(f1), 0x7632u),
                    prmt(__float_as_uint(f2), __float_as_uint(f3), 0x7632u));
}

// Two e4m3 magnitudes -> bf16x2 with the signs `sign2` (bits 15 and 31),
// exactly: every e4m3 value is a normal f16 or 0; an f16 whose mantissa has
// 3 bits, shifted right by 3, reads as a bf16 of the value times 2^-112
// (exponent bias 15 where bf16's is 127), and 2^112 restores it.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t mag2, uint32_t sign2) {
  uint32_t h;
  asm("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %1;\ncvt.rn.f16x2.e4m3x2 %0, lo;\n}\n" : "=r"(h) : "r"(mag2));
  uint32_t b = (h >> 3) | sign2;
  const uint32_t two112 = 0x77807780u;  // bf16x2 (2^112, 2^112)
  __nv_bfloat162 v = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&b), *reinterpret_cast<const __nv_bfloat162*>(&two112));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four e4m3 weights -> four bf16. prmt's sign mode (selector nibble 8 + i)
// spreads the sign of byte i over a byte.
__device__ __forceinline__ uint2 widen4_e4m3(uint32_t w) {
  const uint32_t m = w & 0x7F7F7F7Fu;
  return make_uint2(e4m3x2_to_bf16x2(m, prmt(w, 0u, 0x9484u) & 0x80008000u),
                    e4m3x2_to_bf16x2(m >> 16, prmt(w, 0u, 0xB4A4u) & 0x80008000u));
}

template <bool FP8>
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  if constexpr (FP8) {
    return widen4_e4m3(w);
  } else {
    return widen4_s8(w);
  }
}

// A warpgroup's 64 columns (64 wg ..) of the stage's one-byte tile (64 k rows
// of 128 bytes, 128-byte swizzled by TMA) widened into `a`: 64 k rows of 64
// bf16 columns, 128-byte swizzled, read MN-major by wgmma. A thread widens
// 16 bytes of one row at a time; the 8 lanes of a quarter warp take 8
// consecutive rows, so loads and stores meet no bank twice.
template <bool FP8>
__device__ __forceinline__ void widen_tile(const unsigned char* wt, bf16* a, int wg, int t128) {
  const int lane = t128 & 31, q = lane >> 3;
  const int k = 8 * (t128 >> 5) + (lane & 7), sw = k & 7;  // rows k and k + 32 (the same swizzle)
  const int from = ((4 * wg + q) ^ sw) << 4, to0 = ((2 * q) ^ sw) << 3, to1 = ((2 * q + 1) ^ sw) << 3;
  const uint4 v0 = *reinterpret_cast<const uint4*>(wt + k * kBN + from);  // both loads first: the
  const uint4 v1 = *reinterpret_cast<const uint4*>(wt + (k + 32) * kBN + from);  // widenings overlap
  const uint2 c0 = widen4<FP8>(v0.x), c1 = widen4<FP8>(v0.y), c2 = widen4<FP8>(v0.z), c3 = widen4<FP8>(v0.w);
  const uint2 d0 = widen4<FP8>(v1.x), d1 = widen4<FP8>(v1.y), d2 = widen4<FP8>(v1.z), d3 = widen4<FP8>(v1.w);
  *reinterpret_cast<uint4*>(a + k * 64 + to0) = make_uint4(c0.x, c0.y, c1.x, c1.y);
  *reinterpret_cast<uint4*>(a + k * 64 + to1) = make_uint4(c2.x, c2.y, c3.x, c3.y);
  *reinterpret_cast<uint4*>(a + (k + 32) * 64 + to0) = make_uint4(d0.x, d0.y, d1.x, d1.y);
  *reinterpret_cast<uint4*>(a + (k + 32) * 64 + to1) = make_uint4(d2.x, d2.y, d3.x, d3.y);
}

// fp32 (a, b) -> bf16x2 hi, mid, lo with hi + mid + lo = (a, b) to 2^-24
// relative: each piece is the residual of the ones before rounded to bf16
// (the residuals are exact in fp32).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - __low2float(m), rb - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The stage's fp32 x (NB rows of 64 k) -> three bf16 B tiles (hi, mid, lo),
// each NB rows of 64 k, K-major and 128-byte swizzled; by all consumers.
template <int NB>
__device__ __forceinline__ void split_tile(const float* xr, bf16* pieces, int tid) {
  constexpr int PIECE = NB * kBK;
  for (int i = tid; i < NB * 16; i += kConsumers) {
    const int r = i >> 4, c4 = i & 15;  // row, 4 k columns
    const float4 v = *reinterpret_cast<const float4*>(xr + r * kBK + 4 * c4);
    const int off = r * kBK + ((((c4 >> 1) ^ (r & 7)) << 3) | ((c4 & 1) << 2));
    uint2 h, m, l;
    split2(v.x, v.y, h.x, m.x, l.x);
    split2(v.z, v.w, h.y, m.y, l.y);
    *reinterpret_cast<uint2*>(pieces + off) = h;
    *reinterpret_cast<uint2*>(pieces + PIECE + off) = m;
    *reinterpret_cast<uint2*>(pieces + 2 * PIECE + off) = l;
  }
}

template <int NB, bool XF32, bool FP8>
__global__ void __launch_bounds__(kThreads, XF32 && NB == 64 ? 1 : 2)
    quant_mm_tc(const Params p, const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap) {
  using C = Cfg<NB, XF32>;
  typedef typename std::conditional<XF32, float, bf16>::type T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);  // 1024-aligned
  bf16* atiles = reinterpret_cast<bf16*>(ring + C::RING);  // [warpgroup][2][A_TILE]
  bf16* pieces = atiles + 4 * C::A_TILE;                   // fp32 x: [2][hi, mid, lo][PIECE]
  float* recv_own = reinterpret_cast<float*>(pieces + (XF32 ? 6 * C::PIECE : 0));
  float* recv = C::RECV_IN_RING ? reinterpret_cast<float*>(ring) : recv_own;  // [rank][column][row]
  uint64_t* full = reinterpret_cast<uint64_t*>(recv_own + (C::RECV_IN_RING ? 0 : C::RECV));
  uint64_t* empty = full + C::STAGES;
  uint64_t* recv_bar = empty + C::STAGES;  // counts the bytes of the ranks' partials as they land in `recv`
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(hopper::cluster_rank());  // clusters of `splits` CTAs along x
  const int n0 = blockIdx.x / p.splits * kBN, m0 = blockIdx.y * kMaxRows;
  const int rows = min(NB, p.m - m0);
  const int ktiles = p.k / kBK;
  const int kt0 = rank * ktiles / p.splits, n_t = (rank + 1) * ktiles / p.splits - kt0;
  // Rank r reduces and stores four-column groups [r 32 / splits, (r + 1) 32 / splits) of the tile's 32; the
  // owner of group g is ((g + 1) splits - 1) / 32.
  const int g0 = rank * 32 / p.splits, groups = (rank + 1) * 32 / p.splits - g0, cmax = 4 * ((31 + p.splits) / p.splits);
  // the scales of this thread's first output (row-fastest order below), loaded now for the epilogue
  // (consumers; the producer warp's first outputs load theirs there)
  const int s_col = n0 + 4 * (g0 + tid / rows);
  float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < rows * groups && s_col < p.n)
    sc = make_float4(__ldg(p.scale + s_col), __ldg(p.scale + s_col + 1), __ldg(p.scale + s_col + 2),
                     __ldg(p.scale + s_col + 3));

  // The producer warp sets up the ring and starts loading at once; the consumers wait for its set-up alone
  // (named barrier 3).
  if (tid == kConsumers) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&wmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&xmap) : "memory");
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);  // the stage's bytes: the weight tile and x's slice
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::mbar_init(recv_bar, 1);
    hopper::mbar_expect(recv_bar, p.splits * 4 * groups * NB * 4);  // every rank's partials of this rank's columns
    hopper::fence_mbar_init();
  }
  __syncwarp();
  hopper::cluster_arrive_relaxed();  // the peers' recv_bar is initialised once this barrier completes

  float total[NB / 2];  // this thread's fp32 sums: the m64nNB accumulator layout
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) total[i] = 0.f;

  if (tid >= kConsumers) {  // the producer warp: the weight tile and x's slice by TMA, as stages empty
    hopper::named_bar_arrive(3, kThreads);
    if (tid == kConsumers) {
      for (int t = 0; t < n_t; ++t) {
        const int s = t % C::STAGES, k0 = (kt0 + t) * kBK;
        if (t >= C::STAGES) hopper::mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        unsigned char* st = ring + s * C::STAGE;
        hopper::mbar_expect(&full[s], C::STAGE);
        hopper::tma_load_2d(st, &wmap, n0, k0, &full[s]);
        hopper::tma_load_2d(st + C::W_TILE, &xmap, k0, m0, &full[s]);  // rows >= M zero-filled
      }
    }
  } else {  // the consumer warpgroups
    const int wg = tid >> 7, lane = tid & 31;
    hopper::named_bar_sync(3, kThreads);
    // the scales arrive while the first tile does (the compiler would otherwise load them in the epilogue)
    asm volatile("" : "+f"(sc.x), "+f"(sc.y), "+f"(sc.z), "+f"(sc.w));
    float acc[NB / 2];
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    auto a_of = [&](int t) { return atiles + (2 * wg + (t & 1)) * C::A_TILE; };
    auto prepare = [&](int t) {  // tile t landed: widen this warpgroup's columns (and split x)
      const unsigned char* st = ring + (t % C::STAGES) * C::STAGE;
      hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
      widen_tile<FP8>(st, a_of(t), wg, tid & 127);
      if constexpr (XF32) split_tile<NB>(reinterpret_cast<const float*>(st + C::W_TILE), pieces + (t & 1) * 3 * C::PIECE, tid);
      hopper::fence_async_smem();  // the widened tile (and the pieces), for wgmma
    };
    auto release = [&](int t) {  // this warp is done with tile t's stage
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[t % C::STAGES]);
    };
    if constexpr (XF32) {
      // fp32 x: acc = tile t's products alone (a fresh accumulator, lo, mid, hi: the small ones first), added to
      // `total` on the CUDA cores once its group has completed, while tile t + 1 is widened and split
      auto issue = [&](int t) {
        const bf16* a = a_of(t);
        const bf16* pc = pieces + (t & 1) * 3 * C::PIECE;
        hopper::reg_fence(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int piece = 2; piece >= 0; --piece)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_ss_tn<NB>(acc, hopper::desc_sw_mn<128>(a + kk * 16 * 64, kBK),
                                    hopper::desc_sw_k<128>(pc + piece * C::PIECE + kk * 16), piece == 2 && kk == 0 ? 0 : 1);
        hopper::wgmma_commit();
      };
      prepare(0);
      hopper::named_bar_sync(1, kConsumers);
      issue(0);
      for (int t = 1; t < n_t; ++t) {
        prepare(t);  // while tile t - 1's products run
        hopper::wgmma_wait<0>();
        hopper::reg_fence(acc);
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) total[i] += acc[i];
        // every warp has tile t's pieces in shared memory, and both warpgroups' tile t - 1 products are done
        hopper::named_bar_sync(1, kConsumers);
        release(t - 1);
        issue(t);
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) total[i] += acc[i];
    } else {
      // bf16 x: one accumulator over the rank's k tiles; tile t's group is issued as soon as this warpgroup
      // has widened it, and tile t - 1's is waited for after that (its stage and widened tile then go)
      for (int t = 0; t < n_t; ++t) {
        prepare(t);
        hopper::named_bar_sync(1 + wg, 128);  // this warpgroup's four warps have widened tile t
        const bf16* a = a_of(t);
        const bf16* xb = reinterpret_cast<const bf16*>(ring + (t % C::STAGES) * C::STAGE + C::W_TILE);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_tn<NB>(acc, hopper::desc_sw_mn<128>(a + kk * 16 * 64, kBK),
                                  hopper::desc_sw_k<128>(xb + kk * 16), t > 0 || kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        if (t > 0) release(t - 1);
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) total[i] = acc[i];
    }
  }

  // Every column's partial goes to the rank that owns it, into its `recv` at [this rank][column][row], by
  // stores that its recv_bar counts; each rank then waits for its own barrier alone, sums its columns'
  // partials in rank order from its own shared memory, scales, casts and stores. No rank reads a peer's
  // memory and there is no cluster barrier here (in the ring, one first: every rank's loads are done).
  hopper::cluster_wait();  // the set-up barrier: every peer's recv_bar is initialised
  if constexpr (C::RECV_IN_RING) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
  if (tid < kConsumers) {
    const int col = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid & 31) >> 2), t4 = tid & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns col and col + 8
      const int c = col + 8 * h, owner = ((c >> 2) * p.splits + p.splits - 1) >> 5;
      const uint32_t dst = hopper::mapa(recv + (rank * cmax + c - 4 * (owner * 32 / p.splits)) * NB, owner);
      const uint32_t bar = hopper::mapa(recv_bar, owner);
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)  // rows 8 j + 2 t4 and the next
        hopper::st_async_v2(dst + 4 * (8 * j + 2 * t4), total[4 * j + 2 * h], total[4 * j + 2 * h + 1], bar);
    }
  }
  hopper::mbar_wait(recv_bar, 0);  // every rank's partials of this rank's columns have landed
  T* y = static_cast<T*>(p.y) + static_cast<long long>(m0) * p.n;
  for (int i = tid; i < rows * groups; i += kThreads) {
    const int r = i % rows, c = 4 * (i / rows), col = n0 + 4 * g0 + c;  // row r, this rank's columns c .. c + 3
    if (col >= p.n) continue;  // N % 16 == 0: four columns lie wholly inside or outside
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {  // straight-line: ranks past `splits` read rank splits - 1 and add nothing
      const float* src = recv + (min(q, p.splits - 1) * cmax + c) * NB + r;
      const float w = q < p.splits ? 1.f : 0.f;
      v.x = fmaf(src[0], w, v.x);
      v.y = fmaf(src[NB], w, v.y);
      v.z = fmaf(src[2 * NB], w, v.z);
      v.w = fmaf(src[3 * NB], w, v.w);
    }
    if (i != tid)  // a later output of this thread: its scales now
      sc = make_float4(__ldg(p.scale + col), __ldg(p.scale + col + 1), __ldg(p.scale + col + 2),
                       __ldg(p.scale + col + 3));
    v.x *= sc.x;
    v.y *= sc.y;
    v.z *= sc.z;
    v.w *= sc.w;
    T* out = y + static_cast<long long>(r) * p.n + col;
    if constexpr (XF32) {
      *reinterpret_cast<float4*>(out) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(out) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

template <int NB, bool XF32, bool FP8>
int launch(const Params& p, const CUtensorMap& map, int device, cudaStream_t s) {
  using C = Cfg<NB, XF32>;
  // x [M, K] as a tensor map, per call: boxes of 64 k x NB rows, zero-filled past M; bf16 128-byte swizzled
  // (the K-major B tile wgmma reads), fp32 as it is (split by the consumers)
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k), static_cast<cuuint64_t>(p.m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k) * (XF32 ? 4 : 2)};
  const cuuint32_t box[2] = {kBK, NB};
  const cudaError_t em =
      XF32 ? hopper::make_tensor_map<0>(&xmap, p.x, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
           : hopper::make_tensor_map<128>(&xmap, p.x, 2, dims, strides, box);
  if (em != cudaSuccess) return static_cast<int>(em);
  static unsigned long long raised = 0;  // devices on which the kernel's shared memory limit is raised
  const auto kernel = quant_mm_tc<NB, XF32, FP8>;
  if (!(raised >> device & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised |= 1ull << device;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits * ((p.n + kBN - 1) / kBN), (p.m + kMaxRows - 1) / kMaxRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, map, xmap);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool XF32, bool FP8>
int launch_rows(const Params& p, const CUtensorMap& map, int device, cudaStream_t s) {
  if (p.m <= 8) return launch<8, XF32, FP8>(p, map, device, s);
  if (p.m <= 16) return launch<16, XF32, FP8>(p, map, device, s);
  return launch<64, XF32, FP8>(p, map, device, s);
}

}  // namespace

// The weight's TMA tensor map (into `map_out`, 128 bytes), once per weight:
// wq [K, N] one-byte elements, boxes of 64 k rows x 128 columns, 128-byte
// swizzled, zero-filled past N. Requires K % 64 == 0, N % 16 == 0 and a
// 16-byte aligned wq (the wrapper checks first).
extern "C" int mt_quant_matmul_prepare(const void* wq, int k, int n, void* map_out) {
  if (k <= 0 || n <= 0 || k % kBK || n % 16 || reinterpret_cast<uintptr_t>(wq) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n)};
  const cuuint32_t box[2] = {kBN, kBK};
  const cudaError_t e = hopper::make_tensor_map<128>(&map, wq, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e != cudaSuccess) return static_cast<int>(e);
  memcpy(map_out, &map, sizeof map);
  return 0;
}

// One launch on `stream`, on device a->device. x_f32: 1 float32, 0 bfloat16;
// w_fp8: 1 float8_e4m3fn, 0 int8. Requires 1 <= splits <= 8, splits <= K / 64,
// 16-byte aligned x and y rows (the wrapper checks). Returns
// cudaGetLastError() right after the launch.
extern "C" int mt_quant_matmul(const QmmArgs* a, void* stream) {
  if (a->m <= 0 || a->splits < 1 || a->splits > 8 || a->splits > a->k / kBK || a->device < 0 || a->device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memcpy(&map, a->wmap, sizeof map);
  const Params p{a->x, a->scale, a->y, a->m, a->k, a->n, a->splits};
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != a->device) e = cudaSetDevice(a->device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int status;
  if (a->x_f32) {
    status = a->w_fp8 ? launch_rows<true, true>(p, map, a->device, s) : launch_rows<true, false>(p, map, a->device, s);
  } else {
    status = a->w_fp8 ? launch_rows<false, true>(p, map, a->device, s) : launch_rows<false, false>(p, map, a->device, s);
  }
  if (prev != a->device) cudaSetDevice(prev);
  return status;
}
