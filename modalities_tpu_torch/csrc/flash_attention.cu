// Flash attention for Hopper (sm_90a): forward, backward-dq and backward-dkv.
//
// Replaces: modalities_tpu/ops/pallas/flash_attention.py:_fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel (the Pallas TPU kernels behind the
// `dao_flash` attention tier, ops/attention.py:flash_attention_or_fallback).
//
// Computes what those kernels compute, per (batch, q head h), with q head h
// reading kv head h / (Hq / Hkv) (GQA):
//   forward:  s = (q . k) * sm_scale, masked to -1e30 where key > query
//             (causal, positions aligned at 0) or key >= Sk; online softmax
//             with fp32 running max m and sum l; out = acc / max(l, 1e-30),
//             lse = m + log(max(l, 1e-30)) in fp32.
//   dq:       p = exp(s - lse), dp = do . v, ds = p * (dp - delta) * sm_scale,
//             dq = sum_keys ds * k.
//   dkv:      dv = sum_q p * do, dk = sum_q ds * q, summed over the GQA group's
//             q heads inside the kv head's CTA (a fixed loop, no atomics).
// delta = sum_D do * out is computed outside (as in the JAX package).
//
// What bounds them on an H100: operations. At the 2.7B shape (B 2, S 4096,
// Hq 32, D 80, causal) the forward does 2 matmuls of 2*B*Hq*S^2*D/2 FLOPs
// each (1.7e11 in all), dq 3 and dkv 4, against ~0.1 GB of q/k/v/out
// traffic: over a thousand operations per byte, far above the ~295 where the
// bf16 tensor cores, not memory, become the limit.
//
// Design:
// - bf16 forward (redesigned for Hopper): wgmma with TMA-fed, ring-buffered
//   K/V tiles, P kept in registers and V read MN-major (no transposed copy);
//   see flash_fwd_bf16 below.
// - bf16 dq (redesigned for Hopper): the forward's structure, with S and dP
//   by wgmma from TMA-fed tiles, dS kept in registers and K read MN-major (no
//   transposed copy); see flash_bwd_dq_bf16 below.
// - bf16 dkv (redesigned for Hopper): wgmma with TMA-fed, ring-buffered tiles
//   and no transposed copies; see flash_bwd_dkv_bf16 below.
// All three need sm_90a (wgmma).
// In all three each output tile is written by one CTA and summed in a fixed
// order: no atomics, and two calls give identical bits. Causal tiles above
// the diagonal are skipped; ragged tails (S not a multiple of the tile) are
// zero-filled and masked. P (and dS) are rounded to bf16 before their matmul
// on the tensor cores; the TPU kernel multiplies them in fp32.
// - fp32: the same loops on the CUDA cores, one query row (or key row) per
//   thread, plain FMA, no TF32: the version the plain PyTorch code is held to
//   in f32.
// Head dims 16, 32, 64, 80 and 128 are compiled; the wrapper refuses others.
// Every tensor is addressed through (batch, head, row) strides with a unit
// stride along D, so the model's [B, S, H, D] layout needs no transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// The file compiles whole, or in parts (MT_FLASH_PART 1-5, one nvcc process
// each; see `here` below), so no one process holds the build up.
#if defined(MT_FLASH_PART) && (MT_FLASH_PART < 1 || MT_FLASH_PART > 5)
#error "MT_FLASH_PART is 1 to 5"
#endif

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward: dO, laid out like q
  const float* lse_in;  // backward: [B, Hq, Sq] fp32
  const float* delta;   // backward: [B, Hq, Sq] fp32
  void* out;            // forward output, laid out like q
  float* lse_out;       // forward: [B, Hq, Sq] fp32
  void* dq;
  void* dk;             // [B, Hkv, Sk, D] like k
  void* dv;
  long long q_s[3];  // element strides over (batch, head, row); stride 1 along D
  long long k_s[3];
  long long v_s[3];
  long long o_s[3];  // out (forward) or dO (backward)
  long long dq_s[3];
  long long dk_s[3];
  long long dv_s[3];
  int b, hq, hkv, sq, sk;
  float sm_scale;
  int causal;
};

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ int key_tiles(const FlashParams& p, int q_end, int bk) {
  int n = (p.sk + bk - 1) / bk;
  if (p.causal) n = min(n, (min(q_end, p.sq) - 1) / bk + 1);
  return n;
}

// ------------------------------------------------------------------ bf16 fwd
// On wgmma, along FlashAttention-3's forward. A CTA of two consumer
// warpgroups owns BQ = 128 query rows (64 a warpgroup, wgmma's M) of one
// (batch, q head); a third warpgroup is the producer, one thread of which
// loads the Q tile once by TMA (a 4-D tensor map over the strided [B, H, S, D]
// view), then streams key tiles of BK = 128 rows of K and V through a ring of
// STAGES buffers by TMA, each stage with a `full` mbarrier (the bytes landed)
// and an `empty` one (the 8 consumer warps have read it). The producer gives
// its registers to the consumers (setmaxnreg: 40 and 232 a thread; 384
// threads at launch allow 168 each, and fewer than ~190 serialise the
// consumers' wgmma at D 128). Every tile is swizzled (hopper.cuh; 32-byte
// atoms at D 80). Per key tile t, a warpgroup's tensor-core phase issues
//   O += P_{t-1} V_{t-1}  (wgmma, P as bf16 A fragments in registers, V the
//                          tile read MN-major: no transposed copy) and
//   S_t = Q K_t^T         (wgmma, both operands in shared memory, K-major),
// waits for both, then runs the online softmax of S_t in the accumulator
// layout (two rows a thread, quad shuffles), in base 2 (the row max m2 of S
// sm_scale log2(e), P = exp2(S sm_scale log2(e) - m2)), masks only on the
// diagonal tile and the ragged last one (causal tiles above the diagonal are
// never loaded), and rescales O, whose wgmma group has completed by then. The
// two warpgroups take turns (two named barriers): one issues its products
// while the other runs its softmax, so the exponentials (16 a clock on an SM;
// at D 80 a tile's take about as long as its products) overlap the tensor
// cores instead of following them. What bounds it is operations (see the
// file note); PERF.md has its time beside that bound. lse leaves in natural
// log, m2 ln 2 + log(max(l, 1e-30)), as dq and dkv read it. CTAs run the
// longest causal rows of every head first.
template <int D>
struct FwdCfg {
  static constexpr int BQ = 128, BK = 128, STAGES = 3;
  static constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;  // two consumer warpgroups, one producer
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;        // 128 x 40 + 256 x 232 <= 65536
  // swizzle (row) bytes of the tiles: the widest of 128, 64, 32 that divides a row of D (80: 32)
  static constexpr int SWB = (D * 2) % 128 == 0 ? 128 : (D * 2) % 64 == 0 ? 64 : 32;
  static constexpr int AW = SWB / 2;  // columns of a swizzle atom
  static constexpr int Q = BQ * D;    // elements of the Q tile
  static constexpr int KV = BK * D;   // elements of a K (or V) tile
  static constexpr int kSmem = 1024 + Q * 2 + STAGES * 2 * KV * 2 + (2 * STAGES + 1) * 8;
  static_assert(KV * 2 % 1024 == 0 && Q * 2 % 1024 == 0, "tiles keep the 1024-byte alignment of their swizzle");
  static_assert(kSmem <= 232448, "fits an SM's shared memory");
};

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, 1)
    flash_fwd_bf16(const FlashParams p, const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap) {
  using C = FwdCfg<D>;
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023));  // 1024-aligned
  bf16* ring = qs + C::Q;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * 2 * C::KV);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bhs = p.b * p.hq, bh = blockIdx.x % bhs;
  const int q0 = (gridDim.x / bhs - 1 - blockIdx.x / bhs) * C::BQ;  // longest causal rows of every head first
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int n_kt = key_tiles(p, q0 + C::BQ, C::BK);

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], C::CONSUMERS / 32);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {  // the producer warpgroup: Q, then K and V of every key tile as stages empty
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == C::CONSUMERS) {
      hopper::mbar_expect(qbar, C::Q * 2);
      for (int a = 0; a < D / C::AW; ++a)
        hopper::tma_load_4d(qs + a * C::BQ * C::AW, &qmap, a * C::AW, q0, h, b, qbar);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES) hopper::mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        bf16* kt = ring + s * 2 * C::KV;
        hopper::mbar_expect(&full[s], 2 * C::KV * 2);
        for (int a = 0; a < D / C::AW; ++a) {
          hopper::tma_load_4d(kt + a * C::BK * C::AW, &kmap, a * C::AW, t * C::BK, hk, b, &full[s]);
          hopper::tma_load_4d(kt + C::KV + a * C::BK * C::AW, &vmap, a * C::AW, t * C::BK, hk, b, &full[s]);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int w0 = q0 + wg * 64;                      // this warpgroup's first row
  const int row = w0 + ((tid >> 5) & 3) * 16 + g;  // and row + 8
  const float sl2 = p.sm_scale * kLog2e;
  float o[D / 2];  // O: 64 rows x D, the m64nD accumulator layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows row, row + 8; l: this thread's columns
  float sc[C::BK / 2];         // S, then P in fp32: 64 rows x BK keys
  uint32_t pa[C::BK / 16][4];  // P as A operands, one k16 step (16 keys) each
  const bf16* qw = qs + wg * 64 * C::AW;  // this warpgroup's 64 rows (in every atom)

  auto qk = [&](int t) {  // S_t = Q K_t^T, issued
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) sc[i] = 0.f;
    hopper::reg_fence(sc);
    const bf16* kt = ring + (t % C::STAGES) * 2 * C::KV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // k step kk: atom kk * 16 / AW, columns kk * 16 % AW in it
      const int qa = (kk * 16 / C::AW) * C::BQ * C::AW + kk * 16 % C::AW;
      const int ka = (kk * 16 / C::AW) * C::BK * C::AW + kk * 16 % C::AW;
      hopper::wgmma_ss<C::BK, 0>(sc, hopper::desc_sw_k<C::SWB>(qw + qa), hopper::desc_sw_k<C::SWB>(kt + ka), 1);
    }
  };
  auto pv = [&](int t) {  // O += P_t V_t, issued
    const bf16* vt = ring + (t % C::STAGES) * 2 * C::KV + C::KV;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
      hopper::wgmma_rs<D, 1>(o, pa[kk], hopper::desc_sw_mn<C::SWB>(vt + kk * 16 * C::AW, C::BK), 1);
  };
  auto softmax = [&](int t) {  // S_t -> P_t (bf16 A operands), the new row maxima and l; O rescaled
    const int k0 = t * C::BK;
    if (k0 + C::BK > p.sk || (p.causal && k0 + C::BK - 1 > w0)) {  // the ragged or diagonal tile
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1), r = row + 8 * ((i >> 1) & 1);
        if (col >= p.sk || (p.causal && col > r)) sc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m2[hh], mx[hh] * sl2);
      alpha[hh] = hopper::exp2_approx(m2[hh] - mn);
      m2[hh] = mn;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p0 = hopper::exp2_approx(fmaf(sc[8 * kk + 2 * r], sl2, -m2[r & 1]));
        const float p1 = hopper::exp2_approx(fmaf(sc[8 * kk + 2 * r + 1], sl2, -m2[r & 1]));
        l[r & 1] += p0 + p1;
        pa[kk][r] = hopper::pack_bf16(p0, p1);
      }
  };
  // Turns on the tensor cores: warpgroup w waits on barrier 1 + w before it issues, and arrives on the
  // other's once it has issued. Warpgroup 1 opens warpgroup 0's first turn; warpgroup 0 opens warpgroup
  // 1's last one (so every arrival has its wait).
  const int mine = 1 + wg, other = 2 - wg;
  if (wg == 1) hopper::named_bar_arrive(other, C::CONSUMERS);
  hopper::mbar_wait(qbar, 0);
  hopper::mbar_wait(&full[0], 0);
  hopper::named_bar_sync(mine, C::CONSUMERS);
  hopper::wgmma_fence();
  qk(0);
  hopper::wgmma_commit();
  hopper::named_bar_arrive(other, C::CONSUMERS);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(sc);
  softmax(0);
  for (int t = 1; t < n_kt; ++t) {
    hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
    hopper::named_bar_sync(mine, C::CONSUMERS);
    hopper::wgmma_fence();
    pv(t - 1);
    qk(t);
    hopper::wgmma_commit();
    hopper::named_bar_arrive(other, C::CONSUMERS);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sc);
    hopper::reg_fence(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % C::STAGES]);  // this warp is done with tile t - 1
    softmax(t);
  }
  hopper::named_bar_sync(mine, C::CONSUMERS);
  hopper::wgmma_fence();
  pv(n_kt - 1);
  hopper::wgmma_commit();
  if (wg == 0) hopper::named_bar_arrive(other, C::CONSUMERS);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(o);

  float inv[2], lse[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const float ls = fmaxf(l[hh], 1e-30f);
    inv[hh] = 1.f / ls;
    lse[hh] = m2[hh] * kLn2 + logf(ls);
  }
  bf16* og = static_cast<bf16*>(p.out) + b * p.o_s[0] + h * p.o_s[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row + 8 * hh;
      if (r < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r * p.o_s[2] + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv[hh], o[4 * j + 2 * hh + 1] * inv[hh]);
    }
  }
  if (t4 == 0) {
    float* lg = p.lse_out + static_cast<long long>(bh) * p.sq;
    if (row < p.sq) lg[row] = lse[0];
    if (row + 8 < p.sq) lg[row + 8] = lse[1];
  }
}

// ------------------------------------------------------------------- bf16 dq
// On wgmma, along the forward's structure (flash_fwd_bf16). A CTA of two
// consumer warpgroups owns BQ = 128 query rows (64 a warpgroup, wgmma's M) of
// one (batch, q head); a third warpgroup is the producer, one thread of which
// loads the Q and dO tiles once by TMA (4-D tensor maps over the strided
// [B, H, S, D] views: no copy), then streams key tiles of BK = 64 rows of K
// and V through a ring of STAGES buffers, each stage with a `full` mbarrier
// (the bytes landed) and an `empty` one (the 8 consumer warps are done with
// it); the producer gives its registers to the consumers (setmaxnreg). Every
// tile is swizzled (hopper.cuh; 32-byte atoms at D 80). lse and delta of a
// thread's two rows are read once into registers. Per key tile t, a
// warpgroup's tensor-core phase issues
//   dQ += dS_{t-1} K_{t-1}    (wgmma, dS as bf16 A fragments in registers, K
//                              the same tile read MN-major: no transposed copy),
//   S_t = Q K_t^T, dP_t = dO V_t^T   (wgmma, both operands in shared memory),
// waits for them, releases tile t - 1, and then computes in registers (fp32)
// P = exp2(S sm_scale log2(e) - lse log2(e)) and dS = P (dP - delta) sm_scale,
// masked only on the diagonal tile and the ragged last one (causal tiles above
// the diagonal are never loaded), rounded to bf16 A fragments. The two
// warpgroups take turns on the tensor cores (two named barriers), so one
// warpgroup's exponentials overlap the other's products. Registers set BK: at
// D 128 a consumer thread holds dQ (64 fp32), S and dP (32 each) and dS (16),
// which 128-key tiles would double past CONSUMER_REGS. dQ is written once from
// registers: no atomics, bitwise repeatable. CTAs run the longest causal rows
// of every head first.
template <int D>
struct DqCfg {
  static constexpr int BQ = 128, BK = 64, STAGES = 4;
  static constexpr int CONSUMERS = 256, THREADS = CONSUMERS + 128;  // two consumer warpgroups, one producer
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;        // 128 x 40 + 256 x 232 <= 65536
  // swizzle (row) bytes of the tiles: the widest of 128, 64, 32 that divides a row of D (80: 32)
  static constexpr int SWB = (D * 2) % 128 == 0 ? 128 : (D * 2) % 64 == 0 ? 64 : 32;
  static constexpr int AW = SWB / 2;  // columns of a swizzle atom
  static constexpr int Q = BQ * D;    // elements of the Q (or dO) tile
  static constexpr int KV = BK * D;   // elements of a K (or V) tile
  static constexpr int kSmem = 1024 + 2 * Q * 2 + STAGES * 2 * KV * 2 + (2 * STAGES + 1) * 8;
  static_assert(KV * 2 % 1024 == 0 && Q * 2 % 1024 == 0, "tiles keep the 1024-byte alignment of their swizzle");
  static_assert(kSmem <= 232448, "fits an SM's shared memory");
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::THREADS, 1)
    flash_bwd_dq_bf16(const FlashParams p, const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap) {
  using C = DqCfg<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023));  // 1024-aligned
  bf16* dos = qs + C::Q;
  bf16* ring = dos + C::Q;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * 2 * C::KV);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int bhs = p.b * p.hq, bh = blockIdx.x % bhs;
  const int q0 = (gridDim.x / bhs - 1 - blockIdx.x / bhs) * C::BQ;  // longest causal rows of every head first
  const int b = bh / p.hq, h = bh % p.hq, hk = h / (p.hq / p.hkv);
  const int n_kt = key_tiles(p, q0 + C::BQ, C::BK);

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], C::CONSUMERS / 32);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {  // the producer warpgroup: Q and dO, then K and V of every key tile as stages empty
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == C::CONSUMERS) {
      hopper::mbar_expect(qbar, 2 * C::Q * 2);
      for (int a = 0; a < D / C::AW; ++a) {
        hopper::tma_load_4d(qs + a * C::BQ * C::AW, &qmap, a * C::AW, q0, h, b, qbar);
        hopper::tma_load_4d(dos + a * C::BQ * C::AW, &omap, a * C::AW, q0, h, b, qbar);
      }
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % C::STAGES;
        if (t >= C::STAGES) hopper::mbar_wait(&empty[s], (t / C::STAGES - 1) & 1);
        bf16* kt = ring + s * 2 * C::KV;
        hopper::mbar_expect(&full[s], 2 * C::KV * 2);
        for (int a = 0; a < D / C::AW; ++a) {
          hopper::tma_load_4d(kt + a * C::BK * C::AW, &kmap, a * C::AW, t * C::BK, hk, b, &full[s]);
          hopper::tma_load_4d(kt + C::KV + a * C::BK * C::AW, &vmap, a * C::AW, t * C::BK, hk, b, &full[s]);
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int w0 = q0 + wg * 64;                      // this warpgroup's first row
  const int row = w0 + ((tid >> 5) & 3) * 16 + g;  // and row + 8
  const float sl2 = p.sm_scale * kLog2e;
  float lse2[2], dl[2];  // lse log2(e) and delta of rows row, row + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    const long long at = static_cast<long long>(bh) * p.sq + r;
    lse2[hh] = r < p.sq ? p.lse_in[at] * kLog2e : 0.f;
    dl[hh] = r < p.sq ? p.delta[at] : 0.f;
  }
  float dq[D / 2];  // dQ: 64 rows x D, the m64nD accumulator layout
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float sc[C::BK / 2], dp[C::BK / 2];  // S and dP: 64 rows x BK keys
  uint32_t da[C::BK / 16][4];          // dS as A operands, one k16 step (16 keys) each
  const bf16* qw = qs + wg * 64 * C::AW;  // this warpgroup's 64 rows (in every atom)
  const bf16* ow = dos + wg * 64 * C::AW;

  auto sdp = [&](int t) {  // S_t = Q K_t^T and dP_t = dO V_t^T, issued
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) sc[i] = dp[i] = 0.f;
    hopper::reg_fence(sc);
    hopper::reg_fence(dp);
    const bf16* kt = ring + (t % C::STAGES) * 2 * C::KV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // k step kk: atom kk * 16 / AW, columns kk * 16 % AW in it
      const int qa = (kk * 16 / C::AW) * C::BQ * C::AW + kk * 16 % C::AW;
      const int ka = (kk * 16 / C::AW) * C::BK * C::AW + kk * 16 % C::AW;
      hopper::wgmma_ss<C::BK, 0>(sc, hopper::desc_sw_k<C::SWB>(qw + qa), hopper::desc_sw_k<C::SWB>(kt + ka), 1);
      hopper::wgmma_ss<C::BK, 0>(dp, hopper::desc_sw_k<C::SWB>(ow + qa), hopper::desc_sw_k<C::SWB>(kt + C::KV + ka),
                                 1);
    }
  };
  auto dsk = [&](int t) {  // dQ += dS_t K_t, issued
    const bf16* kt = ring + (t % C::STAGES) * 2 * C::KV;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
      hopper::wgmma_rs<D, 1>(dq, da[kk], hopper::desc_sw_mn<C::SWB>(kt + kk * 16 * C::AW, C::BK), 1);
  };
  auto grads = [&](int t) {  // S_t, dP_t -> dS_t (bf16 A operands)
    const int k0 = t * C::BK;
    if (k0 + C::BK > p.sk || (p.causal && k0 + C::BK - 1 > w0)) {  // the ragged or diagonal tile
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1), r = row + 8 * ((i >> 1) & 1);
        if (col >= p.sk || (p.causal && col > r)) sc[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float p0 = hopper::exp2_approx(fmaf(sc[i], sl2, -lse2[r & 1]));
        const float p1 = hopper::exp2_approx(fmaf(sc[i + 1], sl2, -lse2[r & 1]));
        da[kk][r] = hopper::pack_bf16(p0 * (dp[i] - dl[r & 1]) * p.sm_scale, p1 * (dp[i + 1] - dl[r & 1]) * p.sm_scale);
      }
  };
  // Turns on the tensor cores, as in the forward: warpgroup w waits on barrier 1 + w before it issues, and
  // arrives on the other's once it has issued. Warpgroup 1 opens warpgroup 0's first turn; warpgroup 0
  // opens warpgroup 1's last one (so every arrival has its wait).
  const int mine = 1 + wg, other = 2 - wg;
  if (wg == 1) hopper::named_bar_arrive(other, C::CONSUMERS);
  hopper::mbar_wait(qbar, 0);
  hopper::mbar_wait(&full[0], 0);
  hopper::named_bar_sync(mine, C::CONSUMERS);
  hopper::wgmma_fence();
  sdp(0);
  hopper::wgmma_commit();
  hopper::named_bar_arrive(other, C::CONSUMERS);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(sc);
  hopper::reg_fence(dp);
  grads(0);
  for (int t = 1; t < n_kt; ++t) {
    hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
    hopper::named_bar_sync(mine, C::CONSUMERS);
    hopper::wgmma_fence();
    dsk(t - 1);
    sdp(t);
    hopper::wgmma_commit();
    hopper::named_bar_arrive(other, C::CONSUMERS);
    hopper::wgmma_wait<0>();
    hopper::reg_fence(sc);
    hopper::reg_fence(dp);
    hopper::reg_fence(dq);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[(t - 1) % C::STAGES]);  // this warp is done with tile t - 1
    grads(t);
  }
  hopper::named_bar_sync(mine, C::CONSUMERS);
  hopper::wgmma_fence();
  dsk(n_kt - 1);
  hopper::wgmma_commit();
  if (wg == 0) hopper::named_bar_arrive(other, C::CONSUMERS);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(dq);

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_s[0] + h * p.dq_s[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row + 8 * hh;
      if (r < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(dqg + r * p.dq_s[2] + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
    }
  }
}

// ------------------------------------------------------------------ bf16 dkv
// On wgmma, along FlashAttention-3's backward. A CTA of two warpgroups owns
// BKV = 128 key rows (64 a warpgroup, wgmma's M). K and V of those rows are
// loaded once into shared memory; the dK and dV accumulators stay in
// registers for the whole kernel. Query tiles of BQ = 64 rows of Q and dO
// stream through a ring of STAGES buffers by TMA (4-D tensor maps over the
// strided [B, H, S, D] views, built per launch), their lse and delta beside
// them by cp.async, one mbarrier a stage. Every tile is swizzled (hopper.cuh;
// 32-byte atoms at D 80). Per tile:
//   S^T = K Q^T and dP^T = V dO^T   (wgmma, both operands in shared memory,
//                                     Q and dO read K-major),
//   P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale  (fp32, in
//                                     registers, masked; then bf16 A operands),
//   dV += P^T dO and dK += dS^T Q   (wgmma, A in registers, B the same Q and
//                                     dO tiles read MN-major: no transposed copy).
// The tiles of the group's q heads run in one loop (head by head), so dk/dv
// are summed over the group in a fixed order: no atomics, bitwise repeatable.
template <int D>
struct DkvCfg {
  static constexpr int BKV = 128, BQ = 64, STAGES = 3, THREADS = 256;
  // swizzle (row) bytes of the tiles: the widest of 128, 64, 32 that divides a row of D (80: 32)
  static constexpr int SWB = (D * 2) % 128 == 0 ? 128 : (D * 2) % 64 == 0 ? 64 : 32;
  static constexpr int AW = SWB / 2;  // columns of a swizzle atom
  static constexpr int KV = BKV * D;  // elements of the K (or V) tile
  static constexpr int T = BQ * D;    // elements of a Q (or dO) tile
  static constexpr int kSmem = 1024 + 2 * KV * 2 + STAGES * 2 * T * 2 + STAGES * 2 * BQ * 4 + STAGES * 8;
  static_assert(T * 2 % 1024 == 0, "tiles keep the 1024-byte alignment of their swizzle");
};

template <int D>
__global__ void __launch_bounds__(256, 1) flash_bwd_dkv_bf16(const FlashParams p, const __grid_constant__ CUtensorMap qmap,
                                                             const __grid_constant__ CUtensorMap omap) {
  using C = DkvCfg<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023));  // 1024-aligned
  bf16* vs = ks + C::KV;
  bf16* ring = vs + C::KV;                                      // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + C::STAGES * 2 * C::T);  // stage s: lse, then delta
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + C::STAGES * 2 * C::BQ);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * C::BKV;
  const int b = blockIdx.y / p.hkv, hk = blockIdx.y % p.hkv, group = p.hq / p.hkv;
  const int key = k0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;  // and key + 8
  const float sl2 = p.sm_scale * kLog2e;

  const int n_qt = (p.sq + C::BQ - 1) / C::BQ;
  const int qt0 = p.causal ? k0 / C::BQ : 0;
  const int per_head = max(n_qt - qt0, 0);
  const int total = group * per_head;  // query tiles over the group's q heads

  // tile t of the loop into ring stage t % STAGES: Q and dO by TMA (thread 0), lse and delta by cp.async
  // (threads 128..255)
  auto issue = [&](int t) {
    const int s = t % C::STAGES, h = hk * group + t / per_head, q0 = (qt0 + t % per_head) * C::BQ;
    bf16* qd = ring + s * 2 * C::T;
    if (tid >= C::THREADS - 2 * C::BQ) {
      const int i = tid - (C::THREADS - 2 * C::BQ), r = i % C::BQ;
      const float* src = (i < C::BQ ? p.lse_in : p.delta) + (static_cast<long long>(b) * p.hq + h) * p.sq + q0 + r;
      const bool in = q0 + r < p.sq;
      hopper::cp_async4(stats + s * 2 * C::BQ + i, in ? src : p.lse_in, in);
      hopper::cp_async_arrive(&full[s]);
    }
    if (tid == 0) {
      hopper::mbar_expect(&full[s], 2 * C::T * 2);
      for (int a = 0; a < D / C::AW; ++a) {
        hopper::tma_load_4d(qd + a * C::BQ * C::AW, &qmap, a * C::AW, q0, h, b, &full[s]);
        hopper::tma_load_4d(qd + C::T + a * C::BQ * C::AW, &omap, a * C::AW, q0, h, b, &full[s]);
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) hopper::mbar_init(&full[s], 2 * C::BQ + 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  for (int t = 0; t < C::STAGES && t < total; ++t) issue(t);
  hopper::cp_tile_sw<C::SWB, D, C::BKV, C::THREADS>(
      ks, static_cast<const bf16*>(p.k) + b * p.k_s[0] + hk * p.k_s[1], p.k_s[2], k0, p.sk, tid);
  hopper::cp_tile_sw<C::SWB, D, C::BKV, C::THREADS>(
      vs, static_cast<const bf16*>(p.v) + b * p.v_s[0] + hk * p.v_s[1], p.v_s[2], k0, p.sk, tid);
  hopper::cp_async_wait_all();
  hopper::fence_async_smem();  // K and V, written by cp.async, read by wgmma
  __syncthreads();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const bf16* kw = ks + wg * 64 * C::AW;  // this warpgroup's 64 key rows (in every atom)
  const bf16* vw = vs + wg * 64 * C::AW;

  for (int t = 0; t < total; ++t) {
    const int s = t % C::STAGES, q0 = (qt0 + t % per_head) * C::BQ;
    const bf16* qt = ring + s * 2 * C::T;
    const bf16* dot = qt + C::T;
    const float* lse_s = stats + s * 2 * C::BQ;
    const float* dl_s = lse_s + C::BQ;
    hopper::mbar_wait(&full[s], (t / C::STAGES) & 1);
    hopper::fence_async_smem();

    float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 queries, the m64n64 accumulator layout
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // k step kk: atom kk * 16 / AW, columns kk * 16 % AW in it
      const int ka = (kk * 16 / C::AW) * C::BKV * C::AW + kk * 16 % C::AW;
      const int qa = (kk * 16 / C::AW) * C::BQ * C::AW + kk * 16 % C::AW;
      hopper::wgmma_ss<64, 0>(st, hopper::desc_sw_k<C::SWB>(kw + ka), hopper::desc_sw_k<C::SWB>(qt + qa), 1);
      hopper::wgmma_ss<64, 0>(dpt, hopper::desc_sw_k<C::SWB>(vw + ka), hopper::desc_sw_k<C::SWB>(dot + qa), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(st);
    hopper::reg_fence(dpt);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = (i >> 2) * 8 + 2 * t4 + (i & 1), qpos = q0 + qc, kpos = key + 8 * ((i >> 1) & 1);
      const bool ok = qpos < p.sq && (!p.causal || qpos >= kpos);
      const float pr = ok ? exp2f(fmaf(st[i], sl2, -lse_s[qc] * kLog2e)) : 0.f;
      st[i] = pr;
      dpt[i] = pr * (dpt[i] - dl_s[qc]) * p.sm_scale;  // dS^T
    }
    uint32_t pa[4][4], da[4][4];  // P^T and dS^T as A operands, one k16 step (16 queries) each
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = hopper::pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = hopper::pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_rs<D, 1>(dv, pa[kk], hopper::desc_sw_mn<C::SWB>(dot + kk * 16 * C::AW, C::BQ), 1);
      hopper::wgmma_rs<D, 1>(dk, da[kk], hopper::desc_sw_mn<C::SWB>(qt + kk * 16 * C::AW, C::BQ), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::reg_fence(dk);
    hopper::reg_fence(dv);
    __syncthreads();  // every read of stage s done before it is refilled
    if (t + C::STAGES < total) issue(t + C::STAGES);
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_s[0] + hk * p.dk_s[1];
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_s[0] + hk * p.dv_s[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = key + 8 * half;
      if (row < p.sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + row * p.dk_s[2] + col) =
            __floats2bfloat162_rn(dk[4 * j + 2 * half], dk[4 * j + 2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvg + row * p.dv_s[2] + col) =
            __floats2bfloat162_rn(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ fp32 path
// One row per thread on the CUDA cores; key (or query) tiles of 32 rows are
// staged in shared memory and read as broadcasts.
constexpr int kRowsF = 64;  // rows (threads) per CTA
constexpr int kTileF = 32;  // staged rows per tile

template <int D>
__device__ __forceinline__ void load_rows_f32(float* smem, const float* g, long long rs, int r0, int n, int tid) {
  for (int i = tid; i < kTileF * (D / 4); i += kRowsF) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) v = *reinterpret_cast<const float4*>(g + (r0 + r) * rs + c);
    *reinterpret_cast<float4*>(smem + r * D + c) = v;
  }
}

template <int D>
__device__ __forceinline__ void load_row_f32(float* dst, const float* g, long long rs, int r, int n) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = r < n ? g[r * rs + d] : 0.f;
}

template <int D>
__device__ __forceinline__ float dot_f32(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int D>
__global__ void __launch_bounds__(kRowsF) flash_fwd_f32(const FlashParams p) {
  __shared__ __align__(16) float ks[kTileF * D];
  __shared__ __align__(16) float vs[kTileF * D];
  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF, row = q0 + tid;
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq, hk = h / (p.hq / p.hkv);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_s[0] + hk * p.k_s[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_s[0] + hk * p.v_s[1];
  float q[D], acc[D];
  load_row_f32<D>(q, static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[1], p.q_s[2], row, p.sq);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] *= p.sm_scale;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int n_kt = key_tiles(p, q0 + kRowsF, kTileF);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileF;
    load_rows_f32<D>(ks, kg, p.k_s[2], k0, p.sk, tid);
    load_rows_f32<D>(vs, vg, p.v_s[2], k0, p.sk, tid);
    __syncthreads();
    float s[kTileF];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const int col = k0 + j;
      const bool ok = col < p.sk && (!p.causal || row >= col);
      s[j] = ok ? dot_f32<D>(q, ks + j * D) : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTileF; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[j * D + d], acc[d]);
    }
    __syncthreads();
  }
  if (row < p.sq) {
    const float ls = fmaxf(l, 1e-30f);
    float* og = static_cast<float*>(p.out) + b * p.o_s[0] + h * p.o_s[1] + row * p.o_s[2];
#pragma unroll
    for (int d = 0; d < D; ++d) og[d] = acc[d] / ls;
    p.lse_out[static_cast<long long>(blockIdx.y) * p.sq + row] = m + logf(ls);
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF) flash_bwd_dq_f32(const FlashParams p) {
  __shared__ __align__(16) float ks[kTileF * D];
  __shared__ __align__(16) float vs[kTileF * D];
  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF, row = q0 + tid;
  const int b = blockIdx.y / p.hq, h = blockIdx.y % p.hq, hk = h / (p.hq / p.hkv);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_s[0] + hk * p.k_s[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_s[0] + hk * p.v_s[1];
  float q[D], dout[D], dq[D];
  load_row_f32<D>(q, static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[1], p.q_s[2], row, p.sq);
  load_row_f32<D>(dout, static_cast<const float*>(p.dout) + b * p.o_s[0] + h * p.o_s[1], p.o_s[2], row, p.sq);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] *= p.sm_scale;
    dq[d] = 0.f;
  }
  const long long ri = static_cast<long long>(blockIdx.y) * p.sq + row;
  const float lse = row < p.sq ? p.lse_in[ri] : 0.f, dl = row < p.sq ? p.delta[ri] : 0.f;
  const int n_kt = key_tiles(p, q0 + kRowsF, kTileF);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTileF;
    load_rows_f32<D>(ks, kg, p.k_s[2], k0, p.sk, tid);
    load_rows_f32<D>(vs, vg, p.v_s[2], k0, p.sk, tid);
    __syncthreads();
    for (int j = 0; j < kTileF; ++j) {
      const int col = k0 + j;
      if (!(col < p.sk && (!p.causal || row >= col))) continue;
      const float pj = expf(dot_f32<D>(q, ks + j * D) - lse);
      const float ds = pj * (dot_f32<D>(dout, vs + j * D) - dl) * p.sm_scale;
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[j * D + d], dq[d]);
    }
    __syncthreads();
  }
  if (row < p.sq) {
    float* g = static_cast<float*>(p.dq) + b * p.dq_s[0] + h * p.dq_s[1] + row * p.dq_s[2];
#pragma unroll
    for (int d = 0; d < D; ++d) g[d] = dq[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kRowsF) flash_bwd_dkv_f32(const FlashParams p) {
  __shared__ __align__(16) float qs[kTileF * D];
  __shared__ __align__(16) float dos[kTileF * D];
  __shared__ float lse_s[kTileF], dl_s[kTileF];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kRowsF, key = k0 + tid;
  const int b = blockIdx.y / p.hkv, hk = blockIdx.y % p.hkv, group = p.hq / p.hkv;
  float k[D], v[D], dk[D], dv[D];
  load_row_f32<D>(k, static_cast<const float*>(p.k) + b * p.k_s[0] + hk * p.k_s[1], p.k_s[2], key, p.sk);
  load_row_f32<D>(v, static_cast<const float*>(p.v) + b * p.v_s[0] + hk * p.v_s[1], p.v_s[2], key, p.sk);
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;
  const int n_qt = (p.sq + kTileF - 1) / kTileF;
  const int qt0 = p.causal ? k0 / kTileF : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_s[0] + h * p.q_s[1];
    const float* dog = static_cast<const float*>(p.dout) + b * p.o_s[0] + h * p.o_s[1];
    const long long rb = (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTileF;
      load_rows_f32<D>(qs, qg, p.q_s[2], q0, p.sq, tid);
      load_rows_f32<D>(dos, dog, p.o_s[2], q0, p.sq, tid);
      if (tid < kTileF) {
        const bool in = q0 + tid < p.sq;
        lse_s[tid] = in ? p.lse_in[rb + q0 + tid] : 0.f;
        dl_s[tid] = in ? p.delta[rb + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kTileF; ++j) {
        const int qpos = q0 + j;
        if (!(qpos < p.sq && (!p.causal || qpos >= key))) continue;
        const float* qj = qs + j * D;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qj[d] * p.sm_scale, k[d], s);
        const float pj = expf(s - lse_s[j]);
        const float ds = pj * (dot_f32<D>(dos + j * D, v) - dl_s[j]) * p.sm_scale;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv[d] = fmaf(pj, dos[j * D + d], dv[d]);
          dk[d] = fmaf(ds, qj[d], dk[d]);
        }
      }
      __syncthreads();
    }
  }
  if (key < p.sk) {
    float* kgo = static_cast<float*>(p.dk) + b * p.dk_s[0] + hk * p.dk_s[1] + key * p.dk_s[2];
    float* vgo = static_cast<float*>(p.dv) + b * p.dv_s[0] + hk * p.dv_s[1] + key * p.dv_s[2];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kgo[d] = dk[d];
      vgo[d] = dv[d];
    }
  }
}

// ------------------------------------------------------------------ launch
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// A [B, H, S, D] bf16 view (element strides `st` over batch, head, row; unit
// stride along D) as a TMA tensor map with boxes of one swizzle atom x `rows`.
template <int SWB>
cudaError_t bhsd_map(CUtensorMap* map, const void* base, const long long* st, int d, int s, int h, int b, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2, static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {SWB / 2, static_cast<cuuint32_t>(rows), 1, 1};
  return hopper::make_tensor_map<SWB>(map, base, 4, dims, strides, box);
}

template <int D, int W>
int launch_dw(const FlashParams& p, int dtype, cudaStream_t s) {
  const int bh_q = p.b * p.hq, bh_kv = p.b * p.hkv;
  if (dtype == 1) {
    if constexpr (W == kFwd) {
      using C = FwdCfg<D>;
      const cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      CUtensorMap qmap, kmap, vmap;
      cudaError_t me = bhsd_map<C::SWB>(&qmap, p.q, p.q_s, D, p.sq, p.hq, p.b, C::BQ);
      if (me == cudaSuccess) me = bhsd_map<C::SWB>(&kmap, p.k, p.k_s, D, p.sk, p.hkv, p.b, C::BK);
      if (me == cudaSuccess) me = bhsd_map<C::SWB>(&vmap, p.v, p.v_s, D, p.sk, p.hkv, p.b, C::BK);
      if (me != cudaSuccess) return static_cast<int>(me);
      flash_fwd_bf16<D><<<((p.sq + C::BQ - 1) / C::BQ) * bh_q, C::THREADS, C::kSmem, s>>>(p, qmap, kmap, vmap);
    } else if constexpr (W == kDq) {
      using C = DqCfg<D>;
      const cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      CUtensorMap qmap, omap, kmap, vmap;
      cudaError_t me = bhsd_map<C::SWB>(&qmap, p.q, p.q_s, D, p.sq, p.hq, p.b, C::BQ);
      if (me == cudaSuccess) me = bhsd_map<C::SWB>(&omap, p.dout, p.o_s, D, p.sq, p.hq, p.b, C::BQ);
      if (me == cudaSuccess) me = bhsd_map<C::SWB>(&kmap, p.k, p.k_s, D, p.sk, p.hkv, p.b, C::BK);
      if (me == cudaSuccess) me = bhsd_map<C::SWB>(&vmap, p.v, p.v_s, D, p.sk, p.hkv, p.b, C::BK);
      if (me != cudaSuccess) return static_cast<int>(me);
      flash_bwd_dq_bf16<D><<<((p.sq + C::BQ - 1) / C::BQ) * bh_q, C::THREADS, C::kSmem, s>>>(p, qmap, omap, kmap, vmap);
    } else {
      using C = DkvCfg<D>;
      const cudaError_t e =
          cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      // Q and dO [B, H, S, D] (any strides) as TMA tensor maps: boxes of one swizzle atom x BQ rows
      CUtensorMap qmap, omap;
      cudaError_t me = bhsd_map<C::SWB>(&qmap, p.q, p.q_s, D, p.sq, p.hq, p.b, C::BQ);
      if (me == cudaSuccess) me = bhsd_map<C::SWB>(&omap, p.dout, p.o_s, D, p.sq, p.hq, p.b, C::BQ);
      if (me != cudaSuccess) return static_cast<int>(me);
      flash_bwd_dkv_bf16<D><<<dim3((p.sk + C::BKV - 1) / C::BKV, bh_kv), C::THREADS, C::kSmem, s>>>(p, qmap, omap);
    }
  } else if (dtype == 0) {
    if constexpr (W == kFwd) {
      flash_fwd_f32<D><<<dim3((p.sq + kRowsF - 1) / kRowsF, bh_q), kRowsF, 0, s>>>(p);
    } else if constexpr (W == kDq) {
      flash_bwd_dq_f32<D><<<dim3((p.sq + kRowsF - 1) / kRowsF, bh_q), kRowsF, 0, s>>>(p);
    } else {
      flash_bwd_dkv_f32<D><<<dim3((p.sk + kRowsF - 1) / kRowsF, bh_kv), kRowsF, 0, s>>>(p);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The part that compiles the (head dim, kernel) pair: 1-3 head dim 128's
// forward, dq and dkv, 4 head dim 80, 5 head dims 16, 32 and 64. Part 1 also
// holds the entry points and hands the other pairs to mt_flash_launch_part<N>.
constexpr int part_of(int d, int which) { return d == 128 ? 1 + which : d == 80 ? 4 : 5; }

constexpr bool here(int d, int which) {
#if defined(MT_FLASH_PART)
  return part_of(d, which) == MT_FLASH_PART;
#else
  return true;
#endif
}

template <int D>
int launch_d(const FlashParams& p, int which, int dtype, cudaStream_t s) {
  if (which == kFwd) {
    if constexpr (here(D, kFwd)) return launch_dw<D, kFwd>(p, dtype, s);
  } else if (which == kDq) {
    if constexpr (here(D, kDq)) return launch_dw<D, kDq>(p, dtype, s);
  } else if (which == kDkv) {
    if constexpr (here(D, kDkv)) return launch_dw<D, kDkv>(p, dtype, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the pairs this unit compiles
int launch_here(const FlashParams* p, int d, int which, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(*p, which, dtype, s);
    case 32: return launch_d<32>(*p, which, dtype, s);
    case 64: return launch_d<64>(*p, which, dtype, s);
    case 80: return launch_d<80>(*p, which, dtype, s);
    case 128: return launch_d<128>(*p, which, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#if defined(MT_FLASH_PART) && MT_FLASH_PART > 1
#define MT_FLASH_CAT(a, b) a##b
#define MT_FLASH_ENTRY(n) MT_FLASH_CAT(mt_flash_launch_part, n)
extern "C" int MT_FLASH_ENTRY(MT_FLASH_PART)(const FlashParams* p, int d, int which, int dtype, void* stream) {
  return launch_here(p, d, which, dtype, stream);
}
#else
#if defined(MT_FLASH_PART)
extern "C" int mt_flash_launch_part2(const FlashParams* p, int d, int which, int dtype, void* stream);
extern "C" int mt_flash_launch_part3(const FlashParams* p, int d, int which, int dtype, void* stream);
extern "C" int mt_flash_launch_part4(const FlashParams* p, int d, int which, int dtype, void* stream);
extern "C" int mt_flash_launch_part5(const FlashParams* p, int d, int which, int dtype, void* stream);
#endif

namespace {

int launch(const FlashParams* p, int d, int which, int dtype, void* stream) {
  if (p->b <= 0 || p->sq <= 0 || p->sk <= 0 || p->hkv <= 0 || p->hq % p->hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d != 16 && d != 32 && d != 64 && d != 80 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
#if defined(MT_FLASH_PART)
  switch (part_of(d, which)) {
    case 2: return mt_flash_launch_part2(p, d, which, dtype, stream);
    case 3: return mt_flash_launch_part3(p, d, which, dtype, stream);
    case 4: return mt_flash_launch_part4(p, d, which, dtype, stream);
    case 5: return mt_flash_launch_part5(p, d, which, dtype, stream);
    default: break;
  }
#endif
  return launch_here(p, d, which, dtype, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor but lse/delta). d: head dim,
// one of 16, 32, 64, 80, 128. Pointers and strides must give 16-byte aligned
// rows (the wrapper checks). Each returns cudaGetLastError() after its launch.
extern "C" int mt_flash_fwd(const FlashParams* p, int d, int dtype, void* stream) {
  return launch(p, d, kFwd, dtype, stream);
}

extern "C" int mt_flash_bwd_dq(const FlashParams* p, int d, int dtype, void* stream) {
  return launch(p, d, kDq, dtype, stream);
}

extern "C" int mt_flash_bwd_dkv(const FlashParams* p, int d, int dtype, void* stream) {
  return launch(p, d, kDkv, dtype, stream);
}
#endif  // the entry points
