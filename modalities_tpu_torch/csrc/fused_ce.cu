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
// tensor cores, not memory, become the limit. What a kernel re-reads from L2
// is the next limit: the forward reads h and W again for every tile of the
// other, 59 GB at its tiles (128 rows x 256 vocab rows).
//
// Design:
// - bf16 forward (redesigned for Hopper): a GEMM mainloop on wgmma, h and W
//   chunks by TMA through a ring, with the online softmax as its epilogue in
//   registers; vocab split over 8 CTAs a row block and merged by a second
//   kernel; see ce_fwd_bf16 below. It needs sm_90a (wgmma).
// - bf16 dh and dW (redesigned for Hopper): a thread-block cluster of 8 CTAs
//   splits E and owns 128 rows of the matrix whose gradient it writes (h for
//   dh, W for dW), keeps that block's E-slice in registers, streams the other
//   matrix by TMA, sums the partial s of the 8 slices through distributed
//   shared memory in a fixed order and carries ds to the tensor cores as bf16
//   hi + lo, ds - hi (two products a tile, about 16 mantissa bits, near the
//   TPU kernel's fp32 ds); see ce_dh_bf16 and ce_dw_bf16 below. The gradient
//   of a 128-row block lives in the registers of its cluster, so every output
//   element is summed by one thread in a fixed order: no atomics, bitwise
//   repeatable. E in {128, 256, 1536} on a cluster of 8 (slices of E / 8);
//   E = 4096 on a cluster of 16 (slices of 256), see "E = 4096" below.
// - fp32: one warp per output row on the CUDA cores (lanes split E, a fixed
//   xor-butterfly sum), plain FMA, no TF32: the version the plain PyTorch code
//   is held to in f32, at small shapes.
// Out-of-range rows on either side are zero-filled and masked (streamed vocab
// columns past V take no part in the softmax; rows past N carry gm 0); all
// flat offsets are 64-bit (N V reaches 1.65e9 at the 32k shape).
//
// E = 4096 (the 7B's width). A cluster of 8 would give each CTA a 512-column
// slice: 128 A-fragment registers a thread for the resident block and 256 for
// its [128, 512] fp32 accumulator (256 KB, an SM's whole register file), and
// 64 KB W (or h) tiles, four of them 256 KB of shared memory. So dh and dW
// keep BM = 128 (the streamed matrix is still read once per 128 rows) and
// split E over a cluster of CL = 16 CTAs, slices of SE = 256. What a thread
// holds across the tile loop: 64 registers of A fragments (the resident
// slice), 128 of accumulator ([64 rows, 256] a warpgroup), 32 of partial s: 224
// of the 255 a thread may have at 256 threads an SM. Shared memory: dh 3 x 32
// KB W stages, 4 x 16 KB ds tiles, 2 x 32 KB partial-s buffers (send,
// receive) and the 1 KB alignment slack, 230,448 bytes; dW the same with its
// partial rows unpadded (permuted 8-column chunks, as dh's) and two slots of
// token statistics, 231,984 bytes (of 232,448). With three stages a tile is
// loaded one tile ahead of the partial s that reads it (four stages: two
// ahead). Each CTA reduces RM = 8 rows of a tile, two columns a thread. A
// cluster above 8 CTAs is non-portable (cudaFuncAttributeNonPortable-
// ClusterSizeAllowed); at one CTA an SM it needs 16 free SMs of one GPC, and
// `mt_fused_ce_clusters` reports how many such clusters the card holds at
// once (cudaOccupancyMaxActiveClusters; 7 on an H100 SXM, 15 of 8 CTAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
  float* part;          // bf16 forward: [3, splits, N] partial (m2, l, corr) of each vocab split
  int n, v, e;
  int splits;           // bf16 forward: vocab splits (CTAs a row block)
};

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNegInf = -1e30f;
enum Mode { kFwd = 0, kDh = 1, kDw = 2 };

// ------------------------------------------------------- bf16 forward (wgmma)
// A GEMM mainloop with a softmax epilogue. A CTA of two warpgroups owns BM =
// 128 rows of h (64 a warpgroup, wgmma's M) and walks its split's vocab tiles
// of BV = 256 rows of W. For each tile it accumulates s [128, 256] = h W^T
// over E in chunks of BK = 64 columns: the chunk of h and of W arrive by TMA
// (2-D tensor maps, 128-byte swizzle) through a ring of STAGES buffers, one
// `full` mbarrier a stage (the bytes landed) and one `empty` mbarrier (its 8
// warps have read it; thread 0 then refills it), and feed wgmma with both
// operands K-major in shared memory; one wgmma group stays in flight while
// the next chunk is waited for.
// The finished tile is folded into each row's running m2 (the max of s
// log2(e)), l and corr in registers (two rows a thread, quad shuffles);
// vocab columns past V are masked to -inf, never left at s = 0. Nothing of s
// goes through shared or global memory. So h is read V / 256 times and W N /
// 128 times from L2 (39.5 GB of W and 19.7 GB of h at the 32k shape). V is
// split over `splits` CTAs a row block (neighbours in launch order, so the
// CTAs on the card share few row blocks of h and each split's W tiles);
// ce_fwd_combine merges the splits' (m2, l, corr) per row in split order: no
// atomics, bitwise repeatable, and lse = m + log(max(l, 1e-37)) as the
// contract has it.
// What bounds it: 59 GB of L2 reads a call at the 32k shape against 5.1e12
// FLOPs (5.1 ms on the tensor cores); at its 10.3 ms on an H100 (PERF.md)
// that is 5.8 TB/s from L2, so L2 traffic, not the tensor cores, is the
// likely limit. A cluster of two row blocks sharing each W chunk by TMA
// multicast would cut it to 39.5 GB.
struct FwdCfg {
  static constexpr int BM = 128, BV = 256, BK = 64, STAGES = 4, THREADS = 256;
  static constexpr int H_TILE = BM * BK, W_TILE = BV * BK;  // elements; rows of 128 bytes (one swizzle atom)
  static constexpr int kSmem = 1024 + STAGES * (H_TILE + W_TILE) * 2 + 2 * STAGES * 8;
};

__global__ void __launch_bounds__(256, 1) ce_fwd_bf16(const CEParams p, const __grid_constant__ CUtensorMap hmap,
                                                      const __grid_constant__ CUtensorMap wmap) {
  using C = FwdCfg;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023));  // 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * (C::H_TILE + C::W_TILE));
  uint64_t* empty = full + C::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x % p.splits, r0 = (blockIdx.x / p.splits) * C::BM;
  const int n_vt = (p.v + C::BV - 1) / C::BV;
  const int vt0 = static_cast<int>(static_cast<long long>(split) * n_vt / p.splits);
  const int vt1 = static_cast<int>(static_cast<long long>(split + 1) * n_vt / p.splits);
  const int n_kc = p.e / C::BK;
  const int n_it = (vt1 - vt0) * n_kc;  // (vocab tile, k chunk) pairs, k chunks innermost

  auto issue = [&](int it) {  // h and W chunks of iteration it into ring stage it % STAGES (thread 0)
    const int s = it % C::STAGES, kc = it % n_kc, vt = vt0 + it / n_kc;
    bf16* hs = ring + s * (C::H_TILE + C::W_TILE);
    hopper::mbar_expect(&full[s], (C::H_TILE + C::W_TILE) * 2);
    hopper::tma_load_2d(hs, &hmap, kc * C::BK, r0, &full[s]);
    hopper::tma_load_2d(hs + C::H_TILE, &wmap, kc * C::BK, vt * C::BV, &full[s]);
  };
  auto release = [&](int it) {  // every warp has read iteration it's stage: refill it
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[it % C::STAGES]);
    if (tid == 0 && it + C::STAGES < n_it) {
      hopper::mbar_wait(&empty[it % C::STAGES], (it / C::STAGES) & 1);
      issue(it + C::STAGES);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], C::THREADS / 32);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < C::STAGES && it < n_it; ++it) issue(it);

  const int row = r0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;  // and row + 8
  int lab[2];  // the label of each row, -1 where it is not a vocab column
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int y = row + 8 * hh < p.n ? p.labels[row + 8 * hh] : -1;
    lab[hh] = y >= 0 && y < p.v ? y : -1;
  }
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2] = {0.f, 0.f};  // l, corr: this thread's columns
  float acc[C::BV / 2];  // s: 64 rows x 256 vocab rows, the m64n256 accumulator layout
  int it = 0;
  for (int vt = vt0; vt < vt1; ++vt) {
#pragma unroll
    for (int i = 0; i < C::BV / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < n_kc; ++kc, ++it) {
      const int s = it % C::STAGES;
      const bf16* hs = ring + s * (C::H_TILE + C::W_TILE);
      hopper::mbar_wait(&full[s], (it / C::STAGES) & 1);
      hopper::reg_fence(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        hopper::wgmma_ss<C::BV, 0>(acc, hopper::desc_sw_k<128>(hs + wg * 64 * C::BK + kk * 16),
                                   hopper::desc_sw_k<128>(hs + C::H_TILE + kk * 16), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous chunk's products are done: its stage can go
      hopper::reg_fence(acc);
      if (kc > 0) release(it - 1);
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(acc);
    release(it - 1);

    // fold the tile into the rows' running statistics
    const int v0 = vt * C::BV, c0 = v0 + 2 * t4;  // vocab row of this thread's first column
    const int lc[2] = {lab[0] - c0, lab[1] - c0};
    const bool ragged = v0 + C::BV > p.v;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < C::BV / 2; ++i) {
      const int c = (i >> 2) * 8 + (i & 1), hh = (i >> 1) & 1;  // column c0 + c, row row + 8 hh
      if (ragged && c0 + c >= p.v) acc[i] = -INFINITY;
      if (c == lc[hh]) corr[hh] += acc[i];
      mx[hh] = fmaxf(mx[hh], acc[i]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m2[hh], mx[hh] * kLog2e);
      l[hh] *= hopper::exp2_approx(m2[hh] - mn);
      m2[hh] = mn;
    }
#pragma unroll
    for (int i = 0; i < C::BV / 2; ++i) l[(i >> 1) & 1] += hopper::exp2_approx(fmaf(acc[i], kLog2e, -m2[(i >> 1) & 1]));
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    corr[hh] += __shfl_xor_sync(0xffffffffu, corr[hh], 1);
    corr[hh] += __shfl_xor_sync(0xffffffffu, corr[hh], 2);
    const int r = row + 8 * hh;
    if (t4 == 0 && r < p.n) {
      const long long at = static_cast<long long>(split) * p.n + r, plane = static_cast<long long>(p.splits) * p.n;
      p.part[at] = m2[hh];
      p.part[plane + at] = l[hh];
      p.part[2 * plane + at] = corr[hh];
    }
  }
}

// Per row, the splits' (m2, l, corr) in split order: lse = m + log(max(l, 1e-37)), corr the sum (the label's
// split holds it, every other split 0).
__global__ void __launch_bounds__(256) ce_fwd_combine(const CEParams p) {
  constexpr float kLn2 = 0.6931471805599453f;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p.n) return;
  const long long plane = static_cast<long long>(p.splits) * p.n;
  float m2 = -INFINITY;
  for (int s = 0; s < p.splits; ++s) m2 = fmaxf(m2, p.part[static_cast<long long>(s) * p.n + r]);
  float l = 0.f, corr = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const long long at = static_cast<long long>(s) * p.n + r;
    l += p.part[plane + at] * hopper::exp2_approx(p.part[at] - m2);
    corr += p.part[2 * plane + at];
  }
  p.lse_out[r] = m2 * kLn2 + logf(fmaxf(l, 1e-37f));
  p.corr_out[r] = corr;
}

int launch_fwd(const CEParams& p, cudaStream_t s) {
  using C = FwdCfg;
  if (p.splits <= 0 || p.part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ce_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // h [N, E] and W [V, E] as TMA tensor maps: boxes of BK columns x BM (h) or BV (W) rows, zero-filled past the edge
  CUtensorMap hmap, wmap;
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.e) * 2};
  const cuuint64_t hdims[2] = {static_cast<cuuint64_t>(p.e), static_cast<cuuint64_t>(p.n)};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(p.e), static_cast<cuuint64_t>(p.v)};
  const cuuint32_t hbox[2] = {C::BK, C::BM}, wbox[2] = {C::BK, C::BV};
  e = hopper::make_tensor_map<128>(&hmap, p.h, 2, hdims, strides, hbox);
  if (e == cudaSuccess) e = hopper::make_tensor_map<128>(&wmap, p.w, 2, wdims, strides, wbox);
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_fwd_bf16<<<p.splits * ((p.n + C::BM - 1) / C::BM), C::THREADS, C::kSmem, s>>>(p, hmap, wmap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ce_fwd_combine<<<(p.n + 255) / 256, 256, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16 dh (cluster)
// dh = ds W on a thread-block cluster of CL CTAs (8, or 16 at E = 4096):
// ce_dw_bf16's design with the roles of h and W swapped (dh = ds W over the
// vocab is dW = ds^T h over the tokens). A cluster owns BM = 128 rows of h;
// CTA c of it owns the E-slice [c SE, (c + 1) SE), SE = E / CL, keeps
// h[r0 : r0 + 128, slice c] in registers (wgmma A fragments, 4 SE / 16 a
// thread) and the [128, SE] fp32 dh accumulator in the registers of its two
// warpgroups (64 rows each) for the whole kernel: the [128, E] accumulator of
// a row block (98,304 fp32 at E 1536) is more than one SM's registers, and
// splitting E without sharing s would regenerate s once per slice. Tiles of
// BV = 64 vocab rows of W[:, slice c] stream through a ring of STAGES buffers
// by TMA (a 2-D tensor map built per launch, swizzled as wgmma reads at full
// rate), one mbarrier a stage, loaded STAGES - 2 tiles ahead of the partial s
// that reads them. The reducing thread's row statistics (lse, gm, label) stay
// in its registers. Per tile t:
//   1. each CTA computes the partial s [128, 64] = h_c W_c^T of its slice
//      (wgmma) and sends rows [RM c', RM c' + RM) of it (RM = 128 / CL) into
//      slot c of CTA c''s receive buffer (distributed shared memory, one bulk
//      copy a CTA);
//   2. CTA c waits for its CL slots (an mbarrier counts the bytes), sums its
//      RM rows over them in the fixed order 0..CL-1, computes ds in fp32
//      (vocab columns past V are 0), splits it into bf16 hi + lo (about 16
//      mantissa bits, near the TPU kernel's fp32 ds) and sends those rows into
//      every other CTA's ds tiles (bulk copies, counted by each CTA's
//      mbarrier);
//   3. each CTA: dh_c += ds_hi W_c + ds_lo W_c (wgmma, A the ds tiles, B the
//      same W tile read MN-major).
// Pipelined across tiles as dW is: tile t - 1's dh runs on the tensor cores
// while tile t's partials travel and are reduced, and tile t + 1's partial s
// while tile t's ds rows travel (two sets of ds tiles); one split cluster
// barrier a tile. W is read once per 128 rows of h (39.5 GB from L2 at the
// 32k shape), every dh element
// is summed by one thread in a fixed order (no atomics, bitwise repeatable),
// and no [rows, V] buffer exists. Needs sm_90a (wgmma) and a cluster launch.
template <int SE_, int CL_, int STAGES_>
struct DhCfg {
  static constexpr int SE = SE_, CL = CL_, BM = 128, BV = 64, STAGES = STAGES_, THREADS = 256;
  static constexpr int AHEAD = STAGES - 2;            // W tiles in flight ahead of the partial s that reads them
  static constexpr int RM = BM / CL;                  // rows of h a CTA reduces
  static constexpr int RC = RM * BV / THREADS;        // vocab columns of one of them a thread reduces
  static constexpr int SWW = SE * 2 < 128 ? SE * 2 : 128;  // swizzle (row) bytes of the W tiles
  static constexpr int AWW = SWW / 2;                 // columns of a W-tile atom
  static constexpr int W_BYTES = BV * SE * 2;         // one W tile (swizzled)
  static constexpr int SLOT = RM * BV * 4;            // RM partial rows: one CTA's share of another's s
  static constexpr int P_BYTES = CL * SLOT;           // partial s [128, 64] (see pcol); as much to receive
  static constexpr int DS_BYTES = BM * BV * 2;        // one of ds hi, ds lo (swizzled, 128-byte rows)
  static constexpr int DS_ROWS = RM * BV * 2;         // a CTA's RM rows of one ds tile: contiguous
  static constexpr int kSmem = 1024 + STAGES * W_BYTES + 4 * DS_BYTES + 2 * P_BYTES + (STAGES + 3) * 8;
  static_assert(BV * 2 == 128 && W_BYTES % 1024 == 0, "ds rows are one 128-byte swizzle atom");
  static_assert(RM * BV == RC * THREADS && (RC == 2 || RC == 4), "one thread reduces 2 or 4 vocab columns of a row");
  static_assert(AHEAD >= 1, "a tile's stage is refilled only after its dh is done");
  static_assert(2 * P_BYTES >= BM * SE * 2, "the h slice is staged in the partial-s buffers");
  static_assert(kSmem <= 232448, "fits an SM's shared memory");
  // Column of partial-s element (r, c) in its unpadded row: 8-column chunks permuted by the row's low bits, so
  // that the 8 rows a warp stores at once spread over the banks (padded rows would not fit beside a fourth W
  // stage).
  static __device__ __forceinline__ int pcol(int r, int c) { return c ^ ((r & 7) << 3); }
};

// x[i] += p[i] for the N (2 or 4) consecutive floats at p, one vector load.
template <int N>
__device__ __forceinline__ void add_vec(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] += y.x;
    x[1] += y.y;
    x[2] += y.z;
    x[3] += y.w;
  } else {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] += y.x;
    x[1] += y.y;
  }
}

// v[0..N) rounded to bf16 at dst, one vector store.
template <int N>
__device__ __forceinline__ void store_bf16(bf16* dst, const float (&v)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<uint2*>(dst) = make_uint2(hopper::pack_bf16(v[0], v[1]), hopper::pack_bf16(v[2], v[3]));
  else
    *reinterpret_cast<uint32_t*>(dst) = hopper::pack_bf16(v[0], v[1]);
}

template <class C>
__global__ void __launch_bounds__(256, 1) ce_dh_bf16(const CEParams p, const __grid_constant__ CUtensorMap wmap) {
  constexpr int SE = C::SE, RC = C::RC;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023);  // 1024-byte aligned
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* dsb = ring + C::STAGES * C::BV * SE;  // [2 sets][hi, lo] swizzled tiles
  float* part = reinterpret_cast<float*>(dsb + 4 * C::BM * C::BV);
  float* recv = part + C::P_BYTES / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + C::P_BYTES / 4);
  uint64_t* recv_bar = full + C::STAGES;
  uint64_t* ds_bar = recv_bar + 1;  // one a set of ds tiles
  const uint32_t rank = hopper::cluster_rank();
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = (blockIdx.x / C::CL) * C::BM, e0 = rank * SE;
  const int n_tiles = (p.v + C::BV - 1) / C::BV;
  auto w_of = [&](int t) { return ring + (t % C::STAGES) * C::BV * SE; };

  auto issue = [&](int t) {  // W tile t into its ring stage by TMA (thread 32, so that warp 0 is not held up)
    if (t >= n_tiles) return;
    if (tid == 32) {
      uint64_t* bar = &full[t % C::STAGES];
      hopper::mbar_expect(bar, C::W_BYTES);
      for (int a = 0; a < SE / C::AWW; ++a)
        hopper::tma_load_2d(w_of(t) + a * C::BV * C::AWW, &wmap, e0 + a * C::AWW, t * C::BV, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_init(recv_bar, 1);
    hopper::mbar_init(&ds_bar[0], 1);
    hopper::mbar_init(&ds_bar[1], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // the h slice, staged in shared memory (the partial-s buffers, unused until the loop), into A fragments
  bf16* hst = reinterpret_cast<bf16*>(part);
  hopper::cp_tile_sw<C::SWW, SE, C::BM, C::THREADS>(hst, static_cast<const bf16*>(p.h) + e0, p.e, r0, p.n, tid);
  for (int a = 0; a < C::AHEAD; ++a) issue(a);
  hopper::cp_async_wait_all();
  __syncthreads();
  uint32_t hf[SE / 16][4];
  const int prow = wg * 64 + warp * 16 + g;  // and prow + 8: this thread's rows of h, s and dh
#pragma unroll
  for (int kk = 0; kk < SE / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hf[kk][r] = *reinterpret_cast<const uint32_t*>(
          hst + hopper::sw_offset<C::SWW>(prow + 8 * (r & 1), kk * 16 + 8 * (r >> 1) + 2 * t4, C::BM));
  __syncthreads();  // every h fragment read before the staging buffers take partials

  float sc[32];
  auto scores = [&](int t) {  // partial s of tile t into sc: issued and committed, not waited for
    const bf16* wt = w_of(t);
    hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SE / 16; ++kk)
      hopper::wgmma_rs<64, 0>(
          sc, hf[kk], hopper::desc_sw_k<C::SWW>(wt + (kk * 16 / C::AWW) * C::BV * C::AWW + kk * 16 % C::AWW), 1);
    hopper::wgmma_commit();
  };
  auto store_partial = [&]() {  // sc, once its wgmma is done, into the partial-s buffer
    hopper::reg_fence(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(part + prow * C::BV + C::pcol(prow, j * 8 + 2 * t4)) =
          make_float2(sc[4 * j], sc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (prow + 8) * C::BV + C::pcol(prow + 8, j * 8 + 2 * t4)) =
          make_float2(sc[4 * j + 2], sc[4 * j + 3]);
    }
    hopper::fence_async_smem();  // read by the bulk copies
  };

  // the reduction thread's place: row rr of this CTA's RM (row n of h), vocab columns nc .. nc + RC - 1 of a tile
  const int rr = tid / (C::BV / RC), nc = (tid % (C::BV / RC)) * RC, n = r0 + rank * C::RM + rr;
  const int my_off = hopper::sw_offset<128>(rank * C::RM + rr, nc, C::BM);
  float lse_r = 0.f, gm_r = 0.f;  // rows past N: gm 0, so ds 0
  int lab_r = -1;
  if (n < p.n) {
    lse_r = p.lse[n];
    gm_r = p.gm[n];
    lab_r = p.labels[n];
  }
  float acc[SE / 2];
#pragma unroll
  for (int i = 0; i < SE / 2; ++i) acc[i] = 0.f;

  auto dh = [&](int t) {  // dh_c += ds_hi W_c + ds_lo W_c for tile t, issued and committed
    hopper::mbar_wait(&ds_bar[t & 1], (t >> 1) & 1);
    const bf16* wt = w_of(t);
    const bf16* dst = dsb + (t & 1) * 2 * C::BM * C::BV + wg * 64 * C::BV;
    hopper::wgmma_fence();
#pragma unroll
    for (int part_i = 0; part_i < 2; ++part_i)
#pragma unroll
      for (int kk = 0; kk < C::BV / 16; ++kk)
        hopper::wgmma_ss<SE, 1>(acc, hopper::desc_sw_k<128>(dst + part_i * C::BM * C::BV + kk * 16),
                                hopper::desc_sw_mn<C::SWW>(wt + kk * 16 * C::AWW, C::BV), 1);
    hopper::wgmma_commit();
  };

  scores(0);
  hopper::wgmma_wait<0>();
  hopper::cluster_arrive();  // every CTA's barriers exist and its h fragments are read before any exchange
  hopper::cluster_wait();
  for (int t = 0; t < n_tiles; ++t) {
    bf16* ds_set = dsb + (t & 1) * 2 * C::BM * C::BV;
    // 1. the partial s of tile t (in sc) out to the CTAs that reduce it; the barrier (armed in tile t - 1)
    // says every CTA has read its slots of tile t - 1 and so received this CTA's partial
    if (t > 0) hopper::cluster_wait();
    store_partial();
    __syncthreads();
    issue(t + C::AHEAD);  // into the stage of tile t - 2, whose dh is done
    if (tid < C::CL) {  // thread c sends CTA c its rows of the partial
      if (tid == 0) {
        hopper::mbar_expect(recv_bar, C::P_BYTES);
        hopper::mbar_expect(&ds_bar[t & 1], (C::CL - 1) * 2 * C::DS_ROWS);
      }
      hopper::bulk_to_peer(hopper::mapa(recv + rank * C::SLOT / 4, tid), part + tid * C::SLOT / 4, C::SLOT,
                           hopper::mapa(recv_bar, tid));
    }

    if (t > 0) dh(t - 1);  // on the tensor cores while the partials travel

    // 2. s = the sum of the CL slots in order; ds in fp32; hi + lo rows, then to every other CTA
    hopper::mbar_wait(recv_bar, t & 1);
    float x[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) x[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CL; ++c) add_vec<RC>(x, recv + (c * C::RM + rr) * C::BV + C::pcol(rr, nc));
    float hi[RC], lo[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int v = t * C::BV + nc + i;
      const float ds = v < p.v ? gm_r * (expf(x[i] - lse_r) - (v == lab_r ? 1.f : 0.f)) : 0.f;
      hi[i] = __bfloat162float(__float2bfloat16_rn(ds));
      lo[i] = ds - hi[i];
    }
    store_bf16<RC>(ds_set + my_off, hi);
    store_bf16<RC>(ds_set + C::BM * C::BV + my_off, lo);
    hopper::fence_async_smem();  // the ds rows, read by the bulk copies and by wgmma
    __syncthreads();
    hopper::cluster_arrive();  // this CTA has read its slots of tile t
    // A peer writes its ds rows of tile t + 2 into this CTA's set t % 2 only after its partial of tile
    // t + 2 has arrived here, which this CTA sends after dh(t) is done: no other guard is needed.
    if (tid >= 1 && tid < C::CL) {  // thread c sends CTA rank + c this CTA's ds rows
      const uint32_t peer = (rank + tid) % C::CL;
      for (int part_i = 0; part_i < 2; ++part_i) {
        const bf16* rows = ds_set + part_i * C::BM * C::BV + rank * C::RM * C::BV;
        hopper::bulk_to_peer(hopper::mapa(rows, peer), rows, C::DS_ROWS, hopper::mapa(&ds_bar[t & 1], peer));
      }
    }
    if (t + 1 < n_tiles) scores(t + 1);
    hopper::wgmma_wait<0>();  // dh(t - 1), scores(t + 1)
    hopper::reg_fence(acc);
  }
  dh(n_tiles - 1);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(acc);
  hopper::cluster_wait();    // the last tile's arrival
  hopper::cluster_arrive();  // no CTA leaves while a peer's copies may still read or write its memory
  hopper::cluster_wait();

  bf16* out = static_cast<bf16*>(p.dh) + e0;
#pragma unroll
  for (int j = 0; j < SE / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + prow + 8 * half;
      if (row < p.n)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * p.e + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// The attributes a cluster launch of CL CTAs needs: the dynamic shared memory, and above 8 CTAs the
// non-portable cluster size.
template <int CL, class K>
cudaError_t cluster_attributes(K kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && CL > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// A cluster launch of CL CTAs a block of rows (dh: rows of h; dW: vocab rows of W), `map` the streamed matrix.
template <int CL, class K>
int launch_cluster(K kernel, const CEParams& p, const CUtensorMap& map, int blocks, int threads, int smem,
                   cudaStream_t s) {
  cudaError_t e = cluster_attributes<CL>(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p, map);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of CL CTAs of `kernel` the card holds at once (cudaOccupancyMaxActiveClusters).
template <int CL, class K>
int max_clusters(K kernel, int threads, int smem, int* out) {
  cudaError_t e = cluster_attributes<CL>(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * 1024);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &cfg));
}

template <class C>
int launch_dh(const CEParams& p, cudaStream_t s) {
  // W [V, E] as a TMA tensor map: boxes of one swizzle atom (AWW columns) x BV rows, zero-filled past V
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.e), static_cast<cuuint64_t>(p.v)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.e) * 2};
  const cuuint32_t box[2] = {C::AWW, C::BV};
  const cudaError_t e = hopper::make_tensor_map<C::SWW>(&wmap, p.w, 2, dims, strides, box);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_cluster<C::CL>(ce_dh_bf16<C>, p, wmap, (p.n + C::BM - 1) / C::BM, C::THREADS, C::kSmem, s);
}

// ------------------------------------------------------------ bf16 dW (cluster)
// dW = ds^T h on a thread-block cluster of CL CTAs (8, or 16 at E = 4096). A
// cluster owns BV = 128 vocab rows; CTA c of it owns the E-slice [c SE, (c +
// 1) SE), SE = E / CL, keeps W[v0 : v0 + 128, slice c] in registers (wgmma A
// fragments, 4 SE / 16 a thread) and the [128, SE] fp32 dW accumulator in the
// registers of its two warpgroups (64 rows each) for the whole kernel. Tiles
// of BN = 64 tokens of h[:, slice c] stream through a ring of STAGES buffers
// by TMA (a tensor map built per launch; swizzled as wgmma reads at full
// rate), the tokens' lse, gm and labels beside them by cp.async (ST_SLOTS
// slots), one mbarrier a stage. Per tile t:
//   1. each CTA computes the partial s^T [128, 64] = W_c h_c^T of its slice
//      (wgmma) and sends rows [RV c', RV c' + RV) of it (RV = 128 / CL) into
//      slot c of CTA c''s receive buffer (distributed shared memory, one bulk
//      copy a CTA);
//   2. CTA c waits for its CL slots (an mbarrier counts the bytes), sums its
//      RV rows over them in the fixed order 0..CL-1, computes ds in fp32 from
//      lse, gm and the labels, splits it into bf16 hi + lo (about 16 mantissa
//      bits, near the TPU kernel's fp32 ds) and sends those rows into every
//      other CTA's ds tiles (bulk copies, counted by each CTA's mbarrier);
//   3. each CTA: dW_c += ds_hi^T h_c + ds_lo^T h_c (wgmma, A the ds tiles, B
//      the same h tile read MN-major).
// Pipelined across tiles: tile t - 1's dW runs on the tensor cores while
// tile t's partials travel and are reduced, and tile t + 1's partial s while
// tile t's ds rows travel (two sets of ds tiles). One cluster barrier a tile,
// split: a CTA arrives once it has read its slots, and waits before it sends
// the next partial. Exchanges go through the bulk-copy engine: a thread's own
// loads or stores to a peer stall for the round trip. h is read once per 128
// vocab rows, every dW element
// is summed by one thread in a fixed order (no atomics, bitwise repeatable),
// and no [rows, V] buffer exists. Needs sm_90a (wgmma) and a cluster launch.
// The partial rows: padded to a pitch of BN + 4 floats on a cluster of 8; on a
// cluster of 16 unpadded with dh's permuted chunks, and the statistics in two
// slots, so that the E = 4096 instance fits an SM's shared memory.
template <int SE_, int CL_>
struct DwCfg {
  static constexpr int SE = SE_, CL = CL_, BV = 128, BN = 64, STAGES = 3, THREADS = 256;
  static constexpr int RV = BV / CL;                  // vocab rows a CTA reduces
  static constexpr int RC = RV * BN / THREADS;        // tokens of one of them a thread reduces
  static constexpr bool PAD = CL == 8;                // padded partial rows (else permuted chunks)
  static constexpr int RP = PAD ? BN + 4 : BN;        // fp32 pitch of partial-s rows
  static constexpr int ST_SLOTS = PAD ? STAGES : 2;   // slots of token statistics
  static constexpr int SWH = SE * 2 < 128 ? SE * 2 : 128;  // swizzle (row) bytes of the h tiles
  static constexpr int AWH = SWH / 2;                 // columns of an h-tile atom
  static constexpr int H_BYTES = BN * SE * 2;         // one h tile (swizzled)
  static constexpr int ST_BYTES = 3 * BN * 4;         // lse, gm, labels of a tile's tokens
  static constexpr int SLOT = RV * RP * 4;            // RV partial rows: one CTA's share of another's s^T
  static constexpr int P_BYTES = CL * SLOT;           // partial s^T [128, 64] (pitch RP); as much to receive
  static constexpr int DS_BYTES = BV * BN * 2;        // one of ds hi, ds lo (swizzled, 128-byte rows)
  static constexpr int DS_ROWS = RV * BN * 2;         // a CTA's RV rows of one ds tile: contiguous
  static constexpr int kSmem = 1024 + STAGES * H_BYTES + 4 * DS_BYTES + 2 * P_BYTES + ST_SLOTS * ST_BYTES +
                               (STAGES + 3) * 8;  // 1024: room to align the swizzled tiles
  static_assert(BN * 2 == 128 && H_BYTES % 1024 == 0, "ds rows are one 128-byte swizzle atom");
  static_assert(RV * BN == RC * THREADS && (RC == 2 || RC == 4), "one thread reduces 2 or 4 tokens of a vocab row");
  static_assert(2 * P_BYTES >= BV * SE * 2, "the W slice is staged in the partial-s buffers");
  static_assert(kSmem <= 232448, "fits an SM's shared memory");
  // Index of partial-s^T element (r, c): padded rows, or (as dh's pcol) 8-column chunks permuted by the row's low
  // bits.
  static __device__ __forceinline__ int pidx(int r, int c) { return PAD ? r * RP + c : r * RP + (c ^ ((r & 7) << 3)); }
};

template <class C>
__global__ void __launch_bounds__(256, 1) ce_dw_bf16(const CEParams p, const __grid_constant__ CUtensorMap hmap) {
  constexpr int SE = C::SE, RC = C::RC;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023);  // 1024-byte aligned
  bf16* ring = reinterpret_cast<bf16*>(base);
  bf16* dsb = ring + C::STAGES * C::BN * SE;  // [2 sets][hi, lo] swizzled tiles
  float* part = reinterpret_cast<float*>(dsb + 4 * C::BV * C::BN);
  float* recv = part + C::P_BYTES / 4;
  float* stats = recv + C::P_BYTES / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + C::ST_SLOTS * 3 * C::BN);
  uint64_t* recv_bar = full + C::STAGES;
  uint64_t* ds_bar = recv_bar + 1;  // one a set of ds tiles
  const uint32_t rank = hopper::cluster_rank();
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int v0 = (blockIdx.x / C::CL) * C::BV, e0 = rank * SE;
  const int n_tiles = (p.n + C::BN - 1) / C::BN;
  auto h_of = [&](int t) { return ring + (t % C::STAGES) * C::BN * SE; };
  // tile t's statistics: its slot is refilled (issue(t + ST_SLOTS)) only after every thread has reduced tile t
  auto stats_of = [&](int t) { return stats + (t % C::ST_SLOTS) * 3 * C::BN; };

  // tile t into its ring stage: h by TMA (thread 32), lse, gm and labels by cp.async (threads 64..255), so
  // that warp 0, which sends the partials, is not held up
  auto issue = [&](int t) {
    const int n0 = t * C::BN;
    uint64_t* bar = &full[t % C::STAGES];
    if (tid >= C::THREADS - 3 * C::BN) {
      const int i = tid - (C::THREADS - 3 * C::BN), n = n0 + i % C::BN;
      const void* src = i < C::BN ? static_cast<const void*>(p.lse + n)
                        : i < 2 * C::BN ? static_cast<const void*>(p.gm + n) : static_cast<const void*>(p.labels + n);
      hopper::cp_async4(stats_of(t) + i, n < p.n ? src : p.gm, n < p.n);
      hopper::cp_async_arrive(bar);
    }
    if (tid == 32) {
      hopper::mbar_expect(bar, C::H_BYTES);
      for (int a = 0; a < SE / C::AWH; ++a) hopper::tma_load_2d(h_of(t) + a * C::BN * C::AWH, &hmap, e0 + a * C::AWH, n0, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) hopper::mbar_init(&full[s], 3 * C::BN + 1);
    hopper::mbar_init(recv_bar, 1);
    hopper::mbar_init(&ds_bar[0], 1);
    hopper::mbar_init(&ds_bar[1], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // the W slice, staged in shared memory (the partial-s buffers, unused until the loop), into A fragments
  bf16* wst = reinterpret_cast<bf16*>(part);
  hopper::cp_tile_sw<C::SWH, SE, C::BV, C::THREADS>(wst, static_cast<const bf16*>(p.w) + e0, p.e, v0, p.v, tid);
  issue(0);
  hopper::cp_async_wait_all();
  __syncthreads();
  uint32_t wf[SE / 16][4];
  const int prow = wg * 64 + warp * 16 + g;  // and prow + 8: this thread's rows of W, s^T and dW
#pragma unroll
  for (int kk = 0; kk < SE / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wf[kk][r] = *reinterpret_cast<const uint32_t*>(
          wst + hopper::sw_offset<C::SWH>(prow + 8 * (r & 1), kk * 16 + 8 * (r >> 1) + 2 * t4, C::BV));
  __syncthreads();  // every W fragment read before the staging buffers take partials

  float sc[32];
  auto scores = [&](int t) {  // partial s^T of tile t into sc: issued and committed, not waited for
    const bf16* ht = h_of(t);
    hopper::mbar_wait(&full[t % C::STAGES], (t / C::STAGES) & 1);
    hopper::fence_async_smem();
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SE / 16; ++kk)
      hopper::wgmma_rs<64, 0>(
          sc, wf[kk], hopper::desc_sw_k<C::SWH>(ht + (kk * 16 / C::AWH) * C::BN * C::AWH + kk * 16 % C::AWH), 1);
    hopper::wgmma_commit();
  };
  auto store_partial = [&]() {  // sc, once its wgmma is done, into the partial-s buffer
    hopper::reg_fence(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(part + C::pidx(prow, j * 8 + 2 * t4)) = make_float2(sc[4 * j], sc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + C::pidx(prow + 8, j * 8 + 2 * t4)) = make_float2(sc[4 * j + 2], sc[4 * j + 3]);
    }
    hopper::fence_async_smem();  // read by the bulk copies
  };

  // the reduction thread's place: row rr of this CTA's RV (vocab row v), tokens nc .. nc + RC - 1 of a tile
  const int rr = tid / (C::BN / RC), nc = (tid % (C::BN / RC)) * RC, v = v0 + rank * C::RV + rr;
  const int my_off = hopper::sw_offset<128>(rank * C::RV + rr, nc, C::BV);
  float acc[SE / 2];
#pragma unroll
  for (int i = 0; i < SE / 2; ++i) acc[i] = 0.f;

  auto dw = [&](int t) {  // dW_c += ds_hi^T h_c + ds_lo^T h_c for tile t, issued and committed
    hopper::mbar_wait(&ds_bar[t & 1], (t >> 1) & 1);
    const bf16* ht = h_of(t);
    const bf16* dst = dsb + (t & 1) * 2 * C::BV * C::BN + wg * 64 * C::BN;
    hopper::wgmma_fence();
#pragma unroll
    for (int part_i = 0; part_i < 2; ++part_i)
#pragma unroll
      for (int kk = 0; kk < C::BN / 16; ++kk)
        hopper::wgmma_ss<SE, 1>(acc, hopper::desc_sw_k<128>(dst + part_i * C::BV * C::BN + kk * 16),
                                hopper::desc_sw_mn<C::SWH>(ht + kk * 16 * C::AWH, C::BN), 1);
    hopper::wgmma_commit();
  };

  scores(0);
  hopper::wgmma_wait<0>();
  hopper::cluster_arrive();  // every CTA's barriers exist and its W fragments are read before any exchange
  hopper::cluster_wait();
  for (int t = 0; t < n_tiles; ++t) {
    bf16* ds_set = dsb + (t & 1) * 2 * C::BV * C::BN;
    // 1. the partial s^T of tile t (in sc) out to the CTAs that reduce it; the barrier (armed in
    // tile t - 1) says every CTA has read its slots of tile t - 1 and so received this CTA's partial
    if (t > 0) hopper::cluster_wait();
    store_partial();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);  // into the stage of tile t - 2, whose dW is done
    if (tid < C::CL) {  // thread c sends CTA c its rows of the partial
      if (tid == 0) {
        hopper::mbar_expect(recv_bar, C::P_BYTES);
        hopper::mbar_expect(&ds_bar[t & 1], (C::CL - 1) * 2 * C::DS_ROWS);
      }
      hopper::bulk_to_peer(hopper::mapa(recv + rank * C::SLOT / 4, tid), part + tid * C::SLOT / 4, C::SLOT,
                           hopper::mapa(recv_bar, tid));
    }

    if (t > 0) dw(t - 1);  // on the tensor cores while the partials travel

    // 2. s = the sum of the CL slots in order; ds in fp32; hi + lo rows, then to every other CTA
    hopper::mbar_wait(recv_bar, t & 1);
    float x[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) x[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CL; ++c) add_vec<RC>(x, recv + C::pidx(c * C::RV + rr, nc));
    const float* st = stats_of(t);
    float hi[RC], lo[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int lab = __float_as_int(st[2 * C::BN + nc + i]);
      const float ds = v < p.v ? st[C::BN + nc + i] * (expf(x[i] - st[nc + i]) - (lab == v ? 1.f : 0.f)) : 0.f;
      hi[i] = __bfloat162float(__float2bfloat16_rn(ds));
      lo[i] = ds - hi[i];
    }
    store_bf16<RC>(ds_set + my_off, hi);
    store_bf16<RC>(ds_set + C::BV * C::BN + my_off, lo);
    hopper::fence_async_smem();  // the ds rows, read by the bulk copies and by wgmma
    __syncthreads();
    hopper::cluster_arrive();  // this CTA has read its slots of tile t
    // A peer writes its ds rows of tile t + 2 into this CTA's set t % 2 only after its partial of tile
    // t + 2 has arrived here, which this CTA sends after dW(t) is done: no other guard is needed.
    if (tid >= 1 && tid < C::CL) {  // thread c sends CTA rank + c this CTA's ds rows
      const uint32_t peer = (rank + tid) % C::CL;
      for (int part_i = 0; part_i < 2; ++part_i) {
        const bf16* rows = ds_set + part_i * C::BV * C::BN + rank * C::RV * C::BN;
        hopper::bulk_to_peer(hopper::mapa(rows, peer), rows, C::DS_ROWS, hopper::mapa(&ds_bar[t & 1], peer));
      }
    }
    if (t + 1 < n_tiles) scores(t + 1);
    hopper::wgmma_wait<0>();  // dW(t - 1), scores(t + 1)
    hopper::reg_fence(acc);
  }
  dw(n_tiles - 1);
  hopper::wgmma_wait<0>();
  hopper::reg_fence(acc);
  hopper::cluster_wait();    // the last tile's arrival
  hopper::cluster_arrive();  // no CTA leaves while a peer's copies may still read or write its memory
  hopper::cluster_wait();

  bf16* out = static_cast<bf16*>(p.dw) + e0;
#pragma unroll
  for (int j = 0; j < SE / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = v0 + prow + 8 * half;
      if (row < p.v)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * p.e + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

template <class C>
int launch_dw(const CEParams& p, cudaStream_t s) {
  // h [N, E] as a TMA tensor map: boxes of one swizzle atom (AWH columns) x BN rows, zero-filled past N
  CUtensorMap hmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.e), static_cast<cuuint64_t>(p.n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.e) * 2};
  const cuuint32_t box[2] = {C::AWH, C::BN};
  const cudaError_t e = hopper::make_tensor_map<C::SWH>(&hmap, p.h, 2, dims, strides, box);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_cluster<C::CL>(ce_dw_bf16<C>, p, hmap, (p.v + C::BV - 1) / C::BV, C::THREADS, C::kSmem, s);
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
// The bf16 widths and the configurations of their cluster kernels: a cluster of 8 CTAs up to E = 1536, of 16
// at E = 4096 (see the header).
template <class Dh, class Dw>
int launch_bf16(const CEParams& p, int mode, cudaStream_t s) {
  if (mode == kFwd) return launch_fwd(p, s);
  return mode == kDh ? launch_dh<Dh>(p, s) : launch_dw<Dw>(p, s);
}

template <class Dh, class Dw>
int clusters_bf16(int mode, int* ctas, int* resident) {
  *ctas = mode == kDh ? Dh::CL : Dw::CL;
  return mode == kDh ? max_clusters<Dh::CL>(ce_dh_bf16<Dh>, Dh::THREADS, Dh::kSmem, resident)
                     : max_clusters<Dw::CL>(ce_dw_bf16<Dw>, Dw::THREADS, Dw::kSmem, resident);
}

// f(Dh{}, Dw{}) with the configurations of width e; cudaErrorInvalidValue for a width not built.
template <class F>
int by_width(int e, F f) {
  switch (e) {
    case 128: return f(DhCfg<16, 8, 4>{}, DwCfg<16, 8>{});
    case 256: return f(DhCfg<32, 8, 4>{}, DwCfg<32, 8>{});
    case 1536: return f(DhCfg<192, 8, 4>{}, DwCfg<192, 8>{});
    case 4096: return f(DhCfg<256, 16, 3>{}, DwCfg<256, 16>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return by_width(p->e, [&](auto dh, auto dw) { return launch_bf16<decltype(dh), decltype(dw)>(*p, mode, s); });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h, w, dh, dw; statistics are fp32, labels
// int32). bf16 needs E in {128, 256, 1536, 4096};
// rows must be contiguous and 16-byte aligned (the wrapper checks). Each
// returns cudaGetLastError() after its launch.
extern "C" int mt_fused_ce_fwd(const CEParams* p, int dtype, void* stream) { return launch(p, kFwd, dtype, stream); }

extern "C" int mt_fused_ce_bwd_dh(const CEParams* p, int dtype, void* stream) {
  return launch(p, kDh, dtype, stream);
}

extern "C" int mt_fused_ce_bwd_dw(const CEParams* p, int dtype, void* stream) {
  return launch(p, kDw, dtype, stream);
}

// The clusters of the bf16 dh (mode 1) or dW (mode 2) kernel at width E: its CTAs a cluster into *ctas (each owns
// E / *ctas columns), and how many such clusters the card holds at once (cudaOccupancyMaxActiveClusters) into
// *resident; returns the status.
extern "C" int mt_fused_ce_clusters(int mode, int e, int* ctas, int* resident) {
  *ctas = *resident = 0;
  if (mode != kDh && mode != kDw) return static_cast<int>(cudaErrorInvalidValue);
  return by_width(e, [&](auto dh, auto dw) {
    return clusters_bf16<decltype(dh), decltype(dw)>(mode, ctas, resident);
  });
}
