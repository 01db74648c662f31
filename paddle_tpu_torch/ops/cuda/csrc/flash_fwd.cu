// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/attention.py, one
// entry point each, each kernel templated on the mask policy
// (flash_common.cuh):
// - `flash_fwd`  (DenseMask):   `_fwd_kernel`, reached through `_flash_fwd`;
// - `varlen_fwd` (SegmentMask): `_varlen_fwd_kernel`, through
//   `_varlen_flash_fwd` (packed sequences, `flash_attn_unpadded`);
// - `ragged_fwd` (LengthMask):  `_ragged_fwd_kernel`, through
//   `flash_attention_ragged_bhsd` (per-sequence key counts; no lse).
//
// What it computes, for each batch b, query head h (kv head h / rep) and
// query row i:
//   s_ij   = scale * q_i . k_j   over the keys j the mask lets i see (all
//            keys, or j <= i when causal; the keys of i's own segment; the
//            first kv_lens[b] keys)
//   out_i  = sum_j softmax(s_i)_j v_j   (in the input type)
//   lse_i  = log sum_j exp(s_ij)        (f32)
// with an f32 running max and denominator (online softmax).  Probabilities
// are rounded to the input type before the PV product, as the TPU kernel
// does.  Masked scores are a finite -1e30 and their probability is forced
// to 0, so a row with no visible key gives out 0 and lse -1e30, never NaN.
// Any S: the ragged last tile is zero-padded and masked.
//
// Bound: arithmetic at the dense training shape.  At B=1, H=32, S=4096,
// D=128, causal, bf16 the two products are 137 GFLOP against ~134 MB of
// q/k/v/o traffic, far above the ~295 FLOP per byte where the H100's
// tensor cores become the limit.  (Packed into six documents, or cut by
// ragged lengths, the pairs shrink fourfold and the bytes set the bound;
// the design is the same.)  One block per (query tile, head,
// batch) loops over the key tiles its mask policy gives (the tiles up to
// the diagonal, of the tile's own documents, or below the length), where
// the TPU grid visits every key block and masks it; blocks of one query
// tile start together across the heads, the dense causal pattern's
// longest first (`launch`).  Three kernels, chosen by head dim and type
// alone (`launch_fwd`, `ws_route`):
// - bf16/fp16 at D = 64, 128 and 256 (`flash_fwd_ws_kernel`): warp-
//   specialised for Hopper, the forward twin of the backward's dq kernel
//   (flash_bwd.cu; scaffolding in flash_ws.cuh).  A producer warpgroup
//   loads the block's Q tile once (resident) and K/V tiles into a ring of
//   stages by TMA with the 128-byte swizzle.  Consumer warpgroups of 64
//   query rows compute S = Q K^T by wgmma with both operands K-major in
//   shared memory, the online softmax in registers (a row's max across
//   the 4 lanes that hold it; probabilities 2^(scores in log2 units -
//   max), one MUFU.EX2 each; tiles wholly inside the pattern take no
//   per-element test), then O += P V by wgmma with P from registers (the
//   score accumulator rounded in place to T) and V read MN-major from the
//   same swizzled tile: no operand is transposed.  The consumers take
//   turns at issuing their products (named barriers), so that one's
//   softmax runs under another's products.  Every K/V byte a block loads
//   serves all its query rows, and with the products and the softmax
//   overlapped the K/V traffic from L2 is what bounds the kernel (measured
//   by ablation, PERF.md), so at D = 64 and 128 a block has three
//   consumers (192 rows, 160 registers each) and 128-key tiles (96 for
//   packed sequences at D = 128, whose mask state spilled at 128).  At
//   D = 256 O is 128 f32 a thread: two consumers (240 registers), 64-key
//   tiles, two stages.  Issuing the next tile's S before waiting on the
//   current P V (a consumer holding two stages) measured slower, with
//   K and V in one stage or under barriers of their own.
// - bf16/fp16 at the other head dims (16..240 in steps of 16):
//   `flash_fwd_kernel`, mma.sync m16n8k16 (bf16/fp16 in, f32 out) on
//   ldmatrix fragments, eight warps of 16 rows, K/V tiles of 64 keys by
//   cp.async; each warp holds its rows' scores, running max and sum and
//   output accumulator (16 x D) in registers.
// - float32 inputs: plain f32 FMA out of shared memory (no TF32), for
//   exact agreement with the plain version.

#include <type_traits>

#include "flash_ws.cuh"

namespace flash {
namespace {

size_t fwd_smem_f32(int d) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const size_t ldt = d + 4, lds = BK + 4, ldo = d + 4;
  return 3 * round128(BQ * ldt * 4) + 2 * round128(BQ * lds * 4)
         + round128(BQ * ldo * 4) + 2 * round128(BQ * 4);
}

// The mma.sync kernel's blocks are eight warps of 16 query rows: each K/V
// tile it loads, and each barrier, serves 128 rows (measured 6 % faster
// than four warps of 16).
constexpr int kFwdWarps = 8;

// a Q tile of 128 rows, K and V tiles of 64 keys
size_t fwd_smem_mma(int d) {
  return round128(size_t(kFwdWarps * 16) * (d + 8) * 2)
         + 2 * round128(size_t(kMmaTile) * (d + 8) * 2);
}

template <typename Mask>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(Params p) {
  constexpr int BQ = kF32Tile, BK = kF32Tile, kWarps = kF32Threads / 32;
  const int d = p.d;
  const int ldt = d + 4, lds = BK + 4, ldo = d + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(BQ * ldt);
  float* ks = cv.take<float>(BK * ldt);
  float* vs = cv.take<float>(BK * ldt);
  float* ss = cv.take<float>(BQ * lds);
  float* ps = cv.take<float>(BQ * lds);
  float* os = cv.take<float>(BQ * ldo);
  float* m_s = cv.take<float>(BQ);
  float* l_s = cv.take<float>(BQ);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int iq = gridDim.y - 1 - blockIdx.y;  // see launch()
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.rep;
  const int q0 = iq * BQ;
  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_st.b + h * p.q_st.h;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_st.b + hk * p.v_st.h;

  load_tile<kF32Threads>(qs, ldt, qg, p.q_st.s, q0, p.sq, BQ, d);
  for (int i = threadIdx.x; i < BQ * ldo; i += kF32Threads) os[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += kF32Threads) {
    m_s[i] = kBigNeg;
    l_s[i] = 0.f;
  }
  const Mask mask(p, b);
  const Range loop = mask.key_loop(q0, BQ);
  for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
    await_tiles();
    __syncthreads();  // the previous tile's readers of ks/vs are done
    load_tile<kF32Threads>(ks, ldt, kg, p.k_st.s, k0, p.sk, BK, d);
    load_tile<kF32Threads>(vs, ldt, vg, p.v_st.s, k0, p.sk, BK, d);
    await_tiles();
    __syncthreads();
    block_mm_f32<false, true, false>(ss, lds, qs, ldt, ks, ldt, BQ, BK, d);
    __syncthreads();
    // online softmax, one warp per row, a lane per column (BK = 32)
    for (int r = warp; r < BQ; r += kWarps) {
      const int qi = q0 + r;
      const float m_old = m_s[r];
      const bool ok = inside(mask.keys(qi), k0 + lane);
      const float sv = ok ? ss[r * lds + lane] * p.scale : kBigNeg;
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float pj = ok ? expf(sv - m_new) : 0.f;
      ps[r * lds + lane] = pj;
      const float psum = warp_sum(pj);
      const float alpha = expf(m_old - m_new);
      for (int c = lane; c < d; c += 32) os[r * ldo + c] *= alpha;
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
    __syncthreads();
    block_mm_f32<false, false, true>(os, ldo, ps, lds, vs, ldt, BQ, d, BK);
  }
  __syncthreads();
  float* og = static_cast<float*>(p.out) + b * p.o_st.b + h * p.o_st.h;
  for (int i = threadIdx.x; i < BQ * d; i += kF32Threads) {
    const int r = i / d, c = i % d, qi = q0 + r;
    if (qi >= p.sq) continue;
    const float l = l_s[r];
    og[qi * p.o_st.s + c] = l > 0.f ? os[r * ldo + c] / l : 0.f;
  }
  if (p.lse == nullptr) return;
  float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
  for (int r = threadIdx.x; r < BQ; r += kF32Threads) {
    const int qi = q0 + r;
    if (qi < p.sq)
      lse[qi] = l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : kBigNeg;
  }
}

// DMAX (128 or 256): the largest head dim the instantiation takes; a warp
// holds DMAX / 8 n-tiles of output accumulators.
template <typename T, typename Mask, int DMAX>
__global__ void __launch_bounds__(kFwdWarps * 32) flash_fwd_kernel(Params p) {
  constexpr int BQ = kFwdWarps * 16, BK = kMmaTile, NT = kFwdWarps * 32;
  const int d = p.d, ld = d + pad<T>();
  const int nkd = d / 16, nnd = d / 8;  // k-steps over D, n-tiles over D
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(BQ * ld);
  T* ks = cv.take<T>(BK * ld);
  T* vs = cv.take<T>(BK * ld);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int iq = gridDim.y - 1 - blockIdx.y;  // see launch()
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.rep;
  const int q0 = iq * BQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_st.b + h * p.q_st.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  load_tile<NT>(qs, ld, qg, p.q_st.s, q0, p.sq, BQ, d);

  // this thread's two query rows (fragment rows g and g + 8)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // running max (log2 units) and sum of the two rows
  float m0 = kBigNeg, m1 = kBigNeg, l0 = 0.f, l1 = 0.f;
  const float scale2 = p.scale * kLog2e;

  // the keys each of the two rows sees, and the key tiles the block visits
  const Mask mask(p, b);
  const Range kr0 = mask.keys(row0), kr1 = mask.keys(row1);
  const Range loop = mask.key_loop(q0, BQ);
  for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers of ks/vs are done
    load_tile<NT>(ks, ld, kg, p.k_st.s, k0, p.sk, BK, d);
    load_tile<NT>(vs, ld, vg, p.v_st.s, k0, p.sk, BK, d);
    await_tiles();
    __syncthreads();
    // S = Q K^T for the warp's 16 rows x 64 keys (8 n-tiles)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk < nkd) {
        uint32_t a[4];
        frag_a(a, qs, ld, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t bb[4];
          frag_b_nk(bb, ks, ld, j * 8, kk * 16, lane);
          mma16816<T>(s[j], a, bb);
          mma16816<T>(s[j + 1], a, bb + 2);
        }
      }
    }
    // scores in log2 units, masked outside the pattern; the rows' new max
    // across the 4 lanes that hold a row
    const bool full = mask.tile_full(q0, BQ, k0, BK);
    float mx0 = kBigNeg, mx1 = kBigNeg;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = full || inside(e < 2 ? kr0 : kr1, kj) ? s[j][e] * scale2
                                                         : kBigNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is kBigNeg; its probability must be 0 even when
        // the row's max is still kBigNeg
        const float m = e < 2 ? mn0 : mn1;
        s[j][e] = s[j][e] > kBigNeg ? fast_exp2(s[j][e] - m) : 0.f;
      }
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o_);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o_);
    }
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      o[j][0] *= a0;
      o[j][1] *= a0;
      o[j][2] *= a1;
      o[j][3] *= a1;
    }
    // O += P V, P (rounded to T) straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      frag_a_from_acc<T>(a, s, kk);
#pragma unroll
      for (int j = 0; j < DMAX / 8; j += 2) {
        if (j < nnd) {
          uint32_t bb[4];
          frag_b_kn(bb, vs, ld, kk * 16, j * 8, lane);
          mma16816<T>(o[j], a, bb);
          mma16816<T>(o[j + 1], a, bb + 2);
        }
      }
    }
  }
  T* og = static_cast<T*>(p.out) + b * p.o_st.b + h * p.o_st.h;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (j < nnd) {
      const int c = j * 8 + 2 * t;
      if (row0 < p.sq)
        *reinterpret_cast<uint32_t*>(og + row0 * p.o_st.s + c) = pack_f32<T>(
            l0 > 0.f ? o[j][0] / l0 : 0.f, l0 > 0.f ? o[j][1] / l0 : 0.f);
      if (row1 < p.sq)
        *reinterpret_cast<uint32_t*>(og + row1 * p.o_st.s + c) = pack_f32<T>(
            l1 > 0.f ? o[j][2] / l1 : 0.f, l1 > 0.f ? o[j][3] / l1 : 0.f);
    }
  }
  if (p.lse == nullptr) return;
  float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
  if (t == 0) {
    if (row0 < p.sq) lse[row0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kBigNeg;
    if (row1 < p.sq) lse[row1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kBigNeg;
  }
}

// ---------------------------------------------------------------------------
// The warp-specialised wgmma + TMA forward (16-bit, D = 64, 128 or 256).
// Warpgroup 0 is the producer (its first thread issues the TMA loads);
// the others are the consumers, 64 query rows each.
// ---------------------------------------------------------------------------

// Consumer warpgroups at D 64 and 128: every K/V tile a block loads serves
// 64 query rows per consumer, and the K/V bytes the blocks pull from L2
// are what bounds the kernel once its products overlap its softmax.
constexpr int kFwdConsumers = 3;
// Keys a stage at D 64 and 128, and for packed sequences at D = 128,
// whose mask keeps more state a thread (at 128 keys ptxas spilled there).
constexpr int kFwdBK = 128, kFwdSegmentBK = 96;
// Q (kBQ rows) resident; a stage holds K and V (kBK keys); as many stages
// as the shared memory holds, at most 8.  At D = 256, O is 128 f32 a
// thread: two consumers (240 registers each), 64-key tiles, two stages
// (Q 64 KB + 2 x 64 KB).  The carve starts 1024-aligned (the 1024 spare
// bytes pay for the alignment).
template <int D, typename Mask> struct FwdSmem {
  static constexpr int kCons = D == 256 ? 2 : kFwdConsumers;
  static constexpr int kThreads = 128 * (1 + kCons);
  static constexpr int kBQ = 64 * kCons;
  static constexpr int kBK =
      D == 256 ? 64
      : D == 128 && std::is_same<Mask, SegmentMask>::value ? kFwdSegmentBK
                                                           : kFwdBK;
  static constexpr int kQ = kBQ * D * 2, kKV = kBK * D * 2;
  static constexpr int kStage = 2 * kKV;
  // stages that fit the 232,448 bytes of shared memory a block may have
  static constexpr int kFit = (232448 - 1024 - 256 - kQ) / kStage;
  static constexpr int kRing = kFit < 8 ? kFit : 8;  // stages
  static constexpr int kBars = kQ + kRing * kStage;
  static constexpr int kBytes = kBars + (2 * kRing + 1) * 8 + 1024;
  // the consumers' registers: the block's 64 K less the producer's 24 x 128
  static constexpr int kRegs = kCons == 2 ? kConsumerRegs : 160;
  static_assert(kRing >= 2, "the ring needs two stages");
  static_assert(kProducerRegs * 128 + kRegs * 128 * kCons <= 65536,
                "registers");
};

template <typename T, int D, typename Mask>
__global__ void __launch_bounds__(FwdSmem<D, Mask>::kThreads, 1)
    flash_fwd_ws_kernel(const __grid_constant__ Sm90Args a) {
  using namespace sm90;
  using L = FwdSmem<D, Mask>;
  constexpr int BQ = L::kBQ, BK = L::kBK, S = L::kRing, NC = L::kCons;
  // O += P V in column blocks of at most 128 (wgmma's N here)
  constexpr int NV = D > 128 ? 128 : D;
  const Params& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + L::kQ;  // stage s at ring + s * kStage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  uint64_t* q_bar = empty + S;

  const int iq = gridDim.y - 1 - blockIdx.y;  // see launch()
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.rep;
  const int q0 = iq * BQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NC);  // every consumer thread
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  // the key tiles the block visits
  const Mask mask(p, b);
  const Range loop = mask.key_loop(q0, BQ);

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_bar, L::kQ);
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load(qs + cb * BQ * 128, a.q, q_bar, cb * 64, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
        mbar_wait_or_trap(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * L::kStage;
        mbar_arrive_tx(&full[stage], L::kStage);
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(st + cb * BK * 128, a.k, &full[stage], cb * 64, k0, hk, b);
          tma_load(st + L::kKV + cb * BK * 128, a.v, &full[stage], cb * 64,
                   k0, hk, b);
        }
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      producer_drain<S>(q_bar, empty, stage, phase);
    }
  } else {
    setmaxnreg_inc<L::kRegs>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int qc = q0 + 64 * c;  // this warpgroup's rows [qc, qc + 64)
    const int qi0 = qc + 16 * w + g, qi1 = qi0 + 8;  // this thread's rows
    // the keys each of the two rows sees, and those of this warpgroup
    const Range kr0 = mask.keys(qi0), kr1 = mask.keys(qi1);
    const Range own = qc < p.sq ? mask.key_loop(qc, 64) : Range{0, 0};
    const float scale2 = p.scale * kLog2e;
    const uint32_t q_tile = smem_u32(qs);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running max (log2 units) of the two rows, and this lane's share of
    // their sums (the 4 lanes of a row add theirs at the end)
    float m0 = kBigNeg, m1 = kBigNeg, l0 = 0.f, l1 = 0.f;

    // S (scores of tile k0) -> probabilities in place; the rows' max and
    // sums updated; returns O's rescale factors in a0, a1
    auto softmax = [&](float* s, int k0, float& a0, float& a1) {
      // a tile wholly inside the pattern (the common case) takes no
      // per-element test: its scores are all valid, and so is its max
      const bool full_tile = mask.tile_full(qc, 64, k0, BK);
      if (full_tile) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] *= scale2;
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            s[4 * j + e] = inside(e < 2 ? kr0 : kr1, kj)
                               ? s[4 * j + e] * scale2 : kBigNeg;
          }
      }
      float mx0 = kBigNeg, mx1 = kBigNeg;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      if (full_tile) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j] = fast_exp2(s[4 * j] - mn0);
          s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mn0);
          s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mn1);
          s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mn1);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          // exp2 of every element, then a select (no branch): a masked
          // score's probability is 0 even while the row's max is kBigNeg
          const float x = s[i];
          const float ex = fast_exp2(x - ((i & 2) ? mn1 : mn0));
          s[i] = x > kBigNeg ? ex : 0.f;
        }
      }
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      a0 = fast_exp2(m0 - mn0);
      a1 = fast_exp2(m1 - mn1);
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
      m0 = mn0;
      m1 = mn1;
    };
    auto rescale = [&](float a0, float a1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    };
    // The consumers take turns, in a ring, at issuing their products, so
    // that one's softmax runs under the others' products (measured 0.5-2 %
    // faster than no turns): barrier 1 + c is consumer c's; it waits for
    // its turn, issues one product and hands the turn on, so the tensor
    // cores see consumer 0's S, 1's S, ..., then 0's P V, ...
    auto my_turn = [&] { named_bar_sync(1 + c, 256); };
    auto next_turn = [&] { named_bar_arrive(1 + (c + 1) % NC, 256); };

    mbar_wait(q_bar, 0);
    if (c == NC - 1) named_bar_arrive(1, 256);  // consumer 0 first
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
      mbar_wait(&full[stage], phase);
      __syncwarp();  // wgmma's .aligned: the warp converged
      if (k0 < own.hi && k0 + BK > own.lo) {
        const uint32_t k_tile = smem_u32(ring + stage * L::kStage);
        // S = Q K^T: 64 rows x BK keys, both operands K-major
        float s[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
        fence_regs<BK / 2>(s);
        my_turn();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T, BK>(s, desc_k(q_tile, BQ, 64 * c, kk),
                          desc_k(k_tile, BK, 0, kk), kk > 0);
        wgmma_commit();
        next_turn();
        wgmma_wait_all();
        fence_regs<BK / 2>(s);
        float a0, a1;
        softmax(s, k0, a0, a1);
        rescale(a0, a1);
        // O += P V, P (rounded to T) from registers, V MN-major
        uint32_t ap[BK / 16][4];
        acc_to_frags<T, BK>(ap, s);
        fence_regs<BK / 4>(&ap[0][0]);
        fence_regs<D / 2>(o);
        my_turn();
        wgmma_fence();
        const uint32_t v_tile = k_tile + L::kKV;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int n = 0; n < D / NV; ++n)
            wgmma_rs_tb<T, NV>(o + n * NV / 2, ap[kk],
                               desc_mn(v_tile + n * (NV / 64) * BK * 128,
                                       BK, kk));
        wgmma_commit();
        next_turn();
        wgmma_wait_all();
        fence_regs<D / 2>(o);
      } else {
        my_turn();  // the two turns of a tile this warpgroup skips
        next_turn();
        my_turn();
        next_turn();
      }
      mbar_arrive(&empty[stage]);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (c == 0) named_bar_sync(1, 256);  // the last turn

    // the rows' sums across their 4 lanes; O / l and lse
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float r0 = l0 > 0.f ? 1.f / l0 : 0.f, r1 = l1 > 0.f ? 1.f / l1 : 0.f;
    rescale(r0, r1);
    T* og = static_cast<T*>(p.out) + b * p.o_st.b + h * p.o_st.h;
    store_acc<T, D>(og, p.o_st.s, o, qi0, p.sq, t);
    if (p.lse != nullptr && t == 0) {
      float* lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
      if (qi0 < p.sq) lse[qi0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kBigNeg;
      if (qi1 < p.sq) lse[qi1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kBigNeg;
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The grid is (head, query tile, batch), heads fastest, so that the blocks
// of one query tile start together in every head, and the kernels take the
// tiles in reverse (the dense causal pattern's longest first): measured
// 23 % faster than query tiles fastest at B=1, H=32, S=4096, causal.
template <typename K, typename A>
int launch(K kernel, const A& args, const Params& p, int tile, int threads,
           size_t smem, int batch, cudaStream_t stream) {
  int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<dim3(p.heads, ceil_div(p.sq, tile), batch), threads, smem,
           stream>>>(args);
  return int(cudaGetLastError());
}

template <typename T, int D, typename Mask>
int launch_fwd_ws(const Params& p, int batch, int dtype, cudaStream_t s) {
  using L = FwdSmem<D, Mask>;
  Sm90Args a;
  a.p = p;
  const int e = make_views(a, batch, dtype, L::kBQ, L::kBK);
  if (e) return e;
  return launch(flash_fwd_ws_kernel<T, D, Mask>, a, p, L::kBQ, L::kThreads,
                L::kBytes, batch, s);
}

template <typename T, typename Mask>
int launch_fwd_16(const Params& p, int batch, int dtype, cudaStream_t s) {
  if (ws_route(p.d, dtype, true)) {
    if (p.d == 64) return launch_fwd_ws<T, 64, Mask>(p, batch, dtype, s);
    if (p.d == 128) return launch_fwd_ws<T, 128, Mask>(p, batch, dtype, s);
    return launch_fwd_ws<T, 256, Mask>(p, batch, dtype, s);
  }
  if (p.d <= 128)
    return launch(flash_fwd_kernel<T, Mask, 128>, p, p, kFwdWarps * 16,
                  kFwdWarps * 32, fwd_smem_mma(p.d), batch, s);
  return launch(flash_fwd_kernel<T, Mask, 256>, p, p, kFwdWarps * 16,
                kFwdWarps * 32, fwd_smem_mma(p.d), batch, s);
}

template <typename Mask>
int launch_fwd(const Params& p, int batch, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch(flash_fwd_f32_kernel<Mask>, p, p, kF32Tile, kF32Threads,
                    fwd_smem_f32(p.d), batch, s);
    case 1:
      return launch_fwd_16<__half, Mask>(p, batch, dtype, s);
    case 2:
      return launch_fwd_16<__nv_bfloat16, Mask>(p, batch, dtype, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <int D>
size_t ws_fwd_smem() {
  const size_t dense = FwdSmem<D, DenseMask>::kBytes;
  const size_t seg = FwdSmem<D, SegmentMask>::kBytes;
  return dense > seg ? dense : seg;
}

Params make_params(const void* q, const void* k, const void* v, void* out,
                   float* lse, const long long* strides, int heads,
                   int kv_heads, int sq, int sk, int d, int causal,
                   float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  set_strides(p, strides);
  p.heads = heads;
  p.rep = heads / kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace
}  // namespace flash

extern "C" {

// Shared-memory bytes one block needs; dtype 0 float32, 1 float16,
// 2 bfloat16.
size_t flash_fwd_smem_bytes(int d, int dtype) {
  using namespace flash;
  if (ws_route(d, dtype, true))  // the larger of the masks' layouts
    return d == 64    ? ws_fwd_smem<64>()
           : d == 128 ? ws_fwd_smem<128>()
                      : ws_fwd_smem<256>();
  return dtype == 0 ? fwd_smem_f32(d) : fwd_smem_mma(d);
}

const char* flash_fwd_error_string(int code) {
  return flash::ws_error_string(code);
}

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched), or a tensor-map error (flash_fwd_error_string).  strides: 24
// int64 as in flash::set_strides (q, k, v and o are read).

// Dense: q (B, H, Sq, D), k/v (B, Hkv, Sk, D), out like q, lse (B, H, Sq)
// f32 contiguous.
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              float* lse, const long long* strides, int batch, int heads,
              int kv_heads, int sq, int sk, int d, int causal, float scale,
              int dtype, void* stream) {
  using namespace flash;
  if (batch == 0 || sq == 0) return 0;
  const Params p = make_params(q, k, v, out, lse, strides, heads, kv_heads,
                               sq, sk, d, causal, scale);
  return launch_fwd<DenseMask>(p, batch, dtype,
                               static_cast<cudaStream_t>(stream));
}

// Packed sequences (batch 1, sq == sk == T): q (H, T, D), k/v (Hkv, T, D)
// as views with batch stride 0, out like q, lse (H, T) f32 contiguous,
// span (2, T) int32: the start and end of each token's segment.
int varlen_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const int* span, const long long* strides,
               int batch, int heads, int kv_heads, int sq, int sk, int d,
               int causal, float scale, int dtype, void* stream) {
  using namespace flash;
  if (batch != 1 || sq != sk) return int(cudaErrorInvalidValue);
  if (sq == 0) return 0;
  Params p = make_params(q, k, v, out, lse, strides, heads, kv_heads, sq,
                         sk, d, causal, scale);
  p.span = span;
  return launch_fwd<SegmentMask>(p, 1, dtype,
                                 static_cast<cudaStream_t>(stream));
}

// Ragged lengths: q (B, H, Sq, D), k/v (B, H, Sk, D) (kv_heads == heads),
// out like q, kv_lens (B,) int32; no lse.
int ragged_fwd(const void* q, const void* k, const void* v, void* out,
               const int* kv_lens, const long long* strides, int batch,
               int heads, int kv_heads, int sq, int sk, int d, int causal,
               float scale, int dtype, void* stream) {
  using namespace flash;
  if (kv_heads != heads) return int(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0) return 0;
  Params p = make_params(q, k, v, out, nullptr, strides, heads, kv_heads,
                         sq, sk, d, causal, scale);
  p.kv_lens = kv_lens;
  return launch_fwd<LengthMask>(p, batch, dtype,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
