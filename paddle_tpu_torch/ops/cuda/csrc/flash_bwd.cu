// Flash attention, backward, for Hopper (sm_90a): two kernels, each
// templated on the mask policy (flash_common.cuh), two entry points each.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/attention.py:
// - `flash_dq`, `flash_dkv` (DenseMask): `_dq_kernel` and `_dkv_kernel`,
//   reached through `_flash_bwd`;
// - `varlen_dq`, `varlen_dkv` (SegmentMask): `_varlen_dq_kernel` and
//   `_varlen_dkv_kernel`, through `_varlen_flash_bwd` (packed sequences).
//
// What they compute, from the forward's saved output o and f32 log-sum-exp
// lse, for each batch b and query head h (kv head h / rep):
//   p_ij    = exp(scale * q_i . k_j - lse_i)   (0 where the mask hides j)
//   delta_i = sum_d dO_id * o_id                (f32, recomputed per tile)
//   dS_ij   = p_ij * (dO_i . v_j - delta_i) * scale
//   dq_i    = sum_j dS_ij k_j
//   dk_j    = sum_{h in the group} sum_i dS_ij q_i
//   dv_j    = sum_{h in the group} sum_i p_ij dO_i
// p and dS are rounded to the input type as operands of the products, as
// the TPU kernels do; the sums are f32 and each output is written once.
//
// Bound: arithmetic at the dense training shape.  At B=1, H=32, S=4096,
// D=128, causal, bf16 the dq kernel does three products (206 GFLOP) and
// the dk/dv kernel four (275 GFLOP) over ~200 MB of operands, far above
// the H100's ~295 FLOP per byte balance point.  (Packed into six
// documents, the same T has a quarter of the pairs and the bytes set the
// bound.)  So, as in the forward, the 16-bit kernels keep scores,
// probabilities, dS and the accumulators in registers (mma.sync m16n8k16,
// bf16/fp16 in, f32 out), each warp owning 16 rows, and stage only the
// operand tiles in shared memory:
// - `flash_dq_kernel`: one block per (64-row query tile, head, batch)
//   loops over the key tiles its mask policy gives (up to the diagonal,
//   or the tile's own documents; the TPU kernel's sequential key axis
//   becomes this loop); each warp computes S and dP for its 16 query
//   rows, turns them into dS in place and accumulates dq = dS K in
//   registers.
// - `flash_dkv_kernel`: one block of eight warps per (128-key tile, kv
//   head, batch) keeps its K/V tile in shared memory and walks the group's
//   `rep` query heads and, for each, the 64-row query tiles that see its
//   keys (from the diagonal on, or those of its keys' documents).  Each
//   warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T
//   directly, so P^T and dS^T are already the A operands of dv += P^T dO
//   and dk += dS^T Q: no transpose passes through shared memory.  Summing
//   the group inside the block needs no atomics and no repeated K/V in
//   device memory, and is deterministic.
// Operand tiles arrive by cp.async, all of a tile's copies in flight at
// once, and probabilities are one FMA and one MUFU.EX2 each.  float32
// inputs take kernels of plain f32 FMA out of shared memory (no TF32).
// wgmma, TMA and a fused single-pass backward are later work.

#include "flash_common.cuh"

namespace flash {
namespace {

size_t dq_smem_f32(int d) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const size_t ldt = d + 4, lds = BK + 4, ldo = d + 4;
  return 5 * round128(BQ * ldt * 4) + 3 * round128(BQ * lds * 4)
         + round128(BQ * ldo * 4) + 2 * round128(BQ * 4);
}

size_t dkv_smem_f32(int d) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const size_t ldt = d + 4, lds = BK + 4, ldo = d + 4;
  return 5 * round128(BQ * ldt * 4) + 4 * round128(BQ * lds * 4)
         + 2 * round128(BK * ldo * 4) + 2 * round128(BQ * 4);
}

// The 16-bit dk/dv kernel's blocks are eight warps of 16 keys: each
// Q/dO/O tile it loads, and each barrier, serves 128 keys (measured 18 %
// faster than four warps of 16 at the same occupancy).
constexpr int kDkvWarps = 8;

// 16-bit dq: Q, dO, O, K and V tiles; the rows' lse and delta
size_t dq_smem_mma(int d) {
  return 5 * round128(size_t(kMmaTile) * (d + 8) * 2)
         + 2 * round128(kMmaTile * 4);
}

// 16-bit dk/dv: K and V tiles of 128 keys, Q, dO and O tiles of 64 rows;
// the rows' lse and delta
size_t dkv_smem_mma(int d) {
  return 2 * round128(size_t(kDkvWarps * 16) * (d + 8) * 2)
         + 3 * round128(size_t(kMmaTile) * (d + 8) * 2)
         + 2 * round128(kMmaTile * 4);
}

template <typename Mask>
__global__ void __launch_bounds__(kF32Threads) flash_dq_f32_kernel(Params p) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const int d = p.d;
  const int ldt = d + 4, lds = BK + 4, ldo = d + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* qs = cv.take<float>(BQ * ldt);
  float* dos = cv.take<float>(BQ * ldt);
  float* ots = cv.take<float>(BQ * ldt);
  float* ks = cv.take<float>(BK * ldt);
  float* vs = cv.take<float>(BK * ldt);
  float* ss = cv.take<float>(BQ * lds);
  float* dps = cv.take<float>(BQ * lds);
  float* dss = cv.take<float>(BQ * lds);
  float* dqs = cv.take<float>(BQ * ldo);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int iq = gridDim.y - 1 - blockIdx.y;  // most key tiles first
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.rep;
  const int q0 = iq * BQ;
  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_st.b + h * p.q_st.h;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  const float* og =
      static_cast<const float*>(p.o) + b * p.o_st.b + h * p.o_st.h;
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
  const float* lse_g =
      p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;

  load_tile<kF32Threads>(qs, ldt, qg, p.q_st.s, q0, p.sq, BQ, d);
  load_tile<kF32Threads>(dos, ldt, dog, p.do_st.s, q0, p.sq, BQ, d);
  load_tile<kF32Threads>(ots, ldt, og, p.o_st.s, q0, p.sq, BQ, d);
  await_tiles();
  __syncthreads();
  row_stats<kF32Threads>(lse_s, delta_s, lse_g, ots, dos, ldt, q0, p.sq, BQ,
                         d);
  for (int i = threadIdx.x; i < BQ * ldo; i += kF32Threads) dqs[i] = 0.f;
  const Mask mask(p, b);
  const Range loop = mask.key_loop(q0, BQ);
  for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
    await_tiles();
    __syncthreads();  // the previous tile's readers of ks/vs/dss are done
    load_tile<kF32Threads>(ks, ldt, kg, p.k_st.s, k0, p.sk, BK, d);
    load_tile<kF32Threads>(vs, ldt, vg, p.v_st.s, k0, p.sk, BK, d);
    await_tiles();
    __syncthreads();
    block_mm_f32<false, true, false>(ss, lds, qs, ldt, ks, ldt, BQ, BK, d);
    block_mm_f32<false, true, false>(dps, lds, dos, ldt, vs, ldt, BQ, BK, d);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += kF32Threads) {
      const int r = i / BK, c = i % BK;
      const bool ok = inside(mask.keys(q0 + r), k0 + c);
      const float pr = ok ? expf(ss[r * lds + c] * p.scale - lse_s[r]) : 0.f;
      dss[r * lds + c] = pr * (dps[r * lds + c] - delta_s[r]) * p.scale;
    }
    __syncthreads();
    block_mm_f32<false, false, true>(dqs, ldo, dss, lds, ks, ldt, BQ, d, BK);
  }
  __syncthreads();
  float* dqg = static_cast<float*>(p.dq) + b * p.dq_st.b + h * p.dq_st.h;
  for (int i = threadIdx.x; i < BQ * d; i += kF32Threads) {
    const int r = i / d, c = i % d, qi = q0 + r;
    if (qi < p.sq) dqg[qi * p.dq_st.s + c] = dqs[r * ldo + c];
  }
}

template <typename Mask>
__global__ void __launch_bounds__(kF32Threads)
    flash_dkv_f32_kernel(Params p) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const int d = p.d;
  const int ldt = d + 4, lds = BK + 4, ldo = d + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  float* ks = cv.take<float>(BK * ldt);
  float* vs = cv.take<float>(BK * ldt);
  float* qs = cv.take<float>(BQ * ldt);
  float* dos = cv.take<float>(BQ * ldt);
  float* ots = cv.take<float>(BQ * ldt);
  float* ss = cv.take<float>(BQ * lds);
  float* dps = cv.take<float>(BQ * lds);
  float* ps = cv.take<float>(BQ * lds);
  float* dss = cv.take<float>(BQ * lds);
  float* dks = cv.take<float>(BK * ldo);
  float* dvs = cv.take<float>(BK * ldo);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int ik = blockIdx.y;  // under causality tile 0 has the most work
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = ik * BK;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  load_tile<kF32Threads>(ks, ldt, kg, p.k_st.s, k0, p.sk, BK, d);
  load_tile<kF32Threads>(vs, ldt, vg, p.v_st.s, k0, p.sk, BK, d);
  for (int i = threadIdx.x; i < BK * ldo; i += kF32Threads) {
    dks[i] = 0.f;
    dvs[i] = 0.f;
  }
  // the query rows that see some key of the tile
  const Mask mask(p, b);
  const Range loop = mask.query_loop(k0, BK, BQ);
  for (int g = 0; g < p.rep; ++g) {
    const int h = hk * p.rep + g;
    const float* qg =
        static_cast<const float*>(p.q) + b * p.q_st.b + h * p.q_st.h;
    const float* og =
        static_cast<const float*>(p.o) + b * p.o_st.b + h * p.o_st.h;
    const float* dog =
        static_cast<const float*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
    const float* lse_g =
        p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
      await_tiles();
      __syncthreads();  // the previous tile's readers are done
      load_tile<kF32Threads>(qs, ldt, qg, p.q_st.s, q0, p.sq, BQ, d);
      load_tile<kF32Threads>(dos, ldt, dog, p.do_st.s, q0, p.sq, BQ, d);
      load_tile<kF32Threads>(ots, ldt, og, p.o_st.s, q0, p.sq, BQ, d);
      await_tiles();
      __syncthreads();
      row_stats<kF32Threads>(lse_s, delta_s, lse_g, ots, dos, ldt, q0, p.sq,
                             BQ, d);
      block_mm_f32<false, true, false>(ss, lds, qs, ldt, ks, ldt, BQ, BK, d);
      block_mm_f32<false, true, false>(dps, lds, dos, ldt, vs, ldt, BQ, BK,
                                       d);
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * BK; i += kF32Threads) {
        const int r = i / BK, c = i % BK;
        const bool ok = inside(mask.keys(q0 + r), k0 + c);
        const float pr =
            ok ? expf(ss[r * lds + c] * p.scale - lse_s[r]) : 0.f;
        ps[r * lds + c] = pr;
        dss[r * lds + c] = pr * (dps[r * lds + c] - delta_s[r]) * p.scale;
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: the transposes are read in place
      block_mm_f32<true, false, true>(dvs, ldo, ps, lds, dos, ldt, BK, d,
                                      BQ);
      block_mm_f32<true, false, true>(dks, ldo, dss, lds, qs, ldt, BK, d,
                                      BQ);
    }
  }
  __syncthreads();
  float* dkg = static_cast<float*>(p.dk) + b * p.dk_st.b + hk * p.dk_st.h;
  float* dvg = static_cast<float*>(p.dv) + b * p.dv_st.b + hk * p.dv_st.h;
  for (int i = threadIdx.x; i < BK * d; i += kF32Threads) {
    const int r = i / d, c = i % d, kj = k0 + r;
    if (kj >= p.sk) continue;
    dkg[kj * p.dk_st.s + c] = dks[r * ldo + c];
    dvg[kj * p.dv_st.s + c] = dvs[r * ldo + c];
  }
}

// Store a warp's 16-row accumulator acc[n-tile][4] (rows r0 and r0 + 8 of
// this thread) as T pairs at dst (row stride ss); rows >= rows are skipped.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long ss,
                                           const float (*acc)[4], int r0,
                                           int rows, int nnd, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < nnd) {
      const int c = j * 8 + 2 * t;
      if (r0 < rows)
        *reinterpret_cast<uint32_t*>(dst + r0 * ss + c) =
            pack_f32<T>(acc[j][0], acc[j][1]);
      if (r0 + 8 < rows)
        *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * ss + c) =
            pack_f32<T>(acc[j][2], acc[j][3]);
    }
  }
}

template <typename T, typename Mask>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_kernel(Params p) {
  constexpr int BQ = kMmaTile, BK = kMmaTile;
  const int d = p.d, ld = d + pad<T>();
  const int nkd = d / 16, nnd = d / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(BQ * ld);
  T* dos = cv.take<T>(BQ * ld);
  T* ots = cv.take<T>(BQ * ld);
  T* ks = cv.take<T>(BK * ld);
  T* vs = cv.take<T>(BK * ld);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int iq = gridDim.y - 1 - blockIdx.y;  // most key tiles first
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.rep;
  const int q0 = iq * BQ;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_st.b + h * p.q_st.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  const T* og = static_cast<const T*>(p.o) + b * p.o_st.b + h * p.o_st.h;
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
  const float* lse_g =
      p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;

  load_tile<kMmaThreads>(qs, ld, qg, p.q_st.s, q0, p.sq, BQ, d);
  load_tile<kMmaThreads>(dos, ld, dog, p.do_st.s, q0, p.sq, BQ, d);
  load_tile<kMmaThreads>(ots, ld, og, p.o_st.s, q0, p.sq, BQ, d);
  await_tiles();
  __syncthreads();
  row_stats<kMmaThreads>(lse_s, delta_s, lse_g, ots, dos, ld, q0, p.sq, BQ,
                         d);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  // exp(s scale - lse) = 2^(s scale log2e - lse log2e): one FMA and ex2
  const float scale2 = p.scale * kLog2e;
  const float nl0 = -lse_s[r0] * kLog2e, nl1 = -lse_s[r0 + 8] * kLog2e;
  const float dl0 = delta_s[r0], dl1 = delta_s[r0 + 8];
  float dq[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  // the keys each of the two rows sees, and the key tiles the block visits
  const Mask mask(p, b);
  const Range kr0 = mask.keys(qi0), kr1 = mask.keys(qi1);
  const Range loop = mask.key_loop(q0, BQ);
  for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers of ks/vs are done
    load_tile<kMmaThreads>(ks, ld, kg, p.k_st.s, k0, p.sk, BK, d);
    load_tile<kMmaThreads>(vs, ld, vg, p.v_st.s, k0, p.sk, BK, d);
    await_tiles();
    __syncthreads();
    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk < nkd) {
        uint32_t aq[4], ad[4];
        frag_a(aq, qs, ld, warp * 16, kk * 16, lane);
        frag_a(ad, dos, ld, warp * 16, kk * 16, lane);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          uint32_t bb[4];
          frag_b_nk(bb, ks, ld, j * 8, kk * 16, lane);
          mma16816<T>(s[j], aq, bb);
          mma16816<T>(s[j + 1], aq, bb + 2);
          frag_b_nk(bb, vs, ld, j * 8, kk * 16, lane);
          mma16816<T>(dp[j], ad, bb);
          mma16816<T>(dp[j + 1], ad, bb + 2);
        }
      }
    }
    // dS = P (dP - delta) scale, P = exp(S scale - lse), in place in s
    const bool full = mask.tile_full(q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = full || inside(e < 2 ? kr0 : kr1, kj);
        const float pr =
            ok ? fast_exp2(fmaf(s[j][e], scale2, e < 2 ? nl0 : nl1)) : 0.f;
        s[j][e] = pr * (dp[j][e] - (e < 2 ? dl0 : dl1)) * p.scale;
      }
    }
    // dQ += dS K, dS (rounded to T) straight from registers
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      frag_a_from_acc<T>(a, s, kk);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        if (j < nnd) {
          uint32_t bb[4];
          frag_b_kn(bb, ks, ld, kk * 16, j * 8, lane);
          mma16816<T>(dq[j], a, bb);
          mma16816<T>(dq[j + 1], a, bb + 2);
        }
      }
    }
  }
  T* dqg = static_cast<T*>(p.dq) + b * p.dq_st.b + h * p.dq_st.h;
  store_rows<T>(dqg, p.dq_st.s, dq, qi0, p.sq, nnd, t);
}

template <typename T, typename Mask>
__global__ void __launch_bounds__(kDkvWarps * 32)
    flash_dkv_kernel(Params p) {
  constexpr int BQ = kMmaTile, BK = kDkvWarps * 16, NT = kDkvWarps * 32;
  const int d = p.d, ld = d + pad<T>();
  const int nkd = d / 16, nnd = d / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* ks = cv.take<T>(BK * ld);
  T* vs = cv.take<T>(BK * ld);
  T* qs = cv.take<T>(BQ * ld);
  T* dos = cv.take<T>(BQ * ld);
  T* ots = cv.take<T>(BQ * ld);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ik = blockIdx.y;  // under causality tile 0 has the most work
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = ik * BK;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  load_tile<NT>(ks, ld, kg, p.k_st.s, k0, p.sk, BK, d);
  load_tile<NT>(vs, ld, vg, p.v_st.s, k0, p.sk, BK, d);
  const int kj0 = k0 + warp * 16 + g, kj1 = kj0 + 8;  // this thread's keys
  // exp(s scale - lse) = 2^(s scale log2e - lse log2e): one FMA and ex2
  const float scale2 = p.scale * kLog2e;
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // the query rows that see each of the two keys, and the query tiles the
  // block visits
  const Mask mask(p, b);
  const Range qr0 = mask.queries(kj0), qr1 = mask.queries(kj1);
  const Range loop = mask.query_loop(k0, BK, BQ);
  for (int gi = 0; gi < p.rep; ++gi) {
    const int h = hk * p.rep + gi;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_st.b + h * p.q_st.h;
    const T* og = static_cast<const T*>(p.o) + b * p.o_st.b + h * p.o_st.h;
    const T* dog =
        static_cast<const T*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
    const float* lse_g =
        p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
      await_tiles();
      __syncthreads();  // the previous tile's readers are done
      load_tile<NT>(qs, ld, qg, p.q_st.s, q0, p.sq, BQ, d);
      load_tile<NT>(dos, ld, dog, p.do_st.s, q0, p.sq, BQ, d);
      load_tile<NT>(ots, ld, og, p.o_st.s, q0, p.sq, BQ, d);
      await_tiles();
      __syncthreads();
      row_stats<NT>(lse_s, delta_s, lse_g, ots, dos, ld, q0, p.sq,
                             BQ, d);
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < nkd) {
          uint32_t ak[4], av[4];
          frag_a(ak, ks, ld, warp * 16, kk * 16, lane);
          frag_a(av, vs, ld, warp * 16, kk * 16, lane);
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            uint32_t bb[4];
            frag_b_nk(bb, qs, ld, j * 8, kk * 16, lane);
            mma16816<T>(st[j], ak, bb);
            mma16816<T>(st[j + 1], ak, bb + 2);
            frag_b_nk(bb, dos, ld, j * 8, kk * 16, lane);
            mma16816<T>(dpt[j], av, bb);
            mma16816<T>(dpt[j + 1], av, bb + 2);
          }
        }
      }
      __syncthreads();  // lse_s and delta_s are written by all warps
      // P^T in st, dS^T in dpt; lse and delta belong to the query column
      const bool full = mask.tile_full(q0, BQ, k0, BK);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          const bool ok = full || inside(e < 2 ? qr0 : qr1, q0 + qc);
          const float pr =
              ok ? fast_exp2(fmaf(st[j][e], scale2, -lse_s[qc] * kLog2e))
                 : 0.f;
          dpt[j][e] = pr * (dpt[j][e] - delta_s[qc]) * p.scale;
          st[j][e] = pr;
        }
      }
      // rounded to T as A operands here, so that the f32 tiles die before
      // the products (the accumulators need the registers)
      uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        frag_a_from_acc<T>(ap[kk], st, kk);
        frag_a_from_acc<T>(ads[kk], dpt, kk);
      }
      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          if (j < nnd) {
            uint32_t bb[4];
            frag_b_kn(bb, dos, ld, kk * 16, j * 8, lane);
            mma16816<T>(dv[j], ap[kk], bb);
            mma16816<T>(dv[j + 1], ap[kk], bb + 2);
            frag_b_kn(bb, qs, ld, kk * 16, j * 8, lane);
            mma16816<T>(dk[j], ads[kk], bb);
            mma16816<T>(dk[j + 1], ads[kk], bb + 2);
          }
        }
      }
    }
  }
  T* dkg = static_cast<T*>(p.dk) + b * p.dk_st.b + hk * p.dk_st.h;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_st.b + hk * p.dv_st.h;
  store_rows<T>(dkg, p.dk_st.s, dk, kj0, p.sk, nnd, t);
  store_rows<T>(dvg, p.dv_st.s, dv, kj0, p.sk, nnd, t);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   const long long* strides, int heads, int kv_heads, int sq,
                   int sk, int d, int causal, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
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

template <typename K>
int launch(K kernel, const Params& p, dim3 grid, int threads, size_t smem,
           cudaStream_t stream) {
  int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Grids are (head, tile, batch), heads fastest, so that the blocks of one
// tile start together in every head (measured faster than tiles fastest:
// 17 % in dq, 3 % in dk/dv at B=1, H=32, S=4096, causal).
template <typename Mask>
int launch_dq(const Params& p, int batch, int dtype, cudaStream_t s) {
  const dim3 f32_grid(p.heads, ceil_div(p.sq, kF32Tile), batch);
  const dim3 grid(p.heads, ceil_div(p.sq, kMmaTile), batch);
  switch (dtype) {
    case 0:
      return launch(flash_dq_f32_kernel<Mask>, p, f32_grid, kF32Threads,
                    dq_smem_f32(p.d), s);
    case 1:
      return launch(flash_dq_kernel<__half, Mask>, p, grid, kMmaThreads,
                    dq_smem_mma(p.d), s);
    case 2:
      return launch(flash_dq_kernel<__nv_bfloat16, Mask>, p, grid,
                    kMmaThreads, dq_smem_mma(p.d), s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename Mask>
int launch_dkv(const Params& p, int batch, int dtype, cudaStream_t s) {
  const int kv_heads = p.heads / p.rep;
  const dim3 f32_grid(kv_heads, ceil_div(p.sk, kF32Tile), batch);
  const dim3 grid(kv_heads, ceil_div(p.sk, kDkvWarps * 16), batch);
  switch (dtype) {
    case 0:
      return launch(flash_dkv_f32_kernel<Mask>, p, f32_grid, kF32Threads,
                    dkv_smem_f32(p.d), s);
    case 1:
      return launch(flash_dkv_kernel<__half, Mask>, p, grid, kDkvWarps * 32,
                    dkv_smem_mma(p.d), s);
    case 2:
      return launch(flash_dkv_kernel<__nv_bfloat16, Mask>, p, grid,
                    kDkvWarps * 32, dkv_smem_mma(p.d), s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace flash

extern "C" {

// Shared-memory bytes one block of each kernel needs; dtype 0 float32,
// 1 float16, 2 bfloat16.
size_t flash_dq_smem_bytes(int d, int dtype) {
  using namespace flash;
  return dtype == 0 ? dq_smem_f32(d) : dq_smem_mma(d);
}

size_t flash_dkv_smem_bytes(int d, int dtype) {
  using namespace flash;
  return dtype == 0 ? dkv_smem_f32(d) : dkv_smem_mma(d);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched).  strides: 24 int64 as in flash::set_strides.

// Dense: q, o, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); lse
// (B, H, Sq) f32 contiguous.
int flash_dq(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dq,
             const long long* strides, int batch, int heads, int kv_heads,
             int sq, int sk, int d, int causal, float scale, int dtype,
             void* stream) {
  using namespace flash;
  if (batch == 0 || sq == 0) return 0;
  Params p = make_params(q, k, v, o, dout, lse, strides, heads, kv_heads, sq,
                         sk, d, causal, scale);
  p.dq = dq;
  return launch_dq<DenseMask>(p, batch, dtype,
                              static_cast<cudaStream_t>(stream));
}

int flash_dkv(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dk, void* dv,
              const long long* strides, int batch, int heads, int kv_heads,
              int sq, int sk, int d, int causal, float scale, int dtype,
              void* stream) {
  using namespace flash;
  if (batch == 0 || sk == 0) return 0;
  Params p = make_params(q, k, v, o, dout, lse, strides, heads, kv_heads, sq,
                         sk, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return launch_dkv<DenseMask>(p, batch, dtype,
                               static_cast<cudaStream_t>(stream));
}

// Packed sequences (batch 1, sq == sk == T): (H, T, D) and (Hkv, T, D)
// views with batch stride 0, lse (H, T) f32 contiguous, span (2, T) int32:
// the start and end of each token's segment.
int varlen_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, void* dq, const int* span,
              const long long* strides, int batch, int heads, int kv_heads,
              int sq, int sk, int d, int causal, float scale, int dtype,
              void* stream) {
  using namespace flash;
  if (batch != 1 || sq != sk) return int(cudaErrorInvalidValue);
  if (sq == 0) return 0;
  Params p = make_params(q, k, v, o, dout, lse, strides, heads, kv_heads, sq,
                         sk, d, causal, scale);
  p.dq = dq;
  p.span = span;
  return launch_dq<SegmentMask>(p, 1, dtype,
                                static_cast<cudaStream_t>(stream));
}

int varlen_dkv(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dk, void* dv,
               const int* span, const long long* strides, int batch,
               int heads, int kv_heads, int sq, int sk, int d, int causal,
               float scale, int dtype, void* stream) {
  using namespace flash;
  if (batch != 1 || sq != sk) return int(cudaErrorInvalidValue);
  if (sk == 0) return 0;
  Params p = make_params(q, k, v, o, dout, lse, strides, heads, kv_heads, sq,
                         sk, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  p.span = span;
  return launch_dkv<SegmentMask>(p, 1, dtype,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
