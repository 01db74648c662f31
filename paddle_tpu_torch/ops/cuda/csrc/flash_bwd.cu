// Flash attention, backward, for Hopper (sm_90a): a delta pre-pass and two
// kernels, each templated on the mask policy (flash_common.cuh), two entry
// points each.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/attention.py:
// - `flash_dq`, `flash_dkv` (DenseMask): `_dq_kernel` and `_dkv_kernel`,
//   reached through `_flash_bwd`;
// - `varlen_dq`, `varlen_dkv` (SegmentMask): `_varlen_dq_kernel` and
//   `_varlen_dkv_kernel`, through `_varlen_flash_bwd` (packed sequences);
// - `flash_bwd_delta`: the delta = rowsum(dO * O) that each of those TPU
//   kernels recomputes for every tile (`_dq_kernel`'s first lines).
//
// What they compute, from the forward's f32 log-sum-exp lse and the
// pre-pass's f32 delta, for each batch b and query head h (kv head h /
// rep):
//   delta_i = sum_d dO_id * o_id                (the pre-pass, once a row)
//   p_ij    = exp(scale * q_i . k_j - lse_i)   (0 where the mask hides j)
//   dS_ij   = p_ij * (dO_i . v_j - delta_i) * scale
//   dq_i    = sum_j dS_ij k_j
//   dk_j    = sum_{h in the group} sum_i dS_ij q_i
//   dv_j    = sum_{h in the group} sum_i p_ij dO_i
// p and dS are rounded to the input type as operands of the products, as
// the TPU kernels do; the sums are f32, each output is written once and
// dq is deterministic (no atomics anywhere).
//
// Bound: arithmetic at the dense training shape.  At B=1, H=32, S=4096,
// D=128, causal, bf16 the dq kernel does three products (206 GFLOP) and
// the dk/dv kernel four (275 GFLOP) over ~200 MB of operands, far above
// the H100's ~295 FLOP per byte balance point; the pre-pass is bound by
// its bytes (dO and O read once, 64 MB there).  Three kernels:
// - bf16/fp16 at D = 64 and 128 (`flash_dq_ws_kernel`,
//   `flash_dkv_ws_kernel`): warp-specialised for Hopper.  A producer
//   warpgroup (its registers cut by setmaxnreg) loads tiles by TMA with the
//   128-byte swizzle into a ring of kStages stages, each guarded by a full
//   and an empty mbarrier; two consumer warpgroups of 64 rows each (their
//   registers raised) compute every product by wgmma: S and dP (or S^T and
//   dP^T) with both operands K-major in shared memory, then P and dS in
//   registers, then dQ += dS K (dV += P^T dO, dK += dS^T Q) with A from
//   registers and B read MN-major from the same swizzled tiles, so no
//   operand is transposed.  dk/dv blocks hold 128 keys of one kv head and
//   keep K/V resident, streaming Q, dO, lse and delta for the group's
//   `rep` heads in turn (the group is summed in registers, deterministic);
//   dq blocks hold 128 query rows and stream K and V.  A consumer skips
//   the tiles its own 64 rows cannot see (a causal block's diagonal).
//   The producer's waits are bounded (about 4 s, then a trap) and it
//   waits at its end for the consumers to free the ring, so a wrong byte
//   or arrival count fails the launch with a CUDA error instead of
//   hanging it; the consumers' own waits are not bounded (see mbar_wait).
// - bf16/fp16 at the other head dims (16..256 in steps of 16):
//   `flash_dq_kernel`/`flash_dkv_kernel`, mma.sync m16n8k16 from ldmatrix
//   fragments, each warp owning 16 rows, operand tiles by cp.async.  Above
//   D = 128 (`DMAX` 256) a dq warp holds 16 x D accumulators (128 f32 a
//   thread at D = 256), and a dk/dv warp, which would need twice that,
//   holds 128 columns of dK and dV: the grid gives each block of keys two
//   column halves, and each recomputes S^T and dP^T over the full D (no
//   shared-memory accumulators, no spills).  The wgmma kernels' resident
//   tiles do not fit at D = 256 (Q and dO alone are 128 KB).
// - float32 inputs: plain f32 FMA out of shared memory (no TF32).
// The route is by head dim and type alone (`launch_dq`, `launch_dkv`).
// A fused single-pass backward (dq by f32 atomics) is later work.

#include "flash_ws.cuh"

namespace flash {
namespace {

size_t dq_smem_f32(int d) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const size_t ldt = d + 4, lds = BK + 4, ldo = d + 4;
  return 4 * round128(BQ * ldt * 4) + 3 * round128(BQ * lds * 4)
         + round128(BQ * ldo * 4) + 2 * round128(BQ * 4);
}

size_t dkv_smem_f32(int d) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const size_t ldt = d + 4, lds = BK + 4, ldo = d + 4;
  return 4 * round128(BQ * ldt * 4) + 4 * round128(BQ * lds * 4)
         + 2 * round128(BK * ldo * 4) + 2 * round128(BQ * 4);
}

// The 16-bit dk/dv kernel's blocks are eight warps of 16 keys: each
// Q/dO/O tile it loads, and each barrier, serves 128 keys (measured 18 %
// faster than four warps of 16 at the same occupancy).
constexpr int kDkvWarps = 8;

// 16-bit dq: Q, dO, K and V tiles; the rows' lse and delta
size_t dq_smem_mma(int d) {
  return 4 * round128(size_t(kMmaTile) * (d + 8) * 2)
         + 2 * round128(kMmaTile * 4);
}

// 16-bit dk/dv: K and V tiles of 128 keys, Q and dO tiles of 64 rows;
// the rows' lse and delta
size_t dkv_smem_mma(int d) {
  return 2 * round128(size_t(kDkvWarps * 16) * (d + 8) * 2)
         + 2 * round128(size_t(kMmaTile) * (d + 8) * 2)
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
  const float* dog =
      static_cast<const float*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
  const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq;

  load_tile<kF32Threads>(qs, ldt, qg, p.q_st.s, q0, p.sq, BQ, d);
  load_tile<kF32Threads>(dos, ldt, dog, p.do_st.s, q0, p.sq, BQ, d);
  load_row_stats<kF32Threads>(lse_s, delta_s, p.lse + row, p.delta + row, q0,
                              p.sq, BQ);
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
    const float* dog =
        static_cast<const float*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
    const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
      await_tiles();
      __syncthreads();  // the previous tile's readers are done
      load_tile<kF32Threads>(qs, ldt, qg, p.q_st.s, q0, p.sq, BQ, d);
      load_tile<kF32Threads>(dos, ldt, dog, p.do_st.s, q0, p.sq, BQ, d);
      load_row_stats<kF32Threads>(lse_s, delta_s, p.lse + row, p.delta + row,
                                  q0, p.sq, BQ);
      await_tiles();
      __syncthreads();
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
// this thread; its first nnd of N n-tiles) as T pairs at dst (row stride
// ss); rows >= rows are skipped.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* dst, long long ss,
                                           const float (*acc)[4], int r0,
                                           int rows, int nnd, int t) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
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

// DMAX (128 or 256): the largest head dim the instantiation takes; a warp
// holds DMAX / 8 n-tiles of dq accumulators (128 f32 a thread at 256).
template <typename T, typename Mask, int DMAX>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_kernel(Params p) {
  constexpr int BQ = kMmaTile, BK = kMmaTile;
  const int d = p.d, ld = d + pad<T>();
  const int nkd = d / 16, nnd = d / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(BQ * ld);
  T* dos = cv.take<T>(BQ * ld);
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
  const T* dog =
      static_cast<const T*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
  const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq;

  load_tile<kMmaThreads>(qs, ld, qg, p.q_st.s, q0, p.sq, BQ, d);
  load_tile<kMmaThreads>(dos, ld, dog, p.do_st.s, q0, p.sq, BQ, d);
  load_row_stats<kMmaThreads>(lse_s, delta_s, p.lse + row, p.delta + row, q0,
                              p.sq, BQ);
  await_tiles();
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qi0 = q0 + r0, qi1 = qi0 + 8;
  // exp(s scale - lse) = 2^(s scale log2e - lse log2e): one FMA and ex2
  const float scale2 = p.scale * kLog2e;
  const float nl0 = -lse_s[r0] * kLog2e, nl1 = -lse_s[r0 + 8] * kLog2e;
  const float dl0 = delta_s[r0], dl1 = delta_s[r0 + 8];
  float dq[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

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
    for (int kk = 0; kk < DMAX / 16; ++kk) {
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
      for (int j = 0; j < DMAX / 8; j += 2) {
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
  store_rows<T, DMAX / 8>(dqg, p.dq_st.s, dq, qi0, p.sq, nnd, t);
}

// DMAX (128 or 256): the largest head dim the instantiation takes.  A warp
// holds dK and dV for at most 128 columns (2 x 64 f32 a thread): above
// D = 128 each block computes the columns [c0, c0 + 128) of its keys'
// dK/dV only (blockIdx.z = batch x column chunks, `dkv_chunks`), and
// recomputes S^T and dP^T over the full D for each chunk.
template <typename T, typename Mask, int DMAX>
__global__ void __launch_bounds__(kDkvWarps * 32)
    flash_dkv_kernel(Params p) {
  constexpr int BQ = kMmaTile, BK = kDkvWarps * 16, NT = kDkvWarps * 32;
  const int d = p.d, ld = d + pad<T>();
  const int chunks = (d + 127) / 128, c0 = blockIdx.z % chunks * 128;
  // k-steps over D; n-tiles of this block's output columns
  const int nkd = d / 16, nnd = min(d - c0, 128) / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* ks = cv.take<T>(BK * ld);
  T* vs = cv.take<T>(BK * ld);
  T* qs = cv.take<T>(BQ * ld);
  T* dos = cv.take<T>(BQ * ld);
  float* lse_s = cv.take<float>(BQ);
  float* delta_s = cv.take<float>(BQ);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int ik = blockIdx.y;  // under causality tile 0 has the most work
  const int hk = blockIdx.x, b = blockIdx.z / chunks;
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
    const T* dog =
        static_cast<const T*>(p.dout) + b * p.do_st.b + h * p.do_st.h;
    const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq;
    for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
      await_tiles();
      __syncthreads();  // the previous tile's readers are done
      load_tile<NT>(qs, ld, qg, p.q_st.s, q0, p.sq, BQ, d);
      load_tile<NT>(dos, ld, dog, p.do_st.s, q0, p.sq, BQ, d);
      load_row_stats<NT>(lse_s, delta_s, p.lse + row, p.delta + row, q0,
                         p.sq, BQ);
      await_tiles();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
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
      // dV += P^T dO and dK += dS^T Q (this block's columns)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          if (j < nnd) {
            uint32_t bb[4];
            frag_b_kn(bb, dos, ld, kk * 16, c0 + j * 8, lane);
            mma16816<T>(dv[j], ap[kk], bb);
            mma16816<T>(dv[j + 1], ap[kk], bb + 2);
            frag_b_kn(bb, qs, ld, kk * 16, c0 + j * 8, lane);
            mma16816<T>(dk[j], ads[kk], bb);
            mma16816<T>(dk[j + 1], ads[kk], bb + 2);
          }
        }
      }
    }
  }
  T* dkg = static_cast<T*>(p.dk) + b * p.dk_st.b + hk * p.dk_st.h + c0;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_st.b + hk * p.dv_st.h + c0;
  store_rows<T, 16>(dkg, p.dk_st.s, dk, kj0, p.sk, nnd, t);
  store_rows<T, 16>(dvg, p.dv_st.s, dv, kj0, p.sk, nnd, t);
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), f32, one warp a row (16-byte loads; at D = 128
// in 16 bits half the lanes hold the row).  Bound by its bytes.
// ---------------------------------------------------------------------------

// the dot product of 16 bytes of a and b as T, in f32

__device__ __forceinline__ float dot16b(uint4 a, uint4 b, const float*) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2] + x[3] * y[3];
}
__device__ __forceinline__ float dot16b(uint4 a, uint4 b, const __half*) {
  const __half2* x = reinterpret_cast<const __half2*>(&a);
  const __half2* y = reinterpret_cast<const __half2*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __half22float2(x[i]), w = __half22float2(y[i]);
    acc += u.x * w.x + u.y * w.y;
  }
  return acc;
}
__device__ __forceinline__ float dot16b(uint4 a, uint4 b,
                                      const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc += u.x * w.x + u.y * w.y;
  }
  return acc;
}

constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
    flash_bwd_delta_kernel(Params p, long long rows) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int s = int(r % p.sq);
  const long long bh = r / p.sq;
  const int h = int(bh % p.heads), b = int(bh / p.heads);
  const T* o = static_cast<const T*>(p.o) + b * p.o_st.b + h * p.o_st.h +
               s * p.o_st.s;
  const T* dout = static_cast<const T*>(p.dout) + b * p.do_st.b +
                  h * p.do_st.h + s * p.do_st.s;
  constexpr int vec = 16 / int(sizeof(T));
  float acc = 0.f;
  for (int c = lane * vec; c < p.d; c += 32 * vec)
    acc += dot16b(*reinterpret_cast<const uint4*>(o + c),
                *reinterpret_cast<const uint4*>(dout + c),
                static_cast<const T*>(nullptr));
  acc = warp_sum(acc);
  if (lane == 0) const_cast<float*>(p.delta)[r] = acc;
}

// ---------------------------------------------------------------------------
// The warp-specialised wgmma + TMA kernels (16-bit, D = 64 or 128;
// scaffolding in flash_ws.cuh).  Warpgroup 0 is the producer (warp 0's lane 0 issues the TMA loads; in
// the dk/dv kernel warp 1 stages each query tile's lse and delta);
// warpgroups 1 and 2 are the consumers, 64 rows each.  Stage s of the ring
// is filled when full[s] completes and free again when empty[s] does (one
// arrival from every consumer thread).
// ---------------------------------------------------------------------------

// dk/dv: K and V (128 keys) resident; a stage holds Q and dO (64 rows) and
// their rows' -lse log2(e) and delta.  The carve starts 1024-aligned
// (the 1024 spare bytes pay for the alignment).
template <int D> struct DkvSmem {
  static constexpr int kBK = 128, kBQ = 64;
  static constexpr int kKV = kBK * D * 2, kQ = kBQ * D * 2;
  static constexpr int kStage = round1024(2 * kQ + 2 * kBQ * 4);
  static constexpr int kBars = 2 * kKV + kStages * kStage;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// dq: Q and dO (128 rows) resident; a stage holds K and V (64 keys).
template <int D> struct DqSmem {
  static constexpr int kBQ = 128, kBK = 64;
  static constexpr int kQ = kBQ * D * 2, kKV = kBK * D * 2;
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = 2 * kQ + kStages * kStage;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

template <typename T, int D, typename Mask>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dkv_ws_kernel(const __grid_constant__ Sm90Args a) {
  using namespace sm90;
  using L = DkvSmem<D>;
  constexpr int BK = L::kBK, BQ = L::kBQ;
  const Params& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + L::kKV;
  unsigned char* ring = smem + 2 * L::kKV;  // stage s at ring + s * kStage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BK;  // under causality tile 0 has most work
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the lse warp
      mbar_init(&empty[s], 256);    // every consumer thread
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  // the query rows that see some key of the block
  const Mask mask(p, b);
  const Range loop = mask.query_loop(k0, BK, BQ);

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int stage = 0;
    uint32_t phase = 0;
    if (warp == 0 && lane == 0) {
      mbar_arrive_tx(kv_bar, 2 * L::kKV);
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load(ks + cb * BK * 128, a.k, kv_bar, cb * 64, k0, hk, b);
        tma_load(vs + cb * BK * 128, a.v, kv_bar, cb * 64, k0, hk, b);
      }
      for (int gi = 0; gi < p.rep; ++gi) {
        const int h = hk * p.rep + gi;
        for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
          mbar_wait_or_trap(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * L::kStage;
          mbar_arrive_tx(&full[stage], 2 * L::kQ);
          for (int cb = 0; cb < D / 64; ++cb) {
            tma_load(st + cb * BQ * 128, a.q, &full[stage], cb * 64, q0, h,
                     b);
            tma_load(st + L::kQ + cb * BQ * 128, a.dout, &full[stage],
                     cb * 64, q0, h, b);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      producer_drain(kv_bar, empty, stage, phase);
    } else if (warp == 1) {
      for (int gi = 0; gi < p.rep; ++gi) {
        const int h = hk * p.rep + gi;
        const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq;
        for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
          mbar_wait(&empty[stage], phase ^ 1);
          float* nl = reinterpret_cast<float*>(ring + stage * L::kStage +
                                               2 * L::kQ);
          for (int r = lane; r < BQ; r += 32) {
            const bool ok = q0 + r < p.sq;
            nl[r] = ok ? -p.lse[row + q0 + r] * kLog2e : 0.f;
            nl[BQ + r] = ok ? p.delta[row + q0 + r] : 0.f;
          }
          mbar_arrive(&full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int kc = k0 + 64 * c;  // this warpgroup's keys [kc, kc + 64)
    const int kj0 = kc + 16 * w + g;  // this thread's keys: kj0, kj0 + 8
    const Range qr0 = mask.queries(kj0), qr1 = mask.queries(kj0 + 8);
    // the query rows that see some key of this warpgroup
    const Range own = kc < p.sk ? mask.query_loop(kc, 64, BQ) : Range{0, 0};
    const float scale2 = p.scale * kLog2e;
    const uint32_t k_tile = smem_u32(ks), v_tile = smem_u32(vs);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int gi = 0; gi < p.rep; ++gi) {
      for (int q0 = loop.lo; q0 < loop.hi; q0 += BQ) {
        mbar_wait(&full[stage], phase);
        __syncwarp();  // wgmma's .aligned: the warp converged
        if (q0 < own.hi && q0 + BQ > own.lo) {
          const unsigned char* st = ring + stage * L::kStage;
          const uint32_t q_tile = smem_u32(st), do_tile = q_tile + L::kQ;
          const float* nl = reinterpret_cast<const float*>(st + 2 * L::kQ);
          const float* dl = nl + BQ;
          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
          float s[32], dp[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
          fence_regs<32>(s);
          fence_regs<32>(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<T>(s, desc_k(k_tile, BK, 64 * c, kk),
                        desc_k(q_tile, BQ, 0, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<T>(dp, desc_k(v_tile, BK, 64 * c, kk),
                        desc_k(do_tile, BQ, 0, kk), kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs<32>(s);
          fence_regs<32>(dp);
          // P^T in s, dS^T in dp; lse and delta belong to the query column
          const bool full_tile = mask.tile_full(q0, BQ, kc, 64);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + 2 * t;
            const float2 nlj = *reinterpret_cast<const float2*>(nl + col);
            const float2 dlj = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // exp2 of every element, then a select: no branch
              const int qi = q0 + col + (e & 1);
              const bool ok = full_tile || inside(e < 2 ? qr0 : qr1, qi);
              const float ex = fast_exp2(
                  fmaf(s[4 * j + e], scale2, (e & 1) ? nlj.y : nlj.x));
              const float pr = ok ? ex : 0.f;
              dp[4 * j + e] =
                  pr * (dp[4 * j + e] - ((e & 1) ? dlj.y : dlj.x)) * p.scale;
              s[4 * j + e] = pr;
            }
          }
          uint32_t ap[4][4], ads[4][4];
          acc_to_frags<T>(ap, s);
          acc_to_frags<T>(ads, dp);
          // dV += P^T dO and dK += dS^T Q, B read MN-major
          fence_regs<16>(&ap[0][0]);
          fence_regs<16>(&ads[0][0]);
          fence_regs<D / 2>(dv);
          fence_regs<D / 2>(dk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_tb<T, D>(dv, ap[kk], desc_mn(do_tile, BQ, kk));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs_tb<T, D>(dk, ads[kk], desc_mn(q_tile, BQ, kk));
          wgmma_commit();
          wgmma_wait_all();  // the stage's Q and dO are read until here
          fence_regs<D / 2>(dv);
          fence_regs<D / 2>(dk);
        }
        mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    T* dkg = static_cast<T*>(p.dk) + b * p.dk_st.b + hk * p.dk_st.h;
    T* dvg = static_cast<T*>(p.dv) + b * p.dv_st.b + hk * p.dv_st.h;
    store_acc<T, D>(dkg, p.dk_st.s, dk, kj0, p.sk, t);
    store_acc<T, D>(dvg, p.dv_st.s, dv, kj0, p.sk, t);
  }
}

template <typename T, int D, typename Mask>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dq_ws_kernel(const __grid_constant__ Sm90Args a) {
  using namespace sm90;
  using L = DqSmem<D>;
  constexpr int BQ = L::kBQ, BK = L::kBK;
  const Params& p = a.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + L::kQ;
  unsigned char* ring = smem + 2 * L::kQ;  // stage s at ring + s * kStage
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int iq = gridDim.y - 1 - blockIdx.y;  // most key tiles first
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.rep;
  const int q0 = iq * BQ;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
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
      mbar_arrive_tx(q_bar, 2 * L::kQ);
      for (int cb = 0; cb < D / 64; ++cb) {
        tma_load(qs + cb * BQ * 128, a.q, q_bar, cb * 64, q0, h, b);
        tma_load(dos + cb * BQ * 128, a.dout, q_bar, cb * 64, q0, h, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
        mbar_wait_or_trap(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * L::kStage;
        mbar_arrive_tx(&full[stage], 2 * L::kKV);
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load(st + cb * BK * 128, a.k, &full[stage], cb * 64, k0, hk, b);
          tma_load(st + L::kKV + cb * BK * 128, a.v, &full[stage], cb * 64,
                   k0, hk, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      producer_drain(q_bar, empty, stage, phase);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int w = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int qc = q0 + 64 * c;  // this warpgroup's rows [qc, qc + 64)
    const int qi0 = qc + 16 * w + g, qi1 = qi0 + 8;  // this thread's rows
    const long long row = (static_cast<long long>(b) * p.heads + h) * p.sq;
    // exp(s scale - lse) = 2^(s scale log2e - lse log2e): one FMA and ex2
    const float scale2 = p.scale * kLog2e;
    const float nl0 = qi0 < p.sq ? -p.lse[row + qi0] * kLog2e : 0.f;
    const float nl1 = qi1 < p.sq ? -p.lse[row + qi1] * kLog2e : 0.f;
    const float dl0 = qi0 < p.sq ? p.delta[row + qi0] : 0.f;
    const float dl1 = qi1 < p.sq ? p.delta[row + qi1] : 0.f;
    // the keys each of the two rows sees, and those of this warpgroup
    const Range kr0 = mask.keys(qi0), kr1 = mask.keys(qi1);
    const Range own = qc < p.sq ? mask.key_loop(qc, 64) : Range{0, 0};
    const uint32_t q_tile = smem_u32(qs), do_tile = smem_u32(dos);
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_bar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = loop.lo; k0 < loop.hi; k0 += BK) {
      mbar_wait(&full[stage], phase);
      __syncwarp();  // wgmma's .aligned: the warp converged
      if (k0 < own.hi && k0 + BK > own.lo) {
        const uint32_t k_tile = smem_u32(ring + stage * L::kStage);
        const uint32_t v_tile = k_tile + L::kKV;
        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        fence_regs<32>(s);
        fence_regs<32>(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(s, desc_k(q_tile, BQ, 64 * c, kk),
                          desc_k(k_tile, BK, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<T>(dp, desc_k(do_tile, BQ, 64 * c, kk),
                          desc_k(v_tile, BK, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(s);
        fence_regs<32>(dp);
        // dS = P (dP - delta) scale, P = exp(S scale - lse), in place in s
        const bool full_tile = mask.tile_full(qc, 64, k0, BK);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            const bool ok = full_tile || inside(e < 2 ? kr0 : kr1, kj);
            const float ex =
                fast_exp2(fmaf(s[4 * j + e], scale2, e < 2 ? nl0 : nl1));
            const float pr = ok ? ex : 0.f;
            s[4 * j + e] =
                pr * (dp[4 * j + e] - (e < 2 ? dl0 : dl1)) * p.scale;
          }
        }
        uint32_t ads[4][4];
        acc_to_frags<T>(ads, s);
        // dQ += dS K, K read MN-major
        fence_regs<16>(&ads[0][0]);
        fence_regs<D / 2>(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_tb<T, D>(dq, ads[kk], desc_mn(k_tile, BK, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(dq);
      }
      mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    T* dqg = static_cast<T*>(p.dq) + b * p.dq_st.b + h * p.dq_st.h;
    store_acc<T, D>(dqg, p.dq_st.s, dq, qi0, p.sq, t);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const long long* strides, int heads, int kv_heads, int sq,
                   int sk, int d, int causal, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
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

template <typename K, typename A>
int launch(K kernel, const A& args, dim3 grid, int threads, size_t smem,
           cudaStream_t stream) {
  int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<grid, threads, smem, stream>>>(args);
  return int(cudaGetLastError());
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int D, typename Mask>
int launch_dq_ws(const Params& p, int batch, int dtype, cudaStream_t s) {
  using L = DqSmem<D>;
  Sm90Args a;
  a.p = p;
  const int e = make_views(a, batch, dtype, L::kBQ, L::kBK);
  if (e) return e;
  return launch(flash_dq_ws_kernel<T, D, Mask>, a,
                dim3(p.heads, ceil_div(p.sq, L::kBQ), batch), kWsThreads,
                L::kBytes, s);
}

template <typename T, int D, typename Mask>
int launch_dkv_ws(const Params& p, int batch, int dtype, cudaStream_t s) {
  using L = DkvSmem<D>;
  Sm90Args a;
  a.p = p;
  const int e = make_views(a, batch, dtype, L::kBQ, L::kBK);
  if (e) return e;
  return launch(flash_dkv_ws_kernel<T, D, Mask>, a,
                dim3(p.heads / p.rep, ceil_div(p.sk, L::kBK), batch),
                kWsThreads, L::kBytes, s);
}

// Grids are (head, tile, batch), heads fastest, so that the blocks of one
// tile start together in every head (measured faster than tiles fastest:
// 17 % in dq, 3 % in dk/dv at B=1, H=32, S=4096, causal).
template <typename Mask>
int launch_dq(const Params& p, int batch, int dtype, cudaStream_t s) {
  if (ws_route(p.d, dtype, false)) {
    if (dtype == 1)
      return p.d == 64 ? launch_dq_ws<__half, 64, Mask>(p, batch, dtype, s)
                       : launch_dq_ws<__half, 128, Mask>(p, batch, dtype, s);
    return p.d == 64
               ? launch_dq_ws<__nv_bfloat16, 64, Mask>(p, batch, dtype, s)
               : launch_dq_ws<__nv_bfloat16, 128, Mask>(p, batch, dtype, s);
  }
  const dim3 f32_grid(p.heads, ceil_div(p.sq, kF32Tile), batch);
  const dim3 grid(p.heads, ceil_div(p.sq, kMmaTile), batch);
  const bool wide = p.d > 128;
  switch (dtype) {
    case 0:
      return launch(flash_dq_f32_kernel<Mask>, p, f32_grid, kF32Threads,
                    dq_smem_f32(p.d), s);
    case 1:
      return wide ? launch(flash_dq_kernel<__half, Mask, 256>, p, grid,
                           kMmaThreads, dq_smem_mma(p.d), s)
                  : launch(flash_dq_kernel<__half, Mask, 128>, p, grid,
                           kMmaThreads, dq_smem_mma(p.d), s);
    case 2:
      return wide ? launch(flash_dq_kernel<__nv_bfloat16, Mask, 256>, p, grid,
                           kMmaThreads, dq_smem_mma(p.d), s)
                  : launch(flash_dq_kernel<__nv_bfloat16, Mask, 128>, p, grid,
                           kMmaThreads, dq_smem_mma(p.d), s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename Mask>
int launch_dkv(const Params& p, int batch, int dtype, cudaStream_t s) {
  if (ws_route(p.d, dtype, false)) {
    if (dtype == 1)
      return p.d == 64 ? launch_dkv_ws<__half, 64, Mask>(p, batch, dtype, s)
                       : launch_dkv_ws<__half, 128, Mask>(p, batch, dtype, s);
    return p.d == 64
               ? launch_dkv_ws<__nv_bfloat16, 64, Mask>(p, batch, dtype, s)
               : launch_dkv_ws<__nv_bfloat16, 128, Mask>(p, batch, dtype, s);
  }
  const int kv_heads = p.heads / p.rep;
  const dim3 f32_grid(kv_heads, ceil_div(p.sk, kF32Tile), batch);
  // the mma.sync kernel's blocks: one for each chunk of 128 columns
  const dim3 grid(kv_heads, ceil_div(p.sk, kDkvWarps * 16),
                  batch * ceil_div(p.d, 128));
  const bool wide = p.d > 128;
  switch (dtype) {
    case 0:
      return launch(flash_dkv_f32_kernel<Mask>, p, f32_grid, kF32Threads,
                    dkv_smem_f32(p.d), s);
    case 1:
      return wide ? launch(flash_dkv_kernel<__half, Mask, 256>, p, grid,
                           kDkvWarps * 32, dkv_smem_mma(p.d), s)
                  : launch(flash_dkv_kernel<__half, Mask, 128>, p, grid,
                           kDkvWarps * 32, dkv_smem_mma(p.d), s);
    case 2:
      return wide ? launch(flash_dkv_kernel<__nv_bfloat16, Mask, 256>, p,
                           grid, kDkvWarps * 32, dkv_smem_mma(p.d), s)
                  : launch(flash_dkv_kernel<__nv_bfloat16, Mask, 128>, p,
                           grid, kDkvWarps * 32, dkv_smem_mma(p.d), s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

size_t ws_smem(int d, bool dq) {
  if (d == 64) return dq ? DqSmem<64>::kBytes : DkvSmem<64>::kBytes;
  return dq ? DqSmem<128>::kBytes : DkvSmem<128>::kBytes;
}

}  // namespace
}  // namespace flash

extern "C" {

// Shared-memory bytes one block of each kernel needs; dtype 0 float32,
// 1 float16, 2 bfloat16.
size_t flash_dq_smem_bytes(int d, int dtype) {
  using namespace flash;
  if (ws_route(d, dtype, false)) return ws_smem(d, true);
  return dtype == 0 ? dq_smem_f32(d) : dq_smem_mma(d);
}

size_t flash_dkv_smem_bytes(int d, int dtype) {
  using namespace flash;
  if (ws_route(d, dtype, false)) return ws_smem(d, false);
  return dtype == 0 ? dkv_smem_f32(d) : dkv_smem_mma(d);
}

const char* flash_bwd_error_string(int code) {
  return flash::ws_error_string(code);
}

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched), or a tensor-map error (flash_bwd_error_string).  strides: 24
// int64 as in flash::set_strides.

// delta (B, H, Sq) f32 contiguous = rowsum(dout * o) of (B, H, Sq, D) o
// and dout (strides: o's and do's slots).
int flash_bwd_delta(const void* o, const void* dout, float* delta,
                    const long long* strides, int batch, int heads, int sq,
                    int d, int dtype, void* stream) {
  using namespace flash;
  const long long rows = static_cast<long long>(batch) * heads * sq;
  if (rows == 0) return 0;
  Params p{};
  p.o = o;
  p.dout = dout;
  p.delta = delta;
  set_strides(p, strides);
  p.heads = heads;
  p.sq = sq;
  p.d = d;
  const dim3 grid(unsigned((rows * 32 + kDeltaThreads - 1) / kDeltaThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      flash_bwd_delta_kernel<float><<<grid, kDeltaThreads, 0, s>>>(p, rows);
      break;
    case 1:
      flash_bwd_delta_kernel<__half><<<grid, kDeltaThreads, 0, s>>>(p, rows);
      break;
    case 2:
      flash_bwd_delta_kernel<__nv_bfloat16>
          <<<grid, kDeltaThreads, 0, s>>>(p, rows);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// Dense: q, dout, dq (B, H, Sq, D); k, v, dk, dv (B, Hkv, Sk, D); lse and
// delta (B, H, Sq) f32 contiguous.
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dq,
             const long long* strides, int batch, int heads, int kv_heads,
             int sq, int sk, int d, int causal, float scale, int dtype,
             void* stream) {
  using namespace flash;
  if (batch == 0 || sq == 0) return 0;
  Params p = make_params(q, k, v, dout, lse, delta, strides, heads, kv_heads,
                         sq, sk, d, causal, scale);
  p.dq = dq;
  return launch_dq<DenseMask>(p, batch, dtype,
                              static_cast<cudaStream_t>(stream));
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dk, void* dv,
              const long long* strides, int batch, int heads, int kv_heads,
              int sq, int sk, int d, int causal, float scale, int dtype,
              void* stream) {
  using namespace flash;
  if (batch == 0 || sk == 0) return 0;
  Params p = make_params(q, k, v, dout, lse, delta, strides, heads, kv_heads,
                         sq, sk, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return launch_dkv<DenseMask>(p, batch, dtype,
                               static_cast<cudaStream_t>(stream));
}

// Packed sequences (batch 1, sq == sk == T): (H, T, D) and (Hkv, T, D)
// views with batch stride 0, lse and delta (H, T) f32 contiguous, span
// (2, T) int32: the start and end of each token's segment.
int varlen_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq,
              const int* span, const long long* strides, int batch,
              int heads, int kv_heads, int sq, int sk, int d, int causal,
              float scale, int dtype, void* stream) {
  using namespace flash;
  if (batch != 1 || sq != sk) return int(cudaErrorInvalidValue);
  if (sq == 0) return 0;
  Params p = make_params(q, k, v, dout, lse, delta, strides, heads, kv_heads,
                         sq, sk, d, causal, scale);
  p.dq = dq;
  p.span = span;
  return launch_dq<SegmentMask>(p, 1, dtype,
                                static_cast<cudaStream_t>(stream));
}

int varlen_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               const int* span, const long long* strides, int batch,
               int heads, int kv_heads, int sq, int sk, int d, int causal,
               float scale, int dtype, void* stream) {
  using namespace flash;
  if (batch != 1 || sq != sk) return int(cudaErrorInvalidValue);
  if (sk == 0) return 0;
  Params p = make_params(q, k, v, dout, lse, delta, strides, heads, kv_heads,
                         sq, sk, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  p.span = span;
  return launch_dkv<SegmentMask>(p, 1, dtype,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
