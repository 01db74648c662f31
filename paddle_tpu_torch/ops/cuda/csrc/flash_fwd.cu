// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/attention.py, one
// entry point each, one kernel templated on the mask policy
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
// the design is the same.)  So the 16-bit kernel keeps everything but
// the operand tiles in registers: one block of eight warps per (128-row
// query tile, head, batch) loops over 64-key tiles (the TPU's sequential
// `ik` grid axis becomes this loop) over the key range its mask policy
// gives (the tiles up to the diagonal, of the tile's own documents, or
// below the length), where the TPU grid visits every key block and masks
// it.  Each warp holds its 16 rows' scores (16 x 64), running max and sum,
// and output accumulator (16 x D) in registers; the scores become the PV
// product's operand in place (mma.sync m16n8k16, bf16/fp16 in, f32 out),
// so only Q, K and V pass through shared memory.  Blocks of one query
// tile start together across the heads, the dense causal pattern's
// longest first (`launch`).  K/V tiles arrive by cp.async, all of a
// tile's copies in flight at once.  Probabilities are 2^(scores in log2
// units - max): one FMA and one MUFU.EX2 each; tiles wholly inside the
// pattern skip the mask.
// float32 inputs take a kernel of plain f32 FMA out of shared memory (no
// TF32), for exact agreement with the plain version.  Double-buffered K/V
// tiles measured slower (fewer warps an SM); wgmma, TMA and warp
// specialisation are later work.

#include "flash_common.cuh"

namespace flash {
namespace {

size_t fwd_smem_f32(int d) {
  constexpr int BQ = kF32Tile, BK = kF32Tile;
  const size_t ldt = d + 4, lds = BK + 4, ldo = d + 4;
  return 3 * round128(BQ * ldt * 4) + 2 * round128(BQ * lds * 4)
         + round128(BQ * ldo * 4) + 2 * round128(BQ * 4);
}

// The 16-bit kernel's blocks are eight warps of 16 query rows: each K/V
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

template <typename T, typename Mask>
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
  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
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
    for (int kk = 0; kk < 8; ++kk) {
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
    for (int j = 0; j < 16; ++j) {
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
      for (int j = 0; j < 16; j += 2) {
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
  for (int j = 0; j < 16; ++j) {
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

// The grid is (head, query tile, batch), heads fastest, so that the blocks
// of one query tile start together in every head, and the kernels take the
// tiles in reverse (the dense causal pattern's longest first): measured
// 23 % faster than query tiles fastest at B=1, H=32, S=4096, causal.
template <typename K>
int launch(K kernel, const Params& p, int tile, int threads, size_t smem,
           int batch, cudaStream_t stream) {
  int e = allow_smem(kernel, smem);
  if (e) return e;
  kernel<<<dim3(p.heads, (p.sq + tile - 1) / tile, batch), threads, smem,
           stream>>>(p);
  return int(cudaGetLastError());
}

template <typename Mask>
int launch_fwd(const Params& p, int batch, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch(flash_fwd_f32_kernel<Mask>, p, kF32Tile, kF32Threads,
                    fwd_smem_f32(p.d), batch, s);
    case 1:
      return launch(flash_fwd_kernel<__half, Mask>, p, kFwdWarps * 16,
                    kFwdWarps * 32, fwd_smem_mma(p.d), batch, s);
    case 2:
      return launch(flash_fwd_kernel<__nv_bfloat16, Mask>, p, kFwdWarps * 16,
                    kFwdWarps * 32, fwd_smem_mma(p.d), batch, s);
    default:
      return int(cudaErrorInvalidValue);
  }
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
  return dtype == 0 ? fwd_smem_f32(d) : fwd_smem_mma(d);
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point returns cudaGetLastError() after its launch (0 =
// launched).  strides: 24 int64 as in flash::set_strides (q, k, v and o
// are read).

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
