// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// for Hopper (sm_90a): dense, packed-sequence (varlen) and ragged-length
// attention, which differ only in their mask policy (below).
//
// Two families of kernels share these helpers:
// - bf16/fp16 inputs (the training path): register-resident tiles on the
//   tensor cores through `mma.sync.m16n8k16` (16-bit operands, f32
//   accumulation).  Each warp owns 16 rows of its block's tile; scores,
//   probabilities and accumulators live in the warp's registers, in the
//   documented fragment layouts of the PTX ISA, and probabilities pass
//   from the score accumulators to the next product's operand without
//   leaving registers.  Only the operand tiles (Q, K, V, dO) are staged in
//   shared memory.  The forward at head_dim 64, 128 and 256 and the
//   backward at 64 and 128 have kernels of their own on wgmma and TMA
//   (flash_ws.cuh, flash_sm90.cuh).
// - float32 inputs: the same algorithm with plain f32 FMA out of shared
//   memory (`block_mm_f32`), for exact agreement with the plain version
//   (no TF32).
// Scores and accumulators stay in f32; probabilities and dS are rounded to
// the input type only as operands of the next product, as the TPU kernels
// do.  No library kernel runs inside: the products are the kernels' own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kBigNeg = -1e30f;  // finite: masked scores, never -inf

// float32 kernels: eight warps, 32-row tiles (their f32 tiles must fit one
// block's shared memory).  16-bit kernels: warps of 16 rows, 64-row tiles
// (the forward and dk/dv kernels put eight warps on 128 rows).
constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;
constexpr int kMmaThreads = 128;
constexpr int kMmaTile = 64;

// Shared-memory rows are padded by 16 bytes: rows stay 16-byte aligned for
// the tile loads, and the eight rows a warp's fragment load touches start
// in different banks.
template <typename T> __host__ __device__ constexpr int pad() {
  return 16 / int(sizeof(T));
}

__host__ __device__ inline size_t round128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Carves 128-byte-aligned regions off the dynamic shared memory, in order.
struct Carver {
  unsigned char* p;
  template <typename U> __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += round128(n * sizeof(U));
    return r;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Strides (in elements) of one (B, H, S, D) operand; D is contiguous.
struct Strides {
  long long b, h, s;
};

// Start staging rows [row0, row0 + R) of a (S, D) slice (row stride `ss`)
// into dst (row stride `ld`): one asynchronous 16-byte copy a thread and
// chunk (cp.async), all in flight together; rows at or past `rows` are
// zero-filled.  The wrapper guarantees 16-byte alignment of every row.
// Call `await_tiles()` and then __syncthreads() before reading dst.
template <int NT, typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long ss,
                          int row0, int rows, int R, int d) {
  constexpr int vec = 16 / int(sizeof(T));
  const int per_row = d / vec;
  for (int i = threadIdx.x; i < R * per_row; i += NT) {
    const int r = i / per_row, c = (i % per_row) * vec;
    const bool ok = row0 + r < rows;
    const T* from = ok ? src + (row0 + r) * ss + c : src;
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(from), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's outstanding load_tile copies.
__device__ __forceinline__ void await_tiles() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// C (M x N, f32, row stride ldc) = [C +] A (M x K) * B (K x N), all three
// f32 in shared memory, computed by the whole block of kF32Threads.  A is
// stored row-major (ld lda) or, with TA, transposed as a K x M array; B is
// stored row-major K x N or, with TB, transposed as an N x K array.  Each
// thread owns the same output elements in every call with the same M, N.
template <bool TA, bool TB, bool ACC>
__device__ void block_mm_f32(float* C, int ldc, const float* A, int lda,
                             const float* B, int ldb, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += kF32Threads) {
    const int m = idx / N, n = idx % N;
    float s = ACC ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 (16-bit operands, f32 accumulators) and its fragments.
// In a warp, lane = 4 * g + t.  A (16 x 16, row-major) is 4 registers of
// two elements: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..).
// B (16 x 8, "col") is 2 registers: (k = 2t..2t+1, n = g), (k = 2t+8..,
// n = g).  C (16 x 8, f32) is 4 floats: (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).  The lower 16 bits of a register hold the lower index.
// ---------------------------------------------------------------------------

template <typename T> struct Pair;
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type make(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};

// two f32 values rounded to T, packed lo | hi << 16
template <typename T>
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  typename Pair<T>::type v = Pair<T>::make(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* c,
                                                        const uint32_t* a,
                                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* c, const uint32_t* a,
                                                 const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: four 8 x 8 16-bit matrices, lane l giving the address of row
// l % 8 of matrix l / 8; register i of lane 4g + t then holds row g,
// columns 2t..2t+1 of matrix i (of its transpose with .trans).  Rows are
// 16-byte aligned (the padded tiles' rows are).
template <typename T>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const T* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename T>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const T* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragment of rows [m0, m0+16) x cols [k0, k0+16) of a row-major tile X
// (row stride ld) in shared memory.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t* a, const T* X, int ld,
                                       int m0, int k0, int lane) {
  const int mi = lane >> 3;
  const int row = m0 + (lane & 7) + 8 * (mi & 1);
  ldmatrix_x4(a, X + row * ld + k0 + 8 * (mi >> 1));
}

// B fragments (k0.., n-tiles n0 and n0 + 8) of B = Y^T, Y row-major with n
// as its row (Y[n][k], e.g. K in Q K^T): b[0..1] for n0, b[2..3] for
// n0 + 8.
template <typename T>
__device__ __forceinline__ void frag_b_nk(uint32_t* b, const T* Y, int ld,
                                          int n0, int k0, int lane) {
  const int mi = lane >> 3;
  const int row = n0 + (lane & 7) + 8 * (mi >> 1);
  ldmatrix_x4(b, Y + row * ld + k0 + 8 * (mi & 1));
}

// B fragments (k0.., n-tiles n0 and n0 + 8) of B = Z, Z row-major with k
// as its row (Z[k][n], e.g. V in P V): b[0..1] for n0, b[2..3] for n0 + 8.
template <typename T>
__device__ __forceinline__ void frag_b_kn(uint32_t* b, const T* Z, int ld,
                                          int k0, int n0, int lane) {
  const int mi = lane >> 3;
  const int row = k0 + (lane & 7) + 8 * (mi & 1);
  ldmatrix_x4_trans(b, Z + row * ld + n0 + 8 * (mi >> 1));
}

// The A fragment of k-step kk of a 16-bit copy of score accumulators
// s[n-tile][4] (the 16 x 16 block of n-tiles 2kk, 2kk+1): no data moves
// between lanes.
template <typename T>
__device__ __forceinline__ void frag_a_from_acc(uint32_t* a,
                                                const float (*s)[4], int kk) {
  a[0] = pack_f32<T>(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_f32<T>(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_f32<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_f32<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x (MUFU.EX2; relative error about 2^-22, far below the 16-bit
// operands' rounding).  The 16-bit kernels keep scores in log2 units, so
// exp(scale * s - m) is one FMA and one ex2.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// lse and delta (f32, from the forward and the backward's pre-pass) of
// query rows [q0, q0 + R) into shared memory; rows past sq get 0.
template <int NT>
__device__ void load_row_stats(float* lse_s, float* delta_s,
                               const float* lse_g, const float* delta_g,
                               int q0, int sq, int R) {
  for (int r = threadIdx.x; r < R; r += NT) {
    const bool ok = q0 + r < sq;
    lse_s[r] = ok ? lse_g[q0 + r] : 0.f;
    delta_s[r] = ok ? delta_g[q0 + r] : 0.f;
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K> int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

// Parameters of all the kernels.  Pointers a kernel does not use are
// null, and so are their strides.
struct Params {
  const void *q, *k, *v, *o, *dout;
  float* lse;  // written by the forward (if not null), read by the backward
  const float* delta;  // the backward's rowsum(dO * O), (B, H, Sq) f32
  void *out, *dq, *dk, *dv;
  const int* span;     // SegmentMask: (2, T) start and end of i's segment
  const int* kv_lens;  // LengthMask: (B,) key count of each sequence
  Strides q_st, k_st, v_st, o_st, do_st, dq_st, dk_st, dv_st;
  int heads, rep, sq, sk, d, causal;
  float scale;
};

// ---------------------------------------------------------------------------
// Mask policies (a template parameter of every kernel).  In each pattern
// the kernels take, query row i sees one contiguous range of keys, and key
// j is seen by one contiguous range of query rows, so a policy answers
// five questions from a row or a tile, never from a table of pairs:
//   keys(i)              the keys [lo, hi) query row i sees;
//   queries(j)           the query rows that see key j (dk/dv kernels);
//   key_loop(q0, n)      the keys a query tile [q0, q0 + n) must visit;
//   query_loop(k0, n, bq) the query rows a key tile [k0, k0 + n) must
//                        visit (the loop steps bq rows from lo);
//   tile_full(q0, nq, k0, nk)  does every query of [q0, q0 + nq) see every
//                        key of [k0, k0 + nk)?  Such tiles skip the
//                        per-element mask (the answer is the same for the
//                        whole block: measured 4 % faster in the dk/dv
//                        kernel than a test per thread).
// A range with lo >= hi is empty; rows and keys past the end have none.
// The loops are bounds, not masks: a tile they visit is still masked
// element by element.
// ---------------------------------------------------------------------------

struct Range {
  int lo, hi;
};

__device__ __forceinline__ bool inside(Range r, int j) {
  return r.lo <= j && j < r.hi;
}

// Dense (B, H, S, D) attention: every key, or keys j <= i when causal
// (causal needs Sq == Sk).
struct DenseMask {
  int sq, sk, causal;
  __device__ DenseMask(const Params& p, int)
      : sq(p.sq), sk(p.sk), causal(p.causal) {}
  __device__ Range keys(int qi) const {
    return {0, qi < sq ? (causal ? min(qi + 1, sk) : sk) : 0};
  }
  __device__ Range queries(int kj) const {
    return {causal ? kj : 0, kj < sk ? sq : 0};
  }
  __device__ Range key_loop(int q0, int n) const {
    return {0, causal ? min(sk, q0 + n) : sk};
  }
  // query tiles stay aligned to multiples of bq
  __device__ Range query_loop(int k0, int, int bq) const {
    return {causal ? (k0 / bq) * bq : 0, sq};
  }
  __device__ bool tile_full(int q0, int nq, int k0, int nk) const {
    return q0 + nq <= sq && k0 + nk <= sk && (!causal || k0 + nk - 1 <= q0);
  }
};

// Packed sequences (T tokens, Sq == Sk == T): token i belongs to the
// segment [span[i], span[T + i]); a query sees the keys of its own segment,
// only those at or before it when causal.  The key loop of a query tile
// runs from its first row's segment start to its last row's segment end
// (or the diagonal), so a tile never visits another document's keys; the
// TPU kernel's grid visits every key block and masks it.
struct SegmentMask {
  const int *lo_, *hi_;
  int t, causal;
  __device__ SegmentMask(const Params& p, int)
      : lo_(p.span), hi_(p.span + p.sq), t(p.sq), causal(p.causal) {}
  __device__ Range keys(int qi) const {
    if (qi >= t) return {0, 0};
    return {lo_[qi], causal ? qi + 1 : hi_[qi]};
  }
  __device__ Range queries(int kj) const {
    if (kj >= t) return {0, 0};
    return {causal ? kj : lo_[kj], hi_[kj]};
  }
  __device__ Range key_loop(int q0, int n) const {
    const int last = min(q0 + n, t) - 1;
    return {lo_[q0], causal ? last + 1 : hi_[last]};
  }
  __device__ Range query_loop(int k0, int n, int) const {
    const int last = min(k0 + n, t) - 1;
    return {causal ? k0 : lo_[k0], hi_[last]};
  }
  // one segment holds every row and key of the tile (segment starts do
  // not decrease, so the first and the last position's suffice)
  __device__ bool tile_full(int q0, int nq, int k0, int nk) const {
    if (q0 + nq > t || k0 + nk > t || (causal && k0 + nk - 1 > q0))
      return false;
    return lo_[min(q0, k0)] == lo_[max(q0 + nq, k0 + nk) - 1];
  }
};

// Ragged lengths (forward only): sequence b's queries see keys
// [0, kv_lens[b]), only those at or before the query when causal (Sq ==
// Sk).  As in the TPU kernel, rows at or past the length still see those
// keys; only a length of 0 leaves rows with none (output 0).  Key tiles
// at or past the length are not visited.
struct LengthMask {
  int sq, len, causal;
  // the length from lane 0: the compiler then knows it is the same in
  // every lane (a per-lane load left ptxas serialising the wgmma kernel)
  __device__ LengthMask(const Params& p, int b)
      : sq(p.sq),
        len(__shfl_sync(0xffffffffu, min(max(p.kv_lens[b], 0), p.sk), 0)),
        causal(p.causal) {}
  __device__ Range keys(int qi) const {
    return {0, qi < sq ? (causal ? min(qi + 1, len) : len) : 0};
  }
  __device__ Range key_loop(int q0, int n) const {
    return {0, causal ? min(len, q0 + n) : len};
  }
  __device__ bool tile_full(int q0, int nq, int k0, int nk) const {
    return q0 + nq <= sq && k0 + nk <= len && (!causal || k0 + nk - 1 <= q0);
  }
};

// strides: 24 int64, (b, h, s) of q, k, v, o, do, dq, dk, dv in that order
// (o is the forward's output).
inline void set_strides(Params& p, const long long* st) {
  Strides* dst[8] = {&p.q_st, &p.k_st, &p.v_st, &p.o_st,
                     &p.do_st, &p.dq_st, &p.dk_st, &p.dv_st};
  for (int i = 0; i < 8; ++i)
    *dst[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

}  // namespace flash
