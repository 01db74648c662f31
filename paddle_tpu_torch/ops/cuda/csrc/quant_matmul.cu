// Weight-only quantized matmul, int8 and int4 codes, for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/quant_matmul.py
// `_qmm_kernel_i8` and `_qmm_kernel_i4`, reached through
// `_quant_matmul_fwd`.
//
// What it computes:  out[m, n] = sum_{k < K} x[m, k] * (code[k, n] * s[k / group, n])
// with x (M, K) in float32, float16 or bfloat16, codes int8 (Kp, N) or
// nibble-packed int4 (Kp/2, N) (byte [j, n] holds code 2j in its low
// nibble and 2j+1 in its high one, sign (v ^ 8) - 8), f32 scales
// (Kp/group, N), and out (M, N) in x's type.  The zero rows that pad K up
// to a group multiple meet zeros of x (or are never read).  The weight is
// read in quantize_weight's layout as it lies in device memory: no
// repacked copy is kept.
//
// Two routes, chosen from the input alone (qmm_route in the wrapper states
// the same rule):
//
// * Tensor cores, for float16 and bfloat16 x with group % 16 == 0 (the
//   quantized serve's bf16 x with group 128).  The result is the
//   reference's up to f32 rounding: a code is an integer of at most 8
//   significant bits (|c| <= 128), so it is exact in bf16 and fp16; x is
//   already 16-bit; so each product x * c (at most 8 + 11 significant
//   bits) is exact in f32, and the 16-bit tensor cores (mma.sync, wgmma)
//   with f32 accumulators compute each group's P_g = sum_{k in g} x_k c_k
//   exactly up to the order of its f32 sums.  The kernel folds out += s_g * P_g at each group's end, where the
//   reference computes sum_k x_k (c_k s_g): the two differ by f32 rounding
//   only (about 3e-7 relative L2 at K = 4096).  No code is multiplied by
//   its scale before the product: c * s rounded to 16 bits would move
//   every weight by up to 2^-9.  The int8 tensor cores (s8 x s8 -> s32)
//   are not used: they would need x quantized to int8 too (W8A8), another
//   result than the reference's.
//   The codes are widened in registers, exactly, two a 32-bit word: a byte
//   permute gathers two codes of one column (consecutive k, as the operand
//   pairs them) into the low bytes of the two halves; int8 to bf16 is
//   (0x4300 | (b & 0x7f)) - (0x4300 | (b & 0x80)) = (128 + low 7 bits) -
//   (128 or 256); int8 to fp16 is (0x6400 | (b ^ 0x80)) - 1152; an int4
//   nibble v is (magic | (v ^ 8)) - (128 + 8) in bf16 or - (1024 + 8) in
//   fp16: one permute, one lop3 and one packed subtraction for two codes.
//   The weight is the A operand (16 output columns x 16 k a warp), x's
//   rows the B operand.  A block's producer warp fills a ring of stages of
//   64 k rows in shared memory, each guarded by a full and an empty
//   mbarrier: 2-D TMA boxes of the codes (128 columns) and of x (64 k),
//   128-byte swizzled, where a code row is a multiple of 16 bytes and so is
//   an x row (plain loads into the same layout otherwise, e.g. N = 77).
//   Each group's products are summed in their own f32 accumulators and
//   folded into the output's with the group's per-column scales at the
//   group's end.  K is split at group boundaries across blocks until the
//   card is full; the splits write f32 partials to a workspace, and the
//   last block of an output tile to take its ticket (an atomic after
//   __threadfence) adds them in split order, writes the output and resets
//   its counter: one launch a call, bitwise equal from run to run.
//   - Decode (M <= kTcSkinnyMaxM, qmm_tc_kernel): bound by the bytes of
//     the codes (each is used by at most 32 rows).  mma.sync m16n8k16:
//     four consumer warps of 32 columns and all of x's rows (1, 2 or 4
//     row tiles of 8, read by ldmatrix).
//   - Prefill (M > kTcSkinnyMaxM, qmm_wg_kernel): bound by the 2*M*K*N
//     products.  Warp-specialised wgmma: two consumer warpgroups of 64
//     columns widen the codes into wgmma's register A fragment and issue
//     m64n128k16 with x's 128-row tile as B from shared memory.  Where TMA
//     cannot read the operands or a group is not a multiple of a stage
//     (kWgK), qmm_tc_kernel at 64-row tiles takes the product.
// * FMA, for float32 x and any other group: f32 multiply-adds (the codes
//   widened exactly by a byte permute into the mantissa of 2^23, times
//   their scale in f32, as the reference's f32 dot_general).  Rounding f32
//   x to 16 bits for the tensor cores would change the result.
//   - skinny (M <= 32).  A block owns 128 output columns and a slice of at
//     most 1024 K rows; each lane reads 4 adjacent columns of a row in one
//     4-byte load, eight loads in flight a lane; the eight warps take
//     contiguous parts of the slice and sum in shared memory at the end.
//     x's slice is staged once in shared memory as f32.
//   - tiled (M > 32).  A register-tiled product: a block computes a 128 x
//     128 output tile, eight by eight a thread, from 16-deep x and weight
//     tiles double-buffered in shared memory; the weight tile is
//     dequantized to f32 on its way into shared memory.
//   Both split K across blocks when the grid would leave SMs idle: each
//   split writes f32 partial sums and a second kernel adds them in order.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>
#include <atomic>

#include "flash_sm90.cuh"  // mbarriers, TMA, wgmma descriptors (flash::sm90)

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Code j (0..3) of four int8 codes in a word, exactly, as f32.
__device__ __forceinline__ float i8_code(uint32_t biased, int j) {
  // biased = word ^ 0x80808080: byte j is code + 128; put it in the low
  // mantissa byte of 2^23 (0x4B000000) and subtract 2^23 + 128
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}

// The nibble at bit `shift` of a word of eight int4 codes, exactly, as f32.
__device__ __forceinline__ float i4_code(uint32_t biased, int shift) {
  // biased = word ^ 0x88888888: each nibble is code + 8
  return __uint_as_float(0x4B000000u | ((biased >> shift) & 0xFu)) -
         8388616.f;
}

// Four code bytes of one row at columns [col, col + 4); zero past n.
__device__ __forceinline__ uint32_t load_codes4(const int8_t* row, int col,
                                                int n, bool vec) {
  if (vec) {
    return col < n ? __ldg(reinterpret_cast<const uint32_t*>(row + col)) : 0u;
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < n) w |= uint32_t(uint8_t(__ldg(row + col + j))) << (8 * j);
  return w;
}

__device__ __forceinline__ void load_scales4(const float* row, int col, int n,
                                             bool vec, float* s) {
  if (vec) {
    float4 v = col < n ? __ldg(reinterpret_cast<const float4*>(row + col))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = col + j < n ? __ldg(row + col + j) : 0.f;
  }
}

// ---------------------------------------------------------------- skinny

constexpr int kSkThreads = 256;
constexpr int kSkWarps = kSkThreads / 32;
constexpr int kSkCols = 128;      // 32 lanes x 4 columns
constexpr int kSkMaxRows = 1024;  // K rows a split; kSkWarps * kSkCols
constexpr int kSkUnroll = 8;      // code loads in flight a lane
constexpr int kSkMaxM = 32;

template <typename T, int BITS, int MR>
__global__ void __launch_bounds__(kSkThreads)
    qmm_skinny_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                      const float* __restrict__ scales, T* __restrict__ out,
                      float* __restrict__ partial, int m, int k, int n,
                      int group, int ks, bool vec) {
  // x's slice [kb0, kb1) x MR rows as f32 (xs[kk * MR + r]); afterwards the
  // warps' partial sums red[(warp * MR + r) * kSkCols + c]
  __shared__ __align__(16) float smem[MR * kSkMaxRows];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = blockIdx.x * kSkCols + lane * 4;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MR;
  const int kb0 = split * ks;
  const int kb1 = min(k, kb0 + ks);
  const int len = max(0, kb1 - kb0);

  for (int i = tid; i < len * MR; i += kSkThreads) {
    const int r = i / len;
    const int kk = i - r * len;
    smem[kk * MR + r] =
        m0 + r < m ? to_f32(x[size_t(m0 + r) * k + kb0 + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  // this warp's rows: an even-sized contiguous part of the slice (even, so
  // an int4 byte's two rows are never split between warps)
  const int per = ((len + kSkWarps - 1) / kSkWarps + 1) & ~1;
  const int w0 = kb0 + warp * per;
  const int w1 = min(kb1, w0 + per);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int next_group_row = w0;  // the first row needing a scale reload

  auto fma_row = [&](int row, const float* w) {
    const float* xr = smem + (row - kb0) * MR;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const float xv = xr[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
    }
  };
  auto scales_for = [&](int row) {
    if (row >= next_group_row) {  // warp-uniform
      const int g = row / group;
      next_group_row = (g + 1) * group;
      load_scales4(scales + size_t(g) * n, col, n, vec, s);
    }
  };

  if constexpr (BITS == 8) {
    for (int r0 = w0; r0 < w1; r0 += kSkUnroll) {
      uint32_t c[kSkUnroll];
#pragma unroll
      for (int u = 0; u < kSkUnroll; ++u)
        c[u] = r0 + u < w1 ? load_codes4(qw + size_t(r0 + u) * n, col, n, vec)
                           : 0u;
#pragma unroll
      for (int u = 0; u < kSkUnroll; ++u) {
        const int row = r0 + u;
        if (row < w1) {
          scales_for(row);
          const uint32_t b = c[u] ^ 0x80808080u;
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = i8_code(b, j) * s[j];
          fma_row(row, w);
        }
      }
    }
  } else {
    constexpr int kPairs = kSkUnroll / 2;
    for (int r0 = w0; r0 < w1; r0 += 2 * kPairs) {
      uint32_t c[kPairs];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const int row = r0 + 2 * u;
        c[u] = row < w1 ? load_codes4(qw + size_t(row >> 1) * n, col, n, vec)
                        : 0u;
      }
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        const uint32_t b = c[u] ^ 0x88888888u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 2 * u + h;
          if (row < w1) {
            scales_for(row);
            float w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) w[j] = i4_code(b, 8 * j + 4 * h) * s[j];
            fma_row(row, w);
          }
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the x slice
  float* red = smem;
#pragma unroll
  for (int r = 0; r < MR; ++r)
    *reinterpret_cast<float4*>(red + (warp * MR + r) * kSkCols + lane * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = tid; i < MR * kSkCols; i += kSkThreads) {
    const int r = i / kSkCols;
    const int c = i - r * kSkCols;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kSkWarps; ++w) sum += red[(w * MR + r) * kSkCols + c];
    const int row = m0 + r;
    const int oc = blockIdx.x * kSkCols + c;
    if (row < m && oc < n) {
      if (partial != nullptr)
        partial[(size_t(split) * m + row) * n + oc] = sum;
      else
        out[size_t(row) * n + oc] = from_f32<T>(sum);
    }
  }
}

// ----------------------------------------------------------------- tiled

constexpr int kTM = 128;
constexpr int kTN = 128;
constexpr int kTK = 16;
constexpr int kTThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int kAPad = 4;        // As row padding: 2-way store conflicts

template <typename T, int BITS>
struct TileLoads {
  float a[8];       // x values of this thread's 8 A-tile slots
  uint32_t c[2];    // raw codes: 8 int8 of one row, or 4 bytes of int4
  float s[8];       // their scales
};

template <typename T, int BITS>
__device__ __forceinline__ void load_tiles(TileLoads<T, BITS>& t,
                                           const T* __restrict__ x,
                                           const int8_t* __restrict__ qw,
                                           const float* __restrict__ scales,
                                           int m, int k, int n, int group,
                                           int bm, int bn, int kt, int kend,
                                           bool vec) {
  const int tid = threadIdx.x;
  // A: element e = tid + 256 i -> row e / 16, column kt + e % 16
  const int ak = kt + (tid & 15);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bm + (tid >> 4) + 16 * i;
    t.a[i] = (row < m && ak < kend) ? to_f32(x[size_t(row) * k + ak]) : 0.f;
  }
  if constexpr (BITS == 8) {
    // 16 rows x 128 columns: row kt + tid / 16, columns (tid % 16) * 8 + [0, 8)
    const int row = kt + (tid >> 4);
    const int col = bn + (tid & 15) * 8;
    t.c[0] = t.c[1] = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) t.s[j] = 0.f;
    if (row < kend) {
      const int8_t* qr = qw + size_t(row) * n;
      const float* sr = scales + size_t(row / group) * n;
      t.c[0] = load_codes4(qr, col, n, vec);
      t.c[1] = load_codes4(qr, col + 4, n, vec);
      load_scales4(sr, col, n, vec, t.s);
      load_scales4(sr, col + 4, n, vec, t.s + 4);
    }
  } else {
    // 8 byte rows (16 code rows) x 128 columns: byte row kt/2 + tid / 32,
    // columns (tid % 32) * 4 + [0, 4); scales of both of its code rows
    const int row = kt + 2 * (tid >> 5);
    const int col = bn + (tid & 31) * 4;
    t.c[0] = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) t.s[j] = 0.f;
    if (row < kend) {
      t.c[0] = load_codes4(qw + size_t(row >> 1) * n, col, n, vec);
      load_scales4(scales + size_t(row / group) * n, col, n, vec, t.s);
      if (row + 1 < kend)
        load_scales4(scales + size_t((row + 1) / group) * n, col, n, vec,
                     t.s + 4);
    }
  }
}

template <typename T, int BITS>
__device__ __forceinline__ void store_tiles(const TileLoads<T, BITS>& t,
                                            float (*As)[kTM + kAPad],
                                            float (*Bs)[kTN]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) As[tid & 15][(tid >> 4) + 16 * i] = t.a[i];
  if constexpr (BITS == 8) {
    const int kk = tid >> 4;
    const int c = (tid & 15) * 8;
    float w[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t b = t.c[h] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[4 * h + j] = i8_code(b, j) * t.s[4 * h + j];
    }
    *reinterpret_cast<float4*>(&Bs[kk][c]) = make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(&Bs[kk][c + 4]) =
        make_float4(w[4], w[5], w[6], w[7]);
  } else {
    const int kk = 2 * (tid >> 5);
    const int c = (tid & 31) * 4;
    const uint32_t b = t.c[0] ^ 0x88888888u;
    float w[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = i4_code(b, 8 * j) * t.s[j];              // code row kk
      w[4 + j] = i4_code(b, 8 * j + 4) * t.s[4 + j];  // code row kk + 1
    }
    *reinterpret_cast<float4*>(&Bs[kk][c]) = make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(&Bs[kk + 1][c]) =
        make_float4(w[4], w[5], w[6], w[7]);
  }
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kTThreads, 2)
    qmm_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                     const float* __restrict__ scales, T* __restrict__ out,
                     float* __restrict__ partial, int m, int k, int n,
                     int group, int ks, bool vec) {
  __shared__ __align__(16) float As[2][kTK][kTM + kAPad];
  __shared__ __align__(16) float Bs[2][kTK][kTN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bn = blockIdx.x * kTN;
  const int bm = blockIdx.y * kTM;
  const int split = blockIdx.z;
  const int kb0 = split * ks;
  const int kb1 = min(k, kb0 + ks);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (kb0 < kb1) {
    TileLoads<T, BITS> t;
    load_tiles(t, x, qw, scales, m, k, n, group, bm, bn, kb0, kb1, vec);
    store_tiles(t, As[0], Bs[0]);
    __syncthreads();
    int cur = 0;
    for (int kt = kb0; kt < kb1; kt += kTK) {
      const bool more = kt + kTK < kb1;
      if (more)
        load_tiles(t, x, qw, scales, m, k, n, group, bm, bn, kt + kTK, kb1,
                   vec);
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) store_tiles(t, As[cur ^ 1], Bs[cur ^ 1]);
      __syncthreads();
      cur ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = bn + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col >= n) continue;
      if (partial != nullptr)
        partial[(size_t(split) * m + row) * n + col] = acc[i][j];
      else
        out[size_t(row) * n + col] = from_f32<T>(acc[i][j]);
    }
  }
}


// --------------------------------------------------------- tensor cores

constexpr int kTcKStage = 64;      // k rows a ring stage (4 mma k-steps)
constexpr int kTcStages = 3;       // ring depth
constexpr int kTcSkinnyMaxM = 32;  // M up to this takes the decode shape
constexpr int kTcMaxSplits = 16;   // K splits a product at most
constexpr int kTcBlockRows = 128;  // a block's fixed cost, in K rows
constexpr int kTcDecodeWarps = 4;  // decode: 32 columns a warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Loads from shared memory by address (the ring's base is aligned at run
// time, so the compiler cannot tell that pointers into it are shared; a
// generic load there costs a global load's latency).
__device__ __forceinline__ uint32_t lds_u16(const void* p) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(smem_addr(p)));
  return v;
}
__device__ __forceinline__ float4 lds_f32x4(const void* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_addr(p)));
  return v;
}

// Byte `c` of row `r` of a tile of 128-byte rows stored with the 128-byte
// swizzle (TMA's, on a 1024-byte-aligned tile): 16-byte chunk c / 16 of
// row r lies at chunk (c / 16) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// Packed 16-bit subtraction a - b of two halves, in T's format.
template <typename T> __device__ __forceinline__ uint32_t sub2(uint32_t a,
                                                               uint32_t b);
template <>
__device__ __forceinline__ uint32_t sub2<__nv_bfloat16>(uint32_t a,
                                                        uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <>
__device__ __forceinline__ uint32_t sub2<__half>(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The int8 codes in bytes 0 and 2 of u as two T values (low half: byte 0).
template <typename T> __device__ __forceinline__ uint32_t i8_pair(uint32_t u);
template <>
__device__ __forceinline__ uint32_t i8_pair<__nv_bfloat16>(uint32_t u) {
  // (128 + low 7 bits) - (128, or 256 where the sign bit is set)
  return sub2<__nv_bfloat16>((u & 0x007f007fu) | 0x43004300u,
                             (u & 0x00800080u) | 0x43004300u);
}
template <> __device__ __forceinline__ uint32_t i8_pair<__half>(uint32_t u) {
  // 1024 + (code + 128), less 1152
  return sub2<__half>((u & 0x00ff00ffu) ^ 0x64806480u, 0x64806480u);
}

// The int4 nibbles in bits 0-3 of bytes 0 and 2 of v as two T values.
template <typename T> __device__ __forceinline__ uint32_t i4_pair(uint32_t v);
template <>
__device__ __forceinline__ uint32_t i4_pair<__nv_bfloat16>(uint32_t v) {
  // 128 + (v ^ 8), less 136
  return sub2<__nv_bfloat16>((v & 0x000f000fu) ^ 0x43084308u, 0x43084308u);
}
template <> __device__ __forceinline__ uint32_t i4_pair<__half>(uint32_t v) {
  // 1024 + (v ^ 8), less 1032
  return sub2<__half>((v & 0x000f000fu) ^ 0x64086408u, 0x64086408u);
}

// d += a * b, mma.sync m16n8k16 with f32 accumulators.  In a warp, lane =
// 4 g + t.  A (16 x 16): (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8,
// 2t+8..); B (16 x 8): (k = 2t..2t+1, n = g), (k = 2t+8.., n = g); D: (g,
// 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  Low halves hold lower k.
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float* d,
                                                        const uint32_t* a,
                                                        const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float* d, const uint32_t* a,
                                                 const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix of 8 x 8 16-bit matrices: lane l gives row l % 8 of matrix
// l / 8; register i of lane 4g + t gets row g, columns 2t..2t+1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row))
               : "memory");
}

// One TMA box of a 2-D tensor map at (column c0, row c1) into dst; its
// bytes count on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The tensor map of a row-major (rows, cols) array of elem_bytes elements,
// boxes of box_cols x box_rows; 0 or an error code.
int encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
              int elem_bytes, int cols, int rows, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  flash::sm90::EncodeTiled fn = flash::sm90::encode_tiled();
  if (fn == nullptr) return flash::sm90::kNoEncoder;
  cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : flash::sm90::kEncodeError + int(r);
}

// A block of WN x WM consumer warps and one producer warp; a consumer warp
// owns two tiles of 16 output columns (mma's A rows) and NT tiles of 8 x
// rows (mma's n).  Thread 4g + t of a warp owns the 4 adjacent columns c0 +
// 4g + [0, 4): A row g of column tile j is column 2j, row g + 8 column
// 2j + 1.  A stage holds the codes' 64 k rows (int4: 32 byte rows) x kBN
// columns (boxes of 128) and x's kBM rows x 64 k, each in 128-byte rows
// with the 128-byte swizzle, so that a warp's reads of rows 2t (int8) and
// the ldmatrix rows fall in distinct banks, and the scales of the groups
// that end in the stage, so that a consumer's fold reads no device memory.
template <int BITS, int NT, int WN, int WM>
struct TcShape {
  static constexpr int kConsumers = 32 * WN * WM;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kBN = 32 * WN;      // output columns a block
  static constexpr int kBM = 8 * NT * WM;  // x rows a block
  static_assert(kBN % 128 == 0, "codes come in boxes of 128 columns");
  static constexpr int kCodeRows = BITS == 8 ? kTcKStage : kTcKStage / 2;
  static constexpr int kBox = kCodeRows * 128;  // one box of 128 columns
  static constexpr int kCode = kBox * (kBN / 128);
  static constexpr int kX = kBM * 128;
  // f32 scales of the groups that end in the stage (at most one a k-step):
  // rows k0 / group .. + 3 of the scale matrix, the block's columns
  static constexpr int kScaleRows = kTcKStage / 16;
  static constexpr int kScale = kScaleRows * kBN * 4;
  static constexpr int kStage = kCode + kX + kScale;  // 1024-byte multiples
  static constexpr int kBars = kTcStages * kStage;
  static constexpr int kSmem = kBars + 2 * kTcStages * 8 + 1024;
};

struct TcArgs {
  CUtensorMap x_map;      // (K, M) 16-bit, boxes of 64 x kBM
  CUtensorMap code_map;   // (N, code rows) bytes, boxes of 128 x 64 (32)
  CUtensorMap scale_map;  // (N, groups) f32, boxes of 128 x kScaleRows
  const uint16_t* x;
  const int8_t* qw;
  const float* scales;
  void* out;
  float* partial;  // splits x M x N f32 (splits > 1)
  int* counters;   // one a (row block, column tile); 0 between launches
  int m, k, n, kp, group, ks;  // ks: K rows a split, a multiple of group
  bool tma;  // TMA boxes (else the producer warp's plain loads)
};

// The A fragments of this thread's two column tiles for k-step s of the
// stage's code tile cs (columns cb .. cb + 3 its own), widened exactly.
template <typename T, int BITS>
__device__ __forceinline__ void code_frags(const uint8_t* cs, int s, int cb,
                                           int t, uint32_t (&a)[2][4]) {
  auto word = [&](int r) { return lds_u32(cs + swz(r, cb)); };
  if constexpr (BITS == 8) {
    // rows 2t, 2t+1 (a0..a3) and 2t+8, 2t+9 (a4..a7)
    const int r0 = 16 * s + 2 * t;
    const uint32_t w0 = word(r0), w1 = word(r0 + 1);
    const uint32_t w8 = word(r0 + 8), w9 = word(r0 + 9);
#pragma unroll
    for (int b = 0; b < 4; ++b) {  // column b: tile b / 2, half b % 2
      const uint32_t sel = b | ((4 + b) << 8);
      a[b >> 1][b & 1] = i8_pair<T>(__byte_perm(w0, w1, sel));
      a[b >> 1][2 + (b & 1)] = i8_pair<T>(__byte_perm(w8, w9, sel));
    }
  } else {
    // byte rows t (k 2t, 2t+1: a0..a3) and t + 4 (k 2t+8, 2t+9: a4..a7)
    const int r0 = 8 * s + t;
    const uint32_t w0 = word(r0), w4 = word(r0 + 4);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // byte b's low nibble into byte 0, its high nibble into byte 2
      const uint32_t sel = b | ((4 + b) << 8);
      a[b >> 1][b & 1] = i4_pair<T>(__byte_perm(w0, w0 >> 4, sel));
      a[b >> 1][2 + (b & 1)] = i4_pair<T>(__byte_perm(w4, w4 >> 4, sel));
    }
  }
}

// The split merge of the last block of an output tile to finish: the
// tile's f32 partials of every split added in split order, in float4 chunks
// spread over THREADS threads, each thread's loads of kBatch splits issued
// together (a few round trips to L2 however many splits), and written to
// out in T.
template <typename T, int BM, int BN, int THREADS>
__device__ __forceinline__ void merge_tile(const float* partial, T* out,
                                           int m, int n, int m0, int n0,
                                           int tid) {
  constexpr int kChunks = BM * BN / 4 / THREADS;
  constexpr int kBatch = kChunks >= 8 ? 1 : 8 / kChunks;
  static_assert(BM * BN % (4 * THREADS) == 0, "merge chunks");
  const int nsplit = int(gridDim.z);
  const size_t mn = size_t(m) * n;
  float4 sum[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) sum[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp0 = 0; sp0 < nsplit; sp0 += kBatch) {
    float4 v[kChunks][kBatch];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = (tid + c * THREADS) * 4;
      const int row = m0 + e / BN, col = n0 + e % BN;
      const float* p = partial + size_t(row) * n + col;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[c][u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (sp0 + u >= nsplit || row >= m) continue;
        const float* q = p + size_t(sp0 + u) * mn;
        if (n % 4 == 0 && col + 4 <= n) {
          v[c][u] = __ldcg(reinterpret_cast<const float4*>(q));
        } else {
          if (col < n) v[c][u].x = __ldcg(q);
          if (col + 1 < n) v[c][u].y = __ldcg(q + 1);
          if (col + 2 < n) v[c][u].z = __ldcg(q + 2);
          if (col + 3 < n) v[c][u].w = __ldcg(q + 3);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // in split order
        sum[c].x += v[c][u].x;
        sum[c].y += v[c][u].y;
        sum[c].z += v[c][u].z;
        sum[c].w += v[c][u].w;
      }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int e = (tid + c * THREADS) * 4;
    const int row = m0 + e / BN, col = n0 + e % BN;
    if (row >= m) continue;
    const float f[4] = {sum[c].x, sum[c].y, sum[c].z, sum[c].w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < n) out[size_t(row) * n + col + q] = from_f32<T>(f[q]);
  }
}

// The last split of an output tile to finish merges (after its partial
// writes): a ticket taken after __threadfence by the block's `threads`
// consumer threads (named barrier 1); returns whether this block merges.
__device__ __forceinline__ bool take_ticket(int* counter, int tid,
                                            int threads, int* last) {
  __threadfence();
  flash::sm90::named_bar_sync(1, threads);
  if (tid == 0) *last = atomicAdd(counter, 1) == int(gridDim.z) - 1;
  flash::sm90::named_bar_sync(1, threads);
  if (*last) __threadfence();
  return *last;
}

template <typename T, int BITS, int NT, int WN, int WM>
__global__ void __launch_bounds__(32 * WN * WM + 32)
    qmm_tc_kernel(const __grid_constant__ TcArgs a) {
  using namespace flash::sm90;
  using L = TcShape<BITS, NT, WN, WM>;
  constexpr int S = kTcStages;
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tc_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  __shared__ int last_split;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * L::kBM;
  const int n0 = blockIdx.y * L::kBN;
  const int kb0 = blockIdx.z * a.ks;
  const int kb1 = min(a.kp, kb0 + a.ks);
  const int nstages = (kb1 - kb0 + kTcKStage - 1) / kTcKStage;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], a.tma ? 1 : 32);
      mbar_init(&empty[i], L::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == WN * WM) {
    // the producer: stage st holds k rows [kb0 + 64 st, + 64) of the split
    int stage = 0;
    uint32_t phase = 0;
    for (int st = 0; st < nstages; ++st) {
      mbar_wait_or_trap(&empty[stage], phase ^ 1);
      unsigned char* buf = smem + stage * L::kStage;
      const int k0 = kb0 + st * kTcKStage;
      const int crow0 = BITS == 8 ? k0 : k0 / 2;
      if (a.tma) {
        if (lane == 0) {
          mbar_arrive_tx(&full[stage], L::kStage);
          for (int bx = 0; bx < L::kBN / 128; ++bx) {
            tma_load_2d(buf + bx * L::kBox, &a.code_map, &full[stage],
                        n0 + 128 * bx, crow0);
            tma_load_2d(buf + L::kCode + L::kX + bx * 512 * L::kScaleRows,
                        &a.scale_map, &full[stage], n0 + 128 * bx,
                        k0 / a.group);
          }
          tma_load_2d(buf + L::kCode, &a.x_map, &full[stage], k0, m0);
        }
      } else {
        const int rows = min(kTcKStage, kb1 - k0);
        const int crows = BITS == 8 ? rows : rows / 2;
        for (int i = lane; i < crows * L::kBN; i += 32) {
          const int r = i / L::kBN, c = i % L::kBN;
          buf[(c >> 7) * L::kBox + swz(r, c & 127)] = n0 + c < a.n
              ? uint8_t(__ldg(a.qw + size_t(crow0 + r) * a.n + n0 + c))
              : uint8_t(0);
        }
        for (int i = lane; i < L::kBM * kTcKStage; i += 32) {
          const int r = i >> 6, kc = i & 63;
          const int row = m0 + r, col = k0 + kc;
          *reinterpret_cast<uint16_t*>(buf + L::kCode + swz(r, 2 * kc)) =
              row < a.m && col < a.k ? __ldg(a.x + size_t(row) * a.k + col)
                                     : uint16_t(0);
        }
        float* sb = reinterpret_cast<float*>(buf + L::kCode + L::kX);
        for (int i = lane; i < L::kScaleRows * L::kBN; i += 32) {
          // box bx of 128 columns x kScaleRows rows, as the TMA boxes lie
          const int bx = i / (128 * L::kScaleRows);
          const int r = i / 128 % L::kScaleRows, c = 128 * bx + i % 128;
          const int gr = k0 / a.group + r;
          sb[i] = gr < a.kp / a.group && n0 + c < a.n
                      ? __ldg(a.scales + size_t(gr) * a.n + n0 + c)
                      : 0.f;
        }
        mbar_arrive(&full[stage]);
      }
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the watchdog's last waits: the consumers free every stage
    for (int i = 0; i < S; ++i) {
      mbar_wait_or_trap(&empty[stage], phase ^ 1);
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  float acc[NT][2][4], grp[NT][2][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = grp[i][j][e] = 0.f;

  // this thread's columns: the first in its box, and in the output
  const int cb = (wn & 3) * 32 + 4 * g;
  const int col_t = n0 + wn * 32 + 4 * g;
  // the group's sums into the output, times the group's scales (row r of
  // the stage's scale rows ss)
  auto fold = [&](const float* ss, int r) {
    const float4 v =
        lds_f32x4(ss + (wn >> 2) * 128 * L::kScaleRows + r * 128 + cb);
    const float sc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = fmaf(grp[i][j][e], sc[2 * j + (e >> 1)],
                              acc[i][j][e]);
          grp[i][j][e] = 0.f;
        }
  };
  const int steps_a_group = a.group / 16;
  int left = steps_a_group;  // k-steps left in the current group
  int gi = kb0 / a.group;    // the current group

  const int xrow = wm * 8 * NT + (lane & 7);  // ldmatrix row of this lane
  const int xhalf = (lane >> 3) & 1;         // its k half (16-byte chunk)
  int stage = 0;
  uint32_t phase = 0;
  for (int st = 0; st < nstages; ++st) {
    mbar_wait(&full[stage], phase);
    const uint8_t* xs = smem + stage * L::kStage + L::kCode;
    const uint8_t* cs = smem + stage * L::kStage + (wn >> 2) * L::kBox;
    const float* ss =
        reinterpret_cast<const float*>(xs + L::kX);  // from group g_first
    const int g_first = (kb0 + st * kTcKStage) / a.group;
    const int steps = min(kTcKStage, kb1 - kb0 - st * kTcKStage) / 16;
#pragma unroll
    for (int s = 0; s < kTcKStage / 16; ++s) {
      if (s < steps) {
        uint32_t b[NT][2];
#pragma unroll
        for (int i = 0; i + 1 < NT; i += 2) {
          // matrices: (tile i, k 0-7), (i, 8-15), (i + 1, 0-7), (i + 1, 8-15)
          const int r = xrow + 8 * i + 8 * (lane >> 4);
          uint32_t q[4];
          ldmatrix_x4(q, xs + swz(r, 32 * s + 16 * xhalf));
          b[i][0] = q[0];
          b[i][1] = q[1];
          b[i + 1][0] = q[2];
          b[i + 1][1] = q[3];
        }
        if constexpr (NT % 2) {
          ldmatrix_x2(b[NT - 1],
                      xs + swz(xrow + 8 * (NT - 1), 32 * s + 16 * xhalf));
        }
        uint32_t af[2][4];
        code_frags<T, BITS>(cs, s, cb, t, af);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < NT; ++i) mma16816<T>(grp[i][j], af[j], b[i]);
        if (--left == 0) {  // the group ends in this k-step
          fold(ss, gi - g_first);
          ++gi;
          left = steps_a_group;
        }
      }
    }
    mbar_arrive(&empty[stage]);
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  // this thread's outputs: x rows m0 + wm 8 NT + 8 i + 2t + r, columns
  // col_t + 2j + h (4 adjacent), in acc[i][j][2h + r]
  T* out = static_cast<T*>(a.out);
  const int row_t = m0 + wm * 8 * NT + 2 * t;
  const bool vec_cols = a.n % 4 == 0 && col_t + 4 <= a.n;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_t + 8 * i + r;
        if (row >= a.m) continue;
        T* o = out + size_t(row) * a.n + col_t;
        if (vec_cols) {
          uint32_t v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const T lo = from_f32<T>(acc[i][j][r]);
            const T hi = from_f32<T>(acc[i][j][2 + r]);
            v[j] = uint32_t(*reinterpret_cast<const uint16_t*>(&lo)) |
                   uint32_t(*reinterpret_cast<const uint16_t*>(&hi)) << 16;
          }
          *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col_t + e < a.n)
              o[e] = from_f32<T>(acc[i][e >> 1][2 * (e & 1) + r]);
        }
      }
    return;
  }
  // f32 partials of this split; the last split of this output tile to
  // finish adds all splits in split order, writes the output and resets
  // the counter
  float* part = a.partial + blockIdx.z * size_t(a.m) * a.n;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_t + 8 * i + r;
      if (row >= a.m) continue;
      float* p = part + size_t(row) * a.n + col_t;
      if (vec_cols) {
        *reinterpret_cast<float4*>(p) = make_float4(
            acc[i][0][r], acc[i][0][2 + r], acc[i][1][r], acc[i][1][2 + r]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col_t + e < a.n) p[e] = acc[i][e >> 1][2 * (e & 1) + r];
      }
    }
  int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (!take_ticket(counter, tid, L::kConsumers, &last_split)) return;
  merge_tile<T, L::kBM, L::kBN, L::kConsumers>(a.partial, out, a.m, a.n, m0,
                                               n0, tid);
  if (tid == 0) *counter = 0;
}

int tc_decode_nt(int m) { return m <= 8 ? 1 : m <= 16 ? 2 : 4; }

// The kernel, its block's threads, rows and columns, and shared memory,
// for (m, bits, x type); its shared-memory limit raised on the current
// device.
struct TcKernel {
  const void* fn;
  int threads, bm, bn, smem;
};

constexpr int kMaxDevices = 64;

// Raises fn's dynamic shared-memory limit to smem on the current device,
// once a device: cudaFuncSetAttribute holds only for the device that is
// current when it runs.  raised is fn's own table, one entry a device (0
// not yet, 1 raised, -1 refused).
bool raise_smem(std::atomic<int>* raised, const void* fn, int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return false;
  int state = raised[dev].load(std::memory_order_acquire);
  if (state == 0) {
    state = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem) == cudaSuccess ? 1 : -1;
    raised[dev].store(state, std::memory_order_release);
  }
  return state > 0;
}

template <typename T, int BITS, int NT, int WN, int WM>
TcKernel tc_kernel_of() {
  using L = TcShape<BITS, NT, WN, WM>;
  const void* fn =
      reinterpret_cast<const void*>(&qmm_tc_kernel<T, BITS, NT, WN, WM>);
  static std::atomic<int> raised[kMaxDevices];
  return {raise_smem(raised, fn, L::kSmem) ? fn : nullptr, L::kThreads,
          L::kBM, L::kBN, L::kSmem};
}

// decode: kTcDecodeWarps warps of 32 columns x all rows (1, 2 or 4 row
// tiles); prefill (where the wgmma kernel cannot read the operands): eight
// warps, 32 columns x 32 rows each
template <typename T, int BITS>
TcKernel tc_kernel_for(int m) {
  constexpr int W = kTcDecodeWarps;
  if (m > kTcSkinnyMaxM) return tc_kernel_of<T, BITS, 4, 4, 2>();
  switch (tc_decode_nt(m)) {
    case 1: return tc_kernel_of<T, BITS, 1, W, 1>();
    case 2: return tc_kernel_of<T, BITS, 2, W, 1>();
    default: return tc_kernel_of<T, BITS, 4, W, 1>();
  }
}

TcKernel tc_pick(int m, int bits, int dtype) {
  switch (dtype * 2 + (bits == 4)) {
    case 2: return tc_kernel_for<__half, 8>(m);
    case 3: return tc_kernel_for<__half, 4>(m);
    case 4: return tc_kernel_for<__nv_bfloat16, 8>(m);
    case 5: return tc_kernel_for<__nv_bfloat16, 4>(m);
    default: return {nullptr, 0, 0, 0, 0};
  }
}

// The route rule (the wrapper's qmm_route states the same).
bool tensor_core_route(int dtype, int group) {
  return (dtype == 1 || dtype == 2) && group % 16 == 0;
}

// The kernel of a product: qmm_plan chooses it, qmm launches it.
enum QmmKernel : int { kFmaKernel = 0, kMmaKernel = 1, kWgmmaKernel = 2 };

// ---------------------------------------------------------------- splits

template <typename T>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int splits, size_t mn) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < mn;
       i += size_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[size_t(p) * mn + i];
    out[i] = from_f32<T>(s);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

int skinny_rows(int m) { return m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8; }

template <typename T, int BITS>
const void* skinny_fn(int mr) {
  switch (mr) {
    case 1: return reinterpret_cast<const void*>(&qmm_skinny_kernel<T, BITS, 1>);
    case 2: return reinterpret_cast<const void*>(&qmm_skinny_kernel<T, BITS, 2>);
    case 4: return reinterpret_cast<const void*>(&qmm_skinny_kernel<T, BITS, 4>);
    default: return reinterpret_cast<const void*>(&qmm_skinny_kernel<T, BITS, 8>);
  }
}

template <typename T, int BITS>
const void* kernel_fn(int m) {
  if (m <= kSkMaxM) return skinny_fn<T, BITS>(skinny_rows(m));
  return reinterpret_cast<const void*>(&qmm_tiled_kernel<T, BITS>);
}

const void* pick_kernel(int m, int bits, int dtype) {
  switch (dtype * 2 + (bits == 4)) {
    case 0: return kernel_fn<float, 8>(m);
    case 1: return kernel_fn<float, 4>(m);
    case 2: return kernel_fn<__half, 8>(m);
    case 3: return kernel_fn<__half, 4>(m);
    case 4: return kernel_fn<__nv_bfloat16, 8>(m);
    case 5: return kernel_fn<__nv_bfloat16, 4>(m);
    default: return nullptr;
  }
}

template <typename T, int BITS>
int launch(const void* x, const void* qw, const void* scales, void* out,
           void* scratch, int m, int k, int n, int group, int splits, int ks,
           cudaStream_t stream) {
  const bool vec = (n % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(qw) % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(scales) % 16 == 0);
  float* partial = splits > 1 ? static_cast<float*>(scratch) : nullptr;
  const T* xt = static_cast<const T*>(x);
  const int8_t* q = static_cast<const int8_t*>(qw);
  const float* s = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  if (m <= kSkMaxM) {
    const int mr = skinny_rows(m);
    dim3 grid(ceil_div(n, kSkCols), splits, ceil_div(m, mr));
    switch (mr) {
      case 1:
        qmm_skinny_kernel<T, BITS, 1><<<grid, kSkThreads, 0, stream>>>(
            xt, q, s, o, partial, m, k, n, group, ks, vec);
        break;
      case 2:
        qmm_skinny_kernel<T, BITS, 2><<<grid, kSkThreads, 0, stream>>>(
            xt, q, s, o, partial, m, k, n, group, ks, vec);
        break;
      case 4:
        qmm_skinny_kernel<T, BITS, 4><<<grid, kSkThreads, 0, stream>>>(
            xt, q, s, o, partial, m, k, n, group, ks, vec);
        break;
      default:
        qmm_skinny_kernel<T, BITS, 8><<<grid, kSkThreads, 0, stream>>>(
            xt, q, s, o, partial, m, k, n, group, ks, vec);
    }
  } else {
    dim3 grid(ceil_div(n, kTN), ceil_div(m, kTM), splits);
    qmm_tiled_kernel<T, BITS><<<grid, kTThreads, 0, stream>>>(
        xt, q, s, o, partial, m, k, n, group, ks, vec);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || partial == nullptr) return int(e);
  const size_t mn = size_t(m) * n;
  const int blocks = int(std::min<size_t>((mn + 255) / 256, 1 << 16));
  qmm_reduce_kernel<T><<<blocks, 256, 0, stream>>>(partial, o, splits, mn);
  return int(cudaGetLastError());
}

// K padded to a group multiple: the rows the tensor-core kernels contract.
int padded_k(int k, int group) { return ceil_div(k, group) * group; }

// ------------------------------------------- tensor cores, prefill: wgmma

// The prefill kernel where TMA can read both operands (group % kWgK == 0,
// K a multiple of 8, N of 16, 16-byte aligned bases): warpgroup 0 is the
// producer (one thread issues the TMA boxes of each stage into a ring
// guarded by full and empty mbarriers), warpgroups 1 and 2 the consumers,
// 64 output columns each.  A stage holds x's 128 rows x kWgK k (boxes of
// 64 k in 128-byte rows, 128-byte swizzle) and the codes' kWgK k rows x
// 128 columns (int8; kWgK / 2 byte rows for int4), 128-byte swizzle so
// that the lanes' reads of rows 2t (t) fall in distinct banks.  Each consumer warp widens its 16
// columns x 16 k to wgmma's register A fragment (the mma.sync layout of
// rows 16 w .. 16 w + 15) and issues m64n128k16 with x's tile as B,
// K-major from shared memory, into the group's f32 accumulators; a stage's
// four products are one commit group, waited for before the stage is
// freed (the other warpgroup's products run under this one's widening).
// At a group's end the accumulators are folded into the output with the
// group's scales, as in qmm_tc_kernel.
constexpr int kWgStages = 4;
constexpr int kWgK = 128;   // k rows a stage (a multiple of 64)
constexpr int kWgBM = 128;  // x rows a block (wgmma's N)
constexpr int kWgBN = 128;  // output columns a block (two warpgroups)
constexpr int kWgThreads = 384;
constexpr int kWgProducerRegs = 24, kWgConsumerRegs = 240;
static_assert(kWgProducerRegs * 128 + kWgConsumerRegs * 256 <= 65536,
              "registers");

template <int BITS>
struct WgSmem {
  // x: kWgK / 64 boxes of 128 rows x 64 k of 2 bytes
  static constexpr int kX = kWgK / 64 * kWgBM * 128;
  static constexpr int kCodeRows = BITS == 8 ? kWgK : kWgK / 2;
  static constexpr int kCode = kCodeRows * 128;
  static constexpr int kStage = kX + kCode;  // both 1024-byte multiples
  static constexpr int kBars = kWgStages * kStage;
  static constexpr int kSmem = kBars + 2 * kWgStages * 8 + 1024;
};

struct WgArgs {
  CUtensorMap x_map;     // (K, M) 16-bit, boxes of 64 x 128
  CUtensorMap code_map;  // (N, code rows) bytes, boxes of 128 x kCodeRows
  const float* scales;
  void* out;
  float* partial;
  int* counters;
  int m, k, n, kp, group, ks;
};

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) = [d +] A B: A (64 x 16) from registers (mma.sync's A
// fragment, rows 16 w .. of warp w), B (16 x 128) K-major in shared memory
// (descriptor b); scale_d 0 overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_rs128(float* d, const uint32_t* a,
                                            uint64_t b, int scale_d);
#define QMM_WGMMA_RS128(TYPE, PTX)                                            \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_rs128<TYPE>(                          \
      float* d, const uint32_t* a, uint64_t b, int scale_d) {                 \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "        \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                 \
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"                         \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)); \
  }
QMM_WGMMA_RS128(__nv_bfloat16, "bf16")
QMM_WGMMA_RS128(__half, "f16")
#undef QMM_WGMMA_RS128


// The A fragment of k-step kk of a stage for this thread (mma.sync's
// layout: rows g, g + 8 of its warp's 16, k 2t.., 2t + 8..): its warp's 16
// columns start at byte wc of the swizzled code tile (a multiple of 16);
// A row g is column wc + 2g, row g + 8 column wc + 2g + 1.
template <typename T, int BITS>
__device__ __forceinline__ void wg_code_frag(const uint8_t* code, int wc,
                                             int kk, int g, int t,
                                             uint32_t* a) {
  // byte (r, c) of a 128-byte-swizzled tile: 16-byte chunk c / 16 of row r
  // lies at chunk (c / 16) ^ (r % 8)
  auto pair_at = [&](int r) {
    return lds_u16(code + r * 128 + ((((wc >> 4) ^ r) & 7) << 4) + 2 * g);
  };
  if constexpr (BITS == 8) {
    const int r0 = 16 * kk + 2 * t;
    const uint32_t w0 = pair_at(r0), w1 = pair_at(r0 + 1);
    const uint32_t w8 = pair_at(r0 + 8), w9 = pair_at(r0 + 9);
    a[0] = i8_pair<T>(__byte_perm(w0, w1, 0x0400));
    a[1] = i8_pair<T>(__byte_perm(w0, w1, 0x0501));
    a[2] = i8_pair<T>(__byte_perm(w8, w9, 0x0400));
    a[3] = i8_pair<T>(__byte_perm(w8, w9, 0x0501));
  } else {
    const int r0 = 8 * kk + t;
    const uint32_t w0 = pair_at(r0), w4 = pair_at(r0 + 4);
    a[0] = i4_pair<T>(__byte_perm(w0, w0 >> 4, 0x0400));
    a[1] = i4_pair<T>(__byte_perm(w0, w0 >> 4, 0x0501));
    a[2] = i4_pair<T>(__byte_perm(w4, w4 >> 4, 0x0400));
    a[3] = i4_pair<T>(__byte_perm(w4, w4 >> 4, 0x0501));
  }
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kWgThreads, 1)
    qmm_wg_kernel(const __grid_constant__ WgArgs a) {
  using namespace flash::sm90;
  using L = WgSmem<BITS>;
  constexpr int S = kWgStages;
  extern __shared__ unsigned char wg_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + S;
  __shared__ int last_split;
  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int kb0 = blockIdx.z * a.ks;
  const int kb1 = min(a.kp, kb0 + a.ks);
  const int nstages = (kb1 - kb0) / kWgK;  // group % kWgK == 0
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int st = 0; st < nstages; ++st) {
        mbar_wait_or_trap(&empty[stage], phase ^ 1);
        unsigned char* buf = smem + stage * L::kStage;
        const int k0 = kb0 + st * kWgK;
        mbar_arrive_tx(&full[stage], L::kStage);
        for (int cb = 0; cb < kWgK / 64; ++cb)
          tma_load_2d(buf + cb * kWgBM * 128, &a.x_map, &full[stage],
                      k0 + 64 * cb, m0);
        tma_load_2d(buf + L::kX, &a.code_map, &full[stage], n0,
                    BITS == 8 ? k0 : k0 / 2);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the watchdog's last waits: the consumers free every stage
      for (int i = 0; i < S; ++i) {
        mbar_wait_or_trap(&empty[stage], phase ^ 1);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kWgConsumerRegs>();
  const int tid = threadIdx.x - 128;  // 0..255
  const int c = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wc = c * 64 + w * 16;   // this warp's columns in the tile
  const int col0 = n0 + wc + 2 * g;  // this thread's two columns
  float acc[64], grp[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = grp[i] = 0.f;
  float sc0 = 0.f, sc1 = 0.f;
  auto load_scales = [&](int gi) {
    if (col0 < a.n) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(
          a.scales + size_t(gi) * a.n + col0));
      sc0 = v.x;
      sc1 = v.y;
    }
  };
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = fmaf(grp[i], (i & 2) ? sc1 : sc0, acc[i]);
  };
  const int stages_a_group = a.group / kWgK;
  int left = stages_a_group, gi = kb0 / a.group;
  load_scales(gi);
  bool first = true;  // the next product starts its group's sums
  int stage = 0;
  uint32_t phase = 0;

  // one stage: its four products issued as one group and waited for
  // before the stage is freed and the next stage's codes are widened into
  // the same A registers (with a product still in flight across the
  // widening, ptxas serialised every product: C7513, about 10 % slower)
  auto run_stage = [&]() {
    if (left == 0) {  // the previous group ended: fold it
      fold();
      load_scales(++gi);
      left = stages_a_group;
      first = true;
    }
    mbar_wait(&full[stage], phase);
    const unsigned char* buf = smem + stage * L::kStage;
    const uint32_t x_tile = smem_addr(buf);
    constexpr int kSteps = kWgK / 16;
    uint32_t af[kSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wg_code_frag<T, BITS>(buf + L::kX, wc, kk, g, t, af[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_rs128<T>(grp, af[kk], desc_k(x_tile, kWgBM, 0, kk),
                     (first && kk == 0) ? 0 : 1);
    wgmma_commit();
    first = false;
    wgmma_wait<0>();
    fence_regs<64>(grp);
    fence_regs<4 * kSteps>(&af[0][0]);
    mbar_arrive(&empty[stage]);
    --left;
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int st = 0; st < nstages; ++st) run_stage();
  fold();

  // this thread's outputs: x rows m0 + 8j + 2t + (e & 1), columns col0 +
  // (e >> 1), in acc[4j + e]
  T* out = static_cast<T*>(a.out);
  const bool col_in = col0 < a.n;  // n % 16 == 0: col0 + 1 < n too
  if (gridDim.z == 1) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 8 * j + 2 * t + r;
        if (row < a.m && col_in) {
          const T lo = from_f32<T>(acc[4 * j + r]);
          const T hi = from_f32<T>(acc[4 * j + 2 + r]);
          *reinterpret_cast<uint32_t*>(out + size_t(row) * a.n + col0) =
              uint32_t(*reinterpret_cast<const uint16_t*>(&lo)) |
              uint32_t(*reinterpret_cast<const uint16_t*>(&hi)) << 16;
        }
      }
    return;
  }
  const size_t mn = size_t(a.m) * a.n;
  float* part = a.partial + blockIdx.z * mn;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 8 * j + 2 * t + r;
      if (row < a.m && col_in)
        *reinterpret_cast<float2*>(part + size_t(row) * a.n + col0) =
            make_float2(acc[4 * j + r], acc[4 * j + 2 + r]);
    }
  int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (!take_ticket(counter, tid, 256, &last_split)) return;
  merge_tile<T, kWgBM, kWgBN, 256>(a.partial, out, a.m, a.n, m0, n0, tid);
  if (tid == 0) *counter = 0;
}

// The wgmma kernel takes the product where TMA reads both operands (x and
// the codes 16-byte aligned, rows of 16-byte multiples).
bool wg_takes(int m, int k, int n, int group, bool aligned) {
  return m > kTcSkinnyMaxM && group % kWgK == 0 && k % 8 == 0 &&
         n % 16 == 0 && aligned;
}

template <typename T, int BITS>
const void* wg_fn() {
  const void* fn = reinterpret_cast<const void*>(&qmm_wg_kernel<T, BITS>);
  static std::atomic<int> raised[kMaxDevices];
  return raise_smem(raised, fn, WgSmem<BITS>::kSmem) ? fn : nullptr;
}

TcKernel wg_pick(int bits, int dtype) {
  const int smem = bits == 8 ? WgSmem<8>::kSmem : WgSmem<4>::kSmem;
  const void* fn = nullptr;
  switch (dtype * 2 + (bits == 4)) {
    case 2: fn = wg_fn<__half, 8>(); break;
    case 3: fn = wg_fn<__half, 4>(); break;
    case 4: fn = wg_fn<__nv_bfloat16, 8>(); break;
    case 5: fn = wg_fn<__nv_bfloat16, 4>(); break;
    default: break;
  }
  return {fn, kWgThreads, kWgBM, kWgBN, smem};
}

int launch_wg(const TcKernel& kern, const void* x, const void* qw,
              const void* scales, void* out, void* scratch, void* counters,
              int m, int k, int n, int group, int bits, int dtype,
              int splits, int ks, cudaStream_t stream) {
  WgArgs a;
  const int kp = padded_k(k, group);
  int e = encode_2d(&a.x_map, x,
                    dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                    2, k, m, 64, kWgBM);
  if (!e)
    e = encode_2d(&a.code_map, qw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n,
                  bits == 8 ? kp : kp / 2, kWgBN,
                  bits == 8 ? kWgK : kWgK / 2);
  if (e) return e;
  a.scales = static_cast<const float*>(scales);
  a.out = out;
  a.partial = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.m = m;
  a.k = k;
  a.n = n;
  a.kp = kp;
  a.group = group;
  a.ks = ks;
  dim3 grid(ceil_div(m, kWgBM), ceil_div(n, kWgBN), splits);
  void* args[] = {&a};
  return int(cudaLaunchKernel(kern.fn, grid, dim3(kWgThreads), args,
                              size_t(kern.smem), stream));
}

int launch_tc(const TcKernel& kern, const void* x, const void* qw,
              const void* scales, void* out, void* scratch, void* counters,
              int m, int k, int n, int group, int bits, int dtype,
              int splits, int ks, cudaStream_t stream) {
  TcArgs a;
  const int kp = padded_k(k, group);
  // TMA where a code row is a multiple of 16 bytes and so is an x row
  a.tma = n % 16 == 0 && k % 8 == 0 &&
          reinterpret_cast<uintptr_t>(qw) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  if (a.tma) {
    int e = encode_2d(&a.x_map, x,
                      dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                      2, k, m, kTcKStage, kern.bm);
    if (!e)
      e = encode_2d(&a.code_map, qw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n,
                    bits == 8 ? kp : kp / 2, 128,
                    bits == 8 ? kTcKStage : kTcKStage / 2);
    if (!e)
      e = encode_2d(&a.scale_map, scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                    n, kp / group, 128, kTcKStage / 16,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e) return e;
  }
  a.x = static_cast<const uint16_t*>(x);
  a.qw = static_cast<const int8_t*>(qw);
  a.scales = static_cast<const float*>(scales);
  a.out = out;
  a.partial = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.m = m;
  a.k = k;
  a.n = n;
  a.kp = kp;
  a.group = group;
  a.ks = ks;
  dim3 grid(ceil_div(m, kern.bm), ceil_div(n, kern.bn), splits);
  void* args[] = {&a};
  return int(cudaLaunchKernel(kern.fn, grid, dim3(kern.threads), args,
                              size_t(kern.smem), stream));
}

}  // namespace

extern "C" {

const char* qmm_error_string(int code) {
  static char buf[96];
  if (code >= flash::sm90::kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code >= flash::sm90::kEncodeError) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled refused an operand "
             "(CUresult %d)", code - flash::sm90::kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel of one product and how to split K for it on the current
// device, for x and codes whose bases are (aligned != 0) or are not all
// 16-byte aligned: writes the kernel (a QmmKernel, which qmm takes), the
// number of splits, the K rows of each, and the int32 counters the
// tensor-core kernels need, one an output tile of the chosen kernel (0
// where it takes one split or the FMA route).  With more than one split
// the caller passes a float32 scratch of splits * m * n elements (and,
// where counters > 0, that many zeroed counters, which the kernel leaves
// zeroed).  The split count fills the card: it
// minimises (waves of blocks) / splits at the occupancy the compiled
// kernel reaches, within the kernel's limits (the FMA skinny kernel stages
// at most 1024 K rows of x; the tensor-core kernels split at group
// boundaries).  Returns a CUDA error code (0 = planned).
int qmm_plan(int m, int k, int n, int group, int bits, int dtype,
             int aligned, int* kernel_out, int* splits_out, int* ks_out,
             int* counters_out) {
  if (m < 1 || k < 1 || n < 1 || group < 1 || (bits != 4 && bits != 8)) {
    return int(cudaErrorInvalidValue);
  }
  const bool tc = tensor_core_route(dtype, group);
  TcKernel kern{nullptr, 0, 0, 0, 0};
  const void* fn;
  int threads, smem = 0;
  if (tc) {
    const bool wg = wg_takes(m, k, n, group, aligned);
    kern = wg ? wg_pick(bits, dtype) : tc_pick(m, bits, dtype);
    *kernel_out = wg ? kWgmmaKernel : kMmaKernel;
    fn = kern.fn;
    threads = kern.threads;
    smem = kern.smem;
  } else {
    fn = pick_kernel(m, bits, dtype);
    threads = m <= kSkMaxM ? kSkThreads : kTThreads;
    *kernel_out = kFmaKernel;
  }
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      size_t(smem));
  if (e != cudaSuccess) return int(e);
  const int slots = std::max(1, per_sm) * sms;
  if (tc) {
    // splits of whole groups, at most kTcMaxSplits: the fewest waves of
    // blocks, each block charged its rows plus kTcBlockRows for its start
    // (the ring's first stages) and its share of the merge
    const int tiles = ceil_div(m, kern.bm) * ceil_div(n, kern.bn);
    const int kp = padded_k(k, group), groups = kp / group;
    double best_cost = 1e30;
    for (int s = 1; s <= std::min(groups, kTcMaxSplits); ++s) {
      const int ks = ceil_div(groups, s) * group;
      const int splits = ceil_div(kp, ks);
      const double cost = double(ceil_div(tiles * splits, slots)) *
                          (ks + (splits > 1 ? kTcBlockRows : 0));
      if (cost < best_cost - 1e-9) {
        best_cost = cost;
        *ks_out = ks;
        *splits_out = splits;
      }
    }
    *counters_out = *splits_out > 1 ? tiles : 0;
    return 0;
  }
  int tiles, lo, hi;
  if (m <= kSkMaxM) {
    tiles = ceil_div(n, kSkCols) * ceil_div(m, skinny_rows(m));
    lo = ceil_div(k, kSkMaxRows);
    hi = std::max(lo, std::min(16, ceil_div(k, 64)));
  } else {
    tiles = ceil_div(n, kTN) * ceil_div(m, kTM);
    lo = 1;
    hi = std::max(1, std::min(8, ceil_div(k, 256)));
  }
  int best = lo;
  double best_cost = 1e30;
  for (int s = lo; s <= hi; ++s) {
    const double cost = double(ceil_div(tiles * s, slots)) / s;
    if (cost < best_cost - 1e-9) {
      best_cost = cost;
      best = s;
    }
  }
  const int ks = ceil_div(ceil_div(k, best), 16) * 16;
  *ks_out = ks;
  *splits_out = ceil_div(k, ks);
  *counters_out = 0;
  return 0;
}

// out (m, n) = x (m, k) @ dequant(qw, scales); dtype of x and out: 0
// float32, 1 float16, 2 bfloat16.  bits 8: qw int8 (kp, n); bits 4: qw
// nibble-packed (kp / 2, n).  scales f32 (kp / group, n).  kernel, splits,
// ks and the counters' count from qmm_plan (scratch and counters may be
// null with one split; counters is unused on the FMA route).  Launches the
// planned kernel, so the counters fit its tiles; refuses a kernel the
// route or the bases rule out.  Float16 and bfloat16 x with group % 16 ==
// 0 take a tensor-core kernel (one launch), the rest the FMA kernels (a
// second, reducing launch with more than one split).  Returns
// cudaGetLastError() after the launches (0 = launched).
int qmm(const void* x, const void* qw, const void* scales, void* out,
        void* scratch, void* counters, int kernel, int m, int k, int n,
        int group, int bits, int dtype, int splits, int ks, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (group < 1 || splits < 1 || ks < 16 || ks % 16 ||
      (bits != 4 && bits != 8) || (splits > 1 && scratch == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel < kFmaKernel || kernel > kWgmmaKernel ||
      (kernel != kFmaKernel) != tensor_core_route(dtype, group)) {
    return int(cudaErrorInvalidValue);
  }
  if (kernel != kFmaKernel) {
    if (ks % group || splits * ks < padded_k(k, group) ||
        (splits > 1 && counters == nullptr)) {
      return int(cudaErrorInvalidValue);
    }
    if (kernel == kWgmmaKernel) {
      // TMA reads both operands: the plan saw 16-byte aligned bases
      if (!wg_takes(m, k, n, group,
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(qw) % 16 == 0)) {
        return int(cudaErrorInvalidValue);
      }
      const TcKernel kern = wg_pick(bits, dtype);
      if (kern.fn == nullptr) return int(cudaErrorInvalidValue);
      return launch_wg(kern, x, qw, scales, out, scratch, counters, m, k, n,
                       group, bits, dtype, splits, ks, s);
    }
    const TcKernel kern = tc_pick(m, bits, dtype);
    if (kern.fn == nullptr) return int(cudaErrorInvalidValue);
    return launch_tc(kern, x, qw, scales, out, scratch, counters, m, k, n,
                     group, bits, dtype, splits, ks, s);
  }
  if (m <= kSkMaxM && ks > kSkMaxRows) return int(cudaErrorInvalidValue);
  switch (dtype * 2 + (bits == 4)) {
    case 0:
      return launch<float, 8>(x, qw, scales, out, scratch, m, k, n, group,
                              splits, ks, s);
    case 1:
      return launch<float, 4>(x, qw, scales, out, scratch, m, k, n, group,
                              splits, ks, s);
    case 2:
      return launch<__half, 8>(x, qw, scales, out, scratch, m, k, n, group,
                               splits, ks, s);
    case 3:
      return launch<__half, 4>(x, qw, scales, out, scratch, m, k, n, group,
                               splits, ks, s);
    case 4:
      return launch<__nv_bfloat16, 8>(x, qw, scales, out, scratch, m, k, n,
                                      group, splits, ks, s);
    case 5:
      return launch<__nv_bfloat16, 4>(x, qw, scales, out, scratch, m, k, n,
                                      group, splits, ks, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
