// Weight-only quantized matmul, int8 and int4 codes, for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/quant_matmul.py
// `_qmm_kernel_i8` and `_qmm_kernel_i4`, reached through
// `_quant_matmul_fwd`.
//
// What it computes:  out[m, n] = sum_{k < K} x[m, k] * (code[k, n] * s[k / group, n])
// with x (M, K) in float32, float16 or bfloat16 widened to f32, codes int8
// (Kp, N) or nibble-packed int4 (Kp/2, N) (byte [j, n] holds code 2j in its
// low nibble and 2j+1 in its high one, sign (v ^ 8) - 8), f32 scales
// (Kp/group, N), f32 multiply-adds, and out (M, N) in x's type.  Only the
// first K code rows are contracted: the zero rows that pad K up to a group
// multiple (or an even count under int4) are never read.  Each code is
// widened exactly (a byte permute into the mantissa of 2^23 and one
// subtraction) and multiplied by its scale in f32, as the reference's f32
// dot_general does; the tensor cores are not used, so the numerics stay
// those of an f32 product.
//
// Two shapes of work, two kernels:
//
// * skinny (M <= 32: decode steps, the lm_head's last rows).  Bound by the
//   bytes of the codes: every code is used by at most 32 rows.  A block
//   owns 128 output columns and a slice of at most 1024 K rows; each lane
//   reads 4 adjacent columns of a row in one 4-byte load (a warp covers a
//   row's 128 bytes), eight loads in flight a lane; the eight warps take
//   contiguous parts of the slice and sum in shared memory at the end.
//   x's slice is staged once in shared memory as f32.  N = 4096 makes
//   only 32 column tiles, so K is split across blocks until the card is
//   full: each split writes f32 partial sums to a scratch buffer and a
//   second kernel adds them in order (deterministic, no atomics).
// * tiled (M > 32: prefill chunks).  Bound by f32 multiply-adds
//   (2*M*K*N of them at the f32 rate).  A classic register-tiled product:
//   a block computes a 128 x 128 output tile, eight by eight a thread,
//   from 16-deep x and weight tiles double-buffered in shared memory; the
//   weight tile is dequantized to f32 on its way into shared memory, so
//   each code is converted once per block, not once per row.  The next
//   tiles' global loads are in flight while the current ones multiply.
//   K is split across blocks, as above, when the grid would leave SMs
//   idle.
//
// wgmma on bf16-rounded weights, and the f32-accumulating int8 tensor
// cores, would be faster; both change the numerics the tests hold and are
// later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

}  // namespace

extern "C" {

const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// How to split K for one product on the current device: writes the number
// of splits and the K rows of each (a multiple of 16).  With more than one
// split the caller passes a float32 scratch of splits * m * n elements.
// The split count fills the card: it minimises (waves of blocks) / splits
// at the occupancy the compiled kernel reaches, within the kernel's limits
// (the skinny kernel stages at most 1024 K rows of x).  Returns a CUDA
// error code (0 = planned).
int qmm_plan(int m, int k, int n, int bits, int dtype, int* splits_out,
             int* ks_out) {
  if (m < 1 || k < 1 || n < 1 || (bits != 4 && bits != 8)) {
    return int(cudaErrorInvalidValue);
  }
  const void* fn = pick_kernel(m, bits, dtype);
  if (fn == nullptr) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool skinny = m <= kSkMaxM;
  const int threads = skinny ? kSkThreads : kTThreads;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, 0);
  if (e != cudaSuccess) return int(e);
  const int slots = std::max(1, per_sm) * sms;
  int tiles, lo, hi;
  if (skinny) {
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
  return 0;
}

// out (m, n) = x (m, k) @ dequant(qw, scales); dtype of x and out: 0
// float32, 1 float16, 2 bfloat16.  bits 8: qw int8 (kp, n); bits 4: qw
// nibble-packed (kp / 2, n).  scales f32 (kp / group, n).  splits and ks
// from qmm_plan.  Returns cudaGetLastError() after the launches (0 =
// launched).
int qmm(const void* x, const void* qw, const void* scales, void* out,
        void* scratch, int m, int k, int n, int group, int bits, int dtype,
        int splits, int ks, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (group < 1 || splits < 1 || ks < 16 || ks % 16 ||
      (bits != 4 && bits != 8) || (m <= kSkMaxM && ks > kSkMaxRows) ||
      (splits > 1 && scratch == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
