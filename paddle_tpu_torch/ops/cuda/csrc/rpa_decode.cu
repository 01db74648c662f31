// Ragged paged attention, decode step (one query token per sequence), for
// Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/attention.py
// `_rpa_decode_kernel` and `_rpa_decode_kernel_quant` (online-softmax body
// `_rpa_decode_core`), reached through `ragged_paged_attention_decode`:
// entry points `rpa_decode` (pools in q's type) and `rpa_decode_quant`
// (int8 code pools with one f32 scale per (token, kv head) in
// (pages, page, Hkv, 1) scale pools, dequantized as code x scale in f32
// right after each row's load, as the TPU kernel does after each page's).
//
// What it computes, for each sequence b and query head h (kv head
// h / (H / Hkv)):
//   out[b, h] = softmax(scale * q[b, h] . K[b, :len_b]) @ V[b, :len_b]
// where token p of sequence b lives at page block_tables[b, p / page],
// offset p % page, of the pooled K/V arrays (num_pages, page, Hkv, D).
// Arithmetic is f32 throughout; positions >= len get score -1e30 and
// probability 0; len == 0 (an inert batch slot) writes exact zeros.
//
// Bound: device-memory bytes.  Each K/V element (2 bytes in bf16; 1 byte
// and a share of its row's 4-byte scale in int8) is read once and used for
// 2 * (H / Hkv) flops, far below the ~295 flops per byte where the H100's
// arithmetic would become the limit.  So the design reads only what is
// needed: one thread block per (kv head, sequence) walks ONLY the tokens
// the sequence holds (ceil(len / page) pages, found through its block
// table; the page-0 padding of the table is never touched), reads each K/V
// row once with 16-byte loads where alignment allows, and serves all
// H / Hkv query heads of the group from that one read.  The TPU kernel's
// sequential grid over (sequence, page) with softmax state in VMEM becomes
// a loop over 32-token tiles inside the block, with the running max, sum
// and output accumulator in shared memory.  wgmma, TMA and splitting long
// sequences across blocks (flash-decoding) are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;       // tokens staged per step: one per lane
constexpr int kThreads = 128;   // four warps
constexpr int kWarps = kThreads / 32;
constexpr float kBigNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return float(x); }
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: tile row offsets (int64), then f32 arrays (the last two,
// the tile rows' K and V scales, used by the int8 variant only).
__host__ __device__ inline size_t smem_bytes(int groups, int d) {
  return sizeof(long long) * kTile +
         sizeof(float) * (size_t(2) * groups * d + size_t(2) * kTile * d +
                          size_t(groups) * kTile + size_t(3) * groups +
                          size_t(2) * kTile);
}

// Stage rows [0, n) of a tile: row t holds D elements starting at
// src + row_off[t]; converted to f32 (times the row's scale, for int8
// codes) into dst[t * D + :].
template <typename P>
__device__ __forceinline__ void stage_rows(const P* __restrict__ src,
                                           const long long* row_off,
                                           const float* row_scale, int n,
                                           int d, bool vec, float* dst) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = 16 / sizeof(P);
  if (vec) {
    const int per_row = d / kVec;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int t = i / per_row;
      const int c = (i - t * per_row) * kVec;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + row_off[t] + c);
      const P* e = reinterpret_cast<const P*>(&raw);
      float* o = dst + t * d + c;
      const float sc = kQuant ? row_scale[t] : 1.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        o[j] = kQuant ? to_f32(e[j]) * sc : to_f32(e[j]);
    }
  } else {
    for (int i = threadIdx.x; i < n * d; i += kThreads) {
      const int t = i / d;
      const float v = to_f32(src[row_off[t] + (i - t * d)]);
      dst[i] = kQuant ? v * row_scale[t] : v;
    }
  }
}

// T: q and out; P: the pools (T, or int8_t codes with f32 scale pools)
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
    rpa_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                      const P* __restrict__ v_pages,
                      const float* __restrict__ k_scales,
                      const float* __restrict__ v_scales,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ seq_lens, T* __restrict__ out,
                      int heads, int kv_heads, int d, int page, int max_pages,
                      float scale, bool vec) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = heads / kv_heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = seq_lens[b];
  const int gd = groups * d;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* row_off = reinterpret_cast<long long*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(row_off + kTile);  // groups * d
  float* acc_s = q_s + gd;                                  // groups * d
  float* k_s = acc_s + gd;                                  // kTile * d
  float* v_s = k_s + kTile * d;                             // kTile * d
  float* p_s = v_s + kTile * d;                             // groups * kTile
  float* m_s = p_s + groups * kTile;                        // groups
  float* l_s = m_s + groups;                                // groups
  float* alpha_s = l_s + groups;                            // groups
  float* ks_s = alpha_s + groups;                           // kTile
  float* vs_s = ks_s + kTile;                               // kTile

  // the group's query heads are contiguous: q[b, kvh * groups + g, :]
  const size_t head0 = (size_t(b) * heads + size_t(kvh) * groups) * d;
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = to_f32(q[head0 + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < groups; g += kThreads) {
    m_s[g] = kBigNeg;
    l_s[g] = 0.f;
  }
  const int* table = block_tables + size_t(b) * max_pages;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    if (tid < n) {
      const int pos = t0 + tid;
      const long long pg = table[pos / page];
      const long long row = (pg * page + pos % page) * kv_heads + kvh;
      row_off[tid] = row * d;
      if (std::is_same<P, int8_t>::value) {  // one scale per (token, head)
        ks_s[tid] = k_scales[row];
        vs_s[tid] = v_scales[row];
      }
    }
    __syncthreads();
    stage_rows(k_pages, row_off, ks_s, n, d, vec, k_s);
    stage_rows(v_pages, row_off, vs_s, n, d, vec, v_s);
    __syncthreads();

    // scores: one warp per (head, token) pair, lanes split D
    for (int pair = warp; pair < groups * kTile; pair += kWarps) {
      const int g = pair / kTile;
      const int t = pair - g * kTile;
      float s = kBigNeg;
      if (t < n) {  // warp-uniform
        float part = 0.f;
        for (int j = lane; j < d; j += 32)
          part = fmaf(q_s[g * d + j], k_s[t * d + j], part);
        s = warp_sum(part) * scale;
      }
      if (lane == 0) p_s[g * kTile + t] = s;
    }
    __syncthreads();

    // online softmax: one warp per head, one lane per token
    for (int g = warp; g < groups; g += kWarps) {
      const float m_prev = m_s[g];
      const float s = p_s[g * kTile + lane];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // rescale the accumulator and add this tile's P . V
    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / d;
      const int j = i - g * d;
      const float* pg = p_s + g * kTile;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pg[t], v_s[t * d + j], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < gd; i += kThreads) {
    const float l = l_s[i / d];
    out[head0 + i] = from_f32<T>(acc_s[i] / (l > 0.f ? l : 1.f));
  }
}

template <typename T, typename P>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scales, const float* v_scales,
           const int* block_tables, const int* seq_lens, void* out, int batch,
           int heads, int kv_heads, int d, int page, int max_pages,
           float scale, cudaStream_t stream) {
  const int groups = heads / kv_heads;
  const size_t smem = smem_bytes(groups, d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rpa_decode_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int vec_elems = 16 / int(sizeof(P));
  const bool vec = (d % vec_elems == 0) &&
                   (reinterpret_cast<uintptr_t>(k_pages) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v_pages) % 16 == 0);
  dim3 grid(kv_heads, batch);
  rpa_decode_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), k_scales, v_scales, block_tables,
      seq_lens, static_cast<T*>(out), heads, kv_heads, d, page, max_pages,
      scale, vec);
  return int(cudaGetLastError());
}

// kQuant: int8 code pools with f32 scale pools; else pools of q's type
template <bool kQuant>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales,
             const void* block_tables, const void* seq_lens, void* out,
             int batch, int heads, int kv_heads, int d, int page,
             int max_pages, float scale, int dtype, void* stream) {
  if (batch == 0) return 0;
  const int* bt = static_cast<const int*>(block_tables);
  const int* sl = static_cast<const int*>(seq_lens);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float, std::conditional_t<kQuant, int8_t, float>>(
          q, k_pages, v_pages, ks, vs, bt, sl, out, batch, heads, kv_heads,
          d, page, max_pages, scale, s);
    case 1:
      return launch<__half, std::conditional_t<kQuant, int8_t, __half>>(
          q, k_pages, v_pages, ks, vs, bt, sl, out, batch, heads, kv_heads,
          d, page, max_pages, scale, s);
    case 2:
      return launch<__nv_bfloat16,
                    std::conditional_t<kQuant, int8_t, __nv_bfloat16>>(
          q, k_pages, v_pages, ks, vs, bt, sl, out, batch, heads, kv_heads,
          d, page, max_pages, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs (the wrapper refuses shapes whose
// requirement exceeds the card's per-block limit).
size_t rpa_decode_smem_bytes(int groups, int d) {
  return smem_bytes(groups, d);
}

const char* rpa_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of q and out, and of the pools here): 0 float32, 1 float16, 2
// bfloat16.  Returns cudaGetLastError() after the launch (0 = launched).
int rpa_decode(const void* q, const void* k_pages, const void* v_pages,
               const void* block_tables, const void* seq_lens, void* out,
               int batch, int heads, int kv_heads, int d, int page,
               int max_pages, float scale, int dtype, void* stream) {
  return dispatch<false>(q, k_pages, v_pages, nullptr, nullptr, block_tables,
                         seq_lens, out, batch, heads, kv_heads, d, page,
                         max_pages, scale, dtype, stream);
}

// As rpa_decode over int8 code pools (num_pages, page, Hkv, D) and f32
// scale pools (num_pages, page, Hkv, 1); dtype is q's and out's.
int rpa_decode_quant(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scales, const void* v_scales,
                     const void* block_tables, const void* seq_lens,
                     void* out, int batch, int heads, int kv_heads, int d,
                     int page, int max_pages, float scale, int dtype,
                     void* stream) {
  return dispatch<true>(q, k_pages, v_pages, k_scales, v_scales,
                        block_tables, seq_lens, out, batch, heads, kv_heads,
                        d, page, max_pages, scale, dtype, stream);
}

}  // extern "C"
