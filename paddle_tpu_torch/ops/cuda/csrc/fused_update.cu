// The optimizer update (SGD, Adam, AdamW) as one multi-tensor kernel.
//
// The reference traces each parameter's update into its one XLA program,
// which fuses it (paddle_tpu/optimizer/optimizer.py:330-350); here one
// launch updates every tensor of a dtype group in place.  A device table
// holds one Entry (p, g, m1, m2, numel, decay) a tensor; the tensors are
// cut into chunks of kChunk elements, a thread block each, and a prefix
// table (chunks before tensor t) maps a block to its tensor by binary
// search.  Each thread updates 8 consecutive elements at a time, with
// 16-byte vector loads and stores where all four of the tensor's
// addresses are 16-byte aligned, and element by element in a chunk's tail
// (or where they are not).
//
// The learning rate and the step number are read from device memory (0-dim
// float32 tensors), so a CUDA graph of the update takes each replay's
// values.  So is the overflow flag of dynamic loss scaling (amp.GradScaler;
// a 0-dim float32, null without a scaler): where it is nonzero every block
// returns before it reads or writes p, m1 or m2, so an overflowed step
// leaves the whole state bitwise as it was, without a host sync (the
// reference discards the update with a select,
// paddle_tpu/optimizer/optimizer.py:139-148).
//
// All arithmetic is f32, in this order and rounded at each operation (the
// _rn intrinsics keep nvcc from contracting it into FMAs), which is the
// order of the plain version in fused_update.py:
//
//   bc1 = 1 - b1^step, bc2 = 1 - b2^step           (powf, f32)
//   keep = 1 - lr * coeff                           (where decay is set)
//   p  = p * keep                                   (where decay is set)
//   m1 = m1 * b1 + g * (1 - b1)
//   m2 = m2 * b2 + (g * g) * (1 - b2)
//   p  = p - (lr * (m1 / bc1)) / (sqrt(m2 / bc2) + eps)
//
// with p, g, m1, m2 loaded from their storage types (float, half or
// bfloat16; g has p's type) and each output rounded once to its type.
// SGD is p = p - lr * g.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;          // elements a thread updates at a time
constexpr int kUnroll = 2;       // 8-element groups in flight a thread
constexpr int64_t kChunk = 32768;  // elements a block
constexpr int kMaxPatch = 64;    // grad addresses a set_grads launch

enum Op { kSgd = 0, kAdam = 1 };

struct Entry {
  int64_t p, g, m1, m2, numel, decay;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, coeff;
};

struct GradPatch {
  int64_t ptr[kMaxPatch];
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 elements of T as raw 16-byte words: one for 16-bit types, two for f32
template <typename T>
struct Raw {
  static constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 w[kWords];
};

// streaming loads and stores: every byte is touched once
template <typename T>
__device__ __forceinline__ void load_raw(const T* src, Raw<T>& r) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < Raw<T>::kWords; ++i) r.w[i] = __ldcs(s + i);
}

template <typename T>
__device__ __forceinline__ void store_raw(T* dst, const Raw<T>& r) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < Raw<T>::kWords; ++i) __stcs(d + i, r.w[i]);
}

template <typename T>
__device__ __forceinline__ float raw_get(const Raw<T>& r, int k) {
  return to_f<T>(reinterpret_cast<const T*>(r.w)[k]);
}

template <typename T>
__device__ __forceinline__ void raw_set(Raw<T>& r, int k, float v) {
  reinterpret_cast<T*>(r.w)[k] = from_f<T>(v);
}

struct Scalars {
  float lr, keep, bc1, bc2;
};

template <int OP>
__device__ __forceinline__ void update(float& p, float g, float& m1,
                                       float& m2, const Scalars& s,
                                       const Hyper& h, bool decay) {
  if (OP == kSgd) {
    p = __fsub_rn(p, __fmul_rn(s.lr, g));
    return;
  }
  if (decay) p = __fmul_rn(p, s.keep);
  m1 = __fadd_rn(__fmul_rn(m1, h.b1), __fmul_rn(g, h.omb1));
  m2 = __fadd_rn(__fmul_rn(m2, h.b2), __fmul_rn(__fmul_rn(g, g), h.omb2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(m2, s.bc2)), h.eps);
  const float upd = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(m1, s.bc1)), den);
  p = __fsub_rn(p, upd);
}

template <int OP, typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    fused_update_kernel(const Entry* __restrict__ table,
                        const int64_t* __restrict__ prefix, int n_tensors,
                        const float* __restrict__ lr_p,
                        const float* __restrict__ step_p,
                        const float* __restrict__ skip_p, Hyper h) {
  if (skip_p != nullptr && *skip_p != 0.f) return;
  // the tensor of this block's chunk: prefix[t] <= chunk < prefix[t + 1]
  const int64_t chunk = blockIdx.x;
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const Entry e = table[lo];
  const int64_t begin = (chunk - prefix[lo]) * kChunk;
  const int64_t end =
      begin + kChunk < e.numel ? begin + kChunk : e.numel;
  const bool decay = e.decay != 0;

  Scalars s;
  s.lr = *lr_p;
  s.keep = __fsub_rn(1.f, __fmul_rn(s.lr, h.coeff));
  s.bc1 = s.bc2 = 1.f;
  if (OP == kAdam) {
    const float t = *step_p;
    s.bc1 = __fsub_rn(1.f, powf(h.b1, t));
    s.bc2 = __fsub_rn(1.f, powf(h.b2, t));
  }

  P* p = reinterpret_cast<P*>(e.p);
  const P* g = reinterpret_cast<const P*>(e.g);
  M* m1 = reinterpret_cast<M*>(e.m1);
  M* m2 = reinterpret_cast<M*>(e.m2);
  const bool vec = OP == kSgd ? ((e.p | e.g) & 15) == 0
                              : ((e.p | e.g | e.m1 | e.m2) & 15) == 0;
  const int64_t groups = vec ? (end - begin) / kVec : 0;

  for (int64_t j0 = threadIdx.x; j0 < groups;
       j0 += int64_t(kThreads) * kUnroll) {
    Raw<P> rp[kUnroll], rg[kUnroll];
    Raw<M> ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + int64_t(u) * kThreads;
      if (j < groups) {
        const int64_t i = begin + j * kVec;
        load_raw(p + i, rp[u]);
        load_raw(g + i, rg[u]);
        if (OP == kAdam) {
          load_raw(m1 + i, ra[u]);
          load_raw(m2 + i, rb[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + int64_t(u) * kThreads;
      if (j < groups) {
        const int64_t i = begin + j * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          float pv = raw_get(rp[u], k);
          float av = 0.f, bv = 0.f;
          if (OP == kAdam) {
            av = raw_get(ra[u], k);
            bv = raw_get(rb[u], k);
          }
          update<OP>(pv, raw_get(rg[u], k), av, bv, s, h, decay);
          raw_set(rp[u], k, pv);
          if (OP == kAdam) {
            raw_set(ra[u], k, av);
            raw_set(rb[u], k, bv);
          }
        }
        store_raw(p + i, rp[u]);
        if (OP == kAdam) {
          store_raw(m1 + i, ra[u]);
          store_raw(m2 + i, rb[u]);
        }
      }
    }
  }
  // the chunk's tail (the whole chunk where the addresses are unaligned)
  for (int64_t i = begin + groups * kVec + threadIdx.x; i < end;
       i += kThreads) {
    float pv = to_f<P>(p[i]);
    float av = 0.f, bv = 0.f;
    if (OP == kAdam) {
      av = to_f<M>(m1[i]);
      bv = to_f<M>(m2[i]);
    }
    update<OP>(pv, to_f<P>(g[i]), av, bv, s, h, decay);
    p[i] = from_f<P>(pv);
    if (OP == kAdam) {
      m1[i] = from_f<M>(av);
      m2[i] = from_f<M>(bv);
    }
  }
}

// writes grad addresses into the table: the backward allocates the grads,
// so their addresses are known only at the update (a capture records this
// launch with its arguments, and each replay rewrites the same addresses)
__global__ void fused_update_set_grads_kernel(Entry* table, GradPatch patch,
                                              int first, int count) {
  const int i = threadIdx.x;
  if (i < count) table[first + i].g = patch.ptr[i];
}

template <int OP, typename P, typename M>
cudaError_t launch(const void* table, const void* prefix, int n_tensors,
                   long long n_chunks, const void* lr, const void* step,
                   const void* skip, Hyper h, cudaStream_t stream) {
  fused_update_kernel<OP, P, M>
      <<<dim3(static_cast<unsigned>(n_chunks)), kThreads, 0, stream>>>(
          static_cast<const Entry*>(table),
          static_cast<const int64_t*>(prefix), n_tensors,
          static_cast<const float*>(lr), static_cast<const float*>(step),
          static_cast<const float*>(skip), h);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements a chunk (a thread block), and grad addresses a set_grads call.
long long fused_update_chunk() { return kChunk; }
int fused_update_max_patch() { return kMaxPatch; }
// Bytes of one table entry: int64 p, g, m1, m2, numel, decay.
int fused_update_entry_bytes() { return sizeof(Entry); }

const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table: n_tensors Entries on the device; prefix: n_tensors + 1 int64
// chunk counts (prefix[0] = 0, prefix[n] = n_chunks); lr, step: 0-dim f32
// on the device; skip: a 0-dim f32 on the device (nonzero: leave every
// tensor as it is) or null.  op: 0 SGD, 1 Adam (AdamW: Adam with decay
// flags and coeff).  p_dtype (of p and g) and m_dtype (of m1 and m2): 0 float32, 1
// float16, 2 bfloat16; the groups are (f32, f32), (f16, f16), (bf16,
// bf16), (f16, f32), (bf16, f32), and SGD ignores m_dtype.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for another group or op, or a grid past 2^31 - 1
// blocks.
int fused_update(const void* table, const void* prefix, int n_tensors,
                 long long n_chunks, const void* lr, const void* step,
                 const void* skip, int op, int p_dtype, int m_dtype,
                 float b1, float omb1, float b2, float omb2, float eps,
                 float coeff, void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffffLL || n_tensors <= 0)
    return cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps, coeff};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kSgd) {
    switch (p_dtype) {
      case 0: return launch<kSgd, float, float>(
          table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
      case 1: return launch<kSgd, __half, __half>(
          table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
      case 2: return launch<kSgd, __nv_bfloat16, __nv_bfloat16>(
          table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (op != kAdam) return cudaErrorInvalidValue;
  const int group = p_dtype * 3 + m_dtype;
  switch (group) {
    case 0 * 3 + 0: return launch<kAdam, float, float>(
        table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
    case 1 * 3 + 1: return launch<kAdam, __half, __half>(
        table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
    case 2 * 3 + 2: return launch<kAdam, __nv_bfloat16, __nv_bfloat16>(
        table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
    case 1 * 3 + 0: return launch<kAdam, __half, float>(
        table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
    case 2 * 3 + 0: return launch<kAdam, __nv_bfloat16, float>(
        table, prefix, n_tensors, n_chunks, lr, step, skip, h, s);
    default: return cudaErrorInvalidValue;
  }
}

// table[first + i].g = ptrs[i] for i < count (count <= 64), on `stream`.
int fused_update_set_grads(void* table, const long long* ptrs, int first,
                           int count, void* stream) {
  if (count <= 0 || count > kMaxPatch) return cudaErrorInvalidValue;
  GradPatch patch;
  for (int i = 0; i < count; ++i) patch.ptr[i] = ptrs[i];
  fused_update_set_grads_kernel<<<1, kMaxPatch, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<Entry*>(table), patch, first, count);
  return cudaGetLastError();
}

}  // extern "C"
