// The optimizer update (SGD, Adam/AdamW, Momentum, Adagrad, Adamax,
// RMSProp, Adadelta, Rprop, NAdam, RAdam, ASGD, Lamb) as one multi-tensor
// kernel.
//
// The reference traces each parameter's update into its one XLA program,
// which fuses it (paddle_tpu/optimizer/optimizer.py:227-610); here one
// launch updates every tensor of a dtype group in place (Lamb: two
// launches, below).  A device table holds one Entry (p, g, m1, m2, m3,
// numel, decay) a tensor; the tensors are cut into chunks of kChunk
// elements, a thread block each, and a prefix table (chunks before tensor
// t) maps a block to its tensor by binary search.  Each thread updates 8
// consecutive elements at a time, with 16-byte vector loads and stores
// where all of the tensor's addresses the rule touches are 16-byte
// aligned, and element by element in a chunk's tail (or where they are
// not).  Every rule is bound by the bytes it moves: p and g read, each
// state it keeps read and written, p written.
//
// The learning rate and the step number are read from device memory (0-dim
// float32 tensors), so a CUDA graph of the update takes each replay's
// values.  So is the overflow flag of dynamic loss scaling (amp.GradScaler;
// a 0-dim float32, null without a scaler): where it is nonzero every block
// of every rule (and of both of Lamb's passes) returns before it reads or
// writes a tensor, so an overflowed step leaves the whole state bitwise as
// it was, without a host sync (the reference discards the update with a
// select, paddle_tpu/optimizer/optimizer.py:139-148).
//
// All arithmetic on the tensors is f32, in the reference's order and
// rounded at each operation (the _rn intrinsics keep nvcc from contracting
// it into FMAs), which is the order of the plain versions in
// fused_update.py; p, g and the states are loaded from their storage types
// (float, half or bfloat16; g has p's type) and each output is rounded
// once to its type.  Constants are the reference's Python floats rounded
// to f32 (1 - b formed in f64 first).  Adam's bias corrections are formed
// in f32 (powf) from the f32 step:
//
//   bc1 = 1 - b1^step, bc2 = 1 - b2^step           (powf, f32)
//   keep = 1 - lr * coeff                           (where decay is set)
//   p  = p * keep                                   (where decay is set)
//   m1 = m1 * b1 + g * (1 - b1)
//   m2 = m2 * b2 + (g * g) * (1 - b2)
//   p  = p - (lr * (m1 / bc1)) / (sqrt(m2 / bc2) + eps)
//
// The later rules form their step's scalars (bias corrections, RAdam's
// rectification, Adamax's lr / bc1) in f64 from the step and the f64
// betas and round each to f32 once, as the reference's scalar arithmetic
// is f64 (its Python floats and step) until it meets an f32 array; RAdam's
// rho_t = rho_inf - 2 t b2^t / bc2 cancels to a few units out of ~2000 and
// would keep no digit in f32.  With a = m1, b = m2, c = m3:
//
//   Momentum  a = mu a + g;  p -= lr (nesterov ? g + mu a : a)
//   Adagrad   a = a + g g;   p -= (lr g) / (sqrt(a) + eps)
//   Adamax    a = b1 a + (1-b1) g;  b = max(b2 b, |g|);
//             p -= (lr/bc1 a) / (b + eps)
//   RMSProp   a (mean_square) = rho a + ((1-rho) g) g;
//             centered: c (mean_grad) = rho c + (1-rho) g,
//                       den = sqrt((a - c c) + eps), else sqrt(a + eps);
//             b (momentum_acc) = mu b + (lr g) / den;  p -= b
//   Adadelta  a = rho a + ((1-rho) g) g;
//             dx = (sqrt(b + eps) / sqrt(a + eps)) g;
//             b = rho b + ((1-rho) dx) dx;  p -= lr dx
//   Rprop     s = sign(g a); b = clip(s > 0 ? b eta+ : s < 0 ? b eta- : b,
//             lo, hi); a = s < 0 ? 0 : g; p -= sign(a) b   (no lr)
//   NAdam     a, b as Adam's with ((1-b2) g) g;
//             mh = (b1 a) / bc1 + ((1-b1) g) / bc1;
//             p -= (lr mh) / (sqrt(b / bc2) + eps)
//   RAdam     a, b as NAdam's;  p -= (lr (a / bc1)) r, r = rho_t > 5 ?
//             rect (1 / sqrt(b / bc2 + eps^2)) : 1
//   ASGD      p -= lr g;  a = a + (p - a) / step
//   Lamb      a, b as NAdam's; r = (a / bc1) / (sqrt(b / bc2) + eps)
//             (+ wd p where decay is set); p -= (lr trust) r, trust =
//             ||p|| / ||r|| over the tensor (1 where either is 0)
//
// Lamb's trust ratio needs two norms over each whole tensor before any
// element is written, and blocks run in no order, so it takes two
// launches.  Pass 1 (fused_update_lamb_norms_kernel) forms the new moments
// and r in registers, stores nothing, and writes its chunk's sums of p^2
// and r^2 (f32, a fixed tree) to a workspace indexed by chunk: no atomics,
// so the result is the same from run to run.  Pass 2 sums its tensor's
// partials in a fixed order (f64), forms the trust ratio, recomputes the
// moments and r from the old moments exactly as pass 1 did, and writes p,
// m1 and m2.  The pass reads p, g, m1, m2 twice: 22 bytes an element in
// bf16 against the 14 the update needs.

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

// the rules; kLambNorms is Lamb's first pass, launched with kLamb
enum Op {
  kSgd = 0, kAdam = 1, kMomentum = 2, kAdagrad = 3, kAdamax = 4,
  kRmsProp = 5, kRmsPropCentered = 6, kAdadelta = 7, kRprop = 8,
  kNAdam = 9, kRAdam = 10, kAsgd = 11, kLamb = 12, kLambNorms = 13
};

// the states a rule reads and writes: m1, m1 and m2, or m1, m2 and m3
__host__ __device__ constexpr int n_states(int op) {
  return op == kSgd ? 0
       : (op == kMomentum || op == kAdagrad || op == kAsgd) ? 1
       : op == kRmsPropCentered ? 3 : 2;
}

struct Entry {
  int64_t p, g, m1, m2, m3, numel, decay;
};

// Constants of the rules, f32 as the reference's Python floats meet its
// f32 arrays; db1, db2 and rho_inf (f64) form the step's scalars.
// RMSProp and Adadelta keep rho in b1 and 1 - rho in omb1.
struct Hyper {
  float b1, omb1, b2, omb2, eps, coeff;
  float mu;                         // Momentum's and RMSProp's momentum
  float eps2;                       // RAdam: eps^2
  float eta_minus, eta_plus, lo, hi;  // Rprop
  int nesterov;
  double db1, db2, rho_inf;
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

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float fsqrt(float a) { return __fsqrt_rn(a); }

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// the step's scalars, formed once a block
struct Scalars {
  float lr, keep, bc1, bc2;
  float lr_bc;      // Adamax: lr / bc1
  float rect;       // RAdam: the rectification where rho_t > 5
  bool rectify;     // RAdam: rho_t > 5
  float step;       // ASGD
  float lr_trust;   // Lamb's second pass: lr * trust
};

template <int OP>
__device__ __forceinline__ Scalars make_scalars(const float* lr_p,
                                                const float* step_p,
                                                const Hyper& h) {
  Scalars s;
  s.lr = *lr_p;
  s.keep = __fsub_rn(1.f, __fmul_rn(s.lr, h.coeff));
  s.bc1 = s.bc2 = 1.f;
  s.lr_bc = s.rect = s.step = s.lr_trust = 0.f;
  s.rectify = false;
  if (OP == kAdam) {
    const float t = *step_p;
    s.bc1 = __fsub_rn(1.f, powf(h.b1, t));
    s.bc2 = __fsub_rn(1.f, powf(h.b2, t));
  }
  if (OP == kAdamax || OP == kNAdam || OP == kRAdam || OP == kLamb ||
      OP == kLambNorms) {
    const double t = static_cast<double>(*step_p);
    const double bt2 = pow(h.db2, t);
    const double bc1 = __dsub_rn(1.0, pow(h.db1, t));
    const double bc2 = __dsub_rn(1.0, bt2);
    s.bc1 = static_cast<float>(bc1);
    s.bc2 = static_cast<float>(bc2);
    if (OP == kAdamax)
      s.lr_bc = static_cast<float>(__ddiv_rn(static_cast<double>(s.lr),
                                             bc1));
    if (OP == kRAdam) {
      // rho_t = rho_inf - 2 t b2^t / bc2, left to right as the reference
      const double rho_t = __dsub_rn(
          h.rho_inf, __ddiv_rn(__dmul_rn(__dmul_rn(2.0, t), bt2), bc2));
      s.rectify = rho_t > 5.0;
      const double num = __dmul_rn(
          __dmul_rn(__dsub_rn(rho_t, 4.0), __dsub_rn(rho_t, 2.0)),
          h.rho_inf);
      double den = __dmul_rn(__dmul_rn(__dsub_rn(h.rho_inf, 4.0),
                                       __dsub_rn(h.rho_inf, 2.0)), rho_t);
      den = den < 1e-12 ? 1e-12 : den;
      const double q = __ddiv_rn(num, den);
      s.rect = static_cast<float>(__dsqrt_rn(q < 0.0 ? 0.0 : q));
    }
  }
  if (OP == kAsgd) s.step = *step_p;
  return s;
}

// Lamb's r from p, g and the old moments; a and b become the new moments
__device__ __forceinline__ float lamb_r(float p, float g, float& a,
                                        float& b, const Scalars& s,
                                        const Hyper& h, bool decay) {
  a = fadd(fmul(h.b1, a), fmul(h.omb1, g));
  b = fadd(fmul(h.b2, b), fmul(fmul(h.omb2, g), g));
  float r = fdiv(fdiv(a, s.bc1), fadd(fsqrt(fdiv(b, s.bc2)), h.eps));
  if (decay) r = fadd(r, fmul(h.coeff, p));
  return r;
}

template <int OP>
__device__ __forceinline__ void update(float& p, float g, float& a,
                                       float& b, float& c, const Scalars& s,
                                       const Hyper& h, bool decay) {
  if (OP == kSgd) {
    p = fsub(p, fmul(s.lr, g));
  } else if (OP == kAdam) {
    if (decay) p = fmul(p, s.keep);
    a = fadd(fmul(a, h.b1), fmul(g, h.omb1));
    b = fadd(fmul(b, h.b2), fmul(fmul(g, g), h.omb2));
    const float den = fadd(fsqrt(fdiv(b, s.bc2)), h.eps);
    p = fsub(p, fdiv(fmul(s.lr, fdiv(a, s.bc1)), den));
  } else if (OP == kMomentum) {
    a = fadd(fmul(h.mu, a), g);
    const float d = h.nesterov ? fadd(g, fmul(h.mu, a)) : a;
    p = fsub(p, fmul(s.lr, d));
  } else if (OP == kAdagrad) {
    a = fadd(a, fmul(g, g));
    p = fsub(p, fdiv(fmul(s.lr, g), fadd(fsqrt(a), h.eps)));
  } else if (OP == kAdamax) {
    a = fadd(fmul(h.b1, a), fmul(h.omb1, g));
    b = fmaxf(fmul(h.b2, b), fabsf(g));
    p = fsub(p, fdiv(fmul(s.lr_bc, a), fadd(b, h.eps)));
  } else if (OP == kRmsProp || OP == kRmsPropCentered) {
    a = fadd(fmul(h.b1, a), fmul(fmul(h.omb1, g), g));
    float den;
    if (OP == kRmsPropCentered) {
      c = fadd(fmul(h.b1, c), fmul(h.omb1, g));
      den = fsqrt(fadd(fsub(a, fmul(c, c)), h.eps));
    } else {
      den = fsqrt(fadd(a, h.eps));
    }
    b = fadd(fmul(h.mu, b), fdiv(fmul(s.lr, g), den));
    p = fsub(p, b);
  } else if (OP == kAdadelta) {
    a = fadd(fmul(h.b1, a), fmul(fmul(h.omb1, g), g));
    const float dx = fmul(fdiv(fsqrt(fadd(b, h.eps)), fsqrt(fadd(a, h.eps))),
                          g);
    b = fadd(fmul(h.b1, b), fmul(fmul(h.omb1, dx), dx));
    p = fsub(p, fmul(s.lr, dx));
  } else if (OP == kRprop) {
    const float sg = sign_of(fmul(g, a));
    float sz = sg > 0.f ? fmul(b, h.eta_plus)
                        : (sg < 0.f ? fmul(b, h.eta_minus) : b);
    sz = fminf(fmaxf(sz, h.lo), h.hi);
    const float g2 = sg < 0.f ? 0.f : g;
    p = fsub(p, fmul(sign_of(g2), sz));
    a = g2;
    b = sz;
  } else if (OP == kNAdam) {
    a = fadd(fmul(h.b1, a), fmul(h.omb1, g));
    b = fadd(fmul(h.b2, b), fmul(fmul(h.omb2, g), g));
    const float mh = fadd(fdiv(fmul(h.b1, a), s.bc1),
                          fdiv(fmul(h.omb1, g), s.bc1));
    p = fsub(p, fdiv(fmul(s.lr, mh), fadd(fsqrt(fdiv(b, s.bc2)), h.eps)));
  } else if (OP == kRAdam) {
    a = fadd(fmul(h.b1, a), fmul(h.omb1, g));
    b = fadd(fmul(h.b2, b), fmul(fmul(h.omb2, g), g));
    const float r =
        s.rectify
            ? fmul(s.rect, fdiv(1.f, fsqrt(fadd(fdiv(b, s.bc2), h.eps2))))
            : 1.f;
    p = fsub(p, fmul(fmul(s.lr, fdiv(a, s.bc1)), r));
  } else if (OP == kAsgd) {
    p = fsub(p, fmul(s.lr, g));
    a = fadd(a, fdiv(fsub(p, a), s.step));
  } else if (OP == kLamb) {
    const float r = lamb_r(p, g, a, b, s, h, decay);
    p = fsub(p, fmul(s.lr_trust, r));
  }
}

// The block's chunk: the tensor t with prefix[t] <= chunk < prefix[t + 1],
// and the chunk's first and past-the-end elements.
__device__ __forceinline__ int find_tensor(const int64_t* prefix,
                                           int n_tensors, int64_t chunk) {
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int OP>
__device__ __forceinline__ bool aligned(const Entry& e) {
  int64_t a = e.p | e.g;
  if (n_states(OP) >= 1) a |= e.m1;
  if (n_states(OP) >= 2) a |= e.m2;
  if (n_states(OP) >= 3) a |= e.m3;
  return (a & 15) == 0;
}

// Walks the block's chunk 8 elements a thread at a time (16-byte loads
// where aligned, then the tail element by element) and calls
// body(p, g, a, b, c) on each element's values, f32; where STORE, writes p
// and the rule's states back, each rounded once.
template <int OP, bool STORE, typename P, typename M, typename Body>
__device__ __forceinline__ void walk_chunk(const Entry& e, int64_t begin,
                                           int64_t end, Body body) {
  constexpr int NS = n_states(OP);
  P* p = reinterpret_cast<P*>(e.p);
  const P* g = reinterpret_cast<const P*>(e.g);
  M* m1 = reinterpret_cast<M*>(e.m1);
  M* m2 = reinterpret_cast<M*>(e.m2);
  M* m3 = reinterpret_cast<M*>(e.m3);
  const int64_t groups = aligned<OP>(e) ? (end - begin) / kVec : 0;

  for (int64_t j0 = threadIdx.x; j0 < groups;
       j0 += int64_t(kThreads) * kUnroll) {
    Raw<P> rp[kUnroll], rg[kUnroll];
    Raw<M> ra[kUnroll], rb[kUnroll], rc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + int64_t(u) * kThreads;
      if (j < groups) {
        const int64_t i = begin + j * kVec;
        load_raw(p + i, rp[u]);
        load_raw(g + i, rg[u]);
        if (NS >= 1) load_raw(m1 + i, ra[u]);
        if (NS >= 2) load_raw(m2 + i, rb[u]);
        if (NS >= 3) load_raw(m3 + i, rc[u]);
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
          float av = 0.f, bv = 0.f, cv = 0.f;
          if (NS >= 1) av = raw_get(ra[u], k);
          if (NS >= 2) bv = raw_get(rb[u], k);
          if (NS >= 3) cv = raw_get(rc[u], k);
          body(pv, raw_get(rg[u], k), av, bv, cv);
          if (STORE) {
            raw_set(rp[u], k, pv);
            if (NS >= 1) raw_set(ra[u], k, av);
            if (NS >= 2) raw_set(rb[u], k, bv);
            if (NS >= 3) raw_set(rc[u], k, cv);
          }
        }
        if (STORE) {
          store_raw(p + i, rp[u]);
          if (NS >= 1) store_raw(m1 + i, ra[u]);
          if (NS >= 2) store_raw(m2 + i, rb[u]);
          if (NS >= 3) store_raw(m3 + i, rc[u]);
        }
      }
    }
  }
  // the chunk's tail (the whole chunk where the addresses are unaligned)
  for (int64_t i = begin + groups * kVec + threadIdx.x; i < end;
       i += kThreads) {
    float pv = to_f<P>(p[i]);
    float av = 0.f, bv = 0.f, cv = 0.f;
    if (NS >= 1) av = to_f<M>(m1[i]);
    if (NS >= 2) bv = to_f<M>(m2[i]);
    if (NS >= 3) cv = to_f<M>(m3[i]);
    body(pv, to_f<P>(g[i]), av, bv, cv);
    if (STORE) {
      p[i] = from_f<P>(pv);
      if (NS >= 1) m1[i] = from_f<M>(av);
      if (NS >= 2) m2[i] = from_f<M>(bv);
      if (NS >= 3) m3[i] = from_f<M>(cv);
    }
  }
}

// Lamb's trust ratio for tensor t: its chunks' partial sums of p^2 and r^2
// summed in a fixed order (a strided f64 sum a thread, then a fixed tree),
// norms in f64 rounded to f32, ||p|| / ||r|| where both are > 0, else 1.
__device__ float lamb_trust(const float2* partials, int64_t first,
                            int64_t last) {
  __shared__ double sp[kThreads], sr[kThreads];
  double ap = 0.0, ar = 0.0;
  for (int64_t c = first + threadIdx.x; c < last; c += kThreads) {
    const float2 v = partials[c];
    ap += static_cast<double>(v.x);
    ar += static_cast<double>(v.y);
  }
  sp[threadIdx.x] = ap;
  sr[threadIdx.x] = ar;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) {
      sp[threadIdx.x] += sp[threadIdx.x + w];
      sr[threadIdx.x] += sr[threadIdx.x + w];
    }
    __syncthreads();
  }
  const float wn = static_cast<float>(sqrt(sp[0]));
  const float rn = static_cast<float>(sqrt(sr[0]));
  return (wn > 0.f && rn > 0.f) ? fdiv(wn, rn) : 1.f;
}

template <int OP, typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    fused_update_kernel(const Entry* __restrict__ table,
                        const int64_t* __restrict__ prefix, int n_tensors,
                        const float* __restrict__ lr_p,
                        const float* __restrict__ step_p,
                        const float* __restrict__ skip_p,
                        const float2* __restrict__ partials, Hyper h) {
  if (skip_p != nullptr && *skip_p != 0.f) return;
  const int64_t chunk = blockIdx.x;
  const int t = find_tensor(prefix, n_tensors, chunk);
  const Entry e = table[t];
  const int64_t begin = (chunk - prefix[t]) * kChunk;
  const int64_t end = begin + kChunk < e.numel ? begin + kChunk : e.numel;
  const bool decay = e.decay != 0;
  Scalars s = make_scalars<OP>(lr_p, step_p, h);
  if constexpr (OP == kLamb)
    s.lr_trust = fmul(s.lr, lamb_trust(partials, prefix[t], prefix[t + 1]));
  walk_chunk<OP, true, P, M>(
      e, begin, end, [&](float& pv, float gv, float& av, float& bv,
                         float& cv) {
        update<OP>(pv, gv, av, bv, cv, s, h, decay);
      });
}

// Lamb's first pass: the chunk's sums of p^2 and r^2 into partials[chunk]
// (per-thread f32 sums, then a fixed tree); nothing else is written.
template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    fused_update_lamb_norms_kernel(const Entry* __restrict__ table,
                                   const int64_t* __restrict__ prefix,
                                   int n_tensors,
                                   const float* __restrict__ lr_p,
                                   const float* __restrict__ step_p,
                                   const float* __restrict__ skip_p,
                                   float2* __restrict__ partials, Hyper h) {
  if (skip_p != nullptr && *skip_p != 0.f) return;
  const int64_t chunk = blockIdx.x;
  const int t = find_tensor(prefix, n_tensors, chunk);
  const Entry e = table[t];
  const int64_t begin = (chunk - prefix[t]) * kChunk;
  const int64_t end = begin + kChunk < e.numel ? begin + kChunk : e.numel;
  const bool decay = e.decay != 0;
  const Scalars s = make_scalars<kLambNorms>(lr_p, step_p, h);
  float sp = 0.f, sr = 0.f;
  walk_chunk<kLamb, false, P, M>(
      e, begin, end, [&](float& pv, float gv, float& av, float& bv,
                         float&) {
        const float r = lamb_r(pv, gv, av, bv, s, h, decay);
        sp = fadd(sp, fmul(pv, pv));
        sr = fadd(sr, fmul(r, r));
      });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sp = fadd(sp, __shfl_down_sync(0xffffffffu, sp, off));
    sr = fadd(sr, __shfl_down_sync(0xffffffffu, sr, off));
  }
  __shared__ float wp[kThreads / 32], wr[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wp[warp] = sp;
    wr[warp] = sr;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tp = 0.f, tr = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      tp = fadd(tp, wp[w]);
      tr = fadd(tr, wr[w]);
    }
    partials[chunk] = make_float2(tp, tr);
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

struct Launch {
  const Entry* table;
  const int64_t* prefix;
  int n_tensors;
  unsigned n_chunks;
  const float *lr, *step, *skip;
  float2* partials;
  Hyper h;
  cudaStream_t stream;
};

template <int OP, typename P, typename M>
cudaError_t launch(const Launch& a) {
  if constexpr (OP == kLamb) {
    fused_update_lamb_norms_kernel<P, M>
        <<<dim3(a.n_chunks), kThreads, 0, a.stream>>>(
            a.table, a.prefix, a.n_tensors, a.lr, a.step, a.skip,
            a.partials, a.h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fused_update_kernel<OP, P, M><<<dim3(a.n_chunks), kThreads, 0, a.stream>>>(
      a.table, a.prefix, a.n_tensors, a.lr, a.step, a.skip, a.partials, a.h);
  return cudaGetLastError();
}

// the (p, state) dtype groups: 0 float32, 1 float16, 2 bfloat16
template <int OP>
cudaError_t launch_group(const Launch& a, int p_dtype, int m_dtype) {
  if constexpr (OP == kSgd) {
    switch (p_dtype) {
      case 0: return launch<OP, float, float>(a);
      case 1: return launch<OP, __half, __half>(a);
      case 2: return launch<OP, __nv_bfloat16, __nv_bfloat16>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (p_dtype * 3 + m_dtype) {
    case 0 * 3 + 0: return launch<OP, float, float>(a);
    case 1 * 3 + 1: return launch<OP, __half, __half>(a);
    case 2 * 3 + 2: return launch<OP, __nv_bfloat16, __nv_bfloat16>(a);
    case 1 * 3 + 0: return launch<OP, __half, float>(a);
    case 2 * 3 + 0: return launch<OP, __nv_bfloat16, float>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements a chunk (a thread block), and grad addresses a set_grads call.
long long fused_update_chunk() { return kChunk; }
int fused_update_max_patch() { return kMaxPatch; }
// Bytes of one table entry (int64 p, g, m1, m2, m3, numel, decay) and of
// the constants.
int fused_update_entry_bytes() { return sizeof(Entry); }
int fused_update_hyper_bytes() { return sizeof(Hyper); }

const char* fused_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table: n_tensors Entries on the device; prefix: n_tensors + 1 int64
// chunk counts (prefix[0] = 0, prefix[n] = n_chunks); lr, step: 0-dim f32
// on the device; skip: a 0-dim f32 on the device (nonzero: leave every
// tensor as it is) or null; partials: n_chunks float2 on the device for
// Lamb (its first pass's sums), else ignored.  op: an Op above (AdamW:
// Adam with decay flags and coeff; Lamb: two launches).  p_dtype (of p
// and g) and m_dtype (of the states): 0 float32, 1 float16, 2 bfloat16;
// the groups are (f32, f32), (f16, f16), (bf16, bf16), (f16, f32), (bf16,
// f32), and SGD ignores m_dtype.  h: the rule's constants (host memory).
// Returns cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for another group or op, or a grid past 2^31 - 1
// blocks.
int fused_update(const void* table, const void* prefix, int n_tensors,
                 long long n_chunks, const void* lr, const void* step,
                 const void* skip, void* partials, int op, int p_dtype,
                 int m_dtype, const void* hyper, void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffffLL || n_tensors <= 0)
    return cudaErrorInvalidValue;
  if (op == kLamb && partials == nullptr) return cudaErrorInvalidValue;
  const Launch a{static_cast<const Entry*>(table),
                 static_cast<const int64_t*>(prefix),
                 n_tensors,
                 static_cast<unsigned>(n_chunks),
                 static_cast<const float*>(lr),
                 static_cast<const float*>(step),
                 static_cast<const float*>(skip),
                 static_cast<float2*>(partials),
                 *static_cast<const Hyper*>(hyper),
                 static_cast<cudaStream_t>(stream)};
  switch (op) {
    case kSgd: return launch_group<kSgd>(a, p_dtype, m_dtype);
    case kAdam: return launch_group<kAdam>(a, p_dtype, m_dtype);
    case kMomentum: return launch_group<kMomentum>(a, p_dtype, m_dtype);
    case kAdagrad: return launch_group<kAdagrad>(a, p_dtype, m_dtype);
    case kAdamax: return launch_group<kAdamax>(a, p_dtype, m_dtype);
    case kRmsProp: return launch_group<kRmsProp>(a, p_dtype, m_dtype);
    case kRmsPropCentered:
      return launch_group<kRmsPropCentered>(a, p_dtype, m_dtype);
    case kAdadelta: return launch_group<kAdadelta>(a, p_dtype, m_dtype);
    case kRprop: return launch_group<kRprop>(a, p_dtype, m_dtype);
    case kNAdam: return launch_group<kNAdam>(a, p_dtype, m_dtype);
    case kRAdam: return launch_group<kRAdam>(a, p_dtype, m_dtype);
    case kAsgd: return launch_group<kAsgd>(a, p_dtype, m_dtype);
    case kLamb: return launch_group<kLamb>(a, p_dtype, m_dtype);
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
