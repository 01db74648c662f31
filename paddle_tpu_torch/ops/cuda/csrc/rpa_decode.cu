// Ragged paged attention, decode step (one query token per sequence), for
// Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/attention.py
// `_rpa_decode_kernel` and `_rpa_decode_kernel_quant` (online-softmax body
// `_rpa_decode_core`), reached through `ragged_paged_attention_decode`:
// entry points `rpa_decode` (pools in q's type) and `rpa_decode_quant`
// (int8 code pools with one f32 scale per (token, kv head) in
// (pages, page, Hkv, 1) scale pools, dequantized as code x scale in f32).
//
// What it computes, for each sequence b and query head h (kv head
// h / (H / Hkv)):
//   out[b, h] = softmax(scale * q[b, h] . K[b, :len_b]) @ V[b, :len_b]
// where token p of sequence b lives at page block_tables[b, p / page],
// offset p % page, of the pooled K/V arrays (num_pages, page, Hkv, D).
// Arithmetic is f32 throughout; positions >= len get probability 0 (they
// are never read); len == 0 (an inert batch slot) writes exact zeros.
//
// Bound: device-memory bytes.  Each K/V element (2 bytes in bf16; 1 byte
// and a share of its row's 4-byte scale in int8) is read once and used for
// 2 * (H / Hkv) flops: 1 flop a byte for multi-head attention, at most 8
// for 8 query heads a kv head, far below the ~295 flops a byte where the
// H100's tensor cores would become the limit.  So there are no tensor-core
// products here; what the design buys is bytes in flight:
//
// - Split-KV (flash-decoding).  A block walks one split of kPagesPerSplit
//   pages of one sequence at a time, so a long sequence is read by many
//   SMs at once instead of by one block tile after tile.  The grid is (kv
//   heads x head blocks, B + R): block rows 0..B-1 take each sequence's
//   first split; the R rows after them take the later splits of all
//   sequences, packed in sequence order, grid-stride (a block finds each
//   of its pairs by a scan of the lengths).  The host knows only the
//   table's width (it never reads the lengths), so R is the number of
//   later splits a full table would have, capped at kLaterPerSm blocks an
//   SM: the blocks with work are launched first, and however wide the
//   tables (the engine pads them to its longest context) the blocks that
//   find no pair stay few.  A sequence that fits one split writes its
//   output directly.
//   Otherwise each split writes its partial (max, sum, unnormalised
//   output) in f32 to a workspace, and the last block of the (sequence,
//   kv head) to finish (an atomic ticket taken after __threadfence) merges
//   the partials in split order, so reruns are bitwise equal, writes the
//   output and resets its counter to 0 for the next launch: one launch a
//   call, no memset.
// - An asynchronous page ring.  The block first reads its split's block
//   table entries into shared memory, then keeps kStages - 1 stages of 16
//   tokens of K and V in flight, in the pool's own type, while it computes
//   on the oldest: TMA boxes (D, 1, 16) of a 3-D tensor map over the pool
//   (D, Hkv, pages x page) completing on mbarriers where the page size is a
//   multiple of 16 and rows are 16-byte multiples, else 16-byte cp.async
//   copies, else (rows not a multiple of 16 bytes) plain loads.  The int8
//   scales, strided by Hkv x 4 bytes, come by 4-byte cp.async into the same
//   stage.  One __syncthreads a stage frees the stage just consumed.
// - Math in registers.  Each warp takes 4 of a stage's 16 tokens with its
//   own online softmax (max, sum, accumulator of the block's query heads),
//   lanes splitting D in 4-element quads widened to f32 at use; the four
//   warps' states are merged in warp order at the end.  Query heads beyond
//   8 a kv head go to further blocks (head blocks), which re-read K/V.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "flash_sm90.cuh"

namespace {

using flash::sm90::smem_u32;

constexpr int kThreads = 128;              // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 16;                   // tokens a stage
constexpr int kTpw = kTok / kWarps;        // tokens a warp a stage
constexpr int kStages = 4;                 // ring depth
constexpr int kMaxGroups = 8;              // query heads a block at most
// pages a split (8 measured fastest of 2, 4, 8, 16 and 32 at the serving
// shape, PERF.md; at most kThreads)
constexpr int kPagesPerSplit = 8;
// blocks of later-split rows an SM at most (R above; 32 measured fastest
// of 4, 8, 16, 32 and 64, PERF.md)
constexpr int kLaterPerSm = 32;
constexpr float kBigNeg = -1e30f;

// loaders of the K/V tiles
constexpr int kPlain = 0, kCpAsync = 1, kTma = 2;

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

// four consecutive shared-memory elements (4-element aligned) as f32
__device__ __forceinline__ void load_quad(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p,
                                          float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void load_quad(const __half* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void load_quad(const int8_t* p, float (&x)[4]) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  x[0] = float(v.x), x[1] = float(v.y), x[2] = float(v.z), x[3] = float(v.w);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One TMA box of the 3-D pool map at (column c0, kv head c1, row c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// -- shared memory: [ring | warp-merge scratch] (one reused as the other),
// then the stages' scales, the mbarriers, the split's table, a flag and
// the later splits' scan.
__host__ __device__ inline int row_elems(int d) { return (d + 3) & ~3; }

__host__ __device__ inline size_t tile_bytes(int d, int elt) {
  return (size_t(kTok) * row_elems(d) * elt + 127) / 128 * 128;
}

__host__ __device__ inline size_t head_bytes(int gb, int d, int elt) {
  const size_t ring = size_t(kStages) * 2 * tile_bytes(d, elt);
  const size_t merge =
      sizeof(float) * size_t(kWarps) * gb * (row_elems(d) + 2);
  return (ring > merge ? ring : merge) + sizeof(float) * kStages * 2 * kTok +
         sizeof(uint64_t) * kStages;
}

__host__ __device__ inline size_t smem_bytes(int gb, int d, int elt) {
  return head_bytes(gb, d, elt) +
         sizeof(int) * (kPagesPerSplit + 1 + kWarps + 2);
}

__device__ __forceinline__ int splits_of(int len, int max_tokens,
                                         int split_tokens) {
  const int n = max(0, min(len, max_tokens));
  return max(1, (n + split_tokens - 1) / split_tokens);
}

// The (sequence, split) of the k-th later split (past each sequence's
// first) of all sequences, in sequence order; scan[] is kWarps + 2 ints
// of shared memory.  Returns false (for the whole block) past the last.
__device__ bool later_split(const int* lens, int batch, int k,
                            int max_tokens, int split_tokens, int* scan,
                            int* b, int* sp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (batch + kThreads - 1) / kThreads;  // sequences a thread
  const int first = tid * per;
  int cnt = 0;
  for (int i = 0; i < per && first + i < batch; ++i)
    cnt += splits_of(lens[first + i], max_tokens, split_tokens) - 1;
  int incl = cnt;  // inclusive scan: in the warp, then across warps
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += scan[w];
  if (k >= incl - cnt && k < incl) {
    int at = incl - cnt;
    for (int i = 0; i < per && first + i < batch; ++i) {
      const int n = splits_of(lens[first + i], max_tokens, split_tokens) - 1;
      if (k < at + n) {
        scan[kWarps] = first + i;
        scan[kWarps + 1] = 1 + k - at;
        break;
      }
      at += n;
    }
  }
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += scan[w];
  __syncthreads();
  if (k >= total) return false;
  *b = scan[kWarps];
  *sp = scan[kWarps + 1];
  return true;
}

// Order this thread's generic-proxy accesses of shared memory before later
// TMA writes to it (a block's next split reuses its merge scratch as ring)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

struct alignas(64) Params {
  CUtensorMap kmap, vmap;  // read with loader == kTma only
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 pools: scales (num_pages, page, Hkv, 1)
  const float* vs;
  const int* tables;
  const int* lens;
  void* out;
  float* ws_acc;  // (B, H, splits, D) partial outputs, splits > 1 only
  float* ws_ml;   // (B, H, splits, 2) partial max (base 2) and sum
  int* counters;  // (B, gridDim.x) finished splits; 0 between launches
  int batch, heads, kv_heads, d, page, max_pages, splits;
  int head_blocks, loader;
  float scale;
};

// One split `sp` of sequence `b` for the block's kv head and head block:
// its tokens through the ring into an online softmax, then the output (a
// sequence of one split) or the partial, and the merge if this block is
// the split to finish last.  `stages`: the stages the block consumed
// before, which sets the mbarriers' phases.
template <typename T, typename P, int GB, int QPL>
__device__ __forceinline__ void run_split(const Params& a, int b, int sp,
                                          int& stages) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hb = blockIdx.x % a.head_blocks;
  const int kvh = blockIdx.x / a.head_blocks;
  const int groups = a.heads / a.kv_heads;
  const int g0 = hb * GB;
  const int gcount = min(GB, groups - g0);
  const int split_tokens = kPagesPerSplit * a.page;
  const int max_tokens = a.max_pages * a.page;

  extern __shared__ __align__(128) unsigned char smem[];
  const size_t hbytes = head_bytes(GB, a.d, sizeof(P));
  int* tbl = reinterpret_cast<int*>(smem + hbytes);  // kPagesPerSplit
  int* last = tbl + kPagesPerSplit;

  const int page0 = sp * kPagesPerSplit;
  // the split's table entries (kPagesPerSplit <= kThreads) are read beside
  // the length, not after it: one dependent load less before the first
  // page's; entries past the length are read (inside the table), not used
  const int* table = a.tables + size_t(b) * a.max_pages + page0;
  const int entry =
      tid < min(kPagesPerSplit, a.max_pages - page0) ? table[tid] : 0;
  // the table holds max_pages pages: a longer length reads no further
  const int len = max(0, min(a.lens[b], max_tokens));
  const int nsplit = splits_of(len, max_tokens, split_tokens);
  const int t_begin = sp * split_tokens;
  const int ntok = min(len, t_begin + split_tokens) - t_begin;  // >= 0
  const int nst = (ntok + kTok - 1) / kTok;
  const int d = a.d;
  const int dp = row_elems(d);
  // scores in base 2: exp(x) = exp2(x log2(e)), and exp2f is the cheaper
  const float scale2 = a.scale * 1.4426950408889634f;

  const size_t tb = tile_bytes(d, sizeof(P));
  float* scl = reinterpret_cast<float*>(
      smem + hbytes - sizeof(uint64_t) * kStages -
      sizeof(float) * kStages * 2 * kTok);        // [kStages][2][kTok]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + hbytes - sizeof(uint64_t) * kStages);  // TMA: one a slot

  if (tid < kPagesPerSplit) tbl[tid] = entry;
  if (a.loader == kTma && stages > 0) fence_proxy_async();

  // the block's query heads, in registers as f32: lane owns columns
  // qp * 128 + lane * 4 + [0, 4)
  float qr[GB][QPL][4];
  const T* qg = static_cast<const T*>(a.q) +
                (size_t(b) * a.heads + size_t(kvh) * groups + g0) * d;
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int qp = 0; qp < QPL; ++qp)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = qp * 128 + lane * 4 + e;
        qr[g][qp][e] = (g < gcount && c < d) ? to_f32(qg[g * d + c]) : 0.f;
      }
  __syncthreads();  // the table (and, at the block's first split, the
                    // barriers)

  const P* kpool = static_cast<const P*>(a.k);
  const P* vpool = static_cast<const P*>(a.v);
  auto pool_row = [&](int p) -> long long {  // p: token of the sequence
    const int pg = tbl[p / a.page - page0];
    return (static_cast<long long>(pg) * a.page + p % a.page) * a.kv_heads +
           kvh;
  };
  auto tile = [&](int slot, int which) -> P* {
    return reinterpret_cast<P*>(smem + (size_t(slot) * 2 + which) * tb);
  };

  // start loading stage j (tokens t_begin + j * kTok ...) into its slot
  auto issue = [&](int j) {
    const int slot = (stages + j) % kStages;
    const int t0 = t_begin + j * kTok;
    const int n = min(kTok, t_begin + ntok - t0);
    P* kd = tile(slot, 0);
    P* vd = tile(slot, 1);
    if (a.loader == kTma) {
      // page % kTok == 0: the stage lies in one page
      if (tid == 0) {
        const int row = static_cast<int>(pool_row(t0) / a.kv_heads);
        flash::sm90::mbar_arrive_tx(&full[slot],
                                    uint32_t(2 * kTok * d * sizeof(P)));
        tma_load_3d(kd, &a.kmap, &full[slot], 0, kvh, row);
        tma_load_3d(vd, &a.vmap, &full[slot], 0, kvh, row);
      }
    } else if (a.loader == kCpAsync) {
      constexpr int kVec = 16 / int(sizeof(P));
      const int cpr = d / kVec;  // 16-byte chunks a row
      const int per = n * cpr;
      for (int i = tid; i < 2 * per; i += kThreads) {
        const int which = i >= per;
        const int ii = i - which * per;
        const int r = ii / cpr;
        const int c = (ii - r * cpr) * kVec;
        const P* src = (which ? vpool : kpool) + pool_row(t0 + r) * d + c;
        cp_async16((which ? vd : kd) + r * dp + c, src);
      }
    } else {
      const int per = n * dp;
      for (int i = tid; i < 2 * per; i += kThreads) {
        const int which = i >= per;
        const int ii = i - which * per;
        const int r = ii / dp;
        const int c = ii - r * dp;
        P x;  // columns past D are zeros
        memset(&x, 0, sizeof(P));
        if (c < d) x = ((which ? vpool : kpool) + pool_row(t0 + r) * d)[c];
        (which ? vd : kd)[r * dp + c] = x;
      }
    }
    if (kQuant && tid < 2 * n) {
      const int which = tid >= n;
      const int r = tid - which * n;
      cp_async4(scl + (slot * 2 + which) * kTok + r,
                (which ? a.vs : a.ks) + pool_row(t0 + r));
    }
  };

  float m[GB], l[GB], acc[GB][QPL][4];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kBigNeg;
    l[g] = 0.f;
#pragma unroll
    for (int qp = 0; qp < QPL; ++qp)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][qp][e] = 0.f;
  }

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nst) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < nst; ++j) {
    const int slot = (stages + j) % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of stage j
    __syncthreads();  // everyone's copies; stage j - 1 consumed by all
    if (j + kStages - 1 < nst) issue(j + kStages - 1);
    cp_async_commit();
    if (a.loader == kTma)
      flash::sm90::mbar_wait_or_trap(&full[slot],
                                     ((stages + j) / kStages) & 1);

    const int n = min(kTok, ntok - j * kTok);
    const P* kt = tile(slot, 0);
    const P* vt = tile(slot, 1);
    const float* ksc = scl + slot * 2 * kTok;
    const float* vsc = ksc + kTok;
    float s[kTpw][GB];
#pragma unroll
    for (int i = 0; i < kTpw; ++i) {
      const int r = warp * kTpw + i;
      float part[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) part[g] = 0.f;
      if (r < n) {  // warp-uniform
#pragma unroll
        for (int qp = 0; qp < QPL; ++qp) {
          const int c = qp * 128 + lane * 4;
          if (c < dp) {
            float kx[4];
            load_quad(kt + r * dp + c, kx);
#pragma unroll
            for (int g = 0; g < GB; ++g)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                part[g] = fmaf(qr[g][qp][e], kx[e], part[g]);
          }
        }
      }
      const float rs = kQuant && r < n ? ksc[r] : 1.f;
#pragma unroll
      for (int g = 0; g < GB; ++g)
        s[i][g] = r < n ? warp_sum(part[g]) * rs * scale2 : kBigNeg;
    }
    // online softmax over this warp's tokens, then P . V
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int i = 0; i < kTpw; ++i) mx = fmaxf(mx, s[i][g]);
      const float alpha = exp2f(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kTpw; ++i) {
        const float p = warp * kTpw + i < n ? exp2f(s[i][g] - mx) : 0.f;
        s[i][g] = p;
        psum += p;
      }
      l[g] = fmaf(l[g], alpha, psum);
      m[g] = mx;
#pragma unroll
      for (int qp = 0; qp < QPL; ++qp)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][qp][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kTpw; ++i) {
      const int r = warp * kTpw + i;
      if (r < n) {  // warp-uniform
        const float rs = kQuant ? vsc[r] : 1.f;
#pragma unroll
        for (int qp = 0; qp < QPL; ++qp) {
          const int c = qp * 128 + lane * 4;
          if (c < dp) {
            float vx[4];
            load_quad(vt + r * dp + c, vx);
#pragma unroll
            for (int g = 0; g < GB; ++g) {
              const float p = s[i][g] * rs;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[g][qp][e] = fmaf(p, vx[e], acc[g][qp][e]);
            }
          }
        }
      }
    }
  }
  stages += nst;

  // merge the four warps' states, in warp order
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: reuse it as scratch
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][GB]
  float* wl = wm + kWarps * GB;                 // [kWarps][GB]
  float* wa = wl + kWarps * GB;                 // [kWarps][GB][dp]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      wm[warp * GB + g] = m[g];
      wl[warp * GB + g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int qp = 0; qp < QPL; ++qp) {
      const int c = qp * 128 + lane * 4;
      if (c < dp)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wa[(warp * GB + g) * dp + c + e] = acc[g][qp][e];
    }
  __syncthreads();

  const int h0 = kvh * groups + g0;
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < gcount * d; i += kThreads) {
    const int g = i / d;
    const int c = i - g * d;
    float mx = kBigNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * GB + g]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * GB + g] - mx);
      sum = fmaf(f, wl[w * GB + g], sum);
      o = fmaf(f, wa[(w * GB + g) * dp + c], o);
    }
    const size_t row = size_t(b) * a.heads + h0 + g;
    if (nsplit == 1) {
      out[row * d + c] = from_f32<T>(o / (sum > 0.f ? sum : 1.f));
    } else {
      const size_t part = row * a.splits + sp;
      a.ws_acc[part * d + c] = o;
      if (c == 0) {
        a.ws_ml[part * 2] = mx;
        a.ws_ml[part * 2 + 1] = sum;
      }
    }
  }
  if (nsplit == 1) return;

  // the last split of this (sequence, head block) to finish merges
  __threadfence();
  __syncthreads();
  int* counter = a.counters + size_t(b) * gridDim.x + blockIdx.x;
  if (tid == 0) *last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < gcount * d; i += kThreads) {
    const int g = i / d;
    const int c = i - g * d;
    const size_t part = (size_t(b) * a.heads + h0 + g) * a.splits;
    // one pass, in split order (unrolled so that the loads go out together)
    float mx = kBigNeg, sum = 0.f, o = 0.f;
#pragma unroll 4
    for (int t = 0; t < nsplit; ++t) {
      const float mt = __ldcg(a.ws_ml + (part + t) * 2);
      const float lt = __ldcg(a.ws_ml + (part + t) * 2 + 1);
      const float at = __ldcg(a.ws_acc + (part + t) * d + c);
      const float mn = fmaxf(mx, mt);
      const float f0 = exp2f(mx - mn), f1 = exp2f(mt - mn);
      sum = fmaf(sum, f0, lt * f1);
      o = fmaf(o, f0, at * f1);
      mx = mn;
    }
    out[(size_t(b) * a.heads + h0 + g) * d + c] =
        from_f32<T>(o / (sum > 0.f ? sum : 1.f));
  }
  if (tid == 0) *counter = 0;
}

// T: q and out; P: the pools (T, or int8_t codes with f32 scale pools);
// GB: query heads a block (a power of 2 up to 8); QPL: quads a lane (D up
// to 128 or 256).  Block row y < B is sequence y's first split.  The
// later splits of all sequences (past each one's first) are packed in
// sequence order, and the R = gridDim.y - B rows after the first ones
// take pairs y - B, y - B + R, ... of them, each found by a scan of the
// lengths: the blocks with work are launched before those that have
// none, and R stays below kLaterPerSm blocks an SM however wide the
// tables are.  Blocks an SM at least (__launch_bounds__): 6 for one or
// two heads at D <= 128, what shared memory allows a 16-bit pool there
// (without it ptxas took 92-102 registers, 5 blocks, and the serving
// shape ran 20 % slower); else 1 (a higher minimum made ptxas spill 8
// bytes in the 4-head, D <= 128 instantiations to stay at 96 registers).
template <typename T, typename P, int GB, int QPL>
__global__ void __launch_bounds__(kThreads, GB <= 2 && QPL == 1 ? 6 : 1)
    rpa_decode_kernel(const __grid_constant__ Params a) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t hbytes = head_bytes(GB, a.d, sizeof(P));
  int* scan = reinterpret_cast<int*>(smem + hbytes) + kPagesPerSplit + 1;
  if (a.loader == kTma && tid == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(
        smem + hbytes - sizeof(uint64_t) * kStages);
    for (int s = 0; s < kStages; ++s) flash::sm90::mbar_init(&full[s], 1);
    flash::sm90::fence_barrier_init();
  }
  const int split_tokens = kPagesPerSplit * a.page;
  const int max_tokens = a.max_pages * a.page;
  int stages = 0;
  int b = blockIdx.y, sp = 0;
  // one call site of run_split (two would inline its body twice); no
  // state but k lives across it; a block leaves without a further scan
  // once k passes the later splits a full table would have
  const int most = a.batch * (a.splits - 1);
  for (int k = b - a.batch; k < most; k += gridDim.y - a.batch) {
    if (k >= 0 && !later_split(a.lens, a.batch, k, max_tokens, split_tokens,
                               scan, &b, &sp))
      return;
    run_split<T, P, GB, QPL>(a, b, sp, stages);
    if (k < 0) return;
  }
}

// -- host -------------------------------------------------------------------

// GB: the power of 2 that holds the group, at most kMaxGroups
int group_block(int groups) {
  return groups > 4 ? kMaxGroups : groups > 2 ? 4 : groups > 1 ? 2 : 1;
}

// Tensor maps of the pools (boxes of D x 1 head x kTok tokens), cached by
// (pointer, rows, Hkv, D, type): the engine's pools live as long as the
// engine, and an encode a call would add host time to a host-bound decode
// step.
int pool_map(CUtensorMap* map, const void* base, long long rows, int hkv,
             int d, int elt, bool bf16) {
  using Key = std::tuple<const void*, long long, int, int, int, bool>;
  static std::map<Key, CUtensorMap> cache;
  static std::mutex mu;
  const Key key{base, rows, hkv, d, elt, bf16};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  flash::sm90::EncodeTiled fn = flash::sm90::encode_tiled();
  if (fn == nullptr) return flash::sm90::kNoEncoder;
  const CUtensorMapDataType type =
      elt == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : bf16     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(hkv),
                              cuuint64_t(rows)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * elt,
                                 cuuint64_t(d) * elt * hkv};
  const cuuint32_t box[3] = {cuuint32_t(d), 1, cuuint32_t(kTok)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return flash::sm90::kEncodeError + int(r);
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

struct Call {
  const void *q, *k, *v, *ks, *vs, *tables, *lens;
  void* out;
  void *ws_acc, *ws_ml, *counters;
  int batch, heads, kv_heads, d, page, num_pages, max_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename P, int GB, int QPL>
int launch_kernel(Params& p, const Call& c) {
  const size_t smem = smem_bytes(GB, c.d, sizeof(P));
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        rpa_decode_kernel<T, P, GB, QPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    opted = smem;
  }
  // rows: B first splits, then the later ones' rows (R)
  const int blocks_x = c.kv_heads * p.head_blocks;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const long long later =
      std::min(static_cast<long long>(c.batch) * (p.splits - 1),
               std::max(1LL, (static_cast<long long>(kLaterPerSm) * sms +
                              blocks_x - 1) / blocks_x));
  if (c.batch + later > 65535) return int(cudaErrorInvalidConfiguration);
  dim3 grid(blocks_x, c.batch + static_cast<int>(later));
  rpa_decode_kernel<T, P, GB, QPL><<<grid, kThreads, smem, c.stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, typename P, int GB>
int launch_qpl(Params& p, const Call& c) {
  return row_elems(c.d) > 128 ? launch_kernel<T, P, GB, 2>(p, c)
                              : launch_kernel<T, P, GB, 1>(p, c);
}

template <typename T, typename P>
int launch(const Call& c) {
  constexpr int elt = int(sizeof(P));
  const int groups = c.heads / c.kv_heads;
  const int gb = group_block(groups);
  Params p;
  p.q = c.q, p.k = c.k, p.v = c.v;
  p.ks = static_cast<const float*>(c.ks);
  p.vs = static_cast<const float*>(c.vs);
  p.tables = static_cast<const int*>(c.tables);
  p.lens = static_cast<const int*>(c.lens);
  p.out = c.out;
  p.ws_acc = static_cast<float*>(c.ws_acc);
  p.ws_ml = static_cast<float*>(c.ws_ml);
  p.counters = static_cast<int*>(c.counters);
  p.heads = c.heads, p.kv_heads = c.kv_heads, p.d = c.d, p.page = c.page;
  p.batch = c.batch, p.max_pages = c.max_pages;
  p.splits = c.max_pages > 0
                 ? (c.max_pages + kPagesPerSplit - 1) / kPagesPerSplit
                 : 1;
  p.head_blocks = (groups + gb - 1) / gb;
  p.scale = c.scale;
  const bool vec = (c.d * elt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c.v) % 16 == 0;
  p.loader = !vec ? kPlain : c.page % kTok == 0 ? kTma : kCpAsync;
  if (p.loader == kTma) {
    const long long rows = static_cast<long long>(c.num_pages) * c.page;
    const bool bf16 = std::is_same<P, __nv_bfloat16>::value;
    int e = pool_map(&p.kmap, c.k, rows, c.kv_heads, c.d, elt, bf16);
    if (e == 0) e = pool_map(&p.vmap, c.v, rows, c.kv_heads, c.d, elt, bf16);
    if (e != 0) return e;
  }
  switch (gb) {
    case 1: return launch_qpl<T, P, 1>(p, c);
    case 2: return launch_qpl<T, P, 2>(p, c);
    case 4: return launch_qpl<T, P, 4>(p, c);
    default: return launch_qpl<T, P, 8>(p, c);
  }
}

// kQuant: int8 code pools with f32 scale pools; else pools of q's type
template <bool kQuant>
int dispatch(const Call& c, int dtype) {
  if (c.batch == 0) return 0;
  switch (dtype) {
    case 0:
      return launch<float, std::conditional_t<kQuant, int8_t, float>>(c);
    case 1:
      return launch<__half, std::conditional_t<kQuant, int8_t, __half>>(c);
    case 2:
      return launch<__nv_bfloat16,
                    std::conditional_t<kQuant, int8_t, __nv_bfloat16>>(c);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for `groups` query heads a kv head
// at head_dim d and pool elements of `pool_elem_bytes` (the wrapper
// refuses shapes whose requirement exceeds the card's per-block limit).
size_t rpa_decode_smem_bytes(int groups, int d, int pool_elem_bytes) {
  return smem_bytes(group_block(groups), d, pool_elem_bytes);
}

// Pages a split: the workspace holds ceil(max_pages / this) splits.
int rpa_decode_split_pages() { return kPagesPerSplit; }

const char* rpa_decode_error_string(int code) {
  if (code >= flash::sm90::kNoEncoder) return "no cuTensorMapEncodeTiled";
  if (code >= flash::sm90::kEncodeError)
    return "cuTensorMapEncodeTiled refused the pool's tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype (of q and out, and of the pools here): 0 float32, 1 float16, 2
// bfloat16.  ws_acc (f32, B x H x splits x D), ws_ml (f32, B x H x splits x
// 2) and counters (int32, B x Hkv x ceil(groups / 8) or more, zero) are the
// split merge's workspace, with splits = ceil(max_pages /
// rpa_decode_split_pages()); unused when that is 1.  K/V stages come by
// TMA where the page is a multiple of 16 tokens and rows of 16-byte
// multiples, else by 16-byte cp.async for such rows, else by plain loads.
// Returns cudaGetLastError() after the launch (0 = launched), a CUDA error
// of the device query or the grid (cudaErrorInvalidConfiguration past
// 65535 block rows), or an error of the tensor-map encode.
int rpa_decode(const void* q, const void* k_pages, const void* v_pages,
               const void* block_tables, const void* seq_lens, void* out,
               void* ws_acc, void* ws_ml, void* counters, int batch,
               int heads, int kv_heads, int d, int page, int num_pages,
               int max_pages, float scale, int dtype, void* stream) {
  const Call c{q,     k_pages,  v_pages, nullptr,   nullptr,
               block_tables, seq_lens, out,  ws_acc,    ws_ml,
               counters, batch,  heads,   kv_heads,  d,
               page,  num_pages, max_pages, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(c, dtype);
}

// As rpa_decode over int8 code pools (num_pages, page, Hkv, D) and f32
// scale pools (num_pages, page, Hkv, 1); dtype is q's and out's.
int rpa_decode_quant(const void* q, const void* k_pages, const void* v_pages,
                     const void* k_scales, const void* v_scales,
                     const void* block_tables, const void* seq_lens,
                     void* out, void* ws_acc, void* ws_ml, void* counters,
                     int batch, int heads, int kv_heads, int d, int page,
                     int num_pages, int max_pages, float scale, int dtype,
                     void* stream) {
  const Call c{q,     k_pages,  v_pages, k_scales,  v_scales,
               block_tables, seq_lens, out,  ws_acc,    ws_ml,
               counters, batch,  heads,   kv_heads,  d,
               page,  num_pages, max_pages, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(c, dtype);
}

}  // extern "C"
