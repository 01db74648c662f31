// Scaffolding of the warp-specialised wgmma + TMA flash kernels, shared by
// the forward (flash_fwd.cu, `flash_fwd_ws_kernel`) and the backward
// (flash_bwd.cu, `flash_dq_ws_kernel`, `flash_dkv_ws_kernel`).
//
// Warpgroup 0 of a block is the producer: its registers are cut by
// setmaxnreg and one thread issues the TMA loads of the tiles
// (flash_sm90.cuh) into a ring of stages, each guarded by a full and an
// empty mbarrier.  The other warpgroups (two; three in the forward at
// D <= 128) are the consumers, 64 rows each, their registers raised: they
// wait on a stage's full barrier, compute on it by wgmma and arrive on
// its empty barrier (one arrival from every consumer thread).  The producer's waits are bounded and it drains the
// ring at its end (producer_drain), so a wrong byte or arrival count ends
// the launch with a CUDA error instead of hanging it.

#pragma once

#include <stdio.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace flash {

// two consumers: 384 threads, three ring stages
constexpr int kWsThreads = 384;
constexpr int kStages = 3;

// 24 x 128 + 240 x 256 registers = the 168 x 384 a block of 384 threads
// is given at launch (__launch_bounds__(384, 1)); three consumers get 160
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// The wgmma kernels take the 16-bit types (dtype 1 float16, 2 bfloat16)
// at these head dims: the forward at 64, 128 and 256, the backward at 64
// and 128 (at 256 its resident tiles and accumulators do not fit).
inline bool ws_route(int d, int dtype, bool forward) {
  return dtype != 0 && (d == 64 || d == 128 || (forward && d == 256));
}

// The producer's last waits (bounded, see mbar_wait_or_trap): for the
// resident tiles' barrier and for the consumers to free the ring's last
// `Stages` fills, from the stage and phase its loop ended at.
template <int Stages = kStages>
__device__ __forceinline__ void producer_drain(uint64_t* resident,
                                               uint64_t* empty, int stage,
                                               uint32_t phase) {
  sm90::mbar_wait_or_trap(resident, 0);
  for (int i = 0; i < Stages; ++i) {
    sm90::mbar_wait_or_trap(&empty[stage], phase ^ 1);
    if (++stage == Stages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

struct Sm90Args {
  sm90::TmaView q, k, v, dout;
  Params p;
};

constexpr int round1024(int n) { return (n + 1023) / 1024 * 1024; }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A 64-row accumulator d[D / 2] (wgmma layout: rows r0 and r0 + 8 of this
// thread) as T pairs at dst (row stride ss); rows >= rows are skipped.
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* dst, long long ss,
                                          const float* d, int r0, int rows,
                                          int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(dst + r0 * ss + c) =
          pack_f32<T>(d[4 * j], d[4 * j + 1]);
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * ss + c) =
          pack_f32<T>(d[4 * j + 2], d[4 * j + 3]);
  }
}

// The A fragments (N / 16 k-steps of 16 columns) of a 64 x N accumulator,
// rounded to T: no data moves between lanes.
template <typename T, int N = 64>
__device__ __forceinline__ void acc_to_frags(uint32_t (*a)[4],
                                             const float* d) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_f32<T>(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_f32<T>(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_f32<T>(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_f32<T>(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// The tensor maps of q, k, v and (where the kernel reads it) dout; q/dout
// boxes of q_rows rows, k/v of k_rows.  Returns 0 or an error code.
inline int make_views(Sm90Args& a, int batch, int dtype, int q_rows,
                      int k_rows) {
  const Params& p = a.p;
  const bool bf16 = dtype == 2;
  const int kv_heads = p.heads / p.rep;
  int e = sm90::encode_view(&a.q, p.q, bf16, batch, p.heads, p.sq, p.d,
                            p.q_st.b, p.q_st.h, p.q_st.s, q_rows);
  if (!e && p.dout != nullptr)
    e = sm90::encode_view(&a.dout, p.dout, bf16, batch, p.heads, p.sq, p.d,
                          p.do_st.b, p.do_st.h, p.do_st.s, q_rows);
  if (!e)
    e = sm90::encode_view(&a.k, p.k, bf16, batch, kv_heads, p.sk, p.d,
                          p.k_st.b, p.k_st.h, p.k_st.s, k_rows);
  if (!e)
    e = sm90::encode_view(&a.v, p.v, bf16, batch, kv_heads, p.sk, p.d,
                          p.v_st.b, p.v_st.h, p.v_st.s, k_rows);
  return e;
}

// The error string of an entry point's return code: a CUDA error, or a
// tensor map refused by the driver (flash_sm90.cuh's codes).
inline const char* ws_error_string(int code) {
  static char buf[96];
  if (code >= sm90::kNoEncoder)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (code >= sm90::kEncodeError) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled refused the view "
             "(CUresult %d)", code - sm90::kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace flash
