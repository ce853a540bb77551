// Baseline for timing only: the MoE dispatch (K9a) and combine (K9b)
// kernels as they were before their redesign.  One warp a slot (K9a) or a
// token (K9b), each lane walking the row's columns in steps of 32 with
// scalar loads; K9a writes only the held rows, so its caller zero-fills the
// buffer first.  chip_smoke.py builds this file as the port builds
// csrc/moe_gating.cu and times it in turns against those kernels on the
// same inputs; its entry points are renamed tf_moe_*_baseline.  Nothing of
// tpuframe_torch loads it.  The gate gradient (K9c) is unchanged and is
// not kept here.
//
// The design notes of the current kernels are in
// tpuframe_torch/csrc/moe_gating.cu; the comments below are those of this
// version.
//
// MoE dispatch and combine for Hopper (sm_90a): the row copies of a top-k
// mixture of experts (K9a-K9c), in float32 or bfloat16 with float32
// arithmetic.
//
// Replaces the fused path of tpuframe/ops/moe_gating.py
// (moe_dispatch_combine, :90), which the JAX package registers as a kernel
// (kernel_enabled("moe_gating")) but writes as plain XLA: a scatter-add of
// the kept token rows into the (E, C, D) expert buffers and a gather back.
//   K9a  dispatch: buf[e_f, slot_f, :] = scale_f * src[f % N, :] for every
//        slot f of the (k * N,) choice-major frame whose expert is held
//        here (e_f >= 0); scale is 1 in the forward (src the tokens) and
//        the gate weights in the backward of the combine (src its
//        cotangent).  Every destination row is distinct: no atomics.
//   K9b  combine: out[n, :] = sum_{j < k} w[j * N + n] * buf[e, slot, :]
//        over the slots of token n held here, j in order, each product and
//        each sum rounded to float32 (no FMA contraction: JAX's multiply,
//        then its scatter-add); w is gate * keep in the forward and keep
//        in the backward of the dispatch.
//   K9c  gate gradient: dgate_f = <g[f % N, :], buf[e_f, slot_f, :]>, a
//        float32 dot a slot (0 where the slot is not held here).
//
// The slot descriptors come from the routing (ops/moe_gating.py): e_f the
// local expert of slot f (its expert minus this rank's first; -1 where the
// slot was dropped, its expert is held elsewhere or it is not this rank's
// token) and slot_f its row in that expert's buffer, both int32.  buf must
// be zeroed before K9a: rows no slot targets stay zero.
//
// Design (simple kernels, right first): one warp a slot (K9a, K9c) or a
// token (K9b), 8 warps a block; a lane walks the row's D columns in steps
// of 32, so a warp's loads and stores are contiguous.  K9b reads a
// token's descriptors and weights once (up to top 8) before its column
// walk.  K9c's lanes sum their columns in order and the warp adds the 32
// partials by butterfly shuffles, an order fixed by D: a rerun gives the
// same bits.
//
// Bound: bytes, each read and written once (chip_smoke.py counts this
// run's held slots).  At the MoE path's 4,096 tokens a rank, D = 768 in
// bf16, top 2, 4 of 8 experts held (~4,000 held slots): K9a reads and
// writes the held rows (12.3 MB, 3.7 us at 3.35 TB/s); K9b reads them and
// writes (N, D); K9c reads the held rows of g and of the buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxK = 8;  // top-k up to which K9b keeps a token's rows in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ size_t buf_row(int e, int slot, int capacity, int D) {
  return (static_cast<size_t>(e) * capacity + slot) * D;
}

// ---- K9a: dispatch ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dispatch_kernel(const T* __restrict__ src, T* __restrict__ buf,
                    const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                    const float* __restrict__ scale, int N, int KN, int D, int capacity) {
  const int f = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (f >= KN) return;
  const int e = e_loc[f];
  if (e < 0) return;
  const float sc = scale == nullptr ? 1.f : scale[f];
  const T* s = src + static_cast<size_t>(f % N) * D;
  T* dst = buf + buf_row(e, slot[f], capacity, D);
  for (int c = lane; c < D; c += 32) dst[c] = from_f<T>(__fmul_rn(sc, to_f(s[c])));
}

// ---- K9b: combine -----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ buf, const float* __restrict__ w,
                   const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                   T* __restrict__ out, int N, int K, int D, int capacity) {
  const int n = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (n >= N) return;
  T* dst = out + static_cast<size_t>(n) * D;
  if (K <= kMaxK) {  // the token's rows and weights read once; unrolled, they stay in registers
    const T* rows[kMaxK];
    float ws[kMaxK];
    bool held[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      const int f = j * N + n, e = j < K ? e_loc[f] : -1;
      held[j] = e >= 0;
      rows[j] = held[j] ? buf + buf_row(e, slot[f], capacity, D) : buf;
      ws[j] = held[j] ? w[f] : 0.f;
    }
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {  // j in order, as the plain version sums
        if (held[j]) acc = __fadd_rn(acc, __fmul_rn(ws[j], to_f(rows[j][c])));
      }
      dst[c] = from_f<T>(acc);
    }
    return;
  }
  for (int c = lane; c < D; c += 32) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const int f = j * N + n, e = e_loc[f];
      if (e < 0) continue;
      acc = __fadd_rn(acc, __fmul_rn(w[f], to_f(buf[buf_row(e, slot[f], capacity, D) + c])));
    }
    dst[c] = from_f<T>(acc);
  }
}

inline unsigned blocks(int rows) { return static_cast<unsigned>((rows + kWarps - 1) / kWarps); }

bool valid(int N, int K, int D, int capacity) {
  return N >= 1 && K >= 1 && D >= 1 && capacity >= 1 &&
         static_cast<long long>(N) * K <= 0x7fffffffLL;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (src, buf, out, g); anything else, or a
// shape out of range, cudaErrorInvalidValue.  Index and weight arrays are
// (K * N,) choice-major: int32 e_loc and slot, float32 scale, w and dgate.

extern "C" int tf_moe_dispatch_baseline(const void* src, void* buf, const void* e_loc,
                                        const void* slot, const void* scale, int N, int K,
                                        int D, int capacity, int dtype, void* stream) {
  if (!valid(N, K, D, capacity)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KN = N * K;
  const auto* e = static_cast<const int32_t*>(e_loc);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    dispatch_kernel<float><<<blocks(KN), kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(buf), e, sl, sc, N, KN, D, capacity);
  } else if (dtype == 1) {
    dispatch_kernel<__nv_bfloat16><<<blocks(KN), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(buf), e, sl, sc, N,
        KN, D, capacity);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tf_moe_combine_baseline(const void* buf, const void* w, const void* e_loc,
                                       const void* slot, void* out, int N, int K, int D,
                                       int capacity, int dtype, void* stream) {
  if (!valid(N, K, D, capacity)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const int32_t*>(e_loc);
  const auto* sl = static_cast<const int32_t*>(slot);
  const auto* wf = static_cast<const float*>(w);
  if (dtype == 0) {
    combine_kernel<float><<<blocks(N), kThreads, 0, s>>>(
        static_cast<const float*>(buf), wf, e, sl, static_cast<float*>(out), N, K, D, capacity);
  } else if (dtype == 1) {
    combine_kernel<__nv_bfloat16><<<blocks(N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(buf), wf, e, sl, static_cast<__nv_bfloat16*>(out), N,
        K, D, capacity);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
