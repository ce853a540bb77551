// Baseline for timing only: the backward of the MoE combine as two
// launches, the design before K9c was folded into it.  First the scaled
// instance of the dispatch kernel (K9a's template) writes dbuf, every row
// of the (E_local, C, D) buffer: w_f * g[f % N, :] at the held slots'
// rows, +0 elsewhere.  Then the gate-gradient kernel writes dgate_f =
// <g[f % N, :], buf[e_f, slot_f, :]>, one warp a slot (held or not), its
// lanes walking D in steps of 32 with scalar loads and an fmaf chain.
// Both read the same g rows.  chip_smoke.py builds this file as the port
// builds csrc/moe_gating.cu and times the pair in turns against the fused
// kernel on the same inputs; the entry points are
// tf_moe_dispatch_scaled_baseline and tf_moe_gate_grad_baseline.  Nothing
// of tpuframe_torch loads it.
//
// The design notes of the current kernel are in
// tpuframe_torch/csrc/moe_gating.cu.  The slot descriptors (e_loc, slot,
// count) are the port's: e_f the slot's local expert (-1 where it is not
// held here), slot_f its row, count_e the held slots of expert e (rows
// 0 .. count_e - 1; the rest are zero rows).  Arguments and dtype codes
// (0 float32, 1 bfloat16) as the port's entry points.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlotsPerBlock = 16;    // K9a: slots a block compacts (<= 32: one ballot)
constexpr int kDispatchRound = 8;     // K9a: accesses a lane issues before its stores
constexpr int kMaxExperts = 8192;     // K9a's zero-row prefix in 32 KB of shared memory

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

// One access of V elements of T: V = 1 (an element), or 16 bytes (a uint4
// of 4 f32 or 8 bf16).  get/set read and write element i as float32.
template <typename T, int V>
struct Access;

template <typename T>
struct Access<T, 1> {
  using Raw = T;
  __device__ static float get(const Raw& r, int) { return to_f(r); }
  __device__ static void set(Raw& r, int, float x) { r = from_f<T>(x); }
  __device__ static Raw zero() { return from_f<T>(0.f); }
};

template <>
struct Access<float, 4> {
  using Raw = uint4;
  __device__ static float get(const Raw& r, int i) { return __uint_as_float((&r.x)[i]); }
  __device__ static void set(Raw& r, int i, float x) { (&r.x)[i] = __float_as_uint(x); }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

template <>
struct Access<__nv_bfloat16, 8> {  // element 2i in the low half of word i
  using Raw = uint4;
  __device__ static float get(const Raw& r, int i) {
    const unsigned u = (&r.x)[i / 2];
    return __uint_as_float(i % 2 ? u & 0xffff0000u : u << 16);
  }
  __device__ static void set(Raw& r, int i, float x) {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    unsigned& u = (&r.x)[i / 2];
    u = i % 2 ? (u & 0x0000ffffu) | (b << 16) : (u & 0xffff0000u) | b;
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

template <typename T>
constexpr int kVec = 16 / sizeof(T);

// ---- K9a: dispatch ----------------------------------------------------------

template <typename T, int V, bool Scaled>
__global__ void __launch_bounds__(kThreads)
    dispatch_kernel(const T* __restrict__ src, T* __restrict__ buf,
                    const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                    const float* __restrict__ scale, const int32_t* __restrict__ count, int N,
                    int KN, int D, int capacity, int e_local) {
  using A = Access<T, V>;
  using Raw = typename A::Raw;
  extern __shared__ int zero_before[];  // [e_local + 1]: zero rows of the experts before e
  __shared__ int held_src[kSlotsPerBlock], held_dst[kSlotsPerBlock];
  __shared__ float held_scale[kSlotsPerBlock];
  __shared__ int n_held;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = D / V;  // accesses a row

  if (warp == 0) {  // compact this block's held slots, in slot order
    const int f = blockIdx.x * kSlotsPerBlock + lane;
    const bool mine = lane < kSlotsPerBlock && f < KN;
    const int e = mine ? e_loc[f] : -1;
    const int s = mine ? slot[f] : 0;
    const float sc = Scaled && mine ? scale[f] : 1.f;
    const unsigned held = __ballot_sync(kFull, e >= 0);
    if (e >= 0) {
      const int i = __popc(held & ((1u << lane) - 1u));
      held_src[i] = f % N;
      held_dst[i] = e * capacity + s;
      held_scale[i] = sc;
    }
    if (lane == 0) n_held = __popc(held);
  } else if (warp == 1) {  // inclusive warp scans of C - count_e, carried over chunks of 32
    int carry = 0;
    for (int base = 0; base < e_local; base += 32) {
      const int e = base + lane;
      int z = e < e_local ? capacity - min(max(count[e], 0), capacity) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, z, o);
        if (lane >= o) z += t;
      }
      if (e < e_local) zero_before[e + 1] = carry + z;
      carry += __shfl_sync(kFull, z, 31);
    }
    if (lane == 0) zero_before[0] = 0;
  }
  __syncthreads();

  // the held rows: warp w copies entries w, w + 8, ...; a lane's accesses
  // over its entries in order, kDispatchRound loaded before they are stored
  const int per_row = (nv + 31) / 32;
  const int mine = n_held > warp ? (n_held - warp + kWarps - 1) / kWarps : 0;
  const int tasks = mine * per_row;
  for (int t0 = 0; t0 < tasks; t0 += kDispatchRound) {
    Raw x[kDispatchRound];
#pragma unroll
    for (int r = 0; r < kDispatchRound; ++r) {
      const int t = t0 + r, q = t / per_row, c = lane + 32 * (t - q * per_row);
      if (t < tasks && c < nv) {
        x[r] = reinterpret_cast<const Raw*>(
            src + static_cast<size_t>(held_src[warp + kWarps * q]) * D)[c];
      }
    }
#pragma unroll
    for (int r = 0; r < kDispatchRound; ++r) {
      const int t = t0 + r, q = t / per_row, c = lane + 32 * (t - q * per_row);
      if (t < tasks && c < nv) {
        const int i = warp + kWarps * q;
        Raw y = x[r];
        if (Scaled) {
          const float sc = held_scale[i];
#pragma unroll
          for (int v = 0; v < V; ++v) A::set(y, v, __fmul_rn(sc, A::get(x[r], v)));
        }
        reinterpret_cast<Raw*>(buf + static_cast<size_t>(held_dst[i]) * D)[c] = y;
      }
    }
  }

  // the zero rows: rows C - zeros_e .. C - 1 of each expert, numbered in order
  const int zeros = zero_before[e_local];
  const int warps = gridDim.x * kWarps;
  for (int z = blockIdx.x * kWarps + warp; z < zeros; z += warps) {
    int lo = 0, hi = e_local - 1;  // the expert e with zero_before[e] <= z < zero_before[e + 1]
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (zero_before[mid + 1] > z) hi = mid; else lo = mid + 1;
    }
    const int row = capacity - zero_before[lo + 1] + z;
    Raw* dst = reinterpret_cast<Raw*>(buf + buf_row(lo, row, capacity, D));
    for (int c = lane; c < nv; c += 32) dst[c] = A::zero();
  }
}

// ---- K9c: gate gradient -----------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gate_grad_kernel(const T* __restrict__ g, const T* __restrict__ buf,
                     const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                     float* __restrict__ dgate, int N, int KN, int D, int capacity) {
  const int f = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (f >= KN) return;
  const int e = e_loc[f];
  float part = 0.f;
  if (e >= 0) {
    const T* a = g + static_cast<size_t>(f % N) * D;
    const T* b = buf + buf_row(e, slot[f], capacity, D);
    for (int c = lane; c < D; c += 32) part = fmaf(to_f(a[c]), to_f(b[c]), part);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
  if (lane == 0) dgate[f] = part;
}

inline unsigned blocks(long long rows, int per_block) {
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

bool valid(int N, int K, int D, int capacity) {
  return N >= 1 && K >= 1 && D >= 1 && capacity >= 1 &&
         static_cast<long long>(N) * K <= 0x7fffffffLL;
}

// 16-byte accesses where every row of every tensor starts on 16 bytes
template <typename T>
bool vectors_fit(int D, const void* a, const void* b) {
  return (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T, int V>
int launch_dispatch(const T* src, T* buf, const int32_t* e, const int32_t* sl, const float* sc,
                    const int32_t* cnt, int N, int K, int D, int capacity, int e_local,
                    cudaStream_t s) {
  const long long KN = static_cast<long long>(N) * K;
  // enough warps for the copies (a block a 16 slots), and at most 4 zero rows a warp
  const unsigned grid = std::max(blocks(KN, kSlotsPerBlock),
                            blocks(static_cast<long long>(e_local) * capacity, 4 * kWarps));
  const size_t smem = sizeof(int) * (e_local + 1);
  if (sc == nullptr) {
    dispatch_kernel<T, V, false><<<grid, kThreads, smem, s>>>(src, buf, e, sl, sc, cnt, N,
                                                              (int)KN, D, capacity, e_local);
  } else {
    dispatch_kernel<T, V, true><<<grid, kThreads, smem, s>>>(src, buf, e, sl, sc, cnt, N,
                                                             (int)KN, D, capacity, e_local);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_as(const void* src, void* buf, const void* e, const void* sl, const void* sc,
                const void* cnt, int N, int K, int D, int capacity, int e_local, cudaStream_t s) {
  auto* x = static_cast<const T*>(src);
  auto* b = static_cast<T*>(buf);
  auto* ei = static_cast<const int32_t*>(e);
  auto* si = static_cast<const int32_t*>(sl);
  auto* f = static_cast<const float*>(sc);
  auto* c = static_cast<const int32_t*>(cnt);
  return vectors_fit<T>(D, src, buf)
             ? launch_dispatch<T, kVec<T>>(x, b, ei, si, f, c, N, K, D, capacity, e_local, s)
             : launch_dispatch<T, 1>(x, b, ei, si, f, c, N, K, D, capacity, e_local, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (src, buf, out, g); anything else, or a
// shape out of range, cudaErrorInvalidValue.  Index and weight arrays are
// (K * N,) choice-major: int32 e_loc and slot, float32 scale, w and dgate;
// count is (e_local,) int32.

extern "C" int tf_moe_dispatch_scaled_baseline(const void* src, void* buf, const void* e_loc,
                                               const void* slot, const void* scale,
                                               const void* count, int N, int K, int D,
                                               int capacity, int e_local, int dtype,
                                               void* stream) {
  if (!valid(N, K, D, capacity) || e_local < 1 || e_local > kMaxExperts ||
      static_cast<long long>(e_local) * capacity > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_as<float>(src, buf, e_loc, slot, scale, count, N, K, D, capacity, e_local, s);
  }
  if (dtype == 1) {
    return dispatch_as<__nv_bfloat16>(src, buf, e_loc, slot, scale, count, N, K, D, capacity,
                                      e_local, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int tf_moe_gate_grad_baseline(const void* g, const void* buf, const void* e_loc,
                                         const void* slot, void* dgate, int N, int K, int D,
                                         int capacity, int dtype, void* stream) {
  if (!valid(N, K, D, capacity)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KN = N * K;
  const auto* e = static_cast<const int32_t*>(e_loc);
  const auto* sl = static_cast<const int32_t*>(slot);
  auto* dg = static_cast<float*>(dgate);
  if (dtype == 0) {
    gate_grad_kernel<float><<<blocks(KN, kWarps), kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(buf), e, sl, dg, N, KN, D,
        capacity);
  } else if (dtype == 1) {
    gate_grad_kernel<__nv_bfloat16><<<blocks(KN, kWarps), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(buf), e, sl, dg,
        N, KN, D, capacity);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
