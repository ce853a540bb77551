// Softmax cross entropy for Hopper (sm_90a), forward and recompute backward,
// over (B, K) float32 or bfloat16 logits and (B,) int32 or int64 labels.
//
// Replaces the Pallas kernels in tpuframe/ops/cross_entropy.py:
//   K2a  _fwd_kernel via _fwd_pallas: loss[r] = logsumexp(x[r]) - x[r, label[r]]
//   K2b  _bwd_kernel via _bwd_pallas: grad[r, c] = (softmax(x[r])[c] - [c == label[r]]) * g[r]
// The loss is float32; the gradient is written in the logits dtype.  Only
// logits and labels are saved for the backward, which recomputes the row's
// max and sum from them.
//
// Bound.  Each row does a handful of flops per logit, so both kernels are
// bound by bytes: the forward reads the logits once (B*K*4 bytes for f32)
// plus labels and writes B floats; the backward reads the logits once and
// writes the gradient once (2*B*K*4 for f32).  At the train path's (128,
// 1000) f32 that is 0.5 MB and 1 MB: launch latency, not HBM, sets the time.
//
// Design.  The TPU kernel pads rows to 16 and columns to 128 and masks the
// padding with -inf; here rows take their exact K.  A row belongs to one
// warp when K <= 4096 (eight rows per 256-thread block), otherwise to a
// block of 512 threads.  Each thread folds its share of the row into an
// online (max m, sum s) pair in float32: per 16-byte chunk it takes the
// chunk max, rescales s once if the max grew, and adds exp(x - m) for the
// chunk.  The pairs combine by warp shuffles (and shared memory across the
// warps of a block row).  Then loss = m + log(s) - x[label]: the label's
// logit is read directly, with no onehot scan; this equals the JAX
// lse(x - m) - (x[label] - m) up to rounding.  Loads are 16 bytes a thread
// (4 f32 or 8 bf16) where the row start is 16-byte aligned, i.e. K a
// multiple of 4 (f32) or 8 (bf16) on an aligned base; other rows take one
// element per load.  The backward keeps the row's chunks in registers when
// a warp owns the row and it fits (up to 8 chunks a lane: K <= 1024 f32,
// K <= 2048 bf16), so the logits are read once; otherwise it reads them
// twice (the second read mostly from L2).  The gradient's g may have any
// stride, including 0 (the backward of losses.mean() hands over an
// expanded scalar).  Labels outside [0, K) are undefined, as on the TPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpRowMaxK = 4096;  // K above this: one block per row
constexpr int kBlockRowThreads = 512;
constexpr int kWarpRowBlock = 256;  // 8 warps, 8 rows per block
constexpr int kCacheChunks = 8;     // 16-byte chunks a lane keeps in registers

template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bf16 -> f32 is the bf16 bits in the high half of the f32 word
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4], float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[8], __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Fold n values into the running (m, s): one rescale per call.
template <int N>
__device__ __forceinline__ void fold(float& m, float& s, const float v[N]) {
  float cm = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) cm = fmaxf(cm, v[j]);
  if (cm > m) {
    s = (m == -INFINITY) ? 0.f : s * expf(m - cm);
    m = cm;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) s += expf(v[j] - m);
}

__device__ __forceinline__ void combine(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both empty
  const float a = (m == -INFINITY) ? 0.f : s * expf(m - mn);
  const float b = (mo == -INFINITY) ? 0.f : so * expf(mo - mn);
  m = mn;
  s = a + b;
}

// Combine the (m, s) of every thread of a row; every thread gets the result.
template <int ROW_THREADS>
__device__ __forceinline__ void row_reduce(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, mo, so);
  }
  if (ROW_THREADS > 32) {  // a block owns the row: combine its warps
    __shared__ float sm[ROW_THREADS / 32];
    __shared__ float ss[ROW_THREADS / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      sm[warp] = m;
      ss[warp] = s;
    }
    __syncthreads();
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < ROW_THREADS / 32; ++w) combine(m, s, sm[w], ss[w]);
  }
}

// The row this thread works on, and its index within the row's threads.
template <int ROW_THREADS>
__device__ __forceinline__ void row_of(long long& row, int& t) {
  if (ROW_THREADS == 32) {
    row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    t = threadIdx.x & 31;
  } else {
    row = blockIdx.x;
    t = threadIdx.x;
  }
}

// (m, s) of one row, streamed from memory.
template <typename T, int ROW_THREADS, bool kVec>
__device__ __forceinline__ void row_stats(const T* __restrict__ x, int K, int t, float& m,
                                          float& s) {
  constexpr int N = Chunk<T>::N;
  m = -INFINITY;
  s = 0.f;
  if (kVec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const int nv = K / N;
    for (int i = t; i < nv; i += ROW_THREADS) {
      float v[N];
      unpack(__ldg(x4 + i), v);
      fold<N>(m, s, v);
    }
  } else {
    for (int i = t; i < K; i += ROW_THREADS) {
      const float v[1] = {to_float(x[i])};
      fold<1>(m, s, v);
    }
  }
  row_reduce<ROW_THREADS>(m, s);
}

template <typename T, typename L, int ROW_THREADS, bool kVec>
__global__ void ce_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                              float* __restrict__ loss, int B, int K) {
  long long row;
  int t;
  row_of<ROW_THREADS>(row, t);
  if (row >= B) return;  // a whole warp (or block) leaves together
  const T* x = logits + row * K;
  float m, s;
  row_stats<T, ROW_THREADS, kVec>(x, K, t, m, s);
  if (t == 0) loss[row] = m + logf(s) - to_float(x[(long long)labels[row]]);
}

template <typename T, typename L, int ROW_THREADS, bool kVec>
__global__ void ce_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                              const float* __restrict__ g, long long g_stride,
                              T* __restrict__ grad, int B, int K) {
  constexpr int N = Chunk<T>::N;
  long long row;
  int t;
  row_of<ROW_THREADS>(row, t);
  if (row >= B) return;
  const T* x = logits + row * K;
  T* out = grad + row * K;
  float m, s;
  row_stats<T, ROW_THREADS, kVec>(x, K, t, m, s);
  const float inv = 1.f / s;
  const float gr = g[row * g_stride];
  const long long label = (long long)labels[row];
  if (kVec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    const int nv = K / N;
    for (int i = t; i < nv; i += ROW_THREADS) {
      float v[N];
      unpack(__ldg(x4 + i), v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = expf(v[j] - m) * inv;
        v[j] = (p - (i * N + j == label ? 1.f : 0.f)) * gr;
      }
      o4[i] = pack(v, (T*)nullptr);
    }
  } else {
    for (int i = t; i < K; i += ROW_THREADS) {
      const float p = expf(to_float(x[i]) - m) * inv;
      from_float((p - (i == label ? 1.f : 0.f)) * gr, out + i);
    }
  }
}

// Backward with the row held in registers: one warp per row, 16-byte
// chunks, at most kCacheChunks of them per lane.
template <typename T, typename L>
__global__ void ce_bwd_cached_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                                     const float* __restrict__ g, long long g_stride,
                                     T* __restrict__ grad, int B, int K) {
  constexpr int N = Chunk<T>::N;
  long long row;
  int t;
  row_of<32>(row, t);
  if (row >= B) return;
  const uint4* x4 = reinterpret_cast<const uint4*>(logits + row * K);
  uint4* o4 = reinterpret_cast<uint4*>(grad + row * K);
  const int nv = K / N;
  uint4 q[kCacheChunks];
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    const int i = t + 32 * c;
    if (i < nv) q[c] = __ldg(x4 + i);
  }
  float m = -INFINITY, s = 0.f;
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    if (t + 32 * c < nv) {
      float v[N];
      unpack(q[c], v);
      fold<N>(m, s, v);
    }
  }
  row_reduce<32>(m, s);
  const float inv = 1.f / s;
  const float gr = g[row * g_stride];
  const long long label = (long long)labels[row];
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    const int i = t + 32 * c;
    if (i < nv) {
      float v[N];
      unpack(q[c], v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float p = expf(v[j] - m) * inv;
        v[j] = (p - (i * N + j == label ? 1.f : 0.f)) * gr;
      }
      o4[i] = pack(v, (T*)nullptr);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

template <typename T, typename L>
void launch_fwd(const void* logits, const void* labels, float* loss, int B, int K,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  const L* lb = static_cast<const L*>(labels);
  const bool vec = aligned16(logits) && K % Chunk<T>::N == 0;
  if (K <= kWarpRowMaxK) {
    const unsigned blocks = (unsigned)((B + kWarpRowBlock / 32 - 1) / (kWarpRowBlock / 32));
    if (vec)
      ce_fwd_kernel<T, L, 32, true><<<blocks, kWarpRowBlock, 0, stream>>>(x, lb, loss, B, K);
    else
      ce_fwd_kernel<T, L, 32, false><<<blocks, kWarpRowBlock, 0, stream>>>(x, lb, loss, B, K);
  } else {
    if (vec)
      ce_fwd_kernel<T, L, kBlockRowThreads, true>
          <<<(unsigned)B, kBlockRowThreads, 0, stream>>>(x, lb, loss, B, K);
    else
      ce_fwd_kernel<T, L, kBlockRowThreads, false>
          <<<(unsigned)B, kBlockRowThreads, 0, stream>>>(x, lb, loss, B, K);
  }
}

template <typename T, typename L>
void launch_bwd(const void* logits, const void* labels, const float* g, long long g_stride,
                void* grad, int B, int K, cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  const L* lb = static_cast<const L*>(labels);
  T* out = static_cast<T*>(grad);
  const bool vec = aligned16(logits) && aligned16(grad) && K % Chunk<T>::N == 0;
  if (K <= kWarpRowMaxK) {
    const unsigned blocks = (unsigned)((B + kWarpRowBlock / 32 - 1) / (kWarpRowBlock / 32));
    if (vec && K / Chunk<T>::N <= 32 * kCacheChunks)
      ce_bwd_cached_kernel<T, L><<<blocks, kWarpRowBlock, 0, stream>>>(x, lb, g, g_stride, out,
                                                                       B, K);
    else if (vec)
      ce_bwd_kernel<T, L, 32, true>
          <<<blocks, kWarpRowBlock, 0, stream>>>(x, lb, g, g_stride, out, B, K);
    else
      ce_bwd_kernel<T, L, 32, false>
          <<<blocks, kWarpRowBlock, 0, stream>>>(x, lb, g, g_stride, out, B, K);
  } else {
    if (vec)
      ce_bwd_kernel<T, L, kBlockRowThreads, true>
          <<<(unsigned)B, kBlockRowThreads, 0, stream>>>(x, lb, g, g_stride, out, B, K);
    else
      ce_bwd_kernel<T, L, kBlockRowThreads, false>
          <<<(unsigned)B, kBlockRowThreads, 0, stream>>>(x, lb, g, g_stride, out, B, K);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 logits (and gradient).  label_dtype:
// 0 = int32, 1 = int64.  logits are (B, K) row-major and contiguous; loss is
// (B,) float32.  Launches on the calling thread's current device, which must
// hold every pointer and the stream; the caller selects it.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int tf_cross_entropy_fwd(const void* logits, const void* labels, void* loss, int B,
                                    int K, int dtype, int label_dtype, void* stream) {
  if (B < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(loss);
  if (dtype == 0 && label_dtype == 0) {
    launch_fwd<float, int32_t>(logits, labels, l, B, K, s);
  } else if (dtype == 0 && label_dtype == 1) {
    launch_fwd<float, int64_t>(logits, labels, l, B, K, s);
  } else if (dtype == 1 && label_dtype == 0) {
    launch_fwd<__nv_bfloat16, int32_t>(logits, labels, l, B, K, s);
  } else if (dtype == 1 && label_dtype == 1) {
    launch_fwd<__nv_bfloat16, int64_t>(logits, labels, l, B, K, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As tf_cross_entropy_fwd; g is (B,) float32 read at g[row * g_stride]
// (g_stride 0 broadcasts one value), grad is (B, K) in the logits dtype.
extern "C" int tf_cross_entropy_bwd(const void* logits, const void* labels, const void* g,
                                    long long g_stride, void* grad, int B, int K, int dtype,
                                    int label_dtype, void* stream) {
  if (B < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  if (dtype == 0 && label_dtype == 0) {
    launch_bwd<float, int32_t>(logits, labels, gp, g_stride, grad, B, K, s);
  } else if (dtype == 0 && label_dtype == 1) {
    launch_bwd<float, int64_t>(logits, labels, gp, g_stride, grad, B, K, s);
  } else if (dtype == 1 && label_dtype == 0) {
    launch_bwd<__nv_bfloat16, int32_t>(logits, labels, gp, g_stride, grad, B, K, s);
  } else if (dtype == 1 && label_dtype == 1) {
    launch_bwd<__nv_bfloat16, int64_t>(logits, labels, gp, g_stride, grad, B, K, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
