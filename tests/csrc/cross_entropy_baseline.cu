// Baseline for timing only: the softmax cross entropy kernels (K2a, K2b)
// as they were before the forward saved its row statistics.  Its backward
// always takes each row's max and sum itself, and where a warp owns a row
// it launches 8 rows a block whatever the batch (16 blocks at B = 128).
// chip_smoke.py builds this file as the port builds csrc/cross_entropy.cu
// and times it in turns against that kernel on the same inputs.  Nothing
// of tpuframe_torch loads it.
//
// The design notes of the current kernel are in
// tpuframe_torch/csrc/cross_entropy.cu; the comments below are those of
// this version.
//
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
// warp when K <= 4096, otherwise to a block of 512 threads.  Loads are 16
// bytes a thread (4 f32 or 8 bf16) where the row start is 16-byte aligned,
// i.e. K a multiple of 4 (f32) or 8 (bf16) on an aligned base; other rows
// take one element per load.  Labels outside [0, K) are undefined, as on
// the TPU.
//
// Forward (K2a).  At the ResNet path's (128, 1000) the forward is bound by
// latency, not bytes: its time is a chain of trips to memory.  So a warp
// reads its row's label first, then, where the row fits in registers (up to
// kCacheChunks 16-byte chunks a lane: K <= 1024 f32, K <= 2048 bf16), issues
// every load of the row before any arithmetic.  It takes the row max, then
// the sum of exp(x - max) (one expf per element, no rescale), each by warp
// shuffles, and picks the label's logit out of the registers that hold it
// (one shuffle from its lane), so the label costs no second trip.  The
// number of rows a block takes falls from 8 to 1 while the grid would leave
// SMs idle: (128, 1000) runs 128 blocks of one warp, not 16 of eight.
// Longer rows stream: each thread folds its share of the row into an online
// (max m, sum s) pair, four chunks (or elements) loaded before each fold,
// which rescales s once if the max grew; the pairs combine by warp shuffles
// (and shared memory across the warps of a block row), and the label's
// logit is read directly, issued as soon as the label arrives.  Both paths
// sum the exponentials of a chunk in float32 and the row's sum s in float64
// (see fold()).  loss = m + log(s) - x[label] equals the JAX
// lse(x - m) - (x[label] - m) up to rounding.
//
// Backward (K2b).  It keeps the row's chunks in registers when a warp owns
// the row and it fits (as above), so the logits are read once, and takes
// the row's max and sum as the forward does there (its label and g are
// loaded beside the row); otherwise it reads the logits twice (the second
// read mostly from L2).  The gradient's g may
// have any stride, including 0 (the backward of losses.mean() hands over an
// expanded scalar).

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

// Fold n values into the running (m, s): one rescale per call.  The n
// exponentials are summed apart in float32 and added to s in float64.  s
// holds the row's largest term (1) beside many small ones, and where the
// label holds the maximum its softmax is 1 - (the small ones) / s: summed in
// float32, each addition to s would round at 2**-24 of 1, and over a row
// those roundings reach 1e-6 of the gradient.
template <int N>
__device__ __forceinline__ void fold(float& m, double& s, const float v[N]) {
  float cm = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) cm = fmaxf(cm, v[j]);
  if (cm > m) {
    s = (m == -INFINITY) ? 0.0 : s * (double)expf(m - cm);
    m = cm;
  }
  float cs = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) cs += expf(v[j] - m);
  s += (double)cs;
}

__device__ __forceinline__ void combine(float& m, double& s, float mo, double so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;  // both empty
  const double a = (m == -INFINITY) ? 0.0 : s * (double)expf(m - mn);
  const double b = (mo == -INFINITY) ? 0.0 : so * (double)expf(mo - mn);
  m = mn;
  s = a + b;
}

// Combine the (m, s) of every thread of a row; every thread gets the result.
template <int ROW_THREADS>
__device__ __forceinline__ void row_reduce(float& m, double& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const double so = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, mo, so);
  }
  if (ROW_THREADS > 32) {  // a block owns the row: combine its warps
    __shared__ float sm[ROW_THREADS / 32];
    __shared__ double ss[ROW_THREADS / 32];
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
                                          double& s) {
  constexpr int N = Chunk<T>::N;
  m = -INFINITY;
  s = 0.f;
  constexpr int U = 4;  // chunks (or elements) loaded before each fold
  int i = t;
  if (kVec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    const int nv = K / N;
    for (; i + (U - 1) * ROW_THREADS < nv; i += U * ROW_THREADS) {
      uint4 q[U];
#pragma unroll
      for (int u = 0; u < U; ++u) q[u] = __ldg(x4 + i + u * ROW_THREADS);
      float v[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u) unpack(q[u], v[u]);
      fold<U * N>(m, s, &v[0][0]);
    }
    for (; i < nv; i += ROW_THREADS) {
      float v[N];
      unpack(__ldg(x4 + i), v);
      fold<N>(m, s, v);
    }
  } else {
    for (; i + (U - 1) * ROW_THREADS < K; i += U * ROW_THREADS) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = to_float(x[i + u * ROW_THREADS]);
      fold<U>(m, s, v);
    }
    for (; i < K; i += ROW_THREADS) {
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
  // the label first, and its logit as soon as the label arrives: both
  // trips run beside the row's own loads
  const long long label = (long long)labels[row];
  const float picked = to_float(x[label]);
  float m;
  double s;
  row_stats<T, ROW_THREADS, kVec>(x, K, t, m, s);
  if (t == 0) loss[row] = m + logf((float)s) - picked;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (max m, sum s) of a row that one warp holds in registers, q[c] the
// lane's chunk t + 32 c of nv: the max first, then the sum of exp(x - m)
// with no rescale (chunk sums in float32, the row's in float64, as in
// fold()), each by warp shuffles.  The lane that holds element lj of chunk
// lc also takes it into picked (lc = -1: none).
template <typename T>
__device__ __forceinline__ void cached_row_stats(const uint4 (&q)[kCacheChunks], int nv, int t,
                                                 int lc, int lj, float& m, double& s,
                                                 float& picked) {
  constexpr int N = Chunk<T>::N;
  m = -INFINITY;
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    if (t + 32 * c < nv) {
      float v[N];
      unpack(q[c], v);
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaxf(m, v[j]);
    }
  }
  m = warp_max(m);
  s = 0.0;
  picked = 0.f;
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    const int i = t + 32 * c;
    if (i < nv) {
      float v[N];
      unpack(q[c], v);
      float cs = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        cs += expf(v[j] - m);
        picked = (i == lc && j == lj) ? v[j] : picked;
      }
      s += (double)cs;
    }
  }
  s = warp_sum(s);
}

// Forward with the row held in registers: one warp per row, 16-byte
// chunks, at most kCacheChunks of them per lane (see the design note).
template <typename T, typename L>
__global__ void ce_fwd_cached_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                                     float* __restrict__ loss, int B, int K) {
  constexpr int N = Chunk<T>::N;
  long long row;
  int t;
  row_of<32>(row, t);
  if (row >= B) return;
  const long long label = (long long)labels[row];  // issued first, beside the row
  const uint4* x4 = reinterpret_cast<const uint4*>(logits + row * K);
  const int nv = K / N;
  uint4 q[kCacheChunks];
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    const int i = t + 32 * c;
    if (i < nv) q[c] = __ldg(x4 + i);
  }
  // chunk label / N sits in lane (label / N) % 32, slot (label / N) / 32
  const int lc = (int)(label / N), lj = (int)(label % N);
  float m, picked;
  double s;
  cached_row_stats<T>(q, nv, t, lc, lj, m, s, picked);
  picked = __shfl_sync(0xffffffffu, picked, lc & 31);
  if (t == 0) loss[row] = m + logf((float)s) - picked;
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
  float m;
  double s;
  row_stats<T, ROW_THREADS, kVec>(x, K, t, m, s);
  const float inv = (float)(1.0 / s);
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
  const long long label = (long long)labels[row];  // both issued beside the row
  const float gr = g[row * g_stride];
  const uint4* x4 = reinterpret_cast<const uint4*>(logits + row * K);
  uint4* o4 = reinterpret_cast<uint4*>(grad + row * K);
  const int nv = K / N;
  uint4 q[kCacheChunks];
#pragma unroll
  for (int c = 0; c < kCacheChunks; ++c) {
    const int i = t + 32 * c;
    if (i < nv) q[c] = __ldg(x4 + i);
  }
  float m, unused;
  double s;
  cached_row_stats<T>(q, nv, t, -1, 0, m, s, unused);
  const float inv = (float)(1.0 / s);
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

int sm_count() {
  static int count[64] = {0};  // per device, read once
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64) return 132;
  if (count[device] == 0) {
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  }
  return count[device] > 0 ? count[device] : 132;
}

template <typename T, typename L>
void launch_fwd(const void* logits, const void* labels, float* loss, int B, int K,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  const L* lb = static_cast<const L*>(labels);
  const bool vec = aligned16(logits) && K % Chunk<T>::N == 0;
  if (K <= kWarpRowMaxK) {
    // rows (warps) per block: 8, halved while the grid would give fewer
    // than two blocks an SM
    int rows = kWarpRowBlock / 32;
    const int sms = sm_count();
    while (rows > 1 && (B + rows - 1) / rows < 2 * sms) rows >>= 1;
    const unsigned blocks = (unsigned)((B + rows - 1) / rows);
    const int threads = 32 * rows;
    if (vec && K / Chunk<T>::N <= 32 * kCacheChunks)
      ce_fwd_cached_kernel<T, L><<<blocks, threads, 0, stream>>>(x, lb, loss, B, K);
    else if (vec)
      ce_fwd_kernel<T, L, 32, true><<<blocks, threads, 0, stream>>>(x, lb, loss, B, K);
    else
      ce_fwd_kernel<T, L, 32, false><<<blocks, threads, 0, stream>>>(x, lb, loss, B, K);
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
