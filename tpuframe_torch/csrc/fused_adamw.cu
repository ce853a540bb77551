// One-pass AdamW for Hopper (sm_90a) over a list of tensors in one launch:
// moments and parameter update in a single read and write of each array.
//
// Replaces the Pallas kernel in tpuframe/ops/fused_adamw.py:
//   K4  _kernel via _pallas_update (the body is _update_math):
//       m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g g,
//       p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
// with b^t = exp(t log b) (0 when b = 0), all in float32.  p and g are
// float32 or bfloat16 (one dtype in a launch), m and v float32.  Each
// tensor's step count t is read from device memory (its own int32, the
// count after its increment), as the TPU kernel reads it from SMEM, so the
// host never waits for the card.  lr, b1, b2, eps and weight decay are
// arguments, shared by the launch.
//
// The update is in place: p, m and v are read and overwritten (the JAX
// kernel writes new arrays; torch keeps the optimizer state in place).
//
// Bound.  About 20 flops per element against 28 bytes (f32 p and g: four
// reads, three writes), so bytes bound it: 3.8 GB for the 136 M parameters
// of the GPT-2-small LM, 1.14 ms at 3.35 TB/s.
//
// Design.  A step of the LM updates 149 tensors, ~100 of them of 768
// elements.  One launch a tensor made the host's launch rate set the pace
// and left the card nearly empty on the small ones, so one launch takes a
// table of up to kCapacity tensors: per tensor the addresses of p, g, m, v
// and its count, and its element count.  The table travels by value as the
// kernel's parameter (__grid_constant__; CUDA 12.1+ takes up to 32,764
// bytes), so the launch copies it and the host may reuse its array at once;
// a longer list is split into several launches by the caller.  The
// concatenated element space is cut into chunks of kChunk elements, no
// chunk spanning two tensors; block b updates chunk b and finds its tensor
// by a binary search over the table's prefix of chunk counts.  The grid is
// the number of chunks (33 k for the LM), so every SM is filled whatever
// the sizes.  Where all four arrays of a tensor are aligned (16 bytes for
// float32, 8 for bf16 p and g) a thread takes 4 consecutive elements with
// vector loads; a tensor's last partial quad, or a misaligned tensor, takes
// one element at a time.  Each element is computed by update() alone, so
// the bits do not depend on the list, the chunking or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;     // elements of one block: 4 quads a thread
constexpr int kCapacity = 256;   // tensors of one launch's table

struct Entry {
  void* p;
  const void* g;
  float* m;
  float* v;
  const int32_t* count;
  long long n;
};

// 13.4 KB: the kernel's parameter
struct Table {
  Entry e[kCapacity];
  int first[kCapacity + 1];  // entry i owns chunks [first[i], first[i + 1])
  int size;                  // entries in use, each with n > 0
};

struct Hyper {
  float lr, b1, b2, c1, c2, log_b1, log_b2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

struct Step {
  float lr, b1, b2, c1, c2, eps, wd;
  float inv1, inv2;  // 1 - b1^t, 1 - b2^t
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Step& h) {
  m = h.b1 * m + h.c1 * g;
  v = h.b2 * v + h.c2 * g * g;
  const float mhat = m / h.inv1;
  const float vhat = v / h.inv2;
  p = p - h.lr * (mhat / (sqrtf(vhat) + h.eps) + h.wd * p);
}

// 4 consecutive values of P
template <typename P>
struct Four;
template <>
struct Four<float> {
  using type = float4;
  static __device__ __forceinline__ void get(const float4& q, float (&v)[4]) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ float4 put(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Four<__nv_bfloat16> {
  using type = uint2;
  static __device__ __forceinline__ void get(const uint2& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
  static __device__ __forceinline__ uint2 put(const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};

__device__ __forceinline__ bool aligned(const void* ptr, int bytes) {
  return ((uintptr_t)ptr % bytes) == 0;
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    adamw_multi_kernel(const __grid_constant__ Table tab, const Hyper hp) {
  const int chunk = blockIdx.x;
  // the last entry whose first chunk is at or before this one
  int lo = 0, hi = tab.size - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const Entry& e = tab.e[lo];
  P* __restrict__ p = static_cast<P*>(e.p);
  const P* __restrict__ g = static_cast<const P*>(e.g);
  float* __restrict__ m = e.m;
  float* __restrict__ v = e.v;
  const long long n = e.n;

  const float t = (float)*e.count;
  Step h{hp.lr, hp.b1, hp.b2, hp.c1, hp.c2, hp.eps, hp.wd, 0.f, 0.f};
  h.inv1 = 1.f - (hp.b1 > 0.f ? expf(t * hp.log_b1) : 0.f);
  h.inv2 = 1.f - (hp.b2 > 0.f ? expf(t * hp.log_b2) : 0.f);

  const long long start = (long long)(chunk - tab.first[lo]) * kChunk;
  const long long end = min(n, start + kChunk);
  long long done = start;  // first element the scalar loop takes
  if (aligned(p, 4 * (int)sizeof(P)) && aligned(g, 4 * (int)sizeof(P)) && aligned(m, 16) &&
      aligned(v, 16)) {
    using V = typename Four<P>::type;
    const long long q1 = end / 4;  // start is a multiple of 4
    for (long long i = start / 4 + threadIdx.x; i < q1; i += kThreads) {
      float pv[4], gv[4];
      Four<P>::get(reinterpret_cast<const V*>(p)[i], pv);
      Four<P>::get(reinterpret_cast<const V*>(g)[i], gv);
      const float4 mq = reinterpret_cast<const float4*>(m)[i];
      const float4 vq = reinterpret_cast<const float4*>(v)[i];
      float mv[4] = {mq.x, mq.y, mq.z, mq.w};
      float vv[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) update(pv[j], gv[j], mv[j], vv[j], h);
      reinterpret_cast<V*>(p)[i] = Four<P>::put(pv);
      reinterpret_cast<float4*>(m)[i] = make_float4(mv[0], mv[1], mv[2], mv[3]);
      reinterpret_cast<float4*>(v)[i] = make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
    done = q1 * 4;
  }
  for (long long i = done + threadIdx.x; i < end; i += kThreads) {
    float pv = to_float(p[i]);
    float mv = m[i], vv = v[i];
    update(pv, to_float(g[i]), mv, vv, h);
    m[i] = mv;
    v[i] = vv;
    store(p + i, pv);
  }
}

}  // namespace

// Tensors one launch takes: a longer list needs more launches.
extern "C" int tf_fused_adamw_capacity() { return kCapacity; }

// One AdamW step of up to tf_fused_adamw_capacity() tensors, in place, in
// one launch.  table is host memory of n_tensors rows of six int64: the
// device addresses of p, g, m, v and of the tensor's step count (one int32:
// the 1-based step t), then its element count.  dtype: 0 = float32, 1 =
// bfloat16 p and g (all rows alike); m and v float32.  c1 = 1 - b1, c2 =
// 1 - b2, log_b1 = log(b1), log_b2 = log(b2) (ignored where b is 0), all
// computed by the caller in double and rounded to float.  The table is
// copied into the launch: it may be reused as soon as this returns.
// Launches on the calling thread's current device, which must hold every
// pointer and the stream.  Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int tf_fused_adamw(const long long* table, int n_tensors, int dtype, float lr,
                              float b1, float b2, float c1, float c2, float log_b1,
                              float log_b2, float eps, float wd, void* stream) {
  if (n_tensors < 0 || n_tensors > kCapacity || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Table tab;
  long long chunks = 0;
  int size = 0;
  for (int i = 0; i < n_tensors; ++i) {
    const long long* row = table + 6 * i;
    const long long n = row[5];
    if (n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) continue;
    tab.e[size] = Entry{reinterpret_cast<void*>(row[0]), reinterpret_cast<const void*>(row[1]),
                        reinterpret_cast<float*>(row[2]), reinterpret_cast<float*>(row[3]),
                        reinterpret_cast<const int32_t*>(row[4]), n};
    tab.first[size++] = (int)chunks;
    chunks += (n + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  if (size == 0) return 0;
  tab.first[size] = (int)chunks;
  tab.size = size;
  const Hyper hp{lr, b1, b2, c1, c2, log_b1, log_b2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    adamw_multi_kernel<float><<<(unsigned)chunks, kThreads, 0, s>>>(tab, hp);
  else
    adamw_multi_kernel<__nv_bfloat16><<<(unsigned)chunks, kThreads, 0, s>>>(tab, hp);
  return (int)cudaGetLastError();
}
