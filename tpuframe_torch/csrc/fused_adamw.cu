// One-pass AdamW for Hopper (sm_90a): moments and parameter update of one
// tensor in a single read and write of each array.
//
// Replaces the Pallas kernel in tpuframe/ops/fused_adamw.py:
//   K4  _kernel via _pallas_update (the body is _update_math):
//       m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g g,
//       p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
// with b^t = exp(t log b) (0 when b = 0), all in float32.  p and g are
// float32 or bfloat16 (one dtype), m and v float32.  The step count t is
// read from device memory (int32, the count after its increment), as the
// TPU kernel reads it from SMEM, so the host never waits for the card.  lr,
// b1, b2, eps and weight decay are arguments.
//
// The update is in place: p, m and v are read and overwritten (the JAX
// kernel writes new arrays; torch keeps the optimizer state in place).
//
// Bound.  About 20 flops per element against 28 bytes (f32 p and g: four
// reads, three writes), so bytes bound it: 3.8 GB for the 136 M parameters
// of the GPT-2-small LM, 1.14 ms at 3.35 TB/s.
//
// Design.  An element-wise grid-stride loop.  Where every array is aligned
// (16 bytes for float32 arrays, 8 for bf16 p and g), each thread takes 4
// consecutive elements with vector loads; the tail past a multiple of 4, or
// a misaligned tensor, takes one element at a time.  One launch per tensor
// (149 for the LM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct Hyper {
  float lr, b1, b2, c1, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2 (rounded from double)
  float inv1, inv2;                    // 1 - b1^t, 1 - b2^t
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Hyper& h) {
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

template <typename P>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(P* __restrict__ p, const P* __restrict__ g, float* __restrict__ m,
                 float* __restrict__ v, const int32_t* __restrict__ count, long long n,
                 bool vec, float lr, float b1, float b2, float c1, float c2, float log_b1,
                 float log_b2, float eps, float wd) {
  const float t = (float)*count;
  Hyper h{lr, b1, b2, c1, c2, eps, wd, 0.f, 0.f};
  h.inv1 = 1.f - (b1 > 0.f ? expf(t * log_b1) : 0.f);
  h.inv2 = 1.f - (b2 > 0.f ? expf(t * log_b2) : 0.f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;  // elements the vector loop covers
  if (vec) {
    using V = typename Four<P>::type;
    const long long nq = n / 4;
    for (long long i = first; i < nq; i += stride) {
      float pv[4], gv[4];
      Four<P>::get(reinterpret_cast<const V*>(p)[i], pv);
      Four<P>::get(reinterpret_cast<const V*>(g)[i], gv);
      float4 mq = reinterpret_cast<const float4*>(m)[i];
      float4 vq = reinterpret_cast<const float4*>(v)[i];
      float mv[4] = {mq.x, mq.y, mq.z, mq.w};
      float vv[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) update(pv[j], gv[j], mv[j], vv[j], h);
      reinterpret_cast<V*>(p)[i] = Four<P>::put(pv);
      reinterpret_cast<float4*>(m)[i] = make_float4(mv[0], mv[1], mv[2], mv[3]);
      reinterpret_cast<float4*>(v)[i] = make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
    done = nq * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    float pv = to_float(p[i]);
    float mv = m[i], vv = v[i];
    update(pv, to_float(g[i]), mv, vv, h);
    m[i] = mv;
    v[i] = vv;
    store(p + i, pv);
  }
}

bool aligned(const void* ptr, int bytes) { return ((uintptr_t)ptr % bytes) == 0; }

template <typename P>
void launch(void* p, const void* g, float* m, float* v, const int32_t* count, long long n,
            float lr, float b1, float b2, float c1, float c2, float log_b1, float log_b2,
            float eps, float wd, cudaStream_t stream) {
  const int pbytes = 4 * (int)sizeof(P);
  const bool vec = aligned(p, pbytes) && aligned(g, pbytes) && aligned(m, 16) && aligned(v, 16);
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adamw_kernel<P><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const P*>(g), m, v, count, n, vec, lr, b1, b2, c1, c2,
      log_b1, log_b2, eps, wd);
}

}  // namespace

// One AdamW step of n elements, in place.  dtype: 0 = float32, 1 = bfloat16
// p and g; m and v float32.  count points at one int32 on the device: the
// 1-based step t.  c1 = 1 - b1, c2 = 1 - b2, log_b1 = log(b1), log_b2 =
// log(b2) (ignored where b is 0), all computed by the caller in double and
// rounded to float.  Launches on the calling
// thread's current device, which must hold every pointer and the stream.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int tf_fused_adamw(void* p, const void* g, void* m, void* v, const void* count,
                              long long n, int dtype, float lr, float b1, float b2, float c1,
                              float c2, float log_b1, float log_b2, float eps, float wd,
                              void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* vp = static_cast<float*>(v);
  const int32_t* t = static_cast<const int32_t*>(count);
  if (dtype == 0) {
    launch<float>(p, g, mp, vp, t, n, lr, b1, b2, c1, c2, log_b1, log_b2, eps, wd, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(p, g, mp, vp, t, n, lr, b1, b2, c1, c2, log_b1, log_b2, eps, wd, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
