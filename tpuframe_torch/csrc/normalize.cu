// Fused image normalization for Hopper (sm_90a): uint8 or 0-255 float NHWC
// -> (x * scale - mean[c]) / std[c] in float32 or bfloat16.
//
// Replaces the Pallas kernel `_kernel` / `_pallas_normalize` in
// tpuframe/ops/normalize.py (K1).  Same arithmetic: the host folds
// w[c] = scale / std[c] and b[c] = -mean[c] / std[c], and every element is
// one f32 multiply-add, y = x * w[c] + b[c], with c = flat_index mod C.
//
// Bound.  The op does one FMA per element, so it is bound by bytes: each
// input byte is read once and each output written once.  At the serve shape
// 64x224x224x3 that is 9,633,792 elements, 9.63 MB in + 19.27 MB out (bf16)
// = 28.9 MB, about 8.6 us at the H100's 3.35 TB/s.
//
// Design.  The TPU kernel walks (256, 128) tiles in order on one core; here
// each thread owns 16 contiguous elements: one 16-byte load of uint8 (four
// for float32 input), 16 FMAs, and 16-byte stores (two for bf16, four for
// f32), so neighbouring threads touch neighbouring 16-byte words.  A
// grid-stride loop over 8 blocks of 256 per SM keeps every SM loaded.
// The channel of element k of a thread is (base + k) % C, stepped
// without a division per element; the constants sit in shared memory so the
// per-element lookup is a register-indexed shared load.  A plain tail loop
// covers n mod 16.  The 16-element path needs 16-byte aligned pointers; the
// launcher takes the element-wise kernel otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TF_NORM_MAX_C 16

namespace {

struct Affine {
  float w[TF_NORM_MAX_C];
  float b[TF_NORM_MAX_C];
  int c;
};

__device__ __forceinline__ void load16(const uint8_t* __restrict__ x, long long base,
                                       float v[16]) {
  const uint4 q = *reinterpret_cast<const uint4*>(x + base);
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * j + k] = (float)((words[j] >> (8 * k)) & 0xffu);
  }
}

__device__ __forceinline__ void load16(const float* __restrict__ x, long long base, float v[16]) {
  const float4* p = reinterpret_cast<const float4*>(x + base);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = p[j];
    v[4 * j + 0] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void store16(float* __restrict__ out, long long base,
                                        const float v[16]) {
  float4* p = reinterpret_cast<float4*>(out + base);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* __restrict__ out, long long base,
                                        const float v[16]) {
  uint32_t packed[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    packed[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  uint4* p = reinterpret_cast<uint4*>(out + base);
  p[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  p[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void put(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename In, typename Out, bool kVec>
__global__ void normalize_kernel(const In* __restrict__ x, Out* __restrict__ out, long long n,
                                 Affine a) {
  __shared__ float w[TF_NORM_MAX_C];
  __shared__ float b[TF_NORM_MAX_C];
  if (threadIdx.x < a.c) {
    w[threadIdx.x] = a.w[threadIdx.x];
    b[threadIdx.x] = a.b[threadIdx.x];
  }
  __syncthreads();
  const int C = a.c;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (kVec) {
    const long long nvec = n / 16;
    for (long long v = tid; v < nvec; v += stride) {
      const long long base = v * 16;
      float vals[16];
      load16(x, base, vals);
      int c = (int)(base % C);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        vals[k] = fmaf(vals[k], w[c], b[c]);
        c = (c + 1 == C) ? 0 : c + 1;
      }
      store16(out, base, vals);
    }
    done = nvec * 16;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const int c = (int)(i % C);
    put(out, i, fmaf(to_float(x[i]), w[c], b[c]));
  }
}

template <typename In, typename Out>
void launch(const void* x, void* out, long long n, const Affine& a, cudaStream_t stream) {
  const int threads = 256;
  static int sm_count[64] = {0};  // per device, read once
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 0 && device < 64 && sm_count[device] == 0) {
    cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
  }
  const int sms = (device >= 0 && device < 64 && sm_count[device] > 0) ? sm_count[device] : 132;
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long work = vec ? (n / 16 + 15) : n;
  long long blocks = (work + threads - 1) / threads;
  const long long fill = (long long)sms * 8;  // 8 blocks of 256 per SM
  if (blocks > fill) blocks = fill;
  if (blocks < 1) blocks = 1;
  if (vec) {
    normalize_kernel<In, Out, true><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const In*>(x), static_cast<Out*>(out), n, a);
  } else {
    normalize_kernel<In, Out, false><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const In*>(x), static_cast<Out*>(out), n, a);
  }
}

}  // namespace

// in_dtype: 0 = uint8, 1 = float32.  out_dtype: 0 = float32, 1 = bfloat16.
// w and b are host arrays of n_channels floats (1 <= n_channels <= 16).
// Launches on the calling thread's current device, which must hold x, out
// and stream; the caller selects it.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int tf_normalize(const void* x, void* out, long long n, int in_dtype, int out_dtype,
                            const float* w, const float* b, int n_channels, void* stream) {
  if (n_channels < 1 || n_channels > TF_NORM_MAX_C || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Affine a;
  for (int c = 0; c < TF_NORM_MAX_C; ++c) {
    a.w[c] = c < n_channels ? w[c] : 0.f;
    a.b[c] = c < n_channels ? b[c] : 0.f;
  }
  a.c = n_channels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    launch<uint8_t, float>(x, out, n, a, s);
  } else if (in_dtype == 0 && out_dtype == 1) {
    launch<uint8_t, __nv_bfloat16>(x, out, n, a, s);
  } else if (in_dtype == 1 && out_dtype == 0) {
    launch<float, float>(x, out, n, a, s);
  } else if (in_dtype == 1 && out_dtype == 1) {
    launch<float, __nv_bfloat16>(x, out, n, a, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Largest channel count tf_normalize takes; the Python wrapper checks it.
extern "C" int tf_normalize_max_channels() { return TF_NORM_MAX_C; }
