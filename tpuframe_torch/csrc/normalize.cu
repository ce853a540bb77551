// Fused image normalization for Hopper (sm_90a): uint8 or 0-255 float NHWC
// -> (x * scale - mean[c]) / std[c] in float32 or bfloat16.
//
// Replaces the Pallas kernel `_kernel` / `_pallas_normalize` in
// tpuframe/ops/normalize.py (K1).  Same arithmetic: the host folds
// w[c] = scale / std[c] and b[c] = -mean[c] / std[c], and every element is
// one f32 multiply-add, y = fmaf(x, w[c], b[c]), with c = flat_index mod C.
//
// Bound.  The op does one FMA per element, so it is bound by bytes: each
// input byte is read once and each output written once.  At the serve shape
// 64x224x224x3 that is 9,633,792 elements, 9.63 MB in + 19.27 MB out (bf16)
// = 28.9 MB, about 8.6 us at the H100's 3.35 TB/s; at the train shape
// 128x224x224x3, 57.8 MB and 17.3 us.
//
// Design.  The TPU kernel walks (256, 128) tiles in order on one core.  Here
// the image channels (C = 3, and C = 1) take a kernel of runs: a "vector" is
// 16 contiguous elements (one 16-byte load of uint8, four of float32), and
// each thread owns kRunVecs = 3 vectors, lane t of a warp the vectors t,
// t + 32 and t + 64 of the warp's 96, so every load instruction of a warp
// reads 512 contiguous bytes.  A thread issues all its loads before any
// arithmetic (48 uint8 elements, three loads in flight).  Since 16 = 1 mod 3
// and 32 = 2 mod 3, the channel of the first element of vector v is
// (first + 2 j + t) mod 3, where first (the warp's first vector, a multiple
// of 96) is 0 mod 3: the thread rotates the three folded constants into
// registers once per vector, and the channel of element k is then k mod 3,
// fixed at compile time.  No modulo and no shared load per element.  A
// lane's 16 results are 32 bytes of bf16 (64 of f32): stored straight, each
// store instruction of a warp would write half of every 32-byte sector it
// touches.  So the warp stages its results in shared memory and writes its
// output run back with every store instruction covering 512 contiguous
// bytes.  The grid covers the tensor once, with no grid-stride loop: 1,568 blocks of 128
// at 64 images.  The last n mod 16 elements go one per thread.  Other channel
// counts (up to 16) and pointers off 16 bytes take a general grid-stride
// kernel: 16 elements (or one, unaligned) per thread per trip, the channel
// stepped per element from constants in shared memory.

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

constexpr int kRunThreads = 128;
constexpr int kRunVecs = 3;  // 16-element vectors a thread owns
static_assert(16 % 3 == 1 && 32 % 3 == 2 && (32 * kRunVecs) % 3 == 0,
              "vector v = first + 32 j + t starts at channel (2 j + t) mod 3");

// raw 16-byte words of one 16-element vector: one for uint8, four for f32
template <typename In>
__device__ __forceinline__ void load_vec(const In* __restrict__ x, long long v,
                                         uint4 (&r)[sizeof(In)]) {
  const uint4* p = reinterpret_cast<const uint4*>(x) + v * (long long)sizeof(In);
#pragma unroll
  for (int i = 0; i < (int)sizeof(In); ++i) r[i] = __ldg(p + i);
}

__device__ __forceinline__ void unpack_vec(const uint4 (&r)[1], float v[16]) {
  const uint32_t words[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * j + k] = (float)((words[j] >> (8 * k)) & 0xffu);
  }
}

__device__ __forceinline__ void unpack_vec(const uint4 (&r)[4], float v[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[4 * j + 0] = __uint_as_float(r[j].x);
    v[4 * j + 1] = __uint_as_float(r[j].y);
    v[4 * j + 2] = __uint_as_float(r[j].z);
    v[4 * j + 3] = __uint_as_float(r[j].w);
  }
}

// 16 results as the output's 16-byte words: two for bf16, four for f32
__device__ __forceinline__ void pack_vec(const float v[16], uint4 (&w)[2]) {
  uint32_t packed[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    packed[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  w[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  w[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

__device__ __forceinline__ void pack_vec(const float v[16], uint4 (&w)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = make_uint4(__float_as_uint(v[4 * j]), __float_as_uint(v[4 * j + 1]),
                      __float_as_uint(v[4 * j + 2]), __float_as_uint(v[4 * j + 3]));
  }
}

// a[idx] for a runtime idx < C, by selects over compile-time indices, so
// the constants stay in the kernel's parameter bank and registers
template <int C>
__device__ __forceinline__ float pick(const float (&a)[TF_NORM_MAX_C], int idx) {
  float out = a[0];
#pragma unroll
  for (int c = 1; c < C; ++c) out = (idx == c) ? a[c] : out;
  return out;
}

// C = 1 or 3 on 16-byte aligned x and out: see the design note above.
template <int C, typename In, typename Out>
__global__ void __launch_bounds__(kRunThreads, 8)
    normalize_runs_kernel(const In* __restrict__ x, Out* __restrict__ out, long long n,
                          Affine a) {
  constexpr int kOutWords = sizeof(Out);  // 16-byte output words of a vector
  __shared__ uint4 stage[kRunThreads / 32][32 * kRunVecs * kOutWords];
  const long long nvec = n / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first =
      ((long long)blockIdx.x * (kRunThreads / 32) + warp) * (32 * kRunVecs);
  uint4 raw[kRunVecs][sizeof(In)] = {};
#pragma unroll
  for (int j = 0; j < kRunVecs; ++j) {
    const long long v = first + 32 * j + lane;
    if (v < nvec) load_vec(x, v, raw[j]);
  }
#pragma unroll
  for (int j = 0; j < kRunVecs; ++j) {
    const int r = (C == 1) ? 0 : (2 * j + lane) % C;  // channel of element 16 v
    float w[C], b[C];
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const int c = (r + m < C) ? r + m : r + m - C;
      w[m] = pick<C>(a.w, c);
      b[m] = pick<C>(a.b, c);
    }
    float vals[16];
    unpack_vec(raw[j], vals);  // past nvec: zeros, never stored
#pragma unroll
    for (int k = 0; k < 16; ++k) vals[k] = fmaf(vals[k], w[k % C], b[k % C]);
    uint4 words[kOutWords];
    pack_vec(vals, words);
#pragma unroll
    for (int i = 0; i < kOutWords; ++i) stage[warp][(32 * j + lane) * kOutWords + i] = words[i];
  }
  __syncwarp();
  // the warp's output is one contiguous run: every store instruction
  // writes 512 contiguous bytes
  uint4* o = reinterpret_cast<uint4*>(out) + first * kOutWords;
  const long long left = (nvec - first) * kOutWords;
#pragma unroll
  for (int i = 0; i < kRunVecs * kOutWords; ++i) {
    const int slot = 32 * i + lane;
    if (slot < left) o[slot] = stage[warp][slot];
  }
  // the last n mod 16 elements, one per thread of the grid's start
  const long long i = nvec * 16 + (long long)blockIdx.x * kRunThreads + threadIdx.x;
  if (i < n) {
    const int c = (int)(i % C);
    put(out, i, fmaf(to_float(x[i]), pick<C>(a.w, c), pick<C>(a.b, c)));
  }
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

template <int C, typename In, typename Out>
void launch_runs(const void* x, void* out, long long n, const Affine& a, cudaStream_t stream) {
  const long long per_block = (long long)kRunThreads * kRunVecs * 16;  // elements
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  normalize_runs_kernel<C, In, Out><<<(unsigned)blocks, kRunThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), n, a);
}

template <typename In, typename Out>
void launch(const void* x, void* out, long long n, const Affine& a, cudaStream_t stream) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec && a.c == 3) return launch_runs<3, In, Out>(x, out, n, a, stream);
  if (vec && a.c == 1) return launch_runs<1, In, Out>(x, out, n, a, stream);
  const int threads = 256;
  static int sm_count[64] = {0};  // per device, read once
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 0 && device < 64 && sm_count[device] == 0) {
    cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
  }
  const int sms = (device >= 0 && device < 64 && sm_count[device] > 0) ? sm_count[device] : 132;
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
