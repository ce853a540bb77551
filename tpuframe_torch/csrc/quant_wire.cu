// The compressed gradient wire's three passes for Hopper (sm_90a): per-bucket
// abs-max, encode onto the int8 or fp8-e4m3 grid, and decode of the summed
// payload to the mean gradient.
//
// Replaces the Pallas kernels in tpuframe/ops/quant_wire.py:
//   K5a  _amax_kernel via _pallas_bucket_abs_max:  amax[r] = max_j |v[r, j]|
//   K5b  _encode_int8_kernel, _encode_int8_sr_kernel, _encode_fp8_kernel via
//        _pallas_encode:
//          denom = max(amax[r], FLT_MIN)
//          int8:            q = clip(rint(v / (denom / 127)), -127, 127)
//          int8 stochastic: q = clip(floor(v / (denom / 127) + noise), -127, 127)
//          fp8:             q = e4m3fn((v / denom) * 448), held as float32
//   K5c  _decode_kernel via _pallas_decode:
//          mean = total * (max(amax[r], FLT_MIN) / grid) / world,
//          NaN where amax[r] is not finite
// The arrays are (nb, be) row-major: one row per bucket.
//
// The contract is bitwise for K5a and K5b against the plain PyTorch version
// (tpuframe_torch/ops/quant_wire.py), which repeats the JAX expressions:
//   - every division is an IEEE division (no reciprocal, no --use_fast_math:
//     v / scale, not v * 127 / denom), and `v / scale + noise` is a division
//     then an add, which nvcc cannot contract into an FMA;
//   - rintf rounds half to even, as jnp.round does;
//   - max(amax, FLT_MIN) keeps a NaN amax NaN (jnp.maximum propagates it,
//     fmaxf would not), and a NaN on the int8 grid encodes to 0 (XLA's
//     float -> int convert; fmaxf/fminf would clip it to -127);
//   - the e4m3 cast rounds to nearest even through the hardware's
//     satfinite conversion; what lies beyond the 464 rounding edge becomes
//     NaN, as ml_dtypes' and torch's float8_e4m3fn casts make it (satfinite
//     alone would give 448).
// K5c multiplies then divides, as the plain version does; it is held within
// 1e-6.
//
// Bound.  Each pass streams the buckets once: K5a reads 4 bytes an element;
// K5b reads 4 (8 with noise) and writes 4; K5c reads 4 and writes 4.  At the
// ResNet50-1K gradient (25 x 1,022,336 float32) that is 102.2 MB, 204.5 MB
// (306.7 MB) and 204.5 MB: 30.5, 61.0 (91.6) and 61.0 us at 3.35 TB/s.
// Bytes bound all three (about 5 operations an element).
//
// Design.  The TPU kernels walk (8, 2048) tiles in a sequential grid and
// carry the amax across column blocks in the output block.  Here the grid is
// (blocks per row, rows): enough blocks over the few rows of a gradient (25)
// to fill the 132 SMs, each block striding over its row with 16-byte loads
// where the row is 16-byte aligned (be a multiple of 4), one element at a
// time otherwise.  K5a reduces |v| as the unsigned bits of a non-negative
// float (their order is the float order, and a NaN, sign cleared, sorts
// above +inf, so it propagates), in registers, then the warp, then the block,
// and one atomicMax a block into an output the launch first zeroes: max is
// exact in any order, so the bits do not depend on the schedule.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132 * 8;
constexpr float kQmax = 127.0f;
constexpr float kFp8Max = 448.0f;

struct Grid {
  dim3 blocks;
  bool vec;
};

bool aligned(const void* p) { return p == nullptr || ((uintptr_t)p % 16) == 0; }

Grid grid_for(long long nb, long long be, bool vec) {
  const long long units = vec ? be / 4 : be;
  long long per_row = (kTargetBlocks + nb - 1) / nb;
  const long long most = (units + kThreads - 1) / kThreads;
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  const long long rows = nb < 65535 ? nb : 65535;
  return {dim3((unsigned)per_row, (unsigned)rows), vec};
}

__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(fabsf(x)); }

__global__ void __launch_bounds__(kThreads)
    amax_kernel(const float* __restrict__ v, unsigned* __restrict__ out, long long nb,
                long long be, bool vec) {
  __shared__ unsigned warp_max[kThreads / 32];
  for (long long r = blockIdx.y; r < nb; r += gridDim.y) {
    const float* row = v + r * be;
    unsigned m = 0u;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (long long j = first; j < be / 4; j += stride) {
        const float4 q = row4[j];
        m = max(max(m, abs_bits(q.x)), max(abs_bits(q.y), max(abs_bits(q.z), abs_bits(q.w))));
      }
    } else {
      for (long long j = first; j < be; j += stride) m = max(m, abs_bits(row[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
      m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (threadIdx.x == 0) atomicMax(out + r, m);
    }
    __syncthreads();  // warp_max is reused by the next row
  }
}

// max(amax, FLT_MIN) that keeps a NaN amax NaN, as jnp.maximum does
__device__ __forceinline__ float denom_of(float amax) {
  return isnan(amax) ? amax : fmaxf(amax, FLT_MIN);
}

__device__ __forceinline__ int to_grid(float x) {
  return isnan(x) ? 0 : (int)fminf(fmaxf(x, -kQmax), kQmax);
}

__device__ __forceinline__ float e4m3(float x) {
  if (!(fabsf(x) <= 464.0f)) return __int_as_float(0x7fffffff);  // NaN, and past the edge
  const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3)));
}

// mode 0: int8 round half to even; 1: int8 stochastic (noise given); 2: fp8
template <int kMode>
struct Encode {
  using Out = typename std::conditional<kMode == 2, float, int>::type;
  float scale;  // denom / 127 (int8) or denom (fp8)
  __device__ __forceinline__ explicit Encode(float amax) {
    const float denom = denom_of(amax);
    scale = kMode == 2 ? denom : denom / kQmax;
  }
  __device__ __forceinline__ Out operator()(float v, float noise) const {
    if constexpr (kMode == 0) {
      return to_grid(rintf(v / scale));
    } else if constexpr (kMode == 1) {
      return to_grid(floorf(v / scale + noise));
    } else {
      return e4m3((v / scale) * kFp8Max);
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const float* __restrict__ v, const float* __restrict__ amax,
                  const float* __restrict__ noise,
                  typename Encode<kMode>::Out* __restrict__ q, long long nb, long long be,
                  bool vec) {
  using Out = typename Encode<kMode>::Out;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < nb; r += gridDim.y) {
    const Encode<kMode> enc(amax[r]);
    const long long base = r * be;
    if (vec) {
      const float4* v4 = reinterpret_cast<const float4*>(v + base);
      const float4* n4 = kMode == 1 ? reinterpret_cast<const float4*>(noise + base) : nullptr;
      for (long long j = first; j < be / 4; j += stride) {
        const float4 x = v4[j];
        const float4 u = kMode == 1 ? n4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
        const Out o[4] = {enc(x.x, u.x), enc(x.y, u.y), enc(x.z, u.z), enc(x.w, u.w)};
        if constexpr (kMode == 2) {
          reinterpret_cast<float4*>(q + base)[j] = make_float4(o[0], o[1], o[2], o[3]);
        } else {
          reinterpret_cast<int4*>(q + base)[j] = make_int4(o[0], o[1], o[2], o[3]);
        }
      }
    } else {
      for (long long j = first; j < be; j += stride) {
        q[base + j] = enc(v[base + j], kMode == 1 ? noise[base + j] : 0.f);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ total, const float* __restrict__ amax,
                  float* __restrict__ out, long long nb, long long be, float grid_max,
                  float world, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < nb; r += gridDim.y) {
    const float a = amax[r];
    const bool finite = isfinite(a);
    const float deq = fmaxf(a, FLT_MIN) / grid_max;
    const float qnan = __int_as_float(0x7fffffff);
    const long long base = r * be;
    auto mean = [&](T t) { return finite ? (float)t * deq / world : qnan; };
    if (vec) {
      using T4 = typename std::conditional<std::is_same<T, int>::value, int4, float4>::type;
      const T4* t4 = reinterpret_cast<const T4*>(total + base);
      for (long long j = first; j < be / 4; j += stride) {
        const T4 t = t4[j];
        reinterpret_cast<float4*>(out + base)[j] =
            make_float4(mean(t.x), mean(t.y), mean(t.z), mean(t.w));
      }
    } else {
      for (long long j = first; j < be; j += stride) out[base + j] = mean(total[base + j]);
    }
  }
}

}  // namespace

// Per-row max |v| of a (nb, be) float32 array into out (nb floats).
// Launches on the calling thread's current device, which must hold every
// pointer and the stream.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int tf_bucket_abs_max(const void* v, void* out, long long nb, long long be,
                                 void* stream) {
  if (nb <= 0 || be <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // +0.0 is the identity of max |v|; the bits of the result are a float's
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)nb * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const Grid g = grid_for(nb, be, be % 4 == 0 && aligned(v));
  amax_kernel<<<g.blocks, kThreads, 0, s>>>(static_cast<const float*>(v),
                                             static_cast<unsigned*>(out), nb, be, g.vec);
  return (int)cudaGetLastError();
}

// Encode a (nb, be) float32 array against per-row amax (nb floats).  mode 0:
// int8 round half to even, 1: int8 stochastic (noise, (nb, be) float32,
// required), 2: fp8 e4m3.  q is int32 (modes 0, 1) or float32 (mode 2),
// (nb, be).
extern "C" int tf_quant_encode(const void* v, const void* amax, const void* noise, void* q,
                               long long nb, long long be, int mode, void* stream) {
  if (nb <= 0 || be <= 0 || mode < 0 || mode > 2 || (mode == 1 && noise == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = be % 4 == 0 && aligned(v) && aligned(q) && aligned(mode == 1 ? noise : nullptr);
  const Grid g = grid_for(nb, be, vec);
  const float* vp = static_cast<const float*>(v);
  const float* ap = static_cast<const float*>(amax);
  const float* np_ = static_cast<const float*>(noise);
  if (mode == 0) {
    encode_kernel<0><<<g.blocks, kThreads, 0, s>>>(vp, ap, np_, static_cast<int*>(q), nb, be,
                                                    g.vec);
  } else if (mode == 1) {
    encode_kernel<1><<<g.blocks, kThreads, 0, s>>>(vp, ap, np_, static_cast<int*>(q), nb, be,
                                                    g.vec);
  } else {
    encode_kernel<2><<<g.blocks, kThreads, 0, s>>>(vp, ap, np_, static_cast<float*>(q), nb, be,
                                                    g.vec);
  }
  return (int)cudaGetLastError();
}

// Decode summed payloads (nb, be) to the mean gradient (nb, be) float32.
// fp8 0: total is int32 on the int8 grid (127); 1: float32 on the e4m3 grid
// (448).  world is the number of ranks summed.
extern "C" int tf_quant_decode(const void* total, const void* amax, void* out, long long nb,
                               long long be, int fp8, int world, void* stream) {
  if (nb <= 0 || be <= 0 || world < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g = grid_for(nb, be, be % 4 == 0 && aligned(total) && aligned(out));
  const float* ap = static_cast<const float*>(amax);
  float* op = static_cast<float*>(out);
  if (fp8) {
    decode_kernel<float><<<g.blocks, kThreads, 0, s>>>(static_cast<const float*>(total), ap, op,
                                                        nb, be, kFp8Max, (float)world, g.vec);
  } else {
    decode_kernel<int><<<g.blocks, kThreads, 0, s>>>(static_cast<const int*>(total), ap, op, nb,
                                                      be, kQmax, (float)world, g.vec);
  }
  return (int)cudaGetLastError();
}
