// LayerNorm over the last axis for Hopper (sm_90a): forward (K3a) and the
// recompute backward (K3b), over (rows, D) float32 or bfloat16 x with a
// (D,) float32 or bfloat16 scale and bias.
//
// Replaces the Pallas kernels in tpuframe/ops/layer_norm.py:
//   K3a  _fwd_kernel via _fwd_pallas:
//        y = (x - mean) * rsqrt(var + eps) * scale + bias, in the x dtype
//   K3b  _bwd_kernel via _bwd_pallas:
//        dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)), gs = g * scale,
//        dscale = sum over rows of g * xhat, dbias = sum over rows of g
// Statistics are float32, variance the fast form E[x^2] - E[x]^2 clamped at
// 0, eps inside the rsqrt (flax.linen.LayerNorm's conventions).  Only x and
// scale are saved for the backward, which recomputes mean and rstd.  dx is
// written in the x dtype; dscale and dbias are summed in float32 and written
// in the scale dtype.
//
// Bound.  A few flops per element, so both kernels are bound by bytes.  At
// the LM path's (16384, 768) bf16 the forward reads x and writes y (50.3 MB,
// 15 us at 3.35 TB/s); the backward reads x and g and writes dx (75.5 MB,
// 22.5 us).  Scale, bias and the partial sums are under 4 MB.
//
// Design.  The TPU kernels pad rows to 16 and columns to 128 and mask the
// padding; here a row takes its exact D.  One warp owns a row: sums by
// butterfly shuffles, so every lane holds the same bits.  Where D is a
// multiple of the 16-byte chunk (4 f32 or 8 bf16), the row start is
// aligned, and the row fits in at most kMaxChunks chunks a lane (D <= 1024
// f32, D <= 2048 bf16), the row moves in 16-byte loads (the register path);
// other rows stream element by element, twice or three times over the row
// (the later passes mostly hit L1).
//
// The TPU backward accumulates dscale and dbias into one block that every
// step of its sequential grid revisits (a Mosaic workaround).  Hopper's
// blocks run in parallel and in no order, so here each block writes float32
// partials of its rows and a second kernel adds them.  No float atomics,
// and every sum in an order fixed by the shape and the SM count: a rerun
// gives the same bits.
//
// The backward's register path is bound by latency, not by bytes, unless
// the next rows' bytes are in flight while a row reduces: a warp's row is a
// chain of loads, four butterfly sums and a store.  So a block is 8 warps,
// two blocks an SM (16 warps), each warp walking rows grid-stride with a
// ring of kStages rows (3 for bf16, 2 for f32) in shared memory, filled by
// cp.async: the rows ahead are in flight while the current one reduces.
// A lane copies and reads only its own 16-byte chunks, so the ring needs
// no barrier.  Each lane keeps its columns' scale and its dscale/dbias
// partials in registers for all its rows.  At the end the block's 8 warps
// add their partials in shared memory in a fixed tree, and the second
// kernel adds the blocks' partials column strip by column strip: 32
// columns a block, 32 warps each adding a fixed segment of the parts in
// order, then the 32 segment sums in order.  The element path writes each
// row's mean and rstd to scratch, and a column kernel (one thread per
// column, a chunk of rows per block) forms the partials from x, g and them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 4;  // rows in flight per block: forward, element path
constexpr int kThreads = 32 * kWarps;
constexpr int kBwdWarps = 8;  // register-path backward: warps of a block
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kMaxChunks = 8;     // 16-byte chunks a lane keeps in registers
constexpr int kColThreads = 128;  // columns per block of the column kernel
constexpr int kRedCols = 32;      // columns per block of the partials' sum
constexpr int kRedSegs = 32;      // warps per block of the partials' sum

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

// rows of the backward's ring a warp keeps in shared memory
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 3 : 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// Sum over the warp; every lane gets the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// mean and rstd of a row from its sum and sum of squares.
__device__ __forceinline__ void moments(float s, float ss, int d, float eps, float& mean,
                                        float& rstd) {
  mean = s / d;
  const float var = fmaxf(ss / d - mean * mean, 0.f);
  rstd = rsqrtf(var + eps);
}

// 16 bytes from global into shared memory without passing registers (L2
// only: the rows are read once).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's groups are still in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// -- forward ---------------------------------------------------------------

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_chunked(const T* __restrict__ x, const S* __restrict__ scale,
                   const S* __restrict__ bias, T* __restrict__ y, long long rows, int d,
                   float eps) {
  constexpr int N = Chunk<T>::N;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // a whole warp leaves together
  const int nv = d / N;
  const uint4* x4 = reinterpret_cast<const uint4*>(x + row * d);
  uint4 q[kMaxChunks];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = lane + 32 * c;
    if (i < nv) {
      q[c] = __ldg(x4 + i);
      float v[N];
      unpack(q[c], v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s += v[j];
        ss += v[j] * v[j];
      }
    }
  }
  float mean, rstd;
  moments(warp_sum(s), warp_sum(ss), d, eps, mean, rstd);
  uint4* y4 = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int i = lane + 32 * c;
    if (i < nv) {
      float v[N];
      unpack(q[c], v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int col = i * N + j;
        v[j] = (v[j] - mean) * rstd * to_float(scale[col]) + to_float(bias[col]);
      }
      y4[i] = pack(v, (T*)nullptr);
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_elementwise(const T* __restrict__ x, const S* __restrict__ scale,
                       const S* __restrict__ bias, T* __restrict__ y, long long rows, int d,
                       float eps) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_float(xr[i]);
    s += v;
    ss += v * v;
  }
  float mean, rstd;
  moments(warp_sum(s), warp_sum(ss), d, eps, mean, rstd);
  for (int i = lane; i < d; i += 32) {
    const float v = (to_float(xr[i]) - mean) * rstd;
    store(yr + i, v * to_float(scale[i]) + to_float(bias[i]));
  }
}

// -- backward --------------------------------------------------------------

// Register path.  CH chunks a lane at most; MINB blocks an SM.  Warp w of
// block b walks rows b*kBwdWarps + w, stepping by gridDim.x*kBwdWarps, and
// the block writes partial[b] = (dscale[D], dbias[D]) of its rows.  Dynamic
// shared memory: the warps' rings, kBwdWarps * kStages<T> * 2 * D * sizeof(T)
// bytes, which the block's final sum reuses (kBwdWarps * 2 * D floats fit).
template <typename T, typename S, int CH, int MINB>
__global__ void __launch_bounds__(kBwdThreads, MINB)
    ln_bwd_chunked(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int d, float eps) {
  constexpr int N = Chunk<T>::N;
  constexpr int ST = kStages<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = d / N;
  // this warp's ring: ST stages of (x row, g row), nv chunks each
  uint4* ring = reinterpret_cast<uint4*>(smem) + (long long)warp * ST * 2 * nv;

  float sc[CH][N], acc_s[CH][N], acc_b[CH][N];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = lane + 32 * c;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sc[c][j] = i < nv ? to_float(scale[i * N + j]) : 0.f;
      acc_s[c][j] = acc_b[c][j] = 0.f;
    }
  }

  const long long stride = (long long)gridDim.x * kBwdWarps;
  const long long first = (long long)blockIdx.x * kBwdWarps + warp;
  // copy row `row` (if any) into stage `st`, as one group
  auto fetch = [&](long long row, int st) {
    if (row < rows) {
      const uint4* x4 = reinterpret_cast<const uint4*>(x + row * d);
      const uint4* g4 = reinterpret_cast<const uint4*>(g + row * d);
      uint4* sx = ring + st * 2 * nv;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int i = lane + 32 * c;
        if (i < nv) {
          cp_async16(sx + i, x4 + i);
          cp_async16(sx + nv + i, g4 + i);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) fetch(first + s * stride, s);

  int st = 0;  // the stage that holds `row`
  for (long long row = first; row < rows; row += stride) {
    fetch(row + (ST - 1) * stride, st == 0 ? ST - 1 : st - 1);
    cp_async_wait<ST - 1>();  // this row's group has landed
    const uint4* sx = ring + st * 2 * nv;
    const uint4* sg = sx + nv;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = lane + 32 * c;
      if (i < nv) {
        float v[N];
        unpack(sx[i], v);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          s += v[j];
          ss += v[j] * v[j];
        }
      }
    }
    float mean, rstd;
    moments(warp_sum(s), warp_sum(ss), d, eps, mean, rstd);
    float a = 0.f, b = 0.f;  // sum(gs), sum(gs * xhat)
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = lane + 32 * c;
      if (i < nv) {
        float v[N], gv[N];
        unpack(sx[i], v);
        unpack(sg[i], gv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xhat = (v[j] - mean) * rstd;
          const float gs = gv[j] * sc[c][j];
          a += gs;
          b += gs * xhat;
        }
      }
    }
    const float m1 = warp_sum(a) / d;
    const float m2 = warp_sum(b) / d;
    uint4* o4 = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int i = lane + 32 * c;
      if (i < nv) {
        float v[N], gv[N];
        unpack(sx[i], v);
        unpack(sg[i], gv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xhat = (v[j] - mean) * rstd;
          const float gs = gv[j] * sc[c][j];
          acc_s[c][j] += gv[j] * xhat;
          acc_b[c][j] += gv[j];
          v[j] = rstd * (gs - m1 - xhat * m2);
        }
        o4[i] = pack(v, (T*)nullptr);
      }
    }
    st = st + 1 == ST ? 0 : st + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is drained: the block's sum takes the memory

  // the warps' partials side by side, then added in a fixed tree
  float* part = reinterpret_cast<float*>(smem);  // [kBwdWarps][2 * d]
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = lane + 32 * c;
    if (i < nv) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        part[warp * 2 * d + i * N + j] = acc_s[c][j];
        part[warp * 2 * d + d + i * N + j] = acc_b[c][j];
      }
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * 2 * d;
  for (int col = threadIdx.x; col < 2 * d; col += kBwdThreads) {
    const float* p = part + col;
    const int w = 2 * d;
    out[col] = ((p[0] + p[w]) + (p[2 * w] + p[3 * w])) +
               ((p[4 * w] + p[5 * w]) + (p[6 * w] + p[7 * w]));
  }
}
static_assert(kBwdWarps == 8, "ln_bwd_chunked's tree adds 8 warps");

// Element path, rows: dx of one row per warp, and the row's (mean, rstd)
// into stats[2 * row].
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_rows(const T* __restrict__ x, const S* __restrict__ scale, const T* __restrict__ g,
                T* __restrict__ dx, float* __restrict__ stats, long long rows, int d,
                float eps) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * d;
  const T* gr = g + row * d;
  T* out = dx + row * d;
  float s = 0.f, ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_float(xr[i]);
    s += v;
    ss += v * v;
  }
  float mean, rstd;
  moments(warp_sum(s), warp_sum(ss), d, eps, mean, rstd);
  float a = 0.f, b = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xhat = (to_float(xr[i]) - mean) * rstd;
    const float gs = to_float(gr[i]) * to_float(scale[i]);
    a += gs;
    b += gs * xhat;
  }
  const float m1 = warp_sum(a) / d;
  const float m2 = warp_sum(b) / d;
  for (int i = lane; i < d; i += 32) {
    const float xhat = (to_float(xr[i]) - mean) * rstd;
    const float gs = to_float(gr[i]) * to_float(scale[i]);
    store(out + i, rstd * (gs - m1 - xhat * m2));
  }
  if (lane == 0) {
    stats[2 * row] = mean;
    stats[2 * row + 1] = rstd;
  }
}

// Element path, columns: block (bx, p) forms the partials of columns
// [bx * kColThreads, ...) over rows [p * chunk, (p + 1) * chunk).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
    ln_bwd_cols(const T* __restrict__ x, const T* __restrict__ g,
                const float* __restrict__ stats, float* __restrict__ partial, long long rows,
                int d, long long chunk) {
  const int col = blockIdx.x * kColThreads + threadIdx.x;
  if (col >= d) return;
  const long long r0 = (long long)blockIdx.y * chunk;
  const long long r1 = min(rows, r0 + chunk);
  float acc_s = 0.f, acc_b = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const float gv = to_float(g[r * d + col]);
    const float xhat = (to_float(x[r * d + col]) - stats[2 * r]) * stats[2 * r + 1];
    acc_s += gv * xhat;
    acc_b += gv;
  }
  float* out = partial + (long long)blockIdx.y * 2 * d;
  out[col] = acc_s;
  out[d + col] = acc_b;
}

// dscale[c] = sum over p of partial[p][0][c], dbias[c] likewise from
// partial[p][1][c].  Block b takes columns [32 b, 32 b + 32) of the 2 D;
// its warp k adds parts [k * per, (k + 1) * per) in order, lane by column
// (a warp reads 128 contiguous bytes a part), and warp 0 adds the 32
// segment sums in order.
template <typename S>
__global__ void __launch_bounds__(kRedCols * kRedSegs)
    ln_bwd_reduce(const float* __restrict__ partial, int parts, int d, S* __restrict__ dscale,
                  S* __restrict__ dbias) {
  __shared__ float seg_sum[kRedSegs][kRedCols + 1];
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int col = blockIdx.x * kRedCols + lane;
  const int per = (parts + kRedSegs - 1) / kRedSegs;
  const int p0 = seg * per;
  const int p1 = min(parts, p0 + per);
  float acc = 0.f;
  if (col < 2 * d) {
#pragma unroll 8
    for (int p = p0; p < p1; ++p) acc += partial[(long long)p * 2 * d + col];
  }
  seg_sum[seg][lane] = acc;
  __syncthreads();
  if (seg == 0 && col < 2 * d) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kRedSegs; ++k) total += seg_sum[k][lane];
    store(col < d ? dscale + col : dbias + (col - d), total);
  }
}
static_assert(kRedCols == 32, "ln_bwd_reduce maps a warp's lanes onto its columns");

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

// chunks a lane needs for a row of nv chunks; 0 when it exceeds kMaxChunks
int chunks_per_lane(int nv) {
  const int need = (nv + 31) / 32;
  const int options[] = {1, 2, 3, 4, 6, 8};
  for (int ch : options)
    if (need <= ch) return ch;
  return 0;
}

template <typename T, typename S>
void launch_fwd(const void* x, const void* scale, const void* bias, void* y, long long rows,
                int d, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  const S* bp = static_cast<const S*>(bias);
  T* yp = static_cast<T*>(y);
  constexpr int N = Chunk<T>::N;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (aligned16(x) && aligned16(y) && d % N == 0 && d / N <= 32 * kMaxChunks)
    ln_fwd_chunked<T, S><<<blocks, kThreads, 0, stream>>>(xp, sp, bp, yp, rows, d, eps);
  else
    ln_fwd_elementwise<T, S><<<blocks, kThreads, 0, stream>>>(xp, sp, bp, yp, rows, d, eps);
}

// The register path's launch: up to `parts` blocks, two an SM where a
// lane's columns (scale and two partials a column) fit 128 registers, else
// one; returns the blocks launched (the parts to add), or -1 when the
// launch was refused.
template <typename T, typename S, int CH>
int launch_bwd_chunked(const T* x, const S* scale, const T* g, T* dx, float* partial,
                       int parts, long long rows, int d, float eps, cudaStream_t stream) {
  constexpr int MINB = CH * Chunk<T>::N <= 24 ? 2 : 1;
  const int smem = kBwdWarps * kStages<T> * 2 * d * (int)sizeof(T);
  // the rings above 48 KB, and as much of the SM's 256 KB for shared
  // memory as two blocks need (the kernel reads little through L1)
  if (cudaFuncSetAttribute(ln_bwd_chunked<T, S, CH, MINB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess ||
      cudaFuncSetAttribute(ln_bwd_chunked<T, S, CH, MINB>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  // `parts` is two an SM: one an SM where only one fits
  const long long blocks = std::min<long long>(
      MINB == 2 ? parts : (parts + 1) / 2, (rows + kBwdWarps - 1) / kBwdWarps);
  ln_bwd_chunked<T, S, CH, MINB><<<(unsigned)blocks, kBwdThreads, smem, stream>>>(
      x, scale, g, dx, partial, rows, d, eps);
  return (int)blocks;
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* g, void* dx, void* dscale,
               void* dbias, float* work, int parts, long long rows, int d, float eps,
               cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  constexpr int N = Chunk<T>::N;
  float* partial = work;  // parts * 2 * d floats, then 2 * rows floats of stats
  const int ch = (aligned16(x) && aligned16(g) && aligned16(dx) && d % N == 0)
                     ? chunks_per_lane(d / N)
                     : 0;
  int used = parts;
  switch (ch) {
    case 1: used = launch_bwd_chunked<T, S, 1>(xp, sp, gp, dxp, partial, parts, rows, d, eps, stream); break;
    case 2: used = launch_bwd_chunked<T, S, 2>(xp, sp, gp, dxp, partial, parts, rows, d, eps, stream); break;
    case 3: used = launch_bwd_chunked<T, S, 3>(xp, sp, gp, dxp, partial, parts, rows, d, eps, stream); break;
    case 4: used = launch_bwd_chunked<T, S, 4>(xp, sp, gp, dxp, partial, parts, rows, d, eps, stream); break;
    case 6: used = launch_bwd_chunked<T, S, 6>(xp, sp, gp, dxp, partial, parts, rows, d, eps, stream); break;
    case 8: used = launch_bwd_chunked<T, S, 8>(xp, sp, gp, dxp, partial, parts, rows, d, eps, stream); break;
    default: {
      used = (int)std::min<long long>(parts, (rows + kWarps - 1) / kWarps);
      float* stats = work + (long long)parts * 2 * d;
      const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
      ln_bwd_rows<T, S><<<blocks, kThreads, 0, stream>>>(xp, sp, gp, dxp, stats, rows, d, eps);
      const long long chunk = (rows + used - 1) / used;
      const dim3 grid((unsigned)((d + kColThreads - 1) / kColThreads), (unsigned)used);
      ln_bwd_cols<T><<<grid, kColThreads, 0, stream>>>(xp, gp, stats, partial, rows, d, chunk);
    }
  }
  if (used < 0) {  // the kernel's attributes were refused
    const int err = (int)cudaGetLastError();
    return err ? err : (int)cudaErrorInvalidConfiguration;
  }
  ln_bwd_reduce<S><<<(unsigned)((2 * d + kRedCols - 1) / kRedCols), kRedCols * kRedSegs, 0,
                     stream>>>(partial, used, d, static_cast<S*>(dscale), static_cast<S*>(dbias));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 x and y; sdtype the same for scale and
// bias.  x and y are (rows, d) row-major and contiguous.  Launches on the
// calling thread's current device, which must hold every pointer and the
// stream; the caller selects it.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int tf_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                 long long rows, int d, float eps, int dtype, int sdtype,
                                 void* stream) {
  if (rows < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && sdtype == 0) {
    launch_fwd<float, float>(x, scale, bias, y, rows, d, eps, s);
  } else if (dtype == 0 && sdtype == 1) {
    launch_fwd<float, __nv_bfloat16>(x, scale, bias, y, rows, d, eps, s);
  } else if (dtype == 1 && sdtype == 0) {
    launch_fwd<__nv_bfloat16, float>(x, scale, bias, y, rows, d, eps, s);
  } else if (dtype == 1 && sdtype == 1) {
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, rows, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As tf_layer_norm_fwd; g and dx are (rows, d) in the x dtype, contiguous;
// dscale and dbias are (d,) in the scale dtype.  work is float32 scratch of
// at least parts * 2 * d + 2 * rows floats; parts (>= 1, two per SM) bounds
// the row groups whose partial sums the last kernel adds: the groups follow
// from the shape and parts alone.  rows must be >= 1 (the caller zeroes
// dscale and dbias of an empty batch).
extern "C" int tf_layer_norm_bwd(const void* x, const void* scale, const void* g, void* dx,
                                 void* dscale, void* dbias, void* work, int parts,
                                 long long rows, int d, float eps, int dtype, int sdtype,
                                 void* stream) {
  if (rows < 1 || d < 1 || parts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(work);
  if (dtype == 0 && sdtype == 0)
    return launch_bwd<float, float>(x, scale, g, dx, dscale, dbias, w, parts, rows, d, eps, s);
  if (dtype == 0 && sdtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, scale, g, dx, dscale, dbias, w, parts, rows, d,
                                            eps, s);
  if (dtype == 1 && sdtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, scale, g, dx, dscale, dbias, w, parts, rows, d,
                                            eps, s);
  if (dtype == 1 && sdtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, g, dx, dscale, dbias, w, parts,
                                                    rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
