// Baseline for timing only: the blockwise attention kernels (K6a, K6b, K6c)
// as they were before the bf16 backward moved to the tensor cores: every
// product a float32 FMA from shared memory, in float32 and bf16 alike.
// chip_smoke.py builds this file as the port builds
// csrc/blockwise_attention.cu and times its bf16 K6b and K6c in turns
// against the current ones on the same inputs.  Nothing of tpuframe_torch
// loads it.  Below this note the file is that version verbatim, but for
// the entry points, renamed tf_blockwise_attention_baseline_* so that both
// libraries can be loaded in one process.
//
// The design notes of the current kernels are in
// tpuframe_torch/csrc/blockwise_attention.cu; the comments below are those
// of this version.
//
// Blockwise (flash-style) attention for Hopper (sm_90a): the forward (K6a)
// and the two passes of the backward (K6b, K6c), over q, k, v of shape
// (B, L, H, D) in float32 or bfloat16, read in that layout in place.
//
// Replaces the hand-written jax.custom_vjp of
// tpuframe/ops/blockwise_attention.py (no Pallas kernel; lax.scan over
// blocks, sharing _block_update and _tile_grads with
// tpuframe/ops/ring_attention.py):
//   K6a  _fwd_schedule via _blockwise_padded_fwd: the online softmax over
//        K/V tiles for each Q tile; out in the input dtype, lse (B, H, L)
//        float32
//   K6b  _blockwise_padded_bwd pass 1: delta = rowsum(dO * O) in float32,
//        then dQ from P = exp(S - lse), recomputed a tile at a time
//   K6c  _blockwise_padded_bwd pass 2: dK and dV, the K/V tile outer and
//        the Q tiles inner
// Tiles above the causal diagonal are skipped; keys >= L are masked.
//
// Numerics, as JAX: products of storage-dtype values accumulated in float32
// (a bf16 value widens to float32 exactly and a product of two fits in
// float32's mantissa, so a float32 FMA is that product); the softmax state
// float32; P rounded to the value dtype before P·V; dS rounded to the
// storage dtype for dQ and dK, P for dV; out = o / max(lsum, 1e-30), cast
// last.  The -inf guards are JAX's: m_safe, a correction of 0 while the
// running max is -inf, lse_safe.  Every sum runs in an order fixed by the
// shape: no atomics, so a rerun gives the same bits.
//
// Bound.  Operations: at the LM path's (2, 8192, 12, 64) causal the forward
// does 2 products of 2 * B * H * L^2 * D / 2 = 206 GFLOP (0.21 ms at the
// card's 989 TFLOP/s in bf16), the backward 5 (515 GFLOP, 0.52 ms).  The
// bytes (q, k, v, out, lse, g, dq, dk, dv: 25 MB each in bf16) take
// microseconds.
//
// Design (a simple kernel, right first; the tensor cores come with the
// redesign).  A block of 256 threads owns one 64-row tile (a Q tile in K6a
// and K6b, a K/V tile in K6c) of one (b, h) and walks the other operand's
// 64-row tiles.  Tiles sit in shared memory as float32, rows padded by 4
// floats so that the 16-byte loads of 8 threads cover distinct banks.
// Thread (ty, tx) = (tid / 16, tid % 16) computes a 4 x 4 piece of the
// 64 x 64 score tile, rows 4 ty + i and columns tx + 16 j, with float32
// FMAs over 16-byte shared loads; a row's max and sum run over the 16 lanes
// of a half warp by butterfly shuffles (every lane holds the same bits).
// The probabilities (or dS) go to shared memory, rounded as above, and the
// same thread then accumulates rows 4 ty + i of the 64 x D product against
// the tile in its D / 16 columns, in registers.  K6b writes delta to global
// memory for K6c.  Blocks run the heaviest causal tiles first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of every tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kPad = 4;            // floats of padding after each shared row
constexpr int kPS = kTile + kPad;  // row stride of the 64 x 64 P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the storage dtype's rounding in float32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ size_t row_offset(int b, int l, int h, int L, int H, int D) {
  return ((static_cast<size_t>(b) * L + l) * H + h) * static_cast<size_t>(D);
}

// The 64 rows row0.. of (b, h) into shared float32 rows of stride D + kPad;
// rows at or past L are zeros.  16-byte global loads (D is a multiple of 8).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* g, int b, int h, int row0, int L,
                                          int H) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunks = D / V;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    const int l = row0 + r;
    float* dst = s + r * (D + kPad) + c;
    if (l < L) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + row_offset(b, l, h, L, H, D) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[j] = 0.f;
    }
  }
}

// acc[i][j] += sum_d A[4 ty + i][d] * B[tx + 16 j][d], d in order
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, float (&acc)[4][4],
                                         int ty, int tx) {
  constexpr int S = D + kPad;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
    }
  }
}

// The D / 16 columns of thread tx: kVec consecutive columns in each of kGroups
// groups, column = g * 16 * kVec + tx * kVec + e.
template <int D>
struct Cols {
  static constexpr int kPer = D / 16;
  static constexpr int kVec = kPer < 4 ? kPer : 4;
  static constexpr int kGroups = kPer / kVec;
  __device__ static __forceinline__ int col(int t, int tx) {
    return (t / kVec) * 16 * kVec + tx * kVec + (t % kVec);
  }
};

// kVec floats of a shared row at column g * 16 * kVec + tx * kVec
template <int D>
__device__ __forceinline__ void load_cols(const float* row, int tx, float (&out)[D / 16]) {
  using C = Cols<D>;
#pragma unroll
  for (int g = 0; g < C::kGroups; ++g) {
    const float* p = row + g * 16 * C::kVec + tx * C::kVec;
    if constexpr (C::kVec == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[4 * g] = v.x;
      out[4 * g + 1] = v.y;
      out[4 * g + 2] = v.z;
      out[4 * g + 3] = v.w;
    } else if constexpr (C::kVec == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[2 * g] = v.x;
      out[2 * g + 1] = v.y;
    } else {
      out[g] = p[0];
    }
  }
}

// acc[i][t] += sum_c P[4 ty + i][c] * V[c][col(t)], c in order
template <int D>
__device__ __forceinline__ void tile_pv(const float* P, const float* V, float (&acc)[4][D / 16],
                                        int ty, int tx) {
  constexpr int S = D + kPad;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kPS + c);
      p[i][0] = v.x;
      p[i][1] = v.y;
      p[i][2] = v.z;
      p[i][3] = v.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float vv[D / 16];
      load_cols<D>(V + (c + cc) * S, tx, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int t = 0; t < D / 16; ++t) acc[i][t] = fmaf(p[i][cc], vv[t], acc[i][t]);
      }
    }
  }
}

// Over the 16 lanes of a half warp (tx = lane % 16); butterflies, so every
// lane ends with the same bits
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__host__ __device__ constexpr size_t tile_floats() {
  return static_cast<size_t>(kTile) * (D + kPad);
}

// ---- K6a: forward ----------------------------------------------------------

template <typename T, int D>
constexpr size_t fwd_smem() {
  return (3 * tile_floats<D>() + kTile * kPS) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, float* __restrict__ lse, int L, int H, int causal,
               float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* Ps = Vs + tile_floats<D>();
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;  // the longest causal rows first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, D>(Qs, q, b, h, qt * kTile, L, H);
  float o[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) o[i][t] = 0.f;
  }
  const int last = causal ? qt : n_tiles - 1;  // tiles above the diagonal: skipped
  for (int kt = 0; kt <= last; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k, b, h, kt * kTile, L, H);
    load_tile<T, D>(Vs, v, b, h, kt * kTile, L, H);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qt * kTile + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tx + 16 * j;
        const bool ok = kj < L && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = (m[i] == -INFINITY || m_new == -INFINITY) ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        Ps[(4 * ty + i) * kPS + tx + 16 * j] = round_to<T>(p);  // v's dtype
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < D / 16; ++t) o[i][t] *= corr;
    }
    __syncthreads();
    tile_pv<D>(Ps, Vs, o, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = qt * kTile + 4 * ty + i;
    if (qi >= L) continue;
    const float lsum = fmaxf(l[i], 1e-30f);
    if (tx == 0) lse[(static_cast<size_t>(b) * H + h) * L + qi] = m[i] + logf(lsum);
    T* dst = out + row_offset(b, qi, h, L, H, D);
#pragma unroll
    for (int t = 0; t < D / 16; ++t) dst[Cols<D>::col(t, tx)] = from_f<T>(o[i][t] / lsum);
  }
}

// ---- K6b: backward pass 1, delta and dQ -------------------------------------

template <typename T, int D>
constexpr size_t dq_smem() {
  return (4 * tile_floats<D>() + kTile * kPS) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ out, const T* __restrict__ g,
                  const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
                  int L, int H, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + tile_floats<D>();
  float* Ks = dOs + tile_floats<D>();
  float* Vs = Ks + tile_floats<D>();
  float* dSs = Vs + tile_floats<D>();
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row_bh = (static_cast<size_t>(b) * H + h) * L;

  load_tile<T, D>(Qs, q, b, h, qt * kTile, L, H);
  load_tile<T, D>(dOs, g, b, h, qt * kTile, L, H);
  __syncthreads();
  float lse_r[4], delta_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = qt * kTile + 4 * ty + i;
    float part = 0.f;
    if (qi < L) {
      const T* o_row = out + row_offset(b, qi, h, L, H, D);
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        const int c = Cols<D>::col(t, tx);
        part = fmaf(to_f(o_row[c]), dOs[(4 * ty + i) * (D + kPad) + c], part);
      }
    }
    delta_r[i] = half_warp_sum(part);
    const float ls = qi < L ? lse[row_bh + qi] : 0.f;
    lse_r[i] = ls == -INFINITY ? 0.f : ls;  // lse_safe
    if (qi < L && tx == 0) delta[row_bh + qi] = delta_r[i];
#pragma unroll
    for (int t = 0; t < D / 16; ++t) acc[i][t] = 0.f;
  }
  const int last = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, k, b, h, kt * kTile, L, H);
    load_tile<T, D>(Vs, v, b, h, kt * kTile, L, H);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(Qs, Ks, s, ty, tx);
    tile_dot<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qt * kTile + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tx + 16 * j;
        const bool ok = kj < L && qi < L && (!causal || kj <= qi);
        const float p = expf((ok ? s[i][j] * scale : -INFINITY) - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        dSs[(4 * ty + i) * kPS + tx + 16 * j] = round_to<T>(ds);  // k's dtype
      }
    }
    __syncthreads();
    tile_pv<D>(dSs, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = qt * kTile + 4 * ty + i;
    if (qi >= L) continue;
    T* dst = dq + row_offset(b, qi, h, L, H, D);
#pragma unroll
    for (int t = 0; t < D / 16; ++t) dst[Cols<D>::col(t, tx)] = from_f<T>(acc[i][t]);
  }
}

// ---- K6c: backward pass 2, dK and dV ----------------------------------------

template <typename T, int D>
constexpr size_t dkv_smem() {
  return (4 * tile_floats<D>() + 2 * kTile * kPS + 2 * kTile) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ g, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int L, int H, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + tile_floats<D>();
  float* Qs = Vs + tile_floats<D>();
  float* dOs = Qs + tile_floats<D>();
  float* Ps = dOs + tile_floats<D>();
  float* dSs = Ps + kTile * kPS;
  float* lse_s = dSs + kTile * kPS;
  float* delta_s = lse_s + kTile;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // causal: the first K/V tiles meet the most Q tiles
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t row_bh = (static_cast<size_t>(b) * H + h) * L;

  load_tile<T, D>(Ks, k, b, h, kt * kTile, L, H);
  load_tile<T, D>(Vs, v, b, h, kt * kTile, L, H);
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int t = 0; t < D / 16; ++t) acc_k[i][t] = acc_v[i][t] = 0.f;
  }
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {  // tiles above the diagonal: skipped
    __syncthreads();
    load_tile<T, D>(Qs, q, b, h, qt * kTile, L, H);
    load_tile<T, D>(dOs, g, b, h, qt * kTile, L, H);
    if (threadIdx.x < kTile) {
      const int qi = qt * kTile + threadIdx.x;
      const float ls = qi < L ? lse[row_bh + qi] : 0.f;
      lse_s[threadIdx.x] = ls == -INFINITY ? 0.f : ls;  // lse_safe
      delta_s[threadIdx.x] = qi < L ? delta[row_bh + qi] : 0.f;
    }
    __syncthreads();
    // the transposed tile: rows are keys 4 ty + i, columns queries tx + 16 j
    float st[4][4] = {}, dpt[4][4] = {};
    tile_dot<D>(Ks, Qs, st, ty, tx);
    tile_dot<D>(Vs, dOs, dpt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = kt * kTile + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qi = qt * kTile + r;
        const bool ok = kj < L && qi < L && (!causal || kj <= qi);
        const float p = expf((ok ? st[i][j] * scale : -INFINITY) - lse_s[r]);
        const float ds = p * (dpt[i][j] - delta_s[r]) * scale;
        Ps[(4 * ty + i) * kPS + r] = round_to<T>(p);    // dO's dtype
        dSs[(4 * ty + i) * kPS + r] = round_to<T>(ds);  // q's dtype
      }
    }
    __syncthreads();
    tile_pv<D>(Ps, dOs, acc_v, ty, tx);
    tile_pv<D>(dSs, Qs, acc_k, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = kt * kTile + 4 * ty + i;
    if (kj >= L) continue;
    T* dk_row = dk + row_offset(b, kj, h, L, H, D);
    T* dv_row = dv + row_offset(b, kj, h, L, H, D);
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      dk_row[Cols<D>::col(t, tx)] = from_f<T>(acc_k[i][t]);
      dv_row[Cols<D>::col(t, tx)] = from_f<T>(acc_v[i][t]);
    }
  }
}

// ---- launches -------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  // above 48 KB only as opted-in dynamic shared memory; set on every call
  // (cheap, and safe across devices)
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L,
               int H, int causal, float scale, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<T, D>();
  if (int rc = prepare(attn_fwd_kernel<T, D>, smem)) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  attn_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), L, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* g,
              const void* lse, void* dq, void* delta, int B, int L, int H, int causal,
              float scale, cudaStream_t s) {
  constexpr size_t smem = dq_smem<T, D>();
  if (int rc = prepare(attn_bwd_dq_kernel<T, D>, smem)) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  attn_bwd_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), L, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int causal,
               float scale, cudaStream_t s) {
  constexpr size_t smem = dkv_smem<T, D>();
  if (int rc = prepare(attn_bwd_dkv_kernel<T, D>, smem)) return rc;
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  attn_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, H,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int L, int H, int D) {
  return B >= 1 && L >= 1 && H >= 1 && (D == 16 || D == 32 || D == 64 || D == 128) &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && (L + kTile - 1) / kTile <= 65535;
}

}  // namespace

// Dispatch on dtype (0 float32, 1 bfloat16) and head dim D in {16, 32, 64,
// 128}, anything else cudaErrorInvalidValue.
#define TF_DISPATCH(LAUNCH, ...)                                            \
  do {                                                                      \
    if (!valid_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                     \
    if (dtype == 0) {                                                       \
      switch (D) {                                                          \
        case 16: return LAUNCH<float, 16>(__VA_ARGS__, s);                  \
        case 32: return LAUNCH<float, 32>(__VA_ARGS__, s);                  \
        case 64: return LAUNCH<float, 64>(__VA_ARGS__, s);                  \
        case 128: return LAUNCH<float, 128>(__VA_ARGS__, s);                \
      }                                                                     \
    } else if (dtype == 1) {                                                \
      switch (D) {                                                          \
        case 16: return LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__, s);          \
        case 32: return LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__, s);          \
        case 64: return LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__, s);          \
        case 128: return LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__, s);        \
      }                                                                     \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// q, k, v, out: (B, L, H, D) contiguous, 16-byte aligned, in the dtype;
// lse: (B, H, L) float32.  scale is 1 / sqrt(D).
extern "C" int tf_blockwise_attention_baseline_fwd(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int L, int H, int D, int causal,
                                          float scale, int dtype, void* stream) {
  TF_DISPATCH(launch_fwd, q, k, v, out, lse, B, L, H, causal, scale);
}

// As the forward; g (the upstream gradient, dO) and dq like q; lse from the
// forward; delta: (B, H, L) float32, written.
extern "C" int tf_blockwise_attention_baseline_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* out, const void* g, const void* lse,
                                             void* dq, void* delta, int B, int L, int H, int D,
                                             int causal, float scale, int dtype, void* stream) {
  TF_DISPATCH(launch_dq, q, k, v, out, g, lse, dq, delta, B, L, H, causal, scale);
}

// As the forward; delta from tf_blockwise_attention_baseline_bwd_dq; dk and dv like k.
extern "C" int tf_blockwise_attention_baseline_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* g, const void* lse, const void* delta,
                                              void* dk, void* dv, int B, int L, int H, int D,
                                              int causal, float scale, int dtype, void* stream) {
  TF_DISPATCH(launch_dkv, q, k, v, g, lse, delta, dk, dv, B, L, H, causal, scale);
}
