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
// out_f32 stores out, dq, dk and dv as float32 where the input is bf16 (the
// accumulators as they are, not rounded): the ring (ops/ring_attention.py)
// sums one partial a visiting block and casts once, as JAX keeps its ring's
// o, dq, dk and dv in float32 across hops.
//
// Numerics, as JAX: products of storage-dtype values accumulated in float32
// (a bf16 value widens to float32 exactly and a product of two fits in
// float32's mantissa, so a float32 FMA or a bf16 tensor-core product with a
// float32 accumulator is that product); the softmax state float32; P
// rounded to the value dtype before P·V; dS rounded to the storage dtype
// for dQ and dK, P for dV; out = o / max(lsum, 1e-30), cast last.  The
// -inf guards are JAX's: m_safe, a correction of 0 while the running max is
// -inf, lse_safe.  Every sum runs in an order fixed by the shape: no
// atomics, so a rerun gives the same bits.
//
// Bound.  Operations: at the LM path's (2, 8192, 12, 64) causal one product
// over the visible half of L^2 is 2 * B * H * L^2 * D / 2 = 103 GFLOP.  The
// forward does 2 (0.2085 ms at the card's 989 TFLOP/s in bf16).  The
// backward keeps JAX's two passes, 7 products: K6b 3 (S, dP, dQ), K6c 4 (S,
// dP, dV, dK), 721 GFLOP, 0.7296 ms.  The bytes (q, k, v, out, lse, g, dq,
// dk, dv: 25 MB each in bf16) take microseconds.
//
// Design of the float32 kernels (simple kernels, right first).  A block of
// 256 threads owns one 64-row tile (a Q tile in K6a and K6b, a K/V tile in
// K6c) of one (b, h) and walks the other operand's 64-row tiles.  Tiles
// sit in shared memory as float32, rows padded by 4 floats so that the
// 16-byte loads of 8 threads cover distinct banks.  Thread (ty, tx)
// = (tid / 16, tid % 16) computes a 4 x 4 piece of the 64 x 64 score tile,
// rows 4 ty + i and columns tx + 16 j, with float32 FMAs over 16-byte shared
// loads; a row's max and sum run over the 16 lanes of a half warp by
// butterfly shuffles (every lane holds the same bits).  The probabilities
// (or dS) go to shared memory, rounded as above, and the same thread then
// accumulates rows 4 ty + i of the 64 x D product against the tile in its
// D / 16 columns, in registers.  K6b writes delta to global memory for K6c.
// Blocks run the heaviest causal tiles first.  Float32 keeps these FMA
// kernels: its forward is held within 1e-5 and its gradients within 1e-4,
// which TF32 products cannot give.
//
// Design of the bf16 kernels (K6a, K6b, K6c on the tensor cores).  The FMA
// kernels ran at ~32 TFLOP/s, half the card's float32 CUDA-core peak, so
// no arrangement of FMAs could come near the bound.  Here:
// - Every product is mma.sync.m16n8k16 bf16 with a float32 accumulator.  A
//   block of 4 warps owns a 64-row tile, each warp 16 of its rows: query
//   rows in K6a and K6b, key rows in K6c.  Operands come from shared
//   memory by ldmatrix, and by ldmatrix.trans where the product reads the
//   operand along its rows (V in o += P·V, K in dQ += dS·K, dO and Q in dV
//   += Pᵀ·dO, dK += dSᵀ·Q).
// - K6a reads its warp's 16 Q rows into A fragments once (ldmatrix) and
//   keeps them for the whole K/V walk (D / 4 registers).  Each tile: S =
//   Q·Kᵀ into the accumulators, then the online softmax on the fragments:
//   the row max over a row's quad of lanes (shuffles 1 and 2), JAX's -inf
//   guards, o rescaled by the correction, p = exp2 of one FMA.  The running
//   max is that of the raw scores (the scale is positive, so times the
//   scale it is JAX's m, bit for bit), and lse = m · scale + log(l) is
//   written in natural-log units, the one conversion.  Each lane keeps its
//   share of the row sum l (from the unrounded p, as JAX's l_new) and the
//   quad adds the four shares once, at the end.  p rounded to bf16 is the
//   A operand of o += P·V straight from the accumulators.
// - The scores stay in registers.  K6b forms S = Q·Kᵀ and dP = dO·Vᵀ (16 x
//   64 a warp, float32 accumulator fragments), turns them into dS = P ∘ (dP
//   - delta) · scale in place, rounds pairs to bf16 and hands those
//   registers on as the A operand of dQ += dS·K: the accumulator layout of
//   m16n8k16 is the A layout of the next product, so P and dS never touch
//   shared memory.  K6c does the same on the transposed tile, Sᵀ = K·Qᵀ and
//   dPᵀ = V·dOᵀ, so Pᵀ and dSᵀ are the A operands of dV += Pᵀ·dO and dK +=
//   dSᵀ·Q.  lse and delta are per query, so per column there: each thread
//   reads its columns' entries from a small shared array.
// - Tiles sit in shared memory in bf16, rows padded by 16 bytes, so the
//   eight 16-byte rows that one ldmatrix phase reads fall in distinct banks
//   at every head dim.  The streamed operand (K and V in K6a and K6b; Q,
//   dO, lse and delta in K6c) is double-buffered with cp.async: the next
//   tile is in flight while the current one computes.  Rows past L are
//   zero-filled (cp.async's src-size 0).
// - The softmax term costs instruction slots beside the products, so p =
//   exp(s · scale - lse) is exp2f of one FMA, log2(e) folded into scale
//   and lse: faster than expf in both kernels, timed in turns on an H100,
//   and no further from float32.
// - Masks only where needed: the causal mask on the diagonal tile, the
//   ragged-L mask on a tile that holds rows past L; every other tile runs
//   unmasked.  The rules are those of the FMA kernels: tiles above the
//   diagonal skipped, masked scores -inf before exp, lse_safe, p = 0 for a
//   padded query row, the heaviest causal tiles first.
// - K6b computes delta = rowsum(dO * O) itself, from the dO tile it has
//   loaded, and writes it for K6c: two launches, no pre-pass.
// - Registers a thread from ptxas (-Xptxas -v, CUDA 12.8, sm_90a; chip_smoke.py
//   phase 2 prints them), no spills at any head dim:
//     D          16    32    64   128
//     K6a        80   108   128   239
//     K6b       123   128   168   254
//     K6c       128   147   222   255
//   K6c holds two 16 x D float32 accumulators (dK, dV) beside the two
//   16 x 64 score tiles, so at D = 128 it sits at the 255 limit; a block of
//   128 threads then leaves room for 2 blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ---- K6b and K6c in bf16 on the tensor cores --------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;              // each owns 16 rows of the block's 64-row tile
constexpr int kThreads = 32 * kWarps;  // 128
constexpr float kLog2e = 1.4426950408889634f;

// bf16 elements a shared row: D and 16 bytes of padding
template <int D>
__host__ __device__ constexpr int stride() {
  return D + 8;
}
template <int D>
__host__ __device__ constexpr int tile_elems() {
  return kTile * stride<D>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared, asynchronously; zeros where !full
// (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, and r[i] holds (row lane / 4, columns 2 (lane % 4) + {0, 1})
// of it, or with .trans of its transpose
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment coordinates.  Lane = 4 gr + tq.  The accumulator fragment of
// n-tile j holds (row gr, columns 8 j + 2 tq + {0, 1}) in c[0], c[1] and
// (row gr + 8, the same columns) in c[2], c[3].  The A fragment of k-step
// kk (columns 16 kk .. 16 kk + 15) is then n-tiles 2 kk and 2 kk + 1,
// packed in that order: the accumulator-to-A identity.

// This lane's ldmatrix row (offset in elements) for the A operand at the
// 16 x 16 block (row0, col0) of a row-major tile
template <int D>
__device__ __forceinline__ int a_off(int row0, int col0, int lane) {
  return (row0 + (lane & 15)) * stride<D>() + col0 + (lane >> 4) * 8;
}
// For the B operands of two n-tiles (n0, n0 + 8) at k-step k0 from a tile
// stored [n][k] (ldsm_x4): r = {b0, b1} of n0, then {b0, b1} of n0 + 8
template <int D>
__device__ __forceinline__ int b_off(int n0, int k0, int lane) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * stride<D>() + k0 + ((lane >> 3) & 1) * 8;
}
// The same from a tile stored [k][n] (ldsm_x4_t)
template <int D>
__device__ __forceinline__ int bt_off(int k0, int n0, int lane) {
  return (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * stride<D>() + n0 + (lane >> 4) * 8;
}

// The 64 rows row0.. of (b, h) into a shared bf16 tile, asynchronously;
// rows at or past L are zeros
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* s, const bf16* g, int b, int h, int row0,
                                                int L, int H) {
  constexpr int kChunks = D / 8;  // 16 bytes each
static_assert(kTile * kChunks % kThreads == 0, "whole rounds of chunks");
#pragma unroll
  for (int n = 0; n < kTile * kChunks / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int l = row0 + r;
    const bool in = l < L;
    cp_async16(smem_u32(s + r * stride<D>() + c), in ? g + row_offset(b, l, h, L, H, D) + c : g,
               in);
  }
}

// c[j] += A · Bᵀ over D for the 8 n-tiles of a 16 x 64 score block: rows
// a_row0.. of the tile As against the 64 rows of the tile Bs
template <int D>
__device__ __forceinline__ void scores(float (&c)[8][4], const bf16* As, int a_row0,
                                       const bf16* Bs, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(As + a_off<D>(a_row0, 16 * ks, lane)));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(Bs + b_off<D>(16 * np, 16 * ks, lane)));
      mma(c[2 * np], a, b[0], b[1]);
      mma(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += A (16 x 64, bf16 A fragments) · Bs (64 x D, stored [k][n])
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const uint32_t (&a)[4][4],
                                           const bf16* Bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(Bs + bt_off<D>(16 * kk, 16 * nd, lane)));
      mma(acc[2 * nd], a[kk], b[0], b[1]);
      mma(acc[2 * nd + 1], a[kk], b[2], b[3]);
    }
  }
}

// The A fragments of the 4 k-steps, from the 8 accumulator n-tiles of x
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// A warp's 16 rows row0.. of acc into (B, L, H, D) at (b, h); rows past L
// skipped
// (O: bf16, or float for the float32 partials a ring sums)
template <int D, typename O>
__device__ __forceinline__ void store_rows(O* dst, const float (&acc)[D / 8][4], int b, int h,
                                           int row0, int L, int H, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int l = row0 + gr + 8 * half;
    if (l >= L) continue;
    O* row = dst + row_offset(b, l, h, L, H, D);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if constexpr (std::is_same<O, float>::value) {
        *reinterpret_cast<float2*>(row + 8 * j + 2 * tq) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
      }
    }
  }
}

// ---- K6b --------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {
  return 6 * tile_elems<D>() * sizeof(bf16) + kTile * sizeof(float);
}

// S (in s) and dP of a warp's 16 query rows x 64 keys into dS, in place.
// kMask: the tile needs the causal or the ragged mask.
template <bool kMask>
__device__ __forceinline__ void dq_ds(float (&s)[8][4], const float (&dp)[8][4],
                                      const float (&ls)[2], const float (&dl)[2], int qi0,
                                      int kj0, int L, int causal, float scale, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // p = exp(s scale - lse) as exp2 of one FMA, log2(e) folded in
      float x = fmaf(s[j][e], scale * kLog2e, -ls[e >> 1] * kLog2e);
      if (kMask) {
        const int qi = qi0 + gr + 8 * (e >> 1), kj = kj0 + 8 * j + 2 * tq + (e & 1);
        const bool ok = kj < L && qi < L && (!causal || kj <= qi);
        x = ok ? x : -INFINITY;
      }
      const float p = exp2f(x);
      s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
    }
  }
}

template <int D, typename O>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ out,
                   const bf16* __restrict__ g, const float* __restrict__ lse,
                   O* __restrict__ dq, float* __restrict__ delta, int L, int H, int causal,
                   float scale) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* dOs = Qs + tile_elems<D>();
  bf16* KV = dOs + tile_elems<D>();  // buffer i: K at tile 2 i of KV, V at 2 i + 1
  float* delta_s = reinterpret_cast<float*>(KV + 4 * tile_elems<D>());
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;  // the longest causal rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_bh = (static_cast<size_t>(b) * H + h) * L;
  const int last = causal ? qt : n_tiles - 1;  // tiles above the diagonal: skipped
  const bool ragged = L % kTile != 0;

  load_tile_async<D>(Qs, q, b, h, qt * kTile, L, H);
  load_tile_async<D>(dOs, g, b, h, qt * kTile, L, H);
  load_tile_async<D>(KV, k, b, h, 0, L, H);
  load_tile_async<D>(KV + tile_elems<D>(), v, b, h, 0, L, H);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  {  // delta = rowsum(dO * O): two threads a row, D / 2 columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qi = qt * kTile + r;
    float part = 0.f;
    if (qi < L) {
      const bf16* o_row = out + row_offset(b, qi, h, L, H, D) + half * (D / 2);
      const bf16* do_row = dOs + r * stride<D>() + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o_row + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(do_row + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) part = fmaf(to_f(oe[e]), to_f(de[e]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      delta_s[r] = part;
      if (qi < L) delta[row_bh + qi] = part;
    }
  }
  __syncthreads();
  float ls[2], dl[2];  // rows 16 warp + lane / 4 + {0, 8}
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + (lane >> 2) + 8 * i, qi = qt * kTile + r;
    const float x = qi < L ? lse[row_bh + qi] : 0.f;
    ls[i] = x == -INFINITY ? 0.f : x;  // lse_safe
    dl[i] = delta_s[r];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) {  // the next K/V tile into the other buffer, in flight
      bf16* nxt = KV + 2 * ((kt + 1) & 1) * tile_elems<D>();
      load_tile_async<D>(nxt, k, b, h, (kt + 1) * kTile, L, H);
      load_tile_async<D>(nxt + tile_elems<D>(), v, b, h, (kt + 1) * kTile, L, H);
    }
    cp_commit();
    cp_wait<1>();  // this tile's group has landed
    __syncthreads();
    const bf16* Ks = KV + 2 * (kt & 1) * tile_elems<D>();
    const bf16* Vs = Ks + tile_elems<D>();
    float s[8][4] = {}, dp[8][4] = {};
    scores<D>(s, Qs, 16 * warp, Ks, lane);
    scores<D>(dp, dOs, 16 * warp, Vs, lane);
    const int qi0 = qt * kTile + 16 * warp, kj0 = kt * kTile;
    if ((causal && kt == qt) || (ragged && (kt == n_tiles - 1 || qt == n_tiles - 1))) {
      dq_ds<true>(s, dp, ls, dl, qi0, kj0, L, causal, scale, lane);
    } else {
      dq_ds<false>(s, dp, ls, dl, qi0, kj0, L, causal, scale, lane);
    }
    uint32_t a[4][4];
    to_a(a, s);  // dS in k's dtype, straight from the accumulators
    accumulate<D>(acc, a, Ks, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<D, O>(dq, acc, b, h, qt * kTile + 16 * warp, L, H, lane);
}

// ---- K6c --------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem() {
  return 6 * tile_elems<D>() * sizeof(bf16) + 4 * kTile * sizeof(float);
}

// A warp's transposed tile, Sᵀ (in st) and dPᵀ (in dpt) of 16 key rows x
// 64 query columns, into Pᵀ (in st) and dSᵀ (in dpt).  lse_s and delta_s
// hold the tile's 64 queries.  kMask: the tile needs the causal or the
// ragged mask.
template <bool kMask>
__device__ __forceinline__ void dkv_p_ds(float (&st)[8][4], float (&dpt)[8][4],
                                         const float* lse_s, const float* delta_s, int kj0,
                                         int qi0, int L, int causal, float scale, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 ls2 = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + c);
    const float ls[2] = {ls2.x == -INFINITY ? 0.f : ls2.x,  // lse_safe
                         ls2.y == -INFINITY ? 0.f : ls2.y};
    const float dl[2] = {dl2.x, dl2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(st[j][e], scale * kLog2e, -ls[e & 1] * kLog2e);  // as in K6b
      if (kMask) {
        const int kj = kj0 + gr + 8 * (e >> 1), qi = qi0 + c + (e & 1);
        const bool ok = kj < L && qi < L && (!causal || kj <= qi);
        x = ok ? x : -INFINITY;
      }
      const float p = exp2f(x);
      dpt[j][e] = p * (dpt[j][e] - dl[e & 1]) * scale;
      st[j][e] = p;
    }
  }
}

template <int D, typename O>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    O* __restrict__ dk, O* __restrict__ dv, int L, int H, int causal,
                    float scale) {
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);
  bf16* Vs = Ks + tile_elems<D>();
  bf16* QO = Vs + tile_elems<D>();  // buffer i: Q at tile 2 i of QO, dO at 2 i + 1
  float* rows_s = reinterpret_cast<float*>(QO + 4 * tile_elems<D>());  // buffer i: lse, delta
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // causal: the first K/V tiles meet the most Q tiles
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t row_bh = (static_cast<size_t>(b) * H + h) * L;
  const int first = causal ? kt : 0;  // tiles above the diagonal: skipped
  const bool ragged = L % kTile != 0;

  // Q tile qt (q, dO, and the lse and delta of its rows) into buffer i,
  // asynchronously: threads 0..63 copy lse, 64..127 delta
  auto load_q = [&](int qt, int i) {
    bf16* dst = QO + 2 * i * tile_elems<D>();
    load_tile_async<D>(dst, q, b, h, qt * kTile, L, H);
    load_tile_async<D>(dst + tile_elems<D>(), g, b, h, qt * kTile, L, H);
    const int qi = qt * kTile + (threadIdx.x & (kTile - 1));
    const float* src = threadIdx.x < kTile ? lse : delta;
    const bool in = qi < L;
    cp_async4(smem_u32(rows_s + 2 * kTile * i + threadIdx.x), in ? src + row_bh + qi : src, in);
  };
  load_tile_async<D>(Ks, k, b, h, kt * kTile, L, H);
  load_tile_async<D>(Vs, v, b, h, kt * kTile, L, H);
  load_q(first, 0);
  cp_commit();
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  }
  for (int qt = first, it = 0; qt < n_tiles; ++qt, ++it) {
    if (qt + 1 < n_tiles) load_q(qt + 1, (it + 1) & 1);  // in flight
    cp_commit();
    cp_wait<1>();  // this tile's group has landed
    __syncthreads();
    const bf16* Qs = QO + 2 * (it & 1) * tile_elems<D>();
    const bf16* dOs = Qs + tile_elems<D>();
    const float* lse_s = rows_s + 2 * kTile * (it & 1);
    const float* delta_s = lse_s + kTile;
    float st[8][4] = {}, dpt[8][4] = {};
    scores<D>(st, Ks, 16 * warp, Qs, lane);
    scores<D>(dpt, Vs, 16 * warp, dOs, lane);
    const int kj0 = kt * kTile + 16 * warp, qi0 = qt * kTile;
    if ((causal && qt == kt) || (ragged && (qt == n_tiles - 1 || kt == n_tiles - 1))) {
      dkv_p_ds<true>(st, dpt, lse_s, delta_s, kj0, qi0, L, causal, scale, lane);
    } else {
      dkv_p_ds<false>(st, dpt, lse_s, delta_s, kj0, qi0, L, causal, scale, lane);
    }
    uint32_t a[4][4];
    to_a(a, st);  // Pᵀ in dO's dtype, straight from the accumulators
    accumulate<D>(acc_v, a, dOs, lane);
    to_a(a, dpt);  // dSᵀ in q's dtype
    accumulate<D>(acc_k, a, Qs, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows<D, O>(dk, acc_k, b, h, kt * kTile + 16 * warp, L, H, lane);
  store_rows<D, O>(dv, acc_v, b, h, kt * kTile + 16 * warp, L, H, lane);
}

// ---- K6a --------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return 5 * tile_elems<D>() * sizeof(bf16);
}

// c[j] += Q · Kᵀ for the 8 n-tiles of a warp's 16 x 64 score block: the Q
// rows as A fragments in registers (qa[ks] for k-step ks), against the 64
// rows of the tile Bs
template <int D>
__device__ __forceinline__ void scores_q(float (&c)[8][4], const uint32_t (&qa)[D / 16][4],
                                         const bf16* Bs, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(Bs + b_off<D>(16 * np, 16 * ks, lane)));
      mma(c[2 * np], qa[ks], b[0], b[1]);
      mma(c[2 * np + 1], qa[ks], b[2], b[3]);
    }
  }
}

// One K/V tile of the online softmax (ring_attention.py's _block_update) on
// a warp's 16 query rows: s holds the raw scores Q·Kᵀ of rows gr (e < 2) and
// gr + 8 (e >= 2) and ends as p; mr is the running max of the raw scores,
// lp this lane's share of the running sum, o the output accumulator.  The
// scale is positive, so the max of the raw scores times it is JAX's max of
// the scaled ones, bit for bit; c = scale · log2(e) folds the exponent into
// one FMA.  kMask: the tile needs the causal or the ragged mask.
template <bool kMask, int D>
__device__ __forceinline__ void fwd_softmax(float (&s)[8][4], float (&mr)[2], float (&lp)[2],
                                            float (&o)[D / 8][4], int qi0, int kj0, int L,
                                            int causal, float c, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kMask) {
        const int qi = qi0 + gr + 8 * (e >> 1), kj = kj0 + 8 * j + 2 * tq + (e & 1);
        if (!(kj < L && (!causal || kj <= qi))) s[j][e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float corr[2], mc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's four lanes are one quad: lanes 4 gr .. 4 gr + 3
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(mr[i], mx[i]);
    // JAX's guards: m_safe = 0 while the max is -inf; the correction 0
    // while the previous max is -inf (o and l are still 0) or the new one is
    mc[i] = m_new == -INFINITY ? 0.f : m_new * c;
    corr[i] = (mr[i] == -INFINITY || m_new == -INFINITY) ? 0.f : exp2f((mr[i] - m_new) * c);
    mr[i] = m_new;
    lp[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));  // masked: exp2(-inf) = 0
      lp[e >> 1] += p;  // unrounded, as JAX's l_new
      s[j][e] = p;
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

template <int D, typename O>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, O* __restrict__ out, float* __restrict__ lse,
                int L, int H, int causal, float scale) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* KV = Qs + tile_elems<D>();  // buffer i: K at tile 2 i of KV, V at 2 i + 1
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;  // the longest causal rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int last = causal ? qt : n_tiles - 1;  // tiles above the diagonal: skipped
  const bool ragged = L % kTile != 0;
  const float c = scale * kLog2e;

  load_tile_async<D>(Qs, q, b, h, qt * kTile, L, H);
  load_tile_async<D>(KV, k, b, h, 0, L, H);
  load_tile_async<D>(KV + tile_elems<D>(), v, b, h, 0, L, H);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t qa[D / 16][4];  // the warp's 16 Q rows, held for the whole walk
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldsm_x4(qa[ks], smem_u32(Qs + a_off<D>(16 * warp, 16 * ks, lane)));
  }
  float o[D / 8][4], mr[2] = {-INFINITY, -INFINITY}, lp[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    if (kt < last) {  // the next K/V tile into the other buffer, in flight
      bf16* nxt = KV + 2 * ((kt + 1) & 1) * tile_elems<D>();
      load_tile_async<D>(nxt, k, b, h, (kt + 1) * kTile, L, H);
      load_tile_async<D>(nxt + tile_elems<D>(), v, b, h, (kt + 1) * kTile, L, H);
    }
    cp_commit();
    cp_wait<1>();  // this tile's group has landed
    __syncthreads();
    const bf16* Ks = KV + 2 * (kt & 1) * tile_elems<D>();
    const bf16* Vs = Ks + tile_elems<D>();
    float s[8][4] = {};
    scores_q<D>(s, qa, Ks, lane);
    const int qi0 = qt * kTile + 16 * warp, kj0 = kt * kTile;
    if ((causal && kt == qt) || (ragged && kt == n_tiles - 1)) {
      fwd_softmax<true, D>(s, mr, lp, o, qi0, kj0, L, causal, c, lane);
    } else {
      fwd_softmax<false, D>(s, mr, lp, o, qi0, kj0, L, causal, c, lane);
    }
    uint32_t a[4][4];
    to_a(a, s);  // P in v's dtype, straight from the accumulators
    accumulate<D>(o, a, Vs, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // out = o / max(l, 1e-30), cast last; lse = m + log(l) in natural-log
  // units, m the raw max times the scale (JAX's m); a fully masked row
  // keeps m = -inf, so lse = -inf and out = 0
  const size_t row_bh = (static_cast<size_t>(b) * H + h) * L;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = lp[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lsum = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][2 * i] /= lsum;
      o[j][2 * i + 1] /= lsum;
    }
    const int qi = qt * kTile + 16 * warp + (lane >> 2) + 8 * i;
    if ((lane & 3) == 0 && qi < L) lse[row_bh + qi] = mr[i] * scale + logf(lsum);
  }
  store_rows<D, O>(out, o, b, h, qt * kTile + 16 * warp, L, H, lane);
}

}  // namespace tc

// ---- launches -------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  // above 48 KB only as opted-in dynamic shared memory; set on every call
  // (cheap, and safe across devices)
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int D, typename O>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int L,
               int H, int causal, float scale, cudaStream_t s) {
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // the tensor cores
    constexpr size_t smem = tc::fwd_smem<D>();
    if (int rc = prepare(tc::attn_fwd_tc<D, O>, smem)) return rc;
    tc::attn_fwd_tc<D, O><<<grid, tc::kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<O*>(out), static_cast<float*>(lse), L, H, causal, scale);
  } else {
    constexpr size_t smem = fwd_smem<T, D>();
    if (int rc = prepare(attn_fwd_kernel<T, D>, smem)) return rc;
    attn_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), static_cast<float*>(lse), L, H, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename O>
int launch_dq(const void* q, const void* k, const void* v, const void* out, const void* g,
              const void* lse, void* dq, void* delta, int B, int L, int H, int causal,
              float scale, cudaStream_t s) {
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // the tensor cores
    constexpr size_t smem = tc::dq_smem<D>();
    if (int rc = prepare(tc::attn_bwd_dq_tc<D, O>, smem)) return rc;
    tc::attn_bwd_dq_tc<D, O><<<grid, tc::kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(out), static_cast<const T*>(g), static_cast<const float*>(lse),
        static_cast<O*>(dq), static_cast<float*>(delta), L, H, causal, scale);
  } else {
    constexpr size_t smem = dq_smem<T, D>();
    if (int rc = prepare(attn_bwd_dq_kernel<T, D>, smem)) return rc;
    attn_bwd_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(out), static_cast<const T*>(g), static_cast<const float*>(lse),
        static_cast<T*>(dq), static_cast<float*>(delta), L, H, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, typename O>
int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, void* dk, void* dv, int B, int L, int H, int causal,
               float scale, cudaStream_t s) {
  const dim3 grid(B * H, (L + kTile - 1) / kTile);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {  // the tensor cores
    constexpr size_t smem = tc::dkv_smem<D>();
    if (int rc = prepare(tc::attn_bwd_dkv_tc<D, O>, smem)) return rc;
    tc::attn_bwd_dkv_tc<D, O><<<grid, tc::kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<O*>(dk), static_cast<O*>(dv), L, H,
        causal, scale);
  } else {
    constexpr size_t smem = dkv_smem<T, D>();
    if (int rc = prepare(attn_bwd_dkv_kernel<T, D>, smem)) return rc;
    attn_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(g), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), L, H,
        causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int L, int H, int D) {
  return B >= 1 && L >= 1 && H >= 1 && (D == 16 || D == 32 || D == 64 || D == 128) &&
         static_cast<long long>(B) * H <= 0x7fffffffLL && (L + kTile - 1) / kTile <= 65535;
}

}  // namespace

// Dispatch on dtype (0 float32, 1 bfloat16), the output dtype out_f32 (0:
// the input's, 1: float32; a float32 input stores float32 either way) and
// head dim D in {16, 32, 64, 128}, anything else cudaErrorInvalidValue.
#define TF_DISPATCH_D(LAUNCH, T, O, ...)                                   \
  switch (D) {                                                            \
    case 16: return LAUNCH<T, 16, O>(__VA_ARGS__, s);                      \
    case 32: return LAUNCH<T, 32, O>(__VA_ARGS__, s);                      \
    case 64: return LAUNCH<T, 64, O>(__VA_ARGS__, s);                      \
    case 128: return LAUNCH<T, 128, O>(__VA_ARGS__, s);                    \
  }

#define TF_DISPATCH(LAUNCH, ...)                                            \
  do {                                                                      \
    if (!valid_shape(B, L, H, D)) return (int)cudaErrorInvalidValue;        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                     \
    if (dtype == 0) {                                                       \
      TF_DISPATCH_D(LAUNCH, float, float, __VA_ARGS__)                      \
    } else if (dtype == 1 && out_f32) {                                     \
      TF_DISPATCH_D(LAUNCH, __nv_bfloat16, float, __VA_ARGS__)              \
    } else if (dtype == 1) {                                                \
      TF_DISPATCH_D(LAUNCH, __nv_bfloat16, __nv_bfloat16, __VA_ARGS__)      \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

// q, k, v: (B, L, H, D) contiguous, 16-byte aligned, in the dtype; out
// likewise, in float32 when out_f32; lse: (B, H, L) float32.  scale is
// 1 / sqrt(D).
extern "C" int tf_blockwise_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int L, int H, int D, int causal,
                                          float scale, int dtype, int out_f32, void* stream) {
  TF_DISPATCH(launch_fwd, q, k, v, out, lse, B, L, H, causal, scale);
}

// As the forward; g (the upstream gradient, dO) like q; lse from the
// forward; dq like out; delta: (B, H, L) float32, written.
extern "C" int tf_blockwise_attention_bwd_dq(const void* q, const void* k, const void* v,
                                             const void* out, const void* g, const void* lse,
                                             void* dq, void* delta, int B, int L, int H, int D,
                                             int causal, float scale, int dtype, int out_f32,
                                             void* stream) {
  TF_DISPATCH(launch_dq, q, k, v, out, g, lse, dq, delta, B, L, H, causal, scale);
}

// As the forward; delta from tf_blockwise_attention_bwd_dq; dk and dv like
// out.
extern "C" int tf_blockwise_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                              const void* g, const void* lse, const void* delta,
                                              void* dk, void* dv, int B, int L, int H, int D,
                                              int causal, float scale, int dtype, int out_f32,
                                              void* stream) {
  TF_DISPATCH(launch_dkv, q, k, v, g, lse, delta, dk, dv, B, L, H, causal, scale);
}
