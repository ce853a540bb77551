// MoE dispatch and combine for Hopper (sm_90a): the row copies of a top-k
// mixture of experts (K9a-K9c), in float32 or bfloat16 with float32
// arithmetic.
//
// Replaces the fused path of tpuframe/ops/moe_gating.py
// (moe_dispatch_combine, :90), which the JAX package registers as a kernel
// (kernel_enabled("moe_gating")) but writes as plain XLA: a scatter-add of
// the kept token rows into the zero-initialised (E, C, D) expert buffers
// and a gather back.
//   K9a  dispatch (the forward): every row of the (E_local, C, D) buffer.
//        Row slot_f of expert e_f is src[f % N, :] for every slot f of the
//        (k * N,) choice-major frame whose expert is held here (e_f >= 0);
//        every other row is +0.  Every destination row is distinct: no
//        atomics.
//   K9b  combine: out[n, :] = sum_{j < k} w[j * N + n] * buf[e, slot, :]
//        over the slots of token n held here, j in order, each product and
//        each sum rounded to float32 (no FMA contraction: JAX's multiply,
//        then its scatter-add); w is gate * keep in the forward and keep
//        in the backward of the dispatch.
//   K9c  the combine's backward, one launch: dbuf, every row of an
//        (E_local, C, D) buffer, w_f * g[f % N, :] (rounded once) at the
//        held slots' rows and +0 elsewhere, as K9a lays out the forward;
//        and dgate_f = <g[f % N, :], buf[e_f, slot_f, :]>, a float32 dot
//        a slot (+0 where the slot is not held here).
//
// The slot descriptors come from the routing (ops/moe_gating.py): e_f the
// local expert of slot f (its expert minus this rank's first; -1 where the
// slot was dropped, its expert is held elsewhere or it is not this rank's
// token) and slot_f its row in that expert's buffer, both int32; count_e
// the held slots of expert e.  The routing gives expert e's held slots the
// rows 0 .. count_e - 1 in choice-major order, so K9a and K9c know without
// a search that rows count_e .. C - 1 are the ones to zero.
//
// Bound: bytes, each read and written once (chip_smoke.py counts this
// run's held slots).  At the MoE path's 4,096 tokens a rank, D = 768 in
// bf16, top 2, 4 of 8 experts held (~4,000 held slots, a 15.7 MB buffer):
// K9a reads the held rows and writes the whole buffer (21.8 MB, 6.5 us at
// 3.35 TB/s); K9b reads the held rows and writes (N, D) (12.3 MB); K9c
// reads the held rows of g and of the buffer and writes the whole dbuf and
// dgate (28.1 MB, 8.4 us).  At Mixtral's width (8,192 tokens, D = 4,096,
// all 8 experts held, C = 2,560) K9a moves 302 MB, K9b 201 MB and K9c 436
// MB: 90, 60 and 130 us.
//
// Design.  At the path's shape the bytes take less time than a launch, so
// the time is the chain of trips to memory, and the kernels keep it to two:
// the descriptors, then every row a lane needs, loaded before any
// arithmetic or store.  Lanes move 16 bytes an access (8 bf16 or 4 f32)
// where the row pitch and the base pointers allow it (checked at launch),
// else one element; both are this kernel.
// - K9b: one warp a token.  K is a template parameter (1 .. 8): lane j
//   loads choice j's descriptor and weight and the warp shares them by
//   shuffle; a round of columns loads R = 8 / K accesses a lane of each of
//   the K rows, then sums each column over j in order (__fmul_rn,
//   __fadd_rn, one final rounding, as the plain version), then stores.
//   At D = 768 bf16 one round is the row: 3 accesses a lane, 6 loads in
//   flight at top 2.  K > 8 takes a generic loop over j, which at top 2
//   ran 2-3 % slower than the instance on an H100, beyond the spread of
//   either (tests/csrc/moe_combine_any_k.cu, timed by chip_smoke.py).
//   (4 warps a block, 2 or 4 tokens a warp, twice the round depth and
//   __ldg descriptors measured no faster on the card: the time there is
//   the launch plus the bytes.)
// - K9a and K9c are one template (dispatch_kernel<T, V, Backward>): a
//   block takes 16 slots and compacts the held ones into shared memory (a
//   ballot), so a slot not held here costs no warp; its 8 warps copy them,
//   each issuing up to 8 accesses a lane before its stores.  Then every
//   warp of the grid writes zero rows: the zero rows of all experts are
//   numbered in order (a prefix over C - count_e, in shared memory), and
//   warp i takes rows i, i + warps, ...  One launch writes the buffer;
//   nothing zero-fills it first.
// - K9c is that template's backward instance: the g row it scales is the
//   row its dot needs, and the dbuf row it writes sits at the index of the
//   buf row of the dot, so one launch reads each held g row once (the two
//   launches before it read g twice).  A round issues both rows' accesses,
//   4 of each a lane, before any arithmetic: 64 registers, so 4 blocks an
//   SM (8 of each took 126 registers, 2 blocks an SM, and ran slower at the
//   path's shape on an H100, PERF.md §6).  The
//   compaction's warp writes dgate = +0 for the block's slots not held
//   here, so every dgate entry is written exactly once.  The dot's order is
//   fixed by D and the access width alone: each lane sums its own columns
//   of one slot in column order (float32 products, __fmul_rn then
//   __fadd_rn; bf16 x bf16 is exact in float32), carried across rounds,
//   and the warp adds the 32 partials by butterfly shuffles once the slot's
//   last columns are in.  So a rerun, or the same rows at another slot,
//   gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 8;              // top-k up to which K9b is unrolled over k
constexpr int kSlotsPerBlock = 16;    // K9a/K9c: slots a block compacts (<= 32: one ballot)
constexpr int kDispatchRound = 8;     // K9a: accesses a lane issues before its stores
constexpr int kBackwardRound = 4;     // K9c: accesses of each of its two rows a round
constexpr int kMaxExperts = 8192;     // the zero-row prefix in 32 KB of shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ size_t buf_row(int e, int slot, int capacity, int D) {
  return (static_cast<size_t>(e) * capacity + slot) * D;
}

// One access of V elements of T: V = 1 (an element), or 16 bytes (a uint4
// of 4 f32 or 8 bf16).  get/set read and write element i as float32.
template <typename T, int V>
struct Access;

template <typename T>
struct Access<T, 1> {
  using Raw = T;
  __device__ static float get(const Raw& r, int) { return to_f(r); }
  __device__ static void set(Raw& r, int, float x) { r = from_f<T>(x); }
  __device__ static Raw zero() { return from_f<T>(0.f); }
};

template <>
struct Access<float, 4> {
  using Raw = uint4;
  __device__ static float get(const Raw& r, int i) { return __uint_as_float((&r.x)[i]); }
  __device__ static void set(Raw& r, int i, float x) { (&r.x)[i] = __float_as_uint(x); }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

template <>
struct Access<__nv_bfloat16, 8> {  // element 2i in the low half of word i
  using Raw = uint4;
  __device__ static float get(const Raw& r, int i) {
    const unsigned u = (&r.x)[i / 2];
    return __uint_as_float(i % 2 ? u & 0xffff0000u : u << 16);
  }
  __device__ static void set(Raw& r, int i, float x) {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    unsigned& u = (&r.x)[i / 2];
    u = i % 2 ? (u & 0x0000ffffu) | (b << 16) : (u & 0xffff0000u) | b;
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

template <typename T>
constexpr int kVec = 16 / sizeof(T);

// ---- K9a and K9c: dispatch and the combine's backward ------------------------

// Backward false, K9a: buf = the tokens src at the held slots' rows.
// Backward true, K9c: buf = dbuf, src = g scaled by the gate weights
// scale, and dgate[f] = <src row, fwd row> with fwd the forward's buffer.
template <typename T, int V, bool Backward>
__global__ void __launch_bounds__(kThreads)
    dispatch_kernel(const T* __restrict__ src, T* __restrict__ buf,
                    const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                    const float* __restrict__ scale, const int32_t* __restrict__ count,
                    const T* __restrict__ fwd, float* __restrict__ dgate, int N, int KN, int D,
                    int capacity, int e_local) {
  using A = Access<T, V>;
  using Raw = typename A::Raw;
  extern __shared__ int zero_before[];  // [e_local + 1]: zero rows of the experts before e
  __shared__ int held_src[kSlotsPerBlock], held_dst[kSlotsPerBlock], held_f[kSlotsPerBlock];
  __shared__ float held_scale[kSlotsPerBlock];
  __shared__ int n_held;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = D / V;  // accesses a row

  if (warp == 0) {  // compact this block's held slots, in slot order
    const int f = blockIdx.x * kSlotsPerBlock + lane;
    const bool mine = lane < kSlotsPerBlock && f < KN;
    const int e = mine ? e_loc[f] : -1;
    const int s = mine ? slot[f] : 0;
    const float sc = Backward && mine ? scale[f] : 1.f;
    const unsigned held = __ballot_sync(kFull, e >= 0);
    if (e >= 0) {
      const int i = __popc(held & ((1u << lane) - 1u));
      held_src[i] = f % N;
      held_dst[i] = e * capacity + s;
      held_scale[i] = sc;
      if (Backward) held_f[i] = f;
    } else if (Backward && mine) {
      dgate[f] = 0.f;  // a slot not held here: its one write
    }
    if (lane == 0) n_held = __popc(held);
  } else if (warp == 1) {  // inclusive warp scans of C - count_e, carried over chunks of 32
    int carry = 0;
    for (int base = 0; base < e_local; base += 32) {
      const int e = base + lane;
      int z = e < e_local ? capacity - min(max(count[e], 0), capacity) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, z, o);
        if (lane >= o) z += t;
      }
      if (e < e_local) zero_before[e + 1] = carry + z;
      carry += __shfl_sync(kFull, z, 31);
    }
    if (lane == 0) zero_before[0] = 0;
  }
  __syncthreads();

  // the held rows: warp w copies entries w, w + 8, ...; a lane's accesses
  // over its entries in order (task t: entry t / per_row, columns
  // lane + 32 (t mod per_row)), R of each row loaded before any arithmetic
  // or store.  Entry, chunk and the round's end are the same for every lane
  // of the warp.
  constexpr int R = Backward ? kBackwardRound : kDispatchRound;
  const int per_row = (nv + 31) / 32;
  const int mine = n_held > warp ? (n_held - warp + kWarps - 1) / kWarps : 0;
  const int tasks = mine * per_row;
  float part = 0.f;  // K9c: this lane's sum over its columns of the current entry
  for (int t0 = 0; t0 < tasks; t0 += R) {
    Raw x[R], y[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r, q = t / per_row, c = lane + 32 * (t - q * per_row);
      if (t < tasks && c < nv) {
        const int i = warp + kWarps * q;
        x[r] = reinterpret_cast<const Raw*>(src + static_cast<size_t>(held_src[i]) * D)[c];
        if (Backward) {
          y[r] = reinterpret_cast<const Raw*>(fwd + static_cast<size_t>(held_dst[i]) * D)[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r, q = t / per_row, j = t - q * per_row, c = lane + 32 * j;
      const int i = warp + kWarps * q;
      if (t < tasks && c < nv) {
        Raw z = x[r];
        if (Backward) {
          const float sc = held_scale[i];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float gv = A::get(x[r], v);
            A::set(z, v, __fmul_rn(sc, gv));
            part = __fadd_rn(part, __fmul_rn(gv, A::get(y[r], v)));
          }
        }
        reinterpret_cast<Raw*>(buf + static_cast<size_t>(held_dst[i]) * D)[c] = z;
      }
      if (Backward && t < tasks && j == per_row - 1) {  // the entry's last columns are in
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(kFull, part, o));
        if (lane == 0) dgate[held_f[i]] = part;
        part = 0.f;
      }
    }
  }

  // the zero rows: rows C - zeros_e .. C - 1 of each expert, numbered in order
  const int zeros = zero_before[e_local];
  const int warps = gridDim.x * kWarps;
  for (int z = blockIdx.x * kWarps + warp; z < zeros; z += warps) {
    int lo = 0, hi = e_local - 1;  // the expert e with zero_before[e] <= z < zero_before[e + 1]
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (zero_before[mid + 1] > z) hi = mid; else lo = mid + 1;
    }
    const int row = capacity - zero_before[lo + 1] + z;
    Raw* dst = reinterpret_cast<Raw*>(buf + buf_row(lo, row, capacity, D));
    for (int c = lane; c < nv; c += 32) dst[c] = A::zero();
  }
}

// ---- K9b: combine -----------------------------------------------------------

// K a compile-time top-k (1 .. kMaxK): the token's K descriptors in
// registers, R = kMaxK / K accesses a lane of each row in flight a round
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ buf, const float* __restrict__ w,
                   const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                   T* __restrict__ out, int N, int D, int capacity) {
  using A = Access<T, V>;
  using Raw = typename A::Raw;
  constexpr int R = kMaxK / K;
  const int n = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (n >= N) return;
  const int nv = D / V;
  int e = -1, s = 0;
  float wl = 0.f;
  if (lane < K) {  // lane j holds choice j's descriptor and weight
    const int f = lane * N + n;
    e = e_loc[f];
    s = slot[f];
    wl = w[f];
  }
  const Raw* rows[K];
  float ws[K];
  bool held[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int ej = __shfl_sync(kFull, e, j), sj = __shfl_sync(kFull, s, j);
    ws[j] = __shfl_sync(kFull, wl, j);
    held[j] = ej >= 0;
    rows[j] = reinterpret_cast<const Raw*>(buf + (held[j] ? buf_row(ej, sj, capacity, D) : 0));
  }
  Raw* dst = reinterpret_cast<Raw*>(out + static_cast<size_t>(n) * D);
  for (int c0 = 0; c0 < nv; c0 += 32 * R) {
    Raw x[K][R];
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = c0 + 32 * r + lane;
        if (held[j] && c < nv) x[j][r] = rows[j][c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = c0 + 32 * r + lane;
      if (c >= nv) continue;
      Raw o;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < K; ++j) {  // j in order, as the plain version sums
          if (held[j]) acc = __fadd_rn(acc, __fmul_rn(ws[j], A::get(x[j][r], v)));
        }
        A::set(o, v, acc);
      }
      dst[c] = o;
    }
  }
}

// K > kMaxK: the same sums, one choice at a time, R accesses a lane a round
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    combine_any_k_kernel(const T* __restrict__ buf, const float* __restrict__ w,
                         const int32_t* __restrict__ e_loc, const int32_t* __restrict__ slot,
                         T* __restrict__ out, int N, int K, int D, int capacity) {
  using A = Access<T, V>;
  using Raw = typename A::Raw;
  constexpr int R = 4;
  const int n = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (n >= N) return;
  const int nv = D / V;
  Raw* dst = reinterpret_cast<Raw*>(out + static_cast<size_t>(n) * D);
  for (int c0 = 0; c0 < nv; c0 += 32 * R) {
    float acc[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
    }
    for (int j = 0; j < K; ++j) {  // j in order, as the plain version sums
      const int f = j * N + n, e = e_loc[f];
      if (e < 0) continue;
      const float wj = w[f];
      const Raw* row = reinterpret_cast<const Raw*>(buf + buf_row(e, slot[f], capacity, D));
      Raw x[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = c0 + 32 * r + lane;
        if (c < nv) x[r] = row[c];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (c0 + 32 * r + lane >= nv) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[r][v] = __fadd_rn(acc[r][v], __fmul_rn(wj, A::get(x[r], v)));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = c0 + 32 * r + lane;
      if (c >= nv) continue;
      Raw o;
#pragma unroll
      for (int v = 0; v < V; ++v) A::set(o, v, acc[r][v]);
      dst[c] = o;
    }
  }
}

inline unsigned blocks(long long rows, int per_block) {
  return static_cast<unsigned>((rows + per_block - 1) / per_block);
}

bool valid(int N, int K, int D, int capacity) {
  return N >= 1 && K >= 1 && D >= 1 && capacity >= 1 &&
         static_cast<long long>(N) * K <= 0x7fffffffLL;
}

// 16-byte accesses where every row of every tensor starts on 16 bytes (c
// null where a launch has two row tensors)
template <typename T>
bool vectors_fit(int D, const void* a, const void* b, const void* c = nullptr) {
  auto on16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return (static_cast<size_t>(D) * sizeof(T)) % 16 == 0 && on16(a) && on16(b) && on16(c);
}

// K9a (fwd and dgate null) or K9c
template <typename T, int V, bool Backward>
int launch_dispatch(const T* src, T* buf, const int32_t* e, const int32_t* sl, const float* sc,
                    const int32_t* cnt, const T* fwd, float* dgate, int N, int K, int D,
                    int capacity, int e_local, cudaStream_t s) {
  const long long KN = static_cast<long long>(N) * K;
  // enough warps for the copies (a block a 16 slots), and at most 4 zero rows a warp
  const unsigned grid = std::max(blocks(KN, kSlotsPerBlock),
                            blocks(static_cast<long long>(e_local) * capacity, 4 * kWarps));
  const size_t smem = sizeof(int) * (e_local + 1);
  dispatch_kernel<T, V, Backward><<<grid, kThreads, smem, s>>>(
      src, buf, e, sl, sc, cnt, fwd, dgate, N, (int)KN, D, capacity, e_local);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_combine(const T* buf, const float* w, const int32_t* e, const int32_t* sl, T* out,
                   int N, int K, int D, int capacity, cudaStream_t s) {
  const unsigned grid = blocks(N, kWarps);
  switch (K) {
#define TF_COMBINE_K(k)                                                                    \
  case k:                                                                                \
    combine_kernel<T, V, k><<<grid, kThreads, 0, s>>>(buf, w, e, sl, out, N, D, capacity); \
    break;
    TF_COMBINE_K(1)
    TF_COMBINE_K(2)
    TF_COMBINE_K(3)
    TF_COMBINE_K(4)
    TF_COMBINE_K(5)
    TF_COMBINE_K(6)
    TF_COMBINE_K(7)
    TF_COMBINE_K(8)
#undef TF_COMBINE_K
    default:
      combine_any_k_kernel<T, V><<<grid, kThreads, 0, s>>>(buf, w, e, sl, out, N, K, D, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Backward>
int dispatch_as(const void* src, void* buf, const void* e, const void* sl, const void* sc,
                const void* cnt, const void* fwd, void* dgate, int N, int K, int D, int capacity,
                int e_local, cudaStream_t s) {
  auto* x = static_cast<const T*>(src);
  auto* b = static_cast<T*>(buf);
  auto* ei = static_cast<const int32_t*>(e);
  auto* si = static_cast<const int32_t*>(sl);
  auto* f = static_cast<const float*>(sc);
  auto* c = static_cast<const int32_t*>(cnt);
  auto* y = static_cast<const T*>(fwd);
  auto* dg = static_cast<float*>(dgate);
  return vectors_fit<T>(D, src, buf, fwd)
             ? launch_dispatch<T, kVec<T>, Backward>(x, b, ei, si, f, c, y, dg, N, K, D,
                                                     capacity, e_local, s)
             : launch_dispatch<T, 1, Backward>(x, b, ei, si, f, c, y, dg, N, K, D, capacity,
                                               e_local, s);
}

template <typename T>
int combine_as(const void* buf, const void* w, const void* e, const void* sl, void* out, int N,
               int K, int D, int capacity, cudaStream_t s) {
  auto* b = static_cast<const T*>(buf);
  auto* wf = static_cast<const float*>(w);
  auto* ei = static_cast<const int32_t*>(e);
  auto* si = static_cast<const int32_t*>(sl);
  auto* o = static_cast<T*>(out);
  return vectors_fit<T>(D, buf, out)
             ? launch_combine<T, kVec<T>>(b, wf, ei, si, o, N, K, D, capacity, s)
             : launch_combine<T, 1>(b, wf, ei, si, o, N, K, D, capacity, s);
}

bool valid_buffer(int N, int K, int D, int capacity, int e_local) {
  return valid(N, K, D, capacity) && e_local >= 1 && e_local <= kMaxExperts &&
         static_cast<long long>(e_local) * capacity <= 0x7fffffffLL;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (src, g, buf, dbuf, out); anything else, or
// a shape out of range, cudaErrorInvalidValue.  Index and weight arrays are
// (K * N,) choice-major: int32 e_loc and slot, float32 w and dgate; count
// is (e_local,) int32.

extern "C" int tf_moe_dispatch(const void* src, void* buf, const void* e_loc, const void* slot,
                               const void* count, int N, int K, int D, int capacity, int e_local,
                               int dtype, void* stream) {
  if (!valid_buffer(N, K, D, capacity, e_local)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_as<float, false>(src, buf, e_loc, slot, nullptr, count, nullptr, nullptr, N,
                                     K, D, capacity, e_local, s);
  }
  if (dtype == 1) {
    return dispatch_as<__nv_bfloat16, false>(src, buf, e_loc, slot, nullptr, count, nullptr,
                                             nullptr, N, K, D, capacity, e_local, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int tf_moe_combine(const void* buf, const void* w, const void* e_loc, const void* slot,
                              void* out, int N, int K, int D, int capacity, int dtype,
                              void* stream) {
  if (!valid(N, K, D, capacity)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return combine_as<float>(buf, w, e_loc, slot, out, N, K, D, capacity, s);
  if (dtype == 1) return combine_as<__nv_bfloat16>(buf, w, e_loc, slot, out, N, K, D, capacity, s);
  return (int)cudaErrorInvalidValue;
}

// K9c: g (N, D) the combine's cotangent, buf (E_local, C, D) its forward
// input, w (K * N,) its weights; writes every row of dbuf (E_local, C, D)
// and every entry of dgate (K * N,).
extern "C" int tf_moe_combine_backward(const void* g, const void* buf, const void* w,
                                       const void* e_loc, const void* slot, const void* count,
                                       void* dbuf, void* dgate, int N, int K, int D,
                                       int capacity, int e_local, int dtype, void* stream) {
  if (!valid_buffer(N, K, D, capacity, e_local)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_as<float, true>(g, dbuf, e_loc, slot, w, count, buf, dgate, N, K, D, capacity,
                                    e_local, s);
  }
  if (dtype == 1) {
    return dispatch_as<__nv_bfloat16, true>(g, dbuf, e_loc, slot, w, count, buf, dgate, N, K, D,
                                            capacity, e_local, s);
  }
  return (int)cudaErrorInvalidValue;
}
