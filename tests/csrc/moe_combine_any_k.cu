// For timing only: the MoE combine (K9b) through its generic loop over the
// top-k (combine_any_k_kernel) at any K, also the K <= 8 that
// tf_moe_combine gives to its top-k instances (combine_kernel<T, V, K>).
// chip_smoke.py builds this file with the port's flags and times it in
// turns against tf_moe_combine on the same inputs: what the instances gain
// over the one generic kernel.  Nothing of tpuframe_torch loads it.
//
// It compiles the port's source itself, so the two kernels are those of
// the same checkout; the entry point below only picks the kernel.

#include "../../tpuframe_torch/csrc/moe_gating.cu"

namespace {

template <typename T, int V>
int launch_any_k(const void* buf, const void* w, const void* e, const void* sl, void* out, int N,
                 int K, int D, int capacity, cudaStream_t s) {
  combine_any_k_kernel<T, V><<<blocks(N, kWarps), kThreads, 0, s>>>(
      static_cast<const T*>(buf), static_cast<const float*>(w), static_cast<const int32_t*>(e),
      static_cast<const int32_t*>(sl), static_cast<T*>(out), N, K, D, capacity);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int any_k_as(const void* buf, const void* w, const void* e, const void* sl, void* out, int N,
             int K, int D, int capacity, cudaStream_t s) {
  return vectors_fit<T>(D, buf, out)
             ? launch_any_k<T, kVec<T>>(buf, w, e, sl, out, N, K, D, capacity, s)
             : launch_any_k<T, 1>(buf, w, e, sl, out, N, K, D, capacity, s);
}

}  // namespace

// tf_moe_combine's arguments and codes
extern "C" int tf_moe_combine_any_k(const void* buf, const void* w, const void* e_loc,
                                    const void* slot, void* out, int N, int K, int D,
                                    int capacity, int dtype, void* stream) {
  if (!valid(N, K, D, capacity)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return any_k_as<float>(buf, w, e_loc, slot, out, N, K, D, capacity, s);
  if (dtype == 1) return any_k_as<__nv_bfloat16>(buf, w, e_loc, slot, out, N, K, D, capacity, s);
  return (int)cudaErrorInvalidValue;
}
