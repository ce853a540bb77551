// An empty kernel: the least time a launch of this port's kernels takes.
//
// It replaces no TPU kernel and runs on no path.  It is launched the way
// every kernel of the port is launched (a plain C function loaded with
// ctypes, called from Python on PyTorch's current stream), so its time by
// CUDA events holds exactly the overhead that every kernel's time holds:
// the ctypes call, the launch, the block's start and retirement, and the
// events themselves.  A kernel whose byte or operation bound lies far
// below this floor is judged against the floor instead.
//
// One block of one warp, no arguments, no memory traffic.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel on `stream` (on the calling thread's current
// device).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int tf_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
