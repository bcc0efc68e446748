// An empty kernel, for the cost model's launch and per-block overheads.
//
// chip_smoke.py times back-to-back launches of it with CUDA events: one
// block a launch gives the launch overhead, a launch of many blocks the
// extra time a block costs (core/altune/costmodel.py LAUNCH_OVERHEAD_S and
// STEP_OVERHEAD_S). It replaces no TPU kernel and does no work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launch `launches` empty kernels of `blocks` blocks of `threads` threads.
int launch_probe(int64_t blocks, int32_t threads, int32_t launches, cudaStream_t stream) {
  if (blocks <= 0 || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  for (int32_t i = 0; i < launches; ++i) {
    empty_kernel<<<static_cast<unsigned int>(blocks), threads, 0, stream>>>();
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
