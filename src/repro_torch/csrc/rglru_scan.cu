// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t.
//
// Replaces the Pallas TPU kernel _rglru_kernel
// (src/repro/kernels/rglru_scan/kernel.py:25, launcher rglru_scan_tiled,
// entry ops.rglru_scan): a, b (B, S, D) and h0 (B, D), float32 or bfloat16;
// the state is carried in float32 and each step's state is written in a's
// dtype.
//
// What bounds it on this card: bytes. Per element it reads a and b and
// writes h, 12 B in float32, against one multiply and one add; at altune's
// production shape, (8, 4096, 4096) float32, that is 1.61 GB, ~0.48 ms at
// 3.35 TB/s. The dependence runs only along time, so the parallelism is
// B * D channels (32,768 at that shape) and a thread walks its channel's S
// steps in order: the loads, not the arithmetic, are on the critical path.
//
// The tile (BD, BS) is the kernel's timing parameter set (ScanConfig): one
// instantiation per member of kernels/rglru_scan/ops.CANDIDATES (SCAN_TILES
// below). BD is the channels (threads) of a block; BS is how many time
// steps' a and b loads a thread issues before the dependent arithmetic
// that consumes them: 2 * BS loads in flight a thread, the knob that sets
// the memory-level parallelism with so few threads. Neighbouring threads
// read neighbouring channels, so every load and store of a warp is one
// contiguous 128 B (float32) row segment. Ragged D and S are masked in
// place (threads past D exit; steps past S are neither loaded nor stored),
// so no padding copy is made. Offsets are 64-bit.
//
// Numerics: bitwise equal to the plain version (ref.rglru_scan_plain):
// __fmul_rn then __fadd_rn, two roundings as torch's two ops (never an
// FMA), float32 carry, round to nearest even into bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BD, int BS, typename T>
__global__ void __launch_bounds__(BD)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ h0,
             T* __restrict__ out, int64_t s, int64_t d) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * BD + threadIdx.x;
  if (c >= d) return;
  const int64_t bi = blockIdx.y;
  float h = to_f(h0[bi * d + c]);
  const int64_t base = bi * s * d + c;
  const int64_t full = s - s % BS;
  for (int64_t t0 = 0; t0 < full; t0 += BS) {
    float av[BS], bv[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      const int64_t at = base + (t0 + j) * d;
      av[j] = to_f(a[at]);
      bv[j] = to_f(b[at]);
    }
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      h = __fadd_rn(__fmul_rn(av[j], h), bv[j]);
      out[base + (t0 + j) * d] = from_f<T>(h);
    }
  }
  if (full < s) {  // the ragged tail: fewer than BS steps
    float av[BS], bv[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      const int64_t at = base + (full + j) * d;
      av[j] = full + j < s ? to_f(a[at]) : 1.f;
      bv[j] = full + j < s ? to_f(b[at]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      if (full + j >= s) break;
      h = __fadd_rn(__fmul_rn(av[j], h), bv[j]);
      out[base + (full + j) * d] = from_f<T>(h);
    }
  }
}

template <int BD, int BS, typename T>
int launch(const void* a, const void* b, const void* h0, void* out, int64_t batch, int64_t s,
           int64_t d, cudaStream_t stream) {
  const int64_t gx = (d + BD - 1) / BD;
  if (batch > 65535 || gx > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(gx), static_cast<unsigned int>(batch));
  rglru_kernel<BD, BS, T><<<grid, BD, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(h0),
      static_cast<T*>(out), s, d);
  return static_cast<int>(cudaGetLastError());
}

template <int BD, int BS, typename T>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, rglru_kernel<BD, BS, T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes);
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = BD;
  return 0;
}

// The instantiated tiles: kernels/rglru_scan/kernel.TILES, in order.
#define SCAN_TILES(X) \
  X(64, 4)            \
  X(64, 16)           \
  X(128, 8)           \
  X(128, 16)          \
  X(128, 32)          \
  X(256, 16)

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b: contiguous (B, S, D), h0: contiguous (B, D), out: contiguous (B, S, D),
// all float32 (dtype 0) or all bfloat16 (dtype 1). (bd, bs) must be an
// instantiated tile.
int rglru_scan_launch(int32_t bd, int32_t bs, int32_t dtype, const void* a, const void* b,
                      const void* h0, void* out, int64_t batch, int64_t s, int64_t d,
                      cudaStream_t stream) {
  if (batch == 0 || s == 0 || d == 0) return static_cast<int>(cudaGetLastError());
#define SCAN_LAUNCH(BD, BS)                                                           \
  if (bd == BD && bs == BS)                                                           \
    return dtype == 0 ? launch<BD, BS, float>(a, b, h0, out, batch, s, d, stream)     \
                      : launch<BD, BS, __nv_bfloat16>(a, b, h0, out, batch, s, d, stream);
  SCAN_TILES(SCAN_LAUNCH)
#undef SCAN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

int rglru_scan_attributes(int32_t bd, int32_t bs, int32_t dtype, int32_t* out) {
#define SCAN_ATTR(BD, BS)                                                       \
  if (bd == BD && bs == BS)                                                     \
    return dtype == 0 ? attributes<BD, BS, float>(out)                          \
                      : attributes<BD, BS, __nv_bfloat16>(out);
  SCAN_TILES(SCAN_ATTR)
#undef SCAN_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
