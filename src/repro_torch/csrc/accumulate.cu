// Fused trace-score accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _accumulate_kernel
// (src/repro/kernels/replay_step/kernel.py:240, launcher accumulate_tiled):
// perfmodel.trace_score_accumulate over a materialized replay history.
// For every DIMM it folds S steps of (effective bin, switch flag, realized
// (2, 4) timing row) into the running score partials: int32 occupancy per
// effective bin (column n_bins is the JEDEC sentinel), an int32 switch
// count and eight float32 timing sums.
//
// What bounds it on this card: memory. Each (step, DIMM) pair is read once
// -- 32 B of timings, 4 B of bin index, 1 B of switch flag -- against ~17
// integer and float operations, ~0.5 operations per byte; at the trace-eval
// path's 65,536 DIMMs x 10,000 steps that is 24.2 GB, ~7.2 ms at 3.35 TB/s.
//
// Design: one thread per DIMM reads the reference's public layouts
// directly. timings is [S][N][2][4], so at every step a thread loads its
// row as two aligned float4 and a warp reads 1 KB that is contiguous; bins
// [S][N] int32 and switched [S][N] uint8 are read coalesced the same way.
// The n_bins + 1 counters, the switch count and the eight sums live in
// registers (templated on n_bins, as the replay kernel is, so the one-hot
// compare unrolls); the step loop is unrolled so several steps' loads are
// in flight per thread. Offsets are 64-bit: S * N * 8 passes 2^31 at the
// full-width shape.
//
// Numerics: kernel and plain version (partials + one_hot(bins).sum(0),
// partials + timings.sum(0)) must agree bitwise. The counters are integers.
// Realized timings are multiples of tCK = 1.25 ns, so every partial sum is
// exact in float32, whatever the order, while it stays below 2^22 ns (where
// the float32 spacing reaches 0.25 ns): the thread adds the steps in step order
// from zero, then adds its block once into the running sums, as the plain
// version's partials + timings.sum(0) does. Built with -fmad=false and
// without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 8;
constexpr int kSlots = 8;  // (access, param) slots of a timing row: a * 4 + p
constexpr int kThreads = 256;

template <int NB1>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const int32_t* __restrict__ bins,      // [S][N]
                  const uint8_t* __restrict__ switched,  // [S][N]
                  const float4* __restrict__ timings,    // [S][N][2] float4
                  const int32_t* __restrict__ occ_in,    // [N][NB1]
                  const int32_t* __restrict__ sw_in,     // [N]
                  const float* __restrict__ sums_in,     // [N][8]
                  int32_t* __restrict__ occ_out, int32_t* __restrict__ sw_out,
                  float* __restrict__ sums_out, int64_t n, int64_t steps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  int32_t occ[NB1];
#pragma unroll
  for (int b = 0; b < NB1; ++b) occ[b] = 0;
  int32_t sw = 0;
  float sums[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) sums[j] = 0.0f;

#pragma unroll 4
  for (int64_t k = 0; k < steps; ++k) {
    const int64_t at = k * n + i;
    const int32_t b = bins[at];
    const bool s = switched[at] != 0;
    const float4 lo = timings[2 * at];
    const float4 hi = timings[2 * at + 1];
#pragma unroll
    for (int c = 0; c < NB1; ++c) occ[c] += (b == c) ? 1 : 0;
    sw += s ? 1 : 0;
    sums[0] = sums[0] + lo.x;
    sums[1] = sums[1] + lo.y;
    sums[2] = sums[2] + lo.z;
    sums[3] = sums[3] + lo.w;
    sums[4] = sums[4] + hi.x;
    sums[5] = sums[5] + hi.y;
    sums[6] = sums[6] + hi.z;
    sums[7] = sums[7] + hi.w;
  }

#pragma unroll
  for (int c = 0; c < NB1; ++c) occ_out[i * NB1 + c] = occ_in[i * NB1 + c] + occ[c];
  sw_out[i] = sw_in[i] + sw;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) sums_out[i * kSlots + j] = sums_in[i * kSlots + j] + sums[j];
}

template <int NB1>
void launch(const int32_t* bins, const uint8_t* switched, const float* timings,
            const int32_t* occ_in, const int32_t* sw_in, const float* sums_in,
            int32_t* occ_out, int32_t* sw_out, float* sums_out, int64_t n, int64_t steps,
            cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  accumulate_kernel<NB1><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      bins, switched, reinterpret_cast<const float4*>(timings), occ_in, sw_in, sums_in,
      occ_out, sw_out, sums_out, n, steps);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int accumulate_max_bins() { return kMaxBins; }

// All pointers are device pointers in the public layouts above; timings
// must be 16-byte aligned (the wrapper checks).
int accumulate_launch(const int32_t* bins, const uint8_t* switched, const float* timings,
                      const int32_t* occ_in, const int32_t* sw_in, const float* sums_in,
                      int32_t* occ_out, int32_t* sw_out, float* sums_out, int64_t n,
                      int64_t steps, int32_t n_bins, cudaStream_t stream) {
  if (n > 0) {
#define ACCUMULATE_CASE(NB)                                                          \
  case NB:                                                                           \
    launch<NB + 1>(bins, switched, timings, occ_in, sw_in, sums_in, occ_out, sw_out, \
                   sums_out, n, steps, stream);                                      \
    break;
    switch (n_bins) {
      ACCUMULATE_CASE(1)
      ACCUMULATE_CASE(2)
      ACCUMULATE_CASE(3)
      ACCUMULATE_CASE(4)
      ACCUMULATE_CASE(5)
      ACCUMULATE_CASE(6)
      ACCUMULATE_CASE(7)
      ACCUMULATE_CASE(8)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef ACCUMULATE_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
