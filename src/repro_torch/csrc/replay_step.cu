// Fused replay chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _replay_chunk_kernel
// (src/repro/kernels/replay_step/kernel.py:92, launcher replay_chunk_tiled).
// For every DIMM it runs a whole chunk of controller steps: error fuse,
// guard band, bin search sum(t_eff > edge), hysteresis recover, row select
// with the JEDEC sentinel, and the score partials (int32 occupancy per
// effective bin and switch count, eight float32 timing sums).
//
// What bounds it on this card: memory. A 256-step chunk moves ~1.3 KB of
// telemetry per DIMM (4 B temperature + 1 B error flag per step) plus
// ~0.3 KB of table, state and partials, against ~40 integer and float
// operations per step: ~6 operations per byte, far below the card's
// balance point of ~20, so the floor is bytes over 3.35 TB/s.
//
// Design: one thread per DIMM, 256 threads a block. Telemetry is
// step-major, [chunk][n], so at every step a warp reads 32 neighbouring
// floats (coalesced). State, occupancy, switches and the eight sums stay
// in registers for the whole chunk, and the DIMM's n_bins x 8 table rows
// are read once into registers (the kernel is templated on n_bins, at
// most kMaxBins, so the selects unroll and nothing spills to local
// memory). All per-DIMM operands are slot-major, [slot][n], for the same
// coalescing. Only the final state and partials are written.
//
// Numerics: the state and partials must equal the plain PyTorch version
// bit for bit. t_eff = temp + guard and target_edge - hysteresis are
// float32 operations on float32-rounded scalars, the bin is the count of
// edges strictly below t_eff (torch.searchsorted, side left), the target
// edge beyond the last bin is +inf, and each (step, slot) takes exactly one
// float32 add, in step order. Built with -fmad=false and without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxBins = 8;
constexpr int kSlots = 8;  // (access, param) slots of a timing row: a * 4 + p
constexpr int kThreads = 256;

// Passed by pointer from Python (ctypes); external linkage so the
// extern "C" launcher keeps its symbol.
struct ReplayParams {
  float edges[kMaxBins];
  float jedec[kSlots];
  float guard_band_c;
  float hysteresis_c;
  int32_t n_bins;
  int32_t hysteresis_steps;
};

namespace {

template <int NB>
__global__ void __launch_bounds__(kThreads)
replay_chunk_kernel(const int32_t* __restrict__ state_in,   // [3][n]
                    const int32_t* __restrict__ occ_in,     // [NB + 1][n]
                    const int32_t* __restrict__ sw_in,      // [n]
                    const float* __restrict__ sums_in,      // [8][n]
                    const float* __restrict__ stack,        // [NB * 8][n]
                    const float* __restrict__ temps,        // [chunk][n]
                    const uint8_t* __restrict__ errs,       // [chunk][n]
                    int32_t* __restrict__ state_out, int32_t* __restrict__ occ_out,
                    int32_t* __restrict__ sw_out, float* __restrict__ sums_out,
                    int64_t n, int32_t chunk, ReplayParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  int32_t bin = state_in[i];
  int32_t streak = state_in[n + i];
  bool fused = state_in[2 * n + i] != 0;
  int32_t occ[NB + 1];
#pragma unroll
  for (int b = 0; b <= NB; ++b) occ[b] = occ_in[b * n + i];
  int32_t sw = sw_in[i];
  float sums[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) sums[j] = sums_in[j * n + i];
  float rows[NB * kSlots];
#pragma unroll
  for (int r = 0; r < NB * kSlots; ++r) rows[r] = stack[r * n + i];

  for (int32_t k = 0; k < chunk; ++k) {
    const float temp = temps[static_cast<int64_t>(k) * n + i];
    const bool err = errs[static_cast<int64_t>(k) * n + i] != 0;

    // Controller transition.
    fused = fused || err;
    const float t_eff = temp + p.guard_band_c;
    int32_t target = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) target += (t_eff > p.edges[b]) ? 1 : 0;
    const bool hotter = target > bin;
    const bool cooler = target < bin;
    float target_edge = INFINITY;
#pragma unroll
    for (int b = NB - 1; b >= 0; --b) target_edge = (target == b) ? p.edges[b] : target_edge;
    const bool calm = t_eff <= target_edge - p.hysteresis_c;
    const int32_t streak_if_cooler = calm ? streak + 1 : 0;
    const bool recover = cooler && (streak_if_cooler >= p.hysteresis_steps);
    int32_t new_bin = (hotter || recover) ? target : bin;
    int32_t new_streak = (cooler && !recover) ? streak_if_cooler : 0;
    const bool switched = (hotter || recover) && !fused;
    if (fused) {  // a fused DIMM's registers are frozen
      new_bin = bin;
      new_streak = streak;
    }
    const int32_t eff_bin = fused ? NB : new_bin;

    // Score partials: one-hot occupancy, switch count, realized row sums.
#pragma unroll
    for (int b = 0; b <= NB; ++b) occ[b] += (eff_bin == b) ? 1 : 0;
    sw += switched ? 1 : 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      float row = p.jedec[j];
#pragma unroll
      for (int b = NB - 1; b >= 0; --b) row = (eff_bin == b) ? rows[b * kSlots + j] : row;
      sums[j] = sums[j] + row;
    }
    bin = new_bin;
    streak = new_streak;
  }

  state_out[i] = bin;
  state_out[n + i] = streak;
  state_out[2 * n + i] = fused ? 1 : 0;
#pragma unroll
  for (int b = 0; b <= NB; ++b) occ_out[b * n + i] = occ[b];
  sw_out[i] = sw;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) sums_out[j * n + i] = sums[j];
}

template <int NB>
void launch(const int32_t* state_in, const int32_t* occ_in, const int32_t* sw_in,
            const float* sums_in, const float* stack, const float* temps,
            const uint8_t* errs, int32_t* state_out, int32_t* occ_out, int32_t* sw_out,
            float* sums_out, int64_t n, int32_t chunk, const ReplayParams& p,
            cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  replay_chunk_kernel<NB><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      state_in, occ_in, sw_in, sums_in, stack, temps, errs, state_out, occ_out, sw_out,
      sums_out, n, chunk, p);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int replay_max_bins() { return kMaxBins; }

// All pointers are device pointers in the slot-major layouts above.
int replay_chunk_launch(const int32_t* state_in, const int32_t* occ_in,
                        const int32_t* sw_in, const float* sums_in, const float* stack,
                        const float* temps, const uint8_t* errs, int32_t* state_out,
                        int32_t* occ_out, int32_t* sw_out, float* sums_out, int64_t n,
                        int32_t chunk, const ReplayParams* params, cudaStream_t stream) {
  if (n > 0) {
    const ReplayParams& p = *params;
#define REPLAY_CASE(NB)                                                              \
  case NB:                                                                           \
    launch<NB>(state_in, occ_in, sw_in, sums_in, stack, temps, errs, state_out,      \
               occ_out, sw_out, sums_out, n, chunk, p, stream);                      \
    break;
    switch (p.n_bins) {
      REPLAY_CASE(1)
      REPLAY_CASE(2)
      REPLAY_CASE(3)
      REPLAY_CASE(4)
      REPLAY_CASE(5)
      REPLAY_CASE(6)
      REPLAY_CASE(7)
      REPLAY_CASE(8)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef REPLAY_CASE
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
