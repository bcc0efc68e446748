// Fused charge-sweep grid search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _charge_sweep_kernel
// (src/repro/kernels/charge_sweep/kernel.py:96, launched by
// charge_sweep_tiled at :173). Per cell it runs the seven first-pass
// min-safe searches (r_trcd, r_tras, r_trp, w_trcd, w_tras, w_twr, w_trp)
// over the cycle grid, candidate k being (k + 1) cycles, on 18 hoisted
// per-cell invariants.
//
// What bounds it on this card: each cell reads 72 B and writes 28 B, so at
// the boot shape (2^20 DIMMs x 4 bins, 4,194,304 cells) the bytes bound is
// 0.1252 ms. In practice it is bound by instruction issue: a candidate of
// the five charge searches costs a precise expf and an IEEE division, each
// some ten instructions, and walking every search over the longest grid
// (28 candidates, five expf and five divisions each) took 6.9x the bytes
// bound on an H100 SXM at 700 W; this design takes 2.1x there.
//
// Design: one thread per cell, 256 threads a block; the invariants arrive
// structure-of-arrays, [18][cells], so a warp's loads are coalesced; the
// output is [7][cells] int32 and the kernel masks the ragged edge itself.
// Each search does only its own work, in a loop of its own (first_pass):
// it stops at its first pass and before the last candidate of its own grid
// (12 or 28 candidates; the last one's index is the pin, pass or fail),
// and never starts where its JEDEC mask is 0. A warp then walks each search
// only as far as its slowest lane. The two tRAS searches compare a
// constant, with no expf and no division, at the candidates where the
// restore has not started at the sense latch (restored). Each loop keeps
// its candidate as a float counter, so of the ~30 instructions a candidate
// issues only the MUFU of expf and of the division run at quarter rate,
// and is not unrolled (tools/kernel_variants.py times the conversion and
// an unroll by two).
//
// Numerics: the indices must equal the plain PyTorch version (the full
// 28-candidate walk) bit for bit. Stopping a first-pass search after its
// pass, or skipping candidates whose outcome cannot change its index (past
// its grid, its last one, all of a masked search), leaves the index as it
// is whatever the predicate's shape; nothing skips a candidate
// before the first pass (no binary search, no start index in closed form,
// no multiplicative carry, no reciprocal in place of a division). Every
// expression keeps the operand order of the plain version, is built with
// -fmad=false and without fast math (precise expf, IEEE division), and
// forms the candidate as (float)(k + 1) * tck, so each float32
// operation rounds once, as a torch elementwise op does. The scalars
// arrive as float32 roundings of the model's Python constants.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kSearches = 7;
constexpr int kThreads = 256;

// Passed by pointer from Python (ctypes); external linkage so the
// extern "C" launcher keeps its symbol.
struct SweepParams {
  float tck, ovh_rcd, ovh_ras, ovh_wr, ovh_rp;
  float thr_sense, one_minus_vrs, v_half, v_over, v_over_minus_vrs;
  int32_t n_grid[kSearches];
};

namespace {

__device__ __forceinline__ float relu(float x) { return x < 0.0f ? 0.0f : x; }

// The first candidate k < n_grid at which pass((k + 1) * tck) holds, or
// n_grid - 1 (the JEDEC pin) if none does or the search is masked off. The
// last candidate is never evaluated: pass or fail, its index is n_grid - 1.
// kf is (float)(k + 1) exactly (integers below 2^24), kept as a float so
// that no candidate costs an integer-to-float conversion: like the MUFU of
// expf and of the division, it issues at 16 a clock an SM.
template <class Pass>
__device__ __forceinline__ int32_t first_pass(bool mask, int32_t n_grid, float tck, Pass pass) {
  if (mask) {
    float kf = 1.0f;
    for (int32_t k = 0; k < n_grid - 1; ++k, kf += 1.0f) {
      if (pass(kf * tck)) return k;
    }
  }
  return n_grid - 1;
}

// Restore toward v_top through tau: v_top - v_span * expf(-relu(ta) / tau)
// >= thr. Where ta <= 0 the value is `latched` (v_top - v_span), the same
// float32 bits: relu(ta) is +-0, +-0 / tau is +-0 while tau is positive
// and finite (as it is for every population the repository builds),
// expf(+-0) is exactly 1 and v_span * 1 == v_span.
__device__ __forceinline__ bool restored(float ta, float tau, float v_top, float v_span,
                                         float latched, float thr) {
  if (ta <= 0.0f) return latched >= thr;
  return v_top - v_span * expf(-relu(ta) / tau) >= thr;
}

__global__ void __launch_bounds__(kThreads)
charge_sweep_kernel(const float* __restrict__ inv, int32_t* __restrict__ idx_out,
                    int64_t n, SweepParams p) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= n) return;

  const float dv0_r = inv[0 * n + c];
  const float rts = inv[1 * n + c];
  const float t_sense_r = inv[2 * n + c];
  const float thr_rest = inv[3 * n + c];
  const float rtr = inv[4 * n + c];
  const float rtb = inv[5 * n + c];
  const float thr_trp = inv[6 * n + c];
  const float tau_wr = inv[7 * n + c];
  const float t_sense_w = inv[8 * n + c];
  const float thr_trcd_w = inv[9 * n + c];
  const float thr_trp_w = inv[10 * n + c];
  bool mask[kSearches];
#pragma unroll
  for (int j = 0; j < kSearches; ++j) mask[j] = inv[(11 + j) * n + c] > 0.5f;
  const float latched_r = 1.0f - p.one_minus_vrs;
  const float latched_w = p.v_over - p.v_over_minus_vrs;

  int32_t* out = idx_out + c;
  // r_trcd: sense-amp latch from dv0.
  out[0 * n] = first_pass(mask[0], p.n_grid[0], p.tck, [=](float t) {
    return dv0_r * expf((t - p.ovh_rcd) / rts) >= p.thr_sense;
  });
  // r_tras: restore to the adaptive target.
  out[1 * n] = first_pass(mask[1], p.n_grid[1], p.tck, [=](float t) {
    return restored(t - p.ovh_ras - t_sense_r, rtr, 1.0f, p.one_minus_vrs, latched_r,
                    thr_rest);
  });
  // r_trp: bitline equalization.
  out[2 * n] = first_pass(mask[2], p.n_grid[2], p.tck, [=](float t) {
    return p.v_half * expf(-(t - p.ovh_rp) / rtb) <= thr_trp;
  });
  // w_trcd / w_trp: hoisted write-assisted thresholds.
  out[3 * n] = first_pass(mask[3], p.n_grid[3], p.tck,
                          [=](float t) { return t >= thr_trcd_w; });
  // w_tras: row restore under write drive.
  out[4 * n] = first_pass(mask[4], p.n_grid[4], p.tck, [=](float t) {
    return restored(t - p.ovh_ras - t_sense_w, tau_wr, p.v_over, p.v_over_minus_vrs,
                    latched_w, thr_rest);
  });
  // w_twr: write recovery from the opposite rail.
  out[5 * n] = first_pass(mask[5], p.n_grid[5], p.tck, [=](float t) {
    return p.v_over * (1.0f - expf(-(t - p.ovh_wr) / tau_wr)) >= thr_rest;
  });
  out[6 * n] = first_pass(mask[6], p.n_grid[6], p.tck,
                          [=](float t) { return t >= thr_trp_w; });
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// inv: [18][n] float32, idx_out: [7][n] int32, both on the device.
int charge_sweep_launch(const float* inv, int32_t* idx_out, int64_t n,
                        const SweepParams* params, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    charge_sweep_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        inv, idx_out, n, *params);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
