// Fused charge-sweep grid search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _charge_sweep_kernel
// (src/repro/kernels/charge_sweep/kernel.py:96, launcher charge_sweep_tiled).
// Per cell it walks the shared cycle grid once (at most 28 candidates) and
// runs the seven first-True min-safe searches (r_trcd, r_tras, r_trp,
// w_trcd, w_tras, w_twr, w_trp) on 18 hoisted per-cell invariants.
//
// What bounds it on this card: each cell reads 72 B and writes 28 B and
// does ~39 float operations per candidate (5 expf, 5 divisions), ~1.1k per
// cell. Counting expf and a division as one operation each, that is about
// 11 operations per byte, below the card's fp32 balance point of
// 67 TFLOP/s / 3.35 TB/s = 20, so the formal bound is memory. But precise
// expf and IEEE division each issue on the order of ten instructions, which
// puts the instruction stream well above the balance point: expect the
// kernel to be limited by instruction issue, not by memory.
//
// Design: one thread per cell, 256 threads a block. The invariants arrive
// structure-of-arrays, [18][cells], so a warp's loads are coalesced; the
// seven (index, found) pairs stay in registers over the candidate loop;
// the output is [7][cells] int32. The kernel masks the ragged edge itself,
// so the TPU's (8, 128) tile padding is gone.
//
// Numerics: the indices must equal the plain PyTorch version bit for bit.
// Every expression keeps the operand order of the plain version (and of
// the Pallas body), is built with -fmad=false and without fast math
// (precise expf, IEEE division), and forms the candidate exactly as
// (float)(k + 1) * tck, so each float32 operation rounds once, as a torch
// elementwise op does. The scalars arrive as float32 roundings of the
// model's Python constants.

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
  int32_t idx[kSearches];
  bool found[kSearches];
  int max_n = 0;
#pragma unroll
  for (int j = 0; j < kSearches; ++j) {
    mask[j] = inv[(11 + j) * n + c] > 0.5f;
    idx[j] = p.n_grid[j] - 1;  // all-False searches keep the JEDEC pin
    found[j] = false;
    max_n = p.n_grid[j] > max_n ? p.n_grid[j] : max_n;
  }

  for (int k = 0; k < max_n; ++k) {
    const float t = static_cast<float>(k + 1) * p.tck;
    bool pass[kSearches];
    // r_trcd: sense-amp latch from dv0.
    const float dv = dv0_r * expf((t - p.ovh_rcd) / rts);
    pass[0] = dv >= p.thr_sense;
    // r_tras: restore to the adaptive target.
    const float ta_r = t - p.ovh_ras - t_sense_r;
    const float v_reached = 1.0f - p.one_minus_vrs * expf(-relu(ta_r) / rtr);
    pass[1] = v_reached >= thr_rest;
    // r_trp: bitline equalization.
    const float delta = p.v_half * expf(-(t - p.ovh_rp) / rtb);
    pass[2] = delta <= thr_trp;
    // w_trcd / w_trp: hoisted write-assisted thresholds.
    pass[3] = t >= thr_trcd_w;
    pass[6] = t >= thr_trp_w;
    // w_tras: row restore under write drive.
    const float ta_w = t - p.ovh_ras - t_sense_w;
    const float v_row = p.v_over - p.v_over_minus_vrs * expf(-relu(ta_w) / tau_wr);
    pass[4] = v_row >= thr_rest;
    // w_twr: write recovery from the opposite rail.
    const float v_wr = p.v_over * (1.0f - expf(-(t - p.ovh_wr) / tau_wr));
    pass[5] = v_wr >= thr_rest;
#pragma unroll
    for (int j = 0; j < kSearches; ++j) {
      const bool ok = pass[j] && mask[j] && (k < p.n_grid[j]);
      if (ok && !found[j]) idx[j] = k;
      found[j] = found[j] || ok;
    }
  }
#pragma unroll
  for (int j = 0; j < kSearches; ++j) idx_out[j * n + c] = idx[j];
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
