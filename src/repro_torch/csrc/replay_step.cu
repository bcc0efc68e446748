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
// What holds a thread-per-DIMM loop back from that floor: one 4-byte and
// one 1-byte load a step, each waited for, leave a few hundred bytes in
// flight per warp where the card needs ~25 KB per SM; and a realized row
// picked from registers by a select chain costs ~8 x n_bins instructions a
// step, more issue time than the bytes take.
//
// Design: one thread per DIMM, kThreads DIMMs a block. Telemetry is
// step-major, [chunk][n]; the block stages [kSteps steps x kThreads DIMMs]
// tiles of temps and errs through a kStages-deep ring of shared memory with
// cp.async, kStages - 1 tiles ahead of the steps it computes, one barrier a
// tile; each thread then reads its own column (no bank conflicts). Where n
// and the pointers allow (n % 16 == 0, 16-byte aligned bases) whole tiles
// move by 16-byte copies. Other fleets (the card tests' 4,099 DIMMs, any
// offset view) take the narrow path in the same kernel: a 4-byte copy a
// temperature or table entry, and each row of flags copied as the aligned
// 4-byte words that cover it, the thread reading its flag at the row's byte
// offset. A 4-byte word that holds a byte of an allocation lies inside it
// (device allocations are 256-byte aligned), and the last word of errs is
// clipped by the copy's source size.
// The DIMM's n_bins + 1 timing rows (the JEDEC sentinel last) are copied
// once a chunk into shared memory as [slot][row][thread], beside its
// occupancy as [row][thread]: each step reads the realized row's eight
// values and adds one to the occupancy at the effective bin's index, from
// one address, with no select and no branch. State, switches and sums stay
// in registers for the chunk; all per-DIMM operands are slot-major,
// [slot][n], for coalescing. Only the final state and partials are written.
// The ring is two tiles deep: with the rows and occupancy a block holds 66
// KB at 4 bins, three blocks an SM (a deeper ring leaves two).
// A chunk shorter than a tile (trace-eval's chunk 1) skips the staging: the
// direct kernel loads its steps and the whole table at once into registers
// and selects the row, one round trip, where the staged kernel's first tile
// and table copy would add a barrier and shared-memory traffic to a launch
// that is mostly latency.
//
// The emitting entry (replay_chunk_emit_launch; EMIT = true) also writes
// each step's realized row, effective bin, switch flag and fuse flag, the
// decisions a controller programs: rows [chunk][n][8] (the public (c, N, 2,
// 4) layout), bins [chunk][n] int32, flags [chunk][n] uint8 (0 or 1). Each
// output pointer may be null and is then skipped by a branch that is the
// same across the grid. The staged kernel reads the realized row from
// shared memory for its sums anyway; a thread stores it as two 16-byte
// words at rows + (k * n + i) * 8, so a warp writes 1 KB contiguously
// (4-byte stores where the base is not 16-byte aligned). The writes bound
// it: 38 bytes a (DIMM, step) against the 5 the non-emitting kernel reads.
// EMIT is a template parameter, so the non-emitting instantiations are
// unchanged. Offsets are 64-bit: k * n + i passes 2^31 on trace-eval's
// history.
//
// Numerics: the state and partials must equal the plain PyTorch version
// bit for bit. t_eff = temp + guard and target_edge - hysteresis are
// float32 operations on float32-rounded scalars, the bin is the count of
// edges strictly below t_eff (torch.searchsorted, side left, edges
// ascending), the target edge beyond the last bin is +inf, and each (step,
// slot) takes exactly one float32 add of the realized row's value, in step
// order. Built with -fmad=false and without fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxBins = 8;
constexpr int kSlots = 8;  // (access, param) slots of a timing row: a * 4 + p
constexpr int kThreads = 256;
constexpr int kSteps = 8;    // steps a staged tile; shorter chunks take the direct kernel
constexpr int kStages = 2;   // ring depth: kStages - 1 tiles in flight
constexpr int kErrRow = kThreads + 16;  // bytes a staged row of flags (room for the offset)

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

// Per-step outputs of the emitting entry; a null pointer is not written.
struct EmitOut {
  float* rows;        // [chunk][n][8]
  int32_t* eff;       // [chunk][n]
  uint8_t* switched;  // [chunk][n]
  uint8_t* fused;     // [chunk][n]
};

namespace {

// Dynamic shared memory of a staged block: the ring, then the table rows
// and the occupancy.
__host__ __device__ constexpr int ring_bytes() {
  return kStages * kSteps * (kThreads * 4 + kErrRow);
}
template <int NB>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes() + (NB + 1) * (kSlots + 1) * kThreads * 4;
}

// BYTES-byte global -> shared copy; src_bytes < BYTES zero-fills the rest.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One controller step of one DIMM: error fuse, guard band, bin search,
// hysteresis. Updates the state; returns the effective bin (NB = JEDEC) and
// whether the timing set switched.
template <int NB>
__device__ __forceinline__ int32_t transition(const ReplayParams& p, float temp, bool err,
                                              int32_t& bin, int32_t& streak, bool& fused,
                                              bool& switched) {
  fused = fused || err;
  const float t_eff = temp + p.guard_band_c;
  int32_t target = 0;
  float target_edge = INFINITY;  // edges[target], +inf past the last edge
#pragma unroll
  for (int b = NB - 1; b >= 0; --b) {
    const bool above = t_eff > p.edges[b];
    target += above ? 1 : 0;
    target_edge = above ? target_edge : p.edges[b];
  }
  const bool hotter = target > bin;
  const bool cooler = target < bin;
  const bool calm = t_eff <= target_edge - p.hysteresis_c;
  const int32_t streak_if_cooler = calm ? streak + 1 : 0;
  const bool recover = cooler && (streak_if_cooler >= p.hysteresis_steps);
  switched = (hotter || recover) && !fused;
  if (!fused) {  // a fused DIMM's registers are frozen
    const int32_t new_bin = (hotter || recover) ? target : bin;
    streak = (cooler && !recover) ? streak_if_cooler : 0;
    bin = new_bin;
  }
  return fused ? NB : bin;
}

// Store one (DIMM, step)'s decisions at element at = k * n + i.
__device__ __forceinline__ void emit(const EmitOut& e, int64_t at, const float (&row)[kSlots],
                                     int32_t eff_bin, bool switched, bool fused) {
  if (e.rows != nullptr) {
    float* dst = e.rows + at * kSlots;
    if ((reinterpret_cast<uintptr_t>(e.rows) & 15u) == 0) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(row[0], row[1], row[2], row[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(row[4], row[5], row[6], row[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) dst[j] = row[j];
    }
  }
  if (e.eff != nullptr) e.eff[at] = eff_bin;
  if (e.switched != nullptr) e.switched[at] = switched ? 1 : 0;
  if (e.fused != nullptr) e.fused[at] = fused ? 1 : 0;
}

template <int NB, bool WIDE, bool EMIT>
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
                    int64_t n, int32_t chunk, ReplayParams p, EmitOut e) {
  constexpr int kRowStride = (NB + 1) * kThreads;  // floats from one slot of a row to the next
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_temp = reinterpret_cast<float*>(smem);                          // [stage][step][thread]
  uint8_t* s_err = smem + kStages * kSteps * kThreads * 4;                 // [stage][step][kErrRow]
  float* s_rows = reinterpret_cast<float*>(smem + ring_bytes());           // [slot][row][thread]
  int32_t* s_occ = reinterpret_cast<int32_t*>(s_rows + kSlots * kRowStride);  // [row][thread]
  const int tid = threadIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = i0 + tid;
  const bool live = i < n;
  const int n_tiles = (chunk + kSteps - 1) / kSteps;

  // Copies of tile s (steps s * kSteps ...) into its ring slot.
  auto issue = [&](int s) {
    if (s < n_tiles) {
      const int k0 = s * kSteps;
      float* dt = s_temp + (s % kStages) * kSteps * kThreads;
      uint8_t* de = s_err + (s % kStages) * kSteps * kErrRow;
      if constexpr (WIDE) {
        // 16 bytes a copy: 4 temperatures or 16 flags of one step.
#pragma unroll
        for (int q = 0; q < kSteps / 4; ++q) {
          const int c = q * kThreads + tid;
          const int r = c / (kThreads / 4), col = (c % (kThreads / 4)) * 4;
          const bool in = k0 + r < chunk && i0 + col < n;
          cp_async<16>(dt + r * kThreads + col,
                       in ? temps + (static_cast<int64_t>(k0 + r) * n + i0 + col) : temps,
                       in ? 16 : 0);
        }
        if (tid < kSteps * kThreads / 16) {
          const int r = tid / (kThreads / 16), col = (tid % (kThreads / 16)) * 16;
          const bool in = k0 + r < chunk && i0 + col < n;
          cp_async<16>(de + r * kErrRow + col,
                       in ? errs + (static_cast<int64_t>(k0 + r) * n + i0 + col) : errs,
                       in ? 16 : 0);
        }
      } else {
        // 4 bytes a copy: one temperature; flags as the aligned words that
        // cover bytes [k * n + i0, + kThreads) of errs.
#pragma unroll
        for (int r = 0; r < kSteps; ++r) {
          const bool in = k0 + r < chunk && live;
          cp_async<4>(dt + r * kThreads + tid,
                      in ? temps + (static_cast<int64_t>(k0 + r) * n + i) : temps, in ? 4 : 0);
        }
        constexpr int kWords = kErrRow / 4;
        const uintptr_t end = reinterpret_cast<uintptr_t>(errs + static_cast<int64_t>(chunk) * n);
        for (int c = tid; c < kSteps * kWords; c += kThreads) {
          const int r = c / kWords, w = c - r * kWords;
          const uintptr_t row =
              reinterpret_cast<uintptr_t>(errs + (static_cast<int64_t>(k0 + r) * n + i0));
          const uintptr_t src = (row & ~uintptr_t{3}) + 4 * w;
          const int64_t left = k0 + r < chunk ? static_cast<int64_t>(end - src) : 0;
          const int bytes = left >= 4 ? 4 : left > 0 ? static_cast<int>(left) : 0;
          cp_async<4>(de + r * kErrRow + 4 * w,
                      bytes ? reinterpret_cast<const void*>(src) : errs, bytes);
        }
      }
    }
    cp_async_commit();
  };

  // The table rows (first group, with tile 0), the JEDEC sentinel, the occupancy.
  if constexpr (WIDE) {
#pragma unroll
    for (int q = 0; q < NB * kSlots / 4; ++q) {
      const int c = q * kThreads + tid;
      const int r = c / (kThreads / 4), col = (c % (kThreads / 4)) * 4;  // r = b * 8 + j
      const int b = r / kSlots, j = r - b * kSlots;
      const bool in = i0 + col < n;
      cp_async<16>(s_rows + j * kRowStride + b * kThreads + col,
                   in ? stack + (static_cast<int64_t>(r) * n + i0 + col) : stack, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int r = 0; r < NB * kSlots; ++r) {
      const int b = r / kSlots, j = r - b * kSlots;
      cp_async<4>(s_rows + j * kRowStride + b * kThreads + tid,
                  live ? stack + (static_cast<int64_t>(r) * n + i) : stack, live ? 4 : 0);
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) s_rows[j * kRowStride + NB * kThreads + tid] = p.jedec[j];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  int32_t bin = 0, streak = 0, sw = 0;
  bool fused = false;
  float sums[kSlots];
  if (live) {
    bin = state_in[i];
    streak = state_in[n + i];
    fused = state_in[2 * n + i] != 0;
    sw = sw_in[i];
#pragma unroll
    for (int b = 0; b <= NB; ++b) s_occ[b * kThreads + tid] = occ_in[b * n + i];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) sums[j] = sums_in[j * n + i];
  }
  // The byte offset of this block's flags in the first word of a step's row.
  const uint32_t e_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(errs + i0));
  const uint32_t n_lo = static_cast<uint32_t>(n);
  [[maybe_unused]] int32_t k_emit = 0;  // the step a live thread is at (EMIT only)

  auto step = [&](float temp, bool err) {
    bool switched;
    const int32_t eff_bin = transition<NB>(p, temp, err, bin, streak, fused, switched);
    // Score partials: occupancy, switch count, realized row sums, all read
    // and written at the effective bin's index.
    float* rp = s_rows + eff_bin * kThreads + tid;
    reinterpret_cast<int32_t*>(rp + kSlots * kRowStride)[0] += 1;
    sw += switched ? 1 : 0;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) sums[j] = sums[j] + rp[j * kRowStride];
    if constexpr (EMIT) {
      float row[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) row[j] = rp[j * kRowStride];
      emit(e, static_cast<int64_t>(k_emit) * n + i, row, eff_bin, switched, fused);
      ++k_emit;
    }
  };

  for (int s = 0; s < n_tiles; ++s) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile s have landed
    __syncthreads();               // ... and every thread's; tile s - 1's slot is free
    issue(s + kStages - 1);
    if (!live) continue;
    const float* tt = s_temp + (s % kStages) * kSteps * kThreads + tid;
    const uint8_t* te = s_err + (s % kStages) * kSteps * kErrRow + tid;
    const int k0 = s * kSteps;
    if (k0 + kSteps <= chunk) {
#pragma unroll
      for (int r = 0; r < kSteps; ++r) {
        const uint32_t off = WIDE ? 0u : (e_lo + static_cast<uint32_t>(k0 + r) * n_lo) & 3u;
        step(tt[r * kThreads], te[r * kErrRow + off] != 0);
      }
    } else {
      for (int r = 0; r < chunk - k0; ++r) {
        const uint32_t off = WIDE ? 0u : (e_lo + static_cast<uint32_t>(k0 + r) * n_lo) & 3u;
        step(tt[r * kThreads], te[r * kErrRow + off] != 0);
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;

  state_out[i] = bin;
  state_out[n + i] = streak;
  state_out[2 * n + i] = fused ? 1 : 0;
#pragma unroll
  for (int b = 0; b <= NB; ++b) occ_out[b * n + i] = s_occ[b * kThreads + tid];
  sw_out[i] = sw;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) sums_out[j * n + i] = sums[j];
}

// Chunks shorter than a tile: every operand loaded at once into registers,
// the row selected from them, the occupancy one-hot.
template <int NB, bool EMIT>
__global__ void __launch_bounds__(kThreads)
replay_direct_kernel(const int32_t* __restrict__ state_in, const int32_t* __restrict__ occ_in,
                     const int32_t* __restrict__ sw_in, const float* __restrict__ sums_in,
                     const float* __restrict__ stack, const float* __restrict__ temps,
                     const uint8_t* __restrict__ errs, int32_t* __restrict__ state_out,
                     int32_t* __restrict__ occ_out, int32_t* __restrict__ sw_out,
                     float* __restrict__ sums_out, int64_t n, int32_t chunk, ReplayParams p,
                     EmitOut e) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
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
    bool switched;
    const int32_t eff_bin = transition<NB>(p, temps[static_cast<int64_t>(k) * n + i],
                                           errs[static_cast<int64_t>(k) * n + i] != 0, bin,
                                           streak, fused, switched);
#pragma unroll
    for (int b = 0; b <= NB; ++b) occ[b] += (eff_bin == b) ? 1 : 0;
    sw += switched ? 1 : 0;
    float row[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      row[j] = p.jedec[j];
#pragma unroll
      for (int b = NB - 1; b >= 0; --b) row[j] = (eff_bin == b) ? rows[b * kSlots + j] : row[j];
      sums[j] = sums[j] + row[j];
    }
    if constexpr (EMIT) emit(e, static_cast<int64_t>(k) * n + i, row, eff_bin, switched, fused);
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

// 16-byte copies where every staged row starts on a 16-byte boundary.
bool rows_16(const float* stack, const float* temps, const uint8_t* errs, int64_t n) {
  return n % 16 == 0 && reinterpret_cast<uintptr_t>(stack) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(temps) % 16 == 0 && reinterpret_cast<uintptr_t>(errs) % 16 == 0;
}

template <int NB, bool EMIT>
int launch(const int32_t* state_in, const int32_t* occ_in, const int32_t* sw_in,
           const float* sums_in, const float* stack, const float* temps,
           const uint8_t* errs, int32_t* state_out, int32_t* occ_out, int32_t* sw_out,
           float* sums_out, int64_t n, int32_t chunk, const ReplayParams& p,
           const EmitOut& e, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  if (chunk < kSteps) {
    replay_direct_kernel<NB, EMIT><<<blocks, kThreads, 0, stream>>>(
        state_in, occ_in, sw_in, sums_in, stack, temps, errs, state_out, occ_out, sw_out,
        sums_out, n, chunk, p, e);
    return static_cast<int>(cudaGetLastError());
  }
  auto kern = rows_16(stack, temps, errs, n) ? replay_chunk_kernel<NB, true, EMIT>
                                             : replay_chunk_kernel<NB, false, EMIT>;
  constexpr int smem = smem_bytes<NB>();
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, kThreads, smem, stream>>>(state_in, occ_in, sw_in, sums_in, stack, temps, errs,
                                           state_out, occ_out, sw_out, sums_out, n, chunk, p, e);
  return static_cast<int>(cudaGetLastError());
}

template <bool EMIT>
int dispatch(const int32_t* state_in, const int32_t* occ_in, const int32_t* sw_in,
             const float* sums_in, const float* stack, const float* temps,
             const uint8_t* errs, int32_t* state_out, int32_t* occ_out, int32_t* sw_out,
             float* sums_out, int64_t n, int32_t chunk, const ReplayParams& p,
             const EmitOut& e, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
#define REPLAY_CASE(NB)                                                                  \
  case NB:                                                                               \
    return launch<NB, EMIT>(state_in, occ_in, sw_in, sums_in, stack, temps, errs,        \
                            state_out, occ_out, sw_out, sums_out, n, chunk, p, e, stream);
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
  return dispatch<false>(state_in, occ_in, sw_in, sums_in, stack, temps, errs, state_out,
                         occ_out, sw_out, sums_out, n, chunk, *params,
                         EmitOut{nullptr, nullptr, nullptr, nullptr}, stream);
}

// replay_chunk_launch, and each step's decisions: rows [chunk][n][8] float32,
// eff [chunk][n] int32, switched and fused [chunk][n] uint8. Any of the four
// may be null.
int replay_chunk_emit_launch(const int32_t* state_in, const int32_t* occ_in,
                             const int32_t* sw_in, const float* sums_in, const float* stack,
                             const float* temps, const uint8_t* errs, int32_t* state_out,
                             int32_t* occ_out, int32_t* sw_out, float* sums_out,
                             float* rows_out, int32_t* eff_out, uint8_t* switched_out,
                             uint8_t* fused_out, int64_t n, int32_t chunk,
                             const ReplayParams* params, cudaStream_t stream) {
  return dispatch<true>(state_in, occ_in, sw_in, sums_in, stack, temps, errs, state_out,
                        occ_out, sw_out, sums_out, n, chunk, *params,
                        EmitOut{rows_out, eff_out, switched_out, fused_out}, stream);
}

}  // extern "C"
