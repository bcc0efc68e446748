// Flash decode for Hopper (sm_90a): one query token against a KV cache.
//
// Replaces the Pallas TPU kernel _fd_kernel
// (src/repro/kernels/flash_decode/kernel.py:28, launcher flash_decode_hm,
// entry ops.flash_decode): q (B, H, dh) against k, v (B, L, Hk, dh), the
// first `length` cache rows valid, online softmax in float32, and
// out = acc / max(l, 1e-30), so an empty cache gives 0. Operands are
// float32 or bfloat16; the output is in q's dtype.
//
// What bounds it on this card: bytes. Every valid K and V row is read once,
// against 4 * dh operations per (query head, row); at altune's production
// shape (B 8, L 32,768, H 64, Hk 8, dh 128, float32) that is 2.15 GB, ~0.64
// ms at 3.35 TB/s, against 8.6 GFLOP (~0.13 ms at 67 TFLOP/s). To reach the
// bytes bound an SM needs tens of KB of loads in flight all the time, and
// the shared-memory traffic of the G query heads that share a row must stay
// under the SM's 128 bytes a clock.
//
// Design: split-K (FlashDecoding). The TPU kernel walks a head's cache in
// order with its softmax state in scratch; here B * Hk = 64 KV heads at that
// shape would be 64 blocks on 132 SMs, far too few to pull HBM bandwidth.
// So the cache is cut into splits of BK rows (FDConfig.bk, the kernel's
// timing parameter: one instantiation per member of
// kernels/flash_decode/ops.CANDIDATES, FD_TILES below) and one block of
// kWarps warps takes one (batch, KV head, split).
// - Each warp runs its own pipeline over its share of the split: steps of
//   kRows rows (warp w takes steps w, w + kWarps, ...), each step's K and V
//   rows copied by cp.async into a kStages-deep ring of the warp's own
//   shared memory, kStages - 1 steps ahead of the one it computes. Only the
//   warp waits on its copies (__syncwarp), so no block barrier stands in the
//   loop. Rows past `length` are zero-filled through the copy's source size.
//   float32 rows (4-element aligned, so 16 bytes) and 16-byte aligned
//   bfloat16 rows take 16-byte copies; bfloat16 rows on 8-byte boundaries
//   take 8-byte copies in the same kernel. bfloat16 is staged as bfloat16
//   and converted at use.
// - A lane owns 4 columns of dh and keeps the G query heads' 4 values in
//   registers, so each K element is read from shared memory once and used
//   for every head of the group. Its kRows x kMaxG partial dot products are
//   summed over the row's lanes by a butterfly that halves the values a
//   lane holds at each level, so lane L ends with the score of
//   (row L / 8, head L % 8): one value a lane, no shared memory.
// - The online softmax runs in the warp on those scores (max and sum over
//   the step's rows by two shuffles); p and each head's rescale go through
//   40 floats of the warp's shared memory and come back as float4
//   broadcasts; each lane then accumulates its 4 columns of P V for all G
//   heads from one float4 read of each V row.
// - At the end the warps' (m, l, acc) are merged through shared memory and
//   the block writes its split's partials; a second launch combines a head's
//   splits (max of m, rescaled sums) and divides. Only the splits that hold
//   valid rows are launched: the work follows `length`, not the cache size.
//
// Numerics against the plain version (ref.flash_decode_plain): the same
// mask, float32 scale, precise expf and p = 0 where masked; explicit fmaf
// for the dot products (the build passes -fmad=false). The rows, warps and
// splits sum in another order than the plain version's products, so the
// two agree within kernel.tolerance, not bitwise. An empty cache gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 8;     // query heads a KV head
constexpr int kWarps = 4;    // warps a block, each its own pipeline
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;     // cache rows a warp step: kRows * kMaxG = 32 scores, one a lane
constexpr int kStages = 4;   // ring depth of a warp: kStages - 1 steps in flight
constexpr int kMinBlocks = 3;  // blocks an SM the registers must allow (shared memory allows 3 at dh 128)

struct Args {
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t len;  // valid cache rows, <= L
  int32_t kv_heads, group, n_splits;
  float scale;
};

// Shared memory of a block (kernels/flash_decode/ops.FDConfig.smem_bytes):
// the warps' rings (K and V rows of kStages steps), reused at the end for
// the warps' accumulators; then each warp's p and rescale (kRows * kMaxG +
// kMaxG floats) and the warps' (m, l).
template <int DH, typename T>
__host__ __device__ constexpr int ring_bytes() {
  return kWarps * kStages * 2 * kRows * DH * static_cast<int>(sizeof(T));
}
template <int DH>
__host__ __device__ constexpr int merge_bytes() {
  return kWarps * kMaxG * DH * 4;
}
template <int DH, typename T>
__host__ __device__ constexpr int smem_bytes() {
  return (ring_bytes<DH, T>() > merge_bytes<DH>() ? ring_bytes<DH, T>() : merge_bytes<DH>()) +
         kWarps * (kRows * kMaxG + kMaxG) * 4 + kWarps * 2 * kMaxG * 4;
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive staged elements as float4 (a 16-byte shared load for
// float32, 8-byte for bfloat16).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
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

// Sum N values a lane over the lanes of a row, MSK the highest lane bit: at
// each level a lane keeps the half of its values that its lane bit selects
// and adds its partner's copy of that half, so lane L ends with value
// L % (2 * MSK) summed in x[0].
template <int N, int MSK>
__device__ __forceinline__ void butterfly(float* x, int lane) {
  const bool up = (lane & MSK) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = up ? x[i] : x[i + N / 2];
    const float keep = up ? x[i + N / 2] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, MSK);
  }
  if constexpr (MSK > 1) butterfly<N / 2, MSK / 2>(x, lane);
}

template <int DH, int BK, typename T, int COPY>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ part_ml, float* __restrict__ part_acc, const Args a) {
  constexpr int LPR = DH / 4;          // lanes a row: a lane owns 4 columns
  constexpr int HALVES = 32 / LPR;     // rows a warp reads at once (1 at dh 128, 2 at dh 64)
  constexpr int RL = kRows / HALVES;   // rows a lane reads a step
  constexpr int NV = RL * kMaxG;       // partial dot products a lane holds before the butterfly
  constexpr int CE = COPY / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int CPR = DH / CE;         // copies a row
  constexpr int RPC = 32 / CPR;        // rows a warp's copy instruction covers
  constexpr int NC = kRows / RPC;      // copy instructions a step, K and V each
  constexpr int STEP = 2 * kRows * DH; // elements of a ring slot: K rows, then V rows
  static_assert(BK % (kWarps * kRows) == 0 && (DH == 64 || DH == 128), "tile shapes");
  static_assert(CPR <= 32 && 32 % CPR == 0 && kRows % RPC == 0, "whole rows a copy pass");
  static_assert(NV * HALVES == 32, "one score a lane after the butterfly");

  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kBig = ring_bytes<DH, T>() > merge_bytes<DH>() ? ring_bytes<DH, T>()
                                                               : merge_bytes<DH>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* ring = reinterpret_cast<T*>(smem) + warp * kStages * STEP;     // [stage][K|V][row][DH]
  float* s_pc = reinterpret_cast<float*>(smem + kBig) + warp * (kRows * kMaxG + kMaxG);
  float* s_ml = reinterpret_cast<float*>(smem + kBig) + kWarps * (kRows * kMaxG + kMaxG);

  const int b = blockIdx.x / a.kv_heads, kvh = blockIdx.x - b * a.kv_heads;
  const int g_n = a.group;
  const int64_t split = blockIdx.y;
  const int64_t row0 = split * BK;
  const int64_t row_end = row0 + BK < a.len ? row0 + BK : a.len;
  const int n_rows = row_end > row0 ? static_cast<int>(row_end - row0) : 0;
  const int first = warp * kRows;
  const int steps = n_rows > first ? (n_rows - first + kWarps * kRows - 1) / (kWarps * kRows) : 0;

  // The lane's 4 columns of every query head of the group (0 past the group).
  const int sub = lane / LPR, c4 = (lane % LPR) * 4;
  float qr[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    const T* qp = q + b * a.q_sb + (kvh * g_n + (g < g_n ? g : 0)) * a.q_sh + c4;
#pragma unroll
    for (int c = 0; c < 4; ++c) qr[g][c] = g < g_n ? to_f(qp[c]) : 0.f;
  }

  // Copies: a lane moves CE elements of row (c * RPC + lane / CPR) of a step.
  const int cr = lane / CPR, cc = (lane % CPR) * CE;
  const T* kb = k + b * a.k_sb + kvh * a.k_sh + cc;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh + cc;
  auto issue = [&](int j) {
    if (j < steps) {
      T* dst = ring + (j % kStages) * STEP + cr * DH + cc;
      const int64_t pos0 = row0 + static_cast<int64_t>(j * kWarps + warp) * kRows + cr;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int64_t pos = pos0 + c * RPC;
        const bool in = pos < row_end;
        const int64_t at = in ? pos : row0;
        cp_async<COPY>(dst + c * RPC * DH, kb + at * a.k_sl, in ? COPY : 0);
        cp_async<COPY>(dst + kRows * DH + c * RPC * DH, vb + at * a.v_sl, in ? COPY : 0);
      }
    }
    cp_async_commit();
  };

  float m = kNegInf, l = 0.f;  // softmax state of head lane % 8 (the same in its 4 row lanes)
  float acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[g][c] = 0.f;

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  for (int j = 0; j < steps; ++j) {
    cp_async_wait<kStages - 2>();  // this lane's copies of step j have landed
    __syncwarp();                  // ... and every lane's; step j - 1's slot is free
    issue(j + kStages - 1);
    const T* ks = ring + (j % kStages) * STEP;
    const T* vs = ks + kRows * DH;

    // Partial scores of the lane's rows (sub * RL + r) and 4 columns.
    float x[NV];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const float4 kk = ld4(ks + (sub * RL + r) * DH + c4);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float t = qr[g][0] * kk.x;
        t = fmaf(qr[g][1], kk.y, t);
        t = fmaf(qr[g][2], kk.z, t);
        x[r * kMaxG + g] = fmaf(qr[g][3], kk.w, t);
      }
    }
    butterfly<NV, LPR / 2>(x, lane);

    // Online softmax: lane L holds the score of (row L / 8, head L % 8).
    const int64_t pos = row0 + static_cast<int64_t>(j * kWarps + warp) * kRows + (lane >> 3);
    const bool valid = pos < row_end;
    const float s = valid ? x[0] * a.scale : kNegInf;
    float mx = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float m_new = fmaxf(m, mx);
    const float p = expf(s - m_new) * (valid ? 1.f : 0.f);  // exactly 0 where masked
    float sum = p + __shfl_xor_sync(0xffffffffu, p, 8);
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, 16);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    s_pc[lane] = p;  // [row][head]
    if (lane < kMaxG) s_pc[kRows * kMaxG + lane] = corr;
    __syncwarp();

    // acc = acc * corr + P V over the lane's rows and 4 columns, every head:
    // the rows' products summed in row order, then added to the rescaled acc.
    float t[kMaxG][4];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) t[g][c] = 0.f;
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      const float4 lo = ld4(s_pc + (sub * RL + r) * kMaxG);
      const float4 hi = ld4(s_pc + (sub * RL + r) * kMaxG + 4);
      const float pr[kMaxG] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float4 vv = ld4(vs + (sub * RL + r) * DH + c4);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        t[g][0] = fmaf(pr[g], vv.x, t[g][0]);
        t[g][1] = fmaf(pr[g], vv.y, t[g][1]);
        t[g][2] = fmaf(pr[g], vv.z, t[g][2]);
        t[g][3] = fmaf(pr[g], vv.w, t[g][3]);
      }
    }
    const float4 clo = ld4(s_pc + kRows * kMaxG), chi = ld4(s_pc + kRows * kMaxG + 4);
    const float cg[kMaxG] = {clo.x, clo.y, clo.z, clo.w, chi.x, chi.y, chi.z, chi.w};
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] = acc[g][c] * cg[g] + t[g][c];
  }
  cp_async_wait<0>();

  // Both half-warps of dh 64 hold the same (m, l): add their accumulators.
  if constexpr (HALVES == 2) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][c] = acc[g][c] + __shfl_xor_sync(0xffffffffu, acc[g][c], 16);
  }

  // Merge the warps: their accumulators over the ring, (m, l) beside it.
  __syncthreads();
  float* s_acc = reinterpret_cast<float*>(smem);  // [warp][head][DH]
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      *reinterpret_cast<float4*>(s_acc + (warp * kMaxG + g) * DH + c4) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  if (lane < kMaxG) {
    s_ml[warp * 2 * kMaxG + lane] = m;
    s_ml[(warp * 2 + 1) * kMaxG + lane] = l;
  }
  __syncthreads();
  // Threads g < G: the head's max and each warp's weight, over the (m, l) slots.
  if (threadIdx.x < g_n) {
    const int g = threadIdx.x;
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, s_ml[w * 2 * kMaxG + g]);
    float lg = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(s_ml[w * 2 * kMaxG + g] - mg);
      lg = lg + s_ml[(w * 2 + 1) * kMaxG + g] * e;
      s_ml[w * 2 * kMaxG + g] = e;
    }
    const int64_t at = (static_cast<int64_t>(blockIdx.x) * g_n + g) * a.n_splits + split;
    part_ml[2 * at] = mg;
    part_ml[2 * at + 1] = lg;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g_n * DH; idx += kThreads) {
    const int g = idx / DH, d = idx - g * DH;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      t = t + s_acc[(w * kMaxG + g) * DH + d] * s_ml[w * 2 * kMaxG + g];
    // Query head (b, kvh * G + g) is row blockIdx.x * G + g of (B * H).
    const int64_t at = (static_cast<int64_t>(blockIdx.x) * g_n + g) * a.n_splits + split;
    part_acc[at * DH + d] = t;
  }
}

// One block of DH threads a query head: combine its splits and divide.
template <int DH, typename T>
__global__ void __launch_bounds__(DH)
fd_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                  T* __restrict__ out, int32_t n_splits) {
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ml = part_ml + 2 * bh * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(ml[2 * s] - m);
    l = l + ml[2 * s + 1] * w;
    acc = acc + part_acc[(bh * n_splits + s) * DH + tid] * w;
  }
  out[bh * DH + tid] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

// 16-byte copies where every K and V row starts on a 16-byte boundary
// (always for float32 rows on 4-element boundaries), else 8-byte ones.
template <typename T>
bool rows_16(const void* k, const void* v, const Args& a) {
  constexpr int64_t e = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
         a.k_sb % e == 0 && a.k_sl % e == 0 && a.k_sh % e == 0 && a.v_sb % e == 0 &&
         a.v_sl % e == 0 && a.v_sh % e == 0;
}

template <int DH, int BK, typename T, int COPY>
int launch_split(const void* q, const void* k, const void* v, float* part_ml, float* part_acc,
                 const dim3& grid, const Args& a, cudaStream_t stream) {
  auto kern = fd_split_kernel<DH, BK, T, COPY>;
  constexpr int smem = smem_bytes<DH, T>();
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), part_ml, part_acc, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int BK, typename T>
int launch(const void* q, const void* k, const void* v, float* part_ml, float* part_acc,
           void* out, int64_t batch, const Args& a, cudaStream_t stream) {
  const int64_t blocks = batch * a.kv_heads;
  if (blocks > 0x7fffffff || a.n_splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(a.n_splits));
  int rc;
  if constexpr (sizeof(T) == 4)
    rc = launch_split<DH, BK, T, 16>(q, k, v, part_ml, part_acc, grid, a, stream);
  else
    rc = rows_16<T>(k, v, a)
             ? launch_split<DH, BK, T, 16>(q, k, v, part_ml, part_acc, grid, a, stream)
             : launch_split<DH, BK, T, 8>(q, k, v, part_ml, part_acc, grid, a, stream);
  if (rc != 0) return rc;
  fd_combine_kernel<DH, T><<<static_cast<unsigned int>(blocks * a.group), DH, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int BK, typename T>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fd_split_kernel<DH, BK, T, 16>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes + smem_bytes<DH, T>());
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = kThreads;
  return 0;
}

// The instantiated tiles: kernels/flash_decode/kernel.TILES, in order.
#define FD_TILES(X) X(256) X(512) X(1024) X(2048) X(4096)

template <int BK>
int launch_dh(int32_t head_dim, int32_t dtype, const void* q, const void* k, const void* v,
              float* part_ml, float* part_acc, void* out, int64_t batch, const Args& a,
              cudaStream_t stream) {
  if (head_dim == 64)
    return dtype == 0 ? launch<64, BK, float>(q, k, v, part_ml, part_acc, out, batch, a, stream)
                      : launch<64, BK, __nv_bfloat16>(q, k, v, part_ml, part_acc, out, batch, a,
                                                      stream);
  if (head_dim == 128)
    return dtype == 0 ? launch<128, BK, float>(q, k, v, part_ml, part_acc, out, batch, a, stream)
                      : launch<128, BK, __nv_bfloat16>(q, k, v, part_ml, part_acc, out, batch,
                                                       a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int BK>
int attributes_dh(int32_t head_dim, int32_t dtype, int32_t* out) {
  if (head_dim == 64)
    return dtype == 0 ? attributes<64, BK, float>(out) : attributes<64, BK, __nv_bfloat16>(out);
  if (head_dim == 128)
    return dtype == 0 ? attributes<128, BK, float>(out) : attributes<128, BK, __nv_bfloat16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, H, dh) with contiguous rows (strides q_sb, q_sh); k, v: (B, L, Hk, dh)
// with contiguous rows (strides over batch, position, head), every row's
// start aligned to 4 elements; all float32 (dtype 0) or all bfloat16 (1).
// part_ml: float32 [B * H * n_splits][2], part_acc: float32
// [B * H * n_splits][dh] scratch; out: contiguous (B, H, dh) in the same
// dtype. n_splits = max(1, ceil(length / bk)); length <= L; H = Hk * group,
// group <= 8; head_dim 64 or 128; bk an instantiated tile.
int flash_decode_launch(int32_t bk, int32_t head_dim, int32_t dtype, const void* q,
                        const void* k, const void* v, float* part_ml, float* part_acc,
                        void* out, int64_t batch, int32_t kv_heads, int32_t group,
                        int64_t length, int32_t n_splits, int64_t q_sb, int64_t q_sh,
                        int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl,
                        int64_t v_sh, float scale, cudaStream_t stream) {
  if (group <= 0 || group > kMaxG || kv_heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  const Args a{q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, length, kv_heads, group,
               n_splits, scale};
#define FD_LAUNCH(BK)                                                                        \
  if (bk == BK)                                                                              \
    return launch_dh<BK>(head_dim, dtype, q, k, v, part_ml, part_acc, out, batch, a, stream);
  FD_TILES(FD_LAUNCH)
#undef FD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaFuncGetAttributes of the split pass's 16-byte-copy build (the 8-byte
// one has the same shared memory and threads), its shared memory counted
// with the dynamic amount the launcher requests.
int flash_decode_attributes(int32_t bk, int32_t head_dim, int32_t dtype, int32_t* out) {
#define FD_ATTR(BK) \
  if (bk == BK) return attributes_dh<BK>(head_dim, dtype, out);
  FD_TILES(FD_ATTR)
#undef FD_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
