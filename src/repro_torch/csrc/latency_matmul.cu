// Latency-tuned tiled matmul for Hopper (sm_90a): out = x @ y, float32 FMA.
//
// Replaces the Pallas TPU kernel _mm_kernel
// (src/repro/kernels/latency_matmul/kernel.py:29, launcher matmul_tiled,
// entry ops.matmul): (m, k) @ (k, n) with a float32 accumulator over
// bk-deep slices of the contraction, the result cast to x's dtype. x and y
// are float32 or bfloat16.
//
// What bounds it on this card: operations. At altune's production shape,
// 4096 x 4096 x 4096, it does 137.4 GFLOP of float32 FMA against 201 MB
// of operands and output: ~2.05 ms at the 67 TFLOP/s of float32 outside
// the tensor cores, ~0.06 ms of bytes. Tensor cores are not used: TF32 or
// bf16 products would change the numbers against the float32 plain
// version (ref.matmul_plain). At one FMA warp-instruction a clock per
// scheduler, every other instruction the kernel issues, and every clock a
// scheduler finds no ready warp, is time off that bound.
//
// Design (a SIMT SGEMM in the manner of cuBLAS's float32 kernels). The tile
// is the kernel's timing parameter set, as on the TPU: the kernel is a
// template over (BM, BN, BK), one instantiation for each member of
// kernels/latency_matmul/ops.CANDIDATES (MM_TILES below).
// - Each thread owns 8 x TN outputs (rows ty + 8 i, columns 4 tx + 16 h + j)
//   and each warp a 64 x 4 TN piece of the block's BM x BN output tile.
//   TN = 16 on the 128 x 128 and 128 x 256 tiles (warps of 64 x 64, as
//   cuBLAS's float32 kernels run them): 128 accumulators and up to 255
//   registers a thread, 8 warps an SM. TN = 8 on the smaller tiles: 64
//   accumulators, launch bounds of 128 registers, four 128-thread blocks
//   (eight of 64) an SM. Shared-memory loads per FMA are what a SIMT GEMM
//   on this card spends most against: per 2 k steps a thread reads 8
//   float2 of x and TN / 2 float4 of y for 16 TN FMAs.
// - The K axis is walked BK at a time through a ring of up to 4
//   shared-memory stages, filled 3 slices ahead of the products with one
//   barrier a slice. float32 operands whose rows are 16-byte aligned are
//   copied by cp.async (16 bytes, .cg): whole slices of interior blocks by
//   straight-line copies, slices on a ragged edge zero-filled past it
//   through the copy's source size. x's slice stays row-major (cp.async
//   cannot transpose) in rows padded to BK + 4 floats, so the 8 rows a
//   warp's lanes read at once fall in distinct banks.
// - bfloat16 operands, and float32 ones whose rows are not 16-byte aligned
//   (a row of 700 bfloat16 is 1,400 bytes), take the register path inside
//   the same kernel: element loads with bounds checks, converted to
//   float32 and stored into the same ring. A tile's shared memory is
//   therefore stages * 4 * (BM * (BK + 4) + BK * BN) bytes in either dtype,
//   all of it dynamic (MMConfig.smem_bytes; 4 stages, or 3 where four
//   would leave room for one 256-thread block an SM). Stores past an edge
//   are dropped.
// - Blocks launch in groups of 8 block rows, so the blocks in flight share
//   rows of x and columns of y in L2.
// - On the cp.async path (operands under 2^31 elements) offsets are 32-bit;
//   the register path takes any size with 64-bit ones.
//
// Numerics: explicit fmaf in k order from 0 (the build passes -fmad=false),
// one rounding to x's dtype at the end (round to nearest even for bf16).
// The plain version's float32 product sums in another order, so the two
// agree within kernel.tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 4;          // slices in the shared-memory ring, at most
constexpr int kGroup = 8;              // block rows of a launch group
constexpr int kTwoBlockSmem = 115712;  // bytes a block may take with two on an SM
constexpr int kPadA = 4;               // floats of padding after a row of x's slice
constexpr int kWarpM = 64;             // a warp's rows; its columns are 4 * TN

template <int BM, int BN, int TN>
__host__ __device__ constexpr int threads_of() { return BM * BN / (8 * TN); }

// Launch bounds: 128 registers a thread at 8 x 8 outputs (512 threads an
// SM), 255 at 8 x 16 (256 threads an SM).
template <int BM, int BN, int TN>
__host__ __device__ constexpr int min_blocks() {
  return (TN == 8 ? 512 : 256) / threads_of<BM, BN, TN>();
}

// The ring holds kMaxStages slices, or as many (two at least) as leave room
// for two blocks an SM.
template <int BM, int BN, int BK>
__host__ __device__ constexpr int stages_of() {
  constexpr int fit = kTwoBlockSmem / (4 * (BM * (BK + kPadA) + BK * BN));
  return fit < 2 ? 2 : fit < kMaxStages ? fit : kMaxStages;
}

template <int BM, int BN, int BK>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * stages_of<BM, BN, BK>() * (BM * (BK + kPadA) + BK * BN);
}

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

// 16-byte global -> shared copy; bytes past src_bytes (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ASYNC: float32 operands with 16-byte aligned rows and fewer than 2^31
// elements, copied by cp.async with 32-bit offsets; otherwise the register
// path, with 64-bit ones. Both fill the same float32 ring. TN: a thread's
// columns, 8 or 16.
template <int BM, int BN, int BK, int TN, typename T, bool ASYNC>
__global__ void __launch_bounds__(threads_of<BM, BN, TN>(), min_blocks<BM, BN, TN>())
mm_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int m,
          int n, int k, int64_t ldx, int64_t ldy) {
  constexpr int NT = threads_of<BM, BN, TN>();
  constexpr int kStages = stages_of<BM, BN, BK>();
  constexpr int kWarpN = 4 * TN;
  constexpr int TH = TN / 4;                // float4 column groups a thread, 16 apart
  constexpr int WARPS_M = BM / kWarpM;
  constexpr int SA = BK + kPadA;            // row stride of x's slice, floats
  constexpr int STAGE = BM * SA + BK * BN;  // floats a stage
  constexpr int AV = BK / 4, BV = BN / 4;   // 16-byte chunks a row of each slice
  constexpr int NA = BM * AV / NT, NB = BK * BV / NT;
  static_assert(BM % kWarpM == 0 && BN % kWarpN == 0 && BK % 4 == 0, "tile shape");
  static_assert((BM * AV) % NT == 0 && (BK * BV) % NT == 0, "even copies");
  static_assert(!ASYNC || sizeof(T) == 4, "cp.async copies float32 only");
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane >> 2, tx = lane & 3;
  const int row0 = (warp % WARPS_M) * kWarpM + ty;      // rows row0 + 8 i
  const int col0 = (warp / WARPS_M) * kWarpN + 4 * tx;  // columns col0 + 16 h + j
  // Blocks launch in groups of kGroup block rows, down each column of a
  // group, so the blocks in flight share rows of x and columns of y in L2.
  const int gm = (m + BM - 1) / BM, gn = (n + BN - 1) / BN, bid = blockIdx.x;
  const int first = bid / (kGroup * gn) * kGroup, rows = min(gm - first, kGroup);
  const int bm_i = first + bid % (kGroup * gn) % rows, bn_i = bid % (kGroup * gn) / rows;
  const int m0 = bm_i * BM, n0 = bn_i * BN;
  const bool interior = m0 + BM <= m && n0 + BN <= n;

  // Slice k0 .. k0 + BK of x's rows and y's columns into stage st.
  auto load_slice = [&](int st, int k0) {
    float* sa = smem + st * STAGE;
    float* sb = sa + BM * SA;
    const bool full = interior && k0 + BK <= k;
    if constexpr (ASYNC) {
      const int ldx32 = static_cast<int>(ldx), ldy32 = static_cast<int>(ldy);
      if (full) {  // straight-line copies: chunks at fixed offsets
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int c = tid + i * NT, r = c / AV, kc = 4 * (c % AV);
          cp_async16(sa + r * SA + kc, x + ((m0 + r) * ldx32 + k0 + kc), 16);
        }
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const int c = tid + i * NT, r = c / BV, cc = 4 * (c % BV);
          cp_async16(sb + r * BN + cc, y + ((k0 + r) * ldy32 + n0 + cc), 16);
        }
        return;
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int c = tid + i * NT, r = c / AV, kc = 4 * (c % AV);
        const int bytes = full ? 16 : m0 + r < m ? 4 * max(0, min(4, k - k0 - kc)) : 0;
        cp_async16(sa + r * SA + kc, x + (bytes ? (m0 + r) * ldx32 + k0 + kc : 0), bytes);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int c = tid + i * NT, r = c / BV, cc = 4 * (c % BV);
        const int bytes = full ? 16 : k0 + r < k ? 4 * max(0, min(4, n - n0 - cc)) : 0;
        cp_async16(sb + r * BN + cc, y + (bytes ? (k0 + r) * ldy32 + n0 + cc : 0), bytes);
      }
    } else {
      const T* xs = x + static_cast<int64_t>(m0) * ldx + k0;
      const T* ys = y + static_cast<int64_t>(k0) * ldy + n0;
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        sa[r * SA + kk] = (full || (m0 + r < m && k0 + kk < k)) ? to_f(xs[r * ldx + kk]) : 0.f;
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int r = e / BN, c = e % BN;
        sb[r * BN + c] = (full || (k0 + r < k && n0 + c < n)) ? to_f(ys[r * ldy + c]) : 0.f;
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_slices = (k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) load_slice(s, s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < n_slices; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slice t have landed
    __syncthreads();               // everyone's have; everyone is done with slice t - 1
    if (t + kStages - 1 < n_slices) load_slice((t + kStages - 1) % kStages, (t + kStages - 1) * BK);
    cp_async_commit();

    const float* pa = smem + (t % kStages) * STAGE + row0 * SA;
    const float* pb = smem + (t % kStages) * STAGE + BM * SA + col0;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {  // x's fragments two k values a load
      float a[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 v = *reinterpret_cast<const float2*>(pa + 8 * i * SA + kk);
        a[i][0] = v.x, a[i][1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4 bv[TH];
#pragma unroll
        for (int hh = 0; hh < TH; ++hh)
          bv[hh] = *reinterpret_cast<const float4*>(pb + (kk + j) * BN + 16 * hh);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = a[i][j];
#pragma unroll
          for (int hh = 0; hh < TH; ++hh) {
            acc[i][4 * hh] = fmaf(av, bv[hh].x, acc[i][4 * hh]);
            acc[i][4 * hh + 1] = fmaf(av, bv[hh].y, acc[i][4 * hh + 1]);
            acc[i][4 * hh + 2] = fmaf(av, bv[hh].z, acc[i][4 * hh + 2]);
            acc[i][4 * hh + 3] = fmaf(av, bv[hh].w, acc[i][4 * hh + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  T* ob = out + static_cast<int64_t>(m0) * n + n0;
  const bool vec = sizeof(T) == 4 && interior && n % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * i;
#pragma unroll
    for (int h = 0; h < TH; ++h) {
      const int c = col0 + 16 * h;
      T* o = ob + static_cast<int64_t>(r) * n + c;
      if (vec) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else if (m0 + r < m) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + c + j < n) o[j] = from_f<T>(acc[i][4 * h + j]);
      }
    }
  }
}

template <int BM, int BN, int BK, int TN, typename T, bool ASYNC>
int launch(const void* x, const void* y, void* out, int m, int n, int k, int64_t ldx,
           int64_t ldy, cudaStream_t stream) {
  auto kern = mm_kernel<BM, BN, BK, TN, T, ASYNC>;
  constexpr size_t smem = smem_bytes<BM, BN, BK>();
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned int>(blocks), threads_of<BM, BN, TN>(), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), m, n, k, ldx,
      ldy);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int TN, typename T, bool ASYNC>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, mm_kernel<BM, BN, BK, TN, T, ASYNC>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes + smem_bytes<BM, BN, BK>());
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = threads_of<BM, BN, TN>();
  return 0;
}

// The instantiated tiles: kernels/latency_matmul/kernel.TILES, in order,
// each with its thread's column count TN (ops.MMConfig.thread_cols).
#define MM_TILES(X)   \
  X(64, 64, 16, 8)    \
  X(128, 64, 16, 8)   \
  X(64, 128, 16, 8)   \
  X(128, 128, 8, 16)  \
  X(128, 128, 16, 16) \
  X(128, 128, 32, 16) \
  X(128, 256, 16, 16)

// The cp.async path: 16-byte aligned rows, offsets within 32 bits.
bool async_ok(const void* p, int64_t ld, int64_t rows) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0 && rows * ld < INT32_MAX;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (m, k), y: (k, n) device tensors with contiguous rows (row strides ldx,
// ldy in elements), out: contiguous (m, n); dtype 0 = float32, 1 = bfloat16
// for all three. (bm, bn, bk) must be an instantiated tile; m, n, k < 2^31.
int latency_matmul_launch(int32_t bm, int32_t bn, int32_t bk, int32_t dtype, const void* x,
                          const void* y, void* out, int64_t m, int64_t n, int64_t k,
                          int64_t ldx, int64_t ldy, cudaStream_t stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  if (m > INT32_MAX || n > INT32_MAX || k > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mi = static_cast<int>(m), ni = static_cast<int>(n), ki = static_cast<int>(k);
  const bool async = dtype == 0 && async_ok(x, ldx, m) && async_ok(y, ldy, k);
#define MM_LAUNCH(BM, BN, BK, TN)                                                              \
  if (bm == BM && bn == BN && bk == BK) {                                                      \
    if (dtype != 0)                                                                            \
      return launch<BM, BN, BK, TN, __nv_bfloat16, false>(x, y, out, mi, ni, ki, ldx, ldy,     \
                                                          stream);                             \
    return async ? launch<BM, BN, BK, TN, float, true>(x, y, out, mi, ni, ki, ldx, ldy, stream) \
                 : launch<BM, BN, BK, TN, float, false>(x, y, out, mi, ni, ki, ldx, ldy, stream); \
  }
  MM_TILES(MM_LAUNCH)
#undef MM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaFuncGetAttributes of one instantiation (float32: the cp.async path that
// aligned operands take if aligned != 0, else the register path; bfloat16
// always takes the register path): registers a thread, shared memory a block
// (static plus the dynamic ring its launcher requests), max threads a block,
// local (spill) bytes, threads launched.
int latency_matmul_attributes(int32_t bm, int32_t bn, int32_t bk, int32_t dtype,
                              int32_t aligned, int32_t* out) {
#define MM_ATTR(BM, BN, BK, TN)                                                          \
  if (bm == BM && bn == BN && bk == BK) {                                                \
    if (dtype != 0) return attributes<BM, BN, BK, TN, __nv_bfloat16, false>(out);        \
    return aligned ? attributes<BM, BN, BK, TN, float, true>(out)                        \
                   : attributes<BM, BN, BK, TN, float, false>(out);                      \
  }
  MM_TILES(MM_ATTR)
#undef MM_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
