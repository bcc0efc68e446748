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
// version (ref.matmul_plain).
//
// The tile is the kernel's timing parameter set, as on the TPU: the kernel
// is a template over (BM, BN, BK), and one instantiation exists for each
// member of kernels/latency_matmul/ops.CANDIDATES (TILES below). A block of
// 256 threads (16 x 16) owns a BM x BN output tile; each thread owns
// (BM / 16) x (BN / 16) outputs in registers, in 4 x 4 groups 64 rows or
// columns apart, so its fragment reads from shared memory are float4 and
// free of bank conflicts. The K axis is walked BK at a time through two
// shared-memory stages: while the block multiplies one stage, each thread
// has the next slice's global loads in flight in registers, then stores
// them into the other stage, one __syncthreads a slice. x's slice is
// stored transposed (k-major), so a thread's rows are one float4 read.
// Operands are converted to float32 on their way into shared memory, so a
// tile's shared memory is 2 * 4 * (BM * BK + BK * BN) bytes in either
// dtype (MMConfig.smem_bytes). Ragged m, n and k are masked in place:
// loads past an edge give 0, stores past an edge are dropped.
//
// Numerics: explicit fmaf in k order from 0 (the build passes -fmad=false),
// one rounding to x's dtype at the end (round to nearest even for bf16).
// The plain version's float32 product sums in another order, so the two
// agree within kernel.tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty picks row groups, tx column groups

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

template <int BM, int BN, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
mm_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
          int64_t m, int64_t n, int64_t k, int64_t ldx, int64_t ldy) {
  static_assert(BM % 64 == 0 && BN % 64 == 0, "BM and BN are multiples of 64");
  static_assert((BM * BK) % (4 * kThreads) == 0 && (BK * BN) % kThreads == 0, "even loads");
  constexpr int RM = BM / 64, RN = BN / 64;       // 4 x 4 groups a thread
  constexpr int LX = BM * BK / (4 * kThreads);    // 4-element x loads a thread
  constexpr int LY = BK * BN / kThreads;          // y loads a thread
  __shared__ __align__(16) float s_x[2][BK][BM];  // k-major
  __shared__ __align__(16) float s_y[2][BK][BN];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  float rx[LX][4], ry[LY];
  // x: lane -> row (consecutive rows, so the transposed stores hit distinct
  // banks), 4 consecutive k a load; y: lane -> column (coalesced).
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < LX; ++i) {
      const int e = tid + i * kThreads;
      const int r = e % BM, kq = e / BM;
      const int64_t gr = m0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t gk = k0 + 4 * kq + j;
        rx[i][j] = (gr < m && gk < k) ? to_f(x[gr * ldx + gk]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < LY; ++i) {
      const int e = tid + i * kThreads;
      const int c = e % BN, kr = e / BN;
      const int64_t gk = k0 + kr, gc = n0 + c;
      ry[i] = (gk < k && gc < n) ? to_f(y[gk * ldy + gc]) : 0.f;
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < LX; ++i) {
      const int e = tid + i * kThreads;
      const int r = e % BM, kq = e / BM;
#pragma unroll
      for (int j = 0; j < 4; ++j) s_x[st][4 * kq + j][r] = rx[i][j];
    }
#pragma unroll
    for (int i = 0; i < LY; ++i) {
      const int e = tid + i * kThreads;
      s_y[st][e / BN][e % BN] = ry[i];
    }
  };

  float acc[RM][4][RN][4];
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < RN; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][i][b][j] = 0.f;

  const int64_t n_slices = (k + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int64_t s = 0; s < n_slices; ++s) {
    const int st = static_cast<int>(s & 1);
    if (s + 1 < n_slices) load((s + 1) * BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float4 fa[RM], fb[RN];
#pragma unroll
      for (int a = 0; a < RM; ++a)
        fa[a] = *reinterpret_cast<const float4*>(&s_x[st][kk][a * 64 + ty * 4]);
#pragma unroll
      for (int b = 0; b < RN; ++b)
        fb[b] = *reinterpret_cast<const float4*>(&s_y[st][kk][b * 64 + tx * 4]);
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        const float av[4] = {fa[a].x, fa[a].y, fa[a].z, fa[a].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int b = 0; b < RN; ++b) {
            acc[a][i][b][0] = fmaf(av[i], fb[b].x, acc[a][i][b][0]);
            acc[a][i][b][1] = fmaf(av[i], fb[b].y, acc[a][i][b][1]);
            acc[a][i][b][2] = fmaf(av[i], fb[b].z, acc[a][i][b][2]);
            acc[a][i][b][3] = fmaf(av[i], fb[b].w, acc[a][i][b][3]);
          }
      }
    }
    if (s + 1 < n_slices) store(st ^ 1);  // that stage's readers passed the last barrier
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t gr = m0 + a * 64 + ty * 4 + i;
      if (gr >= m) continue;
#pragma unroll
      for (int b = 0; b < RN; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t gc = n0 + b * 64 + tx * 4 + j;
          if (gc < n) out[gr * n + gc] = from_f<T>(acc[a][i][b][j]);
        }
    }
}

template <int BM, int BN, int BK, typename T>
int launch(const void* x, const void* y, void* out, int64_t m, int64_t n, int64_t k,
           int64_t ldx, int64_t ldy, cudaStream_t stream) {
  const int64_t gm = (m + BM - 1) / BM, gn = (n + BN - 1) / BN;
  if (gm > 65535 || gn > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(gn), static_cast<unsigned int>(gm));
  mm_kernel<BM, BN, BK, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), m, n, k, ldx,
      ldy);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, typename T>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, mm_kernel<BM, BN, BK, T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes);
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = kThreads;
  return 0;
}

// The instantiated tiles: kernels/latency_matmul/kernel.TILES, in order.
#define MM_TILES(X) \
  X(64, 64, 16)     \
  X(128, 64, 16)    \
  X(64, 128, 16)    \
  X(128, 128, 8)    \
  X(128, 128, 16)

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (m, k), y: (k, n) device tensors with contiguous rows (row strides ldx,
// ldy in elements), out: contiguous (m, n); dtype 0 = float32, 1 = bfloat16
// for all three. (bm, bn, bk) must be an instantiated tile.
int latency_matmul_launch(int32_t bm, int32_t bn, int32_t bk, int32_t dtype, const void* x,
                          const void* y, void* out, int64_t m, int64_t n, int64_t k,
                          int64_t ldx, int64_t ldy, cudaStream_t stream) {
  if (m == 0 || n == 0) return static_cast<int>(cudaGetLastError());
#define MM_LAUNCH(BM, BN, BK)                                                              \
  if (bm == BM && bn == BN && bk == BK)                                                    \
    return dtype == 0 ? launch<BM, BN, BK, float>(x, y, out, m, n, k, ldx, ldy, stream)    \
                      : launch<BM, BN, BK, __nv_bfloat16>(x, y, out, m, n, k, ldx, ldy, stream);
  MM_TILES(MM_LAUNCH)
#undef MM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaFuncGetAttributes of one instantiation: registers a thread, static
// shared memory, max threads a block, local (spill) bytes, threads launched.
int latency_matmul_attributes(int32_t bm, int32_t bn, int32_t bk, int32_t dtype,
                              int32_t* out) {
#define MM_ATTR(BM, BN, BK)                                                          \
  if (bm == BM && bn == BN && bk == BK)                                              \
    return dtype == 0 ? attributes<BM, BN, BK, float>(out)                           \
                      : attributes<BM, BN, BK, __nv_bfloat16>(out);
  MM_TILES(MM_ATTR)
#undef MM_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
