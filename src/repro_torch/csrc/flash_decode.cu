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
// ms at 3.35 TB/s, against 8.6 GFLOP (~0.13 ms at 67 TFLOP/s).
//
// Design: split-K (FlashDecoding). The TPU kernel walks a head's cache in
// order with its softmax state in scratch; here B * Hk = 64 KV heads at that
// shape would be 64 blocks on 132 SMs, far too few to pull HBM bandwidth.
// So the cache is cut into splits of BK rows (FDConfig.bk, the kernel's
// timing parameter: one instantiation per member of
// kernels/flash_decode/ops.CANDIDATES, FD_TILES below) and one block of DH
// threads takes one (batch, KV head, split): it stages the group's G query
// heads once, then walks its split in 32-row sub-tiles — K and V rows
// loaded with 16-byte (float32) or 8-byte (bfloat16) vector loads into
// shared memory (K rows padded by 4 floats so the score loop's float4 reads
// are free of bank conflicts), the G x 32 scores, one warp per head for the
// max and the sum, and thread d accumulating output column d for all G
// heads. GQA costs nothing: the group shares every K and V row it loads, and
// KV is read through its strides (no head repeat, no transpose copy). Each
// block writes its (m, l, acc) partials; a second launch combines a head's
// splits (max of m, rescaled sums) and divides. Only the splits that hold
// valid rows are launched: the work follows `length`, not the cache size.
//
// Numerics against the plain version (ref.flash_decode_plain): the same
// mask, float32 scale, precise expf and p = 0 where masked; explicit fmaf
// for the dot products (the build passes -fmad=false). The splits sum in
// another order than the plain version's products, so the two agree within
// kernel.tolerance, not bitwise. With one split the combine is exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kT = 32;     // KV rows a sub-tile (one warp lane a row in the softmax)
constexpr int kMaxG = 8;   // query heads a KV head

struct Args {
  int64_t q_sb, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t len;  // valid cache rows, <= L
  int32_t kv_heads, group, n_splits;
  float scale;
};

template <int DH>
__host__ __device__ constexpr int smem_floats() {
  return kT * (DH + 4) + kT * DH + kMaxG * DH + kMaxG * kT + 3 * kMaxG;
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

// Four consecutive elements as float4 (16-byte load for float32, 8-byte for bf16).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

template <int DH, int BK, typename T>
__global__ void __launch_bounds__(DH)
fd_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ part_ml, float* __restrict__ part_acc, const Args a) {
  static_assert(BK % kT == 0 && DH % 32 == 0, "tile shapes");
  constexpr int KS = DH + 4;  // padded K row
  constexpr int D4 = DH / 4;
  constexpr int kWarps = DH / 32;
  __shared__ __align__(16) float smem[smem_floats<DH>()];
  float* s_k = smem;                 // [kT][KS]
  float* s_v = s_k + kT * KS;        // [kT][DH]
  float* s_q = s_v + kT * DH;        // [kMaxG][DH]
  float* s_p = s_q + kMaxG * DH;     // [kMaxG][kT]: scores, then p
  float* s_m = s_p + kMaxG * kT;     // [kMaxG]
  float* s_l = s_m + kMaxG;          // [kMaxG]
  float* s_c = s_l + kMaxG;          // [kMaxG]: this sub-tile's rescale

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.kv_heads, kvh = blockIdx.x - b * a.kv_heads;
  const int g_n = a.group;
  const int64_t split = blockIdx.y;

  for (int idx = tid; idx < g_n * DH; idx += DH) {
    const int g = idx / DH, d = idx - g * DH;
    s_q[g * DH + d] = to_f(q[b * a.q_sb + (kvh * g_n + g) * a.q_sh + d]);
  }
  if (tid < kMaxG) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  const T* kb = k + b * a.k_sb + kvh * a.k_sh;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh;
  const int64_t row0 = split * BK;
  const int64_t row_end = row0 + BK < a.len ? row0 + BK : a.len;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int64_t t0 = row0; t0 < row_end; t0 += kT) {
    __syncthreads();  // the previous sub-tile's readers are done (and q, m, l are set)
    for (int idx = tid; idx < kT * D4; idx += DH) {
      const int r = idx / D4, c4 = idx - r * D4;
      const int64_t pos = t0 + r;
      const bool in = pos < row_end;
      const float4 kr = in ? ld4(kb + pos * a.k_sl + 4 * c4) : zero;
      const float4 vr = in ? ld4(vb + pos * a.v_sl + 4 * c4) : zero;
      *reinterpret_cast<float4*>(s_k + r * KS + 4 * c4) = kr;
      *reinterpret_cast<float4*>(s_v + r * DH + 4 * c4) = vr;
    }
    __syncthreads();

    // Scores of the G heads against the sub-tile's rows: pair (g, r), lane = r.
    for (int p = tid; p < g_n * kT; p += DH) {
      const int g = p / kT, r = p - g * kT;
      const float* qr = s_q + g * DH;
      const float* kr = s_k + r * KS;
      float x = 0.f;
#pragma unroll 8
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 qa = *reinterpret_cast<const float4*>(qr + 4 * d4);
        const float4 ka = *reinterpret_cast<const float4*>(kr + 4 * d4);
        x = fmaf(qa.x, ka.x, x);
        x = fmaf(qa.y, ka.y, x);
        x = fmaf(qa.z, ka.z, x);
        x = fmaf(qa.w, ka.w, x);
      }
      s_p[g * kT + r] = t0 + r < row_end ? x * a.scale : kNegInf;
    }
    __syncthreads();

    // Online softmax, one warp a head.
    for (int g = warp; g < g_n; g += kWarps) {
      const float s = s_p[g * kT + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;
      s_p[g * kT + lane] = p;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
        s_c[g] = corr;
      }
    }
    __syncthreads();

    // acc += P V: thread tid owns output column tid of every head.
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= g_n) break;
      const float* pr = s_p + g * kT;
      float t = 0.f;
#pragma unroll 8
      for (int r = 0; r < kT; ++r) t = fmaf(pr[r], s_v[r * DH + tid], t);
      acc[g] = acc[g] * s_c[g] + t;
    }
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= g_n) break;
    // Query head (b, kvh * G + g) is row blockIdx.x * G + g of (B * H).
    const int64_t at = (static_cast<int64_t>(blockIdx.x) * g_n + g) * a.n_splits + split;
    part_acc[at * DH + tid] = acc[g];
    if (tid == 0) {
      part_ml[2 * at] = s_m[g];
      part_ml[2 * at + 1] = s_l[g];
    }
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

template <int DH, int BK, typename T>
int launch(const void* q, const void* k, const void* v, float* part_ml, float* part_acc,
           void* out, int64_t batch, const Args& a, cudaStream_t stream) {
  const int64_t blocks = batch * a.kv_heads;
  if (blocks > 0x7fffffff || a.n_splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks), static_cast<unsigned int>(a.n_splits));
  fd_split_kernel<DH, BK, T><<<grid, DH, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part_ml,
      part_acc, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_combine_kernel<DH, T><<<static_cast<unsigned int>(blocks * a.group), DH, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int BK, typename T>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fd_split_kernel<DH, BK, T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes);
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = DH;
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

int flash_decode_attributes(int32_t bk, int32_t head_dim, int32_t dtype, int32_t* out) {
#define FD_ATTR(BK) \
  if (bk == BK) return attributes_dh<BK>(head_dim, dtype, out);
  FD_TILES(FD_ATTR)
#undef FD_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
