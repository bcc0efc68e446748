// Flash attention (FA-2 online softmax) for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel _fa_kernel
// (src/repro/kernels/flash_attention/kernel.py:35, launcher flash_attention_hm,
// entry ops.flash_attention): causal, sliding-window and padding masks, GQA
// by KV head h / g, float32 softmax state and accumulators, and
// out = acc / max(l, 1e-30), so a fully masked row gives 0.
//
// What bounds it on this card: operations. Per unmasked (query, key) pair it
// does 2 * dh multiply-adds (Q K^T and P V) against q, k, v read once; at
// the LM serve path's prefill (B 4, H 24, Hk 8, S 1,024, dh 128, causal)
// that is 25.8 GFLOP against 0.13 GB, ~0.39 ms at the 67 TFLOP/s of
// float32 outside the tensor cores. Tensor cores are not used: TF32 would
// change the numbers against the float32 plain version.
//
// Design. One block of 256 threads per (batch * head, 64-query tile); the
// block walks the 64-key tiles its queries can see (the causal diagonal and
// the window bound its range: a fully masked tile leaves m, l and acc as
// they were, so skipping it changes no result). The Q tile, the K and V
// tiles and the P tile live in shared memory (112 KB at dh 128, so two
// blocks share an SM); each thread owns 4 query rows (ty + 16 i) and, of
// each tile, 4 key columns (tx + 16 j) of S and dh / 16 output columns of
// the accumulator, so a row's max and sum reduce over the 16 lanes that
// hold it with shuffles (at dh 32 the output has 8 float4 slots: lanes
// tx >= 8 mirror lanes tx - 8 and do not write). Q and K rows are
// XOR-swizzled by float4 slot (slot ^ (row & 7)) and P by row parity, so
// the inner loops' shared loads are free of bank conflicts without padding.
// The kernel reads the public (B, S, H, dh) layout through strides (last
// dim contiguous, 16-byte aligned), masks ragged lengths itself (rows and
// keys past the end load as zeros and are masked) and writes a contiguous
// (B, Sq, H, dh) output. The heaviest causal query tiles launch first.
// Offsets are 64-bit.
//
// Numerics against the plain version (ref.flash_attention_plain): the same
// masks and the same float32 scale, precise expf, explicit fmaf for the
// dot products (the build passes -fmad=false, which only stops the compiler
// contracting separate multiplies and adds), IEEE division at the end.
// Sums run in another order than a float32 matrix product, so results agree
// within a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks query rows, tx key / output columns
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;

struct Args {
  int64_t sq, skv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int32_t heads, group, causal, window;
  float scale;
};

template <int DH>
constexpr size_t smem_bytes() {
  return (kBQ + 2 * kBK) * (DH / 4) * sizeof(float4) + kBQ * kBK * sizeof(float);
}

__device__ __forceinline__ int swz(int row, int slot) { return slot ^ (row & 7); }

// Float offset of P[r][c] in the P tile: float4 slots swizzled by row parity.
__device__ __forceinline__ int p_at(int r, int c) {
  return r * kBK + ((((c >> 2) ^ ((r & 1) << 2))) << 2) + (c & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, const Args a) {
  constexpr int D4 = DH / 4;                  // float4 slots per row
  constexpr int OG = DH >= 64 ? DH / 64 : 1;  // output float4 slots per thread: tx + 16 g
  extern __shared__ float4 smem[];
  float4* s_q = smem;                 // [kBQ][D4], swizzled
  float4* s_k = s_q + kBQ * D4;       // [kBK][D4], swizzled
  float4* s_v = s_k + kBK * D4;       // [kBK][D4]
  float* s_p = reinterpret_cast<float*>(s_v + kBK * D4);  // [kBQ][kBK], p_at

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int kvh = h / a.group;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;

  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* kb = k + b * a.k_sb + kvh * a.k_sh;
  const float* vb = v + b * a.v_sb + kvh * a.v_sh;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = tid; idx < kBQ * D4; idx += kThreads) {
    const int r = idx / D4, d4 = idx - r * D4;
    const int64_t qp = q0 + r;
    s_q[r * D4 + swz(r, d4)] = qp < a.sq ? ld4(qb + qp * a.q_ss + 4 * d4) : zero;
  }

  // Key tiles this query tile can see.
  const int64_t q_last = (q0 + kBQ < a.sq ? q0 + kBQ : a.sq) - 1;
  int64_t kv_lo = 0, kv_hi = a.skv;
  if (a.causal && q_last + 1 < kv_hi) kv_hi = q_last + 1;
  if (a.window > 0 && q0 - a.window + 1 > 0) kv_lo = q0 - a.window + 1;
  const int64_t t_lo = kv_lo / kBK, t_hi = (kv_hi + kBK - 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][OG][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done with s_k, s_v, s_p
    for (int idx = tid; idx < kBK * D4; idx += kThreads) {
      const int c = idx / D4, d4 = idx - c * D4;
      const int64_t kp = k0 + c;
      const bool in = kp < a.skv;
      s_k[c * D4 + swz(c, d4)] = in ? ld4(kb + kp * a.k_ss + 4 * d4) : zero;
      s_v[c * D4 + d4] = in ? ld4(vb + kp * a.v_ss + 4 * d4) : zero;
    }
    __syncthreads();

    // S = Q K^T over this tile: rows ty + 16 i, columns tx + 16 j.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 qa[kRows], ka[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + 16 * i;
        qa[i] = s_q[r * D4 + swz(r, d4)];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tx + 16 * j;
        ka[j] = s_k[c * D4 + swz(c, d4)];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float x = s[i][j];
          x = fmaf(qa[i].x, ka[j].x, x);
          x = fmaf(qa[i].y, ka[j].y, x);
          x = fmaf(qa[i].z, ka[j].z, x);
          x = fmaf(qa[i].w, ka[j].w, x);
          s[i][j] = x;
        }
    }

    // Mask, online softmax, P into shared memory.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int64_t qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        bool ok = qp < a.sq && kp < a.skv;
        if (a.causal) ok = ok && qp >= kp;
        if (a.window > 0) ok = ok && qp - kp < a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        ps += p;
        s_p[p_at(r, tx + 16 * j)] = p;
      }
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < OG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty + 16 i, output float4 slots tx + 16 g.
    const float4* p4 = reinterpret_cast<const float4*>(s_p);
#pragma unroll 2
    for (int c4 = 0; c4 < kBK / 4; ++c4) {
      float4 pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = ty + 16 * i;
        pa[i] = p4[r * (kBK / 4) + (c4 ^ ((r & 1) << 2))];
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = 4 * c4 + cc;
        float4 va[OG];
#pragma unroll
        for (int g = 0; g < OG; ++g) va[g] = s_v[c * D4 + ((tx + 16 * g) & (D4 - 1))];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = comp(pa[i], cc);
#pragma unroll
          for (int g = 0; g < OG; ++g) {
            acc[i][g][0] = fmaf(p, va[g].x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, va[g].y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, va[g].z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, va[g].w, acc[i][g][3]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30): l is the sum of the 16 lanes' partial sums.
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float den = fmaxf(lt, 1e-30f);
    const int64_t qp = q0 + ty + 16 * i;
    if (qp < a.sq && tx < D4) {
      float* o = out + ((static_cast<int64_t>(b) * a.sq + qp) * a.heads + h) * DH;
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        *reinterpret_cast<float4*>(o + 4 * (tx + 16 * g)) =
            make_float4(acc[i][g][0] / den, acc[i][g][1] / den, acc[i][g][2] / den,
                        acc[i][g][3] / den);
      }
    }
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* out, int64_t batch,
           const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_q_tiles = (a.sq + kBQ - 1) / kBQ;
  const int64_t n_heads = batch * a.heads;
  if (n_q_tiles > 65535 || n_heads > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(n_heads), static_cast<unsigned int>(n_q_tiles));
  fa_kernel<DH><<<grid, kThreads, smem, stream>>>(q, k, v, out, a);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fa_kernel<DH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes + smem_bytes<DH>());
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = kThreads;
  return 0;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, Sq, H, dh), k and v: (B, Skv, Hk, dh) float32 device tensors given
// by their element strides over (batch, position, head), the head dim
// contiguous and every row 16-byte aligned (the wrapper checks); out is a
// contiguous (B, Sq, H, dh) float32 tensor. head_dim must be 32, 64 or 128.
int flash_attention_launch(const float* q, const float* k, const float* v, float* out,
                           int64_t batch, int64_t sq, int64_t skv, int32_t heads,
                           int32_t kv_heads, int32_t head_dim, int64_t q_sb, int64_t q_ss,
                           int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                           int64_t v_sb, int64_t v_ss, int64_t v_sh, int32_t causal,
                           int32_t window, float scale, cudaStream_t stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0 || heads == 0) return static_cast<int>(cudaGetLastError());
  const Args a{sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               heads, heads / kv_heads, causal, window, scale};
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, out, batch, a, stream);
    case 64:
      return launch<64>(q, k, v, out, batch, a, stream);
    case 128:
      return launch<128>(q, k, v, out, batch, a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cudaFuncGetAttributes of the head_dim instantiation (its one 64 x 64 tile):
// registers a thread, shared memory a block (static plus the dynamic amount
// the launcher requests), max threads a block, local (spill) bytes, threads.
int flash_attention_attributes(int32_t head_dim, int32_t* out) {
  switch (head_dim) {
    case 32:
      return attributes<32>(out);
    case 64:
      return attributes<64>(out);
    case 128:
      return attributes<128>(out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
