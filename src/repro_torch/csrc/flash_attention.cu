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
// Design. The (BQ, BK) query x key tile is the kernel's timing parameter
// set, as on the TPU: the kernel is a template over (BQ, BK, dh), one
// instantiation for each tile of kernels/flash_attention/ops.candidates(dh)
// at each head width (FA_INSTANCES below). One block per (batch * head,
// BQ-query tile) walks the BK-key tiles its queries can see (the causal
// diagonal and the window bound its range: a fully masked tile leaves m, l
// and acc as they were, so skipping it changes no result).
// - A block has BQ * BK / 32 threads, 16 lanes tx across keys and output
//   columns and TY = threads / 16 rows ty. Each thread owns 32 scores of a
//   tile, rows ty + TY i and keys tx + 16 j (8 x 4; 4 x 8 at BK 128), and
//   output float4 slots tx + 16 g of those rows, so a row's max and sum
//   reduce over the 16 lanes that hold it with shuffles (at dh 32 the
//   output has 8 float4 slots: lanes tx >= 8 mirror lanes tx - 8 and do not
//   write, at dh 16 4 slots, lanes tx >= 4 mirroring tx & 3; at dh 80, 20
//   slots, and at dh 112, 28: slot tx + 16 of lanes tx >= 4, or tx >= 12,
//   lies past the row, reads the next V row's slots, which lie inside the
//   block's shared memory, and is not written).
// - At dh 256 and 320 a thread owns 16 scores (4 x 4; kScoresWide), twice
//   the threads a tile, so its share of the output accumulator (4 rows x
//   dh / 16 columns) stays in registers.
//   At 8 x 4 a thread, Q K^T does 128 FMAs for 12 LDS.128 and P V 256 for
//   16 (64 for 8 and 128 for 12 at 4 x 4).
// - The Q tile, one K tile, one V tile and the P tile live in shared
//   memory, (BQ + 2 BK) dh + BQ BK floats and a float4 of padding a K row:
//   113 KB at (64, 64) and dh 128, so two 128-thread blocks share an SM;
//   161 and 194 KB at (128, 64) and (64, 128), one 256-thread block an SM.
//   A tile is instantiated at a head width only where this fits the 227 KB
//   a block may have: at dh 256 only (64, 64) (209 KB), at dh 320 only
//   (32, 64) (209 KB; (64, 64) would need 257 KB).
//   K rows are padded by one float4, and Q's and P's float4 slots swizzled
//   by row parity, so the inner loops' shared loads are free of bank
//   conflicts and address their operands from a few base registers with
//   compile-time offsets.
//
// Loads overlap the products: Q, K and V are copied by cp.async (16 bytes,
// zero-filled past the end; each thread copies one float4 column of every
// (threads / (dh / 4))-th row from one base address, or, where dh / 4 does
// not divide the threads (dh 80, 112, 320), the tile's float4 slots tid +
// threads * i in row-major order) in a staggered order
// with single buffers and two barriers a tile. V(t) is in flight while the
// block computes S = Q K(t)^T and the softmax; K(t + 1) is in flight while
// it computes P V(t). Key tiles that lie wholly inside every mask skip the
// mask arithmetic.
//
// The kernel reads the public (B, S, H, dh) layout through strides (last
// dim contiguous, 16-byte aligned) and writes a contiguous (B, Sq, H, dh)
// output. The heaviest causal query tiles launch first. Row offsets are
// 64-bit.
//
// Numerics against the plain version (ref.flash_attention_plain): the same
// masks and the same float32 scale, precise expf, explicit fmaf for the
// dot products in dh order and for P V in key order (the build passes
// -fmad=false, which only stops the compiler contracting separate
// multiplies and adds), IEEE division at the end. Sums run in another order
// than a float32 matrix product, so results agree within a tolerance, not
// bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kScores = 32;  // scores of a tile a thread owns (ops.SCORES_PER_THREAD)
constexpr int kScoresWide = 16;  // ... at dh >= 256 (ops.SCORES_PER_THREAD_WIDE)

template <int DH>
__host__ __device__ constexpr int scores_of() { return DH >= 256 ? kScoresWide : kScores; }

// 16 lanes tx across key / output columns, threads / 16 rows ty.
template <int BQ, int BK, int DH>
__host__ __device__ constexpr int threads_of() { return BQ * BK / scores_of<DH>(); }

struct Args {
  int sq, skv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int32_t heads, group, causal, window;
  float scale;
};

// Q, K (rows padded by one float4), V and P tiles.
template <int BQ, int BK, int DH>
__host__ __device__ constexpr size_t smem_bytes() {
  return ((BQ + 2 * BK) * DH + BQ * BK) * sizeof(float) + BK * sizeof(float4);
}

// Two blocks an SM where the 64 x 64 tile's shared memory allows it.
template <int BQ, int BK, int DH>
__host__ __device__ constexpr int min_blocks() {
  return BQ * BK <= 64 * 64 && 2 * smem_bytes<BQ, BK, DH>() <= 232448 ? 2 : 1;
}

// Whether each thread copies one float4 column of whole rows (every
// (threads / (dh / 4))-th row, all of one parity); else the tile's float4
// slots are copied in row-major order.
template <int NT, int D4, int BQ, int BK>
__host__ __device__ constexpr bool row_copy() {
  return NT % D4 == 0 && BQ % (NT / D4) == 0 && BK % (NT / D4) == 0 && (NT / D4) % 2 == 0;
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int BQ, int BK, int DH>
__global__ void __launch_bounds__(threads_of<BQ, BK, DH>(), min_blocks<BQ, BK, DH>())
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, const Args a) {
  constexpr int D4 = DH / 4;                  // float4 slots per row
  constexpr int OG = (D4 + 15) / 16;          // output float4 slots per thread: tx + 16 g
  constexpr int NT = threads_of<BQ, BK, DH>(), TY = NT / 16;
  constexpr bool ROW_COPY = row_copy<NT, D4, BQ, BK>();
  static_assert(DH % 16 == 0 && TY % 2 == 0 && BK % 64 == 0,
                "even float4 slots a row, rows of one parity a thread, P slots swizzled by 4");
  constexpr int RQ = BQ / TY, RK = BK / 16;   // S rows and keys per thread
  constexpr int P4 = BK / 4;                  // float4 slots per row of P
  constexpr int KS = D4 + 1;                  // row stride of K, float4
  extern __shared__ float4 smem[];
  float4* s_q = smem;                 // [BQ][D4], slot ^ 1 on odd rows
  float4* s_k = s_q + BQ * D4;        // [BK][KS]
  float4* s_v = s_k + BK * KS;        // [BK][D4]
  float* s_p = reinterpret_cast<float*>(s_v + BK * D4);  // [BQ][BK], slot ^ 4 on odd rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int kvh = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const float* qb = q + b * a.q_sb + h * a.q_sh;
  const float* kb = k + b * a.k_sb + kvh * a.k_sh;
  const float* vb = v + b * a.v_sb + kvh * a.v_sh;

  // Thread tid copies float4 slot tid % D4 of rows tid / D4 + ROWS i (ROWS
  // is even, so those rows share a parity); without ROW_COPY, slots tid +
  // NT i of the tile in row-major order.
  constexpr int ROWS = ROW_COPY ? NT / D4 : 1;
  const int c0 = tid / D4, d4 = tid % D4;
  auto load_q = [&]() {
    if constexpr (ROW_COPY) {
      const float* src = qb + (q0 + c0) * a.q_ss + 4 * d4;
      float4* d = s_q + c0 * D4 + (d4 ^ (c0 & 1));
#pragma unroll
      for (int i = 0; i < BQ / ROWS; ++i) {
        const bool in = q0 + c0 + ROWS * i < a.sq;
        cp_async16(d + ROWS * i * D4, in ? src + ROWS * i * a.q_ss : q, in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < (BQ * D4 + NT - 1) / NT; ++i) {
        const int e = tid + NT * i, r = e / D4, c = e - r * D4;
        const bool in = q0 + r < a.sq;
        if ((BQ * D4) % NT == 0 || e < BQ * D4)
          cp_async16(s_q + r * D4 + (c ^ (r & 1)), in ? qb + (q0 + r) * a.q_ss + 4 * c : q,
                     in ? 16 : 0);
      }
    }
  };
  auto load_kv = [&](float4* dst, int row_stride, const float* base, int64_t stride, int k0) {
    const bool full = k0 + BK <= a.skv;
    if constexpr (ROW_COPY) {
      const float* src = base + (k0 + c0) * stride + 4 * d4;
      float4* d = dst + c0 * row_stride + d4;
#pragma unroll
      for (int i = 0; i < BK / ROWS; ++i) {
        const bool in = full || k0 + c0 + ROWS * i < a.skv;
        cp_async16(d + ROWS * i * row_stride, in ? src + ROWS * i * stride : base, in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < (BK * D4 + NT - 1) / NT; ++i) {
        const int e = tid + NT * i, r = e / D4, c = e - r * D4;
        const bool in = full || k0 + r < a.skv;
        if ((BK * D4) % NT == 0 || e < BK * D4)
          cp_async16(dst + r * row_stride + c, in ? base + (k0 + r) * stride + 4 * c : base,
                     in ? 16 : 0);
      }
    }
  };
  // Shared-memory bases of this thread's fragments; every offset added to
  // them below is a compile-time constant. Q's slot d4 of row r is at
  // d4 ^ (r & 1): d4 + 1 on odd rows for even d4, d4 - 1 for odd d4 (rows
  // ty + TY i share ty's parity). P's slot c4 likewise at c4 ^ 4 on odd rows.
  const int par = ty & 1;
  const float4* q_even = s_q + ty * D4 + par;
  const float4* q_odd = s_q + ty * D4 - par;
  const float4* k_row = s_k + tx * KS;
  // Lanes past a row's slots mirror lanes tx - D4 where D4 is a power of
  // two under 16 (dh 32); at dh 80 slot tx + 16 of lanes tx >= 4 runs on
  // into the next row (never written).
  const float4* v_col = s_v + ((D4 & (D4 - 1)) == 0 ? (tx & (D4 - 1)) : tx);
  float* p_st_even = s_p + ty * BK + tx + 16 * par;  // P[r][tx + 16 j] at j ^ par
  float* p_st_odd = s_p + ty * BK + tx - 16 * par;
  const float4* p_lo = reinterpret_cast<const float4*>(s_p) + ty * P4 + 4 * par;
  const float4* p_hi = reinterpret_cast<const float4*>(s_p) + ty * P4 - 4 * par;

  // Key tiles this query tile can see.
  const int q_last = min(q0 + BQ, a.sq) - 1;
  int kv_lo = 0, kv_hi = a.skv;
  if (a.causal && q_last + 1 < kv_hi) kv_hi = q_last + 1;
  if (a.window > 0 && q0 - a.window + 1 > 0) kv_lo = q0 - a.window + 1;
  const int t_lo = kv_lo / BK, t_hi = (kv_hi + BK - 1) / BK;

  float m[RQ], l[RQ], acc[RQ][OG][4];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < OG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  load_q();
  if (t_lo < t_hi) load_kv(s_k, KS, kb, a.k_ss, t_lo * BK);
  cp_async_commit();

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    cp_async_wait_all();  // this thread's Q and K(t) copies have landed
    __syncthreads();      // everyone's have; everyone is done with P and V(t - 1)
    load_kv(s_v, D4, vb, a.v_ss, k0);  // V(t): in flight during S and the softmax
    cp_async_commit();

    // S = Q K^T over this tile: rows ty + TY i, columns tx + 16 j.
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D4; d0 += 2) {
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d4 = d0 + dd;
        float4 qa[RQ], ka[RK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) qa[i] = ((dd & 1) ? q_odd : q_even)[TY * i * D4 + d4];
#pragma unroll
        for (int j = 0; j < RK; ++j) ka[j] = k_row[16 * j * KS + d4];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            float x = s[i][j];
            x = fmaf(qa[i].x, ka[j].x, x);
            x = fmaf(qa[i].y, ka[j].y, x);
            x = fmaf(qa[i].z, ka[j].z, x);
            x = fmaf(qa[i].w, ka[j].w, x);
            s[i][j] = x;
          }
      }
    }

    // Mask (unless every pair of the tile is visible), online softmax, P
    // into shared memory: every row's steps side by side, so the shuffle
    // chains and the exponentials of the RQ rows overlap.
    const bool visible = k0 + BK <= a.skv && q0 + BQ <= a.sq &&
                         (!a.causal || k0 + BK - 1 <= q0) &&
                         (a.window <= 0 || q0 + BQ - 1 - k0 < a.window);
    float mx[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty + TY * i;
      mx[i] = kNegInf;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = true;
        if (!visible) {
          ok = qp < a.sq && kp < a.skv;
          if (a.causal) ok = ok && qp >= kp;
          if (a.window > 0) ok = ok && qp - kp < a.window;
        }
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx[i] = fmaxf(mx[i], s[i][j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int i = 0; i < RQ; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        // expf(s - m_new) is 0 for a masked s unless the whole row is masked
        // so far (m_new is the mask value too): the factor keeps p at 0 there
        // without a branch around expf.
        const float p = expf(s[i][j] - m_new) * (s[i][j] > 0.5f * kNegInf ? 1.f : 0.f);
        ps += p;
        ((j & 1) ? p_st_odd : p_st_even)[TY * i * BK + 16 * j] = p;
      }
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < OG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    cp_async_wait_all();  // this thread's V(t) copies have landed
    __syncthreads();      // everyone's have, P is written, everyone is done with K(t)
    if (t + 1 < t_hi) {
      load_kv(s_k, KS, kb, a.k_ss, k0 + BK);  // K(t + 1): in flight during P V
      cp_async_commit();
    }

    // acc += P V: rows ty + TY i, output float4 slots tx + 16 g.
#pragma unroll 4
    for (int c4 = 0; c4 < P4; ++c4) {
      const float4* p_c = (c4 & 4) ? p_hi : p_lo;
      float4 pa[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pa[i] = p_c[TY * i * P4 + c4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = 4 * c4 + cc;
        float4 va[OG];
#pragma unroll
        for (int g = 0; g < OG; ++g) va[g] = v_col[c * D4 + 16 * g];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
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
  cp_async_wait_all();  // a block that saw no key tile still has Q in flight

  // out = acc / max(l, 1e-30): l is the sum of the 16 lanes' partial sums.
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float den = fmaxf(lt, 1e-30f);
    const int qp = q0 + ty + TY * i;
    if (qp < a.sq && tx < D4) {
      float* o = out + ((static_cast<int64_t>(b) * a.sq + qp) * a.heads + h) * DH;
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        if (D4 % 16 == 0 || tx + 16 * g < D4)
          *reinterpret_cast<float4*>(o + 4 * (tx + 16 * g)) =
              make_float4(acc[i][g][0] / den, acc[i][g][1] / den, acc[i][g][2] / den,
                          acc[i][g][3] / den);
      }
    }
  }
}

template <int BQ, int BK, int DH>
int launch(const float* q, const float* k, const float* v, float* out, int64_t batch,
           const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BQ, BK, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<BQ, BK, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_kernel<BQ, BK, DH>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_q_tiles = (a.sq + BQ - 1) / BQ;
  const int64_t n_heads = batch * a.heads;
  if (n_q_tiles > 65535 || n_heads > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(n_heads), static_cast<unsigned int>(n_q_tiles));
  fa_kernel<BQ, BK, DH><<<grid, threads_of<BQ, BK, DH>(), smem, stream>>>(q, k, v, out, a);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int BK, int DH>
int attributes(int32_t* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, fa_kernel<BQ, BK, DH>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<int32_t>(fa.sharedSizeBytes + smem_bytes<BQ, BK, DH>());
  out[2] = fa.maxThreadsPerBlock;
  out[3] = static_cast<int32_t>(fa.localSizeBytes);
  out[4] = threads_of<BQ, BK, DH>();
  return 0;
}

// The instantiated (bq, bk, head width) triples: kernels/flash_attention/
// kernel.TILES_BY_DH, every tile whose shared memory fits a block.
#define FA_INSTANCES(X)                                                                  \
  X(64, 64, 16) X(64, 64, 32) X(64, 64, 64) X(64, 64, 80) X(64, 64, 112) X(64, 64, 128)       \
  X(128, 64, 16) X(128, 64, 32) X(128, 64, 64) X(128, 64, 80) X(128, 64, 112)                 \
  X(128, 64, 128)                                                                              \
  X(64, 128, 16) X(64, 128, 32) X(64, 128, 64) X(64, 128, 80) X(64, 128, 112)                 \
  X(64, 128, 128)                                                                              \
  X(64, 64, 256) X(32, 64, 320)

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (B, Sq, H, dh), k and v: (B, Skv, Hk, dh) float32 device tensors given
// by their element strides over (batch, position, head), the head dim
// contiguous and every row 16-byte aligned (the wrapper checks); out is a
// contiguous (B, Sq, H, dh) float32 tensor. (bq, bk, head_dim) must be
// instantiated (FA_INSTANCES), Sq and Skv < 2^31.
int flash_attention_launch(int32_t bq, int32_t bk, const float* q, const float* k,
                           const float* v, float* out, int64_t batch, int64_t sq, int64_t skv,
                           int32_t heads, int32_t kv_heads, int32_t head_dim, int64_t q_sb,
                           int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                           int32_t causal, int32_t window, float scale, cudaStream_t stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sq > INT32_MAX - 256 || skv > INT32_MAX - 256) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0 || heads == 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<int>(sq), static_cast<int>(skv), q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, heads, heads / kv_heads, causal, window, scale};
#define FA_LAUNCH(BQ, BK, DH) \
  if (bq == BQ && bk == BK && head_dim == DH) return launch<BQ, BK, DH>(q, k, v, out, batch, a, stream);
  FA_INSTANCES(FA_LAUNCH)
#undef FA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaFuncGetAttributes of the (bq, bk, head_dim) instantiation: registers a
// thread, shared memory a block (static plus the dynamic amount the launcher
// requests), max threads a block, local (spill) bytes, threads.
int flash_attention_attributes(int32_t bq, int32_t bk, int32_t head_dim, int32_t* out) {
#define FA_ATTR(BQ, BK, DH) \
  if (bq == BQ && bk == BK && head_dim == DH) return attributes<BQ, BK, DH>(out);
  FA_INSTANCES(FA_ATTR)
#undef FA_ATTR
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
