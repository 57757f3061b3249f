// Copyright 2026. Licensed under the Apache License, Version 2.0.
//
// Flash attention for Hopper (sm_90a): the forward, and the two kernels of
// the FlashAttention-2 backward.
//
// Replaces the Pallas kernels of bluefog_tpu/ops/flash.py:
//   bf_flash_fwd      <- _fwd_call      (_fwd_kernel; pallas_call at :169)
//   bf_flash_bwd_dkv  <- _bwd_call      (_bwd_dkv_kernel with _recompute_p;
//                                        pallas_call at :343)
//   bf_flash_bwd_dq   <- _bwd_call      (_bwd_dq_kernel; pallas_call at :369)
//
// Layout: q [b, t, h, d], k and v [b, t, h_kv, d] with h % h_kv == 0 (grouped
// query attention: query head i reads KV head i / (h / h_kv)), each with its
// own batch, sequence and head strides in elements and a contiguous last
// axis, so the views of a fused qkv projection need no copy. Outputs are
// contiguous: out and dq [b, t, h, d], dk and dv [b, t, h_kv, d], and the
// per-row logsumexp lse [b, h, t] f32. delta = rowsum(dO * O) and the lse
// cotangent dlse (null: zero) are [b, h, t] f32 inputs of the backward.
//
// What is computed is the Pallas kernels' arithmetic: scores in f32 times
// scale; key positions past the query (causal) or past t masked to -inf; the
// online softmax with f32 m, l and accumulator and the isfinite guards, so a
// row with no valid key gives out = 0 and lse = -inf; P rounded to V's type
// before P.V; in the backward P recomputed from Q, K and lse, dS = P * ((dP -
// delta) + dlse) * scale, P rounded to dO's type before P^T.dO and dS to Q's
// (K's) type before dS^T.Q (dS.K). No padding copy exists: a ragged tail is
// zero-filled in shared memory and masked.
//
// Two routes here (ops/flash.py::_route chooses; the bf16 calls whose rows
// TMA can address take flash_sm90.cu instead):
// - bf16 q/k/v with a bf16 cotangent: tensor cores through mma.sync.m16n8k16
//   (bf16 operands, f32 accumulation), operands brought from shared memory by
//   ldmatrix, tiles staged by cp.async (or scalar loads where rows are off 16
//   bytes) in two stages so the next tile loads while this one computes. Four
//   warps, 16 rows each. head_dim is zero-padded in shared memory to DP = 64,
//   128 or 256. At DP = 256 a block accumulates one 128-column half of its
//   output (blockIdx.z picks the half; the scores are computed over the
//   whole head_dim in both halves), so the accumulators keep to 64 registers
//   a thread, and dQ reads its A operands from shared memory. This is the
//   route of rows off 16 bytes, head_dim not a multiple of 8, above 128 or a
//   scale that is not positive, for all three kernels.
// - f32 q/k/v, or an f32 cotangent beside bf16 q/k/v (flash_attention_with_lse
//   returns f32 out, so its cotangent is f32): CUDA cores, all arithmetic in
//   f32, with the same roundings emulated (P stays f32 when dO is f32, dS is
//   rounded to bf16 when Q is bf16), so nothing rounds dO to bf16. head_dim
//   is zero-padded in shared memory to SD = 64, 128 or 256.
//
// Bound: operations. At the training shape (b 2, h 16, t 4096, d 64, causal)
// the forward does 2 products over the lower triangle, 68.7 GFLOP, 0.069 ms
// at 989 TFLOP/s (bf16 dense); dK/dV 4 products, 0.139 ms; dQ 3 products,
// 0.104 ms. Their bytes (q, k, v, dO, outputs: about 67 MB) take 0.02 ms at
// 3.35 TB/s. The design keeps the T x T matrices out of device memory
// entirely (scores and probabilities live in registers, one 16-row strip per
// warp), feeds the tensor cores from shared memory with ldmatrix, skips the
// K tiles above the causal diagonal (the loop bound, not a mask) and runs the
// heaviest causal tiles first. flash_sm90.cu redesigns all three with
// wgmma, TMA and warp specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_args.cuh"

// Dynamic shared memory of the tensor-core kernels.
extern __shared__ __align__(16) unsigned char flash_smem[];

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps
constexpr int kBM = 64;        // query rows per block, 16 per warp

// ---- Hopper instructions (inline PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b for one 16 x 8 x 16 tile (bf16 operands, f32 accumulators).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- end of inline PTX ----

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the rounding a product in T's type applies.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// A recomputed probability: exp(s - lse) with the guards of _recompute_p
// (s is already scaled and masked to -inf).
__device__ __forceinline__ float recompute_p(float s, float lse) {
  const bool finite = isfinite(lse);
  const float p = expf(s - (finite ? lse : 0.0f));
  return (finite && isfinite(s)) ? p : 0.0f;
}

// Rows row0 .. row0 + ROWS - 1 of a [t, d] bf16 matrix (row stride `stride`)
// into shared memory rows of DP + 8 elements, zero past t and past d.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long stride, int row0, int t,
                                          int d, bool vec) {
  constexpr int kRow = DP + 8;
  if (vec) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks per row
    for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int row = row0 + r;
      const bool ok = row < t && col < d;
      cp_async_16(s + r * kRow + col, ok ? g + row * stride + col : g,
                  ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += kThreads) {
      const int r = e / DP;
      const int col = e % DP;
      const int row = row0 + r;
      s[r * kRow + col] = (row < t && col < d) ? g[row * stride + col]
                                               : __float2bfloat16_rn(0.0f);
    }
  }
}

// The A operand (16 rows x 16 columns at column k0) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int row_stride, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, s + (lane & 15) * row_stride + k0 + (lane >> 4) * 8);
}

// B operands of two 8-column blocks for C[m][n] += A[m][k] . X[n][k] (X
// row-major with rows n0 .. n0 + 15, depth k0 .. k0 + 15): b[0..1] serve
// rows n0 .. n0 + 7, b[2..3] rows n0 + 8 .. n0 + 15.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* s,
                                            int row_stride, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * row_stride + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B operands of two 8-column blocks for C[m][n] += A[m][k] . X[k][n] (X
// row-major with rows k0 .. k0 + 15, columns n0 .. n0 + 15): b[0..1] serve
// columns n0 .. n0 + 7, b[2..3] columns n0 + 8 .. n0 + 15.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* s,
                                            int row_stride, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * row_stride +
                           n0 + (lane >> 4) * 8);
}

// acc[NB][4] (16 x 8*NB) += a-strip (16 x 16*KB) . X^T for X's rows n, where
// the a-strip's fragments are given.
template <int NB, int KB>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4],
                                         const uint32_t (&a)[KB][4],
                                         const bf16* x, int row_stride) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      load_b_rows(b, x, row_stride, nb * 16, kk * 16);
      mma_bf16(acc[2 * nb], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a[kk], b[2], b[3]);
    }
  }
}

// mma_rows with the a-strip read from shared memory (16 rows of a row-major
// tile, row stride a_stride) at each depth step: registers for the head_dims
// whose fragments would not fit beside the accumulators.
template <int NB, int KB>
__device__ __forceinline__ void mma_rows_smem(float (&acc)[NB][4], const bf16* sa,
                                              int a_stride, const bf16* x,
                                              int row_stride) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    uint32_t a[4];
    load_a(a, sa, a_stride, kk * 16);
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      load_b_rows(b, x, row_stride, nb * 16, kk * 16);
      mma_bf16(acc[2 * nb], a, b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// acc[NB][4] (16 x 8*NB) += P (16 x 8*KB8, given as f32 accumulator blocks,
// rounded to bf16 here) . X (X row-major, KB8*8 rows, 8*NB columns).
template <int NB, int KB8>
__device__ __forceinline__ void mma_cols(float (&acc)[NB][4],
                                         const float (&p)[KB8][4],
                                         const bf16* x, int row_stride) {
#pragma unroll
  for (int kk = 0; kk < KB8 / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      load_b_cols(b, x, row_stride, kk * 16, nb * 16);
      mma_bf16(acc[2 * nb], a, b[0], b[1]);
      mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }
}

// Number of K tiles of width bn that query rows [q0, q0 + bm) attend to.
__device__ __forceinline__ int key_tiles(const BfFlashArgs& a, int q0, int bm,
                                         int bn) {
  const int all = (a.t + bn - 1) / bn;
  return a.causal ? min(all, (q0 + bm + bn - 1) / bn) : all;
}

// Stores element (row, col) of a 16-row strip's accumulator blocks, divided
// by div[r], into a contiguous [rows, ld] matrix.
template <typename T, int NB>
__device__ __forceinline__ void store_strip(T* dst, long long ld,
                                            const float (&acc)[NB][4],
                                            int row0, int t, int d,
                                            const float (&div)[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int row = row0 + g + 8 * r;
      const int col = nb * 8 + 2 * tg + (e & 1);
      if (row < t && col < d) {
        dst[row * ld + col] = from_f32<T>(acc[nb][e] / div[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16).
// ---------------------------------------------------------------------------

// Output columns a block accumulates: all of DP up to 128, one half at 256.
template <int DP>
__host__ __device__ constexpr int out_cols() {
  return DP > 128 ? 128 : DP;
}

template <int DP>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (kBM + 4 * 64) * (DP + 8) * 2;
}

// B6: one block per (Q tile, b*h, column half); K and V tiles of 64 keys in
// two stages.
template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma(const BfFlashArgs a) {
  constexpr int BN = 64, kRow = DP + 8, KB = DP / 16, DC = out_cols<DP>();
  const int c0 = blockIdx.z * DC;  // this block's output columns
  bf16* sQ = reinterpret_cast<bf16*>(flash_smem);
  bf16* sK = sQ + kBM * kRow;     // [2][BN][kRow]
  bf16* sV = sK + 2 * BN * kRow;  // [2][BN][kRow]

  const int n_qt = (a.t + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBM;  // heaviest tiles first
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.h_kv);
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_stride[0] +
                  hi * a.q_stride[2];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_stride[0] +
                  hk * a.k_stride[2];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_stride[0] +
                  hk * a.v_stride[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n_kt = key_tiles(a, q0, kBM, BN);
  const bool vec = a.vec != 0;

  load_tile<kBM, DP>(sQ, q, a.q_stride[1], q0, a.t, a.d, vec);
  load_tile<BN, DP>(sK, k, a.k_stride[1], 0, a.t, a.d, vec);
  load_tile<BN, DP>(sV, v, a.v_stride[1], 0, a.t, a.d, vec);
  cp_async_commit();

  uint32_t qf[KB][4];
  float acc[DC / 8][4];
  zero(acc);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<BN, DP>(sK + (st ^ 1) * BN * kRow, k, a.k_stride[1],
                        (kt + 1) * BN, a.t, a.d, vec);
      load_tile<BN, DP>(sV + (st ^ 1) * BN * kRow, v, a.v_stride[1],
                        (kt + 1) * BN, a.t, a.d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        load_a(qf[kk], sQ + warp * 16 * kRow, kRow, kk * 16);
      }
    }
    const bf16* sk = sK + st * BN * kRow;
    const bf16* sv = sV + st * BN * kRow;

    float s[BN / 8][4];
    zero(s);
    mma_rows(s, qf, sk, kRow);

    const int k0 = kt * BN;
    const int row_base = q0 + warp * 16 + g;
    const bool masked =
        (a.causal && k0 + BN - 1 > q0) || (k0 + BN > a.t);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[nb][e] * a.scale;
        if (masked) {
          const int row = row_base + 8 * r;
          const int col = k0 + nb * 8 + 2 * tg + (e & 1);
          if ((a.causal && col > row) || col >= a.t) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      m_safe[r] = isfinite(m_new) ? m_new : 0.0f;
      corr[r] = isfinite(m_run[r]) ? expf(m_run[r] - m_safe[r]) : 0.0f;
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = s[nb][e];
        const float p = isfinite(x) ? expf(x - m_safe[r]) : 0.0f;
        s[nb][e] = p;
        l_run[r] += p;
      }
    }
#pragma unroll
    for (int nb = 0; nb < DC / 8; ++nb) {
      acc[nb][0] *= corr[0];
      acc[nb][1] *= corr[0];
      acc[nb][2] *= corr[1];
      acc[nb][3] *= corr[1];
    }
    mma_cols(acc, s, sv + c0, kRow);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    l_safe[r] = l > 0.0f ? l : 1.0f;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (tg == 0 && row < a.t && blockIdx.z == 0) {
      a.lse[(long long)blockIdx.y * a.t + row] =
          l > 0.0f ? m_run[r] + logf(l_safe[r]) : -INFINITY;
    }
  }
  OutT* out = static_cast<OutT*>(a.out) +
              ((long long)bi * a.t * a.h + hi) * a.d + c0;
  store_strip<OutT>(out, (long long)a.h * a.d, acc, q0 + warp * 16, a.t,
                    a.d - c0, l_safe);
}

template <int DP>
__host__ __device__ constexpr int dq_bn() {
  return DP >= 128 ? 32 : 64;
}

template <int DP>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 * kBM + 4 * dq_bn<DP>()) * (DP + 8) * 2;
}

// B8: one block per (Q tile, b*h, column half), looping over K tiles up to
// the diagonal. Q and dO fragments stay in registers up to DP 128; at 256
// they are read from shared memory at each product.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma(const BfFlashArgs a) {
  constexpr int BN = dq_bn<DP>(), kRow = DP + 8, KB = DP / 16, DC = out_cols<DP>();
  constexpr bool kFragsInRegs = DP <= 128;
  const int c0 = blockIdx.z * DC;  // this block's dQ columns
  bf16* sQ = reinterpret_cast<bf16*>(flash_smem);
  bf16* sO = sQ + kBM * kRow;     // dO
  bf16* sK = sO + kBM * kRow;     // [2][BN][kRow]
  bf16* sV = sK + 2 * BN * kRow;  // [2][BN][kRow]

  const int n_qt = (a.t + kBM - 1) / kBM;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBM;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.h_kv);
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_stride[0] +
                  hi * a.q_stride[2];
  const bf16* dout = static_cast<const bf16*>(a.d_o) + bi * a.do_stride[0] +
                     hi * a.do_stride[2];
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_stride[0] +
                  hk * a.k_stride[2];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_stride[0] +
                  hk * a.v_stride[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n_kt = key_tiles(a, q0, kBM, BN);
  const bool vec = a.vec != 0;

  load_tile<kBM, DP>(sQ, q, a.q_stride[1], q0, a.t, a.d, vec);
  load_tile<kBM, DP>(sO, dout, a.do_stride[1], q0, a.t, a.d, vec);
  load_tile<BN, DP>(sK, k, a.k_stride[1], 0, a.t, a.d, vec);
  load_tile<BN, DP>(sV, v, a.v_stride[1], 0, a.t, a.d, vec);
  cp_async_commit();

  // per-row lse, delta and dlse of this thread's two rows
  float lse_r[2], delta_r[2], dlse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const long long i = (long long)blockIdx.y * a.t + row;
    const bool ok = row < a.t;
    lse_r[r] = ok ? a.lse[i] : -INFINITY;
    delta_r[r] = ok ? a.delta[i] : 0.0f;
    dlse_r[r] = (ok && a.dlse != nullptr) ? a.dlse[i] : 0.0f;
  }

  uint32_t qf[kFragsInRegs ? KB : 1][4], of[kFragsInRegs ? KB : 1][4];
  float dq[DC / 8][4];
  zero(dq);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {
      load_tile<BN, DP>(sK + (st ^ 1) * BN * kRow, k, a.k_stride[1],
                        (kt + 1) * BN, a.t, a.d, vec);
      load_tile<BN, DP>(sV + (st ^ 1) * BN * kRow, v, a.v_stride[1],
                        (kt + 1) * BN, a.t, a.d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = sK + st * BN * kRow;
    const bf16* sv = sV + st * BN * kRow;
    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    if constexpr (kFragsInRegs) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < KB; ++kk) {
          load_a(qf[kk], sQ + warp * 16 * kRow, kRow, kk * 16);
          load_a(of[kk], sO + warp * 16 * kRow, kRow, kk * 16);
        }
      }
      mma_rows(s, qf, sk, kRow);
      mma_rows(dp, of, sv, kRow);
    } else {
      mma_rows_smem<BN / 8, KB>(s, sQ + warp * 16 * kRow, kRow, sk, kRow);
      mma_rows_smem<BN / 8, KB>(dp, sO + warp * 16 * kRow, kRow, sv, kRow);
    }

    const int k0 = kt * BN;
    const int row_base = q0 + warp * 16 + g;
    const bool masked = (a.causal && k0 + BN - 1 > q0) || (k0 + BN > a.t);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[nb][e] * a.scale;
        if (masked) {
          const int row = row_base + 8 * r;
          const int col = k0 + nb * 8 + 2 * tg + (e & 1);
          if ((a.causal && col > row) || col >= a.t) x = -INFINITY;
        }
        const float p = recompute_p(x, lse_r[r]);
        s[nb][e] = p * ((dp[nb][e] - delta_r[r]) + dlse_r[r]) * a.scale;
      }
    }
    mma_cols(dq, s, sk + c0, kRow);  // dS (rounded to K's type) . K
    __syncthreads();
  }

  const float one[2] = {1.0f, 1.0f};
  bf16* dst = static_cast<bf16*>(a.dq) + ((long long)bi * a.t * a.h + hi) * a.d + c0;
  store_strip<bf16>(dst, (long long)a.h * a.d, dq, q0 + warp * 16, a.t,
                    a.d - c0, one);
}

template <int DP>
__host__ __device__ constexpr int dkv_bm() {
  return DP >= 128 ? 32 : 64;
}

template <int DP>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return (2 * 64 + 4 * dkv_bm<DP>()) * (DP + 8) * 2 +
         2 * 3 * dkv_bm<DP>() * 4;
}

// B7: one block per (K tile of 64 keys, b*h_kv, column half); each warp owns
// 16 keys and walks every query head of the group and every Q tile that
// reaches its keys, accumulating dK and dV in f32 registers.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_mma(const BfFlashArgs a) {
  constexpr int BN = 64, BM = dkv_bm<DP>(), kRow = DP + 8, DC = out_cols<DP>();
  const int c0 = blockIdx.z * DC;  // this block's dK and dV columns
  bf16* sK = reinterpret_cast<bf16*>(flash_smem);
  bf16* sV = sK + BN * kRow;
  bf16* sQ = sV + BN * kRow;      // [2][BM][kRow]
  bf16* sO = sQ + 2 * BM * kRow;  // dO, [2][BM][kRow]
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * kRow);  // [2][BM] lse
  float* sD = sL + 2 * BM;                                   // [2][BM] delta
  float* sE = sD + 2 * BM;                                   // [2][BM] dlse

  const int k0 = blockIdx.x * BN;  // causal: the heaviest tiles come first
  const int bi = blockIdx.y / a.h_kv, hk = blockIdx.y % a.h_kv;
  const int group = a.h / a.h_kv;
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_stride[0] +
                  hk * a.k_stride[2];
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_stride[0] +
                  hk * a.v_stride[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const bool vec = a.vec != 0;

  const int n_qt = (a.t + BM - 1) / BM;
  const int qt0 = a.causal ? k0 / BM : 0;  // first Q tile that reaches k0
  const int per_head = n_qt - qt0;
  const int n_it = group * per_head;

  // Q tile `it` of the flattened (group member, Q tile) walk, into stage st
  auto load_q = [&](int it, int st) {
    const int hi = hk * group + it / per_head;
    const int r0 = (qt0 + it % per_head) * BM;
    const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_stride[0] +
                    hi * a.q_stride[2];
    const bf16* dout = static_cast<const bf16*>(a.d_o) + bi * a.do_stride[0] +
                       hi * a.do_stride[2];
    load_tile<BM, DP>(sQ + st * BM * kRow, q, a.q_stride[1], r0, a.t, a.d, vec);
    load_tile<BM, DP>(sO + st * BM * kRow, dout, a.do_stride[1], r0, a.t, a.d,
                      vec);
    const long long base = ((long long)bi * a.h + hi) * a.t;
    for (int r = threadIdx.x; r < BM; r += kThreads) {
      const int row = r0 + r;
      const bool ok = row < a.t;
      sL[st * BM + r] = ok ? a.lse[base + row] : -INFINITY;
      sD[st * BM + r] = ok ? a.delta[base + row] : 0.0f;
      sE[st * BM + r] = (ok && a.dlse != nullptr) ? a.dlse[base + row] : 0.0f;
    }
  };

  load_tile<BN, DP>(sK, k, a.k_stride[1], k0, a.t, a.d, vec);
  load_tile<BN, DP>(sV, v, a.v_stride[1], k0, a.t, a.d, vec);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float dk[DC / 8][4], dv[DC / 8][4];
  zero(dk);
  zero(dv);
  const bf16* wk = sK + warp * 16 * kRow;  // this warp's 16 keys
  const bf16* wv = sV + warp * 16 * kRow;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sq = sQ + st * BM * kRow;
    const bf16* so = sO + st * BM * kRow;
    const float* lse = sL + st * BM;
    const float* delta = sD + st * BM;
    const float* dlse = sE + st * BM;
    const int r0 = (qt0 + it % per_head) * BM;

    // S^T = K . Q^T and dP^T = V . dO^T for this warp's keys x BM queries
    float s[BM / 8][4], dp[BM / 8][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, wk, kRow, kk * 16);
      load_a(va, wv, kRow, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BM / 16; ++nb) {
        uint32_t b[4];
        load_b_rows(b, sq, kRow, nb * 16, kk * 16);
        mma_bf16(s[2 * nb], ka, b[0], b[1]);
        mma_bf16(s[2 * nb + 1], ka, b[2], b[3]);
        load_b_rows(b, so, kRow, nb * 16, kk * 16);
        mma_bf16(dp[2 * nb], va, b[0], b[1]);
        mma_bf16(dp[2 * nb + 1], va, b[2], b[3]);
      }
    }

    const int key_base = k0 + warp * 16 + g;
    const bool masked = (a.causal && k0 + BN - 1 > r0) || (k0 + BN > a.t);
#pragma unroll
    for (int nb = 0; nb < BM / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key_base + 8 * (e >> 1);
        const int qi = nb * 8 + 2 * tg + (e & 1);
        float x = s[nb][e] * a.scale;
        if (masked && ((a.causal && key > r0 + qi) || key >= a.t)) {
          x = -INFINITY;
        }
        const float p = recompute_p(x, lse[qi]);
        s[nb][e] = p;
        dp[nb][e] = p * ((dp[nb][e] - delta[qi]) + dlse[qi]) * a.scale;
      }
    }
    mma_cols(dv, s, so + c0, kRow);   // P^T (rounded to dO's type) . dO
    mma_cols(dk, dp, sq + c0, kRow);  // dS^T (rounded to Q's type) . Q
    __syncthreads();
  }

  const float one[2] = {1.0f, 1.0f};
  const long long off = ((long long)bi * a.t * a.h_kv + hk) * a.d + c0;
  const long long ld = (long long)a.h_kv * a.d;
  store_strip<bf16>(static_cast<bf16*>(a.dk) + off, ld, dk, k0 + warp * 16,
                    a.t, a.d - c0, one);
  store_strip<bf16>(static_cast<bf16*>(a.dv) + off, ld, dv, k0 + warp * 16,
                    a.t, a.d - c0, one);
}

// ---------------------------------------------------------------------------
// CUDA-core route (f32, or an f32 cotangent beside bf16 q/k/v). Tiles of 32
// keys and 8 query rows; head_dim zero-padded in shared memory to SD = 64,
// 128 or 256 (dynamic shared memory: 74-84 KB a block at 256).
// ---------------------------------------------------------------------------

constexpr int kSK = 32;         // keys per tile
constexpr int kSM = 8;          // query rows per block (or chunk)
constexpr int kRowsPerWarp = kSM / 4;

// Key rows are padded to SD + 1 floats: lane j reads row j conflict-free.
template <int SD>
__host__ __device__ constexpr int simt_fwd_smem_bytes() {
  return (kSM * SD + 2 * kSK * (SD + 1)) * 4;
}
template <int SD>
__host__ __device__ constexpr int simt_dq_smem_bytes() {
  return (2 * kSM * SD + 2 * kSK * (SD + 1)) * 4;
}
template <int SD>
__host__ __device__ constexpr int simt_dkv_smem_bytes() {
  return (2 * kSK * (SD + 1) + 2 * kSM * SD + 2 * kSM * kSK) * 4;
}

// rows [row0, row0 + rows) of a [t, d] matrix into f32 shared rows of `ld`,
// SD columns, zero past t and past d.
template <int SD, typename T>
__device__ __forceinline__ void load_rows_f32(float* s, int ld, const T* g,
                                              long long stride, int row0,
                                              int rows, int t, int d) {
  for (int e = threadIdx.x; e < rows * SD; e += kThreads) {
    const int r = e / SD, col = e % SD, row = row0 + r;
    s[r * ld + col] = (row < t && col < d) ? to_f32(g[row * stride + col]) : 0.0f;
  }
}

// B6 on CUDA cores (f32 q/k/v): one block per (8 query rows, b*h); each
// warp owns 2 rows; lane j scores key j of the tile, then each lane owns
// columns lane + 32c of the accumulator.
template <int SD>
__global__ void __launch_bounds__(kThreads) flash_fwd_simt(const BfFlashArgs a) {
  constexpr int kSRow = SD + 1, kC = SD / 32;
  float* sQ = reinterpret_cast<float*>(flash_smem);  // [kSM][SD]
  float* sK = sQ + kSM * SD;                          // [kSK][kSRow]
  float* sV = sK + kSK * kSRow;                       // [kSK][kSRow]
  const int n_qt = (a.t + kSM - 1) / kSM;
  const int q0 = (n_qt - 1 - blockIdx.x) * kSM;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.h_kv);
  const float* q = static_cast<const float*>(a.q) + bi * a.q_stride[0] +
                   hi * a.q_stride[2];
  const float* k = static_cast<const float*>(a.k) + bi * a.k_stride[0] +
                   hk * a.k_stride[2];
  const float* v = static_cast<const float*>(a.v) + bi * a.v_stride[0] +
                   hk * a.v_stride[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_kt = key_tiles(a, q0, kSM, kSK);
  load_rows_f32<SD>(sQ, SD, q, a.q_stride[1], q0, kSM, a.t, a.d);

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][kC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[rr][c] = 0.0f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kSK;
    __syncthreads();
    load_rows_f32<SD>(sK, kSRow, k, a.k_stride[1], k0, kSK, a.t, a.d);
    load_rows_f32<SD>(sV, kSRow, v, a.v_stride[1], k0, kSK, a.t, a.d);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, row = q0 + r, key = k0 + lane;
      float x = 0.0f;
      for (int c = 0; c < a.d; ++c) x += sQ[r * SD + c] * sK[lane * kSRow + c];
      x *= a.scale;
      if ((a.causal && key > row) || key >= a.t) x = -INFINITY;
      const float m_new = fmaxf(m_run[rr], warp_max(x));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float corr = isfinite(m_run[rr]) ? expf(m_run[rr] - m_safe) : 0.0f;
      const float p = isfinite(x) ? expf(x - m_safe) : 0.0f;
      l_run[rr] = l_run[rr] * corr + warp_sum(p);
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[rr][c] *= corr;
      for (int j = 0; j < kSK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[rr][c] += pj * sV[j * kSRow + lane + 32 * c];
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= a.t) continue;
    const float l = l_run[rr];
    const float l_safe = l > 0.0f ? l : 1.0f;
    if (lane == 0) {
      a.lse[(long long)blockIdx.y * a.t + row] =
          l > 0.0f ? m_run[rr] + logf(l_safe) : -INFINITY;
    }
    const long long base = (((long long)bi * a.t + row) * a.h + hi) * a.d;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = lane + 32 * c;
      if (col >= a.d) continue;
      static_cast<float*>(a.out)[base + col] = acc[rr][c] / l_safe;
    }
  }
}

// B8 on CUDA cores: one block per (8 query rows, b*h), warp per 2 rows,
// lane j on key j of the tile for S and dP, then lane on columns for dQ.
template <int SD, typename InT, typename DoT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_simt(const BfFlashArgs a) {
  constexpr int kSRow = SD + 1, kC = SD / 32;
  float* sQ = reinterpret_cast<float*>(flash_smem);  // [kSM][SD]
  float* sO = sQ + kSM * SD;                          // [kSM][SD]
  float* sK = sO + kSM * SD;                          // [kSK][kSRow]
  float* sV = sK + kSK * kSRow;                       // [kSK][kSRow]
  const int n_qt = (a.t + kSM - 1) / kSM;
  const int q0 = (n_qt - 1 - blockIdx.x) * kSM;
  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int hk = hi / (a.h / a.h_kv);
  const InT* q = static_cast<const InT*>(a.q) + bi * a.q_stride[0] + hi * a.q_stride[2];
  const DoT* dout = static_cast<const DoT*>(a.d_o) + bi * a.do_stride[0] +
                    hi * a.do_stride[2];
  const InT* k = static_cast<const InT*>(a.k) + bi * a.k_stride[0] + hk * a.k_stride[2];
  const InT* v = static_cast<const InT*>(a.v) + bi * a.v_stride[0] + hk * a.v_stride[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_kt = key_tiles(a, q0, kSM, kSK);
  load_rows_f32<SD>(sQ, SD, q, a.q_stride[1], q0, kSM, a.t, a.d);
  load_rows_f32<SD>(sO, SD, dout, a.do_stride[1], q0, kSM, a.t, a.d);

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], dlse_r[kRowsPerWarp],
      dq[kRowsPerWarp][kC];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    const long long i = (long long)blockIdx.y * a.t + row;
    const bool ok = row < a.t;
    lse_r[rr] = ok ? a.lse[i] : -INFINITY;
    delta_r[rr] = ok ? a.delta[i] : 0.0f;
    dlse_r[rr] = (ok && a.dlse != nullptr) ? a.dlse[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < kC; ++c) dq[rr][c] = 0.0f;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kSK;
    __syncthreads();
    load_rows_f32<SD>(sK, kSRow, k, a.k_stride[1], k0, kSK, a.t, a.d);
    load_rows_f32<SD>(sV, kSRow, v, a.v_stride[1], k0, kSK, a.t, a.d);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr, row = q0 + r, key = k0 + lane;
      float x = 0.0f, dp = 0.0f;
      for (int c = 0; c < a.d; ++c) {
        x += sQ[r * SD + c] * sK[lane * kSRow + c];
        dp += sO[r * SD + c] * sV[lane * kSRow + c];
      }
      x *= a.scale;
      if ((a.causal && key > row) || key >= a.t) x = -INFINITY;
      const float p = recompute_p(x, lse_r[rr]);
      const float ds = round_to<InT>(
          p * ((dp - delta_r[rr]) + dlse_r[rr]) * a.scale);
      for (int j = 0; j < kSK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < kC; ++c) dq[rr][c] += dsj * sK[j * kSRow + lane + 32 * c];
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= a.t) continue;
    const long long base = (((long long)bi * a.t + row) * a.h + hi) * a.d;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = lane + 32 * c;
      if (col < a.d) static_cast<InT*>(a.dq)[base + col] = from_f32<InT>(dq[rr][c]);
    }
  }
}

// B7 on CUDA cores: one block per (32 keys, b*h_kv). For each chunk of 8
// query rows (every query head of the group, every chunk that reaches the
// keys), phase 1 puts P and dS in shared memory (warp per 2 rows, lane j on
// key j), phase 2 accumulates dV and dK (lane on key, warp on columns warp +
// 4c) in registers.
template <int SD, typename InT, typename DoT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_simt(const BfFlashArgs a) {
  constexpr int kSRow = SD + 1, kC = SD / 4;
  float* sK = reinterpret_cast<float*>(flash_smem);  // [kSK][kSRow]
  float* sV = sK + kSK * kSRow;                       // [kSK][kSRow]
  float* sQ = sV + kSK * kSRow;                       // [kSM][SD]
  float* sO = sQ + kSM * SD;                          // [kSM][SD]
  float* sP = sO + kSM * SD;                          // [kSM][kSK]
  float* sS = sP + kSM * kSK;                         // [kSM][kSK]
  const int k0 = blockIdx.x * kSK;
  const int bi = blockIdx.y / a.h_kv, hk = blockIdx.y % a.h_kv;
  const int group = a.h / a.h_kv;
  const InT* k = static_cast<const InT*>(a.k) + bi * a.k_stride[0] + hk * a.k_stride[2];
  const InT* v = static_cast<const InT*>(a.v) + bi * a.v_stride[0] + hk * a.v_stride[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows_f32<SD>(sK, kSRow, k, a.k_stride[1], k0, kSK, a.t, a.d);
  load_rows_f32<SD>(sV, kSRow, v, a.v_stride[1], k0, kSK, a.t, a.d);

  float dk[kC], dv[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) dk[c] = dv[c] = 0.0f;
  const int n_qt = (a.t + kSM - 1) / kSM;
  const int qt0 = a.causal ? k0 / kSM : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int hi = hk * group + gi;
    const InT* q = static_cast<const InT*>(a.q) + bi * a.q_stride[0] + hi * a.q_stride[2];
    const DoT* dout = static_cast<const DoT*>(a.d_o) + bi * a.do_stride[0] +
                      hi * a.do_stride[2];
    const long long base = ((long long)bi * a.h + hi) * a.t;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int r0 = qt * kSM;
      __syncthreads();
      load_rows_f32<SD>(sQ, SD, q, a.q_stride[1], r0, kSM, a.t, a.d);
      load_rows_f32<SD>(sO, SD, dout, a.do_stride[1], r0, kSM, a.t, a.d);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr, row = r0 + r, key = k0 + lane;
        const bool ok = row < a.t;
        const float lse = ok ? a.lse[base + row] : -INFINITY;
        const float delta = ok ? a.delta[base + row] : 0.0f;
        const float dlse = (ok && a.dlse != nullptr) ? a.dlse[base + row] : 0.0f;
        float x = 0.0f, dp = 0.0f;
        for (int c = 0; c < a.d; ++c) {
          x += sQ[r * SD + c] * sK[lane * kSRow + c];
          dp += sO[r * SD + c] * sV[lane * kSRow + c];
        }
        x *= a.scale;
        if ((a.causal && key > row) || key >= a.t) x = -INFINITY;
        const float p = recompute_p(x, lse);
        sP[r * kSK + lane] = round_to<DoT>(p);
        sS[r * kSK + lane] = round_to<InT>(p * ((dp - delta) + dlse) * a.scale);
      }
      __syncthreads();
      for (int r = 0; r < kSM; ++r) {
        const float p = sP[r * kSK + lane], ds = sS[r * kSK + lane];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          dv[c] += p * sO[r * SD + warp + 4 * c];
          dk[c] += ds * sQ[r * SD + warp + 4 * c];
        }
      }
    }
  }
  const int key = k0 + lane;
  if (key < a.t) {
    const long long base = (((long long)bi * a.t + key) * a.h_kv + hk) * a.d;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = warp + 4 * c;
      if (col < a.d) {
        static_cast<InT*>(a.dk)[base + col] = from_f32<InT>(dk[c]);
        static_cast<InT*>(a.dv)[base + col] = from_f32<InT>(dv[c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, const BfFlashArgs& a,
           void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool tensor_core_route(const BfFlashArgs& a, bool backward) {
  return a.qkv_bf16 != 0 && !(backward && a.do_f32 != 0);
}

// The padded head_dim of a call: 64, 128 or 256 (the wrapper refuses more).
int padded_head_dim(int d) { return d <= 64 ? 64 : (d <= 128 ? 128 : 256); }

template <int DP>
int fwd_mma(const BfFlashArgs& a, void* stream) {
  const dim3 grid((a.t + kBM - 1) / kBM, a.b * a.h, DP / out_cols<DP>());
  return a.out_f32 ? launch(flash_fwd_mma<DP, float>, grid, fwd_smem_bytes<DP>(), a, stream)
                   : launch(flash_fwd_mma<DP, bf16>, grid, fwd_smem_bytes<DP>(), a, stream);
}

template <int SD>
int fwd_simt(const BfFlashArgs& a, void* stream) {
  const dim3 grid((a.t + kSM - 1) / kSM, a.b * a.h);
  return launch(flash_fwd_simt<SD>, grid, simt_fwd_smem_bytes<SD>(), a, stream);
}

template <int DP>
int dkv_mma(const BfFlashArgs& a, void* stream) {
  const dim3 grid((a.t + 63) / 64, a.b * a.h_kv, DP / out_cols<DP>());
  return launch(flash_bwd_dkv_mma<DP>, grid, dkv_smem_bytes<DP>(), a, stream);
}

template <int SD>
int dkv_simt(const BfFlashArgs& a, void* stream) {
  const dim3 grid((a.t + kSK - 1) / kSK, a.b * a.h_kv);
  const int smem = simt_dkv_smem_bytes<SD>();
  return a.qkv_bf16 ? launch(flash_bwd_dkv_simt<SD, bf16, float>, grid, smem, a, stream)
                    : launch(flash_bwd_dkv_simt<SD, float, float>, grid, smem, a, stream);
}

template <int DP>
int dq_mma(const BfFlashArgs& a, void* stream) {
  const dim3 grid((a.t + kBM - 1) / kBM, a.b * a.h, DP / out_cols<DP>());
  return launch(flash_bwd_dq_mma<DP>, grid, dq_smem_bytes<DP>(), a, stream);
}

template <int SD>
int dq_simt(const BfFlashArgs& a, void* stream) {
  const dim3 grid((a.t + kSM - 1) / kSM, a.b * a.h);
  const int smem = simt_dq_smem_bytes<SD>();
  return a.qkv_bf16 ? launch(flash_bwd_dq_simt<SD, bf16, float>, grid, smem, a, stream)
                    : launch(flash_bwd_dq_simt<SD, float, float>, grid, smem, a, stream);
}

}  // namespace

extern "C" {

// out, lse <- attention(q, k, v). Returns a cudaError_t (0: launched).
int bf_flash_fwd(const BfFlashArgs* args, void* stream) {
  const BfFlashArgs& a = *args;
  if (a.t <= 0 || a.b * a.h <= 0) return 0;
  switch (padded_head_dim(a.d)) {
    case 64: return tensor_core_route(a, false) ? fwd_mma<64>(a, stream) : fwd_simt<64>(a, stream);
    case 128: return tensor_core_route(a, false) ? fwd_mma<128>(a, stream) : fwd_simt<128>(a, stream);
    default: return tensor_core_route(a, false) ? fwd_mma<256>(a, stream) : fwd_simt<256>(a, stream);
  }
}

// dk, dv <- the dK/dV half of the backward. Returns a cudaError_t.
int bf_flash_bwd_dkv(const BfFlashArgs* args, void* stream) {
  const BfFlashArgs& a = *args;
  if (a.t <= 0 || a.b * a.h_kv <= 0) return 0;
  switch (padded_head_dim(a.d)) {
    case 64: return tensor_core_route(a, true) ? dkv_mma<64>(a, stream) : dkv_simt<64>(a, stream);
    case 128: return tensor_core_route(a, true) ? dkv_mma<128>(a, stream) : dkv_simt<128>(a, stream);
    default: return tensor_core_route(a, true) ? dkv_mma<256>(a, stream) : dkv_simt<256>(a, stream);
  }
}

// dq <- the dQ half of the backward. Returns a cudaError_t.
int bf_flash_bwd_dq(const BfFlashArgs* args, void* stream) {
  const BfFlashArgs& a = *args;
  if (a.t <= 0 || a.b * a.h <= 0) return 0;
  switch (padded_head_dim(a.d)) {
    case 64: return tensor_core_route(a, true) ? dq_mma<64>(a, stream) : dq_simt<64>(a, stream);
    case 128: return tensor_core_route(a, true) ? dq_mma<128>(a, stream) : dq_simt<128>(a, stream);
    default: return tensor_core_route(a, true) ? dq_mma<256>(a, stream) : dq_simt<256>(a, stream);
  }
}

}  // extern "C"
