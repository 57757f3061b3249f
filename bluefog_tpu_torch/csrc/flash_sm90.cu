// Copyright 2026. Licensed under the Apache License, Version 2.0.
//
// Flash attention for Hopper (sm_90a), the bf16 training route of all three
// kernels, in FlashAttention-3's shape: wgmma fed by the Tensor Memory
// Accelerator, one producer warpgroup and two consumer warpgroups.
//
// Replaces the Pallas kernels of bluefog_tpu/ops/flash.py:
//   bf_flash_fwd_sm90      <- _fwd_call (_fwd_kernel; pallas_call at :169)
//   bf_flash_bwd_dkv_sm90  <- _bwd_call (_bwd_dkv_kernel with _recompute_p;
//                                        pallas_call at :343)
//   bf_flash_bwd_dq_sm90   <- _bwd_call (_bwd_dq_kernel; pallas_call at :369)
//   bf_flash_split_cotangent <- the f32 dO that _bwd_call hands both
//                               backward kernels in the lse form, as two
//                               bf16 halves (below)
// The routes for rows TMA cannot address (off 16 bytes, head_dim not a
// multiple of 8) and for f32 operands stay in flash_kernels.cu;
// ops/flash.py::_route chooses before the launch.
//
// An f32 cotangent (flash_attention_with_lse, whose out is f32 so that ring
// attention's merges stay in f32) enters the tensor cores as two bf16
// halves, hi = bf16(dO) and lo = bf16(dO - hi): dO - hi is exact in f32, so
// hi + lo keeps 16 of dO's 24 mantissa bits (relative error at most 2^-17),
// and every bf16 product is exact in the f32 accumulators. The backward
// kernels then take a fifth tensor map (lo) and compute dP = hi V^T + lo V^T
// in one accumulator, and dV += P_hi^T hi + P_hi^T lo + P_lo^T hi with P_hi
// = bf16(P), P_lo = bf16(P - P_hi) from the f32 P in registers; the dropped
// P_lo^T lo is about 2^-18 of the product. So P stays f32 in P^T dO to
// about 2^-16, as the plain version's contract (P rounded to dO's type)
// asks, before the outputs' rounding to bf16.
//
// What is computed is flash_kernels.cu's arithmetic (its header states it):
// f32 scores times scale, causal and ragged-tail masks to -inf, the online
// softmax with f32 m, l and accumulator and the isfinite guards (a row with no
// valid key gives out 0 and lse -inf), P rounded to bf16 before P.V; in the
// backward P recomputed from Q, K and the lse, dS = P ((dP - delta) + dlse)
// scale, P and dS rounded to bf16 before the products; lse in natural log,
// [b, h, t] f32; grouped-query K/V kept compact. Exponentials are ex2 of
// one FFMA, x (scale log2 e) - m log2 e, with m kept in natural units
// (m = max(s) scale, exact for scale > 0, which the route requires), so the
// lse is m + log(l) as before.
//
// Layout: q [b, t, h, d], k and v [b, t, h_kv, d] with their own batch,
// sequence and head strides (views of the fused projection need no copy);
// out [b, t, h, d], dk and dv [b, t, h_kv, d] contiguous. Each operand gets a
// four-dimensional tensor map (d, head, t, batch; the views' own strides in
// bytes), built on the host per call through cuTensorMapEncodeTiled (found
// with cudaGetDriverEntryPoint, so no -lcuda). A tile is a box of 64 columns
// x 1 head x rows x 1 batch, 128-byte swizzled; TMA zero-fills the rows past
// t inside one (batch, head) and the columns d..DP, so no padding copy and no
// read of the next head exists. The route requires 16-byte aligned bases
// and strides (ops/flash.py::_rows_aligned).
//
// Bound: operations. At the training shape (b 2, h 16, t 4096, d 64,
// causal) the forward does two products over the lower triangle, 68.7
// GFLOP: 0.069 ms at 989 TFLOP/s; dK/dV four, 0.139 ms; dQ three, 0.104 ms.
// Their bytes take 0.02-0.03 ms at 3.35 TB/s. The design:
// - Forward: one block per (Q tile of 128 rows, b h), heaviest causal tiles
//   first. Warpgroup 0 is the producer: one thread issues TMA for Q (once)
//   and for K and V through a ring of 2-3 stages of BN keys, each stage
//   with a full and an empty mbarrier; the warpgroup drops to 24 registers
//   (setmaxnreg). Warpgroups 1 and 2 each own 64 query rows (240
//   registers). S = Q K^T is wgmma.m64nBNk16 with both operands in shared
//   memory, K-major; O += P V takes P from registers (the f32 accumulator
//   layout of S, packed to bf16 pairs, is wgmma's register-A layout) and V
//   from shared memory, MN-major (the transpose flag). Inside a warpgroup,
//   S of tile j+1 is issued together with P_j V_j, and its softmax runs
//   while P_j V_j is on the tensor cores. Masks run only on diagonal and
//   ragged tiles. The epilogue stages bf16 out in the warpgroup's own Q rows
//   of shared memory and writes 16-byte stores.
// - dK/dV: one block per (K tile of 128 keys, b h_kv), heaviest first. The
//   producer streams Q and dO tiles of 64 rows for every query head of the
//   group and every Q tile that reaches the keys; a second producer warp
//   loads the per-row lse (as -lse log2 e, -inf past t or where the lse is
//   -inf), delta and dlse with bounds checks (zero past t), since TMA's zero
//   rows past t would otherwise meet the next head's lse. Each consumer owns
//   64 keys: S^T = K Q^T and dP^T = V dO^T (wgmma.m64n64k16, K and V loaded
//   once, Q and dO streamed, both K-major), then dV += P^T dO and dK += dS^T
//   Q with P^T and dS^T from registers and dO and Q MN-major. dK and dV stay
//   in f32 registers; the group's heads sum in the loop, without atomics.
//   Split (kSplit): a lo tile streams beside every dO tile (107 KB of shared
//   memory at head_dim 64, 212 KB at 128), the lo chain follows the hi
//   chain of dP^T, and dV takes the three chains above: 7 products in
//   place of 4.
// - dQ: the forward's shape. One block per (Q tile of 128 rows, b h),
//   heaviest first; the producer loads Q and dO once and streams K and V
//   tiles of 64 keys through the ring. Each consumer thread reads the lse (as -lse
//   log2 e), delta and dlse of its own two rows once, bounds-checked (past t:
//   -inf and 0, whatever the next head holds there). Per tile, S = Q K^T and
//   dP = dO V^T (wgmma from shared memory, K-major), P = ex2 of one FFMA,
//   dS = P ((dP - delta) + dlse) scale packed to bf16 in registers, and dQ
//   += dS K with K MN-major (the forward's P V descriptor). The product
//   dS_j K_j is issued between S_{j+1} and dP_{j+1}, so P_{j+1} is
//   computed while both run on the tensor cores. dQ stays in f32 registers
//   and is written once, through the warpgroup's own Q rows of shared
//   memory. Split (kSplit): dO's lo panel stays resident beside hi (113 KB
//   at head_dim 64, 225 KB at 128, of 227) and dP takes a second chain
//   into its accumulator: 4 products in place of 3.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_args.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;  // three warpgroups
constexpr int kRowBytes = 128; // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

// ---- Hopper instructions (inline PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed. A pipeline
// fault traps after about ten seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// One box of a four-dimensional tensor map into shared memory, completing
// on `bar`. Coordinates innermost first: column, head, row, batch.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// 8-row groups 1024 bytes apart (SBO); `lbo` bytes between 64-column panels
// (used by the MN-major operands, whose N spans panels).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d[N/2] (64 x N, f32) = (scale_d ? d : 0) + A . B, A (64 x 16) and B (16 x
// N) from shared memory, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d);

// d[N/2] (64 x N, f32) += A . B, A (64 x 16 bf16) from four registers a
// thread, B (16 x N) from shared memory, MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(
    float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(
    float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t* a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---- end of inline PTX ----

// 2^x by the hardware instruction (MUFU.EX2; relative error about 2^-22,
// subnormal results flushed to 0): exp2f adds the subnormal handling on top,
// and the softmax is bound by these instructions.
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// The accumulator blocks of a 64 x N tile (f32, wgmma's layout: block j
// holds columns 8j + 2 (lane % 4) + {0, 1} of rows lane / 4 and lane / 4 +
// 8 of the warp's 16) as bf16 register-A fragments, 16 columns each.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The low bf16 halves of the same blocks: s - bf16(s), rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a_lo(uint32_t (&a)[N / 4], const float (&s)[N / 2]) {
  float r[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) r[i] = s[i] - __bfloat162float(__float2bfloat16_rn(s[i]));
  pack_a<N>(a, r);
}

// Byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in a
// 128-byte-swizzled panel, the layout TMA writes and wgmma reads.
__device__ __forceinline__ int swizzled(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// Stores a warpgroup's 64 x DP f32 accumulator (divided by div[r]) as bf16
// into `stage` (DP / 64 swizzled panels of 64 rows, `panel` bytes apart),
// then, after the warpgroup's named barrier, copies rows row0 .. row0 + 63
// below t, columns below d, to dst (row stride ld elements) in 16-byte
// stores.
template <int DP>
__device__ __forceinline__ void store_tile(unsigned char* stage, int panel,
                                           const float (&acc)[DP / 2],
                                           const float (&div)[2], bf16* dst,
                                           long long ld, int row0, int t, int d,
                                           int barrier) {
  const int tid = threadIdx.x & 127, lane = tid & 31;
  const int r_lo = (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      const uint32_t v = pack_bf16(acc[4 * j + 2 * r] / div[r],
                                   acc[4 * j + 2 * r + 1] / div[r]);
      *reinterpret_cast<uint32_t*>(stage + (j >> 3) * panel +
                                   swizzled(row, j & 7) + (lane & 3) * 4) = v;
    }
  }
  named_barrier(barrier, 128);
  constexpr int kChunks = DP / 8;
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    if (row < t && c * 8 < d) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + (c >> 3) * panel +
                                                      swizzled(r, c & 7));
      *reinterpret_cast<uint4*>(dst + row * ld + c * 8) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// B6: the forward.
// ---------------------------------------------------------------------------

constexpr int kFwdBM = 128;  // query rows per block, 64 per consumer
constexpr int kFwdBN = 128;  // keys per streamed tile

// Depth of the K/V ring: three stages where they fit in shared memory.
template <int DP>
__host__ __device__ constexpr int fwd_stages() {
  return DP <= 64 ? 3 : 2;
}

template <int DP>
__host__ __device__ constexpr int fwd_smem_bytes() {
  // Q, the K and V stages, DP / 64 panels apiece; the barriers; 1024 bytes
  // to align the swizzled tiles.
  return (kFwdBM + 2 * fwd_stages<DP>() * kFwdBN) * (DP / 64) * kRowBytes + 256 + 1024;
}

// S (64 x BN) = Q (this warpgroup's 64 rows) . K^T of one stage.
template <int DP>
__device__ __forceinline__ void fwd_issue_s(float (&s)[kFwdBN / 2], const unsigned char* q_rows,
                                            const unsigned char* k_st) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int col = (kk & 3) * 32;  // 16 columns of a 64-column panel
    wgmma_ss<kFwdBN>(s, desc_sw128(q_rows + (kk >> 2) * kFwdBM * kRowBytes + col, 16),
                     desc_sw128(k_st + (kk >> 2) * kFwdBN * kRowBytes + col, 16), kk > 0);
  }
}

// O += P . V of one stage (P from registers, V MN-major).
template <int DP>
__device__ __forceinline__ void fwd_issue_pv(float (&o)[DP / 2], const uint32_t (&p)[kFwdBN / 4],
                                             const unsigned char* v_st) {
#pragma unroll
  for (int kk = 0; kk < kFwdBN / 16; ++kk) {
    wgmma_rs<DP>(o, &p[4 * kk], desc_sw128(v_st + kk * 16 * kRowBytes, kFwdBN * kRowBytes), 1);
  }
}

// The online softmax of one tile of scores s (keys k0 .. k0 + BN - 1; this
// thread's rows row_lo and row_lo + 8): masks when `masked`, the running
// max m (natural units) and sum l, P packed to bf16 into pn, and the factor
// corr that rescales the earlier tiles.
__device__ __forceinline__ void fwd_softmax(float (&s)[kFwdBN / 2], uint32_t (&pn)[kFwdBN / 4],
                                            float (&m_run)[2], float (&l_run)[2],
                                            float (&corr)[2], const BfFlashArgs& a, int k0,
                                            int row_lo, bool masked) {
  const int tg = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kFwdBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = s[4 * j + e];
      if (masked) {
        const int row = row_lo + 8 * r;
        const int col = k0 + 8 * j + 2 * tg + (e & 1);
        if ((a.causal && col > row) || col >= a.t) x = -INFINITY;
        s[4 * j + e] = x;
      }
      mx[r] = fmaxf(mx[r], x);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * a.scale);
    const float m_safe = isfinite(m_new) ? m_new : 0.0f;
    corr[r] = isfinite(m_run[r]) ? pow2((m_run[r] - m_safe) * kLog2e) : 0.0f;
    m_run[r] = m_new;
    l_run[r] *= corr[r];
    neg_m[r] = -m_safe * kLog2e;
  }
  const float c2 = a.scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kFwdBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float pe = pow2(fmaf(s[4 * j + e], c2, neg_m[r]));
      s[4 * j + e] = pe;
      l_run[r] += pe;
    }
  }
  pack_a<kFwdBN>(pn, s);
}

template <int DP, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const BfFlashArgs a) {
  constexpr int BN = kFwdBN, kPanels = DP / 64, kStages = fwd_stages<DP>();
  constexpr int kQPanel = kFwdBM * kRowBytes, kKPanel = BN * kRowBytes;
  constexpr int kStageBytes = kPanels * kKPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + kPanels * kQPanel;
  unsigned char* sV = sK + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int bh = blockIdx.x, bi = bh / a.h, hi = bh % a.h;
  const int hk = hi / (a.h / a.h_kv);
  const int n_qt = (a.t + kFwdBM - 1) / kFwdBM;
  const int q0 = (n_qt - 1 - blockIdx.y) * kFwdBM;  // heaviest tiles first
  const int all = (a.t + BN - 1) / BN;
  const int n_kt = a.causal ? min(all, (q0 + kFwdBM + BN - 1) / BN) : all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kPanels * kQPanel);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sQ + p * kQPanel, &tq, q_full, 64 * p, hi, q0, bi);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kStageBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sK + st * kStageBytes + p * kKPanel, &tk, &full[st], 64 * p, hk,
                   kt * BN, bi);
          tma_load(sV + st * kStageBytes + p * kKPanel, &tv, &full[st], 64 * p, hk,
                   kt * BN, bi);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int row_lo = q0 + 64 * wg + (tid >> 5) * 16 + (lane >> 2);  // and + 8
    const unsigned char* q_rows = sQ + wg * 64 * kRowBytes;
    // a tile needs masks when it crosses this warpgroup's diagonal or t
    auto masked = [&](int kt) {
      return (a.causal && kt * BN + BN - 1 > q0 + 64 * wg) || (kt * BN + BN > a.t);
    };

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    float s[BN / 2];
    uint32_t p[BN / 4];  // P of the tile whose P.V is in flight
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
    float corr[2];

    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    fence_regs(s);
    wgmma_fence();
    fwd_issue_s<DP>(s, q_rows, sK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fwd_softmax(s, p, m_run, l_run, corr, a, 0, row_lo, masked(0));
    for (int kt = 1; kt < n_kt; ++kt) {
      const int st = kt % kStages, prev = (kt - 1) % kStages;
      mbar_wait(&full[st], (kt / kStages) & 1);
      fence_regs(s);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      fwd_issue_s<DP>(s, q_rows, sK + st * kStageBytes);
      wgmma_commit();
      fwd_issue_pv<DP>(o, p, sV + prev * kStageBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile kt; P.V of tile kt - 1 still runs
      fence_regs(s);
      uint32_t pn[BN / 4];
      fwd_softmax(s, pn, m_run, l_run, corr, a, kt * BN, row_lo, masked(kt));
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);  // live until its product completes: pn may not take its registers
      mbar_arrive(&empty[prev]);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) p[i] = pn[i];
    }
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    fwd_issue_pv<DP>(o, p, sV + ((n_kt - 1) % kStages) * kStageBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(n_kt - 1) % kStages]);

    const int tg = lane & 3;
    float l_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      l_safe[r] = l > 0.0f ? l : 1.0f;
      const int row = row_lo + 8 * r;
      if (tg == 0 && row < a.t) {
        a.lse[(long long)bh * a.t + row] = l > 0.0f ? m_run[r] + logf(l_safe[r]) : -INFINITY;
      }
    }
    const long long ld = (long long)a.h * a.d;
    OutT* out = static_cast<OutT*>(a.out) + ((long long)bi * a.t * a.h + hi) * a.d;
    if constexpr (sizeof(OutT) == 2) {
      // this warpgroup's Q rows are free once its last S has completed
      store_tile<DP>(sQ + wg * 64 * kRowBytes, kQPanel, o, l_safe, out, ld, q0 + 64 * wg,
                     a.t, a.d, 1 + wg);
    } else {
      // the lse form's f32 out: each quad writes 32 contiguous bytes a row
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_lo + 8 * r, col = 8 * j + 2 * tg;
          if (row < a.t && col < a.d) {
            *reinterpret_cast<float2*>(out + row * ld + col) =
                make_float2(o[4 * j + 2 * r] / l_safe[r], o[4 * j + 2 * r + 1] / l_safe[r]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B7: dK and dV.
// ---------------------------------------------------------------------------

constexpr int kDkvBM = 64;      // query rows per streamed tile
constexpr int kDkvBN = 128;     // keys per block, 64 per consumer
constexpr int kDkvStages = 3;  // depth of the Q/dO ring

// Streamed tiles a stage: Q and dO, and with a split cotangent dO's low half.
__host__ __device__ constexpr int dkv_streams(bool split) { return split ? 3 : 2; }

template <int DP, bool kSplit>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // K and V (128 rows), the streamed stages (64 rows), DP / 64 panels
  // apiece; the per-row vectors; the barriers; 1024 bytes of alignment.
  return (2 * kDkvBN + dkv_streams(kSplit) * kDkvStages * kDkvBM) * (DP / 64) * kRowBytes +
         kDkvStages * 3 * kDkvBM * 4 + 256 + 1024;
}

// kSplit: dO comes as hi (tdo) and lo (tdo_lo) halves of an f32 cotangent;
// else tdo is a bf16 cotangent and tdo_lo is not read.
template <int DP, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdo_lo, const BfFlashArgs a) {
  constexpr int BM = kDkvBM, BN = kDkvBN, kPanels = DP / 64, kStages = kDkvStages;
  constexpr int kKPanel = BN * kRowBytes, kQPanel = BM * kRowBytes;
  constexpr int kStageBytes = kPanels * kQPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = sK + kPanels * kKPanel;
  unsigned char* sQ = sV + kPanels * kKPanel;
  unsigned char* sO = sQ + kStages * kStageBytes;  // dO (its high half when split)
  unsigned char* sL = sO + kStages * kStageBytes;  // dO's low half (kSplit only)
  // the per-row vectors, [stage][3][BM]
  float* vec = reinterpret_cast<float*>(sL + (kSplit ? kStages * kStageBytes : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(vec + kStages * 3 * BM);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int bi = blockIdx.x / a.h_kv, hk = blockIdx.x % a.h_kv;
  const int k0 = blockIdx.y * BN;  // causal: the heaviest tiles come first
  const int group = a.h / a.h_kv;
  const int n_qt = (a.t + BM - 1) / BM;
  const int qt0 = a.causal ? k0 / BM : 0;  // first Q tile that reaches k0
  const int per_head = n_qt - qt0;
  const int n_it = group * per_head;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the vector warp
      mbar_init(&empty[s], 256);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    setmaxnreg_dec<24>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * kPanels * kKPanel);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sK + p * kKPanel, &tk, kv_full, 64 * p, hk, k0, bi);
        tma_load(sV + p * kKPanel, &tv, kv_full, 64 * p, hk, k0, bi);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int hi = hk * group + it / per_head;
        const int r0 = (qt0 + it % per_head) * BM;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], dkv_streams(kSplit) * kStageBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sQ + st * kStageBytes + p * kQPanel, &tq, &full[st], 64 * p, hi, r0, bi);
          tma_load(sO + st * kStageBytes + p * kQPanel, &tdo, &full[st], 64 * p, hi, r0, bi);
          if constexpr (kSplit) {
            tma_load(sL + st * kStageBytes + p * kQPanel, &tdo_lo, &full[st], 64 * p, hi, r0,
                     bi);
          }
        }
      }
    } else if (warp == 1) {
      // the per-row vectors, bounds-checked: past t the lse is -inf (so P is
      // 0) and delta and dlse are 0, whatever the next head holds there
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int hi = hk * group + it / per_head;
        const int r0 = (qt0 + it % per_head) * BM;
        const long long base = ((long long)bi * a.h + hi) * a.t;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        float* v = vec + st * 3 * BM;
        for (int r = lane; r < BM; r += 32) {
          const int row = r0 + r;
          const bool ok = row < a.t;
          const float lse = ok ? a.lse[base + row] : -INFINITY;
          v[r] = isfinite(lse) ? -lse * kLog2e : -INFINITY;
          v[BM + r] = ok ? a.delta[base + row] : 0.0f;
          v[2 * BM + r] = (ok && a.dlse != nullptr) ? a.dlse[base + row] : 0.0f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    setmaxnreg_inc<240>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int tg = lane & 3;
    const int key_lo = k0 + 64 * wg + (tid >> 5) * 16 + (lane >> 2);  // and + 8
    const float c2 = a.scale * kLog2e;
    unsigned char* k_rows = sK + wg * 64 * kRowBytes;
    unsigned char* v_rows = sV + wg * 64 * kRowBytes;

    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;

    // P^T and dS^T of the tile whose dV/dK products are in flight. At d <= 64
    // those products run on while the next tile's S^T and dP^T are issued
    // (kDefer); at d 128 the registers do not allow it and they are waited
    // for at once.
    constexpr bool kDefer = DP <= 64;
    // pl: P^T's low half (kSplit)
    uint32_t pa[BM / 4], da[BM / 4], pl[kSplit ? BM / 4 : 1];
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int r0 = (qt0 + it % per_head) * BM;
      const unsigned char* q_st = sQ + st * kStageBytes;
      const unsigned char* o_st = sO + st * kStageBytes;
      const unsigned char* l_st = sL + st * kStageBytes;
      const float* nl = vec + st * 3 * BM;  // -lse log2 e
      const float* delta = nl + BM;
      const float* dlse = nl + 2 * BM;
      mbar_wait(&full[st], (it / kStages) & 1);

      // S^T = K . Q^T and dP^T = V . dO^T (this warpgroup's 64 keys x BM)
      float s[BM / 2], dp[BM / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk >> 2) * kKPanel + (kk & 3) * 32;
        const int qoff = (kk >> 2) * kQPanel + (kk & 3) * 32;
        wgmma_ss<BM>(s, desc_sw128(k_rows + off, 16), desc_sw128(q_st + qoff, 16), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk >> 2) * kKPanel + (kk & 3) * 32;
        const int qoff = (kk >> 2) * kQPanel + (kk & 3) * 32;
        wgmma_ss<BM>(dp, desc_sw128(v_rows + off, 16), desc_sw128(o_st + qoff, 16), kk > 0);
      }
      if constexpr (kSplit) {
        // + V . lo^T, into the same accumulator
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int off = (kk >> 2) * kKPanel + (kk & 3) * 32;
          const int qoff = (kk >> 2) * kQPanel + (kk & 3) * 32;
          wgmma_ss<BM>(dp, desc_sw128(v_rows + off, 16), desc_sw128(l_st + qoff, 16), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous tile's dV/dK and this S^T; dP^T still runs
      fence_regs(s);
      if constexpr (kDefer) {
        fence_regs(dk);
        fence_regs(dv);
        fence_regs(pa);
        fence_regs(da);
        fence_regs(pl);
        if (it > 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }

      const bool masked = (a.causal && k0 + 64 * wg + 63 > r0) || (k0 + 64 * wg + 64 > a.t);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tg + (e & 1);
          const int key = key_lo + 8 * (e >> 1);
          float pe = pow2(fmaf(s[4 * j + e], c2, nl[qi]));
          if (masked && ((a.causal && key > r0 + qi) || key >= a.t)) pe = 0.0f;
          s[4 * j + e] = pe;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * tg + (e & 1);
          dp[4 * j + e] = s[4 * j + e] * ((dp[4 * j + e] - delta[qi]) + dlse[qi]) * a.scale;
        }
      }
      pack_a<BM>(pa, s);   // P^T, rounded to dO's type (split: its high half)
      if constexpr (kSplit) pack_a_lo<BM>(pl, s);
      pack_a<BM>(da, dp);  // dS^T, rounded to Q's type

      // dV += P^T . dO and dK += dS^T . Q (Q and dO MN-major). Split: dV +=
      // P_hi^T hi + P_hi^T lo + P_lo^T hi. The last chain is about 2^-9 of
      // dV, the size of the output's own bf16 rounding, so no check of the
      // kernel's outputs can see it; tests/test_torch_flash_split.py holds
      // the composite of these products to the f32 plain version.
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        const uint64_t o_desc = desc_sw128(o_st + kk * 16 * kRowBytes, kQPanel);
        wgmma_rs<DP>(dv, &pa[4 * kk], o_desc, 1);
        wgmma_rs<DP>(dk, &da[4 * kk], desc_sw128(q_st + kk * 16 * kRowBytes, kQPanel), 1);
        if constexpr (kSplit) {
          wgmma_rs<DP>(dv, &pa[4 * kk], desc_sw128(l_st + kk * 16 * kRowBytes, kQPanel), 1);
          wgmma_rs<DP>(dv, &pl[4 * kk], o_desc, 1);
        }
      }
      wgmma_commit();
      if constexpr (!kDefer) {
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        mbar_arrive(&empty[st]);
      }
    }
    if constexpr (kDefer) {
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(pl);
      mbar_arrive(&empty[(n_it - 1) % kStages]);
    }

    const float one[2] = {1.0f, 1.0f};
    const long long ld = (long long)a.h_kv * a.d;
    const long long off = ((long long)bi * a.t * a.h_kv + hk) * a.d;
    // this warpgroup's K and V rows are read by nothing else
    store_tile<DP>(k_rows, kKPanel, dk, one, static_cast<bf16*>(a.dk) + off, ld,
                   k0 + 64 * wg, a.t, a.d, 1 + wg);
    store_tile<DP>(v_rows, kKPanel, dv, one, static_cast<bf16*>(a.dv) + off, ld,
                   k0 + 64 * wg, a.t, a.d, 1 + wg);
  }
}

// ---------------------------------------------------------------------------
// B8: dQ.
// ---------------------------------------------------------------------------

constexpr int kDqBM = 128;  // query rows per block, 64 per consumer
// Keys per streamed tile. 64 rather than the forward's 128: a warpgroup's
// last causal tile then wastes at most 64 masked keys, and S, dP, dQ and dS
// take 112 registers a thread at head_dim 64 (128 keys measured slower).
constexpr int kDqBN = 64;
// Depth of the K/V ring: a 64-key tile is short work, so more tiles are
// kept in flight than in the forward (3 stages measured slower).
constexpr int kDqStages = 4;

template <int DP, bool kSplit>
__host__ __device__ constexpr int dq_smem_bytes() {
  // Q and dO, and with a split cotangent dO's low half (128 rows), the K
  // and V stages (BN rows), DP / 64 panels apiece; the barriers; 1024
  // bytes to align the swizzled tiles. Split at DP 128: 230 656 bytes.
  return ((kSplit ? 3 : 2) * kDqBM + 2 * kDqStages * kDqBN) * (DP / 64) * kRowBytes + 256 +
         1024;
}

// acc (64 x BN) = (accumulate ? acc : 0) + A (this warpgroup's 64 rows of Q
// or dO) . B^T (K or V of one stage), both K-major.
template <int DP, int BN>
__device__ __forceinline__ void dq_issue_rows(float (&acc)[BN / 2], const unsigned char* rows,
                                              const unsigned char* st, bool accumulate = false) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int col = (kk & 3) * 32;  // 16 columns of a 64-column panel
    wgmma_ss<BN>(acc, desc_sw128(rows + (kk >> 2) * kDqBM * kRowBytes + col, 16),
                 desc_sw128(st + (kk >> 2) * BN * kRowBytes + col, 16), accumulate || kk > 0);
  }
}

// dQ += dS . K of one stage (dS from registers, K MN-major).
template <int DP, int BN>
__device__ __forceinline__ void dq_issue_ds_k(float (&dq)[DP / 2], const uint32_t (&ds)[BN / 4],
                                              const unsigned char* k_st) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    wgmma_rs<DP>(dq, &ds[4 * kk], desc_sw128(k_st + kk * 16 * kRowBytes, BN * kRowBytes), 1);
  }
}

// kSplit: as in flash_bwd_dkv_sm90.
template <int DP, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tdo_lo, const BfFlashArgs a) {
  constexpr int BM = kDqBM, BN = kDqBN, kPanels = DP / 64, kStages = kDqStages;
  constexpr int kQPanel = BM * kRowBytes, kKPanel = BN * kRowBytes;
  constexpr int kStageBytes = kPanels * kKPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sO = sQ + kPanels * kQPanel;  // dO (its high half when split)
  unsigned char* sL = sO + kPanels * kQPanel;  // dO's low half (kSplit only)
  unsigned char* sK = sL + (kSplit ? kPanels * kQPanel : 0);
  unsigned char* sV = sK + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qo_full = empty + kStages;

  const int bh = blockIdx.x, bi = bh / a.h, hi = bh % a.h;
  const int hk = hi / (a.h / a.h_kv);
  const int n_qt = (a.t + BM - 1) / BM;
  const int q0 = (n_qt - 1 - blockIdx.y) * BM;  // heaviest tiles first
  const int all = (a.t + BN - 1) / BN;
  const int n_kt = a.causal ? min(all, (q0 + BM + BN - 1) / BN) : all;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(qo_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qo_full, (kSplit ? 3 : 2) * kPanels * kQPanel);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(sQ + p * kQPanel, &tq, qo_full, 64 * p, hi, q0, bi);
        tma_load(sO + p * kQPanel, &tdo, qo_full, 64 * p, hi, q0, bi);
        if constexpr (kSplit) tma_load(sL + p * kQPanel, &tdo_lo, qo_full, 64 * p, hi, q0, bi);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kStages;
        mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * kStageBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sK + st * kStageBytes + p * kKPanel, &tk, &full[st], 64 * p, hk, j * BN, bi);
          tma_load(sV + st * kStageBytes + p * kKPanel, &tv, &full[st], 64 * p, hk, j * BN, bi);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    setmaxnreg_inc<240>();
    const int wg = (threadIdx.x >> 7) - 1;
    const int tid = threadIdx.x & 127, lane = tid & 31;
    const int tg = lane & 3;
    const int row_lo = q0 + 64 * wg + (tid >> 5) * 16 + (lane >> 2);  // and + 8
    const unsigned char* q_rows = sQ + wg * 64 * kRowBytes;
    const unsigned char* o_rows = sO + wg * 64 * kRowBytes;
    const unsigned char* l_rows = sL + wg * 64 * kRowBytes;
    const float c2 = a.scale * kLog2e;

    // this thread's two rows of -lse log2 e, delta and dlse; TMA zero-fills
    // the Q and dO rows past t, but these vectors would meet the next head's
    float nl[2], delta[2], dlse[2];
    const long long vbase = (long long)bh * a.t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int vrow = row_lo + 8 * r;
      const bool in_t = vrow < a.t;
      const float lse_row = in_t ? a.lse[vbase + vrow] : -INFINITY;
      nl[r] = isfinite(lse_row) ? -lse_row * kLog2e : -INFINITY;
      delta[r] = in_t ? a.delta[vbase + vrow] : 0.0f;
      dlse[r] = (in_t && a.dlse != nullptr) ? a.dlse[vbase + vrow] : 0.0f;
    }
    // a tile needs masks when it crosses this warpgroup's diagonal or t
    auto masked = [&](int j) {
      return (a.causal && j * BN + BN - 1 > q0 + 64 * wg) || (j * BN + BN > a.t);
    };
    // P of tile j's scores s, in place (exponent as one FFMA; masked only on
    // diagonal and ragged tiles)
    auto probabilities = [&](float (&s)[BN / 2], int j) {
      const bool m = masked(j);
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_lo + 8 * (e >> 1);
          const int col = j * BN + 8 * i + 2 * tg + (e & 1);
          float pe = pow2(fmaf(s[4 * i + e], c2, nl[e >> 1]));
          if (m && ((a.causal && col > row) || col >= a.t)) pe = 0.0f;
          s[4 * i + e] = pe;
        }
      }
    };
    // dS = P ((dP - delta) + dlse) scale in place of dP (f32)
    auto grad_scores = [&](const float (&p)[BN / 2], float (&dp)[BN / 2]) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          dp[4 * i + e] = p[4 * i + e] * ((dp[4 * i + e] - delta[r]) + dlse[r]) * a.scale;
        }
      }
    };

    // dP = dO . V^T of one stage; split: hi . V^T + lo . V^T in one
    // accumulator
    auto issue_dp = [&](float (&acc)[BN / 2], const unsigned char* v_st) {
      dq_issue_rows<DP, BN>(acc, o_rows, v_st);
      if constexpr (kSplit) dq_issue_rows<DP, BN>(acc, l_rows, v_st, true);
    };

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;
    float s[BN / 2], dp[BN / 2];
    uint32_t ds[BN / 4];  // dS of the tile whose dS.K is in flight

    mbar_wait(qo_full, 0);
    if (n_kt > 0) {
      mbar_wait(&full[0], 0);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      dq_issue_rows<DP, BN>(s, q_rows, sK);
      wgmma_commit();
      issue_dp(dp, sV);
      wgmma_commit();
      wgmma_wait<1>();  // S; dP still runs
      fence_regs(s);
      probabilities(s, 0);
      wgmma_wait<0>();
      fence_regs(dp);
      grad_scores(s, dp);
      pack_a<BN>(ds, dp);  // rounded to K's type
    }
    for (int j = 1; j < n_kt; ++j) {
      const int st = j % kStages, prev = (j - 1) % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq);
      fence_regs(ds);
      wgmma_fence();
      dq_issue_rows<DP, BN>(s, q_rows, sK + st * kStageBytes);
      wgmma_commit();
      dq_issue_ds_k<DP, BN>(dq, ds, sK + prev * kStageBytes);
      wgmma_commit();
      issue_dp(dp, sV + st * kStageBytes);
      wgmma_commit();
      // P of tile j while dS.K of tile j - 1 and dP of tile j run; ds takes
      // dS of tile j once dS.K has completed
      wgmma_wait<2>();
      fence_regs(s);
      probabilities(s, j);
      wgmma_wait<1>();
      fence_regs(dq);
      fence_regs(ds);
      mbar_arrive(&empty[prev]);
      wgmma_wait<0>();
      fence_regs(dp);
      grad_scores(s, dp);
      pack_a<BN>(ds, dp);
    }
    if (n_kt > 0) {
      fence_regs(dq);
      fence_regs(ds);
      wgmma_fence();
      dq_issue_ds_k<DP, BN>(dq, ds, sK + ((n_kt - 1) % kStages) * kStageBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(&empty[(n_kt - 1) % kStages]);
    }

    const float one[2] = {1.0f, 1.0f};
    bf16* dst = static_cast<bf16*>(a.dq) + ((long long)bi * a.t * a.h + hi) * a.d;
    // this warpgroup's Q rows are free once its last S has completed
    store_tile<DP>(sQ + wg * 64 * kRowBytes, kQPanel, dq, one, dst, (long long)a.h * a.d,
                   q0 + 64 * wg, a.t, a.d, 1 + wg);
  }
}

// ---------------------------------------------------------------------------
// The f32 cotangent's two bf16 halves.
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;

__device__ __forceinline__ void split_bf16(float x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// hi = bf16(x), lo = bf16(x - hi) for x [b, t, h, d] f32 read through its
// element strides s0, s1, s2 (batch, sequence, head; the last axis
// contiguous), written to contiguous bf16 [b, t, h, d]: the plain
// version's bits (ops/flash.py::split_cotangent_reference). Bound: bytes,
// 4 read and 4 written an element (0.04 ms for the ring block's 64 MiB at
// 3.35 TB/s). Each thread converts W neighbouring elements of one row: W
// = 4 (a 16-byte load, two 8-byte stores) when every row starts on 16
// bytes and d % 4 == 0, else 1; a grid-stride loop over n = b t h d / W.
template <int W>
__global__ void __launch_bounds__(kSplitThreads)
    flash_split_cotangent(const float* __restrict__ x, bf16* __restrict__ hi,
                          bf16* __restrict__ lo, long long s0, long long s1, long long s2,
                          int t, int h, int d, long long n) {
  const int per_row = d / W;
  for (long long i = blockIdx.x * (long long)kSplitThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kSplitThreads) {
    const long long row = i / per_row;  // (batch, sequence, head)
    const int col = static_cast<int>(i - row * per_row) * W;
    const long long bt = row / h;
    const long long src = (bt / t) * s0 + (bt % t) * s1 + (row % h) * s2 + col;
    const long long dst = row * d + col;
    if constexpr (W == 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + src);
      const float e[4] = {v.x, v.y, v.z, v.w};
      uint32_t hw[2], lw[2];  // element 2j in the low 16 bits of word j
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bf16 h0, l0, h1, l1;
        split_bf16(e[2 * j], h0, l0);
        split_bf16(e[2 * j + 1], h1, l1);
        hw[j] = __bfloat16_as_ushort(h0) | (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
        lw[j] = __bfloat16_as_ushort(l0) | (static_cast<uint32_t>(__bfloat16_as_ushort(l1)) << 16);
      }
      *reinterpret_cast<uint2*>(hi + dst) = make_uint2(hw[0], hw[1]);
      *reinterpret_cast<uint2*>(lo + dst) = make_uint2(lw[0], lw[1]);
    } else {
      split_bf16(x[src], hi[dst], lo[dst]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launchers.
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (the library links no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Status codes above those of cudaError_t: the tensor map could not be made.
constexpr int kNoEncoder = 100000;
constexpr int kEncodeFailed = 100001;

// The map of a bf16 [b, t, heads, d] operand with element strides (batch,
// sequence, head): dimensions d, head, t, batch innermost first, boxes of 64
// columns x 1 head x `rows` x 1 batch, 128-byte swizzle, zero fill.
int make_map(CUtensorMap* map, const void* base, const long long* stride, int b, int t,
             int heads, int d, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[2] * 2, (cuuint64_t)stride[1] * 2,
                                 (cuuint64_t)stride[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              const_cast<void*>(base), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int DP, typename OutT>
int launch_fwd(const BfFlashArgs& a, const CUtensorMap* maps, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90<DP, OutT>;
  const int smem = fwd_smem_bytes<DP>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(a.b * a.h, (a.t + kFwdBM - 1) / kFwdBM);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kSplit>
int launch_dkv(const BfFlashArgs& a, const CUtensorMap* maps, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_sm90<DP, kSplit>;
  const int smem = dkv_smem_bytes<DP, kSplit>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(a.b * a.h_kv, (a.t + kDkvBN - 1) / kDkvBN);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool kSplit>
int launch_dq(const BfFlashArgs& a, const CUtensorMap* maps, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_sm90<DP, kSplit>;
  const int smem = dq_smem_bytes<DP, kSplit>();
  if (int err = prepare(kernel, smem)) return err;
  const dim3 grid(a.b * a.h, (a.t + kDqBM - 1) / kDqBM);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], a);
  return static_cast<int>(cudaGetLastError());
}

// The five maps of a backward launch: q, k, v, dO (its high half when
// split) with `q_rows`-row boxes for q and dO and `kv_rows` for k and v;
// the fifth is dO's low half (d_o_lo, with do_stride) or, without a
// split, a copy of the fourth that the kernel does not read.
int backward_maps(CUtensorMap* maps, const BfFlashArgs& a, int q_rows, int kv_rows) {
  int err = make_map(&maps[0], a.q, a.q_stride, a.b, a.t, a.h, a.d, q_rows);
  if (!err) err = make_map(&maps[1], a.k, a.k_stride, a.b, a.t, a.h_kv, a.d, kv_rows);
  if (!err) err = make_map(&maps[2], a.v, a.v_stride, a.b, a.t, a.h_kv, a.d, kv_rows);
  if (!err) err = make_map(&maps[3], a.d_o, a.do_stride, a.b, a.t, a.h, a.d, q_rows);
  if (err) return err;
  if (a.d_o_lo == nullptr) {
    maps[4] = maps[3];
    return 0;
  }
  return make_map(&maps[4], a.d_o_lo, a.do_stride, a.b, a.t, a.h, a.d, q_rows);
}

}  // namespace

extern "C" {

// out, lse <- attention(q, k, v) for bf16 q, k, v with 16-byte aligned rows,
// d % 8 == 0, d <= 128 and scale > 0 (ops/flash.py::_route). Returns a
// cudaError_t (0: launched), or kNoEncoder / kEncodeFailed.
int bf_flash_fwd_sm90(const BfFlashArgs* args, void* stream) {
  const BfFlashArgs& a = *args;
  if (a.t <= 0 || a.b * a.h <= 0) return 0;
  CUtensorMap maps[3];
  int err = make_map(&maps[0], a.q, a.q_stride, a.b, a.t, a.h, a.d, kFwdBM);
  if (!err) err = make_map(&maps[1], a.k, a.k_stride, a.b, a.t, a.h_kv, a.d, kFwdBN);
  if (!err) err = make_map(&maps[2], a.v, a.v_stride, a.b, a.t, a.h_kv, a.d, kFwdBN);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d <= 64) {
    return a.out_f32 ? launch_fwd<64, float>(a, maps, s) : launch_fwd<64, bf16>(a, maps, s);
  }
  return a.out_f32 ? launch_fwd<128, float>(a, maps, s) : launch_fwd<128, bf16>(a, maps, s);
}

// dk, dv <- the dK/dV half of the backward, with the conditions of
// bf_flash_fwd_sm90 and a bf16 cotangent in d_o, or an f32 cotangent as
// its two bf16 halves (d_o, d_o_lo: bf_flash_split_cotangent). Returns a
// cudaError_t, or kNoEncoder / kEncodeFailed.
int bf_flash_bwd_dkv_sm90(const BfFlashArgs* args, void* stream) {
  const BfFlashArgs& a = *args;
  if (a.t <= 0 || a.b * a.h_kv <= 0) return 0;
  CUtensorMap maps[5];
  if (int err = backward_maps(maps, a, kDkvBM, kDkvBN)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d_o_lo != nullptr) {
    return a.d <= 64 ? launch_dkv<64, true>(a, maps, s) : launch_dkv<128, true>(a, maps, s);
  }
  return a.d <= 64 ? launch_dkv<64, false>(a, maps, s) : launch_dkv<128, false>(a, maps, s);
}

// dq <- the dQ half of the backward, with the operands of
// bf_flash_bwd_dkv_sm90. Returns a cudaError_t, or kNoEncoder /
// kEncodeFailed.
int bf_flash_bwd_dq_sm90(const BfFlashArgs* args, void* stream) {
  const BfFlashArgs& a = *args;
  if (a.t <= 0 || a.b * a.h <= 0) return 0;
  CUtensorMap maps[5];
  if (int err = backward_maps(maps, a, kDqBM, kDqBN)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d_o_lo != nullptr) {
    return a.d <= 64 ? launch_dq<64, true>(a, maps, s) : launch_dq<128, true>(a, maps, s);
  }
  return a.d <= 64 ? launch_dq<64, false>(a, maps, s) : launch_dq<128, false>(a, maps, s);
}

// hi, lo <- the two bf16 halves of the f32 cotangent x [b, t, h, d] (element
// strides s0, s1, s2; the last axis contiguous), both contiguous. Returns a
// cudaError_t.
int bf_flash_split_cotangent(const void* x, void* hi, void* lo, long long s0, long long s1,
                             long long s2, int b, int t, int h, int d, void* stream) {
  const long long elems = (long long)b * t * h * d;
  if (elems <= 0) return 0;
  const bool vec = d % 4 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long n = vec ? elems / 4 : elems;
  const long long blocks = (n + kSplitThreads - 1) / kSplitThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 132 * 64 ? blocks : 132 * 64));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* src = static_cast<const float*>(x);
  if (vec) {
    flash_split_cotangent<4><<<grid, kSplitThreads, 0, s>>>(
        src, static_cast<bf16*>(hi), static_cast<bf16*>(lo), s0, s1, s2, t, h, d, n);
  } else {
    flash_split_cotangent<1><<<grid, kSplitThreads, 0, s>>>(
        src, static_cast<bf16*>(hi), static_cast<bf16*>(lo), s0, s1, s2, t, h, d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
