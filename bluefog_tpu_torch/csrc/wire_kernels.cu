// Copyright 2026. Licensed under the Apache License, Version 2.0.
//
// Block-scaled quantized gossip wire for Hopper (sm_90a): encode,
// encode_diff, decode, decode_add and decode_accumulate.
//
// Replaces the Pallas kernels of bluefog_tpu/collective/kernels.py:
//   bf_wire_encode             <- encode            (_encode8_body / _encode4_body)
//   bf_wire_encode_diff        <- encode_diff       (_encode_diff8_body / _encode_diff4_body)
//   bf_wire_decode             <- decode            (_make_decode_body)
//   bf_wire_decode_add         <- decode_add        (_make_decode_add_body)
//   bf_wire_decode_accumulate  <- decode_accumulate (_make_dacc_body)
//
// Layout: N workers stacked on the leading axis; each worker's flat f32
// payload is cut into C blocks of 512 elements with one scale per block.
// int8 wire: payload [N, C, 512] int8, scales [N, C] f32.
// int4 wire: payload [N, C, 256] int8 (element k in the low nibble of lane
// k, element 256 + k in the high nibble), scales [N, C] bf16.
//
// Bits are pinned to the JAX programs' arithmetic: the block scale as a
// multiply by the f32 reciprocal of 127 or 7 (see kRecip127), the quantize
// as an IEEE divide (__fdiv_rn), round half to even (__float2int_rn), the
// int4 scale snapped to bf16 before it divides (__float2bfloat16_rn), zero
// guard fmaxf(absmax, FLT_MIN), and no FMA contraction (explicit __fmul_rn
// / __fadd_rn / __fsub_rn, and the file is built with -fmad=false).
// Subnormals are kept (no -ftz), as numpy keeps them.
//
// The error-feedback (CHOCO) copies rest on one invariant: the sender's
// copy h + q*s (encode_diff) and every receiver's copy base + q*s
// (decode_add) are the same two roundings, a multiply then an add, of the
// same q and s, so they stay bit-identical however many steps they run.
//
// Bound: every kernel moves a few bytes per element and does a handful of
// f32 operations on each, so all are bound by device memory bandwidth.
// Design: one warp per (worker, block); each lane owns 16 elements, read
// and written with 16-byte (int8 wire) or 8-byte (int4 wire) accesses so a
// warp touches contiguous 2 KiB of f32 and 512/256 B of payload. The block
// absmax is a warp shuffle reduction; nothing goes through shared memory.
// decode, which only stores f32, has its own mapping (four blocks per warp,
// each warp store one contiguous 512-byte run; see decode_kernel).
// A round's sender row src[j] is read straight from the senders' payload:
// the stacked ppermute is fused into the gather, and src[j] == -1 delivers
// a zero payload with a zero scale, as ppermute does. decode_accumulate
// keeps the accumulator in registers across all rounds and writes it
// once. TMA copies and deeper pipelining are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 512;
constexpr int kHalf = 256;
constexpr int kPerLane = 16;
constexpr int kWarpsPerBlock = 8;
// The JAX programs compute the block scale max(absmax, tiny) / 127 (or / 7)
// as a multiply by the f32 reciprocal: XLA rewrites a division by a
// constant that way. These are those reciprocals, bit for bit.
constexpr float kRecip127 = 0x1.020408p-7f;  // 0x3c010204
constexpr float kRecip7 = 0x1.24924ap-3f;    // 0x3e124925

__device__ __forceinline__ float warp_absmax(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ int quantize(float x, float s, int lim) {
  int q = __float2int_rn(__fdiv_rn(x, s));
  return q < -lim ? -lim : (q > lim ? lim : q);
}

// Element offsets (within the 512-element block) of a lane's 16 values:
// int8 wire: 16*lane .. 16*lane+15; int4 wire: 8*lane .. +7 (low nibbles)
// then 256 + 8*lane .. +7 (high nibbles).
template <bool PACKED>
__device__ __forceinline__ void load_block(const float* base, int lane,
                                           float (&v)[kPerLane]) {
  if (PACKED) {
    const float4* lo = reinterpret_cast<const float4*>(base + 8 * lane);
    const float4* hi = reinterpret_cast<const float4*>(base + kHalf + 8 * lane);
    float4 a = lo[0], b = lo[1], c = hi[0], d = hi[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
    v[12] = d.x; v[13] = d.y; v[14] = d.z; v[15] = d.w;
  } else {
    const float4* p = reinterpret_cast<const float4*>(base + kPerLane * lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float4 a = p[k];
      v[4 * k] = a.x; v[4 * k + 1] = a.y; v[4 * k + 2] = a.z; v[4 * k + 3] = a.w;
    }
  }
}

template <bool PACKED>
__device__ __forceinline__ void store_block(float* base, int lane,
                                            const float (&v)[kPerLane]) {
  if (PACKED) {
    float4* lo = reinterpret_cast<float4*>(base + 8 * lane);
    float4* hi = reinterpret_cast<float4*>(base + kHalf + 8 * lane);
    lo[0] = make_float4(v[0], v[1], v[2], v[3]);
    lo[1] = make_float4(v[4], v[5], v[6], v[7]);
    hi[0] = make_float4(v[8], v[9], v[10], v[11]);
    hi[1] = make_float4(v[12], v[13], v[14], v[15]);
  } else {
    float4* p = reinterpret_cast<float4*>(base + kPerLane * lane);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  }
}

// Decode a lane's 16 values of one block into q (integers in [-127, 127]
// or [-8, 7]). int4: byte b holds element k (low nibble, sign-extended as
// ((b & 15) ^ 8) - 8) and element 256 + k (high nibble, b >> 4 arithmetic).
template <bool PACKED>
__device__ __forceinline__ void load_q(const int8_t* row, int lane,
                                       int (&q)[kPerLane]) {
  if (PACKED) {
    uint2 raw = *reinterpret_cast<const uint2*>(row + 8 * lane);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int byte = b[k];
      q[k] = ((byte & 15) ^ 8) - 8;
      q[8 + k] = byte >> 4;
    }
  } else {
    uint4 raw = *reinterpret_cast<const uint4*>(row + kPerLane * lane);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) q[k] = b[k];
  }
}

template <bool PACKED>
__device__ __forceinline__ float load_scale(const void* scales, long long i) {
  if (PACKED) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(scales)[i]);
  }
  return static_cast<const float*>(scales)[i];
}

// Block g of a round's receive: the payload integers and the scale of
// sender row i (i < 0: the zero payload and zero scale ppermute delivers).
template <bool PACKED>
__device__ __forceinline__ float load_sender(const int8_t* payload,
                                             const void* scales, int i,
                                             long long n_chunks, long long c,
                                             int lane, int (&q)[kPerLane]) {
  if (i < 0) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) q[k] = 0;
    return 0.0f;
  }
  const long long gi = (long long)i * n_chunks + c;
  load_q<PACKED>(payload + gi * (PACKED ? kHalf : kChunk), lane, q);
  return load_scale<PACKED>(scales, gi);
}

// Quantize block g, whose lane values are v: the block absmax is a warp
// reduction; writes the lane's payload bytes and (lane 0) the wire scale.
// Returns the scale the payload was divided by (the int4 one snapped to
// bf16) and the lane's integers in q, as the copies integrate them.
template <bool PACKED>
__device__ __forceinline__ float quantize_block(const float (&v)[kPerLane],
                                                int lane, long long g,
                                                int8_t* payload, void* scales,
                                                int (&q)[kPerLane]) {
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) amax = fmaxf(amax, fabsf(v[k]));
  amax = warp_absmax(amax);
  const float s = __fmul_rn(fmaxf(amax, FLT_MIN), PACKED ? kRecip7 : kRecip127);

  if (PACKED) {
    const __nv_bfloat16 s16 = __float2bfloat16_rn(s);
    const float sw = __bfloat162float(s16);
    uint2 out;
    int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      q[k] = quantize(v[k], sw, 7);
      q[8 + k] = quantize(v[8 + k], sw, 7);
      b[k] = static_cast<int8_t>(
          static_cast<uint8_t>((q[k] & 15) | ((q[8 + k] & 15) << 4)));
    }
    *reinterpret_cast<uint2*>(payload + g * kHalf + 8 * lane) = out;
    if (lane == 0) static_cast<__nv_bfloat16*>(scales)[g] = s16;
    return sw;
  }
  uint4 out;
  int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    q[k] = quantize(v[k], s, 127);
    b[k] = static_cast<int8_t>(q[k]);
  }
  *reinterpret_cast<uint4*>(payload + g * kChunk + kPerLane * lane) = out;
  if (lane == 0) static_cast<float*>(scales)[g] = s;
  return s;
}

template <bool PACKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
encode_kernel(const float* __restrict__ x, int8_t* __restrict__ payload,
              void* __restrict__ scales, long long n_blocks) {
  const long long g =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n_blocks) return;

  float v[kPerLane];
  int q[kPerLane];
  load_block<PACKED>(x + g * kChunk, lane, v);
  quantize_block<PACKED>(v, lane, g, payload, scales, q);
}

// The CHOCO sender: quantize d = x - h, and integrate the shipped q into
// the sender's public copy, h <- h + q * s, in place.
template <bool PACKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
encode_diff_kernel(const float* __restrict__ x, float* __restrict__ h,
                   int8_t* __restrict__ payload, void* __restrict__ scales,
                   long long n_blocks) {
  const long long g =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n_blocks) return;

  float d[kPerLane], hv[kPerLane];
  int q[kPerLane];
  load_block<PACKED>(x + g * kChunk, lane, d);
  load_block<PACKED>(h + g * kChunk, lane, hv);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) d[k] = __fsub_rn(d[k], hv[k]);
  const float sw = quantize_block<PACKED>(d, lane, g, payload, scales, q);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    hv[k] = __fadd_rn(hv[k], __fmul_rn(static_cast<float>(q[k]), sw));
  }
  store_block<PACKED>(h + g * kChunk, lane, hv);
}

// decode has a lane mapping of its own, since its time is its stores (4
// bytes written per element, 1 or 1/2 read): every warp-wide float4 store
// writes one contiguous 512-byte run. int8 wire: lane l holds elements 4l +
// 128k .. +3 (k = 0..3), from the payload bytes at the same offsets. int4
// wire: lane l reads bytes 4l .. +3 and 128 + 4l .. +3; their low nibbles
// are elements 4l.. and 128 + 4l.., their high nibbles 256 + 4l.. and 384 +
// 4l... A warp takes kDecodeBlocks blocks at a time and issues all their
// loads before their stores.
constexpr int kDecodeBlocks = 4;

// Lane `lane`'s payload words of block c of sender row i (i < 0: zeros and
// a zero scale): int8, the words at bytes 4 lane + 128 k; int4, k = 0, 1.
template <bool PACKED>
__device__ __forceinline__ float load_words(const int8_t* payload, const void* scales,
                                            int i, long long n_chunks, long long c,
                                            int lane, uint32_t (&w)[4]) {
  if (i < 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = 0u;
    return 0.0f;
  }
  const long long gi = (long long)i * n_chunks + c;
  const uint32_t* p =
      reinterpret_cast<const uint32_t*>(payload + gi * (PACKED ? kHalf : kChunk)) + lane;
#pragma unroll
  for (int k = 0; k < (PACKED ? 2 : 4); ++k) w[k] = p[32 * k];
  return load_scale<PACKED>(scales, gi);
}

// Stores q * s of a lane's words into its four float4 slots of a block,
// elements 4 lane + 128 k (int4: word k & 1, high nibbles for k >= 2;
// sign-extended as load_q does).
template <bool PACKED>
__device__ __forceinline__ void store_words(float* out, int lane, const uint32_t (&w)[4],
                                            float s) {
  float4* o = reinterpret_cast<float4*>(out) + lane;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t word = w[PACKED ? (k & 1) : k];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int byte = static_cast<int8_t>(word >> (8 * e));
      const int q = !PACKED ? byte : (k < 2 ? ((byte & 15) ^ 8) - 8 : byte >> 4);
      v[e] = __fmul_rn(static_cast<float>(q), s);
    }
    o[32 * k] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// out[j] = deq(payload[src[j]]) (src == nullptr: src[j] = j); a grid-stride
// loop over groups of kDecodeBlocks blocks per warp.
template <bool PACKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_kernel(float* __restrict__ out, const int8_t* __restrict__ payload,
              const void* __restrict__ scales, const int32_t* __restrict__ src,
              int n_workers, long long n_chunks) {
  const long long n_blocks = (long long)n_workers * n_chunks;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock * kDecodeBlocks;
  const int lane = threadIdx.x & 31;
  for (long long g0 = ((long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) *
                      kDecodeBlocks;
       g0 < n_blocks; g0 += stride) {
    uint32_t w[kDecodeBlocks][4];
    float s[kDecodeBlocks];
#pragma unroll
    for (int u = 0; u < kDecodeBlocks; ++u) {
      const long long g = g0 + u;
      if (g < n_blocks) {
        const int j = static_cast<int>(g / n_chunks);
        s[u] = load_words<PACKED>(payload, scales, src ? src[j] : j, n_chunks,
                                  g - (long long)j * n_chunks, lane, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDecodeBlocks; ++u) {
      if (g0 + u < n_blocks) store_words<PACKED>(out + (g0 + u) * kChunk, lane, w[u], s[u]);
    }
  }
}

// base[j] += deq(payload[src[j]]) in place. A missing sender adds the
// zero payload (+0.0), as XLA adds what ppermute delivers: a -0.0 in base
// becomes +0.0, so the row is not skipped.
template <bool PACKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_add_kernel(float* __restrict__ base, const int8_t* __restrict__ payload,
                  const void* __restrict__ scales,
                  const int32_t* __restrict__ src, int n_workers,
                  long long n_chunks) {
  const long long g =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= (long long)n_workers * n_chunks) return;
  const int j = static_cast<int>(g / n_chunks);
  const long long c = g - (long long)j * n_chunks;

  int q[kPerLane];
  const float s = load_sender<PACKED>(payload, scales, src[j], n_chunks, c, lane, q);
  float b[kPerLane];
  load_block<PACKED>(base + g * kChunk, lane, b);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    b[k] = __fadd_rn(b[k], __fmul_rn(static_cast<float>(q[k]), s));
  }
  store_block<PACKED>(base + g * kChunk, lane, b);
}

template <bool PACKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
decode_accumulate_kernel(float* __restrict__ acc,
                         const int8_t* __restrict__ payload,
                         const void* __restrict__ scales,
                         const int32_t* __restrict__ src,
                         const float* __restrict__ w, int n_workers,
                         long long n_chunks, int n_rounds) {
  const long long g =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= (long long)n_workers * n_chunks) return;
  const int j = static_cast<int>(g / n_chunks);
  const long long c = g - (long long)j * n_chunks;

  float a[kPerLane];
  load_block<PACKED>(acc + g * kChunk, lane, a);

  // x_hat_self, decoded again from this worker's own payload: the same
  // bits every receiver reconstructs.
  int q[kPerLane];
  float deq_s[kPerLane];
  const float s_self = load_sender<PACKED>(payload, scales, j, n_chunks, c, lane, q);
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    deq_s[k] = __fmul_rn(static_cast<float>(q[k]), s_self);
  }

  for (int r = 0; r < n_rounds; ++r) {
    const float wr = w[r * n_workers + j];
    const float s_r = load_sender<PACKED>(payload, scales, src[r * n_workers + j],
                                          n_chunks, c, lane, q);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const float deq_r = __fmul_rn(static_cast<float>(q[k]), s_r);
      a[k] = __fadd_rn(a[k], __fmul_rn(__fsub_rn(deq_r, deq_s[k]), wr));
    }
  }
  store_block<PACKED>(acc + g * kChunk, lane, a);
}

unsigned grid_for(long long warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// x [n_blocks * 512] f32 -> payload, scales. Returns cudaGetLastError().
int bf_wire_encode(const float* x, int8_t* payload, void* scales,
                   long long n_blocks, int packed, void* stream) {
  if (n_blocks > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed) {
      encode_kernel<true><<<grid_for(n_blocks), kWarpsPerBlock * 32, 0, st>>>(
          x, payload, scales, n_blocks);
    } else {
      encode_kernel<false><<<grid_for(n_blocks), kWarpsPerBlock * 32, 0, st>>>(
          x, payload, scales, n_blocks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// x, h [n_blocks * 512] f32 -> payload, scales of Q(x - h); h += deq(q) in
// place. Returns cudaGetLastError().
int bf_wire_encode_diff(const float* x, float* h, int8_t* payload,
                        void* scales, long long n_blocks, int packed,
                        void* stream) {
  if (n_blocks > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed) {
      encode_diff_kernel<true>
          <<<grid_for(n_blocks), kWarpsPerBlock * 32, 0, st>>>(
              x, h, payload, scales, n_blocks);
    } else {
      encode_diff_kernel<false>
          <<<grid_for(n_blocks), kWarpsPerBlock * 32, 0, st>>>(
              x, h, payload, scales, n_blocks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out [n_workers, n_chunks * 512] f32 <- deq of sender row src[j] (src may
// be null: every row decodes its own). Returns cudaGetLastError().
int bf_wire_decode(float* out, const int8_t* payload, const void* scales,
                   const int32_t* src, int n_workers, long long n_chunks,
                   int packed, void* stream) {
  const long long warps =
      ((long long)n_workers * n_chunks + kDecodeBlocks - 1) / kDecodeBlocks;
  if (warps > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed) {
      decode_kernel<true><<<grid_for(warps), kWarpsPerBlock * 32, 0, st>>>(
          out, payload, scales, src, n_workers, n_chunks);
    } else {
      decode_kernel<false><<<grid_for(warps), kWarpsPerBlock * 32, 0, st>>>(
          out, payload, scales, src, n_workers, n_chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// base [n_workers, n_chunks * 512] f32 += deq of sender row src[j], in
// place. Returns cudaGetLastError().
int bf_wire_decode_add(float* base, const int8_t* payload, const void* scales,
                       const int32_t* src, int n_workers, long long n_chunks,
                       int packed, void* stream) {
  const long long warps = (long long)n_workers * n_chunks;
  if (warps > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed) {
      decode_add_kernel<true><<<grid_for(warps), kWarpsPerBlock * 32, 0, st>>>(
          base, payload, scales, src, n_workers, n_chunks);
    } else {
      decode_add_kernel<false><<<grid_for(warps), kWarpsPerBlock * 32, 0, st>>>(
          base, payload, scales, src, n_workers, n_chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// acc [n_workers, n_chunks * 512] f32 updated in place from the payload of
// all workers; src/w are [n_rounds, n_workers]. Returns cudaGetLastError().
int bf_wire_decode_accumulate(float* acc, const int8_t* payload,
                              const void* scales, const int32_t* src,
                              const float* w, int n_workers,
                              long long n_chunks, int n_rounds, int packed,
                              void* stream) {
  const long long warps = (long long)n_workers * n_chunks;
  if (warps > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (packed) {
      decode_accumulate_kernel<true>
          <<<grid_for(warps), kWarpsPerBlock * 32, 0, st>>>(
              acc, payload, scales, src, w, n_workers, n_chunks, n_rounds);
    } else {
      decode_accumulate_kernel<false>
          <<<grid_for(warps), kWarpsPerBlock * 32, 0, st>>>(
              acc, payload, scales, src, w, n_workers, n_chunks, n_rounds);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
