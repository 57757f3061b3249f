// Copyright 2026. Licensed under the Apache License, Version 2.0.
//
// BatchNorm of the ResNets for Hopper (sm_90a): the training forward
// (per-channel statistics, then normalize with the residual add and the
// ReLU fused) and its backward, on channels-last activations.
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.BatchNorm to
// XLA. The kernels replace the plain PyTorch composite of
// bluefog_tpu_torch/ops/batchnorm.py (batch_norm_reference), which stays
// the CPU path and the oracle. bf_bn_forward launches the first three,
// bf_bn_backward the last three:
//   bn_stats           per-block column sums of x and x^2 into [G, 2, C]
//   bn_finish          the G partials summed in a fixed order: mean, the
//                      fast variance E[x^2] - E[x]^2 clipped at 0, rstd,
//                      and the running statistics updated in place
//   bn_apply           y = (x - mean) * (rstd * scale) + bias, rounded to
//                      the activation dtype; + residual (rounded again);
//                      ReLU (eval mode: this alone, from the running
//                      statistics)
//   bn_bwd_reduce      per-block column sums of g and g * xhat into
//                      [G, 2, C], g = dy masked by y > 0 where ReLU was
//                      fused, xhat = (x - mean) * rstd recomputed
//   bn_bwd_finish      the partials summed in a fixed order: dbias, dscale
//                      and the three per-channel coefficients of dx
//   bn_bwd_dx          dx = rstd*scale * (g - sum(g)/M - xhat *
//                      sum(g*xhat)/M), the last term dropped where the
//                      variance was clipped; and g itself as the residual's
//                      gradient
//
// Layout: an activation [N, C, H, W] in channels-last memory is a row-major
// [M, C] matrix, M = N*H*W; per-channel vectors are [C] f32. Element types:
// bf16 and f32, the arithmetic in f32.
//
// Bound: each kernel does a few f32 operations per element it moves, so all
// are bound by device-memory bytes. The design moves each activation as few
// times as two passes allow: the forward reads x twice and writes y once
// (the residual read once beside it); the backward reads dy, y and x twice
// and writes dx (and the residual's gradient) once. Nothing f32 of an
// activation's size is written: the backward recomputes xhat from x.
// Each thread owns a fixed group of channels (8 bf16 or 4 f32 with 16-byte
// loads where C and every pointer allow, else one) and walks rows, so its
// per-channel constants stay in registers and a warp reads whole rows;
// four rows are loaded before any is used. The second pass walks the rows
// in the opposite order to the first, so it starts on what L2 still holds.
// Column sums go through per-block partials and a second kernel that adds
// them in a fixed order: no atomics, so the statistics are the same bits on
// every call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// finish kernels: 32 channels a block, the partials split over 32 slices
constexpr int kFinishCols = 32;
constexpr int kFinishSlices = 32;

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements at p (16 bytes when V * sizeof(T) == 16) as f32.
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        float2 f = __bfloat1622float2(h[k]);
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = f[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f32(p[k]);
  }
}

// V f32 values rounded to T, stored at p.
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    } else {
      float* f = reinterpret_cast<float*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = v[k];
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_f32<T>(v[k]);
  }
}

// A round trip through T: the rounding of a value stored as T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The thread's place in a block of the row walk: the block's column chunk
// holds ng groups of V channels (at most kThreads), rpp rows are walked in
// parallel; inactive threads (tid >= rpp * ng) have row == -1.
struct Walk {
  int ng, rpp, g, rr, c0;
  long long row, stride;
};

template <int V>
__device__ __forceinline__ Walk walk(long long M, int C) {
  Walk w;
  const int groups = C / V;
  const int first = blockIdx.y * kThreads;
  w.ng = min(groups - first, kThreads);
  w.rpp = kThreads / w.ng;
  w.g = threadIdx.x % w.ng;
  w.rr = threadIdx.x / w.ng;
  w.c0 = (first + w.g) * V;
  w.stride = static_cast<long long>(gridDim.x) * w.rpp;
  w.row = w.rr < w.rpp ? static_cast<long long>(blockIdx.x) * w.rpp + w.rr : -1;
  if (w.row >= M) w.row = -1;
  return w;
}

// The elementwise kernels walk the rows from the top down: the reducing
// pass before them walked up, so the rows it read last, still in L2, are
// the first they read again.
__device__ __forceinline__ long long top_down(long long row, long long M) {
  return M - 1 - row;
}

// Column sums of the block, written to partial[blockIdx.x, 0:2, c0:c0+V]:
// a[] and b[] of every thread of a column group added over its rows in a
// fixed tree through shared memory.
template <int V>
__device__ __forceinline__ void block_column_sums(const Walk& w, const float (&a)[V],
                                                  const float (&b)[V], float* partial,
                                                  int C) {
  __shared__ float red[2 * V * kThreads];
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[k * kThreads + t] = a[k];
    red[(V + k) * kThreads + t] = b[k];
  }
  __syncthreads();
  int span = 1;
  while (span < w.rpp) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (w.rr < s && w.rr + s < w.rpp) {
      const int o = t + s * w.ng;
#pragma unroll
      for (int k = 0; k < 2 * V; ++k) red[k * kThreads + t] += red[k * kThreads + o];
    }
    __syncthreads();
  }
  if (w.rr == 0) {
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * C + w.c0;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[k] = red[k * kThreads + t];
      out[C + k] = red[(V + k) * kThreads + t];
    }
  }
}

// Forward statistics: per block, the column sums of x and x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, long long M,
                    int C) {
  const Walk w = walk<V>(M, C);
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
  if (w.row >= 0) {
    long long row = w.row;
    for (; row + (kUnroll - 1) * w.stride < M; row += kUnroll * w.stride) {
      float v[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load<T, V>(x + (row + u * w.stride) * C + w.c0, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += v[u][k];
          q[k] += v[u][k] * v[u][k];
        }
      }
    }
    for (; row < M; row += w.stride) {
      float v[V];
      load<T, V>(x + row * C + w.c0, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] += v[k];
        q[k] += v[k] * v[k];
      }
    }
  }
  block_column_sums<V>(w, s, q, partial, C);
}

// g (dy masked by y > 0 where the ReLU was fused) and x at element offset i.
template <typename T, int V, bool RELU>
__device__ __forceinline__ void load_grad(const T* __restrict__ dy, const T* __restrict__ y,
                                          const T* __restrict__ x, long long i, float (&g)[V],
                                          float (&xv)[V]) {
  load<T, V>(dy + i, g);
  load<T, V>(x + i, xv);
  if constexpr (RELU) {
    float yv[V];
    load<T, V>(y + i, yv);
#pragma unroll
    for (int k = 0; k < V; ++k) g[k] = yv[k] > 0.f ? g[k] : 0.f;
  }
}

// Backward statistics: per block, the column sums of g and g * xhat.
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                         const T* __restrict__ x, const float* __restrict__ mean,
                         const float* __restrict__ rstd, float* __restrict__ partial,
                         long long M, int C) {
  const Walk w = walk<V>(M, C);
  float sg[V], sgx[V], mu[V], rs[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sg[k] = sgx[k] = 0.f;
    mu[k] = mean[w.c0 + k];
    rs[k] = rstd[w.c0 + k];
  }
  if (w.row >= 0) {
    long long row = w.row;
    for (; row + (kUnroll - 1) * w.stride < M; row += kUnroll * w.stride) {
      float g[kUnroll][V], xv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_grad<T, V, RELU>(dy, y, x, (row + u * w.stride) * C + w.c0, g[u], xv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sg[k] += g[u][k];
          sgx[k] += g[u][k] * ((xv[u][k] - mu[k]) * rs[k]);
        }
      }
    }
    for (; row < M; row += w.stride) {
      float g[V], xv[V];
      load_grad<T, V, RELU>(dy, y, x, row * C + w.c0, g, xv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sg[k] += g[k];
        sgx[k] += g[k] * ((xv[k] - mu[k]) * rs[k]);
      }
    }
  }
  block_column_sums<V>(w, sg, sgx, partial, C);
}

// Sums of the G partials of one channel pair (a at [g, 0, c], b at [g, 1,
// c]) in a fixed order; valid in threadIdx.y == 0.
__device__ __forceinline__ void finish_sums(const float* __restrict__ partial, int C, int G,
                                            int c, float& a, float& b) {
  __shared__ float sa[kFinishSlices][kFinishCols + 1];
  __shared__ float sb[kFinishSlices][kFinishCols + 1];
  a = 0.f;
  b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int g = threadIdx.y; g < G; g += kFinishSlices) {
      a += partial[static_cast<long long>(g) * 2 * C + c];
      b += partial[static_cast<long long>(g) * 2 * C + C + c];
    }
  }
  sa[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  for (int s = kFinishSlices / 2; s > 0; s >>= 1) {
    if (threadIdx.y < s) {
      sa[threadIdx.y][threadIdx.x] += sa[threadIdx.y + s][threadIdx.x];
      sb[threadIdx.y][threadIdx.x] += sb[threadIdx.y + s][threadIdx.x];
    }
    __syncthreads();
  }
  a = sa[0][threadIdx.x];
  b = sb[0][threadIdx.x];
}

// stats [3, C]: mean, rstd, and 1 where the variance term of the backward
// stands (E[x^2] - E[x]^2 >= 0: torch.clamp passes its gradient there),
// else 0. The running statistics (if given) become keep * running + take
// * batch, each product rounded, then the sum.
__global__ void __launch_bounds__(kFinishCols * kFinishSlices)
    bn_finish_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                     float* running_mean, float* running_var, long long M, int C, int G,
                     float eps, float keep, float take) {
  const int c = blockIdx.x * kFinishCols + threadIdx.x;
  float s, q;
  finish_sums(partial, C, G, c, s, q);
  if (threadIdx.y != 0 || c >= C) return;
  const float n = static_cast<float>(M);
  const float mean = __fdiv_rn(s, n);
  const float mean2 = __fdiv_rn(q, n);
  const float raw = __fsub_rn(mean2, __fmul_rn(mean, mean));
  const float var = fmaxf(raw, 0.f);
  stats[c] = mean;
  stats[C + c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  stats[2 * C + c] = raw >= 0.f ? 1.f : 0.f;
  if (running_mean != nullptr) {
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(take, mean));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]), __fmul_rn(take, var));
  }
}

// coef [3, C]: k1 = rstd * scale, k2 = sum(g) * (1/M), k3 = sum(g * xhat) *
// (1/M), 1/M rounded to f32 first (k2 and k3 are 0 without batch
// statistics, k3 where the variance was clipped); dbias = sum(g), dscale =
// sum(g * xhat).
__global__ void __launch_bounds__(kFinishCols * kFinishSlices)
    bn_bwd_finish_kernel(const float* __restrict__ partial, const float* __restrict__ stats,
                         const float* __restrict__ scale, float* __restrict__ dscale,
                         float* __restrict__ dbias, float* __restrict__ coef, long long M,
                         int C, int G, int batch_stats) {
  const int c = blockIdx.x * kFinishCols + threadIdx.x;
  float sg, sgx;
  finish_sums(partial, C, G, c, sg, sgx);
  if (threadIdx.y != 0 || c >= C) return;
  const float inv_n = __frcp_rn(static_cast<float>(M));
  dbias[c] = sg;
  dscale[c] = sgx;
  coef[c] = __fmul_rn(stats[C + c], scale[c]);
  coef[C + c] = batch_stats ? __fmul_rn(sg, inv_n) : 0.f;
  coef[2 * C + c] = batch_stats && stats[2 * C + c] != 0.f ? __fmul_rn(sgx, inv_n) : 0.f;
}

// y = (x - mean) * (rstd * scale) + bias, rounded to T; + residual, rounded
// again; ReLU. Without batch statistics inv is the running variance and
// rstd = 1 / sqrt(var + eps).
template <typename T, int V, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    long long M, int C, int inv_is_var, float eps) {
  const Walk w = walk<V>(M, C);
  if (w.row < 0) return;
  float mu[V], mul[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = w.c0 + k;
    const float r = inv_is_var ? __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(inv[c], eps))) : inv[c];
    mu[k] = mean[c];
    mul[k] = __fmul_rn(r, scale[c]);
    b[k] = bias[c];
  }
  auto out = [&](const float (&v)[V], const float (&rv)[V], long long i) {
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = __fadd_rn(__fmul_rn(__fsub_rn(v[k], mu[k]), mul[k]), b[k]);
      if constexpr (RES) t = __fadd_rn(round_to<T>(t), rv[k]);
      if constexpr (RELU) t = t < 0.f ? 0.f : t;
      o[k] = t;
    }
    store<T, V>(y + i, o);
  };
  long long row = w.row;
  for (; row + (kUnroll - 1) * w.stride < M; row += kUnroll * w.stride) {
    float v[kUnroll][V], rv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = top_down(row + u * w.stride, M) * C + w.c0;
      load<T, V>(x + i, v[u]);
      if constexpr (RES) load<T, V>(res + i, rv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      out(v[u], rv[u], top_down(row + u * w.stride, M) * C + w.c0);
    }
  }
  for (; row < M; row += w.stride) {
    const long long i = top_down(row, M) * C + w.c0;
    float v[V], rv[V];
    load<T, V>(x + i, v);
    if constexpr (RES) load<T, V>(res + i, rv);
    out(v, rv, i);
  }
}

// dx = k1 * (g - k2 - xhat * k3), rounded to T; dres = g.
template <typename T, int V, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                     const T* __restrict__ x, const float* __restrict__ stats,
                     const float* __restrict__ coef, T* __restrict__ dx, T* __restrict__ dres,
                     long long M, int C) {
  const Walk w = walk<V>(M, C);
  if (w.row < 0) return;
  float mu[V], rs[V], k1[V], k2[V], k3[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = w.c0 + k;
    mu[k] = stats[c];
    rs[k] = stats[C + c];
    k1[k] = coef[c];
    k2[k] = coef[C + c];
    k3[k] = coef[2 * C + c];
  }
  auto out = [&](const float (&g)[V], const float (&xv)[V], long long i) {
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = __fmul_rn(__fsub_rn(xv[k], mu[k]), rs[k]);
      o[k] = __fmul_rn(k1[k], __fsub_rn(__fsub_rn(g[k], k2[k]), __fmul_rn(xh, k3[k])));
    }
    store<T, V>(dx + i, o);
    if constexpr (RES) store<T, V>(dres + i, g);
  };
  long long row = w.row;
  for (; row + (kUnroll - 1) * w.stride < M; row += kUnroll * w.stride) {
    float g[kUnroll][V], xv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_grad<T, V, RELU>(dy, y, x, top_down(row + u * w.stride, M) * C + w.c0, g[u], xv[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      out(g[u], xv[u], top_down(row + u * w.stride, M) * C + w.c0);
    }
  }
  for (; row < M; row += w.stride) {
    const long long i = top_down(row, M) * C + w.c0;
    float g[V], xv[V];
    load_grad<T, V, RELU>(dy, y, x, i, g, xv);
    out(g, xv, i);
  }
}

dim3 row_grid(int G, int C, int V) {
  const int groups = C / V;
  return dim3(static_cast<unsigned>(G), static_cast<unsigned>((groups + kThreads - 1) / kThreads));
}

const dim3 kFinishBlock(kFinishCols, kFinishSlices);

dim3 finish_grid(int C) {
  return dim3(static_cast<unsigned>((C + kFinishCols - 1) / kFinishCols));
}

struct FwdArgs {
  const void* x;
  const void* res;
  void* y;
  float* partial;
  float* stats;
  float* running_mean;
  float* running_var;
  const float* scale;
  const float* bias;
  long long M;
  int C, g_reduce, g_elementwise, training;
  float eps, keep, take;
  int relu;
};

struct BwdArgs {
  const void* dy;
  const void* y;
  const void* x;
  const float* stats;
  const float* scale;
  float* partial;
  float* coef;
  float* dscale;
  float* dbias;
  void* dx;
  void* dres;
  long long M;
  int C, g_reduce, g_elementwise, batch_stats;
};

template <typename T, int V, bool RES, bool RELU>
void apply(const FwdArgs& a, const float* mean, const float* inv, cudaStream_t st) {
  bn_apply_kernel<T, V, RES, RELU><<<row_grid(a.g_elementwise, a.C, V), kThreads, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.res), static_cast<T*>(a.y), mean,
      inv, a.scale, a.bias, a.M, a.C, !a.training, a.eps);
}

// Training: stats, finish, apply; eval: apply from the running statistics.
template <typename T, int V>
void forward(const FwdArgs& a, cudaStream_t st) {
  const float* mean = a.running_mean;
  const float* inv = a.running_var;
  if (a.training) {
    bn_stats_kernel<T, V><<<row_grid(a.g_reduce, a.C, V), kThreads, 0, st>>>(
        static_cast<const T*>(a.x), a.partial, a.M, a.C);
    bn_finish_kernel<<<finish_grid(a.C), kFinishBlock, 0, st>>>(
        a.partial, a.stats, a.running_mean, a.running_var, a.M, a.C, a.g_reduce, a.eps, a.keep,
        a.take);
    mean = a.stats;
    inv = a.stats + a.C;
  }
  if (a.res != nullptr) {
    if (a.relu) apply<T, V, true, true>(a, mean, inv, st);
    else apply<T, V, true, false>(a, mean, inv, st);
  } else {
    if (a.relu) apply<T, V, false, true>(a, mean, inv, st);
    else apply<T, V, false, false>(a, mean, inv, st);
  }
}

template <typename T, int V, bool RELU, bool RES>
void dx(const BwdArgs& a, cudaStream_t st) {
  bn_bwd_dx_kernel<T, V, RELU, RES><<<row_grid(a.g_elementwise, a.C, V), kThreads, 0, st>>>(
      static_cast<const T*>(a.dy), static_cast<const T*>(a.y), static_cast<const T*>(a.x),
      a.stats, a.coef, static_cast<T*>(a.dx), static_cast<T*>(a.dres), a.M, a.C);
}

// bwd_reduce, bwd_finish, bwd_dx.
template <typename T, int V>
void backward(const BwdArgs& a, cudaStream_t st) {
  const dim3 grid = row_grid(a.g_reduce, a.C, V);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  const T* x = static_cast<const T*>(a.x);
  if (y != nullptr) {
    bn_bwd_reduce_kernel<T, V, true><<<grid, kThreads, 0, st>>>(dy, y, x, a.stats,
                                                                a.stats + a.C, a.partial, a.M,
                                                                a.C);
  } else {
    bn_bwd_reduce_kernel<T, V, false><<<grid, kThreads, 0, st>>>(dy, y, x, a.stats,
                                                                 a.stats + a.C, a.partial, a.M,
                                                                 a.C);
  }
  bn_bwd_finish_kernel<<<finish_grid(a.C), kFinishBlock, 0, st>>>(
      a.partial, a.stats, a.scale, a.dscale, a.dbias, a.coef, a.M, a.C, a.g_reduce,
      a.batch_stats);
  if (y != nullptr) {
    if (a.dres != nullptr) dx<T, V, true, true>(a, st);
    else dx<T, V, true, false>(a, st);
  } else {
    if (a.dres != nullptr) dx<T, V, false, true>(a, st);
    else dx<T, V, false, false>(a, st);
  }
}

// The element type (0 f32, 1 bf16) and the vector width: vec != 0 takes
// 16-byte accesses (8 bf16 or 4 f32 a thread), else one element a thread.
template <template <typename, int> class Pass, typename A>
void by_type(int dtype, int vec, const A& a, cudaStream_t st) {
  if (dtype == kBF16) {
    if (vec) Pass<__nv_bfloat16, 8>::run(a, st);
    else Pass<__nv_bfloat16, 1>::run(a, st);
  } else {
    if (vec) Pass<float, 4>::run(a, st);
    else Pass<float, 1>::run(a, st);
  }
}

template <typename T, int V>
struct Forward {
  static void run(const FwdArgs& a, cudaStream_t st) { forward<T, V>(a, st); }
};

template <typename T, int V>
struct Backward {
  static void run(const BwdArgs& a, cudaStream_t st) { backward<T, V>(a, st); }
};

}  // namespace

extern "C" {

// Activations are [M, C] row-major of element type dtype (0 f32, 1 bf16);
// vec: 16-byte accesses (C a multiple of 8 bf16 or 4 f32, every activation
// pointer on 16 bytes). g_reduce and g_elementwise are the blocks along the
// rows of the reducing and the elementwise kernels (partial is [g_reduce,
// 2, C] f32). Each returns cudaGetLastError().

// y <- (x - mean) * (rstd * scale) + bias (+ res, may be null; ReLU if
// relu). Training: stats [3, C] <- mean, rstd, variance-term flag, the
// running statistics updated in place as keep * running + take * batch.
// Eval (training 0): mean and rstd from the running statistics.
int bf_bn_forward(const void* x, const void* res, void* y, float* partial, float* stats,
                  float* running_mean, float* running_var, const float* scale,
                  const float* bias, long long M, int C, int g_reduce, int g_elementwise,
                  int training, float eps, float keep, float take, int relu, int dtype, int vec,
                  void* stream) {
  if (M > 0 && C > 0) {
    const FwdArgs a{x, res, y, partial, stats, running_mean, running_var, scale, bias, M, C,
                    g_reduce, g_elementwise, training, eps, keep, take, relu};
    by_type<Forward>(dtype, vec, a, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// dx <- the input's gradient and dres (may be null) <- g, from dy, the
// fused ReLU's output y (null: no mask), x and stats; dscale, dbias [C]
// and coef [3, C] f32 beside them.
int bf_bn_backward(const void* dy, const void* y, const void* x, const float* stats,
                   const float* scale, float* partial, float* coef, float* dscale, float* dbias,
                   void* dx, void* dres, long long M, int C, int g_reduce, int g_elementwise,
                   int batch_stats, int dtype, int vec, void* stream) {
  if (M > 0 && C > 0) {
    const BwdArgs a{dy, y, x, stats, scale, partial, coef, dscale, dbias, dx, dres, M, C,
                    g_reduce, g_elementwise, batch_stats};
    by_type<Backward>(dtype, vec, a, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
