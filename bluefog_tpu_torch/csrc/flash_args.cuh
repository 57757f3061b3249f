// Copyright 2026. Licensed under the Apache License, Version 2.0.
//
// The argument block of every flash-attention entry point, shared by
// flash_kernels.cu and flash_sm90.cu (mirrored by a ctypes Structure in
// bluefog_tpu_torch/ops/flash.py). Strides are in elements: batch,
// sequence, head.

#pragma once

extern "C" {

struct BfFlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;
  const void* d_o_lo;  // sm90 with an f32 cotangent: dO's low bf16 half, d_o
                       // its high half (both with do_stride); else null
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  const float* delta;
  const float* dlse;
  long long q_stride[3];
  long long k_stride[3];
  long long v_stride[3];
  long long do_stride[3];
  int b;
  int t;
  int h;
  int h_kv;
  int d;
  float scale;
  int causal;
  int qkv_bf16;  // q, k, v are bf16 (else f32)
  int out_f32;   // forward output f32 (else q's type)
  int do_f32;    // backward cotangent f32 (else q's type)
  int vec;       // every row of q, k, v (and dO) is 16-byte aligned, d % 8 == 0
};

}  // extern "C"
