// One warp streams one token's V logits once: the online sums shared by
// K1 (ce_score.cu) and K4 (ce_score_block.cu).
//
// For logits z (V,) with unit stride and label y it gives
//     ce = lse(z) - z_y
//     g2 = max(exp(lse(2z) - 2 lse(z)) - 2 exp(z_y - lse(z)) + 1, 0)
// with z_y = 0 when y lies outside [0, V), as the TPU kernels' label
// gather (no column matches) gives. The stream is bytes-bound; the design:
//   * 16-byte vector loads (8 bf16 or 4 f32 a lane), kUnroll loads in
//     flight per lane, an unaligned scalar head and tail (no padding copy);
//   * ONE exp per element: with m the running max of z, exp(2z - 2m) is
//     exp(z - m)^2, so the online sums of exp(z) and exp(2z) share it;
//   * z_y is one direct load by lane 0, not a gather over the stream;
//   * a fixed butterfly reduce, so the result does not depend on timing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ce_stream {

constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 8;

struct Acc {
  float m;   // running max of z
  float s1;  // sum exp(z - m)
  float s2;  // sum exp(2z - 2m)
};

__device__ __forceinline__ void fold(Acc& a, const float* v, int n) {
  float mx = v[0];
#pragma unroll
  for (int i = 1; i < 8; ++i)
    if (i < n) mx = fmaxf(mx, v[i]);
  if (mx > a.m) {
    const float f = __expf(a.m - mx);  // a.m == -inf gives 0
    a.s1 *= f;
    a.s2 *= f * f;
    a.m = mx;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < n) {
      const float e = __expf(v[i] - a.m);
      a.s1 += e;
      a.s2 += e * e;
    }
  }
}

__device__ __forceinline__ Acc combine(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) return a;
  const float fa = (a.m == -INFINITY) ? 0.f : __expf(a.m - m);
  const float fb = (b.m == -INFINITY) ? 0.f : __expf(b.m - m);
  return {m, a.s1 * fa + b.s1 * fb, a.s2 * fa * fa + b.s2 * fb * fb};
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes -> floats
__device__ __forceinline__ void unpack(const uint4& r, float* v, float) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* v,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// The whole warp calls this for one token; lane 0 writes *ce_out and
// *g2_out.
template <typename T>
__device__ __forceinline__ void warp_token_stats(const T* __restrict__ z,
                                                 int V, int y, int lane,
                                                 float* ce_out,
                                                 float* g2_out) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
  Acc a = {-INFINITY, 0.f, 0.f};
  float v[8];

  // head: scalar elements up to the first 16-byte boundary
  int head = (int)(((16 - ((uintptr_t)z & 15)) & 15) / sizeof(T));
  head = min(head, V);
  if (lane < head) {
    v[0] = to_f(z[lane]);
    fold(a, v, 1);
  }
  // body: aligned 16-byte vectors, kUnroll of them in flight per lane
  const uint4* zv = reinterpret_cast<const uint4*>(z + head);
  const int nvec = (V - head) / N;
  int i = lane;
  for (; i + 32 * (kUnroll - 1) < nvec; i += 32 * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(zv + i + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unpack(r[u], v, T());
      fold(a, v, N);
    }
  }
  for (; i < nvec; i += 32) {
    unpack(__ldg(zv + i), v, T());
    fold(a, v, N);
  }
  // tail: scalar elements after the last full vector
  for (int j = head + nvec * N + lane; j < V; j += 32) {
    v[0] = to_f(z[j]);
    fold(a, v, 1);
  }

  // warp reduce, a fixed butterfly
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc o;
    o.m = __shfl_xor_sync(0xffffffffu, a.m, off);
    o.s1 = __shfl_xor_sync(0xffffffffu, a.s1, off);
    o.s2 = __shfl_xor_sync(0xffffffffu, a.s2, off);
    a = combine(a, o);
  }
  if (lane == 0) {
    // as the TPU kernel's label gather: a label outside [0, V) matches no
    // column and gathers 0
    const float zy = (y >= 0 && y < V) ? to_f(z[y]) : 0.f;
    const float lse = a.m + logf(a.s1);
    const float lse2 = 2.f * a.m + logf(fmaxf(a.s2, 1e-30f));
    *ce_out = lse - zy;
    const float g2 = expf(lse2 - 2.f * lse) - 2.f * expf(zy - lse) + 1.f;
    *g2_out = fmaxf(g2, 0.f);
  }
}

}  // namespace ce_stream
