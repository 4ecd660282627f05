// Survival-gated, row-blocked CE + importance-score chunk for Hopper (sm_90a).
//
// Replaces the TPU kernel ce_score_block_pallas
// (src/repro/kernels/ce_score/ce_score.py, body _block_kernel). For logits
// z (B, Tc, V), labels y (B, Tc) and a survival mask alive (B,) it returns
// the masked per-row sums over the time chunk
//     ce_sum[b] = sum_t [y >= 0] (lse(z) - z_y)
//     g2_sum[b] = sum_t [y >= 0] max(exp(lse(2z) - 2 lse(z)) - 2 exp(z_y - lse(z)) + 1, 0)
// A row whose block_b-sized row block holds no live row reads nothing and
// returns 0.0; a dead row that shares a block with a live row is computed.
//
// Bound: bytes. Every supervised token of a live block streams its V logits
// from HBM once (at the slice's (12, 128, 128256) bf16 chunk, 394 MB per
// launch); the work is ~6 flops and one exp per element, far under the
// card's compute rate. The design keeps the stream at full width:
//   * one warp per token, 16-byte vector loads (8 bf16 or 4 f32 a lane),
//     kUnroll loads in flight per lane, so enough bytes are outstanding;
//   * ONE exp per element: with m the running max of z, exp(2z - 2m) is
//     exp(z - m)^2, so the online sums of exp(z) and exp(2z) share it;
//   * z_y is one direct load by lane 0, not a gather over the stream.
// Determinism: survivor scores of the pruned pass must be bitwise those of
// the unpruned pass, so nothing depends on which other rows are alive or on
// scheduling. Each warp writes its token's (ce, g2) to a per-token scratch
// slot; a second kernel sums each row's tokens in order t = 0..Tc-1. No
// float atomics.
//
// The logits may be a strided view (the time-chunk slice of the pool's
// logits): batch and time strides are arguments, the vocab stride must be 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ce_token_kernel(const T* __restrict__ logits, long long s_b, long long s_t,
                int B, int Tc, int V, const int* __restrict__ labels,
                long long l_b, long long l_t, const float* __restrict__ alive,
                int block_b, float* __restrict__ ce_tok,
                float* __restrict__ g2_tok) {
  constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long tok =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (tok >= (long long)B * Tc) return;
  const int b = (int)(tok / Tc);
  const int t = (int)(tok % Tc);

  // the survival gate: the row block's alive lanes
  const int b0 = (b / block_b) * block_b;
  const int b1 = min(b0 + block_b, B);
  bool live = false;
  for (int r = b0; r < b1; ++r) live |= alive[r] > 0.f;
  const int y = labels[b * l_b + t * l_t];
  if (!live || y < 0) {  // skipped block or unsupervised token: no reads
    if (lane == 0) {
      ce_tok[tok] = 0.f;
      g2_tok[tok] = 0.f;
    }
    return;
  }

  const T* z = logits + b * s_b + t * s_t;
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
    const float zy = (y < V) ? to_f(z[y]) : 0.f;  // as the TPU kernel: no match, 0
    const float lse = a.m + logf(a.s1);
    const float lse2 = 2.f * a.m + logf(fmaxf(a.s2, 1e-30f));
    ce_tok[tok] = lse - zy;
    const float g2 = expf(lse2 - 2.f * lse) - 2.f * expf(zy - lse) + 1.f;
    g2_tok[tok] = fmaxf(g2, 0.f);
  }
}

__global__ void row_sum_kernel(const float* __restrict__ ce_tok,
                               const float* __restrict__ g2_tok, int B, int Tc,
                               float* __restrict__ ce_sum,
                               float* __restrict__ g2_sum) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float ce = 0.f, g2 = 0.f;
  for (int t = 0; t < Tc; ++t) {  // one fixed order per row
    ce += ce_tok[(long long)b * Tc + t];
    g2 += g2_tok[(long long)b * Tc + t];
  }
  ce_sum[b] = ce;
  g2_sum[b] = g2;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ce_tok/g2_tok: (B*Tc) f32 scratch.
// Returns the cudaError_t of the launches (0 = cudaSuccess).
extern "C" int ce_score_block_launch(const void* logits, int dtype,
                                     long long s_b, long long s_t, int B,
                                     int Tc, int V, const int* labels,
                                     long long l_b, long long l_t,
                                     const float* alive, int block_b,
                                     float* ce_tok, float* g2_tok,
                                     float* ce_sum, float* g2_sum,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long ntok = (long long)B * Tc;
  if (ntok > 0) {
    const unsigned grid =
        (unsigned)((ntok + kWarpsPerBlock - 1) / kWarpsPerBlock);
    if (dtype == 1)
      ce_token_kernel<__nv_bfloat16><<<grid, kWarpsPerBlock * 32, 0, st>>>(
          static_cast<const __nv_bfloat16*>(logits), s_b, s_t, B, Tc, V,
          labels, l_b, l_t, alive, block_b, ce_tok, g2_tok);
    else
      ce_token_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
          static_cast<const float*>(logits), s_b, s_t, B, Tc, V, labels, l_b,
          l_t, alive, block_b, ce_tok, g2_tok);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  row_sum_kernel<<<(B + 127) / 128, 128, 0, st>>>(ce_tok, g2_tok, B, Tc,
                                                  ce_sum, g2_sum);
  return (int)cudaGetLastError();
}
