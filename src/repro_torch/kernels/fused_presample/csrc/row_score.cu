// Per-row importance score of a presample pool, for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel row_score_pallas
// (src/repro/kernels/fused_presample/fused_presample.py, body _score_kernel
// / row_score_math). For per-token g2 (B, T) f32 and a (B, T) byte mask it
// writes, per row,
//     s_i = sqrt(max(sum_t g2[i, t] * mask[i, t], 1e-20))
// the paper's per-sample score over the row's supervised tokens, the
// reduction LM.sample_stats applies to the ce_score token stats.
//
// Bound: bytes. Each row's T values of g2 (4 B) and of the mask (1 B) are
// read once and one f32 written: at prod's pool (768, 4096) 15.7 MB, 4.7 us
// at 3.35 TB/s; at the slice's pool (12, 1024) 61 KB, where the launch
// itself sets the time. The work is one multiply-add a token. One block
// of 256 threads per row (the TPU kernel's row block of 128 rows is a
// grid step of one core; here the rows spread over the SMs): coalesced
// strided loads, an f32 accumulator a thread, a warp-shuffle tree and one
// shared-memory pass across the block's 8 warps. No padding: the TPU
// kernel pads B only to fill its grid. The sum's order differs from the
// plain version's (rtol 1e-5 between them); sqrtf is IEEE-rounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
row_score_kernel(const float* __restrict__ g2, const uint8_t* __restrict__ mask,
                 int T, float* __restrict__ s) {
  const long long row = blockIdx.x;
  const float* g = g2 + row * T;
  const uint8_t* m = mask + row * T;
  float acc = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads)
    acc = fmaf(g[t], (float)m[t], acc);
  acc = warp_sum(acc);
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? part[lane] : 0.f);
    if (lane == 0) s[row] = sqrtf(fmaxf(acc, 1e-20f));
  }
}

}  // namespace

// g2 (B, T) f32 and mask (B, T) uint8 (0 or 1), both contiguous; s (B,)
// f32. Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int row_score_launch(const float* g2, const uint8_t* mask,
                                long long B, int T, float* s, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  row_score_kernel<<<(unsigned)B, kThreads, 0, st>>>(g2, mask, T, s);
  return (int)cudaGetLastError();
}
