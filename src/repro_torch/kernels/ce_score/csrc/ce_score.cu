// Per-token CE + importance score for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel ce_score_pallas
// (src/repro/kernels/ce_score/ce_score.py, body _kernel). For logits
// z (T, V) and labels y (T,) it returns per token
//     ce = lse(z) - z_y
//     g2 = max(exp(lse(2z) - 2 lse(z)) - 2 exp(z_y - lse(z)) + 1, 0)
// in f32, z_y = 0 for a label outside [0, V) (the TPU kernel's gather
// matches no column there).
//
// Bound: bytes. Each token's V logits are read from HBM once (at the
// scoring cell's (8*1024, 128256) bf16 logits, 2.10 GB a launch); the work
// is a few flops and one exp per element. One warp per token streams its
// vocab (ce_stream.cuh, the stream K4 uses): 16-byte loads with kUnroll in
// flight per lane, one exp per element for both online sums, an unaligned
// head and tail instead of the TPU kernel's -1e30 vocab padding, so
// V = 128256 (not a multiple of the TPU's 2048-wide tile) needs no copy.
// Rows may be strided (row stride an argument); the vocab stride is 1.

#include "ce_stream.cuh"

namespace {

using namespace ce_stream;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ce_score_kernel(const T* __restrict__ logits, long long s_t, int T_, int V,
                const int* __restrict__ labels, float* __restrict__ ce,
                float* __restrict__ g2) {
  const long long tok =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (tok >= T_) return;
  warp_token_stats(logits + tok * s_t, V, labels[tok], threadIdx.x & 31,
                   ce + tok, g2 + tok);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; labels (T,) int32 contiguous; ce, g2
// (T,) f32. Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int ce_score_launch(const void* logits, int dtype, long long s_t,
                               int T, int V, const int* labels, float* ce,
                               float* g2, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T <= 0) return 0;
  const unsigned grid = (unsigned)((T + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (dtype == 1)
    ce_score_kernel<__nv_bfloat16><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), s_t, T, V, labels, ce, g2);
  else
    ce_score_kernel<float><<<grid, kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float*>(logits), s_t, T, V, labels, ce, g2);
  return (int)cudaGetLastError();
}
