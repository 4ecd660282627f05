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
// card's compute rate. One warp per token streams its vocab at full width
// (ce_stream.cuh: 16-byte loads with kUnroll in flight, one exp per
// element for both online sums, a direct load of z_y).
// Determinism: survivor scores of the pruned pass must be bitwise those of
// the unpruned pass, so nothing depends on which other rows are alive or on
// scheduling. Each warp writes its token's (ce, g2) to a per-token scratch
// slot; a second kernel sums each row's tokens in order t = 0..Tc-1. No
// float atomics.
//
// The logits may be a strided view (the time-chunk slice of the pool's
// logits): batch and time strides are arguments, the vocab stride must be 1.

#include "ce_stream.cuh"

namespace {

using namespace ce_stream;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ce_token_kernel(const T* __restrict__ logits, long long s_b, long long s_t,
                int B, int Tc, int V, const int* __restrict__ labels,
                long long l_b, long long l_t, const float* __restrict__ alive,
                int block_b, float* __restrict__ ce_tok,
                float* __restrict__ g2_tok) {
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

  warp_token_stats(logits + b * s_b + t * s_t, V, y, lane, ce_tok + tok,
                   g2_tok + tok);
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
