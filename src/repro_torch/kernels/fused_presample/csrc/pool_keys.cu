// Race keys over a presample pool, for Hopper (sm_90a): K3.
//
// Replaces the TPU kernel pool_keys_pallas
// (src/repro/kernels/fused_presample/fused_presample.py, body _keys_kernel
// / pool_keys_math). For the pool's fresh scores s (B,) it writes, per row i,
//     u   = race_hash::uniform(i, ctx)       (race_hash.cuh, shared with K6)
//     g   = s_i * inv_total                  inv_total = 1 / sum(s)
//     key = -log(u) / max(g, 1e-20), and +inf where s_i < 0 (a padded lane)
// The bottom-(k+1) over the keys runs after this kernel (ops.select_pool).
//
// Bound: bytes, and at any pool the main path builds, the launch. Each row
// reads its score and writes its key, 8 B: at B = 768, 6 KB, below 0.01 us
// at 3.35 TB/s. The work is two fmix32 rounds and one log a row. One
// thread a row on a grid-stride loop. inv_total is read from a (1,) device
// tensor, as the TPU kernel reads it from SMEM, so the op that computes it
// never waits for the host. The row id is the thread's index (the TPU
// kernel streams a uint32 iota beside the scores).
// Numerics: uint32_t hash (exact), IEEE logf and __fmul_rn/__fdiv_rn (no
// fast-math, as in K6: __logf near u -> 1 loses the small keys that decide
// the race), so the keys are the plain version's, computed by the same
// separately rounded operations.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../topk_keys/csrc/race_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pool_keys_kernel(const float* __restrict__ scores, long long n, uint32_t ctx,
                 const float* __restrict__ inv_total,
                 float* __restrict__ keys) {
  const float it = *inv_total;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = scores[i];
    if (s < 0.f) {  // padded lane: never wins the race
      keys[i] = INFINITY;
      continue;
    }
    const float u = race_hash::uniform((uint32_t)i, ctx);
    const float g = fmaxf(__fmul_rn(s, it), 1e-20f);
    keys[i] = __fdiv_rn(-logf(u), g);
  }
}

}  // namespace

// scores, keys: (n,) f32; inv_total: (1,) f32; all on the device. Returns
// the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int pool_keys_launch(const float* scores, long long n, unsigned ctx,
                                const float* inv_total, float* keys,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  pool_keys_kernel<<<grid, kThreads, 0, st>>>(scores, n, ctx, inv_total, keys);
  return (int)cudaGetLastError();
}
