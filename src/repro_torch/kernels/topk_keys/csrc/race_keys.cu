// Exponential-race keys of the sharded store selection, for Hopper (sm_90a).
//
// Replaces the TPU kernel race_keys_pallas
// (src/repro/kernels/topk_keys/topk_keys.py, body _kernel / race_keys_math).
// For one host's score shard (n slots; the slot's global id is
// slot * n_hosts + host_id, wrapping mod 2^32 as the reference's uint32 ids
// do) it writes, per slot,
//     h   = fmix32(fmix32(gid * 0x9E3779B9 ^ ctx) + 0x6A09E667)
//     u   = (h >> 8) * 2^-24 + 2^-25                        in (0, 1)
//     s~  = exp(log(max(s, 1e-12)) * inv_t), or fill_pow where unseen
//     p   = s~ * scale + lam_over_n          scale = (1 - lambda) / S~
//     key = -log(u) / p, and +inf on a padded lane (seen < 0)
// The bottom-k over the keys runs after this kernel (ops.topk_race_keys).
//
// Bound: bytes. Each slot reads its score and seen flag and writes its key,
// 12 B (the global id is derived here, not read: the TPU kernel streams a
// uint32 id array too); at the slice's n = 2^24, 201 MB a launch, 0.060 ms
// at 3.35 TB/s. The work is two fmix32 rounds and three transcendentals a
// slot, a few percent of the card's rate. The design is one thread per slot
// on a grid-stride loop with coalesced 4-byte loads, so HBM streams at width.
// Numerics: the hash is race_hash.cuh's, shared with K3 (uint32_t
// arithmetic, bitwise the host's selection.hash_uniform). The float tail
// uses the IEEE-rounded logf/expf (no fast-math: __logf near u -> 1 loses
// the small keys that decide the race), and __fmul_rn/__fadd_rn/__fdiv_rn
// keep every product, sum and quotient a separately rounded operation, as
// the plain version computes it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "race_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
race_keys_kernel(const float* __restrict__ scores,
                 const float* __restrict__ seen, long long n, uint32_t host_id,
                 uint32_t n_hosts, uint32_t ctx, float fill_pow, float scale,
                 float lam_over_n, float inv_t, float* __restrict__ keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float sn = seen[i];
    if (sn < 0.f) {  // padded lane: never wins a bottom-k
      keys[i] = INFINITY;
      continue;
    }
    const uint32_t gid = (uint32_t)i * n_hosts + host_id;
    const float u = race_hash::uniform(gid, ctx);
    float sp = fill_pow;
    if (sn > 0.f) sp = expf(__fmul_rn(logf(fmaxf(scores[i], 1e-12f)), inv_t));
    const float p = __fadd_rn(__fmul_rn(sp, scale), lam_over_n);
    keys[i] = __fdiv_rn(-logf(u), p);
  }
}

}  // namespace

// scores, seen, keys: (n,) f32 on the device. Returns the cudaError_t of the
// launch (0 = cudaSuccess).
extern "C" int race_keys_launch(const float* scores, const float* seen,
                                long long n, unsigned host_id,
                                unsigned n_hosts, unsigned ctx, float fill_pow,
                                float scale, float lam_over_n, float inv_t,
                                float* keys, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // enough resident blocks to fill 132 SMs (8 x 256 threads each), then
  // the grid-stride loop walks the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  race_keys_kernel<<<grid, kThreads, 0, st>>>(scores, seen, n, host_id,
                                              n_hosts, ctx, fill_pow, scale,
                                              lam_over_n, inv_t, keys);
  return (int)cudaGetLastError();
}
