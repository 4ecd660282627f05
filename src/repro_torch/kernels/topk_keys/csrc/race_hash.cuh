// The race's counter hash, shared by the pool selection's keys (K3,
// pool_select.cu) and the sharded store's race keys (K6, race_keys.cu).
//
// Each id i of a plan (a pool row, or a store slot's global id) gets
//     h = fmix32(fmix32(i * 0x9E3779B9 ^ ctx) + 0x6A09E667)
//     u = (h >> 8) * 2^-24 + 2^-25                      in (0, 1]
// the composition of the host's selection.hash_uniform, bit for bit for
// ids below 2^32. uint32_t arithmetic wraps mod 2^32 as the reference's
// uint32 lanes do. (h >> 8) * 2^-24 is exact, so the float tail rounds
// once; __fmul_rn/__fadd_rn keep nvcc from contracting it into an FMA, so
// it is the separately rounded product and sum the plain version computes.
#pragma once

#include <stdint.h>

namespace race_hash {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float uniform(uint32_t id, uint32_t ctx) {
  uint32_t h = fmix32(id * 0x9E3779B9u ^ ctx);
  h = fmix32(h + 0x6A09E667u);
  return __fadd_rn(__fmul_rn((float)(h >> 8), 5.9604644775390625e-8f),
                   2.98023223876953125e-8f);
}

}  // namespace race_hash
