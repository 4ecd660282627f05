// Flash-attention decode for Hopper (sm_90a) at head dim 256: one query
// row per (batch, query head), GQA-packed, the key range split over blocks
// and the splits merged in the same launch.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py, body _kernel) and the fold
// of its wrapper (ops.flash_attention) for the calls flash_attn.kernel_for
// names "decode": bf16, hd 256, sq = 1 (gemma3's decode over its rings and
// its global caches). For q (b, 1, hq, 256) and k, v (b, skv, hkv, 256),
// read in place through their strides, query head h at position q_offset:
//     o_h = sum_j softmax_j(scale * <q_h, k_j>) v_j,  j in [lo, hi)
// where [lo, hi) is what the causal edge (j <= q_offset) and the window
// (j > q_offset - window) leave of [0, skv): with one query row the mask
// is an interval, so the kernel reads exactly the valid keys. A masked key
// is never visited, which is exact: the TPU kernel's -1e30 scores weigh
// exp(-1e30 - m) = 0.
//
// Bound: bytes. Every key is 512 B of K and 512 B of V, read once for the
// g query heads of its kv head: g multiply-adds a byte, far below the
// card's ridge. So no tensor cores; the design keeps bytes in flight:
//   * a warp reads a key row with one 16-byte load a lane (lane l holds
//     columns 8l..8l+7) and streams chunks of kKeys keys (K and V) through
//     its own kStages-deep ring in shared memory by cp.async. Each lane
//     reads back only the 16 bytes it copied, so cp.async.wait_group alone
//     orders the ring: no barrier in the loop;
//   * q (times scale * log2 e) and the output accumulator stay in
//     registers, G heads x 8 columns a lane. A score is an 8-column
//     partial dot summed over the warp by xor shuffles (every lane ends
//     with the same bits); the online softmax (acc, m, l) runs in base 2;
//   * the warps of a block take interleaved chunks (a block step covers
//     kTile consecutive keys); their states merge through shared memory in
//     warp order;
//   * the grid is (pair, split): a pair is (batch, kv head, chunk of G
//     query heads), G the largest divisor of g up to kMaxG (registers).
//     flash_attn.decode_split sizes the split from the SM count: at most
//     one block an SM (8 warps, 96 KB of shared memory, at most 128
//     registers a thread; kMinBlocks fit an SM when the pairs alone
//     outnumber the SMs), at most kMaxSplit splits. Split s of n takes the
//     kTile-key tiles [s * tiles / n, (s + 1) * tiles / n): at least one,
//     the splits' sizes differ by one tile at most;
//   * the splits of a pair are one thread block cluster. Each block puts
//     its unnormalised (acc, m, l) in its shared memory; after a cluster
//     barrier, block rank 0 reads them all through distributed shared
//     memory and merges them in split order (the same bits on every
//     launch). No scratch in device memory, no counter, no fence.
//   decode_probe.py times edited copies at gemma3's decode (64 pairs, 1024
//   keys): on an H100 80GB HBM3 at 700 W, 2-block clusters of 8-warp
//   blocks (128 blocks, one an SM) took 0.0298 ms, the same blocks at 4
//   splits 0.0329, 8-block clusters of 4-warp blocks 0.0332; without the
//   merge 0.0281, without the math 0.0288, without both 0.0268.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kHD = 256;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 4;                  // keys a warp takes per chunk
constexpr int kStages = 3;                // chunks in a warp's ring
constexpr int kTile = kWarps * kKeys;     // keys a block step covers
constexpr int kMinBlocks = 2;             // resident blocks an SM
constexpr int kMaxG = 4;                  // query heads a block
constexpr int kMaxSplit = 8;              // blocks a cluster (portable)
constexpr int kRowChunks = kHD * 2 / 16;  // 16-byte chunks a row
constexpr int kWarpSmem = kStages * kKeys * 2 * kHD * 2;  // 12 KB
constexpr int kSmemBytes = kWarps * kWarpSmem;            // 96 KB
constexpr int kPart = kHD + 2;            // a head's partial: acc, m, l
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kRowChunks == 32, "one 16-byte chunk of a row per lane");
static_assert(kMaxG * kPart * 4 <= kWarpSmem,
              "a warp's state fits in its ring");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long qs_b, qs_h, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h, os_b, os_h;
  int hkv, g, nhc;                  // heads a kv head, head chunks
  int lo, hi;                       // the valid keys [lo, hi)
  int tiles, nsplit;                // kTile-key tiles of [lo, hi), splits
  float scale_log2;                 // scale * log2(e)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  // the clobber keeps the compiler from moving the ring's reads above it
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 bf16 (16 bytes) -> 8 f32
__device__ __forceinline__ void unpack8(const uint4 r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x: low 16 bits
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float state[G * kPart];  // the block's (acc, m, l)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.x / p.nsplit, split = blockIdx.x % p.nsplit;
  const int bh = pair / p.nhc, hc = pair % p.nhc;
  const int bi = bh / p.hkv, kvh = bh % p.hkv;
  const int h0 = kvh * p.g + hc * G;  // the block's first query head

  const int k0 = p.lo + (int)((long long)split * p.tiles / p.nsplit) * kTile;
  const int k1 = min(
      p.hi, p.lo + (int)((long long)(split + 1) * p.tiles / p.nsplit) * kTile);
  const int first = k0 + warp * kKeys;  // the warp's first key
  const int nchunks = first < k1 ? (k1 - first + kTile - 1) / kTile : 0;
  const __nv_bfloat16* kb =
      p.k + bi * p.ks_b + (long long)kvh * p.ks_h + lane * 8;
  const __nv_bfloat16* vb =
      p.v + bi * p.vs_b + (long long)kvh * p.vs_h + lane * 8;
  // the warp's ring: [kStages][kKeys][K, V][32 lanes] of 16 bytes
  uint4* ring = reinterpret_cast<uint4*>(smem + warp * kWarpSmem);
  constexpr int kStage = kKeys * 2 * 32;

  auto load_chunk = [&](int c) {
    if (c < nchunks) {
      uint4* st = ring + (c % kStages) * kStage;
      const int key0 = first + c * kTile;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const bool ok = key0 + i < k1;
        const long long key = ok ? key0 + i : k0;
        cp_async16(st + (2 * i) * 32 + lane, kb + key * p.ks_s, ok);
        cp_async16(st + (2 * i + 1) * 32 + lane, vb + key * p.vs_s, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load_chunk(c);

  // q, this lane's 8 columns of each head, times scale * log2 e (q's
  // pairs are 4-byte aligned, not 16), read while the first chunks fly
  float qr[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const uint32_t* qp = reinterpret_cast<const uint32_t*>(
        p.q + bi * p.qs_b + (long long)(h0 + j) * p.qs_h + lane * 8);
    unpack8(make_uint4(qp[0], qp[1], qp[2], qp[3]), qr[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qr[j][e] *= p.scale_log2;
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;
  }

  for (int c = 0; c < nchunks; ++c) {
    load_chunk(c + kStages - 1);
    cp_async_wait<kStages - 1>();  // chunk c's bytes (this lane's) landed
    const uint4* st = ring + (c % kStages) * kStage;
    const int key0 = first + c * kTile;
    float s[kKeys][G];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      float kf[8];
      unpack8(st[(2 * i) * 32 + lane], kf);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[j][e], kf[e], d);
        s[i][j] = d;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
#pragma unroll
        for (int j = 0; j < G; ++j)
          s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], off);
      }
    }
    // key0 < k1 (c < nchunks), so each head's chunk max is a real score
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mx = kNeg;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (key0 + i >= k1) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[j], mx);
      const float corr = ex2(m[j] - mn);
      m[j] = mn;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        s[i][j] = ex2(s[i][j] - mn);
        sum += s[i][j];
      }
      l[j] = l[j] * corr + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[j][e] *= corr;
    }
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      float vf[8];
      unpack8(st[(2 * i + 1) * 32 + lane], vf);
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(s[i][j], vf[e], acc[j][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies have landed: the ring is free

  // each warp's state into its own ring, then the block's, merged in warp
  // order; a warp without keys weighs 0
  float* ws = reinterpret_cast<float*>(smem + warp * kWarpSmem);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float4* dst = reinterpret_cast<float4*>(ws + j * kHD + lane * 8);
    dst[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    dst[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    if (lane == 0) {
      ws[G * kHD + j] = m[j];
      ws[G * kHD + G + j] = l[j];
    }
  }
  __syncthreads();

  // the block's state: thread t takes columns 2c, 2c + 1 of head j for
  // each (j, c) it owns; one split alone writes the output
  for (int x = threadIdx.x; x < G * (kHD / 2); x += kThreads) {
    const int j = x / (kHD / 2), col = (x % (kHD / 2)) * 2;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wsw = reinterpret_cast<const float*>(smem + w * kWarpSmem);
      M = fmaxf(M, wsw[G * kHD + j]);
    }
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wsw = reinterpret_cast<const float*>(smem + w * kWarpSmem);
      const float e = ex2(wsw[G * kHD + j] - M);
      L += wsw[G * kHD + G + j] * e;
      const float2 a = *reinterpret_cast<const float2*>(wsw + j * kHD + col);
      a0 = fmaf(a.x, e, a0);
      a1 = fmaf(a.y, e, a1);
    }
    if (p.nsplit == 1) {
      const float inv = 1.f / L;
      *reinterpret_cast<uint32_t*>(p.o + bi * p.os_b +
                                   (long long)(h0 + j) * p.os_h + col) =
          pack_bf16(a0 * inv, a1 * inv);
    } else {
      *reinterpret_cast<float2*>(state + j * kPart + col) =
          make_float2(a0, a1);
      if (col == 0) {
        state[j * kPart + kHD] = M;
        state[j * kPart + kHD + 1] = L;
      }
    }
  }
  if (p.nsplit == 1) return;

  // the splits of a pair are one cluster (block rank = split): rank 0
  // reads every block's state from its shared memory and merges them in
  // split order; the second barrier keeps each block's shared memory
  // alive until rank 0 has read it
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (split == 0) {
    for (int x = threadIdx.x; x < G * (kHD / 2); x += kThreads) {
      const int j = x / (kHD / 2), col = (x % (kHD / 2)) * 2;
      float ms[kMaxSplit], M = kNeg;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        ms[r] = r < p.nsplit
                    ? cluster.map_shared_rank(state, r)[j * kPart + kHD]
                    : kNeg;
        M = fmaxf(M, ms[r]);
      }
      float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        if (r < p.nsplit) {
          const float* st = cluster.map_shared_rank(state, r) + j * kPart;
          const float e = ex2(ms[r] - M);
          L += st[kHD + 1] * e;
          const float2 a = *reinterpret_cast<const float2*>(st + col);
          a0 = fmaf(a.x, e, a0);
          a1 = fmaf(a.y, e, a1);
        }
      }
      const float inv = 1.f / L;
      *reinterpret_cast<uint32_t*>(p.o + bi * p.os_b +
                                   (long long)(h0 + j) * p.os_h + col) =
          pack_bf16(a0 * inv, a1 * inv);
    }
  }
  cluster.sync();
}

template <int G>
int set_attributes() {
  static int attr = [] {
    int e = (int)cudaFuncSetAttribute(
        flash_decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e == 0)
      e = (int)cudaFuncSetAttribute(
          flash_decode_kernel<G>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return attr;
}

// the launch configuration: nsplit blocks a cluster (one pair's splits)
struct Config {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Config(int blocks, int nsplit, cudaStream_t st) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nsplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int G>
int launch(const Params& p, int blocks, cudaStream_t st) {
  const int attr = set_attributes<G>();
  if (attr != 0) return attr;
  Config c(blocks, p.nsplit, st);
  return (int)cudaLaunchKernelEx(&c.cfg, flash_decode_kernel<G>, p);
}

// resident blocks an SM, and clusters of nsplit blocks on the card
template <int G>
int occupancy(int nsplit, int* clusters) {
  int n = set_attributes<G>();
  if (n != 0) return -n;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_decode_kernel<G>, kThreads, kSmemBytes);
  if (e != cudaSuccess) return -(int)e;
  Config c(nsplit, nsplit, nullptr);
  e = cudaOccupancyMaxActiveClusters(clusters, flash_decode_kernel<G>,
                                     &c.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// q (b, 1, hkv * g, 256), k/v (b, skv, hkv, 256), o (b, 1, hkv * g, 256),
// bf16, unit stride on hd, strides in elements (k and v rows 16-byte
// aligned, q 4-byte aligned). G in 1..4 divides g: the query heads a block
// takes. Keys [lo, hi) are attended, cut into kTile-key tiles; split s of
// nsplit (1..8, at most one split a tile; one cluster) takes tiles
// [s * tiles / nsplit, (s + 1) * tiles / nsplit). Returns the cudaError_t
// of the launch (0 = cudaSuccess).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, void* o, int b, int hkv,
    int g, int G, long long qs_b, long long qs_h, long long ks_b,
    long long ks_s, long long ks_h, long long vs_b, long long vs_s,
    long long vs_h, long long os_b, long long os_h, int lo, int hi,
    int nsplit, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || G < 1 || G > kMaxG || g % G != 0 || lo < 0 ||
      hi <= lo || nsplit < 1 || nsplit > kMaxSplit ||
      nsplit > ((long long)hi - lo + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.qs_b = qs_b; p.qs_h = qs_h;
  p.ks_b = ks_b; p.ks_s = ks_s; p.ks_h = ks_h;
  p.vs_b = vs_b; p.vs_s = vs_s; p.vs_h = vs_h;
  p.os_b = os_b; p.os_h = os_h;
  p.hkv = hkv; p.g = g; p.nhc = g / G;
  p.lo = lo; p.hi = hi;
  p.tiles = (int)(((long long)hi - lo + kTile - 1) / kTile);
  p.nsplit = nsplit;
  p.scale_log2 = scale * kLog2e;
  const long long blocks = (long long)b * hkv * p.nhc * nsplit;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch<1>(p, (int)blocks, st);
    case 2: return launch<2>(p, (int)blocks, st);
    case 3: return launch<3>(p, (int)blocks, st);
    default: return launch<4>(p, (int)blocks, st);
  }
}

// Resident blocks an SM for G query heads a block, as the occupancy
// calculator gives them on the current device (the split rule assumes
// kMinBlocks), and in *clusters the clusters of nsplit such blocks the
// card holds at once; a negative value is a cudaError_t.
extern "C" int flash_decode_occupancy(int G, int nsplit, int* clusters) {
  if (nsplit < 1 || nsplit > kMaxSplit) return -(int)cudaErrorInvalidValue;
  switch (G) {
    case 1: return occupancy<1>(nsplit, clusters);
    case 2: return occupancy<2>(nsplit, clusters);
    case 3: return occupancy<3>(nsplit, clusters);
    case 4: return occupancy<4>(nsplit, clusters);
    default: return -(int)cudaErrorInvalidValue;
  }
}
