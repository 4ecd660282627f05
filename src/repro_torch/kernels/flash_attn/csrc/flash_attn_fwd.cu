// Flash-attention forward for Hopper (sm_90a), GQA-packed, with a kv split.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py, body _kernel) and the fold
// of its wrapper (ops.flash_attention). For q (b, sq, hq, hd) and k, v
// (b, skv, hkv, hd), read in place through their strides, it computes per
// query head h and position i (query position qpos = q_offset + i, key
// position = kv index j):
//     s_j = scale * <q, k_j>,  masked to -1e30 unless j <= qpos (causal)
//                              and j > qpos - window (window > 0)
//     o   = sum_j softmax(s)_j v_j
// with the TPU kernel's online softmax: (acc, m, l) carried over kv tiles,
// m starting at -1e30, acc / max(l, 1e-30) at the end. A row's first tiles
// may be wholly masked; they add exp(0) = 1 terms that the first real max
// wipes (corr = exp(-1e30 - m) = 0), as on the TPU. A row with no valid key
// at all is outside the contract (the wrapper refuses it).
//
// GQA: the rows a block owns are (position, head-in-group) pairs of ONE kv
// head, packed r = i * g + (h % g). The kv tile is read once for all g
// heads and nothing is folded or broadcast: on the serving path a fold
// would copy the KV cache g times in every layer at every step. Decode
// (sq = 1) packs its g query heads into one block.
//
// The wgmma kernels (flash_attn_fwd_wgmma.cu, flash_attn_fwd_wgmma256.cu)
// take bf16 prefill and scoring at hd = 128 and 256 (the wrapper's
// kernel_for rule: at least 64 query rows, TMA-aligned q, k, v), and the
// decode kernel (flash_attn_decode.cu) bf16 at hd 256 with one query row
// (gemma3's decode); f32 prefill and scoring (lm-100m's pool, lm-tiny, the
// reduced configs: hd 16-128, at least 16 query rows, 16-byte aligned) go
// to flash_attn_fwd_f32.cu. This kernel serves the hd-128 decode (sq = 1,
// the kv range split), the f32 decode and the f32 calls flash_attn_fwd_f32
// refuses (fewer query rows, views off 16 bytes, other head dims), the
// other bf16 head dims and calls not aligned for TMA. Its hd-256 instance
// stays for the hd-256 prefills the wgmma kernel refuses (fewer than 64
// query rows, off TMA's alignment, a softmax scale <= 0).
//
// Bound: at decode (sq = 1) reading the cache once is the bound; a
// prefill (4*b*hq*hd*sum_i(i+1) flop) is compute-bound.
// The design for each:
//   * bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) for Q K^T and
//     P V; K and V tiles stream through a 2-stage cp.async ring in shared
//     memory (zero-filled past skv); the P tile stays in registers (the
//     accumulator fragment of S is the A fragment of P V). Softmax in f32.
//     Up to hd 128 each warp keeps its Q fragments in registers for the
//     whole sweep and a kv tile is 64 keys. At hd 256 (gemma3) the output
//     accumulator alone is 128 registers a thread, so the block's Q is
//     staged once in shared memory (64 rows x 256, 33 KB) and its
//     fragments are loaded per 16-column step, and a kv tile is 32 keys
//     (the S tile 16 registers, not 32): about 100 KB of shared memory.
//   * f32: plain f32 FMA (no TF32, for the reference's 2e-4 tolerance), one
//     key per lane, with the kv split: the f32 decode and the f32 calls the
//     register-tiled f32 kernel (flash_attn_fwd_f32.cu) refuses.
//   * tiles wholly above the causal diagonal or before the window of every
//     row in the block are never visited;
//   * when the grid would not fill the card (decode) the kv range is split
//     over blockIdx.z; each split writes unnormalised (acc, m, l) and a
//     second kernel merges them (flash-decoding).
// It keeps to mma.sync; the wgmma kernel is Hopper's full-rate path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // packed query rows per block

struct Problem {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, skv, hkv, hd, g;
  long long qs_b, qs_s, qs_h;
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long os_b, os_s, os_h;
  int causal, window, q_offset;
  float scale;
  int nsplit;
  float* part_o;  // (nsplit, b*hkv, sq*g, hd), used when nsplit > 1
  float* part_m;  // (nsplit, b*hkv, sq*g)
  float* part_l;
};

__device__ __forceinline__ bool key_ok(const Problem& p, int kpos, int qpos) {
  return kpos < p.skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// The kv tiles [t_begin, t_end) of tile width bk this block visits: the
// union of its rows' unmasked keys, cut into nsplit even parts.
__device__ __forceinline__ void tile_range(const Problem& p, int row0, int bk,
                                           int& t_begin, int& t_end) {
  const int nrows = p.sq * p.g;
  const int last = min(row0 + kRows, nrows) - 1;
  const int qlo = p.q_offset + row0 / p.g;
  const int qhi = p.q_offset + last / p.g;
  const int kv_end = p.causal ? min(p.skv, qhi + 1) : p.skv;
  const int kv_begin = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  if (kv_end <= kv_begin) {
    t_begin = t_end = 0;
    return;
  }
  const int tb = kv_begin / bk;
  const int te = (kv_end + bk - 1) / bk;
  const int per = (te - tb + p.nsplit - 1) / p.nsplit;
  t_begin = min(te, tb + (int)blockIdx.z * per);
  t_end = min(te, t_begin + per);
}

// Row r of kv head (bi, kvh): its output (or query) element offset.
__device__ __forceinline__ long long row_offset(const Problem& p, long long s_b,
                                                long long s_s, long long s_h,
                                                int bi, int kvh, int r) {
  return bi * s_b + (long long)(r / p.g) * s_s +
         (long long)(kvh * p.g + r % p.g) * s_h;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tiles
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x: low 16 bits
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The bf16 kernel's tiling at head dim HD (see the header).
template <int HD>
struct Bf16Tiles {
  static constexpr bool kQSmem = HD > 128;       // Q staged in shared memory
  static constexpr int BK = HD > 128 ? 32 : 64;  // keys per kv tile
  static constexpr int LD = HD + 8;  // smem row stride in bf16: conflict-free
  // K and V, 2 stages of BK keys, then the block's Q rows when staged
  static constexpr int kSmemBytes =
      (2 * 2 * BK + (kQSmem ? kRows : 0)) * LD * 2;
};

// Each warp owns 16 packed rows; thread (grp = lane/4, tig = lane%4) holds
// rows grp and grp + 8 of them, as the m16n8k16 fragments lay them out.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const Problem p) {
  using T = Bf16Tiles<HD>;
  constexpr int BK = T::BK;
  constexpr int LD = T::LD;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                   // [2][BK][LD]
  bf16* qsm = vs + 2 * BK * LD;                  // [kRows][LD] (kQSmem)

  const int row0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int bi = bh / p.hkv, kvh = bh % p.hkv;
  const int nrows = p.sq * p.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int rA = row0 + warp * 16 + grp, rB = rA + 8;
  const bool warp_live = row0 + warp * 16 < nrows;
  const int qposA = p.q_offset + rA / p.g, qposB = p.q_offset + rB / p.g;

  int t_begin, t_end;
  tile_range(p, row0, BK, t_begin, t_end);

  const bf16* kbase = static_cast<const bf16*>(p.k) + bi * p.ks_b +
                      (long long)kvh * p.ks_h;
  const bf16* vbase = static_cast<const bf16*>(p.v) + bi * p.vs_b +
                      (long long)kvh * p.vs_h;

  // Q fragments, kept in registers for the whole kv sweep (hd <= 128), or
  // the block's Q rows staged in shared memory (hd 256)
  uint32_t qf[T::kQSmem ? 1 : HD / 16][4];
  if constexpr (T::kQSmem) {
    const bf16* q = static_cast<const bf16*>(p.q);
    constexpr int WPR = HD / 2;  // 4-byte words a row (q is 4-byte aligned)
    for (int c = threadIdx.x; c < kRows * WPR; c += kThreads) {
      const int r = c / WPR, col = (c % WPR) * 2;
      const int row = row0 + r;
      *reinterpret_cast<uint32_t*>(qsm + r * LD + col) =
          row < nrows
              ? ld32(q + row_offset(p, p.qs_b, p.qs_s, p.qs_h, bi, kvh, row) +
                     col)
              : 0u;
    }
    __syncthreads();
  } else {
    const bf16* q = static_cast<const bf16*>(p.q);
    const bf16* qA =
        rA < nrows ? q + row_offset(p, p.qs_b, p.qs_s, p.qs_h, bi, kvh, rA)
                   : nullptr;
    const bf16* qB =
        rB < nrows ? q + row_offset(p, p.qs_b, p.qs_s, p.qs_h, bi, kvh, rB)
                   : nullptr;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      qf[kk][0] = qA ? ld32(qA + c) : 0u;
      qf[kk][1] = qB ? ld32(qB + c) : 0u;
      qf[kk][2] = qA ? ld32(qA + c + 8) : 0u;
      qf[kk][3] = qB ? ld32(qB + c + 8) : 0u;
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;  // l: this thread's part

  auto load_tile = [&](int t, int buf) {
    constexpr int CPR = HD / 8;  // 16-byte chunks per row
    const int key0 = t * BK;
    for (int c = threadIdx.x; c < BK * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const int key = key0 + r;
      const bool ok = key < p.skv;
      const long long kr = ok ? key : 0;
      cp_async16(ks + (buf * BK + r) * LD + col, kbase + kr * p.ks_s + col,
                 ok);
      cp_async16(vs + (buf * BK + r) * LD + col, vbase + kr * p.vs_s + col,
                 ok);
    }
    cp_async_commit();
  };

  if (t_begin < t_end) load_tile(t_begin, 0);
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int buf = it & 1;
    if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      const bf16* K = ks + buf * BK * LD;
      const bf16* V = vs + buf * BK * LD;
      // S = Q K^T, (16 x BK) per warp
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (T::kQSmem) {
          const bf16* qr = qsm + (warp * 16 + grp) * LD + kk * 16 + tig * 2;
          qa[0] = ld32(qr);
          qa[1] = ld32(qr + 8 * LD);
          qa[2] = ld32(qr + 8);
          qa[3] = ld32(qr + 8 * LD + 8);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
          const bf16* kr = K + (n * 8 + grp) * LD + kk * 16 + tig * 2;
          mma_bf16(s[n], qa, ld32(kr), ld32(kr + 8));
        }
      }
      // scale, mask, tile max per row
      const int key0 = t * BK;
      float tmA = kNeg, tmB = kNeg;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = key0 + n * 8 + tig * 2 + e;
          const float a = key_ok(p, kpos, qposA) ? s[n][e] * p.scale : kNeg;
          const float b = key_ok(p, kpos, qposB) ? s[n][2 + e] * p.scale : kNeg;
          s[n][e] = a;
          s[n][2 + e] = b;
          tmA = fmaxf(tmA, a);
          tmB = fmaxf(tmB, b);
        }
      }
      tmA = fmaxf(tmA, __shfl_xor_sync(0xffffffffu, tmA, 1));
      tmA = fmaxf(tmA, __shfl_xor_sync(0xffffffffu, tmA, 2));
      tmB = fmaxf(tmB, __shfl_xor_sync(0xffffffffu, tmB, 1));
      tmB = fmaxf(tmB, __shfl_xor_sync(0xffffffffu, tmB, 2));
      const float mAn = fmaxf(mA, tmA), mBn = fmaxf(mB, tmB);
      const float cA = __expf(mA - mAn), cB = __expf(mB - mBn);
      mA = mAn;
      mB = mBn;
      // P = exp(S - m) as bf16 A fragments of P V
      uint32_t pf[BK / 16][4];
      float sumA = 0.f, sumB = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float p0 = __expf(s[n][0] - mA), p1 = __expf(s[n][1] - mA);
        const float p2 = __expf(s[n][2] - mB), p3 = __expf(s[n][3] - mB);
        sumA += p0 + p1;
        sumB += p2 + p3;
        pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(p0, p1);
        pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      lA = lA * cA + sumA;
      lB = lB * cB + sumB;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[d][0] *= cA;
        o[d][1] *= cA;
        o[d][2] *= cB;
        o[d][3] *= cB;
      }
      // O += P V; V^T fragments by ldmatrix.trans: matrix lane/8 of the
      // x4 is (keys +8*(m&1), columns +8*(m>>1)) of a 16 x 16 block
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(
              bv, V + (j * 16 + (mi & 1) * 8 + rr) * LD + dp * 16 + (mi >> 1) * 8);
          mma_bf16(o[2 * dp], pf[j], bv[0], bv[1]);
          mma_bf16(o[2 * dp + 1], pf[j], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }

  // row sums over the 4 threads that share a row
  lA += __shfl_xor_sync(0xffffffffu, lA, 1);
  lA += __shfl_xor_sync(0xffffffffu, lA, 2);
  lB += __shfl_xor_sync(0xffffffffu, lB, 1);
  lB += __shfl_xor_sync(0xffffffffu, lB, 2);
  if (!warp_live) return;

  if (p.nsplit == 1) {
    bf16* out = static_cast<bf16*>(p.o);
    const float iA = 1.f / fmaxf(lA, 1e-30f), iB = 1.f / fmaxf(lB, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int col = d * 8 + tig * 2;
      if (rA < nrows)
        *reinterpret_cast<uint32_t*>(
            out + row_offset(p, p.os_b, p.os_s, p.os_h, bi, kvh, rA) + col) =
            pack_bf16(o[d][0] * iA, o[d][1] * iA);
      if (rB < nrows)
        *reinterpret_cast<uint32_t*>(
            out + row_offset(p, p.os_b, p.os_s, p.os_h, bi, kvh, rB) + col) =
            pack_bf16(o[d][2] * iB, o[d][3] * iB);
    }
    return;
  }
  const long long base = ((long long)blockIdx.z * gridDim.y + bh) * nrows;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const int col = d * 8 + tig * 2;
    if (rA < nrows)
      *reinterpret_cast<float2*>(p.part_o + (base + rA) * HD + col) =
          make_float2(o[d][0], o[d][1]);
    if (rB < nrows)
      *reinterpret_cast<float2*>(p.part_o + (base + rB) * HD + col) =
          make_float2(o[d][2], o[d][3]);
  }
  if (tig == 0) {
    if (rA < nrows) {
      p.part_m[base + rA] = mA;
      p.part_l[base + rA] = lA;
    }
    if (rB < nrows) {
      p.part_m[base + rB] = mB;
      p.part_l[base + rB] = lB;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA, one key of a 32-key tile per lane
// ---------------------------------------------------------------------------
constexpr int kF32Bk = 32;

__host__ __device__ constexpr int f32_smem_floats(int hd) {
  return kRows * hd + kF32Bk * (hd + 1) + kF32Bk * hd + kWarps * 16 * kF32Bk;
}

template <int NC>  // output columns per lane: hd <= 32 * NC
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Problem p) {
  constexpr int BK = kF32Bk;
  const int HD = p.hd;
  extern __shared__ float smf[];
  float* qs = smf;                   // [kRows][HD]
  float* ksm = qs + kRows * HD;      // [BK][HD + 1]
  float* vsm = ksm + BK * (HD + 1);  // [BK][HD]
  float* ps = vsm + BK * HD;         // [kWarps][16][BK]

  const int row0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int bi = bh / p.hkv, kvh = bh % p.hkv;
  const int nrows = p.sq * p.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool warp_live = row0 + warp * 16 < nrows;

  int t_begin, t_end;
  tile_range(p, row0, BK, t_begin, t_end);

  const float* q = static_cast<const float*>(p.q);
  const float* kbase = static_cast<const float*>(p.k) + bi * p.ks_b +
                       (long long)kvh * p.ks_h;
  const float* vbase = static_cast<const float*>(p.v) + bi * p.vs_b +
                       (long long)kvh * p.vs_h;

  for (int c = threadIdx.x; c < kRows * HD; c += kThreads) {
    const int r = row0 + c / HD, d = c % HD;
    qs[c] = r < nrows
                ? q[row_offset(p, p.qs_b, p.qs_s, p.qs_h, bi, kvh, r) + d]
                : 0.f;
  }

  float o[16][NC], m[16], l[16];  // l: this lane's part of the row sum
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
  }
  const float* qw = qs + warp * 16 * HD;
  float* pw = ps + warp * 16 * BK;

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int c = threadIdx.x; c < BK * HD; c += kThreads) {
      const int r = c / HD, d = c % HD;
      const int key = t * BK + r;
      const bool ok = key < p.skv;
      ksm[r * (HD + 1) + d] = ok ? kbase[key * p.ks_s + d] : 0.f;
      vsm[r * HD + d] = ok ? vbase[key * p.vs_s + d] : 0.f;
    }
    __syncthreads();
    if (!warp_live) continue;
    float s[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) s[r] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float kd = ksm[lane * (HD + 1) + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) s[r] = fmaf(qw[r * HD + d], kd, s[r]);
    }
    const int kpos = t * BK + lane;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int qpos = p.q_offset + (row0 + warp * 16 + r) / p.g;
      const float x = key_ok(p, kpos, qpos) ? s[r] * p.scale : kNeg;
      const float mn = fmaxf(m[r], warp_max(x));
      const float corr = __expf(m[r] - mn);
      const float pe = __expf(x - mn);
      m[r] = mn;
      l[r] = l[r] * corr + pe;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] *= corr;
      pw[r * BK + lane] = pe;
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        const float vv = d < HD ? vsm[j * HD + d] : 0.f;
#pragma unroll
        for (int r = 0; r < 16; ++r) o[r][c] = fmaf(pw[r * BK + j], vv, o[r][c]);
      }
    }
    __syncwarp();
  }
  if (!warp_live) return;

  const long long base = ((long long)blockIdx.z * gridDim.y + bh) * nrows;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float lr = warp_sum(l[r]);
    const int row = row0 + warp * 16 + r;
    if (row >= nrows) continue;
    if (p.nsplit == 1) {
      float* out = static_cast<float*>(p.o) +
                   row_offset(p, p.os_b, p.os_s, p.os_h, bi, kvh, row);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) out[d] = o[r][c] * inv;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) p.part_o[(base + row) * HD + d] = o[r][c];
      }
      if (lane == 0) {
        p.part_m[base + row] = m[r];
        p.part_l[base + row] = lr;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// merge of the kv splits: one block per packed row, one thread per column
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void store(T* dst, float x);
template <>
__device__ __forceinline__ void store<float>(float* dst, float x) {
  *dst = x;
}
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* dst,
                                                     float x) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void combine_kernel(const Problem p) {
  const int nrows = p.sq * p.g;
  const int bhs = p.b * p.hkv;
  const long long idx = blockIdx.x;
  const int bh = (int)(idx / nrows), r = (int)(idx % nrows);
  const int d = threadIdx.x;
  if (d >= p.hd) return;
  float mx = kNeg;
  for (int s = 0; s < p.nsplit; ++s)
    mx = fmaxf(mx, p.part_m[((long long)s * bhs + bh) * nrows + r]);
  float lsum = 0.f, acc = 0.f;
  for (int s = 0; s < p.nsplit; ++s) {
    const long long at = ((long long)s * bhs + bh) * nrows + r;
    const float w = expf(p.part_m[at] - mx);
    lsum += p.part_l[at] * w;
    acc += p.part_o[at * p.hd + d] * w;
  }
  T* out = static_cast<T*>(p.o) +
           row_offset(p, p.os_b, p.os_s, p.os_h, bh / p.hkv, bh % p.hkv, r);
  store<T>(out + d, acc / fmaxf(lsum, 1e-30f));
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch_bf16(const Problem& p, dim3 grid, cudaStream_t st) {
  constexpr int bytes = Bf16Tiles<HD>::kSmemBytes;
  static int attr = set_smem(flash_bf16_kernel<HD>, bytes);
  if (attr != 0) return attr;
  flash_bf16_kernel<HD><<<grid, kThreads, bytes, st>>>(p);
  return 0;
}

template <int NC>
int launch_f32(const Problem& p, dim3 grid, cudaStream_t st) {
  const int bytes = f32_smem_floats(p.hd) * (int)sizeof(float);
  const int err = set_smem(flash_f32_kernel<NC>, bytes);
  if (err != 0) return err;
  flash_f32_kernel<NC><<<grid, kThreads, bytes, st>>>(p);
  return 0;
}

}  // namespace

// q (b, sq, hq, hd), k/v (b, skv, hkv, hd), o (b, sq, hq, hd), all with a
// unit stride on hd; strides in elements. dtype: 0 = float32, 1 = bfloat16
// (bf16 needs hd in {16, 32, 64, 128, 256} and 16-byte aligned k/v rows;
// f32 takes hd <= 128). nsplit > 1 needs part_o (nsplit*b*hkv*sq*g*hd f32) and
// part_m, part_l (nsplit*b*hkv*sq*g f32) as scratch. Returns the
// cudaError_t of the launches (0 = cudaSuccess).
extern "C" int flash_attn_fwd_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int sq, int skv, int hq, int hkv, int hd, long long qs_b, long long qs_s,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, long long os_b,
    long long os_s, long long os_h, int causal, int window, int q_offset,
    float scale, int nsplit, float* part_o, float* part_m, float* part_l,
    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      nsplit < 1 || hd > (dtype == 1 ? 256 : 128) || hd <= 0)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.b = b; p.sq = sq; p.skv = skv; p.hkv = hkv; p.hd = hd; p.g = hq / hkv;
  p.qs_b = qs_b; p.qs_s = qs_s; p.qs_h = qs_h;
  p.ks_b = ks_b; p.ks_s = ks_s; p.ks_h = ks_h;
  p.vs_b = vs_b; p.vs_s = vs_s; p.vs_h = vs_h;
  p.os_b = os_b; p.os_s = os_s; p.os_h = os_h;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale; p.nsplit = nsplit;
  p.part_o = part_o; p.part_m = part_m; p.part_l = part_l;
  const int nrows = sq * p.g;
  const dim3 grid((nrows + kRows - 1) / kRows, b * hkv, nsplit);
  int err;
  if (dtype == 1) {
    switch (hd) {
      case 16: err = launch_bf16<16>(p, grid, st); break;
      case 32: err = launch_bf16<32>(p, grid, st); break;
      case 64: err = launch_bf16<64>(p, grid, st); break;
      case 128: err = launch_bf16<128>(p, grid, st); break;
      case 256: err = launch_bf16<256>(p, grid, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    err = hd <= 32   ? launch_f32<1>(p, grid, st)
          : hd <= 64 ? launch_f32<2>(p, grid, st)
                     : launch_f32<4>(p, grid, st);
  }
  if (err != 0) return err;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nsplit > 1) {
    const unsigned rows = (unsigned)((long long)b * hkv * nrows);
    const int threads = (hd + 31) / 32 * 32;
    if (dtype == 1)
      combine_kernel<__nv_bfloat16><<<rows, threads, 0, st>>>(p);
    else
      combine_kernel<float><<<rows, threads, 0, st>>>(p);
    e = cudaGetLastError();
  }
  return (int)e;
}
