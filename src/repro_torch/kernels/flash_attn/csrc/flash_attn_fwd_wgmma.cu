// Flash-attention forward for Hopper (sm_90a), bf16, head dim 128: the
// prefill and scoring kernel, warp-specialised on wgmma and TMA, with a
// persistent grid.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py:66, body _kernel :25-63)
// for bf16 calls with hd = 128 and at least 64 query rows; its sibling
// flash_attn_fwd_wgmma256.cu takes hd = 256, and the mma.sync kernel of
// flash_attn_fwd.cu keeps decode, f32 and the other head dims. The helpers
// both share are in flash_attn_wgmma.cuh.
// For q (b, sq, hq, hd) and k, v (b, skv, hkv, hd), read in place through
// their strides, query head h (kv head h / g), query position
// qpos = q_offset + i and key position j:
//     s_j = scale * <q, k_j>, masked unless j < skv, j <= qpos (causal)
//           and j > qpos - window (window > 0)
//     o   = sum_j softmax(s)_j v_j
// with the online softmax (acc, m, l) carried over kv tiles in f32 and
// o = acc / max(l, 1e-30).
//
// P is rounded to bf16 for the P.V product, once, as in the mma.sync
// kernel: wgmma takes a register A operand only in 16 bits or fewer, and
// an f32 P.V would run at the TF32 rate, half the bf16 one. The rounding
// is held per query row against an f32 oracle (chip_smoke.py K5_ROW_REL).
//
// Bound: 4 * b * hq * hd * sum_i(i + 1) flop (causal) at 989 TFLOP/s bf16,
// the operations: at cell C's prefill (8 x 4096, 24/8 heads of 128) that is
// 8.25e11 flop, 0.834 ms, against 0.54 GB of q, k, v and o (0.16 ms at
// 3.35 TB/s). What each design choice does about it:
//   * wgmma m64n128k16 (f32 += bf16 x bf16), the only way to the full
//     tensor-core rate: S = Q K^T with both operands in shared memory
//     (K-major), O += P V with P from registers (the f32 accumulator of S,
//     packed in pairs, is the bf16 A fragment) and V as the N-major B
//     operand through the descriptor's transpose bit, with no copy.
//   * A work tile is 128 query rows of ONE query head, as two consumer
//     warpgroups of 64 rows; kv tiles of 128 keys.
//   * Persistent grid: one block per SM walks the work tiles, numbered row
//     block first, heaviest (last) causal row block first, then batch and
//     query head, so the g heads of a kv group run side by side on
//     neighbouring blocks and read their K and V tiles from the 50 MB L2,
//     and the light tiles form the tail. The blocks take the tiles in
//     rounds of one each, in a snake (block i takes the i-th tile of even
//     rounds and the i-th from the end of odd ones), which evens out the
//     causal tiles' unequal work. A block pays its set-up once; the next
//     tile's loads are in flight before this one ends, and its first
//     Q K^T is issued with this one's last P V. The walk is static: no
//     atomics, so two launches on the same inputs give the same bits.
//   * Warpgroup 0 produces: one thread each of three warps issues TMA
//     loads (cp.async.bulk.tensor, 4-D maps (hd, s, heads, b) with the
//     tensors' own byte strides, 128-byte swizzle, two 64-column boxes a
//     tile) of Q into two buffers (the next tile's Q lands while this one
//     computes), of K into a ring of kKStages and of V into a ring of
//     kVStages, each slot with full and empty mbarriers. K's slot empties
//     when S = Q K^T is done, V's when O += P V is: K runs ahead of V.
//     Shared memory: (2 + 3 + 2) x 32 KB = 224 KB, one block an SM. No
//     __syncthreads in the loop. setmaxnreg gives the producer 24
//     registers and each consumer 240, so S, O and P (64 + 64 + 32 per
//     thread) stay in registers.
//   * Within a consumer warpgroup, kv tile t's Q K^T is issued together
//     with tile t-1's P V, and t's softmax runs while P V computes. Between
//     the two groups, named barriers pass a turn (ping-pong): a group
//     issues its products only in its turn and hands it over once issued,
//     so one group's softmax overlaps the other's products.
//   * A k or v map spans the prefix length skv, not the cache's
//     capacity: TMA zero-fills keys >= skv and query rows >= sq.
//   * Only kv tiles that straddle the causal diagonal, the window's edge
//     or skv take the per-element mask; interior tiles take none. Tiles
//     wholly above the diagonal or before the window are never loaded. A
//     masked score is -inf, and the running max starts from -1e30, so a
//     row whose first tiles are wholly masked gets P = 0 there, never NaN.
//   * exp2 of one FMA: P = exp2(s * scale * log2(e) - m), the row max
//     taken on the unscaled scores, so scale > 0 (the wrapper's dispatch
//     rule sends any other scale to the mma.sync kernel).
//   * Epilogue: normalise by l, round to bf16 into the warpgroup's own Q
//     rows in shared memory (swizzled, bank-conflict free) and TMA-store
//     them; rows past sq are clipped by the map. The Q buffer goes back to
//     the producer once the store has read it.

#include "flash_attn_wgmma.cuh"

namespace {

constexpr int kHd = 128;
constexpr int kBlockM = 128;               // query rows per work tile
constexpr int kBlockN = 128;               // keys per kv tile
constexpr int kKStages = 3;                // K ring depth
constexpr int kVStages = 2;                // V ring depth
constexpr int kThreads = 384;              // producer WG + 2 consumer WGs
constexpr int kHalf = kBlockM * 64 * 2;    // one 64-column box: 16 KB
constexpr int kTile = 2 * kHalf;           // a 128 x 128 bf16 tile: 32 KB
constexpr int kBars = 2 * (2 + kKStages + kVStages);
constexpr int kSmemBytes = (2 + kKStages + kVStages) * kTile + 1024 + 8 * kBars;
static_assert(kSmemBytes <= 232448, "more shared memory than a block has");

// wgmma descriptor strides, in 16-byte units. K-major Q and K: 1024 bytes
// between 8-row groups (the leading offset is unused under the swizzle).
// N-major V (the B operand of P V): the leading offset steps between its
// two 64-column boxes, the stride offset between 8-key groups.
constexpr uint32_t kSbo = 1024 / 16;
constexpr uint32_t kVLbo = kHalf / 16;

struct Params {
  int b, sq, skv, hq, g;
  int causal, window, q_offset;
  int n_mb, n_tiles;  // row blocks per head; work tiles in all
  float scale_log2;   // scale * log2(e)
};

// ---------------------------------------------------------------------------
// wgmma m64n128k16
// ---------------------------------------------------------------------------
#define K5_D_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define K5_D_OPS                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 128), A and
// B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K5_D_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : K5_D_OPS
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (64 x 16, bf16 fragments in registers) B (16 x 128), B N-major in
// shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K5_D_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : K5_D_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the work tiles and their kv ranges
// ---------------------------------------------------------------------------
struct Tile {
  int m0, h, bi;      // first query row, query head, batch row
  int t_begin, t_end;  // the kv tiles it visits
};

// Work tile t: row block n_mb - 1 - t / (b hq) (the heaviest first), then
// batch row and query head, the query heads of one batch row adjacent.
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  const int bh = p.b * p.hq;
  const int r = t % bh;
  Tile c;
  c.m0 = (p.n_mb - 1 - t / bh) * kBlockM;
  c.h = r % p.hq;
  c.bi = r / p.hq;
  // the union of the tile's rows' unmasked keys (every row has one: the
  // wrapper checks it, so t_end > t_begin)
  const int q_lo = p.q_offset + c.m0;
  const int q_hi = p.q_offset + min(c.m0 + kBlockM, p.sq) - 1;
  const int kv_end = p.causal ? min(p.skv, q_hi + 1) : p.skv;
  const int kv_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  c.t_begin = kv_begin / kBlockN;
  c.t_end = (kv_end + kBlockN - 1) / kBlockN;
  return c;
}

// ---------------------------------------------------------------------------
// the kernel: warpgroup 0 produces, warpgroups 1 and 2 consume
// ---------------------------------------------------------------------------
// Accumulator layout of wgmma m64n128 (per warpgroup): warp wi of the
// group holds rows 16 wi + lane / 4 (d[4j], d[4j+1]) and + 8 (d[4j+2],
// d[4j+3]), at columns 8 j + 2 (lane % 4) + {0, 1}, j = 0..15.
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap omap,
                           const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle atoms and the wgmma descriptors
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // [2] tiles
  const uint32_t sK = sQ + 2 * kTile;             // [kKStages] tiles
  const uint32_t sV = sK + kKStages * kTile;      // [kVStages] tiles
  const uint32_t bars = sV + kVStages * kTile;    // 8 bytes each
  auto q_full = [&](int b) { return bars + 8u * b; };
  auto q_empty = [&](int b) { return bars + 8u * (2 + b); };
  auto k_full = [&](int s) { return bars + 8u * (4 + s); };
  auto k_empty = [&](int s) { return bars + 8u * (4 + kKStages + s); };
  auto v_full = [&](int s) { return bars + 8u * (4 + 2 * kKStages + s); };
  auto v_empty = [&](int s) {
    return bars + 8u * (4 + 2 * kKStages + kVStages + s);
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full(b), 1);
      mbar_init(q_empty(b), 2);            // one thread of each group
    }
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // warp 0 loads Q, warp 1 K, warp 2 V, each walking the same tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && warp < 3) {
      int it = 0;  // kv tiles loaded so far, over all work tiles
      for (int n = 0, t = walk(0); t < p.n_tiles; t = walk(++n)) {
        const Tile c = tile_at(p, t);
        if (warp == 0) {
          const int qb = n & 1;
          if (n >= 2) mbar_wait(q_empty(qb), ((n >> 1) - 1) & 1);
          const uint32_t dst = sQ + qb * kTile;
          mbar_expect_tx(q_full(qb), kTile);
          tma_load(dst, &qmap, q_full(qb), 0, c.m0, c.h, c.bi);
          tma_load(dst + kHalf, &qmap, q_full(qb), 64, c.m0, c.h, c.bi);
          continue;
        }
        const int kvh = c.h / p.g;
        for (int kt = c.t_begin; kt < c.t_end; ++kt, ++it) {
          const int key0 = kt * kBlockN;
          if (warp == 1) {
            const int s = it % kKStages;
            if (it >= kKStages)
              mbar_wait(k_empty(s), ((it / kKStages) - 1) & 1);
            const uint32_t dst = sK + s * kTile;
            mbar_expect_tx(k_full(s), kTile);
            tma_load(dst, &kmap, k_full(s), 0, key0, kvh, c.bi);
            tma_load(dst + kHalf, &kmap, k_full(s), 64, key0, kvh, c.bi);
          } else {
            const int s = it % kVStages;
            if (it >= kVStages)
              mbar_wait(v_empty(s), ((it / kVStages) - 1) & 1);
            const uint32_t dst = sV + s * kTile;
            mbar_expect_tx(v_full(s), kTile);
            tma_load(dst, &vmap, v_full(s), 0, key0, kvh, c.bi);
            tma_load(dst + kHalf, &vmap, v_full(s), 64, key0, kvh, c.bi);
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;                  // this group's rows: 64 w ..
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, quad = lane % 4;
    const int row = w * 64 + (tid / 32) * 16 + lane / 4;  // and row + 8

    float o[64], s[64];
    float mx0, mx1, l0, l1;  // l: this thread's part
    uint32_t pa[8][4];
    uint32_t sQb = sQ;       // this tile's Q buffer
    int qpos0 = 0, qpos1 = 0, g_lo = 0, g_hi = 0;

    // S = Q K^T of the K tile in slot st, issued (not waited for)
    auto issue_qk = [&](int st) {
      const uint32_t kt = sK + st * kTile;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        wgmma_ss(s, desc_sw128(sQb + w * 64 * 128 + off, 1, kSbo),
                 desc_sw128(kt + off, 1, kSbo), kk > 0);
      }
      wg_commit();
    };
    // O += P V of the V tile in slot st, issued (not waited for)
    auto issue_pv = [&](int st) {
      const uint32_t vt = sV + st * kTile;
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs(o, pa[kk], desc_sw128(vt + kk * 16 * 128, kVLbo, kSbo));
      wg_commit();
    };
    // S of kv tile t -> P = exp2(S - m) in place (f32), m and l updated;
    // c0, c1: the factors by which O's rows must be rescaled
    auto softmax = [&](int t, float& c0, float& c1) {
      // the per-element mask only on edge tiles (on the unscaled scores):
      // a masked score becomes -inf, so its P is exactly 0 whatever m is
      const int key0 = t * kBlockN;
      const bool edge = key0 + kBlockN > p.skv ||
                        (p.causal && key0 + kBlockN - 1 > g_lo) ||
                        (p.window > 0 && key0 <= g_hi - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = key0 + (i / 4) * 8 + quad * 2 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          const bool ok = key < p.skv && (!p.causal || key <= qpos) &&
                          (p.window <= 0 || key > qpos - p.window);
          if (!ok) s[i] = __int_as_float(0xff800000u);  // -inf
        }
      }
      // online softmax in the log2 domain: m is scale * log2(e) times the
      // row's largest score (scale > 0), and P = exp2(s * that - m) one
      // FMA and one ex2 an element. The row maxima start from -1e30, so m
      // stays finite. A row wholly masked so far keeps P = 0, l = 0 and
      // O = 0 where the reference's -1e30 scores give P = 1; the factor
      // exp(-1e30 - m) of the row's first real maximum wipes those terms
      // to exactly 0, so both end alike.
      float t0 = kNeg, t1 = kNeg;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        t0 = fmaxf(t0, fmaxf(s[i], s[i + 1]));
        t1 = fmaxf(t1, fmaxf(s[i + 2], s[i + 3]));
      }
      const float sl = p.scale_log2;
      const float n0 = fmaxf(mx0, quad_max(t0) * sl);
      const float n1 = fmaxf(mx1, quad_max(t1) * sl);
      c0 = ex2(mx0 - n0);
      c1 = ex2(mx1 - n1);
      mx0 = n0;
      mx1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        s[i] = ex2(fmaf(s[i], sl, -n0));
        s[i + 1] = ex2(fmaf(s[i + 1], sl, -n0));
        s[i + 2] = ex2(fmaf(s[i + 2], sl, -n1));
        s[i + 3] = ex2(fmaf(s[i + 3], sl, -n1));
        sum0 += s[i] + s[i + 1];
        sum1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
    };
    // O's rows rescaled, and P packed into the bf16 A fragments of P V
    auto rescale_pack = [&](float c0, float c1) {
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        o[i] *= c0;
        o[i + 1] *= c0;
        o[i + 2] *= c1;
        o[i + 3] *= c1;
      }
      // s[8 kk + u] holds keys 16 kk + 2 quad + (u & 1) (+ 8 for u >= 4)
      // of row (u & 2 ? row + 8 : row): the A fragment of keys 16 kk..
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // the epilogue of work tile d: o / l in bf16 into this group's rows of
    // d's Q buffer (swizzled as TMA lays them out), then two TMA stores of
    // 64 rows x 64 columns; the buffer goes back to the producer once they
    // have read it (release_q)
    auto epilogue = [&](const Tile& d, uint32_t buf, float la, float lb) {
      la = quad_sum(la);
      lb = quad_sum(lb);
      const float i0 = 1.f / fmaxf(la, 1e-30f), i1 = 1.f / fmaxf(lb, 1e-30f);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t at = buf + (j / 8) * kHalf + row * 128 +
                            (((j % 8) ^ (row % 8)) * 16) + quad * 4;
        const uint32_t v0 = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
        const uint32_t v1 = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v0)
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                     "r"(v1)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
      if (tid == 0) {
        tma_store(&omap, buf + w * 64 * 128, 0, d.m0 + w * 64, d.h, d.bi);
        tma_store(&omap, buf + kHalf + w * 64 * 128, 64, d.m0 + w * 64, d.h,
                  d.bi);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    };
    bool pending = false;  // an O store may still read Q buffer pending_qb
    int pending_qb = 0;
    auto release_q = [&]() {
      if (pending && tid == 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty(pending_qb));
      }
      pending = false;
    };
    // enter work tile tt, the block's n-th: its geometry and a fresh (m, l)
    Tile c;
    auto enter = [&](int tt, int n) {
      c = tile_at(p, tt);
      sQb = sQ + (n & 1) * kTile;
      qpos0 = p.q_offset + c.m0 + row;
      qpos1 = qpos0 + 8;
      // this group's rows, for the choice of masked tiles
      g_lo = p.q_offset + c.m0 + w * 64;
      g_hi = p.q_offset + min(c.m0 + w * 64 + 64, p.sq) - 1;
      mx0 = mx1 = kNeg;
      l0 = l1 = 0.f;
    };

    // Ping-pong between the two consumer warpgroups: a group issues its
    // products only in its turn (named barrier 3 + w) and hands it over
    // once they are issued, so one group's softmax runs while the other's
    // products keep the tensor cores busy. Both groups issue the same
    // number of times; group 0 takes the turn once more at the end, so no
    // hand-over is left pending at exit.
    const int other = 1 - w;
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + w) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + other) : "memory");
    };
    if (w == 1) turn_pass();                 // group 0 goes first

    // Software pipeline: kv tile j's Q K^T is issued with tile j-1's P V,
    // and j's softmax runs while P V computes; a work tile's last P V goes
    // with the next work tile's first Q K^T.
    int it = 0;  // kv tiles consumed so far, over all work tiles
    int n = 0, t = walk(0);
    float c0, c1;
    if (t < p.n_tiles) {
      enter(t, 0);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      mbar_wait(q_full(0), 0);
      mbar_wait(k_full(0), 0);
      turn_wait();
      issue_qk(0);
      turn_pass();
      wg_wait0();
      fence_regs(s);
      mbar_arrive(k_empty(0));
      softmax(c.t_begin, c0, c1);
      rescale_pack(c0, c1);
    }
    while (t < p.n_tiles) {
      const int n_kv = c.t_end - c.t_begin;
      for (int j = 1; j < n_kv; ++j) {
        const int cur = it + j, prev = cur - 1;
        const int sk = cur % kKStages, sv = prev % kVStages;
        mbar_wait(k_full(sk), (cur / kKStages) & 1);
        mbar_wait(v_full(sv), (prev / kVStages) & 1);
        turn_wait();
        issue_qk(sk);
        issue_pv(sv);
        turn_pass();
        release_q();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(s);
        mbar_arrive(k_empty(sk));
        softmax(c.t_begin + j, c0, c1);
        wg_wait0();
        fence_regs(o);
        mbar_arrive(v_empty(sv));
        rescale_pack(c0, c1);
      }
      const int last = it + n_kv - 1, sv = last % kVStages;
      it += n_kv;
      const Tile done = c;
      const uint32_t done_q = sQb;
      const float la = l0, lb = l1;
      const int tn = walk(n + 1);
      mbar_wait(v_full(sv), (last / kVStages) & 1);
      if (tn < p.n_tiles) {
        // the next work tile's first Q K^T with this one's last P V
        release_q();  // its Q buffer may be the one a store still reads
        enter(tn, n + 1);
        const int sk = it % kKStages;
        mbar_wait(q_full((n + 1) & 1), ((n + 1) >> 1) & 1);
        mbar_wait(k_full(sk), (it / kKStages) & 1);
        turn_wait();
        issue_qk(sk);
        issue_pv(sv);
        turn_pass();
        wg_wait0();
        fence_regs(s);
        fence_regs(o);
        mbar_arrive(k_empty(sk));
        mbar_arrive(v_empty(sv));
        epilogue(done, done_q, la, lb);
        pending = true;
        pending_qb = n & 1;
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] = 0.f;
        softmax(c.t_begin, c0, c1);
        rescale_pack(c0, c1);
      } else {
        issue_pv(sv);
        wg_wait0();
        fence_regs(o);
        mbar_arrive(v_empty(sv));
        epilogue(done, done_q, la, lb);
      }
      ++n;
      t = tn;
    }
    if (w == 0) turn_wait();                 // group 1's last hand-over
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

}  // namespace

// q (b, sq, hq, 128), k and v (b, skv, hkv, 128), o (b, sq, hq, 128), all
// bf16 with a unit stride on hd, 16-byte aligned bases and strides. geo
// holds 7 numbers for each of q, k, v and o in that order: the dims (hd,
// s, heads, b) and the byte strides of s, heads and b (the wrapper's
// ``tma_geometry``). The persistent grid has one block per SM of the
// current device, fewer when there are fewer tiles. Returns 0, a
// cudaError_t, 999 when the driver's cuTensorMapEncodeTiled is not found,
// or 1000 + its CUresult.
extern "C" int flash_fwd_wgmma_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const unsigned long long* geo, int b,
                                      int sq, int skv, int hq, int hkv,
                                      int causal, int window, int q_offset,
                                      float scale,
                                      void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  int err;
  if ((err = make_map(&qm, q, geo, kBlockM)) ||
      (err = make_map(&km, k, geo + 7, kBlockN)) ||
      (err = make_map(&vm, v, geo + 14, kBlockN)) ||
      (err = make_map(&om, o, geo + 21, 64)))
    return err;
  // the attribute belongs to the current device's context: set on every
  // launch, so a second card or a reset context gets it too
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  int dev, sms;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.g = hq / hkv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.n_mb = (sq + kBlockM - 1) / kBlockM;
  const long long n_tiles = (long long)p.n_mb * b * hq;
  if (n_tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  p.scale_log2 = scale * kLog2e;
  int blocks = p.n_tiles < sms ? p.n_tiles : sms;
  flash_fwd_wgmma_kernel<<<blocks, kThreads, kSmemBytes,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, om, p);
  return (int)cudaGetLastError();
}
