// Flash-attention forward for Hopper (sm_90a), bf16, head dim 256 (gemma3):
// the prefill and scoring kernel, warp-specialised on wgmma and TMA, with a
// persistent grid. The sibling of flash_attn_fwd_wgmma.cu (head dim 128),
// whose design it keeps; the helpers both use are in flash_attn_wgmma.cuh.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py:66, body _kernel :25-63)
// for bf16 calls with hd = 256 and at least 64 query rows; the mma.sync
// kernel of flash_attn_fwd.cu keeps the hd-256 decode. For q (b, sq, hq,
// hd) and k, v (b, skv, hkv, hd), read in place through their strides,
// query head h (kv head h / g), query position qpos = q_offset + i and key
// position j:
//     s_j = scale * <q, k_j>, masked unless j < skv, j <= qpos (causal)
//           and j > qpos - window (window > 0)
//     o   = sum_j softmax(s)_j v_j
// with the online softmax (acc, m, l) carried over kv tiles in f32 and
// o = acc / max(l, 1e-30). P is rounded to bf16 for P.V once, as in the
// other two kernels.
//
// Bound: 4 * b * hq * hd * sum_i(i + 1) flop (causal) at 989 TFLOP/s bf16,
// the operations: at gemma3's prefill (8 x 1024, 16/8 heads of 256) that is
// 6.88e10 flop, 0.0696 ms, against 0.20 GB of q, k, v and o (0.060 ms at
// 3.35 TB/s). What each design choice does about it:
//   * The design of the hd-128 kernel: wgmma (f32 += bf16 x bf16) with
//     S = Q K^T from shared memory (K-major) and O += P V with P from
//     registers and V N-major through the transpose bit; a work tile of
//     128 query rows of one head as two consumer warpgroups of 64 rows in
//     ping-pong, tile t's Q K^T issued with tile t-1's P V; a producer
//     warpgroup issuing TMA loads (4-D maps, 128-byte swizzle) into rings
//     with full and empty mbarriers, K and V apart; masks on edge tiles
//     only; the persistent grid's static snake walk (no atomics: two
//     launches give the same bits); exp2 of one FMA, so scale > 0.
//   * Registers. A consumer thread holds O, 64 x 256 f32 over 128 threads:
//     128 registers (wgmma m64n256k16). Beside it S of a kv tile of N keys
//     takes N / 2 and P in bf16 N / 4. At N = 128 that is 128 + 64 + 32 =
//     224 before addresses, the softmax state and the loop: over
//     setmaxnreg's 240. At N = 64 it is 176, so kv tiles are 64 keys:
//     Q K^T is 16 wgmma m64n64k16 (K = hd = 256) and P V 4 m64n256k16.
//     setmaxnreg gives the producer 24 registers and each consumer 240.
//   * Shared memory (232,448 bytes a block). A 128-row Q tile is 64 KB, a
//     64-key K or V tile 32 KB. Two Q tiles (the hd-128 kernel's double
//     buffer) would leave 96 KB for K and V: one stage of either, which
//     stalls the tensor cores every kv tile. So Q lives in a ring of three
//     64-row halves (96 KB), one half per consumer group and work tile
//     (half 2n + w of the block's n-th tile, group w): the next tile's
//     first half lands while this tile computes, and its second half in
//     the slot of this tile's first half, released as soon as group 0's
//     last Q K^T of the tile has retired, a kv tile before group 1 needs
//     it. K and V take two stages each (64 + 64 KB): 224 KB in all, plus
//     the 1 KB alignment slack and 14 mbarriers (static_assert below).
//   * Epilogue. O (128 x 256 bf16, 64 KB) has no shared memory left to be
//     staged in for a TMA store, and staging it in a Q slot would hold the
//     next Q load back until the store has read it. So each thread writes
//     its normalised bf16 rows straight to global memory, 16 bytes a
//     store after a 4 x 4 transpose of its quad's words by shuffles (the
//     4-byte pairs of the accumulator layout, stored as they are, took
//     0.165 ms where this takes 0.139 at gemma3's prefill, an H100 80GB
//     HBM3 at 700 W); rows past sq are not written. The Q half is released
//     after the last Q K^T, before the epilogue, so the next tile's Q load
//     does not wait for it.
//   * Group 0's last kv tile of a causal work tile is wholly masked for
//     its rows, yet it computes it as group 1 does: a wgmma issued under a
//     branch makes ptxas serialize every wgmma of the kernel (C7520), and
//     skipping such tiles that way took 0.229 ms at gemma3's prefill where
//     computing them takes 0.165 (4-byte epilogue stores, H100 80GB HBM3,
//     700 W).
//   * TMA. The 128-byte swizzle caps a box's inner dim at 64 bf16, so a
//     256-wide row is four boxes of 64 columns: Q halves, K and V tiles
//     are each four 64-row boxes of 8 KB, and each slot's expect-tx count
//     is 32 KB. TMA zero-fills keys >= skv and query rows >= sq.
//   * The walk. The hd-128 kernel numbers the work tiles row block first
//     (heaviest first) over all heads, which balances the blocks best. At
//     gemma3's prefill k and v hold 64 MB, more than the 50 MB L2, and that
//     order reads every kv head's keys again for each row block. So where
//     the K and V that one row block reads in all (batch row, kv head)
//     groups exceed half of L2, the row blocks are taken in chunks: within
//     a chunk group by group, within a group its row blocks (heaviest
//     first) with its g query heads side by side, about kGroupTiles tiles
//     of a group in a chunk; the blocks then share a few groups' K and V,
//     which stay in L2. Where they fit (a window that cuts, few groups), a
//     chunk is one row block: the row-block-first order. On an H100 80GB
//     HBM3 at 700 W the chunked walk took 0.140 ms at gemma3's prefill
//     where row block first took 0.158, and row block first 0.232 ms at
//     (2, 4096) with the window of 1024 where chunks took 0.247.

#include "flash_attn_wgmma.cuh"

namespace {

constexpr int kHd = 256;
constexpr int kBlockM = 128;              // query rows per work tile
constexpr int kRows = 64;                 // a consumer group's rows: a Q half
constexpr int kBlockN = 64;               // keys per kv tile
constexpr int kQSlots = 3;                // Q ring depth, in halves
constexpr int kKStages = 2;               // K ring depth
constexpr int kVStages = 2;               // V ring depth
constexpr int kThreads = 384;             // producer WG + 2 consumer WGs
constexpr int kBox = 64 * 128;            // 64 rows x 64 columns: 8 KB
constexpr int kSlot = (kHd / 64) * kBox;  // 64 rows x 256 columns: 32 KB
constexpr int kBars = 2 * (kQSlots + kKStages + kVStages);
constexpr int kSmemBytes =
    (kQSlots + kKStages + kVStages) * kSlot + 1024 + 8 * kBars;
static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
static_assert(kRows == kBlockN, "a Q half and a K or V tile share kSlot");
constexpr int kGroupTiles = 16;           // a chunked walk's tiles of one
                                          // group in a chunk (see tile_at)

// wgmma descriptor strides, in 16-byte units. K-major Q and K: 1024 bytes
// between 8-row groups (the leading offset is unused under the swizzle).
// N-major V (the B operand of P V): the leading offset steps between its
// four 64-column boxes, the stride offset between 8-key groups.
constexpr uint32_t kSbo = 1024 / 16;
constexpr uint32_t kVLbo = kBox / 16;

struct Params {
  int b, sq, skv, hq, hkv, g;
  int causal, window, q_offset;
  int n_mb, n_tiles;   // row blocks per head; work tiles in all
  int chunk;           // row blocks of a chunk of the walk
  float scale_log2;    // scale * log2(e)
  uint16_t* o;         // bf16 output
  long long o_sb, o_ss, o_sh;  // its strides in elements: batch, s, head
};

// ---------------------------------------------------------------------------
// wgmma m64n64k16 (S = Q K^T) and m64n256k16 (O += P V)
// ---------------------------------------------------------------------------
#define K5_S_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define K5_S_OPS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])
#define K5_O_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define K5_O_OPS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 64, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 64), A and
// B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K5_S_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : K5_S_OPS
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 256, f32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 256), B N-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_pv(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " K5_O_REGS
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : K5_O_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the work tiles and their kv ranges
// ---------------------------------------------------------------------------
struct Tile {
  int m0, h, bi;       // first query row, query head, batch row
  int t_begin, t_end;  // the kv tiles it visits
};

// Work tile t: the row blocks in chunks of p.chunk, the heaviest (last)
// chunk first; within a chunk the (batch row, kv head) groups in turn;
// within a group the chunk's row blocks, heaviest first, each with the
// group's g query heads side by side. The last chunk may be shorter.
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  const int full = p.b * p.hkv * p.chunk * p.g;  // tiles of a full chunk
  const int k = t / full, rem = t % full;
  const int rows = min(p.chunk, p.n_mb - k * p.chunk);  // this chunk's
  const int grp = rem / (rows * p.g), r = rem % (rows * p.g);
  Tile c;
  c.m0 = (p.n_mb - 1 - k * p.chunk - r / p.g) * kBlockM;
  c.bi = grp / p.hkv;
  c.h = (grp % p.hkv) * p.g + r % p.g;
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
// Accumulator layout of wgmma m64nN (per warpgroup): warp wi of the group
// holds rows 16 wi + lane / 4 (d[4j], d[4j+1]) and + 8 (d[4j+2], d[4j+3]),
// at columns 8 j + 2 (lane % 4) + {0, 1}, j = 0 .. N / 8 - 1.
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma256_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the swizzle atoms and the wgmma descriptors
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // [kQSlots] halves
  const uint32_t sK = sQ + kQSlots * kSlot;       // [kKStages] tiles
  const uint32_t sV = sK + kKStages * kSlot;      // [kVStages] tiles
  const uint32_t bars = sV + kVStages * kSlot;    // 8 bytes each
  auto q_full = [&](int s) { return bars + 8u * s; };
  auto q_empty = [&](int s) { return bars + 8u * (kQSlots + s); };
  auto k_full = [&](int s) { return bars + 8u * (2 * kQSlots + s); };
  auto k_empty = [&](int s) {
    return bars + 8u * (2 * kQSlots + kKStages + s);
  };
  auto v_full = [&](int s) {
    return bars + 8u * (2 * kQSlots + 2 * kKStages + s);
  };
  auto v_empty = [&](int s) {
    return bars + 8u * (2 * kQSlots + 2 * kKStages + kVStages + s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQSlots; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), 128);          // every thread of its group
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
    // warp 0 loads the Q halves, warp 1 K, warp 2 V, each walking the same
    // tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0 && warp < 3) {
      int it = 0;  // kv tiles loaded so far, over all work tiles
      for (int n = 0, t = walk(0); t < p.n_tiles; t = walk(++n)) {
        const Tile c = tile_at(p, t);
        if (warp == 0) {
          for (int w = 0; w < 2; ++w) {
            const int idx = 2 * n + w, s = idx % kQSlots;
            if (idx >= kQSlots)
              mbar_wait(q_empty(s), ((idx / kQSlots) - 1) & 1);
            const uint32_t dst = sQ + s * kSlot;
            mbar_expect_tx(q_full(s), kSlot);
            for (int x = 0; x < kHd / 64; ++x)
              tma_load(dst + x * kBox, &qmap, q_full(s), 64 * x,
                       c.m0 + kRows * w, c.h, c.bi);
          }
          continue;
        }
        const int kvh = c.h / p.g;
        for (int kt = c.t_begin; kt < c.t_end; ++kt, ++it) {
          const int key0 = kt * kBlockN;
          const bool is_k = warp == 1;
          const int stages = is_k ? kKStages : kVStages;
          const int s = it % stages;
          if (it >= stages)
            mbar_wait(is_k ? k_empty(s) : v_empty(s),
                      ((it / stages) - 1) & 1);
          const uint32_t dst = (is_k ? sK : sV) + s * kSlot;
          const uint32_t full = is_k ? k_full(s) : v_full(s);
          mbar_expect_tx(full, kSlot);
          for (int x = 0; x < kHd / 64; ++x)
            tma_load(dst + x * kBox, is_k ? &kmap : &vmap, full, 64 * x,
                     key0, kvh, c.bi);
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

    float o[128], s[32];
    float mx0, mx1, l0, l1;  // l: this thread's part
    uint32_t pa[4][4];
    uint32_t sQw = sQ;       // this tile's Q half
    int q_slot = 0, q_par = 0;
    int qpos0 = 0, qpos1 = 0, g_lo = 0, g_hi = 0;

    // S = Q K^T of the K tile in slot st, issued (not waited for)
    auto issue_qk = [&](int st) {
      const uint32_t kt = sK + st * kSlot;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
        wgmma_qk(s, desc_sw128(sQw + off, 1, kSbo),
                 desc_sw128(kt + off, 1, kSbo), kk > 0);
      }
      wg_commit();
    };
    // O += P V of the V tile in slot st, issued (not waited for)
    auto issue_pv = [&](int st) {
      const uint32_t vt = sV + st * kSlot;
      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_pv(o, pa[kk], desc_sw128(vt + kk * 16 * 128, kVLbo, kSbo));
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
        for (int i = 0; i < 32; ++i) {
          const int key = key0 + (i / 4) * 8 + quad * 2 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          const bool ok = key < p.skv && (!p.causal || key <= qpos) &&
                          (p.window <= 0 || key > qpos - p.window);
          if (!ok) s[i] = __int_as_float(0xff800000u);  // -inf
        }
      }
      // online softmax in the log2 domain, as in the hd-128 kernel: m is
      // scale * log2(e) times the row's largest score, P = exp2(s * that
      // - m); the maxima start from -1e30, so a row wholly masked so far
      // keeps P = 0, l = 0 and O = 0, and ends as the reference's
      float t0 = kNeg, t1 = kNeg;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
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
      for (int i = 0; i < 32; i += 4) {
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
      for (int i = 0; i < 128; i += 4) {
        o[i] *= c0;
        o[i + 1] *= c0;
        o[i + 2] *= c1;
        o[i + 3] *= c1;
      }
      // s[8 kk + u] holds keys 16 kk + 2 quad + (u & 1) (+ 8 for u >= 4)
      // of row (u & 2 ? row + 8 : row): the A fragment of keys 16 kk..
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    // the epilogue of work tile d: o / l in bf16 straight to global
    // memory, 16 bytes a store, rows past sq left out. A thread holds the
    // pairs of columns 8 j + 2 quad of its two rows; a 4 x 4 transpose of
    // the quad's words (two rounds of shuffles) gives it columns
    // 8 (4 jb + quad) .. + 7 of each, for jb = 0 .. 7
    auto epilogue = [&](const Tile& d, float la, float lb) {
      la = quad_sum(la);
      lb = quad_sum(lb);
      const float i0 = 1.f / fmaxf(la, 1e-30f), i1 = 1.f / fmaxf(lb, 1e-30f);
      const int m = d.m0 + row;
      uint16_t* r0 = p.o + d.bi * p.o_sb + (long long)m * p.o_ss +
                     d.h * p.o_sh + 8 * quad;
      uint16_t* r1 = r0 + 8 * p.o_ss;
      const bool ok0 = m < p.sq, ok1 = m + 8 < p.sq;
      const bool hi = quad & 2, odd = quad & 1;
      // x[u] of lane quad q becomes x[q] of lane quad u
      auto transpose = [&](uint32_t(&x)[4]) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const uint32_t got =
              __shfl_xor_sync(0xffffffffu, hi ? x[k] : x[2 + k], 2);
          if (hi)
            x[k] = got;
          else
            x[2 + k] = got;
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const uint32_t got =
              __shfl_xor_sync(0xffffffffu, odd ? x[2 * k] : x[2 * k + 1], 1);
          if (odd)
            x[2 * k] = got;
          else
            x[2 * k + 1] = got;
        }
      };
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        uint32_t a[4], b[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * jb + u;
          a[u] = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
          b[u] = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
        }
        transpose(a);
        transpose(b);
        if (ok0)
          *reinterpret_cast<uint4*>(r0 + 32 * jb) =
              make_uint4(a[0], a[1], a[2], a[3]);
        if (ok1)
          *reinterpret_cast<uint4*>(r1 + 32 * jb) =
              make_uint4(b[0], b[1], b[2], b[3]);
      }
    };
    // enter work tile tt, the block's n-th: its geometry, its Q half and a
    // fresh (m, l)
    Tile c;
    auto enter = [&](int tt, int n) {
      c = tile_at(p, tt);
      const int idx = 2 * n + w;
      q_slot = idx % kQSlots;
      q_par = (idx / kQSlots) & 1;
      sQw = sQ + q_slot * kSlot;
      qpos0 = p.q_offset + c.m0 + row;
      qpos1 = qpos0 + 8;
      // this group's rows, for the choice of masked tiles
      g_lo = p.q_offset + c.m0 + w * 64;
      g_hi = p.q_offset + min(c.m0 + w * 64 + 64, p.sq) - 1;
      mx0 = mx1 = kNeg;
      l0 = l1 = 0.f;
    };
    // after the Q K^T of kv tile j of n_kv has retired in this thread: the
    // last one hands the Q half back to the producer
    auto qk_retired = [&](int j, int n_kv) {
      if (j == n_kv - 1) mbar_arrive(q_empty(q_slot));
    };

    // Ping-pong between the two consumer warpgroups: a group issues its
    // products only in its turn (named barrier 1 + w) and hands it over
    // once they are issued. Both groups issue the same number of times;
    // group 0 takes the turn once more at the end, so no hand-over is left
    // pending at exit.
    const int other = 1 - w;
    auto turn_wait = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
    };
    auto turn_pass = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + other) : "memory");
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
      for (int i = 0; i < 128; ++i) o[i] = 0.f;
      mbar_wait(q_full(q_slot), q_par);
      mbar_wait(k_full(0), 0);
      turn_wait();
      issue_qk(0);
      turn_pass();
      wg_wait0();
      fence_regs(s);
      mbar_arrive(k_empty(0));
      qk_retired(0, c.t_end - c.t_begin);
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
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(s);
        mbar_arrive(k_empty(sk));
        qk_retired(j, n_kv);
        softmax(c.t_begin + j, c0, c1);
        wg_wait0();
        fence_regs(o);
        mbar_arrive(v_empty(sv));
        rescale_pack(c0, c1);
      }
      const int last = it + n_kv - 1, sv = last % kVStages;
      it += n_kv;
      const Tile done = c;
      const float la = l0, lb = l1;
      const int tn = walk(n + 1);
      mbar_wait(v_full(sv), (last / kVStages) & 1);
      if (tn < p.n_tiles) {
        // the next work tile's first Q K^T with this one's last P V
        enter(tn, n + 1);
        const int sk = it % kKStages;
        mbar_wait(q_full(q_slot), q_par);
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
        qk_retired(0, c.t_end - c.t_begin);
        epilogue(done, la, lb);
#pragma unroll
        for (int i = 0; i < 128; ++i) o[i] = 0.f;
        softmax(c.t_begin, c0, c1);
        rescale_pack(c0, c1);
      } else {
        issue_pv(sv);
        wg_wait0();
        fence_regs(o);
        mbar_arrive(v_empty(sv));
        epilogue(done, la, lb);
      }
      ++n;
      t = tn;
    }
    if (w == 0) turn_wait();                 // group 1's last hand-over
  }
}

}  // namespace

// q (b, sq, hq, 256), k and v (b, skv, hkv, 256), o (b, sq, hq, 256), all
// bf16 with a unit stride on hd, 16-byte aligned bases and strides. geo
// holds 7 numbers for each of q, k, v and o in that order: the dims (hd,
// s, heads, b) and the byte strides of s, heads and b (the wrapper's
// ``tma_geometry``; o is written through its strides, not a map). The
// persistent grid has one block per SM of the current device, fewer when
// there are fewer tiles. Returns 0, a cudaError_t, 999 when the driver's
// cuTensorMapEncodeTiled is not found, or 1000 + its CUresult.
extern "C" int flash_fwd_wgmma256_launch(const void* q, const void* k,
                                         const void* v, void* o,
                                         const unsigned long long* geo,
                                         int b, int sq, int skv, int hq,
                                         int hkv, int causal, int window,
                                         int q_offset, float scale,
                                         void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      geo[0] != kHd || geo[7] != kHd || geo[14] != kHd || geo[21] != kHd)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  int err;
  if ((err = make_map(&qm, q, geo, kRows)) ||
      (err = make_map(&km, k, geo + 7, kBlockN)) ||
      (err = make_map(&vm, v, geo + 14, kBlockN)))
    return err;
  // the attribute belongs to the current device's context: set on every
  // launch, so a second card or a reset context gets it too
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  int dev, sms, l2;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.b = b;
  p.sq = sq;
  p.skv = skv;
  p.hq = hq;
  p.hkv = hkv;
  p.g = hq / hkv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.n_mb = (sq + kBlockM - 1) / kBlockM;
  const long long n_tiles = (long long)p.n_mb * b * hq;
  if (n_tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)n_tiles;
  // about kGroupTiles tiles of one group in a chunk: enough blocks share a
  // group's K and V for L2 to keep them, and few enough groups are in
  // flight at once that not all blocks read the same lines
  // The walk: row block first (chunks of one row block), the heaviest
  // first over all groups, which balances the blocks best, when the K and
  // V that one row block reads in every group fit in half of L2; else
  // chunks of about kGroupTiles tiles of a group, so the groups in flight
  // are few enough for L2 to keep their K and V
  const long long span = window > 0 && window + kBlockM < skv
                             ? window + kBlockM : skv;
  const long long working = 2LL * b * hkv * span * kHd * 2;
  if (working <= l2 / 2) {
    p.chunk = 1;
  } else {
    p.chunk = kGroupTiles / p.g < p.n_mb ? kGroupTiles / p.g : p.n_mb;
    if (p.chunk < 1) p.chunk = 1;
  }
  p.scale_log2 = scale * kLog2e;
  p.o = static_cast<uint16_t*>(o);
  p.o_ss = (long long)(geo[25] / 2);
  p.o_sh = (long long)(geo[26] / 2);
  p.o_sb = (long long)(geo[27] / 2);
  int blocks = p.n_tiles < sms ? p.n_tiles : sms;
  flash_fwd_wgmma256_kernel<<<blocks, kThreads, kSmemBytes,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, p);
  return (int)cudaGetLastError();
}
