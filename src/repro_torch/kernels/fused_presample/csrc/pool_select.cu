// Presample pool selection for Hopper (sm_90a): the row scores (K2), their
// race keys (K3) and the selection they feed, in one launch.
//
// Replaces the TPU kernels row_score_pallas (K2) and pool_keys_pallas (K3)
// of src/repro/kernels/fused_presample/fused_presample.py, and the XLA tail
// of the reference's _select_pool (src/repro/kernels/fused_presample/ops.py).
// For per-token g2 (B, T) f32 and a (B, T) byte mask, or for given scores:
//     s_i   = sqrt(max(sum_t g2[i, t] * mask[i, t], 1e-20))   stage 1 (K2)
//     total = max(sum_i s_i, 1e-20), inv_total = 1 / total
//     key_i = -log(u_i) / max(s_i * inv_total, 1e-20), +inf where s_i < 0
//             (u_i = race_hash::uniform(i, ctx), shared with K6)     (K3)
//     the k + 1 smallest keys, ties to the lower row; thr the (k+1)-th;
//     idx   = the k winners in ascending key order, probs = s / total,
//     w     = 1 / (B * max(-expm1(-probs * thr), 1e-30))
// and, for k >= B, every row with weights 1/B and thr +inf.
//
// Bound: bytes, and below some thousands of rows the launch itself. Stage 1
// reads each g2 value (4 B) and mask byte once: at prod's pool (768, 4096)
// 15.7 MB, 4.7 us at 3.35 TB/s; at a 12-row pool of 1024 tokens 61 KB,
// 18 ns, where one launch (microseconds) sets the time. Everything after it
// moves O(B) bytes. What cost the time before this kernel was dispatch: two
// launches and about ten PyTorch ops between them. Here it is one launch.
//
// Stage 1: one block of 256 threads a row, so the rows spread over all SMs
// (six blocks an SM: prod's 768 rows fit the card in one wave). A thread
// takes 16 tokens at a time: one 16-byte load of the mask and four of g2,
// issued before any is used; scalar loads for the head and tail of a row
// that does not start or end on 16 tokens (ragged T), and for whole rows
// when a base pointer is not 16-byte aligned. f32 partial sums, a
// warp-shuffle tree and one pass over the block's warps: a fixed order, so
// two launches give the same bits (not torch.sum's order: rtol 1e-5 against
// the plain version).
//
// The grid-wide dependency is a "last block done" counter (one uint32 per
// stream, which the wrapper allocates zeroed once). Each block writes its
// row's score, fences, and adds one to the counter; the block that brings it
// to the grid size runs stage 2 and sets it back to zero for the next launch.
// Chosen over a cooperative launch: it needs no co-residency (any B
// launches, however many blocks fit the card), so it can never be refused,
// and the other blocks retire while the last one finishes. With the scores
// given the grid is that one block.
//
// Stage 2, in one block:
// - sum s in a fixed order (strided per thread, then the same trees);
// - the keys by K3's math: race_hash::uniform, IEEE logf, __fmul_rn and
//   __fdiv_rn (no fast math: __logf near u -> 1 loses the small keys that
//   decide the race), so they are bitwise what the plain version computes
//   from the same scores and inv_total. They are kept in shared memory up to
//   kSmemKeys rows, and above that read back from the keys output in device
//   memory;
// - the bottom-(k+1) over the composite (max(key bits, 0) << 32 | row), the
//   order of the plain version's int64 top-k (-0.0 counts as +0.0, ties go
//   to the lower row). Up to one row a thread (B <= 256), each row counts
//   the rows below it, which is its place. Above that, a radix select of the
//   (k+1)-th key's bits, four passes of 8-bit digits over a shared-memory
//   histogram (a warp's lanes in one bin add to it once: the keys' top bits
//   are mostly equal); the winners are every row below it and the lowest
//   rows equal to it, placed by a block scan in row order; then a rank sort
//   of the k + 1 winners (each counts those below it, 32 at a time) up to
//   kRankMax winners, else a bitonic sort, in shared memory up to kSmemWin
//   slots, else in a scratch buffer from the wrapper;
// - idx, probs, w and thr, each by the plain version's separately rounded
//   operations.
// Every step is a serial chain of block barriers and dependent reads, so at
// the pools the main path builds a launch costs microseconds above its bytes.
// Clamps let NaN through, as torch.clamp and jnp.maximum do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../topk_keys/csrc/race_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kSmemKeys = 2048;  // keys in shared memory up to this B
constexpr long long kRankMax = 512;    // winners rank-sorted up to this many
constexpr long long kSmemWin = 1024;   // winners' slots in shared memory

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// A key's order bits: non-negative keys order like their bits; -0.0 (and
// any negative bit pattern) counts as +0.0.
__device__ __forceinline__ unsigned key_bits(float key) {
  const int b = __float_as_int(key);
  return b < 0 ? 0u : (unsigned)b;
}

// Sum over the block in a fixed order; every thread gets the sum.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  v = red[kWarps];
  __syncthreads();
  return v;
}

// This thread's part of sum_t g2[row, t] * mask[row, t].
__device__ float row_partial(const float* __restrict__ g2,
                             const uint8_t* __restrict__ mask, long long row,
                             long long T, int vec) {
  const long long f0 = row * T, f1 = f0 + T;
  long long a = f1, e = f1;  // the 16-token body [a, e); scalar elsewhere
  if (vec) {
    a = (f0 + 15) & ~15LL;
    e = f1 & ~15LL;
    if (a >= e) a = e = f1;
  }
  float acc = 0.f;
  for (long long i = f0 + threadIdx.x; i < a; i += kThreads)
    acc = fmaf(__ldg(g2 + i), (float)__ldg(mask + i), acc);
  const uint4* m16 = reinterpret_cast<const uint4*>(mask);
  const float4* g4 = reinterpret_cast<const float4*>(g2);
  for (long long q = a / 16 + threadIdx.x; q < e / 16; q += kThreads) {
    const uint4 m = __ldg(m16 + q);
    float4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(g4 + 4 * q + j);
    const unsigned mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(v[j].x, (float)(mw[j] & 0xffu), acc);
      acc = fmaf(v[j].y, (float)((mw[j] >> 8) & 0xffu), acc);
      acc = fmaf(v[j].z, (float)((mw[j] >> 16) & 0xffu), acc);
      acc = fmaf(v[j].w, (float)(mw[j] >> 24), acc);
    }
  }
  for (long long i = e + threadIdx.x; i < f1; i += kThreads)
    acc = fmaf(__ldg(g2 + i), (float)__ldg(mask + i), acc);
  return acc;
}

// One winner's outputs: probs = s / total, w = 1 / (B * max(pi, 1e-30)) with
// pi = 1 - exp(-probs * thr), each operation rounded as the plain version's.
__device__ __forceinline__ void write_winner(long long p, long long row,
                                             float s, float total, float tv,
                                             long long B, long long* idx,
                                             float* probs, float* w) {
  const float pr = __fdiv_rn(s, total);
  const float pi = -expm1f(-__fmul_rn(pr, tv));
  idx[p] = row;
  probs[p] = pr;
  w[p] = __fdiv_rn(1.f, __fmul_rn((float)B, clamp_min(pi, 1e-30f)));
}

// Stage 2: everything after the scores, in the one block that runs it.
__device__ void select_stage(long long B, const float* __restrict__ scores,
                             uint32_t ctx, long long k,
                             float* __restrict__ inv_total,
                             float* __restrict__ keys,
                             long long* __restrict__ idx,
                             float* __restrict__ probs,
                             float* __restrict__ w, float* __restrict__ thr,
                             unsigned long long* __restrict__ scratch,
                             float* red) {
  __shared__ float s_keys[kSmemKeys];
  __shared__ unsigned long long s_win[kSmemWin];
  __shared__ unsigned s_rank[kRankMax];
  __shared__ unsigned hist[256];
  __shared__ unsigned s_cnt[2][kWarps];
  __shared__ unsigned s_digit, s_r;
  __shared__ float s_thr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Each step below is one block's serial chain, so the loops are unrolled
  // to put their loads in flight together.
  // sum s in a fixed order; row tid's score stays in a register
  const float s0 = tid < B ? __ldcg(scores + tid) : 0.f;
  float part = s0;
#pragma unroll 4
  for (long long i = tid + kThreads; i < B; i += kThreads)
    part += __ldcg(scores + i);
  const float total = clamp_min(block_sum(part, red), 1e-20f);
  const float it = __fdiv_rn(1.f, total);
  if (tid == 0) *inv_total = it;

  const bool keys_in_smem = B <= kSmemKeys;
  float key0 = INFINITY;
#pragma unroll 4
  for (long long i = tid; i < B; i += kThreads) {
    const float s = i == tid ? s0 : __ldcg(scores + i);
    float key = INFINITY;  // a padded lane (s < 0) never wins the race
    if (!(s < 0.f)) {
      const float u = race_hash::uniform((uint32_t)i, ctx);
      key = __fdiv_rn(-logf(u), clamp_min(__fmul_rn(s, it), 1e-20f));
    }
    keys[i] = key;
    if (keys_in_smem) s_keys[i] = key;
    if (i == tid) key0 = key;
  }
  if (k >= B) {  // the ratio-1 pool: every row, the exact-mean weights
    const float w_all = (float)(1.0 / (double)(B > 1 ? B : 1));
    for (long long i = tid; i < B; i += kThreads) {
      idx[i] = i;
      probs[i] = __fdiv_rn(i == tid ? s0 : __ldcg(scores + i), total);
      w[i] = w_all;
    }
    if (tid == 0) *thr = INFINITY;
    return;
  }
  __syncthreads();

  if (B <= kThreads) {  // a row a thread: each row's rank among all B rows
    unsigned rank = 0u;
    if (tid < B) {
      const unsigned b = key_bits(key0);
#pragma unroll 8
      for (int j = 0; j < (int)B; ++j) {
        const unsigned bj = key_bits(s_keys[j]);
        rank += bj < b || (bj == b && j < tid);
      }
      if (rank == k) s_thr = key0;
    }
    __syncthreads();
    const float tv = s_thr;
    if (tid == 0) *thr = tv;
    if (tid < B && rank < k)
      write_winner(rank, tid, s0, total, tv, B, idx, probs, w);
    return;
  }
  const float* kb = keys_in_smem ? s_keys : keys;
  const long long b_pad = (B + kThreads - 1) & ~(long long)(kThreads - 1);

  // radix select: the bits of the (k+1)-th smallest key, and r, the rank of
  // the (k+1)-th composite among the rows that share those bits. A warp's
  // lanes that fall in one bin add to it once (the keys' top bits are
  // mostly equal, and one shared address would take the atomics in turn).
  unsigned prefix = 0u, pmask = 0u, r = (unsigned)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int j = tid; j < 256; j += kThreads) hist[j] = 0u;
    __syncthreads();
#pragma unroll 4
    for (long long i = tid; i < b_pad; i += kThreads) {
      const unsigned b = i < B ? key_bits(kb[i]) : 0u;
      const bool in = i < B && (b & pmask) == prefix;
      const unsigned active = __ballot_sync(0xffffffffu, in);
      if (in) {
        const unsigned bin = (b >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(active, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {  // lane l owns bins 8l .. 8l+7
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      unsigned cum = incl - sum;
      if (cum <= r && r < incl) {
        int d = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (d < 0 && r < cum + c[j]) d = 8 * lane + j;
          else if (d < 0) cum += c[j];
        }
        s_digit = (unsigned)d;
        s_r = r - cum;
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    pmask |= 0xffu << shift;
    r = s_r;
  }
  const unsigned n_less = (unsigned)k - r;  // rows whose bits are below

  // the k + 1 winners' composites, placed by a block scan in row order:
  // the rows below at 0 .. n_less-1, the r + 1 lowest rows at the bits after
  const long long n = k + 1;
  const bool rank_sort = n <= kRankMax;
  long long P = 1;
  while (P < n) P <<= 1;
  unsigned long long* win = rank_sort || P <= kSmemWin ? s_win : scratch;
  unsigned run_lt = 0u, run_eq = 0u;  // rows below / at the bits so far
  for (long long base = 0; base < B; base += kThreads) {
    const long long i = base + tid;
    const unsigned b = i < B ? key_bits(kb[i]) : 0xffffffffu;
    const unsigned long long comp =
        ((unsigned long long)b << 32) | (unsigned long long)i;
    const bool lt = b < prefix, eq = b == prefix;
    const unsigned ball_lt = __ballot_sync(0xffffffffu, lt);
    const unsigned ball_eq = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) {
      s_cnt[0][warp] = __popc(ball_lt);
      s_cnt[1][warp] = __popc(ball_eq);
    }
    __syncthreads();
    const unsigned below_lane = (1u << lane) - 1u;
    unsigned pos_lt = run_lt + __popc(ball_lt & below_lane);
    unsigned pos_eq = run_eq + __popc(ball_eq & below_lane);
    for (int j = 0; j < kWarps; ++j) {
      if (j < warp) {
        pos_lt += s_cnt[0][j];
        pos_eq += s_cnt[1][j];
      }
      run_lt += s_cnt[0][j];
      run_eq += s_cnt[1][j];
    }
    if (lt) win[pos_lt] = comp;
    if (eq && pos_eq <= r) win[n_less + pos_eq] = comp;
    __syncthreads();
  }

  const unsigned long long* sorted;
  if (rank_sort) {  // each winner counts the winners below it, 32 at a time
    // (a warp's lanes take neighbouring winners against the same 32, so
    // every read of s_win[j] is one broadcast, free of bank conflicts; the
    // slots past the winners hold ~0, which no composite exceeds)
    const int nn = (int)n, runs = (nn + 31) >> 5;
    for (int j = tid; j < nn; j += kThreads) s_rank[j] = 0u;
    for (int j = nn + tid; j < runs << 5; j += kThreads) s_win[j] = ~0ull;
    __syncthreads();
    for (int u = tid; u < nn * runs; u += kThreads) {
      const int run = u / nn, e = u - run * nn;
      const unsigned long long* row32 = s_win + (run << 5);
      const unsigned long long c = s_win[e];
      unsigned below = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) below += row32[j] < c;
      if (below) atomicAdd(&s_rank[e], below);
    }
    __syncthreads();
    for (int e = tid; e < nn; e += kThreads)
      s_win[kRankMax + s_rank[e]] = s_win[e];
    sorted = s_win + kRankMax;
  } else {  // a bitonic sort over the next power of two
    for (long long j = n + tid; j < P; j += kThreads) win[j] = ~0ull;
    __syncthreads();
    for (long long size = 2; size <= P; size <<= 1) {
      for (long long stride = size >> 1; stride > 0; stride >>= 1) {
        for (long long t = tid; t < (P >> 1); t += kThreads) {
          const long long lo =
              ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
          const long long hi = lo + stride;
          const unsigned long long a = win[lo], b = win[hi];
          if ((a > b) == ((lo & size) == 0)) {
            win[lo] = b;
            win[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    sorted = win;
  }
  __syncthreads();

  const float tv = kb[sorted[k] & 0xffffffffull];
  if (tid == 0) *thr = tv;
  for (long long p = tid; p < k; p += kThreads) {
    const long long row = (long long)(sorted[p] & 0xffffffffull);
    write_winner(p, row, __ldcg(scores + row), total, tv, B, idx, probs, w);
  }
}

// Six blocks an SM (at most 40 registers a thread): prod's 768 rows in one
// wave over 132 SMs.
__global__ void __launch_bounds__(kThreads, 6)
pool_select_kernel(const float* __restrict__ g2,
                   const uint8_t* __restrict__ mask, long long B, long long T,
                   int vec, float* scores, uint32_t ctx, long long k,
                   float* inv_total, float* keys, long long* idx,
                   float* probs, float* w, float* thr,
                   unsigned long long* scratch, unsigned* counter) {
  __shared__ float red[kWarps + 1];
  __shared__ int last;
  if (g2 != nullptr) {
    const long long row = blockIdx.x;
    if (row < B) {
      const float acc = block_sum(row_partial(g2, mask, row, T, vec), red);
      if (threadIdx.x == 0) scores[row] = sqrtf(clamp_min(acc, 1e-20f));
    }
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
    __threadfence();
  }
  select_stage(B, scores, ctx, k, inv_total, keys, idx, probs, w, thr,
               scratch, red);
}

}  // namespace

// g2 (B, T) f32 and mask (B, T) uint8 (0 or 1), both contiguous, or both
// null when the (B,) scores are given; vec: both base pointers are 16-byte
// aligned. scores (B,) f32: written by stage 1, else read. k >= 0. Outputs
// on the device: inv_total (1,), keys (B,), idx (m,) int64, probs and w (m,)
// f32 with m = min(k, B), thr (1,). scratch: next_pow2(k + 1) uint64 slots
// when k + 1 exceeds kSmemWin and k < B, else unused. counter: one zeroed uint32 owned by the stream. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
extern "C" int pool_select_launch(const float* g2, const uint8_t* mask,
                                  long long B, long long T, int vec,
                                  float* scores, unsigned ctx, long long k,
                                  float* inv_total, float* keys,
                                  long long* idx, float* probs, float* w,
                                  float* thr, unsigned long long* scratch,
                                  unsigned* counter, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const unsigned grid = g2 != nullptr && B > 1 ? (unsigned)B : 1u;
  pool_select_kernel<<<grid, kThreads, 0, st>>>(
      g2, mask, B, T, vec, scores, ctx, k, inv_total, keys, idx, probs, w,
      thr, scratch, counter);
  return (int)cudaGetLastError();
}
