// Flash-attention forward in f32 for Hopper (sm_90a): prefill and scoring.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py, body _kernel) and the fold
// of its wrapper (ops.flash_attention) for the calls flash_attn.kernel_for
// names "f32": float32, hd in {16, 32, 64, 128}, at least F32_MIN_ROWS
// query rows, q, k and v 16-byte aligned (base and strides a multiple of 4
// floats). That is the scoring forward and the prefills of the f32 models
// (lm-100m's pool at (12, 1024, 10/5, 64), lm-tiny, the reduced configs).
// For q (b, sq, hq, hd) and k, v (b, skv, hkv, hd), read in place through
// their strides, it computes per query head h and position i (query
// position qpos = q_offset + i, key position = kv index j):
//     s_j = scale * <q, k_j>,  masked to -1e30 unless j <= qpos (causal)
//                              and j > qpos - window (window > 0)
//     o   = sum_j softmax(s)_j v_j
// with the TPU kernel's online softmax: (acc, m, l) carried over kv tiles,
// m starting at -1e30, acc / max(l, 1e-30) at the end. A wholly masked
// tile of a row adds exp(0) = 1 terms that the row's first real max wipes
// (corr = 0), as on the TPU. A row with no valid key at all is outside the
// contract (the wrapper refuses it).
//
// GQA as in flash_attn_fwd.cu: a block's rows are (position, head-in-group)
// pairs of ONE kv head, packed r = i * g + (h % g); a kv tile is read once
// for all g heads.
//
// Bound: operations. A prefill is 4 * b * hq * hd * sum_i(i + 1) flop, and
// the tolerance the port holds K5 to in f32 (2e-4, and 1e-5 of a row's
// largest output) rules out TF32's ~3 digits: the work is f32 FMA on CUDA
// cores, 67 TFLOP/s on an H100 SXM. The design is an SGEMM's register
// tiling of both products:
//   * a block of kThreads = 128 threads owns kBM = 64 packed rows and walks
//     kv tiles of kBN = 32 keys. Thread (ty, tx), ty = 2 * warp + lane / 16
//     and tx = lane % 16, keeps an 8 x 2 tile of S in registers: rows
//     ty + 8 i (i < 8) and keys tx + 16 c (c < 2). The 16 threads of a row
//     group are one half-warp, so a row's max and sum are xor shuffles over
//     offsets 1, 2, 4, 8 in a fixed order;
//   * Q (staged once) and K sit in shared memory row-major with a row
//     stride of hd + 4 floats; each step over d is four d wide: 8 float4
//     loads of Q (a broadcast within a half-warp; the two row groups of a
//     warp are adjacent rows, on other banks) and 2 of K (16 keys a
//     half-warp, on distinct banks) for 64 FMAs;
//   * K and V tiles come through a 2-stage cp.async ring of 16-byte copies,
//     zero-filled past skv, so tile t + 1 loads under tile t's math;
//   * softmax in base 2: scale * log2 e folded into one multiply, ex2; l
//     stays a per-thread partial until the end;
//   * P goes to shared memory (row stride kBN + 16 = 48: the two row groups
//     of a warp store on disjoint banks), read back only by the half-warp
//     that wrote it (__syncwarp). Each thread keeps an 8 x hd/16 tile of O:
//     rows ty + 8 i, columns tx * VEC + 16 * VEC * n; P V reads a float4 of
//     P per row and VEC floats of V per key, 128 FMAs per 12 loads at
//     hd 64;
//   * tiles wholly above the causal diagonal or before the window of every
//     row of the block are never visited; the mask is evaluated only on
//     the tiles where some row of the block needs it (the diagonal, the
//     window's edge, past skv), outside the inner products;
//   * blocks are launched heaviest first (the last row blocks of a causal
//     call), so the tail of the grid is short blocks;
//   * no atomics: every sum runs in a fixed order, two launches give the
//     same bits.
// Shared memory at hd 64: Q 17 KB, K and V 2 x 2 x 8.5 KB, P 12 KB: 64 KB,
// three blocks (12 warps) an SM; ptxas keeps hd 64 at 168 registers, under
// the 170 that three 128-thread blocks leave a thread. On an H100 80GB
// HBM3 at 700 W, at lm-100m's pool (12, 1024, 10/5, 64), f32_probe.py
// times the shipped kernel beside 64-key tiles (two blocks an SM, 103 KB),
// the loop over d unrolled by 4 and O rescaled only when a row's max moves
// (the branch bought nothing), each checked, and beside ablations.
// flash_attn.f32_walk transcribes the block order and the tile rule for
// the CPU tests.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64;          // packed query rows a block
constexpr int kBN = 32;          // keys a kv tile
constexpr int kThreads = 128;    // 8 row groups x 16 threads
constexpr int kTM = 8;           // rows a thread: ty + 8 i
constexpr int kTN = 2;           // keys a thread in S: tx + 16 c
constexpr int kLDP = kBN + 16;   // P's row stride (floats)

static_assert(kBM == 8 * kTM && kBN == 16 * kTN && kThreads == 128,
              "8 row groups of 16 threads tile the block's S");

struct Problem {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int sq, skv, hkv, g, nrb, bhkv;  // nrb: row blocks a (batch, kv head)
  long long qs_b, qs_s, qs_h;
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long os_b, os_s, os_h;
  int causal, window, q_offset;
  float scale_log2;  // softmax scale * log2(e)
};

// The tiling at head dim HD: shared-memory strides and the O columns a
// thread holds (VEC contiguous floats at tx * VEC + 16 * VEC * n).
template <int HD>
struct Tiles {
  static constexpr int LDQ = HD + 4;  // Q and K rows: conflict-free float4
  static constexpr int LDK = HD + 4;
  static constexpr int LDV = HD;
  static constexpr int NC = HD / 16;            // O columns a thread
  static constexpr int VEC = NC < 4 ? NC : 4;   // contiguous at a time
  static constexpr int NV = NC / VEC;
  static constexpr int kQ = kBM * LDQ;          // floats
  static constexpr int kK = kBN * LDK;
  static constexpr int kV = kBN * LDV;
  static constexpr int kBytes = (kQ + 2 * kK + 2 * kV + kBM * kLDP) * 4;
  static constexpr int kMinBlocks = HD <= 64 ? 3 : 2;  // by shared memory
};

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool key_ok(const Problem& p, int kpos, int qpos) {
  return kpos < p.skv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// Packed row r of kv head (bi, kvh): its element offset under strides s_*.
__device__ __forceinline__ long long row_offset(const Problem& p,
                                                long long s_b, long long s_s,
                                                long long s_h, int bi,
                                                int kvh, int r) {
  return bi * s_b + (long long)(r / p.g) * s_s +
         (long long)(kvh * p.g + r % p.g) * s_h;
}

template <int N>
__device__ __forceinline__ float max_over(float x) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int N>
__device__ __forceinline__ float sum_over(float x) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// VEC consecutive floats of shared memory into registers
template <int VEC>
__device__ __forceinline__ void lds(const float* src, float* dst) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

template <int VEC>
__device__ __forceinline__ void stg(float* dst, const float* src) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    *dst = src[0];
  }
}

// component j (a constant after unrolling) of a float4
__device__ __forceinline__ float part(const float4& x, int j) {
  return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, Tiles<HD>::kMinBlocks)
flash_fwd_f32_kernel(const Problem p) {
  using T = Tiles<HD>;
  constexpr int C4 = HD / 4;  // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [kBM][LDQ]
  float* ks = qs + T::kQ;        // [2][kBN][LDK]
  float* vs = ks + 2 * T::kK;    // [2][kBN][LDV]
  float* ps = vs + 2 * T::kV;    // [kBM][kLDP]

  // heaviest first: block L takes row block nrb - 1 - L / bhkv of pair
  // L % bhkv
  const int L = blockIdx.x;
  const int row0 = (p.nrb - 1 - L / p.bhkv) * kBM;
  const int bh = L % p.bhkv;
  const int bi = bh / p.hkv, kvh = bh % p.hkv;
  const int nrows = p.sq * p.g;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = (tid >> 5) * 2 + (lane >> 4);
  const int tx = lane & 15;

  // the block's query positions and the kv tiles [t_begin, t_end) that
  // hold its rows' unmasked keys
  const int q_lo = p.q_offset + row0 / p.g;
  const int q_hi = p.q_offset + (min(row0 + kBM, nrows) - 1) / p.g;
  const int kv_end = p.causal ? min(p.skv, q_hi + 1) : p.skv;
  const int kv_begin = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int t_begin = kv_begin / kBN;
  const int t_end = kv_end > kv_begin ? (kv_end + kBN - 1) / kBN : t_begin;

  const float* kb = p.k + bi * p.ks_b + (long long)kvh * p.ks_h;
  const float* vb = p.v + bi * p.vs_b + (long long)kvh * p.vs_h;

  // the copies: thread tid moves the 16-byte chunk tid % C4 of rows
  // tid / C4 + kPass * j, so its column and row step are fixed
  constexpr int kPass = kThreads / C4;  // rows a pass of the block
  static_assert(kThreads % C4 == 0 && kBN % kPass == 0 && kBM % kPass == 0,
                "whole passes over a tile's rows");
  const int r0 = tid / C4, col = (tid % C4) * 4;
#pragma unroll
  for (int j = 0; j < kBM / kPass; ++j) {
    const int row = row0 + r0 + kPass * j;
    const bool ok = row < nrows;
    cp_async16(qs + (r0 + kPass * j) * T::LDQ + col,
               ok ? p.q + row_offset(p, p.qs_b, p.qs_s, p.qs_h, bi, kvh,
                                     row) + col
                  : p.q,
               ok);
  }
  auto load_kv = [&](int t, int buf) {
    const int key = t * kBN + r0;
    const float* kg = kb + key * p.ks_s + col;
    const float* vg = vb + key * p.vs_s + col;
    float* kd = ks + buf * T::kK + r0 * T::LDK + col;
    float* vd = vs + buf * T::kV + r0 * T::LDV + col;
#pragma unroll
    for (int j = 0; j < kBN / kPass; ++j) {
      const bool ok = key + kPass * j < p.skv;
      cp_async16(kd + kPass * j * T::LDK, ok ? kg + kPass * j * p.ks_s : kb,
                 ok);
      cp_async16(vd + kPass * j * T::LDV, ok ? vg + kPass * j * p.vs_s : vb,
                 ok);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();  // Q and the first tile: one group

  float o[kTM][T::NC];
  float m[kTM], l[kTM];  // l: this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < T::NC; ++n) o[i][n] = 0.f;
  }

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int buf = it & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* K = ks + buf * T::kK;
    const float* V = vs + buf * T::kV;

    // S = Q K^T: rows ty + 8 i, keys tx + 16 c, four d at a step
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int c = 0; c < kTN; ++c) s[i][c] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 kf[kTN];
#pragma unroll
      for (int c = 0; c < kTN; ++c)
        kf[c] = *reinterpret_cast<const float4*>(K + (tx + 16 * c) * T::LDK +
                                                 d);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qs + (ty + 8 * i) * T::LDQ + d);
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          s[i][c] = fmaf(qf.x, kf[c].x, s[i][c]);
          s[i][c] = fmaf(qf.y, kf[c].y, s[i][c]);
          s[i][c] = fmaf(qf.z, kf[c].z, s[i][c]);
          s[i][c] = fmaf(qf.w, kf[c].w, s[i][c]);
        }
      }
    }

    // scale into base 2; the mask only where some row of the block needs
    // it (block-uniform branch)
    const int key0 = t * kBN;
    const bool unmasked =
        key0 + kBN <= p.skv && (!p.causal || key0 + kBN - 1 <= q_lo) &&
        (p.window <= 0 || key0 > q_hi - p.window);
    if (unmasked) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTN; ++c) s[i][c] *= p.scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int qpos = p.q_offset + (row0 + ty + 8 * i) / p.g;
#pragma unroll
        for (int c = 0; c < kTN; ++c)
          s[i][c] = key_ok(p, key0 + tx + 16 * c, qpos)
                        ? s[i][c] * p.scale_log2
                        : kNeg;
      }
    }

    // online softmax; P = exp2(S - m) to shared memory
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int c = 1; c < kTN; ++c) mx = fmaxf(mx, s[i][c]);
      mx = max_over<16>(mx);
      const float mn = fmaxf(m[i], mx);
      const float corr = ex2(m[i] - mn);  // exactly 1 while the max holds
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int n = 0; n < T::NC; ++n) o[i][n] *= corr;
      float* prow = ps + (ty + 8 * i) * kLDP + tx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const float e = ex2(s[i][c] - mn);
        sum += e;
        prow[16 * c] = e;
      }
      l[i] += sum;
    }
    __syncwarp();  // a row group's P is read only by its own half-warp

    // O += P V: a float4 of P per row, VEC floats of V per key
#pragma unroll
    for (int j = 0; j < kBN; j += 4) {
      float4 pf[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 8 * i) * kLDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[T::NC];
#pragma unroll
        for (int n = 0; n < T::NV; ++n)
          lds<T::VEC>(V + (j + jj) * T::LDV + tx * T::VEC + 16 * T::VEC * n,
                      vv + n * T::VEC);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float pj = part(pf[i], jj);
#pragma unroll
          for (int n = 0; n < T::NC; ++n) o[i][n] = fmaf(pj, vv[n], o[i][n]);
        }
      }
    }
    __syncthreads();  // this stage and P are free for the next tile
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float den = fmaxf(sum_over<16>(l[i]), 1e-30f);
    const int row = row0 + ty + 8 * i;
    if (row >= nrows) continue;
    float* out =
        p.o + row_offset(p, p.os_b, p.os_s, p.os_h, bi, kvh, row);
#pragma unroll
    for (int n = 0; n < T::NV; ++n) {
      float x[T::VEC];
#pragma unroll
      for (int e = 0; e < T::VEC; ++e) x[e] = o[i][n * T::VEC + e] / den;
      stg<T::VEC>(out + tx * T::VEC + 16 * T::VEC * n, x);
    }
  }
}

template <int HD>
int launch(const Problem& p, int blocks, cudaStream_t st) {
  static int attr = [] {
    int e = (int)cudaFuncSetAttribute(
        flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tiles<HD>::kBytes);
    if (e == 0)
      e = (int)cudaFuncSetAttribute(
          flash_fwd_f32_kernel<HD>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != 0) return attr;
  flash_fwd_f32_kernel<HD><<<blocks, kThreads, Tiles<HD>::kBytes, st>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr, long long s_b, long long s_s, long long s_h) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s_b % 4 == 0 &&
         s_s % 4 == 0 && s_h % 4 == 0;
}

}  // namespace

// q (b, sq, hq, hd), k/v (b, skv, hkv, hd), o (b, sq, hq, hd), float32,
// unit stride on hd, strides in elements: every pointer 16-byte aligned and
// every stride a multiple of 4 (a stride of a size-1 dim is never used and
// may be passed as 0). hd in {16, 32, 64, 128}. Returns the cudaError_t of
// the launch (0 = cudaSuccess).
extern "C" int flash_fwd_f32_launch(
    const float* q, const float* k, const float* v, float* o, int b, int sq,
    int skv, int hq, int hkv, int hd, long long qs_b, long long qs_s,
    long long qs_h, long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h, long long os_b,
    long long os_s, long long os_h, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      !aligned16(q, qs_b, qs_s, qs_h) || !aligned16(k, ks_b, ks_s, ks_h) ||
      !aligned16(v, vs_b, vs_s, vs_h) || !aligned16(o, os_b, os_s, os_h))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.sq = sq; p.skv = skv; p.hkv = hkv; p.g = hq / hkv;
  p.qs_b = qs_b; p.qs_s = qs_s; p.qs_h = qs_h;
  p.ks_b = ks_b; p.ks_s = ks_s; p.ks_h = ks_h;
  p.vs_b = vs_b; p.vs_s = vs_s; p.vs_h = vs_h;
  p.os_b = os_b; p.os_s = os_s; p.os_h = os_h;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale_log2 = scale * kLog2e;
  const long long nrows = (long long)sq * p.g;
  p.nrb = (int)((nrows + kBM - 1) / kBM);
  p.bhkv = b * hkv;
  const long long blocks = (long long)p.nrb * p.bhkv;
  if (nrows >= (1ll << 31) || blocks >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, (int)blocks, st);
    case 32: return launch<32>(p, (int)blocks, st);
    case 64: return launch<64>(p, (int)blocks, st);
    case 128: return launch<128>(p, (int)blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
