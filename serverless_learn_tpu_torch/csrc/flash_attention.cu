// Flash attention for Hopper (sm_90a): forward (K1), dq (K2), dk/dv (K3).
//
// Replaces the TPU kernels of serverless_learn_tpu/ops/pallas/
// flash_attention.py and computes the same functions:
//   * K1 `_flash_fwd_bhsd` (kernel `_fwd_kernel`, call at :223): blocked
//     attention with an online softmax; out in the input type and the f32
//     log-sum-exp of every query row.
//   * K2 the dq call of `_flash_bwd_bhsd` (kernel `_bwd_dq_kernel`, call at
//     :403): dq = sum_j ds k, ds = p (dp - delta) scale, with p recomputed
//     from the saved lse and dp = dO v^T.
//   * K3 the dkv call of `_flash_bwd_bhsd` (kernel `_bwd_dkv_kernel`, call at
//     :427, group sum at :439-444): dv = sum_i p^T dO and dk = sum_i ds^T q,
//     summed over the q heads that share a K/V head.
// Scores are (q . k) * D^-0.5 in f32; masked scores sit at -1e30 and give
// p = 0 (`_masked_exp`); a row with no valid key gets out = 0 (l clamped at
// 1e-30). As in the reference, p is rounded to the input type before p v and
// p^T dO, and ds before ds k and ds^T q; every sum is f32. The floors of l
// and of the rescale exponent propagate a NaN, as the reference's
// jnp.maximum does (fmaxf would drop it): a NaN or an inf in a row's
// scores makes that row's out and lse NaN, as in the plain version.
//
// Layouts: q, out, dO, dq [B, T, H, D]; k, v, dk, dv [B, S, KH, D]; all
// contiguous; lse and delta [B, H, T] f32. Grouped-query heads read K/V head
// h / (H / KH) directly and never expand it. Mask modes: none; "len" (per
// batch row a valid length: keys and queries at positions >= len are
// padding, padding queries get out = 0, lse = -1e30 and no gradient); "rows"
// (an int32 [B, S] key mask, nonzero = keep). Causal means key <= query.
// Ragged T and S are masked here: no shape needs padding by the caller.
//
// What bounds it on an H100 SXM: the operations. Causal attention at
// B=2, T=4096, H=32, D=64 is 1.4e11 FLOPs forward (0.14 ms at the 989
// TFLOP/s bf16 tensor-core rate) against 17 MB of q/k/v/out, and the
// backward 2.5x that. Two designs share this file:
//   * K1-K3 in f32 (llama_tiny's f32 tests): the products on the CUDA
//     cores in f32 (67 TFLOP/s peak), well above that bound; described
//     next.
//   * K1, K2 and K3 in bf16, every full-width path: wgmma fed by TMA
//     through an mbarrier ring, a producer warp and two consumer
//     warpgroups a block, described at `namespace wk` below.
// All keep flash attention's memory side: the [T, S] scores never reach
// device memory, each q/k/v tile is read into shared memory once per block,
// and blocks above the causal diagonal or past a "len" row's length are
// skipped outright.
//
// CUDA-core design. One block of 256 threads owns a 64 x 64 score tile:
// 16 x 16 threads, each with 4 x 4 scores in registers, fed by float4 reads
// of the transposed q and k tiles in shared memory. Row statistics reduce
// over the 16 threads of a half-warp with shuffles. The D output columns are
// split over the same 16 threads (D / 16 each), so a row's rescale stays in
// the thread.
//   * K1: a block per (q tile, head, batch row), looping over k tiles.
//   * K2: the same grid; the loop recomputes p and dp and sums ds k.
//   * K3: a block per (k tile, kv head, batch row) that loops over the
//     group's q heads and the q tiles at or below the diagonal and writes
//     dk, dv once: no atomics, deterministic sums, no [B, H, S, D] buffer.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper_ptx.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per tile
constexpr int kBK = 64;                 // key rows per tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kPad = kBQ + 4;           // row stride of the p / ds tile
constexpr float kNeg = -1e30f;          // the mask floor (`_NEG`)
constexpr float kLog2e = 1.4426950408889634f;

// max(a, b) that returns NaN when either is NaN (jnp.maximum); the same
// value as fmaxf otherwise.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The raw score q . k at or below which the scaled score is at the mask
// floor: the reference's `_masked_exp` gives it p = 0 exactly, masked or
// not, a -inf score included, whose exp against a NaN lse would be NaN.
// K3 sums p^T dO over the rows, so a NaN row must leave p = 0 at such a
// key; it compares on the raw score, so the exp's own arithmetic stays as
// it was, and the bf16 K3 only on its masked path, which a tile with a NaN
// lse takes (elsewhere the exp of such a score is 0 already). K2 needs no
// compare: a row with a NaN lse has a NaN or +inf score, whose p makes its
// whole dq row NaN under either rule.
__device__ __forceinline__ float raw_floor(float scale) {
  return kNeg * 0.5f / scale;
}

enum DType : int { kF32 = 0, kBF16 = 1 };
enum MaskMode : int { kNone = 0, kLen = 1, kRows = 2 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* mask;
  void* out;
  float* lse;
  void* dq;
  void* dk;
  void* dv;
  int B, T, S, H, KH, causal, mask_mode;
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
};

// The D columns of a row split over the 16 threads of a half-warp: D / 16
// each, as float4 groups 64 columns apart (D >= 64) or pairs (D = 32).
template <int D>
struct Cols {
  static constexpr int N = D / 16;
  __device__ static int col(int tx, int j) {
    return N >= 4 ? (j / 4) * 64 + tx * 4 + (j % 4) : tx * N + j;
  }
  __device__ static void load(const float* row, int tx, float* v) {
    if constexpr (N >= 4) {
#pragma unroll
      for (int g = 0; g < N / 4; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
        v[4 * g] = t.x; v[4 * g + 1] = t.y; v[4 * g + 2] = t.z; v[4 * g + 3] = t.w;
      }
    } else {
      const float2 t = *reinterpret_cast<const float2*>(row + tx * N);
      v[0] = t.x; v[1] = t.y;
    }
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + ROWS) of one head into shared memory as f32, 16 bytes
// a load; rows at or past `nvalid` read as zero. Transposed [D][ROWS] into
// `dst_t` and/or as is [ROWS][D] into `dst`.
template <typename T, int D, int ROWS>
__device__ void load_tile(const T* base, int64_t row_stride, int row0,
                          int nvalid, float* dst_t, float* dst) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int d0 = (c % kPerRow) * kVec;
    float v[kVec];
    if (row0 + r < nvalid) {
      Elem<T>::load(base + static_cast<int64_t>(row0 + r) * row_stride + d0, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
    if (dst_t != nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst_t[(d0 + e) * ROWS + r] = v[e];
    }
    if (dst != nullptr) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[r * D + d0 + e] = v[e];
    }
  }
}

// Whether query `r` may attend to key `c` of batch row `b`.
__device__ __forceinline__ bool valid(const Args& a, int b, int r, int c,
                                      int vlen) {
  if (r >= a.T || c >= a.S) return false;
  if (a.causal && c > r) return false;
  if (a.mask_mode == kLen) return c < vlen && r < vlen;
  if (a.mask_mode == kRows) return a.mask[static_cast<int64_t>(b) * a.S + c] != 0;
  return true;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int row_length(const Args& a, int b) {
  return a.mask_mode == kLen ? a.mask[b] : a.S;
}

// Number of k tiles query tile `q0` visits: the causal diagonal and a "len"
// row's length end the loop early (`last_j`, `:128-146`).
__device__ __forceinline__ int k_tiles_for(const Args& a, int q0, int vlen) {
  int n = (a.S + kBK - 1) / kBK;
  if (a.causal) n = min(n, (q0 + kBQ - 1) / kBK + 1);
  if (a.mask_mode == kLen) n = q0 >= vlen ? 0 : min(n, (vlen + kBK - 1) / kBK);
  return n;
}

// ---------------------------------------------------------------- K1 ----

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  using C = Cols<D>;
  constexpr int N = C::N;
  extern __shared__ __align__(16) float sm[];
  float* sQt = sm;                 // [D][kBQ]
  float* sKt = sQt + D * kBQ;      // [D][kBK]
  float* sV = sKt + D * kBK;       // [kBK][D]
  float* sPt = sV + kBK * D;       // [kBK][kPad]: p, transposed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_q = (a.T + kBQ - 1) / kBQ;
  // Causal: the tiles with the most keys first, so the short ones fill in.
  const int i = a.causal ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KH);
  const int q0 = i * kBQ;
  const int vlen = row_length(a, b);
  const int64_t qs = static_cast<int64_t>(a.H) * D, ks = static_cast<int64_t>(a.KH) * D;
  const T* qb = static_cast<const T*>(a.q) + (static_cast<int64_t>(b) * a.T * a.H + h) * D;
  const T* kb = static_cast<const T*>(a.k) + (static_cast<int64_t>(b) * a.S * a.KH + kh) * D;
  const T* vb = static_cast<const T*>(a.v) + (static_cast<int64_t>(b) * a.S * a.KH + kh) * D;

  load_tile<T, D, kBQ>(qb, qs, q0, a.T, sQt, nullptr);
  float m[4], l[4], acc[4][N];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  }
  const int n_tiles = k_tiles_for(a, q0, vlen);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's sKt / sV / sPt are read
    load_tile<T, D, kBK>(kb, ks, k0, a.S, sKt, nullptr);
    load_tile<T, D, kBK>(vb, ks, k0, a.S, nullptr, sV);
    __syncthreads();
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 q4 = ld4(sQt + d * kBQ + ty * 4);
      const float4 k4 = ld4(sKt + d * kBK + tx * 4);
      const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
      const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = valid(a, b, row, k0 + tx * 4 + c, vlen) ? s[r][c] * a.scale : kNeg;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[r][c] <= kNeg * 0.5f ? 0.f : expf(s[r][c] - m_new);
        sum += p;
        s[r][c] = Elem<T>::round(p);
      }
      sum = half_warp_sum(sum);
      const float alpha = expf(max_nan(m[r] - m_new, kNeg));
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < N; ++n) acc[r][n] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(sPt + (tx * 4 + c) * kPad + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = ld4(sPt + c * kPad + ty * 4);
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[N];
      C::load(sV + c * D, tx, vv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[r][n] = fmaf(pa[r], vv[n], acc[r][n]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= a.T) continue;
    const float ll = max_nan(l[r], 1e-30f);
    T* orow = static_cast<T*>(a.out) + (static_cast<int64_t>(b) * a.T + row) * qs + h * D;
#pragma unroll
    for (int n = 0; n < N; ++n) Elem<T>::store(orow + C::col(tx, n), acc[r][n] / ll);
    if (tx == 0) a.lse[(static_cast<int64_t>(b) * a.H + h) * a.T + row] = m[r] + logf(ll);
  }
}

// ---------------------------------------------------------------- K2 ----

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  using C = Cols<D>;
  constexpr int N = C::N;
  extern __shared__ __align__(16) float sm[];
  float* sQt = sm;                 // [D][kBQ]
  float* sGt = sQt + D * kBQ;      // [D][kBQ]: dO, transposed
  float* sKt = sGt + D * kBQ;      // [D][kBK]
  float* sVt = sKt + D * kBK;      // [D][kBK]
  float* sK = sVt + D * kBK;       // [kBK][D]
  float* sDt = sK + kBK * D;       // [kBK][kPad]: ds, transposed
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_q = (a.T + kBQ - 1) / kBQ;
  const int i = a.causal ? n_q - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (a.H / a.KH);
  const int q0 = i * kBQ;
  const int vlen = row_length(a, b);
  const int64_t qs = static_cast<int64_t>(a.H) * D, ks = static_cast<int64_t>(a.KH) * D;
  const int64_t qoff = (static_cast<int64_t>(b) * a.T * a.H + h) * D;
  const int64_t koff = (static_cast<int64_t>(b) * a.S * a.KH + kh) * D;
  const T* kb = static_cast<const T*>(a.k) + koff;
  const T* vb = static_cast<const T*>(a.v) + koff;

  load_tile<T, D, kBQ>(static_cast<const T*>(a.q) + qoff, qs, q0, a.T, sQt, nullptr);
  load_tile<T, D, kBQ>(static_cast<const T*>(a.dout) + qoff, qs, q0, a.T, sGt, nullptr);
  float lse[4], delta[4], acc[4][N];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    const int64_t at = (static_cast<int64_t>(b) * a.H + h) * a.T + row;
    lse[r] = row < a.T ? a.lse_in[at] : 0.f;
    delta[r] = row < a.T ? a.delta[at] : 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc[r][n] = 0.f;
  }
  const int n_tiles = k_tiles_for(a, q0, vlen);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    load_tile<T, D, kBK>(kb, ks, k0, a.S, sKt, sK);
    load_tile<T, D, kBK>(vb, ks, k0, a.S, sVt, nullptr);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 q4 = ld4(sQt + d * kBQ + ty * 4);
      const float4 g4 = ld4(sGt + d * kBQ + ty * 4);
      const float4 k4 = ld4(sKt + d * kBK + tx * 4);
      const float4 v4 = ld4(sVt + d * kBK + tx * 4);
      const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
      const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
      const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
      const float va[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
          dp[r][c] = fmaf(ga[r], va[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = valid(a, b, row, k0 + tx * 4 + c, vlen);
        const float p = ok ? expf(s[r][c] * a.scale - lse[r]) : 0.f;
        s[r][c] = Elem<T>::round(p * (dp[r][c] - delta[r]) * a.scale);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(sDt + (tx * 4 + c) * kPad + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 d4 = ld4(sDt + c * kPad + ty * 4);
      const float da[4] = {d4.x, d4.y, d4.z, d4.w};
      float kk[N];
      C::load(sK + c * D, tx, kk);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < N; ++n) acc[r][n] = fmaf(da[r], kk[n], acc[r][n]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
    if (row >= a.T) continue;
    T* out = static_cast<T*>(a.dq) + (static_cast<int64_t>(b) * a.T + row) * qs + h * D;
#pragma unroll
    for (int n = 0; n < N; ++n) Elem<T>::store(out + C::col(tx, n), acc[r][n]);
  }
}

// ---------------------------------------------------------------- K3 ----

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  using C = Cols<D>;
  constexpr int N = C::N;
  extern __shared__ __align__(16) float sm[];
  float* sKt = sm;                 // [D][kBK]
  float* sVt = sKt + D * kBK;      // [D][kBK]
  float* sQt = sVt + D * kBK;      // [D][kBQ]
  float* sQ = sQt + D * kBQ;       // [kBQ][D]
  float* sGt = sQ + kBQ * D;       // [D][kBQ]: dO, transposed
  float* sG = sGt + D * kBQ;       // [kBQ][D]
  float* sP = sG + kBQ * D;        // [kBQ][kPad]: p, then ds, per query row
  float* sL = sP + kBQ * kPad;     // [kBQ] lse
  float* sDl = sL + kBQ;           // [kBQ] delta
  // Threads: ty over 4 keys each, tx over 4 queries (scores) or D / 16
  // columns (dk, dv).
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int j = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KH;
  const int k0 = j * kBK;
  const int vlen = row_length(a, b);
  const int n_q = (a.T + kBQ - 1) / kBQ;
  // First q tile at or below the diagonal (`first_i`, :326); "len" skips
  // the q tiles and the k tiles past the row's length (:329-337).
  const int i0 = a.causal ? k0 / kBQ : 0;
  int i1 = n_q;
  if (a.mask_mode == kLen) i1 = k0 >= vlen ? 0 : min(n_q, (vlen + kBQ - 1) / kBQ);
  const int64_t qs = static_cast<int64_t>(a.H) * D, ks = static_cast<int64_t>(a.KH) * D;
  const int64_t koff = (static_cast<int64_t>(b) * a.S * a.KH + kh) * D;

  load_tile<T, D, kBK>(static_cast<const T*>(a.k) + koff, ks, k0, a.S, sKt, nullptr);
  load_tile<T, D, kBK>(static_cast<const T*>(a.v) + koff, ks, k0, a.S, sVt, nullptr);
  float dk[4][N], dv[4][N];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < N; ++n) dk[r][n] = dv[r][n] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kh * group + g;
    const int64_t qoff = (static_cast<int64_t>(b) * a.T * a.H + h) * D;
    const int64_t stat = (static_cast<int64_t>(b) * a.H + h) * a.T;
    for (int i = i0; i < i1; ++i) {
      const int q0 = i * kBQ;
      __syncthreads();  // the previous q tile's shared memory is read
      load_tile<T, D, kBQ>(static_cast<const T*>(a.q) + qoff, qs, q0, a.T, sQt, sQ);
      load_tile<T, D, kBQ>(static_cast<const T*>(a.dout) + qoff, qs, q0, a.T, sGt, sG);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < a.T ? a.lse_in[stat + row] : 0.f;
        sDl[threadIdx.x] = row < a.T ? a.delta[stat + row] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};  // [key][query]
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 k4 = ld4(sKt + d * kBK + ty * 4);
        const float4 v4 = ld4(sVt + d * kBK + ty * 4);
        const float4 q4 = ld4(sQt + d * kBQ + tx * 4);
        const float4 g4 = ld4(sGt + d * kBQ + tx * 4);
        const float ka[4] = {k4.x, k4.y, k4.z, k4.w};
        const float va[4] = {v4.x, v4.y, v4.z, v4.w};
        const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
        const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[r][c] = fmaf(ka[r], qa[c], s[r][c]);
            dp[r][c] = fmaf(va[r], ga[c], dp[r][c]);
          }
      }
      float ds[4][4];
      const float fl = raw_floor(a.scale);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx * 4 + c;
          const bool ok = valid(a, b, q0 + qi, key, vlen) && !(s[r][c] <= fl);
          const float p = ok ? expf(s[r][c] * a.scale - sL[qi]) : 0.f;
          ds[r][c] = Elem<T>::round(p * (dp[r][c] - sDl[qi]) * a.scale);
          s[r][c] = Elem<T>::round(p);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(sP + (tx * 4 + c) * kPad + ty * 4) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      }
      __syncthreads();
#pragma unroll 4
      for (int qi = 0; qi < kBQ; ++qi) {
        const float4 p4 = ld4(sP + qi * kPad + ty * 4);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        float gg[N];
        C::load(sG + qi * D, tx, gg);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < N; ++n) dv[r][n] = fmaf(pa[r], gg[n], dv[r][n]);
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(sP + (tx * 4 + c) * kPad + ty * 4) =
            make_float4(ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
      }
      __syncthreads();
#pragma unroll 4
      for (int qi = 0; qi < kBQ; ++qi) {
        const float4 d4 = ld4(sP + qi * kPad + ty * 4);
        const float da[4] = {d4.x, d4.y, d4.z, d4.w};
        float qq[N];
        C::load(sQ + qi * D, tx, qq);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int n = 0; n < N; ++n) dk[r][n] = fmaf(da[r], qq[n], dk[r][n]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty * 4 + r;
    if (key >= a.S) continue;
    const int64_t at = (static_cast<int64_t>(b) * a.S + key) * ks + kh * D;
    T* dkr = static_cast<T*>(a.dk) + at;
    T* dvr = static_cast<T*>(a.dv) + at;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      Elem<T>::store(dkr + C::col(tx, n), dk[r][n]);
      Elem<T>::store(dvr + C::col(tx, n), dv[r][n]);
    }
  }
}

// -------------------------------- K1, K2 and K3 in bf16 (Hopper, wgmma) ----
//
// K1 (flash_fwd_wgmma) replaces `_fwd_kernel` (call `:223`); K3
// (flash_dkv_wgmma) `_bwd_dkv_kernel` (call `:427`, group sum `:439-444`)
// and K2 (flash_dq_wgmma) `_bwd_dq_kernel` (`:251`, call `:403`), the
// kernels `_flash_bwd_bhsd` (`:371`) calls. What bounds them on the H100
// is the operations: per (query, key) pair K1 does two products of 2 D
// FLOPs (S = Q K^T, out += P V), K3 four (S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q), K2 three (S, dP, dq += dS K); at B=2,
// T=S=4096, H=32, KH=8, D=64, causal, that is 1.4e11, 2.8e11 and 2.1e11
// FLOPs, 0.14, 0.28 and 0.21 ms at 989 TFLOP/s, against ~0.1 GB of
// operands. Only wgmma reaches that rate; the designs before this one
// (mma.sync fed by ldmatrix from a cp.async ring that the same four warps
// issued) held them at 16-22 % of it.
//
// The design, shared by the three:
//   * A block has three warpgroups: a producer and two consumers. The
//     producer gives its registers up (setmaxnreg 24) and one of its
//     threads issues every load; the consumers take them (240).
//   * Tiles come by TMA into shared memory, a tile's rows (64 or 128) in
//     one box, through 4-D tensor maps (D, heads, rows, batch) encoded on
//     the host: a row past T or S is out of bounds and reads as zero,
//     where a map over B·T would read the next batch row. Boxes are 128 B
//     wide (64 bf16) with the 128-byte swizzle, D = 128 as two boxes; at
//     D = 32 the rows are 64 B with the 64-byte swizzle. lse and delta come by 1-D TMA maps
//     into the same stage, one box a tile. TMA faults on a box that does
//     not start a multiple of 16 bytes into the tensor, so at a T that is
//     not a multiple of 4 the start is rounded down and the box widened.
//   * A ring of kStages stages with mbarrier full/empty pairs: the
//     producer waits for a stage to be released, arms its full barrier
//     with the stage's bytes and issues the loads; a consumer waits for
//     full, computes, and each of its warps releases the stage.
//   * Every product is a wgmma: S and dP with both operands K-major in
//     shared memory; p and ds are formed in the accumulators and packed to
//     bf16 there, which is the register A operand of the next wgmma, so
//     dV, dK and dq read their B (dO, Q, K) from the same swizzled stage
//     as MN-major operands (the descriptor's transpose bit). Nothing goes
//     back through shared memory and nothing is transposed by hand.
//   * K3: a block owns 128 keys of one K/V head, 64 per consumer, loaded
//     once; the stages stream (Q, dO, lse, delta) of every q tile at or
//     below the diagonal for each q head of the group in turn, 128
//     queries a stage at D <= 64 and 64 at D = 128. dK and dV stay in
//     registers (at D = 128 a consumer holds both in 128 f32 registers a
//     thread) and are written once: the group is summed inside the block,
//     with no atomics.
//   * K2: a block owns 128 queries of one q head, 64 per consumer; Q, dO,
//     lse and delta load once, and the K and V tiles of every key tile at
//     or left of the diagonal stream through the stages, 128 keys a
//     stage. dq stays in registers and is written once. K2 stays a kernel
//     of its own, as the reference's two pallas_calls are: no atomics, so
//     every run repeats bit for bit.
//   * K1: laid out as K2, Q alone loaded once. S = Q K^T stays in the
//     accumulators, where the online softmax runs per row: the max over a
//     quad by shuffles, p = exp2(s scale log2 e - m) against the running
//     max m (log2 units), the running sum and out rescaled by exp2(m_old -
//     m_new). p is packed to bf16 in place (rounded against the running
//     max, as the reference's block-wise p) and is the register A operand
//     of out += P V, V read MN-major from the stage. A masked p is
//     selected to 0 after the exp, and a row masked so far keeps its max at
//     the floor, where the rescale is exp2(0) = 1: no inf or NaN reaches a
//     product. out is normalised by l in registers and written once; lse =
//     m + ln l, and a row with no valid key gets out = 0 and lse = -1e30.
//     exp2 is one ex2.approx.ftz. Each consumer waits for its S before
//     the softmax: issuing the next tile's S first made ptxas serialise
//     the wgmmas (C7514) and took 1.5x as long, and turn-taking between
//     the consumers on named barriers 1.4x.
//   * Stages of 128 rows halve the barrier round trips and wgmma waits per
//     FLOP against 64; K3 at D = 128 keeps 64 (128 would put dK, dV, S^T
//     and dP^T at 256 f32 registers a thread).
//   * Masks and skips: tiles wholly above the causal diagonal or
//     past a "len" row's length are never loaded (a consumer whose 64 rows
//     a loaded tile cannot reach skips it); the mask is tested only on the
//     diagonal, ragged, "len" and "rows" tiles, and interior tiles of mode
//     none go straight to exp2 with scale log2 e folded into one FFMA. K3
//     keeps `raw_floor`'s rule: a -inf score against a NaN lse gives p = 0
//     (a q tile with a NaN lse among a thread's columns takes the masked
//     path). A query past T (K3) or a key past S (K2), which the reference
//     does not have, gets dS = 0, so a NaN or inf that the box brings
//     there (the next head's delta, a zero row times an inf) stays out.
// The tensor cores add each product's terms in another order than the
// plain version: f32 round-off, far inside kernel_tolerance.

namespace wk {

using namespace ptx;  // hopper_ptx.cuh: mbarrier, TMA, wgmma, setmaxnreg

constexpr int kBox = 64;          // rows of a TMA box and of a consumer's share
constexpr int kConsumers = 2;     // consumer warpgroups of a block
constexpr int kBlockRows = kBox * kConsumers;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;
// lse and delta come R values a tile by a 1-D TMA map. A box must start a
// multiple of 16 bytes into the tensor, so its start is rounded down to 4
// values and it is 4 values wider; the consumers index past the rounding.
// Each takes a 128-byte aligned slot of shared memory.
template <int R>
constexpr int kStatBox = R + 4;
template <int R>
constexpr int kStatSlot = (kStatBox<R> * 4 + 127) / 128 * 128;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// The shared-memory form of a tile of R rows (64 or 128) and D bf16
// columns: kBoxes TMA boxes of R rows x kCols columns, each kRowBytes a row,
// swizzled. Within a box the rows lie kRowBytes apart, so one box of R rows
// is one K-major operand of R rows (N = R) and R / 16 MN-major k-slices.
template <int D, int R>
struct Lay {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxBytes = R * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr uint32_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // 128 B or 64 B
  static constexpr int kGroupBytes = 8 * kRowBytes;               // 8 rows
};

// The descriptor of a K-major operand: all R rows of the tile at `tile`,
// k-slice kk (columns 16 kk .. 16 kk + 15 of D).
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using L = Lay<D, R>;
  constexpr int kPerBox = L::kCols / 16;
  return gmma_desc(tile + (kk / kPerBox) * L::kBoxBytes + (kk % kPerBox) * 32, 16,
                   L::kGroupBytes, L::kSwizzle);
}

// The descriptor of an MN-major operand: k-rows [k0, k0 + 16) of the tile
// at `tile`, all D columns (N = D, the boxes kBoxBytes apart).
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int k0) {
  using L = Lay<D, R>;
  return gmma_desc(tile + k0 * L::kRowBytes, L::kBoxBytes, L::kGroupBytes, L::kSwizzle);
}

// Issues the TMA loads of the R-row tile at rows `row0` of head `head`
// (through a map whose boxes are R rows).
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b) {
  using L = Lay<D, R>;
#pragma unroll
  for (int bx = 0; bx < L::kBoxes; ++bx)
    tma_load_4d(dst + bx * L::kBoxBytes, map, bar, bx * L::kCols, head, row0, b);
}

// The A operand of the next wgmma from the m64 x N accumulator x (f32,
// N / 8 n-tiles of 4): k-slice kq takes n-tiles 2 kq and 2 kq + 1.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float (*x)[4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    a[n / 2][2 * (n & 1)] = pack(x[n][0], x[n][1]);
    a[n / 2][2 * (n & 1) + 1] = pack(x[n][2], x[n][3]);
  }
}

// Stores a warp's 16 x D f32 accumulator rows [row0, row0 + 16) as bf16
// (the m64 accumulator's layout: rows g and g + 8 of n-tile n hold columns
// 8 n + 2 t and + 1).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t row_stride, int row0,
                                           int nvalid, float (*acc)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= nvalid) continue;
    __nv_bfloat16* out = base + static_cast<int64_t>(row) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + 8 * n) = pack(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

struct Maps {
  CUtensorMap q, g, k, v, lse, delta;  // q, dO, k, v: 4-D; lse, delta: 1-D
};

__device__ __forceinline__ uint32_t aligned_base(const unsigned char* smem) {
  return (smem_u32(smem) + 1023u) & ~1023u;
}

// ---------------------------------------------------------------- K3 ----

// Queries of a K3 stage: 128 at D <= 64; 64 at D = 128, where dK and dV
// already hold 128 registers a thread.
template <int D>
constexpr int kDkvQueries = D <= 64 ? 128 : 64;

template <int D>
struct DkvSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kQBytes = Lay<D, kDkvQueries<D>>::kTileBytes;  // Q or dO of a stage
  static constexpr int kK = 0;                                    // [consumer] tiles
  static constexpr int kV = kK + kConsumers * Lay<D, kBox>::kTileBytes;
  static constexpr int kStage = kV + kConsumers * Lay<D, kBox>::kTileBytes;  // [stage] (Q, dO)
  static constexpr int kStats = kStage + kStages * 2 * kQBytes;  // [stage] (lse, delta)
  static constexpr int kBars = kStats + kStages * 2 * kStatSlot<kDkvQueries<D>>;  // full, empty, kv
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ Maps m, const Args a) {
  using L = Lay<D, kBox>;  // K and V
  using SM = DkvSmem<D>;
  constexpr int QS = kDkvQueries<D>, NQ = QS / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const float* stats = reinterpret_cast<const float*>(smem + (base - smem_u32(smem)) + SM::kStats);
  const uint32_t full = base + SM::kBars, empty = full + 8 * kStages, kv_bar = empty + 8 * kStages;

  // The key blocks with the most q tiles first (causal: key block 0).
  const int j = blockIdx.x / (a.KH * a.B), rest = blockIdx.x % (a.KH * a.B);
  const int kh = rest % a.KH, b = rest / a.KH;
  const int group = a.H / a.KH, k0 = j * kBlockRows;
  const int vlen = row_length(a, b);
  const int n_q = (a.T + QS - 1) / QS;
  // The first q tile at or below the diagonal (`first_i`, :326); "len"
  // skips the q tiles and the key blocks past the row's length.
  const int i0 = a.causal ? k0 / QS : 0;
  int i1 = n_q;
  if (a.mask_mode == kLen) i1 = k0 >= vlen ? 0 : min(n_q, (vlen + QS - 1) / QS);
  const int n_i = max(i1 - i0, 0), n_iter = group * n_i;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival a consumer warp
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup; one thread loads
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&m.q);
      prefetch_map(&m.g);
      mbar_expect_tx(kv_bar, 2 * kConsumers * L::kTileBytes);
      for (int c = 0; c < kConsumers; ++c) {
        load_tile<D, kBox>(base + SM::kK + c * L::kTileBytes, &m.k, kv_bar, kh, k0 + c * kBox, b);
        load_tile<D, kBox>(base + SM::kV + c * L::kTileBytes, &m.v, kv_bar, kh, k0 + c * kBox, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int st = it % kStages;
        mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const int h = kh * group + it / n_i, q0 = (i0 + it % n_i) * QS;
        const uint32_t bar = full + 8 * st, sq = base + SM::kStage + st * 2 * SM::kQBytes;
        mbar_expect_tx(bar, 2 * SM::kQBytes + 2 * kStatBox<QS> * 4);
        load_tile<D, QS>(sq, &m.q, bar, h, q0, b);
        load_tile<D, QS>(sq + SM::kQBytes, &m.g, bar, h, q0, b);
        const int stat = ((b * a.H + h) * a.T + q0) & ~3;
        const uint32_t sl = base + SM::kStats + st * 2 * kStatSlot<QS>;
        tma_load_1d(sl, &m.lse, bar, stat);
        tma_load_1d(sl + kStatSlot<QS>, &m.delta, bar, stat);
      }
    }
  } else {  // a consumer: 64 keys
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int kw0 = k0 + wg * kBox;  // the consumer's first key
    const int kw = kw0 + 16 * warp;  // its warp's
    const float scale2 = a.scale * kLog2e, fl = raw_floor(a.scale);
    // The key-only terms of `valid` for this thread's two keys, and the
    // query limit.
    bool key_ok[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = kw + g + 8 * hf;
      key_ok[hf] = key < a.S && (a.mask_mode != kLen || key < vlen) &&
                   (a.mask_mode != kRows || a.mask[static_cast<int64_t>(b) * a.S + key] != 0);
    }
    const int qlim = a.mask_mode == kLen ? min(a.T, vlen) : a.T;
    const int klim = a.mask_mode == kLen ? min(a.S, vlen) : a.S;
    const uint32_t uK = base + SM::kK + wg * L::kTileBytes;
    const uint32_t uV = base + SM::kV + wg * L::kTileBytes;

    float dk[ND][4], dv[ND][4], s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages;
      mbar_wait(full + 8 * st, (it / kStages) & 1);
      const int h = kh * group + it / n_i, q0 = (i0 + it % n_i) * QS;
      const uint32_t sq = base + SM::kStage + st * 2 * SM::kQBytes, sg = sq + SM::kQBytes;
      const float* lse =
          stats + st * 2 * (kStatSlot<QS> / 4) + (((b * a.H + h) * a.T + q0) & 3);
      const float* delta = lse + kStatSlot<QS> / 4;
      if (!(kw0 >= klim || q0 >= qlim || (a.causal && kw0 > q0 + QS - 1))) {  // else all masked
        bool masked = a.mask_mode != kNone || q0 + QS > a.T || kw0 + kBox > a.S ||
                      (a.causal && kw0 + kBox - 1 > q0);
#pragma unroll
        for (int n = 0; n < NQ; ++n)  // a NaN lse in this thread's columns
          masked = masked || isnan(lse[8 * n + 2 * t]) || isnan(lse[8 * n + 2 * t + 1]);
        // S^T = K Q^T and dP^T = V dO^T, k over D.
        wgmma_fence();
        wgmma_ss<QS, 0>(&s[0][0], kmajor<D, kBox>(uK, 0), kmajor<D, QS>(sq, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<QS, 1>(&s[0][0], kmajor<D, kBox>(uK, kk),
                          kmajor<D, QS>(sq, kk));
        wgmma_commit();
        wgmma_ss<QS, 0>(&dp[0][0], kmajor<D, kBox>(uV, 0), kmajor<D, QS>(sg, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<QS, 1>(&dp[0][0], kmajor<D, kBox>(uV, kk),
                          kmajor<D, QS>(sg, kk));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<QS / 2>(&s[0][0]);
        // P^T (keys x queries), then dV += P^T dO, k over the queries.
        if (masked) {
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const int qi = 8 * n + 2 * t;  // the query within the tile
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = exp2f(fmaf(s[n][e], scale2, -lse[qi + (e & 1)] * kLog2e));
              const int q = q0 + qi + (e & 1), key = kw + g + 8 * (e >> 1);
              const bool ok = key_ok[e >> 1] && q < qlim && !(a.causal && key > q) &&
                              !(s[n][e] <= fl);
              s[n][e] = ok ? x : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const int qi = 8 * n + 2 * t;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = exp2f(fmaf(s[n][e], scale2, -lse[qi + (e & 1)] * kLog2e));
          }
        }
        uint32_t pa[QS / 16][4];
        pack_a<QS>(pa, s);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < QS / 16; ++kq) wgmma_rs<D>(&dv[0][0], pa[kq], mnmajor<D, QS>(sg, 16 * kq));
        wgmma_commit();
        wgmma_wait<1>();  // dP^T (dV may still run)
        fence_regs<QS / 2>(&dp[0][0]);
        // dS^T = P^T (dP^T - delta) scale, then dK += dS^T Q. A query past
        // T has no row in the reference: its dS is 0 whatever its delta (the
        // next head's) or dP (a zero dO row against an inf in V) holds.
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int qi = 8 * n + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds = s[n][e] * (dp[n][e] - delta[qi + (e & 1)]) * a.scale;
            dp[n][e] = masked && q0 + qi + (e & 1) >= a.T ? 0.f : ds;
          }
        }
        uint32_t da[QS / 16][4];
        pack_a<QS>(da, dp);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < QS / 16; ++kq) wgmma_rs<D>(&dk[0][0], da[kq], mnmajor<D, QS>(sq, 16 * kq));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(&dv[0][0]);
        fence_regs<D / 2>(&dk[0][0]);
        fence_regs<QS / 4>(&pa[0][0]);
        fence_regs<QS / 4>(&da[0][0]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // the warp is done with the stage
    }
    const int64_t ks = static_cast<int64_t>(a.KH) * D;
    const int64_t koff = (static_cast<int64_t>(b) * a.S * a.KH + kh) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dk) + koff, ks, kw, a.S, dk, lane);
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dv) + koff, ks, kw, a.S, dv, lane);
  }
}

// ---------------------------------------------------------------- K2 ----

// Keys of a K2 stage.
constexpr int kDqKeys = 128;

template <int D>
struct DqSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kKvBytes = Lay<D, kDqKeys>::kTileBytes;  // K or V of a stage
  static constexpr int kQ = 0;                                    // [consumer] tiles
  static constexpr int kG = kQ + kConsumers * Lay<D, kBox>::kTileBytes;
  static constexpr int kStage = kG + kConsumers * Lay<D, kBox>::kTileBytes;  // [stage] (K, V)
  static constexpr int kStats = kStage + kStages * 2 * kKvBytes;  // lse, delta
  static constexpr int kBars = kStats + 2 * kConsumers * kStatSlot<kBox>;  // full, empty, q
  static constexpr int kBytes = kBars + 8 * (2 * kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_wgmma(const __grid_constant__ Maps m, const Args a) {
  using L = Lay<D, kBox>;  // Q and dO
  using SM = DqSmem<D>;
  constexpr int BK = kDqKeys, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const float* stats = reinterpret_cast<const float*>(smem + (base - smem_u32(smem)) + SM::kStats);
  const uint32_t full = base + SM::kBars, empty = full + 8 * kStages, q_bar = empty + 8 * kStages;

  // Causal: the query blocks with the most key tiles first.
  const int n_qb = (a.T + kBlockRows - 1) / kBlockRows;
  const int ib = blockIdx.x / (a.H * a.B), rest = blockIdx.x % (a.H * a.B);
  const int i = a.causal ? n_qb - 1 - ib : ib;
  const int h = rest % a.H, b = rest / a.H, kh = h / (a.H / a.KH);
  const int q0 = i * kBlockRows;
  const int vlen = row_length(a, b);
  // The key tiles the block visits (`last_j`, :128-146, for 128 queries).
  int n_tiles = (a.S + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + kBlockRows - 1) / BK + 1);
  if (a.mask_mode == kLen) n_tiles = q0 >= vlen ? 0 : min(n_tiles, (vlen + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup; one thread loads
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&m.k);
      prefetch_map(&m.v);
      mbar_expect_tx(q_bar, 2 * kConsumers * (L::kTileBytes + kStatBox<kBox> * 4));
      const int stat = ((b * a.H + h) * a.T + q0) & ~3;
      for (int c = 0; c < kConsumers; ++c) {
        load_tile<D, kBox>(base + SM::kQ + c * L::kTileBytes, &m.q, q_bar, h, q0 + c * kBox, b);
        load_tile<D, kBox>(base + SM::kG + c * L::kTileBytes, &m.g, q_bar, h, q0 + c * kBox, b);
        tma_load_1d(base + SM::kStats + c * kStatSlot<kBox>, &m.lse, q_bar, stat + c * kBox);
        tma_load_1d(base + SM::kStats + (kConsumers + c) * kStatSlot<kBox>, &m.delta, q_bar,
                    stat + c * kBox);
      }
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % kStages;
        mbar_wait(empty + 8 * st, ((jt / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st, sk = base + SM::kStage + st * 2 * SM::kKvBytes;
        mbar_expect_tx(bar, 2 * SM::kKvBytes);
        load_tile<D, BK>(sk, &m.k, bar, kh, jt * BK, b);
        load_tile<D, BK>(sk + SM::kKvBytes, &m.v, bar, kh, jt * BK, b);
      }
    }
  } else {  // a consumer: 64 queries
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + wg * kBox;  // the consumer's first query
    const int qw = qw0 + 16 * warp;  // its warp's
    const float scale2 = a.scale * kLog2e;
    const int qlim = a.mask_mode == kLen ? min(a.T, vlen) : a.T;
    const int klim = a.mask_mode == kLen ? min(a.S, vlen) : a.S;
    const uint32_t uQ = base + SM::kQ + wg * L::kTileBytes;
    const uint32_t uG = base + SM::kG + wg * L::kTileBytes;

    float acc[ND][4], s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    mbar_wait(q_bar, 0);
    // This thread's two query rows: lse (times log2 e) and delta.
    const float* lse = stats + wg * (kStatSlot<kBox> / 4) + (((b * a.H + h) * a.T + q0) & 3);
    const float* delta = lse + kConsumers * (kStatSlot<kBox> / 4);
    float lse2[2], dl[2];
    bool row_ok[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * warp + g + 8 * hf;
      lse2[hf] = lse[r] * kLog2e;
      dl[hf] = delta[r];
      row_ok[hf] = qw + g + 8 * hf < qlim;
    }

    for (int jt = 0; jt < n_tiles; ++jt) {
      const int st = jt % kStages;
      mbar_wait(full + 8 * st, (jt / kStages) & 1);
      const int k0 = jt * BK;
      const uint32_t sk = base + SM::kStage + st * 2 * SM::kKvBytes, sv = sk + SM::kKvBytes;
      if (!(qw0 >= qlim || (a.causal && k0 > qw0 + kBox - 1))) {  // else all masked
        const bool masked = a.mask_mode != kNone || qw0 + kBox > a.T || k0 + BK > a.S ||
                            (a.causal && k0 + BK - 1 > qw0);
        // S = Q K^T and dP = dO V^T, k over D.
        wgmma_fence();
        wgmma_ss<BK, 0>(&s[0][0], kmajor<D, kBox>(uQ, 0), kmajor<D, BK>(sk, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BK, 1>(&s[0][0], kmajor<D, kBox>(uQ, kk), kmajor<D, BK>(sk, kk));
        wgmma_commit();
        wgmma_ss<BK, 0>(&dp[0][0], kmajor<D, kBox>(uG, 0), kmajor<D, BK>(sv, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BK, 1>(&dp[0][0], kmajor<D, kBox>(uG, kk), kmajor<D, BK>(sv, kk));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs<BK / 2>(&s[0][0]);
        if (masked) {
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            int keep[2] = {1, 1};
            if (a.mask_mode == kRows) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = k0 + 8 * n + 2 * t + e;
                keep[e] = key < a.S ? a.mask[static_cast<int64_t>(b) * a.S + key] : 0;
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hf = e >> 1;
              const int q = qw + g + 8 * hf, key = k0 + 8 * n + 2 * t + (e & 1);
              const bool ok = row_ok[hf] && key < klim && keep[e & 1] != 0 &&
                              !(a.causal && key > q);
              s[n][e] = ok ? exp2f(fmaf(s[n][e], scale2, -lse2[hf])) : 0.f;
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = exp2f(fmaf(s[n][e], scale2, -lse2[e >> 1]));
        }
        wgmma_wait<0>();
        fence_regs<BK / 2>(&dp[0][0]);
        // dS = P (dP - delta) scale, then dq += dS K, k over the keys. A key
        // past S has no column in the reference: its dS is 0.
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds = s[n][e] * (dp[n][e] - dl[e >> 1]) * a.scale;
            dp[n][e] = masked && k0 + 8 * n + 2 * t + (e & 1) >= a.S ? 0.f : ds;
          }
        uint32_t da[BK / 16][4];
        pack_a<BK>(da, dp);
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < BK / 16; ++kq) wgmma_rs<D>(&acc[0][0], da[kq], mnmajor<D, BK>(sk, 16 * kq));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(&acc[0][0]);
        fence_regs<BK / 4>(&da[0][0]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    const int64_t qs = static_cast<int64_t>(a.H) * D;
    const int64_t qoff = (static_cast<int64_t>(b) * a.T * a.H + h) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(a.dq) + qoff, qs, qw, a.T, acc, lane);
  }
}

// ---------------------------------------------------------------- K1 ----

// Keys of a K1 stage.
constexpr int kFwdKeys = 128;

// 2^x in one MUFU.EX2, subnormal results flushed to 0 (exp2f adds a
// rescale for them): p and the rescale are summed in f32 and rounded to
// bf16, where a p under 2^-126 is 0 either way. NaN and inf pass through.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr int kFwdStages = 2;

template <int D>
struct FwdSmem {  // byte offsets from the 1024-aligned base
  static constexpr int kKvBytes = Lay<D, kFwdKeys>::kTileBytes;  // K or V of a stage
  static constexpr int kQ = 0;                                     // [consumer] tiles
  static constexpr int kStage = kQ + kConsumers * Lay<D, kBox>::kTileBytes;  // [stage] (K, V)
  static constexpr int kBars = kStage + kFwdStages * 2 * kKvBytes;  // full, empty, q
  static constexpr int kBytes = kBars + 8 * (2 * kFwdStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ Maps m, const Args a) {
  using L = Lay<D, kBox>;  // Q
  using SM = FwdSmem<D>;
  constexpr int BK = kFwdKeys, NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = aligned_base(smem);
  const uint32_t full = base + SM::kBars, empty = full + 8 * kFwdStages, q_bar = empty + 8 * kFwdStages;

  // Causal: the query blocks with the most key tiles first.
  const int n_qb = (a.T + kBlockRows - 1) / kBlockRows;
  const int ib = blockIdx.x / (a.H * a.B), rest = blockIdx.x % (a.H * a.B);
  const int i = a.causal ? n_qb - 1 - ib : ib;
  const int h = rest % a.H, b = rest / a.H, kh = h / (a.H / a.KH);
  const int q0 = i * kBlockRows;
  const int vlen = row_length(a, b);
  // The key tiles the block visits (`last_j`, :128-146, for 128 queries).
  int n_tiles = (a.S + BK - 1) / BK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + kBlockRows - 1) / BK + 1);
  if (a.mask_mode == kLen) n_tiles = q0 >= vlen ? 0 : min(n_tiles, (vlen + BK - 1) / BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup; one thread loads
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&m.k);
      prefetch_map(&m.v);
      mbar_expect_tx(q_bar, kConsumers * L::kTileBytes);
      for (int c = 0; c < kConsumers; ++c)
        load_tile<D, kBox>(base + SM::kQ + c * L::kTileBytes, &m.q, q_bar, h, q0 + c * kBox, b);
      for (int jt = 0; jt < n_tiles; ++jt) {
        const int st = jt % kFwdStages;
        mbar_wait(empty + 8 * st, ((jt / kFwdStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st, sk = base + SM::kStage + st * 2 * SM::kKvBytes;
        mbar_expect_tx(bar, 2 * SM::kKvBytes);
        load_tile<D, BK>(sk, &m.k, bar, kh, jt * BK, b);
        load_tile<D, BK>(sk + SM::kKvBytes, &m.v, bar, kh, jt * BK, b);
      }
    }
  } else {  // a consumer: 64 queries
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    const int qw0 = q0 + wg * kBox;  // the consumer's first query
    const int qw = qw0 + 16 * warp;  // its warp's
    const float scale2 = a.scale * kLog2e;
    const int qlim = a.mask_mode == kLen ? min(a.T, vlen) : a.T;
    const uint32_t uQ = base + SM::kQ + wg * L::kTileBytes;

    // This thread's two rows (g, g + 8): running max in log2 units, its own
    // share of the running sum (summed over the quad at the end), out.
    float m2[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float acc[ND][4], s[NK][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    mbar_wait(q_bar, 0);

    for (int jt = 0; jt < n_tiles; ++jt) {
      const int st = jt % kFwdStages;
      mbar_wait(full + 8 * st, (jt / kFwdStages) & 1);
      const int k0 = jt * BK;
      const uint32_t sk = base + SM::kStage + st * 2 * SM::kKvBytes, sv = sk + SM::kKvBytes;
      if (!(qw0 >= qlim || (a.causal && k0 > qw0 + kBox - 1))) {  // else all masked
        const bool masked = a.mask_mode != kNone || qw0 + kBox > a.T || k0 + BK > a.S ||
                            (a.causal && k0 + BK - 1 > qw0);
        // S = Q K^T, k over D.
        wgmma_fence();
        wgmma_ss<BK, 0>(&s[0][0], kmajor<D, kBox>(uQ, 0), kmajor<D, BK>(sk, 0));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss<BK, 1>(&s[0][0], kmajor<D, kBox>(uQ, kk), kmajor<D, BK>(sk, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<BK / 2>(&s[0][0]);
        // Masked scores leave the max at the floor; their p is selected to 0
        // after the exp (bit 4 n + e of `ok`).
        uint64_t ok = ~0ull;
        if (masked) {
          ok = 0ull;
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            int keep[2] = {1, 1};
            if (a.mask_mode == kRows) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = k0 + 8 * n + 2 * t + e;
                keep[e] = key < a.S ? a.mask[static_cast<int64_t>(b) * a.S + key] : 0;
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = qw + g + 8 * (e >> 1), key = k0 + 8 * n + 2 * t + (e & 1);
              if (q < qlim && key < a.S && keep[e & 1] != 0 && !(a.causal && key > q) &&
                  (a.mask_mode != kLen || key < vlen)) {
                ok |= 1ull << (4 * n + e);
              } else {
                s[n][e] = kNeg;
              }
            }
          }
        }
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        float alpha[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
          const float m_new = fmaxf(m2[hf], mx[hf] * scale2);
          alpha[hf] = ex2(m2[hf] - m_new);  // <= 1, and 1 while the row is all masked
          m2[hf] = m_new;
        }
        // p against the running max, in place, then packed to bf16.
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = ex2(fmaf(s[n][e], scale2, -m2[e >> 1]));
            s[n][e] = (ok >> (4 * n + e)) & 1ull ? x : 0.f;
            rs[e >> 1] += s[n][e];
          }
        uint32_t pa[BK / 16][4];
        pack_a<BK>(pa, s);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + rs[hf];
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }
        // out += P V, k over the tile's keys.
        wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < BK / 16; ++kq) wgmma_rs<D>(&acc[0][0], pa[kq], mnmajor<D, BK>(sv, 16 * kq));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(&acc[0][0]);
        fence_regs<BK / 4>(&pa[0][0]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // the warp is done with the stage
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
    // A row with no valid key: l = 0, so out = 0 and lse = the floor.
    const float inv0 = 1.f / max_nan(l[0], 1e-30f), inv1 = 1.f / max_nan(l[1], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= inv0;
      acc[n][1] *= inv0;
      acc[n][2] *= inv1;
      acc[n][3] *= inv1;
    }
    const int64_t qs = static_cast<int64_t>(a.H) * D;
    const int64_t qoff = (static_cast<int64_t>(b) * a.T * a.H + h) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(a.out) + qoff, qs, qw, a.T, acc, lane);
    if (t == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = qw + g + 8 * hf;
        if (row < a.T) {
          a.lse[(static_cast<int64_t>(b) * a.H + h) * a.T + row] =
              !(l[hf] <= 0.f) ? m2[hf] * (1.f / kLog2e) + logf(l[hf]) : kNeg;
        }
      }
    }
  }
}

}  // namespace wk

// ------------------------------------------------------------ launch ----

enum Which : int { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
constexpr size_t smem_bytes(int which) {
  return sizeof(float) *
         (which == kFwd ? 2 * D * kBQ + kBK * D + kBK * kPad
          : which == kDq ? 2 * D * kBQ + 3 * D * kBK + kBK * kPad
                         : 4 * D * kBQ + 2 * D * kBK + kBQ * kPad + 2 * kBQ);
}

// The 4-D map (D, heads, rows, batch) of a contiguous bf16 [B, rows, heads,
// D] tensor, boxes of `box_rows` rows x min(D, 64) columns, swizzled as
// wk::Lay expects; rows past `rows` read as zero.
int head_map(EncodeTiled fn, CUtensorMap* m, const void* p, int B, int rows, int heads, int D,
             int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D < 64 ? D : 64), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The 1-D map of an f32 [B, H, T] statistic, boxes of `box` values.
int stat_map(EncodeTiled fn, CUtensorMap* m, const float* p, int64_t n, int box_values) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // rank 1: none is read
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(box_values)}, unit[1] = {1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// K1, K2 or K3 in bf16: the tensor maps, then the launch. TMA needs every
// base 16-byte aligned (the row strides, 2 D bytes and their multiples,
// are): a misaligned one is refused with cudaErrorMisalignedAddress.
template <int D>
int launch_wgmma(int which, const Args& a, cudaStream_t stream) {
  for (const void* p : {a.q, a.k, a.v, a.dout, static_cast<const void*>(a.lse_in),
                        static_cast<const void*>(a.delta)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  void (*kern)(wk::Maps, Args);
  int smem, blocks;
  if (which == kDkv) {
    kern = wk::flash_dkv_wgmma<D>;
    smem = wk::DkvSmem<D>::kBytes;
    blocks = (a.S + wk::kBlockRows - 1) / wk::kBlockRows * a.KH * a.B;
  } else {
    kern = which == kDq ? wk::flash_dq_wgmma<D> : wk::flash_fwd_wgmma<D>;
    smem = which == kDq ? wk::DqSmem<D>::kBytes : wk::FwdSmem<D>::kBytes;
    blocks = (a.T + wk::kBlockRows - 1) / wk::kBlockRows * a.H * a.B;
  }
  // A runtime call before the driver's encoder: it makes the device's
  // primary context current in a thread that has not used CUDA yet, where
  // cuTensorMapEncodeTiled would fail.
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  wk::Maps m;
  const int64_t n_stat = static_cast<int64_t>(a.B) * a.H * a.T;
  // The boxes' rows: K3 streams q tiles of kDkvQueries and holds 64 keys a
  // consumer; K1 and K2 hold 64 queries a consumer and stream kFwdKeys and
  // kDqKeys keys.
  const int q_rows = which == kDkv ? wk::kDkvQueries<D> : wk::kBox;
  const int k_rows = which == kDkv ? wk::kBox : which == kDq ? wk::kDqKeys : wk::kFwdKeys;
  int rc = head_map(fn, &m.q, a.q, a.B, a.T, a.H, D, q_rows);
  if (rc == 0) rc = head_map(fn, &m.k, a.k, a.B, a.S, a.KH, D, k_rows);
  if (rc == 0) rc = head_map(fn, &m.v, a.v, a.B, a.S, a.KH, D, k_rows);
  if (which != kFwd) {  // dO, lse and delta: the backward's alone
    const int box = which == kDkv ? wk::kStatBox<wk::kDkvQueries<D>> : wk::kStatBox<wk::kBox>;
    if (rc == 0) rc = head_map(fn, &m.g, a.dout, a.B, a.T, a.H, D, q_rows);
    if (rc == 0) rc = stat_map(fn, &m.lse, a.lse_in, n_stat, box);
    if (rc == 0) rc = stat_map(fn, &m.delta, a.delta, n_stat, box);
  }
  if (rc != 0) return rc;
  kern<<<blocks, wk::kThreads, smem, stream>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(int which, const Args& a, cudaStream_t stream) {
  if constexpr (!std::is_same_v<T, float>) {  // bf16: K1, K2 and K3 on wgmma
    return launch_wgmma<D>(which, a, stream);
  } else {  // the CUDA-core f32 kernels
    void (*kern)(Args) = which == kFwd ? flash_fwd_kernel<float, D>
                         : which == kDq ? flash_dq_kernel<float, D>
                                        : flash_dkv_kernel<float, D>;
    const int smem = static_cast<int>(smem_bytes<D>(which));
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(which == kDkv ? (a.S + kBK - 1) / kBK : (a.T + kBQ - 1) / kBQ,
                    which == kDkv ? a.KH : a.H, a.B);
    kern<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int dispatch_d(int which, int D, const Args& a, cudaStream_t s) {
  if (D == 32) return launch<T, 32>(which, a, s);
  if (D == 64) return launch<T, 64>(which, a, s);
  if (D == 128) return launch<T, 128>(which, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int which, int dtype, int D, const Args& a, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.S <= 0 || a.KH <= 0 || a.H % a.KH != 0 ||
      a.B > 65535 || a.H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(which, D, a, s);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(which, D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(int B, int T, int S, int H, int KH, int causal, int mask_mode,
               const void* mask, float scale) {
  Args a = {};
  a.B = B; a.T = T; a.S = S; a.H = H; a.KH = KH;
  a.causal = causal; a.mask_mode = mask_mode;
  a.mask = static_cast<const int*>(mask);
  a.scale = scale;
  return a;
}

}  // namespace

// Each entry point launches one kernel on `stream` without synchronising and
// returns cudaGetLastError(). dtype: 0 = f32, 1 = bf16 (q, k, v, dO and the
// outputs share it); D is 32, 64 or 128; mask is null (mode 0), int32 [B]
// lengths (mode 1) or int32 [B, S] (mode 2).
extern "C" int slt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, const void* mask,
                             int dtype, int B, int T, int S, int H, int KH,
                             int D, int causal, int mask_mode, float scale,
                             void* stream) {
  Args a = make_args(B, T, S, H, KH, causal, mask_mode, mask, scale);
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = lse;
  return dispatch(kFwd, dtype, D, a, stream);
}

extern "C" int slt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, const void* mask,
                            int dtype, int B, int T, int S, int H, int KH,
                            int D, int causal, int mask_mode, float scale,
                            void* stream) {
  Args a = make_args(B, T, S, H, KH, causal, mask_mode, mask, scale);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq = dq;
  return dispatch(kDq, dtype, D, a, stream);
}

extern "C" int slt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const void* mask, int dtype, int B, int T, int S,
                             int H, int KH, int D, int causal, int mask_mode,
                             float scale, void* stream) {
  Args a = make_args(B, T, S, H, KH, causal, mask_mode, mask, scale);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  return dispatch(kDkv, dtype, D, a, stream);
}
