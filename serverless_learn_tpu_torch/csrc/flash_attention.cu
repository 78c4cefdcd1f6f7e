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
// p^T dO, and ds before ds k and ds^T q; every sum is f32.
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
// backward 2.5x that. This first design runs the products on the CUDA cores
// in f32 (67 TFLOP/s peak), so it sits well above that bound; tensor cores
// (mma.sync, then wgmma with TMA-fed tiles) are the next step. What the
// design does keep from flash attention is the memory side: the [T, S]
// scores never reach device memory, each q/k/v tile is read into shared
// memory once per block and converted to f32 there, and blocks above the
// causal diagonal or past a "len" row's length are skipped outright.
//
// One block of 256 threads owns a 64 x 64 score tile: 16 x 16 threads, each
// with 4 x 4 scores in registers, fed by float4 reads of the transposed q
// and k tiles in shared memory. Row statistics reduce over the 16 threads of
// a half-warp with shuffles. The D output columns are split over the same 16
// threads (D / 16 each), so a row's rescale stays in the thread.
//   * K1: a block per (q tile, head, batch row), looping over k tiles.
//   * K2: the same grid; the loop recomputes p and dp and sums ds k.
//   * K3: a block per (k tile, kv head, batch row) that loops over the
//     group's q heads and the q tiles at or below the diagonal and writes
//     dk, dv once: no atomics, deterministic sums, no [B, H, S, D] buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per tile
constexpr int kBK = 64;                 // key rows per tile
constexpr int kThreads = 256;           // 16 x 16
constexpr int kPad = kBQ + 4;           // row stride of the p / ds tile
constexpr float kNeg = -1e30f;          // the mask floor (`_NEG`)

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

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
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
      const float alpha = expf(fmaxf(m[r] - m_new, kNeg));
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
    const float ll = fmaxf(l[r], 1e-30f);
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
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tx * 4 + c;
          const bool ok = valid(a, b, q0 + qi, key, vlen);
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

// ------------------------------------------------------------ launch ----

enum Which : int { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
constexpr size_t smem_bytes(int which) {
  return sizeof(float) *
         (which == kFwd ? 2 * D * kBQ + kBK * D + kBK * kPad
          : which == kDq ? 2 * D * kBQ + 3 * D * kBK + kBK * kPad
                         : 4 * D * kBQ + 2 * D * kBK + kBQ * kPad + 2 * kBQ);
}

template <typename T, int D>
int launch(int which, const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = which == kFwd  ? flash_fwd_kernel<T, D>
                       : which == kDq ? flash_dq_kernel<T, D>
                                      : flash_dkv_kernel<T, D>;
  const size_t smem = smem_bytes<D>(which);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(which == kDkv ? (a.S + kBK - 1) / kBK : (a.T + kBQ - 1) / kBQ,
                  which == kDkv ? a.KH : a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
