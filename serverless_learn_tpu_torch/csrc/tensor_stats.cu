// Tensor statistics for the numerics layer (telemetry/numerics.py) on Hopper
// (sm_90a): the per-subtree norms, maxima, non-finite counts and positional
// fingerprint sums of a training step.
//
// Replaces no TPU kernel. The reference computes the same values as jnp
// reductions that XLA fuses into its jitted step
// (serverless_learn_tpu/telemetry/numerics.py:109-166, `_sub_stats` and
// `fingerprint`, over the grads, the params and the updates). Eager PyTorch
// would read every tensor once per statistic and allocate full-size masks
// (the reference concatenates a subtree and masks it with jnp.where); these
// two kernels read each tensor once and keep every intermediate in
// registers.
//
//   * tensor_stats_kernel: one pass over a tensor x (f32, bf16, f16 or int8),
//     v = scale * x in f32. Block b owns the contiguous slab [b * slab,
//     (b + 1) * slab) of elements and writes one row of kCols doubles:
//       0 sum of v^2 over finite v       1 sum of v^2 over every v (a NaN or
//                                          an inf carries into it)
//       2 max |v| over finite v          3 NaN count       4 +-inf count
//       5 sum of finite v                6 + c: the sum of finite v whose
//                                          index within its subtree lies in
//                                          chunk c (the reference's padded
//                                          reshape into `chunks` parts)
//     Squares are taken in f32 (the reference's jnp.square, which overflows
//     the same way); each thread folds kUnroll of them in f32, then adds the
//     partial to f64 accumulators.
//     tensor_stats_many_kernel does the same for a list of tensors in one
//     launch (a step's gradients, its parameters), their descriptors passed
//     by value: block b finds its tensor by its first row.
//   * stats_reduce_kernel: one block per group of consecutive rows (a
//     subtree's tensors): warp w folds every 32nd row from the w-th, lane j
//     column j, then the warps' partials are folded in warp order (max for
//     column 2).
// Nothing depends on the order blocks run in or on the tensor's alignment
// (each thread folds the same elements in the same order, with one vector
// load per four where they are aligned), so every result repeats bit for
// bit: a fingerprint of a restored state equals the saved state's.
//
// What bounds it on an H100 SXM: the bytes. llama_1b's f32 parameters are
// 4.9 GB, read once (1.5 ms at 3.35 TB/s); the work is ~10 flops and a few
// f64 adds per element, far under the f32 and f64 rates.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;          // elements in flight per thread
constexpr int kFixed = 6;           // columns before the chunk sums
constexpr int kMaxChunks = 16;
constexpr int kCols = kFixed + kMaxChunks;
constexpr int kMaxGrid = 1056;      // 8 blocks a SM of an H100
constexpr int kQuad = 4;            // consecutive elements a thread loads

enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

// A tensor of the many-tensor launch. The launch takes them by value (up to
// kMaxMany, 12 KB of parameters; Hopper takes up to 32 KB), so nothing is
// copied to the card first.
struct Desc {
  const void* x;
  long long n, base, chunk, row0;
  int dtype;
};
constexpr int kMaxMany = 256;
struct Many {
  Desc d[kMaxMany];
};

__device__ __forceinline__ float load(const float* p, int64_t i) { return __ldg(p + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load(const __half* p, int64_t i) { return __half2float(p[i]); }
__device__ __forceinline__ float load(const int8_t* p, int64_t i) {
  return static_cast<float>(p[i]);
}

// kQuad consecutive elements in one load (16 bytes of f32, 8 of bf16 / f16,
// 4 of int8), where their address is aligned to it.
template <typename T> struct Quad;
template <> struct Quad<float> {
  static constexpr int bytes = 16;
  __device__ static void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Quad<__nv_bfloat16> {
  static constexpr int bytes = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
};
template <> struct Quad<__half> {
  static constexpr int bytes = 8;
  __device__ static void load(const __half* p, float* f) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&w);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
};
template <> struct Quad<int8_t> {
  static constexpr int bytes = 4;
  __device__ static void load(const int8_t* p, float* f) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(p));
    f[0] = c.x; f[1] = c.y; f[2] = c.z; f[3] = c.w;
  }
};

struct Acc {
  double sq = 0.0, sq_all = 0.0, sum = 0.0;
  float amax = 0.f;
  unsigned nan = 0, inf = 0;
};

// Folds x[a, z) into acc and returns the sum of its finite values. Thread
// t takes the kQuad elements from a + kQuad t, kUnroll of them in flight (in
// quads kThreads * kQuad apart), in one load each where they are aligned and
// one by one where they are not (a range that starts at a chunk boundary):
// the same values in the same order either way, so the result does not
// depend on where x lies.
template <typename T>
__device__ __forceinline__ double fold(const T* __restrict__ x, int64_t a,
                                       int64_t z, float scale, Acc& acc) {
  constexpr int kQuads = kUnroll / kQuad;
  const bool vec = reinterpret_cast<uintptr_t>(x + a) % Quad<T>::bytes == 0;
  double part = 0.0;
  for (int64_t i0 = a + kQuad * static_cast<int64_t>(threadIdx.x); i0 < z;
       i0 += static_cast<int64_t>(kThreads) * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int64_t i = i0 + static_cast<int64_t>(q) * kThreads * kQuad;
      if (vec && i + kQuad <= z) {
        Quad<T>::load(x + i, v + kQuad * q);
      } else {
#pragma unroll
        for (int e = 0; e < kQuad; ++e)
          v[kQuad * q + e] = i + e < z ? load(x, i + e) : 0.f;
      }
    }
    float sq = 0.f, sq_all = 0.f, s = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float w = scale * v[u];
      const float aw = fabsf(w);
      const bool finite = aw <= FLT_MAX;  // false for NaN and +-inf
      const float wf = finite ? w : 0.f;
      sq += wf * wf;
      sq_all += w * w;
      s += wf;
      acc.amax = fmaxf(acc.amax, finite ? aw : 0.f);
      acc.nan += w != w;
      acc.inf += !finite && w == w;
    }
    acc.sq += sq;
    acc.sq_all += sq_all;
    part += s;
  }
  acc.sum += part;
  return part;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The block's sum of x, in warp order, on thread 0 (others get garbage).
__device__ double block_sum(double x, double* sm) {
  x = warp_sum(x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // sm may hold the previous call's values
  if (lane == 0) sm[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += sm[w];
  return s;
}

// The rows x owns are as many as the blocks it takes: one per
// kThreads * kUnroll elements, at most kMaxGrid (the wrappers' grid_for).
__host__ __device__ __forceinline__ int64_t grid_for(int64_t n) {
  const int64_t per = static_cast<int64_t>(kThreads) * kUnroll;
  int64_t g = (n + per - 1) / per;
  return g < 1 ? 1 : (g > kMaxGrid ? kMaxGrid : g);
}

// Elements a block of x's reads: ceil(n / grid) rounded up to a multiple of
// kThreads * kUnroll (a block past n writes a row of zeros).
__host__ __device__ __forceinline__ int64_t slab_for(int64_t n, int64_t grid) {
  const int64_t per = static_cast<int64_t>(kThreads) * kUnroll;
  int64_t slab = (n + grid - 1) / grid;
  slab = (slab + per - 1) / per * per;
  return slab == 0 ? per : slab;
}

// Block `lb` of x's blocks: elements [lb * slab, (lb + 1) * slab) into
// `row`.
template <typename T>
__device__ __forceinline__ void stats_block(const T* __restrict__ x,
                                            int64_t n, int64_t slab,
                                            float scale, int64_t base,
                                            int64_t chunk, int chunks,
                                            int64_t lb, double* row) {
  __shared__ double sm_d[kWarps];
  __shared__ double sm_acc[3][kWarps];
  __shared__ float sm_max[kWarps];
  __shared__ unsigned long long sm_cnt[2][kWarps];
  const int64_t lo = lb * slab;
  const int64_t hi = lo + slab < n ? lo + slab : n;
  Acc acc;
  if (threadIdx.x == 0)
    for (int c = kFixed; c < kCols; ++c) row[c] = 0.0;
  if (chunks > 0 && lo < hi) {
    // One sub-range per chunk the slab crosses (a chunk boundary is a
    // multiple of `chunk` in the subtree's index, base + i).
    int64_t a = lo;
    while (a < hi) {
      const int64_t c = (base + a) / chunk;
      int64_t z = (c + 1) * chunk - base;
      if (z > hi) z = hi;
      const double part = block_sum(fold(x, a, z, scale, acc), sm_d);
      if (threadIdx.x == 0 && c < kMaxChunks) row[kFixed + c] += part;
      a = z;
    }
  } else if (lo < hi) {
    fold(x, lo, hi, scale, acc);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const double sq = warp_sum(acc.sq), sq_all = warp_sum(acc.sq_all),
               sum = warp_sum(acc.sum);
  const float amax = warp_max(acc.amax);
  const unsigned long long nan = warp_sum(static_cast<unsigned long long>(acc.nan)),
                           inf = warp_sum(static_cast<unsigned long long>(acc.inf));
  if (lane == 0) {
    sm_acc[0][warp] = sq;
    sm_acc[1][warp] = sq_all;
    sm_acc[2][warp] = sum;
    sm_max[warp] = amax;
    sm_cnt[0][warp] = nan;
    sm_cnt[1][warp] = inf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s0 = 0.0, s1 = 0.0;
    float m = 0.f;
    unsigned long long c0 = 0, c1 = 0;
    for (int w = 0; w < kWarps; ++w) {
      s0 += sm_acc[0][w];
      s1 += sm_acc[1][w];
      m = fmaxf(m, sm_max[w]);
      c0 += sm_cnt[0][w];
      c1 += sm_cnt[1][w];
    }
    row[0] = s0;
    row[1] = s1;
    row[2] = m;
    row[3] = static_cast<double>(c0);
    row[4] = static_cast<double>(c1);
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += sm_acc[2][w];
    row[5] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tensor_stats_kernel(const T* __restrict__ x, int64_t n, int64_t slab,
                    float scale, int64_t base, int64_t chunk, int chunks,
                    double* __restrict__ rows) {
  stats_block(x, n, slab, scale, base, chunk, chunks, blockIdx.x,
              rows + static_cast<int64_t>(blockIdx.x) * kCols);
}

// Many tensors in one launch: block b takes row b, of the tensor whose rows
// hold it (the rows of m.d[0..count) follow each other from m.d[0].row0).
__global__ void __launch_bounds__(kThreads)
tensor_stats_many_kernel(const __grid_constant__ Many m, int count,
                         int chunks, float scale,
                         double* __restrict__ rows) {
  const int64_t b = m.d[0].row0 + blockIdx.x;
  int lo = 0, hi = count - 1;  // the last tensor whose first row is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (m.d[mid].row0 <= b) lo = mid; else hi = mid - 1;
  }
  const Desc& d = m.d[lo];
  const int64_t n = d.n, lb = b - d.row0, grid = grid_for(n);
  if (lb >= grid) return;  // no row past the tensor's own is launched
  const int64_t slab = slab_for(n, grid);
  double* row = rows + b * kCols;
  switch (d.dtype) {
    case kF32:
      stats_block(static_cast<const float*>(d.x), n, slab, scale, d.base,
                  d.chunk, chunks, lb, row);
      break;
    case kBF16:
      stats_block(static_cast<const __nv_bfloat16*>(d.x), n, slab, scale,
                  d.base, d.chunk, chunks, lb, row);
      break;
    case kF16:
      stats_block(static_cast<const __half*>(d.x), n, slab, scale, d.base,
                  d.chunk, chunks, lb, row);
      break;
    default:
      stats_block(static_cast<const int8_t*>(d.x), n, slab, scale, d.base,
                  d.chunk, chunks, lb, row);
  }
}

constexpr int kReduceWarps = 32;

// One block per group: warp w folds rows a + w, a + w + 32, ... (lane j
// column j), then thread j folds the warps' partials in warp order.
__global__ void __launch_bounds__(kReduceWarps * 32)
stats_reduce_kernel(const double* __restrict__ rows,
                    const int64_t* __restrict__ bounds,
                    double* __restrict__ out) {
  __shared__ double part[kReduceWarps][kCols];
  const int g = blockIdx.x, warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const int64_t a = bounds[g], z = bounds[g + 1];
  if (j < kCols) {
    double s = 0.0;
    if (j == 2) {
      for (int64_t r = a + warp; r < z; r += kReduceWarps)
        s = fmax(s, rows[r * kCols + j]);
    } else {
      for (int64_t r = a + warp; r < z; r += kReduceWarps)
        s += rows[r * kCols + j];
    }
    part[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kCols) {
    const int c = threadIdx.x;
    double s = 0.0;
    for (int w = 0; w < kReduceWarps; ++w)
      s = c == 2 ? fmax(s, part[w][c]) : s + part[w][c];
    out[static_cast<int64_t>(g) * kCols + c] = s;
  }
}

}  // namespace

// Writes grid_for(n) rows of kCols doubles at `rows` for the n elements of
// x (contiguous; dtype 0 f32, 1 bf16, 2 f16, 3 int8), each v = scale * x.
// The element at index i of x has index base + i in its subtree; with
// chunks > 0 (at most 16) its finite value also adds to chunk (base + i) /
// chunk. Launches on `stream` without synchronising and returns
// cudaGetLastError(); `grid` must be grid_for(n) (the caller's rows).
extern "C" int slt_tensor_stats(const void* x, int dtype, long long n,
                                int grid, float scale, long long base,
                                long long chunk, int chunks, double* rows,
                                void* stream) {
  if (n < 0 || grid != grid_for(n) || chunks < 0 || chunks > kMaxChunks ||
      (chunks > 0 && chunk < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t slab = slab_for(n, grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      tensor_stats_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), n, slab, scale, base, chunk, chunks, rows);
      break;
    case kBF16:
      tensor_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n, slab, scale, base, chunk,
          chunks, rows);
      break;
    case kF16:
      tensor_stats_kernel<__half><<<grid, kThreads, 0, s>>>(
          static_cast<const __half*>(x), n, slab, scale, base, chunk, chunks, rows);
      break;
    case kI8:
      tensor_stats_kernel<int8_t><<<grid, kThreads, 0, s>>>(
          static_cast<const int8_t*>(x), n, slab, scale, base, chunk, chunks, rows);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same for `count` (at most 256) tensors in one launch, each described
// by six int64s of the host array desc: pointer, n, base, chunk, first row,
// dtype. The first rows follow each other (each tensor's grid_for(n) rows
// after its first); `rows` is the whole row buffer.
extern "C" int slt_tensor_stats_many(const long long* desc, int count,
                                     int chunks, float scale, double* rows,
                                     void* stream) {
  if (count < 1 || count > kMaxMany || chunks < 0 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  Many m;
  long long next = desc[4];
  for (int j = 0; j < count; ++j) {
    const long long* e = desc + 6 * j;
    m.d[j] = Desc{reinterpret_cast<const void*>(e[0]), e[1], e[2], e[3],
                  e[4], static_cast<int>(e[5])};
    if (e[1] < 0 || e[4] != next || e[5] < kF32 || e[5] > kI8 ||
        (chunks > 0 && e[3] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
    next = e[4] + grid_for(e[1]);
  }
  const long long blocks = next - desc[4];
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tensor_stats_many_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      m, count, chunks, scale, rows);
  return static_cast<int>(cudaGetLastError());
}

// out[g] (kCols doubles) folds rows[bounds[g], bounds[g + 1]) for g < groups:
// sums, and the max for column 2. bounds: int64 [groups + 1] on the card.
extern "C" int slt_stats_reduce(const double* rows, const long long* bounds,
                                int groups, double* out, void* stream) {
  if (groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  stats_reduce_kernel<<<groups, kReduceWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rows, reinterpret_cast<const int64_t*>(bounds), out);
  return static_cast<int>(cudaGetLastError());
}
