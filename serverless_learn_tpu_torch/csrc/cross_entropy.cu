// Fused softmax cross-entropy with integer labels for Hopper (sm_90a):
// forward (K4) and backward (K5).
//
// Replaces the TPU kernels of serverless_learn_tpu/ops/pallas/
// cross_entropy.py and computes the same functions:
//   * K4 `_ce_fwd` (kernel `_fwd_kernel`, call at :100): per row of logits
//     x [N, V], lse = logsumexp(x) with an online max / sum over the vocab
//     and loss = lse - x[label], both f32. The running max starts at -1e30
//     (`_NEG`), lse = m + log(max(l, 1e-30)), and the label's logit is read
//     from the f32-upcast x; a label outside [0, V) picks nothing, so the
//     loss is lse. The floor of l propagates a NaN, as jnp.maximum does: a
//     NaN or a +inf logit makes the row's lse and loss NaN, as in the plain
//     version (fmaxf would turn the NaN sum into 1e-30, a finite loss).
//   * K5 `_ce_bwd_call` (kernel `_bwd_kernel`, call at :129):
//     dx = (exp(x - lse) - onehot(label)) * g, in f32, cast once to x's type.
// Every exp is of x minus a running or final maximum, so logits of +-80 in
// bf16 never overflow.
//
// What bounds it on an H100 SXM: the bytes. At the llama_8b training shape
// (N = 2 * 4095 rows, V = 128256, bf16) K4 reads 2.1 GB of logits (0.63 ms
// at 3.35 TB/s) and K5 reads and writes that much (1.25 ms); their 1.05e9
// exps each fit under those times. So the design is a streaming pass with
// 16-byte loads, and f32 exists only in registers:
//   * one block of 256 threads owns a row (no state carries between blocks,
//     no atomics, so every sum is deterministic); the TPU grid's sequential
//     vocab axis becomes a loop inside the block;
//   * K4: each thread walks the row 16 bytes at a time, four loads in
//     flight, keeping an online (max, sum) pair in f32 registers; the pairs
//     merge by warp shuffles, then across the 8 warps in shared memory; one
//     thread reads the label's logit directly;
//   * K5: each thread reads 16 bytes of x, writes 16 bytes of dx.
// Rows are read in place through two strides (a batch stride and a row
// stride, the vocab contiguous), so the causal loss's logits[:, :-1] view is
// never copied; dx has its own two strides. A ragged vocab tail is handled
// by scalar accesses, and a row that is not 16-byte aligned (an odd V in
// bf16) takes the scalar path throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // 16-byte loads in flight per thread
constexpr float kNeg = -1e30f;          // the running max's start (`_NEG`)

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T <-> f32 registers.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const int4& w, float (&f)[4]) {
    f[0] = __int_as_float(w.x); f[1] = __int_as_float(w.y);
    f[2] = __int_as_float(w.z); f[3] = __int_as_float(w.w);
  }
  __device__ static int4 pack(const float (&f)[4]) {
    return make_int4(__float_as_int(f[0]), __float_as_int(f[1]),
                     __float_as_int(f[2]), __float_as_int(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const int4& w, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  __device__ static int4 pack(const float (&f)[8]) {
    int4 w;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return w;
  }
};

struct Rows {
  int64_t A, T, V;        // rows n = a * T + t, a < A, t < T; V columns
  int64_t sa, st;         // x's element strides of a and t (vocab stride 1)
  int vec;                // 16-byte path: every row of x (and dx) aligned
};

template <typename P>
__device__ __forceinline__ P* row_ptr(P* base, int64_t n, int64_t T,
                                      int64_t sa, int64_t st) {
  return base + (n / T) * sa + (n % T) * st;
}

// Folds one more value block into the running (max, sum).
template <int K>
__device__ __forceinline__ void online(const float (&f)[K], float& m,
                                       float& l) {
  float mb = f[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mb = fmaxf(mb, f[k]);
  if (mb > m) {
    l *= __expf(m - mb);
    m = mb;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) l += __expf(f[k] - m);
}

__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * __expf(m - mn) + l2 * __expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cross_entropy_fwd_kernel(const T* __restrict__ x,
                         const int* __restrict__ labels,
                         float* __restrict__ loss, float* __restrict__ lse,
                         Rows r) {
  constexpr int kVec = Vec<T>::n;
  const int64_t n = blockIdx.x;
  const T* row = row_ptr(x, n, r.T, r.sa, r.st);
  float m = kNeg, l = 0.f;
  int64_t tail = 0;
  if (r.vec) {
    const int4* rv = reinterpret_cast<const int4*>(row);
    const int64_t nv = r.V / kVec;
    int64_t i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < nv; i += kUnroll * kThreads) {
      int4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(rv + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[kVec];
        Vec<T>::unpack(w[u], f);
        online(f, m, l);
      }
    }
    for (; i < nv; i += kThreads) {
      float f[kVec];
      Vec<T>::unpack(__ldg(rv + i), f);
      online(f, m, l);
    }
    tail = nv * kVec;
  }
  for (int64_t j = tail + threadIdx.x; j < r.V; j += kThreads) {
    const float f[1] = {to_f32(row[j])};
    online(f, m, l);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, l, off));
  }
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) merge(m, l, sm_m[w], sm_l[w]);
    const int lab = labels[n];
    const float picked =
        (lab >= 0 && lab < r.V) ? to_f32(row[lab]) : 0.f;
    const float s = m + logf(l != l || l > 1e-30f ? l : 1e-30f);
    lse[n] = s;
    loss[n] = s - picked;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cross_entropy_bwd_kernel(const T* __restrict__ x,
                         const int* __restrict__ labels,
                         const float* __restrict__ lse,
                         const float* __restrict__ g, T* __restrict__ dx,
                         Rows r, int64_t da, int64_t dt) {
  constexpr int kVec = Vec<T>::n;
  const int64_t n = blockIdx.x;
  const T* row = row_ptr(x, n, r.T, r.sa, r.st);
  T* drow = row_ptr(dx, n, r.T, da, dt);
  const int lab = labels[n];
  const float s = lse[n], gn = g[n];
  int64_t tail = 0;
  if (r.vec) {
    const int4* rv = reinterpret_cast<const int4*>(row);
    int4* dv = reinterpret_cast<int4*>(drow);
    const int64_t nv = r.V / kVec;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float f[kVec];
      Vec<T>::unpack(__ldg(rv + i), f);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float p = __expf(f[k] - s);
        f[k] = (i * kVec + k == lab ? p - 1.f : p) * gn;
      }
      dv[i] = Vec<T>::pack(f);
    }
    tail = nv * kVec;
  }
  for (int64_t j = tail + threadIdx.x; j < r.V; j += kThreads) {
    const float p = __expf(to_f32(row[j]) - s);
    from_f32(drow + j, (j == lab ? p - 1.f : p) * gn);
  }
}

bool aligned(const void* p, int64_t stride_bytes_a, int64_t stride_bytes_t) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride_bytes_a % 16 == 0 &&
         stride_bytes_t % 16 == 0;
}

bool valid(const Rows& r) {
  return r.A > 0 && r.T > 0 && r.V > 0 && r.A * r.T <= 0x7fffffffLL;
}

}  // namespace

// Rows n = a * T + t of x (a < A, t < T) start at x + a * sa + t * st
// (element strides; the V columns contiguous). labels int32 [A * T]; loss,
// lse f32 [A * T]; all contiguous. dtype: 0 = f32, 1 = bf16. Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int slt_ce_fwd(const void* x, const int* labels, float* loss,
                          float* lse, int dtype, long long A, long long T,
                          long long V, long long sa, long long st,
                          void* stream) {
  Rows r = {A, T, V, sa, st, 0};
  if (!valid(r)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(A * T);
  if (dtype == kBF16) {
    r.vec = aligned(x, sa * 2, st * 2);
    cross_entropy_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), labels, loss, lse, r);
  } else if (dtype == kF32) {
    r.vec = aligned(x, sa * 4, st * 4);
    cross_entropy_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), labels, loss, lse, r);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As slt_ce_fwd for x and labels; lse and g f32 [A * T] contiguous; dx in
// x's dtype, row n at dx + a * da + t * dt.
extern "C" int slt_ce_bwd(const void* x, const int* labels, const float* lse,
                          const float* g, void* dx, int dtype, long long A,
                          long long T, long long V, long long sa,
                          long long st, long long da, long long dt,
                          void* stream) {
  Rows r = {A, T, V, sa, st, 0};
  if (!valid(r)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(A * T);
  if (dtype == kBF16) {
    r.vec = aligned(x, sa * 2, st * 2) && aligned(dx, da * 2, dt * 2);
    cross_entropy_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), labels, lse, g,
        static_cast<__nv_bfloat16*>(dx), r, da, dt);
  } else if (dtype == kF32) {
    r.vec = aligned(x, sa * 4, st * 4) && aligned(dx, da * 4, dt * 4);
    cross_entropy_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), labels, lse, g, static_cast<float*>(dx),
        r, da, dt);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
