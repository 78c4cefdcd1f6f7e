// Weight-only int8 matmul for Hopper (sm_90a):
//
//     out[R, O] = (bf16(x)[R, I] @ float(wq)[I, O]) * scale[O]
//
// Replaces the TPU kernel `_kernel` / `quant_matmul` in
// serverless_learn_tpu/ops/pallas/quant_matmul.py (call at :119) and
// computes the same function: activations rounded to bf16, int8 weights
// converted exactly to bf16, products summed in f32, the per-column f32
// scale applied once at the end, the result cast to x's type. The weights
// keep the layout the bridge and `inference/quantize` give them: int8 [I,
// O], O contiguous; they are never repacked (a second copy would not fit
// Mixtral).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode (R <= 16 rows): the int8 weight bytes. Llama-3-8B reads ~7.5
//     GB of projections a forward, so a decode forward cannot take less
//     than ~2.2 ms.
//   * prefill and training (R in the hundreds or thousands): the 2 R I O
//     operations at the tensor-core rate (~7.8 ms a llama_8b forward at R
//     = 512, ~62 ms at QLoRA's 4,096).
// Four tilings, which ops/quant_matmul.py's plan() picks by shape:
//   * decode (quant_decode; mma.sync m16n8k16): out^T = wq^T x^T, so the
//     16 rows of an m16 tile are output columns and x's rows fill one n8
//     tile (two up to 16 rows). A block owns 128 columns; its 4 warps each
//     take one 16-row step of every 64-row stage of a 4-stage cp.async
//     ring, and the weights go from shared memory straight into A
//     fragments: the order of the contraction inside an m16n8k16 is free,
//     so a thread's k slots are 4 consecutive weight rows (and the B
//     fragment 4 consecutive values of x) and its 16 columns one 16-byte
//     read; a byte permute pairs two rows' bytes and the int8 -> bf16 rule
//     below converts them. The warps' sums are added in shared memory in
//     warp order. The contraction is split across blocks (k_split rows
//     each) so that even the 8 column tiles of a k/v projection fill the
//     card.
//   * prefill (quant_prefill; wgmma fed by TMA, every aligned shape above
//     16 rows): out^T = wq^T x^T, so the weight is the A operand, in
//     registers, and x the B operand, K-major in shared memory. A block
//     owns 128 rows of x and 256 output columns and has three
//     warpgroups. The producer's one loading thread keeps a 6-stage ring
//     fed by TMA: each 64-row stage is x's 128 x 64 tile (bf16) and the
//     weight's 64 x 256 int8 tile as two 128-column boxes, all with the
//     128-byte swizzle. Each consumer warpgroup owns 128 weight columns as
//     two m64 tiles: for every k-slice of 16 a thread reads four 4-byte
//     words of int8 (its 4 neighbouring columns at rows 2t, 2t + 1, 2t +
//     8, 2t + 9: the M order of wgmma's rows is free, so a thread's rows
//     are neighbouring columns), pairs bytes across rows and converts them
//     with the rule below into the A registers of both m-tiles, then
//     issues wgmma.m64n128k16 twice; the next k-slice converts while those
//     run (two register sets). The f32 sums stay in registers across the
//     contraction. The int8 tile crosses shared memory once and the bf16
//     weights never do. Blocks walk the tiles in groups of 8 row tiles,
//     column by column, so that the blocks on the card at once share
//     their x and weight tiles in L2. Converting in registers keeps the
//     bf16 weights out of shared memory: a bf16 B tile written there by
//     converting warps and read by wgmma cost ~160 KB of shared-memory
//     traffic a stage, more than the products' time.
//   * prefill_mma (quant_prefill_mma; mma.sync): the shapes TMA cannot
//     describe (a weight row not a multiple of 16 bytes, a bf16 x row not a
//     multiple of 16 bytes) and nothing on a full-width path: 8 warps on a
//     128 x 128 tile; each 64-row int8 stage of a 3-stage cp.async ring is
//     converted once into a bf16 tile in shared memory, which every warp
//     reads by ldmatrix.trans.
// Where the tiles alone leave SMs idle, the contraction is split across
// blocks too; split partials go to an f32 workspace [splits, R, O] that the
// wrapper allocates once a stream, and quant_reduce adds them in split
// order, applies the scale and casts. No atomics anywhere: a run repeats
// bit for bit.
//
// int8 -> bf16: bf16 holds 8 significant bits, so no single magic number
// turns all 256 byte values into bf16 by one subtract. Two do: for a
// signed byte s in the low byte of a 16-bit half, (0x4300 | s & 0x7f) is
// 128 + (s & 0x7f) and (0x4300 | s & 0x80) is 128 or 256, and one bf16x2
// subtract of the two gives s exactly. Two LOP3s and a subtract convert
// two values; no I2F per element.
//
// Ragged R, I and O are masked: rows past R or I and columns past O read
// as 0 (TMA's out-of-bounds fill, whole boxes included; cp.async with
// src-size 0). The prefill
// tiling takes a bf16 x (the wrapper rounds an f32 x to bf16 first, the
// reference's own first step) and writes x's type; prefill_mma and decode
// take an f32 x as it is, and copy a weight matrix whose rows are not
// 16-byte aligned, an f32 x and a bf16 x with I % 8 != 0 to shared memory
// element by element.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"

namespace {

using namespace ptx;  // hopper_ptx.cuh: cp.async, ldmatrix, mma; mbarrier, TMA, wgmma
using bf16 = __nv_bfloat16;

enum DType : int { kF32 = 0, kBF16 = 1 };

// The tile geometry that ops/quant_matmul.py's plan() counts blocks with
// (TILE_COLS, STEP_ROWS, PREFILL_TILE_ROWS, DECODE_MAX_ROWS,
// PREFILL_TILE_COLS; checked on loading through
// slt_quant_matmul_geometry); plan() picks the tiling.
constexpr int kCols = 128;            // output columns a block: decode, prefill_mma
constexpr int kStep = 64;             // contraction rows a stage, every tiling
constexpr int kPreRows = 128;         // x rows a block, both prefill tilings
constexpr int kDecodeMaxRows = 16;    // two n8 tiles of x's rows
constexpr int kWgCols = 256;          // output columns a block: prefill (wgmma)
enum Tiling : int { kDecodeN8 = 0, kDecodeN16 = 1, kPrefill = 2, kPrefillMma = 3 };

struct Params {
  const void* x;
  const int8_t* wq;
  const float* scale;
  void* out;
  float* ws;       // [splits, R, O] partial sums, or null when splits == 1
  int R, I, O;      // below 2^31 each (checked at the entry point)
  int k_split;      // contraction rows per split
  bool vec;         // wq rows 16-byte aligned: cp.async copies
  bool xvec;        // bf16 x with 16-byte aligned rows: cp.async copies
};

// The signed bytes in the low bytes of t's two 16-bit halves as bf16x2,
// exactly (the rule in the header).
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t t) {
  uint32_t v, o;  // (t & mask) | 0x43004300, one LOP3 each (0xEA: a & b | c)
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(v) : "r"(t), "r"(0x007f007fu), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(o) : "r"(t), "r"(0x00800080u), "r"(0x43004300u));
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&o));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Byte b of lo and byte b of hi in the low bytes of the two halves.
__device__ __forceinline__ uint32_t pair_bytes(uint32_t lo, uint32_t hi, int b) {
  return __byte_perm(lo, hi, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12));
}

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
// Four neighbouring columns (the first a multiple of 4, so 16 or 8 bytes
// aligned).
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack(a, b), pack(c, d));
}

// Decode tiles swizzle a row's eight 16-byte chunks so that the reads of a
// quarter-warp (4 rows 4 apart, 2 chunks each) hit 8 different bank groups.
__device__ __forceinline__ int swz(int r) { return 2 * ((r >> 2) & 3); }

// Weight rows [k0, k0 + ROWS) x columns [c0, c0 + kCols) into dst
// [ROWS][kCols] int8; rows at or past kend and columns past O read as 0.
template <int ROWS, bool SWZ>
__device__ __forceinline__ void load_w(uint8_t* dst, const Params& p, int k0, int kend, int c0,
                                       int tid, int nthreads) {
  if (p.vec) {
    for (int ch = tid; ch < ROWS * (kCols / 16); ch += nthreads) {
      const int r = ch / (kCols / 16), c = ch % (kCols / 16);
      const int k = k0 + r, col = c0 + 16 * c;
      const bool ok = k < kend && col < p.O;
      cp16(dst + r * kCols + 16 * (SWZ ? c ^ swz(r) : c),
           ok ? p.wq + static_cast<int64_t>(k) * p.O + col : p.wq, ok ? 16 : 0);
    }
  } else {  // one byte at a time, not unrolled: it is the rare path
#pragma unroll 1
    for (int idx = tid; idx < ROWS * kCols; idx += nthreads) {
      const int r = idx / kCols, col = idx % kCols, c = col / 16;
      const int k = k0 + r, gc = c0 + col;
      dst[r * kCols + 16 * (SWZ ? c ^ swz(r) : c) + col % 16] =
          k < kend && gc < p.O ? static_cast<uint8_t>(p.wq[static_cast<int64_t>(k) * p.O + gc])
                               : 0;
    }
  }
}

// x rows [r0, r0 + ROWS) x contraction [k0, k0 + KC) into dst [ROWS][LD]
// bf16 (rounded from f32 here); rows past R and k at or past kend read 0.
template <typename T, int ROWS, int KC, int LD>
__device__ __forceinline__ void load_x(bf16* dst, const Params& p, int r0, int k0, int kend,
                                       int tid, int nthreads) {
  const T* x = static_cast<const T*>(p.x);
  if (std::is_same_v<T, bf16> && p.xvec) {
    for (int ch = tid; ch < ROWS * (KC / 8); ch += nthreads) {
      const int r = ch / (KC / 8), c = ch % (KC / 8);
      const int gr = r0 + r, k = k0 + 8 * c;
      const bool ok = gr < p.R && k < kend;
      cp16(dst + r * LD + 8 * c, ok ? x + static_cast<int64_t>(gr) * p.I + k : x, ok ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int idx = tid; idx < ROWS * KC; idx += nthreads) {
      const int r = idx / KC, c = idx % KC;
      const int gr = r0 + r, k = k0 + c;
      dst[r * LD + c] =
          gr < p.R && k < kend ? to_bf16(x[static_cast<int64_t>(gr) * p.I + k]) : to_bf16(0.f);
    }
  }
}

// ------------------------------------------------------------- decode ----

constexpr int kDecThreads = 128;      // 4 warps, 16 rows of each stage apiece
constexpr int kDecStages = 4;
constexpr int kDecXLd = kStep + 16;   // bf16; 160-byte rows: conflict-free 8-byte reads

template <int NT>
struct Dec {
  static constexpr int kWBytes = kStep * kCols;
  static constexpr int kXBytes = 8 * NT * kDecXLd * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmem = kDecStages * kStageBytes;
  static_assert(kSmem >= 4 * 8 * NT * kCols * 4, "the warps' sums fit the ring");
};

// NT n-tiles of 8 rows: R <= 8 NT. Grid (column tiles, splits).
template <typename T, int NT>
__global__ void __launch_bounds__(kDecThreads) quant_decode(Params p) {
  using L = Dec<NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int kbeg = split * p.k_split;
  const int kend = kbeg + p.k_split < p.I ? kbeg + p.k_split : p.I;
  const int n_st = (kend - kbeg + kStep - 1) / kStep;

  auto issue = [&](int it) {
    unsigned char* st = smem + (it % kDecStages) * L::kStageBytes;
    const int k0 = kbeg + it * kStep;
    load_w<kStep, true>(st, p, k0, kend, c0, tid, kDecThreads);
    load_x<T, 8 * NT, kStep, kDecXLd>(reinterpret_cast<bf16*>(st + L::kWBytes), p, 0, k0,
                                          kend, tid, kDecThreads);
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < n_st) issue(s);
    cp_commit();
  }

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][m][e] = 0.f;

  for (int it = 0; it < n_st; ++it) {
    cp_wait<kDecStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1
    if (it + kDecStages - 1 < n_st) issue(it + kDecStages - 1);
    cp_commit();
    const unsigned char* st = smem + (it % kDecStages) * L::kStageBytes;
    const bf16* xs = reinterpret_cast<const bf16*>(st + L::kWBytes);
    // This thread's k slots 2t, 2t + 1, 2t + 8, 2t + 9 are the weight rows
    // 16 warp + 4t + (0, 1, 2, 3), its m rows g and g + 8 of m-tile m the
    // columns 16 g + 2 m and 16 g + 2 m + 1.
    uint32_t w[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          st + (16 * warp + 4 * t + e) * kCols + 16 * (g ^ (2 * t)));
      w[e][0] = v.x; w[e][1] = v.y; w[e][2] = v.z; w[e][3] = v.w;
    }
    uint2 xb[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      xb[nt] = *reinterpret_cast<const uint2*>(xs + (8 * nt + g) * kDecXLd + 16 * warp + 4 * t);
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int j = m >> 1, b = 2 * (m & 1);
      uint32_t a[4];
      a[0] = i8x2_to_bf16x2(pair_bytes(w[0][j], w[1][j], b));
      a[1] = i8x2_to_bf16x2(pair_bytes(w[0][j], w[1][j], b + 1));
      a[2] = i8x2_to_bf16x2(pair_bytes(w[2][j], w[3][j], b));
      a[3] = i8x2_to_bf16x2(pair_bytes(w[2][j], w[3][j], b + 1));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[nt][m], a, xb[nt].x, xb[nt].y);
    }
  }
  cp_wait<0>();
  __syncthreads();
  // The warps' sums [warp][row][column] in the ring's memory, then added
  // in warp order: thread (g, t) holds rows 8 nt + 2t + hf, columns 16 g ..
  // 16 g + 15 (m rows g: c[hf], g + 8: c[2 + hf]).
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float4* dst = reinterpret_cast<float4*>(
          red + (warp * 8 * NT + 8 * nt + 2 * t + hf) * kCols + 16 * g);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_float4(acc[nt][2 * q][hf], acc[nt][2 * q][2 + hf],
                             acc[nt][2 * q + 1][hf], acc[nt][2 * q + 1][2 + hf]);
    }
  __syncthreads();
  const int col = c0 + tid;  // 128 threads, 128 columns
  if (col >= p.O) return;
  const int rows = p.R < 8 * NT ? p.R : 8 * NT;
  for (int n = 0; n < rows; ++n) {
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) s += red[(wp * 8 * NT + n) * kCols + tid];
    if (p.ws != nullptr) {
      p.ws[(static_cast<int64_t>(split) * p.R + n) * p.O + col] = s;
    } else {
      store(static_cast<T*>(p.out) + static_cast<int64_t>(n) * p.O + col, s * p.scale[col]);
    }
  }
}

// -------------------------------------------------------- prefill_mma ----

constexpr int kPreThreads = 256;      // 8 warps: 2 along rows x 4 along columns
constexpr int kPreStages = 3;
constexpr int kPreXLd = kStep + 8;    // bf16, padded rows for ldmatrix
constexpr int kPreWLd = kCols + 8;     // bf16, the converted weight tile

struct Pre {
  static constexpr int kXBytes = kPreRows * kPreXLd * 2;
  static constexpr int kWqBytes = kStep * kCols;
  static constexpr int kStageBytes = kXBytes + kWqBytes;
  static constexpr int kWbBytes = kStep * kPreWLd * 2;
  static constexpr int kSmem = kPreStages * kStageBytes + kWbBytes;
};

// The shapes TMA cannot describe. Grid (column tiles, row tiles, splits).
template <typename T>
__global__ void __launch_bounds__(kPreThreads, 2) quant_prefill_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sWb = reinterpret_cast<bf16*>(smem + kPreStages * Pre::kStageBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // rows 64 wm.., columns 32 wn..
  const int c0 = blockIdx.x * kCols, r0 = blockIdx.y * kPreRows;
  const int split = blockIdx.z;
  const int kbeg = split * p.k_split;
  const int kend = kbeg + p.k_split < p.I ? kbeg + p.k_split : p.I;
  const int n_st = (kend - kbeg + kStep - 1) / kStep;

  auto issue = [&](int it) {
    unsigned char* st = smem + (it % kPreStages) * Pre::kStageBytes;
    const int k0 = kbeg + it * kStep;
    load_x<T, kPreRows, kStep, kPreXLd>(reinterpret_cast<bf16*>(st), p, r0, k0, kend, tid,
                                           kPreThreads);
    load_w<kStep, false>(st + Pre::kXBytes, p, k0, kend, c0, tid, kPreThreads);
  };
#pragma unroll
  for (int s = 0; s < kPreStages - 1; ++s) {
    if (s < n_st) issue(s);
    cp_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const uint32_t uWb = smem_u32(sWb);

  for (int it = 0; it < n_st; ++it) {
    cp_wait<kPreStages - 2>();
    __syncthreads();  // stage it landed; every warp is done with stage it - 1 and sWb
    if (it + kPreStages - 1 < n_st) issue(it + kPreStages - 1);
    cp_commit();
    const unsigned char* st = smem + (it % kPreStages) * Pre::kStageBytes;
    // The int8 stage -> bf16, once for the block: 16 columns of a row at a
    // time.
#pragma unroll 1
    for (int ch = tid; ch < kStep * (kCols / 16); ch += kPreThreads) {
      const int r = ch >> 3, c = ch & 7;
      const uint4 v = *reinterpret_cast<const uint4*>(st + Pre::kXBytes + r * kCols + 16 * c);
      const uint32_t wv[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[2 * j] = i8x2_to_bf16x2(__byte_perm(wv[j], 0u, 0x1100));
        o[2 * j + 1] = i8x2_to_bf16x2(__byte_perm(wv[j], 0u, 0x3322));
      }
      uint4* dst = reinterpret_cast<uint4*>(sWb + r * kPreWLd + 16 * c);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
    __syncthreads();
    const uint32_t uX = smem_u32(st);
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      uint32_t b[2][4];  // the warp's 4 n-tiles of this k16 step
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_t(b[np], bt_addr<kPreWLd>(uWb, 16 * kk, 32 * wn + 16 * np, lane));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm(a, a_addr<kPreXLd>(uX, 64 * wm + 16 * mt, 16 * kk, lane));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], a, b[nt >> 1][2 * (nt & 1)],
                                           b[nt >> 1][2 * (nt & 1) + 1]);
      }
    }
  }
  cp_wait<0>();
  const int cw = c0 + 32 * wn + 2 * t;  // this thread's first column
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 64 * wm + 16 * mt + g + 8 * hf;
      if (row >= p.R) continue;
      float* wrow = p.ws + (static_cast<int64_t>(split) * p.R + row) * p.O;
      T* orow = static_cast<T*>(p.out) + static_cast<int64_t>(row) * p.O;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = cw + 8 * nt + e;
          if (col >= p.O) continue;
          const float v = acc[mt][nt][2 * hf + e];
          if (p.ws != nullptr) {
            wrow[col] = v;
          } else {
            store(orow + col, v * p.scale[col]);
          }
        }
    }
}

// ------------------------------------------------- prefill on wgmma ----

namespace pf {

constexpr int kThreads = 384;       // a producer and two consumer warpgroups
constexpr int kStages = 6;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kGroupRows = 8;       // row tiles of a raster group
constexpr int kBoxCols = 128;       // weight columns a TMA box and a consumer

struct Smem {  // byte offsets from the 1024-aligned base; a stage is (x, int8)
  static constexpr int kXBytes = kPreRows * kStep * 2;      // 128 rows x 64 k, 128 B rows
  static constexpr int kBoxBytes = kStep * kBoxCols;        // 64 k-rows x 128 int8 columns
  static constexpr int kStageBytes = kXBytes + 2 * kBoxBytes;
  static constexpr int kBars = kStages * kStageBytes;       // full, empty
  static constexpr int kBytes = kBars + 16 * kStages + 1024;
};
static_assert(Smem::kBytes <= 232448, "one block fits an SM's shared memory");
static_assert(2 * kBoxCols == kWgCols, "two consumers cover a tile's columns");

struct Maps {
  CUtensorMap x, w;  // x bf16 [R, I], boxes 64 k x 128 rows; wq int8 [I, O], 128 x 64
};

// The block's output tile: tiles run in groups of kGroupRows row tiles,
// column tile by column tile, so the blocks resident at once share a few
// x row tiles and weight column tiles (L2 reuse both ways).
__device__ __forceinline__ void tile_of(int tile, int n_rt, int n_ct, int& rt, int& ct) {
  const int per_group = kGroupRows * n_ct, first = tile / per_group * kGroupRows;
  const int rows = min(kGroupRows, n_rt - first), in_group = tile % per_group;
  rt = first + in_group % rows;
  ct = in_group / rows;
}

// The consumer's A operands of k-slice kk (rows 16 kk .. 16 kk + 15 of the
// stage's int8 box, 128-byte swizzled as TMA lays it: row k's 16-byte chunk
// j at chunk j ^ (k % 8)): out^T = wq^T x^T, so the weight's columns are
// the product's rows, and a thread's rows 16 warp + g (+ 8) of m-tile j are
// its columns 4 g + 2 j (+ 1) of the warp's 32, four neighbouring bytes of
// a weight row. Four 4-byte reads (k = 2 t, 2 t + 1, 2 t + 8, 2 t + 9),
// byte pairs across two rows, the exact int8 -> bf16 rule: a[j][0..3].
__device__ __forceinline__ void load_a(uint32_t (*a)[4], const unsigned char* box, int kk,
                                       int warp, int g, int t) {
  const int col = 32 * warp + 4 * g;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 16 * kk + 2 * t + (i & 1) + 8 * (i >> 1);
    w[i] = *reinterpret_cast<const uint32_t*>(box + k * kBoxCols +
                                              16 * ((col / 16) ^ (k % 8)) + col % 16);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    a[j][0] = i8x2_to_bf16x2(pair_bytes(w[0], w[1], 2 * j));
    a[j][1] = i8x2_to_bf16x2(pair_bytes(w[0], w[1], 2 * j + 1));
    a[j][2] = i8x2_to_bf16x2(pair_bytes(w[2], w[3], 2 * j));
    a[j][3] = i8x2_to_bf16x2(pair_bytes(w[2], w[3], 2 * j + 1));
  }
}

// Grid (output tiles, splits). T: out's type; x is bf16.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    quant_prefill(const __grid_constant__ Maps m, const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const unsigned char* sb = smem + (base - smem_u32(smem));
  const uint32_t full = base + Smem::kBars, empty = full + 8 * kStages;
  int rt, ct;
  tile_of(blockIdx.x, (p.R + kPreRows - 1) / kPreRows, (p.O + kWgCols - 1) / kWgCols, rt, ct);
  const int r0 = rt * kPreRows, c0 = ct * kWgCols;
  const int split = blockIdx.y;
  const int kbeg = split * p.k_split;
  const int kend = kbeg + p.k_split < p.I ? kbeg + p.k_split : p.I;
  const int n_st = (kend - kbeg + kStep - 1) / kStep;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup; one thread loads
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&m.x);
      prefetch_map(&m.w);
      for (int it = 0; it < n_st; ++it) {
        const int st = it % kStages;
        mbar_wait(empty + 8 * st, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * st, sx = base + st * Smem::kStageBytes;
        const int k0 = kbeg + it * kStep;
        mbar_expect_tx(bar, Smem::kStageBytes);
        tma_load_2d(sx, &m.x, bar, k0, r0);
        tma_load_2d(sx + Smem::kXBytes, &m.w, bar, c0, k0);
        tma_load_2d(sx + Smem::kXBytes + Smem::kBoxBytes, &m.w, bar, c0 + kBoxCols, k0);
      }
    }
  } else {  // a consumer: the tile's 128 rows against its 128 columns
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    float acc[2][kPreRows / 8][4];  // [m-tile][x rows / 8][4]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int n = 0; n < kPreRows / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.f;
    uint32_t a[2][2][4];  // two k-slices' A operands: one converts while the other multiplies
    for (int it = 0; it < n_st; ++it) {
      const int st = it % kStages;
      mbar_wait(full + 8 * st, (it / kStages) & 1);
      const uint32_t sx = base + st * Smem::kStageBytes;
      const unsigned char* box = sb + st * Smem::kStageBytes + Smem::kXBytes + cw * Smem::kBoxBytes;
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        uint32_t (*ak)[4] = a[kk & 1];
        load_a(ak, box, kk, warp, g, t);
        wgmma_fence();
        const uint64_t bx = gmma_desc(sx + 32 * kk, 16, 1024, 1);  // x's 128 rows, K-major
        wgmma_rs_k<kPreRows>(&acc[0][0][0], ak[0], bx);
        wgmma_rs_k<kPreRows>(&acc[1][0][0], ak[1], bx);
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-slice's products are done: its A is free
        fence_regs<8>(&a[(kk + 1) & 1][0][0]);
        if (kk == 0 && it > 0) {  // so are the previous stage's: free it
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
        }
      }
    }
    wgmma_wait<0>();
    fence_regs<kPreRows / 2>(&acc[0][0][0]);
    fence_regs<kPreRows / 2>(&acc[1][0][0]);
    fence_regs<16>(&a[0][0][0]);
    // Thread (warp, g, t) holds x rows 8 n + 2 t (+ 1) and output columns
    // 32 warp + 4 g .. + 3 of its consumer's 128: acc[j][n][2 h + e] is
    // row 8 n + 2 t + e, column 4 g + 2 j + h.
    const int col = c0 + kBoxCols * cw + 32 * warp + 4 * g;  // O % 16 == 0: all 4 or none
    if (col < p.O) {
      const float4 sc = p.ws != nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                        : *reinterpret_cast<const float4*>(p.scale + col);
#pragma unroll
      for (int n = 0; n < kPreRows / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r0 + 8 * n + 2 * t + e;
          if (row >= p.R) continue;
          const float v0 = acc[0][n][e], v1 = acc[0][n][2 + e];
          const float v2 = acc[1][n][e], v3 = acc[1][n][2 + e];
          if (p.ws != nullptr) {
            *reinterpret_cast<float4*>(p.ws + (static_cast<int64_t>(split) * p.R + row) * p.O +
                                       col) = make_float4(v0, v1, v2, v3);
          } else {
            store4(static_cast<T*>(p.out) + static_cast<int64_t>(row) * p.O + col,
                   v0 * sc.x, v1 * sc.y, v2 * sc.z, v3 * sc.w);
          }
        }
    }
  }
}

}  // namespace pf

// ------------------------------------------------------------- reduce ----

// out = (sum of the splits' partials, in split order) * scale, cast.
template <typename T>
__global__ void __launch_bounds__(256) quant_reduce(const float* __restrict__ ws,
                                                    const float* __restrict__ scale,
                                                    T* __restrict__ out, int64_t R, int64_t O,
                                                    int splits) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= R * O) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += ws[sp * R * O + e];
  store(out + e, s * scale[e % O]);
}

// ------------------------------------------------------------- launch ----

// The prefill tiling: the tensor maps, then the launch. TMA needs 16-byte
// aligned bases and row strides (plan() sends it only I % 8 == 0 and O %
// 16 == 0): a misaligned base is refused with cudaErrorMisalignedAddress.
template <typename T>
int launch_prefill(const Params& p, int64_t splits, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(p.x) % 16 != 0 || reinterpret_cast<uintptr_t>(p.wq) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // A runtime call before the driver's encoder: it makes the device's
  // primary context current in a thread that has not used CUDA yet, where
  // cuTensorMapEncodeTiled would fail.
  const cudaError_t err = cudaFuncSetAttribute(
      pf::quant_prefill<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, pf::Smem::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  pf::Maps m;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(p.I), static_cast<cuuint64_t>(p.R)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(p.I) * 2};
  const cuuint32_t xbox[2] = {kStep, kPreRows};
  CUresult r = fn(&m.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p.x), xdims,
                  xstride, xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(p.O), static_cast<cuuint64_t>(p.I)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(p.O)};
  const cuuint32_t wbox[2] = {pf::kBoxCols, kStep};
  if (r == CUDA_SUCCESS)
    r = fn(&m.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p.wq), wdims, wstride,
           wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((p.R + kPreRows - 1) / kPreRows) *
                        ((p.O + kWgCols - 1) / kWgCols);
  pf::quant_prefill<T><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(splits)),
                         pf::kThreads, pf::Smem::kBytes, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int tiling, int64_t splits, cudaStream_t stream) {
  const unsigned col_tiles = static_cast<unsigned>((p.O + kCols - 1) / kCols);
  int rc = 0;
  if (tiling == kDecodeN8) {
    quant_decode<T, 1><<<dim3(col_tiles, static_cast<unsigned>(splits)), kDecThreads, Dec<1>::kSmem, stream>>>(p);
  } else if (tiling == kDecodeN16) {
    quant_decode<T, 2><<<dim3(col_tiles, static_cast<unsigned>(splits)), kDecThreads, Dec<2>::kSmem, stream>>>(p);
  } else if (tiling == kPrefill) {
    rc = launch_prefill<T>(p, splits, stream);
  } else {
    // Above 48 KB only by opting in, for the current device: set on every
    // launch, as a per-process flag would miss a second card.
    const cudaError_t err = cudaFuncSetAttribute(
        quant_prefill_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Pre::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(col_tiles, static_cast<unsigned>((p.R + kPreRows - 1) / kPreRows),
                    static_cast<unsigned>(splits));
    quant_prefill_mma<T><<<grid, kPreThreads, Pre::kSmem, stream>>>(p);
  }
  cudaError_t err = rc != 0 ? static_cast<cudaError_t>(rc) : cudaGetLastError();
  if (err != cudaSuccess || p.ws == nullptr) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(p.R) * p.O;
  quant_reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      p.ws, p.scale, static_cast<T*>(p.out), p.R, p.O, static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile geometry plan() counts blocks with, for the wrapper to check
// its copy against on loading: output columns a decode or prefill_mma
// block, contraction rows a stage, x rows a prefill block, most rows of the
// decode tilings, output columns a prefill (wgmma) block.
extern "C" void slt_quant_matmul_geometry(int* out) {
  out[0] = kCols;
  out[1] = kStep;
  out[2] = kPreRows;
  out[3] = kDecodeMaxRows;
  out[4] = kWgCols;
}

// out [R, O] of `dtype` (code 0 = f32, 1 = bf16), x [R, I] of that dtype
// too except under the prefill tiling, which takes a bf16 x whatever out's
// dtype; wq int8 [I, O], scale f32 [O]; all row-major, contiguous and on
// card `device`. `tiling` (0: decode, one n8 tile, R <= 8; 1: decode, two,
// R <= 16; 2: prefill on wgmma, I % 8 == 0 and O % 16 == 0, x and wq
// 16-byte aligned; 3: prefill_mma) and `k_split` come from
// ops/quant_matmul.py's plan(): the contraction is split into ceil(I /
// k_split) parts of k_split rows (a multiple of the 64-row stage of every
// tiling); with more than one, ws holds at least [splits, R, O] f32 and
// may not be null, else it must be null. Launches on `stream` without
// synchronising, with `device` current for the call, and returns
// cudaGetLastError().
extern "C" int slt_quant_matmul(const void* x, const void* wq, const void* scale, void* out,
                                float* ws, int dtype, int tiling, long long R, long long I,
                                long long O, long long k_split, int device, void* stream) {
  constexpr long long kMax = 0x7fffffff;
  if (R <= 0 || I <= 0 || O <= 0 || R > kMax || I > kMax || O > kMax || k_split <= 0 ||
      k_split > kMax || k_split % kStep != 0 || (dtype != kF32 && dtype != kBF16) ||
      (tiling == kDecodeN8 && R > 8) || (tiling == kDecodeN16 && R > kDecodeMaxRows) ||
      (tiling == kPrefill && (I % 8 != 0 || O % 16 != 0)) ||
      (tiling != kDecodeN8 && tiling != kDecodeN16 && tiling != kPrefill &&
       tiling != kPrefillMma)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long splits = (I + k_split - 1) / k_split;
  if (splits > 65535 || (R + kPreRows - 1) / kPreRows > 65535 || (splits > 1) != (ws != nullptr) ||
      (tiling == kPrefill && (R + kPreRows - 1) / kPreRows * ((O + kWgCols - 1) / kWgCols) > kMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.x = x;
  p.wq = static_cast<const int8_t*>(wq);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.ws = ws;
  p.R = static_cast<int>(R);
  p.I = static_cast<int>(I);
  p.O = static_cast<int>(O);
  p.k_split = static_cast<int>(k_split);
  p.vec = O % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  p.xvec = dtype == kBF16 && I % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = dtype == kBF16 ? launch<bf16>(p, tiling, splits, s)
                                : launch<float>(p, tiling, splits, s);
  if (current != device) cudaSetDevice(current);
  return rc;
}
