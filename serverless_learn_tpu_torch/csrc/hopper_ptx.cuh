// PTX helpers shared by the port's tensor-core kernels (sm_90a): cp.async
// copies, ldmatrix, mma.sync m16n8k16 (bf16 in, f32 sums) and the
// ldmatrix row addresses of the fragments. Included by flash_attention.cu
// and quant_matmul.cu; ops/build.py's hash covers this file, so an edit
// here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes 16 zero bytes.
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[4] += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared-memory addresses of the ldmatrix rows this lane supplies, for a
// tile stored [row][col] with row stride LD (bf16):
//   a_addr: the A fragment of the 16 x 16 block at (r0, c0);
//   b_addr: the B fragments of two n-tiles (rows n0, n0 + 8) x 16 columns
//     at c0, for a B stored [n][k] (plain ldmatrix);
//   bt_addr: the B fragments of two n-tiles (columns n0, n0 + 8) x 16 rows
//     at k0, for a B stored [k][n] (ldmatrix.trans).
template <int LD>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int r0, int c0, int lane) {
  return base + 2 * ((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int n0, int c0, int lane) {
  return base + 2 * ((n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int k0, int n0, int lane) {
  return base + 2 * ((k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8);
}

}  // namespace ptx
