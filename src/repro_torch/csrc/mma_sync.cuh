// Tensor-core building blocks shared by the kernels that use mma.sync
// m16n8k16 (bf16 operands, fp32 accumulators): flash_attention.cu (D 16 and
// 32), decode_common.cuh (bf16 decode) and ssd_scan.cu (bf16 x, B and C).
//
// Fragment layouts (PTX ISA, mma.m16n8k16, g = lane / 4, t = lane % 4):
//   A 16x16: {a0,a1} row g, cols 2t..2t+1; {a2,a3} row g+8; {a4,a5} row g,
//            cols 2t+8..; {a6,a7} row g+8, cols 2t+8..
//   B 16x8:  {b0,b1} rows 2t..2t+1, col g; {b2,b3} rows 2t+8..2t+9
//   C 16x8:  {c0,c1} row g, cols 2t..2t+1; {c2,c3} row g+8
// So the fp32 accumulators of two neighbouring 8-column tiles are, packed to
// bf16, the A fragment of the 16 columns they cover.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// Not volatile: the compiler may interleave independent products (each
// accumulator's products stay in order, as its data dependences demand).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two values into one register, the first in the low half (the element of
// the lower index in every mma and wgmma fragment).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ldmatrix x4: lane l gives the address of row l % 8 of 8x8 matrix l / 8
// (16 bytes); register i receives matrix i, without .trans as lane l's row
// l / 4, columns 2(l % 4).., with .trans as its column l / 4, rows 2(l % 4)..
__device__ __forceinline__ void ldsm4(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm4_t(uint32_t* r, const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Fragments from bf16 tiles in shared memory with a row stride of ld
// elements (a multiple of 8; rows 16-byte aligned).  Each takes the lane.
// A (16 x 16 at rows m0, columns k0) of a row-major [m][k] tile:
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* s,
                                       int ld, int m0, int k0, int lane) {
  const int mi = lane / 8, r = lane % 8;
  ldsm4(a, s + (m0 + (mi & 1) * 8 + r) * ld + k0 + (mi >> 1) * 8);
}

// ... of a tile stored transposed, [k][m]:
__device__ __forceinline__ void frag_a_t(uint32_t* a, const __nv_bfloat16* s,
                                         int ld, int m0, int k0, int lane) {
  const int mi = lane / 8, r = lane % 8;
  ldsm4_t(a, s + (k0 + (mi >> 1) * 8 + r) * ld + m0 + (mi & 1) * 8);
}

// B of two 8-column tiles (columns n0.. in b[0..1], n0 + 8.. in b[2..3])
// over k0..k0 + 15, from a tile stored [n][k]:
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* s,
                                       int ld, int n0, int k0, int lane) {
  const int mi = lane / 8, r = lane % 8;
  ldsm4(b, s + (n0 + (mi >> 1) * 8 + r) * ld + k0 + (mi & 1) * 8);
}

// ... from a tile stored [k][n] (ldmatrix .trans):
__device__ __forceinline__ void frag_b_t(uint32_t* b, const __nv_bfloat16* s,
                                         int ld, int n0, int k0, int lane) {
  const int mi = lane / 8, r = lane % 8;
  ldsm4_t(b, s + (k0 + (mi & 1) * 8 + r) * ld + n0 + (mi >> 1) * 8);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !pred
// (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of copies are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
