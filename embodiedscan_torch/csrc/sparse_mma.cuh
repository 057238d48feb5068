// Device helpers shared by the sparse-conv kernels (sparse_conv.cu, the
// forward and input-gradient kernel K2, and sparse_conv_wgrad.cu, the
// weight-gradient kernel K3): 16-byte cp.async row gathers, 3xTF32
// products on the tensor cores (mma.sync m16n8k8) and bfloat16 ones
// (mma.sync m16n8k16) for the kernels' bfloat16 variants.
//
// 3xTF32: each float32 operand x is split into x_hi = tf32(x) and
// x_lo = tf32(x - x_hi) (cvt.rna), and a product takes
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, which keeps roughly the float32 result
// (single TF32 moves it by ~1e-3 relative).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, the small terms first, then the large one
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t* bhi,
                                           const uint32_t* blo) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// A bfloat16 operand is kept as its raw 16 bits: the kernels only load,
// stage and convert it (exactly, by a shift into a float32's high half)
using bf16_t = uint16_t;

__device__ __forceinline__ float to_f32(float x) { return x; }

__device__ __forceinline__ float to_f32(bf16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// two bfloat16 values, the first in the low half: one register of an
// mma.sync bf16 fragment
__device__ __forceinline__ uint32_t pack_bf16(bf16_t lo, bf16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a * b, a 16 x 16 (row-major fragment), b 16 x 8 (column-major), in
// bfloat16 with float32 accumulation; the products are exact in float32
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
