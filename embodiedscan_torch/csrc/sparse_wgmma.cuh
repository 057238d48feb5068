// Device helpers for the sparse-conv kernels' wgmma routes (sm_90a): the
// fences around wgmma, the shared-memory matrix descriptors of the 128-byte
// swizzle, the bfloat16 wgmma m64nNk16 with its transpose operands, and the
// last-arrival test of the reductions folded into the kernels.
//
// The 128-byte swizzle: a 128-byte line of shared memory keeps its 16-byte
// chunk q at chunk q ^ (line % 8), 8 lines forming a 1024-byte atom (the
// hardware takes the line from address bits 7-9, so a region's atoms start
// at 1024-byte boundaries). Two canonical layouts read it:
// - K-major: a line is 64 bfloat16 values of the reduction (K) of one row
//   of the operand (M or N); rows follow each other line by line.
// - MN-major (a transposed operand, imm-trans 1): a line is 64 bfloat16
//   values along M or N at one k; lines of consecutive k follow each other
//   (8 to an atom, the stride byte offset between atoms), and the next 64
//   values along M or N start a leading byte offset further.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_mma.cuh"

namespace {

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of a wgmma result above the wait
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// descriptor of a K-major operand in shared memory with the 128-byte
// swizzle: 128-byte lines, 8 to a 1024-byte atom
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // LBO (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // SBO: next 8 rows
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

// descriptor of an MN-major operand with the 128-byte swizzle: lines of 64
// values along M or N, one k a line; the next 8 k an atom (1024 bytes)
// further (SBO), the next 64 values along M or N `lbo` bytes further
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, int lbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define WGB_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N over a warpgroup, N / 2 floats a thread) = a * b (+ d when
// scale_d) over bfloat16 operands in shared memory: a 64 x 16, b 16 x N;
// TA / TB: 0 for a K-major operand, 1 for an MN-major one
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b,
                                           int scale_d);

template <int TA, int TB>
struct WgmmaBf16 {
  __device__ __forceinline__ static void n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : WGB_D8(0), WGB_D8(8), WGB_D8(16), WGB_D8(24)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  __device__ __forceinline__ static void n128(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : WGB_D8(0), WGB_D8(8), WGB_D8(16), WGB_D8(24), WGB_D8(32),
          WGB_D8(40), WGB_D8(48), WGB_D8(56)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
  __device__ __forceinline__ static void n256(float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %132;\n}\n"
        : WGB_D8(0), WGB_D8(8), WGB_D8(16), WGB_D8(24), WGB_D8(32),
          WGB_D8(40), WGB_D8(48), WGB_D8(56), WGB_D8(64), WGB_D8(72),
          WGB_D8(80), WGB_D8(88), WGB_D8(96), WGB_D8(104), WGB_D8(112),
          WGB_D8(120)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

#undef WGB_D8

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b,
                                           int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256,
                "wgmma_bf16: N is 64, 128 or 256");
  if constexpr (N == 64)
    WgmmaBf16<TA, TB>::n64(d, a, b, scale_d);
  else if constexpr (N == 128)
    WgmmaBf16<TA, TB>::n128(d, a, b, scale_d);
  else
    WgmmaBf16<TA, TB>::n256(d, a, b, scale_d);
}

// A reduction folded into a kernel: every block of a group writes its
// partial sums, then calls this; it returns true in the one block that
// arrives last of the `expected` blocks counted at *counter. The partials
// of the others are then visible to it (each block fences its writes
// before it arrives; the last one reads them through L2, __ldcg).
__device__ __forceinline__ bool last_arrival(int* counter, int expected) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  const bool last = s_last != 0;
  if (last) __threadfence();
  return last;
}

// dst[r * ld + c] = sum over the parts z < parts whose bit is set in
// `which`, in the order of z, of src[z * stride + r * ld + c] (+ bias[c])
// for r < rows, c < cols (cols a multiple of 4, ld and the bases 16-byte
// aligned; no part: 0 + bias): 4 floats a thread
__device__ __forceinline__ void reduce_parts4(float* dst, const float* src,
                                              int parts, unsigned which,
                                              int64_t stride, int rows,
                                              int cols, int64_t ld,
                                              const float* bias) {
  const int quads = cols / 4;
  for (int e = threadIdx.x; e < rows * quads; e += blockDim.x) {
    const int r = e / quads, c = (e - r * quads) * 4;
    const int64_t at = r * ld + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    bool first = true;
    for (int z = 0; z < parts; ++z) {
      if (!((which >> z) & 1u)) continue;
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(src + z * stride + at));
      if (first) {
        s = v;
        first = false;
      } else {
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
    }
    if (bias != nullptr) {
      s.x += bias[c]; s.y += bias[c + 1];
      s.z += bias[c + 2]; s.w += bias[c + 3];
    }
    *reinterpret_cast<float4*>(dst + at) = s;
  }
}

}  // namespace
