// Sparse gather-GEMM convolution, forward (Hopper, sm_90a).
//
//   out[m, :] = sum_k feats_safe[nbr[m, k], :] @ W[k] (+ bias)
//
// feats_safe is feats with the rows whose mask is false read as zero; an
// index of -1 (or outside [0, n)) contributes nothing. Inputs, accumulation
// and output are float32.
//
// Replaces the Pallas TPU kernel embodiedscan_tpu/experimental/pallas_conv.py
// (banded_conv_pallas / _kernel), whose contract is the engine's conv core
// embodiedscan_tpu/ops/sparse.py:gather_matmul_conv. The TPU kernel copies a
// contiguous band of rows into VMEM and gathers with a one-hot matmul,
// because the TPU cannot gather rows cheaply. A GPU loads the rows
// directly, so neither the band nor its fallback is carried over.
//
// Bound on this card: at the main path's shapes (Cin, Cout of 64-512) the
// FP32 operations (2 * M * K * Cin * Cout against 67 TFLOP/s without tensor
// cores) outweigh the gathered bytes (M * K * Cin * 4 B against 3.35 TB/s);
// at the stem (Cin = 3) the index and output bytes dominate.
//
// Design: one block of 256 threads computes a 64-row x 64-column output
// tile. It loops over the K offsets and, within each, over Cin in chunks of
// 16: the tile's 64 gathered input rows (zero where absent, masked or past
// Cin) and the matching 16 x 64 slice of W[k] are staged in shared memory,
// and each thread accumulates a 4 x 4 register micro-tile with FP32 FMAs.
// An offset at which none of the tile's 64 rows has a neighbor is skipped.
// No tensor cores: TF32 would change the numbers against the f32 reference.
// Making this fast (bf16/TF32 wgmma, cp.async pipelining) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define SC_BM 64
#define SC_BN 64
#define SC_BK 16
#define SC_THREADS 256

namespace {

__global__ void __launch_bounds__(SC_THREADS)
sparse_conv_fwd(const float* __restrict__ feats, const uint8_t* __restrict__ mask,
                int64_t n, int cin, const int32_t* __restrict__ nbr, int64_t m,
                int kk, const float* __restrict__ w, int cout,
                const float* __restrict__ bias, float* __restrict__ out) {
  __shared__ float as[SC_BK][SC_BM];  // gathered rows, transposed
  __shared__ float bs[SC_BK][SC_BN];  // W[k] slice
  __shared__ int64_t rows[SC_BM];     // source row per tile row, -1 = zero

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows    ty*4 .. ty*4+3
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * SC_BM;
  const int n0 = blockIdx.y * SC_BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kk; ++k) {
    int valid = 0;
    if (tid < SC_BM) {
      int64_t gm = m0 + tid;
      int64_t src = -1;
      if (gm < m) {
        int64_t idx = nbr[gm * kk + k];
        if (idx >= 0 && idx < n && mask[idx]) src = idx;
      }
      rows[tid] = src;
      valid = src >= 0;
    }
    if (!__syncthreads_or(valid)) continue;  // no neighbor at this offset

    for (int c0 = 0; c0 < cin; c0 += SC_BK) {
      // A: 64 rows x 16 channels, 4 consecutive channels per thread
      {
        const int r = tid / 4;
        const int cc = (tid % 4) * 4;
        const int64_t src = rows[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + cc + q;
          as[cc + q][r] =
              (src >= 0 && c < cin) ? feats[src * cin + c] : 0.f;
        }
      }
      // B: 16 channels x 64 outputs, 4 consecutive outputs per thread
      {
        const int c = tid / 16;
        const int jj = (tid % 16) * 4;
        const int gc = c0 + c;
        const float* wrow =
            w + (static_cast<int64_t>(k) * cin + gc) * cout;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gj = n0 + jj + q;
          bs[c][jj + q] = (gc < cin && gj < cout) ? wrow[gj] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < SC_BK; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[c][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[c][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = n0 + tx * 4 + j;
      if (gj < cout) {
        float v = acc[i][j];
        if (bias != nullptr) v += bias[gj];
        out[gm * cout + gj] = v;
      }
    }
  }
}

}  // namespace

// feats: (n, cin) f32; mask: (n,) bool bytes; nbr: (m, kk) int32;
// w: (kk, cin, cout) f32; bias: (cout,) f32 or null; out: (m, cout) f32.
// All on the device, contiguous. Returns the launch's CUDA error (0 = none).
extern "C" int es_sparse_conv(const float* feats, const uint8_t* mask,
                              int64_t n, int cin, const int32_t* nbr, int64_t m,
                              int kk, const float* w, int cout,
                              const float* bias, float* out, void* stream) {
  if (m <= 0 || cout <= 0) return 0;
  if (cin <= 0 || kk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t mt = (m + SC_BM - 1) / SC_BM;
  if (mt > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(mt), (cout + SC_BN - 1) / SC_BN);
  sparse_conv_fwd<<<grid, SC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, mask, n, cin, nbr, m, kk, w, cout, bias, out);
  return static_cast<int>(cudaGetLastError());
}
