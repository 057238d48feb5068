// Sparse conv weight gradient (Hopper, sm_90a), kernel K3.
//
//   G[k] = sum_r x_safe[r]^T @ y_safe[idx[r, k]]        G: (K, Cx, Cy)
//
// x_safe is x with the rows whose x_mask is false read as zero; y_safe is y
// with the rows whose y_mask is false read as zero, and an index of -1 (or
// outside [0, ny)) contributes nothing. Inputs, accumulation and output are
// float32. ops/sparse.py:conv_wgrad turns G into dW for each route of the
// sparse conv: G.flip(0) over the table of a submanifold conv (the mirror
// identity), G over the transpose table of a strided one, G.transpose(1, 2)
// with x = dout and y = feats over the table of any other.
//
// This is no TPU kernel's port: the JAX package computes dW inside the
// custom VJPs embodiedscan_tpu/ops/sparse.py:_subm_bwd (:354) and
// _strided_bwd (:413) in XLA, as feats^T @ dout[idx[:, k]] per offset. As
// plain PyTorch that product would first write K gathered copies of dout.
//
// Bound on this card: the operations, as for K2. At the main path's shapes
// (Cx, Cy of 64-1024) a 32-row step holds 32 x Cx + 32 x Cy floats and does
// 2 x 32 x Cx x Cy operations, 3 TF32 products each at float32 accuracy.
// Only about a quarter of the (row, offset) pairs hit a valid row.
//
// Design of the tensor-core route (wg_tc):
// - A GEMM whose reduction runs over rows: the grid is (Cx tile, Cy tile)
//   x K offsets x row chunks; a block of 4 warps computes one 64 x 64 tile
//   of G[k] over its chunk, each warp a 32 x 32 piece, in 3xTF32 mma.sync
//   (sparse_mma.cuh); each 32-row step's partial sum is added into register
//   accumulators with a float32 add that rounds to nearest, as in K2.
// - Skips: the block first marks the 32-row steps of its chunk at which
//   some row has both a valid x row and a valid gathered y row (a warp
//   ballot per step) and lists them; the others are never loaded.
// - Gathers: x rows and gathered y rows go through a ring of 3 stages
//   filled by cp.async.cg at 16 B per thread, rows that do not count
//   zero-filled, so the next step's gathers are in flight during the math.
// - Occupancy: the wrapper picks the row chunks, only as many as it takes
//   to reach two waves of blocks (the stem and the wide FPN child have only
//   27 x 1-2 tiles of G). With more than one chunk the blocks write partial
//   sums to a workspace that wg_reduce adds in a fixed order: no float
//   atomics, so a call gives the same bits every time.
//
// The SIMT route (wg_simt, FP32 FMAs, 64 x 64 tiles of G, the same chunks
// and step skips) serves the shapes whose rows are not 16-byte chunks: the
// stem's Cy = 3, or any Cx or Cy that is below 8 or not a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_mma.cuh"

namespace {

constexpr int WG_BM = 64;            // rows of a G tile (x channels)
constexpr int WG_BN = 64;            // columns of a G tile (y channels)
constexpr int WG_BK = 32;            // input rows per step
constexpr int WG_STAGES = 3;         // depth of the cp.async ring
constexpr int WG_STRIDE = WG_BM + 8;  // 72 = 8 mod 32: fragment reads free
                                      // of shared-memory bank conflicts
constexpr int WG_TILE = WG_BK * WG_STRIDE;
constexpr int WG_THREADS = 128;      // 2 x 2 warps
constexpr int WG_MAX_STEPS = 2048;   // steps of a chunk (65536 rows)
constexpr int WG_WORDS = WG_MAX_STEPS / 32;
constexpr size_t WG_SMEM = sizeof(float) * WG_STAGES * 2 * WG_TILE +
                           sizeof(uint16_t) * WG_MAX_STEPS +
                           sizeof(uint32_t) * WG_WORDS + sizeof(int);

// row r of the chunk counts when its x row and its gathered y row are valid
__device__ __forceinline__ int64_t gathered_row(
    const uint8_t* __restrict__ x_mask, const int32_t* __restrict__ idx,
    const uint8_t* __restrict__ y_mask, int64_t ny, int kk, int k, int64_t r,
    int64_t r1) {
  if (r >= r1 || !x_mask[r]) return -1;
  const int64_t j = idx[r * kk + k];
  return (j >= 0 && j < ny && y_mask[j]) ? j : -1;
}

// Marks the steps of [r0, r1) with at least one counting row and lists them
// in act (ascending); returns their number. All threads must call it.
__device__ int list_steps(const uint8_t* __restrict__ x_mask,
                          const int32_t* __restrict__ idx,
                          const uint8_t* __restrict__ y_mask, int64_t ny,
                          int kk, int k, int64_t r0, int64_t r1,
                          uint32_t* bits, uint16_t* act, int* n_act) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int n_steps = static_cast<int>((r1 - r0 + WG_BK - 1) / WG_BK);
  const int n_words = (n_steps + 31) / 32;
  for (int w = tid; w < n_words; w += blockDim.x) bits[w] = 0;
  __syncthreads();
  for (int s = warp; s < n_steps; s += warps) {
    const int64_t r = r0 + static_cast<int64_t>(s) * WG_BK + lane;
    const bool ok =
        gathered_row(x_mask, idx, y_mask, ny, kk, k, r, r1) >= 0;
    if (__any_sync(0xffffffffu, ok) && lane == 0)
      atomicOr(bits + (s >> 5), 1u << (s & 31));
  }
  __syncthreads();
  if (warp == 0) {  // compact the marked steps, 32 words at a time
    int base = 0;
    for (int w0 = 0; w0 < n_words; w0 += 32) {
      const int w = w0 + lane;
      uint32_t word = w < n_words ? bits[w] : 0u;
      const int cnt = __popc(word);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int pos = base + incl - cnt;
      while (word) {
        act[pos++] = static_cast<uint16_t>(w * 32 + __ffs(word) - 1);
        word &= word - 1;
      }
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) *n_act = base;
  }
  __syncthreads();
  return *n_act;
}

// grid (ceil(cx / 64) * ceil(cy / 64), kk, chunks); chunk z covers rows
// [z * chunk_rows, min(r, (z + 1) * chunk_rows)). With ws == null (one
// chunk) it writes out, else its partial sums to ws[z] (kk x cx x cy).
__global__ void __launch_bounds__(WG_THREADS)
wg_tc(const float* __restrict__ x, const uint8_t* __restrict__ x_mask,
      int64_t r, int cx, const int32_t* __restrict__ idx, int kk,
      const float* __restrict__ y, const uint8_t* __restrict__ y_mask,
      int64_t ny, int cy, int chunk_rows, float* __restrict__ out,
      float* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_s = reinterpret_cast<float*>(smem_raw);
  float* b_s = a_s + WG_STAGES * WG_TILE;
  uint16_t* act = reinterpret_cast<uint16_t*>(b_s + WG_STAGES * WG_TILE);
  uint32_t* bits = reinterpret_cast<uint32_t*>(act + WG_MAX_STEPS);
  int* n_act = reinterpret_cast<int*>(bits + WG_WORDS);

  const int tid = threadIdx.x;
  const int tiles_x = (cx + WG_BM - 1) / WG_BM;
  const int cx0 = (blockIdx.x % tiles_x) * WG_BM;
  const int cy0 = (blockIdx.x / tiles_x) * WG_BN;
  const int k = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r1 = min(r, r0 + chunk_rows);

  const int steps = r0 < r1 ? list_steps(x_mask, idx, y_mask, ny, kk, k, r0,
                                         r1, bits, act, n_act)
                            : 0;

  // stage active step a into ring slot `slot`: A = x rows, B = gathered y
  // rows, each 32 rows x 64 channels = 512 chunks of 4 floats
  auto load_step = [&](int a, int slot) {
    const int64_t rb = r0 + static_cast<int64_t>(act[a]) * WG_BK;
    float* as = a_s + slot * WG_TILE;
    float* bs = b_s + slot * WG_TILE;
    for (int c = tid; c < WG_BK * (WG_BM / 4); c += WG_THREADS) {
      const int rr = c / (WG_BM / 4), q = c % (WG_BM / 4);
      const int64_t row = rb + rr;
      const int col = cx0 + q * 4;
      const bool ok = row < r1 && col < cx && x_mask[row];
      const float* g = ok ? x + row * cx + col : x;
      cp_async16(smem_addr(as + rr * WG_STRIDE + q * 4), g, ok ? 16 : 0);
    }
    for (int c = tid; c < WG_BK * (WG_BN / 4); c += WG_THREADS) {
      const int rr = c / (WG_BN / 4), q = c % (WG_BN / 4);
      const int64_t src =
          gathered_row(x_mask, idx, y_mask, ny, kk, k, rb + rr, r1);
      const int col = cy0 + q * 4;
      const bool ok = src >= 0 && col < cy;
      const float* g = ok ? y + src * cy + col : y;
      cp_async16(smem_addr(bs + rr * WG_STRIDE + q * 4), g, ok ? 16 : 0);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32;  // warp's x channels within the tile
  const int wn = (warp & 1) * 32;   // warp's y channels within the tile
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();
    const int nxt = step + WG_STAGES - 1;
    if (nxt < steps) load_step(nxt, nxt % WG_STAGES);
    cp_async_commit();

    // A[m][kr] = x[row kr][channel m], B[kr][n] = y[row kr][channel n]:
    // both tiles are stored row-major over the step's 32 rows
    const float* as = a_s + (step % WG_STAGES) * WG_TILE;
    const float* bs = b_s + (step % WG_STAGES) * WG_TILE;
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < WG_BK; k8 += 8) {
      uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = as + (k8 + t) * WG_STRIDE + wm + i * 16 + g;
        split_tf32(p[0], ahi[i][0], alo[i][0]);
        split_tf32(p[8], ahi[i][1], alo[i][1]);
        split_tf32(p[4 * WG_STRIDE], ahi[i][2], alo[i][2]);
        split_tf32(p[4 * WG_STRIDE + 8], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (k8 + t) * WG_STRIDE + wn + j * 8 + g;
        split_tf32(p[0], bhi[j][0], blo[j][0]);
        split_tf32(p[4 * WG_STRIDE], bhi[j][1], blo[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_3xtf32(part[i][j], ahi[i], alo[i], bhi[j], blo[j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  cp_async_wait<0>();

  // epilogue: fragment (i, j) holds x channels g, g + 8 and y channels
  // 2t, 2t + 1; every block writes its whole tile (zeros where no step ran)
  float* dst = (ws == nullptr ? out : ws + blockIdx.z * (kk * static_cast<
                                          int64_t>(cx) * cy)) +
               static_cast<int64_t>(k) * cx * cy;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cy0 + wn + j * 8 + 2 * t;
      if (col >= cy) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = cx0 + wm + i * 16 + g + h * 8;
        if (row < cx)
          *reinterpret_cast<float2*>(dst + static_cast<int64_t>(row) * cy +
                                     col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// SIMT route: the same grid and chunks, 256 threads of 4 x 4 outputs each
__global__ void __launch_bounds__(256)
wg_simt(const float* __restrict__ x, const uint8_t* __restrict__ x_mask,
        int64_t r, int cx, const int32_t* __restrict__ idx, int kk,
        const float* __restrict__ y, const uint8_t* __restrict__ y_mask,
        int64_t ny, int cy, int chunk_rows, float* __restrict__ out,
        float* __restrict__ ws) {
  __shared__ float xs[WG_BK][WG_BM];
  __shared__ float ys[WG_BK][WG_BN];
  __shared__ int64_t src_s[WG_BK];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // y channels tx*4 .. tx*4+3
  const int ty = tid / 16;  // x channels ty*4 .. ty*4+3
  const int tiles_x = (cx + WG_BM - 1) / WG_BM;
  const int cx0 = (blockIdx.x % tiles_x) * WG_BM;
  const int cy0 = (blockIdx.x / tiles_x) * WG_BN;
  const int k = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r1 = min(r, r0 + chunk_rows);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t rb = r0; rb < r1; rb += WG_BK) {
    int valid = 0;
    if (tid < WG_BK) {
      const int64_t src =
          gathered_row(x_mask, idx, y_mask, ny, kk, k, rb + tid, r1);
      src_s[tid] = src;
      valid = src >= 0;
    }
    if (!__syncthreads_or(valid)) continue;  // no row of this step counts
    for (int e = tid; e < WG_BK * WG_BM; e += 256) {
      const int rr = e / WG_BM, c = e % WG_BM;
      const bool ok = src_s[rr] >= 0;
      xs[rr][c] = ok && cx0 + c < cx ? x[(rb + rr) * cx + cx0 + c] : 0.f;
      ys[rr][c] = ok && cy0 + c < cy ? y[src_s[rr] * cy + cy0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < WG_BK; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[rr][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[rr][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = (ws == nullptr ? out : ws + blockIdx.z * (kk * static_cast<
                                          int64_t>(cx) * cy)) +
               static_cast<int64_t>(k) * cx * cy;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = cx0 + ty * 4 + i;
    if (row >= cx) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cy0 + tx * 4 + j;
      if (col < cy) dst[static_cast<int64_t>(row) * cy + col] = acc[i][j];
    }
  }
}

// out[i] = sum over chunks z in order of ws[z][i]
__global__ void wg_reduce(const float* __restrict__ ws, int chunks,
                          int64_t total, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = ws[i];
  for (int z = 1; z < chunks; ++z) s += ws[z * total + i];
  out[i] = s;
}

int launch(bool tc, const float* x, const uint8_t* x_mask, int64_t r, int cx,
           const int32_t* idx, int kk, const float* y, const uint8_t* y_mask,
           int64_t ny, int cy, float* out, int chunk_rows, int chunks,
           float* ws, void* stream) {
  if (cx <= 0 || cy <= 0 || kk <= 0) return 0;
  const int64_t tiles = static_cast<int64_t>((cx + WG_BM - 1) / WG_BM) *
                        ((cy + WG_BN - 1) / WG_BN);
  if (r < 0 || chunk_rows <= 0 || chunk_rows % WG_BK ||
      chunk_rows > WG_MAX_STEPS * WG_BK || chunks <= 0 || chunks > 65535 ||
      kk > 65535 || tiles > 0x7fffffff ||
      static_cast<int64_t>(chunks - 1) * chunk_rows >= (r > 0 ? r : 1) ||
      static_cast<int64_t>(chunks) * chunk_rows < r || (chunks > 1 && !ws) ||
      (tc && (cx % 4 || cy % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst_ws = chunks > 1 ? ws : nullptr;
  dim3 grid(static_cast<unsigned>(tiles), kk, chunks);
  if (tc) {
    // above 48 KB of shared memory only by request, once per device
    constexpr int kMaxDevices = 64;
    static bool smem_set[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!smem_set[dev]) {
      e = cudaFuncSetAttribute(wg_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WG_SMEM));
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set[dev] = true;
    }
    wg_tc<<<grid, WG_THREADS, WG_SMEM, s>>>(x, x_mask, r, cx, idx, kk, y,
                                            y_mask, ny, cy, chunk_rows, out,
                                            dst_ws);
  } else {
    wg_simt<<<grid, 256, 0, s>>>(x, x_mask, r, cx, idx, kk, y, y_mask, ny,
                                 cy, chunk_rows, out, dst_ws);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return static_cast<int>(e);
  const int64_t total = static_cast<int64_t>(kk) * cx * cy;
  const int threads = 256;
  wg_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads,
              0, s>>>(ws, chunks, total, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (r, cx) f32; x_mask: (r,) bool bytes; idx: (r, kk) int32 rows of y;
// y: (ny, cy) f32; y_mask: (ny,) bool bytes; out: (kk, cx, cy) f32. The
// wrapper's plan: rows per chunk (a multiple of 32, at most 65536) and the
// number of chunks; ws holds chunks x kk x cx x cy floats when chunks > 1
// (else null). All on the device, contiguous. Returns the launch's CUDA
// error (0 = none). The tensor-core route takes cx % 4 == 0, cy % 4 == 0
// and 16-byte aligned x and y.
extern "C" int es_sparse_wgrad_tc(const float* x, const uint8_t* x_mask,
                                  int64_t r, int cx, const int32_t* idx,
                                  int kk, const float* y,
                                  const uint8_t* y_mask, int64_t ny, int cy,
                                  float* out, int chunk_rows, int chunks,
                                  float* ws, void* stream) {
  return launch(true, x, x_mask, r, cx, idx, kk, y, y_mask, ny, cy, out,
                chunk_rows, chunks, ws, stream);
}

extern "C" int es_sparse_wgrad_simt(const float* x, const uint8_t* x_mask,
                                    int64_t r, int cx, const int32_t* idx,
                                    int kk, const float* y,
                                    const uint8_t* y_mask, int64_t ny, int cy,
                                    float* out, int chunk_rows, int chunks,
                                    float* ws, void* stream) {
  return launch(false, x, x_mask, r, cx, idx, kk, y, y_mask, ny, cy, out,
                chunk_rows, chunks, ws, stream);
}
