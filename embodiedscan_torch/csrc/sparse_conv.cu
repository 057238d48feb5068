// Sparse gather-GEMM convolution (Hopper, sm_90a).
//
//   out[m, :] = sum_k feats_safe[nbr[m, k], :] @ W[k] (+ bias)
//
// feats_safe is feats with the rows whose mask is false read as zero; an
// index of -1 (or outside [0, n)) contributes nothing. Inputs, accumulation
// and output are float32.
//
// The same contract computes a conv's input gradient (ops/sparse.py:
// conv_dgrad): dout gathered over the mirrored table of a submanifold conv,
// or over the transpose table of a strided one, times the transposed
// weights.
//
// Replaces the Pallas TPU kernel embodiedscan_tpu/experimental/pallas_conv.py
// (banded_conv_pallas / _kernel), whose contract is the engine's conv core
// embodiedscan_tpu/ops/sparse.py:gather_matmul_conv. The TPU kernel copies a
// contiguous band of rows into VMEM and gathers with a one-hot matmul,
// because the TPU cannot gather rows cheaply. A GPU loads the rows
// directly, so neither the band nor its fallback is carried over.
//
// Bound on this card: at the main path's shapes (Cin, Cout of 64-1024) the
// operations bound it. Computed at float32 accuracy on the tensor cores
// (3xTF32, below) they cost 3 TF32 products each, against 495 TFLOP/s;
// the gathered bytes (M * K * Cin * 4 B against 3.35 TB/s) weigh less. At
// the stem (Cin = 3) the index and output bytes bound it.
//
// Only about a quarter of the dense M x K (row, offset) work of a request
// hits a valid row: 24.6% by a CPU count, 26.5% as chip_smoke.py measures
// it on the card (hit_share, weighted by Cin x Cout over the 44 calls of
// one full-width request). A 64-row tile that skips the offsets none of its
// rows has computes 32.3% (CPU count) / 33.3% (work_share). Sorting rows by
// neighbor pattern would cut that only to 27.6%, so the design keeps the
// row order and goes after the arithmetic rate and the occupancy instead.
//
// Design of the tensor-core route (sc_tc_fwd):
// - Numbers: 3xTF32 (sparse_mma.cuh). Each operand is split into its TF32
//   parts as its fragment is read from shared memory; W is split as its
//   fragments are read, not cached. The tensor cores' float32 accumulation
//   truncates, which over
//   K x Cin / 8 x 3 accumulations (up to 5184) drifts: each step's
//   32-channel partial sum is therefore added into the accumulators with a
//   float32 add that rounds to nearest.
// - Math: mma.sync.m16n8k8 TF32; a block of 2 x BN/32 warps computes a
//   64 x BN output tile, each warp a 32 x 32 piece.
// - Gathers: a block first reads its rows' neighbor indices for its
//   offsets into shared memory (-1 where absent, out of range or masked)
//   and lists the offsets at which some row has a neighbor; the others are
//   skipped. The (offset, 32-channel chunk) steps then run through a ring
//   of 3 stages filled by cp.async.cg at 16 B per thread, absent rows
//   zero-filled (src-size 0), so the next gathers are in flight while the
//   tensor cores work.
// - Occupancy: the wrapper picks BN and a split of the K offsets from the
//   shape. A split block writes its partial sums to a workspace, and
//   sc_reduce adds the splits in a fixed order plus the bias: no float
//   atomics, so a call gives the same bits every time.
//
// The SIMT route (sc_simt_fwd, FP32 FMAs, 64 x 64 tiles) serves the shapes
// whose rows are not 16-byte chunks: Cin < 8 (the stem's 3) or a Cin or
// Cout that is not a multiple of 4.
//
// The bfloat16 variant (K2-bf16) is the contract of the reference's bf16
// compute route (ops/sparse.py: set_conv_compute_dtype, gather_matmul_conv
// :311-316): feats and W arrive as bfloat16 (the wrapper casts feats per
// call and keeps one bfloat16 copy of W per weight version), products are
// exact in float32 and sums are float32. It replaces the same TPU kernel,
// banded_conv_pallas, under the reference's bf16 route, and computes the
// input gradient of the custom VJPs (_subm_bwd :367-370, _strided_bwd
// :427-430) from the forward's own W.
// Bound on this card: the bytes (3.35 TB/s; W as its kept bfloat16 copy)
// and the bf16 products (989 TFLOP/s) weigh about the same at the main
// path's shapes (summed, a request's forward calls are bound by the bytes,
// a step's input-gradient calls by the products); what a tile re-reads
// (the gathered rows once per column tile, W's slice once per row tile)
// comes from L2, whose rate, not the tensor cores', sets the pace.
// Design of its tensor-core route (sc_wgmma_bf16, es_sparse_conv_wgmma_bf16):
// - wgmma.m64nNk16.f32.bf16.bf16 with A and B read from shared memory as
//   they land: a step is 64 channels, one 128-byte line a row. cp.async
//   writes each gathered row's 16-byte chunks straight to their places in
//   the 128-byte swizzle (K-major A; absent rows zero-filled by src-size
//   0) and W's slice the same way: in the forward W[k] (Cin x Cout, Cout
//   contiguous) is read MN-major through the descriptor's transpose; the
//   input gradient reads the same (K, Cin, Cout) bfloat16 W K-major at
//   offset K - 1 - k (a submanifold table) or k (a strided conv's
//   transpose table), so no transposed copy of W is made. No pass runs
//   between the landing and the products.
// - Tiles of 64, 128 or 256 rows (a warpgroup per 64) by 64, 128 or 256
//   columns, a ring of 4 slots (3 steps of gathers in flight), one
//   barrier a step; issue and wait of a step's four products stay in one
//   iteration. A warpgroup whose 64 rows have no neighbor at a step's
//   offset skips its products.
// - Numbers: the products accumulate in the wgmma registers for the whole
//   call. The tensor cores' float32 accumulation truncates, which moves the
//   worst call of the main path to ~1e-5 x max|ref| (gate 1e-4; the
//   float32 route's per-step promotion would need a second set of
//   accumulators, which the 256-wide tiles cannot hold).
// - The per-tile offset list as in the float32 route; each thread's copies
//   are the same lines every step, so their places are computed once.
// - Split calls: a block writes its partial sums to the workspace (one with
//   no offset to compute writes none), and the last block of each output
//   tile to arrive (a counter per tile, which it resets) adds the splits
//   that wrote, in split order, plus the bias: no float atomics, no second
//   kernel, the same bits every time.
// The SIMT route serves the bfloat16 shapes whose rows are not 16-byte
// chunks (Cin < 8): float32 FMAs over the bfloat16 operands, converted
// exactly as they are read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_mma.cuh"
#include "sparse_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- SIMT route

#define SC_BM 64
#define SC_BN 64
#define SC_BK 16
#define SC_THREADS 256

// T: float, or bf16_t (converted to float32 as it is read)
template <typename T>
__global__ void __launch_bounds__(SC_THREADS)
sc_simt_fwd(const T* __restrict__ feats, const uint8_t* __restrict__ mask,
            int64_t n, int cin, const int32_t* __restrict__ nbr, int64_t m,
            int kk, const T* __restrict__ w, int cout,
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
      {  // A: 64 rows x 16 channels, 4 consecutive channels per thread
        const int r = tid / 4;
        const int cc = (tid % 4) * 4;
        const int64_t src = rows[r];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + cc + q;
          as[cc + q][r] =
              (src >= 0 && c < cin) ? to_f32(feats[src * cin + c]) : 0.f;
        }
      }
      {  // B: 16 channels x 64 outputs, 4 consecutive outputs per thread
        const int c = tid / 16;
        const int jj = (tid % 16) * 4;
        const int gc = c0 + c;
        const T* wrow = w + (static_cast<int64_t>(k) * cin + gc) * cout;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gj = n0 + jj + q;
          bs[c][jj + q] = (gc < cin && gj < cout) ? to_f32(wrow[gj]) : 0.f;
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

// --------------------------------------------------------- tensor-core route

constexpr int TC_BM = 64;      // output rows per block
constexpr int TC_BK = 32;      // input channels per pipeline step
constexpr int TC_STAGES = 3;   // depth of the cp.async ring
constexpr int TC_MAXK = 27;    // offsets per split (the wrapper's limit)

// Operands float (3xTF32). Row pads keep fragment reads free of shared-memory
// bank conflicts and staged rows 16-byte aligned: rows of A are 36 words
// (fragment rows land 4 banks apart), rows of B BN + 8 elements.
template <int BN>
struct TcShape {
  static constexpr int kVec = 4;  // floats a 16-byte copy
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = 64 * kWarpsN;  // 2 x kWarpsN warps
  static constexpr int kAStride = TC_BK + 4;
  static constexpr int kBStride = BN + 8;
  static constexpr int kAElems = TC_BM * kAStride;
  static constexpr int kBElems = TC_BK * kBStride;
  static constexpr size_t kSmem =
      sizeof(float) * TC_STAGES * (kAElems + kBElems) +
      sizeof(int) * (TC_MAXK * TC_BM + 2 * TC_MAXK + 1);
};

// One 32-channel step of a warp's 32 x 32 piece into part: 3xTF32 over
// float operands (m16n8k8, each operand split into TF32 parts as its
// fragment is read)
template <int AS, int BS>
__device__ __forceinline__ void tc_step(float (&part)[2][4][4],
                                        const float* as, const float* bs,
                                        int wm, int wn, int g, int t) {
#pragma unroll
  for (int k8 = 0; k8 < TC_BK; k8 += 8) {
    uint32_t ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = as + (wm + i * 16 + g) * AS + k8 + t;
      split_tf32(p[0], ahi[i][0], alo[i][0]);
      split_tf32(p[8 * AS], ahi[i][1], alo[i][1]);
      split_tf32(p[4], ahi[i][2], alo[i][2]);
      split_tf32(p[8 * AS + 4], ahi[i][3], alo[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* p = bs + (k8 + t) * BS + wn + j * 8 + g;
      split_tf32(p[0], bhi[j][0], blo[j][0]);
      split_tf32(p[4 * BS], bhi[j][1], blo[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_3xtf32(part[i][j], ahi[i], alo[i], bhi[j], blo[j]);
  }
}

// grid (ceil(m / 64), ceil(cout / BN), splits); split z covers the offsets
// [z * per, min(kk, (z + 1) * per)). With ws == null (one split) it writes
// out (+ bias); otherwise its partial sums to ws[z] (m x cout).
template <int BN>
__global__ void __launch_bounds__(TcShape<BN>::kThreads)
sc_tc_fwd(const float* __restrict__ feats, const uint8_t* __restrict__ mask,
          int64_t n, int cin, const int32_t* __restrict__ nbr, int64_t m,
          int kk, int per, const float* __restrict__ w, int cout,
          const float* __restrict__ bias, float* __restrict__ out,
          float* __restrict__ ws) {
  using S = TcShape<BN>;
  constexpr int V = S::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* a_s = reinterpret_cast<float*>(smem_raw);
  float* b_s = a_s + TC_STAGES * S::kAElems;
  int* rows = reinterpret_cast<int*>(b_s + TC_STAGES * S::kBElems);
  int* hit = rows + TC_MAXK * TC_BM;  // per offset: some row has a neighbor
  int* act = hit + TC_MAXK;           // the offsets that are computed
  int* n_act = act + TC_MAXK;

  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * TC_BM;
  const int n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * per;
  const int nk = min(kk, k_lo + per) - k_lo;

  // 1. the tile's source rows per offset, and which offsets to compute
  for (int j = tid; j < nk; j += S::kThreads) hit[j] = 0;
  __syncthreads();
  for (int e = tid; e < TC_BM * nk; e += S::kThreads) {
    const int r = e / nk, j = e - r * nk;
    const int64_t gm = m0 + r;
    int src = -1;
    if (gm < m) {
      const int idx = nbr[gm * kk + k_lo + j];
      if (idx >= 0 && idx < n && mask[idx]) src = idx;
    }
    rows[j * TC_BM + r] = src;
    if (src >= 0) hit[j] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int c = 0;
    for (int j = 0; j < nk; ++j)
      if (hit[j]) act[c++] = j;
    *n_act = c;
  }
  __syncthreads();

  const int n_chunks = (cin + TC_BK - 1) / TC_BK;
  const int steps = *n_act * n_chunks;

  // 2. stage one (offset, channel chunk) step into ring slot `slot`
  auto load_step = [&](int step, int slot) {
    const int a = step / n_chunks;
    const int c0 = (step - a * n_chunks) * TC_BK;
    const int j = act[a];
    const int* rj = rows + j * TC_BM;
    float* as = a_s + slot * S::kAElems;
    float* bs = b_s + slot * S::kBElems;
    // A: 64 rows x 32 channels, in chunks of V = 4 channels
    for (int c = tid; c < TC_BM * (TC_BK / V); c += S::kThreads) {
      const int r = c / (TC_BK / V), q = c % (TC_BK / V);
      const int src = rj[r];
      const int ch = c0 + q * V;
      const bool ok = src >= 0 && ch < cin;
      const float* g = ok ? feats + static_cast<int64_t>(src) * cin + ch : feats;
      cp_async16(smem_addr(as + r * S::kAStride + q * V), g, ok ? 16 : 0);
    }
    // B: 32 channels x BN outputs of W[k]
    const float* wk = w + static_cast<int64_t>(k_lo + j) * cin * cout;
    for (int c = tid; c < TC_BK * (BN / V); c += S::kThreads) {
      const int kr = c / (BN / V), q = c % (BN / V);
      const int ch = c0 + kr, col = n0 + q * V;
      const bool ok = ch < cin && col < cout;
      const float* g = ok ? wk + static_cast<int64_t>(ch) * cout + col : w;
      cp_async16(smem_addr(bs + kr * S::kBStride + q * V), g, ok ? 16 : 0);
    }
  };

  // 3. the ring: wait for step s, refill the slot step s - 1 used, compute
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / S::kWarpsN) * 32;  // warp's rows within the tile
  const int wn = (warp % S::kWarpsN) * 32;  // warp's columns within the tile
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int nxt = step + TC_STAGES - 1;
    if (nxt < steps) load_step(nxt, nxt % TC_STAGES);
    cp_async_commit();

    const float* as = a_s + (step % TC_STAGES) * S::kAElems;
    const float* bs = b_s + (step % TC_STAGES) * S::kBElems;
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    tc_step<S::kAStride, S::kBStride>(part, as, bs, wm, wn, g, t);
    // the tensor cores' own float32 sums truncate; adding each step's
    // 32-channel partial into the accumulators here rounds to nearest
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
  }
  cp_async_wait<0>();

  // 4. epilogue: fragment (i, j) holds rows g, g + 8 and columns 2t, 2t + 1
  float* dst = ws == nullptr ? out : ws + blockIdx.z * m * cout;
  const bool add_bias = ws == nullptr && bias != nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      if (col >= cout) continue;
      const float b0 = add_bias ? bias[col] : 0.f;
      const float b1 = add_bias ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + i * 16 + g + h * 8;
        if (row < m)
          *reinterpret_cast<float2*>(dst + row * cout + col) =
              make_float2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
      }
    }
}

// out[i] = sum over splits s in order of ws[s][i] (+ bias); 4 floats a thread
__global__ void sc_reduce(const float4* __restrict__ ws, int splits,
                          int64_t quads, int cout,
                          const float* __restrict__ bias,
                          float4* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  float4 s = ws[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = ws[z * quads + i];
    s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
  }
  if (bias != nullptr) {
    const int col = static_cast<int>((i * 4) % cout);
    s.x += bias[col]; s.y += bias[col + 1];
    s.z += bias[col + 2]; s.w += bias[col + 3];
  }
  out[i] = s;
}

template <int BN>
int launch_tc(const float* feats, const uint8_t* mask, int64_t n, int cin,
              const int32_t* nbr, int64_t m, int kk, int per, int splits,
              const float* w, int cout, const float* bias, float* out,
              float* ws, cudaStream_t s) {
  using S = TcShape<BN>;
  // above 48 KB of shared memory only by request, once per device
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(sc_tc_fwd<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  dim3 grid(static_cast<unsigned>((m + TC_BM - 1) / TC_BM),
            (cout + BN - 1) / BN, splits);
  sc_tc_fwd<BN><<<grid, S::kThreads, S::kSmem, s>>>(
      feats, mask, n, cin, nbr, m, kk, per, w, cout, bias, out,
      splits > 1 ? ws : nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int64_t quads = m * cout / 4;
  const int threads = 256;
  sc_reduce<<<static_cast<unsigned>((quads + threads - 1) / threads), threads,
              0, s>>>(reinterpret_cast<const float4*>(ws), splits, quads,
                      cout, bias, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- K2-bf16's tensor-core route

constexpr int KB_STAGES = 4;  // ring slots of 64-channel steps (3 ahead)
constexpr int KB_ILP = 8;     // table entries a thread reads at once

// mode of a K2-bf16 call: how B, the (K x N) matrix of offset k, is read
// from w
enum KbMode : int {
  KB_FORWARD = 0,  // W[k] (Cin x Cout rows, Cout contiguous): MN-major
  KB_MIRROR = 1,   // W[K - 1 - k]^T of a (K, N, Cin) w: K-major (the input
                   // gradient over a submanifold conv's own table)
  KB_TRANSPOSE = 2,  // W[k]^T of a (K, N, Cin) w: K-major (the input
                     // gradient over a strided conv's transpose table)
};

// A block tile of 64 WM rows by BN columns, WM warpgroups of 64 rows by
// all BN columns. A slot holds one step: A, the tile's rows' 64 channels
// (a 128-byte line a row, K-major), then B, 64 channels by the tile's
// columns (BN 128-byte lines: K-major lines of 64 channels a column, or
// MN-major lines of 64 columns a channel, 64 channels a block of 64
// columns); both with the 128-byte swizzle. kA, kB: a thread's 16-byte
// copies of a step
template <int WM, int BN>
struct KbTile {
  static constexpr int kBM = 64 * WM;
  static constexpr int kThreads = 128 * WM;
  static constexpr int kA = kBM * 8 / kThreads;
  static constexpr int kB = BN * 8 / kThreads;
  static constexpr int kStage = (kBM + BN) * 128;  // bytes
  static constexpr size_t kSmem =
      1024 + KB_STAGES * kStage +
      sizeof(int) * (TC_MAXK * (kBM + WM) + 2 * TC_MAXK + 1);
};

// byte offset of 16-byte chunk q of line l in a swizzled region
__device__ __forceinline__ uint32_t sw_chunk(int l, int q) {
  return l * 128 + ((q ^ (l & 7)) << 4);
}

// grid (ceil(m / BM), ceil(cout / BN), splits); split z covers the offsets
// [z * per, min(kk, (z + 1) * per)). feats: (n, cin) bfloat16; w: (kk,
// cin, cout) (KB_FORWARD) or (kk, cout, cin) bfloat16. With one split the
// block writes out (+ bias); else its partial sums to ws[z] (m x cout),
// and the last block of the output tile to arrive (arrivals: two zeroed
// words per tile, which it resets) adds the splits in split order (+
// bias) into out.
template <int WM, int BN, bool KMAJOR_B>
__global__ void __launch_bounds__(KbTile<WM, BN>::kThreads)
sc_wgmma_bf16(const bf16_t* __restrict__ feats,
              const uint8_t* __restrict__ mask, int64_t n, int cin,
              const int32_t* __restrict__ nbr, int64_t m, int kk, int per,
              const bf16_t* __restrict__ w, int cout, int mirror,
              const float* __restrict__ bias, float* __restrict__ out,
              float* __restrict__ ws, int* __restrict__ arrivals) {
  using T = KbTile<WM, BN>;
  constexpr int BM = T::kBM, kThreads = T::kThreads;
  extern __shared__ unsigned char kb_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(kb_smem) + 1023) & ~uintptr_t(1023));
  int* rows = reinterpret_cast<int*>(ring + KB_STAGES * T::kStage);
  // per offset and warpgroup: some row of its 64 has a neighbor
  int* hit = rows + TC_MAXK * BM;
  int* act = hit + TC_MAXK * WM;  // the offsets that are computed
  int* act_wg = act + TC_MAXK;    // and their warpgroups with a neighbor
  int* n_act = act_wg + TC_MAXK;

  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int k_lo = blockIdx.z * per;
  const int nk = min(kk, k_lo + per) - k_lo;

  // 1. the tile's source rows per offset, and which offsets to compute.
  // A thread issues the table reads of KB_ILP entries, then their mask
  // reads, before it uses any: the two dependent loads an entry would
  // otherwise cost in turn are what a block's start waits on
  for (int j = tid; j < nk * WM; j += kThreads) hit[j] = 0;
  __syncthreads();
  for (int e0 = tid; e0 < BM * nk; e0 += KB_ILP * kThreads) {
    int idx[KB_ILP];
    bool ok[KB_ILP];
#pragma unroll
    for (int u = 0; u < KB_ILP; ++u) {
      const int e = e0 + u * kThreads, r = e / nk;
      idx[u] = e < BM * nk && m0 + r < m
                   ? nbr[(m0 + r) * kk + k_lo + e - r * nk]
                   : -1;
    }
#pragma unroll
    for (int u = 0; u < KB_ILP; ++u)
      ok[u] = idx[u] >= 0 && idx[u] < n && mask[idx[u]];
#pragma unroll
    for (int u = 0; u < KB_ILP; ++u) {
      const int e = e0 + u * kThreads, r = e / nk, j = e - r * nk;
      if (e < BM * nk) {
        rows[j * BM + r] = ok[u] ? idx[u] : -1;
        if (ok[u]) hit[j * WM + r / 64] = 1;
      }
    }
  }
  __syncthreads();
  if (tid < 32) {  // one warp lists them in order (nk <= 27 lanes)
    int wgs = 0;
    if (tid < nk)
      for (int q = 0; q < WM; ++q) wgs |= hit[tid * WM + q] << q;
    const unsigned some = __ballot_sync(0xffffffffu, wgs != 0);
    if (wgs) {
      const int c = __popc(some & ((1u << tid) - 1u));
      act[c] = tid;
      act_wg[c] = wgs;
    }
    if (tid == 0) *n_act = __popc(some);
  }
  __syncthreads();

  const int n_chunks = (cin + 63) / 64;
  const int steps = *n_act * n_chunks;

  // 2. one (offset, 64-channel chunk) step into ring slot step % S: the
  // gathered rows and W's slice land as the operands, 16 B a copy,
  // zero-filled for absent rows and past the channels and columns. A
  // thread's copies are the same lines and chunks every step: copy i is
  // chunk (tid + i * threads) % 8 of line (tid + i * threads) / 8, so its
  // place in the slot and its offset in W (from the step's offset and
  // first channel) are set once here
  uint32_t a_dst[T::kA], b_dst[T::kB];
  int a_row[T::kA], a_ch[T::kA], b_ch[T::kB];
  int64_t b_off[T::kB];
#pragma unroll
  for (int i = 0; i < T::kA; ++i) {
    const int e = tid + i * kThreads;
    a_dst[i] = sw_chunk(e >> 3, e & 7);
    a_row[i] = e >> 3;
    a_ch[i] = (e & 7) * 8;
  }
#pragma unroll
  for (int i = 0; i < T::kB; ++i) {
    const int e = tid + i * kThreads, l = e >> 3, q = e & 7;
    b_dst[i] = sw_chunk(l, q);
    int col;
    if constexpr (KMAJOR_B) {  // line l: column n0 + l, 8 channels a chunk
      b_ch[i] = q * 8;
      col = n0 + l;
      b_off[i] = static_cast<int64_t>(col) * cin + q * 8;
    } else {  // line l: channel l % 64, 8 columns a chunk
      b_ch[i] = l & 63;
      col = n0 + (l >> 6) * 64 + q * 8;
      b_off[i] = static_cast<int64_t>(l & 63) * cout + col;
    }
    if (col >= cout) b_ch[i] = cin;  // never in range: zero-filled
  }
  auto load_step = [&](int step) {
    const int a = step / n_chunks;
    const int c0 = (step - a * n_chunks) * 64;
    const int j = act[a];
    const int* rj = rows + j * BM;
    const uint32_t as = smem_addr(ring + (step % KB_STAGES) * T::kStage);
    const uint32_t bs = as + BM * 128;
#pragma unroll
    for (int i = 0; i < T::kA; ++i) {
      const int src = rj[a_row[i]], ch = c0 + a_ch[i];
      const bool ok = src >= 0 && ch < cin;
      cp_async16(as + a_dst[i],
                 ok ? feats + static_cast<int64_t>(src) * cin + ch : feats,
                 ok ? 16 : 0);
    }
    const int k = k_lo + j, kw = mirror ? kk - 1 - k : k;
    // W[kw]'s slice from channel c0: in K-major lines c0 channels along
    // a line, in MN-major ones c0 lines (of cout values) further
    const bf16_t* wk = w + static_cast<int64_t>(kw) * cin * cout +
                       (KMAJOR_B ? c0 : static_cast<int64_t>(c0) * cout);
#pragma unroll
    for (int i = 0; i < T::kB; ++i) {
      const bool ok = c0 + b_ch[i] < cin;
      cp_async16(bs + b_dst[i], ok ? wk + b_off[i] : w, ok ? 16 : 0);
    }
  };

  // 3. the ring: step s's slot landed (one barrier), step s + S - 1's
  // gathers start into the slot step s - 1 read, step s's four k16
  // products are issued and waited for in the same iteration; a
  // warpgroup none of whose rows has a neighbor at the step's offset
  // skips them (its rows landed as zeros)
  const int wg = tid >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // slot 0's descriptors; slot s is s * kStage bytes further. A: the
  // warpgroup's 64 rows, the k16 product kq 32 bytes along each line. B:
  // all BN columns; K-major: 32 bytes along each line; MN-major: 16 lines
  // (2048 bytes) further, the next 64 columns 64 lines (8192 bytes)
  // further
  const uint64_t da = sw128_desc(ring + wg * 64 * 128);
  const uint64_t db = KMAJOR_B ? sw128_desc(ring + BM * 128)
                               : sw128_mn_desc(ring + BM * 128, 64 * 128);
  constexpr int kBStep = KMAJOR_B ? 2 : 128;  // 16-byte units a k16 step
#pragma unroll
  for (int s = 0; s < KB_STAGES - 1; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<KB_STAGES - 2>();
    fence_proxy_async();  // the landed rows, visible to the tensor cores
    __syncthreads();
    const int nxt = step + KB_STAGES - 1;
    if (nxt < steps) load_step(nxt);
    cp_async_commit();
    if ((act_wg[step / n_chunks] >> wg) & 1) {
      const uint64_t so = (step % KB_STAGES) * (T::kStage >> 4);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
        wgmma_bf16<BN, 0, KMAJOR_B ? 0 : 1>(acc, da + so + 2 * kq,
                                            db + so + kBStep * kq, 1);
      wgmma_commit();
      wgmma_wait_all();
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
  cp_async_wait<0>();

  // 4. epilogue: warp w of a warpgroup holds rows 16 w + g, + 8; register
  // 4 i + q columns 8 i + 2 t + (q & 1) of row + 8 (q >> 1). A split
  // block with no offset to compute writes no partial (on a sparse level
  // most do not): it only marks itself absent from its tile's sum
  const bool split = gridDim.z > 1;
  float* dst = split ? ws + blockIdx.z * m * cout : out;
  const bool add_bias = !split && bias != nullptr;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < (split && steps == 0 ? 0 : BN / 8); ++i) {
    const int col = n0 + i * 8 + 2 * t;
    if (col >= cout) continue;
    const float b0 = add_bias ? bias[col] : 0.f;
    const float b1 = add_bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + h * 8;
      if (row < m)
        *reinterpret_cast<float2*>(dst + row * cout + col) = make_float2(
            acc[4 * i + 2 * h] + b0, acc[4 * i + 2 * h + 1] + b1);
    }
  }
  // 5. the split reduction, folded in: no second kernel, and the splits'
  // partials added in split order (+ bias), the order sc_reduce takes
  // (an absent split adds nothing). A tile's two words: its arrivals and
  // the splits that wrote a partial
  if (!split) return;
  int* words = arrivals + 2 * (static_cast<int64_t>(blockIdx.y) * gridDim.x +
                               blockIdx.x);
  if (tid == 0 && steps > 0) atomicOr(words + 1, 1 << blockIdx.z);
  if (!last_arrival(words, gridDim.z)) return;
  __shared__ unsigned s_which;
  if (tid == 0) {
    s_which = static_cast<unsigned>(atomicExch(words + 1, 0));
    words[0] = 0;  // ready for the next call on this buffer
  }
  __syncthreads();
  const int64_t at = m0 * cout + n0;
  reduce_parts4(out + at, ws + at, gridDim.z, s_which, m * cout,
                static_cast<int>(min(static_cast<int64_t>(BM), m - m0)),
                min(BN, cout - n0), cout, bias == nullptr ? nullptr
                                                          : bias + n0);
}

template <int WM, int BN, bool KMAJOR_B>
int launch_wgmma_bf16(const bf16_t* feats, const uint8_t* mask, int64_t n,
                      int cin, const int32_t* nbr, int64_t m, int kk,
                      int per, int splits, const bf16_t* w, int cout,
                      int mirror, const float* bias, float* out, float* ws,
                      int* arrivals, cudaStream_t s) {
  using T = KbTile<WM, BN>;
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(sc_wgmma_bf16<WM, BN, KMAJOR_B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  dim3 grid(static_cast<unsigned>((m + T::kBM - 1) / T::kBM),
            (cout + BN - 1) / BN, splits);
  sc_wgmma_bf16<WM, BN, KMAJOR_B><<<grid, T::kThreads, T::kSmem, s>>>(
      feats, mask, n, cin, nbr, m, kk, per, w, cout, mirror, bias, out,
      splits > 1 ? ws : nullptr, arrivals);
  return static_cast<int>(cudaGetLastError());
}

template <bool KMAJOR_B>
int conv_wgmma_bf16(const bf16_t* feats, const uint8_t* mask, int64_t n,
                    int cin, const int32_t* nbr, int64_t m, int kk,
                    int per, int splits, const bf16_t* w, int cout,
                    int mirror, const float* bias, float* out, int bm,
                    int bn, float* ws, int* arrivals, cudaStream_t s) {
#define KB_LAUNCH(WM, BN)                                                    \
  launch_wgmma_bf16<WM, BN, KMAJOR_B>(feats, mask, n, cin, nbr, m, kk, per,  \
                                      splits, w, cout, mirror, bias, out,    \
                                      ws, arrivals, s)
  if (bm == 64 && bn == 64) return KB_LAUNCH(1, 64);
  if (bm == 64 && bn == 128) return KB_LAUNCH(1, 128);
  if (bm == 128 && bn == 128) return KB_LAUNCH(2, 128);
  if (bm == 128 && bn == 256) return KB_LAUNCH(2, 256);
  if (bm == 256 && bn == 128) return KB_LAUNCH(4, 128);
#undef KB_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int conv_simt(const T* feats, const uint8_t* mask, int64_t n, int cin,
              const int32_t* nbr, int64_t m, int kk, const T* w, int cout,
              const float* bias, float* out, void* stream) {
  if (m <= 0 || cout <= 0) return 0;
  if (cin <= 0 || kk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t mt = (m + SC_BM - 1) / SC_BM;
  if (mt > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(mt), (cout + SC_BN - 1) / SC_BN);
  sc_simt_fwd<T><<<grid, SC_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, mask, n, cin, nbr, m, kk, w, cout, bias, out);
  return static_cast<int>(cudaGetLastError());
}

int conv_tc(const float* feats, const uint8_t* mask, int64_t n, int cin,
            const int32_t* nbr, int64_t m, int kk, const float* w, int cout,
            const float* bias, float* out, int bn, int per, int splits,
            float* ws, void* stream) {
  if (m <= 0 || cout <= 0) return 0;
  if (cin <= 0 || kk <= 0 || cin % 4 || cout % 4 || per <= 0 ||
      per > TC_MAXK || splits <= 0 || splits > 65535 ||
      static_cast<int64_t>(splits - 1) * per >= kk ||
      static_cast<int64_t>(splits) * per < kk || (splits > 1 && !ws) ||
      (m + TC_BM - 1) / TC_BM > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return launch_tc<64>(feats, mask, n, cin, nbr, m, kk, per, splits, w,
                            cout, bias, out, ws, s);
  if (bn == 128)
    return launch_tc<128>(feats, mask, n, cin, nbr, m, kk, per, splits, w,
                             cout, bias, out, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// feats: (n, cin) f32; mask: (n,) bool bytes; nbr: (m, kk) int32;
// w: (kk, cin, cout) f32; bias: (cout,) f32 or null; out: (m, cout) f32.
// All on the device, contiguous. Returns the launch's CUDA error (0 = none).
extern "C" int es_sparse_conv_simt(const float* feats, const uint8_t* mask,
                                   int64_t n, int cin, const int32_t* nbr,
                                   int64_t m, int kk, const float* w, int cout,
                                   const float* bias, float* out,
                                   void* stream) {
  return conv_simt(feats, mask, n, cin, nbr, m, kk, w, cout, bias, out,
                   stream);
}

// The tensor-core route, same arguments plus the wrapper's plan: the block
// tile's width bn (64 or 128), the offsets per split `per` and the number of
// splits; ws holds splits x m x cout floats when splits > 1 (else null).
// Takes cin % 4 == 0, cout % 4 == 0 and 16-byte aligned feats and w.
extern "C" int es_sparse_conv_tc(const float* feats, const uint8_t* mask,
                                 int64_t n, int cin, const int32_t* nbr,
                                 int64_t m, int kk, const float* w, int cout,
                                 const float* bias, float* out, int bn,
                                 int per, int splits, float* ws,
                                 void* stream) {
  return conv_tc(feats, mask, n, cin, nbr, m, kk, w, cout, bias, out, bn, per,
                 splits, ws, stream);
}

// K2-bf16: the two routes with feats (n, cin) and w (kk, cin, cout) as
// bfloat16 bits; bias, accumulation and out stay float32. The tensor-core
// route takes cin % 8 == 0, cout % 8 == 0 and 16-byte aligned feats and w.
extern "C" int es_sparse_conv_simt_bf16(const bf16_t* feats,
                                        const uint8_t* mask, int64_t n,
                                        int cin, const int32_t* nbr,
                                        int64_t m, int kk, const bf16_t* w,
                                        int cout, const float* bias,
                                        float* out, void* stream) {
  return conv_simt(feats, mask, n, cin, nbr, m, kk, w, cout, bias, out,
                   stream);
}

// K2-bf16's tensor-core route (wgmma): feats (n, cin) and w as bfloat16
// bits; bias, accumulation and out float32. mode 0 (KbMode): the forward,
// w (kk, cin, cout); mode 1 or 2: the input gradient from the forward's
// own weights, w (kk, cout, cin) read transposed, at offset kk - 1 - k
// (1: a submanifold conv's table) or k (2: a strided conv's transpose
// table). The plan: the block tile bm x bn ((64, 64), (64, 128), (128,
// 128), (128, 256) or (256, 128)), the offsets per split and the splits.
// With splits > 1 (at most 32), ws holds splits x m x cout floats and
// arrivals at least 2 ceil(m / bm) ceil(cout / bn) int32 words, zero,
// which the call leaves zero (one call at a time on a buffer); else both
// null.
// Takes cin and cout multiples of 8, 16-byte aligned feats and w.
extern "C" int es_sparse_conv_wgmma_bf16(
    const bf16_t* feats, const uint8_t* mask, int64_t n, int cin,
    const int32_t* nbr, int64_t m, int kk, const bf16_t* w, int cout,
    int mode, const float* bias, float* out, int bm, int bn, int per,
    int splits, float* ws, int* arrivals, void* stream) {
  if (m <= 0 || cout <= 0) return 0;
  if (cin <= 0 || kk <= 0 || cin % 8 || cout % 8 || per <= 0 ||
      per > TC_MAXK || splits <= 0 || splits > 32 ||
      static_cast<int64_t>(splits - 1) * per >= kk ||
      static_cast<int64_t>(splits) * per < kk ||
      (splits > 1 && (!ws || !arrivals)) || mode < 0 || mode > 2 ||
      (mode != KB_FORWARD && bias != nullptr) ||
      (m + 63) / 64 > 0x7fffffff ||
      reinterpret_cast<uintptr_t>(feats) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mirror = mode == KB_MIRROR;
  return mode == KB_FORWARD
             ? conv_wgmma_bf16<false>(feats, mask, n, cin, nbr, m, kk, per,
                                      splits, w, cout, 0, bias, out, bm, bn,
                                      ws, arrivals, s)
             : conv_wgmma_bf16<true>(feats, mask, n, cin, nbr, m, kk, per,
                                     splits, w, cout, mirror, nullptr, out,
                                     bm, bn, ws, arrivals, s);
}
