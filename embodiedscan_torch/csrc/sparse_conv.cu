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
// The bfloat16 variant (K2-bf16; the es_*_bf16 entry points) is the
// contract of the reference's bf16 compute route (ops/sparse.py:
// set_conv_compute_dtype, gather_matmul_conv :311-316): feats and W arrive
// as bfloat16 (the wrapper casts each once per call), products are exact
// in float32 and sums are float32. Both routes are templates on the
// operand type T, so one source serves both variants:
// - tensor cores: a 16-byte cp.async moves 8 bfloat16 channels, half the
//   gathered bytes of float32 a channel; the product is one mma.sync
//   m16n8k16 bf16 per fragment pair where 3xTF32 takes three m16n8k8, at
//   twice the tensor cores' TF32 rate. Rows and W must be 16-byte chunks
//   of 8 channels (Cin, Cout multiples of 8). The promotion of each step's
//   partial sum into the float32 accumulators is the float32 route's.
// - SIMT for Cin < 8: float32 FMAs over the bfloat16 operands, converted
//   exactly as they are read.
// Bound: bf16 dense products at 989 TFLOP/s; at the main path's shapes
// the operations still weigh more than the halved gathers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_mma.cuh"

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

// T: float (3xTF32) or bf16_t. Row pads keep fragment reads free of
// shared-memory bank conflicts and staged rows 16-byte aligned: float rows
// of A are 36 words (fragment rows land 4 banks apart), bfloat16 ones 20
// words (g * 20 mod 32 covers the 8 multiples of 4); rows of B are BN + 8
// elements either way (bfloat16 rows 2t and 2t + 1 of a fragment then lie
// 4 banks apart).
template <typename T, int BN>
struct TcShape {
  static constexpr int kVec = 16 / sizeof(T);     // elements a 16-byte copy
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = 64 * kWarpsN;  // 2 x kWarpsN warps
  static constexpr int kAStride = TC_BK + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int kBStride = BN + 8;
  static constexpr int kAElems = TC_BM * kAStride;
  static constexpr int kBElems = TC_BK * kBStride;
  static constexpr size_t kSmem =
      sizeof(T) * TC_STAGES * (kAElems + kBElems) +
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

// the same over bfloat16 operands: m16n8k16, one product a fragment pair.
// A fragment: rows g, g + 8 by channels 2t, 2t + 1 (+ 8); B fragment:
// channels 2t, 2t + 1 (+ 8) of column g, two rows of B packed in a
// register
template <int AS, int BS>
__device__ __forceinline__ void tc_step(float (&part)[2][4][4],
                                        const bf16_t* as, const bf16_t* bs,
                                        int wm, int wn, int g, int t) {
#pragma unroll
  for (int k16 = 0; k16 < TC_BK; k16 += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16_t* p = as + (wm + i * 16 + g) * AS + k16 + 2 * t;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * AS);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * AS + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bf16_t* p = bs + (k16 + 2 * t) * BS + wn + j * 8 + g;
      b[j][0] = pack_bf16(p[0], p[BS]);
      b[j][1] = pack_bf16(p[8 * BS], p[9 * BS]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a[i], b[j]);
  }
}

// grid (ceil(m / 64), ceil(cout / BN), splits); split z covers the offsets
// [z * per, min(kk, (z + 1) * per)). With ws == null (one split) it writes
// out (+ bias); otherwise its partial sums to ws[z] (m x cout).
template <typename T, int BN>
__global__ void __launch_bounds__(TcShape<T, BN>::kThreads)
sc_tc_fwd(const T* __restrict__ feats, const uint8_t* __restrict__ mask,
          int64_t n, int cin, const int32_t* __restrict__ nbr, int64_t m,
          int kk, int per, const T* __restrict__ w, int cout,
          const float* __restrict__ bias, float* __restrict__ out,
          float* __restrict__ ws) {
  using S = TcShape<T, BN>;
  constexpr int V = S::kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = a_s + TC_STAGES * S::kAElems;
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
    T* as = a_s + slot * S::kAElems;
    T* bs = b_s + slot * S::kBElems;
    // A: 64 rows x 32 channels, in chunks of V channels (4 floats or 8
    // bfloat16)
    for (int c = tid; c < TC_BM * (TC_BK / V); c += S::kThreads) {
      const int r = c / (TC_BK / V), q = c % (TC_BK / V);
      const int src = rj[r];
      const int ch = c0 + q * V;
      const bool ok = src >= 0 && ch < cin;
      const T* g = ok ? feats + static_cast<int64_t>(src) * cin + ch : feats;
      cp_async16(smem_addr(as + r * S::kAStride + q * V), g, ok ? 16 : 0);
    }
    // B: 32 channels x BN outputs of W[k]
    const T* wk = w + static_cast<int64_t>(k_lo + j) * cin * cout;
    for (int c = tid; c < TC_BK * (BN / V); c += S::kThreads) {
      const int kr = c / (BN / V), q = c % (BN / V);
      const int ch = c0 + kr, col = n0 + q * V;
      const bool ok = ch < cin && col < cout;
      const T* g = ok ? wk + static_cast<int64_t>(ch) * cout + col : w;
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

    const T* as = a_s + (step % TC_STAGES) * S::kAElems;
    const T* bs = b_s + (step % TC_STAGES) * S::kBElems;
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

template <typename T, int BN>
int launch_tc(const T* feats, const uint8_t* mask, int64_t n, int cin,
              const int32_t* nbr, int64_t m, int kk, int per, int splits,
              const T* w, int cout, const float* bias, float* out,
              float* ws, cudaStream_t s) {
  using S = TcShape<T, BN>;
  // above 48 KB of shared memory only by request, once per device
  constexpr int kMaxDevices = 64;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(sc_tc_fwd<T, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  dim3 grid(static_cast<unsigned>((m + TC_BM - 1) / TC_BM),
            (cout + BN - 1) / BN, splits);
  sc_tc_fwd<T, BN><<<grid, S::kThreads, S::kSmem, s>>>(
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

template <typename T>
int conv_tc(const T* feats, const uint8_t* mask, int64_t n, int cin,
            const int32_t* nbr, int64_t m, int kk, const T* w, int cout,
            const float* bias, float* out, int bn, int per, int splits,
            float* ws, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (m <= 0 || cout <= 0) return 0;
  if (cin <= 0 || kk <= 0 || cin % V || cout % V || per <= 0 ||
      per > TC_MAXK || splits <= 0 || splits > 65535 ||
      static_cast<int64_t>(splits - 1) * per >= kk ||
      static_cast<int64_t>(splits) * per < kk || (splits > 1 && !ws) ||
      (m + TC_BM - 1) / TC_BM > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64)
    return launch_tc<T, 64>(feats, mask, n, cin, nbr, m, kk, per, splits, w,
                            cout, bias, out, ws, s);
  if (bn == 128)
    return launch_tc<T, 128>(feats, mask, n, cin, nbr, m, kk, per, splits, w,
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

extern "C" int es_sparse_conv_tc_bf16(const bf16_t* feats,
                                      const uint8_t* mask, int64_t n, int cin,
                                      const int32_t* nbr, int64_t m, int kk,
                                      const bf16_t* w, int cout,
                                      const float* bias, float* out, int bn,
                                      int per, int splits, float* ws,
                                      void* stream) {
  return conv_tc(feats, mask, n, cin, nbr, m, kk, w, cout, bias, out, bn, per,
                 splits, ws, stream);
}
