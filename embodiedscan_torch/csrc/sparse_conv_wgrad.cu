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
// What it replaces: no TPU kernel. The JAX package computes dW inside the
// custom VJPs embodiedscan_tpu/ops/sparse.py:_subm_bwd (:354) and
// _strided_bwd (:413) in XLA, as feats^T @ dout[idx[:, k]] per offset.
//
// Bound on this card: the operations. Over the (row, offset) pairs whose x
// row and gathered y row are both valid (the hit pairs), G takes
// 2 x Cx x Cy operations a pair, each at float32 accuracy as 3 TF32
// products; the bytes (x, y and idx read once, G written once) are far
// below that at every main-path shape but the stem's.
//
// Design, one call = a memset, the pair pass, the product, and (float32) a
// reduction when the pairs of an offset are cut into chunks:
// 1. Pair pass (wg_pairs): one read of idx, coalesced, with x_mask and
//    y_mask[idx]. A block of 256 rows ballots each offset's hit rows, counts
//    them, and finds its place among the blocks by a decoupled look-back
//    (a ticket orders the blocks; the status words are zeroed by the
//    memset). It writes each offset's pairs (r, idx[r, k]) in ascending r
//    and the counts n_k. Once per call, not once per tile of G, and after it
//    every 32-pair step of the product is dense.
// 2. Work split on the device: the grid is (tiles of G, K, chunks), chunks
//    from the shape on the host. Block z of offset k takes pairs
//    [z c_k, min(n_k, (z + 1) c_k)), c_k = n_k / chunks rounded up to 32 and
//    at least WG_MIN_CHUNK: the blocks of an offset get the same work, and
//    a thin offset fills few chunks rather than many near-empty ones whose
//    partial tiles would cost more to write than to compute. Blocks past
//    the last filled chunk exit. With one filled chunk the block writes G;
//    else partials go to ws[z] and wg_reduce adds them in the order of z.
//    No float atomics: a call gives the same bits every time.
// 3. Tensor cores (wg_wgmma): tiles of G of 64 or 128 channels each way
//    (128 where the side has at least 128 channels), one warpgroup per 64
//    x channels. Each 32-pair step gathers its x rows and y rows as fp32
//    with cp.async (16 B copies; TMA cannot gather rows) two steps ahead,
//    their row indices loaded an iteration before. One split pass then
//    turns the landed step into TF32 hi and lo parts, transposed to
//    K-major: a channel's 32 pairs form one 128-byte line, the 128-byte
//    swizzle atom of the wgmma descriptors. Each element is split once per
//    block, not once per warp that reads it, by integer rounding (the bits
//    of cvt.rna, a slow conversion) and 16-byte stores: on the main path
//    the split, not the gathers, is what a step waits on.
// 4. wgmma.m64nNk8.tf32 reads A (x channels x pairs) and B (y channels x
//    pairs) through those descriptors: lo*hi, hi*lo, hi*hi per k8 into a
//    fresh partial (scale-d 0 on the first product), and after
//    wgmma.wait_group the partial is added into the running sum with a
//    float32 add that rounds to nearest, as K2 does. The parts are
//    double-buffered: step s + 1's split pass runs while step s's products
//    are in flight. Issue and wait stay in one loop iteration; carried
//    across the loop edge, the in-flight accumulators made ptxas serialize
//    the products (its note C7517).
// 5. Narrow route (wg_narrow, FP32 FMAs) for any Cx or Cy below 8 or not a
//    multiple of 4 (the stem's Cy = 3) and for views that do not start at
//    a 16-byte boundary: one thread per channel of the wide side, each with
//    the 4 accumulators of a group of the narrow side, over the same pairs
//    and chunks, so no column of a 64-wide tile idles.
// 6. The bfloat16 variant (K3-bf16, es_sparse_wgrad_bf16): the contract of
//    the reference's bf16 compute route on its custom-VJP backwards
//    (_subm_bwd :367-370, _strided_bwd :427-430): x and y arrive as
//    bfloat16 (the backward casts dout and feats once for this kernel and
//    K2-bf16's input gradient), products are exact in float32, sums and G
//    are float32. Bound: the bf16 products at 989 TFLOP/s (summed over a
//    step's calls); the pair pass, the gathers and the chunks' partials,
//    not the products, set its pace.
//    The pair pass and the narrow route (FP32 FMAs over the converted
//    values) are the float32 route's; its tensor-core kernel
//    (wg_wgmma_bf16) is its own:
//    - A 64-pair step lands its x rows and y rows as the operands
//      themselves: for bfloat16, wgmma reads A (x channels x pairs) and B
//      (pairs x y channels) MN-major through its transpose operands, so
//      cp.async writes each row's 16-byte chunks straight into the
//      128-byte swizzle those descriptors read (a line is 64 channels of
//      one pair). No pass transposes them, no buffer holds parts, and a
//      step costs one barrier.
//    - A ring of 4 slots (3 steps of gathers in flight); the steps' pair
//      indices come through shared memory too, copied S - 1 steps ahead
//      of the gathers that read them, so no gather waits on a global load
//      of its row numbers.
//    - Each step's partial is added into float32 accumulators with a
//      rounding add, as in the float32 route (the chunk sums run over
//      thousands of pairs).
//    - Chunk reduction folded in: the last block of each (tile of G,
//      offset) to finish (a counter per pair, zeroed by the pair pass's
//      memset) adds the chunks' partials in chunk order, wg_reduce's
//      order; no reduction kernel runs (the narrow route folds the same
//      way).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_mma.cuh"
#include "sparse_wgmma.cuh"

namespace {

constexpr int WG_STEP = 32;         // pairs per step of a tensor-core block
constexpr int WG_STAGES = 3;        // slots of staged rows (2 steps in flight)
constexpr int WG_MIN_CHUNK = 256;   // least pairs of a chunk (a multiple of 32)
// 3xTF32 products per term (kernel_ab.py --tf32-control sets 1)
constexpr int WG_TF32_TERMS = 3;

// ---- 1. the pair pass ----------------------------------------------------

constexpr int WP_ROWS = 256;        // rows of a pair-pass block, one a thread
constexpr int WP_WARPS = WP_ROWS / 32;
constexpr int WP_KGROUP = 32;       // offsets staged at a time
constexpr unsigned long long kAggregate = 1;  // status flags (0: not ready)
constexpr unsigned long long kInclusive = 2;

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long pack(unsigned long long flag,
                                                   int v) {
  return (flag << 32) | static_cast<unsigned>(v);
}

__device__ __forceinline__ unsigned flag_of(unsigned long long w) {
  return static_cast<unsigned>(w >> 32);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Pairs of the blocks before `tile` (one offset's status row), looking back
// 32 blocks at a time and stopping at the first inclusive prefix. Called by
// one whole warp.
__device__ int look_back_sum(const unsigned long long* st, int tile) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int i = pred - lane;  // lane 0 is the nearest predecessor
    unsigned long long w = pack(kInclusive, 0);  // before block 0
    if (i >= 0) {
      do {
        w = load_status(st + i);
      } while (flag_of(w) == 0);
    }
    const unsigned incl =
        __ballot_sync(0xffffffffu, flag_of(w) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    excl += warp_sum(lane <= stop ? static_cast<int>(static_cast<unsigned>(w))
                                  : 0);
    if (incl) return excl;
  }
}

// grid (ntiles): block `ticket` covers rows [256 t, 256 t + 256). pairs:
// (kk, r) int2; counts: (kk,); status: (kk, ntiles) and ticket zeroed.
__global__ void __launch_bounds__(WP_ROWS)
wg_pairs(const uint8_t* __restrict__ x_mask, int64_t r,
         const int32_t* __restrict__ idx, int kk,
         const uint8_t* __restrict__ y_mask, int64_t ny, int ntiles,
         int2* __restrict__ pairs, int* __restrict__ counts,
         unsigned long long* status, int* ticket) {
  extern __shared__ int s_idx[];  // WP_ROWS x (kg | 1): odd rows, no conflict
  __shared__ uint32_t s_ball[WP_KGROUP][WP_WARPS];
  __shared__ int s_pre[WP_KGROUP][WP_WARPS];  // pairs before each warp
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t r0 = static_cast<int64_t>(tile) * WP_ROWS, row = r0 + tid;
  const bool xv = row < r && x_mask[row];
  for (int k0 = 0; k0 < kk; k0 += WP_KGROUP) {
    const int kg = min(WP_KGROUP, kk - k0), stride = kg | 1;
    for (int e = tid; e < WP_ROWS * kg; e += WP_ROWS) {
      const int rr = e / kg, c = e - rr * kg;
      const int64_t g = r0 + rr;
      s_idx[rr * stride + c] = g < r ? idx[g * kk + k0 + c] : -1;
    }
    __syncthreads();
    for (int c = 0; c < kg; ++c) {
      const int j = s_idx[tid * stride + c];
      const bool ok = xv && j >= 0 && j < ny && y_mask[j];
      const uint32_t b = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) s_ball[c][warp] = b;
    }
    __syncthreads();
    // each warp owns offsets warp, warp + 8, ...: first publish every
    // owned offset's count, then look back for each
    for (int c = warp; c < kg; c += WP_WARPS) {
      const int cnt = lane < WP_WARPS ? __popc(s_ball[c][lane]) : 0;
      int inc = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int agg = __shfl_sync(0xffffffffu, inc, 31);
      if (lane < WP_WARPS) s_pre[c][lane] = inc - cnt;
      if (lane == 0)
        store_status(status + static_cast<int64_t>(k0 + c) * ntiles + tile,
                     pack(tile == 0 ? kInclusive : kAggregate, agg));
    }
    __syncwarp();
    for (int c = warp; c < kg; c += WP_WARPS) {
      unsigned long long* st = status + static_cast<int64_t>(k0 + c) * ntiles;
      const int agg = s_pre[c][WP_WARPS - 1] +
                      __popc(s_ball[c][WP_WARPS - 1]);
      const int excl = tile == 0 ? 0 : look_back_sum(st, tile);
      if (lane == 0) {
        if (tile > 0) store_status(st + tile, pack(kInclusive, excl + agg));
        if (tile == ntiles - 1) counts[k0 + c] = excl + agg;
      }
      __syncwarp();
      if (lane < WP_WARPS) s_pre[c][lane] += excl;
    }
    __syncthreads();
    for (int c = 0; c < kg; ++c) {  // coalesced: a warp's pairs are adjacent
      const uint32_t b = s_ball[c][warp];
      if ((b >> lane) & 1u) {
        const int pos = s_pre[c][warp] + __popc(b & ((1u << lane) - 1u));
        pairs[static_cast<int64_t>(k0 + c) * r + pos] =
            make_int2(static_cast<int>(row), s_idx[tid * stride + c]);
      }
    }
    __syncthreads();  // before the next group restages s_idx
  }
}

// ---- 2. chunks: block z of an offset with n pairs ------------------------

__device__ __forceinline__ int chunk_pairs(int n, int chunks) {
  int64_t c = (static_cast<int64_t>(n) + chunks - 1) / chunks;
  c = (c + WG_STEP - 1) / WG_STEP * WG_STEP;
  return static_cast<int>(c < WG_MIN_CHUNK ? WG_MIN_CHUNK : c);
}

// chunks that hold pairs (at least 1: with n = 0 block 0 writes zeros)
__device__ __forceinline__ int chunks_filled(int n, int chunks) {
  const int c = chunk_pairs(n, chunks);
  return n == 0 ? 1 : static_cast<int>((static_cast<int64_t>(n) + c - 1) / c);
}

struct Chunk {
  int p0, p1;   // pairs [p0, p1) of the offset
  float* dst;   // G[k] or ws[z][k]
};

// The block's chunk, or dst == null when its chunk holds no pair
__device__ __forceinline__ Chunk block_chunk(const int* counts, int chunks,
                                             int cx, int cy, float* out,
                                             float* ws) {
  const int k = blockIdx.y, z = blockIdx.z, kk = gridDim.y;
  const int n = counts[k];
  const int c = chunk_pairs(n, chunks), filled = chunks_filled(n, chunks);
  Chunk ch{0, 0, nullptr};
  if (z >= filled) return ch;
  ch.p0 = z * c;  // z < filled, so z * c < n (or 0)
  ch.p1 = min(n, ch.p0 + c);
  const int64_t plane = static_cast<int64_t>(cx) * cy;
  ch.dst = (filled == 1 ? out : ws + z * (kk * plane)) + k * plane;
  return ch;
}

// ---- 3-4. the tensor-core route: wgmma over pre-split TF32 parts ---------

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N over a warpgroup, N / 2 floats a thread) = a * b (+ d when
// scale_d); a: 64 x 8, b: N x 8, both K-major TF32 in shared memory
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float* d, uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef WG_D8

// S: slots of staged rows (S - 1 steps of gathers in flight). Two buffers
// of TF32 parts: a step's split pass runs while the last step's products
// are in flight.
template <int BM, int BN, int S>
struct WgTile {
  static_assert(S >= 3, "a step's gathers and the next split need 2 slots");
  static constexpr int kThreads = BM * 2;  // BM / 64 warpgroups
  static constexpr int kStage = WG_STEP * (BM + BN);  // staged fp32 rows
  // one step's TF32 parts: A hi, B hi, A lo, B lo, each 1024-byte aligned
  static constexpr int kParts = 2 * (BM + BN) * WG_STEP;
  static constexpr int kA = WG_STEP * (BM / 4) / kThreads;  // copies of a
  static constexpr int kB = WG_STEP * (BN / 4) / kThreads;  // thread a step
  // parts, staged rows, and 1024 bytes of slack to align the swizzled
  // parts to their atoms
  static constexpr size_t kSmem =
      1024 + sizeof(float) * (2 * kParts + S * kStage);
};

// staged rows: row p of W floats keeps 16-byte chunk q at chunk
// q ^ ((p / 4) % 8), so the split pass's float4 reads (rows 4 j + c of 8
// values of j) are conflict-free
template <int W>
__device__ __forceinline__ int staged(int p, int q) {
  return p * W + ((q ^ ((p >> 2) & 7)) << 2);
}

// K-major part with the 128-byte swizzle: row m (a channel) holds a step's
// pairs in one 128-byte line, 8 rows form a 1024-byte atom, and 16-byte
// chunk q of row m sits at chunk q ^ (m % 8)
__device__ __forceinline__ int sw128(int m, int p) {
  return m * WG_STEP + ((((p >> 2) ^ m) & 7) << 2) + (p & 3);
}

// cvt.rna.tf32.f32 in two integer operations (round half away from zero at
// the 13th mantissa bit): the same bits, at the full integer rate
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// One landed step (32 pairs x W channels) into its K-major swizzled hi and
// lo parts. A thread takes 4 pairs x 4 channels: four float4 reads, then
// per channel one 16-byte store of its 4 pairs into each part; the 8
// threads of a quarter warp fill one 128-byte line
template <int W>
__device__ __forceinline__ void split_stage(const float* src, float* hi,
                                            float* lo, int tid, int threads) {
  for (int e = tid; e < (WG_STEP / 4) * (W / 4); e += threads) {
    const int pq = e & 7, mq = e >> 3;
    float v[4][4];  // [pair 4 pq + j][channel 4 mq + i]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t =
          *reinterpret_cast<const float4*>(src + staged<W>(4 * pq + j, mq));
      v[j][0] = t.x, v[j][1] = t.y, v[j][2] = t.z, v[j][3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = tf32_rna(v[j][i]);
        l[j] = tf32_rna(v[j][i] - __uint_as_float(h[j]));
      }
      const int m = 4 * mq + i;
      const int off = sw128(m, 4 * pq);  // pairs 4 pq .. 4 pq + 3 of line m
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
}

// grid (ceil(cx / BM) * ceil(cy / BN), kk, chunks), BM * 2 threads
template <int BM, int BN, int S>
__global__ void __launch_bounds__(WgTile<BM, BN, S>::kThreads)
wg_wgmma(const float* __restrict__ x, int cx, const float* __restrict__ y,
         int cy, int64_t r, const int2* __restrict__ pairs,
         const int* __restrict__ counts, int chunks, float* __restrict__ out,
         float* __restrict__ ws) {
  using T = WgTile<BM, BN, S>;
  constexpr int kThreads = T::kThreads;
  extern __shared__ unsigned char wg_smem[];
  float* parts = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  float* ring = parts + 2 * T::kParts;

  const Chunk ch = block_chunk(counts, chunks, cx, cy, out, ws);
  if (ch.dst == nullptr) return;
  const int tid = threadIdx.x;
  const int tiles_x = (cx + BM - 1) / BM;
  const int cx0 = (blockIdx.x % tiles_x) * BM;
  const int cy0 = (blockIdx.x / tiles_x) * BN;
  const int2* pk = pairs + blockIdx.y * r;
  const int steps = (ch.p1 - ch.p0 + WG_STEP - 1) / WG_STEP;

  // the x and y rows of this thread's copies of one step (-1 past the
  // chunk), loaded an iteration before their gathers are issued
  int xr[T::kA], yr[T::kB];
  auto fetch_rows = [&](int s) {
    const int pb = ch.p0 + s * WG_STEP;
#pragma unroll
    for (int i = 0; i < T::kA; ++i) {
      const int p = pb + (tid + i * kThreads) / (BM / 4);
      xr[i] = p < ch.p1 ? pk[p].x : -1;
    }
#pragma unroll
    for (int i = 0; i < T::kB; ++i) {
      const int p = pb + (tid + i * kThreads) / (BN / 4);
      yr[i] = p < ch.p1 ? pk[p].y : -1;
    }
  };
  // gather step s into ring slot s % S: x rows then y rows, 16 B a copy,
  // zero-filled past the chunk's pairs and the channels
  auto load_step = [&](int s) {
    float* as = ring + (s % S) * T::kStage;
    float* bs = as + WG_STEP * BM;
#pragma unroll
    for (int i = 0; i < T::kA; ++i) {
      const int e = tid + i * kThreads;
      const int rr = e / (BM / 4), q = e % (BM / 4), col = cx0 + q * 4;
      const bool ok = xr[i] >= 0 && col < cx;
      const float* g = ok ? x + static_cast<int64_t>(xr[i]) * cx + col : x;
      cp_async16(smem_addr(as + staged<BM>(rr, q)), g, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < T::kB; ++i) {
      const int e = tid + i * kThreads;
      const int rr = e / (BN / 4), q = e % (BN / 4), col = cy0 + q * 4;
      const bool ok = yr[i] >= 0 && col < cy;
      const float* g = ok ? y + static_cast<int64_t>(yr[i]) * cy + col : y;
      cp_async16(smem_addr(bs + staged<BN>(rr, q)), g, ok ? 16 : 0);
    }
  };

  const int wg = tid >> 7;  // warpgroup: x channels wg * 64 ..
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  // descriptors of parts buffer 0; buffer 1 is kParts floats further
  const uint64_t dahi = sw128_desc(parts + wg * 64 * WG_STEP);
  const uint64_t dbhi = sw128_desc(parts + BM * WG_STEP);
  const uint64_t dalo = sw128_desc(parts + (BM + BN + wg * 64) * WG_STEP);
  const uint64_t dblo = sw128_desc(parts + (2 * BM + BN) * WG_STEP);
  // step s's landed rows into parts buffer s % 2
  auto split = [&](int s) {
    const float* as = ring + (s % S) * T::kStage;
    float* pb = parts + (s & 1) * T::kParts;
    split_stage<BM>(as, pb, pb + (BM + BN) * WG_STEP, tid, kThreads);
    split_stage<BN>(as + WG_STEP * BM, pb + BM * WG_STEP,
                    pb + (2 * BM + BN) * WG_STEP, tid, kThreads);
    fence_proxy_async();  // the parts' stores, visible to the tensor cores
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) {
      fetch_rows(s);
      load_step(s);
    }
    cp_async_commit();
  }
  if (S - 1 < steps) fetch_rows(S - 1);
  if (steps > 0) {
    cp_async_wait<S - 2>();
    __syncthreads();
    split(0);
    __syncthreads();
  }
  // step s: its products are issued on parts buffer s % 2; step s + S - 1's
  // gathers start; step s + 1's rows land and are split into the other
  // buffer while the products run; then they are added. Issue and wait
  // stay in one iteration, so no loop edge carries registers the tensor
  // cores are still writing.
  for (int step = 0; step < steps; ++step) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(part[i]);
    wgmma_fence();
    const uint64_t bo = (step & 1) * (T::kParts / 4);  // 16-byte units
#pragma unroll
    for (int k8 = 0; k8 < WG_STEP / 8; ++k8) {
      const uint64_t o = bo + 2 * k8;  // 32 bytes further along each line
      if (WG_TF32_TERMS == 3) {
        wgmma_tf32<BN>(part, dalo + o, dbhi + o, k8 > 0);
        wgmma_tf32<BN>(part, dahi + o, dblo + o, 1);
      }
      wgmma_tf32<BN>(part, dahi + o, dbhi + o,
                     WG_TF32_TERMS == 3 || k8 > 0);
    }
    wgmma_commit();

    const int nxt = step + S - 1;
    if (nxt < steps) {
      load_step(nxt);  // ring slot of step - 1, split in the last iteration
      if (nxt + 1 < steps) fetch_rows(nxt + 1);
    }
    cp_async_commit();
    if (step + 1 < steps) {
      cp_async_wait<S - 2>();
      __syncthreads();  // step + 1 landed everywhere
      split(step + 1);  // buffer (step + 1) % 2: step - 1's, already added
    }
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      fence_reg(part[i]);
      acc[i] += part[i];
    }
    __syncthreads();  // the split is visible, the products read their parts
  }
  cp_async_wait<0>();

  // fragment: warp w of the warpgroup holds rows 16 w + g, + 8; register
  // 4 i + q holds columns 8 i + 2 t + (q & 1) of row + 8 (q >> 1)
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = cx0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = cy0 + i * 8 + 2 * t;
    if (col >= cy) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row < cx)
        *reinterpret_cast<float2*>(ch.dst + static_cast<int64_t>(row) * cy +
                                   col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// ---- 6. K3-bf16's tensor-core route: wgmma on the landed rows ------------

constexpr int WB_STEP = 64;    // pairs a step: 4 products of k16
constexpr int WB_STAGES = 4;   // ring slots of landed rows (3 steps ahead)

// A step lands its 64 pairs' rows as the operands themselves: x (A, BM
// channels) and y (B, BN channels) MN-major with the 128-byte swizzle,
// line 64 b + p holding channels 64 b .. 64 b + 63 of pair p (see
// sparse_wgmma.cuh); kA and kB: a thread's 16-byte copies of a step.
// After the ring, 2 S slots of a step's pair indices (their copies run S
// - 1 steps ahead of the gathers that read them)
template <int BM, int BN>
struct WbTile {
  static constexpr int kThreads = BM * 2;  // BM / 64 warpgroups
  static constexpr int kStage = (BM + BN) * 128;  // bytes of a slot
  static constexpr int kA = WB_STEP * (BM / 8) / kThreads;
  static constexpr int kB = WB_STEP * (BN / 8) / kThreads;
  static constexpr int kIdxSlots = 2 * WB_STAGES;
  static constexpr size_t kSmem =
      1024 + WB_STAGES * kStage + kIdxSlots * WB_STEP * sizeof(int2);
};

// 8-byte async copy (through L1); src_bytes = 0 zero-fills the destination
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// byte offset of 16-byte chunk q8 (8 channels) of pair p in an MN-major
// region
__device__ __forceinline__ int mn_chunk(int p, int q8) {
  const int line = (q8 >> 3) * WB_STEP + p;
  return line * 128 + (((q8 & 7) ^ (p & 7)) << 4);
}

// grid (ceil(cx / BM) * ceil(cy / BN), kk, chunks), BM * 2 threads; x, y:
// bfloat16. With more than one filled chunk the last block of a (tile,
// offset) to finish adds the chunks' partials in chunk order (arrivals: kk
// x tiles counters, zeroed)
template <int BM, int BN>
__global__ void __launch_bounds__(WbTile<BM, BN>::kThreads)
wg_wgmma_bf16(const bf16_t* __restrict__ x, int cx,
              const bf16_t* __restrict__ y, int cy, int64_t r,
              const int2* __restrict__ pairs, const int* __restrict__ counts,
              int chunks, float* __restrict__ out, float* __restrict__ ws,
              int* __restrict__ arrivals) {
  using T = WbTile<BM, BN>;
  constexpr int kThreads = T::kThreads;
  extern __shared__ unsigned char wb_smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wb_smem) + 1023) & ~uintptr_t(1023));

  const Chunk ch = block_chunk(counts, chunks, cx, cy, out, ws);
  if (ch.dst == nullptr) return;
  const int tid = threadIdx.x;
  const int tiles_x = (cx + BM - 1) / BM;
  const int cx0 = (blockIdx.x % tiles_x) * BM;
  const int cy0 = (blockIdx.x / tiles_x) * BN;
  const int2* pk = pairs + blockIdx.y * r;
  const int steps = (ch.p1 - ch.p0 + WB_STEP - 1) / WB_STEP;

  // step t's pair indices into index slot t % 2S, 8 B a copy (a pair a
  // thread), zero-filled past the chunk; gathers test p < p1, not these
  const int2* idx_s = reinterpret_cast<const int2*>(ring + WB_STAGES *
                                                          T::kStage);
  const uint32_t idx_a = smem_addr(idx_s);
  auto load_idx = [&](int t) {
    if (tid < WB_STEP && t < steps) {
      const int p = ch.p0 + t * WB_STEP + tid;
      cp_async8(idx_a + ((t % T::kIdxSlots) * WB_STEP + tid) * 8,
                p < ch.p1 ? pk + p : pk, p < ch.p1 ? 8 : 0);
    }
  };
  // step s's rows straight into their operand layout in slot s % S, 16 B
  // a copy, zero-filled past the chunk's pairs and the channels
  auto load_step = [&](int s) {
    const uint32_t as = smem_addr(ring + (s % WB_STAGES) * T::kStage);
    const uint32_t bs = as + BM * 128;
    const int2* ix = idx_s + (s % T::kIdxSlots) * WB_STEP;
    const int left = ch.p1 - (ch.p0 + s * WB_STEP);  // pairs in the step
#pragma unroll
    for (int i = 0; i < T::kA; ++i) {
      const int e = tid + i * kThreads;
      const int p = e / (BM / 8), q8 = e % (BM / 8), col = cx0 + q8 * 8;
      const bool ok = p < left && col < cx;
      const bf16_t* g =
          ok ? x + static_cast<int64_t>(ix[p].x) * cx + col : x;
      cp_async16(as + mn_chunk(p, q8), g, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < T::kB; ++i) {
      const int e = tid + i * kThreads;
      const int p = e / (BN / 8), q8 = e % (BN / 8), col = cy0 + q8 * 8;
      const bool ok = p < left && col < cy;
      const bf16_t* g =
          ok ? y + static_cast<int64_t>(ix[p].y) * cy + col : y;
      cp_async16(bs + mn_chunk(p, q8), g, ok ? 16 : 0);
    }
  };

  const int wg = tid >> 7;  // warpgroup: x channels wg * 64 ..
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  // slot 0's descriptors (A: the warpgroup's 64 x channels; B: all BN y
  // channels, 64 a line); slot s is s * kStage bytes further, and the
  // k16 product kq 16 lines (2048 bytes) further
  const uint64_t da = sw128_mn_desc(ring + wg * WB_STEP * 128,
                                    WB_STEP * 128);
  const uint64_t db = sw128_mn_desc(ring + BM * 128, WB_STEP * 128);
  // the first S - 1 steps' indices, then their gathers, each group with
  // the indices of the step S - 1 further
#pragma unroll
  for (int s = 0; s < WB_STAGES - 1; ++s) load_idx(s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int s = 0; s < WB_STAGES - 1; ++s) {
    if (s < steps) load_step(s);
    load_idx(s + WB_STAGES - 1);
    cp_async_commit();
  }
  // step s: its rows landed (one barrier), step s + S - 1's gathers start
  // into the slot step s - 1 read (their indices landed with step s), with
  // the indices of step s + 2 S - 2; then step s's products are issued and
  // waited for in the same iteration (no loop edge carries registers the
  // tensor cores are still writing) and added into the running sum with a
  // float32 add that rounds to nearest
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<WB_STAGES - 2>();
    fence_proxy_async();  // the landed rows, visible to the tensor cores
    __syncthreads();
    const int nxt = step + WB_STAGES - 1;
    if (nxt < steps) load_step(nxt);
    load_idx(nxt + WB_STAGES - 1);
    cp_async_commit();
    const uint64_t so = (step % WB_STAGES) * (T::kStage >> 4);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(part[i]);
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < 4; ++kq)
      wgmma_bf16<BN, 1, 1>(part, da + so + 128 * kq, db + so + 128 * kq,
                           kq > 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      fence_reg(part[i]);
      acc[i] += part[i];
    }
  }
  cp_async_wait<0>();

  // fragment: warp w of the warpgroup holds rows 16 w + g, + 8; register
  // 4 i + q holds columns 8 i + 2 t + (q & 1) of row + 8 (q >> 1)
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = cx0 + wg * 64 + ((tid >> 5) & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = cy0 + i * 8 + 2 * t;
    if (col >= cy) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row < cx)
        *reinterpret_cast<float2*>(ch.dst + static_cast<int64_t>(row) * cy +
                                   col) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
  const int k = blockIdx.y, filled = chunks_filled(counts[k], chunks);
  if (filled == 1 ||
      !last_arrival(arrivals + static_cast<int64_t>(k) * gridDim.x +
                        blockIdx.x, filled))
    return;
  // the last of the offset's chunks to finish: G[k]'s tile = the chunks'
  // partials added in chunk order (wg_reduce's order)
  const int64_t plane = static_cast<int64_t>(cx) * cy;
  const int64_t at = k * plane + static_cast<int64_t>(cx0) * cy + cy0;
  reduce_parts4(out + at, ws + at, filled, ~0u, gridDim.y * plane,
                min(BM, cx - cx0), min(BN, cy - cy0), cy, nullptr);
}

// ---- 5. the narrow route -------------------------------------------------

constexpr int WN_THREADS = 256;
constexpr int WN_WIDE = 64;                       // wide channels a block
constexpr int WN_GROUPS = WN_THREADS / WN_WIDE;  // each takes every 4th pair
constexpr int WN_NARROW = 4;                      // narrow channels a block
constexpr int WN_STEP = 128;                      // pairs staged at a time

// grid (tiles, kk, chunks). y_narrow: the wide side is x (64 x channels a
// block, groups of 4 y channels), else the wide side is y. E: float, or
// bf16_t (converted to float32 as it is read)
template <typename E>
__global__ void __launch_bounds__(WN_THREADS)
wg_narrow(const E* __restrict__ x, int cx, const E* __restrict__ y,
          int cy, int64_t r, const int2* __restrict__ pairs,
          const int* __restrict__ counts, int chunks, bool y_narrow,
          float* __restrict__ out, float* __restrict__ ws,
          int* __restrict__ arrivals) {
  __shared__ int s_wrow[WN_STEP];
  __shared__ float s_nv[WN_STEP][WN_NARROW];
  __shared__ float s_red[WN_GROUPS][WN_NARROW][WN_WIDE];
  const Chunk ch = block_chunk(counts, chunks, cx, cy, out, ws);
  if (ch.dst == nullptr) return;
  const E* wsrc = y_narrow ? x : y;
  const E* nsrc = y_narrow ? y : x;
  const int cw = y_narrow ? cx : cy, cn = y_narrow ? cy : cx;
  const int tiles_w = (cw + WN_WIDE - 1) / WN_WIDE;
  const int cw0 = (blockIdx.x % tiles_w) * WN_WIDE;
  const int cn0 = (blockIdx.x / tiles_w) * WN_NARROW;
  const int tid = threadIdx.x, c = tid % WN_WIDE, grp = tid / WN_WIDE;
  const int wc = cw0 + c;
  const int2* pk = pairs + blockIdx.y * r;

  float acc[WN_NARROW] = {0.f, 0.f, 0.f, 0.f};
  for (int pb = ch.p0; pb < ch.p1; pb += WN_STEP) {
    const int cnt = min(WN_STEP, ch.p1 - pb);
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < WN_STEP * WN_NARROW; e += WN_THREADS) {
      const int i = e / WN_NARROW, q = e % WN_NARROW;
      float v = 0.f;
      if (i < cnt) {
        const int2 pr = pk[pb + i];
        const int nrow = y_narrow ? pr.y : pr.x;
        if (cn0 + q < cn)
          v = to_f32(nsrc[static_cast<int64_t>(nrow) * cn + cn0 + q]);
        if (q == 0) s_wrow[i] = y_narrow ? pr.x : pr.y;
      }
      s_nv[i][q] = v;
    }
    __syncthreads();
    if (wc < cw) {
#pragma unroll 4
      for (int i = grp; i < cnt; i += WN_GROUPS) {
        const float v =
            to_f32(wsrc[static_cast<int64_t>(s_wrow[i]) * cw + wc]);
#pragma unroll
        for (int q = 0; q < WN_NARROW; ++q)
          acc[q] = fmaf(v, s_nv[i][q], acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < WN_NARROW; ++q) s_red[grp][q][c] = acc[q];
  __syncthreads();
  // the float32 route returns here in its blocks that write nothing;
  // K3-bf16's take part in the folded chunk reduction below
  if (grp != 0 || wc >= cw) {
    if constexpr (sizeof(E) == 4) return;
  } else {
#pragma unroll
    for (int q = 0; q < WN_NARROW; ++q) {
      if (cn0 + q >= cn) break;
      float s = s_red[0][q][c];
#pragma unroll
      for (int gr = 1; gr < WN_GROUPS; ++gr) s += s_red[gr][q][c];  // in order
      const int64_t at = y_narrow
                             ? static_cast<int64_t>(wc) * cy + cn0 + q
                             : static_cast<int64_t>(cn0 + q) * cy + wc;
      ch.dst[at] = s;
    }
  }
  if constexpr (sizeof(E) == 2) {
    // K3-bf16: the chunk reduction folded in, as in wg_wgmma_bf16
    const int k = blockIdx.y, filled = chunks_filled(counts[k], chunks);
    if (filled == 1 ||
        !last_arrival(arrivals + static_cast<int64_t>(k) * gridDim.x +
                          blockIdx.x, filled))
      return;
    const int64_t plane = static_cast<int64_t>(cx) * cy;
    const int nw = min(WN_WIDE, cw - cw0), nn = min(WN_NARROW, cn - cn0);
    const int rows = y_narrow ? nw : nn, cols = y_narrow ? nn : nw;
    const int64_t at = k * plane + (y_narrow ? static_cast<int64_t>(cw0) * cy
                                             + cn0
                                             : static_cast<int64_t>(cn0) * cy
                                             + cw0);
    for (int e = tid; e < rows * cols; e += WN_THREADS) {
      const int64_t o = at + static_cast<int64_t>(e / cols) * cy + e % cols;
      float s = __ldcg(ws + o);
      for (int z = 1; z < filled; ++z)
        s += __ldcg(ws + z * (gridDim.y * plane) + o);
      out[o] = s;
    }
  }
}

// grid (ceil(plane / 256), kk): G[k] = sum over the filled chunks z of
// ws[z][k], in order. An offset with one filled chunk was written by its
// block, and its reduction blocks return at once
__global__ void wg_reduce(const float* __restrict__ ws,
                          const int* __restrict__ counts, int chunks,
                          int64_t plane, float* __restrict__ out) {
  const int filled = chunks_filled(counts[blockIdx.y], chunks);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (filled == 1 || i >= plane) return;
  const int64_t total = gridDim.y * plane;
  const int64_t at = blockIdx.y * plane + i;
  float s = ws[at];
  for (int z = 1; z < filled; ++z) s += ws[z * total + at];
  out[at] = s;
}

// ---- launches ------------------------------------------------------------

// above 48 KB of shared memory only by request, once per device and kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  constexpr int kMaxDevices = 64;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

// the tensor-core launch for a bm x bn tile (with 3 slots of staged rows
// the 64 x 64 block still fits twice on an SM)
template <int BM, int BN>
cudaError_t launch_wgmma(dim3 grid, cudaStream_t s, const float* x, int cx,
                         const float* y, int cy, int64_t r, const int2* pairs,
                         const int* counts, int chunks, float* out,
                         float* ws) {
  using T = WgTile<BM, BN, WG_STAGES>;
  static bool done[64] = {};
  cudaError_t e = allow_smem(wg_wgmma<BM, BN, WG_STAGES>, T::kSmem, done);
  if (e != cudaSuccess) return e;
  wg_wgmma<BM, BN, WG_STAGES><<<grid, T::kThreads, T::kSmem, s>>>(
      x, cx, y, cy, r, pairs, counts, chunks, out, ws);
  return cudaGetLastError();
}

int64_t status_offset(int kk) { return (kk + 2) & ~1; }  // ints

int64_t pair_tiles(int64_t r) { return (r + WP_ROWS - 1) / WP_ROWS; }

// the memset of meta (its counts, ticket and status words, and `extra`
// words after them) and the pair pass
int launch_pairs(const uint8_t* x_mask, int64_t r, const int32_t* idx,
                 int kk, const uint8_t* y_mask, int64_t ny, int32_t* pairs,
                 int32_t* meta, int64_t extra, cudaStream_t s) {
  const int64_t ntiles = pair_tiles(r);
  const int64_t words = status_offset(kk) + 2 * kk * ntiles + extra;
  cudaError_t e = cudaMemsetAsync(meta, 0, sizeof(int32_t) * words, s);
  if (e != cudaSuccess || ntiles == 0) return static_cast<int>(e);
  const int kg = kk < WP_KGROUP ? kk : WP_KGROUP;
  wg_pairs<<<static_cast<unsigned>(ntiles), WP_ROWS,
             sizeof(int) * WP_ROWS * (kg | 1), s>>>(
      x_mask, r, idx, kk, y_mask, ny, static_cast<int>(ntiles),
      reinterpret_cast<int2*>(pairs), meta,
      reinterpret_cast<unsigned long long*>(meta + status_offset(kk)),
      meta + kk);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K3-bf16's tensor-core launch for a bm x bn tile
template <int BM, int BN>
cudaError_t launch_wgmma_bf16(dim3 grid, cudaStream_t s, const bf16_t* x,
                              int cx, const bf16_t* y, int cy, int64_t r,
                              const int2* pairs, const int* counts,
                              int chunks, float* out, float* ws,
                              int* arrivals) {
  using T = WbTile<BM, BN>;
  static bool done[64] = {};
  cudaError_t e = allow_smem(wg_wgmma_bf16<BM, BN>, T::kSmem, done);
  if (e != cudaSuccess) return e;
  wg_wgmma_bf16<BM, BN><<<grid, T::kThreads, T::kSmem, s>>>(
      x, cx, y, cy, r, pairs, counts, chunks, out, ws, arrivals);
  return cudaGetLastError();
}

// The call for operands of type E (see es_sparse_wgrad): float, or bf16_t
// (K3-bf16: its own tensor-core kernel, and the chunk reduction folded
// into the product's blocks)
template <typename E>
int sparse_wgrad(int narrow, const E* x, const uint8_t* x_mask, int64_t r,
                 int cx, const int32_t* idx, int kk, const E* y,
                 const uint8_t* y_mask, int64_t ny, int cy, int bm, int bn,
                 int chunks, int32_t* pairs, int32_t* meta, float* ws,
                 float* out, void* stream) {
  constexpr int V = 16 / sizeof(E);
  if (cx <= 0 || cy <= 0 || kk <= 0 || kk > 65535 || r < 0 ||
      r > 0x7fffffff || ny < 0 || chunks <= 0 || chunks > 65535 ||
      (chunks > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool y_narrow = bn == WN_NARROW;
  const bool tc_ok = (bm == 64 || bm == 128) && (bn == 64 || bn == 128) &&
                     cx % V == 0 && cy % V == 0 && aligned16(x) &&
                     aligned16(y);
  const bool narrow_ok = (bm == WN_WIDE && bn == WN_NARROW) ||
                         (bm == WN_NARROW && bn == WN_WIDE);
  if (narrow ? !narrow_ok : !tc_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = static_cast<int64_t>((cx + bm - 1) / bm) *
                        ((cy + bn - 1) / bn);
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool kBf16 = sizeof(E) == 2;
  // K3-bf16's arrival counters (kk x tiles) follow the status words
  const int64_t arrivals = kBf16 && chunks > 1 ? kk * tiles : 0;
  const int e = launch_pairs(x_mask, r, idx, kk, y_mask, ny, pairs, meta,
                             arrivals, s);
  if (e != 0) return e;
  const int2* pr = reinterpret_cast<const int2*>(pairs);
  const int* counts = meta;
  int* arr = meta + status_offset(kk) + 2 * kk * pair_tiles(r);
  float* dst_ws = chunks > 1 ? ws : nullptr;
  dim3 grid(static_cast<unsigned>(tiles), kk, chunks);
  cudaError_t err;
  if (narrow) {
    wg_narrow<E><<<grid, WN_THREADS, 0, s>>>(x, cx, y, cy, r, pr, counts,
                                             chunks, y_narrow, out, dst_ws,
                                             arr);
    err = cudaGetLastError();
  } else if constexpr (kBf16) {
    if (bm == 128 && bn == 128)
      err = launch_wgmma_bf16<128, 128>(grid, s, x, cx, y, cy, r, pr, counts,
                                        chunks, out, dst_ws, arr);
    else if (bm == 128)
      err = launch_wgmma_bf16<128, 64>(grid, s, x, cx, y, cy, r, pr, counts,
                                       chunks, out, dst_ws, arr);
    else if (bn == 128)
      err = launch_wgmma_bf16<64, 128>(grid, s, x, cx, y, cy, r, pr, counts,
                                       chunks, out, dst_ws, arr);
    else
      err = launch_wgmma_bf16<64, 64>(grid, s, x, cx, y, cy, r, pr, counts,
                                      chunks, out, dst_ws, arr);
  } else if (bm == 128 && bn == 128) {
    err = launch_wgmma<128, 128>(grid, s, x, cx, y, cy, r, pr, counts,
                                    chunks, out, dst_ws);
  } else if (bm == 128) {
    err = launch_wgmma<128, 64>(grid, s, x, cx, y, cy, r, pr, counts,
                                   chunks, out, dst_ws);
  } else if (bn == 128) {
    err = launch_wgmma<64, 128>(grid, s, x, cx, y, cy, r, pr, counts,
                                   chunks, out, dst_ws);
  } else {
    err = launch_wgmma<64, 64>(grid, s, x, cx, y, cy, r, pr, counts,
                                  chunks, out, dst_ws);
  }
  if (err != cudaSuccess || chunks == 1 || kBf16)
    return static_cast<int>(err);
  const int64_t plane = static_cast<int64_t>(cx) * cy;
  const int threads = 256;
  wg_reduce<<<dim3(static_cast<unsigned>((plane + threads - 1) / threads), kk),
              threads, 0, s>>>(ws, counts, chunks, plane, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3. x: (r, cx) f32; x_mask: (r,) bool bytes; idx: (r, kk) int32 rows of
// y; y: (ny, cy) f32; y_mask: (ny,) bool bytes; out: (kk, cx, cy) f32.
// pairs: (kk, r, 2) int32, receives offset k's n_k pairs (row,
// idx[row, k]) in ascending row; meta: int32 scratch of ((kk + 2) & ~1) +
// 2 kk ceil(r / 256) words of any content, receives n_k in its first kk
// words. narrow = 0: tensor cores, tiles of G
// bm x bn in {64, 128}, cx and cy multiples of 4, x and y 16-byte aligned;
// narrow = 1: FP32 FMAs, (bm, bn) = (64, 4) with y the narrow side or
// (4, 64) with x. chunks: pair chunks per offset (1-65535); ws: chunks x kk
// x cx x cy floats when chunks > 1, else null. All on the device,
// contiguous. The pair pass, the product and, with chunks > 1, the
// reduction, on `stream`; returns the first CUDA error (0 = none).
extern "C" int es_sparse_wgrad(int narrow, const float* x,
                               const uint8_t* x_mask, int64_t r, int cx,
                               const int32_t* idx, int kk, const float* y,
                               const uint8_t* y_mask, int64_t ny, int cy,
                               int bm, int bn, int chunks, int32_t* pairs,
                               int32_t* meta, float* ws, float* out,
                               void* stream) {
  return sparse_wgrad(narrow, x, x_mask, r, cx, idx, kk, y, y_mask, ny, cy,
                      bm, bn, chunks, pairs, meta, ws, out, stream);
}

// K3-bf16: the same call with x (r, cx) and y (ny, cy) as bfloat16 bits;
// accumulation, the chunk partials and out stay float32. The tensor-core
// route takes cx and cy multiples of 8. With chunks > 1, meta holds kk x
// tiles more words (the arrival counters of the folded reduction, tiles =
// ceil(cx / bm) x ceil(cy / bn)); no reduction kernel runs.
extern "C" int es_sparse_wgrad_bf16(int narrow, const bf16_t* x,
                                    const uint8_t* x_mask, int64_t r, int cx,
                                    const int32_t* idx, int kk,
                                    const bf16_t* y, const uint8_t* y_mask,
                                    int64_t ny, int cy, int bm, int bn,
                                    int chunks, int32_t* pairs, int32_t* meta,
                                    float* ws, float* out, void* stream) {
  return sparse_wgrad(narrow, x, x_mask, r, cx, idx, kk, y, y_mask, ny, cy,
                      bm, bn, chunks, pairs, meta, ws, out, stream);
}
