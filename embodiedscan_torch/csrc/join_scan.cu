// Masked running-max scan of the sparse engine's merge join (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel embodiedscan_tpu/ops/pscan.py
// (_join_scan_pallas / _join_scan_kernel / _block_cummax). For each of K
// aux ranges [lo, hi) it emits the inclusive running max of the key
// (fill INT32_MIN) and of the aux (fill -1) over the rows whose aux lies in
// the range and whose key is not a batched sentinel (low `sbits` all ones
// after undoing the INT32_MIN bias flip).
//
// Bound on this card: memory. Each element is read once (8 B: key + aux) and
// written 2K times (8K B); no arithmetic worth counting. At the stem lookup
// (N ~ 1.9M, K = 1) that is ~30 MB, ~9 us at 3.35 TB/s, so at these sizes
// the three launches cost as much as the bytes.
//
// Design: the TPU version carries the running max across a sequential grid
// in scratch memory. GPU blocks run in no order, so the carry is spelled
// out in three passes:
//   1. js_block_max: each block reduces its tile to one masked (key, aux)
//      max per range;
//   2. js_carry: one small block turns the per-tile maxima into exclusive
//      carries (a serial max-scan over ~N/2048 entries per output);
//   3. js_scan: each block re-reads its tile, scans it (per-thread serial
//      prefix, warp shuffles, then shared memory across warps) and writes
//      max(carry, prefix).
// The input is read twice; a single pass with decoupled look-back would
// read it once and is left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define JS_THREADS 256
#define JS_ITEMS 8
#define JS_TILE (JS_THREADS * JS_ITEMS)
#define JS_MAXK 3
#define JS_WARPS (JS_THREADS / 32)

namespace {

constexpr int kIntMin = (-2147483647 - 1);

struct Ranges {
  int lo[JS_MAXK];
  int hi[JS_MAXK];
};

__device__ __forceinline__ bool keep_row(int key, int aux, int lo, int hi,
                                         int sbits) {
  bool ok = (aux >= lo) && (aux < hi);
  if (sbits != 0) {
    unsigned u = static_cast<unsigned>(key) ^ 0x80000000u;
    unsigned m = static_cast<unsigned>(sbits);
    ok = ok && ((u & m) != m);
  }
  return ok;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// Pass 1: per-tile masked maxima. tot layout: [2K][nblocks].
__global__ void js_block_max(const int* __restrict__ key,
                             const int* __restrict__ aux, int64_t n,
                             Ranges rg, int k, int sbits, int* __restrict__ tot) {
  __shared__ int red[2 * JS_MAXK][JS_WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * JS_TILE;
  int mk[JS_MAXK], ma[JS_MAXK];
#pragma unroll
  for (int r = 0; r < JS_MAXK; ++r) { mk[r] = kIntMin; ma[r] = -1; }
  for (int i = threadIdx.x; i < JS_TILE; i += JS_THREADS) {
    int64_t g = base + i;
    if (g >= n) break;
    int kv = key[g], av = aux[g];
#pragma unroll
    for (int r = 0; r < JS_MAXK; ++r) {
      if (r < k && keep_row(kv, av, rg.lo[r], rg.hi[r], sbits)) {
        mk[r] = max(mk[r], kv);
        ma[r] = max(ma[r], av);
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < JS_MAXK; ++r) {
    int a = warp_max(mk[r]), b = warp_max(ma[r]);
    if (lane == 0) { red[2 * r][warp] = a; red[2 * r + 1][warp] = b; }
  }
  __syncthreads();
  if (threadIdx.x < 2 * k) {
    int j = threadIdx.x;
    int v = red[j][0];
    for (int w = 1; w < JS_WARPS; ++w) v = max(v, red[j][w]);
    tot[static_cast<int64_t>(j) * gridDim.x + blockIdx.x] = v;
  }
}

// Pass 2: exclusive max-scan of the tile maxima, in place.
__global__ void js_carry(int* __restrict__ tot, int nblocks, int k) {
  int j = threadIdx.x;
  if (j >= 2 * k) return;
  int carry = (j & 1) ? -1 : kIntMin;
  int* row = tot + static_cast<int64_t>(j) * nblocks;
  for (int b = 0; b < nblocks; ++b) {
    int t = row[b];
    row[b] = carry;
    carry = max(carry, t);
  }
}

// Block-wide inclusive max-scan of one value per thread; returns the
// exclusive prefix (the max over lower threads), `fill` for thread 0.
__device__ __forceinline__ int block_exclusive_max(int v, int fill,
                                                   int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, inc, s);
    if (lane >= s) inc = max(inc, o);
  }
  int exc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) exc = fill;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int before = fill;
  for (int w = 0; w < warp; ++w) before = max(before, warp_tot[w]);
  __syncthreads();  // warp_tot is reused by the next call
  return max(before, exc);
}

// Pass 3: tile-local scan seeded with the tile's carry. out: [2K][n].
__global__ void js_scan(const int* __restrict__ key, const int* __restrict__ aux,
                        int64_t n, Ranges rg, int k, int sbits,
                        const int* __restrict__ carry, int* __restrict__ out) {
  __shared__ int warp_tot[JS_WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * JS_TILE +
                       static_cast<int64_t>(threadIdx.x) * JS_ITEMS;
  int kv[JS_ITEMS], av[JS_ITEMS];
#pragma unroll
  for (int i = 0; i < JS_ITEMS; ++i) {
    int64_t g = base + i;
    kv[i] = g < n ? key[g] : kIntMin;
    av[i] = g < n ? aux[g] : kIntMin;  // outside every range
  }
  for (int r = 0; r < k; ++r) {
    int pk[JS_ITEMS], pa[JS_ITEMS];
    int rk = kIntMin, ra = -1;
#pragma unroll
    for (int i = 0; i < JS_ITEMS; ++i) {
      if (keep_row(kv[i], av[i], rg.lo[r], rg.hi[r], sbits)) {
        rk = max(rk, kv[i]);
        ra = max(ra, av[i]);
      }
      pk[i] = rk;
      pa[i] = ra;
    }
    int ck = carry[static_cast<int64_t>(2 * r) * gridDim.x + blockIdx.x];
    int ca = carry[static_cast<int64_t>(2 * r + 1) * gridDim.x + blockIdx.x];
    int ek = max(ck, block_exclusive_max(rk, kIntMin, warp_tot));
    int ea = max(ca, block_exclusive_max(ra, -1, warp_tot));
    int* ok_ = out + static_cast<int64_t>(2 * r) * n;
    int* oa_ = out + static_cast<int64_t>(2 * r + 1) * n;
#pragma unroll
    for (int i = 0; i < JS_ITEMS; ++i) {
      int64_t g = base + i;
      if (g < n) {
        ok_[g] = max(ek, pk[i]);
        oa_[g] = max(ea, pa[i]);
      }
    }
  }
}

}  // namespace

extern "C" int es_join_scan_tile(void) { return JS_TILE; }

// key, aux: (n,) int32 device arrays; tot: (2k * ceil(n / tile),) int32
// scratch; out: (2k, n) int32. Returns the first CUDA error (0 = none).
extern "C" int es_join_scan(const int32_t* key, const int32_t* aux, int64_t n,
                            int k, int lo0, int hi0, int lo1, int hi1, int lo2,
                            int hi2, int sbits, int32_t* tot, int32_t* out,
                            void* stream) {
  if (k < 1 || k > JS_MAXK || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Ranges rg;
  rg.lo[0] = lo0; rg.hi[0] = hi0;
  rg.lo[1] = lo1; rg.hi[1] = hi1;
  rg.lo[2] = lo2; rg.hi[2] = hi2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t nblocks64 = (n + JS_TILE - 1) / JS_TILE;
  if (nblocks64 > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int nblocks = static_cast<int>(nblocks64);
  js_block_max<<<nblocks, JS_THREADS, 0, s>>>(key, aux, n, rg, k, sbits, tot);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  js_carry<<<1, 32, 0, s>>>(tot, nblocks, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  js_scan<<<nblocks, JS_THREADS, 0, s>>>(key, aux, n, rg, k, sbits, tot, out);
  return static_cast<int>(cudaGetLastError());
}
