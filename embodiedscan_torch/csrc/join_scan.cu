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
// every extra launch and every second read of the input costs as much as
// the bytes.
//
// Design: one launch, one read of the input (single-pass scan with
// decoupled look-back, Merrill & Garland 2016). The TPU version carries the
// running max across a sequential grid in scratch memory; GPU blocks run in
// no order, so each block
//   1. takes its tile from an atomic ticket (not blockIdx), so a tile only
//      ever waits on tiles whose blocks are already running;
//   2. loads its 2048 rows coalesced, transposes them through shared memory
//      and reduces them per thread, per warp and per block, one masked
//      (key, aux) max per range: 2K values;
//   3. publishes each value's tile aggregate, then, after looking back over
//      its predecessors' words (one warp, 32 tiles at a time, stopping at
//      the first inclusive prefix), its inclusive prefix. Flag and value
//      share one 64-bit word written by one store, so a reader never sees a
//      flag without its value;
//   4. writes max(exclusive prefix, running max within the tile), again
//      transposed through shared memory so the stores are coalesced.
// The status words and the ticket are scratch the wrapper allocates per
// call; the entry point clears them with one memset before the launch (a
// zero word reads as not ready). A call that fits one tile does no
// look-back and needs neither: one launch and nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

#define JS_THREADS 256
#define JS_ITEMS 8
#define JS_TILE (JS_THREADS * JS_ITEMS)
#define JS_MAXK 3
#define JS_WARPS (JS_THREADS / 32)
// shared-memory index with one pad word per 32: the blocked reads
// (thread t, item i at t * 8 + i) then hit 32 distinct banks
#define JS_PAD(e) ((e) + ((e) >> 5))

namespace {

constexpr int kIntMin = (-2147483647 - 1);
// status word: flag (bits 32-33; 0 = not ready), value (0-31)
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kInclusive = 2;

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

// Max over all tiles before `tile` of value j, by looking back over the
// status words (row j of [2K][nblocks]). Called by one whole warp.
__device__ int look_back(const unsigned long long* status, int tile,
                         int fill) {
  const int lane = threadIdx.x & 31;
  int excl = fill;
  for (int pred = tile - 1;; pred -= 32) {
    const int idx = pred - lane;  // lane 0 is the nearest predecessor
    unsigned long long w = pack(kInclusive, fill);  // before tile 0
    if (idx >= 0) {
      do {
        w = load_status(status + idx);
      } while (flag_of(w) == 0);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, flag_of(w) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    excl = max(excl, warp_max(lane <= stop ? static_cast<int>(w) : fill));
    if (incl) return excl;
  }
}

// status: [2K][nblocks] 64-bit words and ticket, all 0 at launch, or both
// null when nblocks == 1. out: [2K][n].
__global__ void __launch_bounds__(JS_THREADS)
js_scan(const int* __restrict__ key, const int* __restrict__ aux, int64_t n,
        Ranges rg, int k, int sbits, unsigned long long* status, int* ticket,
        int nblocks, int* __restrict__ out) {
  __shared__ int sk[JS_PAD(JS_TILE)], sa[JS_PAD(JS_TILE)];
  __shared__ int warp_tot[2 * JS_MAXK][JS_WARPS];
  __shared__ int tile_excl[2 * JS_MAXK];
  __shared__ int tile_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    tile_s = ticket != nullptr ? atomicAdd(ticket, 1) : 0;
  }
  __syncthreads();
  const int tile = tile_s;
  const int64_t base = static_cast<int64_t>(tile) * JS_TILE;

  // 1. coalesced load, blocked read: thread t holds rows t * 8 .. t * 8 + 7
#pragma unroll
  for (int i = 0; i < JS_ITEMS; ++i) {
    const int e = i * JS_THREADS + tid;
    const int64_t g = base + e;
    sk[JS_PAD(e)] = g < n ? key[g] : kIntMin;
    sa[JS_PAD(e)] = g < n ? aux[g] : kIntMin;  // outside every range
  }
  __syncthreads();
  int kv[JS_ITEMS], av[JS_ITEMS];
#pragma unroll
  for (int i = 0; i < JS_ITEMS; ++i) {
    const int e = tid * JS_ITEMS + i;
    kv[i] = sk[JS_PAD(e)];
    av[i] = sa[JS_PAD(e)];
  }

  // 2. per thread and per warp: exclusive prefix within the warp, warp totals
  int exc[2 * JS_MAXK];
#pragma unroll
  for (int r = 0; r < JS_MAXK; ++r) {
    if (r >= k) break;
    int tot[2] = {kIntMin, -1};
#pragma unroll
    for (int i = 0; i < JS_ITEMS; ++i) {
      if (keep_row(kv[i], av[i], rg.lo[r], rg.hi[r], sbits)) {
        tot[0] = max(tot[0], kv[i]);
        tot[1] = max(tot[1], av[i]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fill = h ? -1 : kIntMin;
      int inc = tot[h];
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, s);
        if (lane >= s) inc = max(inc, o);
      }
      const int e = __shfl_up_sync(0xffffffffu, inc, 1);
      exc[2 * r + h] = lane == 0 ? fill : e;
      if (lane == 31) warp_tot[2 * r + h][warp] = inc;
    }
  }
  __syncthreads();

  // 3. one warp: publish the tile aggregates, look back, publish prefixes
  if (warp == 0) {
    int agg[2 * JS_MAXK];
#pragma unroll
    for (int j = 0; j < 2 * JS_MAXK; ++j) {
      if (j >= 2 * k) break;
      const int fill = (j & 1) ? -1 : kIntMin;
      agg[j] = warp_max(lane < JS_WARPS ? warp_tot[j][lane] : fill);
      if (status != nullptr && lane == 0)
        store_status(status + static_cast<int64_t>(j) * nblocks + tile,
                     pack(tile == 0 ? kInclusive : kAggregate, agg[j]));
    }
#pragma unroll
    for (int j = 0; j < 2 * JS_MAXK; ++j) {
      if (j >= 2 * k) break;
      const int fill = (j & 1) ? -1 : kIntMin;
      int excl = fill;
      if (tile > 0) {
        unsigned long long* row = status + static_cast<int64_t>(j) * nblocks;
        excl = look_back(row, tile, fill);
        if (lane == 0)
          store_status(row + tile, pack(kInclusive, max(excl, agg[j])));
      }
      if (lane == 0) tile_excl[j] = excl;
    }
  }
  __syncthreads();

  // 4. outputs per range, written back through shared memory
#pragma unroll
  for (int r = 0; r < JS_MAXK; ++r) {
    if (r >= k) break;
    int run[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * r + h;
      int v = max(tile_excl[j], exc[j]);
      for (int w = 0; w < warp; ++w) v = max(v, warp_tot[j][w]);
      run[h] = v;
    }
    __syncthreads();  // the previous range's stores have read sk / sa
#pragma unroll
    for (int i = 0; i < JS_ITEMS; ++i) {
      if (keep_row(kv[i], av[i], rg.lo[r], rg.hi[r], sbits)) {
        run[0] = max(run[0], kv[i]);
        run[1] = max(run[1], av[i]);
      }
      const int e = tid * JS_ITEMS + i;
      sk[JS_PAD(e)] = run[0];
      sa[JS_PAD(e)] = run[1];
    }
    __syncthreads();
    int* ok_ = out + static_cast<int64_t>(2 * r) * n;
    int* oa_ = out + static_cast<int64_t>(2 * r + 1) * n;
#pragma unroll
    for (int i = 0; i < JS_ITEMS; ++i) {
      const int e = i * JS_THREADS + tid;
      const int64_t g = base + e;
      if (g < n) {
        ok_[g] = sk[JS_PAD(e)];
        oa_[g] = sa[JS_PAD(e)];
      }
    }
  }
}

}  // namespace

extern "C" int es_join_scan_tile(void) { return JS_TILE; }

// key, aux: (n,) int32 device arrays; scratch: 2k * ceil(n / tile) + 1
// 64-bit words of any content (the status words, then the ticket), or null
// when n <= tile; out: (2k, n) int32. One memset of the scratch (none when
// n <= tile) and one launch. Returns the CUDA error (0 = none).
extern "C" int es_join_scan(const int32_t* key, const int32_t* aux, int64_t n,
                            int k, int lo0, int hi0, int lo1, int hi1, int lo2,
                            int hi2, int sbits, unsigned long long* scratch,
                            int32_t* out, void* stream) {
  if (k < 1 || k > JS_MAXK || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Ranges rg;
  rg.lo[0] = lo0; rg.hi[0] = hi0;
  rg.lo[1] = lo1; rg.hi[1] = hi1;
  rg.lo[2] = lo2; rg.hi[2] = hi2;
  int64_t nblocks64 = (n + JS_TILE - 1) / JS_TILE;
  if (nblocks64 > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int nblocks = static_cast<int>(nblocks64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* status = nullptr;
  int* ticket = nullptr;
  if (nblocks > 1) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t words = 2 * static_cast<int64_t>(k) * nblocks;
    cudaError_t e = cudaMemsetAsync(scratch, 0, 8 * (words + 1), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    status = scratch;
    ticket = reinterpret_cast<int*>(scratch + words);
  }
  js_scan<<<nblocks, JS_THREADS, 0, s>>>(key, aux, n, rg, k, sbits, status,
                                         ticket, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}
