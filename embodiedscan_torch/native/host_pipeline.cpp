// Native host data-pipeline core (C ABI, consumed via ctypes): the port's
// own copy of the reference package's core.
//
// The per-view depth -> points -> world chain (reference
// embodiedscan/datasets/transforms/points.py:30-81 back-projection,
// multiview.py:139-169 ego->global aggregation) is the hot host loop that
// feeds the card, so it runs here as compiled code fanned out over
// std::thread instead of GIL-bound numpy per view.
//
// Exactness contract (tests/test_torch_data.py): every entry point gives
// the reference package's core the same bytes. Back-projection and the
// world transform match the numpy pipeline (float64 inverse, float32
// output) to float32 round-off. Sampling is deterministic per seed via
// splitmix64, not numpy-RandomState-identical, by design.
//
// Build: embodiedscan_torch/native/__init__.py compiles this with
//   g++ -O3 -std=c++17 -shared -fPIC -pthread
// at first use and caches the .so beside a source hash.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// 4x4 inverse in double precision (Gauss-Jordan with partial pivoting) —
// mirrors the numpy path's float64 linalg.solve accuracy.
bool inv4(const double* m, double* out) {
  double a[4][8];
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      a[i][j] = m[i * 4 + j];
      a[i][j + 4] = (i == j) ? 1.0 : 0.0;
    }
  }
  for (int col = 0; col < 4; ++col) {
    int piv = col;
    for (int r = col + 1; r < 4; ++r)
      if (std::fabs(a[r][col]) > std::fabs(a[piv][col])) piv = r;
    if (a[piv][col] == 0.0) return false;
    if (piv != col)
      for (int j = 0; j < 8; ++j) std::swap(a[piv][j], a[col][j]);
    const double d = a[col][col];
    for (int j = 0; j < 8; ++j) a[col][j] /= d;
    for (int r = 0; r < 4; ++r) {
      if (r == col) continue;
      const double f = a[r][col];
      if (f == 0.0) continue;
      for (int j = 0; j < 8; ++j) a[r][j] -= f * a[col][j];
    }
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) out[i * 4 + j] = a[i][j + 4];
  return true;
}

// splitmix64: deterministic, seedable, fast.
inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline uint64_t bounded(uint64_t& s, uint64_t n) {
  // Lemire-style rejection-free enough for sampling quality here.
  return splitmix64(s) % n;
}

struct ViewTask {
  const float* depth;      // (h*w)
  const float* cam2img;    // 4x4 (or embedded 3x3/3x4 padded by caller)
  const float* global2ego; // 4x4 world->cam; nullptr = identity
  float depth_scale;       // divide raw depth by this (1.0 if pre-scaled)
  int h, w;
};

// Back-project one view's nonzero depths into world frame. Writes up to
// `cap` xyz rows into out (row-major v-major scan order, matching the
// numpy pipeline's reshape(-1) order). Returns the number of rows written.
int64_t backproject_view(const ViewTask& t, float* out, int64_t cap) {
  double k[16], kinv[16];
  for (int i = 0; i < 16; ++i) k[i] = t.cam2img[i];
  if (!inv4(k, kinv)) return -1;
  double c2w[16];
  if (t.global2ego) {
    double e[16];
    for (int i = 0; i < 16; ++i) e[i] = t.global2ego[i];
    if (!inv4(e, c2w)) return -1;
  } else {
    for (int i = 0; i < 16; ++i) c2w[i] = (i % 5 == 0) ? 1.0 : 0.0;
  }
  // fused (cam<-pix) then (world<-cam): world = c2w * kinv * [u*z, v*z, z, 1]
  double m[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double acc = 0;
      for (int l = 0; l < 4; ++l) acc += c2w[i * 4 + l] * kinv[l * 4 + j];
      m[i * 4 + j] = acc;
    }
  int64_t n = 0;
  for (int v = 0; v < t.h && n < cap; ++v) {
    const float* row = t.depth + (int64_t)v * t.w;
    for (int u = 0; u < t.w && n < cap; ++u) {
      float z = row[u];
      if (t.depth_scale != 1.0f) z /= t.depth_scale;
      if (!(z > 0.0f)) continue;
      const double uz = (double)u * z, vz = (double)v * z;
      float* o = out + n * 3;
      for (int i = 0; i < 3; ++i)
        o[i] = (float)(m[i * 4 + 0] * uz + m[i * 4 + 1] * vz +
                       m[i * 4 + 2] * z + m[i * 4 + 3]);
      ++n;
    }
  }
  return n;
}

}  // namespace

extern "C" {

// Fused multi-view depth -> world points, one std::thread per view.
//
// depths:      (V, H, W) float32 raw depth (already decoded)
// cam2imgs:    (V, 4, 4) float32
// global2egos: (V, 4, 4) float32 world->cam, or nullptr for identity
// depth_scale: divisor applied to every depth sample (1000/4000 shifts)
// out:         (V, cap, 3) float32
// counts:      (V,) int64 — valid rows per view
// Returns 0 on success, <0 on a singular matrix.
int es_multiview_backproject(const float* depths, const float* cam2imgs,
                             const float* global2egos, float depth_scale,
                             int64_t v, int64_t h, int64_t w, int64_t cap,
                             int n_threads, float* out, int64_t* counts) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= v) return;
      ViewTask t{depths + i * h * w, cam2imgs + i * 16,
                 global2egos ? global2egos + i * 16 : nullptr, depth_scale,
                 (int)h, (int)w};
      const int64_t n = backproject_view(t, out + i * cap * 3, cap);
      if (n < 0) err.store(-1);
      counts[i] = n < 0 ? 0 : n;
    }
  };
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > v) nt = (int)v;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return err.load();
}

// Deterministic row sampling: `num` indices out of n.
//   n >= num: sample WITHOUT replacement (partial Fisher-Yates over an
//             implicit arange, hashed storage-free variant).
//   n < num : sample WITH replacement.
// Matches point_sample's replace semantics (pipeline.py:61-68), not its
// bit stream.
void es_sample_indices(int64_t n, int64_t num, uint64_t seed, int64_t* out) {
  if (n <= 0) {
    for (int64_t i = 0; i < num; ++i) out[i] = 0;
    return;
  }
  uint64_t s = seed * 0x9e3779b97f4a7c15ULL + 0x2545f4914f6cdd1dULL;
  if (n < num) {
    for (int64_t i = 0; i < num; ++i) out[i] = (int64_t)bounded(s, n);
    return;
  }
  // partial Fisher-Yates via a sparse override map (num << n typical):
  // swap slot i with a random j in [i, n); overrides live in a small
  // open-addressing table keyed by slot.
  const int64_t tcap = 4 * num + 8;
  std::vector<int64_t> keys(tcap, -1), vals(tcap, 0);
  auto get = [&](int64_t slot) -> int64_t {
    uint64_t hsh = (uint64_t)slot * 0xff51afd7ed558ccdULL % (uint64_t)tcap;
    while (keys[hsh] != -1) {
      if (keys[hsh] == slot) return vals[hsh];
      hsh = (hsh + 1) % tcap;
    }
    return slot;
  };
  auto put = [&](int64_t slot, int64_t val) {
    uint64_t hsh = (uint64_t)slot * 0xff51afd7ed558ccdULL % (uint64_t)tcap;
    while (keys[hsh] != -1 && keys[hsh] != slot) hsh = (hsh + 1) % tcap;
    keys[hsh] = slot;
    vals[hsh] = val;
  };
  for (int64_t i = 0; i < num; ++i) {
    const int64_t j = i + (int64_t)bounded(s, (uint64_t)(n - i));
    const int64_t vi = get(i), vj = get(j);
    out[i] = vj;
    put(j, vi);
    put(i, vj);
  }
}

// Gather sampled rows: out[i] = pts[idx[i]] for (n,3) float32 rows.
void es_gather_rows3(const float* pts, const int64_t* idx, int64_t num,
                     float* out) {
  for (int64_t i = 0; i < num; ++i) {
    const float* src = pts + idx[i] * 3;
    float* dst = out + i * 3;
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
  }
}

// Image normalization: (N, 3) interleaved u8 -> (x - mean) / std float32,
// optional BGR->RGB channel swap, threaded over row blocks.
void es_normalize_u8(const uint8_t* src, int64_t n_px, const float* mean,
                     const float* std3, int bgr_to_rgb, int n_threads,
                     float* out) {
  const float inv0 = 1.0f / std3[0], inv1 = 1.0f / std3[1],
              inv2 = 1.0f / std3[2];
  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* p = src + i * 3;
      float r = p[0], g = p[1], b = p[2];
      if (bgr_to_rgb) std::swap(r, b);
      float* o = out + i * 3;
      o[0] = (r - mean[0]) * inv0;
      o[1] = (g - mean[1]) * inv1;
      o[2] = (b - mean[2]) * inv2;
    }
  };
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  const int64_t blk = (n_px + nt - 1) / nt;
  if (nt <= 1 || n_px < (1 << 16)) {
    run(0, n_px);
    return;
  }
  std::vector<std::thread> pool;
  for (int i = 0; i < nt; ++i) {
    const int64_t lo = i * blk, hi = std::min(n_px, lo + blk);
    if (lo >= hi) break;
    pool.emplace_back(run, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// uint16 depth decode + shift in one pass (loading.py depth/1000 or /4000).
void es_depth_u16_to_f32(const uint16_t* src, int64_t n, float scale,
                         float* out) {
  const float inv = 1.0f / scale;
  for (int64_t i = 0; i < n; ++i) out[i] = src[i] * inv;
}

}  // extern "C"
