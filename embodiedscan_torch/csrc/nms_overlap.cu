// Suppression matrix of the rotated 3D NMS (Hopper, sm_90a): kernel K4.
//
//   over[i, j] = j > i && label[i] == label[j] && iou(box i, box j) > thr
//
// with iou the exact IoU of two oriented 9-DoF boxes as the port's torch
// route (geometry/iou.py: boxes3d_overlap) computes it on a CUDA tensor,
// bit for bit: Sutherland-Hodgman clips of each box's 6 face quads against
// the other box's 6 half-spaces, the signed origin tetrahedra of the
// clipped faces, and the separating-axis bound of _axis_overlap_bound.
//
// Replaces no TPU kernel: the JAX package builds the matrix with XLA
// (embodiedscan_tpu/geometry/nms.py: boxes3d_iou over all K x K pairs, the
// label mask, triu). The torch route runs that as ~1,400 tensor operations
// per 2^18 pairs, each streaming a (10, 12 x 2^18) buffer: at K = 1024 about
// 5,500 launches and 195 device ms a request, where the pairs that matter
// are few.
//
// Bound on this card: operations, and only for the pairs that are clipped.
// A pair with j <= i or two labels is false; a pair whose separating-axis
// bound is exactly 0 has IoU exactly 0 (the torch route's volume is then
// min(max(vol, 0), 0)), so it is 0 > thr without a clip. The rest are
// clipped in full, in float32: 6.5k-7.3k multiplies, adds, subtracts and
// divides each (the NumPy model in tests/test_torch_nms_overlap.py counts
// them), against the 67 TFLOP/s of FP32 outside the tensor cores. The
// matrix written (K^2 bytes) and the per-box fields read (15 floats a box)
// weigh nothing.
//
// Design: one thread per pair, 32 j by 8 i per block, so each warp writes
// 32 consecutive bytes of a row of `over` and most warps exit after the
// label test. A thread that clips keeps its polygon in a 10-slot buffer per
// coordinate (4 corners + one vertex per clip, the torch route's
// _MAX_VERTS), compacted after each half-space as _clip_soa_body does:
// emitted vertices in order, an emission past slot 10 dropped, the count
// clamped to 10, the last active slot wrapping to slot 0.
//
// Numbers: every operation the torch route rounds is rounded here, in its
// order, with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which the
// compiler never contracts into an FMA. Where the torch route reduces a
// small axis, the order is that of PyTorch's CUDA reduction for the shape
// (Reduce.cuh): a reduced axis that is not the innermost one is summed by
// one thread from 4 accumulators (x0 + x4) + (x1 + x5) + x2 + x3 for the 6
// faces, x0 + x1 + x2 for 3 terms; the innermost axis of 3 is split over 2
// lanes, (x0 + x2) + x1. Division by the Python scalar 6.0 is, on CUDA, a
// product with its float reciprocal. torch.minimum / torch.maximum
// propagate NaN. The corners are computed here, as the torch route's
// batched product (box_corners' einsum, on cuBLAS) computes them at its
// batch of K x rows boxes from 65,536 up: each coordinate the plain sum
// l0 r0 + l1 r1 + l2 r2, no FMA (measured on an H100 with torch 2.11 and
// CUDA 12.8; up to 16,384 cuBLAS takes a kernel that chains FMAs, so for
// K < 256 the torch route's own corners differ by an ulp). K = 1024 on the
// det request and 256 in the benchmark's reference are both above it.
//
// Counters: counts[0] += pairs clipped, counts[1] += pairs given (j > i),
// one atomic each per block; the caller owns and reads the buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#define NMS_BX 32
#define NMS_BY 8
#define NMS_SLOTS 10
// per-box fields (geometry/iou.py:nms_fields): the rotation matrix
// (row-major), center, sizes
#define F_ROT 0
#define F_CENTER 9
#define F_SIZE 12
#define NMS_FIELDS 15

namespace {

// outward-wound face quads of the reference's corner order (iou.py _FACE_IDX)
__constant__ int kFace[6][4] = {{0, 1, 2, 3}, {4, 7, 6, 5}, {0, 4, 5, 1},
                                {3, 2, 6, 7}, {0, 3, 7, 4}, {1, 5, 6, 2}};
// the corners in units of the sizes (boxes.py _CORNERS_NORM)
__constant__ float kCorner[8][3] = {
    {-0.5f, -0.5f, -0.5f}, {-0.5f, -0.5f, 0.5f}, {-0.5f, 0.5f, 0.5f},
    {-0.5f, 0.5f, -0.5f},  {0.5f, -0.5f, -0.5f}, {0.5f, -0.5f, 0.5f},
    {0.5f, 0.5f, 0.5f},    {0.5f, 0.5f, -0.5f}};

// the torch route's Python scalars, rounded to float as PyTorch rounds them
constexpr float kDenomEps = static_cast<float>(1e-12);
constexpr float kKeepTol = static_cast<float>(1e-5);
constexpr float kCoplTol = static_cast<float>(3e-5);
constexpr float kUnionEps = static_cast<float>(1e-8);
constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.minimum / torch.maximum
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
// iou.py _abs: where(x >= 0, x, -x)
__device__ __forceinline__ float tabs(float a) { return a >= 0.0f ? a : -a; }

// x0 * y0 + x1 * y1 + x2 * y2, summed in order
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1,
                                      float x2, float y2) {
  return add(add(mul(x0, y0), mul(x1, y1)), mul(x2, y2));
}

// One frame of _axis_overlap_bound: the overlap of the two boxes' extents
// along each axis of `own`, multiplied.
__device__ float frame_bound(const float* own, const float* oth) {
  const float* ra = own + F_ROT;
  const float* rb = oth + F_ROT;
  float len[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p_own = dot3(own[F_CENTER], ra[k], own[F_CENTER + 1],
                             ra[3 + k], own[F_CENTER + 2], ra[6 + k]);
    const float p_oth = dot3(oth[F_CENTER], ra[k], oth[F_CENTER + 1],
                             ra[3 + k], oth[F_CENTER + 2], ra[6 + k]);
    float m[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      const float dt = tabs(dot3(ra[k], rb[l], ra[3 + k], rb[3 + l],
                                 ra[6 + k], rb[6 + l]));
      m[l] = mul(dt, mul(oth[F_SIZE + l], 0.5f));
    }
    const float w = add(add(m[0], m[2]), m[1]);  // innermost axis of 3
    const float h = mul(own[F_SIZE + k], 0.5f);
    const float hi = tmin(add(p_own, h), add(p_oth, w));
    const float lo = tmax(sub(p_own, h), sub(p_oth, w));
    len[k] = tmax(sub(hi, lo), 0.0f);
  }
  return mul(mul(len[0], len[2]), len[1]);  // innermost axis of 3
}

// _soa_planes' offset of face j: n . center + half size, n = +-column j % 3
__device__ __forceinline__ float plane_offset(const float* box, int j) {
  const float s = j < 3 ? 1.0f : -1.0f;
  const int c = j % 3;
  const float* r = box + F_ROT;
  return add(dot3(s * r[c], box[F_CENTER], s * r[3 + c], box[F_CENTER + 1],
                  s * r[6 + c], box[F_CENTER + 2]),
             mul(box[F_SIZE + c], 0.5f));
}

// boxes.py corners: rot @ (size * norm) + center
__device__ void box_corners(const float* box, float (&c)[8][3]) {
  const float* r = box + F_ROT;
#pragma unroll 1
  for (int m = 0; m < 8; ++m) {
    const float l0 = mul(box[F_SIZE], kCorner[m][0]);
    const float l1 = mul(box[F_SIZE + 1], kCorner[m][1]);
    const float l2 = mul(box[F_SIZE + 2], kCorner[m][2]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      c[m][i] = add(dot3(l0, r[3 * i], l1, r[3 * i + 1], l2, r[3 * i + 2]),
                    box[F_CENTER + i]);
  }
}

// One half-space clip n . p <= d of the polygon in the first `cnt` slots
// (_clip_soa_body on one lane).
__device__ __forceinline__ void clip(float (&vx)[NMS_SLOTS],
                                     float (&vy)[NMS_SLOTS],
                                     float (&vz)[NMS_SLOTS], int& cnt,
                                     float nx, float ny, float nz, float d) {
  float ds[NMS_SLOTS];
#pragma unroll
  for (int s = 0; s < NMS_SLOTS; ++s)
    ds[s] = sub(dot3(vx[s], nx, vy[s], ny, vz[s], nz), d);
  float ox[NMS_SLOTS], oy[NMS_SLOTS], oz[NMS_SLOTS];
  int run = 0;
#pragma unroll
  for (int s = 0; s < NMS_SLOTS; ++s) {
    if (s < cnt) {
      // the next slot, or slot 0 after the last active one (s + 1 < cnt
      // implies s + 1 < NMS_SLOTS; sn keeps the index static)
      const int sn = s + 1 < NMS_SLOTS ? s + 1 : 0;
      const bool wrap = s + 1 < cnt;
      const float d_n = wrap ? ds[sn] : ds[0];
      const bool cur_in = ds[s] <= 0.0f;
      const bool nxt_in = d_n <= 0.0f;
      if (cur_in) {
        if (run < NMS_SLOTS) {
          ox[run] = vx[s];
          oy[run] = vy[s];
          oz[run] = vz[s];
        }
        ++run;
      }
      if (cur_in != nxt_in) {
        const float denom = sub(ds[s], d_n);
        const float t =
            __fdiv_rn(ds[s], fabsf(denom) > kDenomEps ? denom : kDenomEps);
        const float x_n = wrap ? vx[sn] : vx[0];
        const float y_n = wrap ? vy[sn] : vy[0];
        const float z_n = wrap ? vz[sn] : vz[0];
        if (run < NMS_SLOTS) {
          ox[run] = add(vx[s], mul(t, sub(x_n, vx[s])));
          oy[run] = add(vy[s], mul(t, sub(y_n, vy[s])));
          oz[run] = add(vz[s], mul(t, sub(z_n, vz[s])));
        }
        ++run;
      }
    }
  }
  cnt = run < NMS_SLOTS ? run : NMS_SLOTS;
#pragma unroll
  for (int s = 0; s < NMS_SLOTS; ++s) {
    if (s < cnt) {
      vx[s] = ox[s];
      vy[s] = oy[s];
      vz[s] = oz[s];
    }
  }
}

// Signed volume of `own`'s 6 faces clipped by the half-spaces n_j . p <=
// d[j] (_clipped_volume_soa for one box of a pair).
__device__ float clipped_volume(const float* own, const float (&n)[6][3],
                                const float (&d)[6]) {
  float corner[8][3];
  box_corners(own, corner);
  float face_vol[6];
#pragma unroll 1
  for (int f = 0; f < 6; ++f) {
    float vx[NMS_SLOTS], vy[NMS_SLOTS], vz[NMS_SLOTS];
#pragma unroll
    for (int s = 0; s < NMS_SLOTS; ++s) {
      const int c = s < 4 ? kFace[f][s] : -1;
      vx[s] = c >= 0 ? corner[c][0] : 0.0f;
      vy[s] = c >= 0 ? corner[c][1] : 0.0f;
      vz[s] = c >= 0 ? corner[c][2] : 0.0f;
    }
    int cnt = 4;
#pragma unroll 1
    for (int j = 0; j < 6; ++j)
      clip(vx, vy, vz, cnt, n[j][0], n[j][1], n[j][2], d[j]);
    float acc = 0.0f;
#pragma unroll
    for (int i = 1; i < NMS_SLOTS - 1; ++i) {
      const float cx = sub(mul(vy[i], vz[i + 1]), mul(vz[i], vy[i + 1]));
      const float cy = sub(mul(vz[i], vx[i + 1]), mul(vx[i], vz[i + 1]));
      const float cz = sub(mul(vx[i], vy[i + 1]), mul(vy[i], vx[i + 1]));
      const float det = dot3(cx, vx[0], cy, vy[0], cz, vz[0]);
      acc = add(acc, i + 1 < cnt ? det : 0.0f);
    }
    face_vol[f] = acc;
  }
  // the sum over the 6 faces (a reduced axis that is not the innermost)
  const float sum = add(add(add(add(face_vol[0], face_vol[4]),
                                add(face_vol[1], face_vol[5])),
                            face_vol[2]),
                        face_vol[3]);
  return mul(sum, kSixth);
}

// The normals and offsets of `box`'s half-spaces, offsets moved by `shift`
// (added, or subtracted with `minus`).
__device__ __forceinline__ void half_spaces(const float* box,
                                            const float (&off)[6],
                                            float shift, bool minus,
                                            float (&n)[6][3], float (&d)[6]) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float s = j < 3 ? 1.0f : -1.0f;
    const int c = j % 3;
    n[j][0] = s * box[F_ROT + c];
    n[j][1] = s * box[F_ROT + 3 + c];
    n[j][2] = s * box[F_ROT + 6 + c];
    d[j] = minus ? sub(off[j], shift) : add(off[j], shift);
  }
}

// The pair's IoU where its separating-axis bound is `bound` (not 0):
// _intersection_volume_flat and boxes3d_overlap's quotient.
__device__ float pair_iou(const float* a, const float* b, float bound) {
  float off_a[6], off_b[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    off_a[j] = plane_offset(a, j);
    off_b[j] = plane_offset(b, j);
  }
  // functools.reduce(torch.maximum, |da| + |db|): max is exact in any order
  float big = tabs(off_a[0]);
#pragma unroll
  for (int j = 1; j < 6; ++j) big = tmax(big, tabs(off_a[j]));
#pragma unroll
  for (int j = 0; j < 6; ++j) big = tmax(big, tabs(off_b[j]));
  const float scale = add(big, 1.0f);
  float n[6][3], d[6];
  // a's faces against b's half-spaces widened by eps_keep, b's against a's
  // narrowed by eps_copl: coplanar faces count once
  half_spaces(b, off_b, mul(scale, kKeepTol), false, n, d);
  const float vol_a = clipped_volume(a, n, d);
  half_spaces(a, off_a, mul(scale, kCoplTol), true, n, d);
  const float vol_b = clipped_volume(b, n, d);
  const float vol = tmin(tmax(add(vol_a, vol_b), 0.0f), bound);
  const float v1 = fabsf(mul(mul(a[F_SIZE], a[F_SIZE + 1]), a[F_SIZE + 2]));
  const float v2 = fabsf(mul(mul(b[F_SIZE], b[F_SIZE + 1]), b[F_SIZE + 2]));
  const float uni = sub(add(v1, v2), vol);
  // torch.clamp(union, min=1e-8), NaN kept
  return __fdiv_rn(vol, (uni != uni || uni >= kUnionEps) ? uni : kUnionEps);
}

__global__ void __launch_bounds__(NMS_BX * NMS_BY)
nms_overlap(const float* __restrict__ box, const int* __restrict__ label,
            int k, float thr, uint8_t* __restrict__ over,
            unsigned long long* __restrict__ counts) {
  __shared__ unsigned block_counts[2];
  const int tid = threadIdx.y * NMS_BX + threadIdx.x;
  if (tid < 2) block_counts[tid] = 0;
  __syncthreads();
  const int j = blockIdx.x * NMS_BX + threadIdx.x;
  const int i = blockIdx.y * NMS_BY + threadIdx.y;
  const bool inside = i < k && j < k;
  const bool given = inside && j > i;
  bool res = false, clipped = false;
  if (given && (label == nullptr || label[i] == label[j])) {
    const float* a = box + static_cast<int64_t>(i) * NMS_FIELDS;
    const float* b = box + static_cast<int64_t>(j) * NMS_FIELDS;
    const float bound = tmin(frame_bound(a, b), frame_bound(b, a));
    if (bound == 0.0f) {
      res = 0.0f > thr;
    } else {
      clipped = true;
      res = pair_iou(a, b, bound) > thr;
    }
  }
  if (inside) over[static_cast<int64_t>(i) * k + j] = res ? 1 : 0;
  // one warp is one row segment: count by ballot, then once per block
  const unsigned g = __ballot_sync(0xffffffffu, given);
  const unsigned c = __ballot_sync(0xffffffffu, clipped);
  if (threadIdx.x == 0 && g != 0) {
    atomicAdd(&block_counts[0], static_cast<unsigned>(__popc(c)));
    atomicAdd(&block_counts[1], static_cast<unsigned>(__popc(g)));
  }
  __syncthreads();
  if (tid == 0 && block_counts[1] != 0) {
    atomicAdd(&counts[0], static_cast<unsigned long long>(block_counts[0]));
    atomicAdd(&counts[1], static_cast<unsigned long long>(block_counts[1]));
  }
}

}  // namespace

// box: (k, 15) float32 per-box fields; label: (k,) int32, or null for one
// class; over: (k, k) bytes, receives 0 / 1; counts: 2 uint64 the kernel
// adds to (pairs clipped, pairs given). All on the device, contiguous. One
// launch on `stream`; returns the CUDA error (0 = none).
extern "C" int es_nms_overlap(const float* box, const int* label, int k,
                              float thr, uint8_t* over,
                              unsigned long long* counts, void* stream) {
  if (k <= 0 || box == nullptr || over == nullptr || counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(NMS_BX, NMS_BY);
  const int64_t gy = (static_cast<int64_t>(k) + NMS_BY - 1) / NMS_BY;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((k + NMS_BX - 1) / NMS_BX, static_cast<unsigned>(gy));
  nms_overlap<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      box, label, k, thr, over, counts);
  return static_cast<int>(cudaGetLastError());
}
