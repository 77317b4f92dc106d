// K2: per-point normals from segmented Morton-neighbourhood moments, as a
// tile-parallel segmented reduction (reduce, then scan across tiles).
//
// Replaces the TPU kernels chad_tsdf_tpu/ops/normals_pallas.py:
// estimate_normals_pallas (_fwd_kernel :80-130, _bwd_kernel :133-197).
// For Morton-sorted points, at depths d < nd a segment is a run of equal
// (block key, offset >> 3d); each point needs its segment's TOTAL of the 10
// moment features (1, x, y, z, xx, xy, xz, yy, yz, zz), taken relative to
// the first point of its coarsest (d = nd - 1) segment as in the plain
// version (ops/normals.py), then fits a plane at the smallest depth with
// >= min_points members (weighted determinants, normals.hpp:10-148), flips
// it toward the scanner and falls back to the point->scanner direction.
//
// What bounds it on the H100: bytes.  The function must read xyz + block
// key + offset (20 B) and write a normal (12 B) per point, 33.6 MB at
// N = 2^20, 0.010 ms at 3.35 TB/s; its ~200 flops per point are far below
// the f32 peak.  The design therefore keeps every segment total out of
// device memory:
//
// * pass 1 (normals_tile_kernel<false>): one CTA of 256 threads per tile of
//   1024 points, 4 consecutive points per thread, loaded coalesced.  The
//   tile forms the segment flags of every depth, finds its anchors (one
//   warp-wide galloping search per CTA for a coarse segment that began in an
//   earlier tile), and sums the 10 moments of its head piece (the points
//   before its first segment start) and tail piece (from its last one) per
//   depth, with warp shuffles only in the warps those pieces touch.  It
//   writes those sums and two flag bits per depth (f32[T, nd, 2, 10] and
//   i32[2T] with the anchor).
// * pass 2 (normals_combine_kernel): one warp per (tile, depth) whose tail
//   piece starts a segment that runs into later tiles; it adds the pieces in
//   tile order (32 tiles per step) and writes the segment's total back to
//   every tile it covers.
// * pass 3 (normals_tile_kernel<true>): the tile again: per depth, the
//   totals of every in-tile segment piece (sequentially over a thread's 4
//   points, a segmented scan with warp shuffles across lanes, one
//   shared-memory pass across the 8 warps, then each total broadcast back
//   to its members), with the head and tail segments' totals taken from
//   pass 2; a depth at which the whole tile is one segment that continues
//   into another tile takes pass 2's total with no scan.  A point's totals
//   at its fitting depth are kept in shared memory, and the depth loop stops
//   once every point of the tile has them; then each point fits its plane
//   once (a fit per point and depth would run up to nd fits per point in a
//   divergent warp), flips it and falls back.
//
// So a long segment costs what a short one does: its members are reduced by
// the whole tile, not one thread.  No per-point search, no per-point
// buffer; passes 1 and 3 each read the points once (the second read mostly
// from L2).  Every sum is taken in one fixed order, so the result is the
// same bit for bit on every run.  Built with -fmad=false so the fit is the
// same sequence of f32 operations as the plain version
// (ops/normals.py _plane_normal_from_moments).  What keeps it above its
// bound, as read from the code: instruction throughput, not bytes.  Per
// depth, 10 features go through a segmented scan of ~80 shuffles and four
// barriers per thread, and the points are read twice, each pass a
// short-lived CTA whose loads (and the head search) are latency the other
// CTAs of the SM must hide.
#include "common.cuh"

namespace chad {
namespace k2 {

constexpr int kThreads = 256;
constexpr int kPts = 4;                     // consecutive points per thread
constexpr int kTileN = kThreads * kPts;     // points per tile
constexpr int kWarps = kThreads / 32;
constexpr int kF = 10;                      // moment features
constexpr int kMaxDepth = 4;
constexpr unsigned kFull = 0xffffffffu;

// Per-depth shared state of the cross-lane / cross-warp steps.
struct DepthSmem {
  float wa[kWarps][kF];     // sum of each warp's last piece, within the warp
  float carry[kWarps][kF];  // what earlier warps add to a warp's first piece
  float last3[kWarps][kF];  // each warp's last prefix
  float he[kWarps][kF];     // end total of the piece entering each warp
                            // (pass 1: each warp's part of the head piece)
  float wt[kWarps][kF];     // total of the piece holding each warp's last
                            // point (pass 1: its part of the tail piece)
  unsigned hf[kWarps];      // lanes holding a piece start, per warp
  int lead[kWarps];         // the warp's first point starts a piece
  int fmin[kWarps];         // first in-range flag at tile index > 0
  int fmax[kWarps];         // last in-range flag
};

struct Smem {
  DepthSmem d[kMaxDepth];
  int coarse_last[kWarps];  // last coarse flag index of each warp
  int anchor;               // global index of the tile's head anchor
};

__device__ __forceinline__ void features(float rx, float ry, float rz,
                                         float* f) {
  f[0] = 1.0f;
  f[1] = rx;
  f[2] = ry;
  f[3] = rz;
  f[4] = rx * rx;
  f[5] = rx * ry;
  f[6] = rx * rz;
  f[7] = ry * ry;
  f[8] = ry * rz;
  f[9] = rz * rz;
}

__device__ __forceinline__ float max1e30(float x) { return fmaxf(x, 1e-30f); }

// Weighted-determinant plane normal from one segment's moments
// (ops/normals.py _plane_normal_from_moments, the same f32 sequence).
__device__ void plane_fit(const float* best, float* nrm) {
  const float recip = 1.0f / fmaxf(best[0], 1.0f);
  const float mx = best[1] * recip, my = best[2] * recip, mz = best[3] * recip;
  float xx = best[4] * recip - mx * mx;
  float xy = best[5] * recip - mx * my;
  float xz = best[6] * recip - mx * mz;
  float yy = best[7] * recip - my * my;
  float yz = best[8] * recip - my * mz;
  float zz = best[9] * recip - mz * mz;
  float m = fmaxf(fabsf(xx), fabsf(xy));
  m = fmaxf(m, fabsf(xz));
  m = fmaxf(m, fabsf(yy));
  m = fmaxf(m, fabsf(yz));
  m = fmaxf(m, fabsf(zz));
  const float msc = 1.0f / max1e30(m);
  xx = xx * msc; xy = xy * msc; xz = xz * msc;
  yy = yy * msc; yz = yz * msc; zz = zz * msc;

  const float det_x = yy * zz - yz * yz;
  const float ax0 = det_x, ax1 = xz * yz - xy * zz, ax2 = xy * yz - xz * yy;
  float w = det_x * det_x;
  float wx = ax0 * w, wy = ax1 * w, wz = ax2 * w;

  const float det_y = xx * zz - xz * xz;
  const float ay0 = xz * yz - xy * zz, ay1 = det_y, ay2 = xy * xz - yz * xx;
  w = det_y * det_y;
  if (wx * ay0 + wy * ay1 + wz * ay2 < 0.0f) w = -w;
  wx = wx + ay0 * w; wy = wy + ay1 * w; wz = wz + ay2 * w;

  const float det_z = xx * yy - xy * xy;
  const float az0 = xy * yz - xz * yy, az1 = xy * xz - yz * xx, az2 = det_z;
  w = det_z * det_z;
  if (wx * az0 + wy * az1 + wz * az2 < 0.0f) w = -w;
  wx = wx + az0 * w; wy = wy + az1 * w; wz = wz + az2 * w;

  const float norm = sqrtf(wx * wx + wy * wy + wz * wz);
  const float inv = 1.0f / max1e30(norm);
  nrm[0] = wx * inv;
  nrm[1] = wy * inv;
  nrm[2] = wz * inv;
}

__device__ __forceinline__ bool same_key(int b0, int o0, int b1, int o1,
                                         int sh) {
  return b0 == b1 && (o0 >> sh) == (o1 >> sh);
}

// Global index of the first point of the run of equal (bk, ok >> sh) that
// holds point s, where point s - 1 is known to be in it: warp-wide galloping
// search, 32 probes per round, the stride growing then shrinking by 32x.
// Called by one whole warp; every lane gets the result.
__device__ int run_head(const int* __restrict__ bk, const int* __restrict__ ok,
                        int s, int sh) {
  const int lane = threadIdx.x & 31;
  const int b = bk[s], o = ok[s];
  long long hi = s;          // key(hi) == key(s)
  long long step = 1;
  while (true) {
    const long long p = hi - (long long)(lane + 1) * step;
    const bool differs = p < 0 || !same_key(bk[p], ok[p], b, o, sh);
    const unsigned m = __ballot_sync(kFull, differs);
    if (m == 0) {
      // all 32 probes inside the run: widen (only before the first hit)
      hi -= 32 * step;
      step *= 32;
      continue;
    }
    const int l = __ffs(m) - 1;           // probe l differs, l - 1 does not
    if (step == 1) return (int)(hi - l);  // = p_l + 1
    hi -= (long long)l * step;            // = p_(l-1), still in the run
    step /= 32;
  }
}

// Reduces this thread's 4 points' features v (in place) to the total of the
// in-tile segment piece each point belongs to.  fl: bit j = point j starts a
// piece (tile index 0 and out-of-range points always do).
__device__ void piece_totals(float (&v)[kPts][kF], unsigned fl, DepthSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool anyf = fl != 0;
  const bool lead0 = fl & 1u;
  const int fj = anyf ? __ffs(fl) - 1 : kPts;        // first flag in lane
  const int lj = anyf ? 31 - __clz(fl) : 0;          // last flag (or 0)

  // 1. sequential segmented prefix over the thread's own points
#pragma unroll
  for (int j = 1; j < kPts; ++j) {
    if (!(fl & (1u << j))) {
#pragma unroll
      for (int c = 0; c < kF; ++c) v[j][c] = v[j - 1][c] + v[j][c];
    }
  }

  // 2. segmented inclusive scan of the lanes' last pieces (Hillis-Steele)
  const unsigned hf = __ballot_sync(kFull, anyf);
  const unsigned upto = lane == 31 ? kFull : ((2u << lane) - 1u);
  const unsigned below = hf & upto;
  const int sl = below ? 31 - __clz(below) : -1;     // last reset lane <= me
  float a[kF];
#pragma unroll
  for (int c = 0; c < kF; ++c) a[c] = v[kPts - 1][c];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool take = lane >= off && lane - off >= sl;
#pragma unroll
    for (int c = 0; c < kF; ++c) {
      const float y = __shfl_up_sync(kFull, a[c], off);
      if (take) a[c] = y + a[c];
    }
  }
  // the piece entering this lane from earlier lanes of the warp
  const bool from_lane = lane > 0 && !lead0;
#pragma unroll
  for (int c = 0; c < kF; ++c) {
    const float cin = __shfl_up_sync(kFull, a[c], 1);
    if (from_lane) {
#pragma unroll
      for (int j = 0; j < kPts; ++j)
        if (j < fj) v[j][c] = cin + v[j][c];
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kF; ++c) s.wa[warp][c] = a[c];
    s.hf[warp] = hf;
  }
  if (lane == 0) s.lead[warp] = lead0;
  __syncthreads();

  // 3. carries across warps, in warp order
  if (tid < kF) {
    float cy = 0.0f;
    for (int w = 1; w < kWarps; ++w) {
      cy = s.hf[w - 1] ? s.wa[w - 1][tid] : cy + s.wa[w - 1][tid];
      s.carry[w][tid] = cy;
    }
  }
  __syncthreads();
  if (warp > 0 && (hf & (upto >> 1)) == 0 && !(lane == 0 && lead0)) {
    // no piece starts in this warp before my first flag
#pragma unroll
    for (int c = 0; c < kF; ++c) {
      const float cy = s.carry[warp][c];
#pragma unroll
      for (int j = 0; j < kPts; ++j)
        if (j < fj) v[j][c] = cy + v[j][c];
    }
  }
  // v now holds in-tile inclusive prefixes

  // 4. totals: within the thread, backward
#pragma unroll
  for (int j = kPts - 2; j >= 0; --j) {
    if (!(fl & (1u << (j + 1)))) {
#pragma unroll
      for (int c = 0; c < kF; ++c) v[j][c] = v[j + 1][c];
    }
  }
  // E: total of the piece that enters this lane and ends in it
  const unsigned after = hf & ~upto;                 // flagged lanes > me
  const int src = after ? __ffs(after) - 1 : lane;
  const int first_lane = hf ? __ffs(hf) - 1 : 0;
  float e[kF];
#pragma unroll
  for (int c = 0; c < kF; ++c) {
    const float prev3 = __shfl_up_sync(kFull, v[kPts - 1][c], 1);
    e[c] = lead0 ? prev3 : v[0][c];
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < kF; ++c) s.last3[warp][c] = v[kPts - 1][c];
  }
  if (hf && lane == first_lane) {
#pragma unroll
    for (int c = 0; c < kF; ++c) s.he[warp][c] = e[c];
  }
#pragma unroll
  for (int c = 0; c < kF; ++c) {
    const float t = __shfl_sync(kFull, e[c], src);
    if (after) {
#pragma unroll
      for (int j = 0; j < kPts; ++j)
        if (j >= lj) v[j][c] = t;
    }
  }
  __syncthreads();

  // 5. the piece holding each warp's last point, in reverse warp order
  if (tid < kF) {
    float t = s.last3[kWarps - 1][tid];
    s.wt[kWarps - 1][tid] = t;
    for (int w = kWarps - 2; w >= 0; --w) {
      if (s.lead[w + 1]) t = s.last3[w][tid];
      else if (s.hf[w + 1]) t = s.he[w + 1][tid];
      s.wt[w][tid] = t;
    }
  }
  __syncthreads();
  if (!after) {
#pragma unroll
    for (int c = 0; c < kF; ++c) {
      const float t = s.wt[warp][c];
#pragma unroll
      for (int j = 0; j < kPts; ++j)
        if (j >= lj) v[j][c] = t;
    }
  }
}

// Passes 1 and 3.  part: f32[T, nd, 2, kF] head / tail piece sums;
// tot: f32[T, nd, 2, kF] head / tail segment totals (pass 2);
// meta: i32[2T] per tile: [flag bits (bit d: the tile's first point
// continues a depth-d segment of the tile before; bit 8 + d: the tile holds
// one depth-d piece), anchor index].
template <bool kFit>
__global__ void __launch_bounds__(kThreads, kFit ? 2 : 4)
normals_tile_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const int* __restrict__ bk,
                    const int* __restrict__ ok,
                    const float* __restrict__ position, int n, int nd,
                    float min_points, int vec, float* __restrict__ part,
                    const float* __restrict__ tot, int* __restrict__ meta,
                    float* __restrict__ out) {
  __shared__ Smem s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int t0 = tile * kTileN;
  const int base = tid * kPts;                 // tile index of point 0
  const long long i0 = (long long)t0 + base;
  const int n_in = min(kTileN, n - t0);        // in-range points of the tile

  float x[kPts], y[kPts], z[kPts];
  int b[kPts], o[kPts];
  if (vec && n_in == kTileN) {
    const float4 fx = reinterpret_cast<const float4*>(px + i0)[0];
    const float4 fy = reinterpret_cast<const float4*>(py + i0)[0];
    const float4 fz = reinterpret_cast<const float4*>(pz + i0)[0];
    const int4 ib = reinterpret_cast<const int4*>(bk + i0)[0];
    const int4 io = reinterpret_cast<const int4*>(ok + i0)[0];
    x[0] = fx.x; x[1] = fx.y; x[2] = fx.z; x[3] = fx.w;
    y[0] = fy.x; y[1] = fy.y; y[2] = fy.z; y[3] = fy.w;
    z[0] = fz.x; z[1] = fz.y; z[2] = fz.z; z[3] = fz.w;
    b[0] = ib.x; b[1] = ib.y; b[2] = ib.z; b[3] = ib.w;
    o[0] = io.x; o[1] = io.y; o[2] = io.z; o[3] = io.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const bool in = base + j < n_in;
      x[j] = in ? px[i0 + j] : 0.0f;
      y[j] = in ? py[i0 + j] : 0.0f;
      z[j] = in ? pz[i0 + j] : 0.0f;
      b[j] = in ? bk[i0 + j] : kInt32Max;
      o[j] = in ? ok[i0 + j] : 0;
    }
  }
  const bool has_prev = i0 > 0 && base < n_in;
  const int bprev = has_prev ? bk[i0 - 1] : 0;
  const int oprev = has_prev ? ok[i0 - 1] : 0;

  // flags: bit j of g[d] = point j starts a depth-d segment (global sense);
  // f[d] adds the tile start and the out-of-range points (in-tile pieces)
  unsigned g[kMaxDepth], f[kMaxDepth];
  for (int d = 0; d < nd; ++d) {
    const int sh = 3 * d;
    unsigned gd = 0, fd = 0;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const bool in = base + j < n_in;
      const bool start =
          j == 0 ? (!has_prev || !same_key(b[0], o[0], bprev, oprev, sh))
                 : !same_key(b[j], o[j], b[j - 1], o[j - 1], sh);
      if (in && start) gd |= 1u << j;
      if (!in || start || base + j == 0) fd |= 1u << j;
    }
    g[d] = gd;
    f[d] = fd;
  }

  // anchors: the first point of each point's coarsest segment
  const unsigned fc = f[nd - 1];
  int loc[kPts];
  {
    int run = -1;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (fc & (1u << j)) run = base + j;
      loc[j] = run;
    }
    const unsigned hf = __ballot_sync(kFull, fc != 0);
    const unsigned below = hf & ((1u << lane) - 1u);
    const int prev = __shfl_sync(kFull, run, below ? 31 - __clz(below) : lane);
    const int wlast = __reduce_max_sync(kFull, run);
    if (lane == 0) s.coarse_last[warp] = wlast;
    if (!kFit && warp == 0) {
      // tile head: a coarse segment begun in an earlier tile is anchored at
      // its first point, found by one search for the whole CTA
      const bool cont = t0 > 0 &&
          same_key(bk[t0], ok[t0], bk[t0 - 1], ok[t0 - 1], 3 * (nd - 1));
      const int h = cont ? run_head(bk, ok, t0, 3 * (nd - 1)) : t0;
      if (lane == 0) s.anchor = h;
    }
    if (kFit && tid == 0) s.anchor = meta[2 * tile + 1];
    __syncthreads();
    int cy = -1;
    for (int w = 0; w < warp; ++w) cy = max(cy, s.coarse_last[w]);
    const int carry_in = below ? prev : cy;
#pragma unroll
    for (int j = 0; j < kPts; ++j)
      if (loc[j] < 0) loc[j] = carry_in;
  }
  const int head_anchor = s.anchor;
  float rx[kPts], ry[kPts], rz[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const long long a = loc[j] == 0 ? head_anchor : (long long)t0 + loc[j];
    const bool in = base + j < n_in;
    rx[j] = in ? x[j] - px[a] : 0.0f;
    ry[j] = in ? y[j] - py[a] : 0.0f;
    rz[j] = in ? z[j] - pz[a] : 0.0f;
  }

  // first in-range piece start at tile index > 0 and last one, per depth
  for (int d = 0; d < nd; ++d) {
    int fmin = kTileN, fmax = 0;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (base + j < n_in && (f[d] & (1u << j))) {
        if (base + j > 0) fmin = min(fmin, base + j);
        fmax = max(fmax, base + j);
      }
    }
    fmin = __reduce_min_sync(kFull, fmin);
    fmax = __reduce_max_sync(kFull, fmax);
    if (lane == 0) {
      s.d[d].fmin[warp] = fmin;
      s.d[d].fmax[warp] = fmax;
    }
  }
  __syncthreads();
  int tmin[kMaxDepth], tmax[kMaxDepth];
  for (int d = 0; d < nd; ++d) {
    tmin[d] = kTileN;
    tmax[d] = 0;
    for (int w = 0; w < kWarps; ++w) {
      tmin[d] = min(tmin[d], s.d[d].fmin[w]);
      tmax[d] = max(tmax[d], s.d[d].fmax[w]);
    }
  }

  if (!kFit) {
    // pass 1 needs only the tile's head piece [0, tmin) and tail piece
    // [tmax, n_in) per depth: masked sums, reduced in the warps they touch
    float fe[kPts][kF];
#pragma unroll
    for (int j = 0; j < kPts; ++j) features(rx[j], ry[j], rz[j], fe[j]);
    const int w0 = warp * 32 * kPts, w1 = w0 + 32 * kPts;
    for (int d = 0; d < nd; ++d) {
      const bool whole = tmin[d] >= n_in;
      const bool in_head = w0 < tmin[d];
      const bool in_tail = !whole && w1 > tmax[d] && w0 < n_in;
#pragma unroll
      for (int c = 0; c < kF; ++c) {
        float h = 0.0f, t = 0.0f;
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          const int idx = base + j;
          if (idx < n_in && idx < tmin[d]) h = h + fe[j][c];
          if (idx < n_in && !whole && idx >= tmax[d]) t = t + fe[j][c];
        }
        if (in_head) {                    // uniform over the warp
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            h = h + __shfl_xor_sync(kFull, h, off);
        }
        if (in_tail) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            t = t + __shfl_xor_sync(kFull, t, off);
        }
        if (lane == 0) {
          s.d[d].he[warp][c] = in_head ? h : 0.0f;
          s.d[d].wt[warp][c] = in_tail ? t : 0.0f;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nd * kF; i += kThreads) {
      const int d = i / kF, c = i - d * kF;
      float h = 0.0f, t = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        h = h + s.d[d].he[w][c];
        t = t + s.d[d].wt[w][c];
      }
      float* pt = part + ((size_t)tile * nd + d) * 2 * kF;
      pt[c] = h;
      pt[kF + c] = tmin[d] >= n_in ? h : t;
    }
    if (tid == 0) {
      unsigned tflags = 0;
      for (int d = 0; d < nd; ++d) {
        if (t0 > 0 && !(g[d] & 1u)) tflags |= 1u << d;
        if (tmin[d] >= n_in) tflags |= 1u << (8 + d);
      }
      meta[2 * tile] = (int)tflags;
      meta[2 * tile + 1] = head_anchor;
    }
    return;
  }

  const int mflags = meta[2 * tile];
  const int nflags = tile + 1 < tiles ? meta[2 * (tile + 1)] : 0;
  // each point's moment totals at its fitting depth, fitted after the
  // depth loop: one plane fit per point, not one per point and depth
  __shared__ float best[kF][kPts][kThreads];
  bool found[kPts], fit[kPts];   // found: fitted or out of range
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    found[j] = base + j >= n_in;
    fit[j] = false;
  }

  for (int d = 0; d < nd; ++d) {
    const bool cp = (mflags >> d) & 1, cn = (nflags >> d) & 1;
    const float* tt = tot + ((size_t)tile * nd + d) * 2 * kF;
    float v[kPts][kF];
    if (((mflags >> (8 + d)) & 1) && (cp || cn)) {
      // one segment over the whole tile, begun or continued in another
      // tile: every point takes pass 2's total (uniform over the CTA)
      const float* src = cn ? tt + kF : tt;
#pragma unroll
      for (int j = 0; j < kPts; ++j)
#pragma unroll
        for (int c = 0; c < kF; ++c) v[j][c] = src[c];
    } else {
#pragma unroll
      for (int j = 0; j < kPts; ++j) {
        if (base + j < n_in) {
          features(rx[j], ry[j], rz[j], v[j]);
        } else {
#pragma unroll
          for (int c = 0; c < kF; ++c) v[j][c] = 0.0f;
        }
      }
      piece_totals(v, f[d], s.d[d]);
#pragma unroll
      for (int j = 0; j < kPts; ++j) {
        const int idx = base + j;
        const float* src = nullptr;
        if (cn && idx >= tmax[d]) src = tt + kF;     // tail segment total
        else if (cp && idx < tmin[d]) src = tt;      // head segment total
        if (src) {
#pragma unroll
          for (int c = 0; c < kF; ++c) v[j][c] = src[c];
        }
      }
    }
    bool all = true;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (!found[j] && v[j][0] >= min_points) {
#pragma unroll
        for (int c = 0; c < kF; ++c) best[c][j][tid] = v[j][c];
        found[j] = true;
        fit[j] = true;
      }
      all = all && found[j];
    }
    if (__syncthreads_and(all)) break;     // no later depth is needed
  }
  float nrm[kPts][3];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    if (fit[j]) {
      float m[kF];
#pragma unroll
      for (int c = 0; c < kF; ++c) m[c] = best[c][j][tid];
      plane_fit(m, nrm[j]);
    }
  }

  // flip toward the scanner and fallback (normals.hpp:117-134)
  const float qx = position[0], qy = position[1], qz = position[2];
  float ox[kPts], oy[kPts], oz[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    float tx = qx - x[j];
    float ty = qy - y[j];
    float tz = qz - z[j];
    const float tn = sqrtf(tx * tx + ty * ty + tz * tz);
    const float tinv = 1.0f / max1e30(tn);
    tx = tx * tinv; ty = ty * tinv; tz = tz * tinv;
    float nx = fit[j] ? nrm[j][0] : 0.0f;
    float ny = fit[j] ? nrm[j][1] : 0.0f;
    float nz = fit[j] ? nrm[j][2] : 0.0f;
    if (nx * tx + ny * ty + nz * tz < 0.0f) {
      nx = -nx; ny = -ny; nz = -nz;
    }
    const bool fb = !fit[j] || b[j] == kInt32Max;
    ox[j] = fb ? tx : nx;
    oy[j] = fb ? ty : ny;
    oz[j] = fb ? tz : nz;
  }
  if (vec && n_in == kTileN) {
    reinterpret_cast<float4*>(out + i0)[0] =
        make_float4(ox[0], ox[1], ox[2], ox[3]);
    reinterpret_cast<float4*>(out + n + i0)[0] =
        make_float4(oy[0], oy[1], oy[2], oy[3]);
    reinterpret_cast<float4*>(out + 2 * (size_t)n + i0)[0] =
        make_float4(oz[0], oz[1], oz[2], oz[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      if (base + j >= n_in) continue;
      out[i0 + j] = ox[j];
      out[(size_t)n + i0 + j] = oy[j];
      out[2 * (size_t)n + i0 + j] = oz[j];
    }
  }
}

// Pass 2: one warp per (tile, depth).  A warp whose tile's tail piece
// starts a segment that continues into the next tile adds the head pieces
// of the following tiles in tile order, 32 tiles per step (a fixed shuffle
// tree within a step), until the segment ends, then writes the total to
// tot[.., 1] of its tile and of every whole tile it crossed, and to
// tot[.., 0] of every later tile of the segment.
__global__ void __launch_bounds__(256)
normals_combine_kernel(const float* __restrict__ part,
                       const int* __restrict__ meta, int tiles, int nd,
                       float* __restrict__ tot) {
  const int lane = threadIdx.x & 31;
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= (long long)tiles * nd) return;
  const int t = (int)(w / nd), d = (int)(w % nd);
  if (t + 1 >= tiles) return;
  const int ft = meta[2 * t], fn = meta[2 * (t + 1)];
  const bool cont_next = (fn >> d) & 1;
  const bool passes = ((ft >> d) & 1) && ((ft >> (8 + d)) & 1);
  if (!cont_next || passes) return;            // uniform over the warp

  float acc[kF];
  const float* tl = part + ((size_t)t * nd + d) * 2 * kF + kF;
#pragma unroll
  for (int c = 0; c < kF; ++c) acc[c] = tl[c];
  int u0 = t + 1, end;
  while (true) {
    const int u = u0 + lane;
    const bool in = u < tiles;
    const int fu = in ? meta[2 * u] : 0;
    const int fu1 = (u + 1 < tiles) ? meta[2 * (u + 1)] : 0;
    const bool goes_on = in && ((fu >> (8 + d)) & 1) && ((fu1 >> d) & 1);
    const unsigned stop = __ballot_sync(kFull, !goes_on);
    const int nl = stop ? __ffs(stop) : 32;    // lanes < nl are in the run
    const float* hu = part + ((size_t)u * nd + d) * 2 * kF;
#pragma unroll
    for (int c = 0; c < kF; ++c) {
      float h = (in && lane < nl) ? hu[c] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        h = h + __shfl_xor_sync(kFull, h, off);
      acc[c] = acc[c] + __shfl_sync(kFull, h, 0);
    }
    if (stop) {
      end = u0 + nl - 1;
      break;
    }
    u0 += 32;
  }
  if (lane == 0) {
    float* tt = tot + ((size_t)t * nd + d) * 2 * kF + kF;
#pragma unroll
    for (int c = 0; c < kF; ++c) tt[c] = acc[c];
  }
  for (int v = t + 1 + lane; v <= end; v += 32) {
    float* tv = tot + ((size_t)v * nd + d) * 2 * kF;
#pragma unroll
    for (int c = 0; c < kF; ++c) {
      tv[c] = acc[c];
      if (v < end) tv[kF + c] = acc[c];
    }
  }
}

}  // namespace k2
}  // namespace chad

extern "C" int chad_estimate_normals(const float* px, const float* py,
                                     const float* pz, const int* bkey,
                                     const int* okey, const float* position,
                                     int n, int nd, float min_points,
                                     float* part, float* tot, int* meta,
                                     float* out, void* stream) {
  using namespace chad::k2;
  if (n <= 0) return 0;
  if (nd < 1 || nd > kMaxDepth) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kTileN - 1) / kTileN;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = n % 4 == 0 && aligned(px) && aligned(py) && aligned(pz) &&
                  aligned(bkey) && aligned(okey) && aligned(out);
  cudaStream_t st = (cudaStream_t)stream;
  normals_tile_kernel<false><<<tiles, kThreads, 0, st>>>(
      px, py, pz, bkey, okey, position, n, nd, min_points, vec, part, tot,
      meta, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)tiles * nd;
  const int blocks = (int)((warps * 32 + 255) / 256);
  normals_combine_kernel<<<blocks, 256, 0, st>>>(part, meta, tiles, nd, tot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  normals_tile_kernel<true><<<tiles, kThreads, 0, st>>>(
      px, py, pz, bkey, okey, position, n, nd, min_points, vec, part, tot,
      meta, out);
  CHAD_RETURN_LAUNCH_ERROR();
}
