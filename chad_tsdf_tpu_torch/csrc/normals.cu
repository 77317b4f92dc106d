// K2: per-point normals from segmented Morton-neighbourhood moments.
//
// Replaces the TPU kernels chad_tsdf_tpu/ops/normals_pallas.py:
// estimate_normals_pallas (_fwd_kernel :80-130, _bwd_kernel :133-197).
// For Morton-sorted points, at depths d < nd a segment is a run of equal
// (block key, offset >> 3d).  Each point needs only its segment's TOTAL of
// the 10 moment features (1, x, y, z, xx, xy, xz, yy, yz, zz).
//
// The TPU carried running prefixes across sequential lane tiles.  On the
// H100 blocks run in no order, so nothing is carried: the key arrays are
// sorted, so each point finds its segment's first and last member by a
// galloping search on the keys, and the segment's first point sums the
// features of its members in index order.  Totals are thus independent of
// the launch geometry and the same on every run.  The coordinates are
// taken relative to the segment's first point (the anchor of the segmented
// -scan form, ops/normals.py), not the block corner of the TPU kernel: a
// sequential f32 sum of squares of coordinates 0.2 m from their anchor
// loses a mm-scale covariance to cancellation, which the TPU's tree-shaped
// scan did not.  A second kernel picks the smallest depth with >=
// min_points members and does the weighted-determinant plane fit, scanner
// flip and fallback (normals.hpp:10-148).
//
// What bounds it on the H100: the serial sum of the longest segment (one
// thread walks all of its members) and the L2-resident key reads of the
// searches; the sphere's segments hold tens of points.  Built with
// -fmad=false so the fit is the same sequence of f32 operations as the
// plain version (ops/normals.py _plane_normal_from_moments).
#include "common.cuh"

namespace chad {

__device__ __forceinline__ bool same_seg(const int* bk, const int* ok, int j,
                                         int b, int o, int sh) {
  return bk[j] == b && (ok[j] >> sh) == o;
}

// First index of the sorted run holding i.
__device__ int seg_start(const int* bk, const int* ok, int i, int sh) {
  const int b = bk[i], o = ok[i] >> sh;
  int hi = i, step = 1, lo;
  while (true) {
    lo = i - step;
    if (lo < 0) { lo = -1; break; }
    if (!same_seg(bk, ok, lo, b, o, sh)) break;
    hi = lo;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (same_seg(bk, ok, mid, b, o, sh)) hi = mid; else lo = mid;
  }
  return hi;
}

// One past the last index of the sorted run holding i.
__device__ int seg_end(const int* bk, const int* ok, int i, int n, int sh) {
  const int b = bk[i], o = ok[i] >> sh;
  int lo = i, step = 1, hi;
  while (true) {
    hi = i + step;
    if (hi >= n) { hi = n; break; }
    if (!same_seg(bk, ok, hi, b, o, sh)) break;
    lo = hi;
    step <<= 1;
  }
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (same_seg(bk, ok, mid, b, o, sh)) lo = mid; else hi = mid;
  }
  return hi;
}

__global__ void normals_segsum_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const int* __restrict__ bk,
    const int* __restrict__ ok, int n, int nd, float* __restrict__ tot,
    int* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x0 = px[i], y0 = py[i], z0 = pz[i];
  for (int d = 0; d < nd; ++d) {
    const int sh = 3 * d;
    const int st = seg_start(bk, ok, i, sh);
    starts[(size_t)d * n + i] = st;
    if (st != i) continue;
    // this thread owns the segment: sum its members in index order, in
    // coordinates relative to the segment's first point (this one)
    const int en = seg_end(bk, ok, i, n, sh);
    float f[10];
    for (int c = 0; c < 10; ++c) f[c] = 0.0f;
    for (int j = st; j < en; ++j) {
      const float ax = px[j] - x0, ay = py[j] - y0, az = pz[j] - z0;
      f[0] = f[0] + 1.0f;
      f[1] = f[1] + ax;
      f[2] = f[2] + ay;
      f[3] = f[3] + az;
      f[4] = f[4] + ax * ax;
      f[5] = f[5] + ax * ay;
      f[6] = f[6] + ax * az;
      f[7] = f[7] + ay * ay;
      f[8] = f[8] + ay * az;
      f[9] = f[9] + az * az;
    }
    for (int c = 0; c < 10; ++c) tot[((size_t)d * 10 + c) * n + i] = f[c];
  }
}

__device__ __forceinline__ float max1e30(float x) { return fmaxf(x, 1e-30f); }

__global__ void normals_fit_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const int* __restrict__ bk,
    const float* __restrict__ position, const float* __restrict__ tot,
    const int* __restrict__ starts, int n, int nd, float min_points,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best[10];
  for (int c = 0; c < 10; ++c) best[c] = 0.0f;
  bool found = false;
  for (int d = 0; d < nd && !found; ++d) {
    const int st = starts[(size_t)d * n + i];
    const float cnt = tot[((size_t)d * 10) * n + st];
    if (cnt >= min_points) {
      for (int c = 0; c < 10; ++c) best[c] = tot[((size_t)d * 10 + c) * n + st];
      found = true;
    }
  }

  // weighted-determinant plane fit (ops/normals.py _plane_normal_from_moments)
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
  float nx = wx * inv, ny = wy * inv, nz = wz * inv;

  // flip toward the scanner and fallback (normals.hpp:117-134)
  float tx = position[0] - px[i];
  float ty = position[1] - py[i];
  float tz = position[2] - pz[i];
  const float tn = sqrtf(tx * tx + ty * ty + tz * tz);
  const float tinv = 1.0f / max1e30(tn);
  tx = tx * tinv; ty = ty * tinv; tz = tz * tinv;
  if (nx * tx + ny * ty + nz * tz < 0.0f) {
    nx = -nx; ny = -ny; nz = -nz;
  }
  const bool fb = !found || bk[i] == kInt32Max;
  out[i] = fb ? tx : nx;
  out[(size_t)n + i] = fb ? ty : ny;
  out[2 * (size_t)n + i] = fb ? tz : nz;
}

}  // namespace chad

extern "C" int chad_estimate_normals(const float* px, const float* py,
                                     const float* pz, const int* bkey,
                                     const int* okey, const float* position,
                                     int n, int nd, float min_points,
                                     float* tot, int* starts, float* out,
                                     void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  chad::normals_segsum_kernel<<<blocks, threads, 0, st>>>(
      px, py, pz, bkey, okey, n, nd, tot, starts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chad::normals_fit_kernel<<<blocks, threads, 0, st>>>(
      px, py, pz, bkey, position, tot, starts, n, nd, min_points, out);
  CHAD_RETURN_LAUNCH_ERROR();
}
