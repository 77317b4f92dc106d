// K1: fused DDA + signed distance + per-tile partial block rows.
//
// Replaces the TPU kernel chad_tsdf_tpu/ops/fused_integrate.py:
// fused_tile_partials (Pallas body _kernel, :76-340).  One CTA of 1024
// threads per 1024-point tile of Morton-sorted points; thread t owns point
// t of the tile and walks its ray for K steps.
//
// What bounds it on the H100: not bytes (the tile reads 28 KiB of points
// and writes nb x 512 x 8 B = 192 KiB of partial rows at nb = 48) but the
// tile's serial work in shared memory: nb rounds of block-wide min
// extraction for the block list and the shared-memory atomics of the
// accumulate.  The design keeps every sample of the tile in shared memory
// (K x 1024 keys and packed offset|sd payloads, 80 KiB at K = 10) so the
// DDA runs once, and accumulates one slab of 16 list ranks at a time
// (64 KiB of integer sums), skipping slabs past the list's end, so a tile
// with few distinct blocks pays one pass.  1 CTA per SM; wgmma, TMA and
// persistence are left for later work.
//
// Exactness: the DDA must give the voxels of the plain PyTorch traversal
// (ops/dda.py) bit for bit, because the fallback re-derives K1's coverage
// through it.  The file is built with -fmad=false, every expression below
// is the same sequence of rounded f32 operations as dda.py, and res_recip
// is the host-rounded f32 of 1/res.  Signed distances are summed as
// integers on the SD_QUANT grid (common.cuh), which is deterministic; the
// error against an f32 sum is at most trunc / 65534 per sample.
#include "common.cuh"

namespace chad {

constexpr float kFmax = 3.4028235e38f;

struct Axis {
  int vs, vf, sdir;
  float delta, tmax;
};

__device__ __forceinline__ Axis axis_setup(float p, float d, float res,
                                           float res_recip, float trunc) {
  Axis a;
  const float start = p - d * trunc;
  const float final_ = p + d * trunc;
  a.vs = (int)floorf(start * res_recip);
  a.vf = (int)floorf(final_ * res_recip);
  const int diff = a.vf - a.vs;
  a.sdir = (diff > 0) - (diff < 0);
  const float d_recip = 1.0f / d;
  a.delta = fabsf(d_recip * res);
  const float bound = a.sdir < 0 ? floorf(start * res_recip) * res
                                 : ceilf(start * res_recip) * res;
  a.tmax = fabsf((bound - start) * d_recip);
  if (a.sdir == 0) {
    a.tmax = kFmax;
    a.delta = kFmax;
  }
  return a;
}

__global__ void __launch_bounds__(kTile)
fused_tile_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  const float* __restrict__ pz, const float* __restrict__ nx,
                  const float* __restrict__ ny, const float* __restrict__ nz,
                  const int* __restrict__ sb, const float* __restrict__ pos,
                  const int* __restrict__ origin_voxel, int k, int nb,
                  float res, float res_recip, float trunc, int extent,
                  float qscale, float dscale, int* __restrict__ pkeys,
                  float* __restrict__ psd, float* __restrict__ pw,
                  int* __restrict__ counts) {
  extern __shared__ int smem[];
  TileSmem s = tile_smem(smem, k, nb);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t i = (size_t)tile * kTile + tid;
  if (tid < 3) s.red[36 + tid] = 0;

  const float x = px[i], y = py[i], z = pz[i];
  const float n0 = nx[i], n1 = ny[i], n2 = nz[i];
  const int ox = origin_voxel[0], oy = origin_voxel[1], oz = origin_voxel[2];

  // ray direction (octree.hpp:96-97)
  float dx = x - pos[0];
  float dy = y - pos[1];
  float dz = z - pos[2];
  const float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.0f / norm;
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  const bool dir_ok = isfinite(dx) && isfinite(dy) && isfinite(dz);

  const Axis ax = axis_setup(x, dx, res, res_recip, trunc);
  const Axis ay = axis_setup(y, dy, res, res_recip, trunc);
  const Axis az = axis_setup(z, dz, res, res_recip, trunc);

  int vx = ax.vs, vy = ay.vs, vz = az.vs;
  float tx = ax.tmax, ty = ay.tmax, tz = az.tmax;
  bool alive = dir_ok && sb[i] != kInt32Max;
  int n_valid = 0, n_samp_ovf = 0;

  for (int r = 0; r < k; ++r) {
    if (r > 0) {
      // axis pick of octree.hpp:128-148
      const bool pick_x = (tx < ty) && (tx < tz);
      const bool pick_y = !(tx < ty) && (ty < tz);
      const bool pick_z = !(pick_x || pick_y);
      bool passed;
      if (pick_x) {
        vx += ax.sdir;
        tx = tx + ax.delta;
        passed = vx == ax.vf + ax.sdir;
      } else if (pick_y) {
        vy += ay.sdir;
        ty = ty + ay.delta;
        passed = vy == ay.vf + ay.sdir;
      } else {
        vz += az.sdir;
        tz = tz + az.delta;
        passed = vz == az.vf + az.sdir;
      }
      (void)pick_z;
      alive = alive && !passed;
    }
    const int lx = vx - ox, ly = vy - oy, lz = vz - oz;
    const bool in_range = lx >= 0 && lx < extent && ly >= 0 &&
                          ly < extent && lz >= 0 && lz < extent;
    n_samp_ovf += (alive && !in_range);
    const bool ok = alive && in_range;
    n_valid += ok;
    int key = kInt32Max, pay = 0;
    if (ok) {
      key = encode_block(lx >> 3, ly >> 3, lz >> 3);
      const int okey = encode_offset(lx & 7, ly & 7, lz & 7);
      // projective sd along the normal (octree.hpp:156-159)
      float sd = n0 * ((float)vx * res - x) + n1 * ((float)vy * res - y) +
                 n2 * ((float)vz * res - z);
      sd = fminf(fmaxf(sd, -trunc), trunc);
      pay = pack_payload(okey, quantize_sd(sd, qscale));
    }
    s.key[r * kTile + tid] = key;
    s.pay[r * kTile + tid] = pay;
  }
  __syncthreads();

  const unsigned ovf = tile_accumulate(s, k, nb, tile, dscale, pkeys, psd, pw);

  atomicAdd(&s.red[36], n_valid);
  atomicAdd(&s.red[37], __popc(ovf));
  atomicAdd(&s.red[38], n_samp_ovf);
  __syncthreads();
  if (tid < 3) counts[tile * 3 + tid] = s.red[36 + tid];
}

}  // namespace chad

extern "C" int chad_fused_tile_partials(
    const float* px, const float* py, const float* pz, const float* nx,
    const float* ny, const float* nz, const int* sb, const float* position,
    const int* origin_voxel, int n, int k, int nb, float res, float res_recip,
    float trunc, int extent, float qscale, float dscale, int* pkeys,
    float* psd, float* pw, int* counts, void* stream) {
  const int smem = chad::tile_smem_words(k, nb) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      chad::fused_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = n / chad::kTile;
  chad::fused_tile_kernel<<<tiles, chad::kTile, smem,
                            (cudaStream_t)stream>>>(
      px, py, pz, nx, ny, nz, sb, position, origin_voxel, k, nb, res,
      res_recip, trunc, extent, qscale, dscale, pkeys, psd, pw, counts);
  CHAD_RETURN_LAUNCH_ERROR();
}

extern "C" const char* chad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
