// K1: fused DDA + signed distance + per-tile partial block rows.
//
// Replaces the TPU kernel chad_tsdf_tpu/ops/fused_integrate.py:
// fused_tile_partials (Pallas body _kernel, :76-340).  One CTA of 512
// threads per 1024-point tile of Morton-sorted points; thread t owns points
// 2t and 2t + 1 of the tile and walks each ray for K steps.
//
// What bounds it on the H100: bytes.  The tile reads 28 B per point (28
// KiB) and must write its live partial rows (15.3 live blocks x 4 KiB per
// tile on the 1M sphere): ~93 MB per insert, 0.028 ms at 3.35 TB/s.  The
// first design (0.283 ms) was held far above that by its block list (nb
// rounds of a CTA-wide minimum, three barriers each), by writing all nb
// rows (69% zeros) and by 144 KiB of shared memory, one CTA per SM.  Now
// (common.cuh tile_accumulate): every sample of the tile stays in shared
// memory (K x 1024 keys and packed offset|sd payloads) so the DDA runs
// once; each warp builds the list of its own distinct keys with warp
// reductions and warp 0 merges the 16 lists once; a sample's rank and
// payload are packed into one word, so the keys' memory holds a slab of
// 16 list ranks of integer (sd sum, count) cells; only live rows are
// written, 16 bytes a thread; 107 KiB per CTA, so two CTAs share an SM and
// one tile's list or accumulate overlaps the other's DDA and writes.  The
// DDA keeps each voxel's Morton code and steps it with one masked add
// instead of re-encoding both keys at every sample.  What remains is
// instruction throughput more than bytes: the DDA's exact f32 arithmetic
// (its IEEE divisions and square root per ray, ~40 operations per step) is
// the largest phase, then the list, the ranks and writing the live rows,
// in about equal parts (scripts/kernel_phases.py times each; PERF.md has
// the split).
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

// A voxel's local coordinates (each taken mod 2^13, the largest extent)
// interleaved into one 39-bit Morton code: bits >> 9 are the block key,
// bits & 511 the offset key (encode_block / encode_offset).  A DDA step
// moves one axis by one voxel, which is an add on that axis's bits.
constexpr unsigned long long kMortonX = 0x1249249249ull;   // x's 13 bits

__device__ __forceinline__ unsigned long long spread3_13(int v) {
  unsigned long long x = (unsigned)v & 0x1FFFu;
  x = (x | (x << 16)) & 0x1F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

__device__ __forceinline__ unsigned long long step_morton(
    unsigned long long m, unsigned long long mask, int dir) {
  const unsigned long long a = dir > 0 ? (m | ~mask) + 1ull
                                       : (m & mask) - 1ull;
  return dir == 0 ? m : (a & mask) | (m & ~mask);
}

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

template <bool Wide>
__global__ void __launch_bounds__(kTileThreads, 2)
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
  if (tid < 3) s.red[36 + tid] = 0;
  const int ox = origin_voxel[0], oy = origin_voxel[1], oz = origin_voxel[2];
  const float qx = pos[0], qy = pos[1], qz = pos[2];
  int n_valid = 0, n_samp_ovf = 0;

#pragma unroll 1
  for (int c = 0; c < kCols; ++c) {
    const int col = tile_col0() + c;
    const size_t i = (size_t)tile * kTile + col;
    const float x = px[i], y = py[i], z = pz[i];
    const float n0 = nx[i], n1 = ny[i], n2 = nz[i];

    // ray direction (octree.hpp:96-97)
    float dx = x - qx;
    float dy = y - qy;
    float dz = z - qz;
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
    unsigned long long mc = spread3_13(vx - ox) | (spread3_13(vy - oy) << 1) |
                            (spread3_13(vz - oz) << 2);

    for (int r = 0; r < k; ++r) {
      if (r > 0) {
        // axis pick of octree.hpp:128-148
        const bool pick_x = (tx < ty) && (tx < tz);
        const bool pick_y = !(tx < ty) && (ty < tz);
        bool passed;
        if (pick_x) {
          vx += ax.sdir;
          tx = tx + ax.delta;
          passed = vx == ax.vf + ax.sdir;
          mc = step_morton(mc, kMortonX, ax.sdir);
        } else if (pick_y) {
          vy += ay.sdir;
          ty = ty + ay.delta;
          passed = vy == ay.vf + ay.sdir;
          mc = step_morton(mc, kMortonX << 1, ay.sdir);
        } else {
          vz += az.sdir;
          tz = tz + az.delta;
          passed = vz == az.vf + az.sdir;
          mc = step_morton(mc, kMortonX << 2, az.sdir);
        }
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
        key = (int)(mc >> 9);              // encode_block(l >> 3)
        const int okey = (int)(mc & 511u);   // encode_offset(l & 7)
        // projective sd along the normal (octree.hpp:156-159)
        float sd = n0 * ((float)vx * res - x) + n1 * ((float)vy * res - y) +
                   n2 * ((float)vz * res - z);
        sd = fminf(fmaxf(sd, -trunc), trunc);
        pay = pack_payload(okey, quantize_sd(sd, qscale));
      }
      s.key[r * kTile + col] = key;
      s.pay[r * kTile + col] = pay;
    }
  }
  __syncthreads();

  const ColMask ovf = tile_accumulate<Wide>(s, k, nb, tile, dscale, pkeys,
                                            psd, pw);

  int n_ovf = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) n_ovf += __popc(ovf.m[c]);
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_ovf = __reduce_add_sync(0xffffffffu, n_ovf);
  n_samp_ovf = __reduce_add_sync(0xffffffffu, n_samp_ovf);
  if ((tid & 31) == 0) {
    atomicAdd(&s.red[36], n_valid);
    atomicAdd(&s.red[37], n_ovf);
    atomicAdd(&s.red[38], n_samp_ovf);
  }
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
  if (!chad::tile_args_ok(k, nb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = n / chad::kTile;
  return chad::tile_wide(nb)
      ? chad::launch_tile_kernel(chad::fused_tile_kernel<true>, tiles, k, nb,
                                 s, px, py, pz, nx, ny, nz, sb, position,
                                 origin_voxel, k, nb, res, res_recip, trunc,
                                 extent, qscale, dscale, pkeys, psd, pw,
                                 counts)
      : chad::launch_tile_kernel(chad::fused_tile_kernel<false>, tiles, k, nb,
                                 s, px, py, pz, nx, ny, nz, sb, position,
                                 origin_voxel, k, nb, res, res_recip, trunc,
                                 extent, qscale, dscale, pkeys, psd, pw,
                                 counts);
}

extern "C" const char* chad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
