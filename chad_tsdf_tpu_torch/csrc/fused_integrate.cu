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
// through it.  The walk (common.cuh ray_start / ray_step / ray_sample,
// which seg_samples.cu shares) is built with -fmad=false, every expression
// in it is the same sequence of rounded f32 operations as dda.py, and
// res_recip is the host-rounded f32 of 1/res.  Signed distances are summed as
// integers on the SD_QUANT grid (common.cuh), which is deterministic; the
// error against an f32 sum is at most trunc / 65534 per sample.
#include "common.cuh"

namespace chad {

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

    Ray ray = ray_start(x, y, z, qx, qy, qz, sb[i] != kInt32Max, ox, oy,
                        oz, res, res_recip, trunc);
    for (int r = 0; r < k; ++r) {
      if (r > 0) ray_step(ray);
      int key, pay;
      ray_sample(ray, x, y, z, n0, n1, n2, ox, oy, oz, extent, res, trunc,
                 qscale, key, pay, n_valid, n_samp_ovf);
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
