// seg_samples: the ray samples of the seg insert as 64-bit sort keys.
//
// No TPU kernel stands behind it: the JAX package builds the seg insert's
// samples in XLA (chad_tsdf_tpu/core/integrate.py sparse_seg_entry_stream,
// through compute_samples), which fuses the DDA, the signed distances and
// the keys into a few loops.  On the card the same plain PyTorch sequence
// (ops/dda.py local_sample_grids, the payload and the int64 key) is ~400
// launches over a LiDAR sweep's K x N sample slots; this kernel is one.
//
// One thread per Morton-sorted point walks its ray for K steps with K1's
// walk (common.cuh ray_start / ray_step / ray_sample, bit-equal to
// ops/dda.py) and writes, for every step r, key[r * n + i] = (int64) block
// key << 32 | pack_payload(offset, quantized sd): INT32_MAX << 32 | 0 for a
// sample that is not valid.  The (K, N) layout makes a warp's stores one
// contiguous 256-byte run per step; the seg insert sorts the keys by value
// next, so the layout does not reach its result.  counts[0] gains the valid
// samples and counts[1] the emitted samples outside the local extent (the
// caller zeroes them in the same stream): a warp reduction, then one
// atomic per CTA and counter.  Nothing is read back on the host, so the
// launch can sit in a CUDA graph.
//
// What bounds it on the H100: bytes, 28 B a point in and 8 B a sample out
// (14.2 MB on a 131,072-point bucket at K = 10: 4.2 us at 3.35 TB/s); the
// walk's exact f32 arithmetic (four IEEE divisions and a square root a
// ray, then ~25 operations a step) comes close to it.
#include "common.cuh"

namespace chad {

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;

__global__ void __launch_bounds__(kSegThreads)
seg_samples_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, const float* __restrict__ nx,
                   const float* __restrict__ ny, const float* __restrict__ nz,
                   const int* __restrict__ sb, const float* __restrict__ pos,
                   const int* __restrict__ origin_voxel, int n, int k,
                   float res, float res_recip, float trunc, int extent,
                   float qscale, unsigned long long* __restrict__ keys,
                   int* __restrict__ counts) {
  __shared__ int red[2][kSegWarps];
  const int i = blockIdx.x * kSegThreads + threadIdx.x;
  int n_valid = 0, n_samp_ovf = 0;
  if (i < n) {
    const int ox = origin_voxel[0], oy = origin_voxel[1],
              oz = origin_voxel[2];
    const float x = px[i], y = py[i], z = pz[i];
    const float n0 = nx[i], n1 = ny[i], n2 = nz[i];
    Ray ray = ray_start(x, y, z, pos[0], pos[1], pos[2], sb[i] != kInt32Max,
                        ox, oy, oz, res, res_recip, trunc);
    for (int r = 0; r < k; ++r) {
      if (r > 0) ray_step(ray);
      int key, pay;
      ray_sample(ray, x, y, z, n0, n1, n2, ox, oy, oz, extent, res, trunc,
                 qscale, key, pay, n_valid, n_samp_ovf);
      keys[(size_t)r * n + i] =
          ((unsigned long long)(unsigned)key << 32) | (unsigned)pay;
    }
  }
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  n_samp_ovf = __reduce_add_sync(0xffffffffu, n_samp_ovf);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = n_valid;
    red[1][warp] = n_samp_ovf;
  }
  __syncthreads();
  if (warp == 0) {
    int v = lane < kSegWarps ? red[0][lane] : 0;
    int o = lane < kSegWarps ? red[1][lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    o = __reduce_add_sync(0xffffffffu, o);
    if (lane == 0) {
      if (v) atomicAdd(&counts[0], v);
      if (o) atomicAdd(&counts[1], o);
    }
  }
}

}  // namespace chad

extern "C" int chad_seg_samples(
    const float* px, const float* py, const float* pz, const float* nx,
    const float* ny, const float* nz, const int* sb, const float* position,
    const int* origin_voxel, int n, int k, float res, float res_recip,
    float trunc, int extent, float qscale, long long* keys, int* counts,
    void* stream) {
  if (n < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + chad::kSegThreads - 1) / chad::kSegThreads;
  chad::seg_samples_kernel<<<blocks, chad::kSegThreads, 0,
                             (cudaStream_t)stream>>>(
      px, py, pz, nx, ny, nz, sb, position, origin_voxel, n, k, res,
      res_recip, trunc, extent, qscale,
      reinterpret_cast<unsigned long long*>(keys), counts);
  CHAD_RETURN_LAUNCH_ERROR();
}
