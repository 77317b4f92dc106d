// K4 (tile_partials) and K3 (merge_partials).
//
// K4 replaces the TPU kernel chad_tsdf_tpu/ops/tile_accum.py:tile_partials
// (Pallas body _tile_kernel, :61-113): the block list, ranks and partial
// rows of K1, but over precomputed (K, N) sample grids, plus the mask of
// valid samples that fell beyond a tile's list.  The fused insert's
// fallback calls it to learn exactly which samples K1 left out, so it runs
// K1's own tile_accumulate() (common.cuh) on the same keys.  Bound on the
// H100: like K1, the tile's serial list extraction and shared-memory
// atomics, not bytes (it reads K x 1024 x 12 B per tile).  One CTA of 1024
// threads per tile; thread t loads column t of the tile's K rows.
//
// K3 replaces chad_tsdf_tpu/ops/tile_accum.py:merge_partials (Pallas body
// _merge_kernel, :162-201): it adds slot-sorted partial rows into the
// block pool in place, one CTA per 8-row pool group.  Bound on the H100:
// bytes — each live partial row is read once (2 x 2 KiB) and each touched
// pool row read and written once.  The plan (ops/tile_accum.py plan_merge)
// gives every group a distinct pool window, so the in-place adds do not
// race; thread c owns column c and adds the group's partials in their
// sorted order, so the sums are the same on every run.  The grid is sized
// on the host to the plan's capacity and CTAs past the live group count,
// read from device memory, exit at once: no host read.  The partial rows
// are read through the sort permutation ``src`` instead of being gathered
// into slot order first, which saves a copy of every row.
#include "common.cuh"

namespace chad {

__global__ void __launch_bounds__(kTile)
tile_partials_kernel(const int* __restrict__ bkey, const int* __restrict__ okey,
                     const float* __restrict__ sd, int n, int k, int nb,
                     float qscale, float dscale, int* __restrict__ pkeys,
                     float* __restrict__ psd, float* __restrict__ pw,
                     int* __restrict__ ovfmask) {
  extern __shared__ int smem[];
  TileSmem s = tile_smem(smem, k, nb);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const size_t col = (size_t)tile * kTile + tid;
  for (int r = 0; r < k; ++r) {
    const size_t g = (size_t)r * n + col;
    s.key[r * kTile + tid] = bkey[g];
    s.pay[r * kTile + tid] = pack_payload(okey[g], quantize_sd(sd[g], qscale));
  }
  __syncthreads();
  const unsigned ovf = tile_accumulate(s, k, nb, tile, dscale, pkeys, psd, pw);
  for (int r = 0; r < k; ++r) {
    ovfmask[(size_t)r * n + col] = (ovf >> r) & 1u;
  }
}

__global__ void __launch_bounds__(kRowLen)
merge_partials_kernel(float* __restrict__ pool_sd, float* __restrict__ pool_w,
                      const int* __restrict__ n_groups,
                      const int* __restrict__ gstart,
                      const int* __restrict__ glen,
                      const int* __restrict__ grow,
                      const int* __restrict__ prow,
                      const int* __restrict__ src,
                      const float* __restrict__ psd,
                      const float* __restrict__ pw) {
  const int g = blockIdx.x;
  if (g >= n_groups[0]) return;
  const int c = threadIdx.x;
  const int beg = gstart[g];
  const int end = beg + glen[g];
  const size_t base = (size_t)grow[g] * 8;
  int cur = -1;
  float acc_sd = 0.0f, acc_w = 0.0f;
  for (int i = beg; i < end; ++i) {
    const int r = prow[i];
    if (r != cur) {
      if (cur >= 0) {
        const size_t o = (base + cur) * kRowLen + c;
        pool_sd[o] = pool_sd[o] + acc_sd;
        pool_w[o] = pool_w[o] + acc_w;
      }
      cur = r;
      acc_sd = 0.0f;
      acc_w = 0.0f;
    }
    const size_t o = (size_t)src[i] * kRowLen + c;
    acc_sd = acc_sd + psd[o];
    acc_w = acc_w + pw[o];
  }
  if (cur >= 0) {
    const size_t o = (base + cur) * kRowLen + c;
    pool_sd[o] = pool_sd[o] + acc_sd;
    pool_w[o] = pool_w[o] + acc_w;
  }
}

}  // namespace chad

extern "C" int chad_tile_partials(const int* bkey, const int* okey,
                                  const float* sd, int n, int k, int nb,
                                  float qscale, float dscale, int* pkeys,
                                  float* psd, float* pw, int* ovfmask,
                                  void* stream) {
  const int smem = chad::tile_smem_words(k, nb) * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      chad::tile_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  chad::tile_partials_kernel<<<n / chad::kTile, chad::kTile, smem,
                               (cudaStream_t)stream>>>(
      bkey, okey, sd, n, k, nb, qscale, dscale, pkeys, psd, pw, ovfmask);
  CHAD_RETURN_LAUNCH_ERROR();
}

extern "C" int chad_merge_partials(float* pool_sd, float* pool_w,
                                   const int* n_groups, const int* gstart,
                                   const int* glen, const int* grow,
                                   const int* prow, const int* src,
                                   const float* psd, const float* pw,
                                   int g_cap, void* stream) {
  if (g_cap <= 0) return 0;
  chad::merge_partials_kernel<<<g_cap, chad::kRowLen, 0,
                                (cudaStream_t)stream>>>(
      pool_sd, pool_w, n_groups, gstart, glen, grow, prow, src, psd, pw);
  CHAD_RETURN_LAUNCH_ERROR();
}
