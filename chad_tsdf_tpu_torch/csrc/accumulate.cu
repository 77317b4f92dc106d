// K5: accumulate_segments — the sort path's accumulate into the pool.
//
// Replaces the TPU kernel chad_tsdf_tpu/ops/accumulate.py:accumulate_pallas
// (Pallas body _accum_kernel, :75-192).  Samples arrive sorted by block
// key as packed payloads (offset << 16 | sd_q16); each live member of the
// slot-sorted tables owns one segment [start, start + len) of them and one
// pool row, and gets onehot(offset)^T . [sd, 1] over its segment added to
// that row.
//
// The TPU design (8-row DMA groups, 1024-sample aligned windows, and a
// re-scan of each window once per member) is Mosaic's.  Here member slots
// are distinct pool rows, so one CTA takes one member, reads only its own
// segment, and owns its row: no race, no group tables.  Dead members
// (reserved slot, or no samples) are read on the device and exit at once,
// so the grid is the table's static size and no host read is needed.
//
// What bounds it on the H100: bytes — each payload word is read once (4 B
// per sample) and each touched pool cell read and written once; the
// per-sample work is a warp match and reduce.  A dense voxel puts whole
// warps on one cell (a dense-voxel cloud has ~1.8 x 10^5 samples in one
// block), and same-cell atomics serialise, so a warp's lanes with the same
// cell first add their values and counts (__match_any_sync,
// __reduce_add_sync) and one lane adds the sum.  A long segment still runs
// on one CTA; splitting it across CTAs is left for later work.
//
// Exactness: sd is summed as int64 on the SD_QUANT grid of the payload, so
// the order of additions does not matter (deterministic) and no segment
// length can overflow it (65,536 x 32,767 already exceeds int32); weights
// are integer counts.  Each cell is scaled to metres once and added to the
// pool once, the same rounded operations as the plain version
// (ops/accumulate.py accumulate_segments_plain), which it equals bit for
// bit.
#include "common.cuh"

namespace chad {

constexpr int kSegThreads = 512;

__global__ void __launch_bounds__(kSegThreads)
accumulate_segments_kernel(float* __restrict__ pool_sd,
                           float* __restrict__ pool_w,
                           const int* __restrict__ starts,
                           const int* __restrict__ lens,
                           const int* __restrict__ slots,
                           const int* __restrict__ payload, int reserved,
                           float dscale) {
  const int m = blockIdx.x;
  const int slot = slots[m];
  const int len = lens[m];
  if (slot >= reserved || len <= 0) return;        // uniform over the CTA
  __shared__ unsigned long long accq[kRowLen];     // two's complement int64
  __shared__ int accw[kRowLen];
  const int tid = threadIdx.x;
  for (int c = tid; c < kRowLen; c += kSegThreads) {
    accq[c] = 0ull;
    accw[c] = 0;
  }
  __syncthreads();
  // a warp's lanes with the same cell add their sum with one atomic (a
  // dense voxel puts whole warps on one cell); |sum| <= 32 x 32767
  const int lane = tid & 31;
  const int* seg = payload + starts[m];
  for (int base = tid - lane; base < len; base += kSegThreads) {
    const int i = base + lane;
    const bool valid = i < len;
    const unsigned live = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      const int p = seg[i];
      const int off = (p >> 16) & 0x1FF;
      const int q = (p << 16) >> 16;             // arithmetic shift: sd_q16
      const unsigned peers = __match_any_sync(live, off);
      const int qsum = __reduce_add_sync(peers, q);
      if (lane == __ffs(peers) - 1) {
        atomicAdd(&accq[off], (unsigned long long)(long long)qsum);
        atomicAdd(&accw[off], __popc(peers));
      }
    }
  }
  __syncthreads();
  const size_t row = (size_t)slot * kRowLen;
  for (int c = tid; c < kRowLen; c += kSegThreads) {
    const int w = accw[c];
    if (w != 0) {
      const float sd = (float)(long long)accq[c] * dscale;
      pool_sd[row + c] = pool_sd[row + c] + sd;
      pool_w[row + c] = pool_w[row + c] + (float)w;
    }
  }
}

}  // namespace chad

extern "C" int chad_accumulate_segments(float* pool_sd, float* pool_w,
                                        const int* starts, const int* lens,
                                        const int* slots, const int* payload,
                                        int t, int reserved, float dscale,
                                        void* stream) {
  if (t <= 0) return 0;
  chad::accumulate_segments_kernel<<<t, chad::kSegThreads, 0,
                                     (cudaStream_t)stream>>>(
      pool_sd, pool_w, starts, lens, slots, payload, reserved, dscale);
  CHAD_RETURN_LAUNCH_ERROR();
}
