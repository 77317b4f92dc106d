// carve: space carving's free-space samples as 64-bit sort keys, and the
// pool update from the sorted keys.
//
// No TPU kernel stands behind them: the JAX package leaves carving to XLA
// (chad_tsdf_tpu/core/carve.py carve_step_impl).  On the card the same plain
// PyTorch sequence (core/carve.py: ~40 elementwise passes to build the keys,
// then end flags, a compaction, the touched blocks' ranks, a directory
// lookup and two index_add_ over every one of the K x ceil(N / sub) sample
// slots) moved 34-67 MB a pass over a LiDAR sweep's 8.4 M slots.  Around the
// one int64 sort that stays (torch.sort), two kernels do that work:
//
// carve_keys: one thread per carve ray and per kKeysSteps of its steps.  It
// repeats core/carve.py carve_sample_keys' f32 operations one by one (built
// with -fmad=false, res_recip the host-rounded f32 of 1 / res): the
// direction from sqrtf and IEEE divisions, t = (i + 0.5) * f32(stride *
// res), the test t < r - trunc, floor(q * res_recip) and the local extent,
// and writes key[i * ns + j] = block key << 32 | offset key, or kInvalidKey
// (INT32_MAX << 32 | INT32_MAX) for an invalid slot.  n_valid gains the
// valid samples (the caller zeroes it in the same stream): a warp
// reduction, then one atomic per CTA.  It also counts the valid keys'
// digits for carve_sort (carve_sort.cu), which then reads no key twice for
// them: counts[q * kSortBins + v] gains the keys whose digit q (bits 8q to
// 8q + 7 of bkey << 9 | okey) is v, for the sort's `passes` digits, counted
// in shared memory (a shared atomic a key and digit) and added to the
// caller's (zeroed) counts once per CTA and nonzero count.
//
// carve_apply: three launches over the sorted keys, whose valid samples are
// the prefix [0, n_valid), cut into tiles of kTileSlots slots (kItems
// consecutive slots a thread):
//   1. carve_count_kernel: each tile's block starts and its last voxel run
//      start;
//   2. carve_scan_kernel (one CTA): the tiles' exclusive block-start sums
//      (a block's rank is the number of blocks before it) and exclusive
//      running maximum of run starts (where the run a tile opens in began);
//      the touched overflow, max(blocks - t_cap, 0), and the counters reset;
//   3. carve_apply_kernel: per tile, the blocks of the tile (the one it
//      opens in, then each that starts in it) looked up in the sorted
//      directory by binary search, only those ranked below t_cap (LOOKUP
//      ONLY: nothing is allocated); then at each voxel run's last sample,
//      count = the run's length, and where its block was found and is not
//      the reserved row, pool[slot * 512 + offset] += f32(count) * per, a
//      plain read-modify-write (every voxel is one run, so no two threads
//      share an element, and the product and the sum are rounded apart, as
//      index_add_ of the plain version rounds them).  counters[0..2] gain
//      the samples and voxels applied and the samples of kept blocks that
//      were not (the erosion rule's drops); the samples of the blocks past
//      t_cap are in none of them, as in core/carve.py.
// Nothing else is written: no dead entry, no reserved row.  Nothing is read
// back on the host, so the launches can sit in a CUDA graph.
//
// What bounds them on the H100: bytes.  carve_keys reads 12 B a ray and
// writes 8 B a slot (67.1 MB over a sweep's 8,388,608 slots: 0.020 ms at
// 3.35 TB/s; the digit counts add 4 B a count).  carve_apply reads the
// valid keys twice (8 B a valid slot a pass) and reads and writes the
// carved voxels' two pool words; the directory (512 KB at 131,072 blocks)
// stays in L2.
#include "common.cuh"

namespace chad {

constexpr int kKeysThreads = 256;
constexpr int kKeysWarps = kKeysThreads / 32;
constexpr int kKeysSteps = 16;      // steps of one ray a thread writes

constexpr int kCarveThreads = 256;  // count and apply kernels
constexpr int kCarveWarps = kCarveThreads / 32;
constexpr int kItems = 4;           // consecutive sorted slots a thread
constexpr int kTileSlots = kCarveThreads * kItems;
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;

__global__ void __launch_bounds__(kKeysThreads)
carve_keys_kernel(const float* __restrict__ points,
                  const int* __restrict__ n_points,
                  const float* __restrict__ pos,
                  const int* __restrict__ origin_blocks, int ns, int sub,
                  int k, float step_m, float res_recip, float trunc,
                  int extent, int passes,
                  unsigned long long* __restrict__ keys,
                  int* __restrict__ n_valid, int* __restrict__ counts) {
  __shared__ int red[kKeysWarps];
  __shared__ int cta_counts[kMaxSortPasses * kSortBins];
  for (int i = threadIdx.x; i < passes * kSortBins; i += kKeysThreads)
    cta_counts[i] = 0;
  __syncthreads();
  const int j = blockIdx.x * kKeysThreads + threadIdx.x;
  int nv = 0;
  if (j < ns) {
    const int row = j * sub;
    const bool row_ok = row < *n_points;
    const float qx = pos[0], qy = pos[1], qz = pos[2];
    const float dx = points[3 * row] - qx;
    const float dy = points[3 * row + 1] - qy;
    const float dz = points[3 * row + 2] - qz;
    const float r = sqrtf(dx * dx + dy * dy + dz * dz);
    const float lo = static_cast<float>(1e-12);     // torch.clamp's min
    const float safe = r < lo ? lo : r;
    const float ux = dx / safe, uy = dy / safe, uz = dz / safe;
    const float limit = r - trunc;
    const int ox = origin_blocks[0] * 8, oy = origin_blocks[1] * 8,
              oz = origin_blocks[2] * 8;
    const int i1 = min(k, (int)(blockIdx.y + 1) * kKeysSteps);
    for (int i = blockIdx.y * kKeysSteps; i < i1; ++i) {
      const float t = ((float)i + 0.5f) * step_m;
      unsigned long long key = kInvalidKey;
      if (row_ok && t < limit) {
        const int lx = (int)floorf((qx + ux * t) * res_recip) - ox;
        const int ly = (int)floorf((qy + uy * t) * res_recip) - oy;
        const int lz = (int)floorf((qz + uz * t) * res_recip) - oz;
        if (lx >= 0 && lx < extent && ly >= 0 && ly < extent && lz >= 0 &&
            lz < extent) {
          key = ((unsigned long long)(unsigned)encode_block(
                     lx >> 3, ly >> 3, lz >> 3) << 32) |
                (unsigned)encode_offset(lx & 7, ly & 7, lz & 7);
          ++nv;
          const unsigned long long v = sort_value(key);
          for (int q = 0; q < passes; ++q)
            atomicAdd(&cta_counts[q * kSortBins +
                                  ((int)(v >> (q * kSortBits)) &
                                   (kSortBins - 1))],
                      1);
        }
      }
      keys[(size_t)i * ns + j] = key;
    }
  }
  nv = __reduce_add_sync(0xffffffffu, nv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = nv;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kKeysWarps ? red[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v) atomicAdd(n_valid, v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * kSortBins; i += kKeysThreads)
    if (cta_counts[i]) atomicAdd(&counts[i], cta_counts[i]);
}

// A thread's kItems sorted slots from p0 on, and the run and block
// boundaries among them: bit i of vstart / bstart / vend says whether slot
// p0 + i opens a voxel run, opens a block, or closes a voxel run.  Slots
// from n_valid on are not valid and set no bit.
struct Slots {
  unsigned long long key[kItems];
  unsigned vstart, bstart, vend;
};

__device__ __forceinline__ Slots load_slots(
    const unsigned long long* __restrict__ keys, int s, int nv, int p0) {
  Slots q;
  for (int i = 0; i < kItems; ++i)
    q.key[i] = p0 + i < s ? keys[p0 + i] : kInvalidKey;
  unsigned long long prev = p0 > 0 ? keys[p0 - 1] : kInvalidKey;
  const unsigned long long next =
      p0 + kItems < s ? keys[p0 + kItems] : kInvalidKey;
  q.vstart = q.bstart = q.vend = 0u;
  for (int i = 0; i < kItems; ++i) {
    if (p0 + i >= nv) break;
    const unsigned long long k = q.key[i];
    const unsigned long long nk = i + 1 < kItems ? q.key[i + 1] : next;
    q.vstart |= (unsigned)(prev != k) << i;
    q.bstart |= (unsigned)((prev >> 32) != (k >> 32)) << i;
    q.vend |= (unsigned)(nk != k) << i;
    prev = k;
  }
  return q;
}

__device__ __forceinline__ int last_bit_pos(unsigned bits, int p0) {
  return bits ? p0 + 31 - __clz(bits) : -1;
}

__global__ void __launch_bounds__(kCarveThreads)
carve_count_kernel(const unsigned long long* __restrict__ keys, int s,
                   const int* __restrict__ n_valid,
                   int* __restrict__ tile_blocks,
                   int* __restrict__ tile_vmax) {
  __shared__ int red[2 * kCarveWarps];
  const int nv = *n_valid;
  const int base = blockIdx.x * kTileSlots;
  if (base >= nv) return;
  const int p0 = base + threadIdx.x * kItems;
  const Slots q = load_slots(keys, s, nv, p0);
  int nb = __popc(q.bstart), vm = last_bit_pos(q.vstart, p0);
  int tb, tv;
  cta_scan<kCarveWarps, MaxOp>(nb, vm, tb, tv, red);
  if (threadIdx.x == 0) {
    tile_blocks[blockIdx.x] = tb;
    tile_vmax[blockIdx.x] = tv;
  }
}

// One CTA: turns the valid tiles' block-start counts into exclusive sums
// and their last run starts into exclusive running maxima, in place.
__global__ void __launch_bounds__(kScanThreads)
carve_scan_kernel(const int* __restrict__ n_valid, int t_cap,
                  int* __restrict__ tile_blocks, int* __restrict__ tile_vmax,
                  int* __restrict__ counters) {
  __shared__ int red[2 * kScanWarps];
  const int nt = (*n_valid + kTileSlots - 1) / kTileSlots;
  const int per = (nt + kScanThreads - 1) / kScanThreads;
  const int t0 = min(nt, (int)threadIdx.x * per), t1 = min(nt, t0 + per);
  int sum = 0, vm = -1;
  for (int t = t0; t < t1; ++t) {
    sum += tile_blocks[t];
    vm = max(vm, tile_vmax[t]);
  }
  int blocks, unused;
  cta_scan<kScanWarps, MaxOp>(sum, vm, blocks, unused, red);
  for (int t = t0; t < t1; ++t) {
    const int nb = tile_blocks[t], tv = tile_vmax[t];
    tile_blocks[t] = sum;
    tile_vmax[t] = vm;
    sum += nb;
    vm = max(vm, tv);
  }
  if (threadIdx.x == 0) {
    counters[0] = counters[1] = counters[2] = 0;
    counters[3] = max(blocks - t_cap, 0);
  }
}

// Pool row of block key b: its directory slot where the sorted directory
// holds it (torch.searchsorted's left position) and that slot is not the
// reserved row, else -1.
__device__ __forceinline__ int find_slot(const int* __restrict__ dir_keys,
                                         const int* __restrict__ dir_slots,
                                         int cb, int reserved_row, int b) {
  int lo = 0, hi = cb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dir_keys[mid] < b)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int at = min(lo, cb - 1);
  if (dir_keys[at] != b) return -1;
  const int slot = dir_slots[at];
  return slot == reserved_row ? -1 : slot;
}

__global__ void __launch_bounds__(kCarveThreads)
carve_apply_kernel(const unsigned long long* __restrict__ keys, int s,
                   const int* __restrict__ n_valid,
                   const int* __restrict__ tile_blocks,
                   const int* __restrict__ tile_vmax,
                   const int* __restrict__ dir_keys,
                   const int* __restrict__ dir_slots, int cb, int t_cap,
                   float sd_per, float w_per, float* __restrict__ pool_sd,
                   float* __restrict__ pool_w, int* __restrict__ counters) {
  // the tile's blocks: 0 the one it opens in, i the i-th that starts in it
  __shared__ int s_bkey[kTileSlots + 1];
  __shared__ int s_slot[kTileSlots + 1];
  __shared__ int red[2 * kCarveWarps];
  const int nv = *n_valid;
  const int base = blockIdx.x * kTileSlots;
  if (base >= nv) return;
  const int p0 = base + threadIdx.x * kItems;
  const Slots q = load_slots(keys, s, nv, p0);
  int lb = __popc(q.bstart), rs = last_bit_pos(q.vstart, p0);
  int nb, unused;
  cta_scan<kCarveWarps, MaxOp>(lb, rs, nb, unused, red);
  rs = max(rs, tile_vmax[blockIdx.x]);
  const int rank0 = tile_blocks[blockIdx.x] - 1;   // rank of block 0
  if (threadIdx.x == 0) s_bkey[0] = (int)(q.key[0] >> 32);
  for (int i = 0, b = lb; i < kItems; ++i)
    if (q.bstart >> i & 1u) s_bkey[++b] = (int)(q.key[i] >> 32);
  __syncthreads();
  const int reserved_row = cb - 1;
  for (int b = threadIdx.x; b <= nb; b += kCarveThreads)
    s_slot[b] = rank0 + b < t_cap
                    ? find_slot(dir_keys, dir_slots, cb, reserved_row,
                                s_bkey[b])
                    : -1;
  __syncthreads();
  int hit = 0, vox = 0, kept = 0;
  for (int i = 0; i < kItems; ++i) {
    const int p = p0 + i;
    lb += q.bstart >> i & 1u;
    if (q.vstart >> i & 1u) rs = p;
    if (!(q.vend >> i & 1u) || rank0 + lb >= t_cap) continue;
    const int count = p - rs + 1;
    kept += count;
    const int slot = s_slot[lb];
    if (slot < 0) continue;
    const size_t at = (size_t)slot * kRowLen + (unsigned)(q.key[i] & 511u);
    const float cf = (float)count;
    pool_sd[at] = pool_sd[at] + cf * sd_per;
    pool_w[at] = pool_w[at] + cf * w_per;
    hit += count;
    ++vox;
  }
  hit = __reduce_add_sync(0xffffffffu, hit);
  vox = __reduce_add_sync(0xffffffffu, vox);
  kept = __reduce_add_sync(0xffffffffu, kept);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __shared__ int sums[3][kCarveWarps];
  if (lane == 0) {
    sums[0][warp] = hit;
    sums[1][warp] = vox;
    sums[2][warp] = kept - hit;
  }
  __syncthreads();
  if (warp == 0) {
    for (int c = 0; c < 3; ++c) {
      int v = lane < kCarveWarps ? sums[c][lane] : 0;
      v = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0 && v) atomicAdd(&counters[c], v);
    }
  }
}

}  // namespace chad

// counts: passes x kSortBins ints, zeroed by the caller, as n_valid.
extern "C" int chad_carve_keys(const float* points, const int* n_points,
                               const float* position,
                               const int* origin_blocks, int ns, int sub,
                               int k, float step_m, float res_recip,
                               float trunc, int extent, int passes,
                               long long* keys, int* n_valid, int* counts,
                               void* stream) {
  if (ns < 0 || sub < 1 || k < 1 || passes < 1 ||
      passes > chad::kMaxSortPasses)
    return (int)cudaErrorInvalidValue;
  if (ns == 0) return 0;
  const dim3 grid((ns + chad::kKeysThreads - 1) / chad::kKeysThreads,
                  (k + chad::kKeysSteps - 1) / chad::kKeysSteps);
  chad::carve_keys_kernel<<<grid, chad::kKeysThreads, 0,
                            (cudaStream_t)stream>>>(
      points, n_points, position, origin_blocks, ns, sub, k, step_m,
      res_recip, trunc, extent, passes,
      reinterpret_cast<unsigned long long*>(keys), n_valid, counts);
  CHAD_RETURN_LAUNCH_ERROR();
}

// ws holds ws_len ints, of which the launches use 2 * ceil(s /
// kTileSlots) (an invalid value if it holds fewer); counters 4 (all
// written here: applied samples, applied voxels, dropped samples, touched
// overflow).
extern "C" int chad_carve_apply(const long long* keys, int s,
                                const int* n_valid, const int* dir_keys,
                                const int* dir_slots, int cb, int t_cap,
                                float sd_per, float w_per, float* pool_sd,
                                float* pool_w, int* ws, int ws_len,
                                int* counters, void* stream) {
  if (s < 1 || cb < 1 || t_cap < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (s + chad::kTileSlots - 1) / chad::kTileSlots;
  if (ws_len < 2 * tiles) return (int)cudaErrorInvalidValue;
  const auto* k = reinterpret_cast<const unsigned long long*>(keys);
  cudaStream_t st = (cudaStream_t)stream;
  chad::carve_count_kernel<<<tiles, chad::kCarveThreads, 0, st>>>(
      k, s, n_valid, ws, ws + tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chad::carve_scan_kernel<<<1, chad::kScanThreads, 0, st>>>(
      n_valid, t_cap, ws, ws + tiles, counters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chad::carve_apply_kernel<<<tiles, chad::kCarveThreads, 0, st>>>(
      k, s, n_valid, ws, ws + tiles, dir_keys, dir_slots, cb, t_cap,
      sd_per, w_per, pool_sd, pool_w, counters);
  CHAD_RETURN_LAUNCH_ERROR();
}
