// K4 on a block-sorted sample stream: tile_partials_sorted.
//
// Replaces, on the sample_tile insert's path, the TPU kernel
// chad_tsdf_tpu/ops/tile_accum.py:134 tile_partials (Pallas body
// _tile_kernel, :61-113) as core/integrate.py sample_tiled_update calls it:
// over the (1, S) grid of samples sorted by block key, 1024 samples a tile,
// with a list of nb blocks.  Its outputs are exactly those of
// tile_partials(bkey[None], *unpack_payload(payload)): on sorted input the
// nb smallest distinct valid keys of a tile are its first nb runs, so the
// general kernel's coverage rule gives the same list and mask.
//
// Bound on the H100: bytes.  It reads 8 B a sample (key and payload word)
// and writes 4 B of mask a sample, the tile's list and the live partial
// rows (4 KiB each), which are ~80% of the bytes on a LiDAR scan.  What
// holds a kernel back from it here is how evenly those stores spread over
// the card: a tile holds 1 to nb rows (~16 on average on a KITTI-shaped
// scan, up to 128), and one CTA storing a heavy tile's rows reaches ~23
// GB/s, about one SM's share of the card's bandwidth.  Designs that build
// a tile's rows in the CTA that ranked it (slab passes, or a warp a row)
// ended on their heaviest tiles.  So the work is split in two launches:
//
// * tile_heads_kernel, one CTA per tile, ranks from run heads: a valid
//   sample heads a run when its key differs from its predecessor's in the
//   tile (or it is the tile's first); its rank is the count of heads up to
//   it minus 1, from one ballot per 32 samples and one scan of the tile's
//   32 chunk counts.  No list is built by rounds of minima and nothing is
//   searched.  It writes the mask and the list, and appends one descriptor
//   per live row to a compact row list: the row's index and its samples,
//   the contiguous range between the heads of ranks r and r + 1.  It reads
//   the keys only; nb bounds only the list it writes (a tile has at most
//   1024 runs), so any nb >= 1 runs.
// * tile_rows_kernel, persistent, one warp a row: the warp adds the row's
//   samples' payload words into its own 2 x 2 KiB of shared memory with
//   integer atomics, then converts the row to f32 as it stores it (float4
//   a lane, 4 KiB a warp; streaming stores, st.global.cs, which the rows'
//   ~80 MB, past the 50 MB L2, take ~10% faster) and zeroes its buffer in
//   the same pass.  Rows are dealt over all warps of the card, whichever
//   tile they come from.
//
// Sums stay integer: sd on the SD_QUANT grid straight from the payload's
// low 16 bits (the word is not decoded and re-encoded), counts as ints,
// with shared-memory atomics whose order does not matter, so the rows do
// not depend on which warp built them or in which order the list was
// appended.  TMA bulk stores (cp.async.bulk from a double buffer per
// warp) were measured slower than this convert-and-store pass: a row must
// be converted in place before it can leave (PERF.md).
//
// tile_heads_kernel sets word[0] when a valid key of a tile is smaller
// than its predecessor's (the input was not sorted, and the outputs are
// not those of the general kernel); word[1] counts the row list.  The
// caller zeroes both.  Like the general kernel it leaves dead partial rows
// unwritten.
#include <atomic>

#include "common.cuh"

namespace chad {

constexpr int kHeadThreads = 128;
constexpr int kHeadPer = kTile / kHeadThreads;    // samples a thread
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kHeadChunks = kTile / 32;           // ballots a tile
constexpr int kRowThreads = 128;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowCtasPerSm = 12;   // CTAs the launch bounds ask for
constexpr int kRowQuads = kRowLen / 4 / 32;   // int4 a lane a plane
constexpr int kMaxDevices = 64;    // devices whose row grid is cached
static_assert(kHeadChunks == 32, "one warp scans the chunk counts");

__device__ __forceinline__ float4 to_float4(int4 v, float scale) {
  return make_float4((float)v.x * scale, (float)v.y * scale,
                     (float)v.z * scale, (float)v.w * scale);
}

// One tile: its mask, its list and the descriptors of its live rows
// {row index tile * nb + r, first sample, end sample, 0}, appended to rows
// at a place reserved with one atomic on word[1].
__global__ void __launch_bounds__(kHeadThreads)
tile_heads_kernel(const int* __restrict__ bkey, int nb,
                  int* __restrict__ pkeys, int* __restrict__ ovfmask,
                  int4* __restrict__ rows, int* __restrict__ word) {
  __shared__ int hpos[kTile];            // position of the head of rank r
  __shared__ int chunk[kHeadChunks];     // heads per chunk, then prefix
  __shared__ int s_heads, s_valid, s_end, s_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const size_t base = (size_t)tile * kTile;
  if (tid == 0) {
    s_valid = 0;
    s_end = 0;
  }
  // sample j * kHeadThreads + tid is in chunk j * kHeadWarps + warp
  int key[kHeadPer];
  unsigned hmask[kHeadPer];
  bool desc = false;
  int valid_here = 0;
#pragma unroll
  for (int j = 0; j < kHeadPer; ++j) {
    const int i = j * kHeadThreads + tid;
    key[j] = bkey[base + i];
    int prev = __shfl_up_sync(0xffffffffu, key[j], 1);
    if (lane == 0) prev = i == 0 ? -1 : bkey[base + i - 1];
    const bool valid = key[j] != kInt32Max;
    desc |= key[j] < prev;
    hmask[j] = __ballot_sync(0xffffffffu, valid && key[j] != prev);
    valid_here += __popc(__ballot_sync(0xffffffffu, valid));
    if (lane == 0) chunk[j * kHeadWarps + warp] = __popc(hmask[j]);
  }
  if (__any_sync(0xffffffffu, desc) && lane == 0) atomicOr(&word[0], 1);
  __syncthreads();
  if (lane == 0) atomicAdd(&s_valid, valid_here);
  if (warp == 0) {
    const int v = chunk[lane];
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    chunk[lane] = inc - v;
    if (lane == 31) s_heads = inc;
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kHeadPer; ++j) {
    const int i = j * kHeadThreads + tid;
    const bool head = (hmask[j] >> lane) & 1u;
    const int rank = chunk[j * kHeadWarps + warp] +
                     __popc(hmask[j] & below) + (head ? 1 : 0) - 1;
    const bool valid = key[j] != kInt32Max;
    ovfmask[base + i] = valid && rank >= nb;
    if (head && rank < nb) {
      hpos[rank] = i;
      pkeys[(size_t)tile * nb + rank] = key[j];
    }
    if (head && rank == nb) s_end = i;
  }
  const int live = min(s_heads, nb);
  for (int r = live + tid; r < nb; r += kHeadThreads) {
    pkeys[(size_t)tile * nb + r] = kInt32Max;
  }
  if (tid == 0) s_base = atomicAdd(&word[1], live);
  __syncthreads();
  // the last live row ends at the head of rank nb or, where the tile holds
  // no more runs, at its first invalid sample (sorted: the valid ones lead)
  const int end = s_heads > nb ? s_end : s_valid;
  for (int r = tid; r < live; r += kHeadThreads) {
    rows[s_base + r] = make_int4(tile * nb + r, (int)base + hpos[r],
                                 (int)base + (r + 1 < live ? hpos[r + 1]
                                                           : end), 0);
  }
}

// The rows of the list, warp w of the grid taking rows w, w + the grid's
// warps, ...
__global__ void __launch_bounds__(kRowThreads, kRowCtasPerSm)
tile_rows_kernel(const int* __restrict__ payload,
                 const int4* __restrict__ rows, const int* __restrict__ word,
                 float dscale, float* __restrict__ psd,
                 float* __restrict__ pw) {
  // per warp: a row's sd sums, then its counts; zero between rows
  __shared__ __align__(16) int buf[kRowWarps][2 * kRowLen];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4 zero4 = make_int4(0, 0, 0, 0);
  int* q = buf[warp];
  int* w = q + kRowLen;
  int4* q4 = reinterpret_cast<int4*>(q);
  int4* w4 = reinterpret_cast<int4*>(w);
#pragma unroll
  for (int k = 0; k < 2 * kRowQuads; ++k) q4[k * 32 + lane] = zero4;
  __syncwarp();
  const int n_rows = word[1];
  for (int j = blockIdx.x * kRowWarps + warp; j < n_rows;
       j += gridDim.x * kRowWarps) {
    const int4 d = rows[j];
    for (int i = d.y + lane; i < d.z; i += 32) {
      const unsigned p = (unsigned)payload[i];
      const int cell = (p >> 16) & 0x1FF;
      atomicAdd(&q[cell], (int)(short)(p & 0xFFFFu));
      atomicAdd(&w[cell], 1);
    }
    __syncwarp();
    const size_t row = (size_t)d.x * kRowLen;
    float4* sd4 = reinterpret_cast<float4*>(psd + row);
    float4* pw4 = reinterpret_cast<float4*>(pw + row);
#pragma unroll
    for (int k = 0; k < kRowQuads; ++k) {
      const int c = k * 32 + lane;
      const int4 x = q4[c], y = w4[c];
      q4[c] = zero4;
      w4[c] = zero4;
      __stcs(&sd4[c], to_float4(x, dscale));
      __stcs(&pw4[c], to_float4(y, 1.0f));
    }
    __syncwarp();
  }
}

}  // namespace chad

// rows: int4 scratch of n / 1024 * min(nb, 1024) entries; word: two ints,
// zeroed by the caller.
extern "C" int chad_tile_partials_sorted(const int* bkey, const int* payload,
                                         int n, int nb, float dscale,
                                         int* pkeys, float* psd, float* pw,
                                         int* ovfmask, void* rows, int* word,
                                         void* stream) {
  if (nb < 1 || n % chad::kTile != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // resident row CTAs on the whole card, found once per device (the
  // carveout is set in the device's context; racing first calls set and
  // store the same values)
  static std::atomic<int> grid_of[chad::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= chad::kMaxDevices) return (int)cudaErrorInvalidDevice;
  int grid_rows = grid_of[dev].load(std::memory_order_relaxed);
  if (grid_rows == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             chad::tile_rows_kernel,
             cudaFuncAttributePreferredSharedMemoryCarveout,
             (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, chad::tile_rows_kernel, chad::kRowThreads, 0)) !=
            cudaSuccess) {
      return (int)err;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid_rows = sms * per_sm;
    grid_of[dev].store(grid_rows, std::memory_order_relaxed);
  }
  const int tiles = n / chad::kTile;
  if (tiles == 0) return 0;
  int4* r = static_cast<int4*>(rows);
  chad::tile_heads_kernel<<<tiles, chad::kHeadThreads, 0, s>>>(
      bkey, nb, pkeys, ovfmask, r, word);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chad::tile_rows_kernel<<<grid_rows, chad::kRowThreads, 0, s>>>(
      payload, r, word, dscale, psd, pw);
  CHAD_RETURN_LAUNCH_ERROR();
}
