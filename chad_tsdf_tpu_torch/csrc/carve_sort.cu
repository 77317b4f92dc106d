// carve_sort: the carve's free-space sample keys sorted on the card, keys
// only, by a least-significant-digit radix sort over their significant bits.
//
// It replaces no TPU kernel: the JAX package sorts the carve's keys with
// lax.sort (chad_tsdf_tpu/core/carve.py carve_step_impl), which XLA
// compiles.  carve_keys (carve.cu) lays a sweep's samples out as S =
// carve_steps x ceil(N / carve_subsample) int64 slots (8,388,608 in
// kitti_parked_carve), about half of them a valid key bkey << 32 | okey and
// the rest kInvalidKey.  A valid key carries 3 * block_bits + 9 bits of
// information (39 at block_bits 10): bkey < 2^(3 * block_bits), okey < 2^9.
// torch.sort, which the port ran before, sorted (key, index) pairs through
// all 64 bits of all S slots; nothing read the indices.
//
// What bounds it on the H100: bytes.  Whatever the design, each slot is
// read once and written once: 16 B a slot, 134 MB over 8.4 M slots, 0.040
// ms at 3.35 TB/s.  This design moves, over S slots of which V are valid
// and P digit passes: 8 S + 8 V (the first pass) + (P - 1) x 16 V (the
// later passes) + 8 (S - V) (the tail) bytes, 0.40 GB at P = 5 on the
// cell's sweep (0.12 ms).
//
// What the design does about it (Onesweep: Adinets and Merrill, 2022):
// every pass reads each of its keys once and writes it once, only the valid
// keys pass more than once, and no pass reads the keys to count digits.
//   1. carve_keys (carve.cu) counts the valid keys' digits of every pass as
//      it writes them.  The digits are those of the sort value bkey << 9 |
//      okey, kSortBits at a time, least significant first.
//   2. carve_sort_pass_kernel, once a digit: a CTA takes the next tile of
//      kSortTile keys (tiles numbered by an atomic counter, so every tile
//      before it has started), ranks its keys by the digit stably (warp by
//      warp, item by item in the keys' order, peers found with
//      __match_any_sync), publishes its digit counts and looks back over the
//      tiles before it, kLookback at a time, for each digit's prefix
//      (decoupled look-back; a count and its flag share one 32-bit word),
//      then writes its keys through shared memory grouped by digit, so that
//      a digit's run leaves as consecutive stores.  The first pass reads all
//      S slots and ranks the valid keys alone: the invalid slots drop out,
//      and the later passes cover [0, n_valid).  The last pass also writes
//      kInvalidKey over [n_valid, S).
// The digit is 8 bits (5 passes at block_bits 10): 4 passes of 10 bits, on
// CTAs of 1024 threads, measured within 2% of it on the cell's sweep, and
// the 8-bit pass keeps its per-warp counts in static shared memory.
// A sorted multiset is unique, so the result is torch.sort's values bit for
// bit (the first pass need not even be stable).  The passes alternate
// between two buffers that are not the input, which stays as it was.
// Nothing is read back on the host and nothing allocated: the launches sit
// in the carve's CUDA graph.
#include "common.cuh"

namespace chad {

constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;                           // keys a thread
constexpr int kSortTile = kSortThreads * kSortItems;    // keys a CTA
constexpr int kLookback = 8;    // tiles a look-back step reads at once
static_assert(kSortThreads >= kSortBins, "a thread owns each digit");
// a tile's count of one digit: its flag in the top two bits
constexpr unsigned kAggregate = 1u << 30;   // the tile's own count
constexpr unsigned kInclusive = 2u << 30;   // the tile's and its predecessors'
constexpr unsigned kCountMask = kAggregate - 1;

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// One digit pass from in to out (module note).  first: in holds all s
// slots, the valid keys among them; otherwise its first n_valid.  last:
// out's tail [n_valid, s) becomes kInvalidKey.  counts: this digit's counts
// over all valid keys; next_tile and status (one word a tile and digit)
// zeroed by the caller.
__global__ void __launch_bounds__(kSortThreads, 2)
carve_sort_pass_kernel(const unsigned long long* __restrict__ in, int s,
                       const int* __restrict__ n_valid, int first, int last,
                       int shift, const int* __restrict__ counts,
                       int* __restrict__ next_tile,
                       unsigned* __restrict__ status,
                       unsigned long long* __restrict__ out) {
  __shared__ union {
    // a warp's count of each digit, then the tile position of its first key
    // of the digit (at most kSortTile: 16 bits hold it)
    unsigned short warp[kSortWarps][kSortBins];
    unsigned long long keys[kSortTile];   // the tile, grouped by digit
  } sm;
  // a digit's output slot less its tile position
  __shared__ int to_out[kSortBins];
  __shared__ int red[2 * kSortWarps];
  __shared__ int s_tile;
  const int nv = *n_valid;
  const int n = first ? s : nv;
  if (last) {
    const int t1 = min((int)(blockIdx.x + 1) * kSortTile, s);
    for (int p = max((int)blockIdx.x * kSortTile, nv) + threadIdx.x; p < t1;
         p += kSortThreads)
      out[p] = kInvalidKey;
  }
  if ((int)blockIdx.x * kSortTile >= n) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(next_tile, 1);
  for (int d = lane; d < kSortBins; d += 32) sm.warp[warp][d] = 0;
  // the owner of digit threadIdx.x: its count over all valid keys
  const int d = threadIdx.x;
  const bool owner = d < kSortBins;
  int base = owner ? counts[d] : 0;
  __syncthreads();
  const int tile = s_tile;

  // load, warp-striped: item i of lane l at warp * 32 * kSortItems + i * 32
  // + l of the tile, so a warp's items in order are the keys in order
  const int at = tile * kSortTile + warp * 32 * kSortItems + lane;
  unsigned long long k[kSortItems];
  for (int i = 0; i < kSortItems; ++i)
    k[i] = at + i * 32 < n ? in[at + i * 32] : kInvalidKey;

  // rank among the warp's keys of the same digit before it
  int rank[kSortItems];
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = 0; i < kSortItems; ++i) {
    const bool ok = k[i] != kInvalidKey;
    const int di = ok ? (int)(sort_value(k[i]) >> shift) & (kSortBins - 1)
                      : kSortBins;
    const unsigned peers = __match_any_sync(0xffffffffu, di);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (ok && lane == leader) {
      before = sm.warp[warp][di];
      sm.warp[warp][di] = (unsigned short)(before + __popc(peers));
    }
    before = __shfl_sync(0xffffffffu, before, leader);
    rank[i] = before + __popc(peers & lanes_below);
    __syncwarp();
  }
  __syncthreads();

  // the tile's count of each digit, published at once
  int total = 0;
  if (owner) {
    for (int w = 0; w < kSortWarps; ++w) total += sm.warp[w][d];
    store_relaxed(&status[(size_t)tile * kSortBins + d],
                  (tile == 0 ? kInclusive : kAggregate) | (unsigned)total);
  }
  // each digit's first slot in the output (over all tiles) and in the tile
  int start = total, count, all;
  cta_scan<kSortWarps, SumOp>(base, start, all, count, red);
  if (owner) {
    int run = start;
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = sm.warp[w][d];
      sm.warp[w][d] = (unsigned short)run;
      run += c;
    }
    // the digit's keys in the tiles before this one, kLookback tiles a step
    int prefix = 0;
    for (int t = tile - 1; t >= 0; t -= kLookback) {
      unsigned v[kLookback];
      for (int w = 0; w < kLookback; ++w)
        v[w] = t - w >= 0
                   ? load_relaxed(&status[(size_t)(t - w) * kSortBins + d])
                   : kInclusive;
      bool done = false;
      for (int w = 0; w < kLookback && !done; ++w) {
        while (!(v[w] & (kAggregate | kInclusive)))
          v[w] = load_relaxed(&status[(size_t)(t - w) * kSortBins + d]);
        prefix += (int)(v[w] & kCountMask);
        done = v[w] & kInclusive;
      }
      if (done) break;
    }
    if (tile > 0)
      store_relaxed(&status[(size_t)tile * kSortBins + d],
                    kInclusive | (unsigned)(prefix + total));
    to_out[d] = base + prefix - start;
  }
  __syncthreads();

  // each key's place in the tile grouped by digit, then the keys there
  for (int i = 0; i < kSortItems; ++i) {
    if (k[i] == kInvalidKey) continue;
    rank[i] += sm.warp[warp][(int)(sort_value(k[i]) >> shift) &
                             (kSortBins - 1)];
  }
  __syncthreads();
  for (int i = 0; i < kSortItems; ++i)
    if (k[i] != kInvalidKey) sm.keys[rank[i]] = k[i];
  __syncthreads();
  for (int p = threadIdx.x; p < count; p += kSortThreads) {
    const unsigned long long key = sm.keys[p];
    out[to_out[(int)(sort_value(key) >> shift) & (kSortBins - 1)] + p] =
        key;
  }
}

}  // namespace chad

// keys: s slots, the first n_valid of them valid once sorted (the others
// kInvalidKey), each valid key's bkey below 2^(key_bits - 9); counts:
// carve_keys' digit counts of those keys, ceil(key_bits / kSortBits) x
// kSortBins.  out (s slots) gets them sorted; alt (s slots) is the passes'
// other buffer, used when there is more than one pass.  ws holds ws_len
// ints, of which the launches use passes x (1 + ceil(s / 4096) x
// kSortBins): an invalid value if it holds fewer, or if s or key_bits is
// out of range.
extern "C" int chad_carve_sort(const long long* keys, int s,
                               const int* n_valid, const int* counts,
                               int key_bits, long long* alt, long long* out,
                               int* ws, int ws_len, void* stream) {
  using namespace chad;
  const int passes = (key_bits + kSortBits - 1) / kSortBits;
  if (s < 1 || s >= (1 << 30) || key_bits < 1 || passes > kMaxSortPasses)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (s + kSortTile - 1) / kSortTile;
  const long long need = passes * (1 + tiles * kSortBins);
  if (ws_len < need) return (int)cudaErrorInvalidValue;
  int* next_tile = ws;
  auto* status = reinterpret_cast<unsigned*>(ws + passes);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)need * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const auto* src = reinterpret_cast<const unsigned long long*>(keys);
  for (int q = 0; q < passes; ++q) {
    // the last pass writes out, so the passes before alternate into it
    auto* dst = reinterpret_cast<unsigned long long*>(
        (passes - 1 - q) % 2 ? alt : out);
    carve_sort_pass_kernel<<<(int)tiles, kSortThreads, 0, st>>>(
        src, s, n_valid, q == 0, q == passes - 1, q * kSortBits,
        counts + q * kSortBins, next_tile + q,
        status + (size_t)q * tiles * kSortBins, dst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return 0;
}
